"""Detection losses: four scalars, each summed and divided by the batch size.

  * conf: sigmoid-MSE objectness, weight 5 on positives and 1 on negatives,
    rows with obj == −1 ignored. The positive target is the IoU of the
    decoded prediction with its ground-truth box (no gradient).
  * cls: softmax cross-entropy over positive rows.
  * bbox: BCE-with-logits on (tx, ty) + MSE on (tw, th), both scaled by the
    small-box weight 2 − w·h and masked to positives.
  * iou: SmoothL1 (beta 1) of the predicted IoU against the positive mask,
    over ALL rows: it is not masked, pushes background boxes toward IoU 0
    and carries gradient through the box decode.

Label layout [B, N, 8]: [conf (= IoU), obj, cls, tx, ty, tw, th, weight].
"""

from __future__ import annotations

import torch


def _bce_with_logits(x, y):
    """Stable binary cross-entropy with logits: max(x,0) − x·y + log1p(e^−|x|)."""
    return torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def _smooth_l1(x, y):
    """0.5·d² where |d| < 1, else |d| − 0.5."""
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def detection_loss(pred_conf, pred_cls, pred_txtytwth, pred_iou, label):
    """pred_conf [B,N,1], pred_cls [B,N,C], pred_txtytwth [B,N,4],
    pred_iou [B,N,1], label [B,N,8] → (conf, cls, bbox, iou) scalars."""
    b = pred_conf.shape[0]
    pred_conf = pred_conf[..., 0]
    pred_iou = pred_iou[..., 0]
    gt_conf, gt_obj = label[..., 0], label[..., 1]
    gt_cls = label[..., 2].long()
    gt_weight = label[..., 7]
    gt_mask = (gt_obj > 0.0).float()

    conf = torch.sigmoid(pred_conf)
    pos = (gt_obj == 1.0).float()
    neg = (gt_obj == 0.0).float()
    conf_loss = torch.sum(5.0 * pos * torch.square(conf - gt_conf)
                          + neg * torch.square(conf)) / b

    logp = torch.log_softmax(pred_cls, -1)
    ce = -torch.gather(logp, -1, gt_cls[..., None])[..., 0]
    cls_loss = torch.sum(ce * gt_mask) / b

    txty_loss = torch.sum(_bce_with_logits(pred_txtytwth[..., :2],
                                           label[..., 3:5]).sum(-1)
                          * gt_weight * gt_mask) / b
    twth_loss = torch.sum(torch.square(pred_txtytwth[..., 2:]
                                       - label[..., 5:7]).sum(-1)
                          * gt_weight * gt_mask) / b
    iou_loss = torch.sum(_smooth_l1(pred_iou, gt_mask)) / b
    return conf_loss, cls_loss, txty_loss + twth_loss, iou_loss
