"""The reference's training step, plain PyTorch and NumPy, f32: anchor
targets, the YOLO-Nano loss and SGD, written from the method (yjh0410's
YOLO-Nano training recipe) and not from the program under test.

Targets, per ground truth (label >= 0, at least 1 px wide and high): its
width-height IoU with each anchor (both centred) picks the best anchor,
first on ties; the best anchor's row at the cell holding the box centre is
positive, [obj 1, class, tx, ty, tw, th, weight 2 - w*h, box], and the
other anchors above `ignore_thresh` are ignored there (obj -1, weight -1)
unless a positive takes the row; of several positives on one row the last
of the image wins. It runs in f32 in the order the formulas are written,
so that the cell a centre falls in is decided as the program decides it.

Loss, each term summed and divided by the batch: objectness, sigmoid MSE
against the IoU of the decoded box with its target (no gradient), weight 5
on positives and 1 on negatives; class cross-entropy on positives; box,
BCE on (tx, ty) and MSE on (tw, th), times the weight, on positives; IoU,
smooth L1 (beta 1) of the decoded boxes' IoU against the positive mask over
all rows.

SGD: momentum 0.9 and coupled weight decay 5e-4 on every parameter:
g <- g + 5e-4 p; trace <- g + 0.9 trace; p <- p - lr trace.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.detect import Rows, row_tables
from benchmark.reference.model import Forward, precision_scope, units_from_named

WEIGHT_DECAY = 5e-4
MOMENTUM = 0.9
IGNORE_THRESH = 0.5


def targets(gt_boxes: np.ndarray, gt_labels: np.ndarray, anchors, strides,
            size: int) -> np.ndarray:
    """gt_boxes [B, M, 4] normalized corners (f32), gt_labels [B, M] (-1
    pads) -> target [B, N, 11] f32."""
    f = np.float32
    a = len(anchors) // len(strides)
    widths = [size // s for s in strides]
    offsets = np.cumsum([0] + [w * w * a for w in widths])
    n = int(offsets[-1])
    anc = np.asarray(anchors, f)
    out = np.zeros((gt_boxes.shape[0], n, 11), f)
    for b in range(gt_boxes.shape[0]):
        positives = []
        for j in range(gt_boxes.shape[1]):
            if gt_labels[b, j] < 0:
                continue
            x1, y1, x2, y2 = (f(v) for v in gt_boxes[b, j])
            cx = (x1 + x2) / f(2) * f(size)
            cy = (y1 + y2) / f(2) * f(size)
            bw = (x2 - x1) * f(size)
            bh = (y2 - y1) * f(size)
            if bw < 1 or bh < 1:
                continue
            inter = np.minimum(bw, anc[:, 0]) * np.minimum(bh, anc[:, 1])
            iou = inter / (bw * bh + anc[:, 0] * anc[:, 1] - inter + f(1e-20))
            best = int(np.argmax(iou))
            for k in range(len(anchors)):
                level = k // a
                s = f(strides[level])
                gx, gy = int(np.floor(cx / s)), int(np.floor(cy / s))
                if not (0 <= gx < widths[level] and 0 <= gy < widths[level]):
                    continue
                row = offsets[level] + (gy * widths[level] + gx) * a + k % a
                if k == best:
                    tx = cx / s - np.floor(cx / s)
                    ty = cy / s - np.floor(cy / s)
                    tw = np.log(max(bw, f(1e-9)) / anc[k, 0])
                    th = np.log(max(bh, f(1e-9)) / anc[k, 1])
                    weight = f(2) - (bw / f(size)) * (bh / f(size))
                    positives.append((row, [1, gt_labels[b, j], tx, ty, tw,
                                            th, weight, x1, y1, x2, y2]))
                elif iou[k] > IGNORE_THRESH:
                    out[b, row] = [-1, 0, 0, 0, 0, 0, -1, 0, 0, 0, 0]
        for row, values in positives:  # after every ignore; the last wins
            out[b, row] = values
    return out


def _bce_logits(x, y):
    return torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def loss(fwd: Forward, images, target, rows: Rows, size: int):
    """-> (total, [objectness, class, box, iou]) for one batch."""
    obj, cls_logits, raw = fwd(images)
    b = images.shape[0]
    xy = torch.sigmoid(raw[..., :2])
    cx = (xy[..., 0] + rows.gx) * rows.stride
    cy = (xy[..., 1] + rows.gy) * rows.stride
    w = torch.exp(raw[..., 2]) * rows.aw
    h = torch.exp(raw[..., 3]) * rows.ah
    box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    box = box / size
    gt = target[..., 7:11]
    tl = torch.maximum(box[..., :2], gt[..., :2])
    br = torch.minimum(box[..., 2:], gt[..., 2:])
    overlap = (tl < br).all(-1).float()
    inter = (br - tl).prod(-1) * overlap
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])  # noqa: E731
    iou = inter / (area(box) + area(gt) - inter + 1e-14)

    objness, weight = target[..., 0], target[..., 6]
    pos = (objness == 1).float()
    neg = (objness == 0).float()
    mask = (objness > 0).float()
    p = torch.sigmoid(obj)
    l_obj = torch.sum(5 * pos * (p - iou.detach()) ** 2 + neg * p ** 2) / b
    logp = torch.log_softmax(cls_logits, -1)
    ce = -torch.gather(logp, -1, target[..., 1].long()[..., None])[..., 0]
    l_cls = torch.sum(ce * mask) / b
    l_box = (torch.sum(_bce_logits(raw[..., :2], target[..., 2:4]).sum(-1)
                       * weight * mask)
             + torch.sum(((raw[..., 2:] - target[..., 4:6]) ** 2).sum(-1)
                         * weight * mask)) / b
    d = (iou - mask).abs()
    l_iou = torch.sum(torch.where(d < 1, 0.5 * d * d, d - 0.5)) / b
    parts = [l_obj, l_cls, l_box, l_iou]
    return parts[0] + parts[1] + parts[2] + parts[3], parts


def train(params: Dict[str, torch.Tensor], batches: List[tuple], anchors,
          strides, size: int, lr: float, precision=None):
    """SGD steps from `params` (named as the model's tree, on the device),
    one per batch (images, gt_boxes, gt_labels as numpy or tensors) ->
    (each step's total loss, the first raw gradient, the first momentum,
    the parameters after the last step)."""
    dev = next(iter(params.values())).device
    rows = row_tables(anchors, strides, size, dev)
    a = len(anchors) // len(strides)
    p = {k: v.detach().clone() for k, v in params.items()}
    trace = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad, first_trace = [], None, None
    with precision_scope(precision):
        for images, gt_boxes, gt_labels in batches:
            target = torch.as_tensor(targets(
                np.asarray(gt_boxes, np.float32), np.asarray(gt_labels),
                anchors, strides, size), device=dev)
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            fwd = Forward(units_from_named(leaves), a, train=True)
            total, _ = loss(fwd, images, target, rows, size)
            grads = torch.autograd.grad(total, list(leaves.values()))
            losses.append(float(total.detach()))
            with torch.no_grad():
                grads = dict(zip(leaves, grads))
                for k in p:
                    g = grads[k] + WEIGHT_DECAY * p[k]
                    trace[k] = g + MOMENTUM * trace[k]
                    p[k] = (p[k] - lr * trace[k]).detach()
            if first_grad is None:
                first_grad = grads
                first_trace = {k: v.clone() for k, v in trace.items()}
    return losses, first_grad, first_trace, p
