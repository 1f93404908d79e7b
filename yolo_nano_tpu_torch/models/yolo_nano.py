"""YOLO-Nano detector: ShuffleNetV2 backbone + FPN/PAN neck + 3-level head.

Public functions keep the JAX package's layouts: images [B,S,S,3] NHWC in
the model's dtype (f32, or bf16 for a model cast by
`utils.fuse_bn.cast_f32_to_bf16`); `predict` returns (boxes [B,D,4]
normalized x1y1x2y2, scores [B,D], classes [B,D] int32, valid [B,D] bool),
scored and decoded in f32 whatever the model's dtype. Inside, tensors are
NCHW in channels_last memory.

Head channel layout: per level the A·(1+C+4) output channels are
[conf ×A | (classes ×C) anchor-major | txtytwth ×4 anchor-major]; levels are
concatenated HW-major, so prediction row n = level_offset + cell·A + anchor.

Training: `init_yolo_nano` draws a model in train mode; `loss_forward` runs
it on a target tensor from `losses.targets.build_targets`. Training runs
unfolded convs (BN sees real activations); a trained model is folded with
`utils.fuse_bn.fold_bn` before it predicts through the kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from yolo_nano_tpu_torch.config import YoloNanoConfig
from yolo_nano_tpu_torch.losses.losses import detection_loss
from yolo_nano_tpu_torch.models.shufflenetv2 import (ShuffleNetV2,
                                                     init_shufflenetv2)
from yolo_nano_tpu_torch.ops.decode import (Grids, decode_boxes,
                                            decode_boxes_gathered, make_grids)
from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
from yolo_nano_tpu_torch.ops.nms import nms_on_candidates, stable_topk
from yolo_nano_tpu_torch.ops.nn import (  # noqa: F401 (precision_flags)
    ConvUnit, downsample2x_nearest, init_bn, init_conv, precision_flags,
    set_full_f32, upsample2x_nearest)
from yolo_nano_tpu_torch.utils.spans import span


class Head(nn.Module):
    """dw3×3 → 1×1 → dw3×3 → 1×1 (conv blocks, LeakyReLU) → plain 1×1.

    Folded, each dw→pw pair is one `fused_dw_pw` call: on the card the CUDA
    kernel, on the CPU its plain version."""

    def __init__(self, dw0: ConvUnit, pw0: ConvUnit, dw1: ConvUnit,
                 pw1: ConvUnit, out: ConvUnit):
        super().__init__()
        self.dw0, self.pw0, self.dw1, self.pw1, self.out = dw0, pw0, dw1, pw1, out
        self._kernel_weights = None

    @property
    def folded(self) -> bool:
        return not any(u.has_bn for u in (self.dw0, self.pw0, self.dw1,
                                           self.pw1))

    def _apply(self, fn, *args, **kwargs):
        self._kernel_weights = None  # .to()/.cuda() move the weights
        return super()._apply(fn, *args, **kwargs)

    def _pairs(self):
        """Kernel layouts: dw [3,3,C], dw_b, pw [C,Cout], pw_b; dw_w, dw_b
        and pw_b in f32 (bf16 ones widened, which is exact), pw_w in the
        weights' dtype."""
        if self._kernel_weights is None:
            self._kernel_weights = [
                (dw.weight[:, 0].permute(1, 2, 0).float().contiguous(),
                 dw.bias.float(), pw.weight[:, :, 0, 0].t().contiguous(),
                 pw.bias.float())
                for dw, pw in ((self.dw0, self.pw0), (self.dw1, self.pw1))]
        return self._kernel_weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded:
            x = x.contiguous(memory_format=torch.channels_last)
            for dw_w, dw_b, pw_w, pw_b in self._pairs():
                if pw_w.dtype != x.dtype:  # no op on the weights otherwise
                    pw_w = pw_w.to(x.dtype)
                x = fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b,
                                act_mid="leaky", act_out="leaky")
        else:
            x = self.pw1(self.dw1(self.pw0(self.dw0(x))))
        return self.out(x)


class YoloNano(nn.Module):
    """Module names mirror the JAX parameter tree: backbone, lateral0-2,
    smooth0-3, head0-2."""

    def __init__(self, cfg: YoloNanoConfig, backbone: ShuffleNetV2,
                 laterals, smooths, heads):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        for i, m in enumerate(laterals):
            setattr(self, f"lateral{i}", m)
        for i, m in enumerate(smooths):
            setattr(self, f"smooth{i}", m)
        for i, m in enumerate(heads):
            setattr(self, f"head{i}", m)

    def forward(self, images: torch.Tensor):
        """images [B,H,W,3] → (conf [B,N,1], cls [B,N,C],
        txtytwth [B,ΣHW,A,4]); the span `ynt.forward`."""
        with span("ynt.forward"):
            return self._forward(images)

    def _forward(self, images: torch.Tensor):
        a = self.cfg.num_anchors_per_level
        c = self.cfg.num_classes
        x = images.permute(0, 3, 1, 2)  # NHWC bytes = NCHW channels_last
        c3, c4, c5 = self.backbone(x)
        p3, p4, p5 = self.lateral0(c3), self.lateral1(c4), self.lateral2(c5)
        # FPN top-down
        p4 = self.smooth0(p4 + upsample2x_nearest(p5))
        p3 = self.smooth1(p3 + upsample2x_nearest(p4))
        # PAN bottom-up
        p4 = self.smooth2(p4 + downsample2x_nearest(p3))
        p5 = self.smooth3(p5 + downsample2x_nearest(p4))

        confs, clss, boxes = [], [], []
        for head, feat in zip((self.head0, self.head1, self.head2),
                              (p3, p4, p5)):
            pred = head(feat)
            b, ch, h, w = pred.shape
            # NHWC before flattening: row = cell·A + anchor
            pred = pred.permute(0, 2, 3, 1).reshape(b, h * w, ch)
            confs.append(pred[..., :a].reshape(b, h * w * a, 1))
            clss.append(pred[..., a:(1 + c) * a].reshape(b, h * w * a, c))
            boxes.append(pred[..., (1 + c) * a:].reshape(b, h * w, a, 4))
        return torch.cat(confs, 1), torch.cat(clss, 1), torch.cat(boxes, 1)


def forward_features(model: YoloNano, images: torch.Tensor):
    """images [B,H,W,3] → (conf [B,N,1], cls [B,N,C], txtytwth [B,ΣHW,A,4])."""
    return model(images)


def scores_from_features(conf_pred, cls_pred):
    """Head outputs → (score [B,N], cls [B,N] int32), with
    score = max_c softmax(cls)·sigmoid(obj) = exp(max − logsumexp)·obj."""
    obj = torch.sigmoid(conf_pred.float())[..., 0]
    logits = cls_pred.float()
    m = logits.max(-1).values
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
    score = torch.exp(m - lse) * obj
    cls = torch.argmax(logits, -1).to(torch.int32)
    return score, cls


def postprocess_scored(txtytwth_pred, score, cls, cfg: YoloNanoConfig,
                       input_size: int):
    """Confidence filter + top-k on scores, decode only the K survivors,
    then per-class greedy NMS → fixed-shape detections."""
    b, n = score.shape
    k = min(cfg.nms_pre_topk, n)
    ranked = torch.where(score >= cfg.conf_thresh, score,
                         torch.full_like(score, -1.0))
    top_score, idx = stable_topk(ranked, k)
    txty = txtytwth_pred.float().reshape(b, n, 4)
    txty_k = torch.gather(txty, 1, idx[..., None].expand(b, k, 4))
    top_boxes = torch.clamp(
        decode_boxes_gathered(txty_k, idx, cfg, input_size) / input_size,
        0.0, 1.0)
    top_cls = torch.gather(cls, 1, idx)
    return nms_on_candidates(top_boxes, top_score, top_cls,
                             iou_thresh=cfg.nms_thresh,
                             max_det=cfg.max_detections, diou=cfg.diou_nms)


def detect(model: YoloNano, images: torch.Tensor, cfg: YoloNanoConfig,
           input_size: int):
    """What `predict` runs, without its grad mode and precision flags:
    forward → scores → top-k → decode → NMS. `serving.export_graph` traces
    it. The postprocess is the span `ynt.postprocess`."""
    conf_pred, cls_pred, txtytwth_pred = model(images)
    with span("ynt.postprocess"):
        score, cls = scores_from_features(conf_pred, cls_pred)
        return postprocess_scored(txtytwth_pred, score, cls, cfg, input_size)


@torch.inference_mode()
def predict(model: YoloNano, images: torch.Tensor, cfg: YoloNanoConfig,
            input_size: int):
    """Batched inference: images [B,S,S,3] → (boxes [B,D,4], scores [B,D],
    classes [B,D] int32, valid [B,D] bool), all on the images' device."""
    set_full_f32()  # f32 means f32: TF32 off for convolutions and matmuls
    return detect(model, images, cfg, input_size)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_conv_block(gen, k, cin, cout, groups=1):
    """Conv(bias) + BN + LeakyReLU; BN bias starts at 0 in neck and heads."""
    p = init_conv(gen, k, k, cin, cout, groups=groups, bias=True)
    bn_p, bn_s = init_bn(cout, bias_init=0.0)
    return {**p, **bn_p}, bn_s


def _init_head(gen, c, out_ch, num_anchors):
    """dw3×3 → 1×1 → dw3×3 → 1×1 → plain 1×1 with bias, whose objectness
    slots start at −log((1 − 0.01)/0.01)."""
    p, s = {}, {}
    for name, k, groups in (("dw0", 3, c), ("pw0", 1, 1), ("dw1", 3, c),
                            ("pw1", 1, 1)):
        p[name], s[name] = _init_conv_block(gen, k, c, c, groups)
    p["out"] = init_conv(gen, 1, 1, c, out_ch, bias=True)
    p["out"]["b"][:num_anchors] = -math.log((1.0 - 0.01) / 0.01)
    return p, s


def init_yolo_nano_tree(gen: torch.Generator, cfg: YoloNanoConfig):
    """→ (params, stats): JAX-layout trees of numpy arrays for the
    detector."""
    if cfg.backbone not in ("0.5x", "1.0x", "1.5x", "2.0x"):
        raise ValueError(f"unsupported backbone {cfg.backbone!r}")
    bb_p, bb_s = init_shufflenetv2(gen, cfg.backbone)
    params, stats = {"backbone": bb_p}, {"backbone": bb_s}
    nc = cfg.neck_channels
    for i, cin in enumerate(cfg.backbone_channels[1:4]):
        params[f"lateral{i}"], stats[f"lateral{i}"] = _init_conv_block(
            gen, 1, cin, nc)
    for i in range(4):
        params[f"smooth{i}"], stats[f"smooth{i}"] = _init_conv_block(
            gen, 3, nc, nc)
    for i in range(3):
        params[f"head{i}"], stats[f"head{i}"] = _init_head(
            gen, nc, cfg.head_out_channels, cfg.num_anchors_per_level)
    return params, stats


def init_yolo_nano(gen: torch.Generator, cfg: YoloNanoConfig,
                   device=None) -> YoloNano:
    """A freshly initialised detector in train mode, with trainable
    parameters, on CUDA unless `device` names another. The draws come from
    `gen` on the CPU, so a seed gives the same weights on every device."""
    from yolo_nano_tpu_torch.convert import build_yolo_nano
    from yolo_nano_tpu_torch.serving import resolve_device

    dev = resolve_device(device)
    model = build_yolo_nano(*init_yolo_nano_tree(gen, cfg), cfg)
    return model.requires_grad_(True).train().to(dev)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _area(wh: torch.Tensor) -> torch.Tensor:
    """w·h of [..., 2]; not torch.prod, whose backward asks the host whether
    any factor is 0."""
    return wh[..., 0] * wh[..., 1]


def iou_score(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of corner boxes [..., 4]; the intersection counts only
    where tl < br on both axes, and 1e-14 guards 0-area against 0-area."""
    tl = torch.maximum(boxes_a[..., :2], boxes_b[..., :2])
    br = torch.minimum(boxes_a[..., 2:], boxes_b[..., 2:])
    area_a = _area(boxes_a[..., 2:] - boxes_a[..., :2])
    area_b = _area(boxes_b[..., 2:] - boxes_b[..., :2])
    en = (tl < br).all(-1).to(boxes_a.dtype)
    area_i = _area(br - tl) * en
    return area_i / (area_a + area_b - area_i + 1e-14)


def loss_from_features(conf_pred, cls_pred, txtytwth_pred, target,
                       input_size: int, grids: Grids):
    """Head outputs and the [B,N,11] target → (conf, cls, bbox, iou) losses.
    The IoU of each decoded box with its target box is the objectness
    label, without gradient; the IoU loss keeps its gradient through the
    decode. The losses run in f32 at least (f64 stays f64)."""
    b = conf_pred.shape[0]
    wide = torch.promote_types(conf_pred.dtype, torch.float32)
    txtytwth = txtytwth_pred.to(wide)
    boxes = decode_boxes(txtytwth, grids) / input_size
    iou = iou_score(boxes, target[..., 7:11])[..., None]
    label = torch.cat([iou.detach(), target[..., :7].to(wide)], -1)
    n = boxes.shape[1]
    return detection_loss(conf_pred.to(wide), cls_pred.to(wide),
                          txtytwth.reshape(b, n, 4), iou, label)


def loss_forward(model: YoloNano, images: torch.Tensor, target: torch.Tensor,
                 cfg: YoloNanoConfig, input_size: int):
    """Training forward: images [B,S,S,3] and target [B,N,11] → (conf, cls,
    bbox, iou) losses. In train mode the model's BN units write their new
    running stats into its buffers. (The train step calls
    `loss_from_features` with grids already on the device.)"""
    grids = make_grids(cfg, input_size, images.device)
    return loss_from_features(*model(images), target, input_size, grids)
