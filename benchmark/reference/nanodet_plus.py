"""NanoDet-Plus in plain PyTorch, float32: the benchmark's reference forward
and postprocess for the NanoDet-Plus cells.

Written from the architecture (RangiLyu/nanodet: `nanodet/model/backbone/
shufflenetv2.py`, `fpn/ghost_pan.py`, `backbone/ghostnet.py`,
`head/nanodet_plus_head.py`, `module/nms.py`), not from the program under
test, whose modules it does not import. BN is folded into the artifact's
weights, so each unit is conv + bias (+ act); act is LeakyReLU(0.1):

  * backbone: ShuffleNetV2 as `reference.model.Forward`, with LeakyReLU in
    the stem and in every 1×1 of both branches (`activation: LeakyReLU`);
  * GhostPAN: reduce 1×1 + act; top-down GhostBottleneck(cat[bilinear 2×
    up (half-pixel centres) of the higher level, the lower]); bottom-up
    GhostBottleneck(cat[DWConv/s2 of the lower, the higher]); extra level
    DWConv/s2(reduced c5) + DWConv/s2(last output). A DWConv is dw k×k +
    act, then 1×1 + act. A GhostBottleneck (stride 1, no SE) is ghost2(
    ghost1(x)) + shortcut(x): a ghost module is primary 1×1 (+ act) to x1,
    cheap dw3×3 (+ act) of x1, cat[x1, x2] (ghost2 without act); the
    shortcut dw k×k then 1×1, no act;
  * head, per level, not shared: two DWConvs, then 1×1 to C + 4·(R + 1):
    class logits, then each side's R + 1 distance bins;
  * decode: priors (x·s, y·s) with no half-cell offset, side ceil(S / s);
    distances softmax(bins) · [0..R] · s, boxes (x − l, y − t, x + r,
    y + b) clamped to [0, S] (`distance2bbox`), divided by S;
  * scores: sigmoid(logit) for every (prior, class) pair (multi-label);
  * candidates: pairs scoring strictly above conf, in score order, equal
    scores in pair order (pair = prior·C + class);
  * greedy NMS per class (torchvision's `nms` through `batched_nms`): a
    candidate is kept unless a kept one of its class overlaps it by
    IoU > nms.

Departures from NanoDet's code: the candidates are cut at `pre_topk` pairs
(NanoDet's `multiclass_nms` keeps every pair above the threshold; the
program's postprocess has a fixed shape) and the kept ones at max-det;
boxes are normalized by the input size, not warped back to an original
image; weights are the artifact's folded ones (bf16 widened to f32
exactly), and the precision controls of `reference.model` apply to every
convolution.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import detect as ref_detect
from benchmark.reference import model as ref_model


class Forward(ref_model.Forward):
    """The folded forward of a NanoDet-Plus artifact's units."""

    def __init__(self, units, num_classes: int, precision=None):
        super().__init__(units, anchors_per_level=1, precision=precision)
        self.num_classes = num_classes

    def block(self, name: str, x, stride: int):
        def branch2(t):
            t = self.unit(f"{name}.branch2.pw1", t, act="leaky")
            t = self.unit(f"{name}.branch2.dw", t, stride=stride)
            return self.unit(f"{name}.branch2.pw2", t, act="leaky")

        if stride == 2:
            left = self.unit(f"{name}.branch1.dw", x, stride=2)
            left = self.unit(f"{name}.branch1.pw", left, act="leaky")
            right = branch2(x)
        else:
            c = x.shape[1] // 2
            left, right = x[:, :c], branch2(x[:, c:])
        out = torch.cat([left, right], 1)
        b, c, h, w = out.shape
        return out.view(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)

    def backbone(self, x):
        x = self.unit("backbone.conv1", x, stride=2, act="leaky")
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for si, repeats in enumerate(ref_model.STAGE_REPEATS):
            for bi in range(repeats):
                x = self.block(f"backbone.stage{si + 2}.{bi}", x,
                               2 if bi == 0 else 1)
            feats.append(x)
        return feats

    def dwconv(self, name: str, x, stride: int = 1, act="leaky"):
        x = self.unit(f"{name}.dw", x, stride=stride, act=act)
        return self.unit(f"{name}.pw", x, act=act)

    def ghost(self, name: str, x, act):
        x1 = self.unit(f"{name}.primary", x, act=act)
        return torch.cat([x1, self.unit(f"{name}.cheap", x1, act=act)], 1)

    def bottleneck(self, name: str, x):
        y = self.ghost(f"{name}.ghost2", self.ghost(f"{name}.ghost1", x,
                                                    "leaky"), None)
        return y + self.dwconv(f"{name}.shortcut", x, act=None)

    def neck(self, feats):
        ins = [self.unit(f"fpn.reduce_layers.{i}", f, act="leaky")
               for i, f in enumerate(feats)]
        n = len(ins)
        inner = [ins[-1]]
        for i in range(n - 1, 0, -1):
            up = F.interpolate(inner[0], scale_factor=2, mode="bilinear",
                               align_corners=False)
            inner.insert(0, self.bottleneck(
                f"fpn.top_down_blocks.{n - 1 - i}",
                torch.cat([up, ins[i - 1]], 1)))
        outs = [inner[0]]
        for i in range(n - 1):
            down = self.dwconv(f"fpn.downsamples.{i}", outs[-1], stride=2)
            outs.append(self.bottleneck(f"fpn.bottom_up_blocks.{i}",
                                        torch.cat([down, inner[i + 1]], 1)))
        outs.append(self.dwconv("fpn.extra_in", ins[-1], stride=2)
                    + self.dwconv("fpn.extra_out", outs[-1], stride=2))
        return outs

    def __call__(self, images: torch.Tensor):
        """images [B, S, S, 3] f32 -> (class logits [B, N, C], distance
        bins [B, N, 4(R + 1)], the levels' sides), N = sum of sides²."""
        feats = self.neck(self.backbone(
            images.permute(0, 3, 1, 2).contiguous()))
        rows, sides = [], []
        for li, feat in enumerate(feats):
            t = self.dwconv(f"head.cls_convs.{li}.0", feat)
            t = self.dwconv(f"head.cls_convs.{li}.1", t)
            t = self.unit(f"head.gfl_cls.{li}", t)
            b, ch, h, w = t.shape
            rows.append(t.permute(0, 2, 3, 1).reshape(b, h * w, ch))
            sides.append(h)
        out = torch.cat(rows, 1)
        return out[..., :self.num_classes], out[..., self.num_classes:], sides


def priors(strides, sides, device) -> torch.Tensor:
    """[N, 3]: each prior's x·s, y·s and s, level by level, y-major."""
    parts = []
    for s, n in zip(strides, sides):
        ys, xs = torch.meshgrid(torch.arange(n), torch.arange(n),
                                indexing="ij")
        parts.append(torch.stack([xs.reshape(-1) * s, ys.reshape(-1) * s,
                                  torch.full((n * n,), s)], -1))
    return torch.cat(parts).float().to(device)


def dense(cls_logits, reg, pri: torch.Tensor, size: int):
    """Head outputs -> (pair probabilities [B, N, C], boxes [B, N, 4])."""
    probs = torch.sigmoid(cls_logits)
    b, n, c = reg.shape
    bins = c // 4
    proj = torch.linspace(0, bins - 1, bins, device=reg.device)
    d = F.linear(torch.softmax(reg.reshape(b, n, 4, bins), -1), proj[None])
    d = d[..., 0] * pri[:, 2:3]
    x, y = pri[:, 0], pri[:, 1]
    boxes = torch.stack([x - d[..., 0], y - d[..., 1], x + d[..., 2],
                         y + d[..., 3]], -1)
    return probs, torch.clamp(boxes, 0.0, float(size)) / size


def candidates(probs: torch.Tensor, boxes: torch.Tensor, conf: float,
               nms: float, pre_topk: int) -> List[ref_detect.Candidates]:
    """Per image of a batch: its candidate pairs (f64 on the host, in score
    order) and what NMS keeps; `probs` of a candidate is its prior's row."""
    b, n, c = probs.shape
    flat = probs.reshape(b, n * c)
    values, order = torch.sort(flat, dim=1, descending=True, stable=True)
    take = min(pre_topk + 1, n * c)
    values, order = values[:, :take].double().cpu().numpy(), \
        order[:, :take].cpu().numpy()
    out = []
    for i in range(b):
        above = values[i] > conf
        cut = float(values[i][pre_topk]) if (
            len(values[i]) > pre_topk and above[pre_topk]) else -np.inf
        keep = np.flatnonzero(above[:pre_topk])
        pair = order[i][keep]
        prior = torch.as_tensor(pair // c, device=probs.device)
        bx = boxes[i, prior].double().cpu().numpy()
        cls = pair % c
        out.append(ref_detect.Candidates(
            bx, values[i][keep], cls, probs[i, prior].double().cpu().numpy(),
            ref_detect.greedy_nms(bx, cls, nms), cut))
    return out
