"""YOLO-Nano in plain PyTorch, float32: the benchmark's reference forward.

Written from the architecture (yjh0410/YOLO-Nano, `models/yolo_nano.py`;
ShuffleNetV2, Ma et al. 2018, arXiv:1807.11164), not from the program
under test, whose modules it does not import:

  * stem: 3x3/s2 conv + ReLU, 3x3/s2 max-pool (pad 1);
  * stages 2/3/4 of ShuffleV2 blocks (4, 8, 4): a stride-2 block has two
    branches (dw3x3/s2 -> 1x1+ReLU; 1x1+ReLU -> dw3x3/s2 -> 1x1+ReLU), a
    stride-1 block splits the channels and runs the right half through the
    second branch; the two halves are concatenated and shuffled (g = 2);
  * neck: 1x1 laterals, FPN top-down (nearest 2x up, add, 3x3) and PAN
    bottom-up (every second pixel, add, 3x3), LeakyReLU 0.1;
  * three heads: dw3x3 -> 1x1 -> dw3x3 -> 1x1 (LeakyReLU 0.1) -> plain 1x1
    to A*(1 + C + 4) channels: [objectness x A | classes (A x C) | box
    (A x 4)], anchor-major; rows are level-concatenated, n = cell*A + a.

Padding is (k - 1) // 2 on both sides. Weights are a dict {unit name:
{"w": OIHW, "b": bias or absent, "scale", "beta": BN, when unfolded}} with
the names of the published tree (`backbone.stage2.0.branch2.pw1`,
`head0.dw0`, `head0.out`). Folded weights (BN merged into the conv) come
from an artifact's `.npz` (`load_folded`); unfolded ones run BN with the
batch's statistics (training).

`precision` selects the control of `benchmark/checks.py`: None is f32 with
TF32 off; "tf32" lets cuDNN use TF32 for the convolutions; "fp8" rounds
every convolution's input and weight to float8 e4m3 with a per-tensor
scale (quantize, dequantize) and computes in f32.
"""

from __future__ import annotations

import contextlib
import json
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEAKY = 0.1
STAGE_REPEATS = (4, 8, 4)
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def load_folded(path: str):
    """An artifact `.npz` -> (units on the CPU in f32, its config.json
    content). bf16 leaves are stored as uint16 bit patterns under
    `<key>.bf16`; widening them to f32 is exact (the bits shifted up)."""
    units: Dict[str, dict] = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["config.json"]))
        for key in z.files:
            if key == "config.json":
                continue
            a = z[key]
            if key.endswith(".bf16"):
                a = (a.astype(np.uint32) << 16).view(np.float32)
                key = key[:-len(".bf16")]
            *path_, leaf = key.split("/")
            t = torch.from_numpy(np.array(a, np.float32))
            if leaf == "w":  # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1).contiguous()
            units.setdefault(".".join(path_), {})[leaf] = t
    return units, meta


def units_from_named(named: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Tensors named as a module tree (`<unit>.weight`, `.bias`,
    `.bn_scale`, `.bn_bias`) -> units."""
    leaf = {"weight": "w", "bias": "b", "bn_scale": "scale",
            "bn_bias": "beta"}
    units: Dict[str, dict] = {}
    for name, t in named.items():
        unit, attr = name.rsplit(".", 1)
        if attr in leaf:
            units.setdefault(unit, {})[leaf[attr]] = t
    return units


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@contextlib.contextmanager
def precision_scope(precision: Optional[str]):
    """cuDNN and matmul TF32 as `precision` asks (on only for "tf32"),
    restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class Forward:
    """One forward pass: units, whether BN takes batch statistics, and the
    precision of the convolutions."""

    def __init__(self, units: Dict[str, dict], anchors_per_level: int,
                 train: bool = False, precision: Optional[str] = None):
        self.units, self.train, self.precision = units, train, precision
        self.a = anchors_per_level

    def unit(self, name: str, x, stride: int = 1, act: Optional[str] = None):
        u = self.units[name]
        w = u["w"]
        groups = x.shape[1] if w.shape[1] == 1 else 1
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        y = F.conv2d(x, w, u.get("b"), stride=stride,
                     padding=(w.shape[-1] - 1) // 2, groups=groups)
        if "scale" in u:
            if not self.train:
                raise ValueError(f"{name}: unfolded weights run in training")
            mean = y.mean((0, 2, 3), keepdim=True)
            var = (y - mean).square().mean((0, 2, 3), keepdim=True)
            y = ((y - mean) * torch.rsqrt(var + BN_EPS)
                 * u["scale"][:, None, None] + u["beta"][:, None, None])
        if act == "relu":
            return torch.relu(y)
        if act == "leaky":
            return torch.where(y >= 0, y, LEAKY * y)
        return y

    def block(self, name: str, x, stride: int):
        def branch2(t):
            t = self.unit(f"{name}.branch2.pw1", t, act="relu")
            t = self.unit(f"{name}.branch2.dw", t, stride=stride)
            return self.unit(f"{name}.branch2.pw2", t, act="relu")

        if stride == 2:
            left = self.unit(f"{name}.branch1.dw", x, stride=2)
            left = self.unit(f"{name}.branch1.pw", left, act="relu")
            right = branch2(x)
        else:
            c = x.shape[1] // 2
            left, right = x[:, :c], branch2(x[:, c:])
        out = torch.cat([left, right], 1)
        b, c, h, w = out.shape  # channel shuffle, 2 groups
        return out.view(b, 2, c // 2, h, w).transpose(1, 2).reshape(b, c, h, w)

    def backbone(self, x):
        x = self.unit("backbone.conv1", x, stride=2, act="relu")
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for si, repeats in enumerate(STAGE_REPEATS):
            for bi in range(repeats):
                x = self.block(f"backbone.stage{si + 2}.{bi}", x,
                               2 if bi == 0 else 1)
            feats.append(x)
        return feats

    def __call__(self, images: torch.Tensor):
        """images [B, S, S, 3] f32 -> head outputs in rows: (objectness
        [B, N], class logits [B, N, C], raw box [B, N, 4]), N = sum HW * A."""
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        p3 = self.unit("lateral0", c3, act="leaky")
        p4 = self.unit("lateral1", c4, act="leaky")
        p5 = self.unit("lateral2", c5, act="leaky")
        up = lambda t: t.repeat_interleave(2, 2).repeat_interleave(2, 3)  # noqa: E731
        p4 = self.unit("smooth0", p4 + up(p5), act="leaky")
        p3 = self.unit("smooth1", p3 + up(p4), act="leaky")
        p4 = self.unit("smooth2", p4 + p3[:, :, ::2, ::2], act="leaky")
        p5 = self.unit("smooth3", p5 + p4[:, :, ::2, ::2], act="leaky")
        objs, clss, boxes = [], [], []
        for i, feat in enumerate((p3, p4, p5)):
            t = feat
            for part in ("dw0", "pw0", "dw1", "pw1"):
                t = self.unit(f"head{i}.{part}", t, act="leaky")
            t = self.unit(f"head{i}.out", t)
            b, ch, h, w = t.shape
            a = self.a
            t = t.permute(0, 2, 3, 1).reshape(b, h * w, ch)
            ncls = ch // a - 5
            objs.append(t[..., :a].reshape(b, h * w * a))
            clss.append(t[..., a:a + a * ncls].reshape(b, h * w * a, ncls))
            boxes.append(t[..., a + a * ncls:].reshape(b, h * w * a, 4))
        return torch.cat(objs, 1), torch.cat(clss, 1), torch.cat(boxes, 1)
