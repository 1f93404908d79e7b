"""The yardstick's arithmetic for NanoDet-Plus, by the conventions of
`counts.py` and `yolo_nano_tpu_torch/utils/flops.py`: the model's FLOPs an
image, and the operations, bytes and least time of each launch of the
head-pair kernel at k = 5.

FLOPs (XLA's cost analysis, as the repository's count does): 2 a
multiply-add of every convolution tap inside the image, 1 an output
element for a bias add or a sum, 3 for a LeakyReLU (compare, scale,
select), 8 for a 3x3 max-pool output; moving data (split, concatenation,
shuffle) and the bilinear 2x upsampling are free.

A 5x5 pair (dw 5x5 then 1x1, stride 1) does 2·25·C + 2·C·Cout operations
an output pixel and moves its input and output once, its pointwise weights
in the activation dtype and its taps and biases in f32; its least time is
`counts.least_s` of these. The twelve pairs of a forward: two in the head
of each of the four levels (C = Cout = the neck width) and each
GhostBottleneck's shortcut (C = twice the neck width, Cout = the neck
width), two at each of the two lower levels.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark import counts
from benchmark.counts import _conv, conv_out

LEAKY = 3


def sides(cfg: dict) -> List[int]:
    """The four levels' sides: the backbone's three, then the extra level's
    stride-2 5x5 conv of the last."""
    s = cfg["img_size"]
    out = [conv_out(conv_out(s, 2), 2)]  # stem, max-pool
    for _ in range(3):
        out.append(conv_out(out[-1], 2))
    out = out[1:]
    k = cfg["kernel_size"]
    return out + [(out[-1] + 2 * (k // 2) - k) // 2 + 1]


def pair5_launches(cfg: dict, batch: int) -> List[Dict[str, int]]:
    """One dict a launch of the 5x5 head-pair kernel of a forward."""
    nc, hs = cfg["neck_channels"], sides(cfg)
    heads = [dict(batch=batch, c=nc, cout=nc, h=h) for h in hs for _ in (0, 1)]
    shortcuts = [dict(batch=batch, c=2 * nc, cout=nc, h=h)
                 for h in (hs[1], hs[0], hs[1], hs[2])]
    return heads + shortcuts


def pair5_cost(ln: Dict[str, int], dtype: str):
    """(operations, bytes) of one 5x5 pair launch."""
    b, c, cout, h = ln["batch"], ln["c"], ln["cout"], ln["h"]
    act, px = counts.DTYPE_BYTES[dtype], b * h * h
    flops = px * (2 * 25 * c + 2 * c * cout)
    nbytes = (px * (c + cout) * act + c * cout * act
              + (25 * c + c + cout) * 4)
    return flops, nbytes


def pair5_least_s(cfg: dict, batch: int, dtype: str) -> float:
    """Least seconds of a forward's twelve 5x5 pair launches, summed."""
    return sum(counts.least_s(*pair5_cost(ln, dtype), dtype)
               for ln in pair5_launches(cfg, batch))


def _dwconv(n: int, cin: int, cout: int, k: int, stride: int) -> int:
    return (_conv(n, cin, cin, k, stride, groups=cin, act_flops=LEAKY)
            + _conv(conv_out(n, stride), cin, cout, 1, 1, act_flops=LEAKY))


def _ghost(n: int, cin: int, cout: int, act: int) -> int:
    half = (cout + 1) // 2
    return (_conv(n, cin, half, 1, 1, act_flops=act)
            + _conv(n, half, half, 3, 1, groups=half, act_flops=act))


def _bottleneck(n: int, cin: int, cout: int, k: int) -> int:
    shortcut = (_conv(n, cin, cin, k, 1, groups=cin)
                + _conv(n, cin, cout, 1, 1))
    return (_ghost(n, cin, cout, LEAKY) + _ghost(n, cout, cout, 0)
            + shortcut + cout * n * n)  # the residual sum


def model_flops(cfg: dict) -> int:
    """FLOPs of one image's folded inference forward (no postprocess)."""
    widths, s = cfg["backbone_channels"], cfg["img_size"]
    nc, k = cfg["neck_channels"], cfg["kernel_size"]
    total = _conv(s, 3, widths[0], 3, 2, act_flops=LEAKY)
    pooled = conv_out(conv_out(s, 2), 2)
    total += 8 * widths[0] * pooled * pooled
    for ln in counts.stage_launches(cfg, 1):
        cin, c2, h = ln["cin"], ln["c2"], ln["h"]
        if ln["stride"] == 2:
            total += _conv(h, cin, cin, 3, 2, groups=cin)
            total += _conv(ln["ho"], cin, c2, 1, 1, act_flops=LEAKY)
            total += _conv(h, cin, c2, 1, 1, act_flops=LEAKY)
            total += _conv(h, c2, c2, 3, 2, groups=c2)
        else:
            total += _conv(h, c2, c2, 1, 1, act_flops=LEAKY)
            total += _conv(h, c2, c2, 3, 1, groups=c2)
        total += _conv(ln["ho"], c2, c2, 1, 1, act_flops=LEAKY)
    hs = sides(cfg)
    for cin, h in zip(widths[1:4], hs):  # reduce layers
        total += _conv(h, cin, nc, 1, 1, act_flops=LEAKY)
    for h in (hs[1], hs[0]):  # top-down
        total += _bottleneck(h, 2 * nc, nc, k)
    for lo, h in ((hs[0], hs[1]), (hs[1], hs[2])):  # bottom-up
        total += _dwconv(lo, nc, nc, k, 2) + _bottleneck(h, 2 * nc, nc, k)
    total += 2 * _dwconv(hs[2], nc, nc, k, 2) + nc * hs[3] ** 2  # extra
    out = cfg["num_classes"] + 4 * (cfg["reg_max"] + 1)
    for h in hs:
        total += 2 * _dwconv(h, nc, nc, k, 1) + _conv(h, nc, out, 1, 1)
    return total
