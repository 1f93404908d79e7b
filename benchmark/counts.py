"""The yardstick's arithmetic: the H100's peaks, the operations and bytes of
each launch of the detector's two hand kernels, and the model's FLOPs, all
from the shapes of a configuration.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 3.35 TB/s
of HBM3; 989 TFLOP/s bf16 on the tensor cores; float32 computed as three
TF32 products (the f32 kernels' 3xTF32 `mma.sync`) at 495 / 3 TFLOP/s.

A function's least time is the larger of its bytes over the HBM rate and
its operations over the dtype's rate. Bytes count each input read once and
each output written once: the activations in and out of the function, and
its weights as the kernels take them (pointwise weights in the activation
dtype, depthwise weights and every bias in f32). Operations are 2 a
multiply-add of each 1x1 and 3x3 depthwise convolution. The function is a
whole ShuffleNetV2 stage (the stage's input and output, every block's
weights and operations), as the TPU's `fused_stage` computes it in one
call: the activations between the blocks of a stage need not reach HBM,
so a kernel that fuses a stage may run at this bound. A head pair (dw 3x3
then 1x1) is one function.

The model's FLOPs follow XLA's cost analysis, as the repository's count
does: 2 a multiply-add for every convolution tap inside the image, 1 an
output element for a bias add, a ReLU or a sum, 3 for a leaky ReLU
(compare, scale, select), 8 for a 3x3 max-pool output; moving data is free.
"""

from __future__ import annotations

from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
STAGE_REPEATS = (4, 8, 4)


def conv_out(n: int, stride: int) -> int:
    """Output side of a 3x3 (or 1x1) convolution with pad (k - 1) // 2."""
    return (n - 1) // stride + 1


def taps(n: int, k: int, stride: int, pad: int, out: int) -> int:
    """Kernel taps inside [0, n), summed over the outputs of one axis."""
    return sum(min(k, n + pad - i * stride) - max(0, pad - i * stride)
               for i in range(out))


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def stage_launches(cfg: dict, batch: int) -> List[Dict[str, int]]:
    """One dict a ShuffleV2 block of a forward, as the port launches the
    stage kernel: stride, in channels, c2 (half the out channels), sides."""
    widths = cfg["backbone_channels"]
    side = conv_out(conv_out(cfg["img_size"], 2), 2)  # stem, max-pool
    cin, out = widths[0], []
    for repeats, cout in zip(STAGE_REPEATS, widths[1:4]):
        for j in range(repeats):
            stride = 2 if j == 0 else 1
            ho = conv_out(side, stride)
            out.append(dict(batch=batch, stride=stride, cin=cin,
                            c2=cout // 2, h=side, ho=ho))
            cin, side = cout, ho
    return out


def stages(cfg: dict, batch: int) -> List[List[Dict[str, int]]]:
    """The blocks of `stage_launches`, stage by stage."""
    blocks, out = stage_launches(cfg, batch), []
    for repeats in STAGE_REPEATS:
        out.append(blocks[:repeats])
        blocks = blocks[repeats:]
    return out


def block_cost(ln: Dict[str, int], dtype: str):
    """(operations, weight bytes) of one ShuffleV2 block."""
    b, cin, c2, h = ln["batch"], ln["cin"], ln["c2"], ln["h"]
    act, f32 = DTYPE_BYTES[dtype], 4
    if ln["stride"] == 2:
        pi, po = b * h * h, b * ln["ho"] * ln["ho"]
        flops = (po * 2 * 9 * cin + po * 2 * cin * c2       # branch 1
                 + pi * 2 * cin * c2 + po * (2 * 9 * c2 + 2 * c2 * c2))
        weights = ((cin * c2 + c2 * c2 + cin * c2) * act
                   + (9 * cin + cin + 9 * c2 + 3 * c2 + c2) * f32)
    else:
        flops = b * h * h * (4 * c2 * c2 + 2 * 9 * c2)
        weights = 2 * c2 * c2 * act + (9 * c2 + 3 * c2) * f32
    return flops, weights


def stage_cost(blocks: List[Dict[str, int]], dtype: str):
    """(operations, bytes) of one stage: its input and output activations
    once, every block's weights and operations."""
    first, last = blocks[0], blocks[-1]
    costs = [block_cost(ln, dtype) for ln in blocks]
    acts = (first["batch"] * first["h"] ** 2 * first["cin"]
            + last["batch"] * last["ho"] ** 2 * 2 * last["c2"])
    return (sum(f for f, _ in costs),
            acts * DTYPE_BYTES[dtype] + sum(w for _, w in costs))


def head_pair_launches(cfg: dict, batch: int) -> List[Dict[str, int]]:
    """One dict a launch of the head-pair kernel (dw3x3 -> 1x1): two in
    each of the three heads, at strides 8, 16, 32."""
    c = cfg["neck_channels"]
    return [dict(batch=batch, c=c, cout=c, h=cfg["img_size"] // s)
            for s in cfg["strides"] for _ in range(2)]


def head_pair_cost(ln: Dict[str, int], dtype: str):
    """(operations, bytes) of one head-pair launch."""
    b, c, cout, h = ln["batch"], ln["c"], ln["cout"], ln["h"]
    act, px = DTYPE_BYTES[dtype], b * h * h
    flops = px * (2 * 9 * c + 2 * c * cout)
    nbytes = (px * (c + cout) * act + c * cout * act
              + (9 * c + c + cout) * 4)
    return flops, nbytes


def stage_least_s(cfg: dict, batch: int, dtype: str) -> float:
    """Least seconds of a forward's three stages, summed."""
    return sum(least_s(*stage_cost(blocks, dtype), dtype)
               for blocks in stages(cfg, batch))


def head_pair_least_s(cfg: dict, batch: int, dtype: str) -> float:
    """Least seconds of a forward's head-pair launches, summed."""
    return sum(least_s(*head_pair_cost(ln, dtype), dtype)
               for ln in head_pair_launches(cfg, batch))


def _conv(n: int, cin: int, cout: int, k: int, stride: int, groups: int = 1,
          act_flops: int = 0) -> int:
    """XLA-style FLOPs of a conv with bias (and activation) on an n x n
    input, one image."""
    o = conv_out(n, stride)
    t = taps(n, k, stride, (k - 1) // 2, o)
    return 2 * cout * (cin // groups) * t * t + (1 + act_flops) * cout * o * o


def model_flops(cfg: dict) -> int:
    """FLOPs of one image's folded inference forward (no postprocess)."""
    relu, leaky = 1, 3
    widths, nc, s = cfg["backbone_channels"], cfg["neck_channels"], \
        cfg["img_size"]
    total = _conv(s, 3, widths[0], 3, 2, act_flops=relu)
    side = conv_out(s, 2)
    pooled = conv_out(side, 2)
    total += 8 * widths[0] * pooled * pooled
    for ln in stage_launches(cfg, 1):
        cin, c2, h = ln["cin"], ln["c2"], ln["h"]
        if ln["stride"] == 2:
            total += _conv(h, cin, cin, 3, 2, groups=cin)
            total += _conv(ln["ho"], cin, c2, 1, 1, act_flops=relu)
            total += _conv(h, cin, c2, 1, 1, act_flops=relu)
            total += _conv(h, c2, c2, 3, 2, groups=c2)
        else:
            total += _conv(h, c2, c2, 1, 1, act_flops=relu)
            total += _conv(h, c2, c2, 3, 1, groups=c2)
        total += _conv(ln["ho"], c2, c2, 1, 1, act_flops=relu)
    sides = [s // st for st in cfg["strides"]]
    for cin, h in zip(widths[1:4], sides):  # laterals
        total += _conv(h, cin, nc, 1, 1, act_flops=leaky)
    for h in (sides[1], sides[0], sides[1], sides[2]):  # add, then 3x3
        total += nc * h * h + _conv(h, nc, nc, 3, 1, act_flops=leaky)
    out = len(cfg["anchors"]) // len(cfg["strides"]) * (
        1 + cfg["num_classes"] + 4)
    for h in sides:
        for _ in range(2):
            total += _conv(h, nc, nc, 3, 1, groups=nc, act_flops=leaky)
            total += _conv(h, nc, nc, 1, 1, act_flops=leaky)
        total += _conv(h, nc, out, 1, 1)
    return total
