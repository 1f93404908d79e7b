"""One ShuffleNetV2 stage on folded weights: the CUDA kernels
`csrc/fused_stage.cu` (f32) and `csrc/fused_stage_bf16.cu` (bf16), one
launch per block, and their plain PyTorch version.

Same function as the JAX package's Pallas `fused_stage`
(`ops/pallas/fused_stage.py`): a stride-2 block (two downsampling branches,
concat, shuffle g=2), then n stride-1 blocks (channel split, right half
through pw+ReLU → dw3×3 → pw+ReLU, concat, shuffle). Concat + shuffle is
the interleave out[2j] = left[j], out[2j+1] = right[j].

x is f32 or bf16, and the output is in x's dtype. In bf16 every op rounds
where the Pallas kernel rounds (`_mm`, `_dw3x3`), and nowhere else: a
pointwise multiplies bf16 operands (the weights rounded to bf16) with f32
products and sums, adds the f32 bias, applies ReLU and rounds to bf16; a
depthwise sums its f32 taps on the bf16 inputs from the f32 bias and rounds
to bf16. Concat and shuffle are exact.

`prepare_stage` only reshapes a folded stage's weights into the kernels'
layouts: pointwise [Cin, Cout], depthwise [9, C] (tap-major), biases [C],
all f32 and contiguous (bf16 weights widen to f32 exactly, as the Pallas
kernel's `_pw`/`_dw` widen them). The f32 kernel (`csrc/fused_stage.cu`)
takes each pointwise weight zero-padded to multiples of 8 rows and columns
(`*_pad`, the m16n8k8 products' K and N). The bf16 kernel
(`csrc/fused_stage_bf16.cu`) takes it rounded to bf16 (to nearest even, as
the Pallas kernel's `_mm` rounds it; exact on bf16 weights), transposed and
zero-padded to [round8(Cout)][round16(Cin)] (`*_bf16`, the m16n8k16
products' N and K). The plain version takes the weights as they are. x is
[B, C, H, W] in channels_last memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch
import torch.nn.functional as F

from yolo_nano_tpu_torch.ops.kernels.build import check, load
from yolo_nano_tpu_torch.ops.nn import channel_shuffle

# the kernels' weight arguments, in the order of shuffle_block_{f32,bf16}
_WEIGHTS = {torch.float32: ("pw1_w_pad", "pw1_b", "dw_w", "dw_b", "pw2_w_pad",
                            "pw2_b", "b1dw_w", "b1dw_b", "b1pw_w_pad",
                            "b1pw_b"),
            torch.bfloat16: ("pw1_w_bf16", "pw1_b", "dw_w", "dw_b",
                             "pw2_w_bf16", "pw2_b", "b1dw_w", "b1dw_b",
                             "b1pw_w_bf16", "b1pw_b")}
# source, launch symbol and tile-rule prefix of each dtype's kernel
_KERNELS = {torch.float32: ("fused_stage", "shuffle_block_f32",
                            "shuffle_block"),
            torch.bfloat16: ("fused_stage_bf16", "shuffle_block_bf16",
                             "shuffle_block_bf16")}
# the widest c2 of each kernel: f32, 16 warps of at most 4 n8 tiles; bf16,
# 8 warps of at most 4 n8 tiles up to c2 = 256 and 8 above (its wide
# variant, stage 4 at 1.5x and 2.0x)
C2_MAX = {torch.float32: 512, torch.bfloat16: 512}


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pad_pw(w: torch.Tensor) -> torch.Tensor:
    """[K, N] pointwise weight → [round8(K), round8(N)], zeros appended."""
    k, n = w.shape
    out = w.new_zeros(_round_up(k, 8), _round_up(n, 8))
    out[:k, :n] = w
    return out


def _pad_pw_bf16(w: torch.Tensor) -> torch.Tensor:
    """[K, N] pointwise weight → bf16 [round8(N), round16(K)], transposed,
    zeros appended."""
    k, n = w.shape
    out = torch.zeros(_round_up(n, 8), _round_up(k, 16), dtype=torch.bfloat16,
                      device=w.device)
    out[:n, :k] = w.t()
    return out


def _pw(unit) -> tuple:
    """Folded 1×1 unit → (w [Cin, Cout], b [Cout])."""
    return (unit.weight[:, :, 0, 0].t().float().contiguous(),
            unit.bias.float().contiguous())


def _dw(unit) -> tuple:
    """Folded depthwise 3×3 unit → (w [9, C], b [C])."""
    c = unit.weight.shape[0]
    return (unit.weight.reshape(c, 9).t().float().contiguous(),
            unit.bias.float().contiguous())


def prepare_stage(blocks) -> List[Dict[str, torch.Tensor]]:
    """A folded stage (models.shufflenetv2.ShuffleStage: a stride-2 block,
    then stride-1 blocks) → one dict of kernel-layout weights per block."""
    out = []
    for i, blk in enumerate(blocks):
        if (blk.branch1 is not None) != (i == 0):
            raise ValueError("a stage is one stride-2 block, then stride-1 "
                             "blocks")
        b2 = blk.branch2
        if any(u.has_bn for u in b2.values()):
            raise ValueError("fused_stage takes a BN-folded stage")
        w = {"stride": 2 if i == 0 else 1}
        w["pw1_w"], w["pw1_b"] = _pw(b2["pw1"])
        w["dw_w"], w["dw_b"] = _dw(b2["dw"])
        w["pw2_w"], w["pw2_b"] = _pw(b2["pw2"])
        if i == 0:
            w["b1dw_w"], w["b1dw_b"] = _dw(blk.branch1["dw"])
            w["b1pw_w"], w["b1pw_b"] = _pw(blk.branch1["pw"])
        for name in ("pw1_w", "pw2_w", "b1pw_w"):
            if name in w:
                w[name + "_pad"] = _pad_pw(w[name])
                w[name + "_bf16"] = _pad_pw_bf16(w[name])
        out.append(w)
    return out


def round_to(v: torch.Tensor, dt) -> torch.Tensor:
    """v rounded to dt once, to nearest even. PyTorch casts f64 to bf16
    through f32, which rounds twice; rounding to odd in f32 first (toward
    zero, the last bit set if inexact) makes the second rounding exact."""
    if v.dtype == torch.float64 and dt == torch.bfloat16:
        f = v.float()
        f = torch.where(f.double().abs() > v.abs(),
                        torch.nextafter(f, torch.zeros_like(f)), f)
        v = (f.view(torch.int32) | (f.double() != v).int()).view(
            torch.float32)
    return v.to(dt)


def _pw_plain(x, w, b, dt):
    """relu(x @ w + b), the operands rounded to dt and summed in x's dtype
    (f32 or wider), the output rounded to dt."""
    w = round_to(w, dt).to(x.dtype)
    return round_to(torch.relu(F.conv2d(x, w.t()[:, :, None, None],
                                        b.to(x.dtype))), dt)


def _dw_plain(x, w, b, stride, dt):
    c = w.shape[1]
    return round_to(F.conv2d(x, w.t().reshape(c, 1, 3, 3).to(x.dtype),
                             b.to(x.dtype), stride=stride, padding=1,
                             groups=c), dt)


def block_plain(x: torch.Tensor, w: Dict[str, torch.Tensor],
                wide=None) -> torch.Tensor:
    """One ShuffleV2 block from kernel-layout weights, in plain PyTorch: the
    output in x's dtype, each op computed in `wide` (by default f32, f64
    for f64 x) on inputs rounded to x's dtype and rounded to it once.
    chip_smoke.py runs a bf16 block with wide = f64 as the witness of its
    sums: nearly exact sums, rounded where the function rounds."""
    dt = x.dtype
    wide = wide or torch.promote_types(dt, torch.float32)
    xw = x.to(wide)
    if w["stride"] == 2:
        even = _pw_plain(_dw_plain(xw, w["b1dw_w"], w["b1dw_b"], 2,
                                   dt).to(wide), w["b1pw_w"], w["b1pw_b"], dt)
        right = xw
    else:
        c2 = x.shape[1] // 2
        even, right = x[:, :c2], xw[:, c2:]
    t = _pw_plain(right, w["pw1_w"], w["pw1_b"], dt).to(wide)
    t = _dw_plain(t, w["dw_w"], w["dw_b"], w["stride"], dt).to(wide)
    odd = _pw_plain(t, w["pw2_w"], w["pw2_b"], dt)
    return channel_shuffle(torch.cat([even, odd], 1), 2)


def fused_stage_plain(x: torch.Tensor, blocks) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle."""
    for w in blocks:
        x = block_plain(x, w)
    return x


@functools.lru_cache(maxsize=None)
def _lib(dtype=torch.float32):
    """The built kernel of a dtype: shuffle_block_{f32,bf16} launch one
    block; <prefix>_tile and <prefix>_smem_bytes are its tile rule and
    shared-memory layout, computed on the host (`_KERNELS` gives the
    prefix). The bf16 kernel also exports shuffle_block_bf16_blocks_per_sm,
    the occupancy its tile rule weighs."""
    source, sym, prefix = _KERNELS[dtype]
    lib = load(source)
    fn = getattr(lib, sym)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    getattr(lib, prefix + "_tile").argtypes = [ctypes.c_int] * 6
    getattr(lib, prefix + "_tile").restype = ctypes.c_int
    getattr(lib, prefix + "_smem_bytes").argtypes = [ctypes.c_int] * 4
    getattr(lib, prefix + "_smem_bytes").restype = ctypes.c_size_t
    if dtype == torch.bfloat16:
        lib.shuffle_block_bf16_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.shuffle_block_bf16_blocks_per_sm.restype = ctypes.c_int
    return lib


def smem_bytes(tile: int, stride: int, cin: int, c2: int,
               dtype=torch.float32) -> int:
    """Shared memory of one thread block of a dtype's kernel."""
    return getattr(_lib(dtype), _KERNELS[dtype][2] + "_smem_bytes")(
        tile, stride, cin, c2)


@functools.lru_cache(maxsize=None)
def block_tile(stride: int, cin: int, c2: int, batch: int, ho: int,
               wo: int, dtype=torch.float32) -> int:
    """Output tile side of one block launch, as the dtype's kernel picks it
    (shuffle_block_tile in csrc/fused_stage.cu, shuffle_block_bf16_tile in
    csrc/fused_stage_bf16.cu: cost models of the products and the waves of
    blocks, among the sides whose shared memory fits). chip_smoke.py
    --sweep-stage-tiles times every side against them."""
    tile = getattr(_lib(dtype), _KERNELS[dtype][2] + "_tile")(
        stride, cin, c2, batch, ho, wo)
    if tile < 1:
        raise ValueError(f"no tile of a stride-{stride} block with Cin {cin}, "
                         f"c2 {c2} fits in shared memory")
    return tile


def _launch_block(lib, x, w, tile=None):
    """One block launch of x's dtype; lib is `_lib(x.dtype)`."""
    b, cin, h, wd = x.shape
    c2 = w["pw1_w"].shape[1]
    k1 = cin if w["stride"] == 2 else cin // 2
    c2_max = C2_MAX[x.dtype]
    if c2 > c2_max or c2 % 2:
        raise ValueError(f"the stage kernel takes an even c2 up to {c2_max}, "
                         f"got {c2}")
    if w["stride"] == 1 and cin != 2 * c2:
        raise ValueError(f"stride-1 block needs Cin = 2·{c2}, got {cin}")
    if w["pw1_w"].shape[0] != k1:
        raise ValueError(f"pw1 takes {w['pw1_w'].shape[0]} channels, x "
                         f"gives {k1}")
    s = w["stride"]
    ho, wo = (h - 1) // s + 1, (wd - 1) // s + 1
    if tile is None:
        tile = block_tile(s, cin, c2, b, ho, wo, x.dtype)
    out = torch.empty((b, 2 * c2, ho, wo),
                      dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    ptrs = []
    for name in _WEIGHTS[x.dtype]:
        t = w.get(name)
        if t is None:  # the stride-1 block has no branch1
            ptrs.append(None)
            continue
        dt = torch.bfloat16 if name.endswith("_bf16") else torch.float32
        if (t.device != x.device or t.dtype != dt
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous 16-byte aligned "
                             f"{str(dt)[6:]} on {x.device}")
        ptrs.append(t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _KERNELS[x.dtype][1])(x.data_ptr(), out.data_ptr(), b,
                                             h, wd, cin, c2, s, tile, *ptrs,
                                             stream)
    fused_stage.launches += 1
    if x.dtype == torch.bfloat16:
        fused_stage.launches_bf16 += 1
    check(err, "fused_stage block")
    return out


def fused_stage(x: torch.Tensor, blocks) -> torch.Tensor:
    """Run a whole stage: x [B,Cin,H,W] f32 or bf16 → [B,Cout,⌈H/2⌉,⌈W/2⌉]
    in x's dtype, channels_last.

    `blocks` is `prepare_stage`'s list. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel of its dtype once per block
    (counted in `fused_stage.launches`, the bf16 ones also in
    `fused_stage.launches_bf16`; `fused_stage.calls` counts stages) or
    raises."""
    if x.dim() != 4 or x.dtype not in _KERNELS:
        raise ValueError(f"x must be [B,C,H,W] f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return fused_stage_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage runs on CPU or CUDA, not {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous")
    lib = _lib(x.dtype)
    fused_stage.calls += 1
    for w in blocks:
        x = _launch_block(lib, x, w)
    return x


fused_stage.calls = 0
fused_stage.launches = 0
fused_stage.launches_bf16 = 0
