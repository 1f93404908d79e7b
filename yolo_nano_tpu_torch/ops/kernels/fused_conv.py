"""Fused depthwise-k×k → act → pointwise-1×1 → act, k 3 or 5: two CUDA
kernels, `csrc/fused_dw_pw.cu` (f32) and `csrc/fused_dw_pw_bf16.cu` (bf16),
and their plain PyTorch version.

Same function as the JAX package's Pallas `fused_dw_pw` (k = 3):
    out = act_out(act_mid(dwk×k(x, pad (k−1)/2) + dw_b) @ pw_w + pw_b)
with the depthwise taps summed in f32, the pointwise product taken in x's
dtype with f32 accumulation, and the output in x's dtype. At k = 3 it runs
the two dw→pw pairs of every YOLO-Nano head on a folded model; at k = 5
NanoDet-Plus's stride-1 pairs (two a head, and each GhostBottleneck's
shortcut, which has no activation). The depthwise size is a compile-time
parameter of both kernels: each size is a kernel of its own, with its own
tile rule and device symbol (`fused_dw_pw5_kernel`,
`fused_dw_pw5_bf16_kernel` at k = 5); the C exports take k as an
argument.

Both kernels run the pointwise product on the tensor cores with the
weights resident in shared memory, and prefetch the next tile's input
region while the current tile computes. The f32 kernel takes 3×TF32
`mma.sync` (`csrc/mma_tf32.cuh`), one persistent block per SM, and sums in
another order than cuDNN: within 1e-4·max|ref| + 1e-5 of the plain version.
The bf16 kernel keeps bf16 in shared memory and takes native bf16
`mma.sync` (`csrc/mma_bf16.cuh`), two persistent blocks per SM; it rounds
where the plain version rounds, each from its own f32 sum order: within an
ulp of max|ref| and nearly all bit-equal. Each kernel picks its own output
tile (`tile_shape`).

Layouts: x is [B, C, H, W] in channels_last memory (NHWC bytes); the weights
keep the JAX kernel's layouts: dw_w [k, k, C] f32, dw_b [C] f32,
pw_w [C, Cout] in x's dtype, pw_b [Cout] f32. The kernels zero-pad the
pointwise weights in shared memory (the bf16 one transposes them there), so
any C and Cout up to 512 whose weights fit there are taken as they are;
where they do not fit (f32 at k = 5, C = 256), the f32 kernel streams them
from device memory and then takes C and Cout that are multiples of 8.

A call is one call of the PyTorch operator `torch.ops.yolo_nano_torch.dw_pw`:
its CPU implementation is the plain version, its CUDA implementation the
kernel, and its fake one gives the output's shape for tracing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from yolo_nano_tpu_torch.ops.kernels.build import check, load
from yolo_nano_tpu_torch.ops.kernels.fused_stage import round_to
from yolo_nano_tpu_torch.ops.nn import activate

ACT_CODES = {None: 0, "relu": 1, "leaky": 2}
ACT_NAMES = {v: k for k, v in ACT_CODES.items()}
# each dtype's kernel source (a library of its own), also the prefix of its
# tile rule and layout, <source>_tile and <source>_smem_bytes; and the
# symbol that launches it. Each takes the depthwise size k.
_SOURCES = {torch.float32: "fused_dw_pw", torch.bfloat16: "fused_dw_pw_bf16"}
_LAUNCH = {torch.float32: "fused_dw_pw_f32",
           torch.bfloat16: "fused_dw_pw_bf16"}
KERNEL_SIZES = (3, 5)
# f32: the gemm's 16 warps cover at most 64 n8 tiles; bf16: 8 warps of at
# most 8 n8 tiles (4 up to Cout = 256)
COUT_MAX = 512


def fused_dw_pw_plain(x, dw_w, dw_b, pw_w, pw_b, *,
                      act_mid: Optional[str] = "leaky",
                      act_out: Optional[str] = "leaky",
                      wide=None) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle. Each op
    is computed in `wide` (by default f32, f64 for f64 x) and rounded to
    x's dtype where the function rounds: the mid activation and the
    pointwise weights (the product's operands), and the output.
    chip_smoke.py runs a bf16 pair with wide = f64 as the witness of its
    sums: nearly exact sums, rounded where the function rounds."""
    dt = x.dtype
    wide = wide or torch.promote_types(dt, torch.float32)
    c = x.shape[1]
    y = F.conv2d(x.to(wide), dw_w.to(wide).permute(2, 0, 1).unsqueeze(1),
                 dw_b.to(wide), padding=(dw_w.shape[0] - 1) // 2, groups=c)
    y = round_to(activate(y, act_mid), dt).to(wide)
    w = round_to(pw_w, dt).to(wide).t()[:, :, None, None]
    y = activate(F.conv2d(y, w, pw_b.to(wide)), act_out)
    return round_to(y, dt).contiguous(memory_format=torch.channels_last)


def _check(x, dw_w, dw_b, pw_w, pw_b):
    if x.dim() != 4 or x.dtype not in _SOURCES:
        raise ValueError(f"x must be [B,C,H,W] f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    cout = pw_w.shape[-1]
    k = dw_w.shape[0] if dw_w.dim() == 3 else 0
    if k not in KERNEL_SIZES:
        raise ValueError(f"dw_w must be [k,k,C] with k in {KERNEL_SIZES}, got "
                         f"{tuple(dw_w.shape)}")
    want = {"dw_w": ((k, k, c), torch.float32), "dw_b": ((c,), torch.float32),
            "pw_w": ((c, cout), x.dtype), "pw_b": ((cout,), torch.float32)}
    for name, t in (("dw_w", dw_w), ("dw_b", dw_b), ("pw_w", pw_w),
                    ("pw_b", pw_b)):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@functools.lru_cache(maxsize=None)
def _lib(dtype=torch.float32):
    """The built kernel of a dtype, both depthwise sizes: `_LAUNCH[dtype]`
    launches it; <source>_tile and <source>_smem_bytes are its tile rules
    and shared-memory layouts, computed on the host. The bf16 kernel also
    exports <source>_blocks_per_sm, the occupancy its tile rule weighs.
    Each takes k after the shape."""
    source = _SOURCES[dtype]
    lib = load(source)
    fn = getattr(lib, _LAUNCH[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    getattr(lib, source + "_tile").argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    getattr(lib, source + "_tile").restype = ctypes.c_int
    getattr(lib, source + "_smem_bytes").argtypes = [ctypes.c_int] * 5
    getattr(lib, source + "_smem_bytes").restype = ctypes.c_size_t
    if dtype == torch.bfloat16:
        lib.fused_dw_pw_bf16_blocks_per_sm.argtypes = [ctypes.c_int] * 5
        lib.fused_dw_pw_bf16_blocks_per_sm.restype = ctypes.c_int
    return lib


def smem_bytes(tw: int, th: int, c: int, cout: int, dtype,
               k: int = 3) -> int:
    """Shared memory of one block of the dtype's kernel at this tile and
    depthwise size."""
    return getattr(_lib(dtype), _SOURCES[dtype] + "_smem_bytes")(
        tw, th, c, cout, k)


@functools.lru_cache(maxsize=None)
def tile_shape(batch: int, h: int, w: int, c: int, cout: int,
               elem_bytes: int, k: int = 3) -> Tuple[int, int]:
    """(columns, rows) of the output tile of the kernel of this element
    size and depthwise size, as its tile rule picks it among the tiles
    whose shared memory fits: f32, fused_dw_pw_tile (csrc/fused_dw_pw.cu:
    gemm rounds, region cells and tiles per SM); bf16, fused_dw_pw_bf16_tile
    (csrc/fused_dw_pw_bf16.cu: the same with the blocks an SM holds), each
    with its own cost model at k = 5.
    chip_smoke.py --sweep-dw-pw-tiles times tiles against the k = 3
    rules."""
    dtype = {4: torch.float32, 2: torch.bfloat16}[elem_bytes]
    tw, th = ctypes.c_int(), ctypes.c_int()
    rule = getattr(_lib(dtype), _SOURCES[dtype] + "_tile")
    if not rule(batch, h, w, c, cout, k, ctypes.byref(tw), ctypes.byref(th)):
        raise ValueError(f"fused_dw_pw: the weights of C {c}, Cout {cout} "
                         f"and the smallest tile do not fit in shared memory")
    return tw.value, th.value


def _launch(x, dw_w, dw_b, pw_w, pw_b, act_mid, act_out, tile=None):
    """One launch on CUDA tensors, at `tile` = (columns, rows) or the
    kernel's own pick."""
    b, c, h, w = x.shape
    cout = pw_w.shape[1]
    k = dw_w.shape[0]
    if cout > COUT_MAX:
        raise ValueError(f"the fused_dw_pw kernel takes Cout up to "
                         f"{COUT_MAX}, got {cout}")
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if tile is None:
        tile = tile_shape(b, h, w, c, cout, x.element_size(), k)
    fn = getattr(_lib(x.dtype), _LAUNCH[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
             pw_b.data_ptr(), out.data_ptr(), b, h, w, c, cout, k,
             ACT_CODES[act_mid], ACT_CODES[act_out], *tile, stream)
    fused_dw_pw.launches += 1
    if x.dtype == torch.bfloat16:
        fused_dw_pw.launches_bf16 += 1
    if k == 5:
        fused_dw_pw.launches_k5 += 1
    check(err, "fused_dw_pw")
    return out


# The dw→pw pair as a PyTorch operator: the plain version on the CPU, the
# kernel of x's dtype on CUDA, and a fake for tracing, so that a graph
# exported by torch.export (serving.export_graph) holds the operator and
# runs the kernel wherever it is replayed on the card. The activations are
# `ACT_CODES`. Registered on the dispatch keys, as `fused_stage.py`'s.

def dw_pw_plain(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor,
                pw_w: torch.Tensor, pw_b: torch.Tensor, act_mid: int,
                act_out: int) -> torch.Tensor:
    """The operator's plain version (its CPU implementation)."""
    return fused_dw_pw_plain(x, dw_w, dw_b, pw_w, pw_b,
                             act_mid=ACT_NAMES[act_mid],
                             act_out=ACT_NAMES[act_out])


def _dw_pw_cuda(x, dw_w, dw_b, pw_w, pw_b, act_mid, act_out):
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous")
    for t in (dw_w, dw_b, pw_w, pw_b):
        if not t.is_contiguous():
            raise ValueError("weights must be contiguous")
    return _launch(x, dw_w, dw_b, pw_w, pw_b, ACT_NAMES[act_mid],
                   ACT_NAMES[act_out])


def _dw_pw_fake(x, dw_w, dw_b, pw_w, pw_b, act_mid, act_out):
    b, _, h, w = x.shape
    return torch.empty((b, pw_w.shape[1], h, w), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


_LIB = torch.library.Library("yolo_nano_torch", "FRAGMENT")
_LIB.define("dw_pw(Tensor x, Tensor dw_w, Tensor dw_b, Tensor pw_w, "
            "Tensor pw_b, int act_mid, int act_out) -> Tensor")
_LIB.impl("dw_pw", dw_pw_plain, "CPU")
_LIB.impl("dw_pw", _dw_pw_cuda, "CUDA")
torch.library.register_fake("yolo_nano_torch::dw_pw", _dw_pw_fake, lib=_LIB)


def fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b, *,
                act_mid: Optional[str] = "leaky",
                act_out: Optional[str] = "leaky") -> torch.Tensor:
    """x [B,C,H,W] channels_last → [B,Cout,H,W] channels_last, x's dtype;
    the depthwise size is dw_w's, 3 or 5.

    One call of the operator `yolo_nano_torch::dw_pw`: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel of its dtype and
    depthwise size (and counts the launch in `fused_dw_pw.launches`, a bf16
    one also in `fused_dw_pw.launches_bf16`, a 5×5 one in
    `fused_dw_pw.launches_k5`) or raises."""
    _check(x, dw_w, dw_b, pw_w, pw_b)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dw_pw runs on CPU or CUDA, not {x.device}")
    return torch.ops.yolo_nano_torch.dw_pw.default(
        x, dw_w, dw_b, pw_w, pw_b, ACT_CODES[act_mid], ACT_CODES[act_out])


fused_dw_pw.launches = 0
fused_dw_pw.launches_bf16 = 0
fused_dw_pw.launches_k5 = 0
