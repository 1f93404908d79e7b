"""Fused depthwise-3×3 → act → pointwise-1×1 → act: the CUDA kernel
`csrc/fused_dw_pw.cu` and its plain PyTorch version.

Same function as the JAX package's Pallas `fused_dw_pw`:
    out = act_out(act_mid(dw3×3(x, pad 1) + dw_b) @ pw_w + pw_b)
with the depthwise taps summed in f32, the pointwise product taken in x's
dtype with f32 accumulation, and the output in x's dtype. It runs the two
dw→pw pairs of every detection head on a folded model.

The kernel runs the pointwise product on the tensor cores (3×TF32
`mma.sync` in f32, one exact TF32 pass in bf16, `csrc/mma_tf32.cuh`) with
the weights resident in shared memory, and a persistent block per SM
prefetches the next tile's input region while the current tile computes.
It sums in another order than cuDNN: within 1e-4·max|ref| + 1e-5 of the
plain version in f32. The output tile is the kernel's own pick
(`tile_shape`).

Layouts: x is [B, C, H, W] in channels_last memory (NHWC bytes); the weights
keep the JAX kernel's layouts: dw_w [3, 3, C] f32, dw_b [C] f32,
pw_w [C, Cout] in x's dtype, pw_b [Cout] f32. The kernel zero-pads the
pointwise weights to multiples of 8 in shared memory, so any C and Cout up
to 512 whose weights fit there are taken as they are.

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
from yolo_nano_tpu_torch.ops.nn import activate

ACT_CODES = {None: 0, "relu": 1, "leaky": 2}
ACT_NAMES = {v: k for k, v in ACT_CODES.items()}
_SYMBOLS = {torch.float32: "fused_dw_pw_f32", torch.bfloat16: "fused_dw_pw_bf16"}
COUT_MAX = 512  # the gemm's 16 warps cover at most 64 n8 tiles


def fused_dw_pw_plain(x, dw_w, dw_b, pw_w, pw_b, *,
                      act_mid: Optional[str] = "leaky",
                      act_out: Optional[str] = "leaky") -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle."""
    c = x.shape[1]
    y = F.conv2d(x.float(), dw_w.permute(2, 0, 1).unsqueeze(1), dw_b,
                 padding=1, groups=c)
    y = activate(y, act_mid)
    # the pointwise product runs in x's dtype with f32 accumulation: round
    # both operands to x's dtype, then multiply-accumulate in f32
    y = y.to(x.dtype).float()
    w = pw_w.to(x.dtype).float().t()[:, :, None, None]
    y = activate(F.conv2d(y, w, pw_b), act_out)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _check(x, dw_w, dw_b, pw_w, pw_b):
    if x.dim() != 4 or x.dtype not in _SYMBOLS:
        raise ValueError(f"x must be [B,C,H,W] f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    cout = pw_w.shape[-1]
    want = {"dw_w": ((3, 3, c), torch.float32), "dw_b": ((c,), torch.float32),
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
def _lib():
    """The built kernel: fused_dw_pw_{f32,bf16} launch it;
    fused_dw_pw_tile and fused_dw_pw_smem_bytes are its tile rule and
    shared-memory layout, computed on the host."""
    lib = load("fused_dw_pw")
    for sym in _SYMBOLS.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fused_dw_pw_tile.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.fused_dw_pw_tile.restype = ctypes.c_int
    lib.fused_dw_pw_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.fused_dw_pw_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def tile_shape(batch: int, h: int, w: int, c: int, cout: int,
               elem_bytes: int) -> Tuple[int, int]:
    """(columns, rows) of the kernel's output tile, as its fused_dw_pw_tile
    picks it (csrc/fused_dw_pw.cu: a cost model of gemm rounds, region
    cells and tiles per SM, among the tiles whose shared memory fits).
    chip_smoke.py --sweep-dw-pw-tiles times tiles against it."""
    tw, th = ctypes.c_int(), ctypes.c_int()
    if not _lib().fused_dw_pw_tile(batch, h, w, c, cout, elem_bytes,
                                   ctypes.byref(tw), ctypes.byref(th)):
        raise ValueError(f"fused_dw_pw: the weights of C {c}, Cout {cout} "
                         f"and the smallest tile do not fit in shared memory")
    return tw.value, th.value


def _launch(x, dw_w, dw_b, pw_w, pw_b, act_mid, act_out, tile=None):
    """One launch on CUDA tensors, at `tile` = (columns, rows) or the
    kernel's own pick."""
    b, c, h, w = x.shape
    cout = pw_w.shape[1]
    if cout > COUT_MAX:
        raise ValueError(f"the fused_dw_pw kernel takes Cout up to "
                         f"{COUT_MAX}, got {cout}")
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    if tile is None:
        tile = tile_shape(b, h, w, c, cout, x.element_size())
    fn = getattr(_lib(), _SYMBOLS[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), pw_w.data_ptr(),
             pw_b.data_ptr(), out.data_ptr(), b, h, w, c, cout,
             ACT_CODES[act_mid], ACT_CODES[act_out], *tile, stream)
    fused_dw_pw.launches += 1
    if x.dtype == torch.bfloat16:
        fused_dw_pw.launches_bf16 += 1
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
    """x [B,C,H,W] channels_last → [B,Cout,H,W] channels_last, x's dtype.

    One call of the operator `yolo_nano_torch::dw_pw`: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel of its dtype (and
    counts the launch in `fused_dw_pw.launches`, a bf16 one also in
    `fused_dw_pw.launches_bf16`) or raises."""
    _check(x, dw_w, dw_b, pw_w, pw_b)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dw_pw runs on CPU or CUDA, not {x.device}")
    return torch.ops.yolo_nano_torch.dw_pw.default(
        x, dw_w, dw_b, pw_w, pw_b, ACT_CODES[act_mid], ACT_CODES[act_out])


fused_dw_pw.launches = 0
fused_dw_pw.launches_bf16 = 0
