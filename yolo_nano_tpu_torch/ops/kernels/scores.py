"""The detector's scores: the CUDA kernel `csrc/scores.cu` and its plain
PyTorch version.

Per row of the head outputs, conf [B,N,1] and cls [B,N,C] in the model's
dtype, in f32:
    score = max_c softmax(cls) · sigmoid(conf) = exp(m − lse) · sigmoid(conf),
    lse = m + log Σ_c exp(cls_c − m),   m = max_c cls_c,
    class = argmax_c cls_c (the first index on a tie, the first NaN's where
            the row holds one).
The plain version computes it in five PyTorch passes over the logits; the
kernel reads each logit once and computes every operation in f32 in the
plain version's order, the sum in the order of PyTorch's own CUDA
reduction, so that on the card its scores and classes are the plain
version's bit for bit.

A call is one call of the PyTorch operator `torch.ops.yolo_nano_torch.
scores`: its CPU implementation is the plain version, its CUDA
implementation the kernel, and its fake one gives the outputs' shapes for
tracing, so that an exported graph holds one operator call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_nano_tpu_torch.ops.kernels.build import check, load
from yolo_nano_tpu_torch.utils.spans import span

_DTYPES = (torch.float32, torch.bfloat16)


def scores_plain(conf_pred: torch.Tensor, cls_pred: torch.Tensor):
    """The operator's plain version (its CPU implementation): conf [B,N,1],
    cls [B,N,C] → (score [B,N] f32, class [B,N] int32)."""
    obj = torch.sigmoid(conf_pred.float())[..., 0]
    logits = cls_pred.float()
    m = logits.max(-1).values
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
    score = torch.exp(m - lse) * obj
    cls = torch.argmax(logits, -1).to(torch.int32)
    return score, cls


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel: `scores` launches it; `scores_max_c` is the
    largest C it takes at an element size; `scores_plan` is its tile rule's
    pick (lanes a row, rows a tile, shared-memory bytes)."""
    lib = load("scores")
    lib.scores.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.scores.restype = ctypes.c_int
    lib.scores_max_c.argtypes = [ctypes.c_int]
    lib.scores_max_c.restype = ctypes.c_int
    lib.scores_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                ctypes.c_longlong,
                                ctypes.POINTER(ctypes.c_int)]
    lib.scores_plan.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _max_c(itemsize: int) -> int:
    return _lib().scores_max_c(itemsize)


def scores_plan(c: int, dtype: torch.dtype, rows: int) -> dict:
    """The kernel's tile rule on the current card for `rows` rows of `c`
    classes in `dtype`: lanes a row, rows a tile, the ring's bytes."""
    out = (ctypes.c_int * 3)()
    check(_lib().scores_plan(c, dtype.itemsize, rows, out), "scores_plan")
    return dict(lanes=out[0], rows=out[1], smem=out[2])


def _scores_cuda(conf_pred, cls_pred):
    b, n, c = cls_pred.shape
    score = torch.empty((b, n), dtype=torch.float32, device=cls_pred.device)
    cls = torch.empty((b, n), dtype=torch.int32, device=cls_pred.device)
    if score.numel() == 0:
        return score, cls
    if c > _max_c(cls_pred.dtype.itemsize):
        raise ValueError(f"the scores kernel takes C up to "
                         f"{_max_c(cls_pred.dtype.itemsize)} in "
                         f"{cls_pred.dtype}, got {c}")
    stream = torch.cuda.current_stream(cls_pred.device).cuda_stream
    with span("ynt.scores.kernel"):
        err = _lib().scores(conf_pred.data_ptr(), cls_pred.data_ptr(),
                            score.data_ptr(), cls.data_ptr(), b * n, c,
                            int(cls_pred.dtype == torch.bfloat16), stream)
        scores.launches += 1
        check(err, "scores")
    return score, cls


def _scores_fake(conf_pred, cls_pred):
    b, n, _ = cls_pred.shape
    return (cls_pred.new_empty((b, n), dtype=torch.float32),
            cls_pred.new_empty((b, n), dtype=torch.int32))


_LIB = torch.library.Library("yolo_nano_torch", "FRAGMENT")
_LIB.define("scores(Tensor conf, Tensor cls) -> (Tensor, Tensor)")
_LIB.impl("scores", scores_plain, "CPU")
_LIB.impl("scores", _scores_cuda, "CUDA")
torch.library.register_fake("yolo_nano_torch::scores", _scores_fake,
                            lib=_LIB)


def scores(conf_pred: torch.Tensor, cls_pred: torch.Tensor):
    """Head outputs conf [B,N,1] and cls [B,N,C], contiguous, both f32 or
    both bf16, on one device → (score [B,N] f32, class [B,N] int32).

    One call of the operator `yolo_nano_torch::scores`: a CPU tensor takes
    the plain version (`scores_plain`); a CUDA tensor launches the kernel
    (counted in `scores.launches`, under a profiler the span
    `ynt.scores.kernel`) or raises."""
    if (cls_pred.dim() != 3 or conf_pred.shape != cls_pred.shape[:2] + (1,)
            or cls_pred.shape[2] < 1):
        raise ValueError(f"scores takes conf [B, N, 1] and cls [B, N, C], "
                         f"got {tuple(conf_pred.shape)} and "
                         f"{tuple(cls_pred.shape)}")
    if cls_pred.dtype not in _DTYPES or conf_pred.dtype != cls_pred.dtype:
        raise ValueError(f"scores takes f32 or bf16 head outputs of one "
                         f"dtype, got {conf_pred.dtype} and {cls_pred.dtype}")
    if cls_pred.device.type not in ("cpu", "cuda") or (
            conf_pred.device != cls_pred.device):
        raise ValueError(f"scores runs on CPU or CUDA tensors of one device, "
                         f"got {conf_pred.device} and {cls_pred.device}")
    if not (conf_pred.is_contiguous() and cls_pred.is_contiguous()):
        raise ValueError("scores takes contiguous head outputs")
    return torch.ops.yolo_nano_torch.scores.default(conf_pred, cls_pred)


scores.launches = 0
