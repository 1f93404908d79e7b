"""Greedy non-maximum suppression: the CUDA kernel `csrc/nms_greedy.cu`
and its plain PyTorch version.

Over candidates sorted by descending score, the keep set is the sequential
greedy
    keep_i = valid_i ∧ ¬∃ j<i : keep_j ∧ ovr(j,i) > thresh
over the K×K overlap matrix (IoU, minus the distance penalty for DIoU).
The plain version is the fixpoint iteration of that equation, as the JAX
package's `lax.while_loop` runs it: it reaches the same set (the settled
prefix grows every sweep; all images of a batch sweep together). The
kernel computes the same set in one launch with no host read, each
overlap in f32 in the plain version's order, so the keep set is the plain
version's bit for bit.

A call is one call of the PyTorch operator `torch.ops.yolo_nano_torch.
nms_greedy`: its CPU implementation is the plain version, its CUDA
implementation the kernel, and its fake one gives keep's shape for
tracing, so that an exported graph holds one operator call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_nano_tpu_torch.ops.kernels.build import check, load
from yolo_nano_tpu_torch.utils.spans import span


def _pairwise_iou(boxes):
    """IoU [..., K, K] of corner boxes (areas without +1, intersection ≥ 0)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
    return inter / (area[..., :, None] + area[..., None, :] - inter + 1e-20)


def _pairwise_diou_penalty(boxes):
    """DIoU distance penalty d²/c² [..., K, K]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    d2 = ((cx[..., :, None] - cx[..., None, :]) ** 2
          + (cy[..., :, None] - cy[..., None, :]) ** 2)
    ex1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    ey1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    ex2 = torch.maximum(x2[..., :, None], x2[..., None, :])
    ey2 = torch.maximum(y2[..., :, None], y2[..., None, :])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    return d2 / (c2 + 1e-20)


def nms_greedy_plain(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_thresh: float, diou: bool = False) -> torch.Tensor:
    """The operator's plain version (its CPU implementation): boxes
    [..., K, 4] ALREADY SORTED by descending score, valid [..., K] → keep
    [..., K].

    The sweeps carry (keep, changed) from (valid, any(valid)) and stop when
    a sweep changes no keep, as the JAX package's `lax.while_loop` does (its
    carried prev and the test against it become `changed`). JAX's second
    condition, it < K, never stops the loop: the settled prefix grows by
    one every sweep, so at the latest the (K+1)-th sweep finds no change.
    The loop runs in Python and reads the condition on the host once per
    sweep; under a profiler each read is a span `ynt.nms.wait`, each sweep
    a span `ynt.nms.sweep`."""
    k = boxes.shape[-2]
    ovr = _pairwise_iou(boxes)
    if diou:
        ovr = ovr - _pairwise_diou_penalty(boxes)
    order = torch.arange(k, device=boxes.device)
    # sup[j, i]: a kept j would suppress i (strictly lower-scored)
    sup = (ovr > iou_thresh) & (order[:, None] < order[None, :])
    keep, changed = valid, valid.any()
    while True:
        with span("ynt.nms.wait"):  # the host reads the flag off the device
            if not changed:
                break
        with span("ynt.nms.sweep"):
            new = valid & ~(sup & keep[..., :, None]).any(-2)
            keep, changed = new, (new != keep).any()
    # an operator returns no alias of its input (no candidate: keep is valid)
    return keep.clone() if keep is valid else keep


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel: `nms_greedy` launches it; `nms_greedy_max_k` is
    the largest K it takes."""
    lib = load("nms_greedy")
    lib.nms_greedy.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.nms_greedy.restype = ctypes.c_int
    lib.nms_greedy_max_k.argtypes = []
    lib.nms_greedy_max_k.restype = ctypes.c_int
    return lib


def _nms_greedy_cuda(boxes, valid, iou_thresh, diou):
    b, k = valid.shape
    keep = torch.empty_like(valid, memory_format=torch.contiguous_format)
    if keep.numel() == 0:
        return keep
    lib = _lib()
    if k > lib.nms_greedy_max_k():
        raise ValueError(f"the nms_greedy kernel takes K up to "
                         f"{lib.nms_greedy_max_k()}, got {k}")
    boxes, valid = boxes.contiguous(), valid.contiguous()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with span("ynt.nms.kernel"):
        # the threshold as the f32 that torch compares an f32 overlap with
        err = lib.nms_greedy(boxes.data_ptr(), valid.data_ptr(),
                             keep.data_ptr(), b, k, iou_thresh, int(diou),
                             stream)
        nms_greedy.launches += 1
        check(err, "nms_greedy")
    return keep


def _nms_greedy_fake(boxes, valid, iou_thresh, diou):
    return torch.empty_like(valid, memory_format=torch.contiguous_format)


_LIB = torch.library.Library("yolo_nano_torch", "FRAGMENT")
_LIB.define("nms_greedy(Tensor boxes, Tensor valid, float iou_thresh, "
            "bool diou) -> Tensor")
_LIB.impl("nms_greedy", nms_greedy_plain, "CPU")
_LIB.impl("nms_greedy", _nms_greedy_cuda, "CUDA")
torch.library.register_fake("yolo_nano_torch::nms_greedy", _nms_greedy_fake,
                            lib=_LIB)


def nms_greedy(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
               diou: bool = False) -> torch.Tensor:
    """Greedy NMS over candidates ALREADY SORTED by descending score.
    boxes [..., K, 4] f32, valid [..., K] bool → keep [..., K].

    One call of the operator `yolo_nano_torch::nms_greedy` on [B, K]: a
    CPU tensor takes the plain version (`nms_greedy_plain`); a CUDA tensor
    launches the kernel (counted in `nms_greedy.launches`, under a profiler
    the span `ynt.nms.kernel`) or raises."""
    k = boxes.shape[-2]
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool or (
            boxes.shape[-1] != 4 or valid.shape != boxes.shape[:-1]):
        raise ValueError(f"nms_greedy takes boxes [..., K, 4] f32 and valid "
                         f"[..., K] bool, got {tuple(boxes.shape)} "
                         f"{boxes.dtype}, {tuple(valid.shape)} {valid.dtype}")
    if boxes.device.type not in ("cpu", "cuda") or (
            valid.device != boxes.device):
        raise ValueError(f"nms_greedy runs on CPU or CUDA tensors of one "
                         f"device, got {boxes.device} and {valid.device}")
    keep = torch.ops.yolo_nano_torch.nms_greedy.default(
        boxes.reshape(-1, k, 4), valid.reshape(-1, k), iou_thresh, diou)
    return keep.reshape(valid.shape)


nms_greedy.launches = 0
