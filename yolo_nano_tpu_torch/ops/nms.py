"""Batched, fixed-shape non-maximum suppression.

Per-class separation shifts each box by class_id · offset, so cross-class
IoU is exactly 0 and one NMS pass covers every class. Greedy suppression is
the operator `yolo_nano_torch::nms_greedy` (`ops/kernels/nms_greedy.py`):
on the CPU its plain version, a fixpoint loop; on CUDA one launch of the
kernel `csrc/nms_greedy.cu`, with no host read.

Top-k ties: the JAX package's `lax.top_k` puts equal values in index order;
`torch.topk` does not promise that, so `stable_topk` sorts stably instead.
"""

from __future__ import annotations

import torch

from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy


def stable_topk(x: torch.Tensor, k: int):
    """The k largest along the last dim, equal values in index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select_topk(x: torch.Tensor, k: int):
    """`stable_topk` of a wide row found by selection, not by a sort of the
    whole row: the k largest along the last dim, equal values in index
    order, for finite f32 x without −0.0 (which it would put below +0.0).
    Each element becomes one distinct int64 key, its value's bits made
    order-preserving as a signed int in the high half and n − 1 − index in
    the low half, so the k largest keys (`torch.topk`, a radix selection on
    CUDA) are the stable order's first k, each appearing once."""
    n = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # negatives: magnitude flipped
    low = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    keys = (bits.to(torch.int64) << 32) | low
    top = torch.topk(keys, k, dim=-1).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx


def nms_on_candidates(top_boxes, top_score, top_cls, *,
                      iou_thresh: float = 0.50, max_det: int = 128,
                      diou: bool = False, class_offset: float = 4.0):
    """Per-class greedy NMS on K candidates already score-sorted descending
    (entries with top_score < 0 are padding or filtered out).

    top_boxes [B,K,4], top_score [B,K], top_cls [B,K] →
    boxes [B,max_det,4], scores, classes int32, valid (score-sorted,
    zero-padded)."""
    top_boxes = top_boxes.float()
    top_score = top_score.float()
    b, k = top_score.shape
    out_det = max_det
    max_det = min(max_det, k)
    top_valid = top_score >= 0
    shifted = top_boxes + (top_cls[..., None] * class_offset).float()
    keep = nms_greedy(shifted, top_valid, iou_thresh, diou=diou)
    final_rank = torch.where(keep, top_score, torch.full_like(top_score, -1.0))
    out_score, oidx = stable_topk(final_rank, max_det)
    out_valid = out_score >= 0
    boxes = torch.gather(top_boxes, 1, oidx[..., None].expand(b, max_det, 4))
    boxes = torch.where(out_valid[..., None], boxes, torch.zeros_like(boxes))
    scores = torch.where(out_valid, out_score, torch.zeros_like(out_score))
    classes = torch.where(out_valid, torch.gather(top_cls, 1, oidx),
                          torch.zeros_like(oidx, dtype=top_cls.dtype))
    out = (boxes, scores, classes.to(torch.int32), out_valid)
    if max_det < out_det:  # keep the promised fixed output shape
        pad = out_det - max_det
        out = tuple(torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
                    for t in out)
    return out


def batched_nms(boxes, class_scores, *, conf_thresh: float = 0.001,
                iou_thresh: float = 0.50, pre_topk: int = 512,
                max_det: int = 128, diou: bool = False,
                class_offset: float = 4.0):
    """The whole postprocess on per-class scores: boxes [B,N,4] corners
    (normalized; any scale up to class_offset), class_scores [B,N,C] →
    boxes [B,max_det,4], scores, classes int32, valid (score-sorted,
    zero-padded). Each box takes its best class, the first on a tie."""
    class_scores = class_scores.float()
    cls = torch.argmax(class_scores, dim=2)  # the first index on a tie
    score = class_scores.amax(dim=2)
    return batched_nms_scored(boxes, score, cls, conf_thresh=conf_thresh,
                              iou_thresh=iou_thresh, pre_topk=pre_topk,
                              max_det=max_det, diou=diou,
                              class_offset=class_offset)


def batched_nms_scored(boxes, score, cls, *, conf_thresh: float = 0.001,
                       iou_thresh: float = 0.50, pre_topk: int = 512,
                       max_det: int = 128, diou: bool = False,
                       class_offset: float = 4.0):
    """Confidence filter + top-k by score + per-class NMS on decoded boxes
    [B,N,4] with per-box (max score, argmax class) [B,N]."""
    boxes = boxes.float()
    score = score.float()
    b = boxes.shape[0]
    pre_topk = min(pre_topk, boxes.shape[1])
    ranked = torch.where(score >= conf_thresh, score,
                         torch.full_like(score, -1.0))
    top_score, idx = stable_topk(ranked, pre_topk)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(b, pre_topk, 4))
    top_cls = torch.gather(cls, 1, idx)
    return nms_on_candidates(top_boxes, top_score, top_cls,
                             iou_thresh=iou_thresh, max_det=max_det,
                             diou=diou, class_offset=class_offset)
