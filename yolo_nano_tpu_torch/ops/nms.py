"""Batched, fixed-shape non-maximum suppression.

Per-class separation shifts each box by class_id · offset, so cross-class
IoU is exactly 0 and one NMS pass covers every class. Greedy suppression is
the fixpoint iteration
    keep_i = valid_i ∧ ¬∃ j<i : keep_j ∧ ovr(j,i) > thresh
over the K×K overlap matrix, which reaches the sequential-greedy keep set:
the settled prefix grows every sweep. All images of a batch sweep together.

Top-k ties: the JAX package's `lax.top_k` puts equal values in index order;
`torch.topk` does not promise that, so `stable_topk` sorts stably instead.
"""

from __future__ import annotations

import torch
from torch._higher_order_ops.while_loop import while_loop_op


def stable_topk(x: torch.Tensor, k: int):
    """The k largest along the last dim, equal values in index order."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


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


def nms_greedy(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
               diou: bool = False) -> torch.Tensor:
    """Greedy NMS over candidates ALREADY SORTED by descending score.
    boxes [..., K, 4], valid [..., K] → keep [..., K].

    The sweeps are a while loop that carries (keep, changed) from (valid,
    any(valid)) and stops when a sweep changes no keep, as the JAX
    package's loop does (its carried prev and the test against it become
    `changed`, computed in the body). JAX's second condition, it < K, never
    stops the loop: the settled prefix grows by one every sweep, so at the
    latest the (K+1)-th sweep finds no change; the port leaves the counter
    out (three operator calls a sweep). Eagerly the loop runs in Python
    and reads the condition on the host once per sweep (a few sweeps in
    practice); when traced (torch.export in `serving.export_graph`, or
    torch.compile) it is the `while_loop` operator, called directly: the
    `while_loop` wrapper compiles it with dynamo on every new shape."""
    k = boxes.shape[-2]
    ovr = _pairwise_iou(boxes)
    if diou:
        ovr = ovr - _pairwise_diou_penalty(boxes)
    order = torch.arange(k, device=boxes.device)
    # sup[j, i]: a kept j would suppress i (strictly lower-scored)
    sup = (ovr > iou_thresh) & (order[:, None] < order[None, :])

    def cond(keep, changed, valid, sup):
        return changed

    def body(keep, changed, valid, sup):
        new = valid & ~(sup & keep[..., :, None]).any(-2)
        return new, (new != keep).any()

    carried = (valid, valid.any())
    if torch.compiler.is_compiling():
        return while_loop_op(cond, body, carried, (valid, sup))[0]
    while cond(*carried, valid, sup):  # what the operator runs eagerly
        carried = body(*carried, valid, sup)
    return carried[0]


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
