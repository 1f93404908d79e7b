"""The reference's postprocess, plain PyTorch and NumPy: scores, decode,
candidates and per-class greedy NMS, written from the method (YOLOv3-style
decode, class-aware greedy NMS) and not from the program under test.

  * score of a row and class: softmax over the class logits times
    sigmoid(objectness); a row's score is its best class's;
  * box: centre (sigmoid(tx, ty) + cell) * stride, size exp(tw, th) *
    anchor, as corners divided by the input size and clamped to [0, 1];
  * candidates: rows whose score is at least `conf`, the `pre_topk` best,
    equal scores in row order;
  * greedy NMS per class over the candidates in score order: a candidate is
    kept unless a kept one of its class overlaps it by IoU > `nms`; the
    kept ones, best first, up to `max_det`.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class Rows(NamedTuple):
    """Per prediction row: cell x, cell y, stride, anchor w, anchor h."""

    gx: torch.Tensor
    gy: torch.Tensor
    stride: torch.Tensor
    aw: torch.Tensor
    ah: torch.Tensor


def row_tables(anchors, strides, size: int, device) -> Rows:
    """Rows level by level, cell-major (y, then x), anchor-minor."""
    a = len(anchors) // len(strides)
    cols = [[] for _ in range(5)]
    for li, s in enumerate(strides):
        n = size // s
        ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        for part, v in zip(cols, (xs, ys, np.full((n, n), s))):
            part.append(np.repeat(v.reshape(-1), a))
        aw = np.array([anchors[li * a + j][0] for j in range(a)])
        ah = np.array([anchors[li * a + j][1] for j in range(a)])
        cols[3].append(np.tile(aw, n * n))
        cols[4].append(np.tile(ah, n * n))
    return Rows(*(torch.tensor(np.concatenate(c), dtype=torch.float32,
                               device=device) for c in cols))


def dense(obj, cls_logits, box_raw, rows: Rows, size: int):
    """Head outputs -> (class probabilities [B, N, C], boxes [B, N, 4])."""
    probs = torch.softmax(cls_logits, -1) * torch.sigmoid(obj)[..., None]
    xy = torch.sigmoid(box_raw[..., :2])
    cx = (xy[..., 0] + rows.gx) * rows.stride
    cy = (xy[..., 1] + rows.gy) * rows.stride
    w = torch.exp(box_raw[..., 2]) * rows.aw
    h = torch.exp(box_raw[..., 3]) * rows.ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return probs, torch.clamp(boxes / size, 0.0, 1.0)


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU [len(a), len(b)] of corner boxes."""
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


class Candidates(NamedTuple):
    """One image's candidates in score order (f64): boxes [K, 4], scores
    [K], classes [K], class probabilities [K, C], whether NMS keeps each
    [K], and the best score left out by `pre_topk` (-inf if none)."""

    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    probs: np.ndarray
    kept: np.ndarray
    cut_score: float


def greedy_nms(boxes, classes, nms: float) -> np.ndarray:
    """keep [K] for candidates already in score order."""
    iou = pairwise_iou(boxes, boxes)
    same = classes[:, None] == classes[None, :]
    keep = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        keep[i] = not np.any(keep[:i] & same[:i, i] & (iou[:i, i] > nms))
    return keep


def candidates(probs: torch.Tensor, boxes: torch.Tensor, conf: float,
               nms: float, pre_topk: int) -> List[Candidates]:
    """Per image of a batch: its candidates and what NMS keeps."""
    score, cls = probs.max(-1)
    out = []
    for i in range(probs.shape[0]):
        s = score[i].double().cpu().numpy()
        order = np.argsort(-s, kind="stable")
        order = order[s[order] >= conf]
        cut = float(s[order[pre_topk]]) if len(order) > pre_topk else -np.inf
        order = order[:pre_topk]
        idx = torch.as_tensor(order, device=probs.device)
        b = boxes[i, idx].double().cpu().numpy()
        c = cls[i, idx].cpu().numpy()
        out.append(Candidates(b, s[order], c,
                              probs[i, idx].double().cpu().numpy(),
                              greedy_nms(b, c, nms), cut))
    return out
