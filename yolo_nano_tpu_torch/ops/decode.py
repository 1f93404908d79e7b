"""Grid/anchor construction and box decoding.

YOLO-Nano: rows are HW-major and level-concatenated: n = level_offset +
cell·A + anchor. NanoDet-Plus: one prior a cell, n = level_offset + y·side
+ x, at (x·stride, y·stride) with no half-cell offset; a box is the
prior's distances to its four sides, each the expectation of a softmax
over reg_max + 1 bins (the distribution focal loss's integral), times the
stride (`decode_distances`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from yolo_nano_tpu_torch.config import YoloNanoConfig


class Grids(NamedTuple):
    """grid_xy (ΣHW,1,2) cell (x, y); stride (ΣHW,1,1); anchor_wh (ΣHW,A,2)
    in pixels. All float32."""

    grid_xy: torch.Tensor
    stride: torch.Tensor
    anchor_wh: torch.Tensor


def make_grids(cfg: YoloNanoConfig, input_size: int, device=None) -> Grids:
    a = cfg.num_anchors_per_level
    anchors = np.asarray(cfg.anchors, np.float32).reshape(len(cfg.strides),
                                                          a, 2)
    gxy, gs, gwh = [], [], []
    for li, s in enumerate(cfg.strides):
        hs = input_size // s
        ys, xs = np.meshgrid(np.arange(hs), np.arange(hs), indexing="ij")
        gxy.append(np.stack([xs, ys], -1).reshape(hs * hs, 1, 2))
        gs.append(np.full((hs * hs, 1, 1), s))
        gwh.append(np.broadcast_to(anchors[li], (hs * hs, a, 2)))
    as_t = lambda parts: torch.as_tensor(  # noqa: E731
        np.concatenate(parts, 0).astype(np.float32), device=device)
    return Grids(as_t(gxy), as_t(gs), as_t(gwh))


def _corners(xy, wh):
    half = wh / 2
    return torch.cat([xy - half, xy + half], -1)


def decode_boxes(txtytwth: torch.Tensor, grids: Grids) -> torch.Tensor:
    """[B,ΣHW,A,4] (tx,ty,tw,th) → [B,ΣHW·A,4] corner boxes in pixels:
    cxcy = (sigmoid(txty) + grid)·stride, wh = exp(twth)·anchor."""
    b, hw, a, _ = txtytwth.shape
    xy = (torch.sigmoid(txtytwth[..., :2]) + grids.grid_xy) * grids.stride
    wh = torch.exp(txtytwth[..., 2:]) * grids.anchor_wh
    return _corners(xy, wh).reshape(b, hw * a, 4)


# decode's rows on each device, built once per key (`decode_rows`)
_ROWS: Dict[tuple, torch.Tensor] = {}


def decode_rows(cfg: YoloNanoConfig, input_size: int,
                device) -> torch.Tensor:
    """[ΣHW·A, 5] f32: for each flat row n, `make_grids`'s cell x, cell y,
    stride, anchor w, anchor h. Built once per (strides, anchors, anchors
    per level, input size, device) and kept, so that decoding enqueues no
    host copy (a copy from pageable host memory waits for the device). Not
    kept when built during a trace, whose tensors are the tracer's: a
    graph traced after an eager call (as `serving.export_graph` makes one)
    holds the kept rows as a constant. Callers only read it."""
    device = torch.device(device)
    key = (tuple(cfg.strides), tuple(map(tuple, cfg.anchors)),
           cfg.num_anchors_per_level, input_size, device)
    rows = _ROWS.get(key)
    if rows is None:
        g = make_grids(cfg, input_size)
        hw, a = g.anchor_wh.shape[:2]
        rows = torch.cat([g.grid_xy.expand(hw, a, 2),
                          g.stride.expand(hw, a, 1), g.anchor_wh],
                         -1).reshape(hw * a, 5).to(device)
        if not torch.compiler.is_compiling():
            _ROWS[key] = rows
    return rows


def decode_boxes_gathered(txtytwth_k: torch.Tensor, idx: torch.Tensor,
                          cfg: YoloNanoConfig, input_size: int) -> torch.Tensor:
    """Decode only selected candidates: equal to `decode_boxes` gathered at
    the flat indices `idx` [B,K], bit for bit (the same operations on the
    same grid values). txtytwth_k [B,K,4] holds the raw head outputs
    already gathered there; each index's cell, stride and anchor are its
    row of `decode_rows`, kept on the device."""
    b, k = idx.shape
    g = torch.index_select(decode_rows(cfg, input_size, idx.device), 0,
                           idx.reshape(-1)).reshape(b, k, 5)
    xy = (torch.sigmoid(txtytwth_k[..., :2]) + g[..., :2]) * g[..., 2:3]
    wh = torch.exp(txtytwth_k[..., 2:]) * g[..., 3:]
    return _corners(xy, wh)


def prior_rows(strides, sides, device) -> torch.Tensor:
    """[Σ side², 3] f32: each NanoDet-Plus prior's x·stride, y·stride and
    stride, level by level, y-major; built once per (strides, sides,
    device) and kept, as `decode_rows` is."""
    device = torch.device(device)
    key = ("priors", tuple(strides), tuple(sides), device)
    rows = _ROWS.get(key)
    if rows is None:
        parts = []
        for s, n in zip(strides, sides):
            ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            parts.append(np.stack([xs.reshape(-1) * s, ys.reshape(-1) * s,
                                   np.full(n * n, s)], -1))
        rows = torch.as_tensor(np.concatenate(parts).astype(np.float32),
                               device=device)
        if not torch.compiler.is_compiling():
            _ROWS[key] = rows
    return rows


def decode_distances(reg_k: torch.Tensor, rows_k: torch.Tensor,
                     input_size: int) -> torch.Tensor:
    """NanoDet-Plus boxes of selected priors: reg_k [B,K,4·(R+1)] f32 raw
    distribution logits (left, top, right, bottom), rows_k [B,K,3] their
    `prior_rows` → [B,K,4] corners divided by the input size, clamped to
    [0, 1] (`distance2bbox` with the image as max_shape)."""
    b, k, c = reg_k.shape
    bins = c // 4
    p = torch.softmax(reg_k.reshape(b, k, 4, bins), -1)
    proj = torch.arange(bins, dtype=p.dtype, device=p.device)
    d = (p * proj).sum(-1) * rows_k[..., 2:3]
    xy = rows_k[..., :2]
    boxes = torch.cat([xy - d[..., :2], xy + d[..., 2:]], -1)
    return torch.clamp(boxes / input_size, 0.0, 1.0)
