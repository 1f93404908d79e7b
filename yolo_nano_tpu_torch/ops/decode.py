"""Grid/anchor construction and box decoding.

Rows are HW-major and level-concatenated: n = level_offset + cell·A + anchor.
"""

from __future__ import annotations

from typing import NamedTuple

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


def decode_boxes_gathered(txtytwth_k: torch.Tensor, idx: torch.Tensor,
                          cfg: YoloNanoConfig, input_size: int) -> torch.Tensor:
    """Decode only selected candidates: equal to `decode_boxes` gathered at
    the flat indices `idx` [B,K]. txtytwth_k [B,K,4] holds the raw head
    outputs already gathered there. The cell, stride and anchor of each
    index follow from integer arithmetic and small exact table lookups."""
    a = cfg.num_anchors_per_level
    dev = idx.device
    idx = idx.long()
    cell, anchor = idx // a, idx % a
    widths = [input_size // s for s in cfg.strides]
    offsets = np.cumsum([0] + [w * w for w in widths])
    level = torch.zeros_like(cell)
    for li in range(1, len(widths)):
        level = torch.where(cell >= int(offsets[li]), li, level)
    stride = torch.tensor(cfg.strides, dtype=torch.float32, device=dev)[level]
    w_l = torch.tensor(widths, dtype=torch.long, device=dev)[level]
    c_in = cell - torch.tensor(offsets[:-1], dtype=torch.long,
                               device=dev)[level]
    gxy = torch.stack([c_in % w_l, c_in // w_l], -1).float()  # (x, y)
    anchors = torch.tensor(cfg.anchors, dtype=torch.float32, device=dev)
    awh = anchors[level * a + anchor]
    xy = (torch.sigmoid(txtytwth_k[..., :2]) + gxy) * stride[..., None]
    wh = torch.exp(txtytwth_k[..., 2:]) * awh
    return _corners(xy, wh)
