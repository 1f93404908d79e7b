"""Anchor target assignment, batched and fixed-shape on the device.

  * ground truths are padded to M per image (label −1 = padding);
  * each gt's wh-IoU against the anchors is one batched computation
    (centred boxes: overlap = min(w)·min(h));
  * the best anchor (first on ties) gets a positive row; the other anchors
    above `ignore_thresh` get obj = −1, weight = −1 "ignore" rows;
  * the writes go into one flat [B·N + 1, 11] tensor whose last row takes
    every masked write.

CUDA's `index_put_` gives an undefined winner among duplicate indices, so
the writes are arranged to hold no duplicates that matter:

  * ignore rows are all the same row, written first;
  * positive rows are written second, so a positive always beats an ignore;
  * among positives that fall on one row, the gt last in its image's list
    wins (as in a sequential loop); the others go to the dump row.

Target row layout (11 ch): [obj, cls, tx, ty, tw, th, weight, x1, y1, x2, y2]
(boxes normalized).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yolo_nano_tpu_torch.config import YoloNanoConfig


class TargetTables(NamedTuple):
    """Per-anchor constants on the device: anchor wh [K,2] (pixels), stride
    [K], grid width [K], flat row offset [K] (level offset + anchor slot)."""

    anchors: torch.Tensor
    stride: torch.Tensor
    width: torch.Tensor
    offset: torch.Tensor


def target_tables(cfg: YoloNanoConfig, input_size: int, device=None
                  ) -> TargetTables:
    a = cfg.num_anchors_per_level
    k = np.arange(len(cfg.anchors))
    widths = np.asarray([input_size // s for s in cfg.strides])
    level_off = np.concatenate([[0], np.cumsum(widths * widths * a)[:-1]])
    lvl = k // a
    as_t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=device)  # noqa: E731
    return TargetTables(
        as_t(np.asarray(cfg.anchors, np.float32), torch.float32),
        as_t(np.asarray(cfg.strides, np.float32)[lvl], torch.float32),
        as_t(widths[lvl], torch.int64),
        as_t(level_off[lvl] + k % a, torch.int64))


def build_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  cfg: YoloNanoConfig, input_size: int,
                  tables: TargetTables = None) -> torch.Tensor:
    """gt_boxes [B,M,4] normalized x1y1x2y2, gt_labels [B,M] int (−1 pad) →
    target [B, N, 11], N = cfg.num_predictions(input_size). `tables`
    defaults to target_tables on the boxes' device (pass them in where a
    host→device copy must not run)."""
    dev = gt_boxes.device
    t = tables if tables is not None else target_tables(cfg, input_size, dev)
    a = cfg.num_anchors_per_level
    n = cfg.num_predictions(input_size)
    bsz, m = gt_labels.shape
    boxes = gt_boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)                          # [B, M]
    cx = (x1 + x2) / 2 * input_size
    cy = (y1 + y2) / 2 * input_size
    bw = (x2 - x1) * input_size
    bh = (y2 - y1) * input_size
    valid = (gt_labels >= 0) & (bw >= 1.0) & (bh >= 1.0)

    inter = (torch.minimum(bw[..., None], t.anchors[:, 0])
             * torch.minimum(bh[..., None], t.anchors[:, 1]))
    union = (bw[..., None] * bh[..., None]
             + t.anchors[:, 0] * t.anchors[:, 1] - inter + 1e-20)
    iou = inter / union                                        # [B, M, K]
    over = iou > cfg.ignore_thresh
    best = torch.argmax(iou, -1)                               # [B, M]

    gx = torch.floor(cx[..., None] / t.stride).long()          # [B, M, K]
    gy = torch.floor(cy[..., None] / t.stride).long()
    in_bounds = (gx < t.width) & (gy < t.width) & (gx >= 0) & (gy >= 0)
    image = torch.arange(bsz, device=dev)[:, None, None] * n
    flat = image + t.offset + (gy * t.width + gx) * a          # [B, M, K]

    dump = bsz * n
    target = torch.zeros((dump + 1, 11), device=dev)

    # ignore rows: above-threshold anchors that are not the best
    k = torch.arange(len(cfg.anchors), device=dev)
    ign = over & (k != best[..., None]) & valid[..., None] & in_bounds
    # obj = weight = −1, made on the device: writing a Python number into
    # a CUDA tensor would make the host wait
    ign_row = torch.where(torch.arange(11, device=dev) % 6 == 0, -1.0, 0.0)
    target[torch.where(ign, flat, dump).reshape(-1)] = ign_row

    # positive rows: the best anchor of each valid gt; the last gt of an
    # image wins a row that several gts pick
    bi = torch.gather(flat, -1, best[..., None])[..., 0]       # [B, M]
    ok = torch.gather(in_bounds, -1, best[..., None])[..., 0] & valid
    bi = torch.where(ok, bi, dump)
    order = torch.arange(m, device=dev).expand(bsz, m)
    last = torch.full((dump + 1,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, bi.reshape(-1), order.reshape(-1), "amax")
    bi = torch.where(torch.gather(last, 0, bi.reshape(-1)).view(bsz, m)
                     == order, bi, dump)
    sb = t.stride[best]
    tx = cx / sb - torch.floor(cx / sb)
    ty = cy / sb - torch.floor(cy / sb)
    tw = torch.log(torch.clamp(bw, min=1e-9) / t.anchors[best, 0])
    th = torch.log(torch.clamp(bh, min=1e-9) / t.anchors[best, 1])
    weight = 2.0 - (bw / input_size) * (bh / input_size)
    rows = torch.stack([torch.ones_like(tx), gt_labels.float(), tx, ty, tw,
                        th, weight, x1, y1, x2, y2], -1)       # [B, M, 11]
    target[bi.reshape(-1)] = rows.reshape(-1, 11)
    return target[:dump].view(bsz, n, 11)
