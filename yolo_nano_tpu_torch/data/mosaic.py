"""4-image mosaic augmentation, the port's copy of the JAX package's
`data/mosaic.py` (reference data/voc.py:140-211, identical code
in data/coco.py:126-197 — here one implementation shared by both datasets).

Builds a 2S×2S canvas from 4 images around a random center, remaps each
image's percent boxes into canvas pixels, clips, and renormalizes by 2S.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import cv2
import numpy as np

from yolo_nano_tpu_torch.data.transforms import IMAGE_MEAN


def load_mosaic(load_fn: Callable[[int], Tuple[np.ndarray, np.ndarray]],
                indices: Sequence[int], img_size: int,
                rng: np.random.Generator):
    """load_fn(i) → (img_bgr uint8, target [M,5] normalized x1y1x2y2+cls).
    indices: 4 dataset indices (first = the anchor sample).
    Returns (mosaic_img uint8 [2S,2S,3], mosaic_target [M,5] normalized)."""
    s = img_size
    pad = (IMAGE_MEAN * 255.0).astype(np.uint8)
    canvas = np.ones((2 * s, 2 * s, 3), np.uint8) * pad
    # mosaic center uniform over [S/2, 3S/2] (reference voc.py:158)
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))

    targets: List[np.ndarray] = []
    for i, idx in enumerate(indices):
        img, target = load_fn(idx)
        h0, w0 = img.shape[:2]
        r = s / max(h0, w0)
        if r != 1:
            img = cv2.resize(img, (int(w0 * r), int(h0 * r)))
        h, w = img.shape[:2]
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top right
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, 2 * s), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(target):
            t = np.asarray(target, np.float32).copy()
            t[:, [0, 2]] = t[:, [0, 2]] * w + padw
            t[:, [1, 3]] = t[:, [1, 3]] * h + padh
            targets.append(t)

    if not targets:
        return canvas, np.zeros((1, 5), np.float32)
    out = np.concatenate(targets, 0)
    np.clip(out[:, :4], 0, 2 * s, out=out[:, :4])
    out[:, :4] /= 2 * s
    return canvas, out
