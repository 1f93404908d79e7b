"""Shared dataset behavior: mosaic dispatch, transform selection, padding.
The port's copy of the JAX package's `data/base.py`.

VOC and COCO differ only in raw loading (`load_img_targets`) and accessors;
the pull_item pipeline (mosaic coin-flip → augmentation chain → fixed [M,5]
target) is identical (reference data/voc.py:214-235 == data/coco.py:200-230).

The JAX package's in-graph augmentation contract (`device_augment=True`,
its `data/device_aug.py`) is not ported yet: a dataset with it set raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from yolo_nano_tpu_torch.data.mosaic import load_mosaic
from yolo_nano_tpu_torch.data.transforms import (
    color_transform,
    train_transform,
    val_transform_with_boxes,
)


class DetectionDatasetBase:
    """Subclasses set: img_size, mosaic, augment, ids; implement
    load_img_targets(index) → (img_bgr, target [M,5] normalized, h, w).

    `enable_image_cache()` memoizes the raw decoded images + targets in
    memory: JPEG decode dominates the host load cost, and eval/training on
    datasets that fit in RAM pays it once. Cache hits return copies (the
    augmentation chain mutates pixel buffers). Budget ≈ H·W·3 bytes/image."""

    img_size: int
    mosaic: bool
    augment: bool
    _img_cache = None  # index → (img, target, h, w)
    # the JAX package's in-graph augmentation switch; the port has no
    # device augmentation yet, so pull_item raises when it is set
    device_augment: bool = False

    def __len__(self) -> int:
        return len(self.ids)

    def enable_image_cache(self) -> None:
        self._img_cache = {}

    def load_img_targets(self, index: int):
        raise NotImplementedError

    def image_hw(self, index: int):
        """(h, w) of the raw image — subclasses override with a metadata
        read (VOC XML <size>, COCO images index) so callers can build
        letterbox-undo geometry without decoding pixels. Fallback: decode."""
        _, _, h, w = self._load(index)
        return h, w

    def _load(self, index: int):
        if self._img_cache is None:
            return self.load_img_targets(index)
        hit = self._img_cache.get(index)
        if hit is None:
            hit = self.load_img_targets(index)
            self._img_cache[index] = hit
        img, target, h, w = hit
        return img.copy(), target.copy(), h, w

    def _load_for_mosaic(self, index: int):
        img, target, _, _ = self._load(index)
        return img, target

    def pull_item(self, index: int,
                  rng: Optional[np.random.Generator] = None):
        """(img HWC RGB float32, target [M,5] normalized, h, w, scale, offset).
        Mosaic with p=0.5 when enabled (reference voc.py:216); val mode remaps
        boxes into the letterboxed frame."""
        if self.device_augment:
            raise NotImplementedError(
                "device_augment: the in-graph augmentation (the JAX "
                "package's data/device_aug.py, ROADMAP Queue 1 item 14) is "
                "not ported yet")
        rng = rng or np.random.default_rng()
        if self.mosaic and rng.integers(2):
            others = rng.choice(len(self.ids), size=3, replace=False)
            img, target = load_mosaic(self._load_for_mosaic,
                                      [index, *others.tolist()],
                                      self.img_size, rng)
            h = w = self.img_size
            tf = color_transform
        else:
            img, target, h, w = self._load(index)
            tf = train_transform if self.augment else val_transform_with_boxes
        if len(target) == 0:
            target = np.zeros((1, 5), np.float32)  # reference voc.py:226-227
        img, boxes, labels, scale, offset = tf(
            img, target[:, :4], target[:, 4], self.img_size, rng)
        out = np.concatenate([boxes, labels[:, None]], 1).astype(np.float32)
        return img, out, h, w, scale, offset
