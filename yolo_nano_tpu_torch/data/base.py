"""Shared dataset behavior: mosaic dispatch, transform selection, padding.
The port's copy of the JAX package's `data/base.py`.

VOC and COCO differ only in raw loading (`load_img_targets`) and accessors;
the pull_item pipeline (mosaic coin-flip → augmentation chain → fixed [M,5]
target) is identical (reference data/voc.py:214-235 == data/coco.py:200-230).

With `device_augment` set, pull_item returns the in-graph augmentation's
input instead (`data/device_aug.py`): the uint8 letterboxed base canvas,
its target and its image region.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from yolo_nano_tpu_torch.data.mosaic import load_mosaic
from yolo_nano_tpu_torch.data.transforms import (
    color_transform,
    resize_letterbox,
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
    _canvas_cache = None  # device_augment: index → (canvas_u8, target, region)
    # device_augment=True switches pull_item to the in-graph augmentation
    # contract (data/device_aug.py): host work shrinks to decode + uint8
    # letterbox; photometric/crop/mosaic/mirror/normalize run inside the
    # train step. pull_item then returns (canvas_u8, target, region).
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
            return self._pull_item_device(index)
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

    def _pull_item_device(self, index: int):
        """(canvas uint8 BGR [S0,S0,3], target [M,5] canvas-normalized,
        region [5] = image-region rect + crop_allowed). Host cost: decode
        and one uint8 letterbox; everything else, the mosaic included
        (device_aug.compose_mosaic takes its tiles from the batch's other
        rows), runs in the train step.

        The canvas is deterministic per index (all randomness lives on the
        device), so under enable_image_cache the finished triple is memoized
        and the decoded image evicted (keeping both would double the cache);
        warm epochs then cost only the batch's stack and pad on the host.
        The triple is read-only downstream (np.stack copies)."""
        if self._img_cache is not None:
            if self._canvas_cache is None:
                self._canvas_cache = {}
            hit = self._canvas_cache.get(index)
            if hit is not None:
                return hit
        img, target, _, _ = self._load(index)
        if len(target) == 0:
            target = np.zeros((1, 5), np.float32)  # reference voc.py:226-227
        canvas, boxes, scale, offset = resize_letterbox(
            img, self.img_size, target[:, :4], dtype=np.uint8)
        out = np.concatenate([boxes, target[:, 4:5]], 1).astype(np.float32)
        region = np.array([offset[0], offset[1], offset[0] + scale[0],
                           offset[1] + scale[1],
                           1.0 if self.augment else 0.0], np.float32)
        if self._img_cache is not None:
            self._canvas_cache[index] = (canvas, out, region)
            self._img_cache.pop(index, None)
        return canvas, out, region
