"""Host-side image augmentation pipeline (numpy + cv2): the port's copy of
the JAX package's `data/transforms.py`, line for line.

Functional re-design of reference data/transforms.py:402-458. Same operation
chain and distributions, with two structural changes:
  * every transform takes an explicit np.random.Generator — reproducible,
    safe across dataloader worker processes (the reference uses the global
    numpy RNG, which duplicates streams across forked workers);
  * transforms are plain functions over (image, boxes, labels) — no class
    pipeline objects; the output is HWC RGB float32 ready to batch to NHWC.

Pipeline parity notes:
  * the reference works in BGR (cv2 imread) and normalizes with BGR-ordered
    torchvision constants before flipping to RGB at the very end
    (transforms.py:394-417) — we keep that exact ordering;
  * `resize_letterbox` reproduces Resize (transforms.py:73-119): aspect-
    preserving resize, mean-value padding to square, centered; returns the
    (scale, offset) needed to undo it at eval;
  * RandomSampleCrop keeps the reference's SSD-legacy accept condition
    verbatim (transforms.py:290) — the training distribution is the parity
    target, not a cleaned-up crop sampler.
"""

from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np

# BGR-ordered means/stds (reference transforms.py:403)
IMAGE_MEAN = np.array((0.406, 0.456, 0.485), np.float32)
IMAGE_STD = np.array((0.225, 0.224, 0.229), np.float32)


# ---------------------------------------------------------------------------
# photometric ops (reference transforms.py:144-226, 369-391)
# ---------------------------------------------------------------------------

def _random_brightness(img, rng, delta=32.0):
    if rng.integers(2):
        img += rng.uniform(-delta, delta)
    return img


def _random_contrast(img, rng, lower=0.5, upper=1.5):
    if rng.integers(2):
        img *= rng.uniform(lower, upper)
    return img


def _random_saturation(hsv, rng, lower=0.5, upper=1.5):
    if rng.integers(2):
        hsv[:, :, 1] *= rng.uniform(lower, upper)
    return hsv


def _random_hue(hsv, rng, delta=18.0):
    if rng.integers(2):
        hsv[:, :, 0] += rng.uniform(-delta, delta)
        hsv[:, :, 0][hsv[:, :, 0] > 360.0] -= 360.0
        hsv[:, :, 0][hsv[:, :, 0] < 0.0] += 360.0
    return hsv


def photometric_distort(img, rng):
    """reference PhotometricDistort (transforms.py:369-391): brightness, then
    either [contrast → HSV sat/hue] or [HSV sat/hue → contrast]."""
    img = img.copy()
    img = _random_brightness(img, rng)
    contrast_first = bool(rng.integers(2))
    if contrast_first:
        img = _random_contrast(img, rng)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    hsv = _random_saturation(hsv, rng)
    hsv = _random_hue(hsv, rng)
    img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    if not contrast_first:
        img = _random_contrast(img, rng)
    return img


# ---------------------------------------------------------------------------
# geometric ops
# ---------------------------------------------------------------------------

def _jaccard(boxes, rect):
    tl = np.maximum(boxes[:, :2], rect[:2])
    br = np.minimum(boxes[:, 2:], rect[2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=1)
    area_a = np.prod(boxes[:, 2:] - boxes[:, :2], axis=1)
    area_b = np.prod(rect[2:] - rect[:2])
    return inter / (area_a + area_b - inter)


_CROP_MODES = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None),
               (None, None))


def random_sample_crop(img, boxes, labels, rng, max_rounds: int = 50):
    """SSD min-IoU patch sampling (reference transforms.py:228-330).

    Boxes in absolute pixel coords. The accept condition matches the
    reference byte-for-byte (:290); a bounded number of mode re-draws replaces
    the reference's unbounded `while True` (mode None exits with prob 1/6 per
    round, so the truncation is statistically invisible)."""
    height, width = img.shape[:2]
    for _ in range(max_rounds):
        mode = _CROP_MODES[rng.integers(len(_CROP_MODES))]
        if mode is None:
            return img, boxes, labels
        min_iou, max_iou = mode
        min_iou = -np.inf if min_iou is None else min_iou
        max_iou = np.inf if max_iou is None else max_iou
        for _ in range(50):
            w = rng.uniform(0.3 * width, width)
            h = rng.uniform(0.3 * height, height)
            if h / w < 0.5 or h / w > 2:
                continue
            left = rng.uniform(0, width - w)
            top = rng.uniform(0, height - h)
            rect = np.array([int(left), int(top), int(left + w),
                             int(top + h)], np.float32)
            overlap = _jaccard(boxes, rect)
            # reference accept condition verbatim (transforms.py:290)
            if overlap.min() < min_iou and max_iou < overlap.max():
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            mask = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1])
                    & (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
            if not mask.any():
                continue
            r = rect.astype(np.int64)
            out_img = img[r[1]:r[3], r[0]:r[2]]
            out_boxes = boxes[mask].copy()
            out_boxes[:, :2] = np.maximum(out_boxes[:, :2], rect[:2]) - rect[:2]
            out_boxes[:, 2:] = np.minimum(out_boxes[:, 2:], rect[2:]) - rect[:2]
            return out_img, out_boxes, labels[mask]
    return img, boxes, labels


def random_mirror(img, boxes, rng):
    """Horizontal flip (reference transforms.py:333-340)."""
    if rng.integers(2):
        width = img.shape[1]
        img = img[:, ::-1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = width - boxes[:, [2, 0]]
    return img, boxes


def resize_letterbox(img, size: int, boxes: Optional[np.ndarray] = None,
                     dtype=np.float32
                     ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                np.ndarray, np.ndarray]:
    """Aspect-preserving resize + centered mean-value pad to (size, size)
    (reference Resize, transforms.py:73-119).

    boxes (if given) are percent coords and are remapped into the padded
    frame. Returns (img, boxes, scale[4], offset[4]) with
    boxes_out = boxes_in · scale + offset. dtype=np.uint8 keeps the canvas
    uint8 (the JAX package's device-augmentation base canvas — 4×
    less host→device traffic than f32).
    """
    h0, w0 = img.shape[:2]
    pad_value = (IMAGE_MEAN * 255.0).astype(dtype)
    # scale/offset live in ONE place — letterbox_geometry — so the sharded
    # evaluator's pixel-free metas can never drift from the pixel path
    scale, offset = letterbox_geometry(h0, w0, size)
    if h0 > w0:
        w = max(int(w0 / h0 * size), 1)
        resized = cv2.resize(img, (w, size)).astype(dtype)
        canvas = np.ones((size, size, 3), dtype) * pad_value
        left = (size - w) // 2
        canvas[:, left:left + w] = resized
    elif h0 < w0:
        h = max(int(h0 / w0 * size), 1)
        resized = cv2.resize(img, (size, h)).astype(dtype)
        canvas = np.ones((size, size, 3), dtype) * pad_value
        top = (size - h) // 2
        canvas[top:top + h, :] = resized
    else:
        canvas = (img.astype(dtype) if h0 == size
                  else cv2.resize(img, (size, size)).astype(dtype))
    if boxes is not None:
        boxes = boxes * scale + offset
    return canvas, boxes, scale, offset


def letterbox_geometry(h0: int, w0: int, size: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(scale[4], offset[4]) that `resize_letterbox` would produce for an
    (h0, w0) image — WITHOUT touching pixels. The letterbox mapping depends
    only on (h0, w0, size): cv2.resize returns exactly the requested dims,
    so scale/offset are pure arithmetic. Evaluation metas can therefore be
    built from annotation-declared image sizes alone; the multi-controller
    evaluator uses this to keep letterbox-undo info for ALL rows while
    decoding only its own shard (pinned identical to resize_letterbox in
    the JAX package's tests/test_data.py)."""
    if h0 > w0:
        w = max(int(w0 / h0 * size), 1)
        left = (size - w) // 2
        return (np.array([w / size, 1.0, w / size, 1.0], np.float32),
                np.array([left / size, 0.0, left / size, 0.0], np.float32))
    if h0 < w0:
        h = max(int(h0 / w0 * size), 1)
        top = (size - h) // 2
        return (np.array([1.0, h / size, 1.0, h / size], np.float32),
                np.array([0.0, top / size, 0.0, top / size], np.float32))
    return np.ones(4, np.float32), np.zeros(4, np.float32)


def letterbox_undo(boxes, scale, offset, orig_w: int, orig_h: int):
    """Map normalized letterboxed boxes back to original pixel coordinates
    (inverse of resize_letterbox; used by the evaluators like reference
    evaluator/cocoapi_evaluator.py:85-87)."""
    out = (boxes - offset) / scale
    out = out * np.array([orig_w, orig_h, orig_w, orig_h], np.float32)
    return out


def _normalize_to_rgb(img_bgr):
    """/255, −mean, /std in BGR, then flip to RGB HWC float32
    (reference transforms.py:59-70, 394-398)."""
    img = img_bgr.astype(np.float32) / 255.0
    img = (img - IMAGE_MEAN) / IMAGE_STD
    return np.ascontiguousarray(img[..., ::-1])


# ---------------------------------------------------------------------------
# public pipelines (reference TrainTransforms/ColorTransforms/ValTransforms)
# ---------------------------------------------------------------------------

def train_transform(img_bgr, boxes, labels, size: int,
                    rng: np.random.Generator):
    """Full train chain (reference transforms.py:402-420): photometric →
    min-IoU crop → mirror → letterbox → normalize. boxes are percent coords
    in, percent coords (letterboxed frame) out."""
    img = img_bgr.astype(np.float32)
    h, w = img.shape[:2]
    abs_boxes = boxes * np.array([w, h, w, h], np.float32)
    img = photometric_distort(img, rng)
    img, abs_boxes, labels = random_sample_crop(img, abs_boxes, labels, rng)
    img, abs_boxes = random_mirror(img, abs_boxes, rng)
    h, w = img.shape[:2]
    pct = abs_boxes / np.array([w, h, w, h], np.float32)
    img, pct, scale, offset = resize_letterbox(img, size, pct)
    return _normalize_to_rgb(img), pct.astype(np.float32), labels, scale, offset


def color_transform(img_bgr, boxes, labels, size: int,
                    rng: np.random.Generator):
    """Train chain minus the crop — used for mosaic samples
    (reference transforms.py:424-441, voc.py:220)."""
    img = img_bgr.astype(np.float32)
    h, w = img.shape[:2]
    abs_boxes = boxes * np.array([w, h, w, h], np.float32)
    img = photometric_distort(img, rng)
    img, abs_boxes = random_mirror(img, abs_boxes, rng)
    pct = abs_boxes / np.array([w, h, w, h], np.float32)
    img, pct, scale, offset = resize_letterbox(img, size, pct)
    return _normalize_to_rgb(img), pct.astype(np.float32), labels, scale, offset


def val_transform(img_bgr, size: int):
    """Eval chain (reference transforms.py:445-458): letterbox + normalize.
    Returns (img, scale, offset)."""
    img, _, scale, offset = resize_letterbox(img_bgr, size, None)
    return _normalize_to_rgb(img), scale, offset


def val_transform_with_boxes(img_bgr, boxes, labels, size: int,
                             rng=None):
    """val chain carrying boxes: percent boxes are remapped into the
    letterboxed frame (boxes·scale+offset, reference transforms.py:116-117 —
    the reference's ValTransforms applies Resize to boxes too)."""
    img, boxes, scale, offset = resize_letterbox(img_bgr, size, boxes)
    return (_normalize_to_rgb(img), boxes.astype(np.float32), labels, scale,
            offset)
