"""Test-time augmentation: multi-scale + horizontal-flip inference with a
merged cross-scale NMS (the JAX package's `utils/tta.py`).

Each view (scale × flip) runs the full single-view `predict`, per-class
NMS included; the views' survivors are then concatenated and suppressed
once more. NMS per view keeps each view's candidate budget intact: merging
raw candidates first would let near-duplicates from the 22 views crowd
out the tail of each view's top-k.

A folded model on CUDA runs both kernels in every view; an unfolded one
runs its convs, as the JAX function runs on whatever tree it is given.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from yolo_nano_tpu_torch.config import YoloNanoConfig


def tta_predictor(model, cfg: YoloNanoConfig,
                  scale_range: Tuple[int, int, int] = (320, 640, 32),
                  nms_thresh: Optional[float] = None) -> Callable:
    """predict_fn(images [B,S,S,3] float32) → (boxes, scores, classes,
    valid) with multi-scale + flip TTA, for a model already on its device:
    numpy images give numpy detections, a tensor on the model's device
    gives tensors there (as `serving.predictor`). Every scale in
    range(lo, hi + 1, step) runs plain and flipped along W; nms_thresh of
    the merge defaults to cfg.nms_thresh."""
    from yolo_nano_tpu_torch.models.yolo_nano import predict
    from yolo_nano_tpu_torch.ops.nms import batched_nms_scored
    from yolo_nano_tpu_torch.ops.nn import resize_images
    from yolo_nano_tpu_torch.serving import hand_back, take_images

    scales = tuple(range(scale_range[0], scale_range[1] + 1, scale_range[2]))
    thresh = cfg.nms_thresh if nms_thresh is None else nms_thresh
    weight = next(model.parameters())
    dev, dtype = weight.device, weight.dtype

    @torch.inference_mode()
    def run(images: torch.Tensor):
        boxes, scores, classes, valid = [], [], [], []
        for s in scales:
            xs = images if images.shape[1] == s else resize_images(images, s)
            xs = xs.to(dtype)
            for flip in (False, True):
                xv = xs.flip(2) if flip else xs
                b, sc, cl, v = predict(model, xv, cfg, s)
                if flip:  # mirror the boxes back
                    b = torch.stack([1.0 - b[..., 2], b[..., 1],
                                     1.0 - b[..., 0], b[..., 3]], -1)
                boxes.append(b)
                scores.append(sc)
                classes.append(cl)
                valid.append(v)
        boxes = torch.cat(boxes, 1)
        score = torch.where(torch.cat(valid, 1), torch.cat(scores, 1),
                            torch.full_like(boxes[..., 0], -1.0))
        # the merged cross-view NMS; its budget covers every survivor
        return batched_nms_scored(
            boxes, score, torch.cat(classes, 1), conf_thresh=cfg.conf_thresh,
            iou_thresh=thresh, pre_topk=boxes.shape[1],
            max_det=cfg.max_detections, diou=cfg.diou_nms)

    def predict_fn(images):
        x, on_device = take_images(images, dev)
        return hand_back(run(x), on_device)

    predict_fn.model = model
    predict_fn.cfg = cfg
    predict_fn.scales = scales
    predict_fn.device = dev
    predict_fn.dtype = dtype
    return predict_fn


def make_tta_predict(params, stats, cfg: YoloNanoConfig,
                     scale_range: Tuple[int, int, int] = (320, 640, 32),
                     nms_thresh: Optional[float] = None,
                     device=None) -> Callable:
    """`tta_predictor` on the model of a JAX-layout tree of numpy arrays,
    as given (`stats` None for a folded tree; nothing is folded or cast
    here), on CUDA unless `device` names another device."""
    from yolo_nano_tpu_torch.convert import build_yolo_nano
    from yolo_nano_tpu_torch.serving import resolve_device

    dev = resolve_device(device)
    model = build_yolo_nano(params, stats, cfg).to(dev)
    return tta_predictor(model, cfg, scale_range, nms_thresh)
