"""One-call loader: a folded `.npz` artifact → a batched predict function."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def load_predictor(path: str, device=None,
                   conf_thresh: Optional[float] = None,
                   nms_thresh: Optional[float] = None,
                   pre_topk: Optional[int] = None,
                   max_det: Optional[int] = None) -> Callable:
    """Load a folded artifact → predict_fn(images) → numpy (boxes [B,D,4],
    scores [B,D], classes [B,D] int32, valid [B,D] bool).

    `images`: [B, S, S, 3] float32 RGB, normalized like the JAX package's
    val_transform output. The thresholds override the artifact's; pre_topk
    and max_det change the fixed output shapes. The weights go to the device
    once, here."""
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.models.yolo_nano import predict

    dev = resolve_device(device)
    overrides = {k: v for k, v in (
        ("conf_thresh", conf_thresh), ("nms_thresh", nms_thresh),
        ("nms_pre_topk", pre_topk),
        ("max_detections", max_det)) if v is not None}
    model, cfg, meta = load_model(path, **overrides)
    if meta["dtype"] != "float32":
        raise ValueError(f"{path}: only float32 artifacts are supported")
    model = model.to(dev)
    size = meta["img_size"]

    def predict_fn(images: np.ndarray):
        images = np.asarray(images, np.float32)
        if images.ndim != 4 or images.shape[1:] != (size, size, 3):
            raise ValueError(f"images must be [B,{size},{size},3], got "
                             f"{images.shape}")
        x = torch.from_numpy(images).to(dev)
        out = predict(model, x, cfg, size)
        return tuple(t.cpu().numpy() for t in out)

    predict_fn.model = model
    predict_fn.cfg = cfg
    predict_fn.device = dev
    return predict_fn
