"""One-call loader: a folded `.npz` artifact → a batched predict function
(the JAX package's `serving.load_predictor`, parameter path)."""

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


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def predictor(model, cfg, input_size: int, dev: torch.device,
              dtype: str) -> Callable:
    """predict_fn(images [B,S,S,3] float32) → numpy detections, for a model
    already on `dev` in `dtype`: the images go to the device as f32 and are
    cast there, as the JAX package's `_predict_jit` casts them."""
    from yolo_nano_tpu_torch.models.yolo_nano import predict

    tdtype = DTYPES[dtype]

    def predict_fn(images: np.ndarray):
        images = np.asarray(images, np.float32)
        if images.ndim != 4 or images.shape[1:] != (input_size,
                                                    input_size, 3):
            raise ValueError(f"images must be [B,{input_size},{input_size},"
                             f"3], got {images.shape}")
        x = torch.from_numpy(images).to(dev).to(tdtype)
        out = predict(model, x, cfg, input_size)
        return tuple(t.cpu().numpy() for t in out)

    predict_fn.model = model
    predict_fn.cfg = cfg
    predict_fn.input_size = input_size
    predict_fn.device = dev
    predict_fn.dtype = tdtype
    return predict_fn


def load_predictor(path: str, device=None,
                   conf_thresh: Optional[float] = None,
                   nms_thresh: Optional[float] = None,
                   diou_nms: Optional[bool] = None,
                   pre_topk: Optional[int] = None,
                   max_det: Optional[int] = None) -> Callable:
    """Load a folded artifact → predict_fn(images) → numpy (boxes [B,D,4],
    scores [B,D], classes [B,D] int32, valid [B,D] bool).

    `images`: [B, S, S, 3] float32 RGB, normalized like the JAX package's
    val_transform output; a bf16 artifact (`"dtype": "bfloat16"`) casts them
    to bf16 on the device. The thresholds and diou_nms override the
    artifact's; pre_topk and max_det change the fixed output shapes. The weights go to the device
    once, here."""
    from yolo_nano_tpu_torch.convert import load_model

    dev = resolve_device(device)
    overrides = {k: v for k, v in (
        ("conf_thresh", conf_thresh), ("nms_thresh", nms_thresh),
        ("diou_nms", diou_nms), ("nms_pre_topk", pre_topk),
        ("max_detections", max_det)) if v is not None}
    model, cfg, meta = load_model(path, **overrides)
    dtype = meta["dtype"]
    if dtype not in DTYPES:
        raise ValueError(f"{path}: dtype {dtype!r}; float32 and bfloat16 "
                         "artifacts are supported")
    found = {p.dtype for p in model.parameters()}
    if found != {DTYPES[dtype]}:
        raise ValueError(f"{path}: a {dtype} artifact holds {found} leaves")
    return predictor(model.to(dev), cfg, meta["img_size"], dev, dtype)
