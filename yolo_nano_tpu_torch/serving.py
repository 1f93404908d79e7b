"""One-call loader: a folded `.npz` artifact → a batched predict function
(the JAX package's `serving.load_predictor`, parameter path), and batch
buckets for ragged serving traffic over the port's own batch table."""

from __future__ import annotations

import json
import os
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


def take_images(images, dev: torch.device, size: Optional[int] = None):
    """A predict function's input → (an f32 tensor on `dev`, whether it
    came as a tensor). Numpy images are copied there; a tensor must be on
    `dev` already and is taken as it is. They must be [B,S,S,3], with S
    `size` where one is given."""
    on_device = isinstance(images, torch.Tensor)
    if not on_device:
        images = np.asarray(images, np.float32)
    shape = tuple(images.shape)
    if (len(shape) != 4 or shape[3] != 3 or shape[1] != shape[2]
            or size not in (None, shape[1])):
        side = "S" if size is None else size
        raise ValueError(f"images must be [B,{side},{side},3], got {shape}")
    if not on_device:
        return torch.from_numpy(images).to(dev), False
    if images.device != dev:
        raise ValueError(f"images are on {images.device}, the model on {dev}")
    return images.float(), True


def hand_back(out, on_device: bool):
    """Detections as the caller gave the images: tensors on the device for
    a tensor, numpy arrays (copied back) for numpy images."""
    return out if on_device else tuple(t.cpu().numpy() for t in out)


def predictor(model, cfg, input_size: int, dev: torch.device,
              dtype: str) -> Callable:
    """predict_fn(images [B,S,S,3] float32) → detections, for a model
    already on `dev` in `dtype`: the images go to the device as f32 and are
    cast there, as the JAX package's `_predict_jit` casts them. Numpy
    images give numpy detections; a tensor already on `dev` is taken as it
    is and gives tensors on `dev`, fetched by nobody until the caller does
    (as the JAX package's predict_fn takes and gives device arrays)."""
    from yolo_nano_tpu_torch.models.yolo_nano import predict

    tdtype = DTYPES[dtype]
    model_dev = next(model.parameters()).device  # "cuda" with its index

    def predict_fn(images):
        x, on_device = take_images(images, model_dev, input_size)
        return hand_back(predict(model, x.to(tdtype), cfg, input_size),
                         on_device)

    predict_fn.model = model
    predict_fn.cfg = cfg
    predict_fn.input_size = input_size
    predict_fn.device = dev
    predict_fn.dtype = tdtype
    return predict_fn


def load_predictor(path: str, device=None,
                   batch_buckets=None,
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
    artifact's; pre_topk and max_det change the fixed output shapes. The
    weights go to the device once, here.

    batch_buckets (e.g. (1, 8, 32, 128), or "auto" for the ladder of the
    port's batch table through `default_buckets`): serve any batch size
    through a bounded set of batch shapes by zero-padding, each bucket run
    once here (`bucket_batches` with warmup)."""
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
    fn = predictor(model.to(dev), cfg, meta["img_size"], dev, dtype)
    if batch_buckets == "auto":
        batch_buckets = default_buckets(meta["img_size"], cfg.backbone)
    if not batch_buckets:
        return fn
    return bucket_batches(fn, batch_buckets,
                          (meta["img_size"], meta["img_size"], 3),
                          warmup=True)

# the serving batch table measured on the card by
# yolo_nano_tpu_torch/tools/autotune_batch.py
_AUTOTUNE_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "assets", "autotune_batch.json")


def optimal_batch(img_size: int, backbone: str = "1.0x",
                  default: int = 128, table_path: Optional[str] = None
                  ) -> int:
    """The throughput-optimal serving batch for (backbone, resolution) from
    the port's batch table (yolo_nano_tpu_torch/assets/autotune_batch.json,
    or `table_path`); a size never swept takes the nearest swept one, a
    backbone never swept or a missing table `default`."""
    path = table_path or _AUTOTUNE_TABLE
    if not os.path.exists(path):
        return default
    with open(path) as f:
        best = json.load(f).get("best", {})
    sizes = sorted({int(k.split("/")[1]) for k in best
                    if k.startswith(f"{backbone}/")})
    if not sizes:
        return default
    nearest = min(sizes, key=lambda s: abs(s - img_size))
    return int(best[f"{backbone}/{nearest}"]["batch"])


def default_buckets(img_size: int, backbone: str = "1.0x",
                    table_path: Optional[str] = None):
    """Batch buckets for ragged traffic: 1, 8 and 32 below the table's
    optimum, which tops the ladder. The small buckets bound the padding of
    light traffic; the top one serves bulk traffic at the best rate."""
    top = optimal_batch(img_size, backbone, table_path=table_path)
    return tuple([b for b in (1, 8, 32) if b < top] + [top])


def _fetch(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def bucket_batches(predict_fn: Callable, buckets, img_shape=None,
                   warmup: bool = False) -> Callable:
    """Serve any batch size through a bounded set of batch shapes: a batch
    is zero-padded up to the smallest bucket that fits, and the padded
    rows are sliced off the outputs (each image's result is its own); a
    batch larger than the top bucket goes in chunks of the top bucket.
    Every chunk is enqueued before any result is fetched: a predictor of
    this module (one with a `device`) gets each chunk as a tensor on its
    device and gives device tensors back, which are copied to the host
    only once all are enqueued.

    warmup=True (needs img_shape, e.g. (416, 416, 3)) runs every bucket
    once now: the kernels are built and cuDNN picks its algorithms for
    each shape at load time, not on the first live request."""
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    biggest = buckets[-1]
    dev = getattr(predict_fn, "device", None)

    def dispatch(chunk):
        """→ (predict output, not fetched; the real batch size)."""
        b = chunk.shape[0]
        bucket = next(k for k in buckets if k >= b)
        if isinstance(chunk, torch.Tensor):
            if bucket != b:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (bucket - b,) + tuple(chunk.shape[1:]))])
        else:
            chunk = np.asarray(chunk, np.float32)
            if bucket != b:
                chunk = np.concatenate([chunk, np.zeros(
                    (bucket - b,) + chunk.shape[1:], chunk.dtype)])
            if dev is not None:
                chunk = torch.from_numpy(chunk).to(dev)
        return predict_fn(chunk), b

    def wrapped(images):
        n = images.shape[0]
        if n == 0:
            raise ValueError("bucket_batches: empty batch (n=0), nothing "
                             "to dispatch")
        pending = [dispatch(images[lo:lo + biggest])
                   for lo in range(0, n, biggest)]
        parts = [[_fetch(t)[:b] for t in out] for out, b in pending]
        if len(parts) == 1:
            return tuple(parts[0])
        return tuple(np.concatenate([p[i] for p in parts], axis=0)
                     for i in range(len(parts[0])))

    wrapped.__dict__.update(getattr(predict_fn, "__dict__", {}))
    wrapped.buckets = buckets
    if warmup:
        if img_shape is None:
            raise ValueError("warmup=True requires img_shape")
        for k in buckets:
            wrapped(np.zeros((k,) + tuple(img_shape), np.float32))
    return wrapped
