"""Shared CLI plumbing: `make_predict_fn`, which makes a batched predict
function (the JAX package's `cli/common.py::make_predict_fn`, its
single-device branch)."""

from __future__ import annotations

from typing import Callable

from yolo_nano_tpu_torch.config import YoloNanoConfig


def make_predict_fn(params, stats, cfg: YoloNanoConfig, input_size: int,
                    fold: bool = True, dtype: str = "bfloat16",
                    mesh=None, process_shard=None, device=None) -> Callable:
    """Batched inference closure: images [B,S,S,3] float32 → numpy
    (boxes, scores, classes int32, valid bool).

    `params` and `stats` are JAX-layout trees of numpy arrays (a port
    `TrainState` gives them through `convert.tree_from_named`); `stats` may
    be None for a folded tree. With `fold`, every conv+BN unit is folded
    at build time; with dtype "bfloat16", every f32 parameter is cast to
    bf16 (`cast_f32_to_bf16`) and the images are cast on the device. The
    weights go to the device (CUDA unless `device` names another) once,
    here. `mesh` and `process_shard` belong to the multi-device branches,
    which the port does not have yet: either raises."""
    from yolo_nano_tpu_torch.convert import build_yolo_nano
    from yolo_nano_tpu_torch.serving import DTYPES, predictor, resolve_device
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    if mesh is not None or process_shard is not None:
        raise NotImplementedError("make_predict_fn: mesh and process_shard "
                                  "need the port's data parallelism, which "
                                  "is not ported yet")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    dev = resolve_device(device)
    model = build_yolo_nano(params, stats, cfg)
    if fold:
        model = fold_bn(model)
    if dtype == "bfloat16":
        model = cast_f32_to_bf16(model)
    return predictor(model.to(dev), cfg, input_size, dev, dtype)
