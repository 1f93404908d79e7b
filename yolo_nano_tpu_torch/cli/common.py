"""Shared CLI plumbing: `build_config`, the per-dataset model config,
`make_predict_fn`, which makes a batched predict function, the class names
and box drawing (the JAX package's `cli/common.py`)."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from yolo_nano_tpu_torch.config import (
    MULTI_ANCHOR_SIZE,
    MULTI_ANCHOR_SIZE_COCO,
    YoloNanoConfig,
)


def build_config(dataset: str, backbone: str = "1.0x",
                 conf_thresh: float = 0.001, nms_thresh: float = 0.50,
                 diou_nms: bool = False, **overrides) -> YoloNanoConfig:
    """One source of truth for the per-dataset model config: VOC's 20
    classes and anchors, or COCO's 80 ("coco", "coco-val", "coco-test"),
    with the thresholds and any other config field given."""
    if dataset == "voc":
        base = dict(num_classes=20, anchors=MULTI_ANCHOR_SIZE)
    elif dataset.startswith("coco"):
        base = dict(num_classes=80, anchors=MULTI_ANCHOR_SIZE_COCO)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    base.update(backbone=backbone, conf_thresh=conf_thresh,
                nms_thresh=nms_thresh, diou_nms=diou_nms, **overrides)
    return YoloNanoConfig(**base)


def class_names_for(dataset: str) -> Sequence[str]:
    """Display names by class index: VOC's 20, or COCO's 80 in the order
    of their sorted category ids (as COCODataset maps them)."""
    from yolo_nano_tpu_torch.data.coco import (COCO_80_CAT_IDS,
                                               COCO_CLASS_LABELS)
    from yolo_nano_tpu_torch.data.voc import VOC_CLASSES

    if dataset == "voc":
        return VOC_CLASSES
    return [COCO_CLASS_LABELS[c] for c in COCO_80_CAT_IDS]


def draw_detections(img_bgr: np.ndarray, boxes: np.ndarray,
                    scores: np.ndarray, classes: np.ndarray,
                    class_names: Sequence[str],
                    vis_thresh: float = 0.3) -> np.ndarray:
    """A copy of a BGR image with each detection scoring vis_thresh or more
    drawn: its box and "name: score" in its class's colour."""
    import cv2

    rng = np.random.default_rng(0)
    colors = rng.integers(0, 255, (len(class_names), 3)).tolist()
    out = img_bgr.copy()
    for b, s, c in zip(boxes, scores, classes):
        if s < vis_thresh:
            continue
        c = int(c)
        x1, y1, x2, y2 = (int(v) for v in b)
        color = tuple(int(v) for v in colors[c % len(colors)])
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        label = f"{class_names[c]}: {s:.2f}"
        th = max(y1 - 6, 10)
        cv2.putText(out, label, (x1, th), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                    color, 1, lineType=cv2.LINE_AA)
    return out


def card_line(dev) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line for a CUDA
    device (every number measured on it is stated with it); else the
    device's name."""
    import subprocess

    import torch

    dev = torch.device(dev)
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i",
                          str(dev.index or 0)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_predict_fn(params, stats, cfg: YoloNanoConfig, input_size: int,
                    fold: bool = True, dtype: str = "bfloat16",
                    mesh=None, process_shard=None, local_rows: bool = False,
                    device=None) -> Callable:
    """Batched inference closure: images [B,S,S,3] float32 → numpy
    (boxes, scores, classes int32, valid bool).

    `params` and `stats` are JAX-layout trees of numpy arrays (a port
    `TrainState` gives them through `convert.tree_from_named`); `stats` may
    be None for a folded tree. With `fold`, every conv+BN unit is folded
    at build time; with dtype "bfloat16", every f32 parameter is cast to
    bf16 (`cast_f32_to_bf16`) and the images are cast on the device. The
    weights go to the device (CUDA unless `device` names another; with a
    mesh, this process's device in it) once, here.

    With `mesh` (parallel.mesh) inference spreads over the process group:
    each process runs its rows of the batch (which must divide by the mesh
    size) through its copy of the model, and the fixed-shape detections of
    all rows are gathered, the same on every process
    (`serving.shard_predictor`). The closure takes the whole global batch;
    `process_shard` = (process index, count), this process's place in the
    mesh, with `local_rows=True` makes it take only this process's rows
    [B/count, S, S, 3], as EvalLoader(process_shard=…) decodes them."""
    from yolo_nano_tpu_torch.convert import build_yolo_nano
    from yolo_nano_tpu_torch.serving import (
        DTYPES, predictor, resolve_device, shard_predictor)
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    if local_rows and process_shard is None:
        raise ValueError("local_rows=True only makes sense with "
                         "process_shard (multi-process mode)")
    if mesh is None and process_shard is not None:
        raise ValueError("process_shard needs a global mesh")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    if mesh is not None:
        from yolo_nano_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    dev = resolve_device(device)
    model = build_yolo_nano(params, stats, cfg)
    if fold:
        model = fold_bn(model)
    if dtype == "bfloat16":
        model = cast_f32_to_bf16(model)
    fn = predictor(model.to(dev), cfg, input_size, dev, dtype)
    if mesh is None:
        return fn
    return shard_predictor(fn, mesh, process_shard, local_rows)
