"""Typed configuration: the port's own copy of the JAX package's tables.

Anchor tables are the reference k-means anchors (pixel units); the channel
tables and repeats are ShuffleNetV2's. The port keeps its own copy so that it
imports nothing of the JAX package.

Two model families: YOLO-Nano (`YoloNanoConfig`, the JAX package's model)
and NanoDet-Plus (`NanoDetPlusConfig`, RangiLyu/nanodet's anchor-free
detector on the same ShuffleNetV2 backbone). An artifact's meta names its
family under the key "model"; without it the artifact is YOLO-Nano.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

IGNORE_THRESH = 0.5

# VOC, 9 anchors, 3 per stride level
MULTI_ANCHOR_SIZE = (
    (30.65, 39.12), (50.3, 102.62), (94.98, 64.55),
    (93.5, 177.51), (165.25, 113.85), (161.83, 240.95),
    (304.64, 150.34), (251.28, 306.53), (369.38, 261.55),
)

# COCO
MULTI_ANCHOR_SIZE_COCO = (
    (11.89, 14.24), (30.14, 35.62), (45.99, 87.04),
    (92.23, 44.43), (130.78, 99.73), (78.99, 170.81),
    (290.39, 123.89), (165.27, 233.33), (332.57, 279.8),
)

# ShuffleNetV2 channel tables: stem, stage2, stage3, stage4, (unused conv5)
SHUFFLENETV2_CHANNELS = {
    "0.5x": (24, 48, 96, 192, 1024),
    "1.0x": (24, 116, 232, 464, 1024),
    "1.5x": (24, 176, 352, 704, 1024),
    "2.0x": (24, 244, 488, 976, 2048),
}
SHUFFLENETV2_REPEATS = (4, 8, 4)


@dataclasses.dataclass(frozen=True)
class YoloNanoConfig:
    """Static model/build configuration."""

    num_classes: int = 20
    backbone: str = "1.0x"  # any of SHUFFLENETV2_CHANNELS keys
    anchors: Tuple[Tuple[float, float], ...] = MULTI_ANCHOR_SIZE
    strides: Tuple[int, ...] = (8, 16, 32)
    neck_channels: int = 96
    ignore_thresh: float = IGNORE_THRESH
    # postprocess
    conf_thresh: float = 0.001
    nms_thresh: float = 0.50
    diou_nms: bool = False
    # fixed-shape NMS budget
    nms_pre_topk: int = 512   # candidates entering NMS (per image)
    max_detections: int = 128  # final detections per image
    # compute dtype for activations ("float32" or "bfloat16")
    compute_dtype: str = "float32"

    @property
    def num_anchors_per_level(self) -> int:
        return len(self.anchors) // len(self.strides)

    @property
    def backbone_channels(self) -> Tuple[int, ...]:
        return SHUFFLENETV2_CHANNELS[self.backbone]

    @property
    def head_out_channels(self) -> int:
        # A * (1 + C + 4)
        return self.num_anchors_per_level * (1 + self.num_classes + 4)

    def num_cells(self, input_size: int) -> int:
        """Total grid cells Σ (H/s · W/s) across levels for a square input."""
        return sum((input_size // s) * (input_size // s) for s in self.strides)

    def num_predictions(self, input_size: int) -> int:
        """Total predictions N = Σ HW·A across levels."""
        return self.num_cells(input_size) * self.num_anchors_per_level


NANODET_PLUS = "nanodet_plus"  # an artifact meta's "model" of that family


@dataclasses.dataclass(frozen=True)
class NanoDetPlusConfig:
    """NanoDet-Plus (RangiLyu/nanodet, `config/nanodet-plus-m-*.yml`):
    ShuffleNetV2 with LeakyReLU(0.1), GhostPAN of `neck_channels` with
    `kernel_size` depthwise convs and one extra level, one GFL head a level
    (two dw→pw pairs, then a 1×1 to num_classes + 4·(reg_max + 1)).
    Scores are sigmoid(class logit) per (prior, class) pair (multi-label);
    the thresholds are NanoDet's own (`multiclass_nms`: score > 0.05, IoU
    0.6, 100 kept) with the fixed pre-top-k over pairs that a fixed-shape
    postprocess needs."""

    num_classes: int = 80
    backbone: str = "1.5x"  # any of SHUFFLENETV2_CHANNELS keys
    strides: Tuple[int, ...] = (8, 16, 32, 64)
    neck_channels: int = 128
    kernel_size: int = 5
    reg_max: int = 7
    conf_thresh: float = 0.05
    nms_thresh: float = 0.6
    diou_nms: bool = False
    nms_pre_topk: int = 1000  # (prior, class) pairs entering NMS
    max_detections: int = 100
    compute_dtype: str = "float32"

    @property
    def backbone_channels(self) -> Tuple[int, ...]:
        return SHUFFLENETV2_CHANNELS[self.backbone]

    @property
    def head_out_channels(self) -> int:
        return self.num_classes + 4 * (self.reg_max + 1)

    def level_sides(self, input_size: int) -> Tuple[int, ...]:
        """Feature-map side of each level: ceil(size / stride), as NanoDet's
        `get_bboxes` lays its priors."""
        return tuple(-(-input_size // s) for s in self.strides)

    def num_predictions(self, input_size: int) -> int:
        """Priors N = Σ side² over the levels (3,598 at 416 px)."""
        return sum(h * h for h in self.level_sides(input_size))


def config_from_json(meta: dict, **overrides):
    """An artifact's `config.json` content → its family's config
    (`NanoDetPlusConfig` where meta["model"] is "nanodet_plus", else
    YoloNanoConfig), JSON lists back to the tuples the frozen dataclasses
    expect."""
    raw = dict(meta["config"])
    raw["strides"] = tuple(raw["strides"])
    raw.update(overrides)
    if meta.get("model") == NANODET_PLUS:
        return NanoDetPlusConfig(**raw)
    raw["anchors"] = tuple(tuple(a) for a in raw["anchors"])
    return YoloNanoConfig(**raw)


# the key of an artifact's config.json content in its .npz
CONFIG_KEY = "config.json"


def read_meta(path: str) -> dict:
    """A folded `.npz` artifact's config.json content (config, img_size,
    dtype, folded, dataset, graph), without reading its weights."""
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z[CONFIG_KEY]))
