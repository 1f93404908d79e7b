"""COCO detection dataset backed by a lightweight in-repo JSON index: the
port's copy of the JAX package's `data/coco.py`.

Capability parity with reference data/coco.py:36-259, with pycocotools
replaced by a plain-json index (this image ships no pycocotools; the COCO
instances schema is simple enough to parse directly — see also
yolo_nano_tpu_torch.evaluation.coco_eval for the matching evaluator).

Box sanitation matches the reference exactly (data/coco.py:106-118): clamp to
[0, size−1], derive xmax from xmin + max(0, w−1), keep only positive-area
boxes, classes are the contiguous index into sorted category ids.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import cv2
import numpy as np

from yolo_nano_tpu_torch.data.base import DetectionDatasetBase

# 91-entry display-name table (reference data/coco.py:15-28)
COCO_CLASS_LABELS = (
    'background', 'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
    'train', 'truck', 'boat', 'traffic light', 'fire hydrant', 'street sign',
    'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse',
    'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'hat', 'backpack',
    'umbrella', 'shoe', 'eye glasses', 'handbag', 'tie', 'suitcase', 'frisbee',
    'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
    'baseball glove', 'skateboard', 'surfboard', 'tennis racket', 'bottle',
    'plate', 'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl', 'banana',
    'apple', 'sandwich', 'orange', 'broccoli', 'carrot', 'hot dog', 'pizza',
    'donut', 'cake', 'chair', 'couch', 'potted plant', 'bed', 'mirror',
    'dining table', 'window', 'desk', 'toilet', 'door', 'tv', 'laptop',
    'mouse', 'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
    'toaster', 'sink', 'refrigerator', 'blender', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush',
)

# the 11 ids of the 91-entry table with no annotations in COCO2017
# (background + the 10 never-annotated names); the kept 80, in sorted-id
# order, ARE the model's contiguous class indices — the same mapping
# COCODataset derives at runtime from the annotation file's categories
_COCO_UNANNOTATED = ('background', 'street sign', 'hat', 'shoe',
                     'eye glasses', 'plate', 'mirror', 'window', 'desk',
                     'door', 'blender')
COCO_80_CAT_IDS = tuple(i for i, name in enumerate(COCO_CLASS_LABELS)
                        if name not in _COCO_UNANNOTATED)


class COCODataset(DetectionDatasetBase):
    """data_dir: COCO root containing annotations/ and {split}/ image dirs."""

    def __init__(self, data_dir: str, image_set: str = "train2017",
                 img_size: int = 640, mosaic: bool = False,
                 augment: bool = True):
        json_file = {
            "train2017": "instances_train2017.json",
            "val2017": "instances_val2017.json",
            "test2017": "image_info_test-dev2017.json",
        }[image_set]
        self.data_dir = data_dir
        self.image_set = image_set
        self.img_size = img_size
        self.mosaic = mosaic
        self.augment = augment

        with open(os.path.join(data_dir, "annotations", json_file)) as f:
            blob = json.load(f)
        self.images: List[dict] = blob["images"]
        self.class_ids = sorted(c["id"] for c in blob.get("categories", []))
        self._cat_to_contig = {c: i for i, c in enumerate(self.class_ids)}
        self.num_classes = len(self.class_ids) or 80
        self._anns: Dict[int, List[dict]] = {}
        for ann in blob.get("annotations", []):
            self._anns.setdefault(ann["image_id"], []).append(ann)
        self.ids = [im["id"] for im in self.images]
        self._img_info = {im["id"]: im for im in self.images}

    def _img_path(self, img_id: int) -> str:
        info = self._img_info[img_id]
        name = info.get("file_name", "{:012}.jpg".format(img_id))
        return os.path.join(self.data_dir, self.image_set, name)

    def image_hw(self, index: int):
        """(h, w) from the instances-json images index — no JPEG decode.
        Falls back to decoding when the index omits the dims."""
        info = self._img_info[self.ids[index]]
        h, w = info.get("height", 0), info.get("width", 0)
        if h > 0 and w > 0:
            return int(h), int(w)
        return super().image_hw(index)

    def load_img_targets(self, index: int):
        """(img_bgr, target [M,5] normalized, h, w)
        (reference data/coco.py:85-126 semantics)."""
        img_id = self.ids[index]
        img = cv2.imread(self._img_path(img_id))
        assert img is not None, self._img_path(img_id)
        height, width = img.shape[:2]
        target = []
        for anno in self._anns.get(img_id, ()):
            if "bbox" in anno and anno.get("area", 0) > 0:
                x, y, bw, bh = anno["bbox"]
                xmin = max(0.0, x)
                ymin = max(0.0, y)
                xmax = min(width - 1.0, xmin + max(0.0, bw - 1.0))
                ymax = min(height - 1.0, ymin + max(0.0, bh - 1.0))
                if xmax > xmin and ymax > ymin:
                    cls_id = self._cat_to_contig[anno["category_id"]]
                    target.append([xmin / width, ymin / height,
                                   xmax / width, ymax / height,
                                   float(cls_id)])
        return img, np.asarray(target, np.float32).reshape(-1, 5), height, width

    def pull_image(self, index: int):
        img_id = self.ids[index]
        return cv2.imread(self._img_path(img_id), cv2.IMREAD_COLOR), img_id
