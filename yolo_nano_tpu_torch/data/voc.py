"""Pascal VOC detection dataset (XML annotations): the port's copy of the
JAX package's `data/voc.py`.

Capability parity with reference data/voc.py: 20 classes, multi-split
(07+12 trainval default), difficult-object filtering, −1 pixel-origin shift,
percent-coordinate targets, mosaic option, raw accessors for evaluation.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import cv2
import numpy as np

from yolo_nano_tpu_torch.data.base import DetectionDatasetBase

# reference data/voc.py:17-22
VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
_CLASS_TO_IND = {c: i for i, c in enumerate(VOC_CLASSES)}


def parse_voc_xml(path: str, width: int, height: int,
                  keep_difficult: bool = False) -> List[List[float]]:
    """XML → [[x1, y1, x2, y2, label], ...] normalized, −1 origin shift
    (reference data/voc.py:43-71)."""
    root = ET.parse(path).getroot()
    res = []
    for obj in root.iter("object"):
        diff = obj.find("difficult")
        if not keep_difficult and diff is not None and int(diff.text) == 1:
            continue
        name = obj.find("name").text.lower().strip()
        bb = obj.find("bndbox")
        pts = []
        for i, pt in enumerate(("xmin", "ymin", "xmax", "ymax")):
            v = int(float(bb.find(pt).text)) - 1
            pts.append(v / width if i % 2 == 0 else v / height)
        pts.append(float(_CLASS_TO_IND[name]))
        res.append(pts)
    return res


class VOCDataset(DetectionDatasetBase):
    """VOCdevkit loader. data_dir points at VOCdevkit/ (containing VOC2007,
    VOC2012). image_sets like reference data/voc.py:94."""

    def __init__(self, data_dir: str, img_size: int = 640,
                 image_sets: Sequence[Tuple[str, str]] = (
                     ("2007", "trainval"), ("2012", "trainval")),
                 mosaic: bool = False, augment: bool = True,
                 keep_difficult: bool = False):
        self.root = data_dir
        self.img_size = img_size
        self.mosaic = mosaic
        self.augment = augment
        self.keep_difficult = keep_difficult
        self.num_classes = len(VOC_CLASSES)
        self.class_names = VOC_CLASSES
        self.ids: List[Tuple[str, str]] = []
        for year, name in image_sets:
            rootpath = osp.join(data_dir, "VOC" + year)
            with open(osp.join(rootpath, "ImageSets", "Main",
                               name + ".txt")) as f:
                self.ids.extend((rootpath, line.strip()) for line in f
                                if line.strip())

    def _img_path(self, img_id) -> str:
        return osp.join(img_id[0], "JPEGImages", img_id[1] + ".jpg")

    def _anno_path(self, img_id) -> str:
        return osp.join(img_id[0], "Annotations", img_id[1] + ".xml")

    def load_img_targets(self, index: int):
        """(img_bgr, target [M,5] normalized, h, w)
        (reference data/voc.py:127-137)."""
        img_id = self.ids[index]
        img = cv2.imread(self._img_path(img_id))
        assert img is not None, self._img_path(img_id)
        h, w = img.shape[:2]
        target = parse_voc_xml(self._anno_path(img_id), w, h,
                               self.keep_difficult)
        return img, np.asarray(target, np.float32).reshape(-1, 5), h, w

    def pull_image(self, index: int):
        """(raw BGR image, img_id) (reference data/voc.py:238-250)."""
        img_id = self.ids[index]
        return cv2.imread(self._img_path(img_id), cv2.IMREAD_COLOR), img_id

    def image_hw(self, index: int):
        """(h, w) from the annotation's <size> element — no JPEG decode.
        Falls back to decoding when the XML omits/zeroes the size."""
        root = ET.parse(self._anno_path(self.ids[index])).getroot()
        size = root.find("size")
        if size is not None:
            we, he = size.find("width"), size.find("height")
            if we is not None and he is not None and we.text and he.text:
                try:
                    w, h = int(float(we.text)), int(float(he.text))
                except ValueError:  # non-numeric text: decode instead
                    w = h = 0
                if h > 0 and w > 0:
                    return h, w
        return super().image_hw(index)

    def pull_anno(self, index: int):
        """(image name, [[x1,y1,x2,y2,label] in −1-shifted pixel coords])
        (reference data/voc.py:253-268)."""
        img_id = self.ids[index]
        gt = parse_voc_xml(self._anno_path(img_id), 1, 1, self.keep_difficult)
        return img_id[1], gt
