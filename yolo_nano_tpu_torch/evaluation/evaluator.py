"""Batched dataset evaluators: the port's copy of the JAX package's
`evaluation/evaluator.py`.

The reference evaluators run a python loop over single images with a
device→host hop per image (reference evaluator/vocapi_evaluator.py:58-89,
cocoapi_evaluator.py:65-87). Here inference is batched through a fixed-shape
predict function; only the final detections (max_det per image) return to
host. The letterbox-undo math matches the reference exactly (bboxes
−offset, /scale, ×[w,h,w,h], vocapi_evaluator.py:72-74).

Both evaluators take `predict_fn(images [B,S,S,3]) → (boxes [B,D,4] normalized
corners, scores [B,D], classes [B,D], valid [B,D])` as numpy — the port's
`serving.predictor` closures (`load_predictor`, `cli.common.make_predict_fn`)
or any other function of that contract.

Precision: the port's `models.yolo_nano.predict` calls `set_full_f32()`,
which turns TF32 off for cuDNN convolutions and matmuls for the whole
process, and leaves it off. The JAX package has no such global. A caller
must therefore set its own precision explicitly, not rely on whatever the
last `predict` left: `cli/eval.py` sets full f32 before it builds the
predictor, and `cli/train.py` sets full f32 for training once at its start
and raises if its eval hook leaves the flags (`precision_flags()`) other
than it found them (tests/test_torch_train_cli.py).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Callable, Dict, List

import numpy as np

from yolo_nano_tpu_torch.data.loader import EvalLoader
from yolo_nano_tpu_torch.data.voc import VOC_CLASSES, VOCDataset
from yolo_nano_tpu_torch.evaluation.coco_eval import COCOEval
from yolo_nano_tpu_torch.evaluation.voc_eval import voc_eval_class


def parse_rec_raw(path: str) -> List[dict]:
    """Raw-pixel VOC annotations for evaluation (reference
    evaluator/vocapi_evaluator.py:100-117 — note: no −1 shift here)."""
    objects = []
    for obj in ET.parse(path).getroot().findall("object"):
        bbox = obj.find("bndbox")
        diff = obj.find("difficult")
        objects.append({
            "name": obj.find("name").text,
            "difficult": int(diff.text) if diff is not None else 0,
            "bbox": [int(float(bbox.find(k).text))
                     for k in ("xmin", "ymin", "xmax", "ymax")],
        })
    return objects


def _run_batched(dataset, img_size: int, batch_size: int,
                 predict_fn: Callable, num_workers: int = 4,
                 verbose: bool = True, process_shard=None):
    """Yields (meta, boxes [D,4] original-frame pixels, scores [D],
    classes [D]) per real image.

    Batch i+1's predict_fn is called before batch i's detections are
    unpacked, as in the JAX package, where that call only dispatches. The
    port's predictors return numpy, so there the call finishes on the card
    before the host goes on.

    process_shard=(pid, count) under data parallelism: the loader decodes
    only this process's rows of each global batch (EvalLoader); predict_fn
    must be a make_predict_fn(..., process_shard=…, local_rows=True)
    closure, whose gathered detections cover the whole global batch, so
    the per-image stream below is the same on every process, and the same
    as one process's."""
    loader = EvalLoader(dataset, img_size, batch_size, num_workers,
                        process_shard=process_shard)
    done = 0

    def batches():
        pending = None
        for images, metas in loader:
            out = predict_fn(images)
            if pending is not None:
                yield pending
            pending = (out, metas)
        if pending is not None:
            yield pending

    for out, metas in batches():
        boxes, scores, classes, valid = (np.asarray(t) for t in out)
        for bi, meta in enumerate(metas):
            v = valid[bi]
            b = boxes[bi][v]
            # letterbox undo (reference vocapi_evaluator.py:72-74)
            b = (b - meta["offset"]) / meta["scale"]
            b = b * np.array([meta["w"], meta["h"], meta["w"], meta["h"]],
                             np.float32)
            yield meta, b, scores[bi][v], classes[bi][v]
        done += len(metas)
        if verbose and done % 500 < batch_size:
            print(f"[eval {done}/{len(dataset)}]")


class VOCEvaluator:
    """VOC07-test mAP (reference evaluator/vocapi_evaluator.py)."""

    def __init__(self, data_dir: str, img_size: int, set_type: str = "test",
                 year: str = "2007", batch_size: int = 32,
                 num_workers: int = 4, display: bool = False,
                 dump_dir: str | None = None, process_shard=None):
        self.dataset = VOCDataset(data_dir, img_size=img_size,
                                  image_sets=[(year, set_type)],
                                  augment=False, keep_difficult=True)
        self.img_size = img_size
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.display = display
        self.set_type = set_type
        self.dump_dir = dump_dir
        self.process_shard = process_shard
        self.map = 0.0
        self.aps: Dict[str, float] = {}
        self.gt_npos: Dict[str, int] = {}  # non-difficult gt per class;
        # distinguishes "AP 0.0 because only spurious detections exist for a
        # class with NO gt" from a genuinely-failed present class
        self._gt_cache: Dict[str, List[dict]] = {}  # parsed once, reused
        # (the reference pickles parsed annotations for the same reason,
        # vocapi_evaluator.py:241-257)
        self._gt_by_class: Dict[str, dict] = {}  # per-class tables, ditto

    def evaluate(self, predict_fn: Callable) -> float:
        per_class: List[List] = [[] for _ in VOC_CLASSES]
        for meta, boxes, scores, classes in _run_batched(
                self.dataset, self.img_size, self.batch_size, predict_fn,
                self.num_workers, verbose=self.display,
                process_shard=self.process_shard):
            name = meta["id"][1]
            for b, s, c in zip(boxes, scores, classes):
                per_class[int(c)].append((name, float(s), b))

        if self.dump_dir:
            self._dump_detections(per_class)

        # raw-XML ground truth per class (parsed + tabulated on the first
        # evaluate only — a training eval hook calls this every N epochs)
        if not self._gt_cache:
            for idx in range(len(self.dataset)):
                img_id = self.dataset.ids[idx]
                self._gt_cache[img_id[1]] = parse_rec_raw(
                    self.dataset._anno_path(img_id))
            for cls in VOC_CLASSES:
                self._gt_by_class[cls] = {
                    name: {
                        "bbox": np.array(
                            [o["bbox"] for o in recs if o["name"] == cls]
                        ).reshape(-1, 4),
                        "difficult": np.array(
                            [bool(o["difficult"]) for o in recs
                             if o["name"] == cls], bool),
                    } for name, recs in self._gt_cache.items()}
            for cls, tab in self._gt_by_class.items():
                self.gt_npos[cls] = sum(
                    int((~g["difficult"]).sum()) for g in tab.values())

        aps = []
        for ci, cls in enumerate(VOC_CLASSES):
            _, _, ap = voc_eval_class(per_class[ci], self._gt_by_class[cls],
                                      ovthresh=0.5, use_07_metric=True)
            self.aps[cls] = ap
            aps.append(ap)
            if self.display:
                print(f"AP for {cls} = {ap:.4f}")
        self.map = float(np.mean(aps))
        print(f"Mean AP = {self.map:.4f}")
        return self.map

    def _dump_detections(self, per_class: List[List]) -> None:
        """Write the artifacts downstream error-analysis tooling consumes:
        per-class VOCdevkit-style results .txt (1-based pixel coords, same
        line format as reference vocapi_evaluator.py:142-157) and a
        detections.pkl table (reference vocapi_evaluator.py:91-92)."""
        import os
        import pickle

        results_dir = os.path.join(self.dump_dir, "results")
        os.makedirs(results_dir, exist_ok=True)
        all_boxes: Dict[str, Dict[str, np.ndarray]] = {}
        for ci, cls in enumerate(VOC_CLASSES):
            by_image: Dict[str, list] = {}
            for name, score, b in per_class[ci]:
                by_image.setdefault(name, []).append([*b, score])
            all_boxes[cls] = {n: np.asarray(v, np.float32)
                              for n, v in by_image.items()}
            path = os.path.join(results_dir,
                                f"det_{self.set_type}_{cls}.txt")
            with open(path, "w") as f:
                for img_id in self.dataset.ids:
                    name = img_id[1]
                    for det in all_boxes[cls].get(name, ()):
                        # VOCdevkit expects 1-based indices
                        f.write(f"{name} {det[4]:.3f} {det[0] + 1:.1f} "
                                f"{det[1] + 1:.1f} {det[2] + 1:.1f} "
                                f"{det[3] + 1:.1f}\n")
        with open(os.path.join(self.dump_dir, "detections.pkl"), "wb") as f:
            pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
        print(f"dumped detections to {self.dump_dir}")


class COCOEvaluator:
    """COCO-val AP (reference evaluator/cocoapi_evaluator.py), with the
    pycocotools protocol implemented natively (evaluation/coco_eval.py)."""

    def __init__(self, data_dir: str, img_size: int,
                 image_set: str = "val2017", batch_size: int = 32,
                 num_workers: int = 4, testset: bool = False,
                 dump_path: str | None = None, process_shard=None):
        from yolo_nano_tpu_torch.data.coco import COCODataset

        self.dataset = COCODataset(data_dir, image_set=image_set,
                                   img_size=img_size, augment=False)
        self.img_size = img_size
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.testset = testset
        self.dump_path = dump_path
        self.process_shard = process_shard
        self.map = 0.0
        self.ap50_95 = 0.0
        self.ap50 = 0.0
        self.stats: Dict[str, float] = {}

    def evaluate(self, predict_fn: Callable):
        data_dict = []
        for meta, boxes, scores, classes in _run_batched(
                self.dataset, self.img_size, self.batch_size, predict_fn,
                self.num_workers, process_shard=self.process_shard):
            img_id = int(meta["id"])
            for b, s, c in zip(boxes, scores, classes):
                if int(c) >= len(self.dataset.class_ids):
                    # model heads may cover more classes than the annotation
                    # file declares (e.g. reduced-category subsets)
                    continue
                # xywh COCO result format (reference cocoapi_evaluator.py:94-99)
                data_dict.append({
                    "image_id": img_id,
                    "category_id": self.dataset.class_ids[int(c)],
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "score": float(s),
                })
        if self.testset:
            import json
            import os

            path = self.dump_path or "coco_test-dev.json"
            if os.path.dirname(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(data_dict, f)
            return -1.0, -1.0
        if self.dump_path:
            # results json for val runs too — the reference only keeps a
            # tempfile here (cocoapi_evaluator.py:114-116), leaving nothing
            # for error analysis / resubmission
            import json
            import os

            if os.path.dirname(self.dump_path):
                os.makedirs(os.path.dirname(self.dump_path), exist_ok=True)
            with open(self.dump_path, "w") as f:
                json.dump(data_dict, f)
            print(f"dumped detections to {self.dump_path}")
        if not data_dict:
            return 0.0, 0.0
        gt_anns = [a for anns in self.dataset._anns.values() for a in anns]
        ev = COCOEval(gt_anns, self.dataset.ids, self.dataset.class_ids)
        self.stats = ev.evaluate(data_dict)
        self.ap50_95 = self.stats["AP"]
        self.ap50 = self.stats["AP50"]
        self.map = self.ap50_95
        return self.ap50, self.ap50_95
