"""PASCAL VOC detection metric — the VOC07 11-point protocol: the port's
copy of the JAX package's `evaluation/voc_eval.py`.

Same protocol as reference evaluator/vocapi_evaluator.py:160-337 (itself the
py-faster-rcnn eval), reimplemented in-memory: the reference round-trips
detections through per-class VOCdevkit .txt files and pickles; here the
evaluator passes arrays directly (artifact dumps are optional in the CLI).

Protocol details preserved exactly:
  * ground truth is the RAW XML pixel coordinates (no −1 shift —
    parse_rec, vocapi_evaluator.py:100-117);
  * detections are written 1-based before matching (vocapi_evaluator.py:155-157),
    so `voc_eval_class` expects detections already in the original image frame
    and adds the +1 itself;
  * greedy matching by max IoU with ovthresh 0.5; difficult gt neither
    count as npos nor penalize; duplicate matches are false positives;
  * AP = 11-point interpolation (use_07_metric=True) by default, with the
    area-under-curve variant available (vocapi_evaluator.py:199-231).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = True) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(
    detections: Sequence[Tuple[str, float, np.ndarray]],
    gt_by_image: Dict[str, Dict[str, np.ndarray]],
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """One class. detections: list of (image_id, score, box[4] 0-based original
    coords). gt_by_image: image_id → {'bbox': [G,4] raw XML coords,
    'difficult': [G] bool}. Returns (rec, prec, ap); ap = -1 with no dets
    (matching reference behavior vocapi_evaluator.py:333-336)."""
    npos = sum(int((~g["difficult"]).sum()) for g in gt_by_image.values())
    if not detections:
        return np.array(-1.0), np.array(-1.0), -1.0

    order = np.argsort(-np.asarray([d[1] for d in detections]))
    matched = {k: np.zeros(len(g["difficult"]), bool)
               for k, g in gt_by_image.items()}
    nd = len(detections)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for rank, di in enumerate(order):
        image_id, _, box = detections[di]
        bb = np.asarray(box, np.float64) + 1.0  # 1-based, like the .txt round-trip
        r = gt_by_image.get(image_id)
        ovmax, jmax = -np.inf, -1
        if r is not None and r["bbox"].size:
            gt = r["bbox"].astype(np.float64)
            ixmin = np.maximum(gt[:, 0], bb[0])
            iymin = np.maximum(gt[:, 1], bb[1])
            ixmax = np.minimum(gt[:, 2], bb[2])
            iymax = np.minimum(gt[:, 3], bb[3])
            inter = np.maximum(ixmax - ixmin, 0.0) * \
                np.maximum(iymax - iymin, 0.0)
            uni = ((bb[2] - bb[0]) * (bb[3] - bb[1])
                   + (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) - inter)
            overlaps = inter / uni
            ovmax = float(np.max(overlaps))
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not matched[image_id][jmax]:
                    tp[rank] = 1.0
                    matched[image_id][jmax] = True
                else:
                    fp[rank] = 1.0
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(float(npos), np.finfo(np.float64).eps)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
