"""Native COCO bbox evaluation (AP@[.5:.95] protocol): the port's copy of
the JAX package's `evaluation/coco_eval.py`.

The reference evaluates through pycocotools' COCOeval C extension
(reference evaluator/cocoapi_evaluator.py:117-128). pycocotools is not
available in this image, so this module implements the standard COCO bbox
protocol directly from its definition (same parameterization as the official
evaluator):

  * IoU thresholds 0.50:0.05:0.95, 101-point recall grid;
  * area ranges all / small(<32²) / medium / large(>96²), maxDets 1/10/100;
  * crowd ground truths are ignore-matched with IoU = inter/det_area;
  * greedy per-detection matching in score order, preferring non-ignored gts;
  * unmatched detections outside the area range are ignored, not penalized;
  * precision envelope + interpolation at the recall grid, averaged over
    categories and thresholds.

Inputs are plain dicts in COCO json schema (annotations / results format), so
the module needs no pycocotools objects.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _bbox_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                   iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix [D, G] for xywh boxes; crowd gt → inter / det area."""
    if not len(dets) or not len(gts):
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.maximum(0, np.minimum(dx2[:, None], gx2) -
                    np.maximum(dx1[:, None], gx1))
    ih = np.maximum(0, np.minimum(dy2[:, None], gy2) -
                    np.maximum(dy1[:, None], gy1))
    inter = iw * ih
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = gts[:, 2] * gts[:, 3]
    union = np.where(iscrowd[None, :], d_area,
                     d_area + g_area[None, :] - inter)
    return inter / np.maximum(union, 1e-10)


class COCOEval:
    """gt_annotations: COCO 'annotations' dicts (bbox xywh, area, iscrowd,
    image_id, category_id). detections: COCO results dicts (+score)."""

    def __init__(self, gt_annotations: Iterable[dict],
                 image_ids: Sequence[int], category_ids: Sequence[int]):
        self.image_ids = list(image_ids)
        self.category_ids = list(category_ids)
        self._gts: Dict[tuple, List[dict]] = defaultdict(list)
        for g in gt_annotations:
            self._gts[(g["image_id"], g["category_id"])].append(g)

    def evaluate(self, detections: Iterable[dict],
                 verbose: bool = True) -> Dict[str, float]:
        dts: Dict[tuple, List[dict]] = defaultdict(list)
        for d in detections:
            dts[(d["image_id"], d["category_id"])].append(d)

        t_n = len(IOU_THRS)
        r_n = len(REC_THRS)
        k_n = len(self.category_ids)
        a_n = len(AREA_RNG)
        m_n = len(MAX_DETS)
        # precision[t, r, k, a, m]; recall[t, k, a, m]
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))

        area_items = list(AREA_RNG.items())
        for ki, cat in enumerate(self.category_ids):
            # per-image match results at maxDet=100, reused for all area rngs
            per_image = []
            for img in self.image_ids:
                gt = self._gts.get((img, cat), [])
                dt = sorted(dts.get((img, cat), []),
                            key=lambda d: -d["score"])[:max(MAX_DETS)]
                if not gt and not dt:
                    continue
                g_boxes = np.asarray([g["bbox"] for g in gt], np.float64
                                     ).reshape(-1, 4)
                g_crowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gt],
                                     dtype=bool)
                g_area = np.asarray([g.get("area", b[2] * b[3])
                                     for g, b in zip(gt, g_boxes)], np.float64
                                    ).reshape(-1)
                d_boxes = np.asarray([d["bbox"] for d in dt], np.float64
                                     ).reshape(-1, 4)
                d_scores = np.asarray([d["score"] for d in dt], np.float64)
                d_area = d_boxes[:, 2] * d_boxes[:, 3] if len(dt) else \
                    np.zeros(0)
                ious = _bbox_iou_xywh(d_boxes, g_boxes, g_crowd)
                per_image.append(dict(g_crowd=g_crowd, g_area=g_area,
                                      d_scores=d_scores, d_area=d_area,
                                      ious=ious))

            # one greedy match per image, vectorized over ALL (area range,
            # IoU threshold) pairs — the per-detection loop is the only
            # sequential part of the protocol
            rngs = [r for _, r in area_items]
            matches = [self._match_all(pi, rngs) for pi in per_image]
            for ai in range(a_n):
                evals = [{"scores": ev["scores"], "tp": ev["tp"][ai],
                          "ignore": ev["ignore"][ai],
                          "npig": int(ev["npig"][ai])} for ev in matches]
                for mi, max_det in enumerate(MAX_DETS):
                    scores, tps, igs, npig = [], [], [], 0
                    for ev in evals:
                        npig += ev["npig"]
                        nd = min(len(ev["scores"]), max_det)
                        scores.append(ev["scores"][:nd])
                        tps.append(ev["tp"][:, :nd])
                        igs.append(ev["ignore"][:, :nd])
                    if npig == 0:
                        continue
                    scores = np.concatenate(scores) if scores else np.zeros(0)
                    order = np.argsort(-scores, kind="mergesort")
                    tp = (np.concatenate(tps, 1) if tps else
                          np.zeros((t_n, 0)))[:, order]
                    ig = (np.concatenate(igs, 1) if igs else
                          np.zeros((t_n, 0), bool))[:, order]
                    for ti in range(t_n):
                        keep = ~ig[ti]
                        tpi = np.cumsum(tp[ti][keep])
                        fpi = np.cumsum((1 - tp[ti])[keep])
                        nd = len(tpi)
                        rc = tpi / npig
                        pr = tpi / np.maximum(tpi + fpi, 1e-10)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # precision envelope (monotone non-increasing)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.where(inds < nd, pr[np.minimum(inds, nd - 1)],
                                     0.0) if nd else np.zeros(r_n)
                        precision[ti, :, ki, ai, mi] = q

        def _ap(t=None, area="all", max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            p = precision[:, :, :, ai, mi]
            if t is not None:
                p = p[[np.argmin(np.abs(IOU_THRS - t))]]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def _ar(area="all", max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        stats = {
            "AP": _ap(), "AP50": _ap(t=0.5), "AP75": _ap(t=0.75),
            "APs": _ap(area="small"), "APm": _ap(area="medium"),
            "APl": _ap(area="large"),
            "AR1": _ar(max_det=1), "AR10": _ar(max_det=10),
            "AR100": _ar(max_det=100),
            "ARs": _ar(area="small"), "ARm": _ar(area="medium"),
            "ARl": _ar(area="large"),
        }
        if verbose:
            for k, v in stats.items():
                print(f" {k:>5} = {v:.4f}")
        return stats

    @staticmethod
    def _match_all(pi: dict, area_rngs: Sequence[tuple]) -> dict:
        """Greedy matching for one (image, category), vectorized across ALL
        (area range, IoU threshold) pairs at once — only the per-detection
        loop remains (each detection's match depends on which gts earlier,
        higher-scored detections already claimed).

        Semantics are exactly the reference protocol's greedy scan
        (pycocotools COCOeval.evaluateImg, the C path behind reference
        evaluator/cocoapi_evaluator.py:117-121), pinned by the golden
        fixtures + property tests of the JAX package (tests/test_coco_eval_*.py):
          * a detection first looks for the best non-ignored gt with
            IoU ≥ thr; only if none exists may it match an ignored gt;
          * already-matched gts are unavailable unless crowd;
          * ties break to the HIGHEST gt index within each preference class
            (the scan's `< best: continue` lets an equal IoU update the
            match, so the last maximum scanned wins);
          * an unmatched detection outside the area range is ignored.

        Returns tp [A,T,D], ignore [A,T,D] bool, npig [A], scores [D].
        """
        g_crowd, g_area = pi["g_crowd"], pi["g_area"]
        d_scores, d_area, ious = pi["d_scores"], pi["d_area"], pi["ious"]
        t_n, a_n = len(IOU_THRS), len(area_rngs)
        g_n, d_n = len(g_area), len(d_scores)
        lo = np.asarray([r[0] for r in area_rngs])
        hi = np.asarray([r[1] for r in area_rngs])
        g_ignore = (g_crowd[None, :] | (g_area[None, :] < lo[:, None])
                    | (g_area[None, :] > hi[:, None]))          # [A,G]
        d_outside = ((d_area[None, :] < lo[:, None])
                     | (d_area[None, :] > hi[:, None]))         # [A,D]
        tp = np.zeros((a_n, t_n, d_n))
        dt_ig = np.zeros((a_n, t_n, d_n), bool)
        npig = (~g_ignore).sum(1)
        if g_n == 0:
            dt_ig[:] = d_outside[:, None, :]
            return {"scores": d_scores, "tp": tp, "ignore": dt_ig,
                    "npig": npig}
        thr = np.minimum(IOU_THRS, 1 - 1e-10)[None, :, None]    # [1,T,1]
        gi = g_ignore[:, None, :]                               # [A,1,G]
        crowd = g_crowd[None, None, :]                          # [1,1,G]
        matched = np.zeros((a_n, t_n, g_n), bool)
        a_idx = np.arange(a_n)[:, None]
        t_idx = np.arange(t_n)[None, :]
        for di in range(d_n):
            iou = ious[di][None, None, :]                       # [1,1,G]
            ok = (iou >= thr) & (~matched | crowd)              # [A,T,G]
            ok_pref = ok & ~gi
            has_pref = ok_pref.any(-1)                          # [A,T]
            use = np.where(has_pref[..., None], ok_pref, ok & gi)
            sel = use.any(-1)                                   # [A,T]
            # last-occurrence argmax = highest-index tie-break (the scan's
            # equal-IoU update); argmax alone would keep the first maximum
            cand = np.where(use, iou, -1.0)                     # [A,T,G]
            best = g_n - 1 - cand[..., ::-1].argmax(-1)         # [A,T]
            matched[a_idx, t_idx, best] |= sel
            best_ig = g_ignore[a_idx * np.ones_like(best), best]
            tp[:, :, di] = sel & ~best_ig
            dt_ig[:, :, di] = np.where(sel, best_ig,
                                       d_outside[:, None, di])
        return {"scores": d_scores, "tp": tp, "ignore": dt_ig, "npig": npig}
