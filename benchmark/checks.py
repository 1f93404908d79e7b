"""What decides `correct`: the numbers by which the program's outputs are
held to the reference's, each against a limit set in the workload's file.

Detection, per image, the program's detections (valid slots) against the
reference's dense outputs and its candidates:

  * `det_gap`: for each detection scoring at least `LOW_SCORE`, the
    distance to the nearest reference row of its class, max(|box - row's
    box|_inf, |score - row's class probability|); the worst detection. A
    detection stands for one row of the head's output, so in a sound run
    this is the rounding the forward, the scores and the decode carry.
  * `det_gap_low`: for each image, the mean of the same distance over
    its detections scoring under `LOW_SCORE`, which only an operating
    point with a lower `conf_thresh` keeps; the worst image. These are a
    hundred and more an image, mostly rows of the largest anchors on
    background, whose widest gap reads about as high in bf16 as in
    float8; their mean keeps the two apart.
  * `det_select`: how far the program's choice of detections lies from a
    choice the reference can explain. Every reference candidate (score at
    least conf, within pre-top-k) has to be matched or suppressed: matched
    by a detection of its class or by itself with another class at a near
    tie, or suppressed by a detection of its class that scores higher and
    overlaps it by more than the NMS threshold. Each candidate reads the
    least of: its score above conf, above the best score pre-top-k left
    out, above the program's last detection when max-det is full, and the
    margin by which its best match or suppressor misses (NMS threshold
    minus IoU, its score minus the suppressor's; 1 - IoU, the score gap
    and the class-probability gap for another class). Two detections of
    one class kept though they overlap by more than the threshold read
    their IoU minus the threshold. The worst of these, and at least 0.
    Near ties (a score at conf, two scores equal, an IoU at the threshold)
    read their small margin; a detection dropped or invented reads its
    score, a suppression missed reads its overlap.

Training, over the first three steps from one state:

  * `loss_gap`: the first step's |loss - reference| / |reference|
    (`loss_gap_steps`: the worst step's, shown, not compared: from step 2
    on the program's own runs of one seed part, cuDNN's backward not
    being bit for bit, and the third loss swings from 4e-6 to 2e-4);
  * `grad_gap`: for the first gradient as the optimizer takes it (the
    momentum after step 1, weight decay in it), per parameter leaf
    |norm - reference norm| / max(reference norm, median leaf's norm);
    the worst leaf;
  * `change_gap`: the same for the change of each leaf over the three
    steps, of the worst leaf (`change_gap_median`: of the median leaf,
    shown, not compared); leaves whose raw reference gradient norm is
    under a thousandth of the median leaf's (a conv bias under train-mode
    BN) are left out, since only round-off moves them.

And of the window's own steps, which the reference does not follow:

  * `window_still`: 1 where the parameters at the window's end equal
    those at its start, or the window's last loss is not finite; else 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.detect import Candidates, pairwise_iou

QUIET_LEAF = 1e-3  # of the median leaf's gradient norm
LOW_SCORE = 0.1  # det_gap at or above it, det_gap_low under it
DETECTION_NUMBERS = ("det_gap", "det_gap_low", "det_select")


def det_gaps(boxes, scores, classes, probs: torch.Tensor,
             ref_boxes: torch.Tensor) -> Tuple[float, float]:
    """One image: program detections (valid only; host arrays) against
    the reference's dense class probabilities [N, C] and boxes [N, 4] ->
    (det_gap, det_gap_low): the widest gap of the detections scoring at
    least LOW_SCORE, the mean gap of those under it."""
    if len(scores) == 0:
        return 0.0, 0.0
    dev = probs.device
    b = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    c = torch.as_tensor(classes, dtype=torch.long, device=dev)
    box_d = (b[:, None, :] - ref_boxes[None]).abs().amax(-1)  # [P, N]
    score_d = (s[:, None] - probs[:, c].t()).abs()
    gap = torch.maximum(box_d, score_d).amin(1)
    low = s < LOW_SCORE
    return (float(gap[~low].amax()) if (~low).any() else 0.0,
            float(gap[low].mean()) if low.any() else 0.0)


def det_select(boxes, scores, classes, cand: Candidates, conf: float,
               nms: float, max_det: int) -> float:
    """One image: program detections (valid only) against the reference's
    candidates (module docstring)."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    classes = np.asarray(classes)
    worst = 0.0
    if len(scores) > 1:
        iou = pairwise_iou(boxes, boxes)
        same = classes[:, None] == classes[None, :]
        np.fill_diagonal(same, False)
        if same.any():
            worst = max(worst, float((iou[same] - nms).max()))
    if len(cand.scores) == 0:
        return worst
    s_r = cand.scores
    bound = np.minimum(s_r - conf, s_r - cand.cut_score)
    if len(scores) >= max_det:
        bound = np.minimum(bound, s_r - scores.min())
    if len(scores):
        iou = pairwise_iou(cand.boxes, boxes)                  # [K, P]
        later = s_r[:, None] - scores[None, :]
        same = cand.classes[:, None] == classes[None, :]
        own = np.take_along_axis(cand.probs, cand.classes[:, None], 1)
        other = cand.probs[:, classes]                        # [K, P]
        cover = np.where(same, np.maximum(nms - iou, later),
                         np.maximum.reduce([1 - iou, later, own - other]))
        bound = np.minimum(bound, cover.min(1))
    return max(worst, float(bound.max()))


def detection_numbers(out, probs, ref_boxes, cands: List[Candidates],
                      point: dict) -> Tuple[Dict[str, float], np.ndarray]:
    """A batch's program outputs (host arrays: boxes, scores, classes,
    valid) against the reference -> ({number: worst value}, per image
    [B, 3] of DETECTION_NUMBERS)."""
    boxes, scores, classes, valid = (np.asarray(t) for t in out)
    per = np.zeros((len(cands), len(DETECTION_NUMBERS)))
    for i, cand in enumerate(cands):
        v = valid[i]
        per[i, :2] = det_gaps(boxes[i][v], scores[i][v], classes[i][v],
                              probs[i], ref_boxes[i])
        per[i, 2] = det_select(boxes[i][v], scores[i][v], classes[i][v],
                               cand, point["conf_thresh"],
                               point["nms_thresh"], point["max_det"])
    return dict(zip(DETECTION_NUMBERS, map(float, per.max(0)))), per


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys):
    floor = float(np.median([want[k] for k in keys]))
    return [abs(got[k] - want[k]) / max(want[k], floor, 1e-30) for k in keys]


def training_numbers(losses, trace1, params0, params3, ref) -> Dict[str, float]:
    """The program's three losses, momentum after step 1, parameters
    before step 1 and after step 3, against `reference.train.train`'s
    (losses, first raw gradient, first momentum, parameters after)."""
    ref_losses, ref_grad, ref_trace, ref_params = ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    keys = sorted(ref_trace)
    grad_gap = max(_leaf_gaps(_norms(trace1), _norms(ref_trace), keys))
    raw = _norms(ref_grad)
    median = float(np.median(list(raw.values())))
    moving = [k for k in keys if raw[k] >= QUIET_LEAF * median]
    change = _leaf_gaps(_norms({k: params3[k] - params0[k] for k in moving}),
                        _norms({k: ref_params[k] - params0[k]
                                for k in moving}), moving)
    return {"loss_gap": gaps[0], "loss_gap_steps": max(gaps),
            "grad_gap": grad_gap,
            "change_gap": max(change),
            "change_gap_median": float(np.median(change))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """-> (every number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
             for k in limits)
    return ok, shown
