"""Batched multi-label detection of a NanoDet-Plus artifact: one client, one
batch in flight, batches back to back through `serving.load_predictor`,
the images already on the device, the detections fetched to the host
inside each batch's latency, as `drivers/detect.py` runs YOLO-Nano.

Traffic as `drivers/detect.py`'s (batch, pool, the operating point). What
decides `correct` (the workload's limits):

  * `det_gap`: `checks.det_gaps`'s distance over every detection, not only
    those scoring at least `checks.LOW_SCORE`: each against the nearest
    reference row (prior) of its class, max(|box - row's box|_inf, |score -
    row's pair probability|); the worst. At this cell's conf (0.05) most
    detections score under 0.1, and their gaps separate the program from
    the control as the higher ones do (`checks.det_gap_low` answers
    YOLO-Nano's background rows at conf 0.001, which this cell has none
    of);
  * `det_select`: the multi-label counterpart of `checks.det_select`:
    every reference candidate pair (probability above conf, within
    pre-top-k) has to be matched or suppressed by a detection of its own
    class (IoU above the NMS threshold and a score at least its own; a
    pair has no other class to tie with), each reading the least of its
    score above conf, above the best score pre-top-k left out, above the
    program's last detection when max-det is full, and the margin by which
    its best same-class detection misses (NMS threshold minus IoU, its
    score minus the detection's); two detections of one class kept though
    they overlap by more than the threshold read their IoU minus it; the
    worst, and at least 0;
  * `det_lost`: the reference's detections (the first max-det that its NMS
    keeps) that no program detection of their class overlaps by more than
    the NMS threshold, each reading the least of the share of the
    reference's detections scoring below it, the NMS threshold minus the
    IoU of its best same-class detection, and its score's margin above the
    program's last detection when max-det is full (else above conf),
    relative to its score; the worst, and at least 0. At this cell's point
    the kept scores crowd just above the max-det cut (0.07 to 0.1), so a
    pair lost from the middle of the list moves `det_select` by hundredths
    only; by its rank and its relative margin it reads tenths, while a
    rounding flip at the cut or at the NMS threshold still reads near 0.

A traced run reports, beside what the harness reads, the device ms a batch
of the operations inside the program's span `ynt.pairs` (the scores and
the selection of the pairs), summed over the kernels, copies and memsets
whose launch the host issued inside the span (the profiler's correlation
of each launch and its device operation).
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import devtrace, scenes
from benchmark.drivers.detect import (CHECK_BATCHES, ORDERS, REF_BLOCK,
                                      TRACE_SECONDS, WARMUP_BATCHES, _fetch,
                                      _orders, _point, _sync, load_program)
from benchmark.harness import Cell, check_artifact, percentile
from benchmark.reference import model as ref_model
from benchmark.reference import nanodet_plus as ref_nanodet
from benchmark.reference.detect import Candidates, pairwise_iou

NUMBERS = ("det_gap", "det_select", "det_lost")
PAIRS_SPAN = "ynt.pairs"


class Reference:
    """The plain reference on the artifact's weights, on `dev`."""

    def __init__(self, cell: Cell, dev, precision=None):
        units, _ = ref_model.load_folded(check_artifact(cell))
        units = {k: {n: t.to(dev) for n, t in u.items()}
                 for k, u in units.items()}
        c = cell.config
        self.fwd = ref_nanodet.Forward(units, c["num_classes"],
                                       precision=precision)
        self.size, self.strides = c["img_size"], c["strides"]
        self.precision, self.dev = precision, dev
        self.point = _point(cell.workload["traffic"])

    @torch.no_grad()
    def __call__(self, images):
        """-> (probs [B, N, C], boxes [B, N, 4], candidates per image)."""
        p = self.point
        with ref_model.precision_scope(self.precision):
            cls_logits, reg, sides = self.fwd(images.float())
            pri = ref_nanodet.priors(self.strides, sides, self.dev)
            probs, boxes = ref_nanodet.dense(cls_logits, reg, pri, self.size)
        cands = ref_nanodet.candidates(probs, boxes, p["conf_thresh"],
                                       p["nms_thresh"], p["pre_topk"])
        return probs, boxes, cands

    def outputs(self, cands):
        """The reference's detections in the program's fixed shapes (for
        the control)."""
        d = self.point["max_det"]
        out = (np.zeros((len(cands), d, 4), np.float32),
               np.zeros((len(cands), d), np.float32),
               np.zeros((len(cands), d), np.int32),
               np.zeros((len(cands), d), bool))
        for i, c in enumerate(cands):
            k = np.flatnonzero(c.kept)[:d]
            out[0][i, :len(k)] = c.boxes[k]
            out[1][i, :len(k)] = c.scores[k]
            out[2][i, :len(k)] = c.classes[k]
            out[3][i, :len(k)] = True
        return out


def det_gap(boxes, scores, classes, probs: torch.Tensor,
            ref_boxes: torch.Tensor) -> float:
    """One image: the widest distance of a program detection (valid only;
    host arrays) to the nearest reference row of its class (module
    docstring)."""
    if len(scores) == 0:
        return 0.0
    dev = probs.device
    b = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    c = torch.as_tensor(classes, dtype=torch.long, device=dev)
    box_d = (b[:, None, :] - ref_boxes[None]).abs().amax(-1)  # [P, N]
    score_d = (s[:, None] - probs[:, c].t()).abs()
    return float(torch.maximum(box_d, score_d).amin(1).amax())


def det_select(boxes, scores, classes, cand: Candidates, conf: float,
               nms: float, max_det: int) -> float:
    """One image: program detections (valid only) against the reference's
    candidate pairs (module docstring)."""
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
        cover = np.where(cand.classes[:, None] == classes[None, :],
                         np.maximum(nms - iou, s_r[:, None] - scores[None]),
                         np.inf)
        bound = np.minimum(bound, cover.min(1))
    return max(worst, float(bound.max()))


def det_lost(boxes, scores, classes, cand: Candidates, conf: float,
             nms: float, max_det: int) -> float:
    """One image: the reference's detections that the program lost
    (valid program detections only; module docstring)."""
    kept = np.flatnonzero(cand.kept)[:max_det]
    if len(kept) == 0:
        return 0.0
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    classes = np.asarray(classes)
    r_boxes, r_scores = cand.boxes[kept], cand.scores[kept]
    best = np.zeros(len(kept))
    if len(scores):
        iou = pairwise_iou(r_boxes, boxes)                     # [K, P]
        same = cand.classes[kept][:, None] == classes[None, :]
        best = np.where(same, iou, 0.0).max(1)
    below = (r_scores[None, :] < r_scores[:, None]).mean(1)
    last = scores.min() if len(scores) >= max_det else conf
    read = np.minimum(np.minimum(below, nms - best),
                      (r_scores - last) / r_scores)
    return max(float(read.max()), 0.0)


def detection_numbers(out, probs, ref_boxes, cands, point):
    """A batch's program outputs (host arrays) against the reference ->
    ({number: worst}, per image [B, 3] of NUMBERS)."""
    boxes, scores, classes, valid = (np.asarray(t) for t in out)
    per = np.zeros((len(cands), len(NUMBERS)))
    for i, cand in enumerate(cands):
        v = valid[i]
        per[i, 0] = det_gap(boxes[i][v], scores[i][v], classes[i][v],
                            probs[i], ref_boxes[i])
        per[i, 1] = det_select(boxes[i][v], scores[i][v], classes[i][v],
                               cand, point["conf_thresh"],
                               point["nms_thresh"], point["max_det"])
        per[i, 2] = det_lost(boxes[i][v], scores[i][v], classes[i][v],
                             cand, point["conf_thresh"], point["nms_thresh"],
                             point["max_det"])
    return dict(zip(NUMBERS, map(float, per.max(0)))), per


def compare(ref: Reference, pool, orders, kept):
    """The worst of each number over the batches `kept`, the reference run
    in blocks -> ({number: worst}, {number: per image}, mean candidate
    pairs an image)."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    per_image, pairs = [], []
    for i, out in kept:
        order = orders[i % len(orders)]
        for lo in range(0, len(order), REF_BLOCK):
            idx = order[lo:lo + REF_BLOCK]
            probs, boxes, cands = ref(pool.index_select(0, idx))
            part = tuple(np.asarray(t)[lo:lo + REF_BLOCK] for t in out)
            nums, per = detection_numbers(part, probs, boxes, cands,
                                          ref.point)
            for k, v in nums.items():
                worst[k] = max(worst[k], v)
            per_image.append(per)
            pairs += [len(c.scores) for c in cands]
    per_image = np.concatenate(per_image)
    return (worst, {k: per_image[:, i] for i, k in enumerate(worst)},
            float(np.mean(pairs)))


class _Exported:
    """A profile already exported as Chrome-trace JSON at `path`, handed to
    `devtrace.read` in the profile's place (a profile exports once)."""

    def __init__(self, path: str):
        self.path = path

    def export_chrome_trace(self, dst: str) -> None:
        shutil.copyfile(self.path, dst)


def read_trace(prof, name: str):
    """A finished profile -> (its `devtrace.Trace`, the summed device ms of
    the operations launched from inside the host spans `name`, the spans'
    count)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        trace = devtrace.read(_Exported(path))
    finally:
        os.remove(path)
    return (trace, *span_device_ms(events, name))


def span_device_ms(events, name: str):
    """Summed device ms of the operations launched from inside the host
    spans `name` of a Chrome trace's events, and the spans' count; (None,
    count) without such operations."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("tid")) for e in events
                   if e.get("ph") == "X" and e.get("name") == name
                   and e.get("cat") == "user_annotation")
    inside = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime",
                                                      "cuda_driver"):
            continue
        t = float(e["ts"])
        if any(s <= t <= end and tid == e.get("tid") for s, end, tid in spans):
            inside.add(e.get("args", {}).get("correlation"))
    inside.discard(None)
    device = [float(e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in devtrace.DEVICE_CATS
              and e.get("args", {}).get("correlation") in inside]
    if not device:
        return None, len(spans)
    return sum(device) / 1e3, len(spans)


def _counters():
    """The program's launch counters of the stage and head-pair kernels."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import fused_stage

    return {"fused_stage.launches_leaky": fused_stage.launches_leaky,
            "fused_stage.calls": fused_stage.calls,
            "fused_dw_pw.launches_k5": fused_dw_pw.launches_k5}


def run(cell: Cell, args, dev, t_start: float) -> dict:
    t = cell.workload["traffic"]
    size, batch = cell.config["img_size"], t["batch"]
    check_artifact(cell)
    predict = load_program(cell, dev)
    pool = scenes.render(t["pool"], size, args.seed, dev)
    orders = _orders(t, args.seed, dev)
    before = _counters()
    for i in range(WARMUP_BATCHES):
        _fetch(predict(pool.index_select(0, orders[-1 - i])))
    _sync(dev)
    counts = {k: (v - before[k]) / WARMUP_BATCHES
              for k, v in _counters().items()}

    rng = random.Random(scenes.seed_value(args.seed))
    kept, lat = [], []
    window = devtrace.Window(dev)
    if args.trace:
        window.start()
    t_begin = time.perf_counter()
    setup_s = t_begin - t_start
    traced = 0
    i = 0
    while True:
        t0 = time.perf_counter()
        out = _fetch(predict(pool.index_select(0, orders[i % ORDERS])))
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if len(kept) < CHECK_BATCHES:
            kept.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < CHECK_BATCHES:
                kept[j] = (i, out)
        i += 1
        if window.open and t1 - t_begin >= TRACE_SECONDS:
            window.stop()
            traced = i
        if t1 - t_begin >= args.seconds:
            break
    window_s = time.perf_counter() - t_begin
    if window.open:
        window.stop()
        traced = i
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result = {"attempted": i * batch, "memory_peak_bytes": peak,
              "e2e": {"img_per_s": i * batch / window_s,
                      "batch_p95_ms": percentile(lat, 95) * 1e3,
                      "setup_s": setup_s},
              "notes": {"batches": i, "window_s": window_s,
                        "batch_p50_ms": percentile(lat, 50) * 1e3,
                        "forwards": WARMUP_BATCHES + i,
                        "launches_a_forward": counts}}
    if args.trace:
        t0 = time.perf_counter()
        trace, pairs_ms, n = read_trace(window.prof, PAIRS_SPAN)
        result["ctx"] = {"trace": trace, "forwards": traced,
                         "images": traced * batch, "batch": batch,
                         "spans": {"pairs_device_ms": None if pairs_ms is None
                                   else pairs_ms / max(n, 1)}}
        result["notes"]["trace_read_s"] = time.perf_counter() - t0
    del predict
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst, per, pairs = compare(Reference(cell, dev), pool, orders, kept)
    result["notes"]["check_s"] = time.perf_counter() - t0
    result["notes"]["reference_pairs_an_image"] = pairs
    result["numbers"] = worst
    result["per_image"] = per
    return result


def readings(cell: Cell, seeds, dev, control=None) -> list:
    """The numbers compared, per seed, of as many batches as a run checks,
    drawn as a run draws them; from the program, or with `control`
    ("fp8") from the reference computed so."""
    t = cell.workload["traffic"]
    program = None if control else load_program(cell, dev)
    ctrl = Reference(cell, dev, precision=control) if control else None
    ref = Reference(cell, dev)
    out = []
    for seed in seeds:
        pool = scenes.render(t["pool"], cell.config["img_size"], seed, dev)
        orders = _orders(t, seed, dev)
        kept = []
        for i in range(CHECK_BATCHES):
            x = pool.index_select(0, orders[i])
            if ctrl is None:
                kept.append((i, _fetch(program(x))))
            else:
                cands = []
                for lo in range(0, len(x), REF_BLOCK):
                    cands += ctrl(x[lo:lo + REF_BLOCK])[2]
                kept.append((i, ctrl.outputs(cands)))
        worst, _, pairs = compare(ref, pool, orders, kept)
        out.append({"seed": seed, **worst, "pairs_an_image": pairs})
    return out
