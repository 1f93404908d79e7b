"""Batched detection: one client, one batch in flight, batches back to back
through the artifact's predict function (`serving.load_predictor`), the
images already on the device, the detections fetched to the host inside
each batch's latency.

Traffic (the workload's `traffic`): `batch` images a batch, each batch a
seeded draw without replacement from a pool of `pool` rendered scenes made
on the device in set-up; the operating point (`conf_thresh`, `nms_thresh`,
`pre_topk`, `max_det`). `WARMUP_BATCHES` run before the window; of the
window's batches, `CHECK_BATCHES` drawn from the seed (a reservoir sample)
are held to the reference once the window has closed. A traced run
profiles the window's first `TRACE_SECONDS`, and after the window times
the postprocess alone on `POSTPROCESS_BATCHES` batches.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import checks, devtrace, scenes
from benchmark.harness import Cell, check_artifact, percentile
from benchmark.reference import detect as ref_detect
from benchmark.reference import model as ref_model

ORDERS = 1024  # batch draws made in set-up, cycled
REF_BLOCK = 32  # images the reference takes at once
WARMUP_BATCHES = 3
CHECK_BATCHES = 4
TRACE_SECONDS = 3.0
POSTPROCESS_BATCHES = 10


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _point(t: dict) -> dict:
    return {k: t[k] for k in ("conf_thresh", "nms_thresh", "pre_topk",
                              "max_det")}


def _orders(t: dict, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(scenes.seed_value(seed) ^ 0x5EED)
    draws = torch.rand((ORDERS, t["pool"]), generator=gen, device=dev)
    return draws.argsort(1)[:, :t["batch"]].contiguous()


def load_program(cell: Cell, dev):
    from yolo_nano_tpu_torch.serving import load_predictor

    p = _point(cell.workload["traffic"])
    return load_predictor(check_artifact(cell), device=dev,
                          conf_thresh=p["conf_thresh"],
                          nms_thresh=p["nms_thresh"],
                          pre_topk=p["pre_topk"], max_det=p["max_det"])


class Reference:
    """The plain reference on the artifact's weights, on `dev`."""

    def __init__(self, cell: Cell, dev, precision=None):
        units, meta = ref_model.load_folded(check_artifact(cell))
        units = {k: {n: t.to(dev) for n, t in u.items()}
                 for k, u in units.items()}
        c = cell.config
        self.a = len(c["anchors"]) // len(c["strides"])
        self.fwd = ref_model.Forward(units, self.a, precision=precision)
        self.size = c["img_size"]
        self.rows = ref_detect.row_tables(c["anchors"], c["strides"],
                                          self.size, dev)
        self.precision = precision
        self.point = _point(cell.workload["traffic"])

    @torch.no_grad()
    def __call__(self, images):
        """-> (probs [B, N, C], boxes [B, N, 4], candidates per image)."""
        p = self.point
        with ref_model.precision_scope(self.precision):
            heads = self.fwd(images.float())
        probs, boxes = ref_detect.dense(*heads, self.rows, self.size)
        cands = ref_detect.candidates(probs, boxes, p["conf_thresh"],
                                      p["nms_thresh"], p["pre_topk"])
        return probs, boxes, cands

    def outputs(self, cands):
        """The reference's detections in the program's fixed shapes (for
        the control): boxes, scores, classes, valid [B, max_det]."""
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


def compare(ref: Reference, pool, orders, kept):
    """The worst of each number over the batches `kept` [(batch index,
    host outputs)], the reference run in blocks -> ({number: worst},
    {number: per image})."""
    worst = dict.fromkeys(checks.DETECTION_NUMBERS, 0.0)
    per_image = []
    for i, out in kept:
        order = orders[i % len(orders)]
        for lo in range(0, len(order), REF_BLOCK):
            idx = order[lo:lo + REF_BLOCK]
            probs, boxes, cands = ref(pool.index_select(0, idx))
            part = tuple(np.asarray(t)[lo:lo + REF_BLOCK] for t in out)
            nums, per = checks.detection_numbers(part, probs, boxes, cands,
                                                 ref.point)
            for k, v in nums.items():
                worst[k] = max(worst[k], v)
            per_image.append(per)
    per_image = np.concatenate(per_image)
    return worst, {k: per_image[:, i] for i, k in enumerate(worst)}


def _fetch(out):
    return tuple(t.cpu().numpy() for t in out)


def run(cell: Cell, args, dev, t_start: float) -> dict:
    t = cell.workload["traffic"]
    size, batch = cell.config["img_size"], t["batch"]
    predict = load_program(cell, dev)
    pool = scenes.render(t["pool"], size, args.seed, dev)
    orders = _orders(t, args.seed, dev)
    for i in range(WARMUP_BATCHES):
        _fetch(predict(pool.index_select(0, orders[-1 - i])))
    _sync(dev)

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
    if window.open:  # a window shorter than TRACE_SECONDS
        window.stop()
        traced = i
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result = {"attempted": i * batch, "memory_peak_bytes": peak,
              "e2e": {"img_per_s": i * batch / window_s,
                      "batch_p95_ms": percentile(lat, 95) * 1e3,
                      "setup_s": setup_s},
              "notes": {"batches": i, "window_s": window_s,
                        "batch_p50_ms": percentile(lat, 50) * 1e3,
                        "forwards": WARMUP_BATCHES + i + (
                            POSTPROCESS_BATCHES if args.trace else 0)}}
    if args.trace:
        t0 = time.perf_counter()
        trace = window.read()
        result["ctx"] = {"trace": trace, "forwards": traced,
                         "images": traced * batch, "batch": batch,
                         "spans": {"postprocess_s": postprocess_seconds(
                             predict, pool, orders, dev)}}
        result["notes"]["trace_read_s"] = time.perf_counter() - t0
    del predict
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    worst, per = compare(Reference(cell, dev), pool, orders, kept)
    result["notes"]["check_s"] = time.perf_counter() - t0
    result["numbers"] = worst
    result["per_image"] = per
    return result


def postprocess_seconds(predict, pool, orders, dev):
    """Host seconds of the scores and the postprocess of a batch
    (`models.yolo_nano.scores_from_features`, `postprocess_scored`), the
    forward run and synchronized before, a synchronize closing them."""
    from yolo_nano_tpu_torch.models.yolo_nano import (postprocess_scored,
                                                      scores_from_features)

    model, cfg = predict.model, predict.cfg
    out = []
    with torch.inference_mode():
        for i in range(POSTPROCESS_BATCHES):
            x = pool.index_select(0, orders[i]).to(predict.dtype)
            conf, cls, box = model(x)
            _sync(dev)
            t0 = time.perf_counter()
            score, c = scores_from_features(conf, cls)
            postprocess_scored(box, score, c, cfg, predict.input_size)
            _sync(dev)
            out.append(time.perf_counter() - t0)
    return out


def readings(cell: Cell, seeds, dev, control=None) -> list:
    """The numbers compared, per seed, of as many batches as a run checks
    (`CHECK_BATCHES`), drawn as a run draws them; from the program, or
    with `control` ("tf32", "fp8") from the reference computed so."""
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
        out.append({"seed": seed, **compare(ref, pool, orders, kept)[0]})
    return out
