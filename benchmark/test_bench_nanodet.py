"""The NanoDet-Plus cell on the CPU: a throwaway copy of it runs end to end
through `run.main(device="cpu")` with the program's plain versions, faults
planted in the timed path make `correct` false (a single-label postprocess
among them, which only `det_lost` sees), the candidates' checks read their
cases, and the yardstick's counts agree with the repository's FLOP
count."""

import numpy as np
import pytest
import torch

from benchmark import counts_nanodet
from benchmark.conftest import add_cell, run_cell
from benchmark.drivers.detect_nanodet import det_lost, det_select
from benchmark.reference.detect import Candidates
from benchmark.test_bench_harness import ARGS, KEYS, SMALL_DETECT, SMALL_SETTINGS

CELL = "detect-nanodetplus-1.5x-bf16-b128"
SIZE = 128  # px of the throwaway cell: all four levels (16, 8, 4, 2)

FAULTS = {
    # every detection's score +0.05 where the detections are produced
    "answer": """
import yolo_nano_tpu_torch.serving as s
_load = s.load_predictor
def load_predictor(*a, **k):
    fn = _load(*a, **k)
    def broken(x):
        b, sc, c, v = fn(x)
        return b, sc + 0.05 * v, c, v
    broken.__dict__.update(fn.__dict__)
    return broken
s.load_predictor = load_predictor
""",
    # half of the batch's detections dropped
    "half_batch": """
import yolo_nano_tpu_torch.serving as s
_load = s.load_predictor
def load_predictor(*a, **k):
    fn = _load(*a, **k)
    def broken(x):
        b, sc, c, v = fn(x)
        v = v.clone(); v[: len(v) // 2] = False
        return b, sc, c, v
    broken.__dict__.update(fn.__dict__)
    return broken
s.load_predictor = load_predictor
""",
}


def _run(root, argv, setup=""):
    return run_cell(root, argv, setup=SMALL_SETTINGS + setup)


def test_the_cell_runs_end_to_end(checkout):
    add_cell(checkout, "small", CELL, SMALL_DETECT, size=SIZE)
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"])
    assert rc == 0, err[-3000:]
    assert list(last) == KEYS
    assert last["correct"] is True, last["checks"]
    assert set(last["metrics"]) == {"img_per_s", "batch_p95_ms", "setup_s"}
    assert set(last["checks"]) == {"det_gap", "det_select", "det_lost"}
    run_line = [line for line in out.splitlines() if '"run"' in line][-1]
    assert '"reference_pairs_an_image"' in run_line


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(checkout, fault):
    """At the cell's 416 px, where the artifact's scores reach the range
    the cell checks."""
    add_cell(checkout, "small", CELL, SMALL_DETECT, size=416)
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"],
                              FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["checks"]


# each prior's best class alone: YOLO-Nano's single-label scoring in place
# of the multi-label pairs, planted where the pairs are formed
SINGLE_LABEL = """
import torch
import yolo_nano_tpu_torch.models.nanodet_plus as nd
_post = nd.postprocess
def postprocess(cls_logits, reg, cfg, size):
    best = cls_logits.float().argmax(-1, keepdim=True)
    own = torch.zeros_like(cls_logits, dtype=torch.bool).scatter_(-1, best, True)
    return _post(cls_logits.masked_fill(~own, -30.0), reg, cfg, size)
nd.postprocess = postprocess
"""


def test_a_single_label_postprocess_is_not_correct(checkout):
    """The pairs a single-label postprocess loses score just above the
    max-det cut, inside `det_select`'s rounding allowance; `det_lost`
    reads them by their rank and relative margin (16 images at 416 px)."""
    add_cell(checkout, "small", CELL, dict(batch=8, pool=16), size=416)
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"],
                              SINGLE_LABEL)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["checks"]
    lost = last["checks"]["det_lost"]
    assert lost["value"] > lost["limit"], last["checks"]


def _cands(boxes, scores, classes, cut=-np.inf):
    boxes = np.asarray(boxes, np.float64)
    return Candidates(boxes, np.asarray(scores, np.float64),
                      np.asarray(classes), np.zeros((len(scores), 3)),
                      np.ones(len(scores), bool), cut)


def test_det_select_holds_pairs_to_their_own_class():
    """A pair is matched or suppressed by a detection of its class only:
    one prior detected as class 0 does not explain its class-1 pair."""
    box = [0.1, 0.1, 0.4, 0.4]
    cand = _cands([box, box], [0.5, 0.3], [0, 1])
    full = det_select([box, box], [0.5, 0.3], [0, 1], cand, 0.05, 0.6, 100)
    assert full == 0.0
    one = det_select([box], [0.5], [0], cand, 0.05, 0.6, 100)
    assert one == pytest.approx(0.3 - 0.05)
    # suppressed by a same-class detection that overlaps and scores higher
    near = [0.1, 0.1, 0.4, 0.41]
    cand = _cands([box, near], [0.5, 0.3], [0, 0])
    assert det_select([box], [0.5], [0], cand, 0.05, 0.6, 100) == 0.0
    # a near tie at the pre-top-k cut reads its small margin
    cand = _cands([box], [0.3], [2], cut=0.29)
    assert det_select([], [], [], cand, 0.05, 0.6, 100) == pytest.approx(
        0.01)


def test_det_lost_reads_a_lost_detection_by_its_rank():
    """A reference detection no same-class detection overlaps reads the
    least of its rank share, its IoU margin and its relative score margin:
    a flip at the cut or at the NMS threshold reads near 0, a detection
    lost from the middle of the list reads its rank."""
    boxes = [[0.1 * i, 0.1, 0.1 * i + 0.05, 0.2] for i in range(5)]
    scores = [0.5, 0.4, 0.3, 0.2, 0.1]
    cand = _cands(boxes, scores, [0] * 5)
    assert det_lost(boxes, scores, [0] * 5, cand, 0.05, 0.6, 100) == 0.0
    # the middle one lost: 2 of 5 below it; 0.3 is 0.25 of itself above
    # conf, IoU 0 with every detection
    keep = [0, 1, 3, 4]
    got = det_lost([boxes[i] for i in keep], [scores[i] for i in keep],
                   [0] * 4, cand, 0.05, 0.6, 100)
    assert got == pytest.approx(2 / 5)
    # a flip at a full max-det (4): the reference's last kept detection
    # lost to one it left out, nothing of its own below it
    got = det_lost(boxes[:3] + boxes[4:], scores[:3] + [0.19], [0] * 4,
                   cand, 0.05, 0.6, 4)
    assert got == 0.0
    # the lost one's class detected elsewhere, or another class on it
    got = det_lost([boxes[i] for i in keep] + [boxes[2]],
                   [scores[i] for i in keep] + [0.3], [0] * 4 + [1], cand,
                   0.05, 0.6, 100)
    assert got == pytest.approx(2 / 5)
    # an NMS flip: a same-class detection at IoU 0.55 reads 0.6 - 0.55
    wide = [0.2, 0.1, 0.25 + 0.05 * (1 / 0.55 - 1), 0.2]
    got = det_lost([boxes[i] for i in keep] + [wide],
                   [scores[i] for i in keep] + [0.3], [0] * 5, cand, 0.05,
                   0.6, 100)
    assert got == pytest.approx(0.6 - 0.55)


def test_counts_agree_with_the_flop_count_of_a_seeded_tree():
    from yolo_nano_tpu_torch.config import NanoDetPlusConfig
    from yolo_nano_tpu_torch.convert import build_model, tree_from_model
    from yolo_nano_tpu_torch.models.nanodet_plus import init_nanodet_plus_tree
    from yolo_nano_tpu_torch.utils.flops import flops_and_params
    from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn

    cfg = NanoDetPlusConfig()
    tree = init_nanodet_plus_tree(torch.Generator().manual_seed(0), cfg)
    folded = tree_from_model(fold_bn(build_model(*tree, cfg)))
    for size in (96, 128):
        gflops = flops_and_params(folded, None, cfg, size)[0]
        c = {"img_size": size, "backbone_channels": cfg.backbone_channels,
             "neck_channels": cfg.neck_channels,
             "kernel_size": cfg.kernel_size, "num_classes": cfg.num_classes,
             "reg_max": cfg.reg_max}
        assert counts_nanodet.model_flops(c) == pytest.approx(gflops * 1e9,
                                                              abs=1)
        assert counts_nanodet.sides(c) == list(cfg.level_sides(size))
    # the twelve 5x5 pairs: 2 a level in the heads, 4 shortcuts
    c["img_size"] = 416
    launches = counts_nanodet.pair5_launches(c, 32)
    assert len(launches) == 12
    assert sorted({(ln["c"], ln["cout"]) for ln in launches}) == [
        (128, 128), (256, 128)]


def test_a_traced_run_reads_its_trace_once(checkout):
    """A profile exports once: the trace and the pairs span are read from
    one export. On the CPU no metric has a device operation to read."""
    add_cell(checkout, "small", CELL, SMALL_DETECT, size=SIZE)
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "1"])
    assert rc == 0, err[-3000:]
    assert last["correct"] is True and last["metrics"] == {}
    assert {"busy_s", "window_s"} <= set(last["device"])


def test_pairs_device_ms_follows_the_launches_inside_the_span():
    from benchmark.drivers.detect_nanodet import span_device_ms

    def ev(name, cat, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [ev("ynt.pairs", "user_annotation", 100, 50),
              ev("ynt.pairs", "user_annotation", 300, 50),
              ev("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=1),
              ev("cudaLaunchKernel", "cuda_runtime", 310, 5, corr=2),
              ev("cudaLaunchKernel", "cuda_runtime", 200, 5, corr=3),
              ev("cudaLaunchKernel", "cuda_runtime", 120, 5, tid=2, corr=4),
              ev("topk", "kernel", 400, 1000, corr=1),
              ev("sigmoid", "kernel", 1400, 500, corr=2),
              ev("conv", "kernel", 1900, 7000, corr=3),
              ev("other", "kernel", 8900, 7000, corr=4)]
    assert span_device_ms(events, "ynt.pairs") == (1.5, 2)
    assert span_device_ms(events, "ynt.decode") == (None, 0)
