"""The readers of the program's spans (`benchmark/spans.py` and its
metrics): known milliseconds and counts on a hand-built trace, gaps that
only partly overlap a span among them; and traced CPU runs of a detection
cell and of the training cell, which read the spans once the trace holds
a device operation."""

import json
import os

import pytest

from benchmark import devtrace, harness, spans
from benchmark.conftest import add_cell
from benchmark.test_bench_harness import ARGS, _run, _small

DETECT = ["forward_issue_ms.detect", "forward_idle_ms.detect",
          "postprocess_idle_ms.detect", "nms_wait_ms.detect",
          "nms_sweeps.detect"]
TRAIN = ["forward_issue_ms.train", "targets_issue_ms.train",
         "backward_issue_ms.train", "update_issue_ms.train"]


def _trace(device=True):
    """Window 0..100 us. Device busy [0,10], [15,40] (two operations that
    overlap), [60,70], [90,100]: idle [10,15], [40,60], [70,90]."""
    ops = [("k1", 0, 10), ("k2", 15, 30), ("k3", 28, 40), ("k4", 60, 70),
           ("k5", 90, 100)]
    host = [("ynt.forward", 5, 20), ("ynt.forward", 50, 65),
            ("ynt.postprocess", 20, 45), ("ynt.postprocess", 66, 95),
            ("ynt.nms.wait", 21, 22), ("ynt.nms.wait", 41, 44),
            ("ynt.nms.wait", 67, 68), ("ynt.nms.sweep", 22, 30),
            ("ynt.nms.sweep", 68, 80), ("ynt.train.targets", 1, 3),
            ("ynt.train.targets", 51, 52), ("ynt.train.backward", 4, 14),
            ("ynt.train.backward", 70, 80), ("ynt.train.update", 14, 16),
            ("aten::mul", 0, 100)]
    return devtrace.Trace(0.0, 100.0, ops if device else [], host)


# us a unit over two units (batches or steps), worked by hand from _trace
EXPECTED = {
    "forward_issue_ms.detect": (15 + 15) / 2,
    "forward_idle_ms.detect": (5 + 10) / 2,  # [10,15] whole, [50,60]
    "postprocess_idle_ms.detect": (5 + 20) / 2,  # [40,45], [70,90] whole
    "nms_wait_ms.detect": (1 + 3 + 1) / 2,
    "forward_issue_ms.train": (15 + 15) / 2,
    "targets_issue_ms.train": (2 + 1) / 2,
    "backward_issue_ms.train": (10 + 10) / 2,
    "update_issue_ms.train": 2 / 2,
}


def _ctx(name, trace):
    key = "steps" if name.endswith(".train") else "forwards"
    return {"trace": trace, key: 2}


@pytest.mark.parametrize("name", DETECT + TRAIN)
def test_each_reader_on_a_known_trace(name):
    value = harness.reader(name)(_ctx(name, _trace()))
    if name == "nms_sweeps.detect":
        assert value == 1.0  # 2 sweeps over 2 batches
    else:
        assert value == pytest.approx(EXPECTED[name] / 1e3, rel=1e-12)


@pytest.mark.parametrize("name", DETECT + TRAIN)
def test_a_reader_reads_nothing_without_device_operations_or_spans(name):
    read = harness.reader(name)
    assert read(_ctx(name, _trace(device=False))) is None
    bare = _trace()
    bare.host = [e for e in bare.host if not e[0].startswith("ynt.")]
    assert read(_ctx(name, bare)) is None  # a program without the spans


def test_idle_inside_overlapping_spans_counts_once():
    trace = _trace()
    assert spans.merged([(12, 14), (10, 13), (50, 55)]) == [(10, 14),
                                                            (50, 55)]
    assert spans.idle_us(trace, [(10, 14), (12, 15)]) == 5  # not 6
    assert spans.idle_us(trace, [(0, 100)]) == 5 + 20 + 20
    assert spans.overlap_us([(0, 5)], [(5, 9)]) == 0


def test_the_new_metrics_list_their_cells():
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    by_name = {m["name"]: m for m in spec["per_layer"]}
    detect = [w["name"] for w in spec["workloads"]
              if w["name"].startswith(("detect", "evalstrict"))]
    for name in DETECT + TRAIN:
        m = by_name[name]
        assert m["source"] == "device_trace"
        assert m["workloads"] == (detect if name in DETECT
                                  else ["train-1.0x-f32-b128"])


# a device operation planted at the start of the window, as the CPU has
# none: the idle readers then see the device idle through every span
PLANT = """
import benchmark.devtrace as _dt
_read = _dt.read
def read(prof):
    t = _read(prof)
    t.device.append(("planted", t.start, t.start + 1.0))
    return t
_dt.read = read
"""


@pytest.mark.parametrize("base", ["evalstrict-0.5x-bf16-b128",
                                  "train-1.0x-f32-b128"])
@pytest.mark.parametrize("planted", [False, True])
def test_a_traced_cpu_run_reads_the_spans(checkout, base, planted):
    add_cell(checkout, "small", base, _small(base))
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "1"],
                              PLANT if planted else "")
    assert rc == 0, err[-3000:]
    names = TRAIN if base.startswith("train") else DETECT
    got = last["metrics"]
    if not planted:  # no device operation: none of them
        assert not set(names) & set(got)
        return
    assert set(names) <= set(got)
    for name in names:
        assert got[name]["value"] > 0, name
    if names is DETECT:  # conf 0.001: candidates even at 64 px
        assert got["nms_sweeps.detect"]["value"] >= 1
        assert got["nms_sweeps.detect"]["unit"] == "sweeps"
        # the device idle all through the forward
        assert got["forward_idle_ms.detect"]["value"] == pytest.approx(
            got["forward_issue_ms.detect"]["value"], rel=1e-6)
