"""The reader of `nms_kernels.detect` (`metrics/nms_kernels.py`): the
program's `ynt.nms.kernel` spans a traced batch, on a hand-built trace;
nothing without device operations or without the span (the CPU's plain
NMS loop and a program before the kernel record none)."""

import json
import os

from benchmark import devtrace, harness

NAME = "nms_kernels.detect"


def _trace(device=True, kernels=3):
    ops = [("k1", 0, 10), ("k2", 40, 60)]
    host = [("ynt.postprocess", 10, 40), ("ynt.nms.wait", 12, 13)]
    host += [("ynt.nms.kernel", 20 + i, 21 + i) for i in range(kernels)]
    return devtrace.Trace(0.0, 100.0, ops if device else [], host)


def test_reads_kernel_spans_a_batch():
    read = harness.reader(NAME)
    assert read({"trace": _trace(), "forwards": 3}) == 1.0
    assert read({"trace": _trace(kernels=1), "forwards": 2}) == 0.5


def test_reads_nothing_without_device_operations_or_the_span():
    read = harness.reader(NAME)
    assert read({"trace": _trace(device=False), "forwards": 3}) is None
    assert read({"trace": _trace(kernels=0), "forwards": 3}) is None


def test_the_metric_lists_the_detection_cells():
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    detect = [w["name"] for w in spec["workloads"]
              if w["name"].startswith(("detect", "evalstrict"))]
    assert m["workloads"] == detect and m["unit"] == "calls"
    assert m["source"] == "device_trace" and m["moves"] == "batch_p95_ms"
    postprocess = [x["layer"] for x in spec["per_layer"]
                   if x["name"] == "postprocess_idle_ms.detect"]
    assert [m["layer"]] == postprocess
