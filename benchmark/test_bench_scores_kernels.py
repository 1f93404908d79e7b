"""The reader of `scores_kernels.detect` (`metrics/scores_kernels.py`): the
program's `ynt.scores.kernel` spans a traced batch, on a hand-built trace;
nothing without device operations or without the span (the CPU's plain
scores and a program before the kernel record none)."""

import json
import os

from benchmark import devtrace, harness

NAME = "scores_kernels.detect"
CELLS = ["detect-1.0x-f32-b256", "detect-0.5x-bf16-b128",
         "evalstrict-0.5x-bf16-b128"]


def _trace(device=True, kernels=3):
    ops = [("k1", 0, 10), ("k2", 40, 60)]
    host = [("ynt.postprocess", 10, 40), ("ynt.nms.kernel", 30, 31)]
    host += [("ynt.scores.kernel", 20 + i, 21 + i) for i in range(kernels)]
    return devtrace.Trace(0.0, 100.0, ops if device else [], host)


def test_reads_one_kernel_span_a_batch_as_one():
    read = harness.reader(NAME)
    assert read({"trace": _trace(), "forwards": 3}) == 1.0
    assert read({"trace": _trace(kernels=1), "forwards": 2}) == 0.5


def test_reads_nothing_without_device_operations_or_the_span():
    read = harness.reader(NAME)
    assert read({"trace": _trace(device=False), "forwards": 3}) is None
    assert read({"trace": _trace(kernels=0), "forwards": 3}) is None


def test_the_metric_lists_the_yolo_nano_detection_cells():
    """The three YOLO-Nano detection cells; NanoDet-Plus's postprocess
    never scores through the operator."""
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (m,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == CELLS and m["unit"] == "calls"
    assert m["better"] == "higher"
    assert m["source"] == "device_trace" and m["moves"] == "batch_p95_ms"
    assert m["layer"] == "models.yolo_nano postprocess (ops.decode, ops.nms)"
