"""The harness on the CPU: throwaway cells run end to end with the
program's plain versions, the result line, the refusals, and faults planted
in the timed path that `correct` has to catch."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.conftest import ROOT, add_cell, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SMALL_DETECT = dict(batch=2, pool=6)
SMALL_TRAIN = dict(batch=2, pool=8)
# the drivers' settings, cut for the throwaway cells
SMALL_SETTINGS = """
import benchmark.drivers.detect as _detect, benchmark.drivers.train as _train
_detect.WARMUP_BATCHES, _detect.CHECK_BATCHES = 1, 2
_detect.TRACE_SECONDS, _detect.POSTPROCESS_BATCHES = 0.5, 2
_train.TRACE_SECONDS = 0.5
"""
ARGS = ["--workload", "small", "--seed", "3000000019", "--seconds", "1"]


def _small(base):
    return SMALL_TRAIN if base.startswith("train") else SMALL_DETECT


def _run(root, argv, setup=""):
    return run_cell(root, argv, setup=SMALL_SETTINGS + setup)


@pytest.mark.parametrize("base", ["detect-1.0x-f32-b256",
                                  "detect-0.5x-bf16-b128",
                                  "evalstrict-0.5x-bf16-b128",
                                  "train-1.0x-f32-b128"])
def test_a_new_cell_runs_from_new_files_alone(checkout, base):
    """A throwaway configuration and workload, added as files and entries,
    run with no edit, and the last line is the contract's."""
    add_cell(checkout, "small", base, _small(base))
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"])
    assert rc == 0, err[-3000:]
    assert list(last) == KEYS
    assert last["correct"] is True, last["checks"]
    spec = json.load(open(os.path.join(checkout, "BENCHMARK.json")))
    want = {m["name"] for m in spec["end_to_end"]
            if "small" in m.get("workloads", ["small"])}
    assert set(last["metrics"]) == want
    assert last["device"]["count"] == 1 and last["attempted"] > 0
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_a_traced_run_reports_per_layer_metrics(checkout):
    add_cell(checkout, "small", "detect-1.0x-f32-b256", SMALL_DETECT)
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "1"])
    assert rc == 0, err[-3000:]
    assert list(last) == KEYS[:5] + ["breakdown", "checks"]
    # no device on the CPU: only the host-clock metric has something
    assert set(last["metrics"]) == {"postprocess_ms.detect"}
    assert {"busy_s", "window_s"} <= set(last["device"])
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


FAULTS = {
    # a detection altered where it is produced: every score +0.05
    "answer": ("detect-1.0x-f32-b256", """
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
"""),
    # half of the batch left out: its detections dropped
    "half_batch_detect": ("detect-0.5x-bf16-b128", """
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
"""),
    # a step that returns its state unchanged
    "unchanged": ("train-1.0x-f32-b128", """
from yolo_nano_tpu_torch.train import train_step as t
_call = t.TrainStep.__call__
def call(self, state, *a, **k):
    return state, _call(self, state, *a, **k)[1]
t.TrainStep.__call__ = call
"""),
    # a step that returns its state unchanged once the window has begun
    "unchanged_in_window": ("train-1.0x-f32-b128", """
from yolo_nano_tpu_torch.train import train_step as t
_call, calls = t.TrainStep.__call__, []
def call(self, state, *a, **k):
    calls.append(1)
    new, metrics = _call(self, state, *a, **k)
    return (new if len(calls) <= 3 else state), metrics
t.TrainStep.__call__ = call
"""),
    # half of the batch left out, the mean taken over the rest
    "half_batch_train": ("train-1.0x-f32-b128", """
from yolo_nano_tpu_torch.train import train_step as t
_call = t.TrainStep.__call__
def call(self, state, images, boxes, labels, *a, **k):
    h = len(images) // 2
    return _call(self, state, images[:h], boxes[:h], labels[:h], *a, **k)
t.TrainStep.__call__ = call
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(checkout, fault):
    """At 416 px for detection, where the trained model detects."""
    base, setup = FAULTS[fault]
    add_cell(checkout, "small", base, _small(base),
             size=64 if base.startswith("train") else 416)
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"], setup)
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["checks"]


def test_the_artifact_is_pinned(checkout):
    add_cell(checkout, "small", "detect-1.0x-f32-b256", SMALL_DETECT)
    path = os.path.join(checkout, "benchmark", "configs", "small-cfg.json")
    cfg = json.load(open(path))
    cfg["artifact_sha256"] = "0" * 64
    json.dump(cfg, open(path, "w"))
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"])
    assert rc != 0 and last is None and "sha256" in err


def test_no_result_without_the_program(checkout):
    os.remove(os.path.join(checkout, "yolo_nano_tpu_torch"))
    rc, out, err, last = run_cell(checkout, ["--workload",
                                             "detect-1.0x-f32-b256", "--seed",
                                             "1", "--seconds", "1"])
    assert rc != 0 and last is None


def test_no_result_without_cuda(checkout):
    """The command as the driver runs it, on a machine without a card."""
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "detect-1.0x-f32-b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=checkout, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES=""),
        timeout=120)
    assert p.returncode == 2 and '"correct"' not in p.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yolo_nano_tpu_torch_x", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "yolo_nano_tpu", raising=False)
    assert "yolo_nano_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "yolo_nano_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "yolo_nano_tpu"]


def test_a_dry_run_loads_no_jax(checkout):
    add_cell(checkout, "small", "detect-1.0x-f32-b256", SMALL_DETECT)
    setup = ("import atexit\n"
             "from benchmark import harness\n"
             "atexit.register(lambda: print('FORBIDDEN', "
             "harness.forbidden_modules()))\n")
    rc, out, err, last = _run(checkout, ARGS + ["--trace", "0"], setup)
    assert rc == 0 and "FORBIDDEN []" in out


def _imports(path):
    import ast

    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_the_reference_none_of_the_program():
    bench = os.path.join(ROOT, "benchmark")
    for dirpath, _, names in os.walk(bench):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "yolo_nano_tpu"}, path
            if os.sep + "reference" in path or n in ("counts.py",
                                                     "checks.py"):
                assert "yolo_nano_tpu_torch" not in tops, path
