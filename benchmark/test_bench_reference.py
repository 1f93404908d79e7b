"""The yardstick on the CPU: the plain reference against the port, the
counts against the repository's FLOP count, the scenes, and the controls
(the reference one precision down) read above the limits."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import checks, counts, scenes
from benchmark.conftest import ROOT
from benchmark.harness import load_cell
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

CONFIGS = ("yolo_nano-1.0x-coco416-f32", "yolo_nano-0.5x-coco416-bf16")


def _config(name):
    return json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       f"{name}.json")))


@pytest.mark.parametrize("name", CONFIGS)
def test_flop_count_matches_the_repository_count(name):
    """`counts.model_flops` within 0.5% of `utils/flops.py` at 416 px."""
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.utils.flops import flops_and_params

    c = _config(name)
    tree, meta = load_npz(os.path.join(ROOT, c["artifact"]))
    gflops, _, n = flops_and_params(tree, None, config_from_json(meta), 416)
    assert abs(counts.model_flops(c) / (gflops * 1e9) - 1) < 5e-3
    assert n == c["parameters"]


def test_launch_counts_are_the_forward_s():
    c = _config(CONFIGS[0])
    assert len(counts.stage_launches(c, 32)) == 16
    assert len(counts.head_pair_launches(c, 32)) == 6
    # the f32 stages at batch 32, each one function: 0.1505 ms at their
    # bound (operations); the bf16 0.5x stages 0.0131 ms (bytes)
    assert 0.150 < counts.stage_least_s(c, 32, "float32") * 1e3 < 0.151
    assert 0.0130 < counts.stage_least_s(_config(CONFIGS[1]), 32,
                                         "bfloat16") * 1e3 < 0.0132


def test_scenes_repeat_for_a_seed_and_their_boxes_hold_their_shapes():
    a = scenes.render(3, 96, 2 ** 33 + 5, "cpu")
    assert torch.equal(a, scenes.render(3, 96, 2 ** 33 + 5, "cpu"))
    assert not torch.equal(a, scenes.render(3, 96, 7, "cpu"))
    boxes, labels = scenes.boxes(3, 96, 2 ** 33 + 5)
    count = scenes.layout(3, 96, 2 ** 33 + 5)[0]
    assert ((labels >= 0).sum(1) == count).all()
    assert (boxes[labels >= 0][:, 2:] <= 1).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_matches_the_port(name):
    """Head outputs of the folded artifact, plain reference against the
    port's model on the CPU (its kernels' plain versions), at 128 px."""
    from yolo_nano_tpu_torch.convert import load_model

    c = _config(name)
    model, cfg, _ = load_model(os.path.join(ROOT, c["artifact"]))
    model = model.float()
    units, _ = ref_model.load_folded(os.path.join(ROOT, c["artifact"]))
    x = scenes.render(2, 128, 3, "cpu")
    with torch.no_grad():
        conf, cls, box = model(x)
        obj, logits, raw = ref_model.Forward(units, 3)(x)
    tol = 1e-4 * max(float(cls.abs().max()), 1.0)
    assert (conf[..., 0] - obj).abs().max() < tol
    assert (cls - logits).abs().max() < tol
    assert (box.reshape(raw.shape) - raw).abs().max() < tol


def test_reference_detections_match_the_port_s_predict():
    """The f32 artifact at 416 px on two scenes: the port's detections
    read a few f32 roundings off the reference at both operating points."""
    from yolo_nano_tpu_torch.serving import load_predictor

    cell = load_cell("detect-1.0x-f32-b256")
    from benchmark.drivers import detect

    ref = detect.Reference(cell, torch.device("cpu"))
    x = scenes.render(2, 416, 11, "cpu")
    for point in (dict(conf_thresh=0.1, nms_thresh=0.45, pre_topk=128,
                       max_det=128),
                  dict(conf_thresh=0.001, nms_thresh=0.5, pre_topk=512,
                       max_det=128)):
        ref.point = point
        fn = load_predictor(os.path.join(ROOT, cell.config["artifact"]),
                            device="cpu", **point)
        out = tuple(t.numpy() for t in fn(x))
        assert out[3].sum() > 0
        nums, _ = checks.detection_numbers(out, *ref(x), point)
        assert max(nums.values()) < 1e-4, nums


def test_reference_targets_equal_the_port_s():
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.losses.targets import build_targets

    c = _config(CONFIGS[0])
    cfg = YoloNanoConfig(num_classes=80, anchors=tuple(map(tuple,
                                                           c["anchors"])))
    for size in (64, 416):
        boxes, labels = scenes.boxes(32, size, 5)
        got = build_targets(torch.as_tensor(boxes), torch.as_tensor(labels),
                            cfg, size).numpy()
        want = ref_train.targets(boxes, labels, c["anchors"], c["strides"],
                                 size)
        assert np.abs(got - want).max() < 1e-6


def test_reference_training_follows_the_port_s_step():
    """Three steps at 64 px, batch 2, on the CPU: the numbers compared read
    within the cell's limits (a step that leaves its state unchanged reads
    1, half a batch reads 0.6 to 1 in `grad_gap`)."""
    from benchmark.drivers import train

    cell = load_cell("train-1.0x-f32-b128")
    cell.config["img_size"] = 64
    cell.workload["traffic"].update(batch=2, pool=6)
    (row,) = train.readings(cell, [9], torch.device("cpu"))
    for k, limit in _compared(cell, row).items():
        assert row[k] < limit, (k, row)


def _compared(cell, row):
    """The cell's limits of the numbers that readings (no window) give."""
    return {k: v for k, v in cell.workload["limits"].items() if k in row}


@pytest.mark.parametrize("workload", ["detect-0.5x-bf16-b128",
                                      "evalstrict-0.5x-bf16-b128"])
def test_the_fp8_control_fails_the_bf16_cells(workload, monkeypatch):
    """The reference in float8 in the program's place, on the CPU at 416
    px, one batch of 16: above the cell's limits."""
    from benchmark.drivers import detect

    cell = load_cell(workload)
    cell.workload["traffic"].update(batch=16, pool=32)
    monkeypatch.setattr(detect, "CHECK_BATCHES", 1)
    (row,) = detect.readings(cell, [2], torch.device("cpu"),
                             control=cell.config["control"])
    ok, _ = checks.judge(row, cell.workload["limits"])
    assert not ok, row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["detect-1.0x-f32-b256",
                                      "train-1.0x-f32-b128"])
def test_the_tf32_control_fails_the_f32_cells(cuda_device, workload,
                                              monkeypatch):
    """TF32 exists on the card only: the reference with cuDNN's TF32 on, in
    the program's place, at batch 8 (detection at 416 px, training at 128
    px), reads above the cell's limits."""
    cell = load_cell(workload)
    t = cell.workload["traffic"]
    from benchmark import harness

    driver = harness.driver(cell)
    if cell.workload["kind"] == "detect":
        t.update(batch=8, pool=16)
        monkeypatch.setattr(driver, "CHECK_BATCHES", 1)
    else:
        cell.config["img_size"] = 128
        t.update(batch=8, pool=24)
    rows = driver.readings(cell, [3], cuda_device,
                           control=cell.config["control"])
    ok, _ = checks.judge(rows[0], _compared(cell, rows[0]))
    assert not ok, rows
