"""The port's spans (`utils/spans.py`) on the CPU: a shared null context
with no profiler running, user annotations under `torch.profiler`; the
spans of a predict (the committed 0.5x artifact at 128 px, batch 2) and of
training steps nest by interval as `utils/spans.py` lists them; the NMS
loop's spans count its sweeps, counted apart by running the loop's body by
hand on the same candidates; detections and train states are bit-equal
with the profiler on and off."""

import contextlib
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_nano_tpu_torch.utils.spans import span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")
SIZE, BATCH = 128, 2
TRAIN_SIZE, STEPS = 64, 2
PHASES = ["ynt.train.targets", "ynt.train.loss", "ynt.train.backward",
          "ynt.train.update"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """fn() under a CPU profiler → (its result, the `ynt.` spans as
    (name, start us, end us) in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("ynt.")]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_span_is_one_null_context_without_a_profiler():
    assert span("ynt.a") is span("ynt.b")
    assert isinstance(span("ynt.a"), contextlib.nullcontext)


def test_span_records_a_user_annotation_under_the_profiler():
    def run():
        with span("ynt.test"):
            return torch.ones(3).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    (event,) = [e for e in prof.events() if e.name == "ynt.test"]
    assert event.is_user_annotation
    assert span("ynt.a") is span("ynt.b")  # null again once it stopped


@pytest.fixture(scope="module")
def predict_fn():
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.serving import predictor

    model, cfg, meta = load_model(NPZ_05X)
    return predictor(model, cfg, SIZE, torch.device("cpu"), meta["dtype"])


def _sweeps_by_hand(boxes, valid, iou_thresh):
    """The NMS loop's body run by hand until a sweep changes nothing → the
    number of sweeps."""
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import _pairwise_iou

    k = boxes.shape[-2]
    order = torch.arange(k)
    sup = (_pairwise_iou(boxes) > iou_thresh) & (order[:, None] <
                                                 order[None, :])
    keep, n = valid, 0
    while True:
        new = valid & ~(sup & keep[..., :, None]).any(-2)
        n += 1
        if torch.equal(new, keep):
            return n
        keep = new


def test_predict_spans_nest_and_count_the_sweeps(predict_fn, monkeypatch):
    """ynt.predict ⊃ {ynt.forward, then ynt.postprocess ⊃ ynt.nms.wait ×
    (n + 1) alternating with ynt.nms.sweep × n}; the same detections with
    the profiler off."""
    from yolo_nano_tpu_torch.ops import nms

    seen = []
    greedy = nms.nms_greedy

    def spy(boxes, valid, iou_thresh, diou=False):
        seen.append((boxes.clone(), valid.clone(), iou_thresh, diou))
        return greedy(boxes, valid, iou_thresh, diou)

    monkeypatch.setattr(nms, "nms_greedy", spy)
    x = np.random.default_rng(0).normal(
        size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    off = predict_fn(x)
    on, spans = _profiled(lambda: predict_fn(x))
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)

    (boxes, valid, iou_thresh, diou), _ = seen
    assert not diou and bool(valid.any())
    n = _sweeps_by_hand(boxes, valid, iou_thresh)
    assert n >= 2
    (pred,) = _named(spans, "ynt.predict")
    (fwd,) = _named(spans, "ynt.forward")
    (post,) = _named(spans, "ynt.postprocess")
    assert _inside(fwd, pred) and _inside(post, pred)
    assert fwd[2] <= post[1]
    loop = [s for s in spans if s[0].startswith("ynt.nms.")]
    assert [s[0] for s in loop] == (["ynt.nms.wait", "ynt.nms.sweep"] * n
                                    + ["ynt.nms.wait"])
    assert all(_inside(s, post) for s in loop)
    assert all(a[2] <= b[1] for a, b in zip(loop, loop[1:]))
    assert len(spans) == 3 + 2 * n + 1


def _train_setup():
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.train import make_optimizer, make_train_step
    from yolo_nano_tpu_torch.train.state import create_train_state

    cfg = YoloNanoConfig(num_classes=20, backbone="0.5x")
    tx = make_optimizer(lambda count: 1e-3)
    step = make_train_step(cfg, tx, TRAIN_SIZE, device="cpu")
    state = create_train_state(
        init_yolo_nano(torch.Generator().manual_seed(0), cfg, device="cpu"),
        tx, use_ema=True)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(
        size=(2, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32))
    boxes = torch.tensor([[[0.1, 0.1, 0.5, 0.6], [0.4, 0.3, 0.9, 0.8]],
                          [[0.2, 0.2, 0.7, 0.5], [0, 0, 0, 0]]])
    labels = torch.tensor([[3, 7], [11, -1]])
    return step, state, (images, boxes, labels)


def _steps(step, state, batch):
    for _ in range(STEPS):
        state, _ = step(state, *batch)
    return state


def test_train_step_spans_by_phase_and_bit_equal_states():
    """Each step: ynt.train.step ⊃ targets, loss, backward, update once
    each, in order, with ynt.forward inside ynt.train.loss (no augment, no
    group: no ynt.train.augment or .all_reduce); the states after the
    steps equal, leaf for leaf, those taken with the profiler off."""
    step, state0, batch = _train_setup()
    off = _steps(step, state0, batch)
    on, spans = _profiled(lambda: _steps(step, state0, batch))
    a, b = on.flat(), off.flat()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    steps = _named(spans, "ynt.train.step")
    assert len(steps) == STEPS
    for outer in steps:
        inner = [s for s in spans if s is not outer and _inside(s, outer)]
        assert [s[0] for s in inner] == (PHASES[:2] + ["ynt.forward"]
                                         + PHASES[2:])
        phases = [s for s in inner if s[0] != "ynt.forward"]
        assert all(x[2] <= y[1] for x, y in zip(phases, phases[1:]))
        (loss,) = _named(inner, "ynt.train.loss")
        (fwd,) = _named(inner, "ynt.forward")
        assert _inside(fwd, loss)
    assert len(spans) == STEPS * 6
