"""Training: the program's training step (`train.train_step.make_train_step`)
driven step after step on batches made on the device, the window closed by
a synchronize.

Traffic (the workload's `traffic`): `batch` rendered scenes a step with
their shapes' boxes and classes (up to 4, padded with -1), cycled in order
through a pool of `pool` scenes made in set-up; SGD (momentum 0.9, weight
decay 5e-4) at the constant rate `lr`. Set-up builds the step and a state
drawn from the seed and takes the first `COMPARED_STEPS` steps on distinct
rows through the same call and feed as the window, which goes on from that
state; those steps are held to the reference once the window has closed,
and the window's own steps to having moved the parameters to a finite
loss. A traced run profiles the window's first `TRACE_SECONDS`.

The benchmark draws the initial weights itself, on the device, in one
call: every conv weight N(0, 2 / fan_in), biases 0, BN scale 1 and shift 0
(running mean 0, variance 1), and the objectness slots of each head's last
bias at -log(99) (a prior of 0.01). The reference starts from the same
tensors.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import checks, devtrace, scenes
from benchmark.harness import Cell
from benchmark.reference import train as ref_train

COMPARED_STEPS = 3
TRACE_SECONDS = 3.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def initial_weights(named_shapes, anchors_per_level: int, seed: int, dev):
    """{name: tensor} for the model's parameters, by the rule above."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(scenes.seed_value(seed) ^ 0x7EA1)
    weights = [(k, s) for k, s in named_shapes if k.endswith(".weight")]
    draw = torch.randn(sum(math.prod(s) for _, s in weights), generator=gen,
                       device=dev)
    out, at = {}, 0
    for k, shape in named_shapes:
        if k.endswith(".weight"):
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            out[k] = draw[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
            at += n
        elif k.endswith(".bn_scale"):
            out[k] = torch.ones(shape, device=dev)
        else:
            out[k] = torch.zeros(shape, device=dev)
            if k.startswith("head") and k.endswith(".out.bias"):
                out[k][:anchors_per_level] = -math.log(99.0)
    return out


def build(cell: Cell, seed: int, dev):
    """-> (the program's step, its initial state, batch(i) -> arguments,
    the pool's host boxes and labels)."""
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.ops.nn import set_full_f32
    from yolo_nano_tpu_torch.train.state import SGD, TrainState
    from yolo_nano_tpu_torch.train.train_step import make_train_step

    c, t = cell.config, cell.workload["traffic"]
    set_full_f32()  # f32 means f32: cuDNN's TF32 off, as cli.train sets it
    cfg = YoloNanoConfig(num_classes=c["num_classes"], backbone=c["backbone"],
                         anchors=tuple(tuple(a) for a in c["anchors"]),
                         strides=tuple(c["strides"]),
                         neck_channels=c["neck_channels"])
    lr = t["lr"]
    step = make_train_step(cfg, SGD(lambda count: lr), c["img_size"],
                           device=dev)
    a = len(c["anchors"]) // len(c["strides"])
    params = initial_weights(
        [(k, tuple(v.shape)) for k, v in step.skeleton.named_parameters()],
        a, seed, dev)
    stats = {k: (torch.ones if k.endswith("var") else torch.zeros)(
        tuple(v.shape), device=dev) for k, v in step.skeleton.named_buffers()}
    trace, count = SGD(lambda count: lr).init(params)
    state = TrainState(params, stats, trace, count, count.clone())
    n, b = t["pool"], t["batch"]
    images = scenes.render(n, c["img_size"], seed, dev)
    boxes, labels = scenes.boxes(n, c["img_size"], seed)
    gt_boxes = torch.as_tensor(boxes, device=dev)
    gt_labels = torch.as_tensor(labels, device=dev)

    def batch(i):
        lo = (i * b) % n
        return images[lo:lo + b], gt_boxes[lo:lo + b], gt_labels[lo:lo + b]

    return step, state, batch, (boxes, labels)


def first_steps(step, state, batch, k: int):
    """k steps from `state` -> (state after, losses, momentum after step 1,
    parameters before)."""
    params0 = {n: v.clone() for n, v in state.params.items()}
    losses, trace1 = [], None
    for i in range(k):
        state, metrics = step(state, *batch(i))
        losses.append(metrics["loss/total"])
        if i == 0:
            trace1 = {n: v.clone() for n, v in state.trace.items()}
    return state, losses, trace1, params0


def reference_steps(cell: Cell, params0, batch, host, k: int, precision=None):
    c, t = cell.config, cell.workload["traffic"]
    boxes, labels = host
    b, n = t["batch"], t["pool"]
    feed = []
    for i in range(k):
        lo = (i * b) % n
        feed.append((batch(i)[0], boxes[lo:lo + b], labels[lo:lo + b]))
    return ref_train.train(params0, feed, c["anchors"], c["strides"],
                           c["img_size"], t["lr"], precision=precision)


def run(cell: Cell, args, dev, t_start: float) -> dict:
    t = cell.workload["traffic"]
    k = COMPARED_STEPS
    step, state, batch, host = build(cell, args.seed, dev)
    state, losses, trace1, params0 = first_steps(step, state, batch, k)
    params_k = state.params
    _sync(dev)

    window = devtrace.Window(dev)
    if args.trace:
        window.start()
    t_begin = time.perf_counter()
    setup_s = t_begin - t_start
    skipped = torch.zeros((), dtype=torch.int32, device=dev)
    issue, steps, traced = [], 0, 0
    while True:
        t0 = time.perf_counter()
        state, metrics = step(state, *batch(k + steps))
        t1 = time.perf_counter()
        skipped += metrics["skipped_nonfinite"]
        steps += 1
        if window.open:
            if t1 - t_begin >= TRACE_SECONDS:
                _sync(dev)
                window.stop()
                traced = steps
        else:
            issue.append(t1 - t0)
        if t1 - t_begin >= args.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t_begin
    if window.open:
        window.stop()
        traced = steps
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    batch_size = t["batch"]
    result = {"attempted": steps, "failed": int(skipped),
              "memory_peak_bytes": peak,
              "e2e": {"train_img_per_s": steps * batch_size / window_s,
                      "setup_s": setup_s},
              "notes": {"steps": steps, "window_s": window_s}}
    t0 = time.perf_counter()
    if args.trace:
        result["ctx"] = {"trace": window.read(), "steps": traced,
                         "images": traced * batch_size, "batch": batch_size,
                         "spans": {"step_issue_s": issue}}
    losses = [float(v) for v in losses]
    moved = any(not torch.equal(v, params_k[n])
                for n, v in state.params.items())
    still = float(not (moved and math.isfinite(float(metrics["loss/total"]))))
    del state, step, metrics
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["notes"]["trace_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = reference_steps(cell, params0, batch, host, k)
    result["numbers"] = dict(checks.training_numbers(
        losses, trace1, params0, params_k, ref), window_still=still)
    result["notes"]["check_s"] = time.perf_counter() - t0
    result["notes"]["losses"] = losses
    result["notes"]["reference_losses"] = ref[0]
    return result


def readings(cell: Cell, seeds, dev, control=None) -> list:
    """The numbers compared, per seed: from the program's first steps, or
    with `control` ("tf32") from the reference computed so."""
    k = COMPARED_STEPS
    out = []
    for seed in seeds:
        step, state, batch, host = build(cell, seed, dev)
        params0 = {n: v.clone() for n, v in state.params.items()}
        if control is None:
            state, losses, trace1, params0 = first_steps(step, state, batch,
                                                         k)
            losses, params_k = [float(v) for v in losses], state.params
        else:
            losses, _, trace1, params_k = reference_steps(
                cell, params0, batch, host, k, precision=control)
        del step, state
        ref = reference_steps(cell, params0, batch, host, k)
        out.append({"seed": seed, **checks.training_numbers(
            losses, trace1, params0, params_k, ref)})
    return out
