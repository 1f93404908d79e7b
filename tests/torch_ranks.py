"""Rank processes for the port's data-parallel tests: each runs a function
as one rank of a gloo process group on the CPU.

`start_ranks` starts n processes with torch.multiprocessing (spawn, so
that nothing of the parent's state leaks in), each joining a group through
a `file://` store under the test's own directory (so that tests running
side by side cannot meet on a port), with the group's timeout and a
join timeout of their own: a rank that dies or hangs fails its test
within a minute or two. Each rank's function returns a value, which the
rank saves with torch.save; the parent gets the list in rank order.

This module imports torch and numpy only: the ranks never import JAX.
"""

from __future__ import annotations

import os
import time

import torch

GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0


def _entry(rank, fn, n, store, out_dir, threads, args):
    torch.set_num_threads(threads)
    from yolo_nano_tpu_torch.parallel.multiprocess import (initialize,
                                                           shutdown_tolerant)

    initialize(f"file://{store}", n, rank, device="cpu",
               timeout_s=GROUP_TIMEOUT_S)
    try:
        result = fn(rank, n, *args)
    finally:
        shutdown_tolerant()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def start_ranks(fn, n, work_dir, *args, threads=1):
    """fn(rank, n, *args) on n gloo ranks (module docstring); fn must be
    a top-level function of an importable module. → a handle for
    join_ranks: the parent works while the ranks run."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(str(work_dir), f"ranks_{fn.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.start_processes(_entry, args=(fn, n, store, out_dir, threads,
                                           args),
                             nprocs=n, join=False, start_method="spawn")
    return ctx, out_dir, n


def join_ranks(handle, timeout_s=JOIN_TIMEOUT_S):
    """→ [result of rank 0, ..., rank n−1]. Raises if a rank failed or the
    ranks outlast timeout_s (they are killed)."""
    ctx, out_dir, n = handle
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"the {n} ranks did not finish within "
                                     f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


class Kinks:
    """Stands in for the port's activation function (ops.nn.activate) and
    records, per call, its input (pre-activation); given `masks` (one bool
    tensor per call, in call order) it takes those as the kink decisions
    (x ≥ 0) instead of x's own signs, with the same slopes. The f64
    witnesses of the f32 steps hold each side to the exact step with that
    side's own kink decisions."""

    def __init__(self, act, slope, masks=None):
        self.act, self.slope, self.masks, self.seen = act, slope, masks, []

    def __call__(self, x, kind):
        if kind is None:
            return x
        self.seen.append(x.detach().clone())
        if self.masks is None:
            return self.act(x, kind)
        keep = self.masks[len(self.seen) - 1]
        assert keep.shape == x.shape
        return torch.where(keep, x, (0.0 if kind == "relu"
                                     else self.slope(x.dtype)) * x)


# ---------------------------------------------------------------------------
# the ranks of tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def _bn_rows(bn: dict, rows: slice, dtype, group):
    """batch_norm_train inside sync_batch_norm on this rank's rows; with
    f64, also the input gradient of sum(out · up)."""
    from yolo_nano_tpu_torch.ops.nn import batch_norm_train, sync_batch_norm

    y = bn["y"][rows].to(dtype).requires_grad_(True)
    args = [bn[k].to(dtype) for k in ("scale", "bias", "mean", "var")]
    with sync_batch_norm(group):
        out, mean, var = batch_norm_train(y, *args)
    (out * bn["up"][rows].to(dtype)).sum().backward()
    return dict(out=out.detach(), mean=mean, var=var, grad=y.grad)


def parallel_checks(rank, n, inputs_path, work_dir):
    """Every data-parallel piece of the port on this rank's rows of the
    inputs tests/test_torch_parallel.py wrote: → a dict of its results."""
    import numpy as np
    import torch.distributed as dist

    from yolo_nano_tpu_torch.cli.common import build_config, make_predict_fn
    from yolo_nano_tpu_torch.config import YoloNanoConfig, config_from_json
    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.data.device_aug import make_augment_fn
    from yolo_nano_tpu_torch.data.loader import device_prefetch
    from yolo_nano_tpu_torch.evaluation.evaluator import VOCEvaluator
    from yolo_nano_tpu_torch.ops import nn as tnn
    from yolo_nano_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                   make_mesh_2d, mesh_group,
                                                   shard_batch)
    from yolo_nano_tpu_torch.parallel.multiprocess import (global_batch,
                                                           replicate_tree)
    from yolo_nano_tpu_torch.serving import load_predictor
    from yolo_nano_tpu_torch.train import (make_optimizer, make_train_step,
                                           warmup_step_schedule)
    from yolo_nano_tpu_torch.train.state import TrainState
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh()
    sh = batch_sharding(mesh)
    group = mesh_group(mesh)
    sh_2d = batch_sharding(make_mesh_2d(1, n))
    out = dict(place=(sh.index, sh.count), place_2d=(sh_2d.index,
                                                     sh_2d.count))
    try:
        make_mesh(n + 1)
    except ValueError as e:
        out["mesh_refusal"] = str(e)

    bn = inp["bn"]
    rows = sh.rows(bn["y"].shape[0])
    out["bn64"] = _bn_rows(bn, rows, torch.float64, group)
    out["bn32"] = _bn_rows(bn, rows, torch.float32, group)
    # a group of one process (every rank makes every group, keeps its own)
    alone = [dist.new_group([r]) for r in range(n)][rank]
    out["bn_alone"] = {k: _bn_rows(bn, slice(None), torch.float32, g)
                       for k, g in (("group", alone), ("plain", None))}

    # the state: rank 0's, bit for bit, whatever the others started from
    t = inp["train"]
    state0 = TrainState.from_flat(t["state0"])
    other = TrainState.from_flat({k: v + rank
                                  for k, v in t["state0"].items()})
    out["replicated"] = replicate_tree(mesh, other).flat()

    cfg = YoloNanoConfig(num_classes=20)
    tx = make_optimizer(warmup_step_schedule(**t["schedule"]))
    batch = shard_batch(mesh, t["images"], t["boxes"], t["labels"])
    out["local_batch"] = global_batch(mesh, *(np.asarray(a)[rows] for a in (
        t["images"], t["boxes"], t["labels"])))
    out["shard_batch"] = batch
    step = make_train_step(cfg, tx, t["size"], device="cpu", mesh=mesh)
    s, metrics = state0.to("cpu", torch.float64), []
    for _ in range(t["steps"]):
        s, m = step(s, batch[0].double(), *batch[1:])
        metrics.append({k: float(v) for k, v in m.items()})
    out["f64"] = (s.flat(), metrics)
    kinks = Kinks(tnn.activate, tnn._leaky_slope)
    tnn.activate = kinks
    try:
        s, m = step(state0, *batch)
    finally:
        tnn.activate = kinks.act
    out["f32"] = (s.flat(), {k: float(v) for k, v in m.items()})
    out["f32_kinks"] = [x >= 0 for x in kinks.seen]

    a = inp["aug"]
    aug_batch = shard_batch(mesh, *a["batch"])
    augment = make_augment_fn(t["size"], out_dtype=torch.float64,
                              mosaic=True, mesh=mesh)
    out["augmented"] = augment(*aug_batch,
                               torch.Generator().manual_seed(a["seed"]))
    astep = make_train_step(cfg, tx, t["size"], device="cpu",
                            augment=augment, mesh=mesh)
    s, m = astep(state0.to("cpu", torch.float64), *aug_batch,
                 torch.Generator().manual_seed(a["seed"]))
    out["aug_step"] = (s.flat(), {k: float(v) for k, v in m.items()})

    p = inp["predict"]
    tree, meta = load_npz(p["npz"])
    pcfg = config_from_json(meta)
    images = p["images"]
    kw = dict(fold=False, device="cpu", mesh=mesh,
              process_shard=(sh.index, sh.count))
    out["predict_f32"] = make_predict_fn(
        tree, None, pcfg, meta["img_size"], dtype="float32", local_rows=True,
        **kw)(images[rows])
    out["predict_f32_whole"] = make_predict_fn(
        tree, None, pcfg, meta["img_size"], dtype="float32", **kw)(images)
    out["predict_bf16"] = make_predict_fn(
        tree, None, pcfg, meta["img_size"], local_rows=True, **kw)(
            images[rows])
    out["predict_bf16_alone"] = make_predict_fn(
        tree, None, pcfg, meta["img_size"], fold=False, device="cpu")(
            images[rows])
    served = load_predictor(p["npz"], mesh=mesh, batch_buckets=(2, 4))
    out["load_predictor"] = served(images[:3])
    try:
        load_predictor(p["npz"], mesh=mesh, batch_buckets=(1, 4))
    except ValueError as e:
        out["bucket_refusal"] = str(e)

    e = inp["eval"]
    ecfg = build_config("voc", backbone=e["backbone"])
    evaluator = VOCEvaluator(e["root"], e["size"], batch_size=e["batch"],
                             num_workers=1, process_shard=(sh.index,
                                                           sh.count))
    evaluator.evaluate(make_predict_fn(
        e["params"], e["stats"], ecfg, e["size"], dtype="float32",
        device="cpu", mesh=mesh, process_shard=(sh.index, sh.count),
        local_rows=True))
    out["eval"] = dict(map=evaluator.map, aps=evaluator.aps)

    # device_prefetch(sharding=): this rank's rows of each global batch
    host = [tuple(np.asarray(x) for x in (t["images"], t["boxes"],
                                           t["labels"]))] * 2
    out["prefetched"] = list(device_prefetch(iter(host), sharding=sh))

    # checkpoints: rank 0 writes, every rank reads it after the barrier
    ckpt = CheckpointManager(os.path.join(str(work_dir), "ckpt"))
    ckpt.save(7, state0 if rank == 0 else other)
    out["ckpt_steps"] = ckpt.steps()
    out["ckpt"] = ckpt.restore(state0).flat()
    return out
