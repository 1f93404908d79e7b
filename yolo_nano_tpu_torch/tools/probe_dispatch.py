"""Host time of predict on the card, for one checkout: the parameter path
and, where the checkout has one, the replayed serving graph.

    python yolo_nano_tpu_torch/tools/probe_dispatch.py [--root CHECKOUT]

Run as a script (not with -m), so that the package is imported from
--root only: another checkout, e.g. the parent commit unpacked with `git
archive`, is timed alike. Run two checkouts in one call as parent,
change, change, parent: the host's share of a batch-1 predict moves 2x
between machines.

For each committed artifact (f32 1.0x, bf16 0.5x) at 416 px, at batch 1,
8 and 32, on seeded images, the wall ms a call, back to back with the device
drained at the end; the least and the median over WINDOWS windows, each
window timing every function below in turn (the host's time moves from
window to window):

1. the parameter path: the model's forward (16 stage-block and 6
   head-pair kernel launches among its ops), `postprocess_scored` (top-k,
   decode, NMS with its host reads) and the whole `predict`;
2. with `serving.export_graph` in the checkout, after part 1 for both
   artifacts, each artifact's serving graph exported on the CPU and
   replayed on the card: `graph_predictor`'s predict (the program's graph
   module called with its weights), the same graph as
   `ExportedProgram.module()` (which checks and flattens its inputs and
   looks up its weights on each call), the parameter path's
   `load_predictor` predict, all f32 device tensors in and out, and part
   1's `predict` again (`predict_after_export`);
3. with a graph, after all the timings, one batch-1 call of each of
   those three under `torch.profiler` (CPU activity): the call's wall µs, and the outermost
   operator calls, counted, with their host µs summed by kind (the
   kernels' operators, the ATen operators, any other event by its name);
   the rest of the wall time is Python between the operators.

Prints one JSON line. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import sys
import tempfile
import time

ITERS = {1: 50, 8: 20, 32: 10}
WINDOWS = 15
NPZS = ("bench_coco416.npz", "bench_coco416_05x.npz")


def wall_ms(fns: dict, iters: int) -> dict:
    """{name: {min, median}} over WINDOWS windows of the wall ms a call of
    each of fns; every window times each fn in turn, so that the host's
    drift from window to window falls on all of them alike."""
    import numpy as np
    import torch

    times = {k: [] for k in fns}
    for fn in fns.values():
        for _ in range(5):
            fn()
    for _ in range(WINDOWS):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / iters * 1e3)
    return {f"{k}_ms": dict(min=min(v), median=float(np.median(v)))
            for k, v in times.items()}


def host_breakdown(fn) -> dict:
    """Part 3 of the module docstring, for one call of fn: the operator
    calls that no other operator made, counted and their host µs summed by
    kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    out = dict(wall_us=wall)
    for e in prof.events():
        if e.cpu_parent is not None:
            continue
        kind = ("kernel_ops" if e.name.startswith("yolo_nano_torch::")
                else "aten" if e.name.startswith("aten::") else e.name)
        out[f"{kind}_calls"] = out.get(f"{kind}_calls", 0) + 1
        out[f"{kind}_us"] = out.get(f"{kind}_us", 0.0) + e.cpu_time_total
    return out


def parameter_path(name: str, root: str, rng) -> dict:
    """Part 1's functions of one committed artifact: {batch: (f32 images,
    {name: fn})}, and "model", "cfg", "meta"."""
    import numpy as np
    import torch

    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.models.yolo_nano import (postprocess_scored,
                                                      predict,
                                                      scores_from_features)

    model, cfg, meta = load_model(os.path.join(
        root, "yolo_nano_tpu_torch", "assets", name))
    size, dt = meta["img_size"], getattr(torch, meta["dtype"])
    out = dict(model=model, cfg=cfg, meta=meta)
    cuda = copy.deepcopy(model).cuda()  # `model` stays on the CPU
    for b in ITERS:
        x32 = torch.from_numpy(rng.uniform(-2, 2, (b, size, size, 3)).astype(
            np.float32)).cuda()
        x = x32.to(dt)
        with torch.inference_mode():
            conf, cls, txty = cuda(x)
            score, cidx = scores_from_features(conf, cls)
        out[b] = (x32, dict(
            forward=functools.partial(cuda, x),
            postprocess=functools.partial(postprocess_scored, txty, score,
                                          cidx, cfg, size),
            predict=functools.partial(predict, cuda, x, cfg, size)))
    return out


def graph_paths(name: str, root: str, tmp: str, part1: dict) -> dict:
    """Part 2's predictors of one committed artifact: {name: fn(images)},
    the graph exported from part 1's model on the CPU."""
    import torch

    from yolo_nano_tpu_torch import serving
    from yolo_nano_tpu_torch.convert import load_npz, save_npz
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32

    path = os.path.join(tmp, name)
    tree, written = load_npz(os.path.join(root, "yolo_nano_tpu_torch",
                                          "assets", name))
    save_npz(path, tree, dict(written, graph=True))
    meta = part1["meta"]
    serving.export_graph(part1["model"], part1["cfg"], meta["img_size"],
                         meta["dtype"], serving.graph_path(path))
    graph = serving.load_predictor(path)
    module = graph.graph.module()

    def unlifted(x):
        set_full_f32()
        with torch.inference_mode():
            return module(x)

    return dict(graph=graph, unlifted=unlifted,
                params=serving.load_predictor(path, prefer_params=True))


def probe(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from yolo_nano_tpu_torch import serving
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32

    set_full_f32()
    out = {"root": root, "torch": torch.__version__}
    rng = np.random.default_rng(0)
    part1 = {name[:-4]: parameter_path(name, root, rng) for name in NPZS}
    with torch.inference_mode():  # part 1, before any export
        for key, p in part1.items():
            for b, iters in ITERS.items():
                out[f"{key}/b{b}"] = wall_ms(p[b][1], iters)
    if not hasattr(serving, "export_graph"):
        return out
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name[:-4]: graph_paths(name, root, tmp, part1[name[:-4]])
                 for name in NPZS}
        for key, fns in paths.items():  # part 2
            for b, iters in ITERS.items():
                x32, p = part1[key][b]
                calls = {f"{k}_predict": functools.partial(f, x32)
                         for k, f in fns.items()}
                # the parameter path's predict again, after the exports
                calls["predict_after_export"] = p["predict"]
                with torch.inference_mode():
                    out[f"{key}/b{b}"].update(wall_ms(calls, iters))
        # part 3 last: the profiler's hooks may slow what runs after it
        for key, fns in paths.items():
            x32 = part1[key][1][0]
            out[f"{key}/b1"]["host"] = {
                k: host_breakdown(functools.partial(f, x32))
                for k, f in fns.items()}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = parser.parse_args()
    print(json.dumps(probe(os.path.abspath(args.root))))


if __name__ == "__main__":
    main()
