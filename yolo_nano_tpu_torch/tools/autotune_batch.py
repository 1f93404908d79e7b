"""The port's serving-batch table, measured on the card.

Sweeps img/s over batch × image size × backbone and writes the table that
`serving.optimal_batch` and `serving.default_buckets` read
(yolo_nano_tpu_torch/assets/autotune_batch.json): `points` (every point's
img/s and ms per batch), `best` (the fastest batch of each backbone and
size), and `device`, the card's `nvidia-smi --query-gpu=name,power.limit`
line. It is the counterpart of the JAX package's tools/autotune_batch.py,
whose table was measured on a TPU and does not apply here.

Each backbone runs its committed artifact through `load_predictor` at the
serving operating point (conf 0.1, NMS 0.45, pre-top-k 128), in the
artifact's dtype (1.0x f32, 0.5x bf16); a backbone without an artifact
runs a seeded `init_yolo_nano_tree` through `make_predict_fn` (folded,
bf16). A size other than the artifact's runs the same model through
`serving.predictor`. A point is timed as chip_smoke.py times the main
path: numpy images in (cli.benchmark's seeded synthetic batch), numpy
detections out, host copies included, wall time over a window of calls
after two warm-up calls; the least of three windows.

    python -m yolo_nano_tpu_torch.tools.autotune_batch [--out PATH]
        [--sizes 320 416 608] [--batches 1 8 32 64 128 256]
        [--backbones 0.5x 1.0x]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(PORT, "assets", "autotune_batch.json")
ARTIFACTS = {"1.0x": os.path.join(PORT, "assets", "bench_coco416.npz"),
             "0.5x": os.path.join(PORT, "assets", "bench_coco416_05x.npz")}
SERVING = dict(conf_thresh=0.1, nms_thresh=0.45, pre_topk=128)
WINDOWS = 3


def predict_fns(backbone: str, sizes, device=None) -> dict:
    """{size: predict_fn} of one backbone, and how its weights were made."""
    from yolo_nano_tpu_torch.serving import (load_predictor, predictor,
                                             resolve_device)

    dev = resolve_device(device)
    npz = ARTIFACTS.get(backbone)
    if npz is not None:
        fn = load_predictor(npz, device=dev, **SERVING)
        dtype = str(fn.dtype)[6:]
        weights = f"{os.path.basename(npz)}, {dtype}"
        return {s: fn if s == fn.input_size else predictor(
            fn.model, fn.cfg, s, dev, dtype) for s in sizes}, weights
    import torch

    from yolo_nano_tpu_torch.cli.common import build_config, make_predict_fn
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    cfg = build_config("coco", backbone=backbone,
                       conf_thresh=SERVING["conf_thresh"],
                       nms_thresh=SERVING["nms_thresh"],
                       nms_pre_topk=SERVING["pre_topk"])
    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(0), cfg)
    fn = make_predict_fn(params, stats, cfg, sizes[0], device=dev)
    return {s: predictor(fn.model, cfg, s, dev, "bfloat16")
            for s in sizes}, "seeded init_yolo_nano_tree, bfloat16"


def time_point(fn, images: np.ndarray) -> float:
    """ms per call of fn(images), numpy in and out: the least of WINDOWS
    windows of max(3, min(50, 1024 // batch)) calls, after two warm-up
    calls."""
    iters = max(3, min(50, 1024 // images.shape[0]))
    for _ in range(2):
        fn(images)
    best = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(images)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def best_of(points: dict) -> dict:
    best = {}
    for key, v in points.items():
        bb, size, batch = key.split("/")
        k = f"{bb}/{size}"
        if k not in best or v["img_per_s"] > best[k]["img_per_s"]:
            best[k] = {"batch": int(batch), "img_per_s": v["img_per_s"]}
    return best


def sweep(sizes, batches, backbones, device=None) -> dict:
    """The table: {"points", "best", "device", "protocol"}."""
    import torch

    from yolo_nano_tpu_torch.cli.common import card_line
    from yolo_nano_tpu_torch.serving import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    points = {}
    for bb in backbones:
        fns, weights = predict_fns(bb, sizes, dev)
        for size in sizes:
            images = rng.uniform(-2, 2, (max(batches), size, size, 3)
                                 ).astype(np.float32)
            for batch in batches:
                ms = time_point(fns[size], images[:batch])
                points[f"{bb}/{size}/{batch}"] = dict(
                    img_per_s=batch / ms * 1e3, batch_ms=ms, weights=weights)
                print(f"{bb}/{size}/b{batch}: {batch / ms * 1e3:.1f} img/s "
                      f"({ms:.3f} ms a batch)", flush=True)
        del fns
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"points": points, "best": best_of(points),
            "device": card_line(dev),
            "protocol": "yolo_nano_tpu_torch/tools/autotune_batch.py: numpy "
                        "in, numpy out, host copies included, serving "
                        "operating point (conf 0.1, NMS 0.45, pre-top-k "
                        "128), least of 3 windows after 2 warm-up calls"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", nargs="+", type=int, default=[320, 416, 608])
    p.add_argument("--batches", nargs="+", type=int,
                   default=[1, 8, 32, 64, 128, 256])
    p.add_argument("--backbones", nargs="+", default=["0.5x", "1.0x"])
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    table = sweep(args.sizes, args.batches, args.backbones, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    print(f"\n{table['device']}")
    print("| backbone | size | " + " | ".join(f"b{b}" for b in args.batches)
          + " | best |")
    print("|---|---|" + "---|" * (len(args.batches) + 1))
    for bb in args.backbones:
        for size in args.sizes:
            row = [f"{table['points'][f'{bb}/{size}/{b}']['img_per_s']:.1f}"
                   for b in args.batches]
            best = table["best"][f"{bb}/{size}"]
            print(f"| {bb} | {size} | " + " | ".join(row)
                  + f" | b{best['batch']}: {best['img_per_s']:.1f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
