"""Benchmark CLI: the port's counterpart of the JAX package's
`cli/benchmark.py`, with the same flags and defaults plus `--device`. It
prints the FLOPs and parameter report, then img/s and latency over
COCO-val images (a seeded synthetic batch when there is no dataset), BN
folded, decode and NMS included.

    python -m yolo_nano_tpu_torch.cli.benchmark --root /data/COCO \\
        --img_size 416 [--weight W] [--batch_size N] [--no_fuse]

`--weight` is a port checkpoint directory or a folded `.npz` artifact (its
own configuration, with this CLI's thresholds); without it, a tree from
`init_yolo_nano_tree` with seed 0. `--batch_size` defaults to the port's
measured optimum for (backbone, img_size) (`serving.optimal_batch`, the
table `tools/autotune_batch.py` writes on the card); `--pre_topk` to the
serving budget, 128.

The timed loop cycles batches already on the device (at most 2 GB of them,
and at most 2,002 images), so that it times the card and not the host
link; each result stays on the device until the loop's end, when the last
one is fetched. The p50 latency of a batch and the reference protocol
(batch 1, `--reference_protocol`) fetch each result. The last line is a
JSON object with the JAX CLI's keys and the card's `nvidia-smi` name and
power limit. The model runs on CUDA unless `--device` names another
device; without a CUDA device and without `--device`, it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="YOLO-Nano benchmark (PyTorch)")
    p.add_argument("--root", default=None, help="COCO root (optional)")
    p.add_argument("--weight", default=None)
    p.add_argument("--img_size", default=416, type=int)
    p.add_argument("--batch_size", default=None, type=int,
                   help="default: the measured throughput optimum for "
                        "(backbone, img_size) from the port's batch table "
                        "(serving.optimal_batch), else 128")
    p.add_argument("--iters", default=30, type=int)
    p.add_argument("--conf_thresh", default=0.1, type=float)
    p.add_argument("--nms_thresh", default=0.45, type=float)
    p.add_argument("--pre_topk", default=128, type=int,
                   help="NMS candidate budget; exact while the candidates "
                        "above --conf_thresh stay below it (a warning says "
                        "when they reach it)")
    p.add_argument("--backbone", default="1.0x")
    p.add_argument("--no_fuse", action="store_true", default=False)
    p.add_argument("--reference_protocol", action="store_true", default=False,
                   help="also time the reference's own protocol: batch 1, "
                        "each result fetched, the first 2 of 102 left out")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA, which must "
                        "be present)")
    return p.parse_args(argv)


def load_tree(args, cfg):
    """(params, stats, cfg) of --weight, f32 leaves: a folded .npz artifact
    (stats None; its configuration with the CLI's thresholds), a port
    checkpoint directory, or a seeded init_yolo_nano_tree."""
    import torch

    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz, widen_tree
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    if args.weight and os.path.isfile(args.weight):
        tree, meta = load_npz(args.weight)
        cfg = config_from_json(meta, conf_thresh=cfg.conf_thresh,
                               nms_thresh=cfg.nms_thresh,
                               nms_pre_topk=cfg.nms_pre_topk)
        return widen_tree(tree), None, cfg
    if args.weight:
        from yolo_nano_tpu_torch.cli.eval import load_weights

        return (*load_weights(args.weight, cfg, use_ema=False), cfg)
    return (*init_yolo_nano_tree(torch.Generator().manual_seed(0), cfg), cfg)


def main(argv=None):
    """Run the benchmark; → a dict of its numbers (the JSON line's, the
    reference protocol's, the FLOPs report's)."""
    args = parse_args(argv)
    import torch

    from yolo_nano_tpu_torch.cli.common import (build_config, card_line,
                                                make_predict_fn)
    from yolo_nano_tpu_torch.models.yolo_nano import (forward_features,
                                                      scores_from_features)
    from yolo_nano_tpu_torch.serving import optimal_batch, resolve_device
    from yolo_nano_tpu_torch.utils.flops import flops_and_params

    dev = resolve_device(args.device)
    cfg = build_config("coco", backbone=args.backbone,
                       conf_thresh=args.conf_thresh,
                       nms_thresh=args.nms_thresh,
                       nms_pre_topk=args.pre_topk)
    params, stats, cfg = load_tree(args, cfg)
    if args.batch_size is None:
        args.batch_size = optimal_batch(args.img_size, cfg.backbone)
    gflops, gmacs, n_params = flops_and_params(params, stats, cfg,
                                               args.img_size)
    predict_fn = make_predict_fn(params, stats, cfg, args.img_size,
                                 fold=not args.no_fuse, dtype=args.dtype,
                                 device=dev)

    # input batches: real COCO-val letterboxed images when there are some,
    # a synthetic one otherwise, resident on the device (at most 2 GB)
    batch_bytes = args.batch_size * args.img_size * args.img_size * 3 * 4
    max_dev_batches = max(1, int(2e9 // batch_bytes))
    batches = []
    if args.root:
        from yolo_nano_tpu_torch.data.coco import COCODataset
        from yolo_nano_tpu_torch.data.loader import EvalLoader

        ds = COCODataset(args.root, image_set="val2017", augment=False)
        for images, _ in EvalLoader(ds, args.img_size, args.batch_size):
            batches.append(torch.from_numpy(images).to(dev))
            if (len(batches) >= max_dev_batches
                    or len(batches) * args.batch_size >= 2002):
                break
    else:
        rng = np.random.default_rng(0)
        batches = [torch.from_numpy(rng.uniform(
            -2, 2, (args.batch_size, args.img_size, args.img_size, 3)
        ).astype(np.float32)).to(dev)]

    # the candidate load above the threshold, counted on the device, so
    # that a truncation by pre_topk shows instead of passing silently
    model, tdtype = predict_fn.model, predict_fn.dtype
    with torch.inference_mode():
        counts = []
        for b in batches:
            conf_p, cls_p, _ = forward_features(model, b.to(tdtype))
            score, _ = scores_from_features(conf_p, cls_p)
            counts.append((score > args.conf_thresh).sum(1).max())
        cand_max = int(torch.stack(counts).max())
    if cand_max >= args.pre_topk:
        print(f"WARNING: above-threshold candidate load (max {cand_max}/img)"
              f" reaches --pre_topk {args.pre_topk}: NMS candidates are "
              f"TRUNCATED; raise --pre_topk", flush=True)

    predict_fn(batches[0])[1].cpu()  # build the kernels, warm up

    n_img = 0
    t0 = time.perf_counter()
    for it in range(args.iters):
        out = predict_fn(batches[it % len(batches)])
        n_img += batches[it % len(batches)].shape[0]
    out[1].cpu()
    dt = time.perf_counter() - t0

    lats = []
    for _ in range(10):
        t0 = time.perf_counter()
        predict_fn(batches[0])[1].cpu()
        lats.append(time.perf_counter() - t0)
    p50 = float(np.median(lats))

    result = {}
    if args.reference_protocol:
        one = batches[0][:1]
        predict_fn(one)[1].cpu()
        times = []
        for i in range(102):
            t0 = time.perf_counter()
            predict_fn(one)[1].cpu()
            if i >= 2:  # the reference's warm-up exclusion
                times.append(time.perf_counter() - t0)
        result.update(reference_fps=1.0 / float(np.mean(times)),
                      reference_p50_ms=float(np.median(times)) * 1e3)
        print(f"reference protocol (batch 1, per-image sync): "
              f"{result['reference_fps']:.1f} FPS, "
              f"p50 {result['reference_p50_ms']:.2f} ms/img")

    fps = n_img / dt
    card = card_line(dev)
    print(f"FPS: {fps:.1f} img/s (batch {args.batch_size})")
    print(f"p50 batch latency: {p50 * 1e3:.2f} ms "
          f"({p50 * 1e3 / args.batch_size:.3f} ms/img)")
    line = {"metric": "coco_eval_images_per_sec_per_chip",
            "value": round(fps, 1), "unit": "img/s",
            "p50_batch_ms": round(p50 * 1e3, 2),
            "candidates_max": cand_max, "pre_topk": args.pre_topk,
            "card": card}
    print(json.dumps(line))
    result.update(line, fps=fps, p50_ms=p50 * 1e3, batch=args.batch_size,
                  device_batches=len(batches), gflops=gflops, gmacs=gmacs,
                  params=n_params)
    return result


if __name__ == "__main__":
    main()
