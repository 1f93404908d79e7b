"""Offline anchor generation: IoU-distance k-means over ground-truth box
sizes (the JAX package's `cli/kmeans_anchor.py`, numpy only): k-means++
seeding and Lloyd steps under the IoU distance, each box scaled by
img_size/max(w, h) of its image.

    python -m yolo_nano_tpu_torch.cli.kmeans_anchor \
        --root_voc /data/VOCdevkit --root_coco /data/COCO -na 9 -size 416
"""

from __future__ import annotations

import argparse

import numpy as np


def wh_iou(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """IoU of origin-centered boxes: [N,2] × [K,2] → [N,K]."""
    inter = np.minimum(wh[:, None, 0], centroids[None, :, 0]) * \
        np.minimum(wh[:, None, 1], centroids[None, :, 1])
    union = wh[:, 0:1] * wh[:, 1:2] + \
        (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_plus_plus_init(wh: np.ndarray, k: int,
                          rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding with the IoU distance."""
    centroids = [wh[rng.integers(len(wh))]]
    for _ in range(k - 1):
        d = 1.0 - wh_iou(wh, np.asarray(centroids)).max(axis=1)
        total = d.sum()
        if total <= 0:  # all boxes identical to a centroid — degenerate data
            centroids.append(wh[rng.integers(len(wh))])
            continue
        centroids.append(wh[rng.choice(len(wh), p=d / total)])
    return np.asarray(centroids)


def anchor_kmeans(wh: np.ndarray, k: int, seed: int = 0,
                  tol: float = 1e-6, max_iters: int = 1000):
    """Returns (centroids [k,2], mean IoU)."""
    rng = np.random.default_rng(seed)
    centroids = kmeans_plus_plus_init(wh, k, rng)
    last = -1.0
    for _ in range(max_iters):
        iou = wh_iou(wh, centroids)
        assign = iou.argmax(axis=1)
        mean_iou = float(iou.max(axis=1).mean())
        for j in range(k):
            sel = wh[assign == j]
            if len(sel):
                centroids[j] = sel.mean(axis=0)
        if abs(mean_iou - last) < tol:
            break
        last = mean_iou
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order], mean_iou


def collect_wh(dataset, img_size: int) -> np.ndarray:
    """Each ground-truth box's (w, h) in pixels of its image resized by
    img_size/max(w0, h0)."""
    out = []
    for i in range(len(dataset)):
        _, target, h0, w0 = dataset.load_img_targets(i)
        if not len(target):
            continue
        r = img_size / max(h0, w0)
        w = (target[:, 2] - target[:, 0]) * w0 * r
        h = (target[:, 3] - target[:, 1]) * h0 * r
        keep = (w > 0) & (h > 0)
        out.append(np.stack([w[keep], h[keep]], 1))
    return np.concatenate(out, 0)


def main(argv=None):
    p = argparse.ArgumentParser(description="anchor k-means")
    p.add_argument("--root_voc", default=None)
    p.add_argument("--voc_sets", default="2007,2012",
                   help="comma-separated VOC years for trainval")
    p.add_argument("--root_coco", default=None)
    p.add_argument("-na", "--num_anchors", default=9, type=int)
    p.add_argument("-size", "--img_size", default=416, type=int)
    p.add_argument("--seed", default=0, type=int)
    args = p.parse_args(argv)

    whs = []
    if args.root_voc:
        from yolo_nano_tpu_torch.data.voc import VOCDataset

        sets = [(y.strip(), "trainval")
                for y in args.voc_sets.split(",") if y.strip()]
        whs.append(collect_wh(VOCDataset(args.root_voc, image_sets=sets),
                              args.img_size))
    if args.root_coco:
        from yolo_nano_tpu_torch.data.coco import COCODataset

        whs.append(collect_wh(COCODataset(args.root_coco), args.img_size))
    if not whs:
        raise SystemExit("pass --root_voc and/or --root_coco")
    wh = np.concatenate(whs, 0)
    print(f"{len(wh)} boxes collected")
    centroids, mean_iou = anchor_kmeans(wh, args.num_anchors, args.seed)
    print(f"mean IoU: {mean_iou:.4f}")
    print("anchors (w, h), area-sorted:")
    for c in centroids:
        print(f"  [{c[0]:.2f}, {c[1]:.2f}],")


if __name__ == "__main__":
    main()
