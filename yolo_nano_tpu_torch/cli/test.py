"""Visualization CLI: the port's counterpart of the JAX package's
`cli/test.py`, with the same flags and defaults plus `--device`. It runs
detection over a dataset split, draws the boxes and writes JPEGs to
det_results/, optionally with TTA.

    python -m yolo_nano_tpu_torch.cli.test -d voc --root /data/VOCdevkit \\
        --weight weights/voc/ckpt --img_size 416 --num_images 20 [--tta]

`--weight` is a port checkpoint directory (`--ema` for its EMA weights) or
a folded `.npz` artifact, as for `cli/eval.py`. The model runs on CUDA
unless `--device` names another device; without a CUDA device and without
`--device`, it raises.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="YOLO-Nano visualization "
                                            "(PyTorch)")
    p.add_argument("-d", "--dataset", default="voc", choices=["voc", "coco"])
    p.add_argument("--root", default="/data")
    p.add_argument("--weight", required=True,
                   help="a port CheckpointManager directory or a folded "
                        ".npz artifact")
    p.add_argument("--img_size", default=416, type=int)
    p.add_argument("--conf_thresh", default=0.1, type=float)
    p.add_argument("--nms_thresh", default=0.50, type=float)
    p.add_argument("--vis_thresh", default=0.3, type=float)
    p.add_argument("--num_images", default=100, type=int)
    p.add_argument("--save_folder", default="det_results/", type=str)
    p.add_argument("--backbone", default="1.0x")
    p.add_argument("--ema", action="store_true", default=False)
    p.add_argument("--tta", action="store_true", default=False)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA, which must "
                        "be present)")
    return p.parse_args(argv)


def main(argv=None):
    """Write the first --num_images images of the split with their
    detections drawn; → the number written."""
    args = parse_args(argv)
    import cv2

    from yolo_nano_tpu_torch.cli.common import (build_config,
                                                class_names_for,
                                                draw_detections)
    from yolo_nano_tpu_torch.cli.eval import build_predict_fn
    from yolo_nano_tpu_torch.data.transforms import (letterbox_undo,
                                                     val_transform)

    cfg = build_config(args.dataset, backbone=args.backbone,
                       conf_thresh=args.conf_thresh,
                       nms_thresh=args.nms_thresh)
    predict_fn = build_predict_fn(args, cfg)
    names = class_names_for(args.dataset)

    if args.dataset == "voc":
        from yolo_nano_tpu_torch.data.voc import VOCDataset

        ds = VOCDataset(args.root, image_sets=[("2007", "test")],
                        augment=False)
    else:
        from yolo_nano_tpu_torch.data.coco import COCODataset

        ds = COCODataset(args.root, image_set="val2017", augment=False)

    os.makedirs(args.save_folder, exist_ok=True)
    n = min(args.num_images, len(ds))
    for i in range(n):
        img_bgr, _ = ds.pull_image(i)
        h, w = img_bgr.shape[:2]
        x, scale, offset = val_transform(img_bgr, args.img_size)
        boxes, scores, classes, valid = predict_fn(x[None])
        v = valid[0]
        b = letterbox_undo(boxes[0][v], scale, offset, w, h)
        out = draw_detections(img_bgr, b, scores[0][v], classes[0][v], names,
                              args.vis_thresh)
        cv2.imwrite(os.path.join(args.save_folder, f"{i:06d}.jpg"), out)
        if i % 20 == 0:
            print(f"[test {i}/{n}]")
    print(f"saved {n} visualizations to {args.save_folder}")
    return n


if __name__ == "__main__":
    main()
