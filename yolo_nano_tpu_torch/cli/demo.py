"""Demo CLI: the port's counterpart of the JAX package's `cli/demo.py`,
image, video and camera inference at batch 1 with the detections drawn,
with the same flags and defaults plus `--device`.

    python -m yolo_nano_tpu_torch.cli.demo --mode image --path img.jpg --weight W
    python -m yolo_nano_tpu_torch.cli.demo --mode video --path in.mp4 --weight W
    python -m yolo_nano_tpu_torch.cli.demo --mode camera --weight W

`--weight` is a port checkpoint directory or a folded `.npz` artifact, as
for `cli/eval.py`. The streaming modes report each frame's wall time
(preprocess, predict, draw) as p50 and p99 and the sustained FPS, the
first frame (kernel build, cuDNN's choice of algorithms) left out. The
model runs on CUDA unless `--device` names another device; without a
CUDA device and without `--device`, it raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="YOLO-Nano demo (PyTorch)")
    p.add_argument("--mode", default="image",
                   choices=["image", "video", "camera"])
    p.add_argument("--path", default=None,
                   help="image file/dir or video file")
    p.add_argument("--weight", required=True)
    p.add_argument("-d", "--dataset", default="coco", choices=["voc", "coco"])
    p.add_argument("--img_size", default=416, type=int)
    p.add_argument("--conf_thresh", default=0.35, type=float)
    p.add_argument("--nms_thresh", default=0.50, type=float)
    p.add_argument("--vis_thresh", default=0.35, type=float)
    p.add_argument("--path_to_save", default="det_results/demo/", type=str)
    p.add_argument("--show", action="store_true", default=False)
    p.add_argument("--backbone", default="1.0x")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA, which must "
                        "be present)")
    return p.parse_args(argv)


def _detect_frame(frame_bgr, predict_fn, img_size, names, vis_thresh):
    from yolo_nano_tpu_torch.cli.common import draw_detections
    from yolo_nano_tpu_torch.data.transforms import (letterbox_undo,
                                                     val_transform)

    h, w = frame_bgr.shape[:2]
    x, scale, offset = val_transform(frame_bgr, img_size)
    boxes, scores, classes, valid = predict_fn(x[None])
    v = valid[0]
    b = letterbox_undo(boxes[0][v], scale, offset, w, h)
    return draw_detections(frame_bgr, b, scores[0][v], classes[0][v], names,
                           vis_thresh)


def main(argv=None):
    """Run the mode; → {"frames": n, "latency_ms": per-frame wall times
    with the first left out} (image mode: one entry per image written)."""
    args = parse_args(argv)
    import cv2

    from yolo_nano_tpu_torch.cli.common import build_config, class_names_for
    from yolo_nano_tpu_torch.cli.eval import build_predict_fn

    if args.mode in ("image", "video") and not args.path:
        raise SystemExit(f"--path is required for --mode {args.mode} "
                         "(an image file/directory or a video file)")
    cfg = build_config(args.dataset, backbone=args.backbone,
                       conf_thresh=args.conf_thresh,
                       nms_thresh=args.nms_thresh)
    predict_fn = build_predict_fn(args, cfg)
    names = class_names_for(args.dataset)
    os.makedirs(args.path_to_save, exist_ok=True)

    if args.mode == "image":
        paths = ([os.path.join(args.path, f) for f in os.listdir(args.path)]
                 if os.path.isdir(args.path) else [args.path])
        written = []
        for i, pth in enumerate(sorted(paths)):
            img = cv2.imread(pth)
            if img is None:
                continue
            out = _detect_frame(img, predict_fn, args.img_size, names,
                                args.vis_thresh)
            dst = os.path.join(args.path_to_save, os.path.basename(pth))
            cv2.imwrite(dst, out)
            written.append(dst)
            if args.show:
                cv2.imshow("detection", out)
                cv2.waitKey(0)
            print(f"[{i + 1}/{len(paths)}] → {dst}")
        return {"frames": len(written), "latency_ms": []}

    # the streaming modes run the batch-1 predict every frame
    cap = cv2.VideoCapture(0 if args.mode == "camera" else args.path)
    writer = None
    idx = 0
    frame_times = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        t0 = time.perf_counter()
        out = _detect_frame(frame, predict_fn, args.img_size, names,
                            args.vis_thresh)
        frame_times.append(time.perf_counter() - t0)
        if args.mode == "video":
            if writer is None:
                fps = cap.get(cv2.CAP_PROP_FPS) or 30
                dst = os.path.join(args.path_to_save, "demo_out.avi")
                writer = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"XVID"),
                                         fps, (out.shape[1], out.shape[0]))
                if not writer.isOpened():
                    raise RuntimeError(f"cv2.VideoWriter could not open {dst}"
                                       " with the XVID codec")
            writer.write(out)
        if args.show:
            cv2.imshow("detection", out)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        idx += 1
        if idx % 50 == 0:
            recent = frame_times[-50:]
            print(f"processed {idx} frames "
                  f"({1.0 / float(np.mean(recent)):.1f} FPS recent)")
    cap.release()
    if writer is not None:
        writer.release()
        print(f"wrote {os.path.join(args.path_to_save, 'demo_out.avi')}")
    lat = np.asarray(frame_times[1:]) * 1e3  # the first frame builds
    if len(lat):
        print(f"frame latency: p50 {np.percentile(lat, 50):.1f} ms / "
              f"p99 {np.percentile(lat, 99):.1f} ms "
              f"({1e3 / float(np.mean(lat)):.1f} FPS sustained)")
    return {"frames": idx, "latency_ms": lat.tolist()}


if __name__ == "__main__":
    main()
