"""Serving export: the port's counterpart of the JAX package's
`cli/export.py`. Folds BN, casts, and writes one self-contained `.npz`.

    python -m yolo_nano_tpu_torch.cli.export \\
        --weight weights/voc/yolo_nano/ckpt --out serving/yolo_nano_voc.npz \\
        --img_size 416 [--ema] [--dtype bfloat16]

    from yolo_nano_tpu_torch.serving import load_predictor
    predict = load_predictor("serving/yolo_nano_voc.npz")
    boxes, scores, classes, valid = predict(images)  # [B,416,416,3] RGB norm.

`--weight` is a checkpoint directory written by the port's
`utils.checkpoint.CheckpointManager` (the training CLI's `<save>/ckpt`;
the newest step is read), with its EMA weights under --ema. The artifact
is the folded tree (`utils.fuse_bn.fold_bn`, then `cast_f32_to_bf16`
under --dtype bfloat16, the default) written by `convert.save_npz`, with
the config, `img_size`, `dtype`, `folded`, `dataset` and `graph` (whether
this export wrote the graph below) in its meta, so that
`load_predictor(path)` needs no other argument.

By default the export also writes `<out stem>.pt2` beside the `.npz`: the
whole serving graph (forward, scores, decode and NMS at the artifact's
thresholds, a bf16 artifact's image cast, the weights as constants)
traced by torch.export on the CPU with a symbolic batch dimension
(`serving.export_graph`), the counterpart of the JAX package's
`predict.stablehlo`. It replays on the CPU and on CUDA, where its
operators launch the hand kernels, without the port's model code;
`load_predictor` prefers it when the meta's `graph` is true. `--no_stablehlo` (the JAX CLI's flag) skips
it. The artifact is then loaded back through `load_predictor` and
predicts one blank image on the device: CUDA unless `--device` names
another; without a CUDA device and without `--device`, it raises before
anything is read.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="YOLO-Nano serving export "
                                "(PyTorch)")
    p.add_argument("--weight", required=True,
                   help="a port CheckpointManager directory (train state)")
    p.add_argument("--out", required=True,
                   help="output artifact (.npz; the suffix is added when "
                        "missing)")
    p.add_argument("-d", "--dataset", default="voc", choices=["voc", "coco"])
    p.add_argument("--img_size", default=416, type=int)
    p.add_argument("--backbone", default="1.0x")
    p.add_argument("--conf_thresh", default=0.001, type=float)
    p.add_argument("--nms_thresh", default=0.50, type=float)
    p.add_argument("--ema", action="store_true", default=False)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no_stablehlo", action="store_true", default=False,
                   help="skip the serialized serving graph <out stem>.pt2 "
                        "(the .npz and its config only)")
    p.add_argument("--device", default=None,
                   help="torch device to check the artifact on (default: "
                        "CUDA, which must be present); 'cpu' runs the plain "
                        "versions of the kernels")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Export --weight; → the artifact's path."""
    args = parse_args(argv)
    import numpy as np

    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.cli.eval import load_weights
    from yolo_nano_tpu_torch.convert import (build_yolo_nano, save_npz,
                                             tree_from_model)
    from yolo_nano_tpu_torch.serving import (export_graph, graph_path,
                                             load_predictor, resolve_device)
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    dev = resolve_device(args.device)
    cfg = build_config(args.dataset, backbone=args.backbone,
                       conf_thresh=args.conf_thresh,
                       nms_thresh=args.nms_thresh)
    params, stats = load_weights(args.weight, cfg, args.ema)
    folded = fold_bn(build_yolo_nano(params, stats, cfg))
    if args.dtype == "bfloat16":
        folded = cast_f32_to_bf16(folded)

    out = os.path.abspath(args.out)
    if not out.endswith(".npz"):
        out += ".npz"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_npz(out, tree_from_model(folded), {
        "config": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(cfg).items()},
        "img_size": args.img_size,
        "dtype": args.dtype,
        "folded": True,
        "dataset": args.dataset,
        "graph": not args.no_stablehlo,
    })
    if os.path.exists(graph_path(out)):  # never replay an older graph
        os.remove(graph_path(out))
    if not args.no_stablehlo:
        export_graph(folded, cfg, args.img_size, args.dtype, graph_path(out))
    # the artifact loads alone and predicts
    load_predictor(out, device=dev)(
        np.zeros((1, args.img_size, args.img_size, 3), np.float32))
    print(f"exported serving artifact → {out}")
    return out


if __name__ == "__main__":
    main()
