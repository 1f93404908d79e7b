"""Evaluation CLI: the port's counterpart of the JAX package's
`cli/eval.py`, with the same flags and defaults.

    python -m yolo_nano_tpu_torch.cli.eval -d voc --root /data/VOCdevkit \\
        --weight weights/voc/ckpt --img_size 416 [--device cpu]

`--weight` is a checkpoint directory written by the port's
`utils.checkpoint.CheckpointManager` (a full train state; the newest step
is read), evaluated through `make_predict_fn` at its defaults (BN folded,
bf16), or a folded `.npz` artifact (`convert.save_npz`), evaluated through
`serving.load_predictor` in the artifact's dtype at its own image size. An
orbax checkpoint written by the JAX package cannot be read without JAX;
carry such a state across with `convert.train_state_from_jax` and save it
with `CheckpointManager`. `--tta` predicts with multi-scale + flip TTA
(`utils.tta`): a checkpoint's weights unfolded in f32 through
`make_tta_predict`, as the JAX CLI runs it, an artifact's folded model in
its dtype through `tta_predictor`.

The model runs on CUDA unless `--device` names another device; without a
CUDA device and without `--device`, it raises.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="YOLO-Nano evaluation (PyTorch)")
    p.add_argument("-d", "--dataset", default="voc",
                   choices=["voc", "coco-val", "coco-test"])
    p.add_argument("--root", default="/data")
    p.add_argument("--weight", required=True,
                   help="a port CheckpointManager directory (train state) "
                        "or a folded .npz artifact; JAX orbax checkpoints "
                        "are not read (convert.train_state_from_jax carries "
                        "a JAX state across)")
    p.add_argument("--img_size", default=416, type=int)
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--conf_thresh", default=0.001, type=float)
    p.add_argument("--nms_thresh", default=0.50, type=float)
    p.add_argument("--diou_nms", action="store_true", default=False)
    p.add_argument("--pre_topk", default=512, type=int,
                   help="candidates entering NMS per image")
    p.add_argument("--max_det", default=128, type=int,
                   help="final detections per image")
    p.add_argument("--backbone", default="1.0x")
    p.add_argument("--ema", action="store_true", default=False,
                   help="evaluate the EMA weights from a train checkpoint")
    p.add_argument("--tta", action="store_true", default=False,
                   help="multi-scale (320-640 px) + flip test-time "
                        "augmentation with a merged NMS")
    p.add_argument("--dump_dets", default=None, metavar="DIR",
                   help="write detection artifacts for error analysis: VOC → "
                        "per-class VOCdevkit results .txt + detections.pkl "
                        "(reference vocapi_evaluator.py:91-92,142-157); "
                        "COCO → results json (val and test-dev)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA, which must "
                        "be present); 'cpu' runs the plain versions of the "
                        "kernels")
    return p.parse_args(argv)


def load_weights(weight_dir: str, cfg, use_ema: bool):
    """(params, stats) as JAX-layout numpy trees from the newest train
    state in a port checkpoint directory, saved with or without EMA."""
    import torch

    from yolo_nano_tpu_torch.convert import tree_from_named
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    model = init_yolo_nano(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tx = make_optimizer(lambda count: 1e-3)
    mgr = CheckpointManager(weight_dir)
    try:
        state = mgr.restore(create_train_state(model, tx, use_ema=True))
    except ValueError:
        state = mgr.restore(create_train_state(model, tx, use_ema=False))
    if use_ema:
        if state.ema_params is None:
            raise SystemExit(
                "--ema requested but the checkpoint carries no EMA state "
                "(was training run without --ema?); drop --ema to evaluate "
                "the raw weights")
        return tree_from_named(state.ema_params), tree_from_named(
            state.ema_stats)
    return tree_from_named(state.params), tree_from_named(state.stats)


def config_from_args(args):
    """The model config of the dataset's classes and the CLI's thresholds."""
    from yolo_nano_tpu_torch.cli.common import build_config

    return build_config("voc" if args.dataset == "voc" else "coco",
                        backbone=args.backbone, conf_thresh=args.conf_thresh,
                        nms_thresh=args.nms_thresh, diou_nms=args.diou_nms,
                        nms_pre_topk=args.pre_topk,
                        max_detections=args.max_det)


def build_predict_fn(args, cfg):
    """The predict function of --weight: a folded .npz artifact through
    load_predictor (with --tta, its model through tta_predictor), a
    checkpoint directory through make_predict_fn (with --tta,
    make_tta_predict). The eval CLI's flags that another CLI lacks
    (--ema, --tta, --diou_nms, --pre_topk, --max_det) are left at their
    defaults."""
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.serving import load_predictor
    from yolo_nano_tpu_torch.utils.tta import make_tta_predict, tta_predictor

    ema, tta = getattr(args, "ema", False), getattr(args, "tta", False)
    overrides = dict(conf_thresh=args.conf_thresh, nms_thresh=args.nms_thresh,
                     diou_nms=getattr(args, "diou_nms", None),
                     pre_topk=getattr(args, "pre_topk", None),
                     max_det=getattr(args, "max_det", None))
    if os.path.isfile(args.weight):
        if ema:
            raise SystemExit("--ema needs a train checkpoint directory; "
                             f"{args.weight} is a folded artifact")
        fn = load_predictor(args.weight, device=args.device,
                            prefer_params=tta, **overrides)
        if not tta and fn.input_size != args.img_size:
            raise SystemExit(f"{args.weight} predicts at {fn.input_size} px; "
                             f"pass --img_size {fn.input_size}")
        if args.dataset == "voc" and fn.cfg.num_classes != cfg.num_classes:
            raise SystemExit(f"{args.weight} has {fn.cfg.num_classes} "
                             f"classes; VOC has {cfg.num_classes}")
        if tta:
            return tta_predictor(fn.model, fn.cfg,
                                 nms_thresh=args.nms_thresh)
        return fn
    params, stats = load_weights(args.weight, cfg, ema)
    if tta:
        return make_tta_predict(params, stats, cfg,
                                nms_thresh=args.nms_thresh,
                                device=args.device)
    return make_predict_fn(params, stats, cfg, args.img_size,
                           device=args.device)


def main(argv=None):
    """Evaluate --weight on the dataset; → the evaluator, whose `map` (VOC)
    or `stats` (COCO) hold the result."""
    args = parse_args(argv)
    from yolo_nano_tpu_torch.evaluation.evaluator import (COCOEvaluator,
                                                          VOCEvaluator)
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32

    # f32 means f32 here, set before any model is built, not left to the
    # process-wide flags that predict also sets (evaluation/evaluator.py)
    set_full_f32()
    predict_fn = build_predict_fn(args, config_from_args(args))

    if args.dataset == "voc":
        ev = VOCEvaluator(args.root, args.img_size,
                          batch_size=args.batch_size,
                          num_workers=args.num_workers, display=True,
                          dump_dir=args.dump_dets)
        ev.evaluate(predict_fn)
    else:
        dump_path = (os.path.join(args.dump_dets, "coco_results.json")
                     if args.dump_dets else None)
        ev = COCOEvaluator(args.root, args.img_size,
                           image_set=("test2017" if args.dataset ==
                                      "coco-test" else "val2017"),
                           batch_size=args.batch_size,
                           num_workers=args.num_workers,
                           testset=args.dataset == "coco-test",
                           dump_path=dump_path)
        ap50, ap = ev.evaluate(predict_fn)
        print(f"ap50_95 : {ap}")
        print(f"ap50 : {ap50}")
    return ev


if __name__ == "__main__":
    main()
