"""Writes the seeded NanoDet-Plus-m-1.5x artifact of the benchmark's
`nanodet_plus-m-1.5x-coco416-bf16` configuration: folded, bf16, 416 px,
80 classes, from seed 0. Not part of a benchmark run.

    python3 benchmark/make_nanodet_artifact.py \
        [--out yolo_nano_tpu_torch/assets/nanodet_plus_m_1.5x_416_seed0.npz]

No trained NanoDet-Plus weights are in the repository, so the weights are
NanoDet's own init (`models.nanodet_plus.init_nanodet_plus_tree`, seed 0)
made to detect like a trained model in the benchmark's scenes, on the CPU
in f32:

  1. BN: every BN's scale is drawn from U`BN_SCALE` and its bias from
     U`BN_BIAS` (NanoDet's init: 1 and 0), and its running mean and
     variance are the batch statistics of `CALIBRATION_SCENES` scenes
     (`benchmark/scenes.py`, seed 0, which no run draws), layer by layer in
     one train-mode forward (momentum 1). So each BN output is scaled as
     drawn and the folded weights are not the init's. A bias of 0 leaves a
     random network whose LeakyReLUs cut half of every layer and whose
     depth then amplifies any rounding (bf16 head outputs 15% to 24% RMS
     off f32 in this model); biases about 1.5 keep most units on the
     linear side (1.5% to 2% measured);
  2. the head's output 1x1 (N(0, 0.01) at init): its class rows and its
     distance rows are scaled so that the class logits and the distance
     bins each spread by `LOGIT_STD` over the calibration scenes (assumed:
     a trained head's logits spread by units, the init's by hundredths);
  3. the class bias (NanoDet's -4.595 at init, where no pair would score
     above 0.05) is set so that the calibration scenes give a mean of
     `PAIRS_AN_IMAGE` (prior, class) pairs an image above 0.05.

Then BN is folded, every leaf cast to bf16 and the tree written with the
meta {"model": "nanodet_plus", ...}; the sha256 and the calibration's
readings are printed.
"""

import argparse
import hashlib
import json
import math
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

OUT = os.path.join("yolo_nano_tpu_torch", "assets",
                   "nanodet_plus_m_1.5x_416_seed0.npz")
SEED = 0
SIZE = 416
CALIBRATION_SCENES = 16
LOGIT_STD = 1.0
PAIRS_AN_IMAGE = 600
CONF = 0.05
BN_SCALE = (0.75, 1.25)
BN_BIAS = (1.0, 2.0)


def main(argv=None) -> int:
    import torch

    from benchmark import scenes
    from yolo_nano_tpu_torch.config import NANODET_PLUS, NanoDetPlusConfig
    from yolo_nano_tpu_torch.convert import save_npz, tree_from_model
    from yolo_nano_tpu_torch.models.nanodet_plus import (
        build_nanodet_plus, init_nanodet_plus_tree)
    from yolo_nano_tpu_torch.ops import nn as nn_ops
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    torch.manual_seed(SEED)
    cfg = NanoDetPlusConfig(compute_dtype="bfloat16")
    model = build_nanodet_plus(*init_nanodet_plus_tree(
        torch.Generator().manual_seed(SEED), cfg), cfg)
    x = scenes.render(CALIBRATION_SCENES, SIZE, SEED, "cpu")
    with torch.no_grad():
        draw = torch.Generator().manual_seed(SEED + 1)
        for name, prm in model.named_parameters():
            for leaf, (lo, hi) in (("bn_scale", BN_SCALE),
                                   ("bn_bias", BN_BIAS)):
                if name.endswith(leaf):
                    prm.copy_(lo + (hi - lo) * torch.rand(prm.shape,
                                                          generator=draw))
        with mock.patch.object(nn_ops, "BN_MOMENTUM", 1.0):
            model.train()(x)  # 1. running stats := the batch's
        model.eval()
        feats = model.fpn(model.backbone(x.permute(0, 3, 1, 2)))
        c = cfg.num_classes
        logits = []
        for feat, convs, out in zip(feats, model.head.cls_convs,
                                    model.head.gfl_cls):
            for conv in convs:
                feat = conv(feat)
            raw = torch.nn.functional.conv2d(feat, out.weight)  # no bias
            logits.append(raw.permute(0, 2, 3, 1).reshape(len(x), -1,
                                                          raw.shape[1]))
        logits = torch.cat(logits, 1)  # [B, N, C + bins]
        cls_std = float(logits[..., :c].std())
        reg_std = float(logits[..., c:].std())
        z = logits[..., :c] * (LOGIT_STD / cls_std)
        pairs = z.numel() // len(x)
        q = 1.0 - PAIRS_AN_IMAGE / pairs
        bias = math.log(CONF / (1 - CONF)) - float(
            torch.quantile(z.reshape(-1)[::7].double(), q))
        for out in model.head.gfl_cls:  # 2. and 3.
            out.weight[:c] *= LOGIT_STD / cls_std
            out.weight[c:] *= LOGIT_STD / reg_std
            out.bias[:c] = bias
        scored = torch.sigmoid(z + bias)
        count = float((scored > CONF).sum()) / len(x)
    folded = cast_f32_to_bf16(fold_bn(model))
    meta = {"model": NANODET_PLUS, "config": {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in cfg.__dict__.items()}, "img_size": SIZE,
        "dtype": "bfloat16", "folded": True, "dataset": "coco",
        "weights": f"NanoDet init, seed {SEED}, calibrated "
                   f"(benchmark/make_nanodet_artifact.py)"}
    save_npz(args.out, tree_from_model(folded), meta)
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    params = sum(t.numel() for t in folded.parameters())
    print(json.dumps({"out": args.out, "sha256": digest,
                      "bytes": os.path.getsize(args.out),
                      "parameters": params, "class_bias": bias,
                      "cls_logit_std_at_init": cls_std,
                      "reg_logit_std_at_init": reg_std,
                      "pairs_an_image_f32": count}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
