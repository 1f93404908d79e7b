"""Convert torchvision ShuffleNetV2 ImageNet weights → the port's backbone
tree, for `cli/train.py --pretrained`.

The reference loads ImageNet-pretrained ShuffleNetV2 from the torchvision
model zoo at train start (reference backbone/shufflenetv2.py:170-182,
strict=False so only the trunk loads). Here the conversion is offline:
with a shufflenetv2_x{0.5,1.0}-*.pth downloaded elsewhere,

    python -m yolo_nano_tpu_torch.tools.convert_shufflenetv2 x1.pth \\
        backbone_1x.npz --size 1.0x

writes the backbone's params and BN stats as one `.npz`
(`convert.save_npz`, tree {"params", "stats"}); pass it as
`--pretrained backbone_1x.npz` to `yolo_nano_tpu_torch.cli.train`. The
mapping is the JAX package's `tools/convert_torch_shufflenetv2.py`
(OIHW → HWIO, torch BN → scale/bias + mean/var stats).
"""

from __future__ import annotations

import argparse

import numpy as np

from yolo_nano_tpu_torch.config import (SHUFFLENETV2_CHANNELS,
                                        SHUFFLENETV2_REPEATS)

KIND = "shufflenetv2_backbone"


def convert(state_dict, model_size: str = "1.0x"):
    """torch state_dict (torchvision shufflenet_v2 naming: conv1/stage2..4)
    → (backbone_params, backbone_stats) trees of numpy arrays. model_size
    validates the checkpoint's channel widths against the expected
    variant."""
    expect_stem = SHUFFLENETV2_CHANNELS[model_size][0]
    got_stem = np.asarray(state_dict["conv1.0.weight"]).shape[0]
    if got_stem != expect_stem:
        raise ValueError(f"checkpoint stem has {got_stem} channels; "
                         f"--size {model_size} expects {expect_stem}")
    # the stem is 24ch for every variant — the stage widths are what
    # actually distinguish 0.5x/1.0x/1.5x/2.0x checkpoints
    for si in (2, 3, 4):
        expect = SHUFFLENETV2_CHANNELS[model_size][si - 1] // 2
        got = np.asarray(state_dict[f"stage{si}.0.branch2.0.weight"]).shape[0]
        if got != expect:
            raise ValueError(
                f"checkpoint stage{si} branch width {got} != {expect}; "
                f"this is not a {model_size} checkpoint")

    def w(key):  # OIHW → HWIO
        return np.ascontiguousarray(
            np.asarray(state_dict[key]).transpose(2, 3, 1, 0))

    def v(key):
        return np.asarray(state_dict[key])

    def unit(conv_key, bn_key):
        p = {"w": w(conv_key + ".weight"),
             "scale": v(bn_key + ".weight"), "bias": v(bn_key + ".bias")}
        s = {"mean": v(bn_key + ".running_mean"),
             "var": v(bn_key + ".running_var")}
        return p, s

    params, stats = {}, {}
    params["conv1"], stats["conv1"] = unit("conv1.0", "conv1.1")
    for si, repeats in zip((2, 3, 4), SHUFFLENETV2_REPEATS):
        blocks_p, blocks_s = [], []
        for bi in range(repeats):
            base = f"stage{si}.{bi}"
            bp, bs = {}, {}
            if bi == 0:  # stride-2 block has branch1
                d_p, d_s = unit(f"{base}.branch1.0", f"{base}.branch1.1")
                p_p, p_s = unit(f"{base}.branch1.2", f"{base}.branch1.3")
                bp["branch1"] = {"dw": d_p, "pw": p_p}
                bs["branch1"] = {"dw": d_s, "pw": p_s}
            p1, s1 = unit(f"{base}.branch2.0", f"{base}.branch2.1")
            d2, ds2 = unit(f"{base}.branch2.3", f"{base}.branch2.4")
            p2, s2 = unit(f"{base}.branch2.5", f"{base}.branch2.6")
            bp["branch2"] = {"pw1": p1, "dw": d2, "pw2": p2}
            bs["branch2"] = {"pw1": s1, "dw": ds2, "pw2": s2}
            blocks_p.append(bp)
            blocks_s.append(bs)
        params[f"stage{si}"] = blocks_p
        stats[f"stage{si}"] = blocks_s
    return params, stats


def check_like(got, want, what: str) -> None:
    """Raise unless two trees have the same paths and leaf shapes."""
    from yolo_nano_tpu_torch.convert import flatten_tree

    g = {k: tuple(np.shape(a)) for k, a in flatten_tree(got).items()}
    w = {k: tuple(np.shape(a)) for k, a in flatten_tree(want).items()}
    if g != w:
        diff = sorted(set(g.items()) ^ set(w.items()))[:5]
        raise ValueError(f"{what}: not a backbone tree of this width "
                         f"(first differences {diff})")


def save(path: str, params, stats, model_size: str) -> None:
    from yolo_nano_tpu_torch.convert import save_npz

    save_npz(path, {"params": params, "stats": stats},
             {"kind": KIND, "backbone": model_size})


def load(path: str, model_size: str):
    """→ (backbone params, backbone stats) from a file `save` wrote,
    checked against the tree of a `model_size` backbone."""
    import torch

    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.models.shufflenetv2 import init_shufflenetv2

    tree, meta = load_npz(path)
    if meta.get("kind") != KIND:
        raise ValueError(f"{path} is not a converted ShuffleNetV2 backbone")
    want_p, want_s = init_shufflenetv2(torch.Generator(), model_size)
    check_like(tree["params"], want_p, f"{path} params")
    check_like(tree["stats"], want_s, f"{path} stats")
    return tree["params"], tree["stats"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pth", help="torchvision shufflenetv2 .pth file")
    ap.add_argument("out", help="output .npz")
    ap.add_argument("--size", default="1.0x")
    args = ap.parse_args(argv)

    import torch

    from yolo_nano_tpu_torch.models.shufflenetv2 import init_shufflenetv2

    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    sd = {k: t.numpy() for k, t in sd.items() if hasattr(t, "numpy")}
    params, stats = convert(sd, args.size)
    # sanity: structure must match a fresh init
    want_p, want_s = init_shufflenetv2(torch.Generator(), args.size)
    check_like(params, want_p, "params")
    check_like(stats, want_s, "stats")
    save(args.out, params, stats, args.size)
    print(f"wrote backbone to {args.out}")


if __name__ == "__main__":
    main()
