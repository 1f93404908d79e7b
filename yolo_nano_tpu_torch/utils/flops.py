"""FLOPs and parameter count of the inference forward (the JAX package's
`utils/flops.py`, which reads XLA's cost analysis).

The count comes from `torch.utils.flop_counter.FlopCounterMode` over
`forward_features` at batch 1 (no postprocess, as the reference's thop
profile). It always runs on the CPU: there the folded stages and head
pairs run their plain PyTorch versions, whose convs and products the
counter sees; on the card they would be ctypes calls into the hand
kernels, which it cannot see.

Conventions: the counter counts a multiply-add as 2 FLOPs, as XLA does;
thop counts 1, so the report gives both. The counter counts every tap of a
convolution, as thop does; XLA counts only the taps inside the image, and
the elementwise ops too. At 416 px the two agree within 0.5%; at small
sizes, where the border is a large share, XLA's count is lower.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from yolo_nano_tpu_torch.config import YoloNanoConfig


def count_params(tree) -> int:
    """Elements over the leaves of a JAX-layout tree."""
    from yolo_nano_tpu_torch.convert import flatten_tree

    return sum(math.prod(a.shape) for a in flatten_tree(tree).values())


def flops_and_params(params, stats, cfg: YoloNanoConfig, input_size: int,
                     batch: int = 1) -> Tuple[float, float, int]:
    """(gflops_per_image, thop_style_gmacs_per_image, n_params) of the
    inference forward of a JAX-layout tree (`stats` None for a folded
    one), counted in f32 on the CPU; prints the three lines."""
    from torch.utils.flop_counter import FlopCounterMode

    from yolo_nano_tpu_torch.convert import build_yolo_nano, widen_tree
    from yolo_nano_tpu_torch.models.yolo_nano import forward_features

    # a bf16 tree widened: the count does not depend on the dtype
    model = build_yolo_nano(widen_tree(params), widen_tree(stats), cfg)
    x = torch.zeros((batch, input_size, input_size, 3), dtype=torch.float32)
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        forward_features(model, x)
    gflops = counter.get_total_flops() / batch / 1e9
    n = count_params(params)
    print(f"FLOPs (x2 MAC)      : {gflops:.2f} G")
    print(f"GMACs (thop-style)  : {gflops / 2:.2f} G")
    print(f"Params              : {n / 1e6:.2f} M")
    return gflops, gflops / 2, n
