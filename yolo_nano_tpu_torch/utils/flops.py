"""FLOPs and parameter count of the inference forward (the JAX package's
`utils/flops.py`, which reads XLA's cost analysis).

The count comes from a dispatch mode over `forward_features` at batch 1
(no postprocess, as the reference's thop profile), which counts each
operator as XLA's cost analysis counts it on the compiled graph:

  * a convolution: 2 FLOPs (a multiply-add) for every tap that falls inside
    the image, so a 3×3 depthwise over a 4×4 image is 100 taps a channel,
    not 144; its bias add 1 a output element;
  * an elementwise add, subtract, multiply, compare, select, max or ReLU:
    1 a output element (the eval-mode BN's (y − mean)·inv + bias is 3, the
    leaky ReLU's where(y ≥ 0, y, 0.1·y) 3); a subtraction of a mean that
    is all zeros is free, since XLA folds the constant stats there;
    transcendentals (rsqrt, exp) are not FLOPs;
  * the 3×3 max-pool: 8 a output element;
  * data movement (split, concat, shuffle, nearest up/down sampling): 0;
    so is NanoDet-Plus's bilinear 2× upsampling (`upsample_bilinear2d`,
    about 0.1% of its count), which the rules above leave out.

It always runs on the CPU. The folded stages and head pairs run their plain
PyTorch versions under the mode (the hand kernels' custom operators are
opaque to it), and the count does not depend on the dtype. On seeded trees
it is within 0.15% of XLA's at 128 and 416 px, at 0.5x and 1.0x
(`tests/test_torch_tools_cli.py`): XLA counts each head output conv's bias
add once in each of the three fusions that slice its conf, class and box
channels apart, 2 FLOPs an output element more than the port.
The report gives thop's convention too (a multiply-add as 1).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from yolo_nano_tpu_torch.config import YoloNanoConfig

_aten = torch.ops.aten
# 1 FLOP a output element each
_ELEMENTWISE = {_aten.add.Tensor, _aten.add.Scalar, _aten.sub.Tensor,
                _aten.mul.Tensor, _aten.mul.Scalar, _aten.div.Tensor,
                _aten.where.self, _aten.ge.Scalar, _aten.relu.default,
                _aten.maximum.default}
_CONV = {_aten.convolution.default, _aten.conv2d.default}
_MAX_POOL = {_aten.max_pool2d.default, _aten.max_pool2d_with_indices.default}


def _taps(n: int, k: int, stride: int, pad: int, out: int) -> int:
    """Kernel taps inside [0, n) summed over the `out` output positions of
    one spatial axis."""
    return sum(min(k, n + pad - i * stride) - max(0, pad - i * stride)
               for i in range(out))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_flops(args, out) -> int:
    # conv2d's trailing defaults: bias None, stride 1, padding 0
    x, w, b, stride, pad = (tuple(args) + (None, 1, 0)[len(args) - 2:])[:5]
    stride, pad = _pair(stride), _pair(pad)
    (n, _, h, wd), (cout, cpg, kh, kw) = x.shape, w.shape
    oh, ow = out.shape[2:]
    fma = n * cout * cpg * (_taps(h, kh, stride[0], pad[0], oh)
                            * _taps(wd, kw, stride[1], pad[1], ow))
    return 2 * fma + (out.numel() if b is not None else 0)


class XlaFlopCount(TorchDispatchMode):
    """Counts the FLOPs of the operators dispatched under it, by XLA's
    rules (module docstring) → `flops`."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from yolo_nano_tpu_torch.ops.kernels import PLAIN_VERSIONS

        if func in PLAIN_VERSIONS:  # a hand kernel: count its plain ops
            with self:
                return PLAIN_VERSIONS[func](*args, **(kwargs or {}))
        out = func(*args, **(kwargs or {}))
        if func in _CONV:
            self.flops += _conv_flops(args, out)
        elif func is _aten.sub.Tensor and isinstance(
                args[1], torch.Tensor) and not bool(args[1].any()):
            pass  # x − 0: XLA folds the constant away
        elif func in _ELEMENTWISE:
            self.flops += out.numel()
        elif func in _MAX_POOL:
            self.flops += 8 * (out[0] if isinstance(out, tuple)
                               else out).numel()
        return out


def count_params(tree) -> int:
    """Elements over the leaves of a JAX-layout tree."""
    from yolo_nano_tpu_torch.convert import flatten_tree

    return sum(math.prod(a.shape) for a in flatten_tree(tree).values())


def flops_and_params(params, stats, cfg: YoloNanoConfig, input_size: int,
                     batch: int = 1) -> Tuple[float, float, int]:
    """(gflops_per_image, thop_style_gmacs_per_image, n_params) of the
    inference forward of a JAX-layout tree (`stats` None for a folded
    one) of cfg's model family, counted in f32 on the CPU; prints the
    three lines."""
    from yolo_nano_tpu_torch.convert import build_model, widen_tree
    from yolo_nano_tpu_torch.serving import model_module

    forward_features = model_module(cfg).forward_features
    # a bf16 tree widened: the count does not depend on the dtype
    model = build_model(widen_tree(params), widen_tree(stats), cfg)
    x = torch.zeros((batch, input_size, input_size, 3), dtype=torch.float32)
    counter = XlaFlopCount()
    with torch.inference_mode(), counter:
        forward_features(model, x)
    gflops = counter.flops / batch / 1e9
    n = count_params(params)
    print(f"FLOPs (x2 MAC)      : {gflops:.2f} G")
    print(f"GMACs (thop-style)  : {gflops / 2:.2f} G")
    print(f"Params              : {n / 1e6:.2f} M")
    return gflops, gflops / 2, n
