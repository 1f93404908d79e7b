"""Conv+BN folding on the port's modules.

For every `ConvUnit` that carries an eval-mode BatchNorm:

    w' = w · γ/√(σ²+ε)          (per output channel, OIHW dim 0)
    b' = (b − μ) · γ/√(σ²+ε) + β

the same arithmetic, in the same order, as the JAX package's `fold_bn` on
its parameter tree. The folded model runs the same module code; a folded
stage or head then runs through its Hopper kernel on the card.

`cast_f32_to_bf16` is the JAX package's `utils/fuse_bn.py::cast_f32_to_bf16`
on the port's modules: every f32 parameter becomes bf16, biases included;
BN running stats (buffers, the JAX stats tree) stay as they are.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from yolo_nano_tpu_torch.ops.nn import BN_EPS, ConvUnit


def fold_unit(unit: ConvUnit) -> ConvUnit:
    if not unit.has_bn:
        return unit
    # the square root in f64, rounded once to the stats' dtype: torch.sqrt
    # on the CPU's vector units is not always correctly rounded in f32 (1
    # ulp off on a few channels), which would fold other bits than JAX
    var = unit.bn_var + BN_EPS
    factor = unit.bn_scale / torch.sqrt(var.double()).to(var.dtype)
    w = unit.weight * factor[:, None, None, None]
    b = unit.bias if unit.bias is not None else torch.zeros_like(unit.bn_mean)
    b = (b - unit.bn_mean) * factor + unit.bn_bias
    return ConvUnit(w.detach().clone(), b.detach().clone(), None,
                    stride=unit.stride, groups=unit.groups,
                    act=unit.act).requires_grad_(False)


def _fold_children(module: nn.Module) -> None:
    for name, child in module.named_children():
        if isinstance(child, ConvUnit):
            setattr(module, name, fold_unit(child))
        else:
            _fold_children(child)


def cast_f32_to_bf16(model: nn.Module) -> nn.Module:
    """A copy of `model` whose f32 parameters are bf16; `model` is left as
    it is. Cached kernel layouts of the copy are dropped, so that its
    stages and heads take them from the bf16 weights."""
    cast = copy.deepcopy(model)
    for m in cast.modules():
        for name, p in m.named_parameters(recurse=False):
            if p.dtype == torch.float32:
                setattr(m, name, nn.Parameter(p.detach().to(torch.bfloat16),
                                              requires_grad=p.requires_grad))
        if hasattr(m, "_kernel_weights"):
            m._kernel_weights = None
    return cast


def fold_bn(model: nn.Module) -> nn.Module:
    """A copy of `model` with every conv+BN unit folded; `model` is left as
    it is."""
    folded = copy.deepcopy(model)
    if isinstance(folded, ConvUnit):
        return fold_unit(folded)
    _fold_children(folded)
    return folded
