"""Conv+BN folding on the port's modules.

For every `ConvUnit` that carries an eval-mode BatchNorm:

    w' = w · γ/√(σ²+ε)          (per output channel, OIHW dim 0)
    b' = (b − μ) · γ/√(σ²+ε) + β

the same arithmetic, in the same order, as the JAX package's `fold_bn` on
its parameter tree. The folded model runs the same module code; a folded
stage or head then runs through its Hopper kernel on the card.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from yolo_nano_tpu_torch.ops.nn import BN_EPS, ConvUnit


def fold_unit(unit: ConvUnit) -> ConvUnit:
    if not unit.has_bn:
        return unit
    factor = unit.bn_scale / torch.sqrt(unit.bn_var + BN_EPS)
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


def fold_bn(model: nn.Module) -> nn.Module:
    """A copy of `model` with every conv+BN unit folded; `model` is left as
    it is."""
    folded = copy.deepcopy(model)
    if isinstance(folded, ConvUnit):
        return fold_unit(folded)
    _fold_children(folded)
    return folded
