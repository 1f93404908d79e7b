"""Train state: parameters, BN stats, optimizer state, step and EMA, as flat
dicts of tensors keyed by the model's own names (`backbone.conv1.weight`,
`head0.dw0.bn_mean`).

The optimizer is SGD, momentum 0.9, with *coupled* L2 weight decay 5e-4 on
every parameter (BN scale and bias and conv biases included), written as
the JAX package's optax chain:

    g ← g + 5e-4·p;   trace ← g + 0.9·trace (from zeros);   p ← p − lr·trace

with lr = schedule(count), count the updates accepted before this one. The
count lives in the optimizer state, so the NaN guard rolls it back with the
rest. EMA tracks the parameters AND the BN stats, with decay
0.9999·(1 − e^(−step/2000)) of the step after the update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]
FIELDS = ("params", "stats", "trace", "ema_params", "ema_stats")


WEIGHT_DECAY = 5e-4
MOMENTUM = 0.9


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum and coupled weight decay; `schedule` maps the count
    tensor to the learning rate (a tensor or a number)."""

    schedule: Callable

    def init(self, params: Tensors) -> Tuple[Tensors, torch.Tensor]:
        """→ (trace of zeros, count 0)."""
        dev = next(iter(params.values())).device
        return ({k: torch.zeros_like(v) for k, v in params.items()},
                torch.zeros((), dtype=torch.int32, device=dev))

    def update(self, grads: Tensors, params: Tensors, trace: Tensors,
               count: torch.Tensor) -> Tuple[Tensors, Tensors]:
        """→ (new params, new trace); the caller advances the count."""
        names = list(params)
        p = [params[k] for k in names]
        g = torch._foreach_add([grads[k] for k in names],
                               torch._foreach_mul(p, WEIGHT_DECAY))
        t = torch._foreach_add(g, torch._foreach_mul(
            [trace[k] for k in names], MOMENTUM))
        new_p = torch._foreach_sub(p, torch._foreach_mul(
            t, self.schedule(count)))
        return dict(zip(names, new_p)), dict(zip(names, t))


def make_optimizer(schedule) -> SGD:
    """torch-equivalent SGD(momentum=0.9, weight_decay=5e-4)."""
    return SGD(schedule)


@dataclasses.dataclass
class TrainState:
    params: Tensors
    stats: Tensors                   # BN running statistics
    trace: Tensors                   # momentum
    count: torch.Tensor              # int32 scalar: the optimizer's count
    step: torch.Tensor               # int32 scalar
    ema_params: Optional[Tensors] = None
    ema_stats: Optional[Tensors] = None

    def flat(self) -> Tensors:
        """Every tensor under one key: '<field>/<name>', 'count', 'step'."""
        out = {"count": self.count, "step": self.step}
        for field in FIELDS:
            tensors = getattr(self, field)
            if tensors is not None:
                out.update({f"{field}/{k}": v for k, v in tensors.items()})
        return out

    @classmethod
    def from_flat(cls, flat: Tensors) -> "TrainState":
        fields = {f: {} for f in FIELDS}
        for key, v in flat.items():
            if "/" in key:
                field, name = key.split("/", 1)
                fields[field][name] = v
        return cls(fields["params"], fields["stats"], fields["trace"],
                   flat["count"], flat["step"],
                   fields["ema_params"] or None, fields["ema_stats"] or None)

    def to(self, device, dtype=None) -> "TrainState":
        """On `device`; with `dtype`, its floating tensors cast to it."""
        return TrainState.from_flat({
            k: v.to(device, dtype if dtype and v.is_floating_point()
                    else v.dtype) for k, v in self.flat().items()})


def create_train_state(model: nn.Module, tx: SGD,
                       use_ema: bool = False) -> TrainState:
    """A state from a model's parameters and BN buffers (copied), on the
    model's device."""
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats = {k: v.detach().clone() for k, v in model.named_buffers()}
    trace, count = tx.init(params)
    copy = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return TrainState(params, stats, trace, count, count.clone(),
                      copy(params) if use_ema else None,
                      copy(stats) if use_ema else None)


def ema_decay(updates: torch.Tensor) -> torch.Tensor:
    return 0.9999 * (1.0 - torch.exp(-updates.float() / 2000.0))


def ema_update(ema: Tensors, new: Tensors, decay: torch.Tensor) -> Tensors:
    names = list(ema)
    out = torch._foreach_add(
        torch._foreach_mul([ema[k] for k in names], decay),
        torch._foreach_mul([new[k] for k in names], 1.0 - decay))
    return dict(zip(names, out))


def select(ok: torch.Tensor, new: Tensors, old: Tensors) -> Tensors:
    """new where `ok` (a device bool), else old: no host sync."""
    return {k: torch.where(ok, new[k], old[k]) for k in old}

