"""Learning-rate schedule: quartic warmup, then step decay.

For the first `wp_epochs` epochs lr = base·(step/nw)⁴ (exactly 0 at step
0); afterwards base·0.1^k, k the number of `lr_epochs` boundaries passed. A
function of the step as a tensor on the device, so that the train step reads
no number back to the host.
"""

from __future__ import annotations

from typing import Sequence

import torch


def warmup_step_schedule(base_lr: float, epoch_size: int,
                         wp_epochs: int = 2,
                         lr_epochs: Sequence[int] = (90, 120),
                         warmup: bool = True):
    """→ schedule(step tensor) → lr, an f32 tensor on the step's device."""
    nw = max(wp_epochs * epoch_size, 1)
    decay_steps = [float(e * epoch_size) for e in lr_epochs]

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        decays = torch.zeros_like(step)
        for d in decay_steps:
            decays = decays + (step >= d).float()
        lr = base_lr * torch.pow(0.1, decays)
        if warmup:
            lr = torch.where(step < nw, base_lr * torch.pow(step / nw, 4.0),
                             lr)
        return lr

    return schedule
