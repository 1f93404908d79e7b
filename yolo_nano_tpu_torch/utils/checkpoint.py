"""Full-train-state checkpoints: params, BN stats, momentum, the optimizer's
count, step and EMA, one directory per step (`<directory>/<step>/state.pt`,
a `torch.save` of plain CPU tensors), keeping the newest `max_to_keep`.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from yolo_nano_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Write the step's directory whole (under a temporary name, then
        renamed), then drop the oldest beyond max_to_keep."""
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({k: v.detach().cpu() for k, v in state.flat().items()},
                   os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """The saved state, on the template's device; its keys, shapes and
        dtypes must be the template's."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        flat = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        want = template.flat()
        if flat.keys() != want.keys():
            raise ValueError(f"checkpoint {step} holds other tensors than the "
                             f"template: {sorted(flat.keys() ^ want.keys())[:5]}")
        for k, v in flat.items():
            if v.shape != want[k].shape or v.dtype != want[k].dtype:
                raise ValueError(f"checkpoint {step}: {k} is {v.dtype} "
                                 f"{tuple(v.shape)}, the template's "
                                 f"{want[k].dtype} {tuple(want[k].shape)}")
        return TrainState.from_flat({k: v.to(want[k].device)
                                     for k, v in flat.items()})
