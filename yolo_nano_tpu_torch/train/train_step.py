"""The training step: the in-graph augmentation or the multi-scale resize,
target assignment, forward and loss, backward, SGD, EMA and the NaN guard,
in one call that reads nothing back to the host.

The model runs through `torch.func.functional_call` on a structure-only
copy (on the meta device) with the state's tensors swapped in: the
parameters as autograd leaves, the BN stats as fresh copies that train-mode
BN overwrites. The NaN guard is `torch.where` on a device bool: on a
non-finite loss the parameters, momentum, count, BN stats, step and EMA all
keep their old values. All constants (grids, anchor tables) go to the
device when the step is built, so a step makes no host→device copy either.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from yolo_nano_tpu_torch.config import YoloNanoConfig
from yolo_nano_tpu_torch.losses.targets import build_targets, target_tables
from yolo_nano_tpu_torch.models.yolo_nano import (init_yolo_nano,
                                                  loss_from_features)
from yolo_nano_tpu_torch.ops.decode import make_grids
from yolo_nano_tpu_torch.ops.nn import resize_images
from yolo_nano_tpu_torch.serving import resolve_device
from yolo_nano_tpu_torch.train.state import (SGD, TrainState, ema_decay,
                                             ema_update, select)

LOSS_NAMES = ("loss/obj", "loss/cls", "loss/bbox", "loss/iou")


class TrainStep:
    """step(state, images, gt_boxes, gt_labels) → (new state, metrics).

    images [B,S,S,3] f32 NHWC, normalized, on the step's device (resized to
    `input_size` when S differs); gt_boxes [B,M,4] normalized corners;
    gt_labels [B,M] int (−1 pads). The parts are methods, so that each can
    be timed alone.

    With `augment` (data.device_aug.make_augment_fn(input_size)) the step
    is step(state, images_u8, gt_boxes, gt_labels, regions, gen): uint8
    base canvases in, the in-graph augmentation drawn from the generator
    `gen` on the step's device, its output already at input_size (no
    multi-scale resize), then the same body."""

    def __init__(self, cfg: YoloNanoConfig, tx: SGD, input_size: int,
                 device=None, augment=None):
        self.cfg, self.tx, self.input_size = cfg, tx, input_size
        self.augment = augment
        self.device = resolve_device(device)
        self.skeleton = init_yolo_nano(torch.Generator(), cfg,
                                       device="cpu").to("meta")
        self.grids = make_grids(cfg, input_size, self.device)
        self.tables = target_tables(cfg, input_size, self.device)

    def targets(self, gt_boxes, gt_labels) -> torch.Tensor:
        return build_targets(gt_boxes, gt_labels, self.cfg, self.input_size,
                             self.tables)

    def loss(self, state: TrainState, images, targets):
        """→ (total, (conf, cls, bbox, iou), leaf params, new BN stats)."""
        if images.shape[1] != self.input_size:
            images = resize_images(images, self.input_size)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        stats = {k: v.clone() for k, v in state.stats.items()}
        feats = functional_call(self.skeleton, {**params, **stats}, (images,),
                                strict=True)
        losses = loss_from_features(*feats, targets, self.input_size,
                                    self.grids)
        total = losses[0] + losses[1] + losses[2] + losses[3]
        return total, losses, params, stats

    def update(self, state: TrainState, total, grads, new_stats
               ) -> TrainState:
        new_params, new_trace = self.tx.update(grads, state.params,
                                               state.trace, state.count)
        ok = torch.isfinite(total)
        new_params = select(ok, new_params, state.params)
        new_stats = select(ok, new_stats, state.stats)
        accepted = ok.to(torch.int32)
        new_step = state.step + accepted
        ema_p = ema_s = None
        if state.ema_params is not None:
            d = ema_decay(new_step)
            ema_p = select(ok, ema_update(state.ema_params, new_params, d),
                           state.ema_params)
            ema_s = select(ok, ema_update(state.ema_stats, new_stats, d),
                           state.ema_stats)
        return TrainState(new_params, new_stats,
                          select(ok, new_trace, state.trace),
                          state.count + accepted, new_step, ema_p, ema_s)

    def __call__(self, state: TrainState, images, gt_boxes, gt_labels,
                 regions=None, gen=None):
        if self.augment is not None:
            images, gt_boxes, gt_labels = self.augment(
                images, gt_boxes, gt_labels, regions, gen)
        elif regions is not None or gen is not None:
            raise TypeError("regions and gen are the augmenting step's "
                            "arguments; this step was built without augment")
        targets = self.targets(gt_boxes, gt_labels)
        total, losses, params, new_stats = self.loss(state, images, targets)
        grads = torch.autograd.grad(total, list(params.values()))
        new_state = self.update(state, total.detach(),
                                dict(zip(params, grads)), new_stats)
        metrics = {"loss/total": total.detach(),
                   **{k: v.detach() for k, v in zip(LOSS_NAMES, losses)},
                   "skipped_nonfinite": (~torch.isfinite(total)).to(
                       torch.int32)}
        return new_state, metrics


def make_train_step(cfg: YoloNanoConfig, tx: SGD, input_size: int,
                    device=None, augment=None) -> TrainStep:
    """The step for one input size, on CUDA unless `device` names another;
    multi-scale training builds one per size. `augment`: the in-graph
    augmentation (TrainStep)."""
    return TrainStep(cfg, tx, input_size, device, augment)
