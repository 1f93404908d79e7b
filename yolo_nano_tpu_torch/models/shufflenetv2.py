"""ShuffleNetV2 backbone as nn.Modules (NCHW, channels_last memory).

Stem 3×3/s2 conv-BN-ReLU + 3×3/s2 max-pool, then stages 2/3/4, returning the
stage-2/3/4 feature maps (strides 8/16/32) for the detection neck. Module
names mirror the JAX parameter tree (`conv1`, `stage2.0.branch1.dw`, ...).

The activation is ReLU (YOLO-Nano) or LeakyReLU(0.1) (NanoDet-Plus's
`activation: LeakyReLU`), in the stem and in every pointwise unit of both
branches; `convert.build_shufflenetv2` takes it. On a BN-folded model each
stage runs as one `fused_stage` call with the stage's activation: on the
card that is the CUDA kernel, one launch per block; on the CPU its plain
version.
An unfolded model runs block by block, with eval-mode BN, or in train mode
with batch statistics (each unit writes its new running stats).

`init_shufflenetv2` draws a JAX-layout (params, stats) tree with the
reference init: conv weights N(0, 1/(cin/groups)), BN scale 1, bias 1e-4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from yolo_nano_tpu_torch.config import SHUFFLENETV2_CHANNELS, SHUFFLENETV2_REPEATS
from yolo_nano_tpu_torch.ops.kernels.fused_stage import (fused_stage,
                                                         prepare_stage,
                                                         stage_act)
from yolo_nano_tpu_torch.ops.nn import (ConvUnit, channel_shuffle, init_bn,
                                        init_conv, max_pool_3x3_s2)


def _init_unit(gen, kh, cin, cout, groups=1):
    """Conv-BN unit, weights N(0, 1/(cin/groups))."""
    p = init_conv(gen, kh, kh, cin, cout, groups=groups,
                  std=1.0 / (cin // groups))
    bn_p, bn_s = init_bn(cout)
    return {**p, **bn_p}, bn_s


def _init_block(gen, cin, cout, stride):
    branch = cout // 2
    p, s = {}, {}
    if stride > 1:  # branch1: dw3×3/s → 1×1
        d_p, d_s = _init_unit(gen, 3, cin, cin, groups=cin)
        w_p, w_s = _init_unit(gen, 1, cin, branch)
        p["branch1"], s["branch1"] = {"dw": d_p, "pw": w_p}, {"dw": d_s,
                                                            "pw": w_s}
    b2_in = cin if stride > 1 else branch
    p["branch2"], s["branch2"] = {}, {}
    for name, args in (("pw1", (1, b2_in, branch)),
                       ("dw", (3, branch, branch, branch)),
                       ("pw2", (1, branch, branch))):
        p["branch2"][name], s["branch2"][name] = _init_unit(gen, *args)
    return p, s


def init_shufflenetv2(gen: torch.Generator, model_size: str = "1.0x"):
    """→ (params, stats), JAX-layout trees of numpy arrays."""
    channels = SHUFFLENETV2_CHANNELS[model_size]
    stem_p, stem_s = _init_unit(gen, 3, 3, channels[0])
    params, stats = {"conv1": stem_p}, {"conv1": stem_s}
    cin = channels[0]
    for si, (repeats, cout) in enumerate(zip(SHUFFLENETV2_REPEATS,
                                             channels[1:4])):
        blocks = [_init_block(gen, cin if bi == 0 else cout, cout,
                              2 if bi == 0 else 1) for bi in range(repeats)]
        params[f"stage{si + 2}"] = [bp for bp, _ in blocks]
        stats[f"stage{si + 2}"] = [bs for _, bs in blocks]
        cin = cout
    return params, stats


class ShuffleBlock(nn.Module):
    """Stride 2 when `branch1` (dw, pw) is given, else stride 1 with a
    channel split and an identity left half. branch2 is (pw1, dw, pw2)."""

    def __init__(self, branch2: nn.ModuleDict,
                 branch1: Optional[nn.ModuleDict] = None):
        super().__init__()
        self.branch1 = branch1
        self.branch2 = branch2

    def _branch2(self, x):
        b2 = self.branch2
        return b2["pw2"](b2["dw"](b2["pw1"](x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.branch1 is None:
            c = x.shape[1] // 2
            out = torch.cat([x[:, :c], self._branch2(x[:, c:])], 1)
        else:
            b1 = self.branch1["pw"](self.branch1["dw"](x))
            out = torch.cat([b1, self._branch2(x)], 1)
        return channel_shuffle(out, 2)


class ShuffleStage(nn.ModuleList):
    """A stride-2 block followed by stride-1 blocks."""

    def __init__(self, blocks):
        super().__init__(blocks)
        self._kernel_weights = None

    @property
    def folded(self) -> bool:
        return not any(isinstance(m, ConvUnit) and m.has_bn
                       for m in self.modules())

    def _apply(self, fn, *args, **kwargs):
        self._kernel_weights = None  # .to()/.cuda() move the weights
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded:
            if self._kernel_weights is None:
                self._kernel_weights = (prepare_stage(self), stage_act(self))
            blocks, act = self._kernel_weights
            return fused_stage(
                x.contiguous(memory_format=torch.channels_last), blocks,
                act=act)
        for blk in self:
            x = blk(x)
        return x


class ShuffleNetV2(nn.Module):
    def __init__(self, conv1: ConvUnit, stage2: ShuffleStage,
                 stage3: ShuffleStage, stage4: ShuffleStage):
        super().__init__()
        self.conv1 = conv1
        self.stage2 = stage2
        self.stage3 = stage3
        self.stage4 = stage4

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B,3,H,W] → (c3, c4, c5) at strides 8, 16, 32."""
        y = max_pool_3x3_s2(self.conv1(x))
        c3 = self.stage2(y)
        c4 = self.stage3(c3)
        return c3, c4, self.stage4(c4)
