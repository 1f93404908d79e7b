"""Core neural-net primitives on NCHW tensors (channels_last inside the model).

Points that keep the port equal to the JAX package:
  * torch-style symmetric padding (k-1)//2 on both sides, also for stride-2
    convs (XLA "SAME" would pad (0, 1) on even sizes and shift every window);
  * eval-mode BatchNorm with eps 1e-5, written as (y - mean)·γ/√(σ²+ε) + β;
  * LeakyReLU with slope 0.1;
  * 3×3/s2 max-pool with a −inf pad;
  * channel_shuffle mapping out[j·g + i] = in[i·C/g + j];
  * nearest 2× up = each pixel repeated 2×2, nearest 2× down = x[::2, ::2].

A conv unit is a `ConvUnit`: an OIHW conv with an optional bias, an optional
eval-mode BN, and an activation. `utils.fuse_bn.fold_bn` folds its BN away.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LEAKY_SLOPE = 0.1


def activate(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "leaky":
        return torch.where(x >= 0, x, LEAKY_SLOPE * x)
    raise ValueError(f"unknown activation {act!r}")


class ConvUnit(nn.Module):
    """Conv (+bias) (+eval BN) + activation, padding (k-1)//2.

    weight: OIHW; `bn` = (scale, bias, mean, var) or None for a folded unit.
    """

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 bn=None, *, stride: int = 1, groups: int = 1,
                 act: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = (nn.Parameter(bias, requires_grad=False)
                     if bias is not None else None)
        if bn is not None:
            scale, beta, mean, var = bn
            self.bn_scale = nn.Parameter(scale, requires_grad=False)
            self.bn_bias = nn.Parameter(beta, requires_grad=False)
            self.register_buffer("bn_mean", mean)
            self.register_buffer("bn_var", var)
        self.has_bn = bn is not None
        self.stride = stride
        self.groups = groups
        self.act = act

    @property
    def kernel_size(self) -> int:
        return self.weight.shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, self.bias, stride=self.stride,
                     padding=(self.kernel_size - 1) // 2, groups=self.groups)
        if self.has_bn:
            inv = torch.rsqrt(self.bn_var + BN_EPS) * self.bn_scale
            y = ((y - self.bn_mean[:, None, None]) * inv[:, None, None]
                 + self.bn_bias[:, None, None])
        return activate(y, self.act)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 max-pool, pad 1 (torch pads max-pool with −inf)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """out[:, j·g + i] = in[:, i·C/g + j]; keeps channels_last memory."""
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w).contiguous(memory_format=torch.channels_last)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def downsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, ::2, ::2]
