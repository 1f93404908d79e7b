"""Core neural-net primitives on NCHW tensors (channels_last inside the model).

Points that keep the port equal to the JAX package:
  * torch-style symmetric padding (k-1)//2 on both sides, also for stride-2
    convs (XLA "SAME" would pad (0, 1) on even sizes and shift every window);
  * BatchNorm with eps 1e-5, written as (y - mean)·γ/√(σ²+ε) + β: in eval
    mode with the running stats; in train mode with the batch mean and the
    two-pass biased variance over (N, H, W) in f32, while the running var
    takes the unbiased estimate var·n/(n−1), momentum 0.1;
  * LeakyReLU with slope 0.1;
  * 3×3/s2 max-pool with a −inf pad;
  * channel_shuffle mapping out[j·g + i] = in[i·C/g + j];
  * nearest 2× up = each pixel repeated 2×2, nearest 2× down = x[::2, ::2].

A conv unit is a `ConvUnit`: an OIHW conv with an optional bias, an optional
BN, and an activation. `utils.fuse_bn.fold_bn` folds its BN away. In bf16
(inference) it rounds as the JAX package's `conv_bn` does: the conv output
to bf16, then the bias added in bf16, then the eval-mode BN and the
activation in bf16. The max-pool, the nearest up/down sampling and the
neck's adds run in the input's dtype.

Initializers draw from an explicit `torch.Generator` on the CPU, with the JAX
package's distributions, into JAX-layout (HWIO) numpy arrays: `convert`
builds modules from such a tree.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # new = (1 - m)·old + m·batch
LEAKY_SLOPE = 0.1


# ---------------------------------------------------------------------------
# initializers (JAX layout: HWIO weights, I = cin/groups)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound):
    return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).numpy()


def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              groups: int = 1, bias: bool = False,
              std: Optional[float] = None) -> dict:
    """std None: torch's default kaiming-uniform (a=√5), bound
    √(2/6)·√(3/fan_in); std a float: N(0, std). The bias is U(±1/√fan_in)."""
    shape = (kh, kw, cin // groups, cout)
    fan_in = kh * kw * (cin // groups)
    if std is None:
        w = _uniform(gen, shape, math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in))
    else:
        w = (std * torch.randn(shape, generator=gen)).numpy()
    p = {"w": w}
    if bias:
        p["b"] = _uniform(gen, (cout,), 1.0 / math.sqrt(fan_in))
    return p


def init_bn(cout: int, bias_init: float = 1e-4):
    """(params, stats): scale 1, bias `bias_init`; mean 0, var 1."""
    f32 = np.float32
    return ({"scale": np.ones(cout, f32), "bias": np.full(cout, bias_init, f32)},
            {"mean": np.zeros(cout, f32), "var": np.ones(cout, f32)})


@functools.lru_cache(maxsize=None)
def _leaky_slope(dtype: torch.dtype) -> float:
    """LEAKY_SLOPE as x's dtype holds it, as the JAX package's weak-typed
    0.1 is cast: 0.10009765625 in bf16."""
    return torch.tensor(LEAKY_SLOPE, dtype=dtype).item()


def activate(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return torch.relu(x)
    if act == "leaky":
        return torch.where(x >= 0, x, _leaky_slope(x.dtype) * x)
    raise ValueError(f"unknown activation {act!r}")


def batch_norm_train(y: torch.Tensor, scale, bias, mean, var):
    """Train-mode BN of y [B,C,H,W] → (out, new running mean, new running
    var); the running stats are not written."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    batch_mean = yf.mean((0, 2, 3))
    # two-pass variance: E[x²]−E[x]² cancels catastrophically in f32
    centred = yf - batch_mean[:, None, None]
    batch_var = centred.square().mean((0, 2, 3))
    n = y.shape[0] * y.shape[2] * y.shape[3]
    with torch.no_grad():
        new_mean = (1 - BN_MOMENTUM) * mean + BN_MOMENTUM * batch_mean
        new_var = ((1 - BN_MOMENTUM) * var
                   + BN_MOMENTUM * (batch_var * (n / max(n - 1, 1))))
    inv = torch.rsqrt(batch_var + BN_EPS) * scale
    out = centred * inv[:, None, None] + bias[:, None, None]
    return out.to(y.dtype), new_mean, new_var


def set_full_f32() -> None:
    """Full-precision f32 on the card: cuDNN convolutions default to TF32
    (about three decimal digits), which would make kernel-vs-plain and
    port-vs-JAX comparisons unlike for like."""
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_flags() -> tuple:
    """The process-wide settings that decide f32 precision on the card
    (cuDNN TF32, matmul TF32 and precision), for a caller to check that a
    call left them as they were."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


class ConvUnit(nn.Module):
    """Conv (+bias) (+BN) + activation, padding (k-1)//2.

    weight: OIHW; `bn` = (scale, bias, mean, var) or None for a folded unit.
    In train mode the BN normalizes with the batch statistics and writes the
    new running stats into `bn_mean` and `bn_var` (the train step hands it
    copies, so that its NaN guard can keep the old ones).
    """

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 bn=None, *, stride: int = 1, groups: int = 1,
                 act: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None
        if bn is not None:
            scale, beta, mean, var = bn
            self.bn_scale = nn.Parameter(scale)
            self.bn_bias = nn.Parameter(beta)
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
        pad = (self.kernel_size - 1) // 2
        if x.dtype in (torch.float32, torch.float64):
            y = F.conv2d(x, self.weight, self.bias, stride=self.stride,
                         padding=pad, groups=self.groups)
        else:
            # as the JAX package's conv_bn: the conv's output rounded to x's
            # dtype, then the bias added in that dtype (F.conv2d would add
            # it before the rounding)
            y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                         padding=pad, groups=self.groups)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)[:, None, None]
        if self.has_bn and self.training:
            y, new_mean, new_var = batch_norm_train(
                y, self.bn_scale, self.bn_bias, self.bn_mean, self.bn_var)
            with torch.no_grad():
                self.bn_mean.copy_(new_mean)
                self.bn_var.copy_(new_var)
        elif self.has_bn:
            # in y's dtype, as the JAX package's eval-mode BN
            dt = y.dtype
            inv = (torch.rsqrt(self.bn_var + BN_EPS) * self.bn_scale).to(dt)
            y = ((y - self.bn_mean.to(dt)[:, None, None]) * inv[:, None, None]
                 + self.bn_bias.to(dt)[:, None, None])
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


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] f32 weights of `jax.image.resize`'s 'bilinear' along
    one axis: the triangle kernel at half-pixel sample points, widened by
    the scale when it shrinks (the antialiasing filter), each column
    normalized to sum 1. The arithmetic is XLA's compiled version of it:
    the sample points as one fused multiply-add (in f64, rounded once), the
    division by the kernel's width as a product with its reciprocal."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5).double()
              * inv_scale.double() - 0.5).float()
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() * (1.0 / kernel_scale)
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_images(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B,S,S,C] → [B,size,size,C] bilinear, half-pixel centres, with an
    antialiasing filter when it shrinks: `jax.image.resize` 'bilinear', as
    its two weight matrices applied along H and W, in the images' dtype."""
    w = _resize_weights(images.shape[1], size, images.device).to(images.dtype)
    x = torch.einsum("bhwc,hH->bHwc", images, w)
    return torch.einsum("bHwc,wW->bHWc", x, w)


def _linear_taps(n_in: int, n_out: int, scale: torch.Tensor,
                 translation: torch.Tensor):
    """The two input taps of each output sample along one axis, per item:
    (first index [B, n_out] int64, weights [B, n_out, 2] f32), the
    nonzero entries of `jax.image.scale_and_translate`'s 'linear' weight
    matrix (antialias off): the triangle kernel at
    sample = (x + 0.5)/s − t/s − 0.5, each column divided by its sum (0
    where the sum is ≤ 1000·eps), and 0 where the sample lies outside
    [−0.5, n_in − 0.5]. The arithmetic is JAX's, op for op, so the weights
    are its weights bit for bit. scale, translation: [B] f32."""
    inv = 1.0 / scale
    xs = torch.arange(n_out, dtype=torch.float32, device=scale.device) + 0.5
    sample = xs[None] * inv[:, None] - (translation * inv)[:, None] - 0.5
    j0 = torch.floor(sample)
    taps = []
    for j in (j0, j0 + 1.0):
        w = torch.clamp(1.0 - (sample - j).abs(), min=0.0)
        taps.append(torch.where((j >= 0) & (j <= n_in - 1), w, 0.0))
    total = taps[0] + taps[1]
    keep = (total.abs() > 1000.0 * float(np.finfo(np.float32).eps)) & (
        sample >= -0.5) & (sample <= n_in - 0.5)
    div = torch.where(total != 0, total, 1.0)
    weights = torch.stack([torch.where(keep, w / div, 0.0) for w in taps], -1)
    return j0.to(torch.int64), weights


def scale_and_translate(images: torch.Tensor, out_size: int,
                        scale: torch.Tensor, translation: torch.Tensor
                        ) -> torch.Tensor:
    """[B,H,W,C] (any real dtype) → [B,out_size,out_size,C] f32: each item
    resampled at output pixel (y, x) from input (y_in, x_in) =
    ((y + 0.5 − t_y)/s_y − 0.5, (x + 0.5 − t_x)/s_x − 0.5), bilinear with
    no antialiasing filter; a sample outside the input gives 0. It is
    `jax.image.scale_and_translate(img, shape, (0, 1), scale, translation,
    "linear", antialias=False)` per item. scale, translation: [B, 2] f32 in
    (y, x) order.

    Each axis is a two-tap gather with JAX's weights (`_linear_taps`), not a
    product with the weight matrix: elementwise f32 on the card, so the
    result does not depend on the process's TF32 settings. The sums of two
    products round where JAX's matrix product (its own order, with FMA on
    the CPU) does not, a few f32 ulps of the pixel values."""
    x = _resample_rows(images, out_size, scale[:, 0], translation[:, 0])
    x = _resample_rows(x.transpose(1, 2), out_size, scale[:, 1],
                       translation[:, 1])
    return x.transpose(1, 2)


def _resample_rows(x: torch.Tensor, out_size: int, scale, translation):
    """[B,N,...] → [B,out_size,...] f32 along axis 1 (`_linear_taps`)."""
    n = x.shape[1]
    j, w = _linear_taps(n, out_size, scale, translation)
    w = w.reshape(w.shape + (1,) * (x.dim() - 2))
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return (x[rows, j.clamp(0, n - 1)].float() * w[:, :, 0]
            + x[rows, (j + 1).clamp(0, n - 1)].float() * w[:, :, 1])
