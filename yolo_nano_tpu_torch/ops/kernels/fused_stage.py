"""One ShuffleNetV2 stage on folded weights: the CUDA kernels
`csrc/fused_stage.cu` (f32) and `csrc/fused_stage_bf16.cu` (bf16), one
launch per block, and their plain PyTorch version.

Same function as the JAX package's Pallas `fused_stage`
(`ops/pallas/fused_stage.py`): a stride-2 block (two downsampling branches,
concat, shuffle g=2), then n stride-1 blocks (channel split, right half
through pw+ReLU → dw3×3 → pw+ReLU, concat, shuffle). Concat + shuffle is
the interleave out[2j] = left[j], out[2j+1] = right[j].

The activation of every pointwise is ReLU (YOLO-Nano's backbone) or
LeakyReLU (NanoDet-Plus's, `STAGE_ACTS`), a compile-time parameter of the
kernels: where(v ≥ 0, v, slope·v) on the f32 sum with its bias, slope the
output dtype's rounding of 0.1 (0.1 in f32, 0.10009765625 in bf16, as
`ops.nn.activate` takes it), then rounded once to the output dtype.

x is f32 or bf16, and the output is in x's dtype. In bf16 every op rounds
where the Pallas kernel rounds (`_mm`, `_dw3x3`), and nowhere else: a
pointwise multiplies bf16 operands (the weights rounded to bf16) with f32
products and sums, adds the f32 bias, applies ReLU and rounds to bf16; a
depthwise sums its f32 taps on the bf16 inputs from the f32 bias and rounds
to bf16. Concat and shuffle are exact.

`prepare_stage` only reshapes a folded stage's weights into the kernels'
layouts: pointwise [Cin, Cout], depthwise [9, C] (tap-major), biases [C],
all f32 and contiguous (bf16 weights widen to f32 exactly, as the Pallas
kernel's `_pw`/`_dw` widen them). The f32 kernel (`csrc/fused_stage.cu`)
takes each pointwise weight zero-padded to multiples of 8 rows and columns
(`*_pad`, the m16n8k8 products' K and N). The bf16 kernel
(`csrc/fused_stage_bf16.cu`) takes it rounded to bf16 (to nearest even, as
the Pallas kernel's `_mm` rounds it; exact on bf16 weights), transposed and
zero-padded to [round8(Cout)][round16(Cin)] (`*_bf16`, the m16n8k16
products' N and K). The plain version takes the weights as they are. x is
[B, C, H, W] in channels_last memory.

Each block launch is one call of the PyTorch operator
`torch.ops.yolo_nano_torch.shuffle_block` on the kernel layouts of x's
dtype: its CPU implementation is the plain block, its CUDA implementation
the kernel, and its fake one gives the output's shape for tracing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from yolo_nano_tpu_torch.ops.kernels.build import check, load
from yolo_nano_tpu_torch.ops.nn import _leaky_slope, channel_shuffle

# the stage activations and their codes in the kernels (csrc/common.cuh Act)
STAGE_ACTS = {"relu": 1, "leaky": 2}
STAGE_ACT_NAMES = {v: k for k, v in STAGE_ACTS.items()}

# the kernels' weight arguments, in the order of shuffle_block_{f32,bf16}
_WEIGHTS = {torch.float32: ("pw1_w_pad", "pw1_b", "dw_w", "dw_b", "pw2_w_pad",
                            "pw2_b", "b1dw_w", "b1dw_b", "b1pw_w_pad",
                            "b1pw_b"),
            torch.bfloat16: ("pw1_w_bf16", "pw1_b", "dw_w", "dw_b",
                             "pw2_w_bf16", "pw2_b", "b1dw_w", "b1dw_b",
                             "b1pw_w_bf16", "b1pw_b")}
# source, launch symbol and tile-rule prefix of each dtype's kernel
_KERNELS = {torch.float32: ("fused_stage", "shuffle_block_f32",
                            "shuffle_block"),
            torch.bfloat16: ("fused_stage_bf16", "shuffle_block_bf16",
                             "shuffle_block_bf16")}
# the widest c2 of each kernel: f32, 16 warps of at most 4 n8 tiles; bf16,
# 8 warps of at most 4 n8 tiles up to c2 = 256 and 8 above (its wide
# variant, stage 4 at 1.5x and 2.0x)
C2_MAX = {torch.float32: 512, torch.bfloat16: 512}


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pad_pw(w: torch.Tensor) -> torch.Tensor:
    """[K, N] pointwise weight → [round8(K), round8(N)], zeros appended."""
    k, n = w.shape
    out = w.new_zeros(_round_up(k, 8), _round_up(n, 8))
    out[:k, :n] = w
    return out


def _pad_pw_bf16(w: torch.Tensor) -> torch.Tensor:
    """[K, N] pointwise weight → bf16 [round8(N), round16(K)], transposed,
    zeros appended."""
    k, n = w.shape
    out = torch.zeros(_round_up(n, 8), _round_up(k, 16), dtype=torch.bfloat16,
                      device=w.device)
    out[:n, :k] = w.t()
    return out


def _pw(unit) -> tuple:
    """Folded 1×1 unit → (w [Cin, Cout], b [Cout])."""
    return (unit.weight[:, :, 0, 0].t().float().contiguous(),
            unit.bias.float().contiguous())


def _dw(unit) -> tuple:
    """Folded depthwise 3×3 unit → (w [9, C], b [C])."""
    c = unit.weight.shape[0]
    return (unit.weight.reshape(c, 9).t().float().contiguous(),
            unit.bias.float().contiguous())


def stage_act(blocks) -> str:
    """The activation of a ShuffleStage's units (`STAGE_ACTS`): its
    pointwise units all carry it."""
    acts = {u.act for blk in blocks for branch in (blk.branch1, blk.branch2)
            if branch is not None for u in branch.values()} - {None}
    if len(acts) != 1 or not acts <= set(STAGE_ACTS):
        raise ValueError(f"a stage takes one activation of {sorted(STAGE_ACTS)}"
                         f", its units carry {sorted(map(str, acts))}")
    return acts.pop()


def prepare_stage(blocks) -> List[Dict[str, torch.Tensor]]:
    """A folded stage (models.shufflenetv2.ShuffleStage: a stride-2 block,
    then stride-1 blocks) → one dict of kernel-layout weights per block
    (the stage's activation is `stage_act`'s)."""
    out = []
    for i, blk in enumerate(blocks):
        if (blk.branch1 is not None) != (i == 0):
            raise ValueError("a stage is one stride-2 block, then stride-1 "
                             "blocks")
        b2 = blk.branch2
        if any(u.has_bn for u in b2.values()):
            raise ValueError("fused_stage takes a BN-folded stage")
        w = {"stride": 2 if i == 0 else 1}
        w["pw1_w"], w["pw1_b"] = _pw(b2["pw1"])
        w["dw_w"], w["dw_b"] = _dw(b2["dw"])
        w["pw2_w"], w["pw2_b"] = _pw(b2["pw2"])
        if i == 0:
            w["b1dw_w"], w["b1dw_b"] = _dw(blk.branch1["dw"])
            w["b1pw_w"], w["b1pw_b"] = _pw(blk.branch1["pw"])
        for name in ("pw1_w", "pw2_w", "b1pw_w"):
            if name in w:
                w[name + "_pad"] = _pad_pw(w[name])
                w[name + "_bf16"] = _pad_pw_bf16(w[name])
        out.append(w)
    return out


def round_to(v: torch.Tensor, dt) -> torch.Tensor:
    """v rounded to dt once, to nearest even. PyTorch casts f64 to bf16
    through f32, which rounds twice; rounding to odd in f32 first (toward
    zero, the last bit set if inexact) makes the second rounding exact."""
    if v.dtype == torch.float64 and dt == torch.bfloat16:
        f = v.float()
        f = torch.where(f.double().abs() > v.abs(),
                        torch.nextafter(f, torch.zeros_like(f)), f)
        v = (f.view(torch.int32) | (f.double() != v).int()).view(
            torch.float32)
    return v.to(dt)


def _act(y: torch.Tensor, act: str, dt) -> torch.Tensor:
    """The stage's activation in y's (wide) dtype, the leaky slope as dt
    rounds 0.1."""
    if act == "leaky":
        return torch.where(y >= 0, y, _leaky_slope(dt) * y)
    if act != "relu":
        raise ValueError(f"unknown stage activation {act!r}")
    return torch.relu(y)


def _pw_plain(x, w, b, dt, act="relu"):
    """act(x @ w + b), the operands rounded to dt and summed in x's dtype
    (f32 or wider), the output rounded to dt."""
    w = round_to(w, dt).to(x.dtype)
    return round_to(_act(F.conv2d(x, w.t()[:, :, None, None], b.to(x.dtype)),
                         act, dt), dt)


def _dw_plain(x, w, b, stride, dt):
    c = w.shape[1]
    return round_to(F.conv2d(x, w.t().reshape(c, 1, 3, 3).to(x.dtype),
                             b.to(x.dtype), stride=stride, padding=1,
                             groups=c), dt)


def block_plain(x: torch.Tensor, w: Dict[str, torch.Tensor],
                wide=None, act: str = "relu") -> torch.Tensor:
    """One ShuffleV2 block from kernel-layout weights, in plain PyTorch: the
    output in x's dtype, each op computed in `wide` (by default f32, f64
    for f64 x) on inputs rounded to x's dtype and rounded to it once; every
    pointwise takes `act`. chip_smoke.py runs a bf16 block with wide = f64
    as the witness of its sums: nearly exact sums, rounded where the
    function rounds."""
    dt = x.dtype
    wide = wide or torch.promote_types(dt, torch.float32)
    xw = x.to(wide)
    if w["stride"] == 2:
        even = _pw_plain(_dw_plain(xw, w["b1dw_w"], w["b1dw_b"], 2,
                                   dt).to(wide), w["b1pw_w"], w["b1pw_b"], dt,
                         act)
        right = xw
    else:
        c2 = x.shape[1] // 2
        even, right = x[:, :c2], xw[:, c2:]
    t = _pw_plain(right, w["pw1_w"], w["pw1_b"], dt, act).to(wide)
    t = _dw_plain(t, w["dw_w"], w["dw_b"], w["stride"], dt).to(wide)
    odd = _pw_plain(t, w["pw2_w"], w["pw2_b"], dt, act)
    return channel_shuffle(torch.cat([even, odd], 1), 2)


def fused_stage_plain(x: torch.Tensor, blocks,
                      act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle."""
    for w in blocks:
        x = block_plain(x, w, act=act)
    return x


@functools.lru_cache(maxsize=None)
def _lib(dtype=torch.float32):
    """The built kernel of a dtype: shuffle_block_{f32,bf16} launch one
    block; <prefix>_tile and <prefix>_smem_bytes are its tile rule and
    shared-memory layout, computed on the host (`_KERNELS` gives the
    prefix). The bf16 kernel also exports shuffle_block_bf16_blocks_per_sm,
    the occupancy its tile rule weighs."""
    source, sym, prefix = _KERNELS[dtype]
    lib = load(source)
    fn = getattr(lib, sym)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 11)
    fn.restype = ctypes.c_int
    getattr(lib, prefix + "_tile").argtypes = [ctypes.c_int] * 6
    getattr(lib, prefix + "_tile").restype = ctypes.c_int
    getattr(lib, prefix + "_smem_bytes").argtypes = [ctypes.c_int] * 4
    getattr(lib, prefix + "_smem_bytes").restype = ctypes.c_size_t
    if dtype == torch.bfloat16:
        lib.shuffle_block_bf16_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.shuffle_block_bf16_blocks_per_sm.restype = ctypes.c_int
    return lib


def smem_bytes(tile: int, stride: int, cin: int, c2: int,
               dtype=torch.float32) -> int:
    """Shared memory of one thread block of a dtype's kernel."""
    return getattr(_lib(dtype), _KERNELS[dtype][2] + "_smem_bytes")(
        tile, stride, cin, c2)


@functools.lru_cache(maxsize=None)
def block_tile(stride: int, cin: int, c2: int, batch: int, ho: int,
               wo: int, dtype=torch.float32) -> int:
    """Output tile side of one block launch, as the dtype's kernel picks it
    (shuffle_block_tile in csrc/fused_stage.cu, shuffle_block_bf16_tile in
    csrc/fused_stage_bf16.cu: cost models of the products and the waves of
    blocks, among the sides whose shared memory fits). chip_smoke.py
    --sweep-stage-tiles times every side against them."""
    tile = getattr(_lib(dtype), _KERNELS[dtype][2] + "_tile")(
        stride, cin, c2, batch, ho, wo)
    if tile < 1:
        raise ValueError(f"no tile of a stride-{stride} block with Cin {cin}, "
                         f"c2 {c2} fits in shared memory")
    return tile


def _padded(k: int, n: int, dtype) -> tuple:
    """Shape of a [K, N] pointwise weight in the kernel layout of a dtype."""
    if dtype == torch.bfloat16:
        return (_round_up(n, 8), _round_up(k, 16))
    return (_round_up(k, 8), _round_up(n, 8))


def _check_widths(x, stride: int, c2: int, k1: int) -> None:
    cin = x.shape[1]
    c2_max = C2_MAX[x.dtype]
    if c2 > c2_max or c2 % 2:
        raise ValueError(f"the stage kernel takes an even c2 up to {c2_max}, "
                         f"got {c2}")
    if stride == 1 and cin != 2 * c2:
        raise ValueError(f"stride-1 block needs Cin = 2·{c2}, got {cin}")
    if k1 != (cin if stride == 2 else cin // 2):
        raise ValueError(f"pw1 takes {k1} channels, x gives "
                         f"{cin if stride == 2 else cin // 2}")


def _launch_weights(lib, x, stride: int, c2: int, weights, tile=None,
                    act: str = "relu"):
    """One block launch of x's dtype on the kernel-layout weights in the
    order of `_WEIGHTS[x.dtype]` (None for a stride-1 block's branch1),
    the activation `act`; lib is `_lib(x.dtype)`."""
    b, cin, h, wd = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    if tile is None:
        tile = block_tile(stride, cin, c2, b, ho, wo, x.dtype)
    out = torch.empty((b, 2 * c2, ho, wo),
                      dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    ptrs = []
    for name, t in zip(_WEIGHTS[x.dtype], weights):
        if t is None:  # the stride-1 block has no branch1
            ptrs.append(None)
            continue
        dt = torch.bfloat16 if name.endswith("_bf16") else torch.float32
        if (t.device != x.device or t.dtype != dt
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous 16-byte aligned "
                             f"{str(dt)[6:]} on {x.device}")
        ptrs.append(t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _KERNELS[x.dtype][1])(x.data_ptr(), out.data_ptr(), b,
                                             h, wd, cin, c2, stride, tile,
                                             STAGE_ACTS[act], *ptrs, stream)
    fused_stage.launches += 1
    if x.dtype == torch.bfloat16:
        fused_stage.launches_bf16 += 1
    if act == "leaky":
        fused_stage.launches_leaky += 1
    check(err, "fused_stage block")
    return out


def _launch_block(lib, x, w, tile=None, act: str = "relu"):
    """One block launch of x's dtype from `prepare_stage`'s dict; lib is
    `_lib(x.dtype)`."""
    k1, c2 = w["pw1_w"].shape
    _check_widths(x, w["stride"], c2, k1)
    return _launch_weights(lib, x, w["stride"], c2,
                           [w.get(n) for n in _WEIGHTS[x.dtype]], tile, act)


# One ShuffleV2 block as a PyTorch operator: the plain version on the CPU,
# the kernel of x's dtype on CUDA, and a fake for tracing, so that a graph
# exported by torch.export (serving.export_graph) holds the operator and
# runs the kernel wherever it is replayed on the card. Its weights are the
# kernel layouts of x's dtype (`_WEIGHTS`: `*_pad` for f32, `*_bf16` for
# bf16), branch1's None for a stride-1 block; c2 is pw1_b's length; act is
# a code of `STAGE_ACTS`, ReLU by default. The
# implementations are registered on the dispatch keys themselves
# (`torch.library.Library.impl`): `torch.library.custom_op`'s wrappers
# cost more host time a call, and a batch-1 forward makes 22 calls.
_LIB = torch.library.Library("yolo_nano_torch", "FRAGMENT")


def shuffle_block_plain(x: torch.Tensor, pw1_w: torch.Tensor,
                        pw1_b: torch.Tensor, dw_w: torch.Tensor,
                        dw_b: torch.Tensor, pw2_w: torch.Tensor,
                        pw2_b: torch.Tensor, b1dw_w: Optional[torch.Tensor],
                        b1dw_b: Optional[torch.Tensor],
                        b1pw_w: Optional[torch.Tensor],
                        b1pw_b: Optional[torch.Tensor],
                        act: int = STAGE_ACTS["relu"]) -> torch.Tensor:
    """The operator's plain version (its CPU implementation)."""
    return block_plain(x, _plain_weights(
        x, (pw1_w, pw1_b, dw_w, dw_b, pw2_w, pw2_b, b1dw_w, b1dw_b, b1pw_w,
            b1pw_b)), act=STAGE_ACT_NAMES[act])


def _plain_weights(x, weights) -> Dict[str, torch.Tensor]:
    """The operator's kernel-layout weights → `block_plain`'s dict: each
    pointwise weight [K, N] cut out of its padding (the bf16 layout
    transposed back; its values are the plain version's rounded to bf16,
    as `block_plain` rounds them)."""
    w = {"stride": 1 if weights[6] is None else 2}
    for name, t in zip(_WEIGHTS[x.dtype], weights):
        if t is None:
            continue
        key = name.replace("_pad", "").replace("_bf16", "")
        w[key] = t
    c2, cin = w["pw1_b"].shape[0], x.shape[1]
    ks = {"pw1_w": cin if w["stride"] == 2 else cin // 2, "pw2_w": c2,
          "b1pw_w": cin}
    for key, k in ks.items():
        if key in w:
            t = w[key]
            w[key] = (t[:c2, :k].t() if x.dtype == torch.bfloat16
                      else t[:k, :c2]).contiguous()
    return w


def _shuffle_block_cuda(x, pw1_w, pw1_b, dw_w, dw_b, pw2_w, pw2_b, b1dw_w,
                        b1dw_b, b1pw_w, b1pw_b, act=STAGE_ACTS["relu"]):
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous")
    stride = 1 if b1dw_w is None else 2
    c2 = pw1_b.shape[0]
    k1 = x.shape[1] if stride == 2 else x.shape[1] // 2
    _check_widths(x, stride, c2, k1)
    if tuple(pw1_w.shape) != _padded(k1, c2, x.dtype):
        raise ValueError(f"pw1 of shape {tuple(pw1_w.shape)} does not take "
                         f"{k1} channels to {c2}")
    if stride == 2:
        fused_stage.calls += 1  # a stage is one stride-2 block, then more
    return _launch_weights(_lib(x.dtype), x, stride, c2,
                           (pw1_w, pw1_b, dw_w, dw_b, pw2_w, pw2_b, b1dw_w,
                            b1dw_b, b1pw_w, b1pw_b), act=STAGE_ACT_NAMES[act])


def _shuffle_block_fake(x, pw1_w, pw1_b, dw_w, dw_b, pw2_w, pw2_b, b1dw_w,
                        b1dw_b, b1pw_w, b1pw_b, act=STAGE_ACTS["relu"]):
    b, _, h, wd = x.shape
    s = 1 if b1dw_w is None else 2
    return torch.empty((b, 2 * pw1_b.shape[0], (h - 1) // s + 1,
                        (wd - 1) // s + 1), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


_LIB.define("shuffle_block(Tensor x, Tensor pw1_w, Tensor pw1_b, Tensor dw_w, "
            "Tensor dw_b, Tensor pw2_w, Tensor pw2_b, Tensor? b1dw_w, "
            "Tensor? b1dw_b, Tensor? b1pw_w, Tensor? b1pw_b, int act=1) "
            "-> Tensor")
_LIB.impl("shuffle_block", shuffle_block_plain, "CPU")
_LIB.impl("shuffle_block", _shuffle_block_cuda, "CUDA")
torch.library.register_fake("yolo_nano_torch::shuffle_block",
                            _shuffle_block_fake, lib=_LIB)


def block_args(w: Dict[str, torch.Tensor], dtype) -> tuple:
    """`prepare_stage`'s dict of one block → the operator's weight
    arguments for activations of `dtype`."""
    return tuple(w.get(n) for n in _WEIGHTS[dtype])


def fused_stage(x: torch.Tensor, blocks, act: str = "relu") -> torch.Tensor:
    """Run a whole stage: x [B,Cin,H,W] f32 or bf16 → [B,Cout,⌈H/2⌉,⌈W/2⌉]
    in x's dtype, channels_last, every pointwise activated by `act`.

    `blocks` is `prepare_stage`'s list. Each block is one call of the
    operator `yolo_nano_torch::shuffle_block`: a CPU tensor takes the plain
    version; a CUDA tensor launches the kernel of its dtype (counted in
    `fused_stage.launches`, the bf16 ones also in
    `fused_stage.launches_bf16`, the LeakyReLU ones in
    `fused_stage.launches_leaky`, and each stage's stride-2 block in
    `fused_stage.calls`) or raises."""
    if x.dim() != 4 or x.dtype not in _KERNELS:
        raise ValueError(f"x must be [B,C,H,W] f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_stage runs on CPU or CUDA, not {x.device}")
    op = torch.ops.yolo_nano_torch.shuffle_block.default
    extra = () if act == "relu" else (STAGE_ACTS[act],)
    for w in blocks:
        x = op(x, *block_args(w, x.dtype), *extra)
    return x


fused_stage.calls = 0
fused_stage.launches = 0
fused_stage.launches_bf16 = 0
fused_stage.launches_leaky = 0
