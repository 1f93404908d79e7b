"""The bf16 stage kernel's weight layout, held on the CPU.

`prepare_stage` hands the bf16 kernel (`csrc/fused_stage_bf16.cu`) each
pointwise weight in bf16, transposed and zero-padded to
[round8(Cout)][round16(Cin)] (`*_bf16`: the m16n8k16 products' N and K).
On bf16 weights (the 0.5x artifact, the 1.0x tree cast by
`cast_f32_to_bf16`) the copy must widen exactly to the f32 kernel-layout
weight, and hold zeros exactly in the pad rows and columns; on f32 weights
it is their rounding to bf16 (to nearest even), the rounding the Pallas
kernel's `_mm` applies to a bf16 product's weights. The card's kernel is
tested in tests/test_torch_cuda.py.
"""

import os

import pytest
import torch

from chip_smoke import _stage_cost
from yolo_nano_tpu_torch import convert
from yolo_nano_tpu_torch.ops.kernels import fused_stage as tfs
from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "yolo_nano_tpu_torch", "assets")
STAGES = ("stage2", "stage3", "stage4")


@pytest.fixture(scope="module")
def backbones():
    """The 0.5x artifact's bf16 backbone and the 1.0x artifact's, cast."""
    half = convert.load_model(os.path.join(ASSETS, "bench_coco416_05x.npz"))[0]
    full = convert.load_model(os.path.join(ASSETS, "bench_coco416.npz"))[0]
    return {"0.5x": half.backbone, "1.0x": cast_f32_to_bf16(full).backbone}


def _pointwise(blk):
    keys = ["pw1_w", "pw2_w"] + (["b1pw_w"] if blk["stride"] == 2 else [])
    return [(k, blk[k], blk[k + "_bf16"]) for k in keys]


@pytest.mark.parametrize("width", ["0.5x", "1.0x"])
@pytest.mark.parametrize("stage", STAGES)
def test_bf16_weights_widen_to_the_f32_layout(backbones, width, stage):
    """Every pointwise weight of every block: bf16, contiguous, 16-byte
    rows, [round8(N)][round16(K)]; its [:N, :K] widens exactly to the f32
    weight transposed, and the rest is zeros."""
    blocks = tfs.prepare_stage(getattr(backbones[width], stage))
    for i, blk in enumerate(blocks):
        if i:
            assert "b1pw_w_bf16" not in blk
        for key, w, wt in _pointwise(blk):
            k, n = w.shape
            assert wt.dtype == torch.bfloat16 and wt.is_contiguous()
            assert tuple(wt.shape) == (-(-n // 8) * 8, -(-k // 16) * 16), key
            assert torch.equal(wt[:n, :k].float().t(), w), (stage, i, key)
            assert torch.equal(wt[:n, :k].float().t(),
                               blk[key + "_pad"][:k, :n])
            assert not wt[n:].any() and not wt[:, k:].any(), (stage, i, key)


def test_bf16_weights_of_f32_weights_round_to_nearest_even():
    """A stage with f32 weights (a folded f32 model run in bf16): each copy
    is the weight rounded to bf16 to nearest even, so the kernel multiplies
    what the plain version multiplies (`w.to(bf16)`)."""
    from tests.test_torch_cuda import _random_stage

    g = torch.Generator().manual_seed(0)
    blocks = tfs.prepare_stage(_random_stage(g, 24, 116, 2))
    rounded = 0
    for blk in blocks:
        for key, w, wt in _pointwise(blk):
            k, n = w.shape
            assert torch.equal(wt[:n, :k].t(), w.to(torch.bfloat16)), key
            rounded += int((wt[:n, :k].float().t() != w).sum())
    assert rounded > 0  # f32 weights that bf16 does not hold


@pytest.mark.parametrize("width", ["0.5x", "1.0x"])
def test_stage_bound_reads_the_same_work(backbones, width):
    """chip_smoke.py's bound counts a stage's weights once, as the function
    holds them: the kernels' padded copies (`*_pad`, `*_bf16`) are left
    out, so the bound is the same whichever kernel runs the stage."""
    x = torch.zeros(1, 24, 104, 104)
    for stage in STAGES:
        blocks = tfs.prepare_stage(getattr(backbones[width], stage))
        plain = [{k: v for k, v in b.items()
                  if not k.endswith(("_pad", "_bf16"))} for b in blocks]
        assert _stage_cost(x, blocks) == _stage_cost(x, plain)
        flops, wbytes = _stage_cost(x, plain)
        assert wbytes == sum(t.numel() * t.element_size() for b in plain
                             for k, t in b.items() if k != "stride")
        c2 = blocks[0]["pw1_w"].shape[1]
        x = torch.zeros(1, 2 * c2, (x.shape[2] + 1) // 2,
                        (x.shape[3] + 1) // 2)


def test_launch_block_refuses_bf16_c2_above_256():
    """The bf16 kernel's 8 warps cover N = c2 up to 512 (4 n8 tiles a warp
    up to 256, 8 above), as the f32 kernel's 16 warps do: the wrapper
    raises on a wider or odd block of either dtype before any launch, and
    takes the widths of stage 4 at 1.5x and 2.0x (c2 = 352, 488) to its
    next check (the bf16 kernel's narrow split alone stopped at 256)."""
    assert tfs.C2_MAX == {torch.float32: 512, torch.bfloat16: 512}
    for dtype in (torch.bfloat16, torch.float32):
        for c2 in (514, 520, 351):
            x = torch.zeros(1, 2 * c2, 4, 4, dtype=dtype)
            with pytest.raises(ValueError, match="even c2 up to 512"):
                tfs._launch_block(None, x, {"stride": 1,
                                            "pw1_w": torch.zeros(c2, c2)})
        for c2 in (258, 352, 488, 512):
            with pytest.raises(ValueError, match="Cin = 2"):
                tfs._launch_block(None, torch.zeros(1, 2 * c2 - 2, 4, 4,
                                                    dtype=dtype),
                                  {"stride": 1, "pw1_w": torch.zeros(c2, c2)})


def _bf16_nearest_even(v: torch.Tensor) -> torch.Tensor:
    """f64 → the nearest bf16 value (ties to even), as f64, by integer
    arithmetic on the f64 bits (normal bf16 range): keep 7 of the 52
    fraction bits."""
    bits = v.view(torch.int64)
    lsb = (bits >> 45) & 1
    return (((bits + (1 << 44) - 1 + lsb) >> 45) << 45).view(torch.float64)


def test_round_to_bf16_rounds_f64_once():
    """`round_to(f64, bf16)` is the nearest bf16, ties to even, also where
    PyTorch's cast (through f32) rounds twice: just off a bf16 midpoint by
    less than half an f32 ulp, and on random values."""
    mid = 1 + 2.0 ** -8  # the midpoint between bf16 1 and 1 + 2^-7
    near = torch.tensor([mid + 2.0 ** -30, mid - 2.0 ** -30, mid,
                         1 + 3 * 2.0 ** -8, -(mid + 2.0 ** -30)],
                        dtype=torch.float64)
    assert near.to(torch.bfloat16).double()[0] == 1.0  # the double rounding
    g = torch.Generator().manual_seed(0)
    rand = torch.randn(100_000, generator=g, dtype=torch.float64) * 10.0
    for v in (near, rand, near * 2.0 ** -20):
        got = tfs.round_to(v, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.double(), _bf16_nearest_even(v))
    f32 = rand.float()
    assert torch.equal(tfs.round_to(f32, torch.bfloat16),
                       f32.to(torch.bfloat16))


@pytest.mark.parametrize("width", ["0.5x", "1.0x"])
def test_block_plain_with_f64_sums_is_the_bf16_witness(backbones, width):
    """`block_plain(x, w, wide=f64)` on a bf16 block: the function's bf16
    output from f64 sums, which chip_smoke.py holds the kernel and the
    plain version (f32 sums) to. Every output is a bf16 value within one
    ulp of the f32-sum block's, nearly all bit-equal."""
    blocks = tfs.prepare_stage(backbones[width].stage4)
    g = torch.Generator().manual_seed(1)
    cin = blocks[0]["pw1_w"].shape[0]
    x = torch.randn(2, cin, 9, 9, generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    for i, w in enumerate(blocks):
        f32 = tfs.block_plain(x, w)
        f64 = tfs.block_plain(x, w, wide=torch.float64)
        assert f64.dtype == torch.bfloat16 and f64.shape == f32.shape
        diff = (f64.float() - f32.float()).abs()
        top = f32.float().abs().max().item()
        assert diff.max().item() <= 2.0 ** (int(torch.tensor(top).log2()
                                                .floor()) - 7), i
        assert (f64 == f32).float().mean().item() >= 0.99, i
        x = f32
