"""Port parity: the plain PyTorch versions of the two CUDA kernels against
the JAX package's Pallas kernels (interpret mode on the CPU) and their XLA
oracles, and the wrappers' dispatch and argument checks.

Tolerances: f32 rtol 1e-4, atol 1e-5 (summation order differs); bf16 2e-2
against the kernel, as tests/test_pallas.py, and 6e-2 against the f32
oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu.ops.pallas import fused_conv as jfc
from yolo_nano_tpu_torch.ops.kernels import fused_conv as tfc
from yolo_nano_tpu_torch.ops.kernels import fused_stage as tfs

F32 = dict(rtol=1e-4, atol=1e-5)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def _dw_pw_inputs(seed, b=2, h=13, w=11, c=96, cout=96):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, w, c)).astype(np.float32),
            rng.normal(0, 0.2, (3, 3, c)).astype(np.float32),
            rng.normal(0, 0.1, (c,)).astype(np.float32),
            rng.normal(0, 0.1, (c, cout)).astype(np.float32),
            rng.normal(0, 0.1, (cout,)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_mid,act_out", [("leaky", "leaky"),
                                             (None, "relu")])
def test_fused_dw_pw_plain_matches_pallas(act_mid, act_out, dtype):
    x, dw_w, dw_b, pw_w, pw_b = _dw_pw_inputs(0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    acts = dict(act_mid=act_mid, act_out=act_out)
    want = jfc.fused_dw_pw(xj, jnp.asarray(dw_w), jnp.asarray(dw_b),
                           jnp.asarray(pw_w), jnp.asarray(pw_b),
                           interpret=True, **acts)
    xt = nchw(x).to(tdt)
    got = tfc.fused_dw_pw(xt, torch.from_numpy(dw_w), torch.from_numpy(dw_b),
                          torch.from_numpy(pw_w).to(tdt),
                          torch.from_numpy(pw_b), **acts)
    assert got.dtype == tdt and tuple(got.shape) == (2, 96, 13, 11)
    assert got.is_contiguous(memory_format=torch.channels_last)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), **tol)
    oracle = jfc.fused_dw_pw_reference(
        xj.astype(jnp.float32), jnp.asarray(dw_w), jnp.asarray(dw_b),
        jnp.asarray(pw_w), jnp.asarray(pw_b), **acts)
    tol = F32 if dtype == "float32" else dict(rtol=6e-2, atol=6e-2)
    np.testing.assert_allclose(nhwc(got), np.asarray(oracle), **tol)


def test_fused_dw_pw_wrapper_checks_and_counts():
    x, dw_w, dw_b, pw_w, pw_b = (torch.from_numpy(a) for a in
                                 _dw_pw_inputs(1, c=8, cout=4))
    x = x.permute(0, 3, 1, 2)
    before = tfc.fused_dw_pw.launches
    out = tfc.fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b)
    torch.testing.assert_close(out, tfc.fused_dw_pw_plain(x, dw_w, dw_b, pw_w,
                                                          pw_b))
    assert tfc.fused_dw_pw.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="pw_w"):
        tfc.fused_dw_pw(x, dw_w, dw_b, pw_w.double(), pw_b)
    with pytest.raises(ValueError, match="dw_w"):
        tfc.fused_dw_pw(x, dw_w[:2], dw_b, pw_w, pw_b)
    with pytest.raises(ValueError, match="x must be"):
        tfc.fused_dw_pw(x.double(), dw_w, dw_b, pw_w, pw_b)
    meta = [t.to("meta") for t in (x, dw_w, dw_b, pw_w, pw_b)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfc.fused_dw_pw(*meta)


@pytest.fixture(scope="module")
def folded_backbone():
    """A random 1.0x backbone with non-trivial BN, folded, JAX and port."""
    from yolo_nano_tpu.models.shufflenetv2 import init_shufflenetv2
    from yolo_nano_tpu.utils.fuse_bn import fold_bn

    from yolo_nano_tpu_torch.convert import build_shufflenetv2

    params, stats = init_shufflenetv2(jax.random.key(0), "1.0x")
    rng = np.random.default_rng(2)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), stats)
    folded = jax.tree.map(np.asarray, fold_bn(params, stats))
    return folded, build_shufflenetv2(folded)


def test_fused_stage_plain_matches_pallas(folded_backbone):
    """Port plain stage vs the JAX Pallas whole-stage kernel (interpret) and
    the per-block XLA path, chained stage2 → stage3 as tests/test_pallas.py."""
    from yolo_nano_tpu.models.shufflenetv2 import _block_apply
    from yolo_nano_tpu.ops.pallas.fused_stage import fused_stage, prepare_stage
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like

    jfolded, model = folded_backbone
    fstats = empty_stats_like(jfolded)
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 24)).astype(
        np.float32)
    for name in ("stage2", "stage3"):
        want = jnp.asarray(x)
        for bp, bs in zip(jfolded[name], fstats[name]):
            want, _ = _block_apply(want, bp, bs, False)
        pallas = fused_stage(jnp.asarray(x), prepare_stage(jfolded[name]),
                             interpret=True)
        stage = getattr(model, name)
        got = tfs.fused_stage(nchw(x), tfs.prepare_stage(stage))
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(nhwc(got), np.asarray(pallas), **F32)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **F32)
        x = np.asarray(want)


def test_prepare_stage_layouts_and_checks(folded_backbone):
    _, model = folded_backbone
    blocks = tfs.prepare_stage(model.stage3)
    assert [b["stride"] for b in blocks] == [2] + [1] * 7
    s2, s1 = blocks[0], blocks[1]
    assert tuple(s2["pw1_w"].shape) == (116, 116)
    assert tuple(s2["b1dw_w"].shape) == (9, 116)
    assert tuple(s1["pw1_w"].shape) == (116, 116) and "b1dw_w" not in s1
    assert tuple(s1["dw_w"].shape) == (9, 116)
    # f32, but the bf16 kernel's copies of the pointwise weights
    assert all(t.is_contiguous() and t.dtype == (
        torch.bfloat16 if k.endswith("_bf16") else torch.float32)
               for b in blocks for k, t in b.items() if k != "stride")
    with pytest.raises(ValueError, match="stride-2 block"):
        tfs.prepare_stage(list(model.stage3)[1:])
    with pytest.raises(ValueError, match="f32"):
        tfs.fused_stage(torch.zeros(1, 116, 4, 4, dtype=torch.float64), blocks)


def test_launch_block_refuses_unsupported_widths():
    """The wrapper's checks before any launch: the gemm's warps cover an
    even c2 up to 512, a stride-1 block takes Cin = 2·c2, and pw1's rows
    match x's channels. (The tile rule and shared-memory layout are the
    kernel's own, tested on the card.)"""
    for c2 in (520, 57):
        x = torch.zeros(1, 2 * c2, 4, 4)
        with pytest.raises(ValueError, match="even c2 up to 512"):
            tfs._launch_block(None, x, {"stride": 1,
                                        "pw1_w": torch.zeros(c2, c2)})
    with pytest.raises(ValueError, match="Cin = 2"):
        tfs._launch_block(None, torch.zeros(1, 100, 4, 4),
                          {"stride": 1, "pw1_w": torch.zeros(58, 58)})
    with pytest.raises(ValueError, match="pw1 takes 24 channels"):
        tfs._launch_block(None, torch.zeros(1, 32, 4, 4),
                          {"stride": 2, "pw1_w": torch.zeros(24, 58)})


def test_prepare_stage_pads_pointwise_weights(folded_backbone):
    """The kernel's pointwise weights: the f32 weights, then zeros up to
    multiples of 8 rows and columns; the plain version's stay as they are."""
    _, model = folded_backbone
    for name, cin, c2 in (("stage2", 24, 58), ("stage3", 116, 116)):
        blocks = tfs.prepare_stage(getattr(model, name))
        for i, blk in enumerate(blocks):
            shapes = {"pw1_w": (cin if i == 0 else c2, c2), "pw2_w": (c2, c2)}
            if i == 0:
                shapes["b1pw_w"] = (cin, c2)
            else:
                assert "b1pw_w_pad" not in blk
            for key, (k, n) in shapes.items():
                w, wp = blk[key], blk[key + "_pad"]
                assert tuple(w.shape) == (k, n)
                assert tuple(wp.shape) == (-(-k // 8) * 8, -(-n // 8) * 8)
                assert wp.is_contiguous() and wp.dtype == torch.float32
                assert torch.equal(wp[:k, :n], w)
                assert not wp[k:].any() and not wp[:, n:].any()


def _tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, to nearest, ties away from
    zero (add half of the dropped range to the magnitude, then cut)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


@pytest.fixture(scope="module")
def trained_model():
    from yolo_nano_tpu_torch.convert import load_model

    npz = __file__.rsplit("/tests/", 1)[0] + (
        "/yolo_nano_tpu_torch/assets/bench_coco416.npz")
    model, _, _ = load_model(npz)
    return model


@pytest.mark.parametrize("part,key,k", [
    ("stage2", "pw1_w", 24),    # stride-2 pw1, Cin 24
    ("stage2", "pw2_w", 64),    # c2 58, padded to 64
    ("stage3", "pw2_w", 120),   # c2 116, padded to 120
    ("stage4", "pw2_w", 232),
    ("head0", "pw0", 96),       # the head pairs of fused_dw_pw
    ("head0", "pw1", 96),
    ("head1", "pw0", 96),
    ("head1", "pw1", 96),
    ("head2", "pw0", 96),
    ("head2", "pw1", 96),
])
def test_tf32_split_product_error_at_stage_widths(trained_model, part, key,
                                                  k):
    """Why the kernels' f32 products take three TF32 passes. On the trained
    pointwise weights of the stages (zero-padded as the kernel takes them)
    and of the head pairs, and seeded activations (ReLU for a stage, leaky
    for a head's mid activation), with every product summed in f64 so that
    only the operand rounding shows: the 3-pass split
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi is within 1e-6·max|ref| of the f64
    product, and a single TF32 pass is more than 1e-4·max|ref| off, past the
    f32 tolerance of the kernel checks."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(256, k))
    if part.startswith("stage"):
        blk = tfs.prepare_stage(getattr(trained_model.backbone, part))[
            1 if key == "pw2_w" else 0]
        w = blk[key + "_pad"].numpy()
        a = np.maximum(a, 0).astype(np.float32)
        a[:, blk[key].shape[0]:] = 0  # the kernel's zero pad columns
    else:
        pair = getattr(trained_model, part)._pairs()[int(key[-1])]
        w = pair[2].detach().numpy()
        a = np.where(a >= 0, a, 0.1 * a).astype(np.float32)
    assert w.shape[0] == k
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    f64 = lambda m: m.astype(np.float64)  # noqa: E731
    ref = f64(a) @ f64(w)
    three = (f64(a_lo) @ f64(w_hi) + f64(a_hi) @ f64(w_lo)
             + f64(a_hi) @ f64(w_hi))
    one = f64(a_hi) @ f64(w_hi)
    scale = np.abs(ref).max()
    assert np.abs(three - ref).max() <= 1e-6 * scale
    assert np.abs(one - ref).max() > 1e-4 * scale


def test_fused_dw_pw_launch_refuses_wide_cout():
    """The wrapper's check before any launch: the gemm's warps cover Cout
    up to 512. (Widths whose weights do not fit in shared memory are the
    kernel's tile rule's to refuse, tested on the card.)"""
    x = torch.zeros(1, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="Cout up to 512"):
        tfc._launch(x, torch.zeros(3, 3, 8), torch.zeros(8),
                    torch.zeros(8, 520), torch.zeros(520), "leaky", "leaky")
