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
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for b in blocks for k, t in b.items() if k != "stride")
    with pytest.raises(ValueError, match="stride-2 block"):
        tfs.prepare_stage(list(model.stage3)[1:])
    with pytest.raises(ValueError, match="f32"):
        tfs.fused_stage(torch.zeros(1, 116, 4, 4, dtype=torch.float64), blocks)


def test_block_tiles_at_main_path_widths():
    """(stride, Cin, c2) of the 1.0x stages → tile side, buffers in budget."""
    want = {(2, 24, 58): 4, (1, 116, 58): 6, (2, 116, 116): 3,
            (1, 232, 116): 4, (2, 232, 232): 2, (1, 464, 232): 2}
    for (stride, cin, c2), tile in want.items():
        assert tfs.block_tile(stride, cin, c2) == tile
        assert tfs.smem_bytes(tile, stride, cin, c2) <= tfs.SMEM_BUDGET
        assert tfs.smem_bytes(tile + 1, stride, cin, c2) > tfs.SMEM_BUDGET
    # the layout of fused_stage.cu: offsets, max(pw1 region, branch1 dw), dw
    assert tfs.smem_bytes(2, 2, 232, 232) == 4 * 28 + 4 * (25 * 232 + 4 * 232)
