"""Port parity in bf16: the bf16 plain version of `fused_stage` against the
Pallas kernel in interpret mode, the bf16 primitives, and the slice (the
0.5x COCO artifact `bench_coco416_05x` through `load_predictor`, and
`make_predict_fn` at its bf16 default) against the JAX package, on the CPU.

Tolerances:
  * stages: every element within one bf16 ulp of the stage output's
    max|ref| of the Pallas kernel's, and at least 95% of the elements
    bit-equal (measured 100%, 98.3%, 100% at stages 2, 3, 4). The two sum
    each op's f32 products in another order, so a bf16 rounding can flip
    by one ulp where the f32 sum sits on a boundary, and a flip moves the
    inputs of every later op and block: through stage 3's eight blocks a
    value near 0 can move by tens of its own ulps (37 measured), but not
    past the resolution of the stage's largest values. A rounding point
    missed or added would flip most elements, not a few percent;
  * the slice's head outputs: the port's bf16 forward and JAX's bf16
    forward are two bf16 approximations of one f32 function (JAX's bf16
    `predict` runs separate convs, each rounded before its bias); the
    yardstick is JAX's f32 forward on the same weights widened to f32
    (exact), and the port's root-mean-square distance to it must be at most
    2x JAX bf16's (measured 0.82x to 0.85x);
  * detections: `chip_smoke.match_detections` with `BF16_MATCH`, the rule
    the card's bf16 phase holds the kernels to: matched one to one by
    class with box IoU >= 0.9 and |Δscore| <= 5e-3 + 10%·score, then
    across classes by the same rule (a class flip); every detection left
    unmatched must be explained by a rule of that function's docstring
    (near conf_thresh, a swap with a detection of its class, an NMS flip
    or chain, a cut).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_MATCH, match_detections
from yolo_nano_tpu_torch import convert
from yolo_nano_tpu_torch.ops.kernels import fused_stage as tfs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")
ARTIFACT_05X = os.path.join(ROOT, "assets", "bench_coco416_05x")
STAGE_BIT_EQUAL = 0.95
OPERATING_POINTS = {
    "serving": dict(conf_thresh=0.1, nms_thresh=0.45, pre_topk=128),
    "eval_strict": dict(conf_thresh=0.001, pre_topk=512, max_det=128),
}


def nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(
        0, 3, 1, 2).to(dtype)


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def bf16_ulps(got, want):
    """|got − want| in bf16 ulps of max(|want|, 2^-8·max|want|) (values
    near 0, where a ReLU decides, count at the ulp of that floor)."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    mag = np.maximum(np.abs(want), 2.0 ** -8 * np.abs(want).max())
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(got - want) / ulp


@pytest.fixture(scope="module")
def model_05x():
    """The 0.5x artifact as the port loads it (bf16 modules), and its tree
    as JAX-layout numpy bf16 arrays."""
    import ml_dtypes

    tree, meta = convert.load_npz(NPZ_05X)
    jtree = jax.tree.map(
        lambda t: t.view(torch.int16).numpy().view(ml_dtypes.bfloat16), tree)
    model, cfg, _ = convert.load_model(NPZ_05X)
    return model, cfg, jtree


@pytest.fixture(scope="module")
def inputs_416():
    import bench

    # seed 5: both scenes carry detections at the serving threshold too
    return bench.render_inputs(2, 416, seed=5)


def test_fused_stage_plain_bf16_matches_pallas(model_05x):
    """Stages 2-4 of the 0.5x artifact (c2 = 24, 48, 96), batch 2, on the
    stem's bf16 output for 128 px scenes (stage inputs 32², 16², 8²),
    chained on the Pallas outputs."""
    import bench
    from yolo_nano_tpu.ops.pallas.fused_stage import fused_stage, prepare_stage

    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    model, _, jtree = model_05x
    images = nchw(bench.render_inputs(2, 128, seed=5), torch.bfloat16)
    with torch.inference_mode():
        x = max_pool_3x3_s2(model.backbone.conv1(images))
    x = nhwc(x)
    for name, side in (("stage2", 32), ("stage3", 16), ("stage4", 8)):
        assert x.shape[1:3] == (side, side)
        want = np.asarray(fused_stage(
            jnp.asarray(x, jnp.bfloat16),
            prepare_stage(jtree["backbone"][name]), interpret=True))
        assert want.dtype == jnp.bfloat16
        got = tfs.fused_stage(nchw(x, torch.bfloat16),
                              tfs.prepare_stage(getattr(model.backbone, name)))
        assert got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        got, want = nhwc(got), want.astype(np.float32)
        assert got.shape == want.shape
        top_ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        equal = float((got == want).mean())
        assert np.abs(got - want).max() <= top_ulp, name
        assert equal >= STAGE_BIT_EQUAL, (name, equal)
        x = want


def _random_folded_stage(rng, cin, c2, n_blocks):
    """A folded stage as a JAX-layout list of blocks (HWIO weights), every
    weight and bias a bf16 value held in f32, as a cast model holds them."""
    import ml_dtypes

    def unit(k, i, o, groups=1):
        w = rng.normal(0, 1 / np.sqrt(i // groups * k * k),
                       (k, k, i // groups, o))
        b = rng.normal(0, 0.1, o)
        return {key: np.asarray(a, np.float32).astype(ml_dtypes.bfloat16
                                                      ).astype(np.float32)
                for key, a in (("w", w), ("b", b))}

    blocks = []
    for i in range(n_blocks):
        k1 = cin if i == 0 else c2
        blk = {"branch2": {"pw1": unit(1, k1, c2),
                           "dw": unit(3, c2, c2, groups=c2),
                           "pw2": unit(1, c2, c2)}}
        if i == 0:
            blk["branch1"] = {"dw": unit(3, cin, cin, groups=cin),
                              "pw": unit(1, cin, c2)}
        blocks.append(blk)
    return blocks


@pytest.mark.parametrize("width,cin,c2", [("1.5x", 352, 352),
                                          ("2.0x", 488, 488)])
def test_fused_stage_plain_bf16_wide_matches_pallas(width, cin, c2):
    """Stage 4 at the widths the bf16 kernel's wide variant runs (1.5x: c2 =
    352, 2.0x: c2 = 488; four blocks, random bf16 weights), batch 1, on an
    8x8 input: the port's bf16 plain version against the Pallas kernel in
    interpret mode, within one bf16 ulp of the stage's max|ref| and 95% of
    the elements bit-equal, as at 0.5x."""
    from yolo_nano_tpu.ops.pallas.fused_stage import fused_stage, prepare_stage

    from torch import nn

    from yolo_nano_tpu_torch.convert import conv_unit
    from yolo_nano_tpu_torch.models.shufflenetv2 import (ShuffleBlock,
                                                         ShuffleStage)
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

    rng = np.random.default_rng(11)
    tree = _random_folded_stage(rng, cin, c2, 4)
    x = np.maximum(rng.normal(size=(1, 8, 8, cin)), 0).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(fused_stage(xb, prepare_stage(tree), interpret=True)
                      ).astype(np.float32)
    blocks = []
    for i, blk in enumerate(tree):
        s = 2 if i == 0 else 1
        b2 = nn.ModuleDict({"pw1": conv_unit(blk["branch2"]["pw1"],
                                             act="relu"),
                            "dw": conv_unit(blk["branch2"]["dw"], stride=s),
                            "pw2": conv_unit(blk["branch2"]["pw2"],
                                             act="relu")})
        b1 = None if i else nn.ModuleDict({
            "dw": conv_unit(blk["branch1"]["dw"], stride=2),
            "pw": conv_unit(blk["branch1"]["pw"], act="relu")})
        blocks.append(ShuffleBlock(b2, b1))
    stage = cast_f32_to_bf16(ShuffleStage(blocks))
    got = nhwc(tfs.fused_stage(nchw(np.asarray(xb, np.float32),
                                    torch.bfloat16),
                               tfs.prepare_stage(stage)))
    assert got.shape == want.shape == (1, 4, 4, 2 * c2)
    top_ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    equal = float((got == want).mean())
    print(f"{width}: {equal:.5f} bit-equal, max |diff| "
          f"{np.abs(got - want).max() / top_ulp:.3g} ulps of max|ref|")
    assert np.abs(got - want).max() <= top_ulp, width
    assert equal >= STAGE_BIT_EQUAL, (width, equal)


def test_fused_stage_bf16_cpu_dispatch(model_05x):
    """A bf16 CPU tensor takes the plain version (and launches nothing);
    f16 and f64 raise."""
    model, _, _ = model_05x
    blocks = tfs.prepare_stage(model.backbone.stage3)
    assert all(t.dtype == torch.float32 for b in blocks
               for k, t in b.items()
               if k != "stride" and not k.endswith("_bf16"))
    x = torch.relu(torch.randn(1, 48, 8, 8, generator=torch.Generator(
        ).manual_seed(0))).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
    counts = lambda: (tfs.fused_stage.launches,  # noqa: E731
                      tfs.fused_stage.launches_bf16)
    launches = counts()
    out = tfs.fused_stage(x, blocks)
    assert counts() == launches
    assert torch.equal(out, tfs.fused_stage_plain(x, blocks))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 96, 4, 4)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="f32 or bf16"):
            tfs.fused_stage(x.to(dtype), blocks)


def test_block_plain_bf16_rounds_where_pallas_rounds():
    """One stride-1 block by hand: each pointwise on bf16 operands with an
    f32 sum, then the f32 bias, ReLU and a round to bf16; the depthwise
    from f32 taps on bf16 inputs, then a round. Weights are f32 values
    (not bf16): the pointwise ones are rounded to bf16, the depthwise ones
    not, as the Pallas kernel's `_mm` and `_dw3x3` do."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(1)
    c2 = 8
    w = {"stride": 1, "pw1_w": torch.randn(c2, c2, generator=g) * 0.3,
         "pw1_b": torch.randn(c2, generator=g) * 0.1,
         "dw_w": torch.randn(9, c2, generator=g) * 0.3,
         "dw_b": torch.randn(c2, generator=g) * 0.1,
         "pw2_w": torch.randn(c2, c2, generator=g) * 0.3,
         "pw2_b": torch.randn(c2, generator=g) * 0.1}
    x = torch.randn(2, 2 * c2, 6, 6, generator=g).to(torch.bfloat16)
    bf = torch.bfloat16
    pw = lambda t, wt, b: torch.relu(  # noqa: E731
        torch.einsum("bchw,co->bohw", t.double(), wt.to(bf).double())
        + b.double()[:, None, None]).float().to(bf)
    t = pw(x[:, c2:], w["pw1_w"], w["pw1_b"])
    t = F.conv2d(t.double(), w["dw_w"].double().t().reshape(c2, 1, 3, 3),
                 w["dw_b"].double(), padding=1, groups=c2).float().to(bf)
    t = pw(t, w["pw2_w"], w["pw2_b"])
    want = torch.stack([x[:, :c2], t], 2).reshape(2, 2 * c2, 6, 6)
    got = tfs.block_plain(x, w)
    assert got.dtype == bf
    # the f32 sums of the plain version and the f64 sums here round alike
    # but where an f32 sum sits on a bf16 rounding boundary
    assert (got.float() == want.float()).float().mean() >= 0.99
    assert bf16_ulps(nhwc(got), nhwc(want)).max() <= 1


def test_cast_f32_to_bf16_matches_jax(small_tree):
    """Every f32 parameter, biases included, becomes bf16 bit for bit as
    JAX's cast_f32_to_bf16 rounds it; BN stats stay f32; the original is
    left as it is; cached kernel layouts are dropped."""
    from yolo_nano_tpu.utils.fuse_bn import cast_f32_to_bf16 as jcast

    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.convert import build_yolo_nano
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

    _, params, stats = small_tree
    model = build_yolo_nano(params, stats,
                            YoloNanoConfig(num_classes=3, backbone="0.5x"))
    model.head0._pairs()
    cast = cast_f32_to_bf16(model)
    assert model.head0._kernel_weights is not None
    assert cast.head0._kernel_weights is None
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.dtype for p in cast.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in cast.buffers()} == {torch.float32}
    want = convert.flatten_tree(jax.tree.map(np.asarray, jcast(params)))
    got = convert.flatten_tree(convert.tree_from_named(
        {k: v.float() for k, v in cast.named_parameters()}))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert w.dtype.name == "bfloat16", k
        np.testing.assert_array_equal(got[k], w.astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("folded", [True, False])
def test_conv_unit_bf16_matches_jax_conv_bn(folded):
    """A bf16 conv unit rounds as JAX conv_bn does: the conv output to
    bf16, then the bias added in bf16 (then eval-mode BN in bf16), then
    LeakyReLU with the slope in bf16; bit for bit. (Adding the bias inside
    F.conv2d, before the rounding, left 30% of the outputs an ulp off.)"""
    from yolo_nano_tpu.ops.nn import conv_bn

    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

    rng = np.random.default_rng(3)
    p = {"w": rng.normal(0, 0.2, (3, 3, 16, 24)).astype(np.float32),
         "b": rng.normal(0, 0.5, (24,)).astype(np.float32)}
    s = None
    if not folded:
        p.update(scale=rng.uniform(0.5, 1.5, 24).astype(np.float32),
                 bias=rng.normal(0, 0.5, 24).astype(np.float32))
        s = {"mean": rng.normal(0, 0.5, 24).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 24).astype(np.float32)}
    x = rng.normal(size=(2, 12, 12, 16)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want, _ = conv_bn(jnp.asarray(x, jnp.bfloat16), jp, s, act="leaky")
    unit = cast_f32_to_bf16(convert.conv_unit(p, s, act="leaky"))
    with torch.inference_mode():
        got = unit(nchw(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("point", sorted(OPERATING_POINTS))
def test_slice_bf16_detections_match_jax(inputs_416, point):
    """The whole slice in bf16: the orbax `_05x` artifact through JAX
    `load_predictor` (eval-strict is the artifact's own thresholds, so the
    stablehlo graph replays; serving's overrides take the parameter path)
    against the committed `.npz` through the port's `load_predictor`, on
    the CPU, at 416 px, batch 2."""
    from yolo_nano_tpu.serving import load_predictor as jax_load_predictor

    from yolo_nano_tpu_torch.serving import load_predictor

    kw = OPERATING_POINTS[point]
    jax_kw = kw if point == "serving" else {}
    want = [np.asarray(w) for w in jax_load_predictor(ARTIFACT_05X,
                                                      **jax_kw)(inputs_416)]
    fn = load_predictor(NPZ_05X, device="cpu", **kw)
    assert fn.dtype == torch.bfloat16
    assert {p.dtype for p in fn.model.parameters()} == {torch.bfloat16}
    got = fn(inputs_416)
    for name, g, w in zip(("boxes", "scores", "classes", "valid"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    assert got[3].sum(1).min() > 0
    counts = match_detections(got, want, fn.cfg.conf_thresh,
                              fn.cfg.nms_thresh, **BF16_MATCH)
    print(f"{point}: {counts}")
    if point == "serving":
        assert counts["matched"] == int(want[3].sum()) == int(got[3].sum())
    else:
        assert counts["matched"] >= 0.8 * want[3].sum()


def test_slice_bf16_head_outputs_against_jax_f32(model_05x, inputs_416):
    """The yardstick: JAX's f32 forward on the `_05x` weights widened to
    f32. The port's bf16 head outputs (conf, cls, txtytwth) are no further
    from it, in root-mean-square, than 2x JAX's bf16 forward. One JAX
    compile computes both JAX forwards."""
    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.models import yolo_nano as jyn
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like

    from yolo_nano_tpu_torch.serving import load_predictor

    _, cfg, jtree = model_05x
    jcfg = JaxConfig(num_classes=cfg.num_classes, backbone=cfg.backbone,
                     anchors=cfg.anchors, strides=cfg.strides,
                     neck_channels=cfg.neck_channels)

    @jax.jit
    def both(params, x):
        stats = empty_stats_like(params)
        wide = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        f32 = jyn.forward_features(wide, stats, x, jcfg)[:3]
        bf16 = jyn.forward_features(params, stats, x.astype(jnp.bfloat16),
                                    jcfg)[:3]
        return f32, bf16

    f32, jbf16 = both(jtree, jnp.asarray(inputs_416))
    fn = load_predictor(NPZ_05X, device="cpu")
    with torch.inference_mode():
        port = fn.model(torch.from_numpy(inputs_416).to(torch.bfloat16))
    for name, ref, j, p in zip(("conf", "cls", "txtytwth"), f32, jbf16, port):
        ref = np.asarray(ref, np.float32)
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == ref.shape
        d_jax = np.sqrt(np.mean((np.asarray(j, np.float32) - ref) ** 2))
        d_port = np.sqrt(np.mean((p.float().numpy() - ref) ** 2))
        print(f"{name}: rms to JAX f32, JAX bf16 {d_jax:.4g}, port bf16 "
              f"{d_port:.4g}, ratio {d_port / d_jax:.3f}")
        assert 0 < d_port <= 2 * d_jax, (name, d_port, d_jax)


def test_load_predictor_bf16_needs_cuda_or_an_explicit_device():
    from yolo_nano_tpu_torch.serving import load_predictor

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_predictor(NPZ_05X)


@pytest.fixture(scope="module")
def small_tree():
    """An unfolded random 0.5x JAX-layout tree (drawn by the port's
    initializer, which is quicker than JAX's eager one), 3 classes, with
    non-trivial BN that keeps the activations alive (running means near
    0), so that the detections' scores do not tie."""
    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig

    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    jcfg = JaxConfig(num_classes=3, backbone="0.5x")
    params, stats = init_yolo_nano_tree(
        torch.Generator().manual_seed(3),
        YoloNanoConfig(num_classes=3, backbone="0.5x"))
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key
                         == "var" else rng.normal(0, 0.1, a.shape)).astype(
                             np.float32), stats)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                         if path[-1].key == "scale" else a), params)
    return jcfg, params, stats


@pytest.mark.parametrize("fold,dtype", [(True, "float32"),
                                        (False, "float32"),
                                        (True, "bfloat16"),
                                        (False, "bfloat16")])
def test_make_predict_fn_matches_jax(small_tree, fold, dtype):
    """The port's make_predict_fn against JAX's, same fold and dtype, on
    96 px images: slot for slot (valid and classes equal, scores and boxes
    within 1e-4), but for bf16 folded, which runs the stages and head pairs
    through the kernels' function and JAX through separate convs: that one
    by the matching rule. Unfolded bf16 runs separate convs on both sides,
    rounded alike."""
    from yolo_nano_tpu.cli.common import make_predict_fn as jax_make

    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.config import YoloNanoConfig

    jcfg, params, stats = small_tree
    cfg = YoloNanoConfig(num_classes=3, backbone="0.5x")
    x = np.random.default_rng(4).normal(size=(2, 96, 96, 3)).astype(
        np.float32)
    want = [np.asarray(w) for w in jax_make(params, stats, jcfg, 96,
                                            fold=fold, dtype=dtype)(x)]
    fn = make_predict_fn(params, stats, cfg, 96, fold=fold, dtype=dtype,
                         device="cpu")
    got = fn(x)
    model_dtypes = {p.dtype for p in fn.model.parameters()}
    assert model_dtypes == {getattr(torch, dtype)}
    assert fn.model.backbone.stage2.folded == fold
    for name, g, w in zip(("boxes", "scores", "classes", "valid"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    assert want[3].sum() > 0
    if not (fold and dtype == "bfloat16"):
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    else:
        counts = match_detections(got, want, cfg.conf_thresh, cfg.nms_thresh,
                                  **BF16_MATCH)
        print(counts)
        assert counts["matched"] >= 0.5 * want[3].sum()


def test_make_predict_fn_takes_a_train_state():
    """A port TrainState reaches make_predict_fn through
    convert.tree_from_named, and predicts as the folded, cast model from
    model_from_state does."""
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.convert import model_from_state, tree_from_named
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.serving import predictor
    from yolo_nano_tpu_torch.train import create_train_state, make_optimizer
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    cfg = YoloNanoConfig(num_classes=3, backbone="0.5x")
    model = init_yolo_nano(torch.Generator().manual_seed(5), cfg,
                           device="cpu")
    state = create_train_state(model, make_optimizer(lambda count: 1e-3))
    fn = make_predict_fn(tree_from_named(state.params),
                         tree_from_named(state.stats), cfg, 64,
                         device="cpu")
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want_model = cast_f32_to_bf16(fold_bn(model_from_state(state, cfg)))
    want = predictor(want_model, cfg, 64, torch.device("cpu"),
                     "bfloat16")(x)
    assert want[3].sum() > 0
    for g, w in zip(fn(x), want):
        np.testing.assert_array_equal(g, w)


def test_make_predict_fn_refuses_the_mesh_branches(small_tree):
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.config import YoloNanoConfig

    from yolo_nano_tpu.cli.common import make_predict_fn as jax_make
    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig

    _, params, stats = small_tree
    cfg = YoloNanoConfig(num_classes=3, backbone="0.5x")
    jcfg = JaxConfig(num_classes=3, backbone="0.5x")
    # the JAX package's refusals: local_rows without process_shard, and
    # process_shard without a mesh
    for kw, msg in ((dict(local_rows=True), "local_rows"),
                    (dict(process_shard=(0, 2)), "needs a global mesh")):
        with pytest.raises(ValueError, match=msg):
            jax_make(params, stats, jcfg, 96, **kw)
        with pytest.raises(ValueError, match=msg):
            make_predict_fn(params, stats, cfg, 96, device="cpu", **kw)
    with pytest.raises(ValueError, match="dtype"):
        make_predict_fn(params, stats, cfg, 96, dtype="float16",
                        device="cpu")
