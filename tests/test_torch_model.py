"""Port parity: backbone, detector features, scores and the whole batched
predict against the JAX package, on the CPU.

Small models (0.5x, 64-96 px) check each module; the trained COCO 1.0x
artifact at 416 checks the slice end to end through `load_predictor`.
Tolerances: f32 rtol 1e-4, atol 1e-5; detections: identical valid and
classes, boxes and scores within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
from yolo_nano_tpu_torch.config import YoloNanoConfig
from yolo_nano_tpu_torch.convert import build_shufflenetv2, build_yolo_nano
from yolo_nano_tpu_torch.models import yolo_nano as tyn
from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn

F32 = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets", "bench_coco416.npz")


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _random_bn(tree, seed):
    """Non-trivial BN: random running stats and scales."""
    rng = np.random.default_rng(seed)
    params, stats = tree
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), stats)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                         if path[-1].key == "scale" else np.asarray(a)),
        params)
    return params, stats


@pytest.mark.parametrize("folded", [False, True])
def test_shufflenetv2_per_stage(folded):
    from yolo_nano_tpu.models.shufflenetv2 import (init_shufflenetv2,
                                                   shufflenetv2_apply)
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like
    from yolo_nano_tpu.utils.fuse_bn import fold_bn as jfold

    params, stats = _random_bn(init_shufflenetv2(jax.random.key(0), "0.5x"),
                               1)
    x = np.random.default_rng(0).normal(size=(2, 96, 96, 3)).astype(np.float32)
    model = build_shufflenetv2(params, stats)
    if folded:
        jparams = jfold(params, stats)
        want, _ = shufflenetv2_apply(jparams, empty_stats_like(jparams),
                                     jnp.asarray(x))
        # both ways to a folded port model: fold the JAX tree, or the module
        from_tree = build_shufflenetv2(jax.tree.map(np.asarray, jparams))
        models = [from_tree, fold_bn(model)]
    else:
        want, _ = shufflenetv2_apply(params, stats, jnp.asarray(x))
        models = [model]
    for m in models:
        assert all(s.folded == folded for s in (m.stage2, m.stage3, m.stage4))
        got = m(nchw(x))
        assert [tuple(g.shape) for g in got] == [
            (2, 48, 12, 12), (2, 96, 6, 6), (2, 192, 3, 3)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), **F32)


@pytest.fixture(scope="module")
def small_detector():
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano

    jcfg = JaxConfig(num_classes=3, backbone="0.5x")
    params, stats = _random_bn(init_yolo_nano(jax.random.key(3), jcfg), 2)
    model = build_yolo_nano(params, stats,
                            YoloNanoConfig(num_classes=3, backbone="0.5x"))
    return jcfg, params, stats, model


@pytest.mark.parametrize("folded", [False, True])
def test_forward_features_and_scores(small_detector, folded):
    from yolo_nano_tpu.models import yolo_nano as jyn
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like
    from yolo_nano_tpu.utils.fuse_bn import fold_bn as jfold

    jcfg, params, stats, model = small_detector
    if folded:
        params = jfold(params, stats)
        stats = empty_stats_like(params)
        model = fold_bn(model)
        assert all(h.folded for h in (model.head0, model.head1, model.head2))
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    conf, cls, txty, _ = jyn.forward_features(params, stats, jnp.asarray(x),
                                              jcfg)
    got = tyn.forward_features(model, torch.from_numpy(x))
    # rows n = level_offset + cell·A + anchor: 3·(8² + 4² + 2²) = 252
    assert tuple(got[0].shape) == (2, 252, 1)
    assert tuple(got[1].shape) == (2, 252, 3)
    assert tuple(got[2].shape) == (2, 84, 3, 4)
    for g, w in zip(got, (conf, cls, txty)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **F32)
    score, cidx = jyn.scores_from_features(conf, cls)
    tscore, tcidx = tyn.scores_from_features(got[0], got[1])
    assert tcidx.dtype == torch.int32
    np.testing.assert_allclose(tscore.detach().numpy(), np.asarray(score),
                               **F32)
    np.testing.assert_array_equal(tcidx.numpy(), np.asarray(cidx))


def test_scores_from_features_on_given_logits():
    from yolo_nano_tpu.models import yolo_nano as jyn

    rng = np.random.default_rng(4)
    conf = rng.normal(0, 3, (2, 50, 1)).astype(np.float32)
    cls = rng.normal(0, 3, (2, 50, 80)).astype(np.float32)
    cls[0, 0, [3, 7]] = 9.0  # a tie: argmax takes the first
    score, cidx = jyn.scores_from_features(jnp.asarray(conf), jnp.asarray(cls))
    tscore, tcidx = tyn.scores_from_features(torch.from_numpy(conf),
                                             torch.from_numpy(cls))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(score), **F32)
    np.testing.assert_array_equal(tcidx.numpy(), np.asarray(cidx))
    assert int(tcidx[0, 0]) == 3


OPERATING_POINTS = {
    # serving: the bench protocol's thresholds
    "serving": dict(conf_thresh=0.1, nms_thresh=0.45, pre_topk=128),
    # eval-strict: the evaluators' operating point
    "eval_strict": dict(conf_thresh=0.001, pre_topk=512, max_det=128),
}


@pytest.fixture(scope="module")
def trained_inputs():
    import bench

    # seed 5: both scenes carry detections at the serving threshold too
    return bench.render_inputs(2, 416, seed=5)


@pytest.mark.parametrize("point", sorted(OPERATING_POINTS))
def test_slice_predict_matches_jax_on_trained_artifact(trained_inputs, point):
    """The whole slice: orbax artifact through JAX predict against the
    committed .npz through the port's load_predictor, on the CPU, at 416."""
    from yolo_nano_tpu.serving import load_predictor as jax_load_predictor

    from yolo_nano_tpu_torch.serving import load_predictor

    kw = OPERATING_POINTS[point]
    want = jax_load_predictor(os.path.join(ROOT, "assets", "bench_coco416"),
                              **kw)(trained_inputs)
    fn = load_predictor(NPZ, device="cpu", **kw)
    assert fn.device.type == "cpu"
    got = fn(trained_inputs)
    names = ("boxes", "scores", "classes", "valid")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-4)
    assert got[3].sum(1).min() > 0  # every image has detections


def test_load_predictor_needs_cuda_or_an_explicit_device():
    from yolo_nano_tpu_torch.serving import load_predictor, resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_predictor(NPZ)
    fn = load_predictor(NPZ, device="cpu", max_det=8)
    with pytest.raises(ValueError, match="images must be"):
        fn(np.zeros((1, 64, 64, 3), np.float32))
