"""The port's test-time augmentation against the JAX package's, on the CPU:
`ops.nms.batched_nms` (the [B,N,C] class-score entry), `ops.nn.
resize_images` against `jax.image.resize(..., "bilinear")`, and
`utils.tta.make_tta_predict` on one seeded tree; plus the JAX package's
own TTA tests (flip equivariance, the merge against a greedy oracle) run
on the port.

Tolerances: batched_nms slot for slot (boxes and scores within 1e-6, the
same candidates in the same order); resize within 1e-5; TTA boxes within
1e-4, scores within 1e-5, classes and valid equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu_torch.config import YoloNanoConfig


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU forwards: the suite runs
    files in parallel worker processes, where every process's default pool
    of one thread per core oversubscribes the cores (a 4 s TTA run took
    390 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _class_scores(seed, b=2, n=96, c=5):
    """[B,N,4] boxes and [B,N,C] scores with planted ties: rows whose top
    two classes tie (argmax must take the first), and rows whose best
    scores tie across boxes (top-k must keep index order)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.7, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (b, n, 2))],
                           -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    scores[:, ::7, 2] = scores[:, ::7, 4] = 0.95      # class ties
    scores[:, 1::5] = np.float32(0.5)                 # score ties, all classes
    scores[:, 3::11, 1] = np.float32(0.8)             # score ties, one class
    return boxes, scores


@pytest.mark.parametrize("seed,diou,pre_topk", [(0, False, 64),
                                                (1, True, 96),
                                                (2, False, 16)])
def test_batched_nms_matches_jax(seed, diou, pre_topk):
    from yolo_nano_tpu.ops.nms import batched_nms as jax_nms

    from yolo_nano_tpu_torch.ops.nms import batched_nms

    boxes, scores = _class_scores(seed)
    kw = dict(conf_thresh=0.05, iou_thresh=0.45, pre_topk=pre_topk,
              max_det=32, diou=diou)
    want = [np.asarray(t) for t in jax_nms(jnp.asarray(boxes),
                                           jnp.asarray(scores), **kw)]
    got = [t.numpy() for t in batched_nms(torch.from_numpy(boxes),
                                          torch.from_numpy(scores), **kw)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert want[3].sum() > 4


@pytest.mark.parametrize("out", [320, 352, 384, 448, 640])
def test_resize_images_matches_jax_at_the_tta_sizes(out):
    """416 → each size: shrinking antialiased, growing not."""
    from yolo_nano_tpu_torch.ops.nn import resize_images

    x = np.random.default_rng(out).normal(size=(1, 416, 416, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, out, out, 3),
                                       "bilinear"))
    got = resize_images(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# make_tta_predict against JAX
# ---------------------------------------------------------------------------

SCALES = (64, 96, 32)  # 2 sizes x 2 flips: 4 views


@pytest.fixture(scope="module")
def tta_case():
    """A seeded 0.5x tree (the port's initializer, 3 classes) with
    non-trivial BN that keeps the scores apart, 80 px images (both TTA
    sizes resize them, one shrinking, one growing), and JAX's TTA
    detections on them."""
    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.utils.tta import make_tta_predict as jax_tta

    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    kw = dict(num_classes=3, backbone="0.5x", nms_pre_topk=64,
              max_detections=24)
    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(5),
                                        YoloNanoConfig(**kw))
    rng = np.random.default_rng(6)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key
                         == "var" else rng.normal(0, 0.1, a.shape)).astype(
                             np.float32), stats)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                         if path[-1].key == "scale" else a), params)
    x = rng.normal(size=(2, 80, 80, 3)).astype(np.float32)
    want = [np.asarray(t) for t in jax_tta(params, stats, JaxConfig(**kw),
                                           scale_range=SCALES)(x)]
    return kw, params, stats, x, want


def test_make_tta_predict_matches_jax(tta_case):
    from yolo_nano_tpu_torch.utils.tta import make_tta_predict

    kw, params, stats, x, want = tta_case
    fn = make_tta_predict(params, stats, YoloNanoConfig(**kw),
                          scale_range=SCALES, device="cpu")
    assert fn.scales == (64, 96) and fn.device.type == "cpu"
    got = fn(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert want[3].sum(1).min() > 2


def test_tta_takes_tensors_and_the_folded_model(tta_case):
    """A tensor on the model's device gives tensors, equal to the numpy
    path's; the folded model (tta_predictor) gives the unfolded tree's
    detections within the tolerances; the merge's nms_thresh is honoured."""
    from yolo_nano_tpu_torch.convert import build_yolo_nano
    from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn
    from yolo_nano_tpu_torch.utils.tta import make_tta_predict, tta_predictor

    kw, params, stats, x, _ = tta_case
    cfg = YoloNanoConfig(**kw)
    fn = make_tta_predict(params, stats, cfg, scale_range=SCALES,
                          device="cpu")
    want = fn(x)
    got = fn(torch.from_numpy(x))
    assert all(isinstance(t, torch.Tensor) for t in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    folded = tta_predictor(fold_bn(build_yolo_nano(params, stats, cfg)), cfg,
                           scale_range=SCALES)(x)
    np.testing.assert_array_equal(folded[3], want[3])
    np.testing.assert_array_equal(folded[2], want[2])
    np.testing.assert_allclose(folded[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(folded[0], want[0], rtol=0, atol=1e-4)
    loose = make_tta_predict(params, stats, cfg, scale_range=SCALES,
                             nms_thresh=0.9, device="cpu")(x)
    assert loose[3].sum() > want[3].sum()
    with pytest.raises(ValueError, match=r"\[B,S,S,3\]"):
        fn(x[:, :, :64])


# ---------------------------------------------------------------------------
# the JAX package's TTA tests, on the port
# ---------------------------------------------------------------------------

def test_tta_is_flip_equivariant():
    """TTA(image) and TTA(flipped image) give mirrored detections: the
    multi-scale + flip ensemble is symmetric under a horizontal flip."""
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree
    from yolo_nano_tpu_torch.utils.tta import make_tta_predict

    cfg = YoloNanoConfig(num_classes=20, nms_pre_topk=64, max_detections=8,
                         conf_thresh=0.0)
    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(0), cfg)
    tta = make_tta_predict(params, stats, cfg, scale_range=(64, 64, 32),
                           device="cpu")
    x = np.random.default_rng(1).uniform(size=(1, 64, 64, 3)).astype(
        np.float32)
    b1, s1, _, v1 = tta(x)
    b2, s2, _, v2 = tta(np.ascontiguousarray(x[:, :, ::-1, :]))
    b2m = np.stack([1 - b2[..., 2], b2[..., 1], 1 - b2[..., 0], b2[..., 3]],
                   -1)
    np.testing.assert_allclose(np.sort(s1[v1]), np.sort(s2[v2]), rtol=1e-3,
                               atol=1e-4)
    top1 = b1[0, np.argmax(s1[0])]
    top2 = b2m[0, np.argmax(s2[0])]
    np.testing.assert_allclose(top1, top2, atol=5e-3)


def test_tta_cross_scale_merge_matches_greedy_oracle():
    """The merge (every view's survivors concatenated, then one per-class
    greedy NMS at the merge threshold, the same batched_nms_scored call)
    equals a sequential numpy oracle on views with heavy cross-view
    duplicates and well-separated scores."""
    from yolo_nano_tpu_torch.ops.nms import batched_nms_scored

    rng = np.random.default_rng(11)
    b, views, per_view, max_det, thresh = 2, 6, 8, 16, 0.4
    n = views * per_view
    base = rng.permutation(n * 2)[:n] * 1e-3 + 0.05
    scores = np.stack([base, np.roll(base, 7)]).astype(np.float32)
    classes = rng.integers(0, 3, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.8
    centers = rng.uniform(0.2, 0.8, (b, per_view, 2))
    sizes = rng.uniform(0.1, 0.25, (b, per_view, 2))
    boxes = np.zeros((b, n, 4), np.float32)
    for v in range(views):
        jit = rng.normal(0, 0.01, (b, per_view, 2))
        c, s = centers + jit, sizes * (1 + rng.normal(0, 0.05,
                                                      (b, per_view, 2)))
        sl = slice(v * per_view, (v + 1) * per_view)
        boxes[:, sl, :2] = c - s / 2
        boxes[:, sl, 2:] = c + s / 2
        classes[:, sl] = classes[:, :per_view]
    merged = np.where(valid, scores, -1.0).astype(np.float32)

    got = [t.numpy() for t in batched_nms_scored(
        torch.from_numpy(boxes), torch.from_numpy(merged),
        torch.from_numpy(classes), conf_thresh=1e-3, iou_thresh=thresh,
        pre_topk=n, max_det=max_det, diou=False)]

    def greedy(bi):
        kept = []
        for j in np.argsort(-merged[bi], kind="stable"):
            if merged[bi, j] < 1e-3:
                continue
            ok = True
            for k in kept:
                if classes[bi, k] != classes[bi, j]:
                    continue
                x1 = max(boxes[bi, j, 0], boxes[bi, k, 0])
                y1 = max(boxes[bi, j, 1], boxes[bi, k, 1])
                x2 = min(boxes[bi, j, 2], boxes[bi, k, 2])
                y2 = min(boxes[bi, j, 3], boxes[bi, k, 3])
                inter = max(x2 - x1, 0) * max(y2 - y1, 0)
                ua = (np.prod(boxes[bi, j, 2:] - boxes[bi, j, :2])
                      + np.prod(boxes[bi, k, 2:] - boxes[bi, k, :2]) - inter)
                if ua > 0 and inter / ua > thresh:
                    ok = False
                    break
            if ok:
                kept.append(j)
        return kept[:max_det]

    for bi in range(b):
        want = greedy(bi)
        kept = np.where(got[3][bi])[0]
        assert len(kept) == len(want)
        np.testing.assert_allclose(got[1][bi][kept], merged[bi][want],
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[2][bi][kept], classes[bi][want])
        np.testing.assert_allclose(got[0][bi][kept], boxes[bi][want],
                                   atol=1e-6)
