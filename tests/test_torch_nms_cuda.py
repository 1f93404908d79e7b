"""The NMS kernel (`csrc/nms_greedy.cu`) on the card against its plain
version, the CPU fixpoint loop (`ops.kernels.nms_greedy.nms_greedy_plain`),
and the postprocess on the card without a host synchronize.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. They
import only torch and numpy, so they run where JAX is not installed:
    python -m pytest tests/test_torch_nms_cuda.py --noconftest -q
The keep sets are compared bit for bit: the kernel computes each overlap
in f32 in the plain version's order, with no FMA contraction and NaN
propagated as torch does. Inputs cover one image to 256, K from 1 past the
kernel's bitmask design (K up to 1024) to 40,000, TTA's merge (batch 8,
K 2,816, on the other design), IoU and DIoU, clustered
candidates with classes shifted apart as the postprocess shifts them,
tied (duplicate) candidates, invalid rows, overlaps at the f32 threshold
and one ulp either side, and rows holding NaN and inf.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32

    set_full_f32()
    return torch.device("cuda")


def _plain(boxes, valid, thresh, diou):
    """The plain version image by image (its K×K tensors stay small)."""
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy_plain

    return torch.cat([nms_greedy_plain(boxes[i:i + 1], valid[i:i + 1],
                                       thresh, diou)
                      for i in range(boxes.shape[0])])


def _kernel(boxes, valid, thresh, diou, dev):
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy

    keep = nms_greedy(boxes.to(dev), valid.to(dev), thresh, diou)
    torch.cuda.synchronize()
    return keep.cpu()


def _check(boxes, valid, thresh, diou, dev):
    want = _plain(boxes, valid, thresh, diou)
    got = _kernel(boxes, valid, thresh, diou, dev)
    assert got.dtype == torch.bool and got.shape == valid.shape
    bad = (got != want).nonzero()
    assert not len(bad), f"{len(bad)} keeps differ, first {bad[:5].tolist()}"
    return want


def _clusters(seed, b, k):
    """Score-sorted candidates in clusters (chains of suppression), shifted
    by class · 4 as `nms_on_candidates` shifts them, a fifth of them
    invalid, and runs of duplicates (tied candidates, IoU 1)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (b, 8, 2))
    pick = rng.integers(0, 8, (b, k))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 0.02, (b, k, 2))
    wh = rng.uniform(0.05, 0.3, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    dup = rng.random((b, k)) < 0.1
    dup[:, 0] = False
    for i in range(b):
        for j in np.flatnonzero(dup[i]):
            boxes[i, j] = boxes[i, j - 1]
    cls = rng.integers(0, 80 if k > 64 else 3, (b, k))
    boxes = (boxes + cls[..., None] * 4.0).astype(np.float32)
    valid = rng.random((b, k)) >= 0.2
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("diou", [False, True])
@pytest.mark.parametrize("b,k", [(1, 1), (3, 7), (256, 7), (128, 128),
                                 (256, 128), (128, 512), (3, 1000),
                                 (2, 1024), (2, 1025), (1, 3000)])
def test_kernel_keeps_the_plain_versions_set(dev, b, k, diou):
    """K = 1024 is the bitmask design's largest, 1025 on the other's."""
    boxes, valid = _clusters(b * 7919 + k, b, k)
    keep = _check(boxes, valid, 0.45, diou, dev)
    if k >= 128:  # suppression did real work
        assert int(keep.sum()) < int(valid.sum())


def _tta_merge(seed, valid_share):
    """TTA's merged candidates (`utils/tta.py`): batch 8, 22 views of 128
    slots each, a view's detections near-duplicates of the scene's objects
    (shifted by class), score-sorted over the views with the padding last.
    valid_share: the slots a view fills (a few at the serving point, all
    at eval-strict's)."""
    rng = np.random.default_rng(seed)
    b, views, slots = 8, 22, 128
    objs = rng.uniform(0.1, 0.7, (b, 40, 2))
    size = rng.uniform(0.05, 0.3, (b, 40, 2))
    cls = rng.integers(0, 80, (b, 40))
    pick = rng.integers(0, 40, (b, views * slots))
    jitter = rng.normal(0, 0.01, (b, views * slots, 4))
    c = np.take_along_axis(objs, pick[..., None], 1)
    wh = np.take_along_axis(size, pick[..., None], 1)
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + jitter
    boxes += np.take_along_axis(cls, pick, 1)[..., None] * 4.0
    filled = rng.random((b, views * slots)) < valid_share
    score = np.where(filled, rng.random((b, views * slots)), -1.0)
    order = np.argsort(-score, 1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1).astype(np.float32)
    valid = np.take_along_axis(score, order, 1) >= 0
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("diou", [False, True])
@pytest.mark.parametrize("valid_share", [0.04, 1.0])
def test_kernel_on_ttas_merge(dev, valid_share, diou):
    """TTA's merge, K = 2,816, on the chain design: mostly padding or all
    valid."""
    boxes, valid = _tta_merge(int(valid_share * 100) + diou, valid_share)
    keep = _check(boxes, valid, 0.5, diou, dev)
    assert int(keep.sum()) < int(valid.sum())


def _plain_on_valid(boxes, valid, thresh, diou):
    """The plain version on each image's valid candidates alone, scattered
    back: the same keep set (a candidate not valid is never kept and
    suppresses nothing; each overlap is the same f32 value), with K×K
    tensors only as large as the valid count."""
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy_plain

    keep = torch.zeros_like(valid)
    for i in range(boxes.shape[0]):
        idx = valid[i].nonzero()[:, 0]
        keep[i, idx] = nms_greedy_plain(
            boxes[i, idx], torch.ones(len(idx), dtype=torch.bool), thresh,
            diou)
    return keep


@pytest.mark.parametrize("diou", [False, True])
@pytest.mark.parametrize("b,k", [(2, 14196), (1, 40000)])
def test_kernel_at_large_k(dev, b, k, diou):
    """K of a pre-top-k as large as a 608 or 640 px image's rows, a tenth
    valid, spread over the candidates."""
    boxes, valid = _clusters(b * 31 + k, b, k)
    valid &= torch.from_numpy(
        np.random.default_rng(k).random((b, k)) < 0.1)
    want = _plain_on_valid(boxes, valid, 0.45, diou)
    got = _kernel(boxes, valid, 0.45, diou, dev)
    bad = (got != want).nonzero()
    assert not len(bad), f"{len(bad)} keeps differ, first {bad[:5].tolist()}"
    assert int(want.sum()) < int(valid.sum())


def _ovr(a, b, diou):
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import (
        _pairwise_diou_penalty, _pairwise_iou)

    boxes = torch.from_numpy(np.stack([a, b], 1))
    ovr = _pairwise_iou(boxes)
    if diou:
        ovr = ovr - _pairwise_diou_penalty(boxes)
    return ovr[:, 0, 1].numpy()


def _threshold_pairs(thresh, diou, per_target=6):
    """Pairs (A, B) whose overlap by the plain version is the f32 threshold
    and one ulp below and above it: A = [0, 0, s, 1], B = [x1, y, s, y + h]
    at random s, x1, y, with h solved near the threshold and then stepped by
    ulps. → boxes [n, 2, 4] and each pair's overlap."""
    t = np.float32(thresh)
    targets = [np.nextafter(t, np.float32(0)), t,
               np.nextafter(t, np.float32(1))]
    rng = np.random.default_rng(int(thresh * 1000) + diou)
    n = 256
    s = rng.uniform(0.5, 3, n).astype(np.float32)
    x1 = (s * rng.uniform(0, 0.2, n)).astype(np.float32)
    y = rng.uniform(0, 0.3, n).astype(np.float32)
    a = np.stack([np.zeros(n), np.zeros(n), s, np.ones(n)], -1).astype(
        np.float32)

    def box(x1, y, s, h):
        return np.stack([x1, y, s, y + h], -1).astype(np.float32)

    h = np.full(n, t, np.float32)
    for _ in range(6):
        h = (h + (t - _ovr(a, box(x1, y, s, h), diou))).astype(np.float32)
    steps = np.arange(-64, 65, dtype=np.int32)
    hs = (h.view(np.int32)[:, None] + steps).view(np.float32).ravel()
    rep = lambda v: np.repeat(v, steps.size, 0)  # noqa: E731
    a, b = rep(a), box(rep(x1), rep(y), rep(s), hs)
    ovr = _ovr(a, b, diou)
    chosen = []
    for target in targets:
        hit = np.flatnonzero(ovr == target)[:per_target]
        assert len(hit) == per_target, (thresh, diou, target)
        chosen.extend(hit)
    return np.stack([a[chosen], b[chosen]], 1), ovr[chosen]


@pytest.mark.parametrize("diou", [False, True])
@pytest.mark.parametrize("thresh", [0.45, 0.5, 0.6])
def test_kernel_at_the_threshold_and_one_ulp_either_side(dev, thresh,
                                                         diou):
    """Each pair an image of K = 2, and all pairs in one image as well, A
    and B in both orders: the lower-scored box goes exactly when the
    overlap exceeds the f32 threshold (0.45 rounds down in f32, 0.6 up)."""
    pairs, ovr = _threshold_pairs(thresh, diou)
    boxes = torch.from_numpy(np.concatenate([pairs, pairs[:, ::-1]]))
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    keep = _check(boxes, valid, thresh, diou, dev)
    second = np.concatenate([ovr, ovr]) <= np.float32(thresh)
    np.testing.assert_array_equal(keep[:, 1].numpy(), second)
    assert keep[:, 1].any() and not keep[:, 1].all()
    # the same pairs side by side in one image, 4 apart
    x = torch.arange(len(boxes), dtype=torch.float32)[:, None] * 4
    side = boxes + torch.stack([x, torch.zeros_like(x)] * 2, -1)
    _check(side.reshape(1, -1, 4), valid.reshape(1, -1), thresh, diou, dev)


@pytest.mark.parametrize("diou", [False, True])
@pytest.mark.parametrize("k", [128, 512, 1100])
def test_kernel_on_nan_and_inf(dev, k, diou):
    """Rows holding NaN, ±inf, zero and negative sizes: NaN overlaps
    suppress nothing, as in the plain version (max, min and clamp propagate
    NaN)."""
    boxes, valid = _clusters(k, 4, k)
    nan, inf = float("nan"), float("inf")
    for img in range(4):
        boxes[img, 3] = nan
        boxes[img, 10, 0] = nan
        boxes[img, 11, 3] = nan
        boxes[img, 20, 2] = inf
        boxes[img, 30, 0], boxes[img, 30, 2] = -inf, inf
        boxes[img, 40, 3] = -inf
        boxes[img, 50, 2] = boxes[img, 50, 0]
        boxes[img, 60, 2] = boxes[img, 60, 0] - 0.1
        boxes[img, 70] = inf
        boxes[img, 80] = boxes[img, 79]
    valid[:, [3, 10, 20, 30, 70]] = True
    _check(boxes, valid, 0.5, diou, dev)


def test_launches_count_each_call(dev):
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy

    boxes, valid = _clusters(1, 2, 40)
    boxes, valid = boxes.to(dev), valid.to(dev)
    before = nms_greedy.launches
    for diou in (False, True, False):
        nms_greedy(boxes, valid, 0.5, diou)
    assert nms_greedy.launches == before + 3
    nms_greedy(boxes[:0], valid[:0], 0.5)  # nothing to launch for
    assert nms_greedy.launches == before + 3
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [128, 512])
@pytest.mark.parametrize("npz", ["bench_coco416.npz",
                                 "bench_coco416_05x.npz"])
def test_postprocess_makes_no_host_sync(dev, npz, k):
    """Scores, top-k, decode, NMS and the final top-k on a forward's
    outputs (the f32 1.0x and the bf16 0.5x artifact) enqueue with no
    synchronizing call, once the decode rows and the kernel are built."""
    from yolo_nano_tpu_torch.models.yolo_nano import (postprocess_scored,
                                                      scores_from_features)
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy
    from yolo_nano_tpu_torch.serving import load_predictor

    fn = load_predictor(os.path.join(ASSETS, npz), device="cuda")
    cfg = dataclasses.replace(fn.cfg, nms_pre_topk=k,
                              conf_thresh=0.1 if k == 128 else 0.001)
    size = fn.input_size
    x = torch.from_numpy(np.random.default_rng(k).uniform(
        0, 1, (16, size, size, 3)).astype(np.float32)).to(dev)

    def postprocess():
        score, cls = scores_from_features(conf, clss)
        return postprocess_scored(txty, score, cls, cfg, size)

    with torch.inference_mode():
        conf, clss, txty = fn.model(x.to(fn.dtype))
        postprocess()  # builds decode's rows and the kernel
        torch.cuda.synchronize()
        before = nms_greedy.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = postprocess()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert nms_greedy.launches == before + 1
    boxes, scores, classes, valid = (t.cpu() for t in out)
    assert boxes.shape == (16, cfg.max_detections, 4)
    assert valid.dtype == torch.bool and classes.dtype == torch.int32
    assert bool(((scores >= cfg.conf_thresh) | ~valid).all())
    if k == 512:
        assert int(valid.sum()) > 0
