"""Port parity of `losses.targets.build_targets` against the JAX package's
sequential numpy oracle `build_targets_numpy` and its batched XLA version,
on the CPU.

Collision-free inputs (every gt of an image in its own stride-32 cell, so
no two gts write one row at any level) must give the oracle's target bit
for bit. Box corners are multiples of 1/S with S a power of two, so that
the centres, sizes, cell offsets and weights are exact in f32 as in the
oracle's f64. tw and th are log(size / anchor): the oracle divides by the
f64 anchor and takes the log in f64, the port and XLA by the f32 anchor, so
they differ from the oracle by the anchor's rounding (within 1e-6) and from
XLA by at most one f32 ulp.

On collisions the port's rule is fixed, where XLA's scatter picks any
contender: a positive row beats an ignore row whatever the order of the
gts, and among positives the gt last in its image's list wins, as in the
oracle's sequential loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
from yolo_nano_tpu.losses.targets import build_targets as jbuild
from yolo_nano_tpu.losses.targets import build_targets_numpy
from yolo_nano_tpu_torch.config import MULTI_ANCHOR_SIZE_COCO, YoloNanoConfig
from yolo_nano_tpu_torch.losses.targets import build_targets

EXACT_COLS = [0, 1, 2, 3, 6, 7, 8, 9, 10]   # all but tw, th
LOG_COLS = [4, 5]
LOG_ATOL = 1e-6


def collision_free_gt(rng, b, m, size, num_classes, n_pad=2):
    """Per image m gts centred in distinct stride-32 cells, corners on the
    1/size lattice; the last n_pad slots are padding (label −1), one more
    gt is under a pixel wide (skipped by both)."""
    g = size // 32
    boxes = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        cells = rng.choice(g * g, m, replace=False)
        for j, cell in enumerate(cells):
            cx = (cell % g) * 32 + int(rng.integers(1, 31))
            cy = (cell // g) * 32 + int(rng.integers(1, 31))
            hw = int(rng.integers(1, min(cx, size - cx, 200) + 1))
            hh = int(rng.integers(1, min(cy, size - cy, 200) + 1))
            boxes[i, j] = np.array([cx - hw, cy - hh, cx + hw, cy + hh]) / size
    labels = rng.integers(0, num_classes, (b, m)).astype(np.int32)
    labels[:, m - n_pad:] = -1
    boxes[:, m - n_pad - 1, 2] = boxes[:, m - n_pad - 1, 0] + 0.5 / size
    return boxes, labels


def port_targets(boxes, labels, cfg, size):
    return build_targets(torch.from_numpy(boxes), torch.from_numpy(labels),
                         cfg, size).numpy()


@pytest.mark.parametrize("size,anchors,seed", [
    (512, None, 0), (256, None, 1), (512, MULTI_ANCHOR_SIZE_COCO, 2),
    (1024, MULTI_ANCHOR_SIZE_COCO, 3)])
def test_build_targets_equals_numpy_oracle_without_collisions(size, anchors,
                                                              seed):
    kw = {} if anchors is None else dict(anchors=anchors)
    cfg, jcfg = YoloNanoConfig(num_classes=20, **kw), JaxConfig(num_classes=20,
                                                                **kw)
    boxes, labels = collision_free_gt(np.random.default_rng(seed), 3, 12,
                                      size, 20)
    got = port_targets(boxes, labels, cfg, size)
    want = build_targets_numpy(boxes, labels, jcfg, size)
    assert got.shape == want.shape == (3, cfg.num_predictions(size), 11)
    assert (want[..., 0] == 1).sum() == 3 * 9
    assert (want[..., 0] == -1).sum() > 0
    np.testing.assert_array_equal(got[..., EXACT_COLS], want[..., EXACT_COLS])
    np.testing.assert_allclose(got[..., LOG_COLS], want[..., LOG_COLS],
                               rtol=0, atol=LOG_ATOL)
    # and XLA's batched version, on the same inputs
    xla = np.asarray(jbuild(jnp.asarray(boxes), jnp.asarray(labels), jcfg,
                            size))
    np.testing.assert_array_equal(got[..., EXACT_COLS], xla[..., EXACT_COLS])
    np.testing.assert_array_max_ulp(got[..., LOG_COLS], xla[..., LOG_COLS],
                                    maxulp=1)


def _collisions():
    """Image 0: gts A and B share a centre cell with other shapes, and each
    is above the ignore threshold on the other's best anchor, so each writes
    an ignore row where the other writes its positive. Image 1: gts C and D
    are the same box with other classes (a positive/positive collision)."""
    size = 256
    a = np.array([100, 100, 160, 160]) / size        # 60 px square
    b = np.array([104, 96, 156, 166]) / size         # same cell, 52 x 70
    c = np.array([20, 30, 120, 200]) / size
    boxes = np.zeros((2, 4, 4), np.float32)
    labels = np.full((2, 4), -1, np.int32)
    boxes[0, 0], boxes[0, 1], labels[0, :2] = a, b, (3, 7)
    boxes[1, 0], boxes[1, 1], labels[1, :2] = c, c, (5, 11)
    return boxes, labels, size


def positives_over_ignores(targets):
    """Merge the oracle's targets of single gts: every ignore row first,
    then every positive row over them."""
    out = np.zeros_like(targets[0])
    for t in targets:
        out[t[:, 0] == -1, 0] = out[t[:, 0] == -1, 6] = -1.0
    for t in targets:
        out[t[:, 0] == 1] = t[t[:, 0] == 1]
    return out


def test_build_targets_collisions_positive_beats_ignore():
    cfg, jcfg = YoloNanoConfig(num_classes=20), JaxConfig(num_classes=20)
    boxes, labels, size = _collisions()
    alone = [build_targets_numpy(boxes[:1, i:i + 1], labels[:1, i:i + 1],
                                 jcfg, size)[0] for i in range(2)]
    # the collision is there: each ignores the row of the other's positive
    for mine, other in ((0, 1), (1, 0)):
        assert ((alone[mine][:, 0] == 1) & (alone[other][:, 0] == -1)).sum() == 1
    want = positives_over_ignores(alone)
    assert (want[:, 0] == 1).sum() == 2
    for order in ([0, 1, 2, 3], [1, 0, 2, 3]):
        got = port_targets(boxes[:, order], labels[:, order], cfg, size)
        np.testing.assert_array_equal(got[0][:, EXACT_COLS],
                                      want[:, EXACT_COLS])
        np.testing.assert_allclose(got[0][:, LOG_COLS], want[:, LOG_COLS],
                                   rtol=0, atol=LOG_ATOL)
        # positive/positive: the gt last in the list wins, as in the oracle
        oracle = build_targets_numpy(boxes[:, order], labels[:, order], jcfg,
                                     size)
        np.testing.assert_array_equal(got[1][:, EXACT_COLS],
                                      oracle[1][:, EXACT_COLS])
        assert (got[1][:, 0] == 1).sum() == 1
        assert got[1][got[1][:, 0] == 1, 1] == labels[1, order[1]]


def test_build_targets_argmax_ties_take_the_first_anchor():
    """A gt whose wh-IoU ties two anchors exactly: the first is best, as
    jnp.argmax and np.argmax pick."""
    anchors = ((16.0, 16.0), (16.0, 16.0), (64.0, 64.0)) * 3
    cfg = YoloNanoConfig(num_classes=20, anchors=anchors)
    jcfg = JaxConfig(num_classes=20, anchors=anchors)
    boxes = np.array([[[32, 32, 48, 48]]], np.float32) / 128
    labels = np.array([[4]], np.int32)
    got = port_targets(boxes, labels, cfg, 128)
    want = build_targets_numpy(boxes, labels, jcfg, 128)
    np.testing.assert_array_equal(got[..., EXACT_COLS], want[..., EXACT_COLS])
    pos = np.nonzero(got[0, :, 0] == 1)[0]
    assert len(pos) == 1 and pos[0] % 3 == 0   # anchor slot 0 of its level
