"""Port parity of the training forward against the JAX package, on the CPU:
`detection_loss`, `iou_score`, `loss_forward` with the train-mode BN stats
of every unit, the init's distributions, and the multi-scale resize.

Tolerances: detection_loss rtol 2e-5 (as the JAX package's own oracle
test); iou_score rtol 1e-6, atol 1e-7; loss_forward's four losses rtol 1e-4
and each unit's new running stats within 1e-4·max|JAX leaf| + 1e-6 (a 1×1
conv after a BN has a batch mean near 1e-6, summed from terms of 1, and
stage 4 normalises over 8 values at 64 px, batch 2); the resize within
1e-5 of `jax.image.resize` at down- and upscales.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
from yolo_nano_tpu_torch.config import YoloNanoConfig
from yolo_nano_tpu_torch.convert import (build_yolo_nano, flatten_tree,
                                         named_from_tree)

SIZE = 64


def random_loss_inputs(seed=0, b=3, n=50, c=20):
    rng = np.random.default_rng(seed)
    pred_conf = rng.normal(0, 2, (b, n, 1)).astype(np.float32)
    pred_cls = rng.normal(0, 2, (b, n, c)).astype(np.float32)
    pred_box = rng.normal(0, 1, (b, n, 4)).astype(np.float32)
    pred_iou = rng.uniform(0, 1, (b, n, 1)).astype(np.float32)
    label = np.zeros((b, n, 8), np.float32)
    obj = rng.choice([-1.0, 0.0, 1.0], (b, n), p=[0.1, 0.7, 0.2])
    label[:, :, 1] = obj
    label[:, :, 0] = rng.uniform(0, 1, (b, n)) * (obj == 1.0)
    label[:, :, 2] = rng.integers(0, c, (b, n))
    label[:, :, 3:5] = rng.uniform(0, 1, (b, n, 2))
    label[:, :, 5:7] = rng.normal(0, 1, (b, n, 2))
    label[:, :, 7] = rng.uniform(1, 2, (b, n)) * (obj == 1.0)
    return pred_conf, pred_cls, pred_box, pred_iou, label


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_matches_jax(seed):
    from yolo_nano_tpu.losses.losses import detection_loss as jloss
    from yolo_nano_tpu_torch.losses.losses import detection_loss

    args = random_loss_inputs(seed)
    # a few extreme logits: the stable BCE and softmax must stay finite
    args[2][0, :3, :2] = [[-120.0, 95.0], [60.0, -60.0], [0.0, 200.0]]
    want = jloss(*map(jnp.asarray, args))
    got = detection_loss(*map(torch.from_numpy, args))
    for g, w, name in zip(got, want, ("conf", "cls", "bbox", "iou")):
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(w), rtol=2e-5,
                                   err_msg=name)


def test_iou_score_matches_jax():
    from yolo_nano_tpu.models.yolo_nano import iou_score as jiou
    from yolo_nano_tpu_torch.models.yolo_nano import iou_score

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 0.8, (2, 300, 2, 2))
    boxes = np.concatenate([xy[..., 0, :], xy[..., 0, :] + rng.uniform(
        0, 0.3, (2, 300, 2))], -1).astype(np.float32)
    other = np.concatenate([xy[..., 1, :], xy[..., 1, :] + rng.uniform(
        0, 0.3, (2, 300, 2))], -1).astype(np.float32)
    other[0, :5] = boxes[0, :5]          # identical boxes: IoU 1
    boxes[1, :5, 2:] = boxes[1, :5, :2]  # zero-area against zero-area
    other[1, :5] = boxes[1, :5]
    got = iou_score(torch.from_numpy(boxes), torch.from_numpy(other)).numpy()
    want = np.asarray(jiou(jnp.asarray(boxes), jnp.asarray(other)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0, :5], 1.0, rtol=1e-6)
    assert (got[1, :5] == 0).all()


@pytest.fixture(scope="module")
def forward_pair():
    """One JAX-initialised 0.5x tree, its train-mode loss_forward in JAX
    (jitted) and in the port, on one batch with its targets."""
    from yolo_nano_tpu.losses.targets import build_targets as jbuild
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu.models.yolo_nano import loss_forward as jforward
    from yolo_nano_tpu_torch.models.yolo_nano import loss_forward

    from tests.test_torch_train import tiny_batch

    jcfg = JaxConfig(num_classes=20, backbone="0.5x")
    cfg = YoloNanoConfig(num_classes=20, backbone="0.5x")
    params, stats = init_yolo_nano(jax.random.key(3), jcfg)
    images, boxes, labels = tiny_batch(seed=4)
    target = jbuild(jnp.asarray(boxes), jnp.asarray(labels), jcfg, SIZE)
    fwd = jax.jit(functools.partial(jforward, cfg=jcfg, input_size=SIZE,
                                    train=True))
    jlosses, jstats = fwd(params, stats, jnp.asarray(images), target)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    model = build_yolo_nano(np_tree(params), np_tree(stats), cfg)
    model.requires_grad_(True).train()
    losses = loss_forward(model, torch.from_numpy(images),
                          torch.from_numpy(np.array(target)), cfg, SIZE)
    return dict(jlosses=jlosses, jstats=np_tree(jstats), losses=losses,
                model=model)


def test_loss_forward_matches_jax(forward_pair):
    got, want = forward_pair["losses"], forward_pair["jlosses"]
    for g, w, name in zip(got, want, ("conf", "cls", "bbox", "iou")):
        np.testing.assert_allclose(g.detach().item(), float(w), rtol=1e-4,
                                   err_msg=name)


def test_loss_forward_gradients_are_finite(forward_pair):
    model = forward_pair["model"]
    sum(forward_pair["losses"]).backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_train_mode_bn_stats_of_every_unit_match_jax(forward_pair):
    got = {k: v.numpy() for k, v in forward_pair["model"].named_buffers()}
    want = {k: v.numpy() for k, v in
            named_from_tree(forward_pair["jstats"]).items()}
    # 55 backbone units, 7 in the neck, 4 in each of 3 heads
    assert got.keys() == want.keys() and len(want) == 2 * 74
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6, (k, err)
        assert not np.array_equal(w, np.zeros_like(w) if k.endswith("mean")
                                  else np.ones_like(w)), k


@pytest.mark.parametrize("backbone", ["0.5x", "1.0x"])
def test_init_tree_has_the_jax_layout_bounds_and_constants(backbone):
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano as jinit
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    cfg = YoloNanoConfig(num_classes=20, backbone=backbone)
    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(0), cfg)
    jparams, jstats = jinit(jax.random.key(0), JaxConfig(num_classes=20,
                                                         backbone=backbone))
    p, s = flatten_tree(params), flatten_tree(stats)
    jp, js = flatten_tree(jparams), flatten_tree(jstats)
    assert {k: v.shape for k, v in p.items()} == {k: v.shape
                                                  for k, v in jp.items()}
    assert {k: v.shape for k, v in s.items()} == {k: v.shape
                                                  for k, v in js.items()}
    for k, v in s.items():                       # running stats: 0 and 1
        assert (v == (0.0 if k.endswith("mean") else 1.0)).all(), k
    for k, v in p.items():
        v = np.asarray(v)
        leaf = k.rsplit("/", 1)[1]
        backbone_leaf = k.startswith("backbone/")
        if leaf == "scale":
            assert (v == 1.0).all(), k
        elif leaf == "bias":                     # BN bias
            assert (v == (1e-4 if backbone_leaf else 0.0)).all(), k
            np.testing.assert_array_equal(v, jp[k])
        elif leaf in ("w", "b"):
            w = np.asarray(p[k.rsplit("/", 1)[0] + "/w"])
            fan_in = w.shape[0] * w.shape[1] * w.shape[2]
            if leaf == "w" and backbone_leaf:    # N(0, 1/(cin/groups))
                std = 1.0 / w.shape[2]
                if v.size >= 2000:
                    assert abs(v.std() / std - 1) < 0.1, k
                assert np.abs(v).max() < 6 * std, k
                continue
            bound = (math.sqrt(2 / 6) * math.sqrt(3 / fan_in) if leaf == "w"
                     else 1 / math.sqrt(fan_in))
            if k.endswith("out/b"):              # objectness slots
                a = cfg.num_anchors_per_level
                np.testing.assert_array_equal(v[:a], jp[k][:a])
                assert np.allclose(v[:a], -math.log(99.0)), k
                v = v[a:]
            assert np.abs(v).max() <= bound, k
            if v.size >= 2000:
                assert np.abs(v).max() > 0.99 * bound, k
                assert abs(v.std() / (bound / math.sqrt(3)) - 1) < 0.1, k
        else:
            raise AssertionError(f"unexpected leaf {k}")


def test_init_yolo_nano_is_seeded_and_trainable():
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano

    cfg = YoloNanoConfig(num_classes=20, backbone="0.5x")
    one, two = (init_yolo_nano(torch.Generator().manual_seed(5), cfg,
                               device="cpu") for _ in range(2))
    assert one.training
    for (k, a), b in zip(one.state_dict().items(),
                         two.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(p.requires_grad for p in one.parameters())


@pytest.mark.parametrize("out", [48, 40, 32, 96])
def test_multiscale_resize_matches_jax_image_resize(out):
    from yolo_nano_tpu_torch.train.train_step import resize_images

    x = np.random.default_rng(out).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out, 3),
                                       "bilinear"))
    got = resize_images(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
