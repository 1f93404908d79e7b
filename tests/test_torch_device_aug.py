"""Port parity of the in-graph augmentation (`data/device_aug.py`) and of
`ops.nn.scale_and_translate` against the JAX package, on the CPU.

The same seeded numpy inputs and the same numpy draws go through the JAX
function (eager, vmapped over items where the JAX function takes one item)
and the port's batched one, at small sizes (batch 2 to 16, canvases of 48
to 96 px, outputs of 32 to 64 px). Tolerances:
  * HSV round trip, box mapping, crop rects, identity flags, labels: equal
    (the same f32 operations in the same order);
  * photometric distortion: 1e-3 on the 0..255 scale (hue arithmetic near
    the sector edges rounds in another order on each side);
  * scale_and_translate: the weights equal JAX's weight matrices bit for
    bit; the images within 1e-4 on the 0..255 scale (JAX contracts with a
    matrix product, the port with a two-tap sum);
  * apply_augment: images within IMAGE_ATOL (1e-5) in normalized units
    (≈ 6e-4 on the 0..255 scale), bf16 images within 1 bf16 ulp of each
    value, boxes within 1e-5, labels equal;
  * the sampler is held in distribution only (its generator is not
    jax.random): identity share within 0.04 and mean crop area within
    0.035 of JAX's over 2,000 items (about 4.5 standard errors);
  * one TrainStep(augment=...) step against JAX's make_train_step(...,
    augment=...) on the same fixed draws, on 8 seeds: each side against an
    f64 witness that takes that side's own ReLU decisions (see
    augmented_steps), within test_torch_train's leaf tolerances; losses
    within its LOSS_RTOL for the port and JAX_LOSS_RTOL (2e-4) for JAX.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.torch_ranks import Kinks
from yolo_nano_tpu.data import device_aug as J
from yolo_nano_tpu_torch.data import device_aug as T

IMAGE_ATOL = 1e-5
BOX_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's small ops, as in
    test_torch_train_cli: with a thread per core, each op's barrier waits
    for threads that the test run's other workers have descheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b=4, s0=64, m=6, seed=0):
    """uint8 canvases, boxes inside the canvas (the last two slots
    padding), regions of several shapes with the crop disallowed on row 2,
    and no valid box on row 3 (when b ≥ 4)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, s0, s0, 3)).astype(np.uint8)
    shapes = np.array([[0, 0.1, 1, 0.9, 1], [0.2, 0, 0.8, 1, 1],
                       [0, 0, 1, 1, 0], [0, 0.25, 1, 0.75, 1]], np.float32)
    regions = shapes[np.arange(b) % 4]
    x1 = rng.uniform(0, 0.5, (b, m))
    y1 = rng.uniform(0, 0.5, (b, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.1, 0.5, (b, m)),
                      y1 + rng.uniform(0.1, 0.5, (b, m))], -1)
    labels = rng.integers(0, 5, (b, m)).astype(np.int32)
    labels[:, -2:] = -1
    if b >= 4:
        labels[3] = -1
    return img, np.clip(boxes, 0, 1).astype(np.float32), labels, regions


def _draws(b, rounds=4, trials=8, mosaic=False, seed=1):
    """One numpy draw dict with JAX's keys and dtypes."""
    rng = np.random.default_rng(seed)
    d = {k: rng.random(b) < 0.5 for k in ("bri_coin", "order_coin",
                                           "con_coin", "sat_coin",
                                           "hue_coin", "mirror")}
    d.update(bri_delta=rng.uniform(-32, 32, b), con_f=rng.uniform(.5, 1.5, b),
             sat_f=rng.uniform(.5, 1.5, b), hue_delta=rng.uniform(-18, 18, b),
             mode=rng.integers(0, 6, (b, rounds)).astype(np.int32))
    for k in ("u_w", "u_h", "u_l", "u_t"):
        d[k] = rng.random((b, rounds, trials))
    if mosaic:
        d.update(mos_coin=np.arange(b) % 4 != 1,
                 mos_tiles=np.stack([rng.permutation(max(b - 1, 1))[:3]
                                     % max(b - 1, 1) for _ in range(b)]
                                    ).astype(np.int32)
                 if b >= 4 else rng.integers(0, max(b - 1, 1), (b, 3)
                                             ).astype(np.int32),
                 mos_cx=rng.random(b), mos_cy=rng.random(b))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in d.items()}


def _jd(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _td(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_hsv_round_trip_matches_jax():
    """Random pixels, gray pixels (R = G = B, S = 0) and black; back from
    HSV with S pushed past 1 (the saturation jitter reaches 1.5)."""
    rng = np.random.default_rng(0)
    px = rng.uniform(0, 255, (16, 16, 3)).astype(np.float32)
    px[0] = 77.0
    px[1, :4] = 0.0
    px[2, :, 1] = px[2, :, 2]  # ties between channels
    hsv = np.asarray(J.bgr_to_hsv(jnp.asarray(px)))
    np.testing.assert_array_equal(T.bgr_to_hsv(torch.from_numpy(px)).numpy(),
                                  hsv)
    hsv = hsv.copy()
    hsv[::2, :, 1] *= 1.5
    np.testing.assert_array_equal(
        T.hsv_to_bgr(torch.from_numpy(hsv)).numpy(),
        np.asarray(J.hsv_to_bgr(jnp.asarray(hsv))))


@pytest.mark.parametrize("order", [False, True])
def test_photometric_distort_matches_jax(order):
    """All 16 combinations of the brightness, contrast, saturation and hue
    coins (one per item), with the order coin fixed."""
    b = 16
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (b, 12, 12, 3)).astype(np.float32)
    d = _draws(b, seed=3)
    bits = (np.arange(b)[:, None] >> np.arange(4)) & 1
    for k, key in enumerate(("bri_coin", "con_coin", "sat_coin",
                             "hue_coin")):
        d[key] = bits[:, k].astype(bool)
    d["order_coin"] = np.full(b, order)
    want = np.asarray(jax.vmap(J.photometric_distort)(jnp.asarray(img),
                                                      _jd(d)))
    got = T.photometric_distort(torch.from_numpy(img), _td(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", ["up", "down", "outside"])
def test_scale_and_translate_matches_jax(case):
    """Upsampling, downsampling, and translations that put samples outside
    the input (zeros there, replicated edge taps inside half a pixel)."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    from yolo_nano_tpu_torch.ops.nn import _linear_taps, scale_and_translate

    rng = np.random.default_rng(4)
    b, n_in, n_out = 3, 48, {"up": 64, "down": 32, "outside": 40}[case]
    lo, hi = {"up": (1.2, 2.5), "down": (0.3, 0.9),
              "outside": (0.5, 1.5)}[case]
    scale = rng.uniform(lo, hi, (b, 2)).astype(np.float32)
    span = 30 if case == "outside" else 4
    trans = rng.uniform(-span, span, (b, 2)).astype(np.float32)
    img = rng.integers(0, 256, (b, n_in, n_in, 3)).astype(np.uint8)

    def one(im, s, t):
        return jax.image.scale_and_translate(
            im.astype(jnp.float32), (n_out, n_out, 3), (0, 1), s, t,
            "linear", antialias=False)

    want = np.asarray(jax.vmap(one)(img, scale, trans))
    got = scale_and_translate(torch.from_numpy(img), n_out,
                              torch.from_numpy(scale),
                              torch.from_numpy(trans)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if case == "outside":
        assert (want == 0).any() and (got[want == 0] == 0).all()
    for ax in range(2):
        j, w = _linear_taps(n_in, n_out, torch.from_numpy(scale[:, ax]),
                            torch.from_numpy(trans[:, ax]))
        for i in range(b):
            mat = np.zeros((n_in, n_out), np.float32)
            for k in range(2):
                rows = j[i].numpy() + k
                ok = (rows >= 0) & (rows < n_in)
                mat[rows[ok], np.arange(n_out)[ok]] += w[i, :, k].numpy()[ok]
            np.testing.assert_array_equal(mat, np.asarray(compute_weight_mat(
                n_in, n_out, scale[i, ax], trans[i, ax],
                _fill_triangle_kernel, False)))


@pytest.mark.parametrize("case", ["random", "no_valid_box", "all_rejected"])
def test_sample_crop_matches_jax(case):
    """The same rect and identity flag as JAX's: random draws (some rounds
    exit on mode 0), items with no valid box (identity), and draws whose
    every candidate is rejected (h/w = 0.3: the fallback to identity)."""
    b, rounds, trials = 8, 4, 8
    _, boxes, labels, regions = _batch(b, seed=5)
    d = _draws(b, rounds, trials, seed=6)
    if case == "no_valid_box":
        labels[:] = -1
    elif case == "all_rejected":
        d["mode"] = np.full((b, rounds), 1, np.int32)
        d["u_w"] = np.ones_like(d["u_w"])
        d["u_h"] = np.zeros_like(d["u_h"])
        regions[:, :4] = (0, 0, 1, 1)  # square regions: h/w = 0.3
    want_rect, want_id = jax.vmap(J.sample_crop, (0, 0, 0, 0, None))(
        _jd(d), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(regions[:, :4]), 64)
    rect, identity = T.sample_crop(_td(d), torch.from_numpy(boxes),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(regions[:, :4]), 64)
    np.testing.assert_array_equal(identity.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(rect.numpy(), np.asarray(want_rect))
    if case == "random":
        assert not identity.all() and identity.any()
    else:
        assert identity.all()
        np.testing.assert_array_equal(rect.numpy(), regions[:, :4])


def test_crop_letterbox_boxes_matches_jax():
    b = 8
    _, boxes, labels, _ = _batch(b, seed=7)
    rng = np.random.default_rng(8)
    lt = rng.uniform(0, 0.4, (b, 2))
    rect = np.concatenate([lt, lt + rng.uniform(0.3, 0.6, (b, 2))],
                          1).astype(np.float32)
    identity = np.arange(b) % 3 == 0
    want = jax.vmap(J.crop_letterbox_boxes)(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(rect),
        jnp.asarray(identity))
    got = T.crop_letterbox_boxes(torch.from_numpy(boxes),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(rect),
                                 torch.from_numpy(identity))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy() == -1).sum() > (labels == -1).sum()


@pytest.mark.parametrize("batch", [4, 2])
def test_compose_mosaic_matches_jax(batch):
    """Every item's mosaic: at batch 4 three distinct other rows, at batch
    2 the degenerate tiles (repeats)."""
    img, boxes, labels, regions = _batch(batch, s0=48, seed=9)
    d = _draws(batch, mosaic=True, seed=10)
    pad = jnp.asarray(J._MEAN, jnp.float32) * 255.0
    args = [jnp.asarray(a) for a in (img, boxes, labels, regions)]
    want = jax.vmap(lambda i, di: J.compose_mosaic(i, di, *args, 40, pad))(
        jnp.arange(batch), _jd(d))
    tpad = T._channels(T._MEAN, "cpu") * 255.0
    got = T.compose_mosaic(_td(d), *map(torch.from_numpy,
                                        (img, boxes, labels, regions)),
                           40, tpad)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=BOX_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mosaic", [False, True])
def test_apply_augment_matches_jax(mosaic, dtype):
    """End to end on the same draws: a row with the crop disallowed, a row
    with no valid box; with mosaic, three of four items take the mosaic
    branch."""
    img, boxes, labels, regions = _batch(8, s0=64, seed=11)
    d = _draws(8, mosaic=mosaic, seed=12)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = J.apply_augment(*map(jnp.asarray, (img, boxes, labels, regions)),
                           _jd(d), 48, jdt, mosaic=mosaic)
    got = T.apply_augment(*map(torch.from_numpy,
                               (img, boxes, labels, regions)),
                          _td(d), 48, getattr(torch, dtype), mosaic=mosaic)
    assert got[0].dtype == getattr(torch, dtype)
    assert got[0].shape == (8, 48, 48, 3)
    gi = got[0].float().numpy()
    wi = np.asarray(want[0]).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(gi, wi, rtol=0, atol=IMAGE_ATOL)
    else:  # within one bf16 ulp of each value
        ulp = np.spacing(np.abs(wi).astype(ml_dtypes.bfloat16)).astype(
            np.float32)
        assert (np.abs(gi - wi) <= ulp).all()
        assert (gi == wi).mean() > 0.99
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=BOX_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[2].numpy() >= 0).any(1).sum() >= 6


@pytest.mark.parametrize("mosaic", [False, True])
def test_sample_draws_keys_shapes_and_ranges(mosaic):
    b, rounds, trials = 6, 16, 32
    want = J.sample_draws(jax.random.key(0), b, rounds, trials, mosaic)
    got = T.sample_draws(torch.Generator().manual_seed(0), b, rounds, trials,
                         mosaic)
    assert got.keys() == want.keys()
    ranges = dict(bri_delta=(-32, 32), con_f=(0.5, 1.5), sat_f=(0.5, 1.5),
                  hue_delta=(-18, 18), mode=(0, 5), u_w=(0, 1), u_h=(0, 1),
                  u_l=(0, 1), u_t=(0, 1), mos_tiles=(0, b - 2), mos_cx=(0, 1),
                  mos_cy=(0, 1))
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert g.numpy().dtype == np.asarray(w).dtype, k
        if k in ranges:
            lo, hi = ranges[k]
            assert g.min() >= lo and g.max() <= hi, k


def test_generator_seed_determines_the_augment():
    """One generator seed gives the same outputs; another seed others; the
    global-iteration seed mix gives distinct seeds."""
    img, boxes, labels, regions = map(torch.from_numpy, _batch(4, seed=13))
    aug = T.make_augment_fn(32, rounds=4, trials=8, mosaic=True)

    def run(seed):
        return aug(img, boxes, labels, regions,
                   torch.Generator().manual_seed(seed))

    a, b, c = run(T.augment_seed(0, 5)), run(T.augment_seed(0, 5)), run(
        T.augment_seed(0, 6))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    seeds = {T.augment_seed(s, i) for s in range(4) for i in range(100)}
    assert len(seeds) == 400 and all(0 <= s < 2 ** 64 for s in seeds)


def test_mosaic_tiles_are_distinct_other_rows():
    for b in (4, 5, 16):
        tiles = T.sample_draws(torch.Generator().manual_seed(b), b,
                               mosaic=True)["mos_tiles"].numpy()
        rows = (np.arange(b)[:, None] + 1 + tiles) % b
        assert (rows != np.arange(b)[:, None]).all()
        assert all(len(set(r)) == 3 for r in rows)


def test_sampler_distribution_matches_jax():
    """2,000 items through each side's sample_draws and sample_crop on
    boxes of a VOC-like spread: the identity share and the mean crop area
    (of the region) agree within 0.04 and 0.035."""
    n, m = 2000, 4
    rng = np.random.default_rng(14)
    cxy = rng.uniform(0.2, 0.8, (n, m, 2))
    wh = rng.uniform(0.05, 0.4, (n, m, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0,
                    1).astype(np.float32)
    labels = np.where(rng.random((n, m)) < 0.6, 1, -1).astype(np.int32)
    labels[:, 0] = 1
    region = np.tile(np.array([0, 0.125, 1, 0.875], np.float32), (n, 1))
    jd = J.sample_draws(jax.random.key(3), n)
    jrect, jid = jax.jit(jax.vmap(J.sample_crop, (0, 0, 0, 0, None)),
                         static_argnums=4)(jd, boxes, labels, region, 96)
    td = T.sample_draws(torch.Generator().manual_seed(3), n)
    trect, tid = T.sample_crop(td, torch.from_numpy(boxes),
                               torch.from_numpy(labels),
                               torch.from_numpy(region), 96)

    def stats(rect, identity):
        rect, identity = np.asarray(rect), np.asarray(identity)
        area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
                / 0.75)
        return identity.mean(), area.mean()

    (ji, ja), (ti, ta) = stats(jrect, jid), stats(trect, tid)
    assert 0.1 < ji < 0.5 and 0.3 < ja < 0.9
    assert abs(ti - ji) < 0.04, (ti, ji)
    assert abs(ta - ja) < 0.035, (ta, ja)


STEP_SEEDS = range(15, 23)
JAX_LOSS_RTOL = 2e-4


@pytest.fixture(scope="module")
def augmented_steps():
    """Per seed of STEP_SEEDS: one JAX step with augment (jitted once), the
    port's step and two f64 witnesses, all from one JAX-initialised state.
    Both augments apply their apply_augment to the same fixed draws (item 0
    through the mosaic, item 1 through the crop branch) on the canvases of
    _batch(seed); JAX's runs compiled into its step, as users run it, and
    its output is recorded with jax.debug.callback.

    Why a witness: two f32 steps on such uint8-valued batches part at the
    kinks. A ReLU or leaky ReLU whose pre-activation lies within rounding
    of 0 (|x| of 2e-6 to 2e-4, max|x| ≈ 4) falls on another side in each
    f32 computation; where BN normalises over 8 to 32 values (the 2×2 and
    4×4 maps at 64 px, batch 2), one such element moves its channel's
    gradient by up to a tenth. Over seeds 15 to 22, JAX's f32 step and the
    port's f32 step took 0 to 7 kinks apart and their momenta were up to
    105 leaf tolerances apart; each was as far from the port's f64 step
    (up to 182 tolerances), and JAX's f64 mode is no witness, since its BN
    computes in f32. So each side is held to the port's step run in f64
    on that side's augmented batch with that side's own kink decisions
    (recorded per activation call, in call order: 55 a forward on both):
    the same function evaluated exactly but for where each kink fell, and
    every kink decision a side took apart from the f64 sign must lie
    within 1e-4·max|x| of 0. Measured margins over the 8 seeds: leaves
    within 0.69 of the tolerance, the port's losses within 6.1e-5 of the
    witness's, JAX's within 1.01e-4 (its f32 obj loss; hence
    JAX_LOSS_RTOL), kinks apart from the f64 sign at ≤ 3.9e-5·max|x|."""
    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu.ops import nn as jnn
    from yolo_nano_tpu.train.state import create_train_state
    from yolo_nano_tpu.train.state import make_optimizer as jopt
    from yolo_nano_tpu.train.train_step import make_train_step as jstep

    from tests.test_torch_train import jax_state_trees
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.convert import train_state_from_jax
    from yolo_nano_tpu_torch.ops import nn as tnn
    from yolo_nano_tpu_torch.train import make_optimizer, make_train_step

    base, out = 128, 64
    regions = np.tile(np.array([0, 0, 1, 1, 1], np.float32), (2, 1))
    d = _draws(2, mosaic=True, seed=16)
    d.update(mode=np.zeros_like(d["mode"]), mos_coin=np.array([True, False]),
             mos_cx=np.full(2, 0.5, np.float32),
             mos_cy=np.full(2, 0.5, np.float32))
    schedule = lambda step: 1e-3  # noqa: E731
    jcfg = JaxConfig(num_classes=20)
    params, stats = jax.jit(init_yolo_nano, static_argnums=1)(
        jax.random.key(0), jcfg)
    jtx = jopt(schedule)
    jstate0 = create_train_state(params, stats, jtx, use_ema=True)
    before = jax_state_trees(jstate0)
    batches = {}
    for seed in STEP_SEEDS:
        img, boxes, labels, _ = _batch(2, s0=base, seed=seed)
        labels[:, 0] = 3  # every item keeps a box
        batches[seed] = (img, boxes, labels, regions)
    jax_act, act, slope = jnn._activate, tnn.activate, tnn._leaky_slope
    jaugs, jkinks = [], []

    def jaug(images_u8, boxes_, labels_, regions_, key):
        batch = J.apply_augment(images_u8, boxes_, labels_, regions_,
                                _jd(d), out, mosaic=True)
        jax.debug.callback(lambda *v: jaugs.append(tuple(map(np.asarray, v))),
                           *batch, ordered=True)
        return batch

    def jact(x, act):
        if act is not None:
            jax.debug.callback(lambda v: jkinks.append(np.asarray(v)), x,
                               ordered=True)
        return jax_act(x, act)

    jfn = jstep(jcfg, jtx, out, donate=False, augment=jaug)
    cfg, tx = YoloNanoConfig(num_classes=20), make_optimizer(schedule)
    fn = make_train_step(cfg, tx, out, device="cpu",
                         augment=lambda *a: T.apply_augment(
                             *a[:4], _td(d), out, mosaic=True))
    plain = make_train_step(cfg, tx, out, device="cpu")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "_activate", jact)
        for seed, arrays in batches.items():
            inputs = [torch.from_numpy(a) for a in arrays]
            jkinks.clear(), jaugs.clear()
            jstate, jmetrics = jfn(jstate0, *arrays, jax.random.key(0))
            jax.effects_barrier()
            r = dict(jstate=jax_state_trees(jstate), jmetrics=jmetrics,
                     jax_aug=jaugs[0])

            kinks = Kinks(act, slope)
            mp.setattr(tnn, "activate", kinks)
            r["state"], r["metrics"] = fn(
                train_state_from_jax(**before, device="cpu"), *inputs,
                torch.Generator())
            mp.setattr(tnn, "activate", act)
            r["aug"] = T.apply_augment(*inputs, _td(d), out, mosaic=True)
            r["plain_state"], _ = plain(
                train_state_from_jax(**before, device="cpu"), *r["aug"])
            masks = dict(port=[x >= 0 for x in kinks.seen],
                         jax=[torch.from_numpy(x.copy()).permute(0, 3, 1, 2)
                              >= 0 for x in jkinks])
            seen = dict(port=r["aug"], jax=[torch.from_numpy(x.copy())
                                            for x in r["jax_aug"]])
            for side, m in masks.items():  # the f64 witnesses
                w = Kinks(act, slope, m)
                mp.setattr(tnn, "activate", w)
                images, *rest = seen[side]
                r[f"witness_{side}"] = plain(
                    train_state_from_jax(**before, device="cpu").to(
                        "cpu", torch.float64), images.double(), *rest)
                r[f"kinks_{side}"] = [(x.abs(), (x >= 0) != k)
                                      for x, k in zip(w.seen, m)]
            r["n_kinks"] = (len(kinks.seen), len(jkinks))
            runs[seed] = r
    return runs


@pytest.mark.parametrize("seed", STEP_SEEDS)
def test_train_step_with_augment_matches_jax(augmented_steps, seed):
    """The augmented batches agree (images within IMAGE_ATOL, boxes within
    BOX_ATOL, labels equal); JAX's step and the port's, each against the
    f64 witness with its own kink decisions, within test_torch_train's
    leaf tolerances; the kinks where a side's decision differs from the
    f64 sign lie within 1e-4 of the layer's max|x| of 0; the augmenting
    step equals the port's plain step on the augment's output bit for
    bit."""
    from tests.test_torch_train import (FIELDS, LOSS_RTOL, LOSSES,
                                        assert_field_close)
    from yolo_nano_tpu_torch.convert import flatten_tree, train_state_to_jax

    r = augmented_steps[seed]
    (gi, gb, gl), (wi, wb, wl) = r["aug"], r["jax_aug"]
    np.testing.assert_allclose(gi.numpy(), wi, rtol=0, atol=IMAGE_ATOL)
    np.testing.assert_allclose(gb.numpy(), wb, rtol=0, atol=BOX_ATOL)
    np.testing.assert_array_equal(gl.numpy(), wl)
    assert r["n_kinks"][0] == r["n_kinks"][1] == 55
    got, want = r["metrics"], r["jmetrics"]
    exact = {s: r[f"witness_{s}"][1] for s in ("port", "jax")}
    assert int(got["skipped_nonfinite"]) == int(want["skipped_nonfinite"]) \
        == int(exact["port"]["skipped_nonfinite"]) == 0
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), float(exact["port"][k]),
                                   rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(want[k]), float(exact["jax"][k]),
                                   rtol=JAX_LOSS_RTOL, err_msg=k)
    for side in ("port", "jax"):
        for x, apart in r[f"kinks_{side}"]:
            assert (x[apart] <= 1e-4 * x.max()).all(), side
    tree = train_state_to_jax(r["state"])
    witness = {s: train_state_to_jax(r[f"witness_{s}"][0])
               for s in ("port", "jax")}
    for field in FIELDS:
        flat = flatten_tree(tree[field])
        assert_field_close(flat, flatten_tree(witness["port"][field]),
                           f"port/{field}")
        assert_field_close(flatten_tree(r["jstate"][field]),
                           flatten_tree(witness["jax"][field]),
                           f"jax/{field}")
        plain = flatten_tree(train_state_to_jax(r["plain_state"])[field])
        for k, v in plain.items():  # augmenting step = plain step after it
            np.testing.assert_array_equal(flat[k], v)
    assert int(r["state"].step) == int(r["jstate"]["step"]) == 1


def test_apply_augment_refuses_bad_regions():
    img, boxes, labels, regions = map(torch.from_numpy, _batch(2, seed=17))
    with pytest.raises(ValueError, match=r"\[B,5\]"):
        T.apply_augment(img, boxes, labels, regions[:, :4],
                        _td(_draws(2)), 32)
