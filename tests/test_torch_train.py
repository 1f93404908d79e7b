"""Port parity of the training step against the JAX package, on the CPU.

Both sides start from one JAX-initialised state (1.0x backbone, 20 classes,
64 px, batch 2, EMA on) and take three steps on one batch with a schedule
that passes warmup (lr exactly 0 at step 0), warmup and a decay. The port
takes each step from the JAX state before it, carried across by
`convert.train_state_from_jax`, so that each step is compared alone: two
free-running f32 trajectories of this model part within three steps on
their own. At 64 px stage 4 is 2×2, so its BNs normalise over 8 values, and
a rounding difference of 1e-4 in a gradient becomes a difference of
several percent in the next step's gradient, for JAX's f32 against f64 as
much as for the port against JAX.

Tolerances:
  * the four losses of every step: rtol 1e-4;
  * every leaf of params, BN stats, momentum and EMA after every step:
    max|port − JAX| ≤ 1e-3·max|JAX leaf| + atol, atol = max(1e-5,
    5e-7·max|JAX field|). The field term is for the gradient sums of the
    momentum, whose rounding noise scales with the largest gradient (1.2e3,
    a backbone 1×1 weight): a BN bias followed linearly by another
    train-mode BN has an exact gradient of 0 and holds noise of 3e-5 on
    both sides, and the two sides' gradients of smooth2/w, a leaf of
    2e-3, differ by 1.9e-4 (1.6e-7 of the field);
  * the NaN guard: every tensor of the state bit-identical;
  * the trained state, folded and run through predict on both sides: the
    same valid masks and classes, boxes and scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
from yolo_nano_tpu_torch.config import YoloNanoConfig
from yolo_nano_tpu_torch.convert import (flatten_tree, model_from_state,
                                         train_state_from_jax,
                                         train_state_to_jax)
from yolo_nano_tpu_torch.train import (make_optimizer, make_train_step,
                                       warmup_step_schedule)

SIZE = 64
STEPS = 3
LOSS_RTOL = 1e-4
LEAF_RTOL, LEAF_ATOL, FIELD_ATOL = 1e-3, 1e-5, 5e-7
FIELDS = ("params", "stats", "trace", "ema_params", "ema_stats")
LOSSES = ("loss/total", "loss/obj", "loss/cls", "loss/bbox", "loss/iou")


def tiny_batch(b=2, m=6, size=SIZE, seed=0):
    """Images U(−1, 1) and m gt slots per image, the last two padding."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    x1 = rng.uniform(0.0, 0.6, (b, m))
    y1 = rng.uniform(0.0, 0.6, (b, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.1, 0.4, (b, m)),
                      y1 + rng.uniform(0.1, 0.4, (b, m))], -1)
    labels = rng.integers(0, 20, (b, m)).astype(np.int32)
    labels[:, -2:] = -1
    return images, np.clip(boxes, 0, 1).astype(np.float32), labels


def jax_state_trees(state):
    """A JAX TrainState → the keyword arguments of train_state_from_jax."""
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params=np_tree(state.params), stats=np_tree(state.stats),
                trace=np_tree(state.opt_state[1].trace),
                count=np.asarray(state.opt_state[2].count),
                step=np.asarray(state.step),
                ema_params=np_tree(state.ema_params),
                ema_stats=np_tree(state.ema_stats))


def schedule_args():
    return dict(base_lr=1e-2, epoch_size=1, wp_epochs=2, lr_epochs=(2,))


def assert_field_close(got: dict, want: dict, what: str):
    """Every leaf of one field within the module's leaf tolerance."""
    assert got.keys() == want.keys()
    atol = max(LEAF_ATOL, FIELD_ATOL * max(np.abs(w).max()
                                           for w in want.values()))
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        tol = LEAF_RTOL * np.abs(w).max() + atol
        assert err <= tol, f"{what}/{k}: max abs err {err:.3g} > {tol:.3g}"


@pytest.fixture(scope="module")
def runs():
    """Three JAX steps, and the port's step from each JAX state before."""
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu.train.schedule import warmup_step_schedule as jsched
    from yolo_nano_tpu.train.state import create_train_state
    from yolo_nano_tpu.train.state import make_optimizer as jopt
    from yolo_nano_tpu.train.train_step import make_train_step as jstep

    jcfg = JaxConfig(num_classes=20)
    cfg = YoloNanoConfig(num_classes=20)
    params, stats = init_yolo_nano(jax.random.key(0), jcfg)
    jtx = jopt(jsched(**schedule_args()))
    jstate = create_train_state(params, stats, jtx, use_ema=True)
    images, boxes, labels = tiny_batch()
    jfn = jstep(jcfg, jtx, SIZE, donate=False)
    jstates, jlosses = [jax_state_trees(jstate)], []
    for _ in range(STEPS):
        jstate, metrics = jfn(jstate, jnp.asarray(images), jnp.asarray(boxes),
                              jnp.asarray(labels))
        jstates.append(jax_state_trees(jstate))
        jlosses.append({k: float(v) for k, v in metrics.items()})

    tx = make_optimizer(warmup_step_schedule(**schedule_args()))
    fn = make_train_step(cfg, tx, SIZE, device="cpu")
    args = (torch.from_numpy(images), torch.from_numpy(boxes),
            torch.from_numpy(labels))
    states, losses = [], []
    for before in jstates[:-1]:
        state, metrics = fn(train_state_from_jax(**before, device="cpu"),
                            *args)
        states.append(state)
        losses.append({k: float(v) for k, v in metrics.items()})
    return dict(jstate=jstate, jstates=jstates, jlosses=jlosses,
                states=states, losses=losses, fn=fn, args=args)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_losses_match_jax(runs, step):
    got, want = runs["losses"][step], runs["jlosses"][step]
    assert got["skipped_nonfinite"] == want["skipped_nonfinite"] == 0
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=f"step {step} {k}")


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("field", FIELDS)
def test_train_state_leaves_match_jax(runs, field, step):
    got = flatten_tree(train_state_to_jax(runs["states"][step])[field])
    want = flatten_tree(runs["jstates"][step + 1][field])
    assert_field_close(got, want, f"step {step} {field}")


@pytest.mark.parametrize("step", range(STEPS))
def test_train_state_counts_match_jax(runs, step):
    got = train_state_to_jax(runs["states"][step])
    want = runs["jstates"][step + 1]
    assert got["step"] == int(want["step"]) == step + 1
    assert got["count"] == int(want["count"]) == step + 1


def test_first_step_at_zero_lr_leaves_params_and_moves_momentum(runs):
    """Warmup gives lr exactly 0 at step 0: the parameters stay bit for bit,
    while the momentum takes the first gradient (plus 5e-4·p)."""
    state0 = train_state_from_jax(**runs["jstates"][0], device="cpu")
    state1 = runs["states"][0]
    for k, v in state0.params.items():
        assert torch.equal(state1.params[k], v), k
    assert all(torch.equal(v, torch.zeros_like(v))
               for v in state0.trace.values())
    assert any(not torch.equal(v, torch.zeros_like(v))
               for v in state1.trace.values())


def test_nan_guard_keeps_every_tensor(runs):
    state = runs["states"][-1]
    images, boxes, labels = runs["args"]
    bad = images.clone()
    bad[0, 0, 0, 0] = float("nan")
    new, metrics = runs["fn"](state, bad, boxes, labels)
    assert int(metrics["skipped_nonfinite"]) == 1
    assert not np.isfinite(float(metrics["loss/total"]))
    before, after = state.flat(), new.flat()
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k


@pytest.mark.parametrize("ema", [False, True])
def test_trained_state_folded_predict_matches_jax(runs, ema):
    """The state after three JAX steps, folded on each side (JAX fold_bn on
    the trees, the port's on its modules) and run through predict."""
    from yolo_nano_tpu.models.yolo_nano import predict as jpredict
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like
    from yolo_nano_tpu.utils.fuse_bn import fold_bn as jfold
    from yolo_nano_tpu_torch.models.yolo_nano import predict
    from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn

    js = runs["jstate"]
    jparams = jfold(*((js.ema_params, js.ema_stats) if ema
                      else (js.params, js.stats)))
    images = tiny_batch(b=2, seed=1)[0]
    jcfg = JaxConfig(num_classes=20, conf_thresh=0.0005)
    want = jpredict(jparams, empty_stats_like(jparams), jnp.asarray(images),
                    jcfg, SIZE)
    cfg = YoloNanoConfig(num_classes=20, conf_thresh=0.0005)
    state = train_state_from_jax(**runs["jstates"][-1], device="cpu")
    model = fold_bn(model_from_state(state, cfg, ema=ema))
    got = predict(model, torch.from_numpy(images), cfg, SIZE)
    (gb, gs, gc, gv), (wb, ws, wc, wv) = (
        [np.asarray(t) for t in got], [np.asarray(t) for t in want])
    assert wv.sum() > 0
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gc[wv], wc[wv])
    np.testing.assert_allclose(gs[wv], ws[wv], atol=1e-4)
    np.testing.assert_allclose(gb[wv], wb[wv], atol=1e-4)


def test_state_round_trips_through_jax_layout(runs):
    state = runs["states"][-1]
    back = train_state_from_jax(**train_state_to_jax(state), device="cpu")
    for k, v in state.flat().items():
        assert torch.equal(back.flat()[k], v), k
