"""Port parity of the schedule, the optimizer and the EMA against the JAX
package, and the full-state checkpoint, on the CPU.

Tolerances: the schedule rtol 1e-6 at the JAX package's own test points
(and exactly 0 at step 0); the optimizer after three steps rtol 1e-6 (the
same f32 operations in the same order); EMA decay rtol 1e-6. A checkpoint
restored mid-run reproduces the uninterrupted run bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu_torch.config import YoloNanoConfig
from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
from yolo_nano_tpu_torch.train import (create_train_state, make_optimizer,
                                       make_train_step, warmup_step_schedule)
from yolo_nano_tpu_torch.train.state import ema_decay, ema_update
from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

SCHEDULE_POINTS = (0, 1, 100, 199, 200, 8999, 9000, 11999, 12000, 20000)


def test_schedule_matches_jax():
    from yolo_nano_tpu.train.schedule import warmup_step_schedule as jsched

    kw = dict(epoch_size=100, wp_epochs=2, lr_epochs=(90, 120))
    sched, jsch = warmup_step_schedule(1e-3, **kw), jsched(1e-3, **kw)
    steps = torch.tensor(SCHEDULE_POINTS, dtype=torch.int32)
    got = sched(steps).numpy()
    want = np.asarray([float(jsch(s)) for s in SCHEDULE_POINTS])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0
    np.testing.assert_allclose(got[[2, 4, 5, 6, 8]],
                               [1e-3 * 0.5 ** 4, 1e-3, 1e-3, 1e-4, 1e-5],
                               rtol=1e-6)
    nowarm = warmup_step_schedule(1e-3, warmup=False, **kw)
    assert float(nowarm(torch.tensor(0))) == pytest.approx(1e-3)


def test_optimizer_three_steps_match_jax():
    """Every parameter decays (BN scale and bias included), the momentum
    starts from zeros, the lr follows the count of accepted updates."""
    import optax

    from yolo_nano_tpu.train.schedule import warmup_step_schedule as jsched
    from yolo_nano_tpu.train.state import make_optimizer as jopt

    rng = np.random.default_rng(0)
    names = ("conv.weight", "conv.bn_scale", "conv.bn_bias", "head.bias")
    params = {k: rng.normal(size=(4, 3)).astype(np.float32) for k in names}
    grads = [{k: rng.normal(size=(4, 3)).astype(np.float32) for k in names}
             for _ in range(3)]
    kw = dict(base_lr=0.1, epoch_size=1, wp_epochs=2, lr_epochs=(2,))

    jtx = jopt(jsched(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tx = make_optimizer(warmup_step_schedule(**kw))
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    trace, count = tx.init(p)
    for g in grads:
        updates, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        p, trace = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                             p, trace, count)
        count = count + 1
    assert int(count) == int(jstate[2].count) == 3
    for k in names:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(trace[k].numpy(),
                                   np.asarray(jstate[1].trace[k]), rtol=1e-6,
                                   err_msg=k)


def test_optimizer_matches_torch_sgd():
    """The update is torch.optim.SGD(momentum 0.9, weight_decay 5e-4)."""
    w0 = torch.tensor([1.0, -2.0, 0.5])
    g = torch.tensor([0.5, 0.25, -1.0])
    tw = w0.clone().requires_grad_(True)
    opt = torch.optim.SGD([tw], lr=0.1, momentum=0.9, weight_decay=5e-4)
    tx = make_optimizer(lambda count: 0.1)
    p = {"w": w0.clone()}
    trace, count = tx.init(p)
    for _ in range(3):
        tw.grad = g.clone()
        opt.step()
        p, trace = tx.update({"w": g}, p, trace, count)
    torch.testing.assert_close(p["w"], tw.detach(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [1, 2, 100, 2000, 100000])
def test_ema_decay_and_update_match_jax(step):
    from yolo_nano_tpu.train.state import ema_decay as jdecay
    from yolo_nano_tpu.train.state import ema_update as jupdate

    d = ema_decay(torch.tensor(step, dtype=torch.int32))
    jd = jdecay(jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(float(d), float(jd), rtol=1e-6)
    rng = np.random.default_rng(step)
    ema, new = (rng.normal(size=(5,)).astype(np.float32) for _ in range(2))
    got = ema_update({"a": torch.from_numpy(ema)}, {"a": torch.from_numpy(new)},
                     d)["a"].numpy()
    want = np.asarray(jupdate({"a": jnp.asarray(ema)}, {"a": jnp.asarray(new)},
                              jd)["a"])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _checkpoint_run():
    from tests.test_torch_train import tiny_batch

    cfg = YoloNanoConfig(num_classes=20, backbone="0.5x")
    tx = make_optimizer(warmup_step_schedule(1e-3, epoch_size=1, wp_epochs=1))
    fn = make_train_step(cfg, tx, 64, device="cpu")
    batch = [torch.from_numpy(a) for a in tiny_batch(seed=7)]

    def fresh(seed):
        model = init_yolo_nano(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")
        return create_train_state(model, tx, use_ema=True)

    return fresh, fn, batch


def test_checkpoint_restore_mid_run_is_bit_identical(tmp_path):
    fresh, fn, batch = _checkpoint_run()
    state = fresh(0)
    for _ in range(4):
        state, _ = fn(state, *batch)
    straight = state.flat()

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = fresh(0)
    for _ in range(2):
        state, _ = fn(state, *batch)
    mgr.save(2, state)
    del state
    resumed = mgr.restore(fresh(1))
    assert int(resumed.step) == 2 and int(resumed.count) == 2
    for _ in range(2):
        resumed, _ = fn(resumed, *batch)
    got = resumed.flat()
    assert got.keys() == straight.keys()
    for k, v in straight.items():
        assert torch.equal(got[k], v), k


def test_checkpoint_retention_and_template_checks(tmp_path):
    fresh, _, _ = _checkpoint_run()
    state = fresh(0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, state)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    got = mgr.restore(fresh(1), step=3)
    for k, v in state.flat().items():
        assert torch.equal(got.flat()[k], v), k
    model = init_yolo_nano(torch.Generator().manual_seed(2),
                           YoloNanoConfig(num_classes=20, backbone="0.5x"),
                           device="cpu")
    no_ema = create_train_state(model, make_optimizer(lambda count: 1e-3))
    with pytest.raises(ValueError):
        mgr.restore(no_ema)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)
