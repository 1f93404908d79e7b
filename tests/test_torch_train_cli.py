"""The port's training and export CLIs on the CPU, against the JAX package's.

All runs: `--device cpu`, 64 px, batch 2, the 0.5x backbone, a synthetic
VOC set of one class.

  (a) CLI against CLI: the JAX CLI from `--seed 0`, and the port CLI
      resumed from a port checkpoint of the same JAX-initialised state at
      step 0, log equal iteration-0 losses (rtol 1e-4, the training
      tests' loss tolerance): both start from the same weights on the same
      first batch (the loaders are equal bit for bit, test_torch_loader);
  (b) a multi-scale run of 4 epochs and one of 2 epochs resumed to 4 log
      the same (epoch, iter, size, step) rows, the sizes JAX's rule
      draws, and end on the same state bit for bit (the CPU ops are
      deterministic, the loader is positioned by set_epoch and the size
      stream fast-forwarded); --profile_steps writes its trace;
  (c) a run killed mid-flight resumes with --resume auto;
  (d) the eval hook predicts on the EMA weights and leaves the precision
      flags as they were; its checkpoint scores the same AP in cli.eval;
  (e) --pretrained: the port's converter equals the JAX tool's on one
      seeded torchvision-named state dict, and the CLI starts from it;
  (f) the flags that raise, --device_augment --mosaic (a run resumed
      after 1 epoch logs and ends as an uninterrupted one), --bf16's cast
      (bit for bit as ml_dtypes) and
      --tfboard's scalars (through a stand-in writer: importing
      torch.utils.tensorboard takes 15 s here);
  (g) cli.export's .npz equals JAX fold_bn (and cast_f32_to_bf16) of the
      same state, and load_predictor on it predicts as the folded model.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_voc

SIZE = 64
BACKBONE = "0.5x"
LOSS_RTOL = 1e-4
LOSSES = ("loss/total", "loss/obj", "loss/cls", "loss/bbox", "loss/iou")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(root, save, *extra, device=True):
    return (["-d", "voc", "--root", root, "--voc_sets", "2007",
             "--img_size", str(SIZE), "--eval_size", str(SIZE),
             "--batch_size", "2", "--num_workers", "1", "--backbone",
             BACKBONE, "--save_folder", str(save)]
            + (["--device", "cpu"] if device else []) + list(extra))


def _log(save):
    path = os.path.join(str(save), "voc", "yolo_nano", "train_log.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _ckpt(save):
    return os.path.join(str(save), "voc", "yolo_nano", "ckpt")


def _train(argv):
    from yolo_nano_tpu_torch.cli import train

    return train.main(argv)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's steps: they are many and small,
    and with a thread per core each op's barrier waits for threads that
    the test run's other workers have descheduled (a 15 s test took 576 s
    in a run of the whole suite on 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root, _ = make_synthetic_voc(tmp_path_factory.mktemp("voc"),
                                 classes=("dog",), n_images=4,
                                 deterministic_boxes=True)
    return root


@pytest.fixture(scope="module")
def voc22(tmp_path_factory):
    """11 iterations an epoch: one multi-scale draw per epoch, at iter 10."""
    root, _ = make_synthetic_voc(tmp_path_factory.mktemp("voc22"),
                                 classes=("dog",), n_images=22,
                                 deterministic_boxes=True)
    return root


@pytest.fixture(scope="module")
def jax_cli_log(voc, tmp_path_factory):
    """One epoch of the JAX CLI from --seed 0 (no eval): its log."""
    from yolo_nano_tpu.cli import train as jax_train

    save = tmp_path_factory.mktemp("jax_cli")
    jax_train.main(_args(voc, save, "--eval_epoch", "99", "--max_epoch", "1",
                         "--seed", "0", device=False))
    return _log(save)


@pytest.fixture(scope="module")
def ema_run(voc, tmp_path_factory):
    """One port epoch with --ema and the eval hook, watched: what the hook
    gave make_predict_fn, and the precision flags around the hook."""
    from yolo_nano_tpu_torch.cli import common
    from yolo_nano_tpu_torch.evaluation.evaluator import VOCEvaluator
    from yolo_nano_tpu_torch.models.yolo_nano import precision_flags

    seen = {}
    make, evaluate = common.make_predict_fn, VOCEvaluator.evaluate

    def make_spy(params, stats, cfg, size, **kw):
        seen.update(params=params, stats=stats, kw=kw,
                    flags_before=precision_flags())
        return make(params, stats, cfg, size, **kw)

    def evaluate_spy(self, fn):
        out = evaluate(self, fn)
        seen["flags_after"] = precision_flags()
        return out

    common.make_predict_fn, VOCEvaluator.evaluate = make_spy, evaluate_spy
    save = tmp_path_factory.mktemp("ema")
    try:
        result = _train(_args(voc, save, "--ema", "-no_wp", "--eval_epoch",
                              "1", "--max_epoch", "1"))
    finally:
        common.make_predict_fn, VOCEvaluator.evaluate = make, evaluate
    return save, result, seen


def test_iteration_0_loss_equals_the_jax_cli(voc, tmp_path, jax_cli_log):
    """(a) The same JAX-initialised state on the same first batch."""
    from yolo_nano_tpu.cli.common import build_config as jax_config
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.convert import train_state_from_jax
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    import jax

    params, stats = jax.tree.map(np.asarray, init_yolo_nano(
        jax.random.key(0), jax_config("voc", backbone=BACKBONE)))
    zeros = jax.tree.map(np.zeros_like, params)
    state = train_state_from_jax(params, stats, zeros, 0, 0)
    CheckpointManager(str(tmp_path / "init")).save(0, state)
    _train(_args(voc, tmp_path / "port", "--resume", str(tmp_path / "init"),
                 "--eval_epoch", "99", "--max_epoch", "1", "--seed", "0"))
    got, want = _log(tmp_path / "port")[0], jax_cli_log[0]
    for k in ("epoch", "iter", "step", "size", "skipped_nonfinite"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)


def _jax_rule_sizes(seed, lo, hi, img_size, epochs, epoch_size):
    """(epoch, iter, size) of the logged rows, by the JAX CLI's rule: a
    draw at every 10th iteration but the first, the size carried over
    epochs (cli/train.py:371-376)."""
    rng, size, rows = np.random.default_rng(seed), img_size, []
    for epoch in range(epochs):
        for it in range(epoch_size):
            if it % 10 == 0 and it > 0:
                size = int(rng.integers(lo, hi)) * 32
            if it % 10 == 0:
                rows.append((epoch, it, size))
    return rows


def test_resumed_multi_scale_run_equals_the_uninterrupted_one(voc22,
                                                             tmp_path):
    """(b)"""
    from yolo_nano_tpu_torch.utils.checkpoint import STATE_FILE

    ms = ["-ms", "--multi_scale_range", "2", "5", "--eval_epoch", "99",
          "--seed", "3"]
    # the uninterrupted run also writes a trace of steps 2-3, which
    # changes nothing it trains
    full = _train(_args(voc22, tmp_path / "full", *ms, "--max_epoch", "4",
                        "--profile_steps", "2"))
    _train(_args(voc22, tmp_path / "seg", *ms, "--max_epoch", "2"))
    seg = _train(_args(voc22, tmp_path / "seg", *ms, "--max_epoch", "4",
                       "--resume", "auto"))
    rows = lambda save: [(e["epoch"], e["iter"], e["size"], e["step"])  # noqa: E731
                         for e in _log(save)]
    assert rows(tmp_path / "seg") == rows(tmp_path / "full")
    want = _jax_rule_sizes(3, 2, 5, SIZE, 4, 11)
    assert [r[:3] for r in rows(tmp_path / "full")] == want
    assert len({r[2] for r in want}) > 1
    assert int(full["state"].step) == int(seg["state"].step) == 44
    run_dir = os.path.join(str(tmp_path / "full"), "voc", "yolo_nano")
    with open(os.path.join(run_dir, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    a = torch.load(os.path.join(_ckpt(tmp_path / "full"), "44", STATE_FILE))
    b = torch.load(os.path.join(_ckpt(tmp_path / "seg"), "44", STATE_FILE))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_kill_and_auto_resume(voc, tmp_path):
    """(c) A run killed (SIGKILL) after its first checkpoint resumes from
    it with --resume auto and runs to the end."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "yolo_nano_tpu_torch.cli.train"] + _args(
        voc, tmp_path / "w", "-no_wp", "--eval_epoch", "1")
    proc = subprocess.Popen(base + ["--max_epoch", "50"], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    ckpt = _ckpt(tmp_path / "w")
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.isdir(ckpt) and any(d.isdigit()
                                           for d in os.listdir(ckpt)):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("no checkpoint appeared before the kill")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    out = subprocess.run(base + ["--max_epoch", "3", "--resume", "auto"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    resumed = [int(line.split()[3]) for line in out.stdout.splitlines()
               if line.startswith("resumed @ step")]
    assert len(resumed) == 1 and resumed[0] > 0
    # 2 steps an epoch; a run killed after epoch 3 has nothing left to do
    last = max(resumed[0], 6)
    assert max(int(d) for d in os.listdir(ckpt) if d.isdigit()) == last
    assert _log(tmp_path / "w")[-1]["step"] in (last - 1, resumed[0] - 1)


def test_eval_hook_predicts_on_the_ema_weights(voc, ema_run):
    """(d)"""
    from yolo_nano_tpu_torch.cli import eval as cli_eval
    from yolo_nano_tpu_torch.convert import flatten_tree, tree_from_named
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32

    save, result, seen = ema_run
    state = result["state"]
    assert int(state.step) == 2
    given = flatten_tree(seen["params"])
    for name, want in (("ema", state.ema_params), ("raw", state.params)):
        want = flatten_tree(tree_from_named(want))
        same = all(np.array_equal(given[k], want[k]) for k in want)
        assert same == (name == "ema"), name
    stats = flatten_tree(seen["stats"])
    ema_stats = flatten_tree(tree_from_named(state.ema_stats))
    assert all(np.array_equal(stats[k], v) for k, v in ema_stats.items())
    assert seen["kw"] == {"device": torch.device("cpu")}
    assert seen["flags_before"] == seen["flags_after"] == (
        False, False, "highest")
    # its checkpoint, read by the port's eval CLI, scores the same
    ev = cli_eval.main(["-d", "voc", "--root", voc, "--weight", _ckpt(save),
                        "--ema", "--img_size", str(SIZE), "--backbone",
                        BACKBONE, "--device", "cpu"])
    hook = result["evaluator"]
    assert hook.aps.keys() == ev.aps.keys()
    assert all(hook.aps[k] == ev.aps[k] for k in ev.aps)
    assert hook.map == ev.map
    set_full_f32()


def test_eval_hook_raises_when_predict_changes_the_flags(voc, tmp_path,
                                                         monkeypatch):
    """(d) The guard: a predict that leaves TF32 on stops the run."""
    from yolo_nano_tpu_torch.models import yolo_nano

    predict = yolo_nano.predict

    def predict_tf32(*a, **kw):
        out = predict(*a, **kw)
        torch.backends.cudnn.allow_tf32 = True
        return out

    monkeypatch.setattr(yolo_nano, "predict", predict_tf32)
    try:
        with pytest.raises(RuntimeError, match="precision flags"):
            _train(_args(voc, tmp_path, "--eval_epoch", "1", "--max_epoch",
                         "1"))
    finally:
        yolo_nano.set_full_f32()


def _torchvision_shufflenet(rng, widths, repeats=(4, 8, 4)):
    """A state dict in torchvision's shufflenet_v2 naming (conv1, stage2-4
    of InvertedResidual blocks), drawn from `rng`."""
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = rng.normal(0, 0.1, (cout, cin, k, k)).astype(
            np.float32)

    def bn(key, c):
        sd[key + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[key + ".bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[key + ".running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[key + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
        sd[key + ".num_batches_tracked"] = np.array(7)

    conv("conv1.0", widths[0], 3, 3)
    bn("conv1.1", widths[0])
    cin = widths[0]
    for si, (cout, n) in enumerate(zip(widths[1:4], repeats), start=2):
        half = cout // 2
        for bi in range(n):
            base = f"stage{si}.{bi}.branch"
            if bi == 0:
                conv(base + "1.0", cin, 1, 3)
                bn(base + "1.1", cin)
                conv(base + "1.2", half, cin, 1)
                bn(base + "1.3", half)
            conv(base + "2.0", half, cin if bi == 0 else half, 1)
            bn(base + "2.1", half)
            conv(base + "2.3", half, 1, 3)
            bn(base + "2.4", half)
            conv(base + "2.5", half, half, 1)
            bn(base + "2.6", half)
        cin = cout
    return sd


def test_pretrained_backbone(voc, tmp_path, capsys):
    """(e)"""
    from yolo_nano_tpu_torch.config import SHUFFLENETV2_CHANNELS
    from yolo_nano_tpu_torch.convert import flatten_tree, tree_from_named
    from yolo_nano_tpu_torch.tools import convert_shufflenetv2 as conv
    from yolo_nano_tpu_torch.utils.checkpoint import STATE_FILE

    from tools.convert_torch_shufflenetv2 import convert as jax_convert

    sd = _torchvision_shufflenet(np.random.default_rng(0),
                                 SHUFFLENETV2_CHANNELS[BACKBONE])
    got, want = conv.convert(sd, BACKBONE), jax_convert(sd, BACKBONE)
    for g, w in zip(got, want):
        g, w = flatten_tree(g), flatten_tree(w)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with pytest.raises(ValueError, match="not a 1.0x checkpoint"):
        conv.convert(sd, "1.0x")

    path = str(tmp_path / "backbone.npz")
    conv.save(path, *got, BACKBONE)
    _train(_args(voc, tmp_path / "w", "--pretrained", path, "--max_epoch",
                 "0"))
    assert f"loaded pretrained backbone from {path}" in capsys.readouterr(
    ).out
    flat = torch.load(os.path.join(_ckpt(tmp_path / "w"), "0", STATE_FILE))
    for field, tree in (("params", got[0]), ("stats", got[1])):
        named = {k.split("/", 1)[1]: v for k, v in flat.items()
                 if k.startswith(field + "/backbone.")}
        loaded = flatten_tree(tree_from_named(named)["backbone"])
        want = flatten_tree(tree)
        assert loaded.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="not a backbone tree"):
        conv.load(path, "1.0x")


def test_flags_that_raise_and_bf16(voc, tmp_path, monkeypatch):
    """(f)"""
    import ml_dtypes

    from yolo_nano_tpu_torch import train as train_pkg
    from yolo_nano_tpu_torch.data.loader import DetectionLoader
    from yolo_nano_tpu_torch.data.voc import VOCDataset

    # --device_augment --mosaic: 2 steps an epoch, the augmentation in the
    # step; 1 epoch resumed to 2 logs what 2 uninterrupted epochs log and
    # ends on the same state bit for bit
    aug = ("--device_augment", "--mosaic", "--eval_epoch", "99")
    whole = _train(_args(voc, tmp_path / "aug_whole", *aug, "--max_epoch",
                         "2"))
    _train(_args(voc, tmp_path / "aug_resumed", *aug, "--max_epoch", "1"))
    resumed = _train(_args(voc, tmp_path / "aug_resumed", *aug,
                           "--max_epoch", "2", "--resume", "auto"))
    rows = [r for r in _log(tmp_path / "aug_whole") if r["epoch"] == 1]
    assert rows and rows == [r for r in _log(tmp_path / "aug_resumed")
                             if r["epoch"] == 1]
    assert rows[0]["step"] == 3 and np.isfinite(rows[0]["loss/total"])
    assert whole["images"] == 8 and resumed["images"] == 4
    from yolo_nano_tpu_torch.convert import flatten_tree, train_state_to_jax

    for field, tree in train_state_to_jax(whole["state"]).items():
        if isinstance(tree, dict):
            got = flatten_tree(train_state_to_jax(resumed["state"])[field])
            for k, v in flatten_tree(tree).items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the JAX CLI's refusals: --coordinator without --num_processes, and a
    # global batch that does not divide over the processes
    with pytest.raises(SystemExit, match="--num_processes"):
        _train(_args(voc, tmp_path, "--coordinator", "localhost:1234"))
    with pytest.raises(SystemExit, match="divisible"):
        _train(_args(voc, tmp_path, "--coordinator", "localhost:1234",
                     "--num_processes", "4", "--process_id", "0"))
    with pytest.raises(SystemExit):
        _train(_args(voc, tmp_path, "-ms", "--multi_scale_range", "5", "5"))
    if not torch.cuda.is_available():  # CUDA unless --device says otherwise
        from yolo_nano_tpu_torch.cli import export

        with pytest.raises(RuntimeError, match="no CUDA device"):
            _train(_args(voc, tmp_path, device=False))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.main(["--weight", str(tmp_path), "--out",
                         str(tmp_path / "a.npz")])

    # the cast rounds to nearest even, as ml_dtypes does, on every kind of
    # value: ties, subnormals, infinities and NaN
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 3, 4096).astype(np.float32),
        np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1e-40,
                  -1e-42, np.inf, -np.inf, 3.4e38, 0.0, -0.0], np.float32)])
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)  # noqa: E731
    np.testing.assert_array_equal(
        bits(torch.from_numpy(x).to(torch.bfloat16)),
        x.astype(ml_dtypes.bfloat16).view(np.uint16))
    nan = torch.tensor([np.nan]).to(torch.bfloat16)
    assert torch.isnan(nan).all()

    # and a --bf16 run's first step takes the first batch so cast
    seen = []
    make = train_pkg.make_train_step

    def make_spy(*a, **kw):
        step = make(*a, **kw)

        def spy(state, images, boxes, labels):
            seen.append(images)
            return step(state, images, boxes, labels)
        return spy

    monkeypatch.setattr(train_pkg, "make_train_step", make_spy)
    scalars = []

    class Writer:
        def __init__(self, logdir):
            scalars.append(logdir)

        def add_scalar(self, tag, value, step):
            scalars.append((tag, step))

        def close(self):
            scalars.append("closed")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        type(sys)("torch.utils.tensorboard"))
    sys.modules["torch.utils.tensorboard"].SummaryWriter = Writer
    _train(_args(voc, tmp_path, "--bf16", "--eval_epoch", "99",
                 "--max_epoch", "1", "--tfboard"))
    assert scalars == [os.path.join(str(tmp_path), "voc", "yolo_nano", "tb"),
                       ("obj loss", 0), ("cls loss", 0), ("box loss", 0),
                       ("iou loss", 0), "closed"]
    ds = VOCDataset(voc, img_size=SIZE, image_sets=[("2007", "trainval")])
    first = next(iter(DetectionLoader(ds, 2, num_workers=1, seed=0)))[0]
    assert len(seen) == 2 and seen[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bits(seen[0]), first.astype(ml_dtypes.bfloat16).view(np.uint16))
    log = _log(tmp_path)
    assert np.isfinite(log[0]["loss/total"]) and log[0]["step"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_equals_the_jax_fold(ema_run, tmp_path, dtype):
    """(g)"""
    import jax

    from yolo_nano_tpu.utils.fuse_bn import cast_f32_to_bf16 as jax_cast
    from yolo_nano_tpu.utils.fuse_bn import fold_bn as jax_fold
    from yolo_nano_tpu_torch.cli import export
    from yolo_nano_tpu_torch.convert import (flatten_tree, load_npz,
                                             model_from_state,
                                             train_state_to_jax)
    from yolo_nano_tpu_torch.serving import load_predictor, predictor
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    save, result, _ = ema_run
    state, cfg = result["state"], result["cfg"]
    path = export.main(["--weight", _ckpt(save), "--out",
                        str(tmp_path / "a"), "--ema", "--backbone", BACKBONE,
                        "--img_size", str(SIZE), "--dtype", dtype,
                        "--no_stablehlo", "--device", "cpu"])
    assert path.endswith(".npz")
    tree, meta = load_npz(path)
    assert meta["dtype"] == dtype and meta["folded"] and \
        meta["img_size"] == SIZE and meta["dataset"] == "voc"
    js = train_state_to_jax(state)
    want = jax_fold(js["ema_params"], js["ema_stats"])
    if dtype == "bfloat16":
        want = jax_cast(want)
    want = flatten_tree(jax.tree.map(np.asarray, want))
    got = flatten_tree(tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if dtype == "bfloat16":
            g = g.view(torch.int16).numpy().view(np.uint16)
            w = w.view(np.uint16)
        np.testing.assert_array_equal(g, w, err_msg=k)

    fn = load_predictor(path, device="cpu")
    model = fold_bn(model_from_state(state, cfg, ema=True))
    if dtype == "bfloat16":
        model = cast_f32_to_bf16(model)
    plain = predictor(model, cfg, SIZE, torch.device("cpu"), dtype)
    x = np.random.default_rng(4).normal(size=(2, SIZE, SIZE, 3)).astype(
        np.float32)
    out = fn(x)
    assert out[3].sum() > 0
    for g, w in zip(out, plain(x)):
        np.testing.assert_array_equal(g, w)
