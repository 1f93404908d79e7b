"""Multi-process training through the port's CLI, on the CPU.

Two processes of `python -m yolo_nano_tpu_torch.cli.train --device cpu
--coordinator ...` (a gloo group) against one process without
--coordinator, on a tiny synthetic VOC set: 0.5x backbone, 64 px, global
batch 4, lr 0, the in-graph augment with mosaic (its draws made for the
global batch, the canvases gathered for the mosaic), as the JAX package's
tests/test_multiprocess_cli.py holds its multi-controller CLI. With lr 0
the params stay where they started, so the logged losses pin the data
stream, the eval mAP the sharded eval, the BN running stats the sync-BN,
and the momentum (the accumulated gradients) the gradient all-reduce:
  * the logged losses within rtol 1e-5, the eval mAP within 1e-6, and
    rank 1 prints no "Mean AP";
  * the checkpoint's params bit-identical, its BN stats within rtol 1e-4;
  * its momentum's global norm within 2% and its cosine above 0.99 (a
    wrong all-reduce factor is an n× norm, a misrouted row a turned
    direction; per leaf, the traces of biases that feed a BN are pure
    rounding residue);
  * --resume auto on 2 processes continues from rank 0's checkpoint.

Each process runs with one intra-op thread (OMP_NUM_THREADS=1) and a
60 s group timeout (--dist_timeout); each run has a join timeout, and the
two-process runs take a free TCP port, once more only if it was taken.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 60


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO  # drops any sitecustomize
    env["OMP_NUM_THREADS"] = "1"
    return env


def _train_args(root: str, save: str, *extra) -> list:
    return [sys.executable, "-m", "yolo_nano_tpu_torch.cli.train",
            "--device", "cpu", "-d", "voc", "--root", root,
            "--voc_sets", "2007", "--img_size", "64", "--eval_size", "64",
            "--batch_size", "4", "--max_epoch", "2", "--eval_epoch", "2",
            "--num_workers", "1", "--backbone", "0.5x", "--lr", "0",
            "--no_warm_up", "--device_augment", "--mosaic", "--seed", "0",
            "--dist_timeout", str(GROUP_TIMEOUT_S),
            "--save_folder", save] + list(extra)


def _run(args):
    out = subprocess.run(args, env=_env(), cwd=REPO, capture_output=True,
                         text=True, timeout=JOIN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(args, n: int = 2, attempts: int = 2) -> list:
    """The CLI as n processes of one group → their stdouts. A second
    attempt, on another port, only if the first port was taken."""
    for attempt in range(attempts):
        port = _free_port()
        procs = [subprocess.Popen(
            args + ["--coordinator", f"127.0.0.1:{port}",
                    "--num_processes", str(n), "--process_id", str(pid)],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for pid in range(n)]
        try:
            outs = [p.communicate(timeout=JOIN_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if all(p.returncode == 0 for p in procs):
            return [so for so, _ in outs]
        taken = any("address already in use" in se.lower()
                    for _, se in outs)
        if not (taken and attempt < attempts - 1):
            for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
                assert p.returncode == 0, (
                    f"process {pid} failed:\n{so[-2000:]}\n{se[-3000:]}")


def _read_log(save: str) -> list:
    path = os.path.join(save, "voc", "yolo_nano", "train_log.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _ckpt(save: str, step=None) -> tuple:
    d = os.path.join(save, "voc", "yolo_nano", "ckpt")
    step = max(int(s) for s in os.listdir(d) if s.isdigit()) \
        if step is None else step
    return step, torch.load(os.path.join(d, str(step), "state.pt"),
                            weights_only=True)


def _mean_ap(stdout: str) -> float:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("Mean AP")]
    assert lines, f"no eval output in:\n{stdout[-2000:]}"
    return float(lines[-1].split("=")[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, then two; → (root, single save dir and stdout, the
    two-process save dir and stdouts)."""
    tmp = tmp_path_factory.mktemp("mp_cli")
    root, _ = make_synthetic_voc(tmp / "voc", n_images=8)
    single = str(tmp / "single")
    out_single = _run(_train_args(root, single))
    multi = str(tmp / "multi")
    outs = _run_ranks(_train_args(root, multi))
    return root, (single, out_single), (multi, outs)


def test_two_processes_log_and_evaluate_as_one(runs):
    _, (single, out_single), (multi, outs) = runs
    log_single, log_multi = _read_log(single), _read_log(multi)
    assert len(log_single) == len(log_multi) > 0
    for a, b in zip(log_single, log_multi):
        assert (a["epoch"], a["iter"], a["step"]) == (b["epoch"], b["iter"],
                                                      b["step"])
        for k in ("loss/total", "loss/obj", "loss/cls", "loss/bbox",
                  "loss/iou"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    assert _mean_ap(outs[0]) == pytest.approx(_mean_ap(out_single), abs=1e-6)
    assert "data-parallel over 2 processes" in outs[0]
    assert "Mean AP" not in outs[1] and outs[1] == ""


def test_two_processes_checkpoint_as_one(runs):
    _, (single, _), (multi, _) = runs
    (step_s, flat_s), (step_m, flat_m) = _ckpt(single), _ckpt(multi)
    assert step_s == step_m == 4
    assert flat_s.keys() == flat_m.keys()
    for k, v in flat_s.items():
        if k.startswith("params/") or k in ("count", "step"):
            assert torch.equal(v, flat_m[k]), k
        elif k.startswith("stats/"):
            np.testing.assert_allclose(flat_m[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    a, b = (torch.cat([f[k].double().ravel() for k in sorted(f)
                       if k.startswith("trace/")]) for f in (flat_s, flat_m))
    na, nb = a.norm().item(), b.norm().item()
    assert abs(na - nb) <= 0.02 * na, (na, nb)
    cos = (a @ b).item() / (na * nb)
    assert cos > 0.99, cos


def test_two_processes_resume(runs, tmp_path):
    """--resume auto on 2 processes: both restore rank 0's step-4
    checkpoint, train epochs 2 and 3 and checkpoint at step 8; lr 0 keeps
    the params bit for bit, the BN stats move."""
    import shutil

    root, _, (multi, _) = runs
    save = str(tmp_path / "resumed")
    shutil.copytree(multi, save)
    args = _train_args(root, save)
    args[args.index("--max_epoch") + 1] = "4"
    outs = _run_ranks(args + ["--resume", "auto"])
    assert "resumed @ step 4 (epoch 2)" in outs[0], outs[0][-2000:]
    assert [e["epoch"] for e in _read_log(save)] == [0, 1, 2, 3]
    assert "Mean AP" in outs[0]
    (step, flat8), (_, flat4) = _ckpt(save), _ckpt(save, 4)
    assert step == 8
    for k, v in flat4.items():
        if k.startswith("params/"):
            assert torch.equal(v, flat8[k]), k
    assert any(not torch.equal(v, flat8[k]) for k, v in flat4.items()
               if k.startswith("stats/"))
