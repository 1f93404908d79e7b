"""Shared fixtures of the benchmark's own tests (`python -m pytest
benchmark/`): a throwaway checkout holding a copy of the benchmark, the
program linked in, and small cells added as new files and entries only."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 64  # px of the throwaway cells


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small_artifact(src: str, dst: str, size: int) -> str:
    """The artifact's weights with its meta set to `size` px -> sha256."""
    import hashlib

    with np.load(src, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["config.json"]))
    meta["img_size"] = size
    arrays["config.json"] = np.array(json.dumps(meta, sort_keys=True))
    np.savez(dst, **arrays)
    with open(dst, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def add_cell(root: str, name: str, base_workload: str, traffic: dict,
             limits=None, size: int = SMALL) -> None:
    """A new configuration (the base's at `size` px) and a new workload
    that uses it, as new files and new BENCHMARK.json entries."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    base = json.load(open(os.path.join(root, "benchmark", "workloads",
                                       f"{base_workload}.json")))
    cfg_name = f"{name}-cfg"
    cfg = json.load(open(os.path.join(root, "benchmark", "configs",
                                      f"{base['config']}.json")))
    artifact = f"{cfg_name}.npz"
    cfg.update(name=cfg_name, img_size=size, artifact=artifact,
               artifact_sha256=small_artifact(
                   os.path.join(root, cfg["artifact"]),
                   os.path.join(root, artifact), size))
    with open(os.path.join(root, "benchmark", "configs",
                           f"{cfg_name}.json"), "w") as f:
        json.dump(cfg, f)
    base.update(name=name, config=cfg_name,
                traffic={**base["traffic"], **traffic})
    if limits:
        base["limits"] = limits
    with open(os.path.join(root, "benchmark", "workloads",
                           f"{name}.json"), "w") as f:
        json.dump(base, f)
    spec["configs"].append({"name": cfg_name, "source": cfg["source"],
                            "file": f"benchmark/configs/{cfg_name}.json",
                            "reduced": ["img_size"], "why": "a test"})
    spec["workloads"].append({"name": name, "config": cfg_name,
                              "traffic": name, "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if base_workload in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


@pytest.fixture
def checkout(tmp_path):
    """A throwaway checkout: BENCHMARK.json, a copy of benchmark/, and the
    program linked in."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "yolo_nano_tpu_torch"),
               root / "yolo_nano_tpu_torch")
    return str(root)


def run_cell(root: str, argv, setup: str = "", timeout: float = 240):
    """benchmark/run.py's main on the CPU in a fresh process of `root`,
    after `setup` (Python that may break the program) -> (returncode,
    stdout, stderr, the last stdout line as JSON or None)."""
    code = (f"import sys; sys.path[0] = {root!r}\n{setup}\n"
            f"from benchmark import run\n"
            f"sys.exit(run.main({list(argv)!r}, device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return p.returncode, p.stdout, p.stderr, last
