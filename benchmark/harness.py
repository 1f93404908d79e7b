"""What every cell shares: finding a cell's files by name, the device's
description, the per-layer metrics' readers, the check that the run loaded
nothing of JAX, and the result line.

A cell is found by its name alone: `BENCHMARK.json` names its workload,
whose file `benchmark/workloads/<name>.json` names its configuration
(`benchmark/configs/<config>.json`), its driver (`benchmark/drivers/
<kind>.py`) and its traffic; a per-layer metric is read by
`benchmark/metrics/<metric>.py`, or, where there is no such file, by the
reader of its name up to the first dot (`device_idle_pct.py` reads
`device_idle_pct.detect` and `device_idle_pct.train`). Adding any of them
adds files and entries and edits none. What is not traffic (warm-up
batches, batches checked, seconds traced) is a constant of the driver.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_nano_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: List[dict]  # this cell's entries of BENCHMARK.json
    per_layer: List[dict]
    root: str

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(entries)}")
    workload = _read_json(os.path.join(root, "benchmark", "workloads",
                                       f"{name}.json"))
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(os.path.join(root, configs[workload["config"]]["file"]))

    def here(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (here(m) if "workloads" in m else m["moves"] in reported)]
    return Cell(name, workload, config, e2e, layer, root)


def check_artifact(cell: Cell) -> str:
    """The configuration's artifact, refused unless its sha256 is the one
    the configuration pins."""
    path = cell.path(cell.config["artifact"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != cell.config["artifact_sha256"]:
        raise SystemExit(f"{path}: sha256 {digest}, the configuration pins "
                         f"{cell.config['artifact_sha256']}")
    return path


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.workload['kind']}")


def reader(name: str) -> Callable:
    """The per-layer metric's reader: `metrics/<name>.py`, else the one of
    its name up to the first dot."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = os.path.join(BENCH, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return load_module(path, "bench_metric_" +
                               stem.replace(".", "_")).read
    raise SystemExit(f"no reader for the per-layer metric {name!r}")


def read_layers(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell, read from the traced run by its
    reader; a reader that finds nothing returns None and is left out."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_info() -> dict:
    """The card's name, clocks, power draw and limit from nvidia-smi."""
    fields = ("name", "power.limit", "power.draw", "clocks.sm",
              "clocks.max.sm", "temperature.gpu")
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"nvidia_smi": f"not read ({e})"}
    return dict(zip(fields, (v.strip() for v in line.split(","))))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`yolo_nano_tpu_torch` is not `yolo_nano_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result as the last line on standard output,
    the numbers compared under `checks`, last."""
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)


def note(line: dict) -> None:
    """An earlier line of the run's output (not the result)."""
    print(json.dumps(line), flush=True)


def percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values), q)) if values else None
