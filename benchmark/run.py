"""The benchmark of record of `yolo_nano_tpu_torch` on NVIDIA GPUs: one
cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name (`benchmark/harness.py`). Set-up (imports, the
program's kernels built or found under `build/`, weights, the cell's
inputs made from the seed on the device, warm-up of the cell's own shapes)
runs first, then the window of `--seconds`, then the check of what the
window produced against the plain reference (`benchmark/reference/`).
`--trace 1` profiles the window's first seconds and reports the cell's
per-layer metrics in place of its end-to-end ones.

The last line on standard output is the result, a JSON object; the
numbers compared, each beside its limit, are the last lines on standard
error and the result's last key. Earlier lines describe the card (name,
clocks, power draw and limit from nvidia-smi) and the run. The run exits
with 2, printing no result, without as many CUDA devices as the cell
asks for, and with 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not benchmark/, so `benchmark` is a package
# the kernel and compiler caches of anything the run loads, at fixed paths
# inside the checkout (the program builds its own kernels into build/)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "benchmark_cache", _sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, t_start=None) -> int:
    """One run. `device` None takes the CUDA devices the cell asks for;
    tests pass the CPU, where the program runs its kernels' plain
    versions."""
    import numpy as np
    import torch

    from benchmark import checks, harness

    args = parse(argv)
    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {chips} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        card = harness.card_info()
        kind = torch.cuda.get_device_name(device)
    else:
        device, card, kind = torch.device(device), {}, str(device)
    out = harness.driver(cell).run(cell, args, device, t_start or T_START)
    launches = _launch_counters()
    forwards = out["notes"].get("forwards")
    if forwards:
        launches = {k: v / forwards for k, v in launches.items()}
    harness.note({"cell": cell.name, "seed": args.seed, "trace": args.trace,
                  "card_before": card, "card_after": card and
                  harness.card_info(), "torch": torch.__version__,
                  "cuda": torch.version.cuda, "run": out["notes"],
                  "launches_a_forward": launches})

    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    limits = cell.workload["limits"]
    correct, shown = checks.judge(out["numbers"], limits)
    failed = out.get("failed", 0)
    if "per_image" in out:  # images of the checked batches out of a limit
        failed = int(sum(np.any([out["per_image"][k] > limits[k]
                                 for k in limits], 0)))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": failed}
    if args.trace:
        ctx = dict(out["ctx"], cell=cell)
        trace = ctx["trace"]
        result["metrics"] = harness.read_layers(cell, ctx)
        dev.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["device"] = dev
        result["breakdown"] = trace.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": out["e2e"][k], "unit": u}
                             for k, u in units.items()}
        result["device"] = dev
    harness.emit(result, shown)
    return 0


def _launch_counters() -> dict:
    """The program's kernel launch counters (counted since the process
    started), where it has loaded them."""
    out = {}
    for mod, fn in (("yolo_nano_tpu_torch.ops.kernels.fused_stage",
                     "fused_stage"),
                    ("yolo_nano_tpu_torch.ops.kernels.fused_conv",
                     "fused_dw_pw")):
        f = getattr(sys.modules.get(mod), fn, None)
        if f is not None:
            out.update({f"{fn}.{k}": getattr(f, k) for k in
                        ("launches", "launches_bf16")})
    return out


if __name__ == "__main__":
    sys.exit(main())
