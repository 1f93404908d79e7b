"""The readings that a cell's limits are set from: the numbers compared, on
many seeds in one process, of the program (sound runs) and of the control,
the reference computed one precision below the configuration's (its
config file's `control`: TF32 for f32, float8 e4m3 for bf16) put in the
program's place. Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 \
        [--control | --fault half_batch] [--out readings.jsonl]

`--fault half_batch` reads the program with a fault planted in its
training step: half of each batch left out, the mean taken over the rest
(a step that returns its state unchanged reads 1 and needs no run). Each
seed prints one JSON line: {"workload", "control", "fault", "seed",
numbers}.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def _half_batch():
    from yolo_nano_tpu_torch.train import train_step

    call = train_step.TrainStep.__call__

    def half(self, state, images, boxes, labels, *args, **kwargs):
        h = len(images) // 2
        return call(self, state, images[:h], boxes[:h], labels[:h], *args,
                    **kwargs)

    train_step.TrainStep.__call__ = half


FAULTS = {"half_batch": _half_batch}


def main(argv=None, device=None) -> int:
    import torch

    from benchmark import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    control = cell.config["control"] if args.control else None
    if args.fault:
        FAULTS[args.fault]()
    rows = harness.driver(cell).readings(cell, args.seeds,
                                         torch.device(device), control)
    with open(args.out, "a") if args.out else open(os.devnull, "w") as f:
        for row in rows:
            line = json.dumps({"workload": cell.name, "control": control,
                               "fault": args.fault, **row})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
