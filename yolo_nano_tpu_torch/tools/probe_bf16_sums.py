"""The bf16 stage kernel's sums, held to the f64-sum witness two ways.

    python -m yolo_nano_tpu_torch.tools.probe_bf16_sums

Runs chip_smoke.py's check_blocks_bf16 (phase 5's per-block check) on every
bf16 stage block of the 0.5x artifact and of the 1.0x tree through
make_predict_fn, at phase 5's inputs (batch 32, 416 px), first with this
checkout's kernel (each k-step's mma from a fresh zero, added to the
running f32 sum), then with a copy whose k-steps run straight through the
tensor core's accumulator (`mma_add` replaced by `mma` in
csrc/mma_bf16.cuh). Per stage it counts the outputs off the witness (each
block with f64 sums, rounded to bf16 where the function rounds), the
kernel's beside the plain version's (cuDNN with TF32 off, as in
chip_smoke.py). The straight-through copy is reported, not held to
BF16_WITNESS_RATIO. Prints one JSON line per variant. Run from the repo
root; needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

# the k-loop's product in csrc/mma_bf16.cuh, and its straight-through form
FRESH_ZERO = "mma_add(acc[i][j], a[i], b[j][0], b[j][1]);"
STRAIGHT = "mma(acc[i][j], a[i], b[j][0], b[j][1]);"


def stage_counts(model, images) -> dict:
    """{stage: check_blocks_bf16's errors} over the bf16 model's stages."""
    import chip_smoke as cs
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import prepare_stage

    out = {}
    with torch.inference_mode():
        x = cs.stem_bf16(model, images)
        for name in ("stage2", "stage3", "stage4"):
            blocks = prepare_stage(getattr(model.backbone, name))
            x, out[name], _ = cs.check_blocks_bf16(
                f"{name} {tuple(x.shape)}", x, blocks)
    return out


def main():
    import chip_smoke as cs
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_model, load_npz
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32
    from yolo_nano_tpu_torch.ops.kernels import build, fused_stage

    if not torch.cuda.is_available():
        raise SystemExit("probe_bf16_sums: no CUDA device")
    set_full_f32()  # the plain version's cuDNN convs in f32, as in phase 5
    images = cs.render_scenes(cs.BATCH, cs.SIZE)
    tree, meta = load_npz(cs.NPZ)
    models = {"0.5x": load_model(cs.NPZ_05X)[0].cuda(),
              "1.0x": make_predict_fn(tree, None, config_from_json(meta),
                                      cs.SIZE).model}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for variant in ("fresh_zero", "straight"):
            if variant == "straight":
                for src in build.CSRC.iterdir():
                    shutil.copy(src, tmp)
                header = Path(tmp) / "mma_bf16.cuh"
                text = header.read_text()
                if text.count(FRESH_ZERO) != 1:
                    raise RuntimeError(f"not found once: {FRESH_ZERO}")
                header.write_text(text.replace(FRESH_ZERO, STRAIGHT))
                build.CSRC = Path(tmp)
                build._LIBS.pop("fused_stage_bf16", None)
                fused_stage._lib.cache_clear()
                cs.BF16_WITNESS_RATIO = math.inf  # reported, not held
            print(f"[{variant}]", flush=True)
            counts = {width: stage_counts(model, images)
                      for width, model in models.items()}
            print(json.dumps({variant: counts}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
