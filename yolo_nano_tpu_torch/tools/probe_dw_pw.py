"""Where fused_dw_pw's time goes, on the card.

    python -m yolo_nano_tpu_torch.tools.probe_dw_pw [--root CHECKOUT]

1. Times one checkout's fused_dw_pw (pair 0 of each head, f32, batch 32,
   416 px) and fused_stage (stages 2-4) at the main path's shapes, two ways:
   queued behind a device sleep (device time alone) and back to back (what
   a caller enqueuing one launch after another sees, its host time
   included when that is longer). --root times another checkout, e.g. the
   parent commit unpacked with `git archive`, so both are timed alike.
2. Builds a copy of this checkout's csrc/fused_dw_pw.cu with clock64()
   probes at the barriers of the tile loop and prints the cycles per tile
   of each phase (region wait, depthwise, product and epilogue, stores) and
   of the block prologue (weights, first region), at each level's tile.

Prints one JSON line per part. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
NPZ = os.path.join("yolo_nano_tpu_torch", "assets", "bench_coco416.npz")
BATCH = 32
LEVELS = (52, 26, 13)

# (anchor in fused_dw_pw.cu, text put after it); each anchor must occur once
PROBES = (
    ('#include "mma_tf32.cuh"\n',
     "__device__ unsigned long long g_probe[8];\n"),
    ("  int t = blockIdx.x;\n", "  const long long k0 = clock64();\n"),
    ("  for (int it = 0; t < tiles; ++it, t += gridDim.x) {\n",
     "    if (it == 0) {\n      __syncthreads();\n"
     "      if (threadIdx.x == 0) {\n"
     "        atomicAdd(&g_probe[4], (unsigned long long)(clock64() - k0));\n"
     "        atomicAdd(&g_probe[6], 1ull);\n      }\n"
     "    }\n    long long c0 = clock64(), c1;\n"),
    ("    __syncthreads();  // ... and the last tile's stores are done with D\n",
     "    c1 = clock64();\n"
     "    if (threadIdx.x == 0)\n"
     "      atomicAdd(&g_probe[0], (unsigned long long)(c1 - c0));\n"
     "    c0 = c1;\n"),
    ("    depthwise(cur, ldr, tw, th, C, par, par + 9 * C, act_mid, D, ldd);\n"
     "    __syncthreads();\n",
     "    c1 = clock64();\n"
     "    if (threadIdx.x == 0)\n"
     "      atomicAdd(&g_probe[1], (unsigned long long)(c1 - c0));\n"
     "    c0 = c1;\n"),
    ("        });\n    __syncthreads();\n",
     "    c1 = clock64();\n"
     "    if (threadIdx.x == 0)\n"
     "      atomicAdd(&g_probe[2], (unsigned long long)(c1 - c0));\n"
     "    c0 = c1;\n"),
    ("    // D is next written after the barrier that follows the next wait\n",
     "    __syncthreads();\n"
     "    if (threadIdx.x == 0) {\n"
     "      atomicAdd(&g_probe[3], (unsigned long long)(clock64() - c0));\n"
     "      atomicAdd(&g_probe[5], 1ull);\n    }\n"),
)
PROBE_READ = """
extern "C" int read_probes(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  const unsigned long long zero[8] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""
PHASES = ("region_wait", "depthwise", "product_and_epilogue", "stores")


def time_ms(fn, queued: bool, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(50_000_000)  # cycles: 25 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def head_inputs(model, gen):
    for level, hw in enumerate(LEVELS):
        dw_w, dw_b, pw_w, pw_b = getattr(model, f"head{level}")._pairs()[0]
        x = torch.randn(BATCH, hw, hw, pw_w.shape[0], device="cuda",
                        generator=gen).permute(0, 3, 1, 2)
        yield hw, (x, dw_w, dw_b, pw_w, pw_b)


def time_checkout(root: str) -> dict:
    """Device and back-to-back ms of root's kernels (imported from root)."""
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("yolo_nano_tpu_torch")]:
        del sys.modules[name]
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (fused_stage,
                                                             prepare_stage)
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    set_full_f32()
    model = load_model(os.path.join(root, NPZ))[0].cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}
    with torch.inference_mode():
        for hw, args in head_inputs(model, gen):
            out[f"fused_dw_pw_{hw}"] = {
                q: time_ms(lambda: fused_dw_pw(*args), q == "device_ms")
                for q in ("device_ms", "back_to_back_ms")}
        images = torch.randn(BATCH, 416, 416, 3, device="cuda", generator=gen)
        bb = model.backbone
        x = max_pool_3x3_s2(bb.conv1(images.permute(0, 3, 1, 2)))
        x = x.contiguous(memory_format=torch.channels_last)
        for name in ("stage2", "stage3", "stage4"):
            blocks = prepare_stage(getattr(bb, name))
            out[f"fused_stage_{name}"] = {
                q: time_ms(lambda: fused_stage(x, blocks), q == "device_ms")
                for q in ("device_ms", "back_to_back_ms")}
            x = fused_stage(x, blocks)
    for q in ("device_ms", "back_to_back_ms"):
        out[f"fused_dw_pw_per_forward_{q}"] = 2 * sum(
            out[f"fused_dw_pw_{hw}"][q] for hw in LEVELS)
        out[f"fused_stage_per_forward_{q}"] = sum(
            out[f"fused_stage_{s}"][q] for s in ("stage2", "stage3", "stage4"))
    sys.path.remove(root)
    return out


def probe_phases() -> dict:
    """Cycles per tile of each phase of this checkout's kernel."""
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32
    from yolo_nano_tpu_torch.ops.kernels import build
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import tile_shape

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src = (build.CSRC / "fused_dw_pw.cu").read_text()
        for anchor, text in PROBES:
            if src.count(anchor) != 1:
                raise RuntimeError(f"probe anchor not found once: {anchor!r}")
            src = src.replace(anchor, anchor + text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, tmp)
        cu = os.path.join(tmp, "fused_dw_pw.cu")
        with open(cu, "w") as f:
            f.write(src + PROBE_READ)
        lib_path = os.path.join(tmp, "probed.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path,
                        cu], check=True)
        lib = ctypes.CDLL(lib_path)
        launch = lib.fused_dw_pw_f32
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        lib.read_probes.argtypes = [ctypes.c_void_p]

        set_full_f32()
        model = load_model(os.path.join(ROOT, NPZ))[0].cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        counts = np.zeros(8, np.uint64)
        out = {}
        for hw, (x, dw_w, dw_b, pw_w, pw_b) in head_inputs(model, gen):
            y = torch.empty_like(x)
            tile = tile_shape(BATCH, hw, hw, 96, 96, 4)
            lib.read_probes(counts.ctypes.data)  # clears them
            for _ in range(4):
                err = launch(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(),
                             pw_w.data_ptr(), pw_b.data_ptr(), y.data_ptr(),
                             BATCH, hw, hw, 96, 96, 2, 2, *tile, stream)
                if err:
                    raise RuntimeError(f"probed launch: CUDA error {err}")
            torch.cuda.synchronize()
            if lib.read_probes(counts.ctypes.data):
                raise RuntimeError("reading the probes failed")
            tiles = int(counts[5])
            blocks = int(counts[6])
            row = {p: float(counts[i]) / tiles for i, p in enumerate(PHASES)}
            row["block_prologue"] = float(counts[4]) / blocks
            row.update(tile=list(tile), tiles_per_block=tiles / blocks)
            out[f"cycles_per_tile_{hw}"] = row
        return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="checkout whose kernels to time (default: this)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_dw_pw: no CUDA device")
    print(json.dumps(time_checkout(os.path.abspath(args.root))))
    if os.path.abspath(args.root) == ROOT:
        print(json.dumps(probe_phases()))


if __name__ == "__main__":
    main()
