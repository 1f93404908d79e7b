"""Where fused_dw_pw's time goes, on the card.

    python -m yolo_nano_tpu_torch.tools.probe_dw_pw [--root CHECKOUT]

1. Times one checkout's fused_dw_pw (pair 0 of each head, f32, batch 32,
   416 px) and fused_stage (stages 2-4; f32 on the 1.0x artifact, bf16 on
   the 0.5x artifact) at the main path's shapes, two ways:
   queued behind a device sleep (device time alone) and back to back (what
   a caller enqueuing one launch after another sees, its host time
   included when that is longer). --root times another checkout, e.g. the
   parent commit unpacked with `git archive`, so both are timed alike.
2. Builds a copy of this checkout's csrc/fused_dw_pw.cu with clock64()
   probes at the barriers of the tile loop and prints the cycles per tile
   of each phase (region wait, depthwise, product and epilogue, stores) and
   of the block prologue (weights, first region), at each level's tile.
3. Builds a copy of csrc/fused_stage_bf16.cu with clock64() probes at its
   barriers and %globaltimer at each block's start and end, and runs every
   block launch of the 0.5x artifact's bf16 stages at the tile the rule
   picks: per launch the span from the first block's start to the last
   block's end, a block's mean duration, the blocks resident on an SM on
   average over the span, and a block's mean cycles in each phase.

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
NPZ_05X = os.path.join("yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")
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

# (anchor in fused_stage_bf16.cu, its replacement); each anchor occurs once
STAGE_PROBES = (
    ('#include "mma_bf16.cuh"\n',
     '#include "mma_bf16.cuh"\n'
     "__device__ unsigned long long g_probe[8];\n"
     "__device__ unsigned long long g_time[2];\n"
     "__device__ __forceinline__ unsigned long long globaltimer() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"
     "#define STAMP(k) do { __syncthreads(); if (threadIdx.x == 0) { "
     "const long long c_ = clock64(); atomicAdd(&g_probe[k], "
     "(unsigned long long)(c_ - t_probe)); t_probe = c_; } } while (0)\n"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  long long t_probe = clock64();\n"
     "  const unsigned long long g_start = globaltimer();\n"
     "  if (threadIdx.x == 0) atomicMin(&g_time[0], g_start);\n"),
    ("    opix[p] = (oy < Ho && ox < Wo) ? (oy * Wo + ox) * Cout : -1;\n"
     "  }\n",
     "    opix[p] = (oy < Ho && ox < Wo) ? (oy * Wo + ox) * Cout : -1;\n"
     "  }\n  STAMP(0);\n"),
    ("  __syncthreads();\n\n  const bf16* w_pw1",
     "  __syncthreads();\n  STAMP(1);\n\n  const bf16* w_pw1"),
    ("      });\n  __syncthreads();\n"
     "  if (!RESIDENT) mb::prefetch(c2, c2",
     "      });\n  __syncthreads();\n  STAMP(2);\n"
     "  if (!RESIDENT) mb::prefetch(c2, c2"),
    ("                    lay.ldd);\n  mb::cp_async_wait<0>();\n"
     "  __syncthreads();\n  // 5.",
     "                    lay.ldd);\n  STAMP(7);\n  mb::cp_async_wait<0>();\n"
     "  __syncthreads();\n  STAMP(3);\n  // 5."),
    ("__byte_perm(l, r, 0x7632));\n      });\n}\n",
     "__byte_perm(l, r, 0x7632));\n      });\n  STAMP(4);\n"
     "  if (threadIdx.x == 0) {\n"
     "    const unsigned long long t_end = globaltimer();\n"
     "    atomicMax(&g_time[1], t_end);\n"
     "    atomicAdd(&g_probe[5], t_end - g_start);\n"
     "    atomicAdd(&g_probe[6], 1ull);\n  }\n}\n"),
)
STAGE_PROBE_READ = """
extern "C" int read_probes(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(static_cast<char*>(out) + sizeof(g_probe),
                             g_time, sizeof(g_time));
  const unsigned long long zero[8] = {};
  const unsigned long long times[2] = {~0ull, 0ull};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_time, times, sizeof(times));
  return static_cast<int>(e);
}
"""
# g_probe index of each phase
STAGE_PHASES = {"copies_issued_and_offsets": 0,
                "region_x1_and_weights_wait": 1,
                "branch1_and_pw1": 2, "depthwise": 7, "depthwise_wait": 3,
                "pw2_and_stores": 4}


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
        model05 = load_model(os.path.join(root, NPZ_05X))[0].cuda()
        for tag, m, dtype in (("", model, torch.float32),
                              ("bf16_05x_", model05, torch.bfloat16)):
            bb = m.backbone
            x = max_pool_3x3_s2(bb.conv1(
                images.to(dtype).permute(0, 3, 1, 2)))
            x = x.contiguous(memory_format=torch.channels_last)
            for name in ("stage2", "stage3", "stage4"):
                blocks = prepare_stage(getattr(bb, name))
                out[f"fused_stage_{tag}{name}"] = {
                    q: time_ms(lambda: fused_stage(x, blocks),
                               q == "device_ms")
                    for q in ("device_ms", "back_to_back_ms")}
                x = fused_stage(x, blocks)
    for q in ("device_ms", "back_to_back_ms"):
        out[f"fused_dw_pw_per_forward_{q}"] = 2 * sum(
            out[f"fused_dw_pw_{hw}"][q] for hw in LEVELS)
        for tag in ("", "bf16_05x_"):
            out[f"fused_stage_{tag}per_forward_{q}"] = sum(
                out[f"fused_stage_{tag}{s}"][q]
                for s in ("stage2", "stage3", "stage4"))
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


def probe_stage_bf16() -> dict:
    """Phases and block residency of this checkout's bf16 stage kernel at
    each block launch of the 0.5x artifact (batch 32, 416 px)."""
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.ops.kernels import build
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _WEIGHTS, block_tile, prepare_stage)
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src = (build.CSRC / "fused_stage_bf16.cu").read_text()
        for anchor, text in STAGE_PROBES:
            if src.count(anchor) != 1:
                raise RuntimeError(f"probe anchor not found once: {anchor!r}")
            src = src.replace(anchor, text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, tmp)
        cu = os.path.join(tmp, "fused_stage_bf16.cu")
        with open(cu, "w") as f:
            f.write(src + STAGE_PROBE_READ)
        lib_path = os.path.join(tmp, "probed_stage.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path,
                        cu], check=True)
        lib = ctypes.CDLL(lib_path)
        launch = lib.shuffle_block_bf16
        launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 11)
        lib.read_probes.argtypes = [ctypes.c_void_p]

        model = load_model(os.path.join(ROOT, NPZ_05X))[0].cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        counts = np.zeros(10, np.uint64)
        lib.read_probes(counts.ctypes.data)  # sets the start/end marks
        out = {}
        with torch.inference_mode():
            images = torch.randn(BATCH, 416, 416, 3, device="cuda",
                                 generator=gen).to(torch.bfloat16)
            bb = model.backbone
            x = max_pool_3x3_s2(bb.conv1(images.permute(0, 3, 1, 2)))
            x = x.contiguous(memory_format=torch.channels_last)
            for name in ("stage2", "stage3", "stage4"):
                for i, w in enumerate(prepare_stage(getattr(bb, name))):
                    b, cin, h, wd = x.shape
                    s, c2 = w["stride"], w["pw1_w"].shape[1]
                    ho, wo = (h - 1) // s + 1, (wd - 1) // s + 1
                    tile = block_tile(s, cin, c2, b, ho, wo, torch.bfloat16)
                    y = torch.empty(b, 2 * c2, ho, wo, dtype=x.dtype,
                                    device="cuda",
                                    memory_format=torch.channels_last)
                    ptrs = [w[k].data_ptr() if k in w else None
                            for k in _WEIGHTS[torch.bfloat16]]
                    rows = []
                    for _ in range(4):
                        err = launch(x.data_ptr(), y.data_ptr(), b, h, wd,
                                     cin, c2, s, tile, *ptrs, stream)
                        if err:
                            raise RuntimeError(f"probed launch: {err}")
                        torch.cuda.synchronize()
                        if lib.read_probes(counts.ctypes.data):
                            raise RuntimeError("reading the probes failed")
                        rows.append(counts.astype(np.float64))
                    c = np.mean(rows[1:], 0)  # the first warms up
                    blocks = c[6]
                    span_ns = c[9] - c[8]
                    row = {p: c[k] / blocks for p, k in STAGE_PHASES.items()}
                    row.update(tile=tile, blocks=int(blocks),
                               span_us=span_ns / 1e3,
                               block_us=c[5] / blocks / 1e3,
                               resident_per_sm=c[5] / span_ns / 132)
                    out[f"{name}[{i}]"] = row
                    print(f"  {name}[{i}] stride {s} tile {tile}: "
                          f"{int(blocks)} blocks, span {row['span_us']:.2f}"
                          f" us, block {row['block_us']:.2f} us, "
                          f"{row['resident_per_sm']:.2f} resident per SM; "
                          "cycles per block " + ", ".join(
                              f"{p} {row[p]:.0f}" for p in STAGE_PHASES))
                    x = y
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
        print(json.dumps(probe_stage_bf16()))


if __name__ == "__main__":
    main()
