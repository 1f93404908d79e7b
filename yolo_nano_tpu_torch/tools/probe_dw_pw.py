"""Where fused_dw_pw's time goes, on the card.

    python -m yolo_nano_tpu_torch.tools.probe_dw_pw [--root CHECKOUT]
        [--witness-against CHECKOUT]

1. Times one checkout's fused_dw_pw (pair 0 of each head, f32, batch 32,
   416 px), its bf16 launches on the 0.5x artifact's heads (both pairs of
   each level: a forward's 6 launches, at batch 32 and 1 at 416 px and at
   batch 8 at the TTA sizes 320 to 640 px) and fused_stage (stages 2-4;
   f32 on the 1.0x artifact, bf16 on the 0.5x artifact) at the main path's
   shapes, two ways: queued behind a device sleep (device time alone) and
   back to back (what a caller enqueuing one launch after another sees,
   its host time included when that is longer). --root times another
   checkout, e.g. the parent commit unpacked with `git archive`, so both
   are timed alike.
2. Builds a copy of this checkout's csrc/fused_dw_pw.cu (f32) with
   clock64() probes at the barriers of the tile loop and prints the cycles
   per tile of each phase (region wait, depthwise, product and epilogue,
   stores) and of the block prologue (weights, first region), at each
   level's tile.
3. Builds a copy of csrc/fused_stage_bf16.cu with clock64() probes at its
   barriers and %globaltimer at each block's start and end, and runs every
   block launch of the 0.5x artifact's bf16 stages at the tile the rule
   picks: per launch the span from the first block's start to the last
   block's end, a block's mean duration, the blocks resident on an SM on
   average over the span, and a block's mean cycles in each phase.
4. The same for csrc/fused_dw_pw_bf16.cu at the 0.5x artifact's head
   pairs, batch 32 and 1 at 416 px: a tile's cycles in the region wait,
   the depthwise, the product and its epilogue, and the stores; a block's
   prologue (weights, taps, first region); span, block duration and blocks
   resident on an SM.
--witness-against CHECKOUT builds CHECKOUT's csrc/fused_dw_pw.cu (one
whose fused_dw_pw_bf16 symbol is the f32 template run with one TF32 pass,
before fused_dw_pw_bf16.cu) and counts, on the same bf16 inputs at the 0.5x
heads (batch 32, 416 px), the outputs of its bf16 launch and of this
checkout's kernel that leave the witness (fused_dw_pw_plain with f64 sums,
rounded where the function rounds), beside the plain version's count.

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
# (batch, size) of the bf16 head timings: the main path, batch 1, and the
# TTA sizes at batch 8
BF16_HEAD_SHAPES = ((32, 416), (1, 416)) + tuple(
    (8, s) for s in range(320, 641, 32))

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
    ("      depthwise_k<K>(cur, ldr, tw, th, C, par, par + kTaps * C, act_mid, "
     "D,\n                     ldd);\n    __syncthreads();\n",
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
# (anchor in fused_dw_pw_bf16.cu, its replacement); each anchor occurs once.
# g_probe: 0-3 the phases of a tile (PHASES), 4 tiles, 5 the prologue, 6 the
# blocks' summed duration (ns), 7 blocks; g_time: first start, last end.
BF16_PROBES = (
    ('#include "mma_bf16.cuh"\n', STAGE_PROBES[0][1]),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     STAGE_PROBES[1][1]),
    ("  for (int it = 0; t < tiles; ++it, t += gridDim.x) {\n",
     "  STAMP(5);\n  for (int it = 0; t < tiles; ++it, t += gridDim.x) {\n"),
    ("    __syncthreads();  // ... and the last tile's stores are done with D\n",
     "    __syncthreads();  // ... and the last tile's stores are done with D\n"
     "    STAMP(0);\n"),
    ("      depthwise5(cur, ldr, tw, th, C, par, par + kTaps * C, act_mid, D, "
     "ldd);\n    __syncthreads();\n",
     "      depthwise5(cur, ldr, tw, th, C, par, par + kTaps * C, act_mid, D, "
     "ldd);\n    __syncthreads();\n    STAMP(1);\n"),
    ("        });\n    __syncthreads();\n",
     "        });\n    __syncthreads();\n    STAMP(2);\n"),
    ("    // D is next written after the barrier that follows the next wait\n"
     "  }\n}\n",
     "    STAMP(3);\n    if (threadIdx.x == 0) atomicAdd(&g_probe[4], 1ull);\n"
     "  }\n  if (threadIdx.x == 0) {\n"
     "    const unsigned long long t_end = globaltimer();\n"
     "    atomicMax(&g_time[1], t_end);\n"
     "    atomicAdd(&g_probe[6], t_end - g_start);\n"
     "    atomicAdd(&g_probe[7], 1ull);\n  }\n}\n"),
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


def bf16_head_calls(model, batch, size, seed=0):
    """The 6 head-pair calls of a bf16 forward at this batch and size:
    (level side, pair, args) on seeded bf16 inputs (the same in every
    checkout)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for level, hw in enumerate((size // 8, size // 16, size // 32)):
        for pair, (dw_w, dw_b, pw_w, pw_b) in enumerate(
                getattr(model, f"head{level}")._pairs()):
            x = torch.randn(batch, hw, hw, pw_w.shape[0], device="cuda",
                            generator=gen).to(torch.bfloat16)
            yield hw, pair, (x.permute(0, 3, 1, 2), dw_w, dw_b, pw_w, pw_b)


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
        for batch, size in BF16_HEAD_SHAPES:
            out[f"fused_dw_pw_bf16_05x_b{batch}_{size}"] = {
                q: sum(time_ms(lambda: fused_dw_pw(*args), q == "device_ms")
                       for _, _, args in bf16_head_calls(model05, batch,
                                                         size))
                for q in ("device_ms", "back_to_back_ms")}
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


def _build_probed(source: str, probes, read: str, tmp: str) -> ctypes.CDLL:
    """A copy of csrc/<source>.cu with each probe anchor replaced (each must
    occur once) and `read` appended, built into tmp and loaded."""
    from yolo_nano_tpu_torch.ops.kernels import build

    src = (build.CSRC / f"{source}.cu").read_text()
    for anchor, text in probes:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    cu = os.path.join(tmp, f"{source}.cu")
    with open(cu, "w") as f:
        f.write(src + read)
    lib_path = os.path.join(tmp, f"probed_{source}.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, cu],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.read_probes.argtypes = [ctypes.c_void_p]
    return lib


def probe_phases() -> dict:
    """Cycles per tile of each phase of this checkout's kernel."""
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32
    from yolo_nano_tpu_torch.ops.kernels import build
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import tile_shape

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        lib = _build_probed("fused_dw_pw", [(a, a + t) for a, t in PROBES],
                            PROBE_READ, tmp)
        launch = lib.fused_dw_pw_f32
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]

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
                             BATCH, hw, hw, 96, 96, 3, 2, 2, *tile, stream)
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
        _WEIGHTS, STAGE_ACTS, block_tile, prepare_stage)
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        lib = _build_probed("fused_stage_bf16", STAGE_PROBES,
                            STAGE_PROBE_READ, tmp)
        launch = lib.shuffle_block_bf16
        launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p] * 11)

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
                                     cin, c2, s, tile, STAGE_ACTS["relu"],
                                     *ptrs, stream)
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


def probe_dw_pw_bf16() -> dict:
    """Phases and block residency of this checkout's bf16 fused_dw_pw at
    the 0.5x artifact's head pairs (pair 0 of each level), batch 32 and 1,
    416 px, at the tile the rule picks."""
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.ops.kernels import build
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (_lib,
                                                            tile_shape)

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        lib = _build_probed("fused_dw_pw_bf16", BF16_PROBES,
                            STAGE_PROBE_READ, tmp)
        launch = lib.fused_dw_pw_bf16
        launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        occupancy = _lib(torch.bfloat16).fused_dw_pw_bf16_blocks_per_sm
        model = load_model(os.path.join(ROOT, NPZ_05X))[0].cuda()
        stream = torch.cuda.current_stream().cuda_stream
        counts = np.zeros(10, np.uint64)
        lib.read_probes(counts.ctypes.data)  # sets the start/end marks
        out = {}
        with torch.inference_mode():
            for batch in (BATCH, 1):
                for hw, pair, (x, dw_w, dw_b, pw_w, pw_b) in bf16_head_calls(
                        model, batch, 416):
                    if pair:
                        continue
                    c, cout = pw_w.shape
                    tile = tile_shape(batch, hw, hw, c, cout, 2)
                    y = torch.empty_like(x)
                    rows = []
                    for _ in range(4):
                        err = launch(x.data_ptr(), dw_w.data_ptr(),
                                     dw_b.data_ptr(), pw_w.data_ptr(),
                                     pw_b.data_ptr(), y.data_ptr(), batch,
                                     hw, hw, c, cout, 3, 2, 2, *tile,
                                     stream)
                        if err:
                            raise RuntimeError(f"probed launch: {err}")
                        torch.cuda.synchronize()
                        if lib.read_probes(counts.ctypes.data):
                            raise RuntimeError("reading the probes failed")
                        rows.append(counts.astype(np.float64))
                    k = np.mean(rows[1:], 0)  # the first warms up
                    tiles, blocks, span_ns = k[4], k[7], k[9] - k[8]
                    row = {p: k[i] / tiles for i, p in enumerate(PHASES)}
                    row.update(tile=list(tile), tiles=int(tiles),
                               blocks=int(blocks),
                               prologue_per_block=k[5] / blocks,
                               span_us=span_ns / 1e3,
                               block_us=k[6] / blocks / 1e3,
                               resident_per_sm=k[6] / span_ns / 132,
                               blocks_per_sm_allowed=occupancy(*tile, c,
                                                               cout, 3))
                    out[f"b{batch}_{hw}"] = row
                    print(f"  bf16 b{batch} {hw}x{hw} tile {tile}: "
                          f"{int(tiles)} tiles on {int(blocks)} blocks, span"
                          f" {row['span_us']:.2f} us, block "
                          f"{row['block_us']:.2f} us, "
                          f"{row['resident_per_sm']:.2f} resident per SM ("
                          f"{row['blocks_per_sm_allowed']} allowed); cycles "
                          "per tile " + ", ".join(
                              f"{p} {row[p]:.0f}" for p in PHASES)
                          + f"; prologue {row['prologue_per_block']:.0f}")
        return out


def witness_against(old_root: str) -> dict:
    """Outputs off the witness of old_root's bf16 fused_dw_pw launch (its
    csrc/fused_dw_pw.cu, at its own tile rule's pick) and of this
    checkout's kernel, on the same inputs: the 0.5x artifact's 6 head pairs
    at batch 32, 416 px; the plain version's count beside them."""
    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.ops.kernels import build
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain)

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        csrc = os.path.join(old_root, "yolo_nano_tpu_torch", "csrc")
        lib_path = os.path.join(tmp, "old_fused_dw_pw.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path,
                        os.path.join(csrc, "fused_dw_pw.cu")], check=True)
        old = ctypes.CDLL(lib_path)
        old.fused_dw_pw_bf16.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 9 + [ctypes.c_void_p]
        old.fused_dw_pw_tile.argtypes = [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        model = load_model(os.path.join(ROOT, NPZ_05X))[0].cuda()
        stream = torch.cuda.current_stream().cuda_stream
        counts = dict(old=0, new=0, plain=0, n=0)
        with torch.inference_mode():
            for hw, pair, args in bf16_head_calls(model, BATCH, 416):
                x = args[0]
                c, cout = args[3].shape
                tw, th = ctypes.c_int(), ctypes.c_int()
                if not old.fused_dw_pw_tile(BATCH, hw, hw, c, cout, 2,
                                            ctypes.byref(tw),
                                            ctypes.byref(th)):
                    raise RuntimeError("the old tile rule found no tile")
                got_old = torch.empty_like(x)
                err = old.fused_dw_pw_bf16(
                    *(t.data_ptr() for t in args), got_old.data_ptr(),
                    BATCH, hw, hw, c, cout, 2, 2, tw.value, th.value, stream)
                if err:
                    raise RuntimeError(f"old launch: CUDA error {err}")
                exact = fused_dw_pw_plain(*args, wide=torch.float64)
                counts["old"] += int((got_old != exact).sum())
                counts["new"] += int((fused_dw_pw(*args) != exact).sum())
                counts["plain"] += int((fused_dw_pw_plain(*args) != exact
                                        ).sum())
                counts["n"] += exact.numel()
        out = {f"{k}_off_f64_share": counts[k] / counts["n"]
               for k in ("old", "new", "plain")}
        out.update(counts, new_over_old=counts["new"] / counts["old"],
                   old_root=old_root)
        print(f"  off the f64-sum witness, 0.5x heads at batch {BATCH}: old "
              f"{out['old_off_f64_share']:.6f}, new "
              f"{out['new_off_f64_share']:.6f} ({out['new_over_old']:.3f}x"
              f" the old), plain {out['plain_off_f64_share']:.6f}")
        return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=ROOT,
                        help="checkout whose kernels to time (default: this)")
    parser.add_argument("--witness-against", metavar="CHECKOUT",
                        help="count the outputs off the witness of "
                        "CHECKOUT's bf16 fused_dw_pw launch beside this "
                        "checkout's kernel's, instead of parts 1 to 4")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_dw_pw: no CUDA device")
    if args.witness_against:
        print(json.dumps(witness_against(os.path.abspath(
            args.witness_against))))
        return
    print(json.dumps(time_checkout(os.path.abspath(args.root))))
    if os.path.abspath(args.root) == ROOT:
        print(json.dumps(probe_phases()))
        print(json.dumps(probe_stage_bf16()))
        print(json.dumps(probe_dw_pw_bf16()))


if __name__ == "__main__":
    main()
