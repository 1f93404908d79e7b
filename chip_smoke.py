#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --sweep-stage-tiles   # phases 1-2, then the sweep
    python3 chip_smoke.py --sweep-dw-pw-tiles   # phase 1, fused_dw_pw's
                                                # phase 2, then its sweep

Phases, each of which raises on failure (exit code non-zero, no result line):
  1. device and build: needs CUDA; prints the card's name and power limit,
     builds the kernels (fused_dw_pw and fused_stage in f32,
     fused_dw_pw_bf16, fused_stage_bf16) from yolo_nano_tpu_torch/csrc with
     nvcc, one process per source;
  2. each kernel against its plain PyTorch version on the card, at the
     main-path shapes for batch 32 (1.0x COCO model, 416 px): max abs error
     and tolerance, kernel / plain / library ms, and the bound; each f32
     row is also run in f64 and fails if the kernel's error against it is
     over 4x cuDNN f32's; each bf16 fused_dw_pw row is held in bf16 ulps of
     max|ref| and bit-equal share, and over the rows against the witness
     (f64 sums rounded where the function rounds: the share of outputs off
     it); then the NMS kernel against its plain version (the fixpoint
     loop) on the candidates of predicts at the benchmark's detection
     cells, at batch 32 and of TTA's merge (NMS_CASES): the keep sets bit
     for bit, kernel µs, the loop's ms and the bound;
  3. the main path: load_predictor on the committed folded artifact, 32
     rendered scenes, serving and eval-strict operating points; checks the
     kernel launch counts (one NMS launch a predict), the detections slot for slot against predict
     with the plain versions on the same card, the NMS candidate load;
     prints img/s and per-stage ms;
  4. training at the artifact's configuration (1.0x COCO, 416 px), batch
     16, from init_yolo_nano: 30 steps must bring the loss below 0.8x the
     first; build_targets on colliding ground truths against the CPU; the
     NaN guard (every state tensor bit-identical) under
     set_sync_debug_mode("error"); multi-scale steps at 320 and 608 px; the
     trained model folded and run through predict with both kernels against
     the plain versions; train step ms, img/s, peak memory and the ms of
     build_targets, forward+loss, backward and update+EMA; last, one step
     from the initial state at batch 4 on the card against the same step on
     the CPU in f32 and in f64: per state field the card's error against
     f64 within 4x the CPU f32's;
  5. bf16 inference: the 0.5x COCO artifact (bf16 weights) through
     load_predictor at both operating points, batch 32: each block's bf16
     stage kernel against its plain block in bf16 ulps of the block's
     max|ref| and the share of bit-equal elements, both of them against
     the block with f64 sums rounded where the function rounds (the
     share of outputs off it), with its ms, tile and bound per launch;
     kernel / plain ms and bound per stage, bf16 fused_dw_pw at the heads
     (held as in phase 2); 16 bf16 fused_stage and 6 bf16 fused_dw_pw
     launches per forward; detections matched to the plain-version
     predict's at bf16 tolerance (match_detections); img/s and forward ms,
     and the forward's device time by kernel. Then the 1.0x artifact
     through make_predict_fn at its bf16 default (the stage kernel at c2
     up to 232), checked, timed and bounded the same way; then seeded
     init_yolo_nano trees at 1.5x and 2.0x (stage 4 at c2 = 352 and 488,
     the bf16 kernel's wide variant) through make_predict_fn, each block
     against its plain block (ulps, bit-equal share, witness ratio), the
     launch counts, each stage's kernel and plain ms and bound;
  6. evaluation through cli.eval.main: 256 synthetic scenes written as a
     VOC and a COCO set; the port's VOCEvaluator and COCOEvaluator on an
     oracle predict_fn (AP 1.0); cli.eval on the f32 artifact, its AP
     equal to the plain-version path's within 1e-6; on the bf16 0.5x
     artifact, on a CheckpointManager directory of the 1.0x artifact's
     weights as a train state (--ema), and on one of phase 4's trained
     state, each at its bf16 default, AP within EVAL_BF16_AP_ATOL of the
     plain path's, the two artifacts' detections matched to the plain
     path's (match_detections); the launch counts of each run, and its
     time in evaluate split into the loader's waits, predict_fn, and the
     letterbox undo and AP protocol;
  7. training through cli.train.main: a VOC2007 trainval split of 256 new
     scenes beside phase 6's test split; run A (1.0x VOC, 416 px, batch
     16, -ms, --ema, the eval hook every epoch, 2 epochs), run B (A
     resumed with --resume auto to 3 epochs: it must resume at step 32)
     and run C (3 epochs uninterrupted), B's epoch-2 log rows (epoch,
     iter, size, step) equal to C's; every next() of device_prefetch
     under set_sync_debug_mode("error"), a sample of its batches equal to
     the host's bit for bit; no kernel launched in a training step, each
     eval hook 16 bf16 fused_stage and 6 bf16 fused_dw_pw launches per
     forward, the precision flags unchanged across it; then cli.export of
     run C's checkpoint with --ema in f32 and bf16: each .npz equal to
     fold_bn (and the cast) of the state's EMA model bit for bit, and
     load_predictor on it launching both kernels, its head outputs
     within check_close of the plain versions'; prints the CLI's training
     img/s (the epoch loops' images over their seconds, eval hooks out)
     beside phase 4's bare step, the share of those seconds spent waiting
     for batches, the pinned host→device copy ms of a batch, each eval
     hook's seconds and AP, and peak memory;
  8. the serving tools, on both artifacts (f32 1.0x, bf16 0.5x): every
     stage block and head pair against its plain version at the 11 TTA
     sizes (320-640 px, batch 8) and at 416 px batch 1 (f32 by check_close
     and 4x cuDNN f32's error against f64, bf16 in ulps and bit-equal
     share, the heads also against the witness), with each shape's tiles,
     ms per forward and bound; one image
     at batch 1 against its row of a batch of 8, bit for bit; TTA on 8
     scenes (22 x (16 + 6) launches and 23 NMS launches, detections
     against the plain path's,
     img/s); cli.eval --tta on phase 6's COCO set (the kernel path's AP
     equal to the plain path's within 1e-6); load_predictor with
     batch_buckets="auto" on ragged requests of 1, 5, 33 and 70 scenes,
     each image against its row of unpadded runs (and whether bit-equal,
     on the kernel and on the plain path); cli.test (with and without
     --tta), cli.demo in image and video mode, cli.benchmark in f32 and
     bf16 with --reference_protocol, its FLOPs lines equal to the CPU's;
     the launches of every run against its forwards;
  9. the serialized serving graph: each artifact's graph exported on the
     CPU (serving.export_graph, as cli.export writes it) and replayed by
     load_predictor on the card at batch 1, 8 and 32 on phase 3's scenes:
     16 + 6 launches of its dtype's kernels per forward, the detections
     against the parameter path's (f32 slot for slot, bf16 matched) with
     the bit-equal share of slots, both paths' predict ms and img/s, and
     the parameter path's forward ms;
 10. the in-graph augmentation (data/device_aug.py): apply_augment on the
     card against the CPU on the same draws (batch 16 of phase 7's scenes
     as uint8 canvases at 416 px, outputs at 320, 416 and 608, with and
     without the mosaic, the crop disallowed on some rows and one row with
     no valid box; images within AUG_IMAGE_ATOL on the 0..255 scale, boxes
     within AUG_BOX_ATOL, labels equal), each card call under
     set_sync_debug_mode("error"); the sampler's crops over 2,000 items on
     the card held to the accept rule, with the identity share and mean
     crop area beside the CPU's; one augmenting train step under
     set_sync_debug_mode("error"); cli.train --device_augment --mosaic -ms
     --ema --cache_images on phase 7's split (run D 1 epoch, run E D
     resumed to 2, run F 2 uninterrupted): E's last-epoch rows and its
     first augmented batch equal to F's, no kernel in a training step, the
     eval hooks' bf16 launches; the augment's ms and launches per call at
     416 and 608 px, the CLI's img/s and loader share beside phase 7's run
     C, the pinned copy of a uint8 batch, peak memory;
 11. data parallelism on an NCCL group of world size 1 (one card; two
     ranks are the CPU tests'): make_predict_fn(mesh, process_shard,
     local_rows=True) on the 1.0x artifact in f32 and bf16 and
     load_predictor(mesh=) at batch 32, each with 16 + 6 launches a
     forward, its detections equal to the predictor's without a mesh bit
     for bit and held to the plain path, and its ms beside that one's;
     make_train_step(mesh=) at phase 4's setup, 3 steps against 3 without
     a mesh (each field within 4x their error against the same steps in
     f64 on the card), one under set_sync_debug_mode("error"), the steps'
     ms; the gradient's all-reduce, the all-gather of a batch's uint8
     canvases and a mesh step's collectives by CUDA events, host issue and
     torch.profiler (calls, device ms); then cli.train --coordinator
     (1 process) --device_augment --mosaic --ema, 1 epoch on phase 7's
     split at the default lr from a state that detects the scenes'
     classes, against the same run without --coordinator: logged losses
     within 1e-5, the eval hooks' detections matched and their AP within
     EVAL_BF16_AP_ATOL;
 12. NanoDet-Plus-m-1.5x (the seeded bf16 artifact) through load_predictor:
     one predict's launches (3 LeakyReLU stages of 16 blocks, 12 5x5
     pairs, 1 NMS), its detections against the plain-version predict
     (matched as bf16), its ms and img/s, and each 5x5 pair and LeakyReLU
     stage of a forward alone: kernel, plain and bound ms;
 13. a JSON line of kernel numbers, the card line, and the result line.

A bound is the least time the card could take for a kernel's work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s of HBM, and its operations over the tensor cores' rate. An f32
kernel is held to f32 accuracy, which the tensor cores give as 3xTF32:
three TF32 passes at 495 TFLOP/s, so 3 * operations / 495e12 s. bf16 runs
one pass at 989 TFLOP/s. (H100 SXM published peaks.)

--sweep-stage-tiles times every block launch of the three stages at every
tile side whose shared memory fits, each checked against the plain block,
and marks the side the kernel's tile rule picks: in f32 at 1.0x, then in
bf16 at 0.5x (the artifact) and at 1.0x (the f32 model cast); it replaces
phase 3 and prints no result line. --sweep-dw-pw-tiles does the same for
fused_dw_pw at each head level over a grid of tiles (columns x rows): the
f32 kernel at batch 32, the bf16 kernel at batch 32, 8 and 1.
--graph-only runs phase 9 alone after phase 1, with no result line;
--nanodet-only runs phase 12 alone after phase 1, with no result line;
--data-parallel-only runs phase 11 alone after phase 1, on the sets of
phases 6 and 7 written anew, with no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets", "bench_coco416.npz")
NPZ_NANODET = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                           "nanodet_plus_m_1.5x_416_seed0.npz")
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")
BATCH = 32
SIZE = 416
HBM_BYTES_PER_S = 3.35e12
SMEM_MAX = 227 * 1024  # shared memory one block may use on sm_90
# operations per second at the working precision: f32 as 3xTF32
EFFECTIVE_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
# training phase: batch and box padding of cli/train.py's defaults
TRAIN_BATCH = 16
MAX_BOXES = 64
TRAIN_STEPS = 30
TRAIN_LR = 1e-3
CPU_BATCH = 4
# the CPU tests' tolerances (tests/test_torch_train.py)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_LEAF_RTOL, TRAIN_LEAF_ATOL, TRAIN_FIELD_ATOL = 1e-3, 1e-5, 5e-7
# detections of the trained model whose scores agree this closely may swap
# slots between the kernel and the plain path: the kernels' head outputs
# differ from the plain versions' by up to 2e-4 on logits of 10 to 100,
# which moves a score by about 2e-4 of itself; two detections of one class
# 1e-5 apart took each other's slot, as did two of two classes 1e-6 apart
TIE_RTOL = 1e-3
# the bf16 stage kernel against its plain block on the same input: within
# BF16_BLOCK_ULPS bf16 ulps of the block output's max|ref|, and at least
# BF16_BLOCK_EQUAL of the elements bit-equal. Both round every op to bf16,
# each from its own f32 sum order, so a rounding on a boundary flips by an
# ulp of its value, and a flip in pw1 moves the depthwise and pw2 after it
# by up to an ulp of pw1's values, which can be tens of ulps of a small
# output (20 measured in a stage-3 block of the 0.5x artifact)
BF16_BLOCK_ULPS = 1
BF16_BLOCK_EQUAL = 0.99
# a bf16 kernel's outputs off the witness (its function with f64 sums,
# rounded where the function rounds): over a stage, or over a phase's head
# pairs, the kernel's count within this many times the plain version's
# (cuDNN f32). Stages 0.89x to 1.04x measured; sums carried straight
# through the tensor core's accumulator gave 1.6x and 2x.
BF16_WITNESS_RATIO = 1.5
# bf16 detections (match_detections): a flipped bf16 rounding moves a head
# logit by an ulp (1/32 to 1/16 at 4 to 16), and a score by e^ulp − 1 of
# itself, 3% to 6.5% (10% for two ulps); one detection more or fewer on a
# side then shifts every later slot, so the two sides are matched, not
# compared slot for slot. (Two boxes of one class at IoU 0.66 swapped
# their NMS order between the kernel and the plain path, their scores
# 0.162 and 0.176 apart: 8% of the larger.)
BF16_MATCH = dict(score_atol=5e-3, score_rtol=0.1, iou_tol=0.02)
# a bf16 model's head outputs (phases 5 and 7): the kernel path's RMS
# distance from the witness (the same forward on the bf16 weights widened
# to f32, plain versions) within this many times the plain path's, the
# yardstick of tests/test_torch_bf16.py. Elementwise they cannot be held: a
# rounding flip early in the forward moves everything after it by its gain
# through the later layers (1.75 to 2.97 bf16 ulps of each output's
# max|ref| on a 48-step model whose logits reach 350 to 580).
BF16_HEAD_RATIO = 2.0
LOSS_NAMES = ("loss/total", "loss/obj", "loss/cls", "loss/bbox", "loss/iou")
OPERATING_POINTS = {
    "serving": dict(conf_thresh=0.1, nms_thresh=0.45, pre_topk=128),
    "eval_strict": dict(conf_thresh=0.001, pre_topk=512, max_det=128),
}
# BGR colours of the synthetic shape classes: circle, rectangle, triangle
SHAPE_COLOURS = ((40, 40, 220), (60, 200, 60), (220, 80, 40))
IMAGE_MEAN = np.array((0.406, 0.456, 0.485), np.float32)  # BGR
IMAGE_STD = np.array((0.225, 0.224, 0.229), np.float32)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _smooth(img: np.ndarray) -> np.ndarray:
    """5-tap Gaussian (σ 2) blur along both axes, edges replicated."""
    k = np.exp(-0.5 * (np.arange(-2, 3) / 2.0) ** 2)
    k /= k.sum()
    out = img.astype(np.float32)
    for axis in (0, 1):
        pad = [(2, 2) if a == axis else (0, 0) for a in range(3)]
        p = np.pad(out, pad, mode="edge")
        n = out.shape[axis]
        out = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis)
                  for i in range(5))
    return out


def _paint(img: np.ndarray, cls: int, x1: int, y1: int, s: int) -> None:
    """One filled shape of side s at (x1, y1) into an [H, W, 3] image, in
    its class's colour: a circle, a square or a triangle."""
    yy, xx = np.mgrid[:img.shape[0], :img.shape[1]]
    cx, cy = x1 + s // 2, y1 + s // 2
    if cls == 0:
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= (s // 2) ** 2
    elif cls == 1:
        mask = (xx >= x1) & (xx <= x1 + s) & (yy >= y1) & (yy <= y1 + s)
    else:  # apex (cx, y1), base from (x1, y1+s) to (x1+s, y1+s)
        half = (yy - y1) / s * (s / 2)
        mask = (yy >= y1) & (yy <= y1 + s) & (np.abs(xx - cx) <= half)
    img[mask] = SHAPE_COLOURS[cls]


def render_scenes(n: int, size: int, seed: int = 0,
                  max_boxes: Optional[int] = None):
    """n scenes of 1-4 filled shapes on smoothed noise → [n,S,S,3] f32 RGB,
    normalized as the JAX package's val_transform: (img/255 − mean)/std in
    BGR, then flipped to RGB. With max_boxes, also each shape's box
    [n,max_boxes,4] (normalized corners) and class [n,max_boxes] (−1 pads),
    in the order drawn."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, size, size, 3), np.float32)
    boxes = np.zeros((n, max_boxes or 0, 4), np.float32)
    labels = np.full((n, max_boxes or 0), -1, np.int32)
    for i in range(n):
        img = _smooth(rng.integers(60, 190, (size, size, 3)))
        for j in range(int(rng.integers(1, 5))):
            s = int(rng.integers(50, 150))
            x1 = int(rng.integers(2, size - s - 2))
            y1 = int(rng.integers(2, size - s - 2))
            cls = int(rng.integers(3))
            if max_boxes:
                boxes[i, j] = np.array([x1, y1, x1 + s + 1, y1 + s + 1]) / size
                labels[i, j] = cls
            _paint(img, cls, x1, y1, s)
        img = np.rint(img).astype(np.uint8).astype(np.float32) / 255.0
        out[i] = ((img - IMAGE_MEAN) / IMAGE_STD)[..., ::-1]
    return out if max_boxes is None else (out, boxes, labels)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False
            ) -> float:
    """Mean ms per call on the card, bracketed by CUDA events. queued: the
    calls are enqueued behind a 25 ms device sleep, so that the events time
    the device's work alone and not the host's enqueue of it (a kernel of
    20 us would otherwise time its Python wrapper)."""
    for _ in range(warmup):
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


def host_ms(fn, reps: int = 5) -> float:
    """Least host ms to issue one call of fn with the card's queue empty
    (synchronized before each call, not after it)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return best


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(bound ms, 'bytes' or 'operations'): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / EFFECTIVE_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name, got, want, dtype, verbose: bool = True) -> float:
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if dtype == torch.float32:
        tol = 1e-4 * ref.max().item() + 1e-5
        ok = err.max().item() <= tol
        tol_s = f"{tol:.3g} (1e-4·max|ref| + 1e-5)"
    else:
        ok = bool((err <= 2e-2 + 2e-2 * ref).all())
        tol_s = "2e-2 + 2e-2·|ref|"
    max_err = err.max().item()
    if verbose:
        print(f"  {name}: max_abs_err {max_err:.3g}, tolerance {tol_s}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {max_err})")
    return max_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device_and_build():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from yolo_nano_tpu_torch.cli.common import card_line
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32
    from yolo_nano_tpu_torch.ops.kernels.build import build

    card = card_line("cuda")
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    set_full_f32()
    t0 = time.perf_counter()
    report = build(ptxas_info=True)
    for name, r in report.items():
        used = [ln.split("info    : ")[-1] for ln in r["log"].splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"  built {name} in {r['seconds']:.1f} s: {'; '.join(used)}")
    print(f"  build wall time {time.perf_counter() - t0:.1f} s")
    return card


def _trained_model():
    from yolo_nano_tpu_torch.convert import load_model

    model, _, _ = load_model(NPZ)
    return model.cuda()


def dw_pw_f64(x, dw_w, dw_b, pw_w, pw_b, act_mid, act_out):
    """fused_dw_pw's function in f64 (cuDNN on doubles): the reference the
    f32 rows' errors are measured against."""
    import torch.nn.functional as F

    from yolo_nano_tpu_torch.ops.nn import activate

    c = x.shape[1]
    y = F.conv2d(x.double(), dw_w.double().permute(2, 0, 1).unsqueeze(1),
                 dw_b.double(), padding=1, groups=c)
    y = activate(y, act_mid)
    y = F.conv2d(y, pw_w.double().t()[:, :, None, None], pw_b.double())
    return activate(y, act_out)


def check_bf16_pair(where, got, want, exact=None) -> dict:
    """A bf16 fused_dw_pw output against its plain version's (within
    BF16_BLOCK_ULPS of max|ref| and BF16_BLOCK_EQUAL bit-equal, else it
    raises) and, given the witness `exact`, both against it: → the ulps,
    the bit-equal share and the counts of outputs off the witness."""
    ulps = bf16_ulps(got, want)[0]
    same = float((got == want).float().mean())
    if ulps > BF16_BLOCK_ULPS or same < BF16_BLOCK_EQUAL:
        raise AssertionError(f"{where}: bf16 kernel {ulps:g} ulps of "
                             f"max|ref| (tolerance {BF16_BLOCK_ULPS}), "
                             f"{same:.5f} bit-equal (at least "
                             f"{BF16_BLOCK_EQUAL})")
    row = dict(ulps=ulps, bit_equal_share=same)
    if exact is not None:
        row.update(off_f64=int((got != exact).sum()),
                   plain_off_f64=int((want != exact).sum()), n=want.numel())
    return row


def check_witness(tag, rows) -> None:
    """Over rows of check_bf16_pair: the kernel's outputs off the witness
    within BF16_WITNESS_RATIO times the plain version's."""
    off = sum(r["off_f64"] for r in rows)
    plain = sum(r["plain_off_f64"] for r in rows)
    n = sum(r["n"] for r in rows)
    print(f"  {tag}: off the f64-sum witness: kernel {off / n:.6f} ({off}),"
          f" plain {plain / n:.6f} ({plain})")
    if off > BF16_WITNESS_RATIO * plain:
        raise AssertionError(f"{tag}: {off} kernel outputs off the f64-sum "
                             f"witness, over {BF16_WITNESS_RATIO}x the plain"
                             f" version's {plain}")


def phase_fused_dw_pw(model, dtypes=(torch.float32, torch.bfloat16),
                      acts=(("leaky", "leaky"), (None, "relu")), phase="[2]"):
    """Head dw→pw pairs at 52², 26², 13² (C = 96), each act pair and dtype,
    with the trained head weights of each level. The f32 rows are also
    held to f64; the bf16 rows in bf16 ulps and bit-equal share, and
    against the witness (check_bf16_pair, check_witness)."""
    import torch.nn.functional as F

    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain,
                                                            tile_shape)
    from yolo_nano_tpu_torch.ops.nn import activate

    print(f"{phase} fused_dw_pw vs plain, batch {BATCH}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for level, hw in enumerate((SIZE // 8, SIZE // 16, SIZE // 32)):
        head = getattr(model, f"head{level}")
        dw_w, dw_b, pw_w, pw_b = head._pairs()[0]
        c, cout = pw_w.shape
        for dtype in dtypes:
            x = torch.randn(BATCH, hw, hw, c, device="cuda", generator=gen,
                            dtype=torch.float32).to(dtype).permute(0, 3, 1, 2)
            w = pw_w.to(dtype)
            dw_conv = dw_w.permute(2, 0, 1).unsqueeze(1).to(dtype)
            pw_conv = w.t()[:, :, None, None]
            tile = tile_shape(BATCH, hw, hw, c, cout, x.element_size())
            for act_mid, act_out in acts:
                def kern():
                    return fused_dw_pw(x, dw_w, dw_b, w, pw_b,
                                       act_mid=act_mid, act_out=act_out)

                def plain():
                    return fused_dw_pw_plain(x, dw_w, dw_b, w, pw_b,
                                             act_mid=act_mid, act_out=act_out)

                def library():  # cuDNN: depthwise conv, then 1×1 conv
                    y = activate(F.conv2d(x, dw_conv, dw_b.to(dtype),
                                          padding=1, groups=c), act_mid)
                    return activate(F.conv2d(y, pw_conv, pw_b.to(dtype)),
                                    act_out)

                tag = (f"{hw}x{hw} {str(dtype)[6:]} "
                       f"{act_mid or 'none'}/{act_out} tile {tile[0]}x{tile[1]}")
                out, want = kern(), plain()
                if dtype == torch.float32:
                    err = check_close(tag, out, want, dtype)
                    row = dict(shape=tag, max_abs_err=err)
                    row["err_vs_f64"], row["plain_err_vs_f64"] = (
                        check_against_f64(tag, dw_pw_f64(
                            x, dw_w, dw_b, w, pw_b, act_mid, act_out),
                            out, want))
                else:
                    err = (out.float() - want.float()).abs().max().item()
                    row = dict(shape=tag, max_abs_err=err, **check_bf16_pair(
                        tag, out, want, fused_dw_pw_plain(
                            x, dw_w, dw_b, w, pw_b, act_mid=act_mid,
                            act_out=act_out, wide=torch.float64)))
                    print(f"  {tag}: {row['ulps']:.3g} bf16 ulps of max|ref|"
                          f", {row['bit_equal_share']:.6f} bit-equal, max abs"
                          f" err {err:.3g}")
                px = BATCH * hw * hw
                flops = px * (2 * 9 * c + 2 * c * cout)
                b_ms, b_by = bound(nbytes(x, dw_w, dw_b, w, pw_b, out), flops,
                                   dtype)
                row.update(ms=time_ms(kern, queued=True),
                           plain_ms=time_ms(plain, queued=True),
                           library_ms=time_ms(library, queued=True),
                           bound_ms=b_ms,
                           bound_by=b_by, dtype=str(dtype)[6:],
                           acts=f"{act_mid}/{act_out}")
                print(f"    kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f}"
                      f" ms, bound {b_ms * 1e3:.2f} us ({b_by})")
                rows.append(row)
    bf16_rows = [r for r in rows if r["dtype"] == "bfloat16"]
    if bf16_rows:
        check_witness(f"{phase} bf16 fused_dw_pw", bf16_rows)
    return rows


DW_PW_SIDES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 18, 20, 24,
               26, 32)
# (dtype, batch) of each sweep: the f32 kernel at the main path's batch,
# the bf16 kernel at the batches its tile rule is fitted to
DW_PW_SWEEPS = ((torch.float32, BATCH), (torch.bfloat16, BATCH),
                (torch.bfloat16, 8), (torch.bfloat16, 1))


def sweep_dw_pw_tiles(model):
    """fused_dw_pw at 52², 26², 13² (leaky/leaky, the trained pair-0 head
    weights) at every tile of DW_PW_SIDES × DW_PW_SIDES that fits, for each
    of DW_PW_SWEEPS: kernel ms, each output checked against the plain
    version (f32 by check_close, bf16 in ulps and bit-equal share). '*'
    marks tile_shape's pick; one JSON line per level holds every time."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (
        _launch, fused_dw_pw_plain, smem_bytes, tile_shape)

    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype, batch in DW_PW_SWEEPS:
        label = str(dtype)[6:]
        print(f"[sweep] {label} fused_dw_pw ms by tile (columns x rows), "
              f"batch {batch}")
        picked = best = 0.0
        for level, hw in enumerate((SIZE // 8, SIZE // 16, SIZE // 32)):
            dw_w, dw_b, pw_w, pw_b = getattr(model, f"head{level}")._pairs()[0]
            c, cout = pw_w.shape
            x = torch.randn(batch, hw, hw, c, device="cuda", generator=gen
                            ).to(dtype).permute(0, 3, 1, 2)
            args = (x, dw_w, dw_b, pw_w.to(dtype), pw_b, "leaky", "leaky")
            want = fused_dw_pw_plain(*args[:5])
            pick = tile_shape(batch, hw, hw, c, cout, x.element_size())
            grid = {(tw, th) for tw in DW_PW_SIDES for th in DW_PW_SIDES
                    if tw <= hw and th <= hw
                    and smem_bytes(tw, th, c, cout, dtype) <= SMEM_MAX}
            times = {}
            for tile in sorted(grid | {pick}):
                got = _launch(*args, tile=tile)
                where = f"{label} b{batch} {hw}x{hw} tile {tile[0]}x{tile[1]}"
                if dtype == torch.float32:
                    check_close(where, got, want, dtype, verbose=False)
                else:
                    check_bf16_pair(where, got, want)
                times[tile] = time_ms(lambda: _launch(*args, tile=tile),
                                      iters=10, queued=True)
            ranked = sorted(times.items(), key=lambda kv: kv[1])
            top = ", ".join(f"{t[0]}x{t[1]}{'*' if t == pick else ''} "
                            f"{ms:.4f}" for t, ms in ranked[:8])
            rank = [t for t, _ in ranked].index(pick) + 1
            print(f"  {hw}x{hw}: fastest {top}; pick {pick[0]}x{pick[1]} "
                  f"{times[pick]:.4f} ms, rank {rank} of {len(times)}")
            print(json.dumps({"dtype": label, "batch": batch, "level": hw,
                              "pick": f"{pick[0]}x{pick[1]}", "ms_by_tile": {
                                  f"{t[0]}x{t[1]}": ms
                                  for t, ms in times.items()}}))
            picked += times[pick]
            best += ranked[0][1]
        print(f"  {label} b{batch}, summed over the 3 levels: tile_shape's "
              f"picks {picked:.4f} ms, the fastest tile of each {best:.4f} ms")


def _stage_cost(x, blocks):
    """(flops, weight bytes) of a stage: multiply-adds ×2 of every 1×1 and
    depthwise 3×3 of its blocks, at this input's sizes; the weights once,
    as the function holds them (not the kernels' padded copies)."""
    b, cin, h, w = x.shape
    flops, wbytes = 0, 0
    for blk in blocks:
        c2 = blk["pw1_w"].shape[1]
        wbytes += nbytes(*(t for k, t in blk.items() if k != "stride"
                           and not k.endswith(("_pad", "_bf16"))))
        if blk["stride"] == 2:
            ho, wo = (h + 1) // 2, (w + 1) // 2
            po, pi = b * ho * wo, b * h * w
            flops += po * 2 * 9 * cin + po * 2 * cin * c2      # branch1
            flops += pi * 2 * cin * c2 + po * (2 * 9 * c2 + 2 * c2 * c2)
            h, w, cin = ho, wo, 2 * c2
        else:
            flops += b * h * w * (4 * c2 * c2 + 2 * 9 * c2)
    return flops, wbytes


def check_against_f64(tag, exact, got, want) -> tuple:
    """The kernel's and the plain version's (cuDNN f32) max abs error
    against the same function run in f64 on the same input. The kernels sum
    in another order than cuDNN, so their error against cuDNN alone cannot
    tell order from lost precision; it must stay within 4x cuDNN's own."""
    scale = exact.abs().max().item()
    err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    print(f"    against f64: kernel {err:.3g} ({err / scale:.3g} of max|ref|)"
          f", cuDNN f32 {plain_err:.3g} ({plain_err / scale:.3g}), ratio "
          f"{err / plain_err:.3g}")
    if not err <= 4 * plain_err:
        raise AssertionError(f"{tag}: kernel error against f64 {err} is over "
                             f"4x cuDNN f32's {plain_err}")
    return err, plain_err


def phase_fused_stage(model, images):
    """Stages 2/3/4 with the trained folded weights, on the main path's own
    activations for the rendered scenes, f32."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage, fused_stage_plain, prepare_stage)
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    print(f"[2] fused_stage vs plain, batch {BATCH}")
    bb = model.backbone
    with torch.inference_mode():
        x = max_pool_3x3_s2(bb.conv1(images.permute(0, 3, 1, 2)))
        x = x.contiguous(memory_format=torch.channels_last)
        rows = []
        for name in ("stage2", "stage3", "stage4"):
            blocks = prepare_stage(getattr(bb, name))
            want = fused_stage_plain(x, blocks)
            got = fused_stage(x, blocks)
            tag = f"{name} {tuple(x.shape)}→{tuple(want.shape)}"
            err = check_close(tag, got, want, torch.float32)
            blocks64 = [{k: v if k == "stride" else v.double()
                         for k, v in b.items()} for b in blocks]
            err64, plain_err64 = check_against_f64(
                tag, fused_stage_plain(x.double(), blocks64), got, want)
            flops, wbytes = _stage_cost(x, blocks)
            b_ms, b_by = bound(nbytes(x, want) + wbytes, flops, torch.float32)
            xx = x
            row = dict(shape=tag, max_abs_err=err, err_vs_f64=err64,
                       plain_err_vs_f64=plain_err64,
                       ms=time_ms(lambda: fused_stage(xx, blocks), queued=True),
                       plain_ms=time_ms(lambda: fused_stage_plain(xx, blocks),
                                        queued=True),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       launches_per_call=len(blocks))
            print(f"    kernel {row['ms']:.4f} ms ({len(blocks)} launches), "
                  f"plain {row['plain_ms']:.4f} ms, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by})")
            rows.append(row)
            x = want  # chain on the plain output
    return rows


# f32 operations a second off the tensor cores (H100 SXM), and the SM clock
# under load: the NMS kernel's bounds
F32_FLOPS = 67e12
SM_HZ = 1.98e9


def nms_candidates(npz, batch, point, tta, images_np):
    """The (boxes, valid, thresh, diou) of the last NMS call of a predict
    on `batch` scenes (the 32 rendered ones repeated) at an operating
    point: its own, or with tta the merge of tta_predictor's views."""
    from yolo_nano_tpu_torch.ops import nms
    from yolo_nano_tpu_torch.serving import load_predictor
    from yolo_nano_tpu_torch.utils.tta import tta_predictor

    fn = load_predictor(npz, **OPERATING_POINTS[point])
    if tta:
        fn = tta_predictor(fn.model, fn.cfg)
    x = np.concatenate([images_np] * -(-batch // len(images_np)))[:batch]
    seen, greedy = [], nms.nms_greedy

    def spy(boxes, valid, iou_thresh, diou=False):
        seen.append((boxes.clone(), valid.clone(), iou_thresh, diou))
        return greedy(boxes, valid, iou_thresh, diou)

    nms.nms_greedy = spy
    try:
        fn(x)
    finally:
        nms.nms_greedy = greedy
    return seen[-1]


def phase_nms(images_np):
    """The NMS kernel against its plain version (the fixpoint loop) on the
    card, on the candidates of each NMS_CASES predict: the keep sets bit
    for bit, the kernel's device ms (queued), the loop's ms (its host
    reads included) and the bound: the largest of its bytes over HBM, its
    K^2 / 2 overlap tests of 20 f32 operations over F32_FLOPS, and its
    sequential scan's latency (K + 30 cycles a kept candidate of the
    image that keeps the most, at SM_HZ). → one row per case."""
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import (nms_greedy,
                                                            nms_greedy_plain)

    print("[2] nms_greedy against its plain version (the fixpoint loop) on "
          "each case's candidates")
    rows = []
    for label, npz, batch, point, tta in NMS_CASES:
        boxes, valid, thresh, diou = nms_candidates(npz, batch, point, tta,
                                                    images_np)
        b, k = valid.shape
        keep = nms_greedy(boxes, valid, thresh, diou)
        want = nms_greedy_plain(boxes, valid, thresh, diou)
        if not torch.equal(keep, want):
            raise AssertionError(
                f"[2] nms_greedy {label}, batch {b}, K {k}: "
                f"{int((keep != want).sum())} keeps differ from the loop's")
        kept_max = int(keep.sum(-1).max())
        b_ms = dict(bytes=b * k * 18 / HBM_BYTES_PER_S * 1e3,
                    operations=b * k * (k - 1) / 2 * 20 / F32_FLOPS * 1e3,
                    scan=(k + 30 * kept_max) / SM_HZ * 1e3)
        by = max(b_ms, key=b_ms.get)
        row = dict(case=label, batch=b, k=k, thresh=thresh, diou=diou,
                   valid_mean=float(valid.float().sum(-1).mean()),
                   kept_mean=float(keep.float().sum(-1).mean()),
                   kept_max=kept_max, equal=True,
                   ms=time_ms(lambda: nms_greedy(boxes, valid, thresh, diou),
                              iters=50, queued=True),
                   plain_ms=time_ms(lambda: nms_greedy_plain(
                       boxes, valid, thresh, diou), iters=5),
                   bound_ms=b_ms[by], bound_by=by)
        rows.append(row)
        print(f"  {label}, batch {b}, K {k}: keep sets equal ("
              f"{row['valid_mean']:.1f} valid, {row['kept_mean']:.1f} kept "
              f"an image, at most {kept_max}); kernel {row['ms'] * 1e3:.2f} "
              f"us, loop {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({by})")
    return rows


# the scores kernel's cases: (label, dtype, batch) at SIZE px and 80
# classes: the benchmark's detection cells, the main path's batch, one image
SCORES_CASES = (("f32 cell", torch.float32, 256),
                ("bf16 cells", torch.bfloat16, 128),
                ("f32 main path", torch.float32, BATCH),
                ("bf16 main path", torch.bfloat16, BATCH),
                ("bf16 batch 1", torch.bfloat16, 1))


def phase_scores():
    """The scores kernel against its plain version (PyTorch's kernels on
    the card) on head outputs of each SCORES_CASES shape (logits drawn in
    [-8, 3), objectness normal): scores and classes bit for bit; the
    kernel's and the plain version's device us (queued) and host us to
    issue a call, and the bound: the logits and objectness read once and 8
    bytes a row written, over HBM. → one row per case."""
    from yolo_nano_tpu_torch.ops.kernels.scores import (scores, scores_plain,
                                                        scores_plan)

    n, c = 3 * sum((SIZE // s) ** 2 for s in (8, 16, 32)), 80
    print(f"[2] scores against its plain version, {n} rows of {c} classes "
          f"at {SIZE} px")
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(20)
    for label, dtype, b in SCORES_CASES:
        conf = (torch.randn((b, n, 1), generator=gen, device="cuda") * 3
                ).to(dtype)
        cls = (torch.rand((b, n, c), generator=gen, device="cuda") * 11 - 8
               ).to(dtype)
        got, want = scores(conf, cls), scores_plain(conf, cls)
        differ = [int((g != w).sum()) for g, w in zip(got, want)]
        if any(differ):
            raise AssertionError(f"[2] scores {label}: {differ[0]} scores and "
                                 f"{differ[1]} classes differ from the plain "
                                 "version's")
        size = dtype.itemsize
        bound_ms = b * n * (c * size + size + 8) / HBM_BYTES_PER_S * 1e3
        row = dict(case=label, dtype=str(dtype).split(".")[-1], batch=b,
                   rows=b * n, classes=c, equal=True,
                   plan=scores_plan(c, dtype, b * n),
                   ms=time_ms(lambda: scores(conf, cls), iters=50,
                              queued=True),
                   plain_ms=time_ms(lambda: scores_plain(conf, cls),
                                    iters=10, queued=True),
                   host_ms=host_ms(lambda: scores(conf, cls)),
                   plain_host_ms=host_ms(lambda: scores_plain(conf, cls)),
                   bound_ms=bound_ms, bound_by="bytes")
        rows.append(row)
        print(f"  {label}, batch {b}: scores and classes equal; kernel "
              f"{row['ms'] * 1e3:.2f} us ({row['plan']}), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"(bytes); host {row['host_ms'] * 1e3:.1f} us a call, plain "
              f"{row['plain_host_ms'] * 1e3:.1f}")
        del conf, cls, got, want
    return rows


def sweep_stage_tiles(model, x, label="f32"):
    """Every block launch of stages 2/3/4 at every tile side that fits, on
    the main path's activations x (the stage-2 input, f32 or bf16): kernel
    ms, each output checked against the plain block (f32: check_close;
    bf16: BF16_BLOCK_ULPS and BF16_BLOCK_EQUAL). '*' marks block_tile's
    pick; in bf16 each side also shows the blocks an SM holds at once."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _launch_block, _lib, block_plain, block_tile, prepare_stage,
        smem_bytes)

    dtype = x.dtype
    print(f"[sweep] fused_stage {label} block ms by tile side"
          + (" (blocks per SM)" if dtype == torch.bfloat16 else "")
          + f", batch {BATCH}")
    lib = _lib(dtype)
    bb = model.backbone
    picked = best = 0.0
    with torch.inference_mode():
        for name in ("stage2", "stage3", "stage4"):
            for i, w in enumerate(prepare_stage(getattr(bb, name))):
                b, cin, h, wd = x.shape
                s, c2 = w["stride"], w["pw1_w"].shape[1]
                ho, wo = (h - 1) // s + 1, (wd - 1) // s + 1
                want = block_plain(x, w)
                pick = block_tile(s, cin, c2, b, ho, wo, dtype)
                times, occ = {}, {}
                for tile in range(1, 17):
                    if smem_bytes(tile, s, cin, c2, dtype) > SMEM_MAX:
                        continue
                    got = _launch_block(lib, x, w, tile)
                    where = f"{label} {name}[{i}] tile {tile}"
                    if dtype == torch.float32:
                        check_close(where, got, want, dtype)
                    else:
                        ulps = bf16_ulps(got, want)[0]
                        same = float((got == want).float().mean())
                        if ulps > BF16_BLOCK_ULPS or same < BF16_BLOCK_EQUAL:
                            raise AssertionError(f"{where}: {ulps:g} ulps, "
                                                 f"{same:.5f} bit-equal")
                        occ[tile] = lib.shuffle_block_bf16_blocks_per_sm(
                            tile, s, cin, c2)
                    times[tile] = time_ms(
                        lambda: _launch_block(lib, x, w, tile), iters=10,
                        queued=True)
                sides = ", ".join(
                    f"{t}{'*' if t == pick else ''}"
                    + (f" ({occ[t]})" if t in occ else "") + f" {ms:.4f}"
                    for t, ms in times.items())
                print(f"  {name}[{i}] {tuple(x.shape)} stride {s}: {sides}")
                picked += times[pick]
                best += min(times.values())
                x = want
    print(f"  {label}, summed over the 16 launches: block_tile's picks "
          f"{picked:.4f} ms, the fastest side of each {best:.4f} ms")


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls, the scores and NMS to their plain
    versions, for the comparison run only."""
    from yolo_nano_tpu_torch.models import nanodet_plus, shufflenetv2, yolo_nano
    from yolo_nano_tpu_torch.ops import nms
    from yolo_nano_tpu_torch.ops.kernels import (fused_conv, fused_stage,
                                                 nms_greedy, scores)

    saved = (shufflenetv2.fused_stage, yolo_nano.fused_dw_pw,
             nanodet_plus.fused_dw_pw, nms.nms_greedy, yolo_nano.scores)
    shufflenetv2.fused_stage = fused_stage.fused_stage_plain
    yolo_nano.fused_dw_pw = fused_conv.fused_dw_pw_plain
    nanodet_plus.fused_dw_pw = fused_conv.fused_dw_pw_plain
    nms.nms_greedy = nms_greedy.nms_greedy_plain
    yolo_nano.scores = scores.scores_plain
    try:
        yield
    finally:
        (shufflenetv2.fused_stage, yolo_nano.fused_dw_pw,
         nanodet_plus.fused_dw_pw, nms.nms_greedy, yolo_nano.scores) = saved


def reset_counts():
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import fused_stage
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy
    from yolo_nano_tpu_torch.ops.kernels.scores import scores

    fused_dw_pw.launches = fused_dw_pw.launches_bf16 = 0
    fused_stage.calls = 0
    fused_stage.launches = fused_stage.launches_bf16 = 0
    nms_greedy.launches = 0
    scores.launches = 0


def read_counts():
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import fused_stage
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy
    from yolo_nano_tpu_torch.ops.kernels.scores import scores

    return dict(fused_dw_pw=fused_dw_pw.launches,
                fused_dw_pw_bf16=fused_dw_pw.launches_bf16,
                fused_stage_calls=fused_stage.calls,
                fused_stage=fused_stage.launches,
                fused_stage_bf16=fused_stage.launches_bf16,
                nms_greedy=nms_greedy.launches,
                scores=scores.launches)


def want_counts(forwards: int, bf16: bool, nms: Optional[int] = None
                ) -> dict:
    """Launches of `forwards` forwards: 16 stage blocks and 6 head pairs
    each, all in bf16 or none, and one scores launch each (every forward
    here is scored: a predict's, a TTA view's, a candidate count's); and
    `nms` NMS launches, by default one a forward (a predict's; TTA adds its
    merge, a candidate count has none)."""
    return dict(fused_dw_pw=6 * forwards,
                fused_dw_pw_bf16=6 * forwards * bf16,
                fused_stage_calls=3 * forwards, fused_stage=16 * forwards,
                fused_stage_bf16=16 * forwards * bf16,
                nms_greedy=forwards if nms is None else nms,
                scores=forwards)


def check_detections(point, got, plain, tol=1e-4, tie_rtol=0.0) -> int:
    """The kernel path's detections against the plain-version predict, slot
    for slot: valid and classes equal, scores and boxes within tol. With
    tie_rtol, a valid slot may hold another detection where the two paths'
    scores there agree within tie_rtol of the score: a near tie, which any
    f32 summation order can flip. A failure names the first image and slot
    that differ, with both scores. → the number of such near-tie slots."""
    b, s, c, v = got
    pb, ps, pc, pv = plain
    bad = ((v != pv) | (c != pc) | (np.abs(s - ps) > tol)
           | (np.abs(b - pb).max(-1) > tol))
    ties = bad & v & pv & (np.abs(s - ps) <= tie_rtol * np.abs(ps))
    bad &= ~ties
    if bad.any():
        img, k = np.argwhere(bad)[0]
        raise AssertionError(
            f"{point}: {int(bad.sum())} slots differ from the plain-version "
            f"predict; first image {img} slot {k}: class {c[img, k]} score "
            f"{s[img, k]:.9g} valid {v[img, k]}, plain class {pc[img, k]} "
            f"score {ps[img, k]:.9g} valid {pv[img, k]}")
    return int(ties.sum())


def _iou(a, b) -> float:
    tl, br = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(br - tl, 0, None))
    return inter / (np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter)


def match_detections(got, want, conf_thresh, nms_thresh, score_atol,
                     score_rtol, iou_tol, cutoffs=None) -> dict:
    """Two bf16 predicts' detections, image by image: matched one to one
    by class with box IoU >= 0.9 and |Δscore| <= score_atol +
    score_rtol·score; then the rest one to one across classes by the same
    rule (a class flip: the top two class logits within bf16's precision
    of each other). A detection left unmatched must be explained:
      near_conf: within that tolerance of conf_thresh;
      swapped: within it of an unmatched detection of its class on the
        other side (the two took each other's place);
      nms_flip: an IoU within iou_tol of nms_thresh with a detection of its
        class kept above it on its side (an NMS suppression flipped);
      nms_chain: an IoU above nms_thresh − iou_tol with a detection of its
        class on the other side that scores above it less the tolerance
        (it would be suppressed there: a flip earlier in NMS's order
        changed which of the two survived);
      class_nms: the same with a detection of another class (there its top
        two class logits gave that class, and NMS, per class, suppressed
        it);
      cut: within the tolerance of a cut, a full side's lowest score
        (max_det) or, from `cutoffs` [B, 2], a side's pre_topk-th
        candidate score.
    → the count of each, and "score_rdiff", the largest |Δscore| / score
    over the matched pairs; raises, naming each detection no rule explains
    and its nearest on the other side."""
    tol = lambda s: score_atol + score_rtol * s  # noqa: E731
    counts = dict(matched=0, class_flip=0, near_conf=0, swapped=0,
                  nms_flip=0, nms_chain=0, class_nms=0, cut=0,
                  score_rdiff=0.0)
    unexplained = []
    for i in range(got[0].shape[0]):
        sides = [[(o[0][i][k], float(o[1][i][k]), int(o[2][i][k]))
                  for k in np.flatnonzero(o[3][i])] for o in (got, want)]
        used = [set(), set()]
        for key, same_class in (("matched", True), ("class_flip", False)):
            for wi, (wb, ws, wc) in enumerate(sides[1]):
                if wi in used[1]:
                    continue
                cands = [(_iou(wb, gb), gi) for gi, (gb, gs, gc)
                         in enumerate(sides[0]) if gi not in used[0]
                         and (gc == wc) == same_class
                         and abs(gs - ws) <= tol(max(gs, ws))]
                best = max(cands, default=(0.0, None))
                if best[0] >= 0.9:
                    used[0].add(best[1])
                    used[1].add(wi)
                    counts[key] += 1
                    gs = sides[0][best[1]][1]
                    counts["score_rdiff"] = max(counts["score_rdiff"],
                                                abs(gs - ws) / max(gs, ws))
        left = [[d for j, d in enumerate(side) if j not in used[k]]
                for k, side in enumerate(sides)]
        # the lowest score of a side that fills every slot
        cuts = [min(d[1] for d in side) for side in sides
                if len(side) == got[3].shape[1]]
        if cutoffs is not None:
            cuts += [float(c) for c in cutoffs[i]]
        for k in (0, 1):
            for box, s, c in left[k]:
                if abs(s - conf_thresh) <= tol(s):
                    counts["near_conf"] += 1
                elif any(c2 == c and abs(s - s2) <= tol(max(s, s2))
                         for _, s2, c2 in left[1 - k]):
                    counts["swapped"] += 1
                elif any(c2 == c and s2 > s and abs(_iou(box, b2)
                                                     - nms_thresh) <= iou_tol
                         for b2, s2, c2 in sides[k]):
                    counts["nms_flip"] += 1
                elif any(c2 == c and s2 >= s - tol(s) and _iou(box, b2)
                         > nms_thresh - iou_tol
                         for b2, s2, c2 in sides[1 - k]):
                    counts["nms_chain"] += 1
                elif any(c2 != c and s2 >= s - tol(s) and _iou(box, b2)
                         > nms_thresh - iou_tol
                         for b2, s2, c2 in sides[1 - k]):
                    counts["class_nms"] += 1
                elif any(abs(s - cut) <= tol(cut) for cut in cuts):
                    counts["cut"] += 1
                else:
                    near = max(sides[1 - k], default=None,
                               key=lambda d: _iou(box, d[0]))
                    same = [(round(float(_iou(box, b2)), 4), round(s2, 6))
                            for b2, s2, c2 in sides[0] + sides[1]
                            if c2 == c and _iou(box, b2) > 0.3]
                    unexplained.append(
                        f"image {i}: a detection of class {c}, score "
                        f"{s:.6g}, box {box}, on side {k} (0: the first) "
                        f"has no counterpart on the other, whose nearest "
                        f"is {near} (IoU "
                        f"{_iou(box, near[0]) if near else 0:.4g}); "
                        f"detections {len(sides[0])} / {len(sides[1])}, "
                        f"cuts {[round(c_, 6) for c_ in cuts]}, (IoU, "
                        f"score) of its class on both sides {same}")
    if unexplained:
        raise AssertionError(f"{len(unexplained)} detections unexplained "
                             f"({counts}): " + "; ".join(unexplained[:6]))
    return counts


def head_witness(tag, heads, plain_heads, witness) -> dict:
    """bf16 head outputs of the kernel and of the plain path, each one's
    RMS distance from the f32 witness's: the kernel's within
    BF16_HEAD_RATIO times the plain path's. → {name: (kernel RMS, plain
    RMS, their ratio)}."""
    out = {}
    for name, g, w, ref in zip(("conf", "cls", "txtytwth"), heads,
                               plain_heads, witness):
        rms = [(t.float() - ref).square().mean().sqrt().item()
               for t in (g, w)]
        out[name] = (rms[0], rms[1], rms[0] / rms[1])
        if not rms[0] <= BF16_HEAD_RATIO * rms[1]:
            raise AssertionError(f"{tag}: head output {name} is {rms[0]} off "
                                 f"the f32 witness, the plain path {rms[1]}")
    print(f"  {tag}: head outputs' RMS off the f32 witness, kernel / plain: "
          + "; ".join(f"{n} {k:.4g} / {p:.4g} ({r:.3f}x)"
                      for n, (k, p, r) in out.items())
          + f", tolerance {BF16_HEAD_RATIO}x")
    return out


def kernel_vs_plain(fn, images_np):
    """The bf16 forward on the kernel path and on the plain path: each head
    output's share of bit-equal elements and max abs difference (printed,
    and returned), each one's RMS off the f32 witness (`head_witness`, held
    to BF16_HEAD_RATIO), and [B, 2] each image's pre_topk-th candidate
    score on each path (a candidate near it is kept on one side only)."""
    from yolo_nano_tpu_torch.models.yolo_nano import scores_from_features

    x = torch.from_numpy(images_np).cuda().to(fn.dtype)
    outs, cutoffs = [], []
    for ctx in (contextlib.nullcontext(), plain_kernels()):
        with ctx, torch.inference_mode():
            heads = fn.model(x)
            score = scores_from_features(*heads[:2])[0]
            k = min(fn.cfg.nms_pre_topk, score.shape[1])
            cutoffs.append(torch.topk(score, k, dim=1).values[:, -1].cpu(
                ).numpy())
            outs.append(heads)
    with torch.inference_mode(), plain_kernels():
        witness = copy.deepcopy(fn.model).float()(x.float())
    heads = {}
    for name, g, w in zip(("conf", "cls", "txtytwth"), *outs):
        heads[name] = dict(bit_equal=float((g == w).float().mean()),
                           max_abs_diff=(g.float() - w.float()).abs().max(
                               ).item())
    print("  head outputs, kernel path against plain path: " + "; ".join(
        f"{n} {h['bit_equal']:.5f} bit-equal, max |diff| "
        f"{h['max_abs_diff']:.3g}" for n, h in heads.items()))
    for name, r in head_witness("bf16", *outs, witness).items():
        heads[name]["witness_rms"] = r
    return heads, np.stack(cutoffs, 1)


def phase_main_path(images_np, npz=NPZ, phase="[3]"):
    """load_predictor on a folded artifact (f32, or bf16 with its bf16
    detection allowance) at both operating points."""
    from yolo_nano_tpu_torch.models.yolo_nano import (postprocess_scored,
                                                      scores_from_features)
    from yolo_nano_tpu_torch.ops.kernels.scores import scores_plain
    from yolo_nano_tpu_torch.serving import load_predictor

    print(f"{phase} main path: load_predictor({os.path.relpath(npz, ROOT)}), "
          f"{BATCH} scenes at {SIZE}")
    fns = {p: load_predictor(npz, **kw) for p, kw in OPERATING_POINTS.items()}
    for fn in fns.values():
        if fn.device.type != "cuda":
            raise AssertionError(f"predictor on {fn.device}, not CUDA")
        fn(images_np)  # warm-up
    bf16 = fn.dtype == torch.bfloat16

    reset_counts()
    outs = {p: fn(images_np) for p, fn in fns.items()}
    counts = read_counts()
    print(f"  launch counts over {len(fns)} forwards: {counts}")
    want = want_counts(len(fns), bf16)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")

    stats = {}
    for point, fn in fns.items():
        with plain_kernels():
            plain = fn(images_np)
        got = outs[point]
        if bf16:
            heads, cutoffs = kernel_vs_plain(fn, images_np)
            agree = match_detections(got, plain, fn.cfg.conf_thresh,
                                     fn.cfg.nms_thresh, **BF16_MATCH,
                                     cutoffs=cutoffs)
            agree["heads"] = heads
        else:
            agree = check_detections(point, got, plain)
        b, s, c, v = got
        if b.shape != (BATCH, fn.cfg.max_detections, 4) or not (
                np.isfinite(b).all() and np.isfinite(s).all()):
            raise AssertionError(f"{point}: bad output {b.shape}")
        if (b[v] < 0).any() or (b[v] > 1).any():
            raise AssertionError(f"{point}: boxes outside [0, 1]")

        model, cfg = fn.model, fn.cfg
        x = torch.from_numpy(images_np).cuda().to(fn.dtype)
        with torch.inference_mode():
            conf, cls, txty = model(x)
            score, cidx = scores_from_features(conf, cls)
            cands = float((score >= cfg.conf_thresh).sum(1).float().mean())
            fwd_ms = time_ms(lambda: model(x), iters=10)
            by_kernel = (forward_kernels(lambda: model(x))
                         if point == "serving" else None)
            sc_ms = time_ms(lambda: scores_from_features(conf, cls), iters=10)
            sc_plain_ms = time_ms(lambda: scores_plain(conf, cls), iters=10)
            pp_ms = time_ms(lambda: postprocess_scored(txty, score, cidx, cfg,
                                                       SIZE), iters=10)
        iters = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            x = torch.from_numpy(images_np).to("cuda")
            torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) / iters * 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(images_np)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / iters * 1e3
        stats[point] = dict(img_per_s=BATCH / step_ms * 1e3,
                            mean_candidates_per_img=cands,
                            detections_per_img=float(v.sum(1).mean()),
                            batch_ms=step_ms, host_to_device_ms=h2d_ms,
                            forward_ms=fwd_ms, scores_ms=sc_ms,
                            scores_plain_ms=sc_plain_ms,
                            postprocess_ms=pp_ms,
                            forward_kernels_ms=by_kernel,
                            **({"matches": agree} if bf16
                               else {"near_tie_slots": agree}),
                            equal_slots=int(((got[3] == plain[3])
                                             & (got[2] == plain[2])
                                             & (got[1] == plain[1])).sum()))
        print(f"  {point}: {stats[point]['img_per_s']:.1f} img/s (numpy in, "
              f"numpy out), {cands:.2f} candidates/img, "
              f"{stats[point]['detections_per_img']:.2f} detections/img; per "
              f"batch {step_ms:.3f} ms: host→device copy {h2d_ms:.3f} ms, "
              f"forward {fwd_ms:.3f} ms, scores {sc_ms:.3f} ms (plain "
              f"{sc_plain_ms:.3f}), postprocess "
              f"{pp_ms:.3f} ms; matches plain predict ("
              + (f"matched { {k: v for k, v in agree.items() if k != 'heads'} }"
                 if bf16 else f"{agree} near-tie slots")
              + f"; {stats[point]['equal_slots']} of {v.size} slots "
              "bit-equal)")
    if not stats["eval_strict"]["mean_candidates_per_img"] > 0:
        raise AssertionError("eval-strict: no candidates, NMS did no work")
    return counts, stats


def fields_close(what, got, cpu, ref):
    """The card's train state `got` against the CPU's f32 step `cpu` and
    its f64 step `ref`. Per field, the card's error against f64 (the root
    of its summed squares over the field's tensors) must be within 4x the
    CPU f32 step's, plus 1e-7 of the field's norm; count and step equal.
    The field and not each tensor: where a BN'd conv's weights are small
    its gradient is large and cancels, and either device's f32 rounding
    moves single tensors by 1e-4 to 1e-3 of themselves, now one device
    further, now the other. → ({field: (card error, CPU f32 error) over
    the field's norm}, the worst tensor's error against the CPU f32 step
    over the CPU tests' leaf tolerance, tests/test_torch_train.py)."""
    g, c, r = got.flat(), cpu.flat(), ref.flat()
    if not g.keys() == c.keys() == r.keys():
        raise AssertionError(f"{what}: the states hold other tensors")
    errors, worst_leaf = {}, 0.0
    for field in ("params", "stats", "trace", "ema_params", "ema_stats"):
        keys = [k for k in r if k.startswith(field + "/")]
        top = max(r[k].abs().max().item() for k in keys)
        atol = max(TRAIN_LEAF_ATOL, TRAIN_FIELD_ATOL * top)
        sq = np.zeros(3)
        for k in keys:
            exact = r[k]
            card = g[k].cpu()
            sq += [(card.double() - exact).square().sum().item(),
                   (c[k].double() - exact).square().sum().item(),
                   exact.square().sum().item()]
            tol = TRAIN_LEAF_RTOL * exact.abs().max().item() + atol
            worst_leaf = max(worst_leaf,
                             (card - c[k]).abs().max().item() / tol)
        card_err, cpu_err, norm = np.sqrt(sq)
        errors[field] = (card_err / norm, cpu_err / norm)
        if not card_err <= 4 * cpu_err + 1e-7 * norm:
            raise AssertionError(
                f"{what}: {field} error against f64 {card_err / norm:.3g} of "
                f"its norm, over 4x the CPU f32's {cpu_err / norm:.3g}")
    for k in ("count", "step"):
        if not int(g[k]) == int(c[k]) == int(r[k]):
            raise AssertionError(f"{what}: {k} {int(g[k])} != {int(c[k])}")
    return errors, worst_leaf


def collision_gts(size, n=4, groups=6):
    """Ground truths made to collide: in each image `groups` boxes of one
    centre at sizes growing by 1.15x (each above the ignore threshold on
    its neighbours' anchors), each followed by a copy with another class
    (a positive/positive collision)."""
    rng = np.random.default_rng(3)
    boxes = np.zeros((n, MAX_BOXES, 4), np.float32)
    labels = np.full((n, MAX_BOXES), -1, np.int32)
    for i in range(n):
        j = 0
        for _ in range(groups):
            c = rng.uniform(0.2, 0.8, 2)
            base = rng.uniform(12, 60)
            for k in range(4):
                half = base * 1.15 ** k / size / 2
                box = np.clip(np.concatenate([c - half, c + half]), 0, 1)
                cls = int(rng.integers(80))
                boxes[i, j:j + 2] = box
                labels[i, j:j + 2] = cls, (cls + 1) % 80
                j += 2
    return boxes, labels


def check_targets_on_card(step, cpu_step):
    """build_targets on CUDA against the CPU on colliding ground truths:
    equal (tw, th within 1e-6: log on two devices), and the row of every
    gt's best anchor positive, though other gts ignore it."""
    boxes, labels = collision_gts(SIZE)
    tb, tl = torch.from_numpy(boxes), torch.from_numpy(labels)
    got = step.targets(tb.cuda(), tl.cuda()).cpu()
    want = cpu_step.targets(tb, tl)
    exact = [0, 1, 2, 3, 6, 7, 8, 9, 10]
    if not torch.equal(got[..., exact], want[..., exact]) or (
            got[..., 4:6] - want[..., 4:6]).abs().max().item() > 1e-6:
        raise AssertionError("build_targets on CUDA differs from the CPU")
    overruled = 0
    for i in range(boxes.shape[0]):
        alone = [cpu_step.targets(tb[i:i + 1, j:j + 1], tl[i:i + 1, j:j + 1])[0]
                 for j in range(MAX_BOXES) if labels[i, j] >= 0]
        for j, t in enumerate(alone):
            pos = t[:, 0] == 1
            if not (got[i][pos, 0] == 1).all():
                raise AssertionError(f"image {i} gt {j}: its positive row "
                                     "lost to another write")
            overruled += sum(int((o[pos, 0] == -1).sum())
                             for k, o in enumerate(alone) if k != j)
    if not overruled:
        raise AssertionError("the colliding inputs hold no ignore/positive "
                             "collision")
    print(f"  build_targets on CUDA equals the CPU on {boxes.shape[0]} images "
          f"of colliding gts; {overruled} ignore writes landed on positive "
          f"rows and lost to them")


def backward_ms(step, state, images, targets, iters=10) -> float:
    """Mean ms of the backward pass alone: CUDA events around each
    autograd.grad, its forward run before the start event."""
    times = []
    for i in range(iters + 2):
        total, _, params, _ = step.loss(state, images, targets)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(total, list(params.values()))
        end.record()
        if i >= 2:
            times.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in times) / iters


def forward_kernels(fn, top: int = 10, iters: int = 3):
    """Device time per call of the `top` CUDA kernels (by name) of fn,
    from torch.profiler, printed and returned as {name: ms}, with the sum
    over all its kernels and their number per call; None (the reason
    printed) if the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
    except (RuntimeError, AttributeError) as e:
        print(f"  forward by kernel: not measured ({e})")
        return None
    by_name = {}
    for e in events:  # "void ns::kernel<T>(args...)" → "kernel<T>"
        name = e.key.replace("void ", "").replace("(anonymous namespace)::",
                                                  "")
        name = name.split("(")[0][:72]
        by_name[name] = (by_name.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / iters)
    total = sum(by_name.values())
    launched = sum(e.count for e in events) / iters
    out = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    print(f"  forward by kernel, device ms per forward (all {launched:g} "
          f"kernels {total:.3f}): " + "; ".join(f"{k} {v:.3f}"
                                                for k, v in out.items()))
    return dict(out, all_kernels=total, kernels_per_call=launched)


def device_busy_ms(fn, iters: int = 3):
    """Summed kernel time per call, from torch.profiler's CUDA events over
    `iters` calls; None (with the reason printed) if the profiler records
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    except (RuntimeError, AttributeError) as e:
        print(f"  device busy time: not measured ({e})")
        return None
    if not us:
        print("  device busy time: not measured (the profiler saw no kernel)")
        return None
    return us / 1e3 / iters


def phase_training():
    """The training path on the card at the artifact's configuration (1.0x
    COCO, 416 px), batch 16, f32 with TF32 off, from init_yolo_nano with a
    seeded generator, on rendered scenes with their boxes."""
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz, model_from_state
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano, predict
    from yolo_nano_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step)
    from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn

    cfg = config_from_json(load_npz(NPZ)[1])
    print(f"[4] training: {cfg.backbone} backbone, {cfg.num_classes} classes, "
          f"{SIZE} px, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps at constant "
          f"lr {TRAIN_LR}, EMA on")
    images, boxes, labels = (torch.from_numpy(a).cuda() for a in render_scenes(
        TRAIN_BATCH, SIZE, seed=1, max_boxes=MAX_BOXES))
    # cuDNN's deterministic algorithms until the fold→predict check: the
    # trained model, and with it the near ties among its detections, is
    # then the same in every run (the timing below runs without them)
    torch.backends.cudnn.deterministic = True
    tx = make_optimizer(lambda count: TRAIN_LR)
    model = init_yolo_nano(torch.Generator().manual_seed(0), cfg)
    state = start = create_train_state(model, tx, use_ema=True)
    step = make_train_step(cfg, tx, SIZE)
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, images, boxes, labels)
        losses.append(torch.stack([metrics[k] for k in LOSS_NAMES]))
    losses = torch.stack(losses).cpu().numpy()       # [steps, 5]
    first, last = losses[0, 0], losses[-1, 0]
    checksum = sum(v.double().sum() for v in state.params.values()).item()
    print(f"  overfit: total loss {first:.4f} → {last:.9g}, "
          f"{last / first:.3f} of the first (params sum {checksum!r}); last "
          + ", ".join(f"{k} {v:.4f}" for k, v in zip(LOSS_NAMES[1:],
                                                      losses[-1, 1:])))
    if not np.isfinite(losses).all():
        raise AssertionError("a training loss is not finite")
    if int(state.step) != TRAIN_STEPS or int(state.count) != TRAIN_STEPS:
        raise AssertionError(f"step {int(state.step)}, count "
                             f"{int(state.count)} after {TRAIN_STEPS} steps")
    if not last < 0.8 * first:
        raise AssertionError(f"loss fell only to {last / first:.3f} of the "
                             "first, not below 0.8")

    cpu_step = make_train_step(cfg, tx, SIZE, device="cpu")
    check_targets_on_card(step, cpu_step)

    # NaN guard: a NaN image leaves every state tensor bit-identical, and
    # neither step makes the host wait on the card
    bad = images.clone()
    bad[0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in state.flat().items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ok_state, _ = step(state, images, boxes, labels)
        nan_state, nan_metrics = step(state, bad, boxes, labels)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if int(nan_metrics["skipped_nonfinite"]) != 1 or int(ok_state.step) != \
            TRAIN_STEPS + 1:
        raise AssertionError("the NaN batch was not skipped")
    after = nan_state.flat()
    changed = [k for k, v in before.items() if not torch.equal(after[k], v)]
    if changed:
        raise AssertionError(f"the NaN step changed {changed[:5]}")
    print(f"  NaN guard: all {len(before)} state tensors bit-identical after "
          "a NaN batch; the good and the NaN step ran under "
          "set_sync_debug_mode('error')")

    # multi-scale: steps built for other sizes, fed the 416 px batch
    for size in (320, 608):
        s, m = make_train_step(cfg, tx, size)(state, images, boxes, labels)
        if not np.isfinite(float(m["loss/total"])) or int(s.step) != \
                TRAIN_STEPS + 1:
            raise AssertionError(f"multi-scale step at {size} failed")
        print(f"  multi-scale {SIZE}→{size} px: loss "
              f"{float(m['loss/total']):.4f}")

    # the trained model, folded, through both kernels: its head outputs
    # and its detections against the plain versions
    folded = fold_bn(model_from_state(state, cfg))
    with torch.inference_mode():
        predict(folded, images, cfg, SIZE)          # warm-up
        reset_counts()
        got = predict(folded, images, cfg, SIZE)
        counts = read_counts()
        features = folded(images)
        with plain_kernels():
            plain = predict(folded, images, cfg, SIZE)
            plain_features = folded(images)
    want = want_counts(1, bf16=False)
    if counts != want:
        raise AssertionError(f"fold→predict launch counts {counts}, expected "
                             f"{want}")
    for name, g, w in zip(("conf", "cls", "txtytwth"), features,
                          plain_features):
        check_close(f"trained, folded: head output {name}", g, w,
                    torch.float32)
    got, plain = ([t.cpu().numpy() for t in r] for r in (got, plain))
    ties = check_detections("trained, folded", got, plain,
                            tie_rtol=TIE_RTOL)
    print(f"  fold→predict: launches {counts}; {int(got[3].sum())} "
          f"detections match the plain-version predict slot for slot, "
          f"{ties} of them near ties (scores within {TIE_RTOL:g} of each "
          "other) that took each other's slots")

    # times at batch 16, by CUDA events
    torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, images, boxes, labels), iters=10)
    peak = torch.cuda.max_memory_allocated()
    busy_ms = device_busy_ms(lambda: step(state, images, boxes, labels))
    targets = step.targets(boxes, labels)
    total, _, params, stats = step.loss(state, images, targets)
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    parts = dict(
        build_targets_ms=time_ms(lambda: step.targets(boxes, labels)),
        forward_loss_ms=time_ms(lambda: step.loss(state, images, targets),
                                iters=10),
        backward_ms=backward_ms(step, state, images, targets),
        update_ema_ms=time_ms(lambda: step.update(state, total.detach(),
                                                  grads, stats), iters=10))
    # one step from the initial state and one batch on the card and on the
    # CPU, in f32 and in f64
    small = (images[:CPU_BATCH], boxes[:CPU_BATCH], labels[:CPU_BATCH])
    cpu_small = [t.cpu() for t in small]
    t0 = time.perf_counter()
    cpu_state, cpu_metrics = cpu_step(start.to("cpu"), *cpu_small)
    cpu_s = time.perf_counter() - t0
    ref_state, _ = cpu_step(start.to("cpu", torch.float64),
                            cpu_small[0].double(), *cpu_small[1:])
    card_state, card_metrics = step(start, *small)
    for k in LOSS_NAMES:
        g, w = float(card_metrics[k]), float(cpu_metrics[k])
        if not abs(g - w) <= TRAIN_LOSS_RTOL * abs(w):
            raise AssertionError(f"card vs CPU: {k} {g} vs {w}")
    errors, worst_leaf = fields_close("card vs CPU", card_state, cpu_state,
                                      ref_state)
    print(f"  card vs CPU, one step from init at batch {CPU_BATCH}: losses "
          f"within rtol {TRAIN_LOSS_RTOL}; error against the CPU's f64 step "
          "over each field's norm, card / CPU f32: " + ", ".join(
              f"{f} {e[0]:.3g} / {e[1]:.3g}" for f, e in errors.items())
          + f"; the worst tensor against the CPU f32 step at {worst_leaf:.3g}"
          f" of the CPU tests' leaf tolerance; the CPU f32 step took "
          f"{cpu_s:.1f} s")
    stats_out = dict(batch=TRAIN_BATCH, size=SIZE, step_ms=step_ms,
                     img_per_s=TRAIN_BATCH / step_ms * 1e3,
                     max_memory_allocated_bytes=peak,
                     device_busy_ms=busy_ms, **parts,
                     first_loss=float(first), last_loss=float(last),
                     card_vs_cpu_f64_errors=errors,
                     card_vs_cpu_worst_leaf=worst_leaf, cpu_step_s=cpu_s)
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.2f} ms ({busy_ms / step_ms:.3f} of the step)")
    print(f"  train step {step_ms:.2f} ms at batch {TRAIN_BATCH} "
          f"({stats_out['img_per_s']:.1f} img/s), kernels busy {busy}, "
          f"peak memory "
          f"{peak / 2**30:.2f} GiB; build_targets "
          f"{parts['build_targets_ms']:.3f} ms, forward+loss "
          f"{parts['forward_loss_ms']:.2f} ms, backward "
          f"{parts['backward_ms']:.2f} ms, update+EMA "
          f"{parts['update_ema_ms']:.2f} ms")
    return counts, stats_out, state


def bf16_ulps(got, want) -> tuple:
    """|got − want| in bf16 ulps: (the largest in ulps of max|want|, the
    largest in ulps of each element's own max(|want|, 2^-8·max|want|))."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max().item()
    mag = torch.clamp(want.abs(), min=2.0 ** -8 * top)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    top_ulp = 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
    return err.max().item() / top_ulp, (err / ulp).max().item()


def block_launch_row(lib, x, w, want, dtype, iters: int = 20,
                     act: str = "relu") -> dict:
    """One stage-block launch on x: its stride, input shape, the tile its
    kernel's rule picks, device ms per launch and bound."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (_launch_block,
                                                             block_tile)

    flops, wbytes = _stage_cost(x, [w])
    b_ms, b_by = bound(nbytes(x, want) + wbytes, flops, dtype)
    b, cin, h, wd = x.shape
    s, c2 = w["stride"], w["pw1_w"].shape[1]
    return dict(stride=s, shape=tuple(x.shape),
                tile=block_tile(s, cin, c2, b, (h - 1) // s + 1,
                                (wd - 1) // s + 1, dtype),
                ms=time_ms(lambda: _launch_block(lib, x, w, act=act),
                           iters=iters, queued=True),
                bound_ms=b_ms, bound_by=b_by)


def check_blocks_bf16(tag, x, blocks, verbose: bool = True, iters: int = 20,
                      act: str = "relu"):
    """Each block's bf16 kernel (activation `act`) against the plain block
    on the same input,
    the plain chain's: within BF16_BLOCK_ULPS of the block's max|ref| and
    BF16_BLOCK_EQUAL bit-equal. Both are also held to the witness, the
    block with f64 sums rounded to bf16 where the function rounds: over
    the stage, the kernel's outputs off it within BF16_WITNESS_RATIO times
    the plain version's. Prints each launch's device ms, tile and bound
    (verbose), and the stage's summary. → (the plain stage output, a dict
    of the stage's errors, one row per launch)."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (_launch_block,
                                                             _lib, block_plain)

    lib = _lib(torch.bfloat16)
    worst = own = err = 0.0
    equal = total = off = plain_off = 0
    least = 1.0
    launches = []
    for i, w in enumerate(blocks):
        want = block_plain(x, w, act=act)
        got = _launch_block(lib, x, w, act=act)
        exact = block_plain(x, w, wide=torch.float64, act=act)
        ulps, own_ulps = bf16_ulps(got, want)
        same = int((got == want).sum())
        n = want.numel()
        worst, own = max(worst, ulps), max(own, own_ulps)
        least = min(least, same / n)
        err = max(err, (got.float() - want.float()).abs().max().item())
        equal += same
        total += n
        if ulps > BF16_BLOCK_ULPS or same < BF16_BLOCK_EQUAL * n:
            raise AssertionError(
                f"{tag} block {i}: bf16 kernel {ulps:g} ulps of max|ref| "
                f"from its plain block (tolerance {BF16_BLOCK_ULPS}), "
                f"{same / n:.5f} bit-equal (at least {BF16_BLOCK_EQUAL})")
        k_off, p_off = int((got != exact).sum()), int((want != exact).sum())
        off += k_off
        plain_off += p_off
        row = dict(block=i, **block_launch_row(lib, x, w, want,
                                               torch.bfloat16, iters, act),
                   ulps=ulps, bit_equal_share=same / n,
                   off_f64_share=k_off / n, plain_off_f64_share=p_off / n)
        if verbose:
            print(f"    {tag} block {i} (stride {row['stride']}, tile "
                  f"{row['tile']}): {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
                  f"{ulps:.3g} ulps of max|ref|, {same / n:.6f} bit-equal; "
                  f"off the f64-sum witness: kernel {k_off / n:.6f}, plain "
                  f"{p_off / n:.6f}")
        launches.append(row)
        x = want
    print(f"  {tag}: blocks within {worst:.3g} bf16 ulps of max|ref| of the "
          f"plain blocks (tolerance {BF16_BLOCK_ULPS}; {own:.3g} ulps of the "
          f"element's own magnitude at most), max abs err {err:.3g}, "
          f"{equal / total:.6f} of the elements bit-equal (the least of a "
          f"block {least:.6f}); off the f64-sum witness: kernel "
          f"{off / total:.6f} ({off}), plain {plain_off / total:.6f} "
          f"({plain_off})")
    if off > BF16_WITNESS_RATIO * plain_off:
        raise AssertionError(
            f"{tag}: {off} kernel outputs off the f64-sum witness, over "
            f"{BF16_WITNESS_RATIO}x the plain version's {plain_off}")
    return x, dict(max_ulps=worst, max_abs_err=err,
                   bit_equal_share=equal / total, off_f64_share=off / total,
                   plain_off_f64_share=plain_off / total), launches


def stem_bf16(model, images_np):
    """The stage-2 input of a bf16 model for the rendered scenes."""
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    x = torch.from_numpy(images_np).cuda().to(torch.bfloat16)
    x = max_pool_3x3_s2(model.backbone.conv1(x.permute(0, 3, 1, 2)))
    return x.contiguous(memory_format=torch.channels_last)


def phase_fused_stage_bf16(model, images_np):
    """Stages 2/3/4 of the bf16 0.5x artifact on the main path's own bf16
    activations: each block against its plain block in ulps; the whole
    stage's kernel, plain and bound ms."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage, fused_stage_plain, prepare_stage)

    print(f"[5] bf16 fused_stage vs plain, block by block, batch {BATCH}")
    bb = model.backbone
    rows = []
    with torch.inference_mode():
        x = stem_bf16(model, images_np)
        for name in ("stage2", "stage3", "stage4"):
            blocks = prepare_stage(getattr(bb, name))
            tag = f"{name} {tuple(x.shape)} bf16"
            want, errors, launches = check_blocks_bf16(tag, x, blocks)
            whole = fused_stage(x, blocks)
            stage_equal = float((whole == fused_stage_plain(x, blocks)
                                 ).float().mean())
            flops, wbytes = _stage_cost(x, blocks)
            b_ms, b_by = bound(nbytes(x, want) + wbytes, flops,
                               torch.bfloat16)
            xx = x
            row = dict(shape=tag, **errors,
                       stage_bit_equal_share=stage_equal,
                       ms=time_ms(lambda: fused_stage(xx, blocks),
                                  queued=True),
                       plain_ms=time_ms(lambda: fused_stage_plain(xx, blocks),
                                        queued=True),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       launches_per_call=len(blocks), launches=launches)
            print(f"    kernel {row['ms']:.4f} ms ({len(blocks)} launches), "
                  f"plain {row['plain_ms']:.4f} ms, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}); the whole stage "
                  f"{stage_equal:.5f} bit-equal to the plain stage")
            rows.append(row)
            x = want
    total = sum(r["ms"] for r in rows)
    print(f"  bf16 fused_stage per forward: {total:.4f} ms in 16 launches, "
          f"bound {sum(r['bound_ms'] for r in rows):.4f} ms")
    return rows


def phase_make_predict_fn_bf16(images_np, label="1.0x", tree=None,
                               stats=None, cfg=None):
    """A JAX-layout tree through make_predict_fn at its defaults (fold,
    bf16): by default the 1.0x artifact's folded f32 tree (the bf16 stage
    kernel at c2 = 58, 116, 232), whose detections are also matched to the
    plain-version predict's; or a tree and its BN stats given, for 1.5x and
    2.0x (stage 4 at c2 = 352 and 488, the kernel's wide variant). Each
    block is checked against its plain block, the head outputs against the
    f32 witness (`kernel_vs_plain`); the launches are counted;
    each stage is timed on the kernel and the plain path and bounded."""
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage, fused_stage_plain, prepare_stage)

    source = "a seeded init_yolo_nano tree"
    if tree is None:
        tree, meta = load_npz(NPZ)
        cfg = config_from_json(meta)
        source = f"{os.path.relpath(NPZ, ROOT)} tree"
    print(f"[5] make_predict_fn({source}, {cfg.backbone}) at its bf16 "
          f"default, {BATCH} scenes, conf {cfg.conf_thresh}")
    fn = make_predict_fn(tree, stats, cfg, SIZE)
    if fn.device.type != "cuda" or fn.dtype != torch.bfloat16:
        raise AssertionError(f"make_predict_fn on {fn.device} {fn.dtype}")
    fn(images_np)  # warm-up
    reset_counts()
    got = fn(images_np)
    counts = read_counts()
    if counts != want_counts(1, bf16=True):
        raise AssertionError(f"make_predict_fn {label} launch counts {counts}")
    matches = None
    heads, cutoffs = kernel_vs_plain(fn, images_np)  # heads to the witness
    if stats is None:
        with plain_kernels():
            plain = fn(images_np)
        matches = match_detections(got, plain, cfg.conf_thresh,
                                   cfg.nms_thresh, **BF16_MATCH,
                                   cutoffs=cutoffs)
        matches["heads"] = heads
    stage_ms, stage_plain_ms, stage_errors = {}, {}, {}
    bound_ms = launch_bound_ms = 0.0
    with torch.inference_mode():
        x = stem_bf16(fn.model, images_np)
        for name in ("stage2", "stage3", "stage4"):
            blocks = prepare_stage(getattr(fn.model.backbone, name))
            xx = x
            stage_ms[name] = time_ms(lambda: fused_stage(xx, blocks),
                                     queued=True)
            stage_plain_ms[name] = time_ms(
                lambda: fused_stage_plain(xx, blocks), queued=True)
            want, stage_errors[name], launches = check_blocks_bf16(
                f"{label} {name} {tuple(x.shape)} bf16", x, blocks)
            flops, wbytes = _stage_cost(x, blocks)
            b_ms = bound(nbytes(x, want) + wbytes, flops, torch.bfloat16)[0]
            stage_errors[name]["bound_ms"] = b_ms
            bound_ms += b_ms
            launch_bound_ms += sum(r["bound_ms"] for r in launches)
            x = want
        xb = torch.from_numpy(images_np).cuda().to(torch.bfloat16)
        fwd_ms = time_ms(lambda: fn.model(xb), iters=10)
    shown = ("" if matches is None else
             f"{int(got[3].sum())} detections match the plain-version "
             f"predict's: { {k: v for k, v in matches.items() if k != 'heads'} }; ")
    print(f"  launches {counts}; {shown}forward {fwd_ms:.3f} ms; bf16 "
          f"fused_stage at {label} {sum(stage_ms.values()):.4f} ms per "
          f"forward ({', '.join(f'{k} {v:.4f}' for k, v in stage_ms.items())}"
          f"), plain {sum(stage_plain_ms.values()):.4f} ms, bound "
          f"{bound_ms:.4f} ms (the launches' bounds summed "
          f"{launch_bound_ms:.4f} ms)")
    return dict(counts=counts, forward_ms=fwd_ms, matches=matches,
                heads=heads, detections=int(got[3].sum()),
                fused_stage_ms=stage_ms,
                fused_stage_plain_ms=stage_plain_ms,
                fused_stage_bound_ms=bound_ms,
                fused_stage_launch_bound_ms=launch_bound_ms,
                fused_stage_errors=stage_errors)


def phase_make_predict_fn_wide(images_np):
    """make_predict_fn on seeded init_yolo_nano trees at 1.5x and 2.0x (the
    1.0x artifact's COCO configuration, backbone swapped): → {label:
    phase_make_predict_fn_bf16's dict}."""
    import dataclasses

    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz, tree_from_named
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano

    out = {}
    for seed, width in enumerate(("1.5x", "2.0x")):
        cfg = dataclasses.replace(config_from_json(load_npz(NPZ)[1]),
                                  backbone=width)
        model = init_yolo_nano(torch.Generator().manual_seed(seed), cfg)
        params = tree_from_named(dict(model.named_parameters()))
        stats = tree_from_named(dict(model.named_buffers()))
        del model
        out[width] = phase_make_predict_fn_bf16(images_np, width, params,
                                                stats, cfg)
    return out


# ---------------------------------------------------------------------------
# phase 6: evaluation
# ---------------------------------------------------------------------------

EVAL_IMAGES = 256
VOC_SHAPE_NAMES = ("aeroplane", "bicycle", "bird")
COCO_SHAPE_CATS = (1, 3, 7)  # person, car, train: class indices 0, 2, 6
# the 80 COCO detection category ids, all declared, as the artifacts were
# trained (the shapes annotate three of them)
COCO_80_CAT_IDS = tuple(i for i in range(1, 91) if i not in (
    12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
# bf16 evaluation AP, kernel path against plain path (COCO AP, AP50 and
# AR100, absolute): an empirical limit, the loosest allowed. The two paths'
# bf16 detections differ, and match_detections holds them to each other
# one by one. Their leftovers do not bound the AP gap usefully: each moves
# one class's AP by at most 1/npos, but a run has hundreds of them, nearly
# all at the conf threshold (0.001) or swapped with a near tie, far below
# the true positives, where they move AP by almost nothing. Readings on an
# H100 80GB HBM3 at 700 W, 256 scenes: 1.3e-3 on the 0.5x artifact (1,078
# leftovers), 6.3e-4 on the checkpoint of the 1.0x artifact's weights
# (1,649), 1.1e-6 on phase 4's state (AP near 0).
EVAL_BF16_AP_ATOL = 0.02
EVAL_F32_AP_ATOL = 1e-6

def _scene(rng):
    """One scene of 1-3 shapes (the render_scenes classes, 40 to 90 px) on
    smoothed noise, 240-359 x 280-419 px: (BGR uint8 image, [(class, x1,
    y1, side)])."""
    h, w = int(rng.integers(240, 360)), int(rng.integers(280, 420))
    img = _smooth(rng.integers(60, 190, (h, w, 3)))
    objs = []
    for _ in range(int(rng.integers(1, 4))):
        s = int(rng.integers(40, 90))
        x1 = int(rng.integers(2, w - s - 2))
        y1 = int(rng.integers(2, h - s - 2))
        cls = int(rng.integers(3))
        _paint(img, cls, x1, y1, s)
        objs.append((cls, x1, y1, s))
    return np.rint(img).astype(np.uint8), objs


def write_voc_scene(voc: str, name: str, img, objs) -> None:
    """One _scene as a VOC2007 JPEG and its annotation."""
    import cv2

    h, w = img.shape[:2]
    cv2.imwrite(os.path.join(voc, "JPEGImages", name + ".jpg"), img)
    xml = "".join(
        f"<object><name>{VOC_SHAPE_NAMES[c]}</name><difficult>0"
        f"</difficult><bndbox><xmin>{x}</xmin><ymin>{y}</ymin><xmax>"
        f"{x + s}</xmax><ymax>{y + s}</ymax></bndbox></object>"
        for c, x, y, s in objs)
    with open(os.path.join(voc, "Annotations", name + ".xml"), "w") as f:
        f.write(f"<annotation><size><width>{w}</width><height>{h}"
                f"</height></size>{xml}</annotation>")


def write_eval_sets(root: str, n: int = EVAL_IMAGES, seed: int = 11):
    """n scenes (_scene) written twice as JPEGs, a VOC2007 test split and a
    COCO val2017 split (all 80 categories declared). → (VOCdevkit root,
    COCO root, boxes per class)."""
    import cv2

    rng = np.random.default_rng(seed)
    scenes = [_scene(rng) for _ in range(n)]
    voc = os.path.join(root, "VOCdevkit", "VOC2007")
    coco = os.path.join(root, "coco")
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(voc, d), exist_ok=True)
    os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(coco, "val2017"), exist_ok=True)
    names, images, anns = [], [], []
    per_class = [0, 0, 0]
    for i, (img, objs) in enumerate(scenes):
        h, w = img.shape[:2]
        for c, *_ in objs:
            per_class[c] += 1
        name = f"s{i:05d}"
        names.append(name)
        write_voc_scene(voc, name, img, objs)
        cv2.imwrite(os.path.join(coco, "val2017", f"{i + 1:012}.jpg"), img)
        images.append({"id": i + 1, "file_name": f"{i + 1:012}.jpg",
                       "width": w, "height": h})
        for c, x, y, s in objs:
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": COCO_SHAPE_CATS[c],
                         "bbox": [x, y, s, s], "area": s * s, "iscrowd": 0})
    with open(os.path.join(voc, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(coco, "annotations", "instances_val2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"cat{c}"} for c in COCO_80_CAT_IDS]}, f)
    return os.path.dirname(voc), coco, per_class


def oracle_predict_fn(dataset, kind: str, img_size: int = SIZE,
                      max_det: int = 16):
    """predict_fn that returns each image's ground truth (score 0.9) in the
    frame letterboxed to img_size, walking the dataset in order, as an
    evaluator feeds it; kind "voc" (raw XML boxes) or "coco"."""
    from yolo_nano_tpu_torch.data.transforms import letterbox_geometry
    from yolo_nano_tpu_torch.data.voc import VOC_CLASSES
    from yolo_nano_tpu_torch.evaluation.evaluator import parse_rec_raw

    cursor = [0]

    def gts(idx):
        if kind == "voc":
            return [(o["bbox"], VOC_CLASSES.index(o["name"])) for o in
                    parse_rec_raw(dataset._anno_path(dataset.ids[idx]))]
        return [([x, y, x + bw, y + bh],
                 dataset.class_ids.index(a["category_id"]))
                for a in dataset._anns.get(dataset.ids[idx], ())
                for x, y, bw, bh in [a["bbox"]]]

    def predict(images):
        b = images.shape[0]
        boxes = np.zeros((b, max_det, 4), np.float32)
        scores = np.zeros((b, max_det), np.float32)
        classes = np.zeros((b, max_det), np.int32)
        valid = np.zeros((b, max_det), bool)
        for bi in range(b):
            idx = cursor[0] + bi
            if idx >= len(dataset):
                continue
            h, w = dataset.image_hw(idx)
            scale, offset = letterbox_geometry(h, w, img_size)
            for k, (box, cls) in enumerate(gts(idx)[:max_det]):
                pct = np.asarray(box, np.float32) / np.array([w, h, w, h],
                                                             np.float32)
                boxes[bi, k] = pct * scale + offset
                scores[bi, k], classes[bi, k], valid[bi, k] = 0.9, cls, True
        cursor[0] += b
        return boxes, scores, classes, valid

    return predict


@contextlib.contextmanager
def watch_cli_eval(keep_images: bool = False):
    """cli.eval.main watched from outside: the predict_fn it builds and the
    seconds to build it, the seconds spent in it and in waiting for the
    evaluator's loader (EvalLoader) to hand over a batch, the moment the
    loader ran out, and each batch's detections (and images, with
    keep_images). → that dict, filled as main runs."""
    from yolo_nano_tpu_torch.cli import eval as cli_eval
    from yolo_nano_tpu_torch.evaluation import evaluator

    w = dict(fn=None, build_s=0.0, predict_s=0.0, loader_wait_s=0.0,
             loader_end=None, outs=[], images=[])
    build, loader = cli_eval.build_predict_fn, evaluator.EvalLoader

    def build_watched(args, cfg):
        t0 = time.perf_counter()
        w["fn"] = fn = build(args, cfg)
        w["build_s"] += time.perf_counter() - t0

        def predict(images):
            t0 = time.perf_counter()
            out = fn(images)
            w["predict_s"] += time.perf_counter() - t0
            w["outs"].append(out)
            if keep_images:
                w["images"].append(images)
            return out
        return predict

    class TimedLoader(loader):
        def __iter__(self):
            batches = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    w["loader_end"] = time.perf_counter()
                    return
                finally:
                    w["loader_wait_s"] += time.perf_counter() - t0
                yield batch

    cli_eval.build_predict_fn, evaluator.EvalLoader = build_watched, TimedLoader
    try:
        yield w
    finally:
        cli_eval.build_predict_fn, evaluator.EvalLoader = build, loader


def run_cli_eval(tag: str, argv: list, bf16: bool, batches: int,
                 nms: Optional[int] = None):
    """cli.eval.main(argv) on the kernel path, timed and its launches
    counted, then on the plain path with its images kept. → (kernel
    evaluator, plain evaluator, the two runs' watches, a dict of the
    launches and the seconds: the whole CLI, building predict_fn, and
    evaluate's time split into the loader's waits, predict_fn (host copy,
    forward, postprocess, copy back), the time after the loader's end (the
    last batch's letterbox undo and the COCO protocol) and the rest
    (evaluator set-up, the earlier batches' letterbox undo))."""
    from yolo_nano_tpu_torch.cli import eval as cli_eval

    reset_counts()
    t0 = time.perf_counter()
    with watch_cli_eval() as w:
        got = cli_eval.main(argv)
    end = time.perf_counter()
    counts = read_counts()
    if counts != want_counts(batches, bf16=bf16, nms=nms):
        raise AssertionError(f"{tag}: launch counts {counts}")
    with plain_kernels(), watch_cli_eval(keep_images=True) as plain_w:
        want = cli_eval.main(argv)
    n = len(got.dataset)
    eval_s = end - t0 - w["build_s"]
    after = end - w["loader_end"]
    t = dict(counts=counts, images=n, cli_s=end - t0, build_s=w["build_s"],
             eval_s=eval_s, img_per_s=n / eval_s,
             loader_wait_s=w["loader_wait_s"], predict_s=w["predict_s"],
             after_loader_s=after,
             other_s=eval_s - w["loader_wait_s"] - w["predict_s"] - after)
    print(f"  {tag}: launches {counts}; {t['img_per_s']:.1f} img/s in "
          f"evaluate ({n} images in {eval_s:.3f} s: loader waits "
          f"{t['loader_wait_s']:.3f}, predict_fn {t['predict_s']:.3f}, after "
          f"the loader's end (the last batch's undo, the COCO protocol) "
          f"{after:.3f}, the rest {t['other_s']:.3f}); the whole CLI "
          f"{t['cli_s']:.3f} s, of which building predict_fn "
          f"{t['build_s']:.3f}")
    return got, want, (w, plain_w), t


def ap_close(what, got: dict, want: dict, atol: float) -> float:
    """COCO AP, AP50 and AR100 of two runs within atol; → the largest
    gap. A run that scored no detection fails."""
    if not got or not want:
        raise AssertionError(f"{what}: no detections to score")
    gap = max(abs(got[k] - want[k]) for k in ("AP", "AP50", "AR100"))
    print(f"  {what}: AP {got['AP']:.6f} / {want['AP']:.6f}, AP50 "
          f"{got['AP50']:.6f} / {want['AP50']:.6f}, AR100 "
          f"{got['AR100']:.6f} / {want['AR100']:.6f} (kernel / plain path), "
          f"largest gap {gap:.3g}, tolerance {atol:g}")
    if not gap <= atol:
        raise AssertionError(f"{what}: the kernel path's AP is {gap} off the "
                             f"plain path's (tolerance {atol})")
    return gap


def artifact_train_state(npz: str):
    """A train state (EMA included) that folds to a folded artifact's
    weights bit for bit: each conv+BN unit holds the folded weight, its
    folded bias as the BN's β (a conv bias 0), mean 0, variance 1 and
    scale √(1 + ε), so that fold's factor is exactly 1. A checkpoint of it
    scores as the artifact does. → (state, config)."""
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz, named_from_tree
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.ops.nn import BN_EPS
    from yolo_nano_tpu_torch.train.state import (TrainState,
                                                 create_train_state,
                                                 make_optimizer)

    tree, meta = load_npz(npz)
    cfg = config_from_json(meta)
    folded = named_from_tree(tree)
    init = create_train_state(
        init_yolo_nano(torch.Generator().manual_seed(0), cfg, device="cpu"),
        make_optimizer(lambda count: 1e-3))
    params, used = {}, set()
    for name, t in init.params.items():
        unit, attr = name.rsplit(".", 1)
        if attr == "bn_scale":
            # the square root as fold_bn takes it (f64, rounded once)
            params[name] = torch.sqrt((torch.ones_like(t) + BN_EPS).double()
                                      ).float()
            continue
        if attr == "bias" and unit + ".bn_scale" in init.params:
            params[name] = torch.zeros_like(t)
            continue
        key = unit + ".bias" if attr == "bn_bias" else name
        params[name] = folded[key]
        used.add(key)
    if used != set(folded):
        raise AssertionError(f"{npz} does not map onto the train state")
    stats = {name: (torch.zeros_like(t) if name.endswith("bn_mean")
                    else torch.ones_like(t))
             for name, t in init.stats.items()}
    copy = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return TrainState(params, stats, init.trace, init.count, init.step,
                      copy(params), copy(stats)), cfg


def phase_eval(state, cfg, tmp: str):
    """Evaluation on the card through cli.eval.main, on synthetic VOC and
    COCO sets written to a temporary directory: the port's evaluators on
    an oracle predict_fn (AP 1.0); then cli.eval on the f32 artifact (the
    kernel path's AP equal to the plain path's within EVAL_F32_AP_ATOL),
    on the bf16 0.5x artifact, on a CheckpointManager directory of the 1.0x
    artifact's weights as a train state with --ema, and on one of phase
    4's trained state, each at its bf16 default (AP within
    EVAL_BF16_AP_ATOL; the two artifacts' detections matched to the plain
    path's by match_detections); each run's launch counts and its time in
    evaluate by part. The sets are written under `tmp`, which phase 7
    reuses. → (the numbers, the VOCdevkit root)."""
    from yolo_nano_tpu_torch.evaluation.evaluator import (COCOEvaluator,
                                                          VOCEvaluator)
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    batches = -(-EVAL_IMAGES // BATCH)
    out = {}
    voc_root, coco_root, per_class = write_eval_sets(tmp, EVAL_IMAGES)
    print(f"[6] evaluation: {EVAL_IMAGES} synthetic scenes as VOC and "
          f"COCO ({per_class} boxes per class), {SIZE} px, batch {BATCH}")
    voc = VOCEvaluator(voc_root, SIZE, batch_size=BATCH)
    voc.evaluate(oracle_predict_fn(voc.dataset, "voc"))
    present = {c: ap for c, ap in voc.aps.items() if voc.gt_npos[c]}
    ev = COCOEvaluator(coco_root, SIZE, batch_size=BATCH)
    ap50, ap = ev.evaluate(oracle_predict_fn(ev.dataset, "coco"))
    print(f"  oracle predict_fn: VOC AP of the present classes "
          f"{present}, COCO AP {ap!r}, AP50 {ap50!r}")
    if len(present) != 3 or any(abs(v - 1) > 1e-6 for v in
                                present.values()) or not (
            abs(ap - 1) <= 1e-6 and abs(ap50 - 1) <= 1e-6):
        raise AssertionError("the oracle predict_fn does not score 1.0")
    out["oracle"] = dict(voc_aps=present, coco_ap=ap, coco_ap50=ap50)

    scoring, scoring_cfg = artifact_train_state(NPZ)
    CheckpointManager(os.path.join(tmp, "artifact")).save(0, scoring)
    CheckpointManager(os.path.join(tmp, "trained")).save(
        int(state.step), state)
    common = ["-d", "coco-val", "--root", coco_root, "--img_size",
              str(SIZE), "--batch_size", str(BATCH)]
    # (key, what, --weight and flags, bf16, match the detections)
    runs = (
        ("f32_artifact", "f32 artifact", ["--weight", NPZ], False, False),
        ("bf16_05x_artifact", "bf16 0.5x artifact",
         ["--weight", NPZ_05X], True, True),
        ("bf16_1x_checkpoint_ema", "bf16 checkpoint of the 1.0x "
         "artifact's weights, --ema",
         ["--weight", os.path.join(tmp, "artifact"), "--backbone",
          scoring_cfg.backbone, "--ema"], True, True),
        # phase 4's 30 steps score AP near 0 on these scenes, and its
        # detections (degenerate boxes among them) are not matched:
        # this run checks the CLI on a trained state and its launches
        ("bf16_phase4_checkpoint", "bf16 checkpoint of phase 4's state",
         ["--weight", os.path.join(tmp, "trained"), "--backbone",
          cfg.backbone], True, False))
    for key, what, flags, bf16, match in runs:
        got, want, (w, plain_w), t = run_cli_eval(
            what, common + flags, bf16, batches)
        gap = ap_close(what, got.stats, want.stats,
                       EVAL_BF16_AP_ATOL if bf16 else EVAL_F32_AP_ATOL)
        out[key] = dict(t, ap_gap=gap, stats=got.stats,
                        plain_stats=want.stats)
        if not match:
            continue
        fn, matches = plain_w["fn"], {}
        for images, got_b, want_b in zip(plain_w["images"], w["outs"],
                                         plain_w["outs"]):
            cutoffs = kernel_vs_plain(fn, images)[1]
            for k, v in match_detections(
                    got_b, want_b, fn.cfg.conf_thresh, fn.cfg.nms_thresh,
                    cutoffs=cutoffs, **BF16_MATCH).items():
                matches[k] = (max(matches.get(k, 0.0), v)
                              if k == "score_rdiff"
                              else matches.get(k, 0) + v)
        print(f"  {what}: detections against the plain path's: "
              f"{matches}")
        out[key]["matches"] = matches
    # the checkpoint is the trained model: it scores near the artifact
    ckpt_ap = out["bf16_1x_checkpoint_ema"]["plain_stats"]["AP"]
    artifact_ap = out["f32_artifact"]["plain_stats"]["AP"]
    print(f"  the 1.0x artifact's weights: AP {artifact_ap:.6f} as the "
          f"f32 artifact, {ckpt_ap:.6f} as a bf16 checkpoint")
    if not ckpt_ap >= 0.5 * artifact_ap:
        raise AssertionError("the checkpoint of the 1.0x artifact's "
                             f"weights scores AP {ckpt_ap}, under half "
                             f"the artifact's {artifact_ap}")
    return out, voc_root


# ---------------------------------------------------------------------------
# phase 7: training through the CLI
# ---------------------------------------------------------------------------

TRAIN_SCENES = 256
# batches of each epoch whose device copy is held against the host batch
PREFETCH_SAMPLE = (0, 7, 15)


def write_train_split(voc_root: str, n: int = TRAIN_SCENES, seed: int = 12
                      ) -> list:
    """n new scenes (_scene) as the VOC2007 trainval split, beside phase 6's
    test split. → boxes per class."""
    rng = np.random.default_rng(seed)
    voc = os.path.join(voc_root, "VOC2007")
    names, per_class = [], [0, 0, 0]
    for i in range(n):
        img, objs = _scene(rng)
        for c, *_ in objs:
            per_class[c] += 1
        names.append(f"t{i:05d}")
        write_voc_scene(voc, names[-1], img, objs)
    with open(os.path.join(voc, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")
    return per_class


class Tee:
    """stdout written through and kept."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def watch_cli_train():
    """cli.train.main watched from outside: every next() of its
    device_prefetch runs under set_sync_debug_mode("error") (a host sync
    in the copies raises), and PREFETCH_SAMPLE's batches of each epoch are
    kept with their host batch; each eval hook's evaluate is entered with
    no kernel launched since the last hook (the train steps run unfused
    convs), its launches counted alone, and the precision flags read
    around it, and the detections it returned kept. → that dict, filled
    as main runs."""
    import sys

    from yolo_nano_tpu_torch.data import loader
    from yolo_nano_tpu_torch.evaluation.evaluator import VOCEvaluator
    from yolo_nano_tpu_torch.models.yolo_nano import precision_flags

    w = dict(pairs=[], batches=0, hooks=[], tee=Tee(sys.stdout))
    prefetch, evaluate = loader.device_prefetch, VOCEvaluator.evaluate

    def prefetch_watched(iterator, *a, **kw):
        host = {}

        def kept():
            for i, batch in enumerate(iterator):
                if i in PREFETCH_SAMPLE:
                    host[i] = batch
                yield batch

        batches = prefetch(kept(), *a, **kw)

        def watched():
            i = 0
            while True:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                w["batches"] += 1
                if i in PREFETCH_SAMPLE:
                    w["pairs"].append((host[i], batch))
                i += 1
                yield batch
        return watched()

    def evaluate_watched(self, fn):
        during_steps = read_counts()
        if any(during_steps.values()):
            raise AssertionError(f"kernels launched in training steps: "
                                 f"{during_steps}")
        flags = precision_flags()
        reset_counts()
        dets = []

        def kept(images):
            got = fn(images)
            dets.append(tuple(np.asarray(t) for t in got))
            return got

        out = evaluate(self, kept)
        counts = read_counts()
        reset_counts()
        forwards = -(-len(self.dataset) // self.batch_size)
        if counts != want_counts(forwards, bf16=True):
            raise AssertionError(f"eval hook launches {counts}, expected "
                                 f"{want_counts(forwards, bf16=True)}")
        if precision_flags() != flags:
            raise AssertionError(f"the eval hook changed the precision "
                                 f"flags {flags} → {precision_flags()}")
        present = {c: ap for c, ap in self.aps.items() if self.gt_npos[c]}
        w["hooks"].append(dict(counts=counts, forwards=forwards,
                               flags=flags, aps=present,
                               dets=tuple(map(np.concatenate, zip(*dets)))))
        return out

    loader.device_prefetch, VOCEvaluator.evaluate = (prefetch_watched,
                                                     evaluate_watched)
    try:
        with contextlib.redirect_stdout(w["tee"]):
            yield w
    finally:
        loader.device_prefetch, VOCEvaluator.evaluate = prefetch, evaluate


def run_cli_train(tag: str, argv: list) -> dict:
    """cli.train.main(argv) watched (watch_cli_train); checks the prefetched
    batches against the host's and that no kernel launched after the last
    hook. → main's dict, with the watch and the run's peak memory."""
    from yolo_nano_tpu_torch.cli import train as cli_train

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with watch_cli_train() as w:
        out = cli_train.main(argv)
    out.update(watch=w, cli_s=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    if any(read_counts().values()):
        raise AssertionError(f"{tag}: kernels launched in training steps "
                             f"{read_counts()}")
    for host, dev in w["pairs"]:
        for a, t in zip(host, dev):
            if not torch.equal(t.cpu(), torch.from_numpy(a)):
                raise AssertionError(f"{tag}: a prefetched batch differs "
                                     "from its host batch")
    hook_s = out["eval_s"]
    print(f"  {tag}: {out['images']} images in {out['loop_s']:.3f} s of "
          f"epoch loops ({out['images'] / out['loop_s']:.1f} img/s), "
          f"waiting for batches {out['loader_wait_s']:.3f} s "
          f"({out['loader_wait_s'] / out['loop_s']:.3f} of them); "
          f"{w['batches']} batches through device_prefetch under "
          f"set_sync_debug_mode('error'), {len(w['pairs'])} of them (on "
          f"{w['pairs'][0][1][0].device}) equal to their host batch bit "
          f"for bit; eval hooks "
          + ", ".join(f"{s:.3f} s (AP {h['aps']}, launches "
                      f"{h['counts']['fused_stage_bf16']} + "
                      f"{h['counts']['fused_dw_pw_bf16']} bf16 in "
                      f"{h['forwards']} forwards)"
                      for s, h in zip(hook_s, w["hooks"]))
          + f"; peak memory {out['peak_bytes'] / 2**30:.2f} GiB; the whole "
          f"CLI {out['cli_s']:.3f} s")
    return out


def log_rows(save: str, epoch: int) -> list:
    with open(os.path.join(save, "voc", "yolo_nano", "train_log.jsonl")) as f:
        return [(r["epoch"], r["iter"], r["size"], r["step"])
                for r in map(json.loads, f) if r["epoch"] == epoch]


def check_export(tag: str, ckpt: str, state, cfg, dtype: str, images_np,
                 out_dir: str) -> dict:
    """cli.export.main on a checkpoint with --ema: the .npz equals fold_bn
    (and the bf16 cast) of the state's EMA model bit for bit; load_predictor
    on it replays the graph written beside it, which launches both kernels
    and whose detections agree with the parameter path's (`agree`); the
    parameter path's head outputs hold to the plain versions' (f32:
    check_close, phase 4's fold→predict tolerance; bf16: as far from the
    f32 witness as the plain path, BF16_HEAD_RATIO)."""
    from yolo_nano_tpu_torch.cli import export as cli_export
    from yolo_nano_tpu_torch.convert import (flatten_tree, load_npz,
                                             model_from_state,
                                             tree_from_model)
    from yolo_nano_tpu_torch.serving import load_predictor
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    path = cli_export.main(["--weight", ckpt, "--out",
                            os.path.join(out_dir, f"export_{dtype}"),
                            "--ema", "-d", "voc", "--img_size", str(SIZE),
                            "--dtype", dtype])
    model = fold_bn(model_from_state(state.to("cpu"), cfg, ema=True))
    if dtype == "bfloat16":
        model = cast_f32_to_bf16(model)
    want = flatten_tree(tree_from_model(model))
    got = flatten_tree(load_npz(path)[0])
    if got.keys() != want.keys():
        raise AssertionError(f"{tag}: the export holds other leaves")
    for k, v in want.items():
        g = got[k] if isinstance(got[k], torch.Tensor) else torch.from_numpy(
            got[k])
        if g.dtype != v.dtype or not torch.equal(g, v):
            raise AssertionError(f"{tag}: {k} differs from the state's fold")
    fn = load_predictor(path)  # the graph written beside the .npz
    params = load_predictor(path, prefer_params=True)
    if not hasattr(fn, "graph"):
        raise AssertionError(f"{tag}: cli.export wrote no serving graph")
    x = torch.from_numpy(images_np).cuda().to(fn.dtype)
    with torch.inference_mode():
        fn(images_np)                                 # warm-up
        reset_counts()
        got = fn(images_np)
        counts = read_counts()
        graph_agree = agree(f"{tag}: graph against the parameter path", got,
                            params(images_np), fn)
        features = params.model(x)
        with plain_kernels():
            plain_features = params.model(x)
    want_c = want_counts(1, bf16=dtype == "bfloat16")
    if counts != want_c:
        raise AssertionError(f"{tag}: launch counts {counts}, expected "
                             f"{want_c}")
    if dtype == "bfloat16":
        with torch.inference_mode(), plain_kernels():
            witness = copy.deepcopy(params.model).float()(x.float())
    errs = {}
    for name, g, w in zip(("conf", "cls", "txtytwth"), features,
                          plain_features):
        if dtype == "float32":  # phase 4's fold→predict tolerance
            errs[name] = check_close(f"{tag}: head output {name}", g, w,
                                     torch.float32)
            continue
        errs[name] = (g.float() - w.float()).abs().max().item()
        print(f"  {tag}: head output {name}: max_abs_err {errs[name]:.3g} "
              f"({bf16_ulps(g, w)[0]:.3g} bf16 ulps of max|ref| "
              f"{w.float().abs().max().item():.4g}), "
              f"{float((g == w).float().mean()):.5f} bit-equal")
    if dtype == "bfloat16":
        head_witness(tag, features, plain_features, witness)
    print(f"  {tag}: {len(want)} leaves equal fold_bn of the state's EMA "
          f"model bit for bit; load_predictor replays its graph, launches "
          f"{counts}, detections bit-equal to the parameter path's "
          f"{graph_agree['bit_equal']}")
    return dict(counts=counts, head_max_abs_err=errs, graph=graph_agree)


def phase_train_cli(voc_root: str, tmp: str, images_np, bare: dict) -> dict:
    """Training through cli.train.main on phase 6's VOCdevkit with a
    trainval split of its own (TRAIN_SCENES scenes), 1.0x VOC, 416 px,
    batch 16, multi-scale, EMA, the eval hook every epoch on phase 6's
    test scenes: run A (2 epochs), run B (A resumed to 3 epochs, from step
    32), run C (3 epochs uninterrupted), B's epoch-2 log rows equal to
    C's; then cli.export of C's checkpoint in f32 and bf16
    (check_export)."""
    per_class = write_train_split(voc_root, TRAIN_SCENES)
    steps = TRAIN_SCENES // TRAIN_BATCH
    print(f"[7] training through cli.train: {TRAIN_SCENES} synthetic scenes "
          f"({per_class} boxes per class), 1.0x VOC, {SIZE} px, batch "
          f"{TRAIN_BATCH} ({steps} steps an epoch), -ms, --ema, the eval "
          f"hook every epoch on phase 6's {EVAL_IMAGES} test scenes")
    common = ["-d", "voc", "--root", voc_root, "--voc_sets", "2007",
              "--img_size", str(SIZE), "--batch_size", str(TRAIN_BATCH),
              "--num_workers", "4", "-ms", "--ema", "--eval_epoch", "1"]
    dir_a, dir_c = os.path.join(tmp, "run_a"), os.path.join(tmp, "run_c")
    runs = {}
    runs["A"] = run_cli_train("run A, 2 epochs", common + [
        "--save_folder", dir_a, "--max_epoch", "2"])
    runs["B"] = run_cli_train("run B, A resumed to 3 epochs", common + [
        "--save_folder", dir_a, "--max_epoch", "3", "--resume", "auto"])
    printed = "".join(runs["B"]["watch"]["tee"].text)
    if f"resumed @ step {2 * steps} " not in printed:
        raise AssertionError(f"run B did not resume at step {2 * steps}")
    runs["C"] = run_cli_train("run C, 3 epochs", common + [
        "--save_folder", dir_c, "--max_epoch", "3"])
    rows_b, rows_c = log_rows(dir_a, 2), log_rows(dir_c, 2)
    if not rows_c or rows_b != rows_c:
        raise AssertionError(f"run B's epoch-2 rows {rows_b} differ from run "
                             f"C's {rows_c}")
    print(f"  run B resumed @ step {2 * steps}; its epoch-2 rows (epoch, "
          f"iter, size, step) equal run C's: {rows_c}")

    # the host→device copy of one batch from pinned memory, alone
    from yolo_nano_tpu_torch.data.loader import pin_batch

    host, _ = runs["C"]["watch"]["pairs"][0]
    pinned = pin_batch(host)
    copy_ms = time_ms(lambda: [t.to("cuda", non_blocking=True)
                               for t in pinned], iters=10)
    print(f"  host→device copy of a batch ({nbytes(*pinned) / 2**20:.1f} "
          f"MiB) from pinned memory: {copy_ms:.3f} ms")

    c = runs["C"]
    state, cfg = c["state"], c["cfg"]
    ckpt = os.path.join(dir_c, "voc", "yolo_nano", "ckpt")
    exports = {dtype: check_export(f"export {dtype}", ckpt, state, cfg,
                                   dtype, images_np, tmp)
               for dtype in ("float32", "bfloat16")}
    stats = {}
    for key, r in runs.items():
        w = r["watch"]
        stats[key] = dict(
            images=r["images"], loop_s=r["loop_s"],
            img_per_s=r["images"] / r["loop_s"],
            loader_wait_s=r["loader_wait_s"],
            loader_share=r["loader_wait_s"] / r["loop_s"],
            eval_hook_s=r["eval_s"], eval_hook_aps=[h["aps"] for h in
                                                    w["hooks"]],
            eval_hook_counts=[h["counts"] for h in w["hooks"]],
            batches=w["batches"], batches_checked=len(w["pairs"]),
            peak_bytes=r["peak_bytes"], cli_s=r["cli_s"])
    print(f"  CLI training {stats['C']['img_per_s']:.1f} img/s (run C, "
          f"multi-scale 320-608 px) beside phase 4's bare step "
          f"{bare['img_per_s']:.1f} img/s (416 px); waiting for batches "
          f"{stats['C']['loader_share']:.3f} of the loops; eval hook "
          f"{np.mean(c['eval_s']):.3f} s on average")
    return dict(runs=stats, resumed_rows=rows_c, h2d_pinned_ms=copy_ms,
                h2d_bytes=nbytes(*pinned), exports=exports)


# ---------------------------------------------------------------------------
# phase 8: the serving tools, and both kernels at their shapes
# ---------------------------------------------------------------------------

# the TTA views' sizes (utils/tta.py's default scale range), each run at
# batch TTA_BATCH; SIZE runs at batch 1 too (cli.demo, the reference
# protocol)
TTA_SIZES = tuple(range(320, 641, 32))
TTA_BATCH = 8
TTA_VIEWS = 2 * len(TTA_SIZES)
# the NMS kernel's cases: (label, artifact, batch, operating point, TTA):
# the benchmark's detection cells, the main path's batch, and TTA's merge
# (22 views of max_detections slots: K = 2,816, the kernel's chain design)
# at the serving point and at eval-strict (cli.eval --tta)
NMS_CASES = (("f32 serving", NPZ, 256, "serving", False),
             ("f32 serving", NPZ, 128, "serving", False),
             ("f32 main path", NPZ, BATCH, "serving", False),
             ("bf16 serving", NPZ_05X, 128, "serving", False),
             ("bf16 eval-strict", NPZ_05X, 128, "eval_strict", False),
             ("f32 TTA serving", NPZ, TTA_BATCH, "serving", True),
             ("f32 TTA eval-strict", NPZ, TTA_BATCH, "eval_strict", True))
# ragged request sizes fed to the bucketed predictor, and the batch of the
# unpadded run each image's detections are held to
RAGGED = (1, 5, 33, 70)
REF_BATCH = 32
TEST_IMAGES = 8
DEMO_IMAGES, DEMO_FRAMES = 4, 24
BENCH_ITERS = 20


def check_blocks_f32(tag, x, blocks):
    """Each block's f32 kernel against the plain block on the plain chain's
    input (check_close), with its tile, ms per launch and bound; then the
    whole stage as phase 2 holds it: check_close, and against the stage in
    f64 within 4x cuDNN f32's error. → (the plain stage output, the largest
    error, one row per launch)."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _launch_block, _lib, block_plain, fused_stage, fused_stage_plain)

    lib = _lib(torch.float32)
    x0, err, rows = x, 0.0, []
    for i, w in enumerate(blocks):
        want = block_plain(x, w)
        err = max(err, check_close(f"{tag} block {i}",
                                   _launch_block(lib, x, w), want,
                                   torch.float32, verbose=False))
        rows.append(dict(block=i, **block_launch_row(lib, x, w, want,
                                                     torch.float32, 10)))
        x = want
    got = fused_stage(x0, blocks)
    err = max(err, check_close(tag, got, x, torch.float32, verbose=False))
    blocks64 = [{k: v if k == "stride" else v.double() for k, v in b.items()}
                for b in blocks]
    check_against_f64(tag, fused_stage_plain(x0.double(), blocks64), got, x)
    return x, err, rows


def check_heads(tag, model, size, batch, dtype, gen):
    """Both dw→pw pairs of each head level at this size on a seeded input,
    the kernel against its plain version: f32 by check_close and within 4x
    cuDNN f32's error against f64; bf16 within BF16_BLOCK_ULPS of max|ref|
    and BF16_BLOCK_EQUAL bit-equal, and over the levels against the witness
    (check_witness). Pair 0 of each level is timed. → one row per level."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain,
                                                            tile_shape)

    rows, checked = [], []
    for level, hw in enumerate((size // 8, size // 16, size // 32)):
        pairs = getattr(model, f"head{level}")._pairs()
        c, cout = pairs[0][2].shape
        x = torch.randn(batch, hw, hw, c, device=gen.device, generator=gen
                        ).to(dtype).permute(0, 3, 1, 2)
        err = ulps = 0.0
        equal = 1.0
        for dw_w, dw_b, pw_w, pw_b in pairs:
            got = fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b)
            want = fused_dw_pw_plain(x, dw_w, dw_b, pw_w, pw_b)
            where = f"{tag} head{level} {hw}x{hw}"
            if dtype == torch.float32:
                err = max(err, check_close(where, got, want, dtype,
                                           verbose=False))
                check_against_f64(where, dw_pw_f64(
                    x, dw_w, dw_b, pw_w, pw_b, "leaky", "leaky"), got, want)
            else:
                r = check_bf16_pair(where, got, want, fused_dw_pw_plain(
                    x, dw_w, dw_b, pw_w, pw_b, wide=torch.float64))
                checked.append(r)
                ulps = max(ulps, r["ulps"])
                equal = min(equal, r["bit_equal_share"])
                err = max(err, (got.float() - want.float()).abs().max().item())
        dw_w, dw_b, pw_w, pw_b = pairs[0]
        out = fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b)
        b_ms, b_by = bound(nbytes(x, dw_w, dw_b, pw_w, pw_b, out),
                           batch * hw * hw * (2 * 9 * c + 2 * c * cout), dtype)
        rows.append(dict(
            level=level, side=hw, tile=tile_shape(batch, hw, hw, c, cout,
                                                  x.element_size()),
            ms=time_ms(lambda: fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b),
                       iters=10, queued=True),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            **({} if dtype == torch.float32 else
               dict(ulps=ulps, bit_equal_share=equal))))
    if checked:
        check_witness(f"{tag} heads", checked)
    return rows


def phase_kernels_at_sizes(model, images_np):
    """Every stage block and head pair of a folded model (f32 or bf16) at
    each TTA size at batch TTA_BATCH and at SIZE at batch 1, on the
    model's own stage inputs for the rendered scenes resized as TTA resizes
    them, against their plain versions; prints each shape's tiles, ms per
    forward and bound. → one row per shape."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import prepare_stage
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2, resize_images

    dtype = next(model.parameters()).dtype
    label = str(dtype)[6:]
    names = ("stage2", "stage3", "stage4")
    stages = [prepare_stage(getattr(model.backbone, n)) for n in names]
    scenes = torch.from_numpy(images_np[:TTA_BATCH]).cuda()
    gen = torch.Generator(device=scenes.device).manual_seed(8)
    print(f"[8] {label} kernels against their plain versions at the TTA "
          f"sizes (batch {TTA_BATCH}) and at {SIZE} px batch 1")
    rows = []
    with torch.inference_mode():
        for size, batch in [(s, TTA_BATCH) for s in TTA_SIZES] + [(SIZE, 1)]:
            x = scenes[:batch]
            if x.shape[1] != size:
                x = resize_images(x, size)
            x = max_pool_3x3_s2(model.backbone.conv1(
                x.to(dtype).permute(0, 3, 1, 2))).contiguous(
                    memory_format=torch.channels_last)
            tag = f"{label} {size} px b{batch}"
            launches, err, ulps, equal = [], 0.0, 0.0, 1.0
            for name, blocks in zip(names, stages):
                if dtype == torch.float32:
                    x, e, ls = check_blocks_f32(f"{tag} {name}", x, blocks)
                else:
                    x, errors, ls = check_blocks_bf16(
                        f"{tag} {name}", x, blocks, verbose=False, iters=10)
                    e = errors["max_abs_err"]
                    ulps = max(ulps, errors["max_ulps"])
                    equal = min(equal, min(r["bit_equal_share"] for r in ls))
                err = max(err, e)
                launches += ls
            heads = check_heads(tag, model, size, batch, dtype, gen)
            row = dict(
                dtype=label, size=size, batch=batch,
                stage_tiles=[r["tile"] for r in launches],
                stage_ms=sum(r["ms"] for r in launches),
                stage_bound_ms=sum(r["bound_ms"] for r in launches),
                stage_max_abs_err=err, stage_launches=launches,
                head_tiles=[r["tile"] for r in heads],
                head_ms=2 * sum(r["ms"] for r in heads),
                head_bound_ms=2 * sum(r["bound_ms"] for r in heads),
                head_max_abs_err=max(r["max_abs_err"] for r in heads),
                heads=heads)
            if dtype == torch.bfloat16:
                row.update(stage_max_ulps=ulps, stage_min_bit_equal=equal,
                           head_max_ulps=max(r["ulps"] for r in heads),
                           head_min_bit_equal=min(r["bit_equal_share"]
                                                  for r in heads))
            print(f"  {tag}: fused_stage {row['stage_ms']:.4f} ms per "
                  f"forward, bound {row['stage_bound_ms']:.4f} ms, tiles "
                  f"{'/'.join(str(t) for t in row['stage_tiles'])}; "
                  f"fused_dw_pw {row['head_ms']:.4f} ms, bound "
                  f"{row['head_bound_ms']:.4f} ms, tiles "
                  + ", ".join(f"{r['side']}²: {r['tile'][0]}x{r['tile'][1]}"
                              for r in heads)
                  + f"; max abs err stages {err:.3g}, heads "
                  f"{row['head_max_abs_err']:.3g}"
                  + ("" if dtype == torch.float32 else
                     f"; bf16 ulps stages {ulps:.3g}, heads "
                     f"{row['head_max_ulps']:.3g}, least bit-equal "
                     f"{min(equal, row['head_min_bit_equal']):.5f}"))
            rows.append(row)
    return rows


def tile_invariance(model, images_np) -> dict:
    """Whether the kernels give an image the same bits whatever its batch:
    each stage (on the plain chain's input) and each head pair at SIZE, the
    first image alone (batch 1) against its row of batch TTA_BATCH, whose
    tiles differ. → {"stage2".., "head0".. : bit-equal}."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage, fused_stage_plain, prepare_stage)
    from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2

    dtype = next(model.parameters()).dtype
    out = {}
    with torch.inference_mode():
        x = torch.from_numpy(images_np[:TTA_BATCH]).cuda().to(dtype)
        x = max_pool_3x3_s2(model.backbone.conv1(x.permute(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)
        for name in ("stage2", "stage3", "stage4"):
            blocks = prepare_stage(getattr(model.backbone, name))
            out[name] = torch.equal(fused_stage(x, blocks)[:1],
                                    fused_stage(x[:1].contiguous(
                                        memory_format=torch.channels_last),
                                        blocks))
            x = fused_stage_plain(x, blocks)
        gen = torch.Generator(device=x.device).manual_seed(9)
        for level, hw in enumerate((SIZE // 8, SIZE // 16, SIZE // 32)):
            dw_w, dw_b, pw_w, pw_b = getattr(model, f"head{level}")._pairs(
                )[0]
            h = torch.randn(TTA_BATCH, hw, hw, pw_w.shape[0], device=x.device,
                            generator=gen).to(dtype).permute(0, 3, 1, 2)
            out[f"head{level}"] = torch.equal(
                fused_dw_pw(h, dw_w, dw_b, pw_w, pw_b)[:1],
                fused_dw_pw(h[:1], dw_w, dw_b, pw_w, pw_b))
    print(f"[8] {str(dtype)[6:]} kernels, one image at batch 1 against its "
          f"row of batch {TTA_BATCH} (other tiles), bit-equal: {out}")
    return out


def agree(tag, got, want, fn) -> dict:
    """Detections of the kernel path against another run's: f32 slot for
    slot (check_detections, near ties allowed), bf16 matched
    (match_detections); with whether they are equal bit for bit."""
    bits = all(np.array_equal(g, w) for g, w in zip(got, want))
    if fn.dtype == torch.bfloat16:
        out = match_detections(got, want, fn.cfg.conf_thresh,
                               fn.cfg.nms_thresh, **BF16_MATCH)
    else:
        out = dict(near_tie_slots=check_detections(tag, got, want,
                                                   tie_rtol=TIE_RTOL))
    b, s, _, v = got
    if not (np.isfinite(b).all() and np.isfinite(s).all()) or (
            b[v] < 0).any() or (b[v] > 1).any():
        raise AssertionError(f"{tag}: non-finite boxes or boxes outside "
                             "[0, 1]")
    return dict(out, bit_equal=bits, detections=int(v.sum()))


def phase_tta(images_np, npz):
    """tta_predictor on a folded artifact's model at the serving operating
    point, TTA_BATCH scenes: 22 forwards of 16 stage blocks and 6 head
    pairs, 23 NMS launches (each view's, then the merge), detections
    against the plain path's, img/s."""
    from yolo_nano_tpu_torch.serving import load_predictor
    from yolo_nano_tpu_torch.utils.tta import tta_predictor

    fn = load_predictor(npz, **OPERATING_POINTS["serving"])
    tta = tta_predictor(fn.model, fn.cfg)
    bf16 = fn.dtype == torch.bfloat16
    x = images_np[:TTA_BATCH]
    tta(x)  # warm-up: cuDNN's algorithms at every size
    reset_counts()
    got = tta(x)
    counts = read_counts()
    want = want_counts(TTA_VIEWS, bf16, nms=TTA_VIEWS + 1)
    if counts != want:
        raise AssertionError(f"TTA launch counts {counts}, expected {want}")
    with plain_kernels():
        plain = tta(x)
    out = agree(f"TTA {os.path.basename(npz)}", got, plain, fn)
    iters = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        tta(x)
    out.update(counts=counts, img_per_s=iters * len(x)
               / (time.perf_counter() - t0))
    print(f"[8] TTA ({len(tta.scales)} sizes x 2 flips) on "
          f"{os.path.basename(npz)}, {len(x)} scenes: launches {counts}; "
          f"{out['img_per_s']:.1f} img/s; against the plain path "
          f"{ {k: v for k, v in out.items() if k not in ('counts',)} }")
    return out


def phase_cli_eval_tta(coco_root):
    """cli.eval.main --tta on phase 6's scenes (COCO layout) with the f32
    artifact: the kernel path's AP equal to the plain path's within
    EVAL_F32_AP_ATOL; 22 forwards and 23 NMS launches a batch."""
    batches = -(-EVAL_IMAGES // BATCH)
    argv = ["-d", "coco-val", "--root", coco_root, "--img_size", str(SIZE),
            "--batch_size", str(BATCH), "--weight", NPZ, "--tta"]
    print(f"[8] cli.eval --tta on the f32 artifact, {EVAL_IMAGES} scenes")
    got, want, _, t = run_cli_eval("f32 artifact --tta", argv, False,
                                   batches * TTA_VIEWS,
                                   nms=batches * (TTA_VIEWS + 1))
    gap = ap_close("f32 artifact --tta", got.stats, want.stats,
                   EVAL_F32_AP_ATOL)
    return dict(t, ap_gap=gap, stats=got.stats, plain_stats=want.stats)


def phase_buckets(images_np, npz):
    """load_predictor(batch_buckets="auto") at the serving operating point
    on ragged requests of RAGGED scenes: each image's detections against
    its row of unpadded batch-REF_BATCH runs; launches; img/s per request
    size; the load's seconds (every bucket run once)."""
    from yolo_nano_tpu_torch.serving import load_predictor

    point = OPERATING_POINTS["serving"]
    plain_fn = load_predictor(npz, **point)
    n = max(RAGGED)
    parts = [plain_fn(images_np[lo:lo + REF_BATCH])
             for lo in range(0, n, REF_BATCH)]
    ref = tuple(np.concatenate(p) for p in zip(*parts))
    t0 = time.perf_counter()
    fn = load_predictor(npz, batch_buckets="auto", **point)
    load_s = time.perf_counter() - t0
    bf16 = fn.dtype == torch.bfloat16
    reset_counts()
    outs = {k: fn(images_np[:k]) for k in RAGGED}
    counts = read_counts()
    forwards = sum(-(-k // fn.buckets[-1]) for k in RAGGED)
    if counts != want_counts(forwards, bf16):
        raise AssertionError(f"bucketed launch counts {counts}, expected "
                             f"{want_counts(forwards, bf16)}")
    with plain_kernels():
        plain_ref = [plain_fn(images_np[lo:lo + REF_BATCH])
                     for lo in range(0, n, REF_BATCH)]
        plain_ref = tuple(np.concatenate(p) for p in zip(*plain_ref))
        plain_outs = {k: fn(images_np[:k]) for k in RAGGED}
    out = dict(buckets=fn.buckets, load_s=load_s, counts=counts,
               requests={})
    for k, got in outs.items():
        r = agree(f"buckets, {k} scenes", got, tuple(t[:k] for t in ref), fn)
        # the same on the plain path: cuDNN alone, batch against batch
        r["plain_path_bit_equal"] = all(np.array_equal(g, w[:k]) for g, w in
                                        zip(plain_outs[k], plain_ref))
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(images_np[:k])
        r["img_per_s"] = iters * k / (time.perf_counter() - t0)
        out["requests"][k] = r
    print(f"[8] bucketed load_predictor({os.path.basename(npz)}): buckets "
          f"{fn.buckets}, loaded in {load_s:.2f} s; launches {counts}; per "
          "request: " + "; ".join(
              f"{k}: {r['img_per_s']:.1f} img/s, bit-equal to the unpadded "
              f"run {r['bit_equal']} (plain path {r['plain_path_bit_equal']})"
              for k, r in out["requests"].items()))
    return out


@contextlib.contextmanager
def counted(what: str, forwards: int, bf16: bool, nms: Optional[int] = None):
    """Launch counts of the block's run, which must be `forwards` forwards
    and `nms` NMS launches (want_counts); → a dict that receives them."""
    got = {}
    reset_counts()
    yield got
    got.update(read_counts())
    if got != want_counts(forwards, bf16, nms):
        raise AssertionError(f"{what}: launch counts {got}, expected "
                             f"{want_counts(forwards, bf16, nms)}")


def phase_cli_tools(tmp, coco_root):
    """cli.test (both artifacts; the f32 one also with --tta), cli.demo in
    image mode on a folder and in video mode on an XVID .avi (both
    artifacts), cli.benchmark in f32 and bf16 on phase 6's COCO scenes
    (--reference_protocol; its FLOPs lines equal to flops_and_params on
    the same tree). Each run's launches match its forwards."""
    import io
    import sys

    import cv2

    from yolo_nano_tpu_torch.cli import benchmark as cli_benchmark
    from yolo_nano_tpu_torch.cli import demo as cli_demo
    from yolo_nano_tpu_torch.cli import test as cli_test
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz, widen_tree
    from yolo_nano_tpu_torch.utils.flops import flops_and_params

    out = dict(test={}, demo={}, benchmark={})
    val = os.path.join(coco_root, "val2017")
    for npz, tta in ((NPZ, False), (NPZ, True), (NPZ_05X, False)):
        key = os.path.basename(npz)[:-4] + ("_tta" if tta else "")
        dst = os.path.join(tmp, "test_" + key)
        bf16 = npz == NPZ_05X
        t0 = time.perf_counter()
        with counted(f"cli.test {key}",
                     TEST_IMAGES * (TTA_VIEWS if tta else 1), bf16,
                     TEST_IMAGES * (TTA_VIEWS + 1 if tta else 1)) as c:
            n = cli_test.main(["-d", "coco", "--root", coco_root, "--weight",
                               npz, "--num_images", str(TEST_IMAGES),
                               "--save_folder", dst]
                              + (["--tta"] if tta else []))
        files = sorted(os.listdir(dst))
        if n != TEST_IMAGES or files != [f"{i:06d}.jpg"
                                         for i in range(TEST_IMAGES)]:
            raise AssertionError(f"cli.test {key} wrote {files}")
        out["test"][key] = dict(counts=c, images=n,
                                seconds=time.perf_counter() - t0)

    images = sorted(os.listdir(val))
    folder = os.path.join(tmp, "demo_in")
    os.makedirs(folder, exist_ok=True)
    for name in images[:DEMO_IMAGES]:
        cv2.imwrite(os.path.join(folder, name),
                    cv2.imread(os.path.join(val, name)))
    video = os.path.join(tmp, "demo_in.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"XVID"), 10,
                             (480, 360))
    if not writer.isOpened():
        raise AssertionError("cv2.VideoWriter does not open with XVID")
    for name in images[:DEMO_FRAMES]:
        writer.write(cv2.resize(cv2.imread(os.path.join(val, name)),
                                (480, 360)))
    writer.release()
    for npz in (NPZ, NPZ_05X):
        bf16 = npz == NPZ_05X
        key = os.path.basename(npz)[:-4]
        dst = os.path.join(tmp, "demo_" + key)
        with counted(f"cli.demo image {key}", DEMO_IMAGES, bf16) as c_img:
            img = cli_demo.main(["--mode", "image", "--path", folder,
                                 "--weight", npz, "--path_to_save", dst])
        with counted(f"cli.demo video {key}", DEMO_FRAMES, bf16) as c_vid:
            vid = cli_demo.main(["--mode", "video", "--path", video,
                                 "--weight", npz, "--path_to_save", dst])
        if img["frames"] != DEMO_IMAGES or vid["frames"] != DEMO_FRAMES or (
                not os.path.getsize(os.path.join(dst, "demo_out.avi"))):
            raise AssertionError(f"cli.demo {key}: {img['frames']} images, "
                                 f"{vid['frames']} frames")
        lat = np.asarray(vid["latency_ms"])
        out["demo"][key] = dict(
            counts_image=c_img, counts_video=c_vid,
            frame_p50_ms=float(np.percentile(lat, 50)),
            frame_p99_ms=float(np.percentile(lat, 99)),
            fps=1e3 / float(lat.mean()))

    for npz, dtype in ((NPZ, "float32"), (NPZ_05X, "bfloat16")):
        key = f"{os.path.basename(npz)[:-4]}_{dtype}"
        printed = Tee(sys.stdout)
        reset_counts()
        with contextlib.redirect_stdout(printed):
            r = cli_benchmark.main(["--root", coco_root, "--weight", npz,
                                    "--dtype", dtype, "--iters",
                                    str(BENCH_ITERS), "--reference_protocol"])
        counts = read_counts()
        # the candidate count (forwards alone), the warm-up, the loop, 10
        # p50 calls, the reference protocol's warm-up and 102 calls
        forwards = r["device_batches"] + 1 + BENCH_ITERS + 10 + 103
        if counts != want_counts(forwards, dtype == "bfloat16",
                                 forwards - r["device_batches"]):
            raise AssertionError(f"cli.benchmark {key}: launch counts "
                                 f"{counts}, expected {forwards} forwards")
        tree, meta = load_npz(npz)
        cpu = io.StringIO()
        with contextlib.redirect_stdout(cpu):
            flops_and_params(widen_tree(tree), None, config_from_json(meta),
                             SIZE)
        lines = [ln for ln in "".join(printed.text).splitlines()
                 if ln.startswith(("FLOPs", "GMACs", "Params"))]
        if lines != cpu.getvalue().splitlines():
            raise AssertionError(f"cli.benchmark {key}: FLOPs lines {lines}, "
                                 f"on the CPU {cpu.getvalue().splitlines()}")
        out["benchmark"][key] = dict(r, counts=counts, flops_lines=lines)
    print("[8] CLIs: " + "; ".join(
        [f"cli.test {k} {v['images']} images in {v['seconds']:.2f} s"
         for k, v in out["test"].items()]
        + [f"cli.demo {k} video frame p50 {v['frame_p50_ms']:.2f} ms, p99 "
           f"{v['frame_p99_ms']:.2f} ms, {v['fps']:.1f} FPS"
           for k, v in out["demo"].items()]
        + [f"cli.benchmark {k} {v['fps']:.1f} img/s at batch {v['batch']}, "
           f"p50 {v['p50_ms']:.2f} ms, reference protocol "
           f"{v['reference_fps']:.1f} FPS" for k, v in
           out["benchmark"].items()]))
    return out


def phase_serving_tools(tmp, images_np):
    """Phase 8 on phase 6's sets under tmp: both kernels of both artifacts
    at the TTA sizes and batch 1, TTA, cli.eval --tta, bucketed serving,
    the CLIs. → (the numbers, the launches of each path by artifact)."""
    from yolo_nano_tpu_torch.convert import load_model

    coco_root = os.path.join(tmp, "coco")
    t0 = time.perf_counter()
    out = dict(kernel_sizes={}, tile_invariance={}, tta={}, buckets={})
    for npz in (NPZ, NPZ_05X):
        model = load_model(npz)[0].cuda()
        key = os.path.basename(npz)[:-4]
        out["kernel_sizes"][key] = phase_kernels_at_sizes(model, images_np)
        out["tile_invariance"][key] = tile_invariance(model, images_np)
        del model
        out["tta"][key] = phase_tta(images_np, npz)
        out["buckets"][key] = phase_buckets(images_np, npz)
    out["cli_eval_tta"] = phase_cli_eval_tta(coco_root)
    out["cli"] = phase_cli_tools(tmp, coco_root)
    out["seconds"] = time.perf_counter() - t0
    print(f"[8] serving tools: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: the serialized serving graph
# ---------------------------------------------------------------------------

GRAPH_BATCHES = (1, 8, 32)
GRAPH_ITERS = {1: 50, 8: 20, 32: 10}
GRAPH_ROUNDS = 3


def phase_graph(images_np, tmp, card: str):
    """Each committed artifact's serving graph exported on the CPU
    (`serving.export_graph`, as cli.export writes it) beside a copy of the
    .npz, loaded through load_predictor on the card (the graph path, no
    model code) and against the parameter path (`prefer_params`): 16 + 6
    launches of the kernels of its dtype per forward of the graph, on
    phase 3's scenes at batch 1, 8 and 32, its detections against the
    parameter path's (`agree`: f32 slot for slot, bf16 matched) with the
    bit-equal share of the slots; the two paths' predict ms (device tensor
    in and out; the least mean of GRAPH_ROUNDS rounds, timed in turn) at
    each batch, their img/s numpy in and out at batch 32,
    and the parameter path's forward ms. → {artifact: numbers}."""
    from yolo_nano_tpu_torch.convert import load_model, load_npz, save_npz
    from yolo_nano_tpu_torch.serving import (export_graph, graph_path,
                                             load_predictor)

    t_phase = time.perf_counter()
    out = {}
    for npz in (NPZ, NPZ_05X):
        key = os.path.basename(npz)[:-4]
        path = os.path.join(tmp, os.path.basename(npz))
        tree, meta = load_npz(npz)  # as cli.export writes one with a graph
        save_npz(path, tree, dict(meta, graph=True))
        model, cfg, meta = load_model(path)
        t0 = time.perf_counter()
        export_graph(model, cfg, meta["img_size"], meta["dtype"],
                     graph_path(path))
        export_s = time.perf_counter() - t0
        del model
        t0 = time.perf_counter()
        graph = load_predictor(path)
        load_s = time.perf_counter() - t0
        params = load_predictor(path, prefer_params=True)
        if not hasattr(graph, "graph") or graph.device.type != "cuda":
            raise AssertionError(f"[9] {key}: load_predictor did not replay "
                                 f"the graph on the card")
        bf16 = graph.dtype == torch.bfloat16
        r = dict(export_s=export_s, load_s=load_s, batches={})
        for b in GRAPH_BATCHES:
            x_np = images_np[:b]
            graph(x_np)  # warm-up: cuDNN picks its algorithms per shape
            with counted(f"[9] {key} graph, batch {b}", 1, bf16) as c:
                got = graph(x_np)
            want = params(x_np)
            a = agree(f"[9] {key} graph, batch {b}", got, want, graph)
            a["equal_slots"] = float(np.mean(
                (got[3] == want[3]) & (got[2] == want[2])
                & (got[1] == want[1]) & (got[0] == want[0]).all(-1)))
            x = torch.from_numpy(x_np).cuda()
            xm = x.to(params.dtype)
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: params.model(xm), GRAPH_ITERS[b])
            # the least of GRAPH_ROUNDS rounds, the two paths in turn: the
            # host's time drifts from one window to the next
            ms = {"graph": [], "params": []}
            for _ in range(GRAPH_ROUNDS):
                for name, fn in (("graph", graph), ("params", params)):
                    ms[name].append(time_ms(lambda: fn(x), GRAPH_ITERS[b]))
            r["batches"][b] = dict(
                counts=c, agree=a, graph_predict_ms=min(ms["graph"]),
                params_predict_ms=min(ms["params"]),
                params_forward_ms=fwd_ms)
        x_np = images_np[:max(GRAPH_BATCHES)]
        for name, fn in (("graph", graph), ("params", params)):
            fn(x_np)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(x_np)
            r[f"{name}_img_per_s"] = 5 * len(x_np) / (
                time.perf_counter() - t0)
        out[key] = r
        rows = r["batches"]
        print(f"[9] {key} graph: exported in {export_s:.1f} s, loaded in "
              f"{load_s:.1f} s; launches per forward "
              f"{rows[max(GRAPH_BATCHES)]['counts']}; against the parameter "
              "path: " + "; ".join(
                  f"batch {b}: {v['agree']['detections']} detections, "
                  f"{v['agree']['equal_slots']:.4f} of slots bit-equal"
                  for b, v in rows.items()))
        print(f"  {key}: predict ms (device tensors), graph / parameter "
              "path: " + "; ".join(
                  f"batch {b}: {v['graph_predict_ms']:.3f} / "
                  f"{v['params_predict_ms']:.3f} (forward "
                  f"{v['params_forward_ms']:.3f})" for b, v in rows.items())
              + f"; img/s numpy in and out at batch {max(GRAPH_BATCHES)}: "
              f"graph {r['graph_img_per_s']:.1f}, parameter path "
              f"{r['params_img_per_s']:.1f}; {card}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[9] serialized graph: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the in-graph augmentation
# ---------------------------------------------------------------------------

AUG_SIZES = (320, 416, 608)
AUG_TIMED_SIZES = (416, 608)
AUG_SAMPLER_ITEMS = 2000
AUG_SEED = 10
# the card against the CPU on the same draws: images on the 0..255 scale
# before normalization (about 6 ulps of 255; the card has read bit-equal
# to the CPU), boxes in normalized units, labels equal
AUG_IMAGE_ATOL = 1e-4
AUG_BOX_ATOL = 1e-5
# the accept rule's aspect bounds, checked on the chosen rect's corners
# (left + w − left rounds apart from w by an ulp)
AUG_RATIO_SLACK = 1e-5
AUG_EPOCHS = 1  # run D; run E resumes D to AUG_EPOCHS + 1; run F runs that


def device_aug_batch(voc_root: str):
    """Phase 7's train split at SIZE through a device-mode DetectionLoader:
    its first batch of TRAIN_BATCH (uint8 canvases, boxes, labels, regions),
    with the crop disallowed on every fifth row and no valid box on row 3."""
    from yolo_nano_tpu_torch.data.loader import DetectionLoader
    from yolo_nano_tpu_torch.data.voc import VOCDataset

    ds = VOCDataset(voc_root, img_size=SIZE,
                    image_sets=[("2007", "trainval")])
    ds.device_augment = True
    loader = DetectionLoader(ds, TRAIN_BATCH, max_boxes=MAX_BOXES,
                             num_workers=4, seed=0)
    it = iter(loader)
    images, boxes, labels, regions = next(it)
    it.close()
    loader.close()
    labels, regions = labels.copy(), regions.copy()
    regions[::5, 4] = 0
    labels[3] = -1
    return images, boxes, labels, regions


def augment_pixels(images: torch.Tensor) -> torch.Tensor:
    """The augment's normalized RGB output back on the 0..255 BGR scale."""
    from yolo_nano_tpu_torch.data.device_aug import _MEAN, _STD

    mean = torch.tensor(_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(_STD, dtype=torch.float32, device=images.device)
    return (images.float().flip(-1) * std + mean) * 255.0


def check_augment_on_card(batch) -> list:
    """(a) apply_augment on the card against the CPU on the same draws, at
    each of AUG_SIZES with and without the mosaic, each card call under
    set_sync_debug_mode("error")."""
    from yolo_nano_tpu_torch.data.device_aug import apply_augment, sample_draws

    cpu_in = [torch.from_numpy(a) for a in batch]
    card_in = [t.cuda() for t in cpu_in]
    rows = []
    for mosaic in (False, True):
        draws = sample_draws(torch.Generator().manual_seed(AUG_SEED),
                             TRAIN_BATCH, mosaic=mosaic)
        card_draws = {k: v.cuda() for k, v in draws.items()}
        for size in AUG_SIZES:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = apply_augment(*card_in, card_draws, size,
                                    mosaic=mosaic)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            want = apply_augment(*cpu_in, draws, size, mosaic=mosaic)
            img_err = (augment_pixels(got[0].cpu())
                       - augment_pixels(want[0])).abs().max().item()
            box_err = (got[1].cpu() - want[1]).abs().max().item()
            row = dict(size=size, mosaic=mosaic, image_max_abs_err=img_err,
                       box_max_abs_err=box_err,
                       bit_equal=float((got[0].cpu() == want[0]).float()
                                       .mean()),
                       labels_equal=torch.equal(got[2].cpu(), want[2]),
                       kept=int((want[2] >= 0).sum()))
            print(f"  apply_augment {size} px, mosaic {mosaic}: image max "
                  f"abs err {img_err:.3g} on 0..255 (tolerance "
                  f"{AUG_IMAGE_ATOL}), {row['bit_equal']:.5f} bit-equal; "
                  f"boxes {box_err:.3g} (tolerance {AUG_BOX_ATOL}); labels "
                  f"equal {row['labels_equal']} ({row['kept']} kept)")
            if not (img_err <= AUG_IMAGE_ATOL and box_err <= AUG_BOX_ATOL
                    and row["labels_equal"]):
                raise AssertionError(f"apply_augment at {size} px, mosaic "
                                     f"{mosaic}: the card differs from the "
                                     "CPU")
            rows.append(row)
    return rows


def crop_stats(where: str, boxes, labels, region, check: bool) -> dict:
    """(b) sample_draws and sample_crop on `where` over the rows given; with
    check, every non-identity crop is held to the accept rule: h/w in
    [0.5, 2], a valid box centre strictly inside, and the rect one of the
    candidates of a round before the first mode-0 round, of a mode other
    than 0. → identity share and mean crop area (of the region's)."""
    from yolo_nano_tpu_torch.data.device_aug import sample_crop, sample_draws

    boxes, labels, region = (t.to(where) for t in (boxes, labels, region))
    n = boxes.shape[0]
    gen = torch.Generator(where).manual_seed(AUG_SEED + 1)
    d = sample_draws(gen, n)
    rect, identity = sample_crop(d, boxes, labels, region, SIZE)
    area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
            / ((region[:, 2] - region[:, 0]) * (region[:, 3] - region[:, 1])))
    out = dict(items=n, identity_share=identity.float().mean().item(),
               mean_area=area.mean().item())
    if check:
        crop = ~identity
        w, h = rect[:, 2] - rect[:, 0], rect[:, 3] - rect[:, 1]
        ratio = h / w
        aspect_ok = ((ratio >= 0.5 - AUG_RATIO_SLACK)
                     & (ratio <= 2.0 + AUG_RATIO_SLACK))
        cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
        cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
        r = rect[:, None]
        inside = ((r[..., 0] < cx) & (r[..., 1] < cy) & (r[..., 2] > cx)
                  & (r[..., 3] > cy) & (labels >= 0)).any(-1)
        rw = (region[:, 2] - region[:, 0])[:, None, None]
        rh = (region[:, 3] - region[:, 1])[:, None, None]
        cw = (0.3 + 0.7 * d["u_w"]) * rw
        ch = (0.3 + 0.7 * d["u_h"]) * rh
        left = region[:, 0, None, None] + d["u_l"] * (rw - cw)
        top = region[:, 1, None, None] + d["u_t"] * (rh - ch)
        cand = torch.stack([left, top, left + cw, top + ch], -1)
        hit = (cand == rect[:, None, None]).all(-1)            # [n,R,T]
        rounds = torch.arange(d["mode"].shape[1], device=where)
        exits = torch.where(d["mode"] == 0, rounds, d["mode"].shape[1])
        before_exit = rounds[None] < exits.amin(-1, keepdim=True)
        mode_ok = (hit & (before_exit & (d["mode"] != 0))[..., None]).any(
            (-1, -2))
        bad = crop & ~(aspect_ok & inside & mode_ok)
        out.update(crops=int(crop.sum()), violations=int(bad.sum()))
        if out["violations"]:
            raise AssertionError(f"{out['violations']} of {out['crops']} "
                                 "crops on the card break the accept rule")
    return out


@contextlib.contextmanager
def watch_augment(keep_call: int):
    """device_aug.make_augment_fn wrapped: the outputs of the augment's
    call number `keep_call` (counted over all its sizes) are kept. → that
    dict, filled as the CLI runs."""
    from yolo_nano_tpu_torch.data import device_aug

    make = device_aug.make_augment_fn
    w = dict(calls=0, kept=None)

    def make_watched(*a, **kw):
        augment = make(*a, **kw)

        def watched(*args):
            out = augment(*args)
            if w["calls"] == keep_call:
                w["kept"] = tuple(t.clone() for t in out)
            w["calls"] += 1
            return out
        return watched

    device_aug.make_augment_fn = make_watched
    try:
        yield w
    finally:
        device_aug.make_augment_fn = make


def phase_device_aug(voc_root: str, tmp: str, state, cfg, cli_stats: dict
                     ) -> dict:
    """The in-graph augmentation on the card: (a) apply_augment against the
    CPU on the same draws; (b) the sampler's crops against the accept rule
    and its identity share and mean area beside the CPU's; one augmenting
    train step under set_sync_debug_mode("error"); (c) cli.train
    --device_augment --mosaic -ms --ema --cache_images on phase 7's train
    split: run D (AUG_EPOCHS), run E (D resumed one epoch further), run F
    (uninterrupted), E's last-epoch rows and first augmented batch equal to
    F's, and run G, F's flags without --device_augment (the host chain);
    (d) augment ms and launches per call, the host ms to issue an augment
    and an augmenting step, the CLI's img/s and loader share in F beside
    G, the uint8 batch's pinned copy, peak memory."""
    from yolo_nano_tpu_torch.data.device_aug import make_augment_fn
    from yolo_nano_tpu_torch.data.loader import pin_batch
    from yolo_nano_tpu_torch.train import make_optimizer, make_train_step

    t_phase = time.perf_counter()
    batch = device_aug_batch(voc_root)
    print(f"[10] in-graph augmentation: batch {TRAIN_BATCH} of phase 7's "
          f"scenes as uint8 canvases at {SIZE} px (crop disallowed on rows "
          f"0, 5, 10, 15; no valid box on row 3)")
    out = dict(card_vs_cpu=check_augment_on_card(batch))

    reps = -(-AUG_SAMPLER_ITEMS // TRAIN_BATCH)
    rows = [torch.from_numpy(a) for a in batch[1:]]
    boxes, labels = rows[0].repeat(reps, 1, 1), rows[1].repeat(reps, 1)
    region = rows[2][:, :4].repeat(reps, 1)
    card = crop_stats("cuda", boxes, labels, region, check=True)
    cpu = crop_stats("cpu", boxes, labels, region, check=False)
    print(f"  sampler over {card['items']} items on the card: "
          f"{card['crops']} crops, all within the accept rule; identity "
          f"share {card['identity_share']:.4f} (CPU "
          f"{cpu['identity_share']:.4f}), mean crop area "
          f"{card['mean_area']:.4f} of the region "
          f"(CPU {cpu['mean_area']:.4f})")
    out["sampler"] = dict(card=card, cpu=cpu)

    # one augmenting train step (phase 4's state), no host sync
    step = make_train_step(cfg, make_optimizer(lambda count: TRAIN_LR), SIZE,
                           augment=make_augment_fn(SIZE, mosaic=True))
    card_in = [torch.from_numpy(a).cuda() for a in batch]
    gen = torch.Generator("cuda").manual_seed(AUG_SEED)
    step(state, *card_in, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_state, metrics = step(state, *card_in, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if int(new_state.step) != int(state.step) + 1 or not torch.isfinite(
            metrics["loss/total"]):
        raise AssertionError("the augmenting step did not take its step")
    print(f"  an augmenting train step (mosaic on) under set_sync_debug_mode"
          f"('error'): loss {float(metrics['loss/total']):.4f}")
    augment = make_augment_fn(SIZE, mosaic=True)
    out["host_ms"] = dict(
        augment=host_ms(lambda: augment(*card_in, gen)),
        step=host_ms(lambda: step(state, *card_in, gen)))
    out["host_ms"]["augment_share"] = (out["host_ms"]["augment"]
                                       / out["host_ms"]["step"])
    print(f"  host time to issue one call at {SIZE} px, mosaic on (least of "
          f"5, the queue empty): augment {out['host_ms']['augment']:.3f} ms, "
          f"the augmenting step {out['host_ms']['step']:.3f} ms; the augment "
          f"is {out['host_ms']['augment_share']:.3f} of the step's host time")

    # (d) the augment alone: ms per batch and launches per call
    timing = {}
    for size in AUG_TIMED_SIZES:
        for mosaic in (False, True):
            augment = make_augment_fn(size, mosaic=mosaic)
            fn = lambda: augment(*card_in, gen)  # noqa: E731
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_ms(fn, iters=10)
            peak = torch.cuda.max_memory_allocated() - base
            kernels = forward_kernels(fn, top=3, iters=2)
            key = f"{size}_{'mosaic' if mosaic else 'crop'}"
            timing[key] = dict(ms=ms, peak_bytes=peak,
                               launches=None if kernels is None
                               else kernels["kernels_per_call"])
            print(f"  augment {size} px, mosaic {mosaic}: {ms:.3f} ms a "
                  f"batch of {TRAIN_BATCH} on the device, "
                  f"{timing[key]['launches']} kernel launches a call, peak "
                  f"{peak / 2**20:.1f} MiB above its inputs")
    out["augment"] = timing

    # (c) training through the CLI
    steps = TRAIN_SCENES // TRAIN_BATCH
    last = AUG_EPOCHS + 1
    common = ["-d", "voc", "--root", voc_root, "--voc_sets", "2007",
              "--img_size", str(SIZE), "--batch_size", str(TRAIN_BATCH),
              "--num_workers", "4", "-ms", "--ema", "--device_augment",
              "--mosaic", "--cache_images", "--eval_epoch", str(last)]
    print(f"  cli.train {' '.join(common[4:])}: run D {AUG_EPOCHS} epoch(s), "
          f"run E D resumed to {last}, run F {last} uninterrupted "
          f"({steps} steps an epoch); run G as F without --device_augment "
          f"(the host chain with the same flags)")
    dir_d, dir_f = os.path.join(tmp, "run_d"), os.path.join(tmp, "run_f")
    runs, kept = {}, {}
    for tag, argv, keep in (
            ("D", ["--save_folder", dir_d, "--max_epoch", str(AUG_EPOCHS)],
             None),
            ("E", ["--save_folder", dir_d, "--max_epoch", str(last),
                   "--resume", "auto"], 0),
            ("F", ["--save_folder", dir_f, "--max_epoch", str(last)],
             AUG_EPOCHS * steps)):
        with watch_augment(-1 if keep is None else keep) as w:
            runs[tag] = run_cli_train(f"run {tag}", common + argv)
        kept[tag] = w["kept"]
    printed = "".join(runs["E"]["watch"]["tee"].text)
    if f"resumed @ step {AUG_EPOCHS * steps} " not in printed:
        raise AssertionError(f"run E did not resume at step "
                             f"{AUG_EPOCHS * steps}")
    rows_e, rows_f = log_rows(dir_d, AUG_EPOCHS), log_rows(dir_f, AUG_EPOCHS)
    if not rows_f or rows_e != rows_f:
        raise AssertionError(f"run E's last-epoch rows {rows_e} differ from "
                             f"run F's {rows_f}")
    if kept["E"] is None or kept["F"] is None or not all(
            torch.equal(a, b) for a, b in zip(kept["E"], kept["F"])):
        raise AssertionError("the first augmented batch of the last epoch "
                             "differs between runs E and F")
    runs["G"] = run_cli_train("run G (host chain)", [
        a for a in common if a != "--device_augment"] + [
        "--save_folder", os.path.join(tmp, "run_g"), "--max_epoch",
        str(last)])
    for tag in ("E", "F", "G"):
        if not runs[tag]["watch"]["hooks"]:
            raise AssertionError(f"run {tag} ran no eval hook")
    print(f"  run E resumed @ step {AUG_EPOCHS * steps}; its last-epoch rows "
          f"(epoch, iter, size, step) equal run F's: {rows_f}; the first "
          f"augmented batch of that epoch ({tuple(kept['F'][0].shape)}, "
          f"{kept['F'][0].dtype}) bit-equal in E and F")

    host, _ = runs["F"]["watch"]["pairs"][0]
    pinned = pin_batch(host)
    copy_ms = time_ms(lambda: [t.to("cuda", non_blocking=True)
                               for t in pinned], iters=10)
    out["cli"] = {tag: dict(images=r["images"], loop_s=r["loop_s"],
                            img_per_s=r["images"] / r["loop_s"],
                            loader_wait_s=r["loader_wait_s"],
                            loader_share=r["loader_wait_s"] / r["loop_s"],
                            eval_hook_s=r["eval_s"],
                            eval_hook_counts=[h["counts"] for h in
                                              r["watch"]["hooks"]],
                            eval_hook_aps=[h["aps"] for h in
                                           r["watch"]["hooks"]],
                            peak_bytes=r["peak_bytes"], cli_s=r["cli_s"])
                  for tag, r in runs.items()}
    out.update(resumed_rows=rows_f, h2d_pinned_ms=copy_ms,
               h2d_bytes=nbytes(*pinned))
    f, g = out["cli"]["F"], out["cli"]["G"]
    print(f"  CLI training with --device_augment {f['img_per_s']:.1f} img/s "
          f"(run F), waiting for batches {f['loader_share']:.3f} of the "
          f"loops; the host chain with the same flags {g['img_per_s']:.1f} "
          f"img/s and {g['loader_share']:.3f} (run G); host→device copy of "
          f"a uint8 "
          f"batch ({nbytes(*pinned) / 2**20:.2f} MiB) from pinned memory "
          f"{copy_ms:.3f} ms beside phase 7's f32 "
          f"{cli_stats['h2d_bytes'] / 2**20:.2f} MiB in "
          f"{cli_stats['h2d_pinned_ms']:.3f} ms; peak memory "
          f"{f['peak_bytes'] / 2**30:.2f} GiB (run F), "
          f"{g['peak_bytes'] / 2**30:.2f} GiB (run G)")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 10: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: data parallelism on an NCCL group
# ---------------------------------------------------------------------------

DP_STEPS = 3
DP_LOSS_RTOL = 1e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def collectives(fn, iters: int = 3):
    """fn's collectives per call and the device ms of their work (NCCL
    kernels and copies) per call, from torch.profiler; None (the reason
    printed) if it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except (RuntimeError, AttributeError) as e:
        print(f"  collectives: not measured ({e})")
        return None
    calls = sum(e.count for e in events if e.key.startswith("c10d::"))
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and ("nccl" in e.key.lower() or "memcpy" in e.key.lower()
                         or "memset" in e.key.lower()))
    return dict(calls=calls / iters, device_ms=device_us / 1e3 / iters)


def sharded_predicts(mesh, images_np) -> dict:
    """make_predict_fn(mesh, process_shard, local_rows=True) on the 1.0x
    artifact in f32 and at its bf16 default, and load_predictor(mesh=) on
    it at batch BATCH: each against the same predictor without a mesh, bit
    for bit, its launches counted alone, its kernel path against its plain
    path (f32 slot for slot, bf16 matched), and its ms beside the
    unsharded one's (numpy in, numpy out)."""
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.parallel.mesh import batch_sharding
    from yolo_nano_tpu_torch.serving import load_predictor

    tree, meta = load_npz(NPZ)
    cfg = config_from_json(meta)
    sh = batch_sharding(mesh)
    rows = images_np[sh.rows(BATCH)]
    made = {}
    for dtype in ("float32", "bfloat16"):
        made[f"make_predict_fn_{dtype}"] = (
            make_predict_fn(tree, None, cfg, SIZE, fold=False, dtype=dtype,
                            mesh=mesh, process_shard=(sh.index, sh.count),
                            local_rows=True),
            make_predict_fn(tree, None, cfg, SIZE, fold=False, dtype=dtype),
            rows)
    made["load_predictor_float32"] = (
        load_predictor(NPZ, mesh=mesh, batch_buckets=(BATCH,)),
        load_predictor(NPZ, prefer_params=True, batch_buckets=(BATCH,)),
        images_np)
    out = {}
    for tag, (fn, alone, x) in made.items():
        bf16 = "bfloat16" in tag
        fn(x)  # warm-up
        reset_counts()
        got = fn(x)
        counts = read_counts()
        if counts != want_counts(1, bf16):
            raise AssertionError(f"{tag}: launch counts {counts}, expected "
                                 f"{want_counts(1, bf16)}")
        want = alone(images_np)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: the sharded detections differ from "
                                 "the predictor's without a mesh")
        with plain_kernels():
            plain = fn(x)
        if bf16:
            _, cutoffs = kernel_vs_plain(alone, images_np)
            agree = match_detections(got, plain, cfg.conf_thresh,
                                     cfg.nms_thresh, **BF16_MATCH,
                                     cutoffs=cutoffs)
        else:
            agree = check_detections(tag, got, plain)
        ms = {}
        for key, f, xx in (("sharded", fn, x), ("alone", alone, images_np)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                f(xx)
            ms[key] = (time.perf_counter() - t0) / 10 * 1e3
        out[tag] = dict(counts=counts, detections=int(got[3].sum()),
                        plain=agree, ms=ms["sharded"], alone_ms=ms["alone"])
        print(f"  {tag}: launches {counts}; {int(got[3].sum())} detections "
              f"bit-equal to the predictor without a mesh; against the plain "
              f"path {agree}; {ms['sharded']:.3f} ms a batch of {BATCH} "
              f"(numpy in and out), {ms['alone']:.3f} ms without a mesh")
    return out


def sharded_steps(mesh) -> dict:
    """make_train_step(mesh=) against the step without a mesh, phase 4's
    setup (1.0x COCO, SIZE px, TRAIN_BATCH): DP_STEPS steps of each from
    one init under cudnn.deterministic, the first step's losses within
    TRAIN_LOSS_RTOL, each field of the mesh step's state after the last
    against the same steps in f64 on the card within 4x the error of the
    steps without a mesh (phase 4's fields_close; from init this model's
    f32 trajectories part by rounding, so the later losses are not held
    to each other); one mesh step under set_sync_debug_mode("error"); the
    steps' ms and host ms, then a mesh step, an all-reduce of the
    gradient's flat buffer and the all-gather of a batch's uint8 canvases
    (the mosaic's), each by CUDA
    events, by the host's issue, and by torch.profiler (its collectives
    a call and their device ms: at world size 1 NCCL may move nothing)."""
    import torch.distributed as dist

    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.parallel.mesh import mesh_device, mesh_group
    from yolo_nano_tpu_torch.parallel.multiprocess import all_gather_rows
    from yolo_nano_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step)

    cfg = config_from_json(load_npz(NPZ)[1])
    images, boxes, labels = (torch.from_numpy(a).cuda() for a in render_scenes(
        TRAIN_BATCH, SIZE, seed=1, max_boxes=MAX_BOXES))
    tx = make_optimizer(lambda count: TRAIN_LR)
    start = create_train_state(init_yolo_nano(
        torch.Generator().manual_seed(0), cfg), tx, use_ema=True)
    steps = dict(mesh=make_train_step(cfg, tx, SIZE, mesh=mesh),
                 alone=make_train_step(cfg, tx, SIZE))
    torch.backends.cudnn.deterministic = True
    try:
        states, losses = {}, {}
        for key, step in steps.items():
            state = start
            for i in range(DP_STEPS):
                state, metrics = step(state, images, boxes, labels)
                if i == 0:  # from one state: apart by rounding only
                    losses[key] = {k: float(metrics[k]) for k in LOSS_NAMES}
            states[key] = state
        ref = start.to(mesh_device(mesh), torch.float64)
        for _ in range(DP_STEPS):
            ref, _ = steps["alone"](ref, images.double(), boxes, labels)
    finally:
        torch.backends.cudnn.deterministic = False
    errors, worst_leaf = fields_close("mesh step vs the step without one",
                                      states["mesh"],
                                      states["alone"].to("cpu"),
                                      ref.to("cpu"))
    for k in LOSS_NAMES:
        g, w = losses["mesh"][k], losses["alone"][k]
        if not abs(g - w) <= TRAIN_LOSS_RTOL * abs(w):
            raise AssertionError(f"mesh step: first step's {k} {g} vs {w}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        synced, _ = steps["mesh"](start, images, boxes, labels)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if int(synced.step) != 1:
        raise AssertionError("the mesh step did not take its step")
    print(f"  make_train_step(mesh=) against the step without a mesh, "
          f"{DP_STEPS} steps from init at batch {TRAIN_BATCH}, both against "
          "the same steps in f64 on the card, error over each field's norm, "
          "mesh / without: " + ", ".join(
              f"{f} {e[0]:.3g} / {e[1]:.3g}" for f, e in errors.items())
          + f"; the worst tensor at {worst_leaf:.3g} of the CPU tests' leaf "
          "tolerance; one mesh step under set_sync_debug_mode('error')")
    ms = {key: time_ms(lambda: step(start, images, boxes, labels), iters=10)
          for key, step in steps.items()}
    host = {key: host_ms(lambda: step(start, images, boxes, labels))
            for key, step in steps.items()}
    numel = sum(v.numel() for v in start.params.values()) + 5
    buf = torch.zeros(numel, device=mesh_device(mesh))
    group = mesh_group(mesh)
    canvases = torch.zeros((TRAIN_BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           device=mesh_device(mesh))
    calls = dict(
        all_reduce=lambda: dist.all_reduce(buf, group=group),
        all_gather=lambda: all_gather_rows(canvases, group),
        step=lambda: steps["mesh"](start, images, boxes, labels))
    comm = {key: dict(ms=time_ms(fn, iters=20), host_ms=host_ms(fn),
                      profile=collectives(fn))
            for key, fn in calls.items() if key != "step"}
    comm["step"] = dict(profile=collectives(calls["step"]))
    out = dict(step_ms=ms["mesh"], alone_step_ms=ms["alone"],
               step_host_ms=host["mesh"], alone_step_host_ms=host["alone"],
               grad_numel=numel, canvas_bytes=canvases.numel(),
               comm=comm, fields=errors, worst_leaf=worst_leaf,
               losses=losses)
    prof = {k: v["profile"] or {} for k, v in comm.items()}
    show = lambda k: (f"{prof[k]['device_ms']:.4f} ms device"  # noqa: E731
                      if prof[k] else "device not measured")
    print(f"  train step {ms['mesh']:.2f} ms with the group, "
          f"{ms['alone']:.2f} ms without (batch {TRAIN_BATCH}); host ms to "
          f"issue one, {host['mesh']:.2f} and {host['alone']:.2f}; "
          f"{prof['step'].get('calls')} collectives a mesh step, "
          f"{show('step')}; the gradient's all-reduce ({numel} f32) "
          f"{comm['all_reduce']['ms']:.4f} ms by CUDA events, "
          f"{comm['all_reduce']['host_ms']:.4f} ms to issue, "
          f"{show('all_reduce')}; all-gather of the batch's uint8 canvases "
          f"({canvases.numel() / 2**20:.2f} MiB) "
          f"{comm['all_gather']['ms']:.4f} ms, "
          f"{comm['all_gather']['host_ms']:.4f} ms to issue, "
          f"{show('all_gather')}")
    return out


def detecting_state(cfg):
    """cli.train's initial state (seed 0, EMA) with each head's objectness
    biases raised from −4.6 to 0 and the class biases past the scenes' 3
    classes lowered to −8, so that its eval hook detects those classes
    from the first epoch (boxes at random: the APs are small but scored;
    a random init detects nothing and scores −1). → the state."""
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)

    state = create_train_state(
        init_yolo_nano(torch.Generator().manual_seed(0), cfg, device="cpu"),
        make_optimizer(lambda count: 1e-3), use_ema=True)
    a, c = cfg.num_anchors_per_level, cfg.num_classes
    for tree in (state.params, state.ema_params):
        for name, t in tree.items():
            if name.startswith("head") and name.endswith(".out.bias"):
                t[:a] = 0.0
                t[a:(1 + c) * a].view(a, c)[:, len(VOC_SHAPE_NAMES):] = -8.0
    return state


def phase_data_parallel(voc_root: str, tmp: str, images_np) -> dict:
    """Data parallelism on the card, on an NCCL group of world size 1
    (NCCL refuses two ranks on one device; two ranks are the CPU tests'):
    (a) make_predict_fn(mesh, process_shard, local_rows) on the 1.0x
    artifact in f32 and bf16 and load_predictor(mesh=), against their
    predictors without a mesh bit for bit and their plain paths; (b)
    make_train_step(mesh=) against the step without a mesh (sharded_steps);
    then, the group destroyed, (c) cli.train.main with --coordinator
    --num_processes 1 --process_id 0 --device_augment --mosaic --ema, 1
    epoch on phase 7's split at the default lr, resumed from
    detecting_state, against the same run without --coordinator under
    cudnn.deterministic: logged losses within DP_LOSS_RTOL, the eval
    hooks' detections matched (match_detections, bf16) and their AP
    within EVAL_BF16_AP_ATOL. A group of one gives the bits of BN without
    a group (the means of the processes' means), so the two runs are
    expected to agree bit for bit."""
    from yolo_nano_tpu_torch.parallel.mesh import make_mesh
    from yolo_nano_tpu_torch.parallel.multiprocess import (initialize,
                                                           shutdown_tolerant)

    t_phase = time.perf_counter()
    port = free_port()
    print(f"[11] data parallelism: an NCCL group of 1 process on "
          f"tcp://127.0.0.1:{port}")
    initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh()
        out = dict(predict=sharded_predicts(mesh, images_np),
                   step=sharded_steps(mesh))
    finally:
        shutdown_tolerant()

    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    start = os.path.join(tmp, "dp_start")
    CheckpointManager(start).save(0, detecting_state(build_config("voc")))
    common = ["-d", "voc", "--root", voc_root, "--voc_sets", "2007",
              "--img_size", str(SIZE), "--batch_size", str(TRAIN_BATCH),
              "--num_workers", "4", "--device_augment", "--mosaic", "--ema",
              "--max_epoch", "1", "--eval_epoch", "1", "--resume", start]
    dirs = {tag: os.path.join(tmp, f"run_dp_{tag}")
            for tag in ("group", "alone")}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        runs["group"] = run_cli_train("run H, --coordinator", common + [
            "--save_folder", dirs["group"], "--coordinator",
            f"127.0.0.1:{free_port()}", "--num_processes", "1",
            "--process_id", "0"])
        runs["alone"] = run_cli_train("run I, H without --coordinator",
                                      common + ["--save_folder",
                                                dirs["alone"]])
    finally:
        torch.backends.cudnn.deterministic = False
    rows = {}
    for tag, d in dirs.items():
        with open(os.path.join(d, "voc", "yolo_nano",
                               "train_log.jsonl")) as f:
            rows[tag] = [json.loads(line) for line in f]
    if not rows["alone"] or len(rows["group"]) != len(rows["alone"]):
        raise AssertionError(f"log rows {len(rows['group'])} against "
                             f"{len(rows['alone'])}")
    loss_rdiff = 0.0
    for g, w in zip(rows["group"], rows["alone"]):
        if (g["epoch"], g["iter"], g["step"]) != (w["epoch"], w["iter"],
                                                  w["step"]):
            raise AssertionError(f"log rows {g} and {w} differ")
        for k in LOSS_NAMES:
            loss_rdiff = max(loss_rdiff, abs(g[k] - w[k]) / abs(w[k]))
    if not loss_rdiff <= DP_LOSS_RTOL:
        raise AssertionError(f"--coordinator's losses {loss_rdiff} off the "
                             "run without it")
    hooks = {tag: r["watch"]["hooks"] for tag, r in runs.items()}
    if len(hooks["group"]) != len(hooks["alone"]) or not hooks["alone"]:
        raise AssertionError("the runs' eval hooks differ in number")
    ap_gap, det_equal, matches = 0.0, [], []
    cfg = runs["alone"]["cfg"]
    for hg, hw in zip(hooks["group"], hooks["alone"]):
        if hg["aps"].keys() != hw["aps"].keys() or \
                min(hw["aps"].values()) < 0:
            raise AssertionError(f"the eval hooks scored {hg['aps']} and "
                                 f"{hw['aps']}: a class undetected")
        ap_gap = max([ap_gap] + [abs(hg["aps"][c] - hw["aps"][c])
                                 for c in hw["aps"]])
        det_equal.append(all(np.array_equal(g, w) for g, w in
                             zip(hg["dets"], hw["dets"])))
        matches.append(match_detections(hg["dets"], hw["dets"],
                                        cfg.conf_thresh, cfg.nms_thresh,
                                        **BF16_MATCH))
        if not hw["dets"][3].any():
            raise AssertionError("the eval hook detected nothing")
    if not ap_gap <= EVAL_BF16_AP_ATOL:
        raise AssertionError(f"eval hooks' AP {ap_gap} apart")
    params_equal = all(
        torch.equal(runs["group"]["state"].params[k].cpu(), v.cpu())
        for k, v in runs["alone"]["state"].params.items())
    if "data-parallel over 1 processes" not in "".join(
            runs["group"]["watch"]["tee"].text):
        raise AssertionError("run H did not train on its process group")
    print(f"  run H (--coordinator, NCCL, 1 process) against run I, both "
          f"from detecting_state at the default lr: {len(rows['alone'])} "
          f"log rows, losses within {loss_rdiff:.3g} relative (tolerance "
          f"{DP_LOSS_RTOL:g}); final params equal bit for bit "
          f"{params_equal}; eval hook APs {[h['aps'] for h in hooks['group']]}"
          f" against {[h['aps'] for h in hooks['alone']]}, gap "
          f"{ap_gap:.3g}; detections "
          f"{[int(h['dets'][3].sum()) for h in hooks['group']]} against "
          f"{[int(h['dets'][3].sum()) for h in hooks['alone']]}, bit-equal "
          f"{det_equal}, matched {matches}")
    out["cli"] = {tag: dict(images=r["images"], loop_s=r["loop_s"],
                            img_per_s=r["images"] / r["loop_s"],
                            eval_hook_s=r["eval_s"],
                            eval_hook_counts=[h["counts"] for h in
                                              r["watch"]["hooks"]],
                            eval_hook_aps=[h["aps"] for h in
                                           r["watch"]["hooks"]],
                            cli_s=r["cli_s"])
                  for tag, r in runs.items()}
    out.update(loss_rdiff=loss_rdiff, ap_gap=ap_gap, dets_equal=det_equal,
               dets_matched=matches, params_equal=params_equal)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 11: {out['seconds']:.1f} s")
    return out


def kernel_row(name, source, rows, per_fwd, launches, replaces):
    """One JSON row per kernel: its main-path calls of one forward summed
    (the two head pairs of a level share a shape, so one is timed twice)."""
    total = lambda key: sum(r[key] * per_fwd for r in rows)  # noqa: E731
    library = [r["library_ms"] for r in rows]
    return dict(
        name=name, route="cuda", source=f"yolo_nano_tpu_torch/csrc/{source}",
        replaces=replaces, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        library_ms=None if None in library else total("library_ms"),
        calls_per_forward=per_fwd * len(rows))


def nanodet_counts() -> dict:
    """The launch counters a NanoDet-Plus predict moves."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import fused_stage
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy

    return dict(fused_stage_calls=fused_stage.calls,
                fused_stage=fused_stage.launches,
                fused_stage_bf16=fused_stage.launches_bf16,
                fused_stage_leaky=fused_stage.launches_leaky,
                fused_dw_pw=fused_dw_pw.launches,
                fused_dw_pw_bf16=fused_dw_pw.launches_bf16,
                fused_dw_pw_k5=fused_dw_pw.launches_k5,
                nms_greedy=nms_greedy.launches)


# launches of one NanoDet-Plus predict: 3 LeakyReLU stages of 16 blocks in
# bf16, 12 stride-1 5×5 pairs (8 in the heads, 4 GhostBottleneck shortcuts)
# and one NMS
NANODET_COUNTS = dict(fused_stage_calls=3, fused_stage=16, fused_stage_bf16=16,
                      fused_stage_leaky=16, fused_dw_pw=12,
                      fused_dw_pw_bf16=12, fused_dw_pw_k5=12, nms_greedy=1)


def phase_nanodet(images_np):
    """The NanoDet-Plus artifact (seeded, bf16) through load_predictor on
    the card: one predict's launches (NANODET_COUNTS), its detections
    against the plain-version predict (matched as bf16, BF16_MATCH), its
    ms and img/s at BATCH; then each 5×5 pair and LeakyReLU stage of a
    forward at BATCH alone, on the forward's own inputs: each 5×5 pair
    against its plain version (check_bf16_pair, check_witness) and each
    stage block against its plain block (check_blocks_bf16, LeakyReLU),
    with kernel ms (queued), plain ms, bound ms and, for the pairs, cuDNN
    bf16's (the dw 5×5, then the 1×1). → the phase's numbers and a
    `kernels` row of each variant."""
    import torch.nn.functional as F

    from yolo_nano_tpu_torch.models.nanodet_plus import DwPw
    from yolo_nano_tpu_torch.models.shufflenetv2 import ShuffleStage
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw_plain
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage_plain, prepare_stage)
    from yolo_nano_tpu_torch.ops.nn import activate
    from yolo_nano_tpu_torch.serving import load_predictor

    fn = load_predictor(NPZ_NANODET, device="cuda")
    cfg = fn.cfg
    x = torch.from_numpy(images_np).cuda()
    fn(x)
    torch.cuda.synchronize()
    before = nanodet_counts()
    got = tuple(t.cpu().numpy() for t in fn(x))
    counts = {k: v - before[k] for k, v in nanodet_counts().items()}
    if counts != NANODET_COUNTS:
        raise AssertionError(f"NanoDet-Plus launches {counts}, want "
                             f"{NANODET_COUNTS}")
    with plain_kernels():
        plain = tuple(t.cpu().numpy() for t in fn(x))
    agree = match_detections(got, plain, cfg.conf_thresh, cfg.nms_thresh,
                             **BF16_MATCH)
    ms = time_ms(lambda: fn(x), iters=10)
    # each 5×5 pair and stage of a forward, at this batch, alone
    inputs, model = [], fn.model
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append((mod, args[0])))
        for m in model.modules()
        if (isinstance(m, DwPw) and m.fused) or isinstance(m, ShuffleStage)]
    with torch.inference_mode():
        model(x.to(fn.dtype))
    for h in hooks:
        h.remove()
    rows = []
    with torch.inference_mode():
        for mod, xin in inputs:
            b, c, h, w = xin.shape
            if isinstance(mod, DwPw):
                dw_w, dw_b, pw_w, pw_b = mod._pair()
                act_mid, act_out = mod.dw.act, mod.pw.act
                cout = pw_w.shape[1]
                px = b * h * w
                flops = px * (2 * 25 * c + 2 * c * cout)
                nb = px * (c + cout) * 2 + nbytes(dw_w, dw_b, pw_w, pw_b)
                kind = f"dw5_pw {c}->{cout} {h}x{w}"

                def plain_pair(wide=None):
                    return fused_dw_pw_plain(xin, dw_w, dw_b, pw_w, pw_b,
                                             act_mid=act_mid,
                                             act_out=act_out, wide=wide)

                dw_conv = dw_w.permute(2, 0, 1).unsqueeze(1).to(xin.dtype)
                pw_conv = pw_w.t()[:, :, None, None]

                def library():  # cuDNN: depthwise conv, then 1×1 conv
                    y = activate(F.conv2d(xin, dw_conv, dw_b.to(xin.dtype),
                                          padding=2, groups=c), act_mid)
                    return activate(F.conv2d(y, pw_conv,
                                             pw_b.to(xin.dtype)), act_out)

                out, want = mod(xin), plain_pair()
                row = check_bf16_pair(kind, out, want,
                                      plain_pair(torch.float64))
                row.update(max_abs_err=(out.float() - want.float()).abs()
                           .max().item(),
                           plain_ms=time_ms(plain_pair, iters=5, queued=True),
                           library_ms=time_ms(library, queued=True))
            else:
                blocks = prepare_stage(mod)
                flops, wbytes = _stage_cost(xin, blocks)
                out = mod(xin)
                nb = nbytes(xin, out) + wbytes
                kind = f"stage {c}->{out.shape[1]} {h}x{w}"
                _, errors, _ = check_blocks_bf16(kind, xin, blocks,
                                                 verbose=False, iters=5,
                                                 act="leaky")
                row = dict(ulps=errors["max_ulps"],
                           bit_equal_share=errors["bit_equal_share"],
                           max_abs_err=errors["max_abs_err"],
                           plain_ms=time_ms(lambda: fused_stage_plain(
                               xin, blocks, act="leaky"), iters=5,
                               queued=True), library_ms=None)
            bound_ms, by = bound(nb, flops, torch.bfloat16)
            rows.append(dict(kind=kind, ms=time_ms(lambda: mod(xin),
                                                   queued=True),
                             bound_ms=bound_ms, bound_by=by, **row))
    pairs = [r for r in rows if r["kind"].startswith("dw5")]
    stages = [r for r in rows if r["kind"].startswith("stage")]
    check_witness("[12] bf16 5x5 fused_dw_pw", pairs)
    total = lambda rs, key: sum(r[key] for r in rs)  # noqa: E731
    out = dict(counts=counts, agree=agree, predict_ms=ms,
               img_per_s=BATCH / ms * 1e3, pair5_ms=total(pairs, "ms"),
               pair5_bound_ms=total(pairs, "bound_ms"),
               pair5_library_ms=total(pairs, "library_ms"),
               stage_leaky_ms=total(stages, "ms"),
               stage_leaky_bound_ms=total(stages, "bound_ms"), rows=rows)
    print(f"[12] NanoDet-Plus bf16 at batch {BATCH}: launches {counts}; "
          f"detections against the plain path {agree}; predict "
          f"{ms:.3f} ms ({BATCH / ms * 1e3:.0f} img/s); 12 5x5 pairs "
          f"{out['pair5_ms']:.4f} ms (bound {out['pair5_bound_ms']:.4f}, "
          f"cuDNN {out['pair5_library_ms']:.4f}); 3 leaky stages "
          f"{out['stage_leaky_ms']:.4f} ms (bound "
          f"{out['stage_leaky_bound_ms']:.4f})")
    for r in rows:
        lib = (f", cuDNN {r['library_ms']:.4f}" if r["library_ms"] is not None
               else "")
        print(f"  {r['kind']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f"{lib}, bound {r['bound_ms']:.4f} ({r['bound_by']}); "
              f"{r['ulps']:.3g} bf16 ulps of max|ref|, "
              f"{r['bit_equal_share']:.6f} bit-equal")
    # the `kernels` rows of the two variants, one predict's launches each
    source = "yolo_nano_tpu_torch/csrc/"
    out["kernels"] = [
        dict(name="fused_dw_pw_bf16_k5", route="cuda",
             source=source + "fused_dw_pw_bf16.cu",
             replaces="yolo_nano_tpu/ops/pallas/fused_conv.py:108",
             launches=counts["fused_dw_pw_k5"],
             max_abs_err=max(r["max_abs_err"] for r in pairs),
             ms=out["pair5_ms"], plain_ms=total(pairs, "plain_ms"),
             bound_ms=out["pair5_bound_ms"],
             bound_by=max(pairs, key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=out["pair5_library_ms"],
             calls_per_forward=len(pairs)),
        dict(name="fused_stage_bf16_leaky", route="cuda",
             source=source + "fused_stage_bf16.cu",
             replaces="yolo_nano_tpu/ops/pallas/fused_stage.py:223",
             launches=counts["fused_stage_leaky"],
             max_abs_err=max(r["max_abs_err"] for r in stages),
             ms=out["stage_leaky_ms"], plain_ms=total(stages, "plain_ms"),
             bound_ms=out["stage_leaky_bound_ms"],
             bound_by=max(stages, key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=None, calls_per_forward=len(stages))]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sweep-stage-tiles", action="store_true",
                        help="time every fitting tile side of each stage "
                        "block launch instead of the main path")
    parser.add_argument("--sweep-dw-pw-tiles", action="store_true",
                        help="time fused_dw_pw at a grid of tiles at each "
                        "head level instead of the main path")
    parser.add_argument("--graph-only", action="store_true",
                        help="phase 9 alone, after phase 1")
    parser.add_argument("--data-parallel-only", action="store_true",
                        help="phase 11 alone, after phase 1, on newly "
                        "written sets")
    parser.add_argument("--nanodet-only", action="store_true",
                        help="phase 12 alone, after phase 1")
    parser.add_argument("--scores-only", action="store_true",
                        help="the scores kernel's phase 2 rows alone, after "
                        "phase 1")
    args = parser.parse_args()
    card = phase_device_and_build()
    if args.scores_only:
        print(json.dumps({"scores_per_case": phase_scores()}))
        print(card)
        return
    if args.nanodet_only:
        print(json.dumps(phase_nanodet(render_scenes(BATCH, SIZE))))
        print(card)
        return
    if args.graph_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_graph(render_scenes(BATCH, SIZE), tmp, card)
        print(card)
        return
    if args.data_parallel_only:
        with tempfile.TemporaryDirectory() as tmp:
            voc_root = write_eval_sets(tmp)[0]
            write_train_split(voc_root)
            print(json.dumps(phase_data_parallel(
                voc_root, tmp, render_scenes(BATCH, SIZE))))
        print(card)
        return
    images_np = render_scenes(BATCH, SIZE)
    model = _trained_model()
    if args.sweep_stage_tiles:
        from yolo_nano_tpu_torch.convert import load_model
        from yolo_nano_tpu_torch.ops.nn import max_pool_3x3_s2
        from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

        phase_fused_stage(model, torch.from_numpy(images_np).cuda())
        with torch.inference_mode():
            x = max_pool_3x3_s2(model.backbone.conv1(
                torch.from_numpy(images_np).cuda().permute(0, 3, 1, 2)))
        sweep_stage_tiles(model, x.contiguous(
            memory_format=torch.channels_last))
        model05 = load_model(NPZ_05X)[0].cuda()
        with torch.inference_mode():
            sweep_stage_tiles(model05, stem_bf16(model05, images_np),
                              "bf16 0.5x")
            model_bf16 = cast_f32_to_bf16(model)
            sweep_stage_tiles(model_bf16, stem_bf16(model_bf16, images_np),
                              "bf16 1.0x")
        print(card)
        return
    if args.sweep_dw_pw_tiles:
        with torch.inference_mode():
            phase_fused_dw_pw(model)
            sweep_dw_pw_tiles(model)
        print(card)
        return
    with torch.inference_mode():
        dw_rows = phase_fused_dw_pw(model)
    stage_rows = phase_fused_stage(model, torch.from_numpy(images_np).cuda())
    nms_rows = phase_nms(images_np)
    scores_rows = phase_scores()
    counts, stats = phase_main_path(images_np)
    train_counts, train_stats, train_state = phase_training()
    from yolo_nano_tpu_torch.convert import load_model

    model05 = load_model(NPZ_05X)[0].cuda()
    with torch.inference_mode():
        dw_rows05 = phase_fused_dw_pw(model05, dtypes=(torch.bfloat16,),
                                      acts=(("leaky", "leaky"),), phase="[5]")
    stage_rows05 = phase_fused_stage_bf16(model05, images_np)
    counts05, stats05 = phase_main_path(images_np, NPZ_05X, phase="[5]")
    stats1x_bf16 = phase_make_predict_fn_bf16(images_np)
    stats_wide = phase_make_predict_fn_wide(images_np)
    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz

    with tempfile.TemporaryDirectory() as tmp:
        eval_stats, voc_root = phase_eval(
            train_state, config_from_json(load_npz(NPZ)[1]), tmp)
        cli_stats = phase_train_cli(voc_root, tmp, images_np, train_stats)
        serving = phase_serving_tools(
            tmp, render_scenes(max(RAGGED), SIZE, seed=8))
        graph = phase_graph(images_np, tmp, card)
        device_aug = phase_device_aug(
            voc_root, tmp, train_state, config_from_json(load_npz(NPZ)[1]),
            cli_stats)
        data_parallel = phase_data_parallel(voc_root, tmp, images_np)
    nanodet = phase_nanodet(images_np)
    print(json.dumps({"main_path": stats, "batch": BATCH, "size": SIZE,
                      "training": train_stats,
                      "fused_dw_pw_per_shape": dw_rows,
                      "fused_stage_per_stage": stage_rows,
                      "nms_greedy_per_case": nms_rows,
                      "scores_per_case": scores_rows,
                      "main_path_bf16_05x": stats05,
                      "fused_dw_pw_bf16_05x_per_shape": dw_rows05,
                      "fused_stage_bf16_05x_per_stage": stage_rows05,
                      "make_predict_fn_bf16_1x": stats1x_bf16,
                      "make_predict_fn_bf16_wide": stats_wide,
                      "eval": eval_stats, "train_cli": cli_stats,
                      "serving_tools": serving, "graph": graph,
                      "device_aug": device_aug,
                      "data_parallel": data_parallel,
                      "nanodet_plus": nanodet}))
    # the main path runs the heads in f32 with leaky/leaky
    main_dw = [r for r in dw_rows if r["dtype"] == "float32"
               and r["acts"] == "leaky/leaky"]
    dw_pw_src, dw_pw_tpu = ("fused_dw_pw.cu",
                            "yolo_nano_tpu/ops/pallas/fused_conv.py:108")
    stage_tpu = "yolo_nano_tpu/ops/pallas/fused_stage.py:223"
    kernels = [
        kernel_row("fused_dw_pw", dw_pw_src, main_dw, 2,
                   counts["fused_dw_pw"], dw_pw_tpu),
        kernel_row("fused_stage", "fused_stage.cu", stage_rows, 1,
                   counts["fused_stage"], stage_tpu),
        # the bf16 launches of the 0.5x artifact's main path (phase 5)
        kernel_row("fused_dw_pw_bf16", "fused_dw_pw_bf16.cu", dw_rows05, 2,
                   counts05["fused_dw_pw_bf16"], dw_pw_tpu),
        kernel_row("fused_stage_bf16", "fused_stage_bf16.cu", stage_rows05, 1,
                   counts05["fused_stage_bf16"], stage_tpu),
        # the main path's call: one a predict, at the serving point
        dict(next(r for r in nms_rows if r["case"] == "f32 main path"),
             name="nms_greedy", route="cuda",
             source="yolo_nano_tpu_torch/csrc/nms_greedy.cu",
             replaces=None, launches=counts["nms_greedy"],
             max_abs_err=0.0, library_ms=None, calls_per_forward=1),
        # the main path's call, one a predict
        dict(next(r for r in scores_rows if r["case"] == "f32 main path"),
             name="scores", route="cuda",
             source="yolo_nano_tpu_torch/csrc/scores.cu",
             replaces=None, launches=counts["scores"], max_abs_err=0.0,
             library_ms=None, calls_per_forward=1)]
    for row in kernels[:2]:  # the training path's fold→predict, alone
        row["launches_train_fold_predict"] = train_counts[row["name"]]
    for row in kernels[2:4]:  # make_predict_fn on each tree, alone
        row["launches_make_predict_fn_1x"] = stats1x_bf16["counts"][
            row["name"]]
        for width, st in stats_wide.items():
            key = width.replace(".0x", "x").replace(".", "_")  # 1_5x, 2x
            row[f"launches_make_predict_fn_{key}"] = st["counts"][row["name"]]
            if row["name"] == "fused_stage_bf16":
                row[f"ms_{key}"] = sum(st["fused_stage_ms"].values())
                row[f"plain_ms_{key}"] = sum(
                    st["fused_stage_plain_ms"].values())
                row[f"bound_ms_{key}"] = st["fused_stage_bound_ms"]
    for row in kernels:  # the evaluation runs of phase 6, alone
        tag = ("bf16_05x_artifact" if row["name"].endswith("_bf16")
               else "f32_artifact")
        row["launches_eval"] = eval_stats[tag]["counts"][row["name"]]
    for row in kernels:  # phase 7: each run's eval hooks, then the export
        dtype = "bfloat16" if row["name"].endswith("_bf16") else "float32"
        if dtype == "bfloat16":
            row["launches_train_cli_eval_hooks"] = sum(
                h[row["name"]] for r in cli_stats["runs"].values()
                for h in r["eval_hook_counts"])
        row["launches_export_" + dtype] = cli_stats["exports"][dtype][
            "counts"][row["name"]]
    for row in kernels:  # phase 8, each path alone, on its dtype's artifact
        name = row["name"]
        key = "bench_coco416" + ("_05x" if name.endswith("_bf16") else "")
        cli = serving["cli"]
        row["launches_tta"] = serving["tta"][key]["counts"][name] + sum(
            r["counts"][name] for k, r in cli["test"].items()
            if k.startswith(key + "_tta"))
        if key == "bench_coco416":
            row["launches_tta"] += serving["cli_eval_tta"]["counts"][name]
        row["launches_batch1"] = cli["test"][key]["counts"][name] + sum(
            cli["demo"][key][c][name] for c in ("counts_image",
                                                "counts_video"))
        row["launches_buckets"] = serving["buckets"][key]["counts"][name]
        row["launches_benchmark"] = next(
            r["counts"][name] for k, r in cli["benchmark"].items()
            if k.startswith(key + "_"))
    for row in kernels:  # phase 9: the graph of its dtype's artifact
        key = "bench_coco416" + ("_05x" if row["name"].endswith("_bf16")
                                 else "")
        row["launches_graph"] = sum(r["counts"][row["name"]] for r in
                                    graph[key]["batches"].values())
    for row in kernels[2:4]:  # phase 10: its CLI runs' eval hooks
        row["launches_device_aug_eval_hooks"] = sum(
            h[row["name"]] for r in device_aug["cli"].values()
            for h in r["eval_hook_counts"])
    for row in kernels:  # phase 11: sharded predicts, then the CLI's hooks
        name = row["name"]
        row["launches_data_parallel"] = sum(
            r["counts"][name] for r in data_parallel["predict"].values()
        ) + sum(h[name] for h in data_parallel["cli"]["group"][
            "eval_hook_counts"])
    kernels += nanodet["kernels"]  # phase 12's variants, its predict alone
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
