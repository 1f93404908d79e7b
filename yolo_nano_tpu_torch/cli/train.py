"""Training CLI: the port's counterpart of the JAX package's `cli/train.py`,
with the same flags and defaults.

    python -m yolo_nano_tpu_torch.cli.train -d voc --root /data/VOCdevkit \\
        --batch_size 16 --img_size 416 -ms --ema --max_epoch 150 \\
        --lr_epoch 90 120 [--device cpu]

It trains on CUDA unless `--device` names another device; without a CUDA
device and without `--device`, it raises. Differences from the reference's
train.py, as in the JAX package's:
  * one train step per multi-scale size, built once and kept;
  * target assignment runs on the device inside the step;
  * the full train state (momentum, EMA, step) is checkpointed by
    `utils.checkpoint.CheckpointManager` under `<save>/ckpt`, so --resume
    resumes: the loader is positioned with `set_epoch` and the size stream
    fast-forwarded, so a resumed run draws what an uninterrupted one would;
  * under --ema, evaluation and the checkpoint's eval weights are the EMA's.

Batches go to the card through `data.loader.device_prefetch` (pinned
memory, a copy stream, two batches ahead); --bf16 casts the images to bf16
there. With --device_augment the host only decodes and letterboxes each
image into a uint8 base canvas, and the batches go to the card as uint8;
the SSD augmentation chain (and with --mosaic the 4-tile mosaic) runs in
the train step (`data/device_aug.py`, in bf16 under --bf16), drawn from a
generator on the device seeded per global iteration
(`device_aug.augment_seed`), so a resumed run draws what an uninterrupted
one would. The training precision is full f32 (TF32 off), set once at the start;
the eval hook (`make_predict_fn` at its defaults: BN folded, bf16, so on
the card both bf16 kernels) must leave it as it found it, and the CLI
raises if it does not.

At the start it prints the FLOPs and parameter report of the model at
--img_size (`utils.flops.flops_and_params`, counted on the CPU).

Data parallelism over N processes, one device each (`parallel/`): start
the same command N times with --coordinator HOST:PORT (process 0's
address), --num_processes N and --process_id 0..N-1 (or the environment
variables YNT_COORDINATOR, YNT_NUM_PROCESSES, YNT_PROCESS_ID). The
processes join a process group (NCCL on CUDA, each process on device
id % cards; gloo with --device cpu). --batch_size stays the global batch
and must divide by N; each process loads its rows of every batch, the
state is replicated from rank 0, the step runs sync-BN and one gradient
all-reduce, the augment draws for the global batch, and the eval hook runs
each process's rows of every eval batch through the kernels and gathers
the detections. N processes train as one process on the same global
batch does. Only rank 0 prints, logs and writes checkpoints.
--pretrained reads a backbone `.npz` written by
`yolo_nano_tpu_torch.tools.convert_shufflenetv2`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="YOLO-Nano training (PyTorch)")
    p.add_argument("--img_size", default=640, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--max_epoch", type=int, default=150)
    p.add_argument("--lr_epoch", nargs="+", default=[90, 120], type=int)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("-r", "--resume", default=None, type=str,
                   help="checkpoint dir to resume full train state from, or "
                        "'auto' to pick up this run's latest checkpoint")
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--worker_mode", default="thread",
                   choices=["thread", "process"],
                   help="augmentation worker pool type (process wins when "
                        "GIL-bound python dominates, e.g. crowded-image "
                        "SSD-crop retries on many-core hosts)")
    p.add_argument("--cache_images", action="store_true", default=False,
                   help="memoize decoded images in RAM (skips JPEG decode "
                        "after the first epoch; budget ~H*W*3 bytes/image)")
    p.add_argument("--eval_epoch", type=int, default=10)
    p.add_argument("--save_folder", default="weights/", type=str)
    p.add_argument("-v", "--version", default="yolo_nano")
    p.add_argument("--root", default="/data", help="dataset root")
    p.add_argument("-d", "--dataset", default="voc", choices=["voc", "coco"])
    p.add_argument("--voc_sets", default="2007,2012",
                   help="comma-separated VOC years for trainval")
    p.add_argument("--ema", action="store_true", default=False)
    p.add_argument("-ms", "--multi_scale", action="store_true", default=False)
    p.add_argument("--multi_scale_range", nargs=2, default=[10, 20],
                   type=int, metavar=("LO", "HI"),
                   help="multi-scale bucket range: sizes drawn from "
                        "randint(LO, HI)·32 (the reference parses this flag "
                        "but hardcodes 10..19, train.py:204 — here it works)")
    p.add_argument("-no_wp", "--no_warm_up", action="store_true",
                   default=False)
    p.add_argument("--wp_epoch", type=int, default=2)
    p.add_argument("--mosaic", action="store_true", default=False)
    p.add_argument("--backbone", default="1.0x")
    p.add_argument("--pretrained", default=None,
                   help="ImageNet backbone .npz (from "
                        "yolo_nano_tpu_torch.tools.convert_shufflenetv2)")
    p.add_argument("--eval_size", default=416, type=int)
    p.add_argument("--max_boxes", default=64, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--log_file", default=None, type=str,
                   help="JSONL metrics log (default <save>/train_log.jsonl)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 activations (params/BN stats/losses stay "
                        "f32); the images are cast on the device")
    p.add_argument("--device_augment", action="store_true", default=False,
                   help="in-graph augmentation: host workers only decode "
                        "+ letterbox to uint8; the SSD chain (and --mosaic) "
                        "runs on the device inside the train step")
    p.add_argument("--tfboard", action="store_true", default=False,
                   help="also log losses to TensorBoard (reference "
                        "train.py:150-157 capability)")
    p.add_argument("--profile_steps", default=0, type=int,
                   help="capture a torch.profiler trace of N steps from "
                        "iteration 2 (written to <save>/profile)")
    # multi-process launch surface; the env fallbacks let a cluster
    # launcher inject the topology without editing command lines
    p.add_argument("--coordinator", default=os.environ.get("YNT_COORDINATOR"),
                   help="host:port of process 0's process-group store — "
                        "setting this enables multi-process training; "
                        "batch_size stays the GLOBAL batch")
    p.add_argument("--num_processes", type=int,
                   default=int(os.environ.get("YNT_NUM_PROCESSES", 0)) or None)
    p.add_argument("--process_id", type=int,
                   default=(int(os.environ["YNT_PROCESS_ID"])
                            if "YNT_PROCESS_ID" in os.environ else None))
    p.add_argument("--dist_timeout", type=float, default=300,
                   help="seconds a collective waits for the other "
                        "processes before the run fails")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: CUDA, which "
                        "must be present); 'cpu' runs the plain versions of "
                        "the kernels in the eval hook")
    return p.parse_args(argv)


def load_pretrained(model, path: str, model_size: str) -> None:
    """Copy a converted backbone's params and BN stats into `model`."""
    from yolo_nano_tpu_torch.convert import named_from_tree
    from yolo_nano_tpu_torch.tools.convert_shufflenetv2 import load

    bb_p, bb_s = load(path, model_size)
    blob = {**named_from_tree({"backbone": bb_p}),
            **named_from_tree({"backbone": bb_s})}
    missing, unexpected = model.load_state_dict(blob, strict=False)
    if unexpected or any(k.startswith("backbone.") for k in missing):
        raise ValueError(f"{path} does not fit the backbone: missing "
                         f"{missing[:3]}, unexpected {unexpected[:3]}")


def timed(iterable, clock: list):
    """Yield from `iterable`, adding the seconds each next() takes to
    clock[0]."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            clock[0] += time.perf_counter() - t0
        yield item


def main(argv=None):
    """Train; → a dict: the final `state`, `cfg`, the `evaluator`, the
    `images` trained on, `loop_s` (the epoch loops' wall seconds, the card
    waited for at each epoch's end, eval hooks excluded), `loader_wait_s`
    (of those, the seconds spent waiting for the next batch) and `eval_s`
    (each eval hook's seconds). With --coordinator, `images` counts the
    global batches' images."""
    args = parse_args(argv)
    if args.multi_scale:
        lo, hi = args.multi_scale_range
        if not 0 < lo < hi:
            # fail at parse time, not at iteration 10 (rng.integers needs
            # lo < hi; HI is exclusive)
            raise SystemExit(
                f"--multi_scale_range needs 0 < LO < HI (exclusive), got "
                f"{lo} {hi}; e.g. '10 20' draws sizes 320..608")
    if not args.coordinator:
        return train(args)
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("--coordinator needs --num_processes and "
                         "--process_id (or the YNT_* env vars)")
    if args.batch_size % args.num_processes:
        raise SystemExit(
            f"multi-process training needs the global batch_size "
            f"({args.batch_size}) divisible by the number of processes "
            f"({args.num_processes})")
    import contextlib

    from yolo_nano_tpu_torch.parallel.mesh import make_mesh
    from yolo_nano_tpu_torch.parallel.multiprocess import (initialize,
                                                           shutdown_tolerant)

    initialize(args.coordinator, args.num_processes, args.process_id,
               device=args.device, timeout_s=args.dist_timeout)
    try:
        mesh = make_mesh()
        if args.process_id == 0:
            return train(args, mesh)
        # one log stream: the other ranks run the same program and would
        # print the same lines
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            return train(args, mesh)
    finally:
        # the run's work is saved; a teardown race must not fail it
        shutdown_tolerant()


def train(args, mesh=None):
    """main's body: the run of the parsed `args`, on one process, or with
    `mesh` (parallel.mesh) on this process's rows of each global batch."""
    import torch

    from yolo_nano_tpu_torch.cli.common import build_config, make_predict_fn
    from yolo_nano_tpu_torch.convert import tree_from_named
    from yolo_nano_tpu_torch.data.coco import COCODataset
    from yolo_nano_tpu_torch.data.device_aug import (augment_seed,
                                                     make_augment_fn)
    from yolo_nano_tpu_torch.data.loader import (DetectionLoader,
                                                 device_prefetch)
    from yolo_nano_tpu_torch.data.voc import VOCDataset
    from yolo_nano_tpu_torch.evaluation.evaluator import (COCOEvaluator,
                                                          VOCEvaluator)
    from yolo_nano_tpu_torch.models.yolo_nano import (init_yolo_nano,
                                                      precision_flags,
                                                      set_full_f32)
    from yolo_nano_tpu_torch.serving import resolve_device
    from yolo_nano_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step,
                                           warmup_step_schedule)
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager
    from yolo_nano_tpu_torch.utils.flops import flops_and_params

    if mesh is None:
        dev, pid, pcount = resolve_device(args.device), 0, 1
    else:
        from yolo_nano_tpu_torch.parallel.mesh import (batch_sharding,
                                                       replicated)

        shard = batch_sharding(mesh)
        dev, pid, pcount = shard.device, shard.index, shard.count
    is_main = pid == 0
    process_shard = None if mesh is None else (pid, pcount)
    # under a mesh each process runs its rows of every eval batch through
    # the kernels, and the detections are gathered on every process
    sharded_eval = {} if mesh is None else dict(
        mesh=mesh, process_shard=process_shard, local_rows=True)
    # training precision, set once: full f32 (TF32 off); the eval hook's
    # predict sets the same flags, and is checked to leave them so
    set_full_f32()
    flags = precision_flags()

    cfg = build_config(args.dataset, backbone=args.backbone)
    save_dir = os.path.join(args.save_folder, args.dataset, args.version)
    os.makedirs(save_dir, exist_ok=True)
    log_path = args.log_file or os.path.join(save_dir, "train_log.jsonl")

    # dataset + evaluator (reference build_dataset, train.py:282-321)
    if args.dataset == "voc":
        sets = [(y.strip(), "trainval")
                for y in args.voc_sets.split(",") if y.strip()]
        dataset = VOCDataset(args.root, img_size=args.img_size,
                             image_sets=sets, mosaic=args.mosaic)
        evaluator = VOCEvaluator(args.root, args.eval_size,
                                 batch_size=args.batch_size,
                                 num_workers=args.num_workers,
                                 process_shard=process_shard)
    else:
        dataset = COCODataset(args.root, image_set="train2017",
                              img_size=args.img_size, mosaic=args.mosaic)
        evaluator = COCOEvaluator(args.root, args.eval_size,
                                  batch_size=args.batch_size,
                                  num_workers=args.num_workers,
                                  process_shard=process_shard)

    # mosaic merges 4 images' ground truth — scale the padding budget so
    # crowded mosaics don't silently truncate boxes
    max_boxes = args.max_boxes * (4 if args.mosaic else 1)
    if args.device_augment:
        dataset.device_augment = True
    if args.cache_images:
        dataset.enable_image_cache()
    loader = DetectionLoader(dataset, args.batch_size, max_boxes=max_boxes,
                             num_workers=args.num_workers, seed=args.seed,
                             worker_mode=args.worker_mode,
                             process_shard=process_shard)
    epoch_size = len(loader)

    model = init_yolo_nano(torch.Generator().manual_seed(args.seed), cfg,
                           device=dev)
    if args.pretrained:
        # ImageNet-pretrained trunk (reference backbone/shufflenetv2.py:177-180)
        load_pretrained(model, args.pretrained, cfg.backbone)
        print(f"loaded pretrained backbone from {args.pretrained}")
    if is_main:
        flops_and_params(tree_from_named(dict(model.named_parameters())),
                         tree_from_named(dict(model.named_buffers())), cfg,
                         args.img_size)

    schedule = warmup_step_schedule(args.lr, epoch_size,
                                    wp_epochs=args.wp_epoch,
                                    lr_epochs=tuple(args.lr_epoch),
                                    warmup=not args.no_warm_up)
    tx = make_optimizer(schedule)
    state = create_train_state(model, tx, use_ema=args.ema)
    del model

    ckpt = CheckpointManager(os.path.join(save_dir, "ckpt"))
    start_epoch = args.start_epoch
    if args.resume:
        mgr = ckpt if args.resume == "auto" else CheckpointManager(
            args.resume)
        if args.resume == "auto" and mgr.latest_step() is None:
            print("no checkpoint yet — starting fresh")
        else:
            state = mgr.restore(state)
            # full state restores optimizer/EMA/LR position; epoch derived
            # from the restored step unless --start_epoch overrides
            start_epoch = max(start_epoch, int(state.step) // epoch_size)
            print(f"resumed @ step {int(state.step)} (epoch {start_epoch})")
    if mesh is not None:
        # every rank made or restored the same state; rank 0's, bit for
        # bit, on every rank
        state = replicated(mesh)(state)
        print(f"data-parallel over {pcount} processes")

    steps = {}  # train_size → step (multi-scale buckets)

    def get_step(size: int):
        if size not in steps:
            augment = None
            if args.device_augment:
                # the mosaic composes in the step from the batch's canvases
                augment = make_augment_fn(
                    size, out_dtype=torch.bfloat16 if args.bf16
                    else torch.float32, mosaic=args.mosaic, mesh=mesh)
            steps[size] = make_train_step(cfg, tx, size, device=dev,
                                          augment=augment, mesh=mesh)
        return steps[size]

    tb_writer = None
    if args.tfboard and is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise SystemExit(
                "--tfboard needs a TensorBoard event writer; install the "
                "optional extra (pip install 'yolo-nano-tpu[tb]') or drop "
                f"the flag — JSONL metrics at {log_path} are always written "
                f"regardless. ({e})")
        tb_writer = SummaryWriter(os.path.join(save_dir, "tb"))

    rng = np.random.default_rng(args.seed)
    train_size = args.img_size
    if args.multi_scale and start_epoch > 0:
        # resume determinism: fast-forward the size stream past the draws
        # an uninterrupted run would have made (one per 10 iters, starting
        # at iter 10), so the resumed run trains on the SAME size schedule
        lo, hi = args.multi_scale_range
        for _ in range(start_epoch * max(0, (epoch_size - 1) // 10)):
            train_size = int(rng.integers(lo, hi)) * 32
    # the metrics log: rank 0 writes it (every rank holds the same values)
    log_f = open(log_path if is_main else os.devnull, "a")
    profiler, profiled = None, False

    # data-order continuity: position the loader at start_epoch so a resumed
    # (or --start_epoch) run draws the same shuffle/augment streams an
    # uninterrupted run would have (loader constructions start at epoch 0)
    loader.set_epoch(start_epoch)

    images_seen, loop_s, wait, eval_s = 0, 0.0, [0.0], []
    aug_gen = torch.Generator(device=dev) if args.device_augment else None
    t0 = time.time()
    for epoch in range(start_epoch, args.max_epoch):
        t_epoch = time.perf_counter()
        # pinned staging and a copy stream: host augmentation and the copy
        # of the next batches overlap the card's work on this one (with a
        # process_shard the loader yields this process's rows)
        batches = device_prefetch(loader, size=2, device=dev)
        for iter_i, (images, boxes, labels, *regions) in enumerate(
                timed(batches, wait)):
            if args.bf16 and not args.device_augment:
                # (the augment emits the compute dtype from uint8 canvases)
                images = images.to(torch.bfloat16)
            if args.profile_steps and is_main and not profiled and \
                    epoch == start_epoch and iter_i == 2:  # skip warm-up
                profiled = True
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA]
                    if dev.type == "cuda" else []))
                profiler.start()
            elif profiler is not None and iter_i == min(
                    2 + args.profile_steps, epoch_size - 1):
                # clamp to the epoch end: iter_i resets each epoch
                profiler.stop()
                trace_dir = os.path.join(save_dir, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(trace_dir,
                                                          "trace.json"))
                profiler = None
                print(f"profiler trace → {trace_dir}")
            # multi-scale trick (reference train.py:202-205)
            if args.multi_scale and iter_i % 10 == 0 and iter_i > 0:
                lo, hi = args.multi_scale_range
                train_size = int(rng.integers(lo, hi)) * 32
            size = train_size if args.multi_scale else args.img_size
            if args.device_augment:
                # keyed on the global iteration: a resumed run draws the
                # augmentation an uninterrupted one drew
                aug_gen.manual_seed(augment_seed(
                    args.seed, epoch * epoch_size + iter_i))
                state, metrics = get_step(size)(state, images, boxes, labels,
                                                regions[0], aug_gen)
            else:
                state, metrics = get_step(size)(state, images, boxes, labels)
            images_seen += images.shape[0] * pcount
            if iter_i % 10 == 0:
                m = {k: float(v) for k, v in metrics.items()}
                lr = float(schedule(state.step))
                dt = time.time() - t0
                t0 = time.time()
                print(f"[Epoch {epoch + 1}/{args.max_epoch}]"
                      f"[Iter {iter_i}/{epoch_size}][lr {lr:.6f}]"
                      f"[Loss: obj {m['loss/obj']:.2f} || cls "
                      f"{m['loss/cls']:.2f} || bbox {m['loss/bbox']:.2f} || "
                      f"iou {m['loss/iou']:.2f} || total "
                      f"{m['loss/total']:.2f} || size {size} "
                      f"|| time {dt:.2f}]", flush=True)
                log_f.write(json.dumps(
                    {"epoch": epoch, "iter": iter_i,
                     "step": int(state.step), "lr": lr, "size": size,
                     **m}) + "\n")
                log_f.flush()
                if tb_writer is not None:
                    gs = iter_i + epoch * epoch_size
                    tb_writer.add_scalar("obj loss", m["loss/obj"], gs)
                    tb_writer.add_scalar("cls loss", m["loss/cls"], gs)
                    tb_writer.add_scalar("box loss", m["loss/bbox"], gs)
                    tb_writer.add_scalar("iou loss", m["loss/iou"], gs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the epoch's steps, done
        loop_s += time.perf_counter() - t_epoch

        if (epoch + 1) % args.eval_epoch == 0:
            t_eval = time.perf_counter()
            eval_params = state.ema_params if args.ema else state.params
            eval_stats = state.ema_stats if args.ema else state.stats
            predict_fn = make_predict_fn(tree_from_named(eval_params),
                                         tree_from_named(eval_stats), cfg,
                                         args.eval_size, device=dev,
                                         **sharded_eval)
            evaluator.evaluate(predict_fn)
            if precision_flags() != flags:
                raise RuntimeError(
                    f"the eval hook changed the precision flags from "
                    f"{flags} to {precision_flags()}")
            ckpt.save(int(state.step), state)
            print(f"saved checkpoint @ step {int(state.step)}")
            eval_s.append(time.perf_counter() - t_eval)
    ckpt.save(int(state.step), state)
    log_f.close()
    if tb_writer is not None:
        tb_writer.close()
    loader.close()
    if loop_s > 0:
        print(f"trained on {images_seen} images in {loop_s:.3f} s "
              f"({images_seen / loop_s:.1f} img/s; waiting for batches "
              f"{wait[0]:.3f} s), eval hooks {sum(eval_s):.3f} s")
    return dict(state=state, cfg=cfg, evaluator=evaluator,
                images=images_seen, loop_s=loop_s, loader_wait_s=wait[0],
                eval_s=eval_s)


if __name__ == "__main__":
    main()
