"""Batching input pipeline: the port's copy of the JAX package's
`data/loader.py`, with its device placement rewritten for CUDA.

  * `pad_targets` and `DetectionLoader`: fixed-shape training batches
    (ground truth padded to `max_boxes` per image, label −1 = padding),
    augmented in a thread pool (cv2/numpy release the GIL) or in spawned
    worker processes, one child np.random.Generator per item keyed on
    [seed, epoch, position], so that both worker modes and every worker
    count give the same batches, and `set_epoch` replays any epoch; for a
    dataset with `device_augment`, uint8 base canvases and their regions,
    the input of the in-graph augmentation (`data/device_aug.py`);
  * `device_prefetch`: each batch into pinned host memory, copied to the
    card on a copy stream of its own up to `size` batches ahead of the
    consumer, whose stream waits on the copy's event;
  * `EvalLoader`: batched evaluation input, each batch carrying the
    (scale, offset, h, w, image id) of its real images for letterbox-undo,
    so evaluation runs batched (the reference evaluators loop single
    images, evaluator/cocoapi_evaluator.py:65-87).

Under data parallelism (`parallel/`) both loaders take `process_shard`
= (process index, process count): a process loads only its rows of every
global batch, keyed on the global positions, so that the processes' rows
together are one process's batches; `device_prefetch(sharding=)` places
this process's rows of each global batch on its device.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch

from yolo_nano_tpu_torch.data.transforms import (letterbox_geometry,
                                                 val_transform)

MAX_BOXES_DEFAULT = 64


def _check_shard(process_shard, batch_size: int, what: str) -> None:
    pid, count = process_shard
    if not 0 <= pid < count:
        raise ValueError(f"bad process_shard {process_shard!r}")
    if batch_size % count:
        raise ValueError(f"global {what} {batch_size} must divide evenly "
                         f"over {count} processes")


# --- process-pool worker side (top-level: must pickle under spawn) ---------
_PP_DATASET = None


def _pp_init(dataset):
    global _PP_DATASET
    _PP_DATASET = dataset
    try:  # keep workers single-threaded: parallelism comes from the pool
        import cv2

        cv2.setNumThreads(0)
    except ImportError:
        pass


def _pp_load(args):
    index, seed_key, width = args
    rng = np.random.default_rng(seed_key)
    return _PP_DATASET.pull_item(index, rng)[:width]


def pad_targets(targets: List[np.ndarray], max_boxes: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """[M_i, 5] normalized (x1,y1,x2,y2,cls) per image → boxes [B, max_boxes, 4]
    + labels [B, max_boxes] int32 (−1 padding). Overflow beyond max_boxes is
    dropped largest-index-first (VOC p99 ≈ 20 boxes; mosaic can exceed —
    enlarge max_boxes for mosaic configs)."""
    b = len(targets)
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    labels = np.full((b, max_boxes), -1, np.int32)
    for i, t in enumerate(targets):
        m = min(len(t), max_boxes)
        if m:
            boxes[i, :m] = t[:m, :4]
            labels[i, :m] = t[:m, 4].astype(np.int32)
    return boxes, labels


class DetectionLoader:
    """Iterable over epochs of (images [B,S,S,3] f32 NHWC, boxes [B,M,4],
    labels [B,M] int32), numpy; for a dataset with device_augment,
    (images uint8 base canvases, boxes, labels, regions [B,5]), the input
    of the in-graph augmentation (data/device_aug.py)."""

    def __init__(self, dataset, batch_size: int, max_boxes: int =
                 MAX_BOXES_DEFAULT, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 worker_mode: str = "thread",
                 process_shard: "Tuple[int, int] | None" = None):
        """worker_mode: "thread" (default — cv2/numpy release the GIL) or
        "process" (spawned worker pool; wins when augmentation is dominated
        by GIL-holding python, e.g. the SSD-crop retry loop on crowded
        images, and on many-core hosts). Both modes draw identical per-item
        RNG streams, so the augmented sample sequence is byte-identical.

        process_shard: (process index, process count) under data
        parallelism: this process loads ONLY rows [pid·B/n, (pid+1)·B/n) of
        every global batch (`batch_size` stays the GLOBAL batch). Shuffle
        order and per-item RNG are keyed on global positions, so the union
        of all processes' rows is byte-identical to one process's batches.
        It needs drop_last (a ragged batch cannot split evenly)."""
        if process_shard is not None:
            _check_shard(process_shard, batch_size, "batch_size")
            if not drop_last:
                raise ValueError(
                    "process_shard requires drop_last=True (a ragged final "
                    "batch cannot split evenly across processes)")
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.worker_mode = worker_mode
        if (worker_mode == "process"
                and getattr(dataset, "_img_cache", None) is not None):
            import warnings

            warnings.warn(
                "cache_images with worker_mode='process' keeps an "
                "INDEPENDENT decoded-image cache in every spawned worker "
                "(the dataset is pickled once per worker): RAM scales with "
                "num_workers and shuffled epochs gut the hit rate. Prefer "
                "worker_mode='thread' with the cache (one shared copy), or "
                "drop the cache for process workers.", stacklevel=2)
        self._epoch = 0
        self._proc_pool = None

    def set_epoch(self, epoch: int) -> None:
        """Position the loader so the NEXT `__iter__` draws epoch `epoch`'s
        (0-based) shuffle order and augmentation RNG streams. A resumed run
        that calls set_epoch(restored_step // epoch_size) therefore sees the
        SAME sample sequence as an uninterrupted one — without this, every
        fresh construction replays the epoch-0/1/2… streams."""
        self._epoch = int(epoch)

    def _process_pool(self):
        """Lazy persistent process pool (the dataset ships once, at init)."""
        if self._proc_pool is None:
            import multiprocessing as mp
            import os

            import __main__

            # spawn re-imports __main__ in each worker: fail with a real
            # message instead of a cryptic BrokenProcessPool when the parent
            # is a REPL/heredoc (same constraint as torch's DataLoader)
            main_file = getattr(__main__, "__file__", None)
            if main_file is not None and not os.path.exists(main_file):
                raise RuntimeError(
                    "worker_mode='process' needs an importable __main__ "
                    f"(got {main_file!r}); run from a .py file / python -m, "
                    "or use worker_mode='thread'")
            self._proc_pool = cf.ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context("spawn"),
                initializer=_pp_init, initargs=(self.dataset,))
        return self._proc_pool

    def close(self) -> None:
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
            self._proc_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = self._epoch_order()
        self._epoch += 1
        nb = len(self)
        epoch = self._epoch

        def seed_key(pos: int):
            # identical per-item RNG streams in thread and process modes
            return [self.seed, epoch, pos]

        # items: (canvas_u8, target, region) for a dataset with
        # device_augment, else (image, target)
        width = 3 if getattr(self.dataset, "device_augment", False) else 2

        def load_one(pos: int):
            rng = np.random.default_rng(seed_key(pos))
            return self.dataset.pull_item(int(order[pos]), rng)[:width]

        def map_batch(pool, lo: int, hi: int):
            if self.worker_mode == "process":
                return list(pool.map(
                    _pp_load, [(int(order[p]), seed_key(p), width)
                               for p in range(lo, hi)]))
            return list(pool.map(load_one, range(lo, hi)))

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that also observes `stop` — a consumer abandoning
            the iterator mid-epoch must not leave this thread blocked on a
            full queue holding image batches."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if self.worker_mode == "process":
                    pool_cm = contextlib.nullcontext(self._process_pool())
                else:
                    pool_cm = cf.ThreadPoolExecutor(self.num_workers)
                with pool_cm as pool:
                    for bi in range(nb):
                        if stop.is_set():
                            return
                        lo = bi * self.batch_size
                        hi = min(lo + self.batch_size, len(order))
                        if self.process_shard is not None:
                            # this process's rows; seed_key stays keyed on
                            # the GLOBAL position
                            pid, count = self.process_shard
                            per = (hi - lo) // count
                            lo, hi = lo + pid * per, lo + (pid + 1) * per
                        items = map_batch(pool, lo, hi)
                        images = np.stack([it[0] for it in items])
                        boxes, labels = pad_targets([it[1] for it in items],
                                                    self.max_boxes)
                        batch = (images, boxes, labels) + tuple(
                            np.stack(f) for f in list(zip(*items))[2:])
                        if not _put(batch):
                            return
            except BaseException as e:  # surface worker errors, don't hang
                _put(e)
                return
            _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def pin_batch(batch) -> Tuple[torch.Tensor, ...]:
    """A host batch (numpy arrays) copied into pinned host memory, from
    PyTorch's caching host allocator: a block freed there is handed out
    again only after the copies recorded on it have completed, so a
    staging buffer is never refilled while its copy to the card runs."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                 for a in batch)


def device_prefetch(iterator, size: int = 2, sharding=None, put_fn=None,
                    device=None):
    """Wrap a host batch iterator with asynchronous device placement: up to
    `size` batches are copied to the device ahead of the consumer,
    overlapping host augmentation and transfer with device compute.

    On CUDA (the default; it raises without a CUDA device unless `device`
    names another): each batch goes into pinned memory (`pin_batch`) and
    is copied with `non_blocking=True` on a copy stream of its own; when
    the batch is handed over, the consumer's current stream waits on an
    event recorded after the copy, and each device tensor is marked as
    used on that stream (`record_stream`), so that its memory is not given
    to a later copy before the consumer's work on it is done. No call here
    waits on the card. On another device the batches are handed over as
    tensors there, with no copy stream.

    `put_fn(batch_tuple) → tuple` overrides placement entirely. `sharding`
    (parallel.mesh.batch_sharding) takes each batch as a GLOBAL batch and
    places this process's rows of it on the process's device, the same
    way; a loader with `process_shard` yields those rows already, and goes
    to the device as it is. The arguments are checked at the call; the
    batches come from the returned generator."""
    from yolo_nano_tpu_torch.serving import resolve_device

    if sharding is not None:
        if device is not None and torch.device(device) != sharding.device:
            raise ValueError(f"device {device} is not the sharding's "
                             f"{sharding.device}")
        device = sharding.device
        iterator = (tuple(np.asarray(a)[sharding.rows(len(a))]
                          for a in batch) for batch in iterator)
    dev = resolve_device(device)
    copy_stream = None
    if put_fn is not None:
        put = put_fn
    elif dev.type == "cuda":
        copy_stream = torch.cuda.Stream(dev)

        def put(batch):
            staged = pin_batch(batch)
            with torch.cuda.stream(copy_stream):
                out = tuple(t.to(dev, non_blocking=True) for t in staged)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, done, staged
    else:
        def put(batch):
            return tuple(torch.as_tensor(np.asarray(a), device=dev)
                         for a in batch)

    def hand_over(item):
        if copy_stream is None:
            return item
        out, done, _ = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out:
            t.record_stream(consumer)
        return out

    return _prefetch(iter(iterator), size, put, hand_over)


def _prefetch(it, size: int, put, hand_over):
    queue_: "collections.deque" = collections.deque()
    try:
        for _ in range(size):
            queue_.append(put(next(it)))
    except StopIteration:
        pass
    while queue_:
        item = queue_.popleft()
        try:
            queue_.append(put(next(it)))
        except StopIteration:
            pass
        yield hand_over(item)


class EvalLoader:
    """Deterministic batched eval pipeline: yields
    (images, metas) where metas is a list of dicts with scale/offset/size/id.
    The last batch is padded by repeating the final image (fixed shapes);
    `metas` has one entry per REAL image only.

    process_shard=(process index, process count) under data parallelism:
    `batch_size` stays the GLOBAL batch; this process decodes and
    letterboxes ONLY rows [pid·B/n, (pid+1)·B/n) of every global batch (the
    final ragged batch padded by repeating its last index first), while
    `metas` still covers ALL real rows: their letterbox-undo geometry comes
    from the annotations' image sizes (dataset.image_hw →
    transforms.letterbox_geometry), no decode. Feed the rows to a
    make_predict_fn(..., process_shard=…, local_rows=True) closure: its
    gathered detections and the full metas make every process's
    evaluation one process's evaluation."""

    def __init__(self, dataset, img_size: int, batch_size: int,
                 num_workers: int = 4,
                 process_shard: "Tuple[int, int] | None" = None):
        if process_shard is not None:
            _check_shard(process_shard, batch_size, "eval batch")
        self.process_shard = process_shard
        self.dataset = dataset
        self.img_size = img_size
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        def load_one(i: int):
            img_bgr, img_id = self.dataset.pull_image(i)
            h, w = img_bgr.shape[:2]
            img, scale, offset = val_transform(img_bgr, self.img_size)
            return img, {"scale": scale, "offset": offset, "w": w, "h": h,
                         "id": img_id, "index": i}

        def meta_only(i: int):
            # the geometry load_one computes, from the annotation's size
            h, w = self.dataset.image_hw(i)
            scale, offset = letterbox_geometry(h, w, self.img_size)
            return {"scale": scale, "offset": offset, "w": w, "h": h,
                    "id": self.dataset.ids[i], "index": i}

        n = len(self.dataset)
        shard = self.process_shard
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for lo in range(0, n, self.batch_size):
                hi = min(lo + self.batch_size, n)
                if shard is None:
                    items = list(pool.map(load_one, range(lo, hi)))
                    images = [it[0] for it in items]
                    while len(images) < self.batch_size:  # pad final batch
                        images.append(images[-1])
                    yield np.stack(images), [it[1] for it in items]
                    continue
                pid, count = shard
                per = self.batch_size // count
                # the final ragged batch padded by its last index, so that
                # it still splits evenly over the processes
                idxs = list(range(lo, hi))
                idxs += [hi - 1] * (self.batch_size - len(idxs))
                img_futs = [pool.submit(load_one, i)
                            for i in idxs[pid * per:(pid + 1) * per]]
                meta_futs = [pool.submit(meta_only, i)
                             for i in range(lo, hi)]
                yield (np.stack([f.result()[0] for f in img_futs]),
                       [f.result() for f in meta_futs])
