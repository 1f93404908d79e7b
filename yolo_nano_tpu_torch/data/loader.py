"""Batched evaluation input: the port's copy of the JAX package's
`data/loader.py::EvalLoader`.

Images are decoded and letterboxed in a thread pool (cv2/numpy release the
GIL) and stacked into fixed-shape batches; each batch carries the
(scale, offset, h, w, image id) of its real images for letterbox-undo, so
evaluation runs batched (the reference evaluators loop single images,
evaluator/cocoapi_evaluator.py:65-87).

The training loader (`DetectionLoader`, `pad_targets`, `device_prefetch`)
is not ported yet (ROADMAP Queue 1 item 13), nor the multi-process shard
(item 17).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Tuple

import numpy as np

from yolo_nano_tpu_torch.data.transforms import val_transform


class EvalLoader:
    """Deterministic batched eval pipeline: yields
    (images, metas) where metas is a list of dicts with scale/offset/size/id.
    The last batch is padded by repeating the final image (fixed shapes);
    `metas` has one entry per REAL image only.

    `process_shard` (the JAX package's multi-controller mode) needs the
    port's data parallelism, which is not ported yet: it raises."""

    def __init__(self, dataset, img_size: int, batch_size: int,
                 num_workers: int = 4,
                 process_shard: "Tuple[int, int] | None" = None):
        if process_shard is not None:
            raise NotImplementedError(
                "EvalLoader: process_shard needs the port's data "
                "parallelism (ROADMAP Queue 1 item 17), which is not ported "
                "yet")
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

        n = len(self.dataset)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for lo in range(0, n, self.batch_size):
                hi = min(lo + self.batch_size, n)
                items = list(pool.map(load_one, range(lo, hi)))
                images = [it[0] for it in items]
                while len(images) < self.batch_size:  # pad final batch
                    images.append(images[-1])
                yield np.stack(images), [it[1] for it in items]
