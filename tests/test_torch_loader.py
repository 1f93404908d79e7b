"""Port parity of the training data layer against the JAX package, on the CPU.

`pad_targets` and `DetectionLoader` are numpy/cv2 copies of the JAX
package's, so they are held bit for bit: the same synthetic VOC set through
both loaders (two shuffled epochs, augmentation and mosaic on) gives equal
batches. `device_prefetch` is rewritten for CUDA (pinned memory, a copy
stream); on the CPU it hands over the host batches as tensors. Its card
behaviour is tested in tests/test_torch_cuda.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_voc

SIZE = 64


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root, _ = make_synthetic_voc(tmp_path_factory.mktemp("voc"), n_images=9)
    return root


def _datasets(root, mosaic=False):
    from yolo_nano_tpu.data.voc import VOCDataset as JaxVOC
    from yolo_nano_tpu_torch.data.voc import VOCDataset

    kw = dict(img_size=SIZE, image_sets=[("2007", "trainval")],
              mosaic=mosaic)
    return JaxVOC(root, **kw), VOCDataset(root, **kw)


def _epochs(loader, n):
    return [[tuple(a.copy() for a in b) for b in loader] for _ in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_pad_targets_matches_jax():
    from yolo_nano_tpu.data.loader import pad_targets as jax_pad
    from yolo_nano_tpu_torch.data.loader import pad_targets

    rng = np.random.default_rng(0)
    targets = []
    for m in (3, 0, 7, 4):  # 7 > max_boxes: the overflow is dropped
        t = rng.uniform(0, 1, (m, 5)).astype(np.float32)
        t[:, 4] = rng.integers(0, 20, m)
        targets.append(t)
    got, want = pad_targets(targets, 4), jax_pad(targets, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (got[1][1] == -1).all() and (got[1][2] != -1).all()


@pytest.mark.parametrize("mosaic", [False, True])
@pytest.mark.parametrize("num_workers", [1, 3])
def test_detection_loader_matches_jax(voc_root, num_workers, mosaic):
    """Two shuffled epochs of augmented batches, bit for bit."""
    from yolo_nano_tpu.data.loader import DetectionLoader as JaxLoader
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    jds, ds = _datasets(voc_root, mosaic)
    kw = dict(batch_size=2, max_boxes=8, num_workers=num_workers, seed=5)
    want = _epochs(JaxLoader(jds, **kw), 2)
    got = _epochs(DetectionLoader(ds, **kw), 2)
    assert len(got[0]) == 4  # 9 // 2, drop_last
    assert not np.array_equal(got[0][0][0], got[1][0][0])
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_set_epoch_reproduces_an_epoch(voc_root):
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    _, ds = _datasets(voc_root)
    kw = dict(batch_size=2, max_boxes=8, num_workers=2, seed=3)
    epochs = _epochs(DetectionLoader(ds, **kw), 2)
    fresh = DetectionLoader(ds, **kw)
    fresh.set_epoch(1)
    _assert_batches_equal(_epochs(fresh, 1)[0], epochs[1])


def test_process_mode_matches_thread_mode(voc_root):
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    _, ds = _datasets(voc_root, mosaic=True)
    kw = dict(batch_size=2, max_boxes=8, num_workers=2, seed=7)
    thread = _epochs(DetectionLoader(ds, **kw), 1)[0]
    proc = DetectionLoader(ds, worker_mode="process", **kw)
    try:
        _assert_batches_equal(_epochs(proc, 1)[0], thread)
    finally:
        proc.close()


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_device_mode_loader_matches_jax(voc_root, worker_mode):
    """A dataset with device_augment: batches of (uint8 canvases, boxes,
    labels, regions [B,5]) bit for bit JAX's DetectionLoader's, in both
    worker modes, with mosaic set (composed in the step, so the host ships
    plain canvases)."""
    from yolo_nano_tpu.data.loader import DetectionLoader as JaxLoader
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    jds, ds = _datasets(voc_root, mosaic=True)
    jds.device_augment = ds.device_augment = True
    kw = dict(batch_size=2, max_boxes=8, num_workers=2, seed=9)
    want = _epochs(JaxLoader(jds, **kw), 1)[0]
    loader = DetectionLoader(ds, worker_mode=worker_mode, **kw)
    try:
        got = _epochs(loader, 1)[0]
    finally:
        loader.close()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        assert g[0].dtype == np.uint8 and g[3].shape == (2, 5)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_loader_refusals_and_the_cache_warning(voc_root):
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    from yolo_nano_tpu.data.loader import DetectionLoader as JaxLoader

    jds, ds = _datasets(voc_root)
    # the JAX package's process_shard refusals: a place outside the
    # processes, a global batch that does not divide, a ragged last batch
    for (cls, d), (shard, kw, msg) in [
            (pair, case) for pair in ((JaxLoader, jds), (DetectionLoader, ds))
            for case in (((2, 2), {}, "bad process_shard"),
                         ((0, 2), dict(batch_size=3), "divide evenly"),
                         ((1, 2), dict(drop_last=False), "drop_last"))]:
        with pytest.raises(ValueError, match=msg):
            cls(d, **dict(dict(batch_size=2), **kw), process_shard=shard)
    with pytest.raises(ValueError, match="worker_mode"):
        DetectionLoader(ds, 2, worker_mode="fork")
    ds.enable_image_cache()
    with pytest.warns(UserWarning, match="cache_images"):
        DetectionLoader(ds, 2, worker_mode="process")


class _CountingDataset:
    """pull_item counts its calls; `fail_at` makes one raise."""

    def __init__(self, n=64, fail_at=None):
        self.n, self.fail_at, self.calls = n, fail_at, 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def pull_item(self, index, rng=None):
        with self.lock:
            self.calls += 1
        if index == self.fail_at:
            raise RuntimeError("corrupt image")
        return (np.zeros((8, 8, 3), np.float32),
                np.zeros((1, 5), np.float32))


def test_worker_exception_surfaces():
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    loader = DetectionLoader(_CountingDataset(4, fail_at=2), batch_size=2,
                             num_workers=2, shuffle=False)
    with pytest.raises(RuntimeError, match="corrupt image"):
        list(loader)


def test_abandoned_iterator_stops_its_producer():
    """A consumer that leaves mid-epoch: the producer observes `stop` at
    its bounded put and ends, instead of loading the rest of the epoch or
    blocking on the full queue."""
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    ds = _CountingDataset(64)
    before = threading.active_count()
    it = iter(DetectionLoader(ds, batch_size=2, num_workers=1, prefetch=1))
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    calls = ds.calls
    assert calls < 64
    time.sleep(0.3)
    assert ds.calls == calls


def test_device_prefetch_on_the_cpu(voc_root):
    """On the CPU the batches come back as tensors equal to the host's, in
    order; sharding raises at the call; put_fn replaces the placement."""
    from yolo_nano_tpu_torch.data.loader import (DetectionLoader,
                                                 device_prefetch)

    _, ds = _datasets(voc_root)
    host = _epochs(DetectionLoader(ds, batch_size=2, max_boxes=8, seed=1), 1
                   )[0]
    got = list(device_prefetch(iter(host), size=2, device="cpu"))
    assert len(got) == len(host)
    for g, w in zip(got, host):
        for t, a in zip(g, w):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(t.numpy(), a)
    assert list(device_prefetch(iter([]), device="cpu")) == []
    tagged = list(device_prefetch(iter(host), size=1, device="cpu",
                                  put_fn=lambda b: ("put", len(b))))
    assert tagged == [("put", 3)] * len(host)
    # sharding: this process's rows of each global batch, on its device; a
    # batch that does not divide over the processes raises, as the JAX
    # package's shard_batch refuses it
    from yolo_nano_tpu_torch.parallel.mesh import BatchSharding

    second = BatchSharding(1, 2, torch.device("cpu"))
    rows = list(device_prefetch(iter(host), sharding=second))
    for g, w in zip(rows, host):
        for t, a in zip(g, w):
            np.testing.assert_array_equal(t.numpy(), a[1:2])
    with pytest.raises(ValueError, match="must divide"):
        list(device_prefetch(iter([tuple(a[:1] for a in host[0])]),
                             sharding=second))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_prefetch(iter(host))
