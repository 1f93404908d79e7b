"""The port's batch buckets against the JAX package's, on the CPU:
`serving.bucket_batches` around one deterministic numpy predict function,
`optimal_batch` and `default_buckets` on one table, the port's own batch
table (measured on the card), and `load_predictor(batch_buckets=...)` on
the committed 0.5x artifact, each image's result bit for bit that of an
unbucketed call.
"""

import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's CPU forwards: the suite runs
    files in parallel worker processes, where every process's default pool
    of one thread per core oversubscribes the cores (a 4 s TTA run took
    390 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_predict(images):
    """Per-image statistics, and the batch it was called with (which shows
    the bucket each chunk was padded to)."""
    b = images.shape[0]
    flat = np.asarray(images, np.float32).reshape(b, -1)
    return (flat.mean(1), flat.max(1)[:, None] * np.arange(3),
            np.full(b, b, np.int32))


@pytest.mark.parametrize("n", [1, 3, 8, 9, 70])
def test_bucket_batches_matches_jax(n):
    from yolo_nano_tpu.serving import bucket_batches as jax_buckets

    from yolo_nano_tpu_torch.serving import bucket_batches

    x = np.random.default_rng(n).normal(size=(n, 4, 4, 3)).astype(
        np.float32)
    buckets = (8, 1, 4, 4)  # unsorted, repeated: both sides normalize
    want = jax_buckets(_numpy_predict, buckets)(x)
    got = bucket_batches(_numpy_predict, buckets)(x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # each image's own statistics survive the padding
    np.testing.assert_array_equal(got[0], x.reshape(n, -1).mean(1))


def test_bucket_batches_refuses_what_jax_refuses():
    from yolo_nano_tpu_torch.serving import bucket_batches

    wrapped = bucket_batches(lambda x: (x,), buckets=(2, 4))
    with pytest.raises(ValueError, match="empty batch"):
        wrapped(np.zeros((0, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="positive"):
        bucket_batches(lambda x: (x,), buckets=(0, 4))
    with pytest.raises(ValueError, match="img_shape"):
        bucket_batches(lambda x: (x,), buckets=(2,), warmup=True)


def test_optimal_batch_and_default_buckets_match_jax(tmp_path):
    """One table through both sides: exact size, the nearest swept size,
    an unswept backbone and a missing table (the default), the ladder."""
    from yolo_nano_tpu import serving as jax_serving

    from yolo_nano_tpu_torch import serving

    table = {"best": {"1.0x/320": {"batch": 128, "img_per_s": 1.0},
                      "1.0x/608": {"batch": 64, "img_per_s": 1.0},
                      "0.5x/416": {"batch": 8, "img_per_s": 1.0}}}
    path = str(tmp_path / "table.json")
    with open(path, "w") as f:
        json.dump(table, f)
    missing = str(tmp_path / "nope.json")
    for size in (256, 320, 352, 463, 465, 608, 640):
        for bb in ("1.0x", "0.5x", "2.0x"):
            for p in (path, missing):
                assert serving.optimal_batch(size, bb, table_path=p) == \
                    jax_serving.optimal_batch(size, bb, table_path=p)
                assert serving.default_buckets(size, bb, table_path=p) == \
                    jax_serving.default_buckets(size, bb, table_path=p)
    assert serving.optimal_batch(352, table_path=path) == 128
    assert serving.default_buckets(608, table_path=path) == (1, 8, 32, 64)
    assert serving.default_buckets(416, "0.5x", table_path=path) == (1, 8)
    assert serving.optimal_batch(320, table_path=missing, default=42) == 42


def test_shipped_table_is_the_cards_own():
    """The port reads its own table, measured on an NVIDIA card, with a
    measured entry for both artifacts' backbones at every swept size."""
    from yolo_nano_tpu_torch import serving

    path = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                        "autotune_batch.json")
    assert os.path.abspath(serving._AUTOTUNE_TABLE) == path
    with open(path) as f:
        table = json.load(f)
    assert table["device"].startswith("NVIDIA"), table["device"]
    assert "W" in table["device"]  # the power limit beside the name
    for bb in ("1.0x", "0.5x"):
        for size in (320, 416, 608):
            best = table["best"][f"{bb}/{size}"]
            assert serving.optimal_batch(size, bb) == best["batch"]
            assert serving.default_buckets(size, bb)[-1] == best["batch"]
            batches = [int(k.split("/")[2]) for k in table["points"]
                       if k.startswith(f"{bb}/{size}/")]
            assert sorted(batches) == [1, 8, 32, 64, 128, 256]
            assert best["img_per_s"] == max(
                table["points"][f"{bb}/{size}/{b}"]["img_per_s"]
                for b in batches)


@pytest.fixture(scope="module")
def scenes():
    import bench

    return bench.render_inputs(5, 416, seed=5)


def test_load_predictor_buckets_give_each_image_its_own_result(scenes):
    """Buckets (1, 2, 4) on the 0.5x artifact: a request of 3 is padded to
    4, one of 5 goes as 4 + 1; every image's detections equal those of an
    unbucketed call on the same request, bit for bit."""
    from yolo_nano_tpu_torch.serving import load_predictor

    plain = load_predictor(NPZ_05X, device="cpu", conf_thresh=0.1)
    fn = load_predictor(NPZ_05X, device="cpu", conf_thresh=0.1,
                        batch_buckets=(1, 2, 4))
    assert fn.buckets == (1, 2, 4) and fn.input_size == 416
    assert fn.dtype == torch.bfloat16
    for n in (1, 3, 5):
        want = plain(scenes[:n])
        got = fn(scenes[:n])
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert want[3].sum() >= 5  # the images carry detections


def test_load_predictor_auto_buckets_and_device_tensors(scenes, monkeypatch):
    """"auto" takes default_buckets of the artifact's backbone and size;
    a predictor takes a tensor already on its device and gives tensors
    there, equal to the numpy path's."""
    from yolo_nano_tpu_torch import serving

    asked = []

    def ladder(size, backbone):
        asked.append((size, backbone))
        return (1, 2)

    monkeypatch.setattr(serving, "default_buckets", ladder)
    fn = serving.load_predictor(NPZ_05X, device="cpu", batch_buckets="auto")
    assert asked == [(416, "0.5x")] and fn.buckets == (1, 2)
    plain = serving.load_predictor(NPZ_05X, device="cpu")
    got = plain(torch.from_numpy(scenes[:2]))
    assert all(isinstance(t, torch.Tensor) for t in got)
    for g, w in zip(got, plain(scenes[:2])):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(fn(torch.from_numpy(scenes[:3])), plain(scenes[:3])):
        np.testing.assert_array_equal(g, w)
