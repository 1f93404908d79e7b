"""The scores kernel (`csrc/scores.cu`) on the card against its plain
version (`ops.kernels.scores.scores_plain`, PyTorch's own kernels on the
card), and predict on the card without a host synchronize.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. They
import only torch and numpy, so they run where JAX is not installed:
    python -m pytest tests/test_torch_scores_cuda.py --noconftest -q
Classes are compared bit for bit, and so are scores from 16 rows on: the
kernel computes every operation in f32 in the plain version's order with
the same expf and logf, and sums the exponentials in the order of
PyTorch's CUDA reduction of a row (csrc/scores.cu, `score_row`), which
PyTorch takes from 16 rows on. Under 16 rows PyTorch gives a row more
threads and sums in another order: scores there are held within a
relative 1e-6. Inputs cover one image to 256, the three-level rows of
320, 416 and 608 px, C from 1 to the kernel's largest (the two orders
PyTorch sums in, C <= 128 and above, rows starting on and off a 16-byte
boundary), f32 and bf16, tied maxima, rows holding NaN and inf, row
counts that are not a multiple of the tile and a base that is not 16-byte
aligned; the logits are drawn in [-8, 3).
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets")
RTOL = 1e-6
BATCHES = (1, 2, 32, 128, 256)
SIZES = (320, 416, 608)
CLASSES = (1, 20, 80, 81, 1000)
MAX_ELEMENTS = 10 ** 9  # B·N·C: the plain version holds four f32 copies


def _rows(size):
    """Rows of the head outputs at `size` px: 3 anchors at strides 8, 16,
    32."""
    return 3 * sum((size // s) ** 2 for s in (8, 16, 32))


CASES = [(b, s, c, d) for d in ("float32", "bfloat16") for c in CLASSES
         for s in SIZES for b in BATCHES
         if b * _rows(s) * c <= MAX_ELEMENTS]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, b, n, c, dtype, dev):
    """conf [b,n,1] and cls [b,n,c] drawn on the card (logits in [-8, 3)),
    with tied maxima, a NaN row, a row with +inf twice, a row of -inf, a
    row with one -inf and a NaN objectness in the first image's rows 0 to
    5, and the same rows again at the batch's last rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    conf = torch.randn((b, n, 1), generator=gen, device=dev) * 3
    cls = torch.rand((b, n, c), generator=gen, device=dev) * 11 - 8
    if c > 1 and n >= 6:
        for img, r in ((0, 0), (b - 1, n - 6)):
            cls[img, r, [c // 2, c - 1]] = 5.0
            cls[img, r + 1, c // 3] = float("nan")
            cls[img, r + 2, [c // 4, c - 1]] = float("inf")
            cls[img, r + 3, :] = -float("inf")
            cls[img, r + 4, c // 2] = -float("inf")
            conf[img, r + 5, 0] = float("nan")
    return conf.to(dtype), cls.to(dtype)


def _check(conf, cls):
    """The kernel against the plain version on the same card tensors:
    classes bit for bit, scores bit for bit from 16 rows on and within
    RTOL below."""
    from yolo_nano_tpu_torch.ops.kernels.scores import scores, scores_plain

    got = scores(conf, cls)
    want = scores_plain(conf, cls)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == want[0].shape == cls.shape[:2]
    bad = (got[1] != want[1].to(torch.int32)).nonzero()
    assert not len(bad), f"{len(bad)} classes differ, first {bad[:5].tolist()}"
    nan = want[0].isnan()
    assert torch.equal(got[0].isnan(), nan)
    g, w = got[0][~nan], want[0][~nan]
    rel = ((g - w).abs() / w.abs().clamp_min(torch.finfo(torch.float32).tiny))
    worst = float(rel.max()) if rel.numel() else 0.0
    assert worst <= RTOL, f"relative score difference {worst:.3g}"
    if cls.shape[0] * cls.shape[1] >= 16:
        differ = int((g != w).sum())
        assert not differ, f"{differ} scores differ, the largest by {worst:.3g}"
    return got, worst


@pytest.mark.parametrize("b,size,c,dtype", CASES)
def test_kernel_gives_the_plain_versions_scores(dev, b, size, c, dtype):
    n = _rows(size)
    conf, cls = _inputs(b * 7919 + size * 31 + c, b, n, c,
                        getattr(torch, dtype), dev)
    (score, k), _ = _check(conf, cls)
    if c > 1:
        for img, r in ((0, 0), (b - 1, n - 6)):
            assert int(k[img, r]) == c // 2       # the first of a tie
            assert int(k[img, r + 1]) == c // 3   # the NaN
            assert int(k[img, r + 2]) == c // 4   # the first +inf
            assert int(k[img, r + 3]) == 0        # all -inf
            assert bool(score[img, r + 1:r + 4].isnan().all())
            assert bool(score[img, r + 5].isnan())
            assert not bool(score[img, r + 4].isnan())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_at_its_largest_c_and_ragged_tiles(dev, dtype):
    """C up to the kernel's largest; row counts that leave the last tile
    short (checked against the tile rule) and a single row."""
    from yolo_nano_tpu_torch.ops.kernels.scores import _lib, scores_plan

    dt = getattr(torch, dtype)
    top = _lib().scores_max_c(dt.itemsize)
    assert top >= 1024
    for b, n, c in ((3, 37, top), (2, 1001, 1024), (1, 1, 80), (1, 1, 1),
                    (1, 9, 1000), (5, 10647, 80), (7, 333, 20),
                    (2, 501, 1001), (3, 203, 365), (2, 99, 129),
                    (2, 99, 128)):
        plan = scores_plan(c, dt, b * n)
        if b * n > plan["rows"]:
            assert (b * n) % plan["rows"], (b, n, c, plan)
        _check(*_inputs(b + n + c, b, n, c, dt, dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_on_a_base_not_16_byte_aligned(dev, dtype):
    """Contiguous views that start an element into their storage: the
    kernel copies element by element there."""
    dt = getattr(torch, dtype)
    b, n, c = 4, 2100, 80
    conf, cls = _inputs(11, b, n, c, dt, dev)
    flat = torch.empty(b * n * c + 1, dtype=dt, device=dev)
    shifted = flat[1:].view(b, n, c)
    shifted.copy_(cls)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    got, _ = _check(conf, shifted)
    want, _ = _check(conf, cls)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)


def test_tile_rule_avoids_a_thread_a_row_at_80_bf16_classes(dev):
    """A thread a row at C = 80 in bf16 reads eight rows from one bank."""
    from yolo_nano_tpu_torch.ops.kernels.scores import scores_plan

    plan = scores_plan(80, torch.bfloat16, 128 * 10647)
    assert plan["lanes"] > 1 and plan["rows"] % 8 == 0
    assert plan["smem"] <= 227 * 1024


def test_kernel_refuses_what_it_does_not_take(dev):
    from yolo_nano_tpu_torch.ops.kernels.scores import _lib, scores

    conf, cls = _inputs(3, 2, 500, 80, torch.float32, dev)
    for bad in ((conf, cls.transpose(0, 1).contiguous().transpose(0, 1)),
                (conf[:, ::2], cls[:, ::2]),
                (conf.double(), cls.double()),
                (conf.half(), cls.half()),
                (conf, cls.bfloat16()),
                (conf, cls.cpu())):
        with pytest.raises(ValueError):
            scores(*bad)
    top = _lib().scores_max_c(4)
    with pytest.raises(ValueError):
        scores(conf[:, :3].contiguous(),
               torch.zeros(2, 3, top + 1, device=dev))


def test_launches_count_each_call(dev):
    from yolo_nano_tpu_torch.ops.kernels.scores import scores

    conf, cls = _inputs(4, 2, 40, 80, torch.bfloat16, dev)
    before = scores.launches
    for _ in range(3):
        scores(conf, cls)
    assert scores.launches == before + 3
    scores(conf[:0], cls[:0])  # nothing to launch for
    assert scores.launches == before + 3
    torch.cuda.synchronize()


@pytest.mark.parametrize("npz", ["bench_coco416.npz",
                                 "bench_coco416_05x.npz"])
def test_predict_makes_no_host_sync_and_one_scores_launch(dev, npz):
    """A whole predict (forward, scores, top-k, decode, NMS) of the f32
    1.0x and the bf16 0.5x artifact enqueues with no synchronizing call
    once built, with one scores launch; its scores are the plain
    version's."""
    from yolo_nano_tpu_torch.ops.kernels.scores import scores
    from yolo_nano_tpu_torch.serving import load_predictor

    fn = load_predictor(os.path.join(ASSETS, npz), device="cuda")
    size = fn.input_size
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (16, size, size, 3)).astype(np.float32)).to(dev)
    fn(x)  # builds decode's rows and the kernels
    torch.cuda.synchronize()
    before = scores.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert scores.launches == before + 1
    boxes, score, classes, valid = (t.cpu() for t in out)
    assert boxes.shape == (16, fn.cfg.max_detections, 4)
    assert valid.dtype == torch.bool and classes.dtype == torch.int32
    with torch.inference_mode():
        conf, cls, _ = fn.model(x.to(fn.dtype))
        _check(conf, cls)
