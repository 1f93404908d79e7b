"""The port's inference tools against the JAX package's, on the CPU: the
FLOPs report, the class names and box drawing, the anchor k-means, and the
CLIs a user runs on a trained model (cli.test, cli.demo, cli.benchmark,
cli.eval --tta), on a synthetic VOC set.

Tolerances: parameter counts equal; GFLOPs within 0.5% of XLA's cost
analysis at 128 and 416 px (both count a convolution's taps inside the
image and the elementwise ops); drawn images, class names and k-means
equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")
JAX_BENCHMARK_KEYS = {"metric", "value", "unit", "p50_batch_ms",
                      "candidates_max", "pre_topk"}


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


@pytest.mark.parametrize("backbone,size", [("0.5x", 416), ("1.0x", 416),
                                          ("0.5x", 128), ("1.0x", 128)])
def test_flops_and_params_match_jax(backbone, size):
    """The same parameter count as JAX's, GFLOPs within 0.5% of XLA's cost
    analysis, at 416 px and at 128, where the image border is a large share
    of a convolution's taps: the port counts only the taps inside the image
    and the elementwise ops, as XLA does (0.09% to 0.15% under it measured:
    XLA counts each head output's bias add in three fusions)."""
    import jax

    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.utils.flops import flops_and_params as jax_flops

    from yolo_nano_tpu_torch.config import MULTI_ANCHOR_SIZE_COCO
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree
    from yolo_nano_tpu_torch.utils.flops import flops_and_params

    kw = dict(num_classes=80, anchors=MULTI_ANCHOR_SIZE_COCO,
              backbone=backbone)
    cfg = YoloNanoConfig(**kw)
    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(0), cfg)
    want = jax_flops(jax.tree.map(np.asarray, params), stats,
                     JaxConfig(**kw), size)
    got = flops_and_params(params, stats, cfg, size)
    assert got[2] == want[2]
    assert abs(got[0] - want[0]) <= 0.005 * want[0], (got, want)
    assert got[1] == got[0] / 2


def test_flops_of_a_folded_bf16_artifact():
    """The 0.5x bf16 artifact (folded, stats None), its leaves widened: the
    stage blocks and head pairs go through the kernels' operators, whose
    plain versions are counted, within 0.5% of XLA's count of the same
    folded tree; fewer FLOPs than the unfolded tree (no BN) and fewer
    parameters."""
    import jax

    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.utils.flops import flops_and_params as jax_flops
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like

    from yolo_nano_tpu_torch.config import config_from_json
    from yolo_nano_tpu_torch.convert import load_npz, widen_tree
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree
    from yolo_nano_tpu_torch.utils.flops import flops_and_params

    tree, meta = load_npz(NPZ_05X)
    cfg = config_from_json(meta)
    got = flops_and_params(tree, None, cfg, 96)
    wide = jax.tree.map(np.asarray, widen_tree(tree))
    want = jax_flops(wide, empty_stats_like(wide), JaxConfig(
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(cfg)}), 96)
    assert abs(got[0] - want[0]) <= 0.005 * want[0], (got, want)
    unfolded = flops_and_params(
        *init_yolo_nano_tree(torch.Generator().manual_seed(0), cfg), cfg, 96)
    assert got[0] < unfolded[0]
    assert got[2] == want[2] == 640_725 < unfolded[2]


@pytest.mark.parametrize("dataset", ["voc", "coco"])
def test_class_names_match_jax(dataset):
    from yolo_nano_tpu.cli.common import class_names_for as jax_names

    from yolo_nano_tpu_torch.cli.common import class_names_for

    assert list(class_names_for(dataset)) == list(jax_names(dataset))


def test_draw_detections_matches_jax():
    from yolo_nano_tpu.cli.common import draw_detections as jax_draw

    from yolo_nano_tpu_torch.cli.common import class_names_for, draw_detections

    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (120, 160, 3), np.uint8)
    xy = rng.uniform(0, 120, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (6, 2))], 1)
    scores = np.array([0.9, 0.2, 0.5, 0.31, 0.3, 0.99], np.float32)
    classes = np.array([0, 5, 79, 12, 3, 40], np.int32)
    names = class_names_for("coco")
    want = jax_draw(img, boxes, scores, classes, names, 0.3)
    got = draw_detections(img, boxes, scores, classes, names, 0.3)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 9), (2, 5)])
def test_anchor_kmeans_matches_jax(seed, k):
    from yolo_nano_tpu.cli import kmeans_anchor as jk

    from yolo_nano_tpu_torch.cli import kmeans_anchor as tk

    rng = np.random.default_rng(seed)
    truth = rng.uniform(10, 300, (k, 2))
    wh = np.concatenate([t + rng.normal(0, 3, (60, 2)) for t in truth])
    got, got_iou = tk.anchor_kmeans(wh, k, seed=seed)
    want, want_iou = jk.anchor_kmeans(wh, k, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got_iou == want_iou


# ---------------------------------------------------------------------------
# the CLIs on a synthetic VOC set
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    from tests.helpers import make_synthetic_voc

    return make_synthetic_voc(tmp_path_factory.mktemp("vocdev"),
                              classes=("dog",), deterministic_boxes=True)[0]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One seeded 0.5x VOC state saved twice: as a JAX orbax checkpoint and
    as a port CheckpointManager directory (convert.train_state_from_jax)."""
    import jax

    from yolo_nano_tpu.train.schedule import warmup_step_schedule
    from yolo_nano_tpu.train.state import create_train_state as jax_state
    from yolo_nano_tpu.train.state import make_optimizer as jax_optimizer
    from yolo_nano_tpu.utils.checkpoint import CheckpointManager as JaxManager

    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.convert import train_state_from_jax
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(0),
                                        build_config("voc", backbone="0.5x"))
    jax_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    state = jax_state(jax.tree.map(np.asarray, params), stats,
                      jax_optimizer(warmup_step_schedule(1e-3, 1)),
                      use_ema=False)
    mgr = JaxManager(jax_dir)
    mgr.save(0, state, wait=True)
    mgr.close()
    port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    zeros = jax.tree.map(np.zeros_like, params)
    CheckpointManager(port_dir).save(
        0, train_state_from_jax(params, stats, zeros, 0, 0))
    return jax_dir, port_dir


def test_cli_test_writes_what_the_jax_cli_writes(voc, checkpoints, tmp_path):
    """cli.test on the same weights: the same files, with the same names,
    as the JAX package's cli.test."""
    from yolo_nano_tpu.cli.test import main as jax_test

    from yolo_nano_tpu_torch.cli.test import main as port_test

    jax_dir, port_dir = checkpoints
    common = ["-d", "voc", "--root", voc, "--img_size", "64",
              "--num_images", "3", "--backbone", "0.5x"]
    jax_test(common + ["--weight", jax_dir, "--save_folder",
                       str(tmp_path / "jax")])
    n = port_test(common + ["--weight", port_dir, "--save_folder",
                            str(tmp_path / "port"), "--device", "cpu"])
    want = sorted(os.listdir(tmp_path / "jax"))
    assert n == 3 and sorted(os.listdir(tmp_path / "port")) == want
    assert want == ["000000.jpg", "000001.jpg", "000002.jpg"]


def test_cli_tta_on_a_folded_artifact():
    """--tta on a folded .npz goes through tta_predictor on the artifact's
    model, folded, in its dtype (any --img_size: TTA resizes); without
    --tta the artifact's size is required."""
    from yolo_nano_tpu_torch.cli import test as cli_test
    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.cli.eval import build_predict_fn

    argv = ["-d", "coco", "--weight", NPZ_05X, "--img_size", "320",
            "--device", "cpu", "--nms_thresh", "0.4"]
    args = cli_test.parse_args(argv + ["--tta"])
    fn = build_predict_fn(args, build_config("coco", backbone="0.5x"))
    assert fn.scales == tuple(range(320, 641, 32))
    assert fn.dtype == torch.bfloat16 and fn.model.head0.folded
    assert fn.cfg.nms_thresh == 0.4 and fn.cfg.conf_thresh == 0.1
    with pytest.raises(SystemExit, match="--img_size 416"):
        build_predict_fn(cli_test.parse_args(argv), build_config("coco"))


@pytest.fixture(scope="module")
def voc1(tmp_path_factory):
    """One VOC test image: each TTA run predicts 22 views up to 640 px."""
    from tests.helpers import make_synthetic_voc

    return make_synthetic_voc(tmp_path_factory.mktemp("voc1"), n_images=1,
                              classes=("dog",), deterministic_boxes=True)[0]


def test_cli_eval_and_test_tta_on_a_checkpoint(voc1, checkpoints, capsys,
                                                tmp_path):
    """--tta on a checkpoint: make_tta_predict on the unfolded f32 tree,
    every scale of 320-640 plain and flipped, with the CLI's NMS
    threshold; cli.eval evaluates and prints the mAP, cli.test writes the
    image."""
    from yolo_nano_tpu_torch.cli import eval as cli_eval
    from yolo_nano_tpu_torch.cli.test import main as port_test

    port_dir = checkpoints[1]
    common = ["-d", "voc", "--root", voc1, "--weight", port_dir,
              "--img_size", "64", "--backbone", "0.5x", "--device", "cpu",
              "--tta", "--nms_thresh", "0.6"]
    argv = common + ["--batch_size", "1", "--num_workers", "1"]
    args = cli_eval.parse_args(argv)
    fn = cli_eval.build_predict_fn(args, cli_eval.config_from_args(args))
    assert fn.scales == tuple(range(320, 641, 32))
    assert fn.dtype == torch.float32 and not fn.model.head0.folded
    assert fn.cfg.nms_thresh == 0.6
    ev = cli_eval.main(argv)
    assert f"Mean AP = {ev.map:.4f}" in capsys.readouterr().out
    out = str(tmp_path / "vis")
    assert port_test(common + ["--num_images", "1", "--save_folder",
                               out]) == 1
    assert os.listdir(out) == ["000000.jpg"]


def test_cli_demo_video_mode(voc, checkpoints, tmp_path, capsys):
    """The streaming demo on a short XVID video: frames written, the
    per-frame latency (first frame left out) reported as p50/p99."""
    import cv2

    from yolo_nano_tpu_torch.cli.demo import main as demo_main

    vid = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"XVID"), 10, (96, 80))
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for _ in range(5):
        w.write(rng.integers(0, 255, (80, 96, 3), np.uint8))
    w.release()
    out_dir = str(tmp_path / "demo_out")
    got = demo_main(["--mode", "video", "--path", vid, "--weight",
                     checkpoints[1], "-d", "voc", "--img_size", "64",
                     "--backbone", "0.5x", "--path_to_save", out_dir,
                     "--device", "cpu"])
    assert os.path.getsize(os.path.join(out_dir, "demo_out.avi")) > 0
    assert got["frames"] == 5 and len(got["latency_ms"]) == 4
    assert "frame latency: p50" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--path is required"):
        demo_main(["--mode", "video", "--weight", checkpoints[1]])


def test_cli_benchmark_synthetic(capsys):
    """The benchmark on the synthetic fallback, 0.5x at 64 px, batch 2:
    the FLOPs report, the reference protocol, and a last line with the JAX
    CLI's keys and the device."""
    from yolo_nano_tpu_torch.cli.benchmark import main as benchmark_main

    got = benchmark_main(["--img_size", "64", "--batch_size", "2",
                          "--iters", "2", "--backbone", "0.5x",
                          "--device", "cpu", "--reference_protocol"])
    printed = capsys.readouterr().out.splitlines()
    line = json.loads(printed[-1])
    assert JAX_BENCHMARK_KEYS <= set(line) and line["card"] == "cpu"
    assert line["value"] > 0 and line["p50_batch_ms"] > 0
    assert line["pre_topk"] == 128 and got["reference_fps"] > 0
    assert any(ln.startswith("FLOPs (x2 MAC)") for ln in printed)
    assert got["params"] == 647_325 and got["device_batches"] == 1
