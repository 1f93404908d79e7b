"""The port's evaluation slice against the JAX package's, on the CPU: the
data readers and transforms, `EvalLoader`, the VOC and COCO metrics, the
evaluators with their dump files, and evaluation end to end through both
sides' `load_predictor` on the committed artifacts.

The metrics, loaders and evaluators are numpy copies, so they are held
exactly: equal arrays, equal stats, byte-equal dump files. End to end:
  * f32 (`bench_coco416`): the port's detections equal JAX's to 1e-4
    (tests/test_torch_model.py), so COCO AP is held within 1e-6;
  * bf16 (`bench_coco416_05x`): the port's and JAX's bf16 forwards are two
    bf16 approximations of one function (tests/test_torch_bf16.py), whose
    detections are matched, not equal: a score moves by up to 10% of
    itself (chip_smoke.BF16_MATCH), enough to swap a true and a false
    positive of a class in rank. One such swap at ranks k, k + 1 moves the
    precision at one of the class's npos recall steps by tp/(k(k+1)) <=
    1/2, so the class's AP by at most 1/(2·npos), and the mean over the C
    classes with ground truth by 1/(2·npos·C): 1/54 here (3 classes of at
    least 9 boxes in the 16 val images). AP, AP50 and AR100 are held within
    BF16_AP_ATOL = 0.02, one such swap (measured: AP 0.0005, AP50 0.001,
    AR100 0); the gaps are printed under `-s`.
"""

import filecmp
import json
import os
import pickle

import numpy as np
import pytest

from chip_smoke import oracle_predict_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets")
BF16_AP_ATOL = 0.02


# ---------------------------------------------------------------------------
# metrics on the same detections
# ---------------------------------------------------------------------------

def _voc_case(kind, seed):
    """(detections, gt_by_image) of one class: gts with difficult flags,
    detections jittered from them plus duplicates and false positives."""
    rng = np.random.default_rng(seed)
    gt = {}
    dets = []
    for i in range(6):
        name = f"im{i}"
        n = 0 if kind == "no_gt_here" and i % 2 else int(rng.integers(0, 4))
        xy = rng.uniform(0, 300, (n, 2))
        wh = rng.uniform(20, 120, (n, 2))
        boxes = np.round(np.concatenate([xy, xy + wh], 1))
        diff = (rng.uniform(size=n) < (0.4 if kind == "difficult" else 0.1))
        gt[name] = {"bbox": boxes.reshape(-1, 4), "difficult": diff}
        for b in boxes:
            if rng.uniform() < 0.8:
                dets.append((name, float(rng.uniform()),
                             b + rng.normal(0, 6, 4) - 1))
                if kind == "duplicates" and rng.uniform() < 0.6:
                    dets.append((name, float(rng.uniform()),
                                 b + rng.normal(0, 3, 4) - 1))
        for _ in range(int(rng.integers(0, 3))):
            xy = rng.uniform(0, 300, 2)
            dets.append((name, float(rng.uniform()),
                         np.concatenate([xy, xy + rng.uniform(20, 90, 2)])))
    if kind == "empty_class":
        dets = []
    if kind == "tied_scores":
        dets = [(n, 0.5, b) for n, _, b in dets]
    return dets, gt


@pytest.mark.parametrize("kind", ["random", "duplicates", "difficult",
                                  "empty_class", "no_gt_here",
                                  "tied_scores"])
def test_voc_metric_matches_jax(kind):
    """voc_eval_class (VOC07 11-point and area under the curve) and voc_ap:
    the port's rec, prec and AP equal JAX's exactly."""
    from yolo_nano_tpu.evaluation import voc_eval as jv

    from yolo_nano_tpu_torch.evaluation import voc_eval as tv

    for seed in range(3):
        dets, gt = _voc_case(kind, seed)
        for use_07 in (True, False):
            want = jv.voc_eval_class(dets, gt, 0.5, use_07)
            got = tv.voc_eval_class(dets, gt, 0.5, use_07)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            if kind == "empty_class":
                assert got[2] == -1.0
        rng = np.random.default_rng(seed)
        rec = np.sort(rng.uniform(size=9))
        prec = rng.uniform(size=9)
        for use_07 in (True, False):
            assert tv.voc_ap(rec, prec, use_07) == jv.voc_ap(rec, prec, use_07)


def _coco_case(seed):
    """COCO gts over 5 images and 3 categories, small, medium and large,
    some crowd; detections jittered from them and false positives."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    aid = 1
    for img in range(1, 6):
        for _ in range(int(rng.integers(1, 7))):
            side = float(rng.choice([14.0, 50.0, 150.0])) * rng.uniform(0.7,
                                                                       1.3)
            x, y = rng.uniform(0, 400, 2)
            bw, bh = side, side * rng.uniform(0.6, 1.5)
            cat = int(rng.choice([1, 3, 7]))
            gts.append({"id": aid, "image_id": img, "category_id": cat,
                        "bbox": [x, y, bw, bh], "area": bw * bh,
                        "iscrowd": int(rng.uniform() < 0.15)})
            aid += 1
            for _ in range(int(rng.integers(0, 3))):
                j = rng.normal(0, 0.08 * side, 4)
                dets.append({"image_id": img, "category_id": cat,
                             "bbox": [x + j[0], y + j[1], bw + j[2],
                                      bh + j[3]],
                             "score": float(rng.uniform())})
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(0, 400, 2)
            dets.append({"image_id": img,
                         "category_id": int(rng.choice([1, 3, 7])),
                         "bbox": [x, y, *rng.uniform(5, 160, 2)],
                         "score": float(rng.uniform())})
    return gts, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_matches_jax(seed):
    """COCOEval.evaluate: the port's stats dict equals JAX's key for key,
    over crowd gts and all three area ranges."""
    from yolo_nano_tpu.evaluation.coco_eval import COCOEval as JaxEval

    from yolo_nano_tpu_torch.evaluation.coco_eval import COCOEval

    gts, dets = _coco_case(seed)
    assert any(g["iscrowd"] for g in gts)
    want = JaxEval(gts, range(1, 6), [1, 3, 7]).evaluate(dets, verbose=False)
    got = COCOEval(gts, range(1, 6), [1, 3, 7]).evaluate(dets, verbose=False)
    assert list(got) == list(want)
    assert got == want
    assert all(want[k] > -1 for k in ("APs", "APm", "APl"))


# ---------------------------------------------------------------------------
# data readers and EvalLoader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic_voc(tmp_path_factory):
    from tests.helpers import make_synthetic_voc

    return make_synthetic_voc(tmp_path_factory.mktemp("vocdev"),
                              n_images=7, splits=("trainval", "test"))


@pytest.fixture(scope="module")
def synthetic_coco(tmp_path_factory):
    """Rendered shapes in COCO format with all 80 categories declared, as
    the COCO artifacts were trained: 16 val2017 images."""
    from tools.make_synthetic_data import make_coco

    root = str(tmp_path_factory.mktemp("coco"))
    make_coco(root, n=24, train_frac=1 / 3, full_cats=True)
    return root


def _datasets(kind, root, img_size=96, **kw):
    """The same split through JAX's reader and the port's."""
    if kind == "voc":
        from yolo_nano_tpu.data.voc import VOCDataset as J

        from yolo_nano_tpu_torch.data.voc import VOCDataset as T

        args = dict(image_sets=[("2007", "test")], keep_difficult=True)
    else:
        from yolo_nano_tpu.data.coco import COCODataset as J

        from yolo_nano_tpu_torch.data.coco import COCODataset as T

        args = dict(image_set="val2017")
    args.update(img_size=img_size, **kw)
    return J(root, **args), T(root, **args)


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_eval_loader_matches_jax(kind, synthetic_voc, synthetic_coco):
    """Batches of 3 over 7 VOC and 16 COCO images (a ragged last batch,
    padded with its final image): images and metas bit-equal to JAX's."""
    from yolo_nano_tpu.data.loader import EvalLoader as JaxLoader

    from yolo_nano_tpu_torch.data.loader import EvalLoader

    root = synthetic_voc[0] if kind == "voc" else synthetic_coco
    jds, tds = _datasets(kind, root)
    want = list(JaxLoader(jds, 96, 3, num_workers=2))
    got = list(EvalLoader(tds, 96, 3, num_workers=2))
    assert len(got) == len(want) == len(EvalLoader(tds, 96, 3)) == -(
        -len(tds) // 3)
    assert len(tds) % 3
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.shape == wi.shape == (3, 96, 96, 3) and gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        assert len(gm) == len(wm)
        for g, w in zip(gm, wm):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    last_images, last_metas = got[-1]
    assert len(last_metas) == len(tds) % 3
    np.testing.assert_array_equal(last_images[-1],
                                  last_images[len(last_metas) - 1])


@pytest.mark.parametrize("kind,mosaic", [("voc", False), ("voc", True),
                                         ("coco", True)])
def test_pull_item_matches_jax(kind, mosaic, synthetic_voc, synthetic_coco):
    """The train path of the readers (transforms, mosaic, base): pull_item
    with augmentation, from the same seed, bit-equal to JAX's; and in device
    mode (device_augment: the uint8 canvas, its target and its region, the
    in-graph augmentation's input) bit-equal to JAX's _pull_item_device,
    without and with the canvas cache (read twice: the miss and the hit),
    which evicts each decoded image once its canvas is memoized."""
    root = synthetic_voc[0] if kind == "voc" else synthetic_coco
    jds, tds = _datasets(kind, root, mosaic=mosaic, augment=True)
    for i in range(len(tds)):
        want = jds.pull_item(i, np.random.default_rng(i))
        got = tds.pull_item(i, np.random.default_rng(i))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tds.image_hw(i), jds.image_hw(i))
    jds.device_augment = tds.device_augment = True
    for cache in (False, True):
        if cache:
            jds.enable_image_cache()
            tds.enable_image_cache()
        for i in range(len(tds)):
            for _ in range(1 + cache):
                want = jds.pull_item(i, np.random.default_rng(i))
                got = tds.pull_item(i, np.random.default_rng(i))
                assert len(got) == len(want) == 3
                assert got[0].dtype == want[0].dtype == np.uint8
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
    assert tds._img_cache == {} and len(tds._canvas_cache) == len(tds)


def test_eval_loader_refuses_process_shard(synthetic_voc):
    from yolo_nano_tpu_torch.data.loader import EvalLoader

    from yolo_nano_tpu.data.loader import EvalLoader as JaxEvalLoader

    jds, tds = _datasets("voc", synthetic_voc[0])
    # the JAX package's refusals: a place outside the processes, and a
    # global eval batch that does not divide over them
    for cls, ds in ((JaxEvalLoader, jds), (EvalLoader, tds)):
        with pytest.raises(ValueError, match="bad process_shard"):
            cls(ds, 96, 4, process_shard=(2, 2))
        with pytest.raises(ValueError, match="divide evenly"):
            cls(ds, 96, 5, process_shard=(0, 2))


# ---------------------------------------------------------------------------
# evaluators on an oracle predict_fn (chip_smoke.py's, which phase 6 runs)
# ---------------------------------------------------------------------------

def test_voc_evaluator_matches_jax(synthetic_voc, tmp_path):
    """VOCEvaluator on the oracle: mAP, per-class AP and gt counts equal to
    JAX's (AP 1.0 for each present class), and its dump files
    (results/det_test_<cls>.txt, detections.pkl) equal JAX's."""
    from yolo_nano_tpu.evaluation.evaluator import VOCEvaluator as JaxEval

    from yolo_nano_tpu_torch.evaluation.evaluator import VOCEvaluator

    root, _ = synthetic_voc
    dumps = [str(tmp_path / d) for d in ("jax", "port")]
    evs = [cls(root, 96, batch_size=3, num_workers=2, dump_dir=d)
           for cls, d in zip((JaxEval, VOCEvaluator), dumps)]
    maps = [ev.evaluate(oracle_predict_fn(ev.dataset, "voc", 96))
            for ev in evs]
    want, got = evs
    assert maps[1] == maps[0] == got.map
    assert got.aps == want.aps and got.gt_npos == want.gt_npos
    for cls, ap in got.aps.items():
        assert ap == pytest.approx(1.0 if got.gt_npos[cls] else -1.0,
                                   abs=1e-6), cls
    names = sorted(os.listdir(os.path.join(dumps[0], "results")))
    assert len(names) == 20 and "det_test_dog.txt" in names
    assert names == sorted(os.listdir(os.path.join(dumps[1], "results")))
    for name in names:
        assert filecmp.cmp(os.path.join(dumps[0], "results", name),
                           os.path.join(dumps[1], "results", name),
                           shallow=False), name
    tables = []
    for d in dumps:
        with open(os.path.join(d, "detections.pkl"), "rb") as f:
            tables.append(pickle.load(f))
    assert tables[0].keys() == tables[1].keys()
    for cls in tables[0]:
        assert tables[0][cls].keys() == tables[1][cls].keys()
        for name, a in tables[0][cls].items():
            np.testing.assert_array_equal(tables[1][cls][name], a)


def test_coco_evaluator_matches_jax(synthetic_coco, tmp_path):
    """COCOEvaluator on the oracle: AP50 and AP (1.0), the stats and the
    results json equal to JAX's; the test-dev path writes the same json."""
    from yolo_nano_tpu.evaluation.evaluator import COCOEvaluator as JaxEval

    from yolo_nano_tpu_torch.evaluation.evaluator import COCOEvaluator

    dumps = [str(tmp_path / d / "results.json") for d in ("jax", "port")]
    evs = [cls(synthetic_coco, 96, batch_size=3, num_workers=2, dump_path=d)
           for cls, d in zip((JaxEval, COCOEvaluator), dumps)]
    out = [ev.evaluate(oracle_predict_fn(ev.dataset, "coco", 96))
           for ev in evs]
    assert out[1] == out[0]
    assert out[1][0] == pytest.approx(1.0, abs=1e-6)
    assert out[1][1] == pytest.approx(1.0, abs=1e-6)
    assert evs[1].stats == evs[0].stats
    assert filecmp.cmp(*dumps, shallow=False)
    with open(dumps[1]) as f:
        assert len(json.load(f)) == sum(len(v) for v in
                                        evs[1].dataset._anns.values())
    tests = [str(tmp_path / d / "test.json") for d in ("jax", "port")]
    for cls, path in zip((JaxEval, COCOEvaluator), tests):
        ev = cls(synthetic_coco, 96, batch_size=3, num_workers=2,
                 testset=True, dump_path=path)
        assert ev.evaluate(oracle_predict_fn(ev.dataset, "coco", 96)) == (
            -1.0, -1.0)
    assert filecmp.cmp(*tests, shallow=False)


# ---------------------------------------------------------------------------
# end to end through both sides' load_predictor
# ---------------------------------------------------------------------------

def _coco_ap(evaluator_cls, root, predict_fn):
    ev = evaluator_cls(root, 416, batch_size=4, num_workers=2)
    ev.evaluate(predict_fn)
    return ev.stats


@pytest.fixture(scope="module")
def e2e_stats(synthetic_coco):
    """COCO stats of the 16 val images through JAX's and the port's
    load_predictor on each committed artifact (f32 1.0x, bf16 0.5x), each
    side through its own COCOEvaluator; computed once for the module."""
    from yolo_nano_tpu.evaluation.evaluator import COCOEvaluator as JaxEval
    from yolo_nano_tpu.serving import load_predictor as jax_load_predictor

    from yolo_nano_tpu_torch.evaluation.evaluator import COCOEvaluator
    from yolo_nano_tpu_torch.serving import load_predictor

    out = {}
    for name in ("bench_coco416", "bench_coco416_05x"):
        jfn = jax_load_predictor(os.path.join(ROOT, "assets", name))
        tfn = load_predictor(os.path.join(ASSETS, name + ".npz"),
                             device="cpu")
        out[name] = (_coco_ap(JaxEval, synthetic_coco,
                              lambda x, f=jfn: [np.asarray(t) for t in f(x)]),
                     _coco_ap(COCOEvaluator, synthetic_coco, tfn))
    return out


def test_coco_ap_f32_end_to_end_matches_jax(e2e_stats):
    """f32: the 1.0x artifact's COCO stats through the port's load_predictor
    on the CPU equal JAX's within 1e-6, every key."""
    want, got = e2e_stats["bench_coco416"]
    print({k: (got[k], want[k]) for k in ("AP", "AP50")})
    assert want["AP50"] > 0.1  # the model finds shapes: AP is not 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def _gt_counts(root):
    """{category: its boxes} of the val2017 split."""
    with open(os.path.join(root, "annotations",
                           "instances_val2017.json")) as f:
        anns = json.load(f)["annotations"]
    out = {}
    for a in anns:
        out.setdefault(a["category_id"], []).append(a["id"])
    return out


def test_coco_ap_bf16_end_to_end_matches_jax(e2e_stats, synthetic_coco):
    """bf16: the 0.5x artifact's AP and AP50 through the port within
    BF16_AP_ATOL of JAX's (two bf16 approximations; module docstring)."""
    want, got = e2e_stats["bench_coco416_05x"]
    assert min(len(v) for v in _gt_counts(synthetic_coco).values()) >= 9
    gaps = {k: got[k] - want[k] for k in ("AP", "AP50", "AR100")}
    print(f"bf16 COCO stats, port - JAX: {gaps}; JAX AP {want['AP']:.4f} "
          f"AP50 {want['AP50']:.4f}")
    assert want["AP50"] > 0.1
    for k, gap in gaps.items():
        assert abs(gap) <= BF16_AP_ATOL, (k, got[k], want[k])


# ---------------------------------------------------------------------------
# cli/eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def voc_checkpoints(tmp_path_factory):
    """A 0.5x VOC train state saved by the port's CheckpointManager, once
    without EMA and once with an EMA that differs from the weights."""
    import torch

    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.train import create_train_state, make_optimizer
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = build_config("voc", backbone="0.5x")
    model = init_yolo_nano(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tx = make_optimizer(lambda count: 1e-3)
    dirs = {}
    for ema in (False, True):
        state = create_train_state(model, tx, use_ema=ema)
        if ema:
            for k, v in state.ema_params.items():
                v.mul_(1.01)
        d = str(tmp_path_factory.mktemp("ema" if ema else "plain"))
        CheckpointManager(d).save(3, state)
        dirs[ema] = (d, state)
    return cfg, dirs


def _cli(root, weight, *extra):
    from yolo_nano_tpu_torch.cli import eval as cli_eval

    return cli_eval.main(["-d", "voc", "--root", root, "--weight", weight,
                          "--img_size", "64", "--batch_size", "4",
                          "--num_workers", "1", "--backbone", "0.5x",
                          "--device", "cpu", *extra])


@pytest.mark.parametrize("ema", [False, True])
def test_cli_eval_on_a_port_checkpoint(synthetic_voc, voc_checkpoints,
                                       capsys, ema):
    """cli.eval.main on a 0.5x checkpoint with --device cpu prints the mAP
    that VOCEvaluator gives for make_predict_fn at its defaults (fold,
    bf16) on the saved weights (--ema: on the EMA weights)."""
    from yolo_nano_tpu_torch.cli.common import make_predict_fn
    from yolo_nano_tpu_torch.convert import tree_from_named
    from yolo_nano_tpu_torch.evaluation.evaluator import VOCEvaluator

    root, _ = synthetic_voc
    cfg, dirs = voc_checkpoints
    weight, state = dirs[ema]
    ev = _cli(root, weight, *(["--ema"] if ema else []))
    printed = capsys.readouterr().out
    assert f"Mean AP = {ev.map:.4f}" in printed
    params, stats = ((state.ema_params, state.ema_stats) if ema
                     else (state.params, state.stats))
    fn = make_predict_fn(tree_from_named(params), tree_from_named(stats),
                         cfg, 64, device="cpu")
    want = VOCEvaluator(root, 64, batch_size=4, num_workers=1)
    assert ev.map == want.evaluate(fn)
    assert ev.aps == want.aps


def test_cli_eval_refuses(synthetic_voc, voc_checkpoints):
    """--ema on a state saved without EMA exits with the JAX CLI's message
    (--tta too: it reads the same weights); with no CUDA device and no
    --device it raises."""
    import torch

    from yolo_nano_tpu_torch.cli import eval as cli_eval

    root, _ = synthetic_voc
    weight = voc_checkpoints[1][False][0]
    for extra in ((), ("--tta",)):
        with pytest.raises(SystemExit, match="carries no EMA state"):
            _cli(root, weight, "--ema", *extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_eval.main(["-d", "voc", "--root", root, "--weight", weight,
                           "--backbone", "0.5x", "--img_size", "64"])


def test_cli_eval_on_a_folded_artifact(synthetic_coco, e2e_stats):
    """--weight a folded .npz: cli.eval.main on COCO val goes through
    load_predictor in the artifact's dtype and gives the port's COCO stats
    of the end-to-end test; another --img_size than the artifact's exits."""
    import torch

    from yolo_nano_tpu_torch.cli import eval as cli_eval

    npz = os.path.join(ASSETS, "bench_coco416_05x.npz")
    args = ["-d", "coco-val", "--root", synthetic_coco, "--weight", npz,
            "--batch_size", "4", "--num_workers", "2", "--device", "cpu"]
    ev = cli_eval.main(args)
    assert ev.stats == e2e_stats["bench_coco416_05x"][1]
    with pytest.raises(SystemExit, match="--img_size 416"):
        cli_eval.main(args + ["--img_size", "320"])
    # the threshold flags reach the artifact's config, --diou_nms included
    parsed = cli_eval.parse_args(args + ["--diou_nms", "--nms_thresh", "0.6"])
    fn = cli_eval.build_predict_fn(parsed, cli_eval.config_from_args(parsed))
    assert fn.cfg.diou_nms and fn.cfg.nms_thresh == 0.6
    assert fn.dtype == torch.bfloat16 and fn.input_size == 416
