"""Port parity of data parallelism (`yolo_nano_tpu_torch/parallel/`) against
the JAX package and against one process, on the CPU.

The JAX package's contract (tests/test_multiprocess_cli.py): n processes
give the result of one process on the same global batch. The port keeps
it with one process per device, joined by a gloo group here (NCCL on the
card): the batch split by rank, the state replicated, sync-BN and one
gradient all-reduce in the step.

  * loaders: JAX's DetectionLoader and EvalLoader with process_shard (p, 2)
    and (p, 4) against the port's, bit for bit, the padded ragged eval
    batch and the metas included; the ranks' rows together equal one
    process's batches;
  * the rest runs on 2 spawned ranks (tests/torch_ranks.py, one
    `parallel_checks` call each), while this process computes the
    references: sync-BN on the halves of a batch against one process on
    the whole (f64: output, running stats and input gradient within
    1e-12) and against JAX's `_batch_norm(train=True)` in f32 (within
    tests/test_torch_train.py's leaf tolerances); 3 steps of
    make_train_step(mesh=) in f64 against one process's f64 steps (every
    state field within 1e-9 of its largest value); one f32 step against
    JAX's make_train_step(mesh=make_mesh(2)) on the global batch (test_
    torch_train.py's setup: 1.0x, 20 classes, 64 px, global batch 4);
    the mosaic augment of 2 ranks bit for bit one process's, and its
    augmenting f64 step within 1e-9; predict through make_predict_fn
    (mesh, process_shard, local_rows) and load_predictor(mesh=) on the
    folded bench_coco416 against JAX's mesh predict (test_torch_model.py's
    detection tolerance); VOCEvaluator(process_shard=) on both ranks
    against JAX's single-process VOCEvaluator (mAP within 1e-6); the
    replicated state, checkpoints and device_prefetch(sharding=).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_voc
from tests.test_torch_train import (FIELDS, LOSS_RTOL, LOSSES,
                                    assert_field_close, jax_state_trees,
                                    schedule_args, tiny_batch)
from tests.torch_ranks import (Kinks, join_ranks, parallel_checks,
                               start_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets", "bench_coco416.npz")
SIZE = 64
N = 2
GLOBAL_BATCH = 4
STEPS = 3
F64_RTOL = 1e-9
BN_F64_ATOL = 1e-12
DET_ATOL = 1e-4     # test_torch_model.py: boxes and scores
MAP_ATOL = 1e-6
AUG_SEED = 11       # its mosaic coins: both branches on both ranks
EVAL_IMAGES = 10    # batches of 4, 4 and a ragged 2


# ---------------------------------------------------------------------------
# loaders, in this process: process_shard is host indexing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root, _ = make_synthetic_voc(tmp_path_factory.mktemp("voc"),
                                 n_images=EVAL_IMAGES)
    return root


def _voc(root, mosaic=False):
    from yolo_nano_tpu.data.voc import VOCDataset as JaxVOC
    from yolo_nano_tpu_torch.data.voc import VOCDataset

    kw = dict(img_size=SIZE, image_sets=[("2007", "trainval")],
              mosaic=mosaic)
    return JaxVOC(root, **kw), VOCDataset(root, **kw)


SHARDS = [(p, n) for n in (2, 4) for p in range(n)]


@pytest.mark.parametrize("shard", SHARDS, ids=lambda s: f"{s[0]}of{s[1]}")
def test_detection_loader_shard_matches_jax(voc_root, shard):
    """Each process's rows of two shuffled epochs (mosaic on), bit for bit
    JAX's; every process's rows of a batch are that batch's rows of one
    process's loader."""
    from yolo_nano_tpu.data.loader import DetectionLoader as JaxLoader
    from yolo_nano_tpu_torch.data.loader import DetectionLoader

    jds, ds = _voc(voc_root, mosaic=True)
    kw = dict(batch_size=4, max_boxes=8, num_workers=2, seed=5)
    p, n = shard
    per = 4 // n
    for epoch in range(2):
        want, got, whole = ([b for b in _at(loader, epoch)] for loader in (
            JaxLoader(jds, process_shard=shard, **kw),
            DetectionLoader(ds, process_shard=shard, **kw),
            DetectionLoader(ds, **kw)))
        assert len(got) == len(want) == len(whole) == EVAL_IMAGES // 4
        for g, w, a in zip(got, want, whole):
            for x, y, z in zip(g, w, a):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert x.shape[0] == per
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z[p * per:(p + 1) * per])


def _at(loader, epoch):
    loader.set_epoch(epoch)
    return [tuple(a.copy() for a in b) for b in loader]


@pytest.mark.parametrize("shard", SHARDS, ids=lambda s: f"{s[0]}of{s[1]}")
def test_eval_loader_shard_matches_jax(voc_root, shard):
    """Each process's decoded rows and the whole batch's metas, bit for bit
    JAX's, the final ragged batch padded by its last index; the metas equal
    one process's EvalLoader's."""
    from yolo_nano_tpu.data.loader import EvalLoader as JaxEvalLoader
    from yolo_nano_tpu.data.voc import VOCDataset as JaxVOC
    from yolo_nano_tpu_torch.data.loader import EvalLoader
    from yolo_nano_tpu_torch.data.voc import VOCDataset

    kw = dict(img_size=SIZE, image_sets=[("2007", "test")], augment=False,
              keep_difficult=True)
    jds, ds = JaxVOC(voc_root, **kw), VOCDataset(voc_root, **kw)
    want = list(JaxEvalLoader(jds, SIZE, 4, 2, process_shard=shard))
    got = list(EvalLoader(ds, SIZE, 4, 2, process_shard=shard))
    whole = list(EvalLoader(ds, SIZE, 4, 2))
    p, n = shard
    per = 4 // n
    assert len(got) == len(want) == len(whole) == 3
    for (gi, gm), (wi, wm), (ai, am) in zip(got, want, whole):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape == (per, SIZE,
                                                                 SIZE, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gi, ai[p * per:(p + 1) * per])
        assert len(gm) == len(wm) == len(am)
        for g, w, a in zip(gm, wm, am):
            assert g.keys() == w.keys() == a.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                np.testing.assert_array_equal(g[k], a[k], err_msg=k)


# ---------------------------------------------------------------------------
# 2 ranks
# ---------------------------------------------------------------------------

def _jax_init():
    """JAX's config, optimizer and train state from the port's seeded
    tree (the same layout as JAX's init, drawn in a fraction of a second
    instead of JAX's op-by-op init)."""
    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.train.schedule import warmup_step_schedule as jsched
    from yolo_nano_tpu.train.state import create_train_state
    from yolo_nano_tpu.train.state import make_optimizer as jopt

    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    jcfg = JaxConfig(num_classes=20)
    jtx = jopt(jsched(**schedule_args()))
    params, stats = jax.tree.map(jnp.asarray, init_yolo_nano_tree(
        torch.Generator().manual_seed(0), YoloNanoConfig(num_classes=20)))
    return jcfg, jtx, create_train_state(params, stats, jtx, use_ema=True)


def _aug_batch(b=GLOBAL_BATCH, s0=SIZE, m=6, seed=0):
    """uint8 canvases, boxes (the last two slots padding), regions with
    the crop disallowed on row 2."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, s0, s0, 3)).astype(np.uint8)
    shapes = np.array([[0, 0.1, 1, 0.9, 1], [0.2, 0, 0.8, 1, 1],
                       [0, 0, 1, 1, 0], [0, 0.25, 1, 0.75, 1]], np.float32)
    x1 = rng.uniform(0, 0.5, (b, m))
    y1 = rng.uniform(0, 0.5, (b, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.1, 0.5, (b, m)),
                      y1 + rng.uniform(0.1, 0.5, (b, m))], -1)
    labels = rng.integers(0, 20, (b, m)).astype(np.int32)
    labels[:, -2:] = -1
    return (img, np.clip(boxes, 0, 1).astype(np.float32), labels,
            shapes[np.arange(b) % 4])


def _eval_tree():
    """A seeded 0.5x VOC tree whose objectness biases are raised, so that
    it detects (at random) on every image."""
    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano_tree

    params, stats = init_yolo_nano_tree(torch.Generator().manual_seed(0),
                                        build_config("voc", backbone="0.5x"))
    for i in range(3):
        params[f"head{i}"]["out"]["b"][:3] = 2.0
    return params, stats


def _self_labelled_voc(root, params, stats):
    """The synthetic VOC set with each image's ground truth replaced by the
    2 highest-scoring detections of the eval tree at SIZE (one process,
    the port's val_transform and letterbox undo): the evaluators then
    score well above 0, and a detection given to another image's row
    would move the AP."""
    import cv2

    from yolo_nano_tpu_torch.cli.common import build_config, make_predict_fn
    from yolo_nano_tpu_torch.data.transforms import val_transform
    from yolo_nano_tpu_torch.data.voc import VOC_CLASSES

    root, _ = make_synthetic_voc(root, n_images=EVAL_IMAGES)
    fn = make_predict_fn(params, stats, build_config("voc", backbone="0.5x"),
                         SIZE, dtype="float32", device="cpu")
    voc = os.path.join(root, "VOC2007")
    for i in range(EVAL_IMAGES):
        name = f"im{i:04d}"
        img = cv2.imread(os.path.join(voc, "JPEGImages", f"{name}.jpg"))
        h, w = img.shape[:2]
        x, scale, offset = val_transform(img, SIZE)
        boxes, scores, classes, valid = fn(x[None])
        top = np.argsort(-np.where(valid[0], scores[0], -1))[:2]
        objs = ""
        for k in top:
            b = (boxes[0, k] - offset) / scale * np.array([w, h, w, h])
            x1, y1, x2, y2 = np.clip(np.round(b), 0, [w, h, w, h]).astype(int)
            objs += (f"<object><name>{VOC_CLASSES[classes[0, k]]}</name>"
                     f"<difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
                     f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax>"
                     "</bndbox></object>")
        with open(os.path.join(voc, "Annotations", f"{name}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}"
                    f"</height></size>{objs}</annotation>")
    return root


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The ranks' results and this process's references. The ranks start
    first and run while the references (JAX's compiles among them) are
    computed here, on one intra-op thread as each rank runs: beside the
    suite's other workers, OpenMP's threads spinning at each op's barrier
    slowed these small steps by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _session(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _session(tmp_path_factory):
    from bench import render_inputs
    from yolo_nano_tpu_torch.convert import train_state_from_jax

    work = tmp_path_factory.mktemp("ranks")
    jcfg, jtx, jstate = _jax_init()
    images, boxes, labels = tiny_batch(b=GLOBAL_BATCH)
    state0 = train_state_from_jax(**jax_state_trees(jstate), device="cpu")
    rng = np.random.default_rng(4)
    shape = (GLOBAL_BATCH, 8, 5, 5)
    bn = {k: torch.from_numpy(v) for k, v in dict(
        y=rng.normal(1.0, 3.0, shape), up=rng.normal(size=shape),
        scale=rng.uniform(0.5, 1.5, 8), bias=rng.normal(size=8),
        mean=rng.normal(size=8), var=rng.uniform(0.5, 1.5, 8)).items()}
    eval_params, eval_stats = _eval_tree()
    eval_root = _self_labelled_voc(tmp_path_factory.mktemp("eval_voc"),
                                   eval_params, eval_stats)
    inputs = dict(
        bn=bn,
        train=dict(state0=state0.flat(), images=images, boxes=boxes,
                   labels=labels, schedule=schedule_args(), size=SIZE,
                   steps=STEPS),
        aug=dict(batch=_aug_batch(), seed=AUG_SEED),
        predict=dict(npz=NPZ, images=render_inputs(GLOBAL_BATCH, 416,
                                                   seed=5)),
        eval=dict(root=eval_root, size=SIZE, batch=4, backbone="0.5x",
                  params=eval_params, stats=eval_stats))
    path = os.path.join(str(work), "inputs.pt")
    torch.save(inputs, path)
    handle = start_ranks(parallel_checks, N, work, path, str(work))
    try:
        refs = _references(inputs, jcfg, jtx, jstate, state0)
    finally:
        ranks = join_ranks(handle)
    refs["witness"] = _witnesses(inputs, state0, dict(
        port=[torch.cat(m) for m in zip(*(r["f32_kinks"] for r in ranks))],
        jax=refs.pop("jax_kinks")))
    return dict(inputs=inputs, refs=refs, ranks=ranks)


def _references(inputs, jcfg, jtx, jstate, state0):
    from yolo_nano_tpu.evaluation.evaluator import VOCEvaluator as JaxEval
    from yolo_nano_tpu.ops import nn as jnn
    from yolo_nano_tpu.ops.nn import _batch_norm
    from yolo_nano_tpu.parallel.mesh import make_mesh as jax_mesh
    from yolo_nano_tpu.serving import load_predictor as jax_load_predictor
    from yolo_nano_tpu.train.train_step import make_train_step as jstep

    from yolo_nano_tpu_torch.cli.common import build_config, make_predict_fn
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.data.device_aug import make_augment_fn
    from yolo_nano_tpu_torch.ops.nn import batch_norm_train
    from yolo_nano_tpu_torch.train import (make_optimizer, make_train_step,
                                           warmup_step_schedule)

    refs = {}
    # BN: one process, the whole batch, in f64; JAX in f32 (NHWC)
    bn = inputs["bn"]
    y = bn["y"].clone().requires_grad_(True)
    out, mean, var = batch_norm_train(y, bn["scale"], bn["bias"], bn["mean"],
                                      bn["var"])
    (out * bn["up"]).sum().backward()
    refs["bn64"] = dict(out=out.detach(), mean=mean, var=var, grad=y.grad)
    f32 = {k: np.asarray(v, np.float32) for k, v in bn.items()}
    p = dict(scale=f32["scale"], bias=f32["bias"])
    stats = dict(mean=f32["mean"], var=f32["var"])
    x = f32["y"].transpose(0, 2, 3, 1)
    up = f32["up"].transpose(0, 2, 3, 1)
    jy, jstats = _batch_norm(x, p, stats, True)
    jgrad = jax.grad(lambda v: jnp.sum(_batch_norm(v, p, stats, True)[0]
                                       * up))(x)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    refs["bn_jax"] = dict(out=nchw(jy), mean=np.asarray(jstats["mean"]),
                          var=np.asarray(jstats["var"]), grad=nchw(jgrad))

    # steps: one process in f64; JAX's mesh step in f32
    t = inputs["train"]
    cfg = YoloNanoConfig(num_classes=20)
    tx = make_optimizer(warmup_step_schedule(**t["schedule"]))
    step = make_train_step(cfg, tx, SIZE, device="cpu")
    batch = [torch.from_numpy(a) for a in (t["images"], t["boxes"],
                                           t["labels"])]
    s, metrics = state0.to("cpu", torch.float64), []
    for _ in range(STEPS):
        s, m = step(s, batch[0].double(), *batch[1:])
        metrics.append({k: float(v) for k, v in m.items()})
    refs["f64"] = (s.flat(), metrics)
    seen = {}

    def record(x, act):  # JAX's pre-activations, in the forward's order
        if act is not None:
            i = len(seen)
            seen[i] = None
            jax.debug.callback(
                lambda v, i=i: seen.__setitem__(i, np.asarray(v)), x)
        return jax_activate(x, act)

    jax_activate = jnn._activate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "_activate", record)
        jfn = jstep(jcfg, jtx, SIZE, mesh=jax_mesh(N), donate=False)
        js, jm = jfn(jstate, jnp.asarray(t["images"]),
                     jnp.asarray(t["boxes"]), jnp.asarray(t["labels"]))
        jax.effects_barrier()
    refs["jax_step"] = (jax_state_trees(js),
                        {k: float(v) for k, v in jm.items()})
    refs["jax_kinks"] = [torch.from_numpy(seen[i].copy()).permute(0, 3, 1, 2)
                         >= 0 for i in range(len(seen))]

    # the mosaic augment and its step: one process
    a = inputs["aug"]
    aug_batch = [torch.from_numpy(x) for x in a["batch"]]
    augment = make_augment_fn(SIZE, out_dtype=torch.float64, mosaic=True)
    refs["augmented"] = augment(*aug_batch,
                                torch.Generator().manual_seed(a["seed"]))
    astep = make_train_step(cfg, tx, SIZE, device="cpu", augment=augment)
    s, m = astep(state0.to("cpu", torch.float64), *aug_batch,
                 torch.Generator().manual_seed(a["seed"]))
    refs["aug_step"] = (s.flat(), {k: float(v) for k, v in m.items()})

    # JAX's predict over a 2-device mesh
    refs["jax_predict"] = [np.asarray(v) for v in jax_load_predictor(
        os.path.join(ROOT, "assets", "bench_coco416"), mesh=jax_mesh(N),
        prefer_params=True)(inputs["predict"]["images"])]

    # JAX's single-process evaluator on the port's one-process predict
    e = inputs["eval"]
    fn = make_predict_fn(e["params"], e["stats"],
                         build_config("voc", backbone=e["backbone"]),
                         e["size"], dtype="float32", device="cpu")
    ev = JaxEval(e["root"], e["size"], batch_size=e["batch"], num_workers=1)
    ev.evaluate(fn)
    refs["eval"] = dict(map=ev.map, aps=ev.aps)
    return refs


def _witnesses(inputs, state0, masks):
    """Per side ("port": the 2 ranks' f32 step, "jax": JAX's mesh step),
    the f64 witness: one process's port step in f64 on the global batch
    with that side's kink decisions (Kinks) → (state, metrics, [(|x|, the
    elements whose decision differs from x's sign)] per activation)."""
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.ops import nn as tnn
    from yolo_nano_tpu_torch.train import (make_optimizer, make_train_step,
                                           warmup_step_schedule)

    t = inputs["train"]
    step = make_train_step(YoloNanoConfig(num_classes=20), make_optimizer(
        warmup_step_schedule(**t["schedule"])), SIZE, device="cpu")
    batch = [torch.from_numpy(a) for a in (t["images"], t["boxes"],
                                           t["labels"])]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for side, m in masks.items():
            w = Kinks(tnn.activate, tnn._leaky_slope, m)
            mp.setattr(tnn, "activate", w)
            s, metrics = step(state0.to("cpu", torch.float64),
                              batch[0].double(), *batch[1:])
            mp.undo()
            out[side] = (s, {k: float(v) for k, v in metrics.items()},
                         [(x.abs(), (x >= 0) != k)
                          for x, k in zip(w.seen, m)])
    return out


def _rows(rank):
    per = GLOBAL_BATCH // N
    return slice(rank * per, (rank + 1) * per)


def test_ranks_hold_their_places(session):
    for r, got in enumerate(session["ranks"]):
        assert got["place"] == got["place_2d"] == (r, N)
        assert "needs 3 processes" in got["mesh_refusal"]


def test_sync_batch_norm_f64_matches_one_process(session):
    """Output, new running mean and var, and the input gradient of the
    halves of the batch on 2 ranks against one process on the whole."""
    want = session["refs"]["bn64"]
    for r, got in enumerate(session["ranks"]):
        got = got["bn64"]
        for k in ("out", "grad"):
            np.testing.assert_allclose(got[k], want[k][_rows(r)], rtol=0,
                                       atol=BN_F64_ATOL, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=BN_F64_ATOL, err_msg=k)


def test_sync_batch_norm_group_of_one_is_plain_bn(session):
    """Sync-BN in a group of one process gives the bits of BN without a
    group (the output, running stats and input gradient), so that one
    process with a group trains exactly as one without."""
    for got in session["ranks"]:
        got = got["bn_alone"]
        for k in ("out", "mean", "var", "grad"):
            assert torch.equal(got["group"][k], got["plain"][k]), k


def test_sync_batch_norm_f32_matches_jax(session):
    """The same in f32 against JAX's train-mode BN on the whole batch,
    within test_torch_train.py's leaf tolerances."""
    want = session["refs"]["bn_jax"]
    got = {k: np.concatenate([r["bn32"][k].numpy() for r in
                              session["ranks"]])
           for k in ("out", "grad")}
    for k in ("mean", "var"):
        got[k] = session["ranks"][0]["bn32"][k].numpy()
        np.testing.assert_array_equal(
            session["ranks"][1]["bn32"][k].numpy(), got[k])
    assert_field_close(got, want, "sync-BN")


def test_replicate_tree_gives_every_rank_rank0s_state(session):
    want = session["inputs"]["train"]["state0"]
    for got in session["ranks"]:
        assert got["replicated"].keys() == want.keys()
        for k, v in want.items():
            assert got["replicated"][k].dtype == v.dtype
            assert torch.equal(got["replicated"][k], v), k


def _field(flat, field):
    return {k: v for k, v in flat.items() if k.startswith(field + "/")}


def _states_equal_across_ranks(key):
    def check(session):
        (s0, m0), (s1, m1) = (r[key] for r in session["ranks"])
        assert m0 == m1
        for k, v in s0.items():
            assert torch.equal(v, s1[k]), k
    return check


@pytest.mark.parametrize("field", FIELDS)
def test_train_step_f64_matches_one_process(session, field):
    """3 steps of make_train_step(mesh=) on 2 ranks in f64: each field
    within 1e-9 of its largest value of one process's 3 steps; the ranks'
    states bit-identical; count and step equal."""
    _states_equal_across_ranks("f64")(session)
    got, metrics = session["ranks"][0]["f64"]
    want, want_metrics = session["refs"]["f64"]
    g, w = _field(got, field), _field(want, field)
    assert g.keys() == w.keys()
    top = max(v.abs().max().item() for v in w.values())
    for k, v in w.items():
        err = (g[k] - v).abs().max().item()
        assert err <= F64_RTOL * top, f"{k}: {err:.3g} > {F64_RTOL * top:.3g}"
    for k in ("count", "step"):
        assert int(got[k]) == int(want[k]) == STEPS
    for m, wm in zip(metrics, want_metrics):
        for k in LOSSES:
            np.testing.assert_allclose(m[k], wm[k], rtol=F64_RTOL)
        assert m["skipped_nonfinite"] == 0


@pytest.mark.parametrize("field", FIELDS)
def test_train_step_f32_matches_jax_mesh_step(session, field):
    """One f32 step of make_train_step(mesh=) on 2 ranks against JAX's
    make_train_step(mesh=make_mesh(2)) on the global batch: the losses
    within LOSS_RTOL. Two f32 steps part at the ReLU kinks (an element
    within rounding of 0 falls on another side in each, and BN over the
    small maps of 64 px spreads it over its channel), as in
    test_torch_device_aug.py: so each side's state is held to the f64
    witness with its own kink decisions (the 55 activations of a forward,
    the ranks' rows joined), each leaf within test_torch_train.py's
    tolerance, and every decision apart from the f64 sign lies within
    1e-4·max|x| of 0."""
    from yolo_nano_tpu_torch.convert import (flatten_tree,
                                             train_state_to_jax)
    from yolo_nano_tpu_torch.train.state import TrainState

    _states_equal_across_ranks("f32")(session)
    got, metrics = session["ranks"][0]["f32"]
    jtrees, jmetrics = session["refs"]["jax_step"]
    for k in LOSSES:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    tree = train_state_to_jax(TrainState.from_flat(got))
    for side, state in (("port", tree), ("jax", jtrees)):
        wstate, wmetrics, kinks = session["refs"]["witness"][side]
        assert len(kinks) == 55, side
        for x, apart in kinks:
            assert (x[apart] <= 1e-4 * x.max()).all(), side
        for k in LOSSES:
            np.testing.assert_allclose(
                (metrics if side == "port" else jmetrics)[k], wmetrics[k],
                rtol=LOSS_RTOL, err_msg=f"{side}/{k}")
        assert_field_close(flatten_tree(state[field]), flatten_tree(
            train_state_to_jax(wstate)[field]), f"{side}/{field}")
    assert tree["step"] == int(jtrees["step"]) == 1


def test_mosaic_augment_on_two_ranks_is_one_process_bit_for_bit(session):
    """make_augment_fn(mosaic=True, mesh=): the ranks' rows of the
    augmented images, boxes and labels equal one process's bit for bit
    (the tiles of a mosaic item come from the other rank's rows too); the
    augmenting step in f64 within 1e-9 of one process's, the ranks'
    states bit-identical."""
    from yolo_nano_tpu_torch.data.device_aug import sample_draws

    coins = sample_draws(torch.Generator().manual_seed(AUG_SEED),
                         GLOBAL_BATCH, mosaic=True)["mos_coin"]
    assert all(coins[_rows(r)].any() and not coins[_rows(r)].all()
               for r in range(N))
    want = session["refs"]["augmented"]
    for r, got in enumerate(session["ranks"]):
        for g, w in zip(got["augmented"], want):
            assert g.dtype == w.dtype
            assert torch.equal(g, w[_rows(r)])
    _states_equal_across_ranks("aug_step")(session)
    got, metrics = session["ranks"][0]["aug_step"]
    want_state, want_metrics = session["refs"]["aug_step"]
    for k in LOSSES:
        np.testing.assert_allclose(metrics[k], want_metrics[k],
                                   rtol=F64_RTOL)
    for field in FIELDS:
        g, w = _field(got, field), _field(want_state, field)
        top = max(v.abs().max().item() for v in w.values())
        for k, v in w.items():
            assert (g[k] - v).abs().max().item() <= F64_RTOL * top, k


def _assert_detections_close(got, want, what):
    names = ("boxes", "scores", "classes", "valid")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
    np.testing.assert_array_equal(got[3], want[3], err_msg=what)
    np.testing.assert_array_equal(got[2], want[2], err_msg=what)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DET_ATOL,
                               err_msg=what)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=DET_ATOL,
                               err_msg=what)


def test_make_predict_fn_on_two_ranks_matches_jax_mesh_predict(session):
    """make_predict_fn(mesh, process_shard, local_rows=True) on the folded
    artifact in f32: the same gathered detections on both ranks, equal to
    the closure that takes the whole batch, and to JAX's predict over a
    2-device mesh within test_torch_model.py's tolerance."""
    want = session["refs"]["jax_predict"]
    assert want[3].sum(1).min() > 0
    first = session["ranks"][0]["predict_f32"]
    for got in session["ranks"]:
        for a, b, c in zip(got["predict_f32"], first,
                           got["predict_f32_whole"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    _assert_detections_close(first, want, "make_predict_fn")


def test_make_predict_fn_bf16_gathers_each_ranks_rows(session):
    """At its bf16 default, each rank's rows of the gathered detections
    equal that rank's one-process predict of them bit for bit."""
    first = session["ranks"][0]["predict_bf16"]
    for r, got in enumerate(session["ranks"]):
        for a, b, alone in zip(got["predict_bf16"], first,
                               got["predict_bf16_alone"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a[_rows(r)], alone)


def test_load_predictor_with_a_mesh(session):
    """load_predictor(mesh=) with buckets (2, 4) on a ragged request of 3:
    JAX's mesh predict's rows within tolerance; a bucket that does not
    divide by the mesh size raises."""
    want = [w[:3] for w in session["refs"]["jax_predict"]]
    for got in session["ranks"]:
        _assert_detections_close(got["load_predictor"], want,
                                 "load_predictor")
        assert "not divisible by the 2-process mesh" in got["bucket_refusal"]


def test_voc_evaluator_on_two_ranks_matches_jax(session):
    """VOCEvaluator(process_shard=) with make_predict_fn(local_rows=True)
    on both ranks: the single-process JAX VOCEvaluator's mAP within 1e-6,
    per-class AP too, the same on both ranks."""
    want = session["refs"]["eval"]
    assert max(want["aps"].values()) > 0.1
    for got in session["ranks"]:
        got = got["eval"]
        assert got == session["ranks"][0]["eval"]
        assert abs(got["map"] - want["map"]) <= MAP_ATOL
        assert got["aps"].keys() == want["aps"].keys()
        for c, ap in want["aps"].items():
            assert abs(got["aps"][c] - ap) <= MAP_ATOL, c


def test_batch_placement_on_two_ranks(session):
    """shard_batch of the global batch, global_batch of the rank's rows
    and device_prefetch(sharding=) all give the rank's rows."""
    t = session["inputs"]["train"]
    for r, got in enumerate(session["ranks"]):
        want = [np.asarray(a)[_rows(r)] for a in (t["images"], t["boxes"],
                                                  t["labels"])]
        for placed in (got["shard_batch"], got["local_batch"],
                       *got["prefetched"]):
            assert len(placed) == 3
            for g, w in zip(placed, want):
                np.testing.assert_array_equal(g.numpy(), w)
        assert len(got["prefetched"]) == 2


def test_checkpoint_rank0_writes_every_rank_restores(session):
    want = session["inputs"]["train"]["state0"]
    for got in session["ranks"]:
        assert got["ckpt_steps"] == [7]
        for k, v in want.items():
            assert torch.equal(got["ckpt"][k], v), k
