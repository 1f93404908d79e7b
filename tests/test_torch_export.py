"""The port's serialized serving graph on the CPU: `cli.export` writes
`<stem>.pt2` beside the `.npz` (torch.export of forward → scores →
postprocess, symbolic batch), and `load_predictor` replays it, as the JAX
package's export writes and replays `predict.stablehlo`
(tests/test_serving.py).

Two artifacts, each exported once: f32, a seeded 0.5x VOC tree through
`cli.export` at 96 px (its objectness biases raised, so that it detects);
bf16, the committed 0.5x COCO artifact at 128 px through `export_graph`.
Tolerances: the graph equals the parameter path bit for bit; against JAX
`predict`, valid and classes equal, boxes and scores within 1e-4, as
tests/test_torch_model.py holds the parameter path.
"""

import dataclasses
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")
SIZES = {"float32": 96, "bfloat16": 128}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_checkpoint(root):
    """A CheckpointManager directory of a seeded 0.5x VOC train state whose
    head output biases are raised 3 above init (a fresh init detects
    nothing at conf 0.001)."""
    from yolo_nano_tpu_torch.cli.common import build_config
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from yolo_nano_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = build_config("voc", backbone="0.5x")
    state = create_train_state(
        init_yolo_nano(torch.Generator().manual_seed(3), cfg, device="cpu"),
        make_optimizer(lambda count: 1e-3))
    for i in range(3):
        state.params[f"head{i}.out.bias"] += 3.0
    ckpt = os.path.join(root, "ckpt")
    CheckpointManager(ckpt).save(1, state)
    return ckpt


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{dtype: .npz path}, each with its graph beside it; and "no_graph":
    the f32 export under --no_stablehlo."""
    from yolo_nano_tpu_torch.cli import export
    from yolo_nano_tpu_torch.convert import load_model, save_npz, load_npz
    from yolo_nano_tpu_torch.serving import export_graph, graph_path

    root = str(tmp_path_factory.mktemp("export"))
    ckpt = _f32_checkpoint(root)
    common = ["--weight", ckpt, "--backbone", "0.5x", "--img_size",
              str(SIZES["float32"]), "--dtype", "float32", "--device", "cpu"]
    out = {"float32": export.main(common + ["--out",
                                            os.path.join(root, "f32")]),
           "no_graph": export.main(common + ["--out",
                                             os.path.join(root, "plain"),
                                             "--no_stablehlo"])}
    tree, meta = load_npz(NPZ_05X)
    path = os.path.join(root, "bf16.npz")
    save_npz(path, tree, dict(meta, img_size=SIZES["bfloat16"], graph=True))
    model, cfg, _ = load_model(path)
    export_graph(model, cfg, SIZES["bfloat16"], "bfloat16", graph_path(path))
    out["bfloat16"] = path
    return out


def _images(size, b, seed=0):
    if size == SIZES["bfloat16"]:  # rendered scenes: the COCO model detects
        import bench

        return bench.render_inputs(b, size, seed=seed)
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
def test_graph_equals_the_parameter_path(artifacts, dtype, batch):
    """The replayed graph's detections equal the parameter path's (the
    model rebuilt from the .npz, `prefer_params`) bit for bit, numpy in and
    numpy out, and a tensor on the device in gives tensors out."""
    from yolo_nano_tpu_torch.serving import load_predictor

    path = artifacts[dtype]
    graph = load_predictor(path, device="cpu")
    params = load_predictor(path, device="cpu", prefer_params=True)
    assert hasattr(graph, "graph") and not hasattr(graph, "model")
    assert hasattr(params, "model") and not hasattr(params, "graph")
    assert graph.dtype == params.dtype == getattr(torch, dtype)
    assert graph.input_size == SIZES[dtype] and graph.cfg == params.cfg
    x = _images(SIZES[dtype], batch)
    got, want = graph(x), params(x)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].sum(1).min() > 0  # every image has detections
    on_device = graph(torch.from_numpy(x))
    for g, w in zip(on_device, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_f32_graph_matches_jax_predict(artifacts):
    """The f32 graph on the folded tree against JAX `predict` on the same
    tree (empty stats), at test_torch_model.py's tolerance."""
    import jax

    from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
    from yolo_nano_tpu.models.yolo_nano import predict as jax_predict
    from yolo_nano_tpu.utils.fuse_bn import empty_stats_like

    from yolo_nano_tpu_torch.convert import load_npz
    from yolo_nano_tpu_torch.serving import load_predictor

    path = artifacts["float32"]
    fn = load_predictor(path, device="cpu")
    tree, _ = load_npz(path)
    tree = jax.tree.map(np.asarray, tree)
    jcfg = JaxConfig(**{f.name: getattr(fn.cfg, f.name)
                        for f in dataclasses.fields(fn.cfg)})
    x = _images(SIZES["float32"], 3, seed=1)
    want = [np.asarray(w) for w in jax_predict(
        tree, empty_stats_like(tree), x, jcfg, SIZES["float32"])]
    got = fn(x)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert got[3].sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_holds_the_kernel_operators(artifacts, dtype):
    """16 block and 6 dw→pw operator calls; convolutions only for the
    stem, the neck and the head outputs (11); every weight the operators
    take is a parameter or a constant of the graph, computed once at
    export, not an op on the weights run at every replay; one while_loop
    (NMS); a symbolic batch."""
    from yolo_nano_tpu_torch.serving import graph_path

    ep = torch.export.load(graph_path(artifacts[dtype]))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    targets = Counter(str(n.target) for n in calls)
    assert targets["yolo_nano_torch.shuffle_block.default"] == 16
    assert targets["yolo_nano_torch.dw_pw.default"] == 6
    convs = {k: v for k, v in targets.items() if "conv" in k}
    assert convs == {"aten.conv2d.default": 11}, convs
    assert targets["while_loop"] == 1
    kinds = {s.arg.name: s.kind.name for s in ep.graph_signature.input_specs}
    stored = set(ep.state_dict) | set(ep.constants)
    for n in calls:
        if str(n.target).startswith("yolo_nano_torch."):
            for w in n.args[1:]:
                if isinstance(w, torch.fx.Node):
                    assert kinds.get(w.name) in ("PARAMETER",
                                                 "CONSTANT_TENSOR"), w.name
    for spec in ep.graph_signature.input_specs:
        if spec.kind.name in ("PARAMETER", "CONSTANT_TENSOR"):
            assert spec.target in stored, spec.target
    (images,) = [n for n in ep.graph.nodes if n.op == "placeholder"
                 and kinds[n.name] == "USER_INPUT"]
    shape = images.meta["val"].shape
    assert isinstance(shape[0], torch.SymInt) and shape[1:] == (
        SIZES[dtype], SIZES[dtype], 3)
    assert images.meta["val"].dtype == torch.float32


def test_no_stablehlo_writes_no_graph(artifacts):
    from yolo_nano_tpu_torch.config import read_meta
    from yolo_nano_tpu_torch.serving import graph_path, load_predictor

    path = artifacts["no_graph"]
    assert not os.path.exists(graph_path(path))
    assert read_meta(path)["graph"] is False
    assert read_meta(artifacts["float32"])["graph"] is True
    fn = load_predictor(path, device="cpu")
    assert hasattr(fn, "model")
    out = fn(_images(SIZES["float32"], 1))
    assert out[3].sum() > 0


def test_overrides_and_prefer_params_take_the_parameter_path(artifacts):
    """As the JAX loader: the graph bakes the thresholds and shapes, so an
    override rebuilds the model, and takes effect."""
    from yolo_nano_tpu_torch.serving import load_predictor

    path = artifacts["float32"]
    x = _images(SIZES["float32"], 2)
    baked = load_predictor(path, device="cpu")
    assert hasattr(baked, "graph")
    out = baked(x)
    assert out[0].shape == (2, 128, 4) and out[3].sum() > 4
    small = load_predictor(path, device="cpu", max_det=4)
    assert hasattr(small, "model")
    got = small(x)
    assert got[0].shape == (2, 4, 4)
    np.testing.assert_array_equal(got[1], out[1][:, :4])
    strict = load_predictor(path, device="cpu", conf_thresh=0.999)
    assert hasattr(strict, "model")
    assert strict(x)[3].sum() < out[3].sum()
    assert hasattr(load_predictor(path, device="cpu", prefer_params=True),
                   "model")


def test_graph_with_auto_buckets(artifacts, monkeypatch):
    """batch_buckets="auto" on an artifact with a graph: the ladder of the
    artifact's size and backbone, served by the graph, each image's
    detections equal to an unbucketed call of the graph, bit for bit."""
    from yolo_nano_tpu_torch import serving

    asked = []

    def ladder(size, backbone):
        asked.append((size, backbone))
        return (1, 2)

    monkeypatch.setattr(serving, "default_buckets", ladder)
    path = artifacts["float32"]
    fn = serving.load_predictor(path, device="cpu", batch_buckets="auto")
    assert asked == [(SIZES["float32"], "0.5x")] and fn.buckets == (1, 2)
    assert hasattr(fn, "graph")
    plain = serving.load_predictor(path, device="cpu")
    x = _images(SIZES["float32"], 3, seed=2)
    for g, w in zip(fn(x), plain(x)):  # 3 = a bucket of 2 and one of 1
        np.testing.assert_array_equal(g, w)


def test_graph_not_written_with_the_npz_is_not_replayed(artifacts,
                                                        tmp_path):
    """A `.npz` written without `"graph": true` (by save_npz, not by the
    export that wrote the graph) takes the parameter path, even with a
    `.pt2` beside it: that graph may hold other weights."""
    import shutil

    from yolo_nano_tpu_torch.convert import load_npz, save_npz
    from yolo_nano_tpu_torch.serving import graph_path, load_predictor

    tree, meta = load_npz(artifacts["float32"])
    path = str(tmp_path / "rewritten.npz")
    save_npz(path, tree, {k: v for k, v in meta.items() if k != "graph"})
    shutil.copy(graph_path(artifacts["float32"]), graph_path(path))
    assert hasattr(load_predictor(path, device="cpu"), "model")


def test_graph_moved_to_a_device_runs_code_for_it(artifacts):
    """The graph replayed on another device than the CPU it was traced on
    runs code that names that device: `move_to_device_pass` rewrites the
    nodes' devices, and the graph modules' code is made anew from them
    (the program's graph module is called directly), without the
    tensor-metadata checks that the saved graph holds."""
    from yolo_nano_tpu_torch.serving import load_predictor

    from yolo_nano_tpu_torch.serving import ASSERT_METADATA, graph_path

    saved = torch.export.load(graph_path(artifacts["float32"]))
    assert any(n.target is ASSERT_METADATA for n in saved.graph.nodes)
    fn = load_predictor(artifacts["float32"], device="meta")
    modules = [m for m in fn.graph.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule)]
    assert len(modules) == 3  # the program and the loop's cond and body
    assert "'meta'" in modules[0].code
    for m in modules:
        assert "'cpu'" not in m.code, m.code
        # the metadata checks, taken out at load, are out of the code too
        assert not any(n.target is ASSERT_METADATA for n in m.graph.nodes)
        assert "_assert_tensor_metadata" not in m.code


def test_graph_load_imports_no_model_code(artifacts):
    """load_predictor's graph path imports the kernels' operators and no
    model code (a fresh process)."""
    code = (
        "import sys, numpy as np\n"
        "from yolo_nano_tpu_torch.serving import load_predictor\n"
        f"fn = load_predictor({artifacts['float32']!r}, device='cpu')\n"
        f"out = fn(np.zeros((2, {SIZES['float32']}, {SIZES['float32']}, 3),"
        " np.float32))\n"
        "assert out[0].shape == (2, 128, 4), out[0].shape\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'yolo_nano_tpu_torch.models', 'yolo_nano_tpu_torch.convert'))]\n"
        "assert not bad, bad\n"
        "assert 'yolo_nano_tpu_torch.ops.kernels' in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), (
        res.stdout + res.stderr)


def test_graph_path_sets_full_f32(artifacts):
    """The f32 precision flags are process state that the graph does not
    hold: each replay sets them as `predict` does (cuDNN and matmul TF32
    off), whatever the caller left them at."""
    from yolo_nano_tpu_torch.ops.nn import precision_flags
    from yolo_nano_tpu_torch.serving import load_predictor

    fn = load_predictor(artifacts["float32"], device="cpu")
    saved = precision_flags()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        fn(_images(SIZES["float32"], 1))
        assert precision_flags() == (False, False, "highest")
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[2])


def _call_targets(ep) -> Counter:
    """The targets of the call nodes of the graph and its subgraphs (the
    NMS loop's condition and body)."""
    return Counter(str(n.target) for m in ep.graph_module.modules()
                   if isinstance(m, torch.fx.GraphModule)
                   for n in m.graph.nodes if n.op == "call_function")


def test_export_under_a_profiler_adds_no_span(artifacts, tmp_path):
    """The program's spans (`utils/spans.py`) leave the serving graph as it
    is: exported while a profiler runs, it holds no profiler or
    record_function node and the same call targets as without one."""
    from torch.profiler import ProfilerActivity, profile

    from yolo_nano_tpu_torch.convert import load_model
    from yolo_nano_tpu_torch.serving import export_graph

    size = SIZES["bfloat16"]
    model, cfg, _ = load_model(artifacts["bfloat16"])
    plain = export_graph(model, cfg, size, "bfloat16",
                         str(tmp_path / "plain.pt2"))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = export_graph(model, cfg, size, "bfloat16",
                              str(tmp_path / "traced.pt2"))
    got = _call_targets(traced)
    assert not [t for t in got if "profiler" in t or "record_function" in t]
    assert got == _call_targets(plain)
    assert got["while_loop"] == 1
