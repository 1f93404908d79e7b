"""The port stands alone: no module of yolo_nano_tpu_torch, and not
chip_smoke.py, imports jax or anything of the yolo_nano_tpu package."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "yolo_nano_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "orbax", "yolo_nano_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_files_cover_the_eval_slice():
    """The walk reaches the port's own copies of the data readers, the
    evaluators and the eval CLI (numpy/cv2 modules of the JAX package that
    the port may not import)."""
    got = {os.path.relpath(p, PORT) for p in _port_files()}
    for name in ("data/transforms.py", "data/mosaic.py", "data/base.py",
                 "data/voc.py", "data/coco.py", "data/loader.py",
                 "evaluation/voc_eval.py", "evaluation/coco_eval.py",
                 "evaluation/evaluator.py", "cli/common.py", "cli/eval.py"):
        assert name in got, name


def test_forbidden_rule():
    assert _forbidden("yolo_nano_tpu.config")
    assert _forbidden("jax.numpy")
    assert not _forbidden("yolo_nano_tpu_torch.config")
    assert not _forbidden("torch")


def test_port_files_cover_the_training_cli_slice():
    """The walk reaches the training CLI, the export CLI and the backbone
    converter (the port's copy of tools/convert_torch_shufflenetv2.py)."""
    got = {os.path.relpath(p, PORT) for p in _port_files()}
    for name in ("cli/train.py", "cli/export.py",
                 "tools/convert_shufflenetv2.py"):
        assert name in got, name


def test_port_files_cover_the_serving_tools_slice():
    """The walk reaches TTA, the FLOPs report, the serving CLIs, the anchor
    k-means and the batch-table tool."""
    got = {os.path.relpath(p, PORT) for p in _port_files()}
    for name in ("utils/tta.py", "utils/flops.py", "cli/test.py",
                 "cli/demo.py", "cli/benchmark.py", "cli/kmeans_anchor.py",
                 "tools/autotune_batch.py", "serving.py", "ops/nms.py"):
        assert name in got, name


def test_port_files_cover_the_export_graph_slice():
    """The walk reaches the kernels' operator registrations, the traceable
    NMS, the graph's export and replay, the FLOP count and chip_smoke.py."""
    got = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("ops/kernels/__init__.py", "ops/kernels/fused_stage.py",
                 "ops/kernels/fused_conv.py", "ops/kernels/nms_greedy.py",
                 "ops/nms.py", "serving.py",
                 "cli/export.py", "utils/flops.py", "config.py"):
        assert os.path.join("yolo_nano_tpu_torch", name) in got, name
    assert "chip_smoke.py" in got
