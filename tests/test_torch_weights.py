"""The port's weight file: the folded COCO 1.0x artifact as a plain .npz.

`export_npz` writes `yolo_nano_tpu_torch/assets/bench_coco416.npz` from the
orbax artifact `assets/bench_coco416` (the card's machine has no JAX or
orbax, so the port reads numpy only). Rewrite it with
    JAX_PLATFORMS=cpu python -m tests.test_torch_weights
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from yolo_nano_tpu_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "bench_coco416")
NPZ = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets", "bench_coco416.npz")


def load_jax_tree(artifact_dir):
    """(folded parameter tree of numpy arrays, config.json content)."""
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu.serving import load_artifact_config
    from yolo_nano_tpu.utils.checkpoint import load_params
    from yolo_nano_tpu.utils.fuse_bn import fold_bn

    cfg, meta = load_artifact_config(artifact_dir)
    if not meta.get("folded") or meta["dtype"] != "float32":
        raise ValueError(f"{artifact_dir}: need a folded float32 artifact")
    p0, s0 = init_yolo_nano(jax.random.key(0), cfg)
    tree = load_params(os.path.join(artifact_dir, "params"), fold_bn(p0, s0))
    return jax.tree.map(np.asarray, tree), meta


def export_npz(artifact_dir, out_path):
    tree, meta = load_jax_tree(artifact_dir)
    convert.save_npz(out_path, tree, meta)


@pytest.fixture(scope="module")
def jax_tree():
    return load_jax_tree(ARTIFACT)


def test_committed_npz_equals_fresh_export(tmp_path, jax_tree):
    fresh = tmp_path / "fresh.npz"
    export_npz(ARTIFACT, str(fresh))
    with np.load(NPZ) as want, np.load(fresh) as got:
        assert sorted(want.files) == sorted(got.files)
        assert len(want.files) == 154 + 1  # 154 leaves + config.json
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, meta = jax_tree
    with open(os.path.join(ARTIFACT, "config.json")) as f:
        assert convert.load_npz(NPZ)[1] == json.load(f) == meta


def _unit_leaves(model, path):
    """JAX-layout leaves {'w', 'b'} of the port's unit at a tree path."""
    unit = model.get_submodule(path.replace("/", "."))
    out = {"w": unit.weight.detach().permute(2, 3, 1, 0).numpy()}
    if unit.bias is not None:
        out["b"] = unit.bias.detach().numpy()
    return out


def test_load_npz_modules_reproduce_jax_tree(jax_tree):
    tree, _ = jax_tree
    model, cfg, _ = convert.load_model(NPZ)
    flat = convert.flatten_tree(tree)
    assert len(flat) == 154
    assert sum(v.size for v in flat.values()) == 1_315_591
    assert sum(p.numel() for p in model.parameters()) == 1_315_591
    for key, want in flat.items():
        path, leaf = key.rsplit("/", 1)
        got = _unit_leaves(model, path)[leaf]
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert cfg.num_classes == 80 and cfg.backbone == "1.0x"
    assert all(not m.has_bn for m in model.modules()
               if isinstance(m, torch.nn.Module) and hasattr(m, "has_bn"))


def test_tree_flatten_round_trip():
    tree = {"a": [{"w": np.ones(2)}, {"w": np.zeros(3)}], "b": np.arange(4)}
    back = convert.unflatten_tree(convert.flatten_tree(tree))
    assert isinstance(back["a"], list) and len(back["a"]) == 2
    np.testing.assert_array_equal(back["a"][1]["w"], np.zeros(3))
    np.testing.assert_array_equal(back["b"], np.arange(4))


if __name__ == "__main__":
    export_npz(ARTIFACT, NPZ)
    print(f"wrote {NPZ}")
