"""The port's weight files: the folded COCO artifacts as plain .npz.

`export_npz` writes `yolo_nano_tpu_torch/assets/bench_coco416.npz` (1.0x,
f32) and `bench_coco416_05x.npz` (0.5x, bf16 leaves stored as uint16 bit
patterns) from the orbax artifacts `assets/bench_coco416` and
`assets/bench_coco416_05x` (the card's machine has no JAX or orbax, so the
port reads numpy only). Rewrite both with
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
ARTIFACT_05X = os.path.join(ROOT, "assets", "bench_coco416_05x")
NPZ_05X = os.path.join(ROOT, "yolo_nano_tpu_torch", "assets",
                       "bench_coco416_05x.npz")


def load_jax_tree(artifact_dir):
    """(folded parameter tree of numpy arrays, config.json content); a bf16
    artifact loads on the `cast_f32_to_bf16` template, as JAX
    `serving.load_predictor` loads it, and keeps its bf16 leaves."""
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu.serving import load_artifact_config
    from yolo_nano_tpu.utils.checkpoint import load_params
    from yolo_nano_tpu.utils.fuse_bn import cast_f32_to_bf16, fold_bn

    cfg, meta = load_artifact_config(artifact_dir)
    if not meta.get("folded") or meta["dtype"] not in ("float32", "bfloat16"):
        raise ValueError(f"{artifact_dir}: need a folded float32 or bfloat16 "
                         "artifact")
    p0, s0 = init_yolo_nano(jax.random.key(0), cfg)
    template = fold_bn(p0, s0)
    if meta["dtype"] == "bfloat16":
        template = cast_f32_to_bf16(template)
    tree = load_params(os.path.join(artifact_dir, "params"), template)
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


@pytest.fixture(scope="module")
def jax_tree_05x():
    return load_jax_tree(ARTIFACT_05X)


def test_committed_05x_npz_equals_fresh_export(tmp_path, jax_tree_05x):
    """The bf16 artifact: every leaf stored as its uint16 bit pattern under
    `<path>.bf16`, equal bit for bit to a fresh export."""
    fresh = tmp_path / "fresh.npz"
    export_npz(ARTIFACT_05X, str(fresh))
    with np.load(NPZ_05X) as want, np.load(fresh) as got:
        assert sorted(want.files) == sorted(got.files)
        assert len(want.files) == 154 + 1
        for k in want.files:
            if k == convert.CONFIG_KEY:
                continue
            assert k.endswith(convert.BF16_SUFFIX), k
            assert want[k].dtype == np.uint16, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree, meta = jax_tree_05x
    with open(os.path.join(ARTIFACT_05X, "config.json")) as f:
        assert convert.load_npz(NPZ_05X)[1] == json.load(f) == meta
    assert meta["dtype"] == "bfloat16"


def test_load_05x_npz_modules_reproduce_jax_tree(jax_tree_05x):
    """load_model builds 640,725 bf16 parameters whose bit patterns are the
    JAX tree's."""
    tree, _ = jax_tree_05x
    model, cfg, _ = convert.load_model(NPZ_05X)
    flat = convert.flatten_tree(tree)
    assert len(flat) == 154
    assert sum(v.size for v in flat.values()) == 640_725
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 640_725
    assert {p.dtype for p in params} == {torch.bfloat16}
    for key, want in flat.items():
        assert want.dtype.name == "bfloat16", key
        path, leaf = key.rsplit("/", 1)
        unit = model.get_submodule(path.replace("/", "."))
        got = (unit.weight.detach().permute(2, 3, 1, 0) if leaf == "w"
               else unit.bias.detach())
        got = got.contiguous().view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, want.view(np.uint16), err_msg=key)
    assert cfg.num_classes == 80 and cfg.backbone == "0.5x"
    assert cfg.neck_channels == 96


def test_npz_bf16_round_trip(tmp_path):
    """bf16 leaves as torch tensors and as numpy bfloat16 arrays go to disk
    and come back as torch.bfloat16, bit for bit; f32 leaves stay numpy."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)).to(
        torch.bfloat16)
    n = rng.normal(size=(5,)).astype(ml_dtypes.bfloat16)
    f = rng.normal(size=(2,)).astype(np.float32)
    path = str(tmp_path / "t.npz")
    convert.save_npz(path, {"a": [{"w": t}, {"w": n}], "b": f}, {"k": 1})
    tree, meta = convert.load_npz(path)
    assert meta == {"k": 1}
    assert tree["a"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(tree["a"][0]["w"].view(torch.int16),
                       t.view(torch.int16))
    assert np.array_equal(tree["a"][1]["w"].view(torch.int16).numpy(),
                          n.view(np.int16))
    assert isinstance(tree["b"], np.ndarray) and tree["b"].dtype == np.float32
    np.testing.assert_array_equal(tree["b"], f)


if __name__ == "__main__":
    for artifact, out in ((ARTIFACT, NPZ), (ARTIFACT_05X, NPZ_05X)):
        export_npz(artifact, out)
        print(f"wrote {out}")
