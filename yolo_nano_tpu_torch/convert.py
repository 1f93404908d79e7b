"""Weight bridge: a JAX-layout parameter tree → the port's modules.

The tree is the JAX package's nesting, as nested dicts/lists of numpy arrays:
conv units are {'w' HWIO, ('b'), 'scale', 'bias'} with a parallel stats tree
{'mean', 'var'} (unfolded), or {'w', 'b'} (BN-folded). Conv weights go
HWIO → OIHW; a depthwise (3,3,1,C) weight becomes (C,1,3,3) by the same
transpose.

On disk the port reads a plain `.npz`: keys are '/'-joined tree paths
(`backbone/stage2/0/branch1/dw/w`), list positions as integers, plus the
artifact's `config.json` content under the key `config.json`. numpy has no
bfloat16, so a bf16 leaf is stored as its uint16 bit pattern under its path
with the key suffix `.bf16` (`backbone/conv1/w.bf16`); `load_npz` gives it
back as a `torch.bfloat16` tensor, bit for bit. Every other leaf is a numpy
array. bf16 leaves may come to `save_npz` as `torch.bfloat16` tensors or as
numpy arrays of a bfloat16 dtype (as JAX's `np.asarray` gives them).

Training state goes both ways: `named_from_tree` / `tree_from_named` map a
tree of parameters (or of anything shaped like them: the momentum, the EMA)
or of stats to the modules' names and back, and `train_state_from_jax` /
`train_state_to_jax` carry a whole train state. `tree_from_model` gives a
(folded) model's tree in its own dtype, which `cli/export.py` saves.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from yolo_nano_tpu_torch.config import (CONFIG_KEY, NanoDetPlusConfig,
                                        YoloNanoConfig, config_from_json)
from yolo_nano_tpu_torch.models.shufflenetv2 import (ShuffleBlock,
                                                     ShuffleNetV2,
                                                     ShuffleStage)
from yolo_nano_tpu_torch.models.yolo_nano import Head, YoloNano
from yolo_nano_tpu_torch.ops.nn import ConvUnit

BF16_SUFFIX = ".bf16"


def _t(a) -> torch.Tensor:
    """A leaf as a tensor: a torch tensor (a bf16 leaf) keeps its dtype, a
    numpy leaf becomes f32."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    return torch.from_numpy(np.array(a, np.float32))


def conv_unit(p: dict, s: Optional[dict] = None, *, stride: int = 1,
              act: Optional[str] = None) -> ConvUnit:
    """One conv unit from its JAX dict (and BN stats, when unfolded)."""
    w = _t(p["w"])
    # depthwise units are the ones with one input channel per group
    groups = w.shape[3] if w.shape[2] == 1 else 1
    bn = None
    if "scale" in p:
        bn = (_t(p["scale"]), _t(p["bias"]), _t(s["mean"]), _t(s["var"]))
    bias = _t(p["b"]) if "b" in p else None
    # built for inference (eval-mode BN, frozen); init_yolo_nano trains it
    return ConvUnit(w.permute(3, 2, 0, 1).contiguous(), bias, bn,
                    stride=stride, groups=groups,
                    act=act).requires_grad_(False).eval()


def _sub(stats, key):
    return None if stats is None else stats[key]


def build_shufflenetv2(params: dict, stats: Optional[dict] = None,
                       act: str = "relu") -> ShuffleNetV2:
    """The backbone from a JAX tree, `act` ("relu", or "leaky" for
    NanoDet-Plus) in the stem and every pointwise unit."""
    stages = []
    for name in ("stage2", "stage3", "stage4"):
        blocks = []
        for bi, bp in enumerate(params[name]):
            bs = _sub(stats, name)
            bs = None if bs is None else bs[bi]
            stride = 2 if "branch1" in bp else 1
            b2p, b2s = bp["branch2"], _sub(bs, "branch2")
            branch2 = nn.ModuleDict({
                "pw1": conv_unit(b2p["pw1"], _sub(b2s, "pw1"), act=act),
                "dw": conv_unit(b2p["dw"], _sub(b2s, "dw"), stride=stride),
                "pw2": conv_unit(b2p["pw2"], _sub(b2s, "pw2"), act=act),
            })
            branch1 = None
            if "branch1" in bp:
                b1p, b1s = bp["branch1"], _sub(bs, "branch1")
                branch1 = nn.ModuleDict({
                    "dw": conv_unit(b1p["dw"], _sub(b1s, "dw"), stride=2),
                    "pw": conv_unit(b1p["pw"], _sub(b1s, "pw"), act=act),
                })
            blocks.append(ShuffleBlock(branch2, branch1))
        stages.append(ShuffleStage(blocks))
    conv1 = conv_unit(params["conv1"], _sub(stats, "conv1"), stride=2,
                      act=act)
    return ShuffleNetV2(conv1, *stages).eval()


def build_yolo_nano(params: dict, stats: Optional[dict],
                    cfg: YoloNanoConfig) -> YoloNano:
    """The whole detector from a JAX tree; `stats` None for a folded tree."""
    def unit(key, act="leaky", sub=None):
        p = params[key] if sub is None else params[key][sub]
        s = _sub(stats, key)
        s = s if sub is None or s is None else s.get(sub)  # 'out' has no BN
        return conv_unit(p, s, act=act)

    heads = [Head(*(unit(f"head{i}", sub=k) for k in ("dw0", "pw0", "dw1",
                                                       "pw1")),
                  unit(f"head{i}", act=None, sub="out"))
             for i in range(3)]
    return YoloNano(
        cfg, build_shufflenetv2(params["backbone"], _sub(stats, "backbone")),
        [unit(f"lateral{i}") for i in range(3)],
        [unit(f"smooth{i}") for i in range(4)], heads).eval()


# ---------------------------------------------------------------------------
# .npz artifact
# ---------------------------------------------------------------------------

def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists of arrays → {'a/0/b': array}; torch tensors stay
    tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif isinstance(tree, torch.Tensor):
        return {prefix: tree}
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def widen_tree(tree):
    """A tree's leaves as f32 numpy arrays (bf16 leaves widened, which is
    exact); None stays None."""
    if tree is None:
        return None
    return unflatten_tree({k: torch.as_tensor(v).float().numpy()
                           for k, v in flatten_tree(tree).items()})


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten_tree(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def _is_bf16(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.bfloat16
    return a.dtype.name == "bfloat16"


def _bf16_bits(a) -> np.ndarray:
    """A bf16 leaf → its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous().view(torch.int16).numpy()
    return np.ascontiguousarray(a).view(np.uint16)


def save_npz(path: str, tree, meta: dict) -> None:
    """Write a parameter tree and its artifact config as a plain .npz; bf16
    leaves as uint16 bit patterns under `<path>.bf16`."""
    flat = {}
    for key, a in flatten_tree(tree).items():
        if _is_bf16(a):
            flat[key + BF16_SUFFIX] = _bf16_bits(a)
        else:
            flat[key] = a.detach().cpu().numpy() if isinstance(
                a, torch.Tensor) else a
    flat[CONFIG_KEY] = np.array(json.dumps(meta, sort_keys=True))
    np.savez(path, **flat)


def load_npz(path: str) -> Tuple[dict, dict]:
    """→ (parameter tree, config.json content): numpy arrays, and
    `torch.bfloat16` tensors for the bf16 leaves."""
    flat = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k.endswith(BF16_SUFFIX):
                bits = z[k].astype(np.uint16, copy=False).view(np.int16)
                flat[k[:-len(BF16_SUFFIX)]] = torch.from_numpy(
                    bits.copy()).view(torch.bfloat16)
            else:
                flat[k] = z[k]
    meta = json.loads(str(flat.pop(CONFIG_KEY)))
    return unflatten_tree(flat), meta


def build_model(params: dict, stats: Optional[dict], cfg) -> nn.Module:
    """The detector of cfg's family (YOLO-Nano or NanoDet-Plus) from a JAX
    tree; `stats` None for a folded tree."""
    if isinstance(cfg, NanoDetPlusConfig):
        from yolo_nano_tpu_torch.models.nanodet_plus import build_nanodet_plus

        return build_nanodet_plus(params, stats, cfg)
    return build_yolo_nano(params, stats, cfg)


def load_model(path: str, **overrides) -> Tuple[nn.Module, object, dict]:
    """A folded .npz artifact → (its family's model on the CPU, config,
    meta): NanoDet-Plus where the meta's "model" says so, else YOLO-Nano."""
    tree, meta = load_npz(path)
    if not meta.get("folded", False):
        raise ValueError(f"{path} holds an unfolded tree without BN stats")
    cfg = config_from_json(meta, **overrides)
    return build_model(tree, None, cfg), cfg, meta


# ---------------------------------------------------------------------------
# training state, both ways
# ---------------------------------------------------------------------------

# JAX leaf name → ConvUnit attribute
_LEAF_TO_ATTR = {"w": "weight", "b": "bias", "scale": "bn_scale",
                "bias": "bn_bias", "mean": "bn_mean", "var": "bn_var"}
_ATTR_TO_LEAF = {v: k for k, v in _LEAF_TO_ATTR.items()}


def named_from_tree(tree, device=None) -> dict:
    """A JAX-layout params or stats tree → {module name: tensor} (copies),
    conv weights HWIO → OIHW."""
    out = {}
    for key, a in flatten_tree(tree).items():
        *path, leaf = key.split("/")
        a = np.asarray(a, np.float32)
        if leaf == "w":
            a = a.transpose(3, 2, 0, 1)
        out[".".join(path + [_LEAF_TO_ATTR[leaf]])] = torch.tensor(
            np.ascontiguousarray(a), device=device)
    return out


def tree_from_named(named: dict):
    """{module name: tensor} → JAX-layout tree of numpy arrays, conv
    weights OIHW → HWIO."""
    flat = {}
    for name, t in named.items():
        *path, attr = name.split(".")
        a = t.detach().cpu().numpy()
        if attr == "weight":
            a = a.transpose(2, 3, 1, 0)
        flat["/".join(path + [_ATTR_TO_LEAF[attr]])] = a
    return unflatten_tree(flat)


def tree_from_model(model: nn.Module):
    """A model's parameters → JAX-layout tree of CPU tensors in their own
    dtype (conv weights OIHW → HWIO), as `save_npz` takes it; for a folded
    model that is its whole weight tree."""
    flat = {}
    for name, t in model.named_parameters():
        *path, attr = name.split(".")
        t = t.detach().cpu()
        if attr == "weight":
            t = t.permute(2, 3, 1, 0)
        flat["/".join(path + [_ATTR_TO_LEAF[attr]])] = t.contiguous()
    return unflatten_tree(flat)


def train_state_from_jax(params, stats, trace, count, step, ema_params=None,
                         ema_stats=None, device=None):
    """The port's TrainState from the JAX one's trees (numpy leaves): params,
    stats, the optax momentum trace and count, step, EMA."""
    from yolo_nano_tpu_torch.train.state import TrainState

    to = lambda t: None if t is None else named_from_tree(t, device)  # noqa: E731
    scalar = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32,  # noqa: E731
                                    device=device)
    return TrainState(to(params), to(stats), to(trace), scalar(count),
                      scalar(step), to(ema_params), to(ema_stats))


def train_state_to_jax(state) -> dict:
    """The port's TrainState → {'params', 'stats', 'trace', 'ema_params',
    'ema_stats': JAX-layout numpy trees (None where absent), 'count',
    'step': ints}."""
    out = {f: None if getattr(state, f) is None
           else tree_from_named(getattr(state, f))
           for f in ("params", "stats", "trace", "ema_params", "ema_stats")}
    out.update(count=int(state.count), step=int(state.step))
    return out


def model_from_state(state, cfg: YoloNanoConfig, ema: bool = False
                     ) -> YoloNano:
    """An eval-mode model holding a train state's weights (its EMA with
    ema=True), on the state's device."""
    params, stats = ((state.ema_params, state.ema_stats) if ema
                     else (state.params, state.stats))
    model = build_yolo_nano(tree_from_named(params), tree_from_named(stats),
                            cfg)
    return model.to(state.step.device)
