"""Weight bridge: a JAX-layout parameter tree → the port's modules.

The tree is the JAX package's nesting, as nested dicts/lists of numpy arrays:
conv units are {'w' HWIO, ('b'), 'scale', 'bias'} with a parallel stats tree
{'mean', 'var'} (unfolded), or {'w', 'b'} (BN-folded). Conv weights go
HWIO → OIHW; a depthwise (3,3,1,C) weight becomes (C,1,3,3) by the same
transpose.

On disk the port reads a plain `.npz`: keys are '/'-joined tree paths
(`backbone/stage2/0/branch1/dw/w`), list positions as integers, plus the
artifact's `config.json` content under the key `config.json`.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from yolo_nano_tpu_torch.config import YoloNanoConfig, config_from_json
from yolo_nano_tpu_torch.models.shufflenetv2 import (ShuffleBlock,
                                                     ShuffleNetV2,
                                                     ShuffleStage)
from yolo_nano_tpu_torch.models.yolo_nano import Head, YoloNano
from yolo_nano_tpu_torch.ops.nn import ConvUnit

CONFIG_KEY = "config.json"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def conv_unit(p: dict, s: Optional[dict] = None, *, stride: int = 1,
              act: Optional[str] = None) -> ConvUnit:
    """One conv unit from its JAX dict (and BN stats, when unfolded)."""
    w = np.asarray(p["w"])
    # depthwise units are the ones with one input channel per group
    groups = w.shape[3] if w.shape[2] == 1 else 1
    bn = None
    if "scale" in p:
        bn = (_t(p["scale"]), _t(p["bias"]), _t(s["mean"]), _t(s["var"]))
    bias = _t(p["b"]) if "b" in p else None
    return ConvUnit(_t(w.transpose(3, 2, 0, 1)), bias, bn, stride=stride,
                    groups=groups, act=act)


def _sub(stats, key):
    return None if stats is None else stats[key]


def build_shufflenetv2(params: dict, stats: Optional[dict] = None
                       ) -> ShuffleNetV2:
    stages = []
    for name in ("stage2", "stage3", "stage4"):
        blocks = []
        for bi, bp in enumerate(params[name]):
            bs = _sub(stats, name)
            bs = None if bs is None else bs[bi]
            stride = 2 if "branch1" in bp else 1
            b2p, b2s = bp["branch2"], _sub(bs, "branch2")
            branch2 = nn.ModuleDict({
                "pw1": conv_unit(b2p["pw1"], _sub(b2s, "pw1"), act="relu"),
                "dw": conv_unit(b2p["dw"], _sub(b2s, "dw"), stride=stride),
                "pw2": conv_unit(b2p["pw2"], _sub(b2s, "pw2"), act="relu"),
            })
            branch1 = None
            if "branch1" in bp:
                b1p, b1s = bp["branch1"], _sub(bs, "branch1")
                branch1 = nn.ModuleDict({
                    "dw": conv_unit(b1p["dw"], _sub(b1s, "dw"), stride=2),
                    "pw": conv_unit(b1p["pw"], _sub(b1s, "pw"), act="relu"),
                })
            blocks.append(ShuffleBlock(branch2, branch1))
        stages.append(ShuffleStage(blocks))
    conv1 = conv_unit(params["conv1"], _sub(stats, "conv1"), stride=2,
                      act="relu")
    return ShuffleNetV2(conv1, *stages)


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
    """Nested dicts/lists of arrays → {'a/0/b': array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


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


def save_npz(path: str, tree, meta: dict) -> None:
    """Write a parameter tree and its artifact config as a plain .npz."""
    flat = flatten_tree(tree)
    flat[CONFIG_KEY] = np.array(json.dumps(meta, sort_keys=True))
    np.savez(path, **flat)


def load_npz(path: str) -> Tuple[dict, dict]:
    """→ (parameter tree of numpy arrays, config.json content)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(str(flat.pop(CONFIG_KEY)))
    return unflatten_tree(flat), meta


def load_model(path: str, **overrides) -> Tuple[YoloNano, YoloNanoConfig,
                                                 dict]:
    """A folded .npz artifact → (YoloNano on the CPU, config, meta)."""
    tree, meta = load_npz(path)
    if not meta.get("folded", False):
        raise ValueError(f"{path} holds an unfolded tree without BN stats")
    cfg = config_from_json(meta, **overrides)
    return build_yolo_nano(tree, None, cfg), cfg, meta
