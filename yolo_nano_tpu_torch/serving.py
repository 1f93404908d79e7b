"""One-call loader: a folded `.npz` artifact → a batched predict function
(the JAX package's `serving.load_predictor`), and batch buckets for ragged
serving traffic over the port's own batch table.

The serialized serving graph is the counterpart of the JAX package's
`predict.stablehlo`: `export_graph` traces forward → scores → postprocess
of a folded model with torch.export (f32 images [b, S, S, 3] with a
symbolic batch b, the thresholds baked in, a bf16 model's cast inside) and
saves it as `<artifact stem>.pt2`, beside the `.npz`. The stages and head
pairs are calls of the kernels' operators (`ops.kernels`), and the
kernel-layout weights are constants of the graph, computed once at export.
`load_predictor` replays that graph when the artifact's meta says that it
was written with it (`"graph": true`), no threshold is overridden and
`prefer_params` is false: it imports the operators and no model code, and
moves the graph to the device, where the operators launch the hand
kernels.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from yolo_nano_tpu_torch.utils.spans import span


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def take_images(images, dev: torch.device, size: Optional[int] = None):
    """A predict function's input → (an f32 tensor on `dev`, whether it
    came as a tensor). Numpy images are copied there; a tensor must be on
    `dev` already and is taken as it is. They must be [B,S,S,3], with S
    `size` where one is given."""
    on_device = isinstance(images, torch.Tensor)
    if not on_device:
        images = np.asarray(images, np.float32)
    shape = tuple(images.shape)
    if (len(shape) != 4 or shape[3] != 3 or shape[1] != shape[2]
            or size not in (None, shape[1])):
        side = "S" if size is None else size
        raise ValueError(f"images must be [B,{side},{side},3], got {shape}")
    if not on_device:
        return torch.from_numpy(images).to(dev), False
    if images.device != dev:
        raise ValueError(f"images are on {images.device}, the model on {dev}")
    return images.float(), True


def hand_back(out, on_device: bool):
    """Detections as the caller gave the images: tensors on the device for
    a tensor, numpy arrays (copied back) for numpy images."""
    return out if on_device else tuple(t.cpu().numpy() for t in out)


def predictor(model, cfg, input_size: int, dev: torch.device,
              dtype: str) -> Callable:
    """predict_fn(images [B,S,S,3] float32) → detections, for a model
    already on `dev` in `dtype`: the images go to the device as f32 and are
    cast there, as the JAX package's `_predict_jit` casts them. Numpy
    images give numpy detections; a tensor already on `dev` is taken as it
    is and gives tensors on `dev`, fetched by nobody until the caller does
    (as the JAX package's predict_fn takes and gives device arrays)."""
    from yolo_nano_tpu_torch.models.yolo_nano import predict

    tdtype = DTYPES[dtype]
    model_dev = next(model.parameters()).device  # "cuda" with its index

    def predict_fn(images):
        with span("ynt.predict"):
            x, on_device = take_images(images, model_dev, input_size)
            return hand_back(predict(model, x.to(tdtype), cfg, input_size),
                             on_device)

    predict_fn.model = model
    predict_fn.cfg = cfg
    predict_fn.input_size = input_size
    predict_fn.device = dev
    predict_fn.dtype = tdtype
    return predict_fn


def shard_predictor(predict_fn: Callable, mesh, process_shard=None,
                    local_rows: bool = False) -> Callable:
    """A predictor of `serving` (tensors on its device in, detections
    there out) spread over the mesh's processes: each process runs its
    rows of the batch, and the fixed-shape [b, max_det] detections of all
    processes are gathered (`all_gather_rows`) into the batch's [B, max_det]
    ones, the same on every process. The closure takes the whole batch and
    keeps this process's rows, or with `local_rows` only those rows. Numpy
    images give numpy detections, a tensor on the device gives tensors
    there. `process_shard`, if given, must be this process's place in the
    mesh."""
    from yolo_nano_tpu_torch.parallel.mesh import batch_sharding, mesh_group
    from yolo_nano_tpu_torch.parallel.multiprocess import all_gather_rows

    shard, group = batch_sharding(mesh), mesh_group(mesh)
    if process_shard is not None and tuple(process_shard) != (
            shard.index, shard.count):
        raise ValueError(f"process_shard {tuple(process_shard)} is not this "
                         f"process's place in the mesh, "
                         f"({shard.index}, {shard.count})")

    def run(rows):
        on_device = isinstance(rows, torch.Tensor)
        if not on_device:
            rows = torch.from_numpy(np.ascontiguousarray(
                rows, np.float32)).to(shard.device)
        out = predict_fn(rows)
        return hand_back(tuple(all_gather_rows(t, group) for t in out),
                         on_device)

    if local_rows:
        sharded = run
    else:
        def sharded(images):
            return run(images[shard.rows(images.shape[0])])

    # not `device`: bucket_batches would copy a whole padded batch to the
    # card before the closure keeps its rows
    sharded.__dict__.update({k: v for k, v in predict_fn.__dict__.items()
                             if k != "device"})
    sharded.mesh = mesh
    return sharded


def graph_path(path: str) -> str:
    """The serialized serving graph beside an artifact: `<stem>.pt2`."""
    return os.path.splitext(path)[0] + ".pt2"


class ServingGraph(torch.nn.Module):
    """What `export_graph` traces: f32 images [B,S,S,3] → the model's dtype
    → `models.yolo_nano.detect` at `cfg`'s thresholds."""

    def __init__(self, model, cfg, input_size: int, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.input_size = input_size
        self.dtype = dtype

    def forward(self, images: torch.Tensor):
        from yolo_nano_tpu_torch.models.yolo_nano import detect

        return detect(self.model, images.to(self.dtype), self.cfg,
                      self.input_size)


def export_graph(model, cfg, img_size: int, dtype: str, path: str):
    """Trace the serving graph of a folded model on the CPU and save it at
    `path` (a `.pt2`); → the ExportedProgram.

    One forward at 64 px first builds each stage's and head's kernel-layout
    weights, so that the graph holds them as constants instead of the ops
    that make them. The example batch is 2: torch.export specializes a
    dimension of size 0 or 1."""
    if {p.device.type for p in model.parameters()} != {"cpu"}:
        raise ValueError("export_graph traces a model on the CPU")
    graph = ServingGraph(model.eval(), cfg, img_size, DTYPES[dtype])
    with torch.no_grad():
        model(torch.zeros((1, 64, 64, 3), dtype=DTYPES[dtype]))
        ep = torch.export.export(
            graph, (torch.zeros((2, img_size, img_size, 3)),),
            dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    torch.export.save(ep, path)
    return ep


# the tensor-metadata check that torch.export puts before each `.to`
ASSERT_METADATA = torch.ops.aten._assert_tensor_metadata.default


def graph_predictor(path: str, cfg, input_size: int, dev: torch.device,
                    dtype: str) -> Callable:
    """predict_fn replaying the serving graph saved at `path` on `dev`,
    with `predictor`'s contract. Only the kernels' operators are imported:
    no model code. Each call first sets full f32 (cuDNN and matmul TF32
    off), as `models.yolo_nano.predict` does, since the flags are process
    state that the graph does not hold.

    The graph runs as the program's own graph module, its weights and
    constants passed in the order of its signature, not as `ep.module()`:
    that module checks and flattens its inputs and fetches each of its
    weights by a chain of attribute lookups on every call, where
    `take_images` has already checked the images. The checks that export
    puts before each dtype cast (`ASSERT_METADATA`, an operator call each)
    are taken out of the graph at load, as torch's own pass that removes
    runtime assertions does."""
    import yolo_nano_tpu_torch.ops.kernels  # noqa: F401 (the operators)
    from torch.export.graph_signature import InputKind
    from torch.export.passes import move_to_device_pass

    from yolo_nano_tpu_torch.ops.nn import set_full_f32

    ep = move_to_device_pass(torch.export.load(path), str(dev))
    for m in ep.graph_module.modules():
        if isinstance(m, torch.fx.GraphModule):
            for node in list(m.graph.nodes):
                if node.target is ASSERT_METADATA:
                    m.graph.erase_node(node)
            m.recompile()  # the pass rewrote the graphs, not their code
    specs = ep.graph_signature.input_specs
    if [s.kind for s in specs].count(InputKind.USER_INPUT) != 1 or (
            specs[-1].kind != InputKind.USER_INPUT):
        raise ValueError(f"{path}: the graph must take the images alone")
    stored = {**ep.state_dict, **ep.constants}
    weights = [stored[s.target] for s in specs[:-1]]
    module = ep.graph_module
    graph_dev = next(iter(ep.state_dict.values())).device  # with its index

    def predict_fn(images):
        with span("ynt.predict"):
            x, on_device = take_images(images, graph_dev, input_size)
            set_full_f32()
            with torch.inference_mode():
                out = module(*weights, x)
            return hand_back(tuple(out), on_device)

    predict_fn.graph = ep
    predict_fn.cfg = cfg
    predict_fn.input_size = input_size
    predict_fn.device = dev
    predict_fn.dtype = DTYPES[dtype]
    return predict_fn


def load_predictor(path: str, device=None,
                   batch_buckets=None,
                   conf_thresh: Optional[float] = None,
                   nms_thresh: Optional[float] = None,
                   diou_nms: Optional[bool] = None,
                   pre_topk: Optional[int] = None,
                   max_det: Optional[int] = None,
                   prefer_params: bool = False, mesh=None) -> Callable:
    """Load a folded artifact → predict_fn(images) → numpy (boxes [B,D,4],
    scores [B,D], classes [B,D] int32, valid [B,D] bool).

    `images`: [B, S, S, 3] float32 RGB, normalized like the JAX package's
    val_transform output; a bf16 artifact (`"dtype": "bfloat16"`) casts them
    to bf16 on the device. The thresholds and diou_nms override the
    artifact's; pre_topk and max_det change the fixed output shapes. The
    weights go to the device once, here.

    batch_buckets (e.g. (1, 8, 32, 128), or "auto" for the ladder of the
    port's batch table through `default_buckets`): serve any batch size
    through a bounded set of batch shapes by zero-padding, each bucket run
    once here (`bucket_batches` with warmup).

    When the artifact's meta says `"graph": true` (cli.export wrote the
    serialized graph `<stem>.pt2` with it), that file is there, no
    threshold is overridden and not `prefer_params`, the graph is replayed
    (`graph_predictor`: no model code is imported); otherwise the model is
    rebuilt from the `.npz` (the parameter path, whose predict_fn also
    carries the `model`). The thresholds, pre_topk and max_det are baked
    into the graph, so an override takes the parameter path.

    With `mesh` (parallel.mesh) batches spread over the process group:
    each process runs its rows on its device and the detections are
    gathered (`shard_predictor`); a mesh takes the parameter
    path (the graph is one device's), and every batch bucket must divide
    by the mesh size."""
    from yolo_nano_tpu_torch.config import config_from_json, read_meta

    if mesh is not None:
        from yolo_nano_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    dev = resolve_device(device)
    overrides = {k: v for k, v in (
        ("conf_thresh", conf_thresh), ("nms_thresh", nms_thresh),
        ("diou_nms", diou_nms), ("nms_pre_topk", pre_topk),
        ("max_detections", max_det)) if v is not None}
    meta = read_meta(path)
    dtype = meta["dtype"]
    if dtype not in DTYPES:
        raise ValueError(f"{path}: dtype {dtype!r}; float32 and bfloat16 "
                         "artifacts are supported")
    cfg = config_from_json(meta, **overrides)
    if batch_buckets == "auto":
        batch_buckets = default_buckets(meta["img_size"], cfg.backbone)
    if batch_buckets and mesh is not None:
        bad = [b for b in batch_buckets if b % mesh.size()]
        if bad:
            raise ValueError(
                f"batch_buckets {bad} not divisible by the {mesh.size()}-"
                "process mesh: sharded batches must split evenly over "
                "axis 0")
    if (meta.get("graph") and os.path.exists(graph_path(path))
            and not overrides and not prefer_params and mesh is None):
        fn = graph_predictor(graph_path(path), cfg, meta["img_size"], dev,
                             dtype)
    else:
        from yolo_nano_tpu_torch.convert import load_model

        model, cfg, meta = load_model(path, **overrides)
        found = {p.dtype for p in model.parameters()}
        if found != {DTYPES[dtype]}:
            raise ValueError(f"{path}: a {dtype} artifact holds {found} "
                             "leaves")
        fn = predictor(model.to(dev), cfg, meta["img_size"], dev, dtype)
        if mesh is not None:
            fn = shard_predictor(fn, mesh)
    if not batch_buckets:
        return fn
    return bucket_batches(fn, batch_buckets,
                          (meta["img_size"], meta["img_size"], 3),
                          warmup=True)

# the serving batch table measured on the card by
# yolo_nano_tpu_torch/tools/autotune_batch.py
_AUTOTUNE_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "assets", "autotune_batch.json")


def optimal_batch(img_size: int, backbone: str = "1.0x",
                  default: int = 128, table_path: Optional[str] = None
                  ) -> int:
    """The throughput-optimal serving batch for (backbone, resolution) from
    the port's batch table (yolo_nano_tpu_torch/assets/autotune_batch.json,
    or `table_path`); a size never swept takes the nearest swept one, a
    backbone never swept or a missing table `default`."""
    path = table_path or _AUTOTUNE_TABLE
    if not os.path.exists(path):
        return default
    with open(path) as f:
        best = json.load(f).get("best", {})
    sizes = sorted({int(k.split("/")[1]) for k in best
                    if k.startswith(f"{backbone}/")})
    if not sizes:
        return default
    nearest = min(sizes, key=lambda s: abs(s - img_size))
    return int(best[f"{backbone}/{nearest}"]["batch"])


def default_buckets(img_size: int, backbone: str = "1.0x",
                    table_path: Optional[str] = None):
    """Batch buckets for ragged traffic: 1, 8 and 32 below the table's
    optimum, which tops the ladder. The small buckets bound the padding of
    light traffic; the top one serves bulk traffic at the best rate."""
    top = optimal_batch(img_size, backbone, table_path=table_path)
    return tuple([b for b in (1, 8, 32) if b < top] + [top])


def _fetch(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def bucket_batches(predict_fn: Callable, buckets, img_shape=None,
                   warmup: bool = False) -> Callable:
    """Serve any batch size through a bounded set of batch shapes: a batch
    is zero-padded up to the smallest bucket that fits, and the padded
    rows are sliced off the outputs (each image's result is its own); a
    batch larger than the top bucket goes in chunks of the top bucket.
    Every chunk is enqueued before any result is fetched: a predictor of
    this module (one with a `device`) gets each chunk as a tensor on its
    device and gives device tensors back, which are copied to the host
    only once all are enqueued.

    warmup=True (needs img_shape, e.g. (416, 416, 3)) runs every bucket
    once now: the kernels are built and cuDNN picks its algorithms for
    each shape at load time, not on the first live request."""
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    biggest = buckets[-1]
    dev = getattr(predict_fn, "device", None)

    def dispatch(chunk):
        """→ (predict output, not fetched; the real batch size)."""
        b = chunk.shape[0]
        bucket = next(k for k in buckets if k >= b)
        if isinstance(chunk, torch.Tensor):
            if bucket != b:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (bucket - b,) + tuple(chunk.shape[1:]))])
        else:
            chunk = np.asarray(chunk, np.float32)
            if bucket != b:
                chunk = np.concatenate([chunk, np.zeros(
                    (bucket - b,) + chunk.shape[1:], chunk.dtype)])
            if dev is not None:
                chunk = torch.from_numpy(chunk).to(dev)
        return predict_fn(chunk), b

    def wrapped(images):
        n = images.shape[0]
        if n == 0:
            raise ValueError("bucket_batches: empty batch (n=0), nothing "
                             "to dispatch")
        pending = [dispatch(images[lo:lo + biggest])
                   for lo in range(0, n, biggest)]
        parts = [[_fetch(t)[:b] for t in out] for out, b in pending]
        if len(parts) == 1:
            return tuple(parts[0])
        return tuple(np.concatenate([p[i] for p in parts], axis=0)
                     for i in range(len(parts[0])))

    wrapped.__dict__.update(getattr(predict_fn, "__dict__", {}))
    wrapped.buckets = buckets
    if warmup:
        if img_shape is None:
            raise ValueError("warmup=True requires img_shape")
        for k in buckets:
            wrapped(np.zeros((k,) + tuple(img_shape), np.float32))
    return wrapped
