"""Device mesh and batch placement over a `torch.distributed` process
group: the port's counterpart of the JAX package's `parallel/mesh.py`.

Data parallelism with one process per device:

  * a batch is split by rank: mesh position r of n holds rows
    [r·B/n, (r+1)·B/n) of every global batch (`batch_sharding`);
  * the state is replicated (`replicated`: a broadcast from rank 0);
  * the training step does its own collectives (sync-BN's sums and one
    gradient all-reduce, `train.train_step`), and predict gathers the
    ranks' fixed-shape detections (`serving.shard_predictor`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the whole
default process group: 1-D ("data",), or 2-D ("dcn", "data") for a
deployment across hosts. The batch splits over all mesh axes jointly, so
mesh position and rank agree, and the collectives run on the default
group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "parallel.multiprocess.initialize first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = _device_type()
    need, world = math.prod(shape), dist.get_world_size()
    if need != world:
        raise ValueError(f"a mesh of {shape} needs {need} processes, the "
                         f"group has {world}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """1-D data-parallel mesh over every process of the group (one device
    each); `n_devices`, if given, must be the group's size."""
    _device_type()  # raises without a group
    n = dist.get_world_size() if n_devices is None else n_devices
    return _mesh((n,), (axis,))


def make_mesh_2d(n_dcn: int, n_data: int, axes=("dcn", "data")):
    """2-D mesh for a deployment across hosts: the leading ("dcn") axis
    across hosts, the trailing ("data") axis across the devices of one
    host, rank = dcn·n_data + data. The batch splits over both axes."""
    return _mesh((n_dcn, n_data), tuple(axes))


def mesh_group(mesh):
    """The process group the mesh's collectives run on: the default group,
    which the mesh spans."""
    return dist.group.WORLD


def mesh_device(mesh) -> torch.device:
    """This process's device in the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This process's share of every global batch: position `index` of
    `count` along the batch axis, on `device`."""

    index: int
    count: int
    device: torch.device

    def rows(self, batch: int) -> slice:
        """The rows [index·B/count, (index+1)·B/count) of a batch of B."""
        if batch % self.count:
            raise ValueError(f"batch {batch} must divide over the mesh's "
                             f"{self.count} processes (pad upstream: fixed "
                             "shapes are the contract)")
        per = batch // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh, axis=None) -> BatchSharding:
    """Batch (axis 0) split over the given mesh axis or axes; by default
    over ALL mesh axes jointly, right for 1-D ("data",) and 2-D
    ("dcn", "data") meshes alike."""
    names = mesh.mesh_dim_names
    axes = names if axis is None else (
        (axis,) if isinstance(axis, str) else tuple(axis))
    coord = dict(zip(names, mesh.get_coordinate()))
    size = dict(zip(names, mesh.shape))
    index = 0
    for a in axes:
        index = index * size[a] + coord[a]
    return BatchSharding(index, math.prod(size[a] for a in axes),
                         mesh_device(mesh))


def replicated(mesh):
    """The replicated placement: tree → the tree as rank 0 holds it, on
    this rank's device (parallel.multiprocess.replicate_tree)."""
    from yolo_nano_tpu_torch.parallel.multiprocess import replicate_tree

    return lambda tree: replicate_tree(mesh, tree)


def shard_batch(mesh, *arrays, axis=None):
    """Host arrays of the whole global batch → this process's rows of
    each, as tensors on its device. The batch must divide by the mesh
    size."""
    sh = batch_sharding(mesh, axis)
    out = tuple(torch.as_tensor(
        a[sh.rows(len(a))] if isinstance(a, torch.Tensor)
        else np.ascontiguousarray(np.asarray(a)[sh.rows(len(a))])
    ).to(sh.device) for a in arrays)
    return out[0] if len(out) == 1 else out
