"""Multi-process execution: one process per device, joined by an explicit
`torch.distributed` process group (the port's counterpart of the JAX
package's `parallel/multiprocess.py`).

  * `initialize()` starts the group: NCCL on CUDA, gloo on the CPU, with a
    timeout, so that a dead peer fails the run instead of hanging it;
  * `global_batch()` places this process's rows of a global batch on its
    device: in the port the global batch is the set of the ranks' shards;
  * `replicate_tree()` broadcasts a state from rank 0 as one flat buffer,
    so that every rank holds it bit for bit;
  * `all_gather_rows()` joins the ranks' rows of a tensor in rank order;
  * `shutdown_tolerant()` ends the group and never fails a finished run.

The JAX package's `compile_barrier` works around its runtime's compile
skew between controllers and has no counterpart here.
"""

from __future__ import annotations

import datetime
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this for a peer fails the run
DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_ids: Optional[list] = None,
               device=None, timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> torch.device:
    """Join the process group; → this process's device.

    `coordinator_address` is process 0's "host:port" (a TCP store), or an
    init method URL such as "file:///path/store". `device`: CUDA unless it
    names another device type; on CUDA the process takes
    `local_device_ids[0]`, else `process_id % torch.cuda.device_count()`,
    and the group is NCCL; on the CPU it is gloo. A failure to join
    raises: nothing falls back to one process."""
    dev_type = torch.device(device).type if device is not None else "cuda"
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a "
                               "gloo group on the CPU")
        index = (local_device_ids[0] if local_device_ids
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        dev, backend = torch.device("cuda", index), "nccl"
    elif dev_type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group backend for {dev_type!r}")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    kwargs = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    return dev


def shutdown_tolerant() -> None:
    """Destroy the process group, if there is one, without failing a run
    whose work is saved: a teardown failure goes to stderr (not print,
    which ranks other than 0 do not show). After it the process may join
    a new group."""
    if not dist.is_initialized():
        return
    try:
        dist.destroy_process_group()
    except Exception as e:  # a peer already gone at teardown
        sys.stderr.write(f"[multiprocess] tolerating teardown failure "
                         f"after a completed run: {e}\n")


def global_batch(mesh, *local, axis=None):
    """This process's rows of a global batch (numpy arrays or tensors) →
    tensors on its device; the global batch is the set of every rank's
    rows. Counterpart of parallel.mesh.shard_batch, which takes the whole
    host batch."""
    from yolo_nano_tpu_torch.parallel.mesh import batch_sharding

    dev = batch_sharding(mesh, axis).device
    out = tuple(torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a).to(dev) for a in local)
    return out[0] if len(out) == 1 else out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def replicate_tree(mesh, tree):
    """A tree of tensors (a dict, list or tuple of them, or a TrainState)
    → the same tree as rank 0 holds it, on this rank's device, on every
    rank: one broadcast of all its bytes in one flat buffer."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from yolo_nano_tpu_torch.parallel.mesh import mesh_device, mesh_group

    if hasattr(tree, "flat") and hasattr(type(tree), "from_flat"):
        return type(tree).from_flat(replicate_tree(mesh, tree.flat()))
    leaves, spec = tree_flatten(tree)
    dev = mesh_device(mesh)
    leaves = [t.to(dev) for t in leaves]
    buf = torch.cat([_bytes(t) for t in leaves])
    group = mesh_group(mesh)
    dist.broadcast(buf, dist.get_global_rank(group, 0), group=group)
    out, at = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        # a copy each: views of one buffer as several dtypes would not save
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape).clone())
        at += n
    return tree_unflatten(out, spec)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[b, ...] on every rank → [n·b, ...], the ranks' rows in rank order,
    the same on every rank. A bool tensor travels as uint8."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(torch.bool) if x.dtype == torch.bool else out
