"""Named spans of the port's host steps, on the profiler's clock.

`span(name)` is a `torch.profiler.record_function` while a
`torch.profiler.profile` runs (the benchmark's traced window, `cli.train
--profile_steps`), so each span lands in that profiler's trace beside the
device operations it enqueued. Otherwise it is one shared null context:
the check is one read of the profiler's flag, where an idle
`record_function` would cost some microseconds a call. Under a compiler
(torch.export, torch.compile) it is the null context too, so that no
profiler op enters a traced graph.

The names, all `ynt.`:

- `ynt.predict`: a predict function's whole call (`serving`);
- `ynt.forward`: `YoloNano.forward`, backbone, neck and heads (and
  `NanoDetPlus.forward`);
- `ynt.postprocess`: scores, top-k, decode and NMS (`models.yolo_nano.detect`,
  `models.nanodet_plus.detect`);
- `ynt.pairs`: NanoDet-Plus's multi-label scores and the selection of the
  top (prior, class) pairs; `ynt.decode`: the distance decode of the pairs
  selected (`models.nanodet_plus.postprocess`, inside `ynt.postprocess`);
- `ynt.scores.kernel`: each launch of the scores kernel on CUDA
  (`ops.kernels.scores`, the operator's CUDA implementation; one a
  YOLO-Nano predict);
- `ynt.nms.kernel`: each launch of the NMS kernel on CUDA
  (`ops.kernels.nms_greedy`, the operator's CUDA implementation);
- `ynt.nms.wait`: each host read of the plain NMS loop's condition, the
  host blocked on the device (sweeps + 1 a call); `ynt.nms.sweep`: each
  sweep (`ops.kernels.nms_greedy.nms_greedy_plain`, the operator's CPU
  implementation);
- `ynt.train.step` and its phases `ynt.train.augment`, `.targets`,
  `.loss`, `.backward`, `.all_reduce`, `.update` (`TrainStep.__call__`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` while a profiler runs, else a shared
    null context."""
    if not _profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NULL
    return torch.profiler.record_function(name)
