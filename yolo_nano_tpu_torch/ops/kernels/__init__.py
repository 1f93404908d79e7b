"""The port's hand kernels for Hopper, each a PyTorch operator in the
namespace `yolo_nano_torch`: `shuffle_block` (one ShuffleV2 block,
`fused_stage.py`), `dw_pw` (a head's dw→pw pair, `fused_conv.py`),
`nms_greedy` (greedy NMS, `nms_greedy.py`) and `scores` (the detector's
scores and classes, `scores.py`). Each has its plain PyTorch
version as its CPU implementation, its CUDA kernel (built with nvcc at
first use) as its CUDA implementation, and a fake one for tracing.
Importing this package registers them: it is all that a graph saved by
torch.export (`serving.export_graph`) needs to load.
"""

import torch

from yolo_nano_tpu_torch.ops.kernels import (fused_conv, fused_stage,
                                             nms_greedy, scores)

# each operator's plain version, called with the operator's arguments, for
# code that must see the plain version's own operators (`utils.flops`)
PLAIN_VERSIONS = {
    torch.ops.yolo_nano_torch.shuffle_block.default:
        fused_stage.shuffle_block_plain,
    torch.ops.yolo_nano_torch.dw_pw.default: fused_conv.dw_pw_plain,
    torch.ops.yolo_nano_torch.nms_greedy.default:
        nms_greedy.nms_greedy_plain,
    torch.ops.yolo_nano_torch.scores.default: scores.scores_plain,
}
