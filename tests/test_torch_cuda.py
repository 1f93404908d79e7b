"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. They
import only torch and numpy, so they run where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
Shapes include ragged tiles (sizes not a multiple of the 8x8 tile) and odd
inputs to stride-2 blocks. Tolerances: f32 1e-4·max|ref| + 1e-5 (summation
order differs); bf16 rtol 2e-2, atol 2e-2.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yolo_nano_tpu_torch.models.yolo_nano import set_full_f32

    set_full_f32()
    return torch.device("cuda")


def _close_f32(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item() + 1e-5, err


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("acts", [("leaky", "leaky"), (None, "relu")])
@pytest.mark.parametrize("shape", [(3, 96, 13, 11), (2, 24, 8, 8),
                                   (1, 40, 17, 5)])
def test_fused_dw_pw_kernel_matches_plain(dev, dtype, acts, shape):
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain)

    g = torch.Generator().manual_seed(0)
    b, c, h, w = shape
    cout = c + 8
    x = _randn(g, b, h, w, c).permute(0, 3, 1, 2).to(dev, dtype)
    args = (_randn(g, 3, 3, c, scale=0.2).to(dev),
            _randn(g, c, scale=0.1).to(dev),
            _randn(g, c, cout, scale=0.1).to(dev, dtype),
            _randn(g, cout, scale=0.1).to(dev))
    kw = dict(act_mid=acts[0], act_out=acts[1])
    before = fused_dw_pw.launches
    got = fused_dw_pw(x, *args, **kw)
    assert fused_dw_pw.launches == before + 1
    want = fused_dw_pw_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        _close_f32(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_fused_dw_pw_refuses_nchw_contiguous(dev):
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw

    x = torch.zeros(1, 8, 4, 4, device=dev)  # NCHW-contiguous, not NHWC
    with pytest.raises(ValueError, match="channels_last"):
        fused_dw_pw(x, torch.zeros(3, 3, 8, device=dev),
                    torch.zeros(8, device=dev), torch.zeros(8, 8, device=dev),
                    torch.zeros(8, device=dev))


def _random_stage(gen, cin, cout, n_blocks):
    """A folded ShuffleV2 stage with random weights."""
    from torch import nn

    from yolo_nano_tpu_torch.models.shufflenetv2 import (ShuffleBlock,
                                                         ShuffleStage)
    from yolo_nano_tpu_torch.ops.nn import ConvUnit

    c2 = cout // 2

    def unit(o, i, k, groups=1, stride=1, act=None):
        return ConvUnit(_randn(gen, o, i // groups, k, k,
                               scale=1.0 / np.sqrt(i // groups * k * k)),
                        _randn(gen, o, scale=0.1), None, stride=stride,
                        groups=groups, act=act)

    blocks = []
    for i in range(n_blocks):
        s = 2 if i == 0 else 1
        k1 = cin if i == 0 else c2
        branch2 = nn.ModuleDict({
            "pw1": unit(c2, k1, 1, act="relu"),
            "dw": unit(c2, c2, 3, groups=c2, stride=s),
            "pw2": unit(c2, c2, 1, act="relu")})
        branch1 = None if i else nn.ModuleDict({
            "dw": unit(cin, cin, 3, groups=cin, stride=2),
            "pw": unit(c2, cin, 1, act="relu")})
        blocks.append(ShuffleBlock(branch2, branch1))
    return ShuffleStage(blocks)


@pytest.mark.parametrize("cin,cout,n,hw", [
    (24, 116, 4, (104, 104)),   # stage2 widths, main-path size
    (116, 232, 3, (25, 23)),    # odd input to the stride-2 block
    (232, 464, 2, (26, 26)),    # stage4 widths
    (24, 48, 2, (9, 14)),       # 0.5x widths, ragged tiles
])
def test_fused_stage_kernel_matches_plain(dev, cin, cout, n, hw):
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage, fused_stage_plain, prepare_stage)

    g = torch.Generator().manual_seed(1)
    stage = _random_stage(g, cin, cout, n).to(dev)
    blocks = prepare_stage(stage)
    x = torch.relu(_randn(g, 2, hw[0], hw[1], cin)).permute(0, 3, 1, 2).to(dev)
    calls, launches = fused_stage.calls, fused_stage.launches
    got = fused_stage(x, blocks)
    assert (fused_stage.calls, fused_stage.launches) == (calls + 1,
                                                         launches + n)
    want = fused_stage_plain(x, blocks)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, cout, (hw[0] + 1) // 2,
                                       (hw[1] + 1) // 2)
    _close_f32(got, want)
    # the module path on the card goes through the kernel too
    _close_f32(stage(x), want)
