"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. They
import only torch and numpy, so they run where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
Shapes include ragged tiles (sizes not a multiple of the tile), widths not
a multiple of 8, more tiles than SMs (so fused_dw_pw's persistent blocks
walk several tiles each) and odd inputs to stride-2 blocks. Tolerances: f32
1e-4·max|ref| + 1e-5 (the tensor-core products sum in another order than
cuDNN); the bf16 kernels (fused_dw_pw by call, the stage block by block)
in bf16 ulps of max|ref| (BF16_BLOCK_ULPS) and mostly bit-equal; against
f64, at most 4x the error of cuDNN in f32; bf16 fused_dw_pw against its
witness (f64 sums, rounded where the function rounds), off it no more often
than BF16_WITNESS_RATIO times the plain version (f32 sums).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
# the bf16 kernels against their plain versions (fused_dw_pw by call, the
# stage block by block): bf16 ulps of the output's max|ref|, and the least
# share of bit-equal elements (as chip_smoke.py holds them)
BF16_BLOCK_ULPS = 1
BF16_BLOCK_EQUAL = 0.99
# bf16 fused_dw_pw's outputs off its f64-sum witness, over the plain
# version's (as chip_smoke.py holds the kernels)
BF16_WITNESS_RATIO = 1.5
# the bf16 fused_dw_pw tile rule's picks at the heads' C = Cout = 96 and
# the blocks an SM holds at each: (batch, side) → ((columns, rows), blocks)
BF16_DW_PW_TILES = {
    (32, 52): ((13, 9), 2), (32, 26): ((7, 13), 2), (32, 13): ((7, 7), 2),
    (8, 80): ((10, 10), 2), (8, 40): ((5, 10), 2), (8, 20): ((5, 5), 2),
    (8, 10): ((4, 2), 2), (1, 52): ((6, 4), 2), (1, 26): ((3, 2), 2),
    (1, 13): ((2, 1), 2)}


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


def _bf16_close(got, want):
    """bf16 got within BF16_BLOCK_ULPS of max|want| and BF16_BLOCK_EQUAL of
    its elements bit-equal."""
    ulps = _bf16_ulps(got, want)
    equal = (got == want).float().mean().item()
    assert ulps <= BF16_BLOCK_ULPS and equal >= BF16_BLOCK_EQUAL, (ulps,
                                                                   equal)


def _dw_pw_args(g, dev, dtype, c, cout):
    return (_randn(g, 3, 3, c, scale=0.2).to(dev),
            _randn(g, c, scale=0.1).to(dev),
            _randn(g, c, cout, scale=0.1).to(dev, dtype),
            _randn(g, cout, scale=0.1).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("acts", [("leaky", "leaky"), (None, "relu")])
@pytest.mark.parametrize("shape", [(3, 96, 13, 11), (2, 24, 8, 8),
                                   (1, 40, 17, 5), (2, 20, 9, 7)])
def test_fused_dw_pw_kernel_matches_plain(dev, dtype, acts, shape):
    """f32 within its tolerance, bf16 in ulps and bit-equal share; Cout =
    C + 8 (C = 20 → Cout = 28: neither a multiple of 16)."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain)

    g = torch.Generator().manual_seed(0)
    b, c, h, w = shape
    x = _randn(g, b, h, w, c).permute(0, 3, 1, 2).to(dev, dtype)
    args = _dw_pw_args(g, dev, dtype, c, c + 8)
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
        _bf16_close(got, want)


def test_fused_dw_pw_refuses_nchw_contiguous(dev):
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw

    x = torch.zeros(1, 8, 4, 4, device=dev)  # NCHW-contiguous, not NHWC
    with pytest.raises(ValueError, match="channels_last"):
        fused_dw_pw(x, torch.zeros(3, 3, 8, device=dev),
                    torch.zeros(8, device=dev), torch.zeros(8, 8, device=dev),
                    torch.zeros(8, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tile", [
    ((3, 96, 13, 11), (1, 2)),     # 231 tiles: each block walks several
    ((4, 40, 30, 28), (5, 3)),     # 240 ragged tiles
    ((8, 96, 52, 52), (13, 9)),    # main-path width and tile, 192 tiles
    ((2, 20, 9, 7), (4, 4)),       # C, Cout not multiples of 8
    ((1, 19, 6, 10), (3, 4)),      # odd C, Cout: no 16-byte copies or stores
    ((2, 96, 26, 26), (16, 6)),    # the bf16 kernel's two blocks an SM
    ((1, 96, 13, 13), (16, 4)),    # a tile wider than the image
])
def test_fused_dw_pw_kernel_at_given_tiles(dev, dtype, shape, tile):
    """The launch at a given tile, whatever the tile rule picks."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (_launch,
                                                            fused_dw_pw_plain)

    g = torch.Generator().manual_seed(5)
    b, c, h, w = shape
    x = _randn(g, b, h, w, c).permute(0, 3, 1, 2).to(dev, dtype)
    args = _dw_pw_args(g, dev, dtype, c, c + 8)
    got = _launch(x, *args, "leaky", "leaky", tile=tile)
    want = fused_dw_pw_plain(x, *args)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _close_f32(got, want)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("acts", [("leaky", "leaky"), (None, "relu")])
@pytest.mark.parametrize("batch", [1, 32])
def test_fused_dw_pw_bf16_at_head_shapes(dev, batch, acts):
    """The bf16 kernel at the heads' 52², 26² and 13² (C = Cout = 96), at
    the tile its rule picks: each level in ulps and bit-equal share; over
    the three levels, its outputs off the witness (fused_dw_pw_plain with
    f64 sums) at most BF16_WITNESS_RATIO times the plain version's."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain)

    g = torch.Generator().manual_seed(9)
    bf = torch.bfloat16
    kw = dict(act_mid=acts[0], act_out=acts[1])
    off = plain_off = 0
    for side in (52, 26, 13):
        x = _randn(g, batch, side, side, 96).permute(0, 3, 1, 2).to(dev, bf)
        args = _dw_pw_args(g, dev, bf, 96, 96)
        before = fused_dw_pw.launches_bf16
        got = fused_dw_pw(x, *args, **kw)
        assert fused_dw_pw.launches_bf16 == before + 1
        want = fused_dw_pw_plain(x, *args, **kw)
        exact = fused_dw_pw_plain(x, *args, wide=torch.float64, **kw)
        torch.cuda.synchronize()
        _bf16_close(got, want)
        off += int((got != exact).sum())
        plain_off += int((want != exact).sum())
    assert off <= BF16_WITNESS_RATIO * plain_off, (off, plain_off)


@pytest.mark.parametrize("cout", [96, 28, 27, 320])
@pytest.mark.parametrize("offset", [1, 2])
def test_fused_dw_pw_bf16_takes_an_unaligned_input(dev, offset, cout):
    """bf16 x at a storage offset of one element (2-byte aligned: single
    loads) or two (4-byte: 4-byte copies), ragged H and W; Cout a multiple
    of 8, even, odd, and above 256 (the product's wide variant)."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain)

    g = torch.Generator().manual_seed(10)
    bf = torch.bfloat16
    c = 20 if cout == 28 else 96
    want_in = _randn(g, 3, 15, 11, c).to(dev, bf)
    buf = torch.zeros(want_in.numel() + offset, device=dev, dtype=bf)
    x = buf[offset:].view(want_in.shape).permute(0, 3, 1, 2)
    x.copy_(want_in.permute(0, 3, 1, 2))
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16
    args = _dw_pw_args(g, dev, bf, c, cout)
    got = fused_dw_pw(x, *args)
    torch.cuda.synchronize()
    _bf16_close(got, fused_dw_pw_plain(x, *args))


@pytest.fixture(scope="module")
def trained_model():
    from yolo_nano_tpu_torch.convert import load_model

    npz = __file__.rsplit("/tests/", 1)[0] + (
        "/yolo_nano_tpu_torch/assets/bench_coco416.npz")
    model, _, _ = load_model(npz)
    return model


@pytest.mark.parametrize("pair", [0, 1])
def test_fused_dw_pw_on_trained_head_weights(dev, trained_model, pair):
    """[2, 96, 52, 52] f32 through a trained head pair of level 0: within
    the f32 tolerance of the plain version, and against the pair in f64 no
    more than 4x the error of the plain version in f32 (cuDNN)."""
    import torch.nn.functional as F

    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (fused_dw_pw,
                                                            fused_dw_pw_plain)
    from yolo_nano_tpu_torch.ops.nn import activate

    dw_w, dw_b, pw_w, pw_b = (t.to(dev) for t in
                              trained_model.head0._pairs()[pair])
    g = torch.Generator().manual_seed(6)
    x = _randn(g, 2, 52, 52, 96).permute(0, 3, 1, 2).to(dev)
    got = fused_dw_pw(x, dw_w, dw_b, pw_w, pw_b)
    want = fused_dw_pw_plain(x, dw_w, dw_b, pw_w, pw_b)
    y = F.conv2d(x.double(), dw_w.double().permute(2, 0, 1).unsqueeze(1),
                 dw_b.double(), padding=1, groups=96)
    y = F.conv2d(activate(y, "leaky"), pw_w.double().t()[:, :, None, None],
                 pw_b.double())
    exact = activate(y, "leaky")
    torch.cuda.synchronize()
    _close_f32(got, want)
    err_kernel = (got.double() - exact).abs().max().item()
    err_cudnn = (want.double() - exact).abs().max().item()
    assert err_kernel <= 4 * err_cudnn, (err_kernel, err_cudnn)


def test_dw_pw_tiles_at_main_path_widths(dev):
    """Each kernel's tile rule and shared-memory layout at the heads' C =
    Cout = 96: the f32 kernel's (fused_dw_pw_tile, fused_dw_pw_smem_bytes)
    at batch 32, 416 px; the bf16 kernel's own (fused_dw_pw_bf16_tile,
    fused_dw_pw_bf16_smem_bytes, fused_dw_pw_bf16_blocks_per_sm) at batch
    32 (416 px), 8 (320 and 640 px) and 1 (416 px), the picks of the rule
    fitted to chip_smoke.py --sweep-dw-pw-tiles, with the blocks an SM
    holds: (batch, side) → (columns, rows); the layouts' bytes; and the
    widths each refuses."""
    from yolo_nano_tpu_torch.ops.kernels.fused_conv import (_lib, smem_bytes,
                                                            tile_shape)

    f32, bf16 = torch.float32, torch.bfloat16
    want = {52: (13, 9), 26: (13, 7), 13: (13, 4)}
    for side, tile in want.items():
        assert tile_shape(32, side, side, 96, 96, 4) == tile
        assert smem_bytes(*tile, 96, 96, f32) <= 227 * 1024
    # weights 96 x 104; taps and biases 9·96 + 96 + 96; output 128 rows x
    # 100; two regions of 15 x 11 cells x 96 channels
    assert smem_bytes(13, 9, 96, 96, f32) == 4 * (
        96 * 104 + 1056 + 128 * 100) + 2 * (11 * 15 * 96 * 4)
    with pytest.raises(ValueError, match="do not fit"):
        tile_shape(2, 8, 8, 256, 256, 4)
    blocks = _lib(bf16).fused_dw_pw_bf16_blocks_per_sm
    for (batch, side), (tile, per_sm) in BF16_DW_PW_TILES.items():
        assert tile_shape(batch, side, side, 96, 96, 2) == tile, (batch, side)
        assert smem_bytes(*tile, 96, 96, bf16) <= 227 * 1024
        assert blocks(*tile, 96, 96, 3) == per_sm, (batch, side)
    # taps, biases and a zero (9·96 + 96 + 96 + 1, to 1060 floats); weights
    # 96 rows x (96 + 8); output 128 rows x 104; two regions of 15 x 11
    # cells x 96 channels: two blocks an SM
    assert smem_bytes(13, 9, 96, 96, bf16) == 4 * 1060 + 2 * (
        96 * 104 + 128 * 104 + 2 * 15 * 11 * 96)
    # C 20 → Cout 28: 232 floats; weights 32 rows x 40; output 16 rows x
    # act_stride(28) = 40; regions of 36 cells x 24 (16-byte cells)
    assert smem_bytes(4, 4, 20, 28, bf16) == 4 * 232 + 2 * (
        32 * 40 + 16 * 40 + 2 * 36 * 24)
    with pytest.raises(ValueError, match="do not fit"):
        tile_shape(2, 8, 8, 512, 512, 2)


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
    (116, 232, 8, (52, 52)),    # stage3 widths and depth, main-path size
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


def test_fused_stage_error_against_f64_is_like_cudnn_f32(dev):
    """The kernel's 3xTF32 products against the stage in f64, at stage 3's
    widths and depth: no more than 4x the error of the plain stage in f32
    (cuDNN). Its error against cuDNN alone cannot tell summation order from
    lost precision; this can."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        fused_stage, fused_stage_plain, prepare_stage)

    g = torch.Generator().manual_seed(3)
    stage = _random_stage(g, 116, 232, 8).to(dev)
    blocks = prepare_stage(stage)
    x = torch.relu(_randn(g, 2, 52, 52, 116)).permute(0, 3, 1, 2).to(dev)
    blocks64 = [{k: v if k == "stride" else v.double() for k, v in b.items()}
                for b in blocks]
    exact = fused_stage_plain(x.double(), blocks64)
    err_kernel = (fused_stage(x, blocks).double() - exact).abs().max().item()
    err_cudnn = (fused_stage_plain(x, blocks).double()
                 - exact).abs().max().item()
    assert err_kernel <= 4 * err_cudnn, (err_kernel, err_cudnn)


@pytest.mark.parametrize("cin,cout", [(116, 232), (116, 116)])
def test_fused_stage_takes_an_unaligned_input(dev, cin, cout):
    """x at a storage offset of one float (channels_last contiguous, not
    16-byte aligned): the stride-2 block (a whole stage) and a stride-1
    block on their own read it without the 16-byte copies."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _launch_block, _lib, block_plain, fused_stage, fused_stage_plain,
        prepare_stage)

    g = torch.Generator().manual_seed(4)
    blocks = prepare_stage(_random_stage(g, cin, cout, 2).to(dev))
    for x_cin, run, plain in ((cin, lambda x: fused_stage(x, blocks),
                               lambda x: fused_stage_plain(x, blocks)),
                              (cout, lambda x: _launch_block(_lib(), x,
                                                             blocks[1]),
                               lambda x: block_plain(x, blocks[1]))):
        want_in = torch.relu(_randn(g, 2, 13, 11, x_cin)).to(dev)
        buf = torch.zeros(want_in.numel() + 1, device=dev)
        x = buf[1:].view(want_in.shape).permute(0, 3, 1, 2)
        x.copy_(want_in.permute(0, 3, 1, 2))
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert x.data_ptr() % 16
        got = run(x)
        torch.cuda.synchronize()
        _close_f32(got, plain(x))


def _bf16_ulps(got, want):
    """max |got − want| in bf16 ulps of max|want|."""
    top = want.float().abs().max().item()
    return ((got.float() - want.float()).abs().max().item()
            / 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7))


@pytest.mark.parametrize("bf16_weights", [True, False])
@pytest.mark.parametrize("cin,cout,n,hw", [
    (24, 48, 4, (104, 104)),    # 0.5x stage2 widths, main-path size
    (48, 96, 8, (52, 52)),      # 0.5x stage3 widths and depth
    (96, 192, 4, (26, 26)),     # 0.5x stage4
    (24, 116, 4, (104, 104)),   # 1.0x stage2: c2 = 58, no 16-byte paths
    (116, 232, 8, (52, 52)),    # 1.0x stage3
    (232, 464, 4, (26, 26)),    # 1.0x stage4, c2 = 232
    (352, 704, 4, (26, 26)),    # 1.5x stage4, c2 = 352 (the wide variant)
    (488, 976, 4, (26, 26)),    # 2.0x stage4, c2 = 488
    (24, 48, 2, (9, 14)),       # ragged tiles, odd input to stride 2
])
def test_fused_stage_bf16_kernel_matches_plain(dev, cin, cout, n, hw,
                                               bf16_weights):
    """The bf16 kernel, block by block on the plain chain's bf16 inputs:
    within BF16_BLOCK_ULPS ulps of max|ref| of the plain block and 99% of
    the elements bit-equal (the two sum each op in another f32 order, which
    can flip a bf16 rounding by one ulp). The weights are bf16 values (a
    cast stage, as on the main path) or f32 ones, whose pointwise weights
    both round to bf16. The wrapper and the module path launch the bf16
    kernel."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _launch_block, _lib, block_plain, fused_stage, prepare_stage)
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

    g = torch.Generator().manual_seed(2)
    stage = _random_stage(g, cin, cout, n)
    if bf16_weights:
        stage = cast_f32_to_bf16(stage)
    stage = stage.to(dev)
    blocks = prepare_stage(stage)
    x = torch.relu(_randn(g, 2, hw[0], hw[1], cin)).permute(0, 3, 1, 2).to(
        dev, torch.bfloat16)
    launches = fused_stage.launches_bf16
    got = fused_stage(x, blocks)
    assert fused_stage.launches_bf16 == launches + n
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, cout, (hw[0] + 1) // 2, (hw[1] + 1) // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(stage(x), got)
    lib = _lib(torch.bfloat16)
    for w in blocks:
        want = block_plain(x, w)
        out = _launch_block(lib, x, w)
        torch.cuda.synchronize()
        ulps = _bf16_ulps(out, want)
        equal = (out == want).float().mean().item()
        assert ulps <= BF16_BLOCK_ULPS and equal >= 0.99, (ulps, equal)
        x = want


@pytest.mark.parametrize("cin,cout,n,hw", [
    (24, 48, 2, (80, 80)),      # 0.5x stage inputs at 320 px
    (48, 96, 2, (40, 40)),
    (96, 192, 2, (20, 20)),
    (24, 48, 2, (152, 152)),    # 0.5x stage inputs at 608 px
    (48, 96, 2, (76, 76)),
    (96, 192, 2, (38, 38)),
    (24, 116, 2, (152, 152)),   # 1.0x stage inputs at 608 px
    (116, 232, 2, (76, 76)),
    (232, 464, 2, (38, 38)),
    (352, 704, 2, (20, 20)),    # 1.5x and 2.0x stage-4 inputs at 320 px
    (488, 976, 2, (20, 20)),
    (352, 704, 2, (38, 38)),    # and at 608 px
    (488, 976, 2, (38, 38)),
])
def test_fused_stage_bf16_at_ragged_sizes(dev, cin, cout, n, hw):
    """Stage inputs of the multi-scale sizes 320 and 608 px, whose output
    sides (40, 20, 10; 76, 38, 19) the tile rule's sides need not divide:
    every block of a bf16 stage within BF16_BLOCK_ULPS of max|ref| of its
    plain block and 99% bit-equal, at the tile the rule picks and at
    every side that fits."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _launch_block, _lib, block_plain, prepare_stage, smem_bytes)
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

    g = torch.Generator().manual_seed(7)
    blocks = prepare_stage(cast_f32_to_bf16(
        _random_stage(g, cin, cout, n)).to(dev))
    x = torch.relu(_randn(g, 2, hw[0], hw[1], cin)).permute(0, 3, 1, 2).to(
        dev, torch.bfloat16)
    lib = _lib(torch.bfloat16)
    for w in blocks:
        want = block_plain(x, w)
        b, c, h, wd = x.shape
        c2 = w["pw1_w"].shape[1]
        tiles = [None] + [t for t in range(1, 17) if smem_bytes(
            t, w["stride"], c, c2, torch.bfloat16) <= 227 * 1024]
        for tile in tiles:
            out = _launch_block(lib, x, w, tile)
            torch.cuda.synchronize()
            ulps = _bf16_ulps(out, want)
            equal = (out == want).float().mean().item()
            assert ulps <= BF16_BLOCK_ULPS and equal >= 0.99, (tile, ulps,
                                                               equal)
        x = want


@pytest.mark.parametrize("cin,cout", [(48, 96), (116, 232), (96, 96)])
def test_fused_stage_bf16_takes_an_unaligned_input(dev, cin, cout):
    """bf16 x at a storage offset of one element (2 bytes): the stride-2
    block (a whole stage) and a stride-1 block on their own read it by
    single loads and store in pairs."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (
        _launch_block, _lib, block_plain, fused_stage, fused_stage_plain,
        prepare_stage)

    g = torch.Generator().manual_seed(4)
    blocks = prepare_stage(_random_stage(g, cin, cout, 2).to(dev))
    for x_cin, run, plain in ((cin, lambda x: fused_stage(x, blocks),
                               lambda x: fused_stage_plain(x, blocks)),
                              (cout, lambda x: _launch_block(
                                  _lib(torch.bfloat16), x, blocks[1]),
                               lambda x: block_plain(x, blocks[1]))):
        want_in = torch.relu(_randn(g, 2, 13, 11, x_cin)).to(
            dev, torch.bfloat16)
        buf = torch.zeros(want_in.numel() + 1, device=dev,
                          dtype=torch.bfloat16)
        x = buf[1:].view(want_in.shape).permute(0, 3, 1, 2)
        x.copy_(want_in.permute(0, 3, 1, 2))
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert x.data_ptr() % 4
        got = run(x)
        torch.cuda.synchronize()
        want = plain(x)
        ulps = _bf16_ulps(got, want)
        assert ulps <= 2 * BF16_BLOCK_ULPS, ulps


def test_block_tiles_at_half_width(dev):
    """The bf16 kernel's own tile rule and shared-memory layout
    (shuffle_block_bf16_tile, shuffle_block_bf16_smem_bytes in
    csrc/fused_stage_bf16.cu), batch 32, 416 px: (stride, Cin, c2, output
    side) → tile side at the 0.5x stages (c2 = 24, 48, 96; the bf16 main
    path) and at the 1.0x stages (c2 = 58, 116, 232; make_predict_fn), each
    the side chip_smoke.py --sweep-stage-tiles measured fastest but at one
    1.0x launch; the blocks an SM holds; the layout's bytes, with the
    pointwise weights resident (up to 64 KB) or streamed."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (_lib,
                                                             block_tile,
                                                             smem_bytes)

    bf16 = torch.bfloat16
    lib = _lib(bf16)
    smem_max = 227 * 1024
    # (stride, Cin, c2, side) → (tile, blocks an SM)
    want = {(2, 24, 24, 52): (13, 2), (1, 48, 24, 52): (13, 2),
            (2, 48, 48, 26): (13, 1), (1, 96, 48, 26): (13, 2),
            (2, 96, 96, 13): (7, 1), (1, 192, 96, 13): (7, 2),
            (2, 24, 58, 52): (9, 2), (1, 116, 58, 52): (13, 2),
            (2, 116, 116, 26): (7, 1), (1, 232, 116, 26): (13, 1),
            (2, 232, 232, 13): (5, 1), (1, 464, 232, 13): (7, 1)}
    for (stride, cin, c2, side), (tile, blocks) in want.items():
        assert block_tile(stride, cin, c2, 32, side, side, bf16) == tile
        assert smem_bytes(tile, stride, cin, c2, bf16) <= smem_max
        assert lib.shuffle_block_bf16_blocks_per_sm(tile, stride, cin,
                                                    c2) == blocks
    # stride 1, Cin 96, c2 48, tile 13: 225 region cells' and 169 pixels'
    # offsets (396 ints), the biases and taps (48 + 48 + 9·48 + 48 floats);
    # X 240 rows at 48 + 8 bf16, L 169 rows at 56, D 176 rows at 56; pw1's
    # and pw2's weights resident, 48 rows at 48 + 8
    assert smem_bytes(13, 1, 96, 48, bf16) == 4 * (396 + 576) + 2 * (
        240 * 56 + 169 * 56 + 176 * 56 + 2 * 48 * 56)
    # streamed, stride 2, Cin = c2 = 232, tile 5: 121 cells + 25 pixels
    # (148 ints) and 5336 floats (three biases, two tap sets); X 128 rows at
    # 240 + 8, L 25 rows and D 32 rows at 248; two chunks of 232 rows at 32
    # + 8. Side 6 fits, 7 does not
    assert smem_bytes(5, 2, 232, 232, bf16) == 4 * (148 + 5336) + 2 * (
        128 * 248 + 25 * 248 + 32 * 248 + 2 * 232 * 40)
    assert smem_bytes(6, 2, 232, 232, bf16) <= smem_max < smem_bytes(
        7, 2, 232, 232, bf16)


@pytest.mark.parametrize("size", [320, 416, 608])
def test_block_tiles_at_wide_stage4(dev, size):
    """The bf16 tile rule above c2 = 256 (stage 4 at 1.5x and 2.0x, the
    kernel's wide variant, 1 block an SM, weights streamed) returns a side
    whose buffers fit for both strides at 416 px and the TTA sizes 320 and
    608, batch 32; at c2 = 488 stride 2 only sides up to 3 fit."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import (_lib,
                                                             block_tile,
                                                             smem_bytes)

    bf16 = torch.bfloat16
    lib = _lib(bf16)
    side = size // 32
    for stride, cin, c2 in ((2, 352, 352), (1, 704, 352), (2, 488, 488),
                            (1, 976, 488)):
        tile = block_tile(stride, cin, c2, 32, side, side, bf16)
        assert 1 <= tile <= 16
        assert smem_bytes(tile, stride, cin, c2, bf16) <= 227 * 1024
        assert lib.shuffle_block_bf16_blocks_per_sm(tile, stride, cin,
                                                    c2) >= 1
    assert smem_bytes(3, 2, 488, 488, bf16) <= 227 * 1024 < smem_bytes(
        4, 2, 488, 488, bf16)


def test_block_tiles_at_main_path_widths(dev):
    """The kernel's tile rule and shared-memory layout
    (shuffle_block_tile, shuffle_block_smem_bytes). (stride, Cin, c2,
    output side) of the 1.0x stages at 416 px, batch 32 → tile side; the
    buffers fit, and pw1's halo recompute (region rows over output pixels)
    is below the earlier 28 KB rule's ×1.78, ×2.25 and ×4.00 at stride 1."""
    from yolo_nano_tpu_torch.ops.kernels.fused_stage import _lib, block_tile

    smem_max = 227 * 1024  # shared memory one block may use on sm_90
    smem = _lib().shuffle_block_smem_bytes
    want = {(2, 24, 58, 52): 11, (1, 116, 58, 52): 13, (2, 116, 116, 26): 7,
            (1, 232, 116, 26): 13, (2, 232, 232, 13): 5, (1, 464, 232, 13): 7}
    halo = {}
    for (stride, cin, c2, side), tile in want.items():
        assert block_tile(stride, cin, c2, 32, side, side) == tile
        assert smem(tile, stride, cin, c2) <= smem_max
        if stride == 1:
            halo[c2] = (tile + 2) ** 2 / tile ** 2
    assert halo[58] < 1.78 and halo[116] < 2.25 and halo[232] < 4.0
    # every side whose buffers fit is a candidate
    assert smem(5, 2, 232, 232) <= smem_max < smem(6, 2, 232, 232)
    # the layout: offsets (81 region cells + 49 tile pixels → 132 ints);
    # region, 96 rows at 232 + 4; depthwise out, 64 rows at 232 + 4; two
    # 16-row weight chunks at 232 (29 tiles of 8, odd). At c2 = 58 the chunk
    # stride is 64 + 8 (8 tiles, even); stride 2 sizes D for max(Cin, c2)
    assert smem(7, 1, 464, 232) == 4 * 132 + 4 * (
        96 * 236 + 64 * 236 + 2 * 16 * 232)
    assert smem(8, 2, 24, 58) == 4 * 356 + 4 * (
        304 * 68 + 64 * 68 + 2 * 16 * 72)
    assert smem(2, 2, 240, 232) == 4 * 32 + 4 * (
        32 * 244 + 16 * 244 + 2 * 16 * 232)


# ---------------------------------------------------------------------------
# training on the card (no kernel of its own: unfolded convs, cuDNN f32)
# ---------------------------------------------------------------------------

def _train_batch(b=2, m=6, size=64, seed=0):
    """Images U(−1, 1) and m gt slots per image, the last two padding."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    x1, y1 = rng.uniform(0.0, 0.6, (2, b, m))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.1, 0.4, (b, m)),
                      y1 + rng.uniform(0.1, 0.4, (b, m))], -1)
    labels = rng.integers(0, 20, (b, m)).astype(np.int32)
    labels[:, -2:] = -1
    return [torch.from_numpy(a) for a in
            (images, np.clip(boxes, 0, 1).astype(np.float32), labels)]


def test_train_step_on_cuda_matches_cpu(dev):
    """One step from the same state and batch on the card and on the CPU
    (1.0x, 256 px, batch 2, EMA on), and on the CPU in f64: the losses
    within rtol 1e-4 of the CPU's f32 step; per state field, the card's
    error against the f64 step (root of the summed squares) within 4x the
    CPU f32 step's, plus 1e-7 of the field's norm, as chip_smoke.py holds
    the card at 416 px."""
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu_torch.train import (create_train_state,
                                           make_optimizer, make_train_step)

    cfg = YoloNanoConfig(num_classes=20)
    tx = make_optimizer(lambda count: 1e-3)
    model = init_yolo_nano(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    state = create_train_state(model, tx, use_ema=True)
    images, boxes, labels = _train_batch(size=256)
    cpu_step = make_train_step(cfg, tx, 256, device="cpu")
    cpu, cpu_m = cpu_step(state, images, boxes, labels)
    ref, _ = cpu_step(state.to("cpu", torch.float64), images.double(), boxes,
                      labels)
    got, got_m = make_train_step(cfg, tx, 256)(
        state.to(dev), *(t.to(dev) for t in (images, boxes, labels)))
    for k, w in cpu_m.items():
        torch.testing.assert_close(got_m[k].cpu(), w, rtol=1e-4, atol=0)
    g, c, r = got.flat(), cpu.flat(), ref.flat()
    assert g.keys() == r.keys()
    for field in ("params", "stats", "trace", "ema_params", "ema_stats"):
        keys = [k for k in r if k.startswith(field + "/")]
        card_err, cpu_err, norm = (sum(t.square().sum().item() for t in ts)
                                   ** 0.5 for ts in (
            [g[k].cpu().double() - r[k] for k in keys],
            [c[k].double() - r[k] for k in keys], [r[k] for k in keys]))
        assert card_err <= 4 * cpu_err + 1e-7 * norm, (field, card_err,
                                                      cpu_err)


def test_build_targets_on_cuda_with_collisions_matches_cpu(dev):
    """Duplicated gts (positive/positive) and concentric boxes of growing
    size (ignore rows on each other's positives): CUDA's index_put_ picks
    any writer among duplicates, so the port's writes hold none that
    matter; the result equals the CPU's (tw, th within 1e-6)."""
    from yolo_nano_tpu_torch.config import YoloNanoConfig
    from yolo_nano_tpu_torch.losses.targets import build_targets

    cfg = YoloNanoConfig(num_classes=20)
    rng = np.random.default_rng(0)
    boxes = np.zeros((3, 40, 4), np.float32)
    labels = np.full((3, 40), -1, np.int32)
    for i in range(3):
        for j in range(0, 40, 8):
            c = rng.uniform(0.2, 0.8, 2)
            base = rng.uniform(0.03, 0.15)
            for k in range(4):
                half = base * 1.15 ** k / 2
                boxes[i, j + 2 * k:j + 2 * k + 2] = np.clip(
                    np.concatenate([c - half, c + half]), 0, 1)
                labels[i, j + 2 * k:j + 2 * k + 2] = rng.integers(0, 20, 2)
    tb, tl = torch.from_numpy(boxes), torch.from_numpy(labels)
    want = build_targets(tb, tl, cfg, 416)
    got = build_targets(tb.to(dev), tl.to(dev), cfg, 416).cpu()
    exact = [0, 1, 2, 3, 6, 7, 8, 9, 10]
    assert torch.equal(got[..., exact], want[..., exact])
    torch.testing.assert_close(got[..., 4:6], want[..., 4:6], rtol=0,
                               atol=1e-6)
    assert (want[..., 0] == 1).sum() > 0 and (want[..., 0] == -1).sum() > 0


# ---------------------------------------------------------------------------
# device_prefetch: pinned staging, a copy stream, the consumer's wait
# ---------------------------------------------------------------------------

def _host_batches(n=10, b=8, size=96, m=16):
    """Distinct seeded batches of a training batch's arrays: images f32,
    boxes f32, labels int32."""
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(b, size, size, 3)).astype(np.float32),
             rng.uniform(0, 1, (b, m, 4)).astype(np.float32),
             rng.integers(-1, 20, (b, m)).astype(np.int32))
            for _ in range(n)]


def test_device_prefetch_equals_host_batches_under_a_writing_consumer(dev):
    """The consumer's stream is held up (a device sleep) and then writes
    into every batch it was handed: a batch read before its copy ended, or
    a buffer handed to a later copy while the consumer still had work on
    it, would show as a batch unequal to the host's."""
    from yolo_nano_tpu_torch.data.loader import device_prefetch

    host = _host_batches()
    seen = []
    for batch in device_prefetch(iter(host), size=2, device=dev):
        torch.cuda._sleep(2_000_000)   # about a millisecond on the card
        seen.append(tuple(t.clone() for t in batch))
        for t in batch:
            t.fill_(-7)
        del batch
    torch.cuda.synchronize()
    assert len(seen) == len(host)
    for got, want in zip(seen, host):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), torch.from_numpy(w))


def test_device_prefetch_makes_no_host_sync(dev):
    from yolo_nano_tpu_torch.data.loader import device_prefetch

    host = _host_batches(n=6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = [tuple(t.sum() for t in batch)
               for batch in device_prefetch(iter(host), size=2, device=dev)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for sums, batch in zip(out, host):
        for s, a in zip(sums, batch):
            assert s.item() == torch.from_numpy(a).to(dev).sum().item()


def test_device_prefetch_stages_in_pinned_memory(dev, monkeypatch):
    from yolo_nano_tpu_torch.data import loader

    staged = []

    def pin_spy(batch):
        out = loader_pin(batch)
        staged.append(out)
        return out

    loader_pin = loader.pin_batch
    monkeypatch.setattr(loader, "pin_batch", pin_spy)
    host = _host_batches(n=3)
    out = list(loader.device_prefetch(iter(host), size=2))
    assert len(staged) == 3
    assert all(t.is_pinned() for batch in staged for t in batch)
    for batch, want in zip(out, host):
        for t, a in zip(batch, want):
            assert t.is_cuda and t.dtype == torch.from_numpy(a).dtype
