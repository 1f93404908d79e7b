"""NanoDet-Plus on the port's path, against the benchmark's plain reference
(`benchmark/reference/nanodet_plus.py`, written from NanoDet's code and
not from the port), on seeded weights at a small size: 1.5x widths, 96 and
128 px, batch 2, all four levels.

Tolerances: head outputs in f32 within 2e-5·max|ref| + 1e-5 (the port's
and the reference's convolutions sum in their own orders; the unfolded
port's BN is one more rounding); the plain 5×5 pair and the LeakyReLU
stage against their unfused units within 1e-6·max + 1e-7 in f32 and one
bf16 ulp of max in bf16. The `cuda`-marked tests need an NVIDIA GPU with
nvcc (sm_90a) and skip elsewhere.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import model as ref_model
from benchmark.reference import nanodet_plus as ref_nanodet
from yolo_nano_tpu_torch.config import NanoDetPlusConfig
from yolo_nano_tpu_torch.convert import (build_model, load_model, load_npz,
                                         save_npz, tree_from_model)
from yolo_nano_tpu_torch.models import nanodet_plus as nd
from yolo_nano_tpu_torch.ops.kernels import fused_conv, fused_stage
from yolo_nano_tpu_torch.ops.nms import select_topk, stable_topk
from yolo_nano_tpu_torch.ops.nn import ConvUnit
from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn

ARTIFACT = "yolo_nano_tpu_torch/assets/nanodet_plus_m_1.5x_416_seed0.npz"
CFG = NanoDetPlusConfig()


def _close(got, want, rel=2e-5, abs_=1e-5):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.abs().max().item() + abs_, err


def _seeded_tree(seed=0):
    """NanoDet's init, then every BN drawn (scale, bias, running mean and
    var) and the head's output scaled up, so that the folded weights are
    not the init's and the scores spread over the scenes."""
    gen = torch.Generator().manual_seed(seed)
    params, stats = nd.init_nanodet_plus_tree(gen, CFG)

    def draw(p, s):
        if isinstance(p, dict) and "scale" in p:
            n = p["scale"].shape[0]
            p["scale"] = (0.75 + 0.5 * torch.rand(n, generator=gen)).numpy()
            p["bias"] = (0.5 + torch.rand(n, generator=gen)).numpy()
            s["mean"] = (0.3 * torch.randn(n, generator=gen)).numpy()
            s["var"] = (0.5 + torch.rand(n, generator=gen)).numpy()
        elif isinstance(p, dict):
            for k in p:
                if isinstance(p[k], (dict, list)) and s is not None \
                        and k in s:
                    draw(p[k], s[k])
        elif isinstance(p, list):
            for a, b in zip(p, s):
                draw(a, b)

    draw(params, stats)
    for out in params["head"]["gfl_cls"]:
        out["w"] = out["w"] * 12.0
        out["b"][:CFG.num_classes] = -6.2
    return params, stats


@pytest.fixture(scope="module")
def models():
    """(unfolded, folded) f32 models of one seeded tree, and the folded
    units the reference takes."""
    unfolded = build_model(*_seeded_tree(), CFG)
    folded = fold_bn(unfolded)
    named = {k: v.detach() for k, v in folded.named_parameters()}
    return unfolded, folded, ref_model.units_from_named(named)


def _images(n, size, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, size, size, 3, generator=gen)


@pytest.mark.parametrize("size", [96, 128])
def test_forwards_match_the_reference(models, size):
    unfolded, folded, units = models
    x = _images(2, size, size)
    with torch.no_grad():
        want_cls, want_reg, sides = ref_nanodet.Forward(units, 80)(x)
        assert list(sides) == list(CFG.level_sides(size))
        for model in (unfolded, folded):
            cls, reg = model(x)
            assert cls.shape == (2, CFG.num_predictions(size), 80)
            _close(cls, want_cls)
            _close(reg, want_reg)


def _reference(units, x, point):
    """The reference's (pair probabilities, boxes, candidates) of x."""
    fwd = ref_nanodet.Forward(units, 80)
    with torch.no_grad():
        cls, reg, sides = fwd(x)
        pri = ref_nanodet.priors(CFG.strides, sides, "cpu")
        probs, boxes = ref_nanodet.dense(cls, reg, pri, x.shape[1])
    return probs, boxes, ref_nanodet.candidates(
        probs, boxes, point["conf_thresh"], point["nms_thresh"],
        point["pre_topk"])


POINT = {"conf_thresh": 0.05, "nms_thresh": 0.6, "pre_topk": 1000,
         "max_det": 100}


def test_detections_equal_the_reference_at_the_cells_point(models):
    """Folded f32 predict against the reference's candidates and NMS at the
    cell's point (conf 0.05, IoU 0.6, 1,000 pairs, 100 kept), by the cell's
    own numbers: every detection on a reference row of its class and every
    candidate pair matched or suppressed and no kept pair lost, to f32
    rounding (the near ties of this seeded model's many similar scores read
    their margins, 1e-5)."""
    from benchmark.drivers.detect_nanodet import detection_numbers

    _, folded, units = models
    x = _images(2, 128, 7)
    out = nd.predict(folded, x, CFG, 128)
    assert out[0].shape == (2, 100, 4) and out[3].dtype == torch.bool
    probs, boxes, cands = _reference(units, x, POINT)
    kept = [int(c.kept.sum()) for c in cands]
    assert min(kept) >= 20 and abs(int(out[3].sum()) - sum(kept)) <= 2
    nums, _ = detection_numbers(tuple(t.numpy() for t in out), probs, boxes,
                                cands, POINT)
    assert nums["det_gap"] < 1e-5 and nums["det_select"] < 1e-5, nums
    assert nums["det_lost"] < 1e-5, nums


def _units(gen, c, cout, k, act_mid, act_out, dtype=torch.float32):
    dw = ConvUnit(torch.randn(c, 1, k, k, generator=gen) * 0.3,
                  torch.randn(c, generator=gen) * 0.2, groups=c,
                  act=act_mid)
    pw = ConvUnit(torch.randn(cout, c, 1, 1, generator=gen) / c ** 0.5,
                  torch.randn(cout, generator=gen) * 0.2, act=act_out)
    return dw.to(dtype), pw.to(dtype)


@pytest.mark.parametrize("acts", [("leaky", "leaky"), (None, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_dw_pw_5x5_equals_its_units(acts, dtype):
    """The 5×5 pair's plain version (the CPU operator) against a dw 5×5
    unit then a 1×1 unit, C ≠ Cout, at the heads' and the shortcuts'
    activation pairs."""
    gen = torch.Generator().manual_seed(5)
    c, cout = 40, 24
    dw, pw = _units(gen, c, cout, 5, *acts)
    x = torch.randn(2, c, 11, 9, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    pair = nd.DwPw(dw, pw)
    assert pair.fused
    with torch.no_grad():
        got = pair(x)
        want = pw(dw(x)) if dtype == torch.float32 else None
        if dtype == torch.bfloat16:  # the function's rounding points
            dwf, pwf = dw.float(), pw.float()
            mid = dwf(x.float()).to(dtype).float()
            want = pwf(mid).to(dtype)
    assert got.shape == (2, cout, 11, 9) and got.dtype == dtype
    assert fused_conv.fused_dw_pw.launches_k5 == 0  # plain on the CPU
    if dtype == torch.float32:
        _close(got, want, rel=1e-6, abs_=1e-7)
    else:
        ulp = 2.0 ** -7 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= ulp


def test_dw_pw_takes_3x3_and_5x5_only():
    x = torch.zeros(1, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    for k in (1, 7):
        with pytest.raises(ValueError, match="k in"):
            fused_conv.fused_dw_pw(x, torch.zeros(k, k, 8), torch.zeros(8),
                                   torch.zeros(8, 8), torch.zeros(8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_leaky_stage_equals_unfused_blocks(models, dtype):
    """stage3 of the folded 1.5x backbone (c2 = 176): the LeakyReLU stage's
    plain version (fused_stage on the CPU) against its blocks' units."""
    _, folded, _ = models
    stage = folded.backbone.stage3
    if dtype == torch.bfloat16:
        from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

        stage = cast_f32_to_bf16(stage)
    assert fused_stage.stage_act(stage) == "leaky"
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 176, 9, 7, generator=gen).abs().to(dtype).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = stage(x)
        want = x
        for blk in stage:
            want = blk(want)
    assert got.shape == (2, 352, 5, 4)
    if dtype == torch.float32:
        _close(got, want, rel=1e-6, abs_=1e-7)
        w = fused_stage.prepare_stage(stage)
        relu = fused_stage.fused_stage_plain(x, w, act="relu")
        assert not torch.equal(relu, got)  # the activation reaches it
    else:  # units round the conv and the bias apart, the block once
        ulp = 2.0 ** -7 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 2 * ulp


def test_pair_selection_keeps_pair_order_on_ties():
    """Equal scores are taken in pair order (prior·C + class), across
    priors and classes, and the -1 padding below conf never precedes a
    pair above it; select_topk is stable_topk."""
    b, n, c = 2, 30, 5
    logits = torch.full((b, n, c), -9.0)
    tied = [(3, 4), (1, 2), (3, 0), (0, 4), (20, 1)]
    for prior, cls in tied:
        logits[0, prior, cls] = 0.0  # sigmoid 0.5, all equal
    logits[1, 7, 3] = 1.0
    logits[1, 2, 2] = 0.0
    ranked = torch.where(torch.sigmoid(logits) > 0.05, torch.sigmoid(logits),
                         -1.0).reshape(b, n * c)
    for k in (3, 5, 8, n * c):
        got, want = select_topk(ranked, k), stable_topk(ranked, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    top, pair = select_topk(ranked, 6)
    assert pair[0, :5].tolist() == sorted(p * c + k for p, k in tied)
    assert top[0, 5] == -1.0 and pair[0, 5] == 0  # padding, in index order
    assert pair[1, :2].tolist() == [7 * c + 3, 2 * c + 2]
    cfg = NanoDetPlusConfig(nms_pre_topk=4, max_detections=6)
    reg = torch.zeros(b, n, 32)
    boxes, scores, classes, valid = nd.postprocess(logits, reg, cfg, 64)
    assert valid[0].sum() == 4  # the cut at pre-top-k: pairs 0·5+4 .. 3·5+4
    assert classes[0][valid[0]].tolist() == [4, 2, 0, 4]


def test_the_artifact_round_trips_through_load_predictor(tmp_path):
    """The committed artifact: meta, bf16 leaves, a save/load round trip
    bit for bit, and `load_predictor` (CPU) giving fixed-shape detections
    that match the reference's at bf16 precision."""
    from yolo_nano_tpu_torch.serving import load_predictor

    tree, meta = load_npz(ARTIFACT)
    assert meta["model"] == "nanodet_plus" and meta["dtype"] == "bfloat16"
    model, cfg, _ = load_model(ARTIFACT)
    assert isinstance(cfg, NanoDetPlusConfig) and cfg.nms_pre_topk == 1000
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    path = str(tmp_path / "again.npz")
    save_npz(path, tree_from_model(model), meta)
    again, _ = load_npz(path)
    from yolo_nano_tpu_torch.convert import flatten_tree

    a, b = flatten_tree(tree), flatten_tree(again)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    predict = load_predictor(ARTIFACT, device="cpu")
    from benchmark import scenes

    x = scenes.render(2, 416, 9, "cpu")
    boxes, scores, classes, valid = predict(x.numpy())
    assert boxes.shape == (2, 100, 4) and classes.dtype == np.int32
    assert valid.sum(1).min() >= 10
    from benchmark.drivers.detect_nanodet import detection_numbers

    units, _ = ref_model.load_folded(ARTIFACT)
    probs, rboxes, cands = _reference(units, x, POINT)
    nums, _ = detection_numbers((boxes, scores, classes, valid), probs,
                                rboxes, cands, POINT)
    assert nums["det_gap"] < 0.03 and nums["det_select"] < 0.03, nums
    assert nums["det_lost"] < 0.1, nums


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from yolo_nano_tpu_torch.ops.nn import set_full_f32

    set_full_f32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout,acts,side", [
    (128, 128, ("leaky", "leaky"), 13), (256, 128, (None, None), 26),
    (40, 24, ("leaky", None), 9)])
def test_cuda_dw_pw_5x5_against_plain(dev, dtype, c, cout, acts, side):
    """The 5×5 kernels (fused_dw_pw5_kernel, fused_dw_pw5_bf16_kernel)
    against their plain version: f32 within 1e-4·max + 1e-5, bf16 within
    an ulp of max and 99% bit-equal; the launch counted as k = 5."""
    gen = torch.Generator().manual_seed(c + cout)
    pair = nd.DwPw(*_units(gen, c, cout, 5, *acts, dtype=dtype))
    x = torch.randn(3, c, side, side + 3, generator=gen)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = pair(x)  # the plain version, on the CPU
        before = fused_conv.fused_dw_pw.launches_k5
        got = pair.to(dev)(x.to(dev)).cpu()
    assert fused_conv.fused_dw_pw.launches_k5 == before + 1
    if dtype == torch.float32:
        _close(got, want, rel=1e-4, abs_=1e-5)
    else:
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= 2.0 ** -7 * want.float().abs().max()
        assert (diff == 0).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_leaky_stages_against_plain(dev, models, dtype):
    """The three LeakyReLU stages of the folded 1.5x backbone (stage 4 at
    c2 = 352: the bf16 kernel's wide variant) against their plain
    version, block by block; launches counted as leaky."""
    from yolo_nano_tpu_torch.utils.fuse_bn import cast_f32_to_bf16

    _, folded, _ = models
    bb = folded.backbone if dtype == torch.float32 else cast_f32_to_bf16(
        folded.backbone)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(4, 24, 30, 26, generator=gen).abs().to(dtype).contiguous(
        memory_format=torch.channels_last)
    for name in ("stage2", "stage3", "stage4"):
        blocks = fused_stage.prepare_stage(getattr(bb, name))
        lib = fused_stage._lib(dtype)
        for w in blocks:
            want = fused_stage.block_plain(x, w, act="leaky")
            wd = {k: v if k == "stride" else v.to(dev) for k, v in w.items()}
            before = fused_stage.fused_stage.launches_leaky
            got = fused_stage._launch_block(lib, x.to(dev), wd,
                                            act="leaky").cpu()
            assert fused_stage.fused_stage.launches_leaky == before + 1
            if dtype == torch.float32:
                _close(got, want, rel=1e-4, abs_=1e-5)
            else:
                diff = (got.float() - want.float()).abs()
                assert diff.max() <= 2.0 ** -7 * want.float().abs().max()
                assert (diff == 0).float().mean().item() >= 0.99
            x = want


@pytest.mark.cuda
def test_cuda_predict_issues_no_synchronize(dev):
    """The artifact through load_predictor on the card: 3 LeakyReLU stage
    calls (16 launches), 12 5×5 pairs and 1 NMS launch a predict, with no
    host synchronize inside it, and detections equal to the plain path's
    within bf16 rounding."""
    from benchmark import scenes
    from yolo_nano_tpu_torch.ops.kernels.nms_greedy import nms_greedy
    from yolo_nano_tpu_torch.serving import load_predictor

    predict = load_predictor(ARTIFACT, device=dev)
    x = scenes.render(8, 416, 21, dev)
    predict(x)  # builds the kernels and the prior table
    torch.cuda.synchronize()
    counters = (fused_stage.fused_stage, "launches_leaky"), (
        fused_stage.fused_stage, "calls"), (
        fused_conv.fused_dw_pw, "launches_k5"), (nms_greedy, "launches")
    before = [getattr(f, k) for f, k in counters]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = predict(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = [getattr(f, k) - b for (f, k), b in zip(counters, before)]
    assert got == [16, 3, 12, 1]
    assert out[0].shape == (8, 100, 4) and out[0].device.type == "cuda"
