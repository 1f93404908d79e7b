"""Port parity: ops/nn primitives, fold_bn, decode and NMS against the JAX
package on the same numpy inputs (CPU).

Tolerances: data movement (shuffle, pool, resampling, gathers) is exact;
f32 arithmetic rtol 1e-4, atol 1e-5 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_nano_tpu.config import MULTI_ANCHOR_SIZE_COCO as JAX_ANCHORS_COCO
from yolo_nano_tpu.config import YoloNanoConfig as JaxConfig
from yolo_nano_tpu.ops import decode as jdecode
from yolo_nano_tpu.ops import nms as jnms
from yolo_nano_tpu.ops import nn as jnn
from yolo_nano_tpu_torch import config as tconfig
from yolo_nano_tpu_torch.convert import conv_unit
from yolo_nano_tpu_torch.ops import decode as tdecode
from yolo_nano_tpu_torch.ops import nms as tnms
from yolo_nano_tpu_torch.ops.kernels import nms_greedy as tknms
from yolo_nano_tpu_torch.ops import nn as tnn
from yolo_nano_tpu_torch.utils.fuse_bn import fold_bn

F32 = dict(rtol=1e-4, atol=1e-5)


def nchw(x):
    """numpy NHWC → torch NCHW (channels_last memory)."""
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_config_copy_matches_jax():
    assert tconfig.MULTI_ANCHOR_SIZE_COCO == JAX_ANCHORS_COCO
    from yolo_nano_tpu import config as jconfig

    assert tconfig.MULTI_ANCHOR_SIZE == jconfig.MULTI_ANCHOR_SIZE
    assert tconfig.SHUFFLENETV2_CHANNELS == jconfig.SHUFFLENETV2_CHANNELS
    assert tconfig.SHUFFLENETV2_REPEATS == jconfig.SHUFFLENETV2_REPEATS
    import dataclasses

    jfields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tfields = {f.name: f.default
               for f in dataclasses.fields(tconfig.YoloNanoConfig)}
    assert jfields == tfields
    cfg = tconfig.YoloNanoConfig(num_classes=80)
    jcfg = JaxConfig(num_classes=80)
    assert cfg.num_predictions(416) == jcfg.num_predictions(416) == 10647
    assert cfg.head_out_channels == jcfg.head_out_channels


@pytest.mark.parametrize("groups", [2, 3])
def test_channel_shuffle_mapping(groups):
    x = np.random.default_rng(0).normal(size=(2, 5, 4, 12)).astype(np.float32)
    want = np.asarray(jnn.channel_shuffle(jnp.asarray(x), groups))
    got = tnn.channel_shuffle(nchw(x), groups)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(got), want)
    # out[j·g + i] = in[i·C/g + j]
    c = 12
    for i in range(groups):
        for j in range(c // groups):
            np.testing.assert_array_equal(nhwc(got)[..., j * groups + i],
                                          x[..., i * (c // groups) + j])


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_pool_and_resampling(hw):
    x = np.random.default_rng(2).normal(
        size=(2,) + hw + (5,)).astype(np.float32)
    xj = jnp.asarray(x)
    np.testing.assert_array_equal(nhwc(tnn.max_pool_3x3_s2(nchw(x))),
                                  np.asarray(jnn.max_pool_3x3_s2(xj)))
    np.testing.assert_array_equal(nhwc(tnn.upsample2x_nearest(nchw(x))),
                                  np.asarray(jnn.upsample2x_nearest(xj)))
    np.testing.assert_array_equal(nhwc(tnn.downsample2x_nearest(nchw(x))),
                                  np.asarray(jnn.downsample2x_nearest(xj)))


def test_activations():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    for act in (None, "relu", "leaky"):
        want = np.asarray(jnn._activate(jnp.asarray(x), act))
        np.testing.assert_array_equal(
            tnn.activate(torch.from_numpy(x), act).numpy(), want)


def _random_unit(rng, k, cin, cout, groups=1, bias=False, bn=True):
    p = {"w": rng.normal(0, 0.3, (k, k, cin // groups, cout)).astype(
        np.float32)}
    if bias:
        p["b"] = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    s = None
    if bn:
        p["scale"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
        s = {"mean": rng.normal(0, 0.2, cout).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}
    return p, s


@pytest.mark.parametrize("k,stride,groups,bias,act", [
    (3, 2, 1, False, "relu"),      # stem
    (3, 1, 8, False, None),        # depthwise, stride 1
    (3, 2, 8, False, None),        # depthwise, stride 2
    (1, 1, 1, True, "leaky"),      # neck 1×1 with bias
    (3, 1, 1, True, "leaky"),      # smooth 3×3 with bias
])
def test_conv_unit_eval_bn_and_folded(k, stride, groups, bias, act):
    rng = np.random.default_rng(3)
    cin, cout = 8, (8 if groups > 1 else 6)
    p, s = _random_unit(rng, k, cin, cout, groups, bias)
    x = rng.normal(size=(2, 10, 10, cin)).astype(np.float32)
    want, _ = jnn.conv_bn(jnp.asarray(x), p, s, stride=stride, groups=groups,
                          act=act, train=False)
    unit = conv_unit(p, s, stride=stride, act=act)
    assert unit.groups == groups and unit.has_bn
    np.testing.assert_allclose(nhwc(unit(nchw(x))), np.asarray(want), **F32)
    # folded: JAX folds its tree, the port folds its module
    from yolo_nano_tpu.utils.fuse_bn import fold_bn as jfold

    jp = jfold(p, s)
    want_f, _ = jnn.conv_bn(jnp.asarray(x), jp, None, stride=stride,
                            groups=groups, act=act, train=False)
    folded = fold_bn(unit)
    assert not folded.has_bn
    np.testing.assert_allclose(nhwc(folded(nchw(x))), np.asarray(want_f),
                               **F32)


def test_fold_bn_matches_jax_fold_of_the_same_tree():
    """Whole detector: the port's module fold against the JAX tree fold.
    Same arithmetic in the same order, so the weights agree to 1 ulp."""
    from yolo_nano_tpu.models.yolo_nano import init_yolo_nano
    from yolo_nano_tpu.utils.fuse_bn import fold_bn as jfold

    from yolo_nano_tpu_torch.convert import build_yolo_nano, flatten_tree

    jcfg = JaxConfig(num_classes=3, backbone="0.5x")
    params, stats = init_yolo_nano(jax.random.key(1), jcfg)
    rng = np.random.default_rng(4)
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32), stats)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                         if path[-1].key == "scale" else a), params)
    want = flatten_tree(jax.tree.map(np.asarray, jfold(params, stats)))
    model = build_yolo_nano(params, stats, tconfig.YoloNanoConfig(
        num_classes=3, backbone="0.5x"))
    folded = fold_bn(model)
    assert any(m.has_bn for m in model.modules() if isinstance(m, tnn.ConvUnit))
    for key, w in want.items():
        path, leaf = key.rsplit("/", 1)
        unit = folded.get_submodule(path.replace("/", "."))
        assert not unit.has_bn
        got = (unit.weight.permute(2, 3, 1, 0) if leaf == "w"
               else unit.bias).detach().numpy()
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7, err_msg=key)


def _coco_cfgs(size):
    tcfg = tconfig.YoloNanoConfig(num_classes=80,
                                  anchors=tconfig.MULTI_ANCHOR_SIZE_COCO)
    jcfg = JaxConfig(num_classes=80, anchors=JAX_ANCHORS_COCO)
    return tcfg, jcfg


@pytest.mark.parametrize("size", [416, 224])
def test_decode_gathered_equals_decode_all_gathered(size):
    tcfg, jcfg = _coco_cfgs(size)
    rng = np.random.default_rng(5)
    cells = tcfg.num_cells(size)
    txty = rng.normal(0, 1.5, (2, cells, 3, 4)).astype(np.float32)
    n = cells * 3
    idx = np.stack([rng.choice(n, 64, replace=False) for _ in range(2)])
    idx[:, :3] = [0, n - 1, cells * 3 // 2]  # first, last, a middle level
    grids = tdecode.make_grids(tcfg, size)
    all_boxes = tdecode.decode_boxes(torch.from_numpy(txty), grids)
    idx_t = torch.from_numpy(idx)
    txty_k = torch.gather(torch.from_numpy(txty).reshape(2, n, 4), 1,
                          idx_t[..., None].expand(2, 64, 4))
    got = tdecode.decode_boxes_gathered(txty_k, idx_t, tcfg, size)
    want = torch.gather(all_boxes, 1, idx_t[..., None].expand(2, 64, 4))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # and against the JAX package
    jgrids = jdecode.make_grids(jcfg, size)
    for a, b in zip(grids, jgrids):
        np.testing.assert_array_equal(a.numpy(), b)
    jwant = np.asarray(jdecode.decode_boxes_gathered(
        jnp.asarray(txty_k.numpy()), jnp.asarray(idx), jcfg, size))
    np.testing.assert_allclose(got.numpy(), jwant, **F32)


def test_decode_rows_are_built_once_per_key():
    """decode's rows are kept per (config, size, device): the same tensor
    again, another at another size; each row is `make_grids`' cell, stride
    and anchor of that flat index."""
    tcfg, _ = _coco_cfgs(224)
    rows = tdecode.decode_rows(tcfg, 224, "cpu")
    assert tdecode.decode_rows(tcfg, 224, torch.device("cpu")) is rows
    assert tdecode.decode_rows(tcfg, 416, "cpu").shape == (
        tcfg.num_cells(416) * 3, 5)
    g = tdecode.make_grids(tcfg, 224)
    n = tcfg.num_cells(224)
    want = torch.cat([g.grid_xy.expand(n, 3, 2), g.stride.expand(n, 3, 1),
                      g.anchor_wh], -1).reshape(n * 3, 5)
    assert rows.dtype == torch.float32 and torch.equal(rows, want)


def test_stable_topk_breaks_ties_by_lower_index():
    x = np.array([0.5, 0.7, 0.5, 0.7, 0.5, -1, -1], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    vals, idx = tnms.stable_topk(torch.from_numpy(x), 5)
    assert idx.tolist() == [1, 3, 0, 2, 4] == np.asarray(jidx).tolist()
    np.testing.assert_array_equal(vals.numpy(), x[[1, 3, 0, 2, 4]])


def _sequential_greedy(boxes, valid, thresh, diou=False):
    """The reference sequential algorithm (one box at a time)."""
    ovr = np.asarray(jnms._pairwise_iou(jnp.asarray(boxes)))
    if diou:
        ovr = ovr - np.asarray(jnms._pairwise_diou_penalty(jnp.asarray(boxes)))
    keep = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if valid[i] and not any(keep[j] and ovr[j, i] > thresh
                                for j in range(i)):
            keep[i] = True
    return keep


def _candidates(rng, b, k, n_valid, ties=False):
    """Score-sorted candidates in clusters (real suppression chains)."""
    centers = rng.uniform(0.2, 0.8, (b, 6, 2))
    pick = rng.integers(0, 6, (b, k))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 0.01, (b, k, 2))
    wh = rng.uniform(0.1, 0.2, (b, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    score = np.sort(rng.uniform(0.05, 1, (b, k)), -1)[:, ::-1].astype(
        np.float32)
    if ties:
        score = np.round(score * 4) / 4  # many equal scores, still sorted
    score[:, n_valid:] = -1.0
    cls = rng.integers(0, 3, (b, k)).astype(np.int32)
    return boxes, np.ascontiguousarray(score), cls


def _host_fixpoint(boxes, valid, thresh, diou=False):
    """The port's sweeps as they ran before the operator: a Python loop
    ending on `torch.equal` of the keep sets."""
    boxes = torch.from_numpy(boxes)
    ovr = tknms._pairwise_iou(boxes)
    if diou:
        ovr = ovr - tknms._pairwise_diou_penalty(boxes)
    k = boxes.shape[-2]
    order = torch.arange(k)
    sup = (ovr > thresh) & (order[:, None] < order[None, :])
    valid = torch.from_numpy(valid)
    keep = valid
    for _ in range(k):
        new = valid & ~(sup & keep[..., :, None]).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _call_targets(module):
    """The targets of a traced module's operator calls other than views."""
    return [str(n.target) for n in module.graph.nodes
            if n.op == "call_function" and "view" not in str(n.target)
            and "reshape" not in str(n.target)]


class _Nms(torch.nn.Module):
    def __init__(self, diou):
        super().__init__()
        self.diou = diou

    def forward(self, boxes, valid):
        return tnms.nms_greedy(boxes, valid, 0.45, diou=self.diou)


@pytest.mark.parametrize("diou,ties,max_det,seed", [
    (False, False, 16, 6), (True, False, 16, 6), (False, True, 64, 6),
    (False, False, 48, 9), (True, True, 48, 10)])
def test_nms_on_candidates_matches_jax(diou, ties, max_det, seed):
    rng = np.random.default_rng(seed)
    boxes, score, cls = _candidates(rng, 3, 48, 40, ties)
    want = jnms.nms_on_candidates(
        jnp.asarray(boxes), jnp.asarray(score), jnp.asarray(cls),
        iou_thresh=0.45, max_det=max_det, diou=diou)
    got = tnms.nms_on_candidates(
        torch.from_numpy(boxes), torch.from_numpy(score),
        torch.from_numpy(cls), iou_thresh=0.45, max_det=max_det, diou=diou)
    assert got[0].shape == (3, max_det, 4)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the fixpoint reaches the sequential-greedy keep set
    shifted = boxes + cls[..., None].astype(np.float32) * 4.0
    keep = tnms.nms_greedy(torch.from_numpy(shifted),
                           torch.from_numpy(score >= 0), 0.45, diou=diou)
    for i in range(3):
        np.testing.assert_array_equal(
            keep[i].numpy(),
            _sequential_greedy(shifted[i], score[i] >= 0, 0.45, diou))
    # the keep sets are the old loop's, eagerly and as the one operator
    # call `yolo_nano_torch::nms_greedy` that an exported graph holds
    np.testing.assert_array_equal(
        keep.numpy(), _host_fixpoint(shifted, score >= 0, 0.45, diou).numpy())
    traced = torch.export.export(_Nms(diou), (
        torch.from_numpy(shifted), torch.from_numpy(score >= 0))).module()
    assert _call_targets(traced) == ["yolo_nano_torch.nms_greedy.default"]
    np.testing.assert_array_equal(
        traced(torch.from_numpy(shifted), torch.from_numpy(score >= 0)),
        keep.numpy())
    assert int(got[3].sum()) < 3 * 40 // 2  # suppression did real work


def test_nms_operator_is_registered_with_a_fake():
    """`yolo_nano_torch::nms_greedy` is an operator of the kernels' library;
    its fake gives valid's shape and dtype; the wrapper takes any leading
    dims and refuses what the operator does not take."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import yolo_nano_tpu_torch.ops.kernels as kernels

    op = torch.ops.yolo_nano_torch.nms_greedy.default
    assert kernels.PLAIN_VERSIONS[op] is tknms.nms_greedy_plain
    with FakeTensorMode() as mode:
        boxes = mode.from_tensor(torch.zeros(5, 33, 4))
        valid = mode.from_tensor(torch.ones(5, 33, dtype=torch.bool))
        keep = op(boxes, valid, 0.45, True)
    assert keep.shape == (5, 33) and keep.dtype == torch.bool
    rng = np.random.default_rng(3)
    boxes, score, _ = _candidates(rng, 6, 20, 16)
    grid = torch.from_numpy(boxes).reshape(2, 3, 20, 4)
    valid = torch.from_numpy(score >= 0).reshape(2, 3, 20)
    np.testing.assert_array_equal(
        tnms.nms_greedy(grid, valid, 0.45).reshape(6, 20),
        _host_fixpoint(boxes, score >= 0, 0.45))
    with pytest.raises(ValueError):
        tnms.nms_greedy(grid.double(), valid, 0.45)
    with pytest.raises(ValueError):
        tnms.nms_greedy(grid, valid[..., :-1], 0.45)


def test_nms_greedy_without_candidates_returns_a_new_tensor():
    """No valid candidate: the plain version's loop ends at once and keeps
    nothing, in a tensor of its own (an operator returns no alias of its
    input)."""
    boxes = torch.rand(2, 9, 4)
    valid = torch.zeros(2, 9, dtype=torch.bool)
    keep = tnms.nms_greedy(boxes, valid, 0.5)
    assert not keep.any() and keep.data_ptr() != valid.data_ptr()


@pytest.mark.parametrize("k", [2, 16])
def test_nms_greedy_on_a_chain_settles_one_candidate_a_sweep(k):
    """Each box overlaps its neighbours alone (IoU 0.67), so the keep set
    settles one candidate a sweep: the most sweeps that K candidates can
    take. The loop, which has no it < K cap, ends with the sequential
    greedy's keep set, eagerly and as the exported operator."""
    x = np.arange(k, dtype=np.float32) * 2
    boxes = np.stack([x, np.zeros(k), x + 10, np.full(k, 10)], -1).astype(
        np.float32)
    valid = np.ones(k, bool)
    want = _sequential_greedy(boxes, valid, 0.45)
    assert want.tolist() == [i % 2 == 0 for i in range(k)]
    args = (torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None])
    np.testing.assert_array_equal(tnms.nms_greedy(*args, 0.45)[0], want)
    traced = torch.export.export(_Nms(False), args).module()
    np.testing.assert_array_equal(traced(*args)[0], want)


def test_batched_nms_scored_matches_jax():
    rng = np.random.default_rng(7)
    boxes, _, cls = _candidates(rng, 2, 200, 200)
    score = rng.uniform(0, 0.3, (2, 200)).astype(np.float32)
    kw = dict(conf_thresh=0.1, iou_thresh=0.5, pre_topk=64, max_det=128)
    want = jnms.batched_nms_scored(jnp.asarray(boxes), jnp.asarray(score),
                                   jnp.asarray(cls), **kw)
    got = tnms.batched_nms_scored(torch.from_numpy(boxes),
                                  torch.from_numpy(score),
                                  torch.from_numpy(cls), **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the scores operator (`ops/kernels/scores.py`)
# ---------------------------------------------------------------------------

def _scores_expression(conf_pred, cls_pred):
    """The scores as `models.yolo_nano.scores_from_features` wrote them
    before they became an operator: the CPU implementation must give these
    bits."""
    obj = torch.sigmoid(conf_pred.float())[..., 0]
    logits = cls_pred.float()
    m = logits.max(-1).values
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
    score = torch.exp(m - lse) * obj
    cls = torch.argmax(logits, -1).to(torch.int32)
    return score, cls


def _head_outputs(seed, b, n, c, dtype):
    """conf [b,n,1] and cls [b,n,c] with tied maxima, a NaN row, +inf and
    -inf rows and a row of -inf alone, in `dtype`."""
    rng = np.random.default_rng(seed)
    conf = rng.normal(0, 3, (b, n, 1)).astype(np.float32)
    cls = rng.uniform(-8, 3, (b, n, c)).astype(np.float32)
    if c > 1 and n >= 6:
        cls[0, 0, [c // 2, c - 1]] = 5.0  # a tie: the first index
        cls[0, 1, c // 3] = np.nan
        cls[0, 2, [c // 4, c - 1]] = np.inf
        cls[0, 3, :] = -np.inf
        cls[0, 4, c // 2] = -np.inf
        conf[0, 5, 0] = np.nan
    return (torch.from_numpy(conf).to(dtype), torch.from_numpy(cls).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(1, 1, 1), (2, 7, 1), (2, 50, 80),
                                   (3, 21, 20), (1, 9, 81), (2, 6, 1000)])
def test_scores_on_the_cpu_are_the_expression_bit_for_bit(b, n, c, dtype):
    from yolo_nano_tpu_torch.models.yolo_nano import scores_from_features

    conf, cls = _head_outputs(b * 1009 + n * 31 + c, b, n, c, dtype)
    want = _scores_expression(conf, cls)
    got = scores_from_features(conf, cls)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got[1], want[1])
    if c > 1 and n >= 6:
        assert int(got[1][0, 0]) == c // 2 and int(got[1][0, 1]) == c // 3
        assert int(got[1][0, 2]) == c // 4 and int(got[1][0, 3]) == 0
        assert bool(got[0][0, 1:4].isnan().all())
        assert bool(got[0][0, 5].isnan()) and not bool(got[0][0, 4].isnan())


def test_scores_operator_is_registered_with_a_fake():
    """`yolo_nano_torch::scores` is an operator of the kernels' library
    whose plain version is `scores_plain`; its fake gives [B,N] f32 and
    int32 in either input dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import yolo_nano_tpu_torch.ops.kernels as kernels
    from yolo_nano_tpu_torch.ops.kernels import scores as tscores

    op = torch.ops.yolo_nano_torch.scores.default
    assert kernels.PLAIN_VERSIONS[op] is tscores.scores_plain
    for dtype in (torch.float32, torch.bfloat16):
        with FakeTensorMode() as mode:
            conf = mode.from_tensor(torch.zeros(5, 33, 1, dtype=dtype))
            cls = mode.from_tensor(torch.zeros(5, 33, 80, dtype=dtype))
            score, c = op(conf, cls)
        assert score.shape == (5, 33) and score.dtype == torch.float32
        assert c.shape == (5, 33) and c.dtype == torch.int32


@pytest.mark.parametrize("c", [1, 80])
def test_scores_return_no_alias(c):
    """The operator's outputs are tensors of their own, never a view of an
    input (an operator returns no alias), also at C = 1, where the score is
    the objectness alone."""
    from yolo_nano_tpu_torch.ops.kernels.scores import scores

    conf, cls = _head_outputs(c, 2, 9, c, torch.float32)
    inputs = {t.untyped_storage().data_ptr() for t in (conf, cls)}
    score, k = scores(conf, cls)
    assert not inputs & {t.untyped_storage().data_ptr() for t in (score, k)}
    if c == 1:
        assert not k.any()
        torch.testing.assert_close(score, torch.sigmoid(conf[..., 0]),
                                   rtol=0, atol=0)


def test_scores_refuse_what_the_operator_does_not_take():
    from yolo_nano_tpu_torch.ops.kernels.scores import scores

    conf, cls = _head_outputs(5, 2, 9, 20, torch.float32)
    for bad in ((conf.double(), cls.double()),       # dtype
                (conf, cls.bfloat16()),              # mixed dtypes
                (conf.half(), cls.half()),
                (conf[..., 0], cls),                 # shape
                (conf[:, :8], cls),
                (conf, cls[0]),
                (conf[:, :, :0], cls[:, :, :0]),     # no class
                (conf, cls.transpose(0, 1).contiguous().transpose(0, 1)),
                (conf.transpose(0, 1).contiguous().transpose(0, 1), cls)):
        with pytest.raises(ValueError):
            scores(*bad)


class _Scores(torch.nn.Module):
    def forward(self, conf, cls):
        from yolo_nano_tpu_torch.models.yolo_nano import scores_from_features

        return scores_from_features(conf, cls)


def test_scores_export_as_one_operator_call():
    conf, cls = _head_outputs(7, 2, 30, 80, torch.float32)
    traced = torch.export.export(_Scores(), (conf, cls)).module()
    assert [t for t in _call_targets(traced) if "getitem" not in t] == [
        "yolo_nano_torch.scores.default"]
    got = traced(conf, cls)
    want = _scores_expression(conf, cls)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got[1], want[1])
