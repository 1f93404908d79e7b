"""NanoDet-Plus detector: ShuffleNetV2 (LeakyReLU) + GhostPAN + a GFL head
a level (RangiLyu/nanodet, `nanodet/model/fpn/ghost_pan.py`,
`nanodet/model/head/nanodet_plus_head.py`).

Public functions keep YOLO-Nano's contract: images [B,S,S,3] NHWC in the
model's dtype; `predict` returns (boxes [B,D,4] normalized x1y1x2y2, scores
[B,D], classes [B,D] int32, valid [B,D] bool), scored and decoded in f32.
Inside, tensors are NCHW in channels_last memory. `act` is LeakyReLU(0.1).

  * backbone: ShuffleNetV2 (stem, stages 2-4, no conv5), LeakyReLU in the
    stem and both branches of every block;
  * GhostPAN: `reduce_layers[i]` 1×1 + act to the neck width; top-down
    inner = GhostBottleneck(cat[bilinear 2× up(high), low]); bottom-up
    out = GhostBottleneck(cat[DWConv/s2(low), high]); one extra level
    DWConv/s2(reduced c5) + DWConv/s2(last out). A DWConv (NanoDet's
    DepthwiseConvModule) is dw k×k + act then 1×1 + act (`DwPw`);
  * GhostBottleneck(2n → n, dw k, stride 1, no SE): ghost1 = GhostModule
    (primary 1×1 to n/2 + act, cheap dw3×3 + act, concatenated), ghost2 the
    same without act; plus the shortcut dw k×k → 1×1 (no act);
  * head: per level two DWConv (k×k) pairs, then a 1×1 to num_classes +
    4·(reg_max + 1) channels, [class logits | distances' bins]. Rows are
    level-concatenated, y-major: n = level_offset + y·side + x.

Postprocess (NanoDet's `get_bboxes` + `multiclass_nms`, at a fixed shape):
sigmoid(class logit) of every (prior, class) pair in f32, strictly above
`conf_thresh` (the span `ynt.pairs` with the selection); the `nms_pre_topk`
best pairs, equal scores in pair order (pair = prior·C + class,
`ops.nms.select_topk`); the survivors' boxes by the distribution's
integral (`ynt.decode`); class-offset greedy NMS (`ops.nms`).

Folded, each stage is one `fused_stage` call with LeakyReLU, and each
stride-1 DWConv pair and GhostBottleneck shortcut one `fused_dw_pw` call
at k = 5 (twelve a forward); the stem, the reduce 1×1s, the ghost modules,
the stride-2 DWConvs and the head's 1×1 outputs run on cuDNN.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_nano_tpu_torch.config import NanoDetPlusConfig
from yolo_nano_tpu_torch.models.shufflenetv2 import (ShuffleNetV2,
                                                     init_shufflenetv2)
from yolo_nano_tpu_torch.ops.decode import decode_distances, prior_rows
from yolo_nano_tpu_torch.ops.kernels.fused_conv import fused_dw_pw
from yolo_nano_tpu_torch.ops.nms import nms_on_candidates, select_topk
from yolo_nano_tpu_torch.ops.nn import ConvUnit, init_bn, set_full_f32
from yolo_nano_tpu_torch.utils.spans import span

LEAKY = "leaky"


class DwPw(nn.Module):
    """dw k×k (+ act_mid) → 1×1 (+ act_out), each a conv unit. Folded at
    stride 1 it is one `fused_dw_pw` call: on the card the CUDA kernel, on
    the CPU its plain version; otherwise the two units."""

    def __init__(self, dw: ConvUnit, pw: ConvUnit):
        super().__init__()
        self.dw, self.pw = dw, pw
        self._kernel_weights = None

    @property
    def fused(self) -> bool:
        return self.dw.stride == 1 and not (self.dw.has_bn or self.pw.has_bn)

    def _apply(self, fn, *args, **kwargs):
        self._kernel_weights = None  # .to()/.cuda() move the weights
        return super()._apply(fn, *args, **kwargs)

    def _pair(self):
        """Kernel layouts: dw [k,k,C], dw_b, pw [C,Cout], pw_b; dw_w, dw_b
        and pw_b in f32 (bf16 ones widened, which is exact), pw_w in the
        weights' dtype."""
        if self._kernel_weights is None:
            dw, pw = self.dw, self.pw
            self._kernel_weights = (
                dw.weight[:, 0].permute(1, 2, 0).float().contiguous(),
                dw.bias.float(), pw.weight[:, :, 0, 0].t().contiguous(),
                pw.bias.float())
        return self._kernel_weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self.pw(self.dw(x))
        dw_w, dw_b, pw_w, pw_b = self._pair()
        if pw_w.dtype != x.dtype:  # no op on the weights otherwise
            pw_w = pw_w.to(x.dtype)
        return fused_dw_pw(x.contiguous(memory_format=torch.channels_last),
                           dw_w, dw_b, pw_w, pw_b, act_mid=self.dw.act,
                           act_out=self.pw.act)


class GhostModule(nn.Module):
    """primary 1×1 → x1; cheap dw3×3 of x1 → x2; cat[x1, x2]."""

    def __init__(self, primary: ConvUnit, cheap: ConvUnit):
        super().__init__()
        self.primary, self.cheap = primary, cheap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary(x)
        return torch.cat([x1, self.cheap(x1)], 1)


class GhostBottleneck(nn.Module):
    """ghost2(ghost1(x)) + shortcut(x), stride 1, no SE."""

    def __init__(self, ghost1: GhostModule, ghost2: GhostModule,
                 shortcut: DwPw):
        super().__init__()
        self.ghost1, self.ghost2, self.shortcut = ghost1, ghost2, shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ghost2(self.ghost1(x)) + self.shortcut(x)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode="bilinear"): half-pixel centres."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class GhostPAN(nn.Module):
    def __init__(self, reduce_layers, top_down_blocks, downsamples,
                 bottom_up_blocks, extra_in: DwPw, extra_out: DwPw):
        super().__init__()
        self.reduce_layers = nn.ModuleList(reduce_layers)
        self.top_down_blocks = nn.ModuleList(top_down_blocks)
        self.downsamples = nn.ModuleList(downsamples)
        self.bottom_up_blocks = nn.ModuleList(bottom_up_blocks)
        self.extra_in, self.extra_out = extra_in, extra_out

    def forward(self, feats) -> List[torch.Tensor]:
        inputs = [r(f) for r, f in zip(self.reduce_layers, feats)]
        n = len(inputs)
        inner = [inputs[-1]]
        for i in range(n - 1, 0, -1):  # top-down
            block = self.top_down_blocks[n - 1 - i]
            inner.insert(0, block(torch.cat(
                [upsample2x_bilinear(inner[0]), inputs[i - 1]], 1)))
        outs = [inner[0]]
        for i in range(n - 1):  # bottom-up
            outs.append(self.bottom_up_blocks[i](torch.cat(
                [self.downsamples[i](outs[-1]), inner[i + 1]], 1)))
        outs.append(self.extra_in(inputs[-1]) + self.extra_out(outs[-1]))
        return outs


class GFLHead(nn.Module):
    """Per level: two DWConv pairs (`cls_convs[level]`), then the 1×1
    `gfl_cls[level]`; levels not shared."""

    def __init__(self, cls_convs, gfl_cls):
        super().__init__()
        self.cls_convs = nn.ModuleList(nn.ModuleList(c) for c in cls_convs)
        self.gfl_cls = nn.ModuleList(gfl_cls)

    def forward(self, feats) -> torch.Tensor:
        """→ [B, N, num_classes + 4·(reg_max + 1)], rows level by level."""
        rows = []
        for feat, convs, out in zip(feats, self.cls_convs, self.gfl_cls):
            for conv in convs:
                feat = conv(feat)
            pred = out(feat)
            b, ch, h, w = pred.shape
            rows.append(pred.permute(0, 2, 3, 1).reshape(b, h * w, ch))
        return torch.cat(rows, 1)


class NanoDetPlus(nn.Module):
    """Module names are the parameter tree's: backbone, fpn, head."""

    def __init__(self, cfg: NanoDetPlusConfig, backbone: ShuffleNetV2,
                 fpn: GhostPAN, head: GFLHead):
        super().__init__()
        self.cfg = cfg
        self.backbone, self.fpn, self.head = backbone, fpn, head

    def forward(self, images: torch.Tensor):
        """images [B,H,W,3] → (class logits [B,N,C], distance bins
        [B,N,4·(reg_max+1)]) in the model's dtype; the span `ynt.forward`."""
        with span("ynt.forward"):
            x = images.permute(0, 3, 1, 2)  # NHWC bytes = NCHW channels_last
            out = self.head(self.fpn(self.backbone(x)))
            c = self.cfg.num_classes
            return out[..., :c], out[..., c:]


def forward_features(model: NanoDetPlus, images: torch.Tensor):
    return model(images)


def postprocess(cls_logits, reg, cfg: NanoDetPlusConfig, input_size: int):
    """Head outputs → fixed-shape detections: multi-label pairs above
    conf_thresh, the nms_pre_topk best, their boxes, class-offset NMS."""
    b, n, c = cls_logits.shape
    k = min(cfg.nms_pre_topk, n * c)
    with span("ynt.pairs"):
        score = torch.sigmoid(cls_logits.float()).reshape(b, n * c)
        ranked = torch.where(score > cfg.conf_thresh, score,
                             torch.full_like(score, -1.0))
        top_score, pair = select_topk(ranked, k)
        prior = torch.div(pair, c, rounding_mode="floor")
        top_cls = pair - prior * c
    with span("ynt.decode"):
        bins = reg.shape[-1]
        reg_k = torch.gather(reg, 1, prior[..., None].expand(b, k, bins))
        rows = prior_rows(cfg.strides, cfg.level_sides(input_size),
                          prior.device)
        rows_k = torch.index_select(rows, 0, prior.reshape(-1)).reshape(
            b, k, 3)
        boxes = decode_distances(reg_k.float(), rows_k, input_size)
    return nms_on_candidates(boxes, top_score, top_cls,
                             iou_thresh=cfg.nms_thresh,
                             max_det=cfg.max_detections, diou=cfg.diou_nms)


def detect(model: NanoDetPlus, images: torch.Tensor, cfg: NanoDetPlusConfig,
           input_size: int):
    """forward → pairs → top-k → decode → NMS; the postprocess is the span
    `ynt.postprocess`."""
    cls_logits, reg = model(images)
    with span("ynt.postprocess"):
        return postprocess(cls_logits, reg, cfg, input_size)


@torch.inference_mode()
def predict(model: NanoDetPlus, images: torch.Tensor, cfg: NanoDetPlusConfig,
            input_size: int):
    """Batched inference: images [B,S,S,3] → (boxes [B,D,4], scores [B,D],
    classes [B,D] int32, valid [B,D] bool), all on the images' device."""
    set_full_f32()
    return detect(model, images, cfg, input_size)


# ---------------------------------------------------------------------------
# init (NanoDet's own) and the tree's layout
# ---------------------------------------------------------------------------

def _kaiming(gen, k, cin, cout, groups=1):
    """nanodet's kaiming_init: N(0, 2 / fan_out), fan_out = cout·k·k (the
    gain of leaky_relu at a = 0), no bias (a BN follows)."""
    std = math.sqrt(2.0 / (cout * k * k))
    return {"w": (std * torch.randn((k, k, cin // groups, cout),
                                    generator=gen)).numpy()}


def _torch_default(gen, k, cin, cout, groups=1):
    """nn.Conv2d's default init (kaiming-uniform, a = √5), no bias."""
    fan_in = k * k * cin // groups
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((k, k, cin // groups, cout), generator=gen) * 2 - 1)
    return {"w": (w * bound).numpy()}


def _normal(gen, k, cin, cout, groups=1, std=0.01):
    return {"w": (std * torch.randn((k, k, cin // groups, cout),
                                    generator=gen)).numpy()}


def _bn(p, cout):
    bn_p, bn_s = init_bn(cout, bias_init=0.0)
    return {**p, **bn_p}, bn_s


def _dwpw(gen, init, cin, cout, k):
    """A DWConv pair's (params, stats): dw k×k on cin, then 1×1 to cout."""
    dw, dws = _bn(init(gen, k, cin, cin, groups=cin), cin)
    pw, pws = _bn(init(gen, 1, cin, cout), cout)
    return {"dw": dw, "pw": pw}, {"dw": dws, "pw": pws}


def _ghost(gen, cin, cout):
    half = math.ceil(cout / 2)
    p, s = {}, {}
    p["primary"], s["primary"] = _bn(_torch_default(gen, 1, cin, half), half)
    p["cheap"], s["cheap"] = _bn(_torch_default(gen, 3, half, half,
                                                groups=half), half)
    return p, s


def _bottleneck(gen, cin, cout, k):
    p, s = {}, {}
    p["ghost1"], s["ghost1"] = _ghost(gen, cin, cout)
    p["ghost2"], s["ghost2"] = _ghost(gen, cout, cout)
    p["shortcut"], s["shortcut"] = _dwpw(gen, _torch_default, cin, cout, k)
    return p, s


def init_nanodet_plus_tree(gen: torch.Generator, cfg: NanoDetPlusConfig):
    """→ (params, stats): JAX-layout trees of numpy arrays, drawn as
    NanoDet draws them: the backbone as `init_shufflenetv2`; GhostPAN's
    ConvModules and DWConvs by kaiming_init, its ghost modules and
    shortcuts by nn.Conv2d's default; the head's convs N(0, 0.01) and the
    output's bias −4.595; every BN scale 1, bias 0 (the backbone's 1e-4),
    running mean 0 and var 1."""
    bb_p, bb_s = init_shufflenetv2(gen, cfg.backbone)
    nc, k = cfg.neck_channels, cfg.kernel_size
    ins = cfg.backbone_channels[1:4]
    fpn_p, fpn_s = {}, {}
    reduce = [_bn(_kaiming(gen, 1, c, nc), nc) for c in ins]
    fpn_p["reduce_layers"] = [p for p, _ in reduce]
    fpn_s["reduce_layers"] = [s for _, s in reduce]
    for name in ("top_down_blocks", "downsamples", "bottom_up_blocks"):
        fpn_p[name], fpn_s[name] = [], []
    for _ in range(len(ins) - 1):
        p, s = _bottleneck(gen, 2 * nc, nc, k)
        fpn_p["top_down_blocks"].append(p)
        fpn_s["top_down_blocks"].append(s)
    for _ in range(len(ins) - 1):
        for name, (p, s) in (("downsamples", _dwpw(gen, _kaiming, nc, nc, k)),
                             ("bottom_up_blocks",
                              _bottleneck(gen, 2 * nc, nc, k))):
            fpn_p[name].append(p)
            fpn_s[name].append(s)
    for name in ("extra_in", "extra_out"):
        fpn_p[name], fpn_s[name] = _dwpw(gen, _kaiming, nc, nc, k)
    head_p = {"cls_convs": [], "gfl_cls": []}
    head_s = {"cls_convs": []}
    for _ in cfg.strides:
        pairs = [_dwpw(gen, _normal, nc, nc, k) for _ in range(2)]
        head_p["cls_convs"].append([p for p, _ in pairs])
        head_s["cls_convs"].append([s for _, s in pairs])
        out = _normal(gen, 1, nc, cfg.head_out_channels)
        out["b"] = np.full(cfg.head_out_channels, -4.595, np.float32)
        head_p["gfl_cls"].append(out)
    return ({"backbone": bb_p, "fpn": fpn_p, "head": head_p},
            {"backbone": bb_s, "fpn": fpn_s, "head": head_s})


def build_nanodet_plus(params: dict, stats: Optional[dict],
                       cfg: NanoDetPlusConfig) -> NanoDetPlus:
    """The whole detector from a JAX-layout tree; `stats` None for a folded
    tree."""
    from yolo_nano_tpu_torch.convert import _sub, build_shufflenetv2, conv_unit

    def unit(p, s, act=LEAKY, stride=1):
        return conv_unit(p, s, stride=stride, act=act)

    def dwpw(p, s, act=LEAKY, stride=1):
        return DwPw(unit(p["dw"], _sub(s, "dw"), act, stride),
                    unit(p["pw"], _sub(s, "pw"), act))

    def ghost(p, s, act):
        return GhostModule(unit(p["primary"], _sub(s, "primary"), act),
                           unit(p["cheap"], _sub(s, "cheap"), act))

    def bottleneck(p, s):
        return GhostBottleneck(ghost(p["ghost1"], _sub(s, "ghost1"), LEAKY),
                               ghost(p["ghost2"], _sub(s, "ghost2"), None),
                               dwpw(p["shortcut"], _sub(s, "shortcut"), None))

    fp, fs = params["fpn"], _sub(stats, "fpn")

    def each(name, build, **kw):
        ss = _sub(fs, name)
        return [build(p, None if ss is None else ss[i], **kw)
                for i, p in enumerate(fp[name])]

    fpn = GhostPAN(each("reduce_layers", unit),
                   each("top_down_blocks", bottleneck),
                   each("downsamples", dwpw, stride=2),
                   each("bottom_up_blocks", bottleneck),
                   dwpw(fp["extra_in"], _sub(fs, "extra_in"), stride=2),
                   dwpw(fp["extra_out"], _sub(fs, "extra_out"), stride=2))
    hp, hs = params["head"], _sub(stats, "head")
    convs = [[dwpw(p, None if hs is None else hs["cls_convs"][li][j])
              for j, p in enumerate(level)]
             for li, level in enumerate(hp["cls_convs"])]
    head = GFLHead(convs, [unit(p, None, act=None) for p in hp["gfl_cls"]])
    backbone = build_shufflenetv2(params["backbone"],
                                  _sub(stats, "backbone"), act=LEAKY)
    return NanoDetPlus(cfg, backbone, fpn, head).eval()
