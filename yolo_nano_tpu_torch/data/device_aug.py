"""In-graph training augmentation: the SSD chain as batched tensor ops on
the card, inside the training step. The port's copy of the JAX package's
`data/device_aug.py`, with its `vmap` over items written out as [B, …]
tensors.

Host workers only decode each image and letterbox it once into a uint8
base canvas (`data.base.DetectionDatasetBase._pull_item_device`); the
photometric distortion, the min-IoU SSD crop, the letterbox to the step's
size, the 4-tile mosaic, the mirror and the normalization run here.

Distribution parity with the host chain (`data/transforms.py`):
  * photometric: the host chain's op order, coins and factor ranges
    (brightness ±32 p=.5; contrast ×U(.5,1.5) p=.5 before or after the HSV
    pair on a p=.5 order coin; saturation ×U(.5,1.5) p=.5; hue ±18° p=.5).
    The HSV round trip follows cv2's float32 convention (H∈[0,360),
    S∈[0,1], V∈[0,255]); values are not clipped back to [0,255];
  * SSD crop: rects are sampled inside the image region of the base
    canvas (the letterbox is a uniform scale, so this is the host's
    distribution), accepted by the host's rule (reject iff
    `overlap.min() < min_iou and max_iou < overlap.max()`, the SSD-legacy
    `and`; ≥1 valid box centre strictly inside; h/w in [0.5, 2]); the
    host's unbounded retry loop becomes a fixed grid of R mode rounds × T
    trials scanned in order, and when all R×T candidates are rejected the
    item falls back to the identity (no crop).

Known deviations from the host chain, kept as the JAX package keeps them:
float crop coordinates (the host truncates to pixels), float centering of
the letterbox (the host uses //2), two bilinear resamples (native → canvas
on the host, canvas → output here), mosaic tiles taken from the batch's
other rows (`compose_mosaic`), and unclipped HSV values.

Shapes are fixed: images [B,S0,S0,3] uint8 BGR in, [B,S,S,3] RGB out in the
requested dtype; boxes stay [B,M,4] with label −1 marking dropped rows. The
draws come from an explicit `torch.Generator` on the step's device
(`sample_draws`). Nothing here reads a value back to the host: no
`.item()`, no `nonzero`, no boolean-mask indexing, and no tensor is made
from host data (constants are filled on the device), so a step that calls
`apply_augment` runs under `torch.cuda.set_sync_debug_mode("error")`.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_nano_tpu_torch.ops.nn import scale_and_translate

# BGR order, as data/transforms.py's IMAGE_MEAN and IMAGE_STD
_MEAN = (0.406, 0.456, 0.485)
_STD = (0.225, 0.224, 0.229)

# SSD crop modes: min_iou per mode; mode 0 is the no-crop exit; max_iou is
# +inf for every mode the reference ships
_MODE_MIN_IOU = (-np.inf, 0.1, 0.3, 0.7, 0.9, -np.inf)
_MODE_MAX_IOU = (np.inf,) * 6

# the mix of augment_seed: splitmix64's constants
_GOLDEN, _MIX1, _MIX2 = 0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, \
    0x94D049BB133111EB
_U64 = (1 << 64) - 1


def augment_seed(seed: int, global_iter: int) -> int:
    """The generator seed of one training iteration: splitmix64 of
    ((seed ^ 0x0DE7A06) << 32) + global_iter, so that each (run seed,
    iteration) pair seeds its own stream and a resumed run draws what an
    uninterrupted one drew at the same iteration."""
    z = ((((seed ^ 0x0DE7A06) << 32) + global_iter) + _GOLDEN) & _U64
    z = ((z ^ (z >> 30)) * _MIX1) & _U64
    z = ((z ^ (z >> 27)) * _MIX2) & _U64
    return z ^ (z >> 31)


def _channels(values, device) -> torch.Tensor:
    """[3] f32 on `device`, each element a fill (no host copy, which a
    store of a Python float into a card tensor is)."""
    return torch.stack([torch.full((), float(np.float32(v)),
                                   dtype=torch.float32, device=device)
                        for v in values])


def _divide(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as a true division on every device: CUDA turns a division by
    a Python number into a product with its reciprocal, an ulp off the
    CPU's quotient; a divisor on x's device is divided by."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _lookup(table, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a tuple of Python floats, as f32, without a host
    copy."""
    out = torch.full(idx.shape, float(table[0]), dtype=torch.float32,
                     device=idx.device)
    for i, v in enumerate(table[1:], 1):
        out = torch.where(idx == i, float(v), out)
    return out


def _per_item(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] draw shaped to broadcast over `like`'s trailing dims."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


# ---------------------------------------------------------------------------
# HSV round trip (cv2 float32 full-range convention)
# ---------------------------------------------------------------------------

def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] float BGR (0..255) → HSV with H∈[0,360), S∈[0,1],
    V∈[0,255]."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(
        v == r, 60.0 * (g - b) / safe_c,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_c,
                    240.0 + 60.0 * (r - g) / safe_c))
    h = torch.where(c > 0, h, 0.0)
    h = torch.where(h < 0, h + 360.0, h)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h, s, v], -1)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of bgr_to_hsv; defined (like cv2) for S outside [0,1]: the
    saturation jitter can push S to 1.5, and the host chain never
    clips."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hp = _divide(h, 60.0)
    i = torch.floor(hp).to(torch.int32) % 6
    f = hp - torch.floor(hp)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)

    def sector(values, default):  # values for sectors 0..4, else default
        out = default
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    r = sector((v, q, p, p, t), v)
    g = sector((t, v, v, q, p), p)
    b = sector((p, p, t, v, v), q)
    return torch.stack([b, g, r], -1)


# ---------------------------------------------------------------------------
# photometric distortion
# ---------------------------------------------------------------------------

def photometric_distort(img: torch.Tensor, d: dict) -> torch.Tensor:
    """img [B,S,S,3] f32 BGR 0..255; d: the batch's draws (sample_draws).
    Brightness, then contrast either before or after the HSV saturation and
    hue pair: the host chain's coin structure."""
    item = lambda v: _per_item(v, img)  # noqa: E731
    img = img + item(torch.where(d["bri_coin"], d["bri_delta"], 0.0))
    con = item(torch.where(d["con_coin"], d["con_f"], 1.0))
    order = item(d["order_coin"])
    img = torch.where(order, img * con, img)
    hsv = bgr_to_hsv(img)
    hue = hsv[..., 0]
    s = hsv[..., 1] * _per_item(torch.where(d["sat_coin"], d["sat_f"], 1.0),
                                hue)
    h = hue + _per_item(torch.where(d["hue_coin"], d["hue_delta"], 0.0), hue)
    h = torch.where(h > 360.0, h - 360.0, h)
    h = torch.where(h < 0.0, h + 360.0, h)
    img = hsv_to_bgr(torch.stack([h, s, hsv[..., 2]], -1))
    return torch.where(order, img, img * con)


# ---------------------------------------------------------------------------
# SSD min-IoU crop sampling
# ---------------------------------------------------------------------------

def sample_crop(d: dict, boxes: torch.Tensor, labels: torch.Tensor,
                region: torch.Tensor, base_size: int):
    """The crop rect of every item.

    d: draws with mode [B,R] int and u_w/u_h/u_l/u_t [B,R,T] uniforms;
    boxes [B,M,4] canvas-normalized, labels [B,M] (−1 pad), region [B,4]
    normalized (the canvas area covered by the image). → (rect [B,4]
    canvas-normalized, identity [B] bool): identity means no crop, and the
    caller letterboxes the whole region. The first round that ends (a mode-0
    exit or an accepted trial) decides, its first accepted trial is the
    rect; all rounds rejected, or no valid box, gives the identity."""
    valid = labels >= 0                                      # [B,M]
    reg = region[:, None, None]                              # [B,1,1,4]
    rw = reg[..., 2] - reg[..., 0]
    rh = reg[..., 3] - reg[..., 1]
    w = (0.3 + 0.7 * d["u_w"]) * rw                          # [B,R,T]
    h = (0.3 + 0.7 * d["u_h"]) * rh
    left = reg[..., 0] + d["u_l"] * (rw - w)
    top = reg[..., 1] + d["u_t"] * (rh - h)
    rect = torch.stack([left, top, left + w, top + h], -1)   # [B,R,T,4]
    # aspect in native pixels == aspect in canvas pixels (uniform scale)
    ratio = (h * base_size) / (w * base_size)
    aspect_ok = (ratio >= 0.5) & (ratio <= 2.0)
    bx = boxes[:, None, None]                                # [B,1,1,M,4]
    rc = rect[:, :, :, None]                                 # [B,R,T,1,4]
    tl = torch.maximum(bx[..., :2], rc[..., :2])
    br = torch.minimum(bx[..., 2:], rc[..., 2:])
    inter = torch.prod(torch.clamp(br - tl, min=0.0), -1)    # [B,R,T,M]
    area_b = torch.prod(bx[..., 2:] - bx[..., :2], -1)
    area_r = torch.prod(rc[..., 2:] - rc[..., :2], -1)
    union = area_b + area_r - inter
    iou = inter / torch.where(union > 0, union, 1.0)
    vm = valid[:, None, None]
    omin = torch.where(vm, iou, np.inf).amin(-1)             # [B,R,T]
    omax = torch.where(vm, iou, -np.inf).amax(-1)
    min_iou = _lookup(_MODE_MIN_IOU, d["mode"])[..., None]   # [B,R,1]
    max_iou = _lookup(_MODE_MAX_IOU, d["mode"])[..., None]
    # the host's accept rule verbatim: reject iff overlap.min() < min_iou
    # AND max_iou < overlap.max(); with max_iou = +inf for every shipped
    # mode IoU never rejects (the SSD-legacy `and`-for-`or`), and the table
    # stays live for modes with a finite max_iou
    iou_ok = ~((omin < min_iou) & (omax > max_iou))
    cx = ((boxes[..., 0] + boxes[..., 2]) * 0.5)[:, None, None]
    cy = ((boxes[..., 1] + boxes[..., 3]) * 0.5)[:, None, None]
    cin = ((rc[..., 0] < cx) & (rc[..., 1] < cy)
           & (rc[..., 2] > cx) & (rc[..., 3] > cy))
    center_ok = (cin & vm).any(-1)                           # [B,R,T]
    ok = aspect_ok & iou_ok & center_ok & (d["mode"] != 0)[..., None]
    round_exit = d["mode"] == 0                              # [B,R]
    term = round_exit | ok.any(-1)
    r_star = term.to(torch.uint8).argmax(-1)                 # first True
    pick = lambda t, i: torch.gather(t, 1, i[:, None])[:, 0]  # noqa: E731
    exit_identity = (pick(round_exit, r_star) | ~term.any(-1)
                     | ~valid.any(-1))
    ok_r = torch.gather(ok, 1, r_star[:, None, None].expand(
        -1, 1, ok.shape[2]))[:, 0]                           # [B,T]
    t_star = ok_r.to(torch.uint8).argmax(-1)
    flat = rect.reshape(rect.shape[0], -1, 4)
    chosen = torch.gather(flat, 1, (r_star * rect.shape[2] + t_star)[
        :, None, None].expand(-1, 1, 4))[:, 0]
    return (torch.where(exit_identity[:, None], region, chosen),
            exit_identity)


# ---------------------------------------------------------------------------
# letterbox affine: crop rect of the base canvas → out_size square
# ---------------------------------------------------------------------------

def _letterbox_params(rect: torch.Tensor, base_size: int, out_size: int):
    """rect [B,4] canvas-normalized → (scale [B,2] yx, translation [B,2] yx,
    bounds [B,4] = the output-pixel rect the image covers): the host
    resize_letterbox geometry (aspect kept, centred, mean pad) with float
    centering."""
    cw = (rect[:, 2] - rect[:, 0]) * base_size
    ch = (rect[:, 3] - rect[:, 1]) * base_size
    side = torch.maximum(cw, ch)
    # a true division (int / tensor is reciprocal-then-multiply in torch)
    s = torch.full_like(side, float(out_size)) / side
    ow = s * cw
    oh = s * ch
    ox0 = (out_size - ow) * 0.5
    oy0 = (out_size - oh) * 0.5
    # scale_and_translate: x_in = (x_out + 0.5 − t)/s − 0.5 ⇒ t = ox0 − s·x0
    tx = ox0 - s * rect[:, 0] * base_size
    ty = oy0 - s * rect[:, 1] * base_size
    return (torch.stack([s, s], -1), torch.stack([ty, tx], -1),
            torch.stack([ox0, oy0, ox0 + ow, oy0 + oh], -1))


def _inside(xs: torch.Tensor, x0, y0, x1, y1) -> torch.Tensor:
    """[B,S,S,1] bool: pixel centres xs strictly inside per-item bounds
    ([B] each)."""
    col = xs[None, None, :]
    row = xs[None, :, None]
    it = lambda v: v[:, None, None]  # noqa: E731
    return ((col > it(x0)) & (col < it(x1)) & (row > it(y0))
            & (row < it(y1)))[..., None]


def crop_letterbox_image(img: torch.Tensor, rect: torch.Tensor,
                         out_size: int, pad_bgr: torch.Tensor
                         ) -> torch.Tensor:
    """img [B,S0,S0,3] f32 → [B,S,S,3] f32: each rect letterboxed into the
    output square, mean-filled outside."""
    scale, trans, bounds = _letterbox_params(rect, img.shape[1], out_size)
    out = scale_and_translate(img, out_size, scale, trans)
    xs = torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5
    inside = _inside(xs, *bounds.unbind(-1))
    return torch.where(inside, out, pad_bgr)


def crop_letterbox_boxes(boxes: torch.Tensor, labels: torch.Tensor,
                         rect: torch.Tensor, identity: torch.Tensor):
    """Map canvas-normalized boxes [B,M,4] through the crop and letterbox;
    drop (label → −1) boxes whose centre lies outside the crop (the host's
    rule; the identity keeps all). The outputs are normalized to the output
    square: x' = x·sc + t, sc = 1/max(rect_w, rect_h), t centring the crop,
    the box-space twin of _letterbox_params."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    r = rect[:, None]                                        # [B,1,4]
    cin = ((r[..., 0] < cx) & (r[..., 1] < cy) & (r[..., 2] > cx)
           & (r[..., 3] > cy))
    keep = (labels >= 0) & (identity[:, None] | cin)
    clipped = torch.cat([torch.maximum(boxes[..., :2], r[..., :2]),
                         torch.minimum(boxes[..., 2:], r[..., 2:])], -1)
    rw = rect[:, 2] - rect[:, 0]
    rh = rect[:, 3] - rect[:, 1]
    sc = 1.0 / torch.maximum(rw, rh)
    t = torch.stack([(1.0 - rw * sc) * 0.5 - rect[:, 0] * sc,
                     (1.0 - rh * sc) * 0.5 - rect[:, 1] * sc], -1)
    mapped = clipped * sc[:, None, None] + torch.cat([t, t], -1)[:, None]
    new_boxes = torch.where(keep[..., None], mapped, 0.0)
    new_labels = torch.where(keep, labels, -1)
    return new_boxes.to(boxes.dtype), new_labels


# ---------------------------------------------------------------------------
# in-graph 4-tile mosaic from the base canvases
# ---------------------------------------------------------------------------

def compose_mosaic(d: dict, images_u8: torch.Tensor, boxes: torch.Tensor,
                   labels: torch.Tensor, regions: torch.Tensor,
                   out_size: int, pad_bgr: torch.Tensor, first_row: int = 0):
    """The mosaic of every item of the draws `d`, on the device: items
    first_row, first_row + 1, ... of the batch given (under data
    parallelism the global batch, gathered, and this process's rows of it;
    else the whole batch).

    The host chain builds a 2S×2S canvas from 4 native images scaled by
    S/max(h,w) and resizes it to S. Here item i's tiles are i and the rows
    (i + 1 + mos_tiles[i]) % B of the batch: a base canvas already holds
    its image at S0/max(h,w) inside its region rect, so a tile's footprint
    is half its region rect, one affine resample per tile at out_size (the
    2S canvas is the unit square of the output).

    Deviations from the host path, as in the JAX package: tiles are the
    item and 3 distinct other rows of the shuffled batch, not 3 draws from
    the whole dataset; float sub-pixel geometry; one resample canvas → out.

    → (images [B,S,S,3] f32 BGR, boxes [B,M,4], labels [B,M]): the merged
    ground truth of the 4 tiles clipped to the canvas, valid rows first
    (stable) in the item's M slots."""
    batch, m = labels.shape
    items = d["mos_cx"].shape[0]
    base_size = images_u8.shape[1]
    dev = images_u8.device
    idx = torch.arange(first_row, first_row + items, device=dev)
    tiles = torch.cat([idx[:, None],
                       (idx[:, None] + 1 + d["mos_tiles"]) % batch], 1)
    # mosaic centre: U(S/2, 3S/2) on the 2S canvas → U(0.25, 0.75)
    cx = 0.25 + 0.5 * d["mos_cx"]
    cy = 0.25 + 0.5 * d["mos_cy"]
    s = torch.full((items, 2), out_size / (2.0 * base_size),
                   dtype=torch.float32, device=dev)  # half the region scale
    img_out = pad_bgr.expand(items, out_size, out_size, 3)
    xs = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    out_boxes, out_labels = [], []
    for t in range(4):
        ti = tiles[:, t]
        reg = regions[ti, :4]                                 # [B,4]
        tw = (reg[:, 2] - reg[:, 0]) * 0.5  # tile footprint, out-normalized
        th = (reg[:, 3] - reg[:, 1]) * 0.5
        # unclipped destination rect per quadrant, anchored at the centre
        dx0 = cx - tw if t in (0, 2) else cx
        dy0 = cy - th if t in (0, 1) else cy
        # x_in = (x_out + 0.5 − t)/s − 0.5 with t = S·(d0 − reg0/2)
        trans = torch.stack([out_size * (dy0 - reg[:, 1] * 0.5),
                             out_size * (dx0 - reg[:, 0] * 0.5)], -1)
        tile = scale_and_translate(images_u8[ti], out_size, s, trans)
        inside = _inside(xs, dx0 * out_size, dy0 * out_size,
                         (dx0 + tw) * out_size, (dy0 + th) * out_size)
        img_out = torch.where(inside, tile, img_out)
        bx = boxes[ti]                                        # [B,M,4]
        o = lambda v: v[:, None, None]  # noqa: E731
        mapped = torch.cat([(bx[..., 0:1] - o(reg[:, 0])) * 0.5 + o(dx0),
                            (bx[..., 1:2] - o(reg[:, 1])) * 0.5 + o(dy0),
                            (bx[..., 2:3] - o(reg[:, 0])) * 0.5 + o(dx0),
                            (bx[..., 3:4] - o(reg[:, 1])) * 0.5 + o(dy0)],
                           -1)
        out_boxes.append(torch.clamp(mapped, 0.0, 1.0))
        out_labels.append(labels[ti])
    all_bx = torch.cat(out_boxes, 1)                          # [B,4M,4]
    all_lb = torch.cat(out_labels, 1)                         # [B,4M]
    order = torch.sort((all_lb < 0).to(torch.uint8), dim=-1, stable=True)[1]
    keep = order[:, :m]
    return (img_out, torch.gather(all_bx, 1, keep[..., None].expand(-1, -1, 4)),
            torch.gather(all_lb, 1, keep))


# ---------------------------------------------------------------------------
# draws and the batched pipeline
# ---------------------------------------------------------------------------

def sample_draws(gen: torch.Generator, batch: int, rounds: int = 16,
                 trials: int = 32, mosaic: bool = False) -> dict:
    """All randomness of one batch, as a dict of tensors with leading dim B
    on `gen`'s device: the JAX package's keys, shapes, dtypes and ranges
    (its `jax.random` streams are another generator, so the two agree in
    distribution only). With mosaic, also the mosaic coin (p=0.5), the 3
    distinct other-row offsets (`rand(B, B−1)` ranked: a draw without
    replacement per item; with repeats below batch 4) and the mosaic
    centre."""
    dev = gen.device
    u = lambda *shape: torch.rand(shape or (batch,), generator=gen,  # noqa
                                  device=dev)
    coin = lambda: u() < 0.5  # noqa: E731
    uniform = lambda lo, hi: lo + (hi - lo) * u()  # noqa: E731
    draws = {
        "bri_coin": coin(),
        "bri_delta": uniform(-32.0, 32.0),
        "order_coin": coin(),
        "con_coin": coin(),
        "con_f": uniform(0.5, 1.5),
        "sat_coin": coin(),
        "sat_f": uniform(0.5, 1.5),
        "hue_coin": coin(),
        "hue_delta": uniform(-18.0, 18.0),
        "mode": torch.randint(0, 6, (batch, rounds), generator=gen,
                              device=dev, dtype=torch.int32),
        "u_w": u(batch, rounds, trials),
        "u_h": u(batch, rounds, trials),
        "u_l": u(batch, rounds, trials),
        "u_t": u(batch, rounds, trials),
        "mirror": coin(),
    }
    if mosaic:
        # 3 distinct offsets into the other B−1 rows: j = (i+1+off) % B
        if batch >= 4:
            tiles = u(batch, batch - 1).argsort(-1)[:, :3].to(torch.int32)
        else:  # tiny batches (tests): repeats allowed
            tiles = torch.randint(0, max(batch - 1, 1), (batch, 3),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)
        draws.update(mos_coin=coin(), mos_tiles=tiles, mos_cx=u(),
                     mos_cy=u())
    return draws


def apply_augment(images_u8: torch.Tensor, boxes: torch.Tensor,
                  labels: torch.Tensor, regions: torch.Tensor, draws: dict,
                  out_size: int, out_dtype=torch.float32,
                  mosaic: bool = False, mosaic_source=None):
    """The batched pipeline, every random choice given in `draws`.

    images_u8 [B,S0,S0,3] uint8 BGR base canvases; boxes [B,M,4]
    canvas-normalized; labels [B,M] int (−1 pad); regions [B,5] = the
    normalized image-region rect and the crop_allowed flag (0 turns the SSD
    crop off). → (images [B,S,S,3] out_dtype, RGB, normalized; boxes
    [B,M,4]; labels [B,M]).

    With mosaic (draws from sample_draws(..., mosaic=True)) an item whose
    mos_coin is set is instead the 4-tile mosaic (compose_mosaic) through
    the crop-free colour chain (photometric, mirror, normalize). Both
    branches are computed for every item and chosen with torch.where.
    `mosaic_source` = (images_u8, boxes, labels, regions, first_row): the
    batch the mosaic tiles come from, whose rows first_row, ... are the
    items given (compose_mosaic); by default the items' own batch."""
    if regions.dim() != 2 or regions.shape[-1] != 5:
        raise ValueError(
            f"regions must be [B,5] (rect + crop_allowed flag, the loader's "
            f"device-mode contract), got {tuple(regions.shape)}")
    base_size = images_u8.shape[1]
    dev = images_u8.device
    mean = _channels(_MEAN, dev)
    std = _channels(_STD, dev)
    pad_bgr = mean * 255.0
    img = photometric_distort(images_u8.float(), draws)
    rect, identity = sample_crop(draws, boxes, labels, regions[:, :4],
                                 base_size)
    blocked = regions[:, 4] == 0
    identity = identity | blocked
    rect = torch.where(blocked[:, None], regions[:, :4], rect)
    out = crop_letterbox_image(img, rect, out_size, pad_bgr)
    nb, nl = crop_letterbox_boxes(boxes, labels, rect, identity)
    if mosaic:
        source = mosaic_source or (images_u8, boxes, labels, regions, 0)
        m_img, m_bx, m_lb = compose_mosaic(draws, *source[:4], out_size,
                                           pad_bgr, source[4])
        # one photometric draw on the composed image, as the host chain's
        # single colour pass over its 2S canvas
        m_img = photometric_distort(m_img, draws)
        use = draws["mos_coin"]
        out = torch.where(use[:, None, None, None], m_img, out)
        nb = torch.where(use[:, None, None], m_bx, nb)
        nl = torch.where(use[:, None], m_lb, nl)
    mirror = draws["mirror"]
    out = torch.where(mirror[:, None, None, None], out.flip(2), out)
    flipped = torch.cat([1.0 - nb[..., 2:3], nb[..., 1:2],
                         1.0 - nb[..., 0:1], nb[..., 3:4]], -1)
    nb = torch.where(mirror[:, None, None],
                     torch.where((nl >= 0)[..., None], flipped, 0.0), nb)
    # normalize in BGR, then flip to RGB (the host's _normalize_to_rgb)
    out = (_divide(out, 255.0) - mean) / std
    return out.flip(-1).to(out_dtype), nb, nl


def make_augment_fn(out_size: int, rounds: int = 16, trials: int = 32,
                    out_dtype=torch.float32, mosaic: bool = False,
                    mesh=None):
    """→ augment(images_u8, boxes, labels, regions, gen) for the training
    step (train.train_step.make_train_step(augment=...)): sample_draws on
    `gen`, then apply_augment at out_size. With mosaic the 4-tile mosaic is
    composed in the step too, so the host always ships plain per-index
    canvases and the canvas cache stays fully effective.

    With `mesh` (parallel.mesh) the arguments are this process's rows of
    the global batch, and every process seeds `gen` alike: the draws are
    made for the global batch and each process keeps its rows', so that
    its rows come out as one process's run of the global batch gives them,
    bit for bit. With mosaic the canvases, boxes, labels and regions of
    the global batch are gathered first (all_gather_rows), since an item's
    tiles are rows of the global batch, as in the JAX package's sharded
    step."""
    if mesh is not None:
        from yolo_nano_tpu_torch.parallel.mesh import (batch_sharding,
                                                       mesh_group)
        from yolo_nano_tpu_torch.parallel.multiprocess import all_gather_rows

        shard, group = batch_sharding(mesh), mesh_group(mesh)

    def augment(images_u8, boxes, labels, regions, gen):
        if mesh is None:
            draws = sample_draws(gen, images_u8.shape[0], rounds, trials,
                                 mosaic=mosaic)
            return apply_augment(images_u8, boxes, labels, regions, draws,
                                 out_size, out_dtype, mosaic=mosaic)
        local = images_u8.shape[0]
        rows = shard.rows(local * shard.count)
        draws = sample_draws(gen, local * shard.count, rounds, trials,
                             mosaic=mosaic)
        source = None
        if mosaic:
            source = tuple(all_gather_rows(t, group) for t in (
                images_u8, boxes, labels, regions)) + (rows.start,)
        return apply_augment(images_u8, boxes, labels, regions,
                             {k: v[rows] for k, v in draws.items()},
                             out_size, out_dtype, mosaic=mosaic,
                             mosaic_source=source)

    return augment
