"""The benchmark's inputs: rendered scenes, made from a seed on the device.

A scene is 1 to 4 filled shapes (a circle, a square or a triangle, one of
three classes, each in its class's colour) of side 50 to 150 px at 416 px
(scaled with the size) on uniform noise in [60, 190) smoothed by a 5-tap
Gaussian (sigma 2, edges replicated), rounded to 8 bits and normalized as
the detector's validation transform: (img / 255 - mean) / std in BGR, then
flipped to RGB. This is the scene generator of the repository's chip smoke
test (`render_scenes`), drawn in bulk on the device instead of image by
image with NumPy: the trained COCO artifacts find 2 to 8 candidates and
about 2 detections an image in such scenes at the serving point.

The layout (counts, sides, corners, classes) comes from NumPy's generator
on the seed, the noise from a `torch.Generator` on the device on the same
seed: a seed gives the same scenes on every run on one kind of device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SHAPE_COLOURS = ((40, 40, 220), (60, 200, 60), (220, 80, 40))  # BGR
IMAGE_MEAN = (0.406, 0.456, 0.485)  # BGR
IMAGE_STD = (0.225, 0.224, 0.229)
MAX_SHAPES = 4
CHUNK = 32  # scenes rendered at once, to bound the device memory it takes


def seed_value(seed: int) -> int:
    """A seed as the generators take it: any whole number, mapped onto
    [0, 2**63)."""
    return int(seed) % 2 ** 63


def layout(n: int, size: int, seed: int):
    """-> (count [n], side [n, 4], x1 [n, 4], y1 [n, 4], class [n, 4]) int64;
    entries past a scene's count are unused."""
    rng = np.random.default_rng(seed_value(seed))
    lo, hi = max(2, round(50 * size / 416)), max(3, round(150 * size / 416))
    count = rng.integers(1, MAX_SHAPES + 1, n)
    side = rng.integers(lo, hi, (n, MAX_SHAPES))
    x1 = (rng.random((n, MAX_SHAPES)) * (size - side - 4)).astype(np.int64) + 2
    y1 = (rng.random((n, MAX_SHAPES)) * (size - side - 4)).astype(np.int64) + 2
    cls = rng.integers(0, 3, (n, MAX_SHAPES))
    return count, side, x1, y1, cls


def boxes(n: int, size: int, seed: int):
    """Each scene's shapes as ground truth: (boxes [n, 4, 4] normalized
    corners, f32; labels [n, 4] int64, -1 past the scene's count)."""
    count, side, x1, y1, cls = layout(n, size, seed)
    b = np.stack([x1, y1, x1 + side + 1, y1 + side + 1], -1).astype(
        np.float32) / np.float32(size)
    used = np.arange(MAX_SHAPES)[None, :] < count[:, None]
    return (np.where(used[..., None], b, 0).astype(np.float32),
            np.where(used, cls, -1))


def _smooth(img: torch.Tensor) -> torch.Tensor:
    """[n, 3, H, W] -> the 5-tap Gaussian (sigma 2) along H and W."""
    k = np.exp(-0.5 * (np.arange(-2, 3) / 2.0) ** 2)
    k = torch.tensor(k / k.sum(), dtype=torch.float32, device=img.device)
    n, c, h, w = img.shape
    x = img.reshape(n * c, 1, h, w)
    x = F.conv2d(F.pad(x, (2, 2, 0, 0), mode="replicate"), k.view(1, 1, 1, 5))
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="replicate"), k.view(1, 1, 5, 1))
    return x.reshape(n, c, h, w)


def render(n: int, size: int, seed: int, device) -> torch.Tensor:
    """n scenes -> [n, size, size, 3] f32 RGB, normalized, on `device`."""
    count, side, x1, y1, cls = (torch.as_tensor(v, device=device)
                                for v in layout(n, size, seed))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_value(seed))
    colours = torch.tensor(SHAPE_COLOURS, dtype=torch.float32, device=device)
    mean = torch.tensor(IMAGE_MEAN, device=device)
    std = torch.tensor(IMAGE_STD, device=device)
    yy = torch.arange(size, device=device).view(1, size, 1)
    xx = torch.arange(size, device=device).view(1, 1, size)
    out = torch.empty((n, size, size, 3), dtype=torch.float32, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        noise = torch.randint(60, 190, (m, 3, size, size), generator=gen,
                              device=device).float()
        img = _smooth(noise).permute(0, 2, 3, 1)  # [m, S, S, 3] BGR
        for j in range(MAX_SHAPES):
            sl = slice(lo, lo + m)
            s = side[sl, j].view(m, 1, 1)
            x0, y0 = x1[sl, j].view(m, 1, 1), y1[sl, j].view(m, 1, 1)
            cx, cy = x0 + s // 2, y0 + s // 2
            circle = (xx - cx) ** 2 + (yy - cy) ** 2 <= (s // 2) ** 2
            square = (xx >= x0) & (xx <= x0 + s) & (yy >= y0) & (yy <= y0 + s)
            half = (yy - y0).float() / s * (s / 2)
            triangle = ((yy >= y0) & (yy <= y0 + s)
                        & ((xx - cx).abs().float() <= half))
            c = cls[sl, j].view(m, 1, 1)
            mask = torch.where(c == 0, circle, torch.where(c == 1, square,
                                                           triangle))
            mask &= (count[sl] > j).view(m, 1, 1)
            img = torch.where(mask[..., None], colours[cls[sl, j]].view(
                m, 1, 1, 3), img)
        img = torch.round(img) / 255.0
        out[lo:lo + m] = ((img - mean) / std).flip(-1)
    return out
