"""Seeded synthetic content with natural-image statistics.

Benchmarks and smoke runs need frames at real sizes without shipping
images: ``natural_bgrx`` builds one from a seed out of the three things
that decide how a block-DCT codec behaves on photographs — smooth
low-frequency gradients (cheap blocks), band-limited texture at several
scales (mid-size chunks) and hard-edged shapes (expensive blocks along
the edges). ``noise_planes`` is uniform noise, the worst case, for
exercising the large-chunk tiers.
"""

from __future__ import annotations

import numpy as np


def _smooth_noise(rng, h: int, w: int, cell: int) -> np.ndarray:
    """Value noise: a coarse random grid, bilinearly upsampled [h, w]."""
    gh, gw = h // cell + 2, w // cell + 2
    g = rng.standard_normal((gh, gw)).astype(np.float32)
    ys = np.arange(h, dtype=np.float32) / cell
    xs = np.arange(w, dtype=np.float32) / cell
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def natural_bgrx(h: int, w: int, seed: int = 0) -> np.ndarray:
    """[h, w, 4] u8 BGRX frame (alpha 0) with natural-image statistics."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.float32)[:, None] / h
    xx = np.arange(w, dtype=np.float32)[None, :] / w
    chans = []
    for _ in range(3):
        a, b, c = rng.uniform(0.5, 3.0, 3)
        p = rng.uniform(0, 2 * np.pi, 2)
        base = (110 + 60 * np.sin(2 * np.pi * a * xx + p[0])
                * np.cos(2 * np.pi * b * yy + p[1]) + 30 * c * (xx - yy))
        chans.append(base)
    # texture: a shared luminance part plus a little per channel, at
    # three scales (amplitude falling with frequency, roughly 1/f)
    tex = sum(_smooth_noise(rng, h, w, cell) * amp
              for cell, amp in ((64, 14.0), (12, 8.0), (3, 4.0)))
    for i in range(3):
        chans[i] = chans[i] + tex + _smooth_noise(rng, h, w, 16) * 3.0
    # edges: flat-coloured rectangles and discs with hard boundaries
    img = np.stack(chans, axis=-1)
    n_shapes = max(4, (h * w) // 200_000)
    for _ in range(n_shapes):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        sh, sw = rng.integers(h // 20 + 1, h // 4 + 2), \
            rng.integers(w // 20 + 1, w // 4 + 2)
        col = rng.uniform(0, 255, 3).astype(np.float32)
        if rng.random() < 0.5:
            img[y0:y0 + sh, x0:x0 + sw] = col
        else:
            r = min(sh, sw) // 2
            gy = np.arange(max(0, y0 - r), min(h, y0 + r))[:, None]
            gx = np.arange(max(0, x0 - r), min(w, x0 + r))[None, :]
            disc = (gy - y0) ** 2 + (gx - x0) ** 2 <= r * r
            img[gy.ravel()[0]:gy.ravel()[-1] + 1,
                gx.ravel()[0]:gx.ravel()[-1] + 1][disc] = col
    out = np.zeros((h, w, 4), np.uint8)
    out[..., :3] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def natural_planes(h: int, w: int, seed: int = 0):
    """(Y, U, V) IYUV planes of ``natural_bgrx`` (the scalar-oracle
    conversion, so the planes do not depend on a device)."""
    from ..kernels import scalar
    return scalar.bgrx_to_iyuv(natural_bgrx(h, w, seed))


def noise_planes(h: int, w: int, seed: int = 0):
    """(Y, U, V) planes of uniform noise — the largest chunks per quality."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
