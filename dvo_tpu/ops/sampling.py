"""Sub-pixel bilinear sampling — the innermost primitive of both hot loops.

Reference: src/core/convert.cpp — ``getSubpixelFromDense`` (:77-105, plain
bilinear with out-of-range corners falling back to the base corner) and
``getSubpixel`` (:128-177, bilinear over images with invalid pixels: invalid
corners are filled from the nearest valid corner in cyclic scan order,
all-invalid -> invalid).

Both are XLA gathers (advanced indexing) plus elementwise blends, which
XLA fuses with their consumers.

Coordinates are (x, y) pixel units, matching the reference; x0 = floor
(callers gate points to x >= 0 so truncation == floor as in the C++).
"""

from __future__ import annotations

import jax.numpy as jnp


def _corners(x: jnp.ndarray, y: jnp.ndarray, w: int, h: int):
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    # In-range flags per corner (reference convert.cpp:90-101).
    in0 = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    in_x1 = (x0 + 1 < w)
    in_y1 = (y0 + 1 < h)
    return x0, y0, fx, fy, in0, in_x1, in_y1


def bilinear_dense(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """getSubpixelFromDense semantics (convert.cpp:77-105).

    Out-of-range +1 corners reuse the base corner (equivalent to clamping the
    +1 index back to the base).  Returns (values, valid) where valid is the
    base-corner in-range flag — the reference returns INVALID there.
    """
    h, w = img.shape[-2], img.shape[-1]
    x0, y0, fx, fy, in0, in_x1, in_y1 = _corners(x, y, w, h)
    x0c = jnp.clip(x0, 0, w - 1)
    y0c = jnp.clip(y0, 0, h - 1)
    x1c = jnp.clip(x0 + 1, 0, w - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    g00 = img[..., y0c, x0c]
    # Any out-of-range corner falls back to the *base* corner g00 (the
    # reference initializes all four to img(y0, x0) before the in-range
    # overwrites, convert.cpp:88-101 — note this is NOT clamp-to-edge).
    g10 = jnp.where(in_x1, img[..., y0c, x1c], g00)
    g01 = jnp.where(in_y1, img[..., y1c, x0c], g00)
    g11 = jnp.where(in_x1 & in_y1, img[..., y1c, x1c], g00)
    top = g00 * (1.0 - fx) + g10 * fx
    bot = g01 * (1.0 - fx) + g11 * fx
    return top * (1.0 - fy) + bot * fy, in0


def bilinear_masked(img: jnp.ndarray, mask: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """getSubpixel semantics (convert.cpp:128-177): corners carrying invalid
    pixels are replaced by the nearest valid corner in the cyclic scan order
    g0=(x0,y0), g1=(x1,y0), g2=(x0,y1), g3=(x1,y1); if all four are invalid
    the sample is invalid.

    (The reference's fill loop has a ``last > 0`` quirk that fails to
    propagate a *valid black* pixel, convert.cpp:158; we treat any valid
    corner as fillable — SURVEY.md §7 quirks, fixed unconditionally since the
    difference only manifests for exactly-0.0 gray at a mask boundary.)
    """
    h, w = img.shape[-2], img.shape[-1]
    x0, y0, fx, fy, in0, in_x1, in_y1 = _corners(x, y, w, h)
    x0c = jnp.clip(x0, 0, w - 1)
    y0c = jnp.clip(y0, 0, h - 1)
    x1c = jnp.clip(x0 + 1, 0, w - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)

    # Corner values; any out-of-range corner aliases the *base* corner value
    # and its validity (reference initializes all four to g0 before the
    # in-range overwrites, convert.cpp:147-156).
    g00 = img[..., y0c, x0c]
    m00 = mask[..., y0c, x0c]
    in3 = in_x1 & in_y1
    g = [
        g00,
        jnp.where(in_x1, img[..., y0c, x1c], g00),
        jnp.where(in_y1, img[..., y1c, x0c], g00),
        jnp.where(in3, img[..., y1c, x1c], g00),
    ]
    v = [
        in0 & m00,
        in0 & jnp.where(in_x1, mask[..., y0c, x1c], m00),
        in0 & jnp.where(in_y1, mask[..., y1c, x0c], m00),
        in0 & jnp.where(in3, mask[..., y1c, x1c], m00),
    ]
    g = [jnp.where(vi, gi, 0.0) for gi, vi in zip(g, v)]

    # Cyclic-predecessor fill: two sweeps of "if invalid, take predecessor"
    # converge for 4 corners (predecessor = previous index mod 4).
    for _ in range(2):
        for i in range(4):
            p = (i - 1) % 4
            take = (~v[i]) & v[p]
            g[i] = jnp.where(take, g[p], g[i])
            v[i] = v[i] | take

    any_valid = v[0] | v[1] | v[2] | v[3]
    top = g[0] * (1.0 - fx) + g[1] * fx
    bot = g[2] * (1.0 - fx) + g[3] * fx
    return top * (1.0 - fy) + bot * fy, any_valid
