"""Batched SE(3)/SO(3) Lie algebra in pure JAX.

Capability parity with the reference math layer (include/math/se3.hpp:7-46,
src/math/se3.cpp), re-designed for jit: every function is closed over
``jnp`` ops only, accepts arbitrary leading batch dimensions, and is
jit/vmap/grad-safe (small-angle branches are ``jnp.where`` selections of
Taylor series, never Python branches — reference uses 1e-6 thresholds at
se3.cpp:84,113).

Conventions (identical to the reference so trajectories are comparable):
  * twist xi = [v; w] with translation first (se3.cpp:70-75);
  * ``exp``/``log`` map 6-twists <-> 4x4 homogeneous transforms;
  * ``compose(xi0, xi1) = log(exp(xi0) @ exp(xi1))`` (se3.cpp:127-131,
    named ``concatenate`` there).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# 3x3/4x4 pose math is tiny but precision-critical: a GPU may run f32
# matmuls in TF32 (~3 decimal digits), which wrecks exp/log round-trips.
# Force full-precision contractions — at this size they are free.
_HI = lax.Precision.HIGHEST


def matmul(a, b):
    """Batched (..., i, j) @ (..., j, k) at HIGHEST precision — use for every
    pose product instead of ``@``."""
    return jnp.einsum("...ij,...jk->...ik", a, b, precision=_HI)


def _mv(a, b):
    return jnp.einsum("...ij,...j->...i", a, b, precision=_HI)

_SMALL = 1e-6  # reference small-angle threshold (se3.cpp:84,113)


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix.  Reference se3.cpp:8-15."""
    zeros = jnp.zeros_like(w[..., 0])
    rows = [
        jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
        jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
        jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def _theta(w: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle with a safe-for-grad floor; (..., 3) -> (...)."""
    return jnp.sqrt(jnp.sum(w * w, axis=-1) + 1e-24)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3).  Reference se3.cpp:21-28
    (which delegates to cv::Rodrigues)."""
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = matmul(W, W)
    small = th < _SMALL
    # sin(th)/th and (1 - cos(th))/th^2 with 2nd-order Taylor fallbacks.
    # th_safe keeps the *untaken* exact branch finite in both value and
    # gradient (jnp.where grads flow through both branches).
    ths = jnp.where(small, 1.0, th)
    a = jnp.where(small, 1.0 - th * th / 6.0, jnp.sin(ths) / ths)
    b = jnp.where(small, 0.5 - th * th / 24.0, (1.0 - jnp.cos(ths)) / (ths * ths))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 3).  Reference se3.cpp:31-43: theta from the
    trace, axis from the antisymmetric part (the reference does not
    special-case theta ~ pi either; we clamp the trace to keep acos
    finite).

    Small-angle branch: VALUE stays the reference's exact zero (th <
    1e-6 rad), but the GRADIENT is that of ``0.5 * vee`` via the
    stop-gradient identity ``x - stop_grad(x)``.  A plain constant-zero
    branch made ``jacfwd`` through log-at-identity return a ZERO
    rotation block (should be I), which zeroed pose-graph
    normal-equation diagonals for nodes whose edges all had exactly-zero
    rotation residual (round-5 find); changing the VALUE instead
    re-rolled the cross-compilation float noise that several
    parity-tolerance gates are calibrated against, so value-compat is
    kept.  The arccos gradient singularity at trace -> 3 is guarded by
    the double-where ``ths``."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_th = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    th = jnp.arccos(cos_th)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = th < _SMALL
    # th / (2 sin th) -> 1/2 as th -> 0; ths guards BOTH the value and
    # the gradient of the untaken exact branch (d(arccos)/d(trace) is
    # singular exactly at identity — 0 * inf = NaN without the guard).
    ths = jnp.where(small, 1.0, th)
    scale = jnp.where(small, 0.5, ths / (2.0 * jnp.sin(ths)))[..., None]
    out = scale * vee
    # Zero VALUE below threshold (reference compat) with the out-branch
    # derivative preserved: x - stop_gradient(x) is 0 with grad(x).
    zeroed = out - lax.stop_gradient(out)
    return jnp.where(small[..., None], zeroed, out)


def _v_coeffs(w: jnp.ndarray):
    """Shared V-matrix ingredients: (W, W2, b, c) with
    b = (1-cos)/th^2, c = (th-sin)/th^3 (Taylor-guarded)."""
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = matmul(W, W)
    small = th < _SMALL
    ths = jnp.where(small, 1.0, th)  # grad-safe untaken branch (see so3_exp)
    b = jnp.where(small, 0.5 - th * th / 24.0, (1.0 - jnp.cos(ths)) / (ths * ths))
    c = jnp.where(small, 1.0 / 6.0 - th * th / 120.0, (ths - jnp.sin(ths)) / (ths ** 3))
    return W, W2, b, c


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) -> (..., 4, 4).  Reference se3.cpp:70-98: R = so3_exp(w),
    t = V v with the closed-form V (the reference collapses to t = v below
    the threshold; the Taylor-series V agrees to O(th^2))."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    W, W2, b, c = _v_coeffs(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + b * W + c * W2
    t = _mv(V, v)
    batch = xi.shape[:-1]
    T = jnp.zeros(batch + (4, 4), dtype=xi.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6).  Reference se3.cpp:101-124 with
    V^-1 = I - W/2 + (1 - th*cos(th/2) / (2 sin(th/2))) / th^2 * W^2."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = matmul(W, W)
    small = th < _SMALL
    half = th * 0.5
    # (1 - th cos(th/2) / (2 sin(th/2))) / th^2  ->  1/12 as th -> 0.
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + th * th / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half)))
        / jnp.where(small, 1.0, th * th),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    V_inv = eye - 0.5 * W + cot_term * W2
    v = _mv(V_inv, t)
    return jnp.concatenate([v, w], axis=-1)


def compose(xi0: jnp.ndarray, xi1: jnp.ndarray) -> jnp.ndarray:
    """log(exp(xi0) @ exp(xi1)).  Reference ``concatenate`` se3.cpp:127-131."""
    return se3_log(matmul(se3_exp(xi0), se3_exp(xi1)))


def inverse(xi: jnp.ndarray) -> jnp.ndarray:
    """Twist of the inverse transform: simply -xi (exp(-xi) = exp(xi)^-1)."""
    return -xi


def transform(T: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., 3): R x + t.
    Reference transform.cpp:7-18 (which also accepts a twist — pass
    ``se3_exp(xi)`` here; keeping the matrix explicit avoids re-deriving it
    per call site)."""
    return _mv(T[..., :3, :3], x) + T[..., :3, 3]


def invert_T(T: jnp.ndarray) -> jnp.ndarray:
    """Proper rigid inverse [R^T | -R^T t].

    NOTE: the reference's ``Convert::inversePose`` (convert.cpp:31-39)
    computes [R^T | -t] — missing the rotation of t.  It is only used for
    trajectory *display* (main.cpp:50); we implement the correct inverse and
    keep the quirk out of the math path."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    out = jnp.zeros_like(T)
    out = out.at[..., :3, :3].set(Rt)
    out = out.at[..., :3, 3].set(-_mv(Rt, t))
    out = out.at[..., 3, 3].set(1.0)
    return out


def is_finite_xi(xi: jnp.ndarray) -> jnp.ndarray:
    """NaN/Inf guard on a twist, (..., 6) -> (...) bool.
    Reference math::testXi (util.hpp:34-44), used to reject bad GN updates
    (tracker.cpp:47-51)."""
    return jnp.all(jnp.isfinite(xi), axis=-1)
