"""Windowed photometric bundle adjustment with Schur-complement depth
elimination.

A capability beyond the reference (which has no joint optimization at all —
SURVEY.md §2 parallelism note, §7 phase 5): jointly
refine the camera poses and per-pixel inverse depths of an M-keyframe
window by minimizing robust photometric residuals over all ordered keyframe
pairs.

Structure (all static shapes, one jitted program):

  * Parameters: right-composed pose increments delta_k in se(3) per
    keyframe (keyframe 0 gauge-fixed) + inverse-depth increments per host
    pixel.
  * Residual r_{kj}(p) = I_j(pi(T_j^-1 T_k backproj(p, 1/rho))) - I_k(p)
    for every pixel p of host keyframe k and target j != k, masked to
    valid/visible pixels, Huber-weighted.
  * Jacobians are analytic (the tracker's direct-method chain extended
    with the target-pose and inverse-depth terms) and evaluated densely.
  * Normal system: camera block H_cc (6M x 6M), diagonal depth block
    H_dd (one scalar per host pixel), coupling H_cd.  The per-pixel depth
    parameter couples only its own host keyframe's residuals, so the Schur
    complement S = H_cc - H_cd H_dd^-1 H_dc is SEPARABLE PER HOST: each
    host keyframe's scan accumulates its own coupling rows b_p (H, W, 6M),
    folds them into a per-host (6M, 6M) Schur contribution, and discards
    them — nothing of size (M, H, W, 6M) is ever materialized (the round-2
    version stacked exactly that: ~1 GB at window 7 / 256x212).  The
    reduced 6M x 6M system is solved by Cholesky; inverse-depth
    back-substitution recomputes the per-pixel coupling dot b_p . dc in a
    second cheap pass over the pair terms.
  * Camera-block accumulation works on 6x6 blocks (host-host, host-target,
    target-target) placed into an (M, M, 6, 6) grid — not on 6M-wide
    one-hot-expanded rows, which costs M^2 more matmul work for the same
    numbers.

On a mesh, host keyframes shard over the ``kf`` axis and the reduced system
is psum-reduced across the axis (dvo_tpu.parallel.ba).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dvo_tpu import lie
from dvo_tpu.config import BAConfig
from dvo_tpu.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu.ops.warp import pixel_grid

_HI = lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BAWindow:
    """M stacked keyframes (base pyramid level)."""

    gray: jax.Array    # (M, H, W)
    mask: jax.Array    # (M, H, W) bool
    gx: jax.Array      # (M, H, W)
    gy: jax.Array      # (M, H, W)
    gmask: jax.Array   # (M, H, W) bool
    depth: jax.Array   # (M, H, W)
    sigma: jax.Array   # (M, H, W)
    xi: jax.Array      # (M, 6) world pose twists (camera-to-world)
    K: jax.Array       # (3, 3)

    @property
    def size(self) -> int:
        return self.gray.shape[0]


def window_slots(history, m: int) -> jax.Array:
    """Ring slots of the newest ``m`` keyframes, oldest-first — the index
    map shared by ``window_from_history`` and the post-BA write-back."""
    from dvo_tpu.models.history import born_slot

    ages = jnp.arange(m - 1, -1, -1)
    return jax.vmap(lambda a: born_slot(history, a))(ages)


def window_from_history(history, K, m: int) -> BAWindow:
    """Materialize the newest ``m`` keyframes (oldest-first) from the ring
    buffer into a dense window."""
    slots = window_slots(history, m)
    take = lambda arr: arr[slots]
    return BAWindow(
        gray=take(history.gray), mask=take(history.mask),
        gx=take(history.gx), gy=take(history.gy), gmask=take(history.gmask),
        depth=take(history.depth), sigma=take(history.sigma),
        xi=history.xi[slots], K=K,
    )


def _pair_terms(window: BAWindow, T_all, k, j, cfg: BAConfig):
    """Dense residual + Jacobian terms for host keyframe k vs target j.

    ``k`` and ``j`` may be traced scalars (the host/target loops are
    ``lax.scan``s — unrolling them made XLA compile time quadratic in the
    window size).  Returns (r, w, Jk (..,6), Jj (..,6), Jrho (..,)) over
    k's pixels.
    """
    m, h, w_px = window.gray.shape
    K = window.K
    fx, fy = K[0, 0], K[1, 1]
    xs, ys = pixel_grid(h, w_px)

    # Relative transform camera_k -> camera_j: T_jk = T_j^-1 T_k.
    T_jk = lie.matmul(lie.invert_T(T_all[j]), T_all[k])
    R_jk = T_jk[:3, :3]

    depth = window.depth[k]
    safe_d = jnp.maximum(depth, 1e-3)
    rho = 1.0 / safe_d

    # Host camera point and its image in camera j.
    xn = (xs - K[0, 2]) / fx
    yn = (ys - K[1, 2]) / fy
    Xk = jnp.stack([xn * safe_d, yn * safe_d, safe_d], axis=-1)
    Xj = jnp.einsum("ab,hwb->hwa", R_jk, Xk, precision=_HI) + T_jk[:3, 3]
    zj = Xj[..., 2]
    safe_z = jnp.where(jnp.abs(zj) < 1e-6, 1e-6, zj)
    u = fx * Xj[..., 0] / safe_z + K[0, 2]
    v = fy * Xj[..., 1] / safe_z + K[1, 2]

    # Samples from the target keyframe.
    i_j, samp_ok = bilinear_masked(window.gray[j], window.mask[j], u, v)
    gxv, _ = bilinear_dense(window.gx[j], u, v)
    gyv, _ = bilinear_dense(window.gy[j], u, v)
    gmask_f, _ = bilinear_dense(window.gmask[j].astype(jnp.float32), u, v)

    r = i_j - window.gray[k]

    valid = window.mask[k] & (depth > 1e-3) & (zj > 1e-3)
    valid &= samp_ok & (gmask_f > 1.0 - 1e-4)
    valid &= (u >= 0) & (u < w_px) & (v >= 0) & (v < h)
    # Semi-dense host selection: only pixels with usable host gradient carry
    # depth information; others would only blur the pose estimate.
    valid &= window.gmask[k]

    # Huber weight on the residual.
    absr = jnp.abs(r)
    w_huber = jnp.where(absr <= cfg.huber_delta, 1.0, cfg.huber_delta / jnp.maximum(absr, 1e-12))
    w_all = w_huber * valid.astype(jnp.float32)

    # du/dXj (2x3) rows folded directly with the image gradient: J_u = [gx gy].
    gfx = gxv * fx
    gfy = gyv * fy
    # dr/dXj = [gfx/z, gfy/z, -(gfx*x + gfy*y)/z^2]
    dr_dXj = jnp.stack(
        [
            gfx / safe_z,
            gfy / safe_z,
            -(gfx * Xj[..., 0] + gfy * Xj[..., 1]) / (safe_z * safe_z),
        ],
        axis=-1,
    )

    # d Xj / d delta_k = R_jk [I | -hat(Xk)]  (right increment on T_k):
    #   dr/dv_k = dr_dXj R_jk =: a
    #   dr/dw_k = -a^T hat(Xk) = -(a x Xk) = Xk x a
    # (a^T hat(X) = a x X since hat(X) e_i = X x e_i.)
    a = jnp.einsum("hwa,ab->hwb", dr_dXj, R_jk, precision=_HI)  # (H,W,3)
    Jk_v = a
    Jk_w = jnp.cross(Xk, a)

    # d Xj / d delta_j = [-I | hat(Xj)]  (from Xj(d) = exp(-d_j) T_jk ... Xk):
    #   dr/dv_j = -dr_dXj
    #   dr/dw_j = dr_dXj^T hat(Xj) = dr_dXj x Xj
    Jj_v = -dr_dXj
    Jj_w = jnp.cross(dr_dXj, Xj)

    # d Xj / d rho = R_jk dXk/drho = R_jk (-Xk / rho) = -(Xj - t_jk)/rho
    dXj_drho = -(Xj - T_jk[:3, 3]) / rho[..., None]
    Jrho = jnp.einsum("hwa,hwa->hw", dr_dXj, dXj_drho, precision=_HI)

    Jk = jnp.concatenate([Jk_v, Jk_w], axis=-1)
    Jj = jnp.concatenate([Jj_v, Jj_w], axis=-1)
    return r, w_all, Jk, Jj, Jrho


def _current_window(window: BAWindow, deltas, drho) -> Tuple[BAWindow, jax.Array]:
    """Window re-linearized at the current increments: poses right-composed
    with deltas, depths updated by inverse-depth increments."""
    T_all = jax.vmap(lambda x, d: lie.matmul(lie.se3_exp(x), lie.se3_exp(d)))(
        window.xi, deltas
    )
    safe_d = jnp.maximum(window.depth, 1e-3)
    new_depth = 1.0 / jnp.maximum(1.0 / safe_d + drho, 1e-4)
    return dataclasses.replace(window, depth=new_depth), T_all


def _gated_pair_terms(window: BAWindow, T_all, k, j, cfg: BAConfig):
    """Pair terms with the self-pair and gauge gates applied (keyframe 0's
    pose is fixed; k == j contributes nothing)."""
    r, w_all, Jk, Jj, Jrho = _pair_terms(window, T_all, k, j, cfg)
    w_all = w_all * jnp.where(j == k, 0.0, 1.0)               # skip self-pair
    Jk = Jk * jnp.where(k == 0, 0.0, 1.0)                     # gauge host
    Jj = Jj * jnp.where(j == 0, 0.0, 1.0)                     # gauge target
    return r, w_all, Jk, Jj, Jrho


def host_system(window: BAWindow, T_all, k, cfg: BAConfig):
    """Schur-reduced normal-system contribution of host keyframe k (its
    pixels against every target j != k).  ``k`` may be a *traced* index —
    block placement uses one-hots along the keyframe axis, which is what
    lets hosts shard across devices (dvo_tpu.parallel.ba).

    Every pixel's inverse-depth parameter belongs to exactly one host, so
    its Schur elimination completes within this function: the coupling rows
    b_p (H, W, 6M) live only for the duration of this host and are folded
    into S_k before returning.

    Returns (S_k (6M,6M) Schur-reduced camera block, g_k (6M,) reduced
    gradient, hdd (H,W), gd (H,W), cost, count)."""
    m, h, w_px = window.gray.shape
    n = 6 * m
    oh_k = jax.nn.one_hot(k, m, dtype=jnp.float32)           # (M,)

    def target(carry, j):
        Hblk, gc, b_host, hdd, gd, cost, count = carry
        r, w_all, Jk, Jj, Jrho = _gated_pair_terms(window, T_all, k, j, cfg)
        oh_j = jax.nn.one_hot(j, m, dtype=jnp.float32)
        wJk = Jk * w_all[..., None]
        wJj = Jj * w_all[..., None]
        # 6x6 blocks; placement via tiny (M,M) one-hot outers.
        Hkk = jnp.einsum("hwi,hwj->ij", wJk, Jk, precision=_HI)
        Hkj = jnp.einsum("hwi,hwj->ij", wJk, Jj, precision=_HI)
        Hjj = jnp.einsum("hwi,hwj->ij", wJj, Jj, precision=_HI)
        Hblk = (
            Hblk
            + jnp.einsum("a,b,ij->abij", oh_k, oh_k, Hkk, precision=_HI)
            + jnp.einsum("a,b,ij->abij", oh_k, oh_j, Hkj, precision=_HI)
            + jnp.einsum("a,b,ij->abij", oh_j, oh_k, Hkj.T, precision=_HI)
            + jnp.einsum("a,b,ij->abij", oh_j, oh_j, Hjj, precision=_HI)
        )
        gk = jnp.einsum("hwi,hw->i", wJk, r, precision=_HI)
        gj = jnp.einsum("hwi,hw->i", wJj, r, precision=_HI)
        gc = gc + oh_k[:, None] * gk + oh_j[:, None] * gj
        # Coupling rows: block k and block j both accumulate over targets.
        wJrho = w_all * Jrho
        b_host = b_host + (
            oh_k[:, None] * (Jk * wJrho[..., None])[..., None, :]
            + oh_j[:, None] * (Jj * wJrho[..., None])[..., None, :]
        )
        hdd = hdd + wJrho * Jrho
        gd = gd + wJrho * r
        cost = cost + jnp.sum(w_all * r * r)
        count = count + jnp.sum((w_all > 0).astype(jnp.int32))
        return (Hblk, gc, b_host, hdd, gd, cost, count), None

    init = (
        jnp.zeros((m, m, 6, 6), jnp.float32),
        jnp.zeros((m, 6), jnp.float32),
        jnp.zeros((h, w_px, m, 6), jnp.float32),
        jnp.zeros((h, w_px), jnp.float32),
        jnp.zeros((h, w_px), jnp.float32),
        jnp.asarray(0.0, jnp.float32),
        jnp.asarray(0, jnp.int32),
    )
    (Hblk, gc, b_host, hdd, gd, cost, count), _ = lax.scan(
        target, init, jnp.arange(m)
    )
    Hcc = Hblk.transpose(0, 2, 1, 3).reshape(n, n)
    gc = gc.reshape(n)
    b_host = b_host.reshape(h, w_px, n)
    # Fold this host's pixels' depth elimination into the camera system NOW
    # and drop b_host — the Schur complement is separable per host.
    hdd_inv = 1.0 / (hdd + cfg.depth_damping)
    S_k = Hcc - jnp.einsum("hwi,hwj,hw->ij", b_host, b_host, hdd_inv,
                           precision=_HI)
    g_k = gc - jnp.einsum("hwi,hw,hw->i", b_host, gd, hdd_inv, precision=_HI)
    return S_k, g_k, hdd, gd, cost, count


def coupling_dot(window: BAWindow, T_all, k, dc, cfg: BAConfig):
    """Per-pixel coupling dot b_p . dc for host keyframe k, recomputed from
    the pair terms (the rows themselves are never stored across hosts).
    ``dc`` is the solved (6M,) camera increment.  Returns (H, W)."""
    m = window.gray.shape[0]
    dc_m = dc.reshape(m, 6)

    def target(bdot, j):
        _, w_all, Jk, Jj, Jrho = _gated_pair_terms(window, T_all, k, j, cfg)
        dot = (
            jnp.einsum("hwi,i->hw", Jk, dc_m[k], precision=_HI)
            + jnp.einsum("hwi,i->hw", Jj, dc_m[j], precision=_HI)
        )
        return bdot + w_all * Jrho * dot, None

    bdot0 = jnp.zeros(window.gray.shape[1:], jnp.float32)
    bdot, _ = lax.scan(target, bdot0, jnp.arange(m))
    return bdot


def build_system(window: BAWindow, deltas, drho, cfg: BAConfig):
    """Accumulate the Schur-reduced BA system at the current increments.

    Returns (S (6M,6M), g_red (6M,), hdd (M,H,W), gd (M,H,W), cost, count).
    Peak memory is one host's coupling rows (H, W, 6M) — nothing scales as
    M * H * W * 6M."""
    m, h, w_px = window.gray.shape
    window, T_all = _current_window(window, deltas, drho)
    n = 6 * m

    def host(carry, k):
        S, g_red, cost, count = carry
        Sk, gk, hddk, gdk, ck, nk = host_system(window, T_all, k, cfg)
        return (S + Sk, g_red + gk, cost + ck, count + nk), (hddk, gdk)

    init = (
        jnp.zeros((n, n), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.asarray(0.0, jnp.float32),
        jnp.asarray(0, jnp.int32),
    )
    (S, g_red, cost, count), (hdd, gd) = lax.scan(host, init, jnp.arange(m))
    return S, g_red, hdd, gd, cost, count


def ba_step(window: BAWindow, deltas, drho, cfg: BAConfig):
    """One damped GN step with Schur elimination of the depth block.
    Returns (new_deltas, new_drho, cost, count)."""
    m, h, w_px = window.gray.shape
    n = 6 * m
    win_cur, T_all = _current_window(window, deltas, drho)
    S, g_red, hdd, gd, cost, count = build_system(window, deltas, drho, cfg)

    S = S + cfg.damping * jnp.eye(n, dtype=S.dtype)
    # Gauge block: keep keyframe 0 pinned via identity rows.
    S = S.at[:6, :6].add(jnp.eye(6, dtype=S.dtype))
    # Sign: residual convention r(delta) with dr/ddelta = J gives the GN
    # step delta = -(S)^-1 g.
    dc = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(S), g_red)
    # Back-substitute inverse-depth increments; the coupling dot is
    # recomputed per host (see coupling_dot) instead of stored.
    hdd_inv = 1.0 / (hdd + cfg.depth_damping)
    bdot = lax.map(
        lambda k: coupling_dot(win_cur, T_all, k, dc, cfg), jnp.arange(m)
    )
    d_drho = -(gd + bdot) * hdd_inv

    new_deltas = jax.vmap(lie.compose)(deltas, dc.reshape(m, 6))
    new_drho = drho + d_drho
    return new_deltas, new_drho, cost, count


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BAResult:
    xi: jax.Array       # (M, 6) refined world pose twists
    depth: jax.Array    # (M, H, W) refined depths
    costs: jax.Array    # (iters,) weighted photometric cost per iteration
    counts: jax.Array   # (iters,) active residual count


def bundle_adjust(window: BAWindow, cfg: BAConfig = BAConfig()) -> BAResult:
    """Run ``cfg.iterations`` damped GN steps as a ``lax.scan`` (one
    compiled step body regardless of iteration count)."""
    m, h, w_px = window.gray.shape

    def body(carry, _):
        deltas, drho = carry
        deltas, drho, cost, count = ba_step(window, deltas, drho, cfg)
        return (deltas, drho), (cost, count)

    init = (jnp.zeros((m, 6), jnp.float32), jnp.zeros((m, h, w_px), jnp.float32))
    (deltas, drho), (costs, counts) = lax.scan(
        body, init, None, length=cfg.iterations
    )
    xi = jax.vmap(lambda x, d: lie.compose(x, d))(window.xi, deltas)
    safe_d = jnp.maximum(window.depth, 1e-3)
    depth = 1.0 / jnp.maximum(1.0 / safe_d + drho, 1e-4)
    return BAResult(xi=xi, depth=depth, costs=costs, counts=counts)
