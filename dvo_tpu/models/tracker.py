"""Coarse-to-fine photometric Gauss-Newton tracking (the frontend).

Reference: src/track/tracker.cpp (level/iteration driver) and
src/track/optimize.cpp (per-pixel residual + 1x6 Jacobian, HOT LOOP #1,
SURVEY.md §2 #14).

Redesign of the reference's execution model for a jitted device program:

* The reference stacks per-pixel Jacobian rows into a dense (H*W, 6) matrix
  and solves by SVD (optimize.cpp:17,97).  We never materialize it: the 6x6
  normal matrix J^T J and gradient J^T (w r) are accumulated directly as two
  small contractions and solved by Cholesky — a (H*W, 6) stack is pure
  memory traffic for no information.  The contractions run at HIGHEST
  precision: an f32 dot on a GPU may otherwise run in TF32 (~3 decimal
  digits), which biases a 6x6 system summed over tens of thousands of
  pixels.
* The reference's per-iteration early exits (residual / update-norm /
  wall-clock, tracker.cpp:68-73) become a device-side ``lax.while_loop``
  (or a fixed-length masked ``lax.scan``) with a convergence test —
  deterministic and jit-compilable.  The wall-clock exit is dropped
  (report, don't branch).
* Per-pixel skip conditions (optimize.cpp:33-63) become one boolean mask.

Sign convention: with r = I_ref(warp(-xi, x)) - I_obj(x) and the standard
direct-method Jacobian J (optimize.cpp:67-77), dr/dxi = -J, so the GN update
is delta = +(J^T J)^-1 J^T (w r) — this reproduces the reference's
``-cv::solve(A, -B)`` double negation (optimize.cpp:97-98), and xi steps by
right-composition: xi <- log(exp(xi) exp(delta)) (tracker.cpp:46).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dvo_tpu import lie
from dvo_tpu.config import TrackerConfig
from dvo_tpu.models.frame import Frame, Scene
from dvo_tpu.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu.ops.warp import back_project, pixel_grid, warp_points


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrackResult:
    xi: jax.Array            # (6,) relative pose obj -> ref
    residuals: jax.Array     # (levels, iters) mean squared residual per iter
    update_norms: jax.Array  # (levels, iters)
    valid_counts: jax.Array  # (levels, iters) int32
    iterations: jax.Array    # (levels,) iterations actually used


def gn_terms(
    obj_gray, obj_mask,
    ref_depth, ref_sigma,
    ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
    K, xi,
    level_index: int,
    cfg: TrackerConfig,
    y_offset=0,
    full_shape=None,
):
    """Normal-equation terms for a row block of pixels.

    ``obj_gray/obj_mask/ref_depth/ref_sigma`` cover rows
    [y_offset, y_offset + block_h) of the image; the gather targets
    (``ref_gray``/gradients) are always the full image — warped points cross
    block boundaries.  ``full_shape`` is the (H, W) of the full image
    (defaults to the block's own shape).  This split is what lets the same
    math run single-device (one block = whole image) and tile-sharded across
    a mesh axis with a final psum (dvo_tpu.parallel.tracking).
    """
    bh, w = obj_gray.shape
    full_h, full_w = full_shape if full_shape is not None else (bh, w)
    xs, ys = pixel_grid(bh, w)
    ys = ys + y_offset
    xy = jnp.stack([xs, ys], axis=-1)
    depth = ref_depth

    # --- warped source coordinates under exp(-xi) (optimize.cpp:51) ---
    T_inv = lie.se3_exp(-xi)
    warped_xy, in_front = warp_points(T_inv, xy, depth, K)
    wx, wy = warped_xy[..., 0], warped_xy[..., 1]

    # --- gather samples ---
    i2, i2_valid = bilinear_masked(ref_gray, ref_mask, wx, wy)
    gx, _ = bilinear_dense(ref_gx, wx, wy)
    gy, _ = bilinear_dense(ref_gy, wx, wy)
    gmask_f, _ = bilinear_dense(ref_gmask.astype(jnp.float32), wx, wy)
    grad_ok = gmask_f > 1.0 - 1e-4   # every contributing corner valid

    # --- validity mask (optimize.cpp:33-63) ---
    valid = depth >= cfg.min_depth                       # :39
    valid &= obj_mask & i2_valid                         # :44-48 luminance
    valid &= (wx >= 0) & (wx < full_w) & (wy >= 0) & (wy < full_h)  # :51-56
    valid &= in_front & grad_ok                          # :58-63 gradient
    if level_index == cfg.crop_level:                    # :33-36 crop
        x0, x1 = cfg.crop_x
        y0, y1 = cfg.crop_y
        valid &= (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)

    # --- Jacobian (optimize.cpp:67-77) ---
    pc = back_project(K, xy, depth)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    fx, fy = K[0, 0], K[1, 1]
    fgx = fx * gx
    fgy = fy * gy
    xz = x / z
    yz = y / z
    J = jnp.stack(
        [
            fgx / z,
            fgy / z,
            -(fgx * x + fgy * y) / (z * z),
            -fgx * xz * yz - fgy * (1.0 + yz * yz),
            fgx * (1.0 + xz * xz) + fgy * xz * yz,
            -fgx * yz + fgy * xz,
        ],
        axis=-1,
    )  # (bh, W, 6)

    r = i2 - obj_gray                                     # :79
    step = cfg.level_steps[min(level_index, len(cfg.level_steps) - 1)]
    weight = step / jnp.clip(ref_sigma, *cfg.sigma_clamp)  # :83-84

    vf = valid.astype(jnp.float32)
    Jm = J * vf[..., None]
    hi = lax.Precision.HIGHEST
    if cfg.compat_weight_b_only:
        # Faithful: weight enters the RHS only (optimize.cpp:87-89).
        Hmat = jnp.einsum("hwi,hwj->ij", Jm, Jm, precision=hi)
        g = jnp.einsum("hwi,hw->i", Jm, r * weight * vf, precision=hi)
    else:
        wf = weight * vf
        Hmat = jnp.einsum("hwi,hwj->ij", Jm * wf[..., None], Jm, precision=hi)
        g = jnp.einsum("hwi,hw->i", Jm, r * wf, precision=hi)
    residual_sum = jnp.sum(r * r * vf)                    # :80
    count = jnp.sum(valid.astype(jnp.int32))
    return Hmat, g, residual_sum, count


def gn_normal_equations(
    obj: Scene,
    ref: Scene,
    xi: jax.Array,
    level_index: int,
    cfg: TrackerConfig,
):
    """One linearization over the whole image: masked per-pixel residual +
    Jacobian accumulated to (H (6,6), g (6,), residual_sum, valid_count).
    Mirrors optimize.cpp:28-90 exactly (gates, weighting, Jacobian), but
    evaluates all pixels as dense vector ops."""
    return gn_terms(
        obj.gray, obj.mask, ref.depth, ref.sigma,
        ref.gray, ref.mask, ref.gx, ref.gy, ref.gmask,
        ref.K, xi, level_index, cfg,
    )


def gn_solve(Hmat, g, count, damping: float):
    """delta = (H + lambda I)^-1 g; zero update when no valid pixels
    (reference returns a zero twist then, optimize.cpp:93-94)."""
    A = Hmat + damping * jnp.eye(6, dtype=Hmat.dtype)
    delta = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(A), g)
    return jnp.where(count > 0, delta, jnp.zeros_like(delta))


def _gn_iteration(obj, ref, xi, level_index, cfg):
    """One linearize-solve-compose GN step.  Returns
    (new_xi, mean_res, update_norm, count, converged)."""
    Hmat, g, rsum, count = gn_normal_equations(obj, ref, xi, level_index, cfg)
    delta = gn_solve(Hmat, g, count, cfg.damping)
    new_xi = lie.compose(xi, delta)
    # NaN guard: keep previous xi on a bad update (tracker.cpp:47-51).
    new_xi = jnp.where(lie.is_finite_xi(new_xi), new_xi, xi)

    mean_res = jnp.where(count > 0, rsum / jnp.maximum(count, 1), -1.0)
    upd = jnp.linalg.norm(delta)
    # Convergence is evaluated *after* applying the update, as in the
    # reference's post-update break (tracker.cpp:68-73).  count == 0
    # also stops (residual -1 < threshold there).
    converged = (upd < cfg.min_update_norm) | (mean_res < cfg.min_residual) | (count == 0)
    return new_xi, mean_res, upd, count, converged


def track_level(
    obj: Scene,
    ref: Scene,
    xi0: jax.Array,
    level_index: int,
    cfg: TrackerConfig,
):
    """<= max_iterations GN steps at one pyramid level (reference
    tracker.cpp:42-73).  Returns (xi, metrics).

    Two equivalent iteration drivers (identical results, same trace shape):

    * ``early_exit=True`` (default): ``lax.while_loop`` that stops at
      convergence — the reference's post-update ``break`` as a real
      device-side exit.  Typical sequences converge in 3-6 iterations, so
      this skips ~2/3 of the linearizations' device time.
    * ``early_exit=False``: fixed-length ``lax.scan`` with a freeze mask —
      constant per-call cost (useful for benchmarking a worst-case bound,
      and marginally better under heavy vmap where lanes converge at very
      different iterations and the while_loop runs to the slowest lane
      anyway).
    """
    n = cfg.max_iterations

    if cfg.early_exit:
        zeros = jnp.zeros((n,), jnp.float32)

        def cond(carry):
            i, _, done, *_ = carry
            return (i < n) & ~done

        def body(carry):
            i, xi, _, res, upd_a, cnt = carry
            new_xi, mean_res, upd, count, converged = _gn_iteration(
                obj, ref, xi, level_index, cfg
            )
            return (
                i + 1,
                new_xi,
                converged,
                res.at[i].set(mean_res),
                upd_a.at[i].set(upd),
                cnt.at[i].set(count),
            )

        iters, xi, _, res, upd, cnt = lax.while_loop(
            cond,
            body,
            (jnp.int32(0), xi0, jnp.asarray(False), zeros, zeros,
             jnp.zeros((n,), jnp.int32)),
        )
        return xi, (res, upd, cnt, iters)

    def body(carry, _):
        xi, done = carry
        new_xi, mean_res, upd, count, converged = _gn_iteration(
            obj, ref, xi, level_index, cfg
        )
        xi_out = jnp.where(done, xi, new_xi)
        new_done = done | converged
        stats = (
            jnp.where(done, 0.0, mean_res),
            jnp.where(done, 0.0, upd),
            jnp.where(done, 0, count),
            (~done).astype(jnp.int32),
        )
        return (xi_out, new_done), stats

    (xi, _), (res, upd, cnt, active) = lax.scan(
        body, (xi0, jnp.asarray(False)), None, length=cfg.max_iterations
    )
    return xi, (res, upd, cnt, jnp.sum(active))


def track(
    obj_frame: Frame,
    ref_frame: Frame,
    cfg: TrackerConfig = TrackerConfig(),
    xi0: jax.Array | None = None,
) -> TrackResult:
    """Full coarse-to-fine track: level 0 (coarsest) -> finest, xi carried
    across levels (reference tracker.cpp:22-84).  The level loop is
    Python-unrolled under jit — levels have distinct static shapes.

    ``xi0`` optionally warm-starts the optimization (the reference always
    starts from identity, tracker.cpp:28).  The VO pipeline also starts
    from identity; callers with a motion prior — e.g. external odometry or
    a constant-velocity model — may pass it here."""
    xi = jnp.zeros(6, jnp.float32) if xi0 is None else xi0
    res_l, upd_l, cnt_l, iters_l = [], [], [], []
    for level in range(len(ref_frame.scenes)):
        xi, (res, upd, cnt, iters) = track_level(
            obj_frame.scenes[level], ref_frame.scenes[level], xi, level, cfg
        )
        res_l.append(res)
        upd_l.append(upd)
        cnt_l.append(cnt)
        iters_l.append(iters)
    return TrackResult(
        xi=xi,
        residuals=jnp.stack(res_l),
        update_norms=jnp.stack(upd_l),
        valid_counts=jnp.stack(cnt_l),
        iterations=jnp.stack(iters_l),
    )
