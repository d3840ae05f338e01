"""Tile-sharded photometric GN tracking.

The dense per-pixel linearization (models/tracker.gn_terms) is embarrassingly
parallel over pixels; across devices we shard image *rows* on the ``tile``
mesh axis.  Per device: its row block of (obj gray/mask, ref depth/sigma)
plus a replicated copy of the gather targets (ref gray/gradients — warped
points cross tile boundaries, and at VO resolutions the whole image is a few
hundred KB, far cheaper to replicate than to halo-exchange).  The only
communication is a ``psum`` of the 6x6 normal matrix, the 6-vector gradient,
and two scalars — a ~200-byte payload per GN iteration.

This is the scaling pattern the single-chip pipeline shares all math with:
``gn_terms`` is literally the same function, called with a row offset.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from dvo_tpu import lie
from dvo_tpu.config import TrackerConfig
from dvo_tpu.models.frame import Frame, Scene
from dvo_tpu.models.tracker import TrackResult, gn_solve, gn_terms


def sharded_gn_normal_equations(
    obj: Scene,
    ref: Scene,
    xi: jax.Array,
    level_index: int,
    cfg: TrackerConfig,
    mesh: Mesh,
    axis: str = "tile",
):
    """One linearization with rows sharded over ``axis``; returns the same
    (H, g, residual_sum, count) as the single-device path (psum-reduced)."""
    n_tiles = mesh.shape[axis]
    h, w = ref.shape
    assert h % n_tiles == 0, f"image height {h} not divisible by {n_tiles} tiles"
    block_h = h // n_tiles

    row_sharded = P(axis, None)
    replicated = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            row_sharded, row_sharded, row_sharded, row_sharded,  # obj g/m, ref d/s
            replicated, replicated, replicated, replicated, replicated,  # gather targets
            replicated, replicated,  # K, xi
        ),
        out_specs=(replicated, replicated, replicated, replicated),
        check_vma=False,
    )
    def block(og, om, rd, rs, rg, rm, rgx, rgy, rgm, K, xi_):
        y0 = lax.axis_index(axis) * block_h
        Hm, g, rsum, count = gn_terms(
            og, om, rd, rs, rg, rm, rgx, rgy, rgm, K, xi_,
            level_index, cfg, y_offset=y0, full_shape=(h, w),
        )
        return (
            lax.psum(Hm, axis),
            lax.psum(g, axis),
            lax.psum(rsum, axis),
            lax.psum(count, axis),
        )

    return block(
        obj.gray, obj.mask, ref.depth, ref.sigma,
        ref.gray, ref.mask, ref.gx, ref.gy, ref.gmask,
        ref.K, xi,
    )


def sharded_track_level(obj, ref, xi0, level_index, cfg, mesh, axis="tile"):
    def body(carry, _):
        xi, done = carry
        Hm, g, rsum, count = sharded_gn_normal_equations(
            obj, ref, xi, level_index, cfg, mesh, axis
        )
        delta = gn_solve(Hm, g, count, cfg.damping)
        new_xi = lie.compose(xi, delta)
        new_xi = jnp.where(lie.is_finite_xi(new_xi), new_xi, xi)
        xi_out = jnp.where(done, xi, new_xi)
        mean_res = jnp.where(count > 0, rsum / jnp.maximum(count, 1), -1.0)
        upd = jnp.linalg.norm(delta)
        converged = (upd < cfg.min_update_norm) | (mean_res < cfg.min_residual) | (count == 0)
        return (xi_out, done | converged), (mean_res, upd, count)

    (xi, _), stats = lax.scan(
        body, (xi0, jnp.asarray(False)), None, length=cfg.max_iterations
    )
    return xi, stats


def sharded_track(
    obj_frame: Frame,
    ref_frame: Frame,
    cfg: TrackerConfig,
    mesh: Mesh,
    axis: str = "tile",
) -> jax.Array:
    """Coarse-to-fine track with every level's linearization tile-sharded.
    Levels whose height does not divide the tile count run replicated (the
    coarsest levels are a few hundred pixels — not worth sharding)."""
    from dvo_tpu.models.tracker import track_level

    n_tiles = mesh.shape[axis]
    xi = jnp.zeros(6, jnp.float32)
    for level in range(len(ref_frame.scenes)):
        obj, ref = obj_frame.scenes[level], ref_frame.scenes[level]
        if ref.shape[0] % n_tiles == 0 and ref.shape[0] >= 4 * n_tiles:
            xi, _ = sharded_track_level(obj, ref, xi, level, cfg, mesh, axis)
        else:
            xi, _ = track_level(obj, ref, xi, level, cfg)
    return xi
