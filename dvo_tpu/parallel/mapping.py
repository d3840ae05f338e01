"""Tile-sharded mapping: the epipolar depth update sharded over image rows.

Each device owns a row block of the reference keyframe's depth/sigma/age and
computes its epipolar observations against replicated current-frame and
born-keyframe images (the search lines roam the whole born image, and at VO
resolutions replication is far cheaper than halo exchange).  Outputs stay
row-sharded (the maps are only ever consumed row-wise); the scalar stats are
psum-reduced.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from dvo_tpu.config import MapperConfig
from dvo_tpu.models.frame import Scene
from dvo_tpu.models.history import KeyframeHistory
from dvo_tpu.models.mapper import depth_update


def sharded_depth_update(
    obj: Scene,
    obj_xi_w: jax.Array,
    rel_xi: jax.Array,
    ref_depth: jax.Array,
    ref_sigma: jax.Array,
    ref_age: jax.Array,
    history: KeyframeHistory,
    key: jax.Array,
    cfg: MapperConfig,
    mesh: Mesh,
    axis: str = "tile",
):
    """Row-sharded ``models.mapper.depth_update``; same outputs, with the
    depth/sigma/age maps sharded over ``axis`` and stats psum-reduced."""
    n_tiles = mesh.shape[axis]
    h, w = ref_depth.shape
    assert h % n_tiles == 0, f"height {h} not divisible by {n_tiles} tiles"
    block_h = h // n_tiles

    row = P(axis, None)
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, rep, row, row, row, rep, rep),
        out_specs=(row, row, row, rep),
        check_vma=False,
    )
    def block(obj_s, oxw, rxi, rd, rs, ra, hist, k):
        y0 = lax.axis_index(axis) * block_h
        # Independent reset-noise per tile: fold the tile id into the key.
        k_tile = jax.random.fold_in(k, lax.axis_index(axis))
        d, s, a, stats = depth_update(
            obj_s, oxw, rxi, rd, rs, ra, hist, k_tile, cfg,
            y_offset=y0, full_shape=(h, w),
        )
        stats = jax.tree.map(lambda v: lax.psum(v, axis), stats)
        return d, s, a, stats

    return block(obj, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age, history, key)
