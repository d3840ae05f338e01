"""Visual odometry orchestration — the reference ``System::VisualOdometry``
(include/system/system.hpp:12-104) as pure-functional per-frame steps.

Two modes, matching the reference:

* ``monocular_*`` — full pipeline (system.hpp:44-74): track against the
  newest keyframe, compose the world pose, then map (keyframe promotion via
  propagate, or per-pixel depth update) and regularize.  Depth is
  bootstrapped from clamped Gaussian noise and refined by the mapper.
* ``rgbd_*`` — tracking-only frame-to-frame mode (odometrizeUsingDepth,
  system.hpp:77-93): every frame becomes the next reference; no mapper.

The entire per-frame step — tracking loop, mapping branch (``lax.cond``),
regularization — is one jitted device program; only trajectory IO and the
one-time initialisation live on host (SURVEY.md §7 "Host/device
boundary").
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from dvo_tpu import lie
from dvo_tpu.config import DVOConfig
from dvo_tpu.models.frame import (
    Frame,
    build_frame,
    build_frame_with_depth,
    with_depth,
    with_pose,
)
from dvo_tpu.models.history import KeyframeHistory, push, refresh_head, write_back
from dvo_tpu.models.mapper import (
    DepthUpdateStats,
    depth_update,
    need_new_keyframe,
    propagate,
    regularize,
)
from dvo_tpu.models.tracker import TrackResult, track


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VOState:
    """Persistent monocular VO state (device-resident across frames)."""

    history: KeyframeHistory
    ref: Frame            # current reference keyframe
    key: jax.Array        # PRNG state (depth bootstrap + filter resets)
    frame_count: jax.Array  # () int32 — id of the next frame
    prev_rel: jax.Array   # (6,) previous frame's twist vs the current ref
    vel: jax.Array        # (6,) last frame-to-frame twist (warm-start prior)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StepResult:
    T_world: jax.Array        # (4, 4) world pose of this frame
    relative_xi: jax.Array    # (6,) twist vs the reference keyframe
    is_keyframe: jax.Array    # () bool — frame promoted to keyframe
    tracking: TrackResult
    mapping: DepthUpdateStats
    ba_cost: jax.Array        # () final windowed-BA cost; -1 when BA not run
    # (window, 6) BA-refined window poses when this step ran BA (ba_cost
    # >= 0), zeros otherwise; (0, 6) when cfg.ba.enabled is False.  Lets
    # the pose-graph harvester build BA-window edges from chunked
    # StepResults without a ring fetch at each promotion (the ring's xi at
    # chunk end has been rewritten by LATER promotions' BA solves).
    ba_window_xi: jax.Array


# ------------------------------------------------------------------ monocular

def monocular_init(gray, mask, K, key, cfg: DVOConfig = DVOConfig.monocular()) -> VOState:
    """First frame becomes the keyframe with identity pose
    (system.hpp:49-54)."""
    key, sub = jax.random.split(key)
    frame = build_frame(
        gray, mask, K, cfg.pyramid.levels, cfg.pyramid.culls, sub, 0, cfg.init
    )
    h, w = frame.base.shape
    history = push(KeyframeHistory.create(cfg.mapper.history_capacity, h, w), frame)
    return VOState(
        history=history, ref=frame, key=key,
        frame_count=jnp.asarray(1, jnp.int32),
        prev_rel=jnp.zeros(6, jnp.float32), vel=jnp.zeros(6, jnp.float32),
    )


def monocular_init_with_depth(
    gray, mask, depth, sigma, K, key, cfg: DVOConfig = DVOConfig.monocular()
) -> VOState:
    """Full monocular pipeline seeded with *measured* initial depth — the
    reference's third mode (system.hpp:24-32, used by test/kinect-vo.cpp):
    the first keyframe carries sensor depth/sigma instead of random
    bootstrap; subsequent frames run the ordinary ``monocular_step``.

    Divergence from the reference (documented fix): it builds this first
    keyframe with (levels=4, culls=1) while tracking frames use (3, 2) —
    mixed resolutions that only line up by accident of its pyramid
    indexing.  Here the keyframe uses the same pyramid config as every
    other frame."""
    frame = build_frame_with_depth(
        gray, mask, depth, sigma, K, cfg.pyramid.levels, cfg.pyramid.culls, 0
    )
    h, w = frame.base.shape
    history = push(KeyframeHistory.create(cfg.mapper.history_capacity, h, w), frame)
    return VOState(
        history=history, ref=frame, key=key,
        frame_count=jnp.asarray(1, jnp.int32),
        prev_rel=jnp.zeros(6, jnp.float32), vel=jnp.zeros(6, jnp.float32),
    )


@partial(jax.jit, static_argnames="cfg")
def monocular_step(state: VOState, gray, mask, K, cfg: DVOConfig = DVOConfig.monocular()):
    """One full frame: track -> pose -> map -> regularize
    (system.hpp:44-74 + mapper.cpp:16-33).  Returns (state', StepResult)."""
    key, k_frame, k_reset = jax.random.split(state.key, 3)
    # Gradients deferred: only the promote branch needs this frame's
    # gradient pyramid (frame.with_gradients there) — tracking reads the
    # REFERENCE's gradients, so ~5 of 6 frames skip the stencil work.
    frame = build_frame(
        gray, mask, K, cfg.pyramid.levels, cfg.pyramid.culls,
        k_frame, state.frame_count, cfg.init, with_grads=False,
    )

    # --- tracking (system.hpp:57-58) ---
    if cfg.tracker.warm_start:
        # Constant-velocity prior (config.py warm_start): discard
        # implausibly large priors rather than risk leaving the basin.
        xi0 = lie.compose(state.prev_rel, state.vel)
        xi0 = jnp.where(
            jnp.linalg.norm(xi0) < cfg.tracker.warm_start_max_norm,
            xi0, jnp.zeros(6, jnp.float32),
        )
    else:
        xi0 = None
    tr = track(frame, state.ref, cfg.tracker, xi0=xi0)
    frame = with_pose(frame, tr.xi, state.ref.xi)
    vel = lie.compose(-state.prev_rel, tr.xi)

    # --- mapping (mapper.cpp:16-33) ---
    need_kf = need_new_keyframe(
        tr.xi, frame.frame_id, state.ref.frame_id, cfg.mapper
    )
    zero_stats = DepthUpdateStats.zero()

    no_ba_cost = jnp.asarray(-1.0, jnp.float32)
    no_win_xi = jnp.zeros(
        (cfg.ba.window if cfg.ba.enabled else 0, 6), jnp.float32
    )

    def promote(_):
        base = state.ref.base
        d, s, age = propagate(
            base.depth, base.sigma, state.ref.age, frame.relative_xi, base.K,
            cfg.mapper, cfg.init,
        )
        from dvo_tpu.models.frame import with_gradients

        new_ref = with_gradients(with_depth(frame, d, s, age))
        # The outgoing keyframe's ring slot still holds its push-time maps;
        # write its final (depth-updated, regularized) state back before the
        # new keyframe joins, so the BA window sees current data.
        hist = push(refresh_head(state.history, state.ref), new_ref)

        if cfg.ba.enabled:
            # Windowed BA on keyframe promotion (hook point:
            # reference mapper.cpp:16-33): refine the newest `window`
            # keyframe poses + depth maps, write back into the ring, and
            # carry the refined pose/depth into the new reference keyframe.
            from dvo_tpu.models.ba import (
                bundle_adjust,
                window_from_history,
                window_slots,
            )

            def run_ba(h_r):
                h, r = h_r
                win = window_from_history(h, r.base.K, cfg.ba.window)
                res = bundle_adjust(win, cfg.ba)
                h = write_back(h, window_slots(h, cfg.ba.window), res.xi, res.depth)
                # Newest window entry (== the just-pushed reference).
                r = dataclasses.replace(
                    with_depth(r, res.depth[-1]), xi=res.xi[-1]
                )
                return h, r, res.costs[-1], res.xi

            def skip_ba(h_r):
                return h_r[0], h_r[1], no_ba_cost, no_win_xi

            hist, new_ref, cost, win_xi = lax.cond(
                hist.count >= cfg.ba.window, run_ba, skip_ba, (hist, new_ref)
            )
        else:
            cost, win_xi = no_ba_cost, no_win_xi
        return hist, new_ref, zero_stats, cost, win_xi

    def update(_):
        base = state.ref.base
        d, s, age, stats = depth_update(
            frame.base, frame.xi, frame.relative_xi,
            base.depth, base.sigma, state.ref.age,
            state.history, k_reset, cfg.mapper,
        )
        return (state.history, with_depth(state.ref, d, s, age), stats,
                no_ba_cost, no_win_xi)

    history, ref, stats, ba_cost, ba_win_xi = lax.cond(
        need_kf, promote, update, None
    )

    # --- regularize the reference keyframe (mapper.cpp:30,139-144) ---
    ref = with_depth(ref, regularize(ref.base.depth, ref.base.sigma, cfg.mapper))

    new_state = VOState(
        history=history, ref=ref, key=key, frame_count=state.frame_count + 1,
        # On promotion this frame IS the new reference: the next frame's
        # twist starts from identity with the frame-to-frame velocity as
        # its prior (warm_start).
        prev_rel=jnp.where(need_kf, jnp.zeros(6, jnp.float32), tr.xi),
        vel=vel,
    )
    # When this frame was promoted, `ref` IS this frame (with its pose
    # possibly BA-refined) — emit that pose so refinements reach the
    # trajectory; otherwise the tracked pose.
    pose_xi = jnp.where(need_kf, ref.xi, frame.xi)
    result = StepResult(
        T_world=lie.se3_exp(pose_xi),
        relative_xi=tr.xi,
        is_keyframe=need_kf,
        tracking=tr,
        mapping=stats,
        ba_cost=ba_cost,
        ba_window_xi=ba_win_xi,
    )
    return new_state, result


def _cull_chunk(cfg: DVOConfig, K, *stacks):
    """Hoist the 2**culls input decimation OUT of the scan: one batched
    stride over the whole (N, H, W) chunk instead of a per-frame strided
    slice of an HBM-resident stack inside the scan body.  Bit-identical
    (the base pyramid level IS the culled input, frame.py), and it keeps
    strided reads of full-resolution frames out of every scan step.
    Returns (cfg with culls=0, culled K, culled stacks)."""
    from dvo_tpu.ops.image import cull_image, cull_intrinsic

    culls = cfg.pyramid.culls
    if not culls:
        return cfg, K, stacks
    cfg = dataclasses.replace(
        cfg, pyramid=dataclasses.replace(cfg.pyramid, culls=0)
    )
    return (
        cfg, cull_intrinsic(K, culls),
        tuple(cull_image(s, culls) if s is not None else None
              for s in stacks),
    )


@partial(jax.jit, static_argnames="cfg")
def monocular_run(state: VOState, grays, masks, K, cfg: DVOConfig = DVOConfig.monocular()):
    """Device-resident sequence driver: ``lax.scan`` of ``monocular_step``
    over a stacked chunk of frames (grays/masks: (N, H, W)).

    The reference's per-frame loop lives on host (main.cpp:36); here the
    whole chunk runs as ONE device program, so the host dispatches once per
    chunk instead of once per frame, and only the stacked ``StepResult``s
    return to host.  Returns (state', StepResult
    with a leading N axis on every field).

    ``masks`` may be (H, W) — one validity mask shared by every frame of
    the chunk (the usual case: it is the undistortion-border map, constant
    for a rig) — which saves re-shipping N identical masks per chunk to
    the device.

    The 2**culls decimation is hoisted out of the scan (``_cull_chunk``)."""
    cfg, K, (grays, masks) = _cull_chunk(cfg, K, grays, masks)
    if masks.ndim == 2:
        def step(st, g):
            return monocular_step(st, g, masks, K, cfg)

        return lax.scan(step, state, grays)

    def step(st, inp):
        g, m = inp
        st, res = monocular_step(st, g, m, K, cfg)
        return st, res

    return lax.scan(step, state, (grays, masks))


# ----------------------------------------------------------------------- RGB-D

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RGBDState:
    ref: Frame
    frame_count: jax.Array
    vel: jax.Array        # (6,) last frame-to-frame twist (warm-start prior)


def rgbd_init(gray, mask, depth, sigma, K, cfg: DVOConfig = DVOConfig.rgbd()) -> RGBDState:
    frame = build_frame_with_depth(
        gray, mask, depth, sigma, K, cfg.pyramid.levels, cfg.pyramid.culls, 0
    )
    return RGBDState(ref=frame, frame_count=jnp.asarray(1, jnp.int32),
                     vel=jnp.zeros(6, jnp.float32))


@partial(jax.jit, static_argnames="cfg")
def rgbd_step(state: RGBDState, gray, mask, depth, sigma, K, cfg: DVOConfig = DVOConfig.rgbd()):
    """Frame-to-frame tracking-only step (odometrizeUsingDepth,
    system.hpp:77-93): track vs the previous frame, which this frame then
    replaces.  Returns (state', StepResult with T_world composed)."""
    frame = build_frame_with_depth(
        gray, mask, depth, sigma, K,
        cfg.pyramid.levels, cfg.pyramid.culls, state.frame_count,
    )
    if cfg.tracker.warm_start:
        # Frame-to-frame mode: the previous relative twist IS the
        # constant-velocity prior (config.py warm_start).
        xi0 = jnp.where(
            jnp.linalg.norm(state.vel) < cfg.tracker.warm_start_max_norm,
            state.vel, jnp.zeros(6, jnp.float32),
        )
    else:
        xi0 = None
    tr = track(frame, state.ref, cfg.tracker, xi0=xi0)
    frame = with_pose(frame, tr.xi, state.ref.xi)
    result = StepResult(
        T_world=lie.se3_exp(frame.xi),
        relative_xi=tr.xi,
        is_keyframe=jnp.asarray(True),
        tracking=tr,
        mapping=DepthUpdateStats.zero(),
        ba_cost=jnp.asarray(-1.0, jnp.float32),
        ba_window_xi=jnp.zeros((0, 6), jnp.float32),
    )
    return RGBDState(ref=frame, frame_count=state.frame_count + 1,
                     vel=tr.xi), result


@partial(jax.jit, static_argnames="cfg")
def rgbd_run(state: RGBDState, grays, masks, depths, sigmas, K,
             cfg: DVOConfig = DVOConfig.rgbd()):
    """Device-resident RGB-D sequence driver: ``lax.scan`` of ``rgbd_step``
    over a stacked chunk (leading N axis on grays/masks/depths/sigmas) —
    see ``monocular_run``.  ``masks`` may be (H, W), shared by the chunk.
    The 2**culls decimation is hoisted out of the scan (``_cull_chunk``)."""
    cfg, K, (grays, masks, depths, sigmas) = _cull_chunk(
        cfg, K, grays, masks, depths, sigmas
    )
    if masks.ndim == 2:
        def step(st, inp):
            g, d, s = inp
            return rgbd_step(st, g, masks, d, s, K, cfg)

        return lax.scan(step, state, (grays, depths, sigmas))

    def step(st, inp):
        g, m, d, s = inp
        st, res = rgbd_step(st, g, m, d, s, K, cfg)
        return st, res

    return lax.scan(step, state, (grays, masks, depths, sigmas))


@partial(jax.jit, static_argnames=("cfg", "depth_scale", "depth_sigma"))
def rgbd_run_raw(state: RGBDState, grays, masks, depths_raw, K,
                 cfg: DVOConfig = DVOConfig.rgbd(),
                 depth_scale: float = 5000.0, depth_sigma: float = 0.1):
    """``rgbd_run`` fed with RAW sensor chunks: gray may be uint8 and depth
    uint16 PNG counts (TUM 1/5000 m convention, loader.cpp:145).  The
    u8->[0,1] and u16->meters conversions plus the sigma synthesis
    (depth_sigma where measured, 1.0 where missing — transform.cpp:74)
    run on device, so the host ships 3 bytes/pixel instead of 12 over the
    host->device link.

    The chunk cull is hoisted ahead of even the dtype conversions (integer
    strides commute with the scale multiply exactly), so full-res raw
    chunks never touch f32."""
    cfg, K, (grays, masks, depths_raw) = _cull_chunk(
        cfg, K, grays, masks, depths_raw
    )
    if jnp.issubdtype(depths_raw.dtype, jnp.integer):
        # Match the per-frame runner path exactly (the prefetch stream
        # multiplies decoded counts by an f32 reciprocal scale): same op,
        # same rounding, bit-identical depth.
        depths = depths_raw.astype(jnp.float32) * jnp.float32(1.0 / depth_scale)
    else:
        depths = depths_raw
    sigmas = jnp.where(depths > 1e-6, depth_sigma, 1.0).astype(jnp.float32)
    return rgbd_run(state, grays, masks, depths, sigmas, K, cfg)


# ------------------------------------------------------------------- batched
#
# Multi-stream throughput mode — no reference counterpart.  The reference is
# a single-camera demo; this mode vmaps the whole per-frame step over a
# leading stream axis to serve many cameras (or replay many sequences) on
# one device.  Under vmap the mapper's ``lax.cond`` runs both arms and the
# GN ``while_loop`` runs to the slowest lane; spreading streams over
# several devices is dvo_tpu.parallel.streams' job.  Streams are
# independent (separate keyframe rings, PRNG streams, histories); a shared
# K keeps the warp geometry common (the multi-camera-rig case), while
# per-stream intrinsics work by passing K with a leading B axis.


def monocular_init_batched(grays, masks, K, key, cfg: DVOConfig = DVOConfig.monocular()):
    """Initialize B independent monocular streams.  grays/masks: (B, H, W);
    K: (3, 3) shared or (B, 3, 3); key: a single PRNG key, split per
    stream.  Returns a VOState with a leading B axis on every leaf."""
    b = grays.shape[0]
    keys = jax.random.split(key, b)
    k_axis = 0 if jnp.ndim(K) == 3 else None
    return jax.vmap(
        lambda g, m, kk, kr: monocular_init(g, m, kk, kr, cfg),
        in_axes=(0, 0, k_axis, 0),
    )(grays, masks, K, keys)


@partial(jax.jit, static_argnames="cfg")
def monocular_run_batched(states, grays, masks, K,
                          cfg: DVOConfig = DVOConfig.monocular()):
    """B-stream chunked driver: ``monocular_run`` vmapped over the stream
    axis.  grays/masks: (B, N, H, W); K: (3, 3) or (B, 3, 3).  Returns
    (states', StepResult with leading (B, N) axes)."""
    k_axis = 0 if jnp.ndim(K) == 3 else None
    return jax.vmap(
        lambda st, g, m, kk: monocular_run(st, g, m, kk, cfg),
        in_axes=(0, 0, 0, k_axis),
    )(states, grays, masks, K)
