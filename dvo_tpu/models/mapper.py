"""Mapping backend: keyframe policy, epipolar depth observation, depth
propagation, and regularization.

Reference: src/map/mapper.cpp + src/map/implement.cpp (HOT LOOP #2,
SURVEY.md §2 #15-18).  Redesigned as dense, fixed-shape device code:

* The per-pixel epipolar search (implement.cpp:106-152, a variable-length
  1-px march with early break) becomes a fixed-length masked scan evaluated
  densely for every reference pixel at once; the 3-tap SSD window re-uses
  neighbouring line samples (offsets s-1, s, s+1), so the whole search is
  (S+2) gathers + vector ops per pixel.
* Per-pixel relative poses to the *born* keyframe (mapper.cpp:99-107) are
  computed once per ring-buffer slot (there are only ``capacity`` distinct
  born keyframes) and gathered per pixel.
* The forward-warp scatter of ``propagate`` (implement.cpp:233-252 — racy
  last-writer-wins under the reference's parallel forEach) gets
  deterministic z-buffer semantics: a single int32 key packing (quantized
  depth, source id) is scattered with ``min``, so the nearest source wins
  and ties break by source id.  Documented divergence from the reference's
  unordered races (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from dvo_tpu import lie
from dvo_tpu.config import InitConfig, MapperConfig
from dvo_tpu.models.frame import Scene
from dvo_tpu.models.history import KeyframeHistory, born_slot
from dvo_tpu.ops.depth_filter import gaussian_fuse, gaussian_update_with_reset
from dvo_tpu.ops.warp import back_project, pixel_grid, project

EPS = 1e-6


# ------------------------------------------------------------- keyframe policy

def need_new_keyframe(rel_xi, frame_id, ref_id, cfg: MapperConfig):
    """Translation > 0.02 m or >= 6 frames since the keyframe
    (mapper.cpp:45-60; the rotation criterion is an acknowledged TODO
    there).  Returns a device bool scalar."""
    moved = jnp.linalg.norm(rel_xi[:3]) > cfg.min_movement
    stale = (frame_id - ref_id) >= cfg.max_forward
    return moved | stale


# ------------------------------------------------------------------ propagate

def propagate(
    ref_depth, ref_sigma, ref_age, rel_xi, K,
    cfg: MapperConfig = MapperConfig(),
    init: InitConfig = InitConfig(),
):
    """Forward-warp the keyframe depth map into the new keyframe
    (implement.cpp:217-256): d1 = d0 + tz (pure-z approximation :244-246),
    sigma grown by (d1/d0)^4 + prediction variance (:247-248), age + 1;
    unobserved pixels initialised to depth 1, sigma 1, age 0 (:229-231).

    Deterministic collision policy: minimum depth wins (z-buffer), ties by
    source raster id."""
    h, w = ref_depth.shape
    xs, ys = pixel_grid(h, w)
    xy = jnp.stack([xs, ys], axis=-1)
    tz = rel_xi[2]

    T = lie.se3_exp(rel_xi)
    warped, in_front = project(K, lie.transform(T, back_project(K, xy, ref_depth)))
    # Point2f -> Point2i conversion in the reference rounds to nearest.
    tx = jnp.rint(warped[..., 0]).astype(jnp.int32)
    ty = jnp.rint(warped[..., 1]).astype(jnp.int32)

    valid = (jnp.abs(ref_depth) >= EPS) & in_front
    valid &= (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)

    d0 = jnp.maximum(ref_depth, 0.01)
    d1 = d0 + tz
    ratio = d1 / d0
    sig1 = jnp.sqrt(ratio ** 4 * ref_sigma ** 2 + cfg.predict_sigma ** 2)
    d1 = jnp.maximum(d1, 0.0)
    age1 = ref_age + 1

    # --- deterministic scatter-min: key = (quantized depth << 15) | src ---
    n = h * w
    src = (ys * w + xs).astype(jnp.int32).reshape(-1)
    tgt = jnp.where(valid, ty * w + tx, n).reshape(-1)  # invalid -> dummy slot
    dq = jnp.clip(jnp.rint(d1 * 4096.0), 0, (1 << 16) - 1).astype(jnp.int32)
    key = ((dq << 15) | (src.reshape(h, w) & 0x7FFF)).reshape(-1)
    key = jnp.where(valid.reshape(-1), key, jnp.iinfo(jnp.int32).max)

    slots = jnp.full((n + 1,), jnp.iinfo(jnp.int32).max, jnp.int32)
    slots = slots.at[tgt].min(key)
    written = slots[:n] != jnp.iinfo(jnp.int32).max
    winner = slots[:n] & 0x7FFF  # source raster id of the winning write

    depth_out = jnp.where(written, d1.reshape(-1)[winner], init.propagate_depth)
    sigma_out = jnp.where(written, sig1.reshape(-1)[winner], init.propagate_sigma)
    age_out = jnp.where(written, age1.reshape(-1)[winner], 0)
    return (
        depth_out.reshape(h, w),
        sigma_out.reshape(h, w),
        age_out.reshape(h, w).astype(ref_age.dtype),
    )


# ----------------------------------------------------------------- regularize

def regularize(depth, sigma, cfg: MapperConfig = MapperConfig()):
    """4-neighbour depth smoothing (implement.cpp:156-180): sequentially
    fuse left, right, down, up neighbours into each pixel with the
    compatibility-gated Gaussian (no reset), reading from the *original*
    maps; clamp the result to <= 6 m.  Only depth is returned — the
    reference's regularizer does not update sigma (mapper.cpp:139-144)."""
    h, w = depth.shape

    def _shift(img, dx, dy, fill):
        out = jnp.full_like(img, fill)
        ys0, ys1 = max(dy, 0), h + min(dy, 0)
        xs0, xs1 = max(dx, 0), w + min(dx, 0)
        return out.at[ys0:ys1, xs0:xs1].set(
            img[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
        )

    def in_bounds(dx, dy):
        m = jnp.zeros((h, w), bool)
        ys0, ys1 = max(dy, 0), h + min(dy, 0)
        xs0, xs1 = max(dx, 0), w + min(dx, 0)
        return m.at[ys0:ys1, xs0:xs1].set(True)

    mu, sg = depth, sigma
    # Neighbour order: left, right, down, up (implement.cpp:160 offsets).
    # _shift(img, sx, sy)[y, x] == img[y - sy, x - sx], so the value of the
    # neighbour at (x + dx, y + dy) is _shift(img, -dx, -dy).
    for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
        nd = _shift(depth, -dx, -dy, 0.0)
        ns = _shift(sigma, -dx, -dy, 1.0)
        ok = in_bounds(-dx, -dy)
        mu, sg, _ = gaussian_fuse(mu, sg, nd, ns, obs_valid=ok, cfg=cfg.depth_filter)
    return jnp.minimum(mu, cfg.max_depth)


# -------------------------------------------------------------- depth update

def _sample_stacked(img, slot, y0, x0, h, w):
    """Gather img[(slot, y, x)] with clamped indices."""
    return img[slot, jnp.clip(y0, 0, h - 1), jnp.clip(x0, 0, w - 1)]


def _bilinear_stacked(img, slot, x, y):
    """Dense bilinear over a (C, H, W) stack with per-point slot index —
    getSubpixelFromDense semantics (out-of-range corners fall back to the
    base corner; out-of-range base -> invalid)."""
    c, h, w = img.shape
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    in0 = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    in_x1 = x0 + 1 < w
    in_y1 = y0 + 1 < h
    g00 = _sample_stacked(img, slot, y0, x0, h, w)
    g10 = jnp.where(in_x1, _sample_stacked(img, slot, y0, x0 + 1, h, w), g00)
    g01 = jnp.where(in_y1, _sample_stacked(img, slot, y0 + 1, x0, h, w), g00)
    g11 = jnp.where(in_x1 & in_y1, _sample_stacked(img, slot, y0 + 1, x0 + 1, h, w), g00)
    top = g00 * (1 - fx) + g10 * fx
    bot = g01 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy, in0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DepthUpdateStats:
    observed: jax.Array   # pixels with a gated-valid epipolar observation
    accepted: jax.Array   # observations fused (reference "valid update" log)
    rejected: jax.Array   # observations rejected -> reset + age cleared
    aged_out: jax.Array   # pixels whose born keyframe left the ring buffer

    @staticmethod
    def zero() -> "DepthUpdateStats":
        z = jnp.asarray(0, jnp.int32)
        return DepthUpdateStats(observed=z, accepted=z, rejected=z, aged_out=z)


def depth_update(
    obj: Scene,
    obj_xi_w: jax.Array,
    rel_xi: jax.Array,
    ref_depth: jax.Array,
    ref_sigma: jax.Array,
    ref_age: jax.Array,
    history: KeyframeHistory,
    key: jax.Array,
    cfg: MapperConfig = MapperConfig(),
    y_offset=0,
    full_shape=None,
):
    """Per-pixel inverse-depth observation + fusion (Mapper::update,
    mapper.cpp:76-137).  Dense over the reference keyframe's base level.

    For each (cropped) ref pixel with depth d:
      1. warp into the current frame -> integer obj pixel (:94, cvRound);
      2. look up the keyframe the pixel was born in by age (:99-101);
      3. prior = (d - tz, sigma) (:104 — the prior lives in the *obj*
         frame; the fused result is written back to the ref pixel, a
         faithful reference quirk that is benign because update only runs
         for sub-2 cm motion);
      4. epipolar-search the born image for the obj pixel's match
         (Implement::update), triangulate, estimate sigma (Engel13 model);
      5. gate to depth in (0.2, 6), sigma in (0, 0.5) (:122);
      6. fuse via the resetting Gaussian filter; rejection clears age
         (occlusion, :124-127).

    ``ref_depth/ref_sigma/ref_age`` may be a row block starting at
    ``y_offset`` of a ``full_shape`` image (obj/history stay full-size) —
    the hook used by dvo_tpu.parallel.mapping to tile-shard this update.

    Returns (new_depth, new_sigma, new_age, DepthUpdateStats).
    """
    bh, bw = ref_depth.shape
    h, w = full_shape if full_shape is not None else (bh, bw)
    xs, ys = pixel_grid(bh, bw)
    ys = ys + y_offset
    xy = jnp.stack([xs, ys], axis=-1)
    K = obj.K
    tz = rel_xi[2]
    # Fixed march length: the reference caps at ~100 steps (:141); +2 covers
    # the SSD window's trailing offsets.
    S = cfg.max_steps + 2

    # --- 1. ref pixel -> obj pixel (rounded) ---
    T_rel = lie.se3_exp(rel_xi)
    warped, in_front = project(K, lie.transform(T_rel, back_project(K, xy, ref_depth)))
    ox = jnp.rint(warped[..., 0]).astype(jnp.int32)
    oy = jnp.rint(warped[..., 1]).astype(jnp.int32)
    in_obj = (ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)
    oxc = jnp.clip(ox, 0, w - 1)
    oyc = jnp.clip(oy, 0, h - 1)
    obj_val = obj.gray[oyc, oxc]
    obj_ok = obj.mask[oyc, oxc]

    x0c, x1c = cfg.crop_x
    y0c, y1c = cfg.crop_y
    crop = (xs >= x0c) & (xs <= x1c) & (ys >= y0c) & (ys <= y1c)
    # A pixel whose born keyframe has been evicted from the ring would
    # epipolar-search the wrong image (born_slot clamps the age); gate it
    # out and count it.  The reference's unbounded history never ages out
    # (frame.hpp:146-188) — this is the fixed ring's explicit validity rule.
    aged_ok = ref_age < history.count
    aged_out_count = jnp.sum((crop & ~aged_ok).astype(jnp.int32))
    pix_ok = crop & in_obj & in_front & obj_ok & aged_ok

    # --- 2. born keyframe (per ring slot, gathered per pixel) ---
    slot = born_slot(history, ref_age)                      # (H, W) int32
    # r_xi = compose(obj_xi_w, -born_xi) per slot (mapper.cpp:107)
    r_xi_slots = jax.vmap(lambda bx: lie.compose(obj_xi_w, -bx))(history.xi)  # (C, 6)
    T_es_slots = lie.se3_exp(-r_xi_slots)                   # (C, 4, 4) for the segment warp
    r_xi_px = r_xi_slots[slot]                              # (H, W, 6)
    T_es = T_es_slots[slot]                                 # (H, W, 4, 4)

    # --- 3. prior ---
    prior_d = ref_depth - tz
    prior_s = ref_sigma

    # --- 4a. epipolar segment in the born image (implement.cpp:23-47) ---
    obj_xyf = jnp.stack([oxc.astype(jnp.float32), oyc.astype(jnp.float32)], axis=-1)
    dmin = jnp.maximum(prior_d - prior_s, cfg.min_search_depth)
    dmax = prior_d + prior_s

    def es_endpoint(d):
        pts = lie.transform(T_es, back_project(K, obj_xyf, d))
        return project(K, pts)

    start, start_front = es_endpoint(dmax)
    end, end_front = es_endpoint(dmin)
    seg = end - start
    length = jnp.sqrt(jnp.sum(seg * seg, axis=-1) + 1e-20)
    seg_ok = (length > 1e-6) & start_front & end_front & (dmax > dmin)
    direction = seg / length[..., None]

    # --- 4b. fixed-length masked SSD march (implement.cpp:106-152) ---
    # Line samples at offsets 0..S+1; window s uses offsets s-1, s, s+1 with
    # the reference's skewed center weights (1/3, 2/3, 1) — N=3, center=2.
    born_gray = history.gray

    def sample_at(o):
        px = start[..., 0] + o * direction[..., 0]
        py = start[..., 1] + o * direction[..., 1]
        v, ok = _bilinear_stacked(born_gray, slot, px, py)
        return v, ok

    offsets = jnp.arange(0, S + 2, dtype=jnp.float32)
    samp_v, samp_ok = jax.vmap(sample_at)(offsets)          # (S+2, H, W)

    diff2 = (samp_v - obj_val[None]) ** 2
    w_win = jnp.asarray([1.0 / 3.0, 2.0 / 3.0, 1.0], jnp.float32)
    ssd = (
        w_win[0] * diff2[:S] + w_win[1] * diff2[1 : S + 1] + w_win[2] * diff2[2 : S + 2]
    )                                                        # (S, H, W) at s=1..S
    win_ok = samp_ok[:S] & samp_ok[1 : S + 1] & samp_ok[2 : S + 2]
    # March mask: sample s taken iff (s-1) < length (1-px steps from start).
    s_idx = jnp.arange(1, S + 1, dtype=jnp.float32)[:, None, None]
    in_march = (s_idx - 1.0) < length[None]
    BIG = jnp.float32(2.0 * cfg.ssd_window)                 # min_ssd init (:124)
    ssd = jnp.where(win_ok & in_march, ssd, BIG)

    best_s = jnp.argmin(ssd, axis=0)                        # first min wins ties
    min_ssd = jnp.take_along_axis(ssd, best_s[None], axis=0)[0]
    match_ok = min_ssd <= cfg.ssd_window * cfg.matching_threshold_ratio  # (:145)
    best_o = (best_s + 1).astype(jnp.float32)
    mx = start[..., 0] + best_o * direction[..., 0]
    my = start[..., 1] + best_o * direction[..., 1]
    # Reference bounds gate on the match (implement.cpp:186-190, inclusive).
    match_ok &= (mx >= 0) & (my >= 0) & (mx <= w) & (my <= h)

    # --- 4c. triangulation (depthEstimate, implement.cpp:49-71) ---
    x_q = back_project(K, obj_xyf, jnp.ones_like(prior_d))  # (H, W, 3)
    t_tw = -r_xi_px[..., :3]                                # twist translation (:57)
    R_inv = T_es[..., :3, :3]                               # exp(-r_xi) rotation (:59)
    hi = lax.Precision.HIGHEST
    r3_dot_q = jnp.einsum("hwi,hwi->hw", R_inv[..., 2, :], x_q, precision=hi)
    KRq = jnp.einsum(
        "ij,hwj->hwi", K,
        jnp.einsum("hwij,hwj->hwi", R_inv, x_q, precision=hi), precision=hi,
    )
    x_h = jnp.stack([mx, my, jnp.ones_like(mx)], axis=-1)
    a = r3_dot_q[..., None] * x_h - KRq
    Kt = jnp.einsum("ij,hwj->hwi", K, t_tw, precision=hi)
    b = t_tw[..., 2:3] * x_h - Kt
    a_dot_a = jnp.sum(a * a, axis=-1)
    new_depth = -jnp.sum(a * b, axis=-1) / jnp.where(a_dot_a < 1e-20, 1.0, a_dot_a)

    # --- 4d. sigma model (sigmaEstimate, implement.cpp:73-104) ---
    l_vec = -direction                                      # (start - end)/|l| (:80)
    alpha = (dmax - dmin) / length
    bxi = jnp.rint(mx).astype(jnp.int32)
    byi = jnp.rint(my).astype(jnp.int32)
    g_in = (bxi >= 0) & (bxi < w) & (byi >= 0) & (byi < h)
    gxv = _sample_stacked(history.gx, slot, byi, bxi, h, w)
    gyv = _sample_stacked(history.gy, slot, byi, bxi, h, w)
    g_ok = g_in & _sample_stacked(history.gmask, slot, byi, bxi, h, w)
    g_dot_l = jnp.abs(gxv * l_vec[..., 0] + gyv * l_vec[..., 1])
    gp2 = g_dot_l / length
    epi = cfg.epipolar_sigma ** 2 / jnp.maximum(g_dot_l * g_dot_l, EPS)
    lum = 2.0 * cfg.luminance_sigma ** 2 / jnp.maximum(gp2, EPS)
    new_sigma = alpha * jnp.sqrt(epi + lum)

    # --- 5. observation gates (mapper.cpp:122) ---
    obs_ok = pix_ok & seg_ok & match_ok & g_ok
    obs_ok &= (new_depth > cfg.accept_depth[0]) & (new_depth < cfg.accept_depth[1])
    obs_ok &= (new_sigma > cfg.accept_sigma[0]) & (new_sigma < cfg.accept_sigma[1])

    # --- 6. fusion with reset (mapper.cpp:124-131) ---
    fused_d, fused_s, accepted = gaussian_update_with_reset(
        key, prior_d, prior_s, new_depth, new_sigma,
        obs_valid=obs_ok, cfg=cfg.depth_filter,
    )
    write = obs_ok                                           # gate-passing pixels write
    new_depth_map = jnp.where(write, fused_d, ref_depth)
    new_sigma_map = jnp.where(write, fused_s, ref_sigma)
    rejected = write & ~accepted
    new_age = jnp.where(rejected, 0, ref_age)                # occlusion (:126)

    stats = DepthUpdateStats(
        observed=jnp.sum(obs_ok.astype(jnp.int32)),
        accepted=jnp.sum((write & accepted).astype(jnp.int32)),
        rejected=jnp.sum(rejected.astype(jnp.int32)),
        aged_out=aged_out_count,
    )
    return new_depth_map, new_sigma_map, new_age, stats
