"""Full-sequence drivers: run a dataset through the VO pipeline, emit a
TUM-format trajectory (the reference only draws its trajectory live,
main.cpp:49-54; we write files so ATE can be evaluated)."""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dvo_tpu.config import DVOConfig
from dvo_tpu.models.odometry import (
    monocular_init,
    monocular_init_with_depth,
    monocular_step,
    rgbd_init,
    rgbd_step,
)
from dvo_tpu.utils.datasets import (
    Calibration,
    KinectCalibration,
    build_undistort_map,
    remap_nearest,
)


# ----------------------------------------------------- chunked result plumbing
#
# The chunked drivers fetch each chunk's stacked StepResult as ONE packed
# f32 array (a single device->host transfer) instead of one transfer per
# pytree leaf, so a chunk pays one transfer latency, not a dozen.
# ``_flatten_results`` runs on device; ``_unflatten`` is free host
# reshaping.


@jax.jit
def _flatten_results(res):
    """Device-side: concat every leaf of a stacked result pytree into one
    (N, D) f32 array."""
    leaves = jax.tree_util.tree_leaves(res)
    n = leaves[0].shape[0]
    return jnp.concatenate(
        [leaf.reshape(n, -1).astype(jnp.float32) for leaf in leaves], axis=1
    )


def _unflatten_results(template, flat_np):
    """Host-side: (N, D) numpy -> pytree shaped/dtyped like ``template``.
    All integer fields are counts far below 2^24, so the f32 round-trip is
    exact."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(template)
    out, off = [], 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape[1:], dtype=np.int64))
        arr = flat_np[:, off:off + size].reshape(leaf.shape)
        out.append(arr.astype(leaf.dtype))
        off += size
    return jax.tree_util.tree_unflatten(treedef, out)


class _ChunkDrain:
    """Pipelined chunk-result consumer: ``push`` dispatches the flatten for
    the *current* chunk and consumes the *previous* chunk's packed results
    (so the device runs chunk k+1 while the host walks chunk k's rows);
    ``finish`` drains the final chunk.  ``on_chunk_done(first_index,
    count, aux)`` (optional) fires after a chunk's rows are consumed with
    the aux device value passed to ``push`` (fetched lazily here — used by
    the pose-graph harvester for its once-per-chunk ring snapshot)."""

    def __init__(self, on_frame, on_chunk_done=None):
        self._on_frame = on_frame   # on_frame(frame_index, result_row)
        self._on_chunk_done = on_chunk_done
        self._pending = None

    def push(self, res, first_index, count, aux=None):
        flat = _flatten_results(res)
        prev, self._pending = (
            self._pending, (res, flat, first_index, count, aux)
        )
        if prev is not None:
            self._consume(*prev)

    def finish(self):
        if self._pending is not None:
            self._consume(*self._pending)
            self._pending = None

    def _consume(self, res, flat, first_index, count, aux):
        host = _unflatten_results(res, np.asarray(flat))
        for k in range(count):
            row = jax.tree_util.tree_map(lambda a: a[k], host)
            self._on_frame(first_index + k, row)
        if self._on_chunk_done is not None:
            self._on_chunk_done(first_index, count, aux)


def _run_chunks(n_steps, chunk, alloc, fill_row, dispatch, on_frame,
                on_chunk_done=None, make_aux=None, before_dispatch=None):
    """Drive ``n_steps // chunk`` full chunks through the device: fill host
    buffers from the (prefetching) stream, dispatch the chunk program
    (async), and consume the PREVIOUS chunk's packed results while the
    device runs — decode, transfer, execution, and result drain all
    overlap.  Returns (steps_consumed, per_chunk_wall_seconds); the first
    chunk's wall usually carries the one-time program compile, so callers
    should report steady-state throughput from the per-chunk medians (the
    per-frame tail remains for the caller).

    Pose-graph hooks: ``before_dispatch()`` runs right before each chunk
    dispatch (where live-refinement corrections apply to the device
    state); ``make_aux()`` runs right after (its device value rides the
    drain and is fetched in ``on_chunk_done`` — the per-chunk keyframe-ring
    snapshot)."""
    drain = _ChunkDrain(on_frame, on_chunk_done)
    done = 0
    chunk_walls = []
    t_prev = time.perf_counter()
    for _ in range(n_steps // chunk):
        bufs = alloc()
        for k in range(chunk):
            fill_row(bufs, k)
        if before_dispatch is not None:
            before_dispatch()
        res = dispatch(bufs)
        aux = make_aux() if make_aux is not None else None
        drain.push(res, done, chunk, aux)
        done += chunk
        t_now = time.perf_counter()
        chunk_walls.append(t_now - t_prev)
        t_prev = t_now
    drain.finish()
    if chunk_walls:
        # The final drain waits for the last chunk's execution.
        chunk_walls[-1] += time.perf_counter() - t_prev
    return done, chunk_walls


def _png_dims(path):
    """(h, w) of a PNG from its header only (no pixel decode)."""
    from dvo_tpu.utils.png import png_size

    return png_size(path)


def _composed_cull_map(srcmap, first_path, st: int):
    """Compose undistortion with a 2**culls point-sample stride into ONE
    dest->src map, so the native loader emits pre-culled frames directly
    (16x less remap work at the monocular operating point and 4**culls
    less host->device traffic; round-4 shipped full-res then strided in
    Python).  EXACT: the culled map's dest pixel (y, x) carries the same
    source coordinate the full-res map had at (st*y, st*x), i.e. the
    remap of the culled map equals ``remap_full[::st, ::st]`` pixel for
    pixel.  ``srcmap=None`` (no undistortion) synthesizes the identity
    stride map from the first frame's PNG header dims."""
    if srcmap is not None:
        return np.ascontiguousarray(srcmap[::st, ::st]) if st > 1 else srcmap
    if st <= 1:
        return None
    h, w = _png_dims(first_path)
    xs = np.arange(0, w, st, dtype=np.float32)
    ys = np.arange(0, h, st, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.ascontiguousarray(np.stack([gx, gy], axis=-1))


def _image_stream(paths, scale, srcmap, loaders=()):
    """Yield (image f32, valid bool) per path, decoding (+undistorting) on
    the native C++ prefetch threads when ``libdvonative.so`` is available
    (dvo_tpu.native, reference src/core/loader.cpp's threaded role) so the
    main thread overlaps decode with device work.  Falls back to the
    numpy + zlib decoder (utils/png.py) per file on the host otherwise.  ``loaders`` collects the live
    PrefetchLoader so callers can close it."""
    try:
        from dvo_tpu import native

        loader = native.PrefetchLoader(
            list(paths), scale, map_xy=srcmap, border=0.0,
            threads=max(2, os.cpu_count() or 2),
        )
    except Exception:
        loader = None
    if loader is not None:
        if isinstance(loaders, list):
            loaders.append(loader)
        for _idx, img, valid in loader:
            yield img, valid
        return
    from dvo_tpu.utils.png import decode_gray

    for p in paths:
        img = decode_gray(p) * scale
        if srcmap is not None:
            img, valid = remap_nearest(img, srcmap, border=0.0)
        else:
            valid = np.ones_like(img, bool)
        yield img.astype(np.float32), valid


def run_monocular(
    sequence,
    calib: Calibration,
    cfg: DVOConfig = DVOConfig.monocular(),
    seed: int = 0,
    max_frames: Optional[int] = None,
    undistort: bool = True,
    verbose: bool = False,
    metrics=None,
    checkpoint_out: Optional[str] = None,
    gallery_out: Optional[str] = None,
    pose_graph: bool = False,
    pose_graph_every: int = 0,
    chunk: int = 0,
):
    """Monocular VO over a sequence.  Returns (timestamps, poses (N,4,4),
    per-frame seconds).  ``metrics``: utils.metrics.MetricsLogger for JSONL
    per-frame records; ``checkpoint_out``: path to save the final device
    state (utils.checkpoint); ``gallery_out``: PNG path for the final
    keyframe-ring gallery (the reference's SHOW_KEYFRAME panel);
    ``pose_graph``: harvest odometry/BA/loop-closure constraints during the
    run and globally refine the keyframe trajectory at sequence end
    (models/posegraph.py) — the returned poses are then the refined ones.

    ``chunk`` > 1 selects the CHUNKED device-side driver: frames dispatch
    as ``chunk``-long ``lax.scan`` programs (models/odometry.monocular_run)
    with uint8 inputs normalized on device, overlapping host decode, input
    transfer, device execution, and result drain — the per-frame dispatch +
    sync of the default path costs one host round-trip per frame.  Gray
    from color sources is quantized to integer levels (rint -> uint8, the
    reference's own cvtColor->8U semantics; 8-bit gray and 16-bit depth
    sources are exact), and the scanned vs standalone step compile with
    different fusion/reduction orders, so the trajectory matches the
    per-frame path to ~1e-5 float noise
    (tests/test_runner.py::test_chunked_matches_per_frame); per-frame
    wall-clock attribution coarsens to the chunk average.  The tail
    (len-1 mod chunk) runs per-frame on the same quantized pixels."""
    srcmap = build_undistort_map(calib) if undistort and calib.distortion is not None else None
    K = jnp.asarray(calib.K)
    items = list(sequence)[:max_frames]
    use_chunk = bool(chunk and chunk > 1) and len(items) > chunk
    loaders: list = []
    # Chunked mode ships raw uint8 (device normalizes, frame._normalize_gray)
    # — 4x less host->device traffic; the scale-1.0 stream keeps the decode
    # values exact so the cast is lossless.  The undistortion map is
    # composed with the 2**culls pre-cull stride (_composed_cull_map), so
    # the native loader's worker threads emit 160x120 frames directly —
    # 16x less remap work and no per-frame Python stride/copy.
    st_ = 2 ** cfg.pyramid.culls if use_chunk else 1
    stream_map = (
        _composed_cull_map(srcmap, items[0].gray_path, st_)
        if use_chunk else srcmap
    )
    stream = _image_stream(
        [it.gray_path for it in items], 1.0 if use_chunk else 1 / 255.0,
        stream_map, loaders=loaders,
    )
    gray, mask = next(stream)
    if not use_chunk:
        state = monocular_init(
            jnp.asarray(gray), jnp.asarray(mask), K, jax.random.PRNGKey(seed), cfg
        )
    harvester = None
    if pose_graph and not use_chunk:
        from dvo_tpu.models.posegraph import PoseGraphHarvester

        harvester = PoseGraphHarvester(
            cfg, np.asarray(calib.K), verbose=verbose,
            refine_every=pose_graph_every,
        )
    poses = [np.eye(4, dtype=np.float32)]
    times = [items[0].timestamp]
    secs = []

    start_fi = 1
    if use_chunk:
        import dataclasses as _dc

        from dvo_tpu.models.odometry import monocular_run

        # HOST PRE-CULL: the pipeline's first device op point-samples the
        # input by 2**culls (cull_image) — an exact stride the loader's
        # composed map already applied (see stream_map above), cutting
        # host->device traffic 4**culls (16x at the reference monocular
        # operating point).  The device program runs with culls=0 on
        # identical pixels.
        culls = cfg.pyramid.culls
        cfg_dev = _dc.replace(
            cfg, pyramid=_dc.replace(cfg.pyramid, culls=0)
        ) if culls else cfg
        K_host = np.asarray(calib.K, np.float32).copy()
        if culls:
            K_host[:2] /= st_            # cull_intrinsic semantics
        K_dev = jnp.asarray(K_host)

        def quantize(g):
            # Fractional color luma -> nearest gray level (the reference's
            # cvtColor->8U semantics, loader.cpp:59); frames arrive from
            # the stream already pre-culled.
            return np.rint(g).astype(np.uint8)

        gray_c = quantize(gray)
        h, w = gray_c.shape
        # The validity mask is the undistortion-border map — constant per
        # rig — so it stages on device ONCE; re-shipping an (N, H, W) bool
        # per chunk would double the host->device traffic.
        mask_full = np.asarray(mask)
        mask_dev = jnp.asarray(mask_full)
        state = monocular_init(
            jnp.asarray(gray_c), mask_dev, K_dev,
            jax.random.PRNGKey(seed), cfg_dev,
        )
        t_sec = time.perf_counter()
        n_done = [0]

        # --- pose-graph harvest machinery (chunked driver; round-4 forced
        # --pose-graph onto the 14 fps per-frame path).  Constraints are
        # harvested from the drained StepResult rows; keyframe gray
        # snapshots come from the very chunk buffers just shipped; the
        # retiring keyframes' refined depth/sigma come from a per-chunk
        # packed ring fetch that pipelines with the next chunk's
        # execution.  Live refinements (--pose-graph-every) apply to the
        # device state two chunks after their trigger (results drain one
        # chunk behind); the rows emitted in between are corrected
        # retroactively so the final apply_refinement sees one consistent
        # chain (corr_records: frames in [from_fi, effective_fi) composed
        # from the pre-correction reference).
        corr_records = []    # (from_fi, effective_fi, corr 4x4)
        pending_corr = []    # refinements awaiting device application
        chunk_grays = {}     # first step index -> host uint8 rows
        refine_due = [False]
        dispatched = [0]
        pack_ring = None
        if pose_graph:
            from dvo_tpu.models.posegraph import PoseGraphHarvester

            harvester = PoseGraphHarvester(
                cfg_dev, K_host, verbose=verbose,
                refine_every=pose_graph_every,
            )

            @jax.jit
            def pack_ring(hist):
                # kf_id rides along (exact in f32: frame ids << 2^24) so
                # absorb_ring can DETECT slots overwritten between a
                # retirement and this fetch (possible whenever a chunk
                # promotes more keyframes than the ring holds).
                return jnp.concatenate(
                    [hist.depth.ravel(), hist.sigma.ravel(),
                     hist.kf_id.astype(jnp.float32)]
                )

        def on_frame(step_idx, row):
            fi = 1 + step_idx
            n_done[0] += 1
            T = np.asarray(row.T_world)
            for f0, eff, corr in corr_records:
                if f0 <= fi < eff:
                    T = corr @ T
            poses.append(T)
            times.append(items[fi].timestamp)
            if harvester is not None and bool(row.is_keyframe):
                first = (step_idx // chunk) * chunk
                g = chunk_grays[first][step_idx - first]
                due = harvester.on_chunk_row(
                    fi, row, g, mask_full, T_emit=T
                )
                refine_due[0] = refine_due[0] or due
            if metrics is not None:
                avg = (time.perf_counter() - t_sec) / n_done[0]
                metrics.log_frame(row, avg, items[fi].timestamp)
            if verbose:
                print(
                    f"frame {fi:4d} kf={bool(row.is_keyframe)} "
                    f"acc={int(row.mapping.accepted):5d} (chunked)"
                )

        def alloc():
            return (np.empty((chunk, h, w), np.uint8),)

        def fill_row(bufs, k):
            g, m = next(stream)
            if not np.array_equal(m, mask_full):
                raise ValueError(
                    "chunked driver requires a constant validity mask "
                    "(it is shipped once); got a frame-varying mask"
                )
            bufs[0][k] = quantize(g)

        def dispatch(bufs):
            nonlocal state
            if harvester is not None:
                chunk_grays[dispatched[0] * chunk] = bufs[0]
            dispatched[0] += 1
            state, res = monocular_run(
                state, jnp.asarray(bufs[0]), mask_dev, K_dev, cfg_dev
            )
            return res

        def make_aux():
            return pack_ring(state.history) if harvester is not None else None

        def on_chunk_done(first_index, count, aux):
            if harvester is None:
                return
            chunk_grays.pop(first_index, None)
            ring = np.asarray(aux)
            cap = cfg_dev.mapper.history_capacity
            hw = h * w
            harvester.absorb_ring(
                ring[:cap * hw].reshape(cap, h, w),
                ring[cap * hw:2 * cap * hw].reshape(cap, h, w),
                ring[2 * cap * hw:].astype(np.int64),
            )
            if refine_due[0]:
                refine_due[0] = False
                out = harvester.refine_live_chunked()
                if out is not None:
                    pending_corr.append(out)

        def apply_pending():
            nonlocal state
            if harvester is None or not pending_corr:
                return
            from dvo_tpu.models.posegraph import apply_live_correction

            cap = cfg_dev.mapper.history_capacity
            for xi_ref, corr in pending_corr:
                m_nodes = len(xi_ref)
                xi_slot = np.zeros((cap, 6), np.float32)
                id_slot = np.full((cap,), -2, np.int32)
                # Deterministic push->slot layout: node k is ring push
                # k+1 (push 0 = the init keyframe), slot = push % cap.
                for k in range(max(0, m_nodes - cap), m_nodes):
                    slot = (k + 1) % cap
                    xi_slot[slot] = xi_ref[k]
                    id_slot[slot] = harvester.nodes[k].frame_idx
                max_id = harvester.nodes[m_nodes - 1].frame_idx
                state = apply_live_correction(
                    state, jnp.asarray(xi_slot), jnp.asarray(id_slot),
                    jnp.asarray(max_id, jnp.int32),
                    jnp.asarray(corr.astype(np.float32)),
                )
                # Rows ALREADY drained on the old chain (the refined
                # keyframe's own row and any frames after it in its
                # chunk) must be corrected in place, or finalize's
                # apply_refinement — which trusts inv(poses[kf]) @
                # poses[f] as tracked relative motion — applies the live
                # correction twice to the frames that follow (note
                # corr @ T_old(kf) == T_new(kf), so the keyframe row
                # lands exactly on its refined pose).
                for fi_done in range(max_id, len(poses)):
                    poses[fi_done] = corr @ poses[fi_done]
                corr_records.append(
                    (max_id, 1 + dispatched[0] * chunk, corr)
                )
            pending_corr.clear()

        done, chunk_walls = _run_chunks(
            len(items) - 1, chunk, alloc, fill_row, dispatch, on_frame,
            on_chunk_done=on_chunk_done, make_aux=make_aux,
            before_dispatch=apply_pending,
        )
        # A refinement triggered by the final chunks applies to the state
        # the tail frames will run on.
        apply_pending()
        # Per-frame seconds from each chunk's own wall time: the first
        # chunk typically absorbs the one-time compile, so downstream
        # medians reflect steady-state throughput.
        for cw in chunk_walls:
            secs.extend([cw / chunk] * chunk)
        start_fi = 1 + done

    for fi in range(start_fi, len(items)):
        item = items[fi]
        gray, mask = next(stream)
        if use_chunk:
            # The raw-count stream feeds the tail too (frames arrive
            # pre-culled): quantize exactly as the chunk rows were; the
            # device normalizes.  Same constant-mask requirement as
            # fill_row — a frame-varying mask must not be silently
            # replaced by the staged one.
            gray = quantize(gray)
            if not np.array_equal(np.asarray(mask), mask_full):
                raise ValueError(
                    "chunked driver requires a constant validity mask "
                    "(it is shipped once); got a frame-varying mask"
                )
            t0 = time.perf_counter()
            state, res = monocular_step(
                state, jnp.asarray(gray), mask_dev, K_dev, cfg_dev
            )
            jax.block_until_ready(res.T_world)
            secs.append(time.perf_counter() - t0)
            poses.append(np.asarray(res.T_world))
            times.append(item.timestamp)
            if harvester is not None and bool(res.is_keyframe):
                # Tail keyframes harvest like chunk rows; their deferred
                # ring snapshots resolve in the final absorb below.
                harvester.on_chunk_row(fi, res, gray, mask_full)
            if metrics is not None:
                metrics.log_frame(res, secs[-1], item.timestamp)
            if verbose:
                print(
                    f"frame {int(state.frame_count)-1:4d} "
                    f"kf={bool(res.is_keyframe)} {secs[-1]*1e3:7.1f} ms"
                )
            continue
        t0 = time.perf_counter()
        state, res = monocular_step(state, jnp.asarray(gray), jnp.asarray(mask), K, cfg)
        jax.block_until_ready(res.T_world)
        secs.append(time.perf_counter() - t0)
        poses.append(np.asarray(res.T_world))
        times.append(item.timestamp)
        if harvester is not None:
            # Periodic live refinement may return a drift-corrected state.
            corrected = harvester.on_frame(fi, res, state, gray, mask)
            if corrected is not None:
                state = corrected
                # This frame IS the refined keyframe: re-emit its pose as
                # corrected, or frames tracked relative to the corrected
                # reference would get the correction applied a second time
                # by finalize's apply_refinement (which trusts
                # inv(poses[base]) @ poses[f] as the tracked relative
                # motion) — round-4 advisor, severity medium.
                from dvo_tpu import lie

                poses[-1] = np.asarray(lie.se3_exp(corrected.ref.xi))
        if metrics is not None:
            metrics.log_frame(res, secs[-1], item.timestamp)
        if verbose:
            print(
                f"frame {int(state.frame_count)-1:4d} kf={bool(res.is_keyframe)} "
                f"acc={int(res.mapping.accepted):5d} {secs[-1]*1e3:7.1f} ms"
            )
    pose_arr = np.stack(poses)
    if harvester is not None:
        if use_chunk and harvester._pending_snaps:
            cap = cfg_dev.mapper.history_capacity
            ring = np.asarray(pack_ring(state.history))
            hh, ww = state.ref.base.shape
            hw = hh * ww
            harvester.absorb_ring(
                ring[:cap * hw].reshape(cap, hh, ww),
                ring[cap * hw:2 * cap * hw].reshape(cap, hh, ww),
                ring[2 * cap * hw:].astype(np.int64),
            )
        pose_arr, pg_costs = harvester.finalize(np.asarray(times), pose_arr, state)
        if verbose and pg_costs.size:
            print(
                f"pose-graph: {len(harvester.nodes)} nodes, "
                f"{len(harvester.e_w)} edges ({harvester.closures} closures), "
                f"cost {pg_costs[0]:.3e} -> {pg_costs[-1]:.3e}"
            )
    if checkpoint_out:
        from dvo_tpu.utils.checkpoint import save_state

        save_state(checkpoint_out, state)
    if gallery_out:
        from dvo_tpu.utils.viz import keyframe_gallery, save_png

        save_png(gallery_out, keyframe_gallery(state.history))
    for ld in loaders:
        ld.close()
    return np.asarray(times), pose_arr, np.asarray(secs)


def run_rgbd(
    sequence,
    calib: Calibration,
    cfg: DVOConfig = DVOConfig.rgbd(),
    depth_sigma: float = 0.1,
    max_frames: Optional[int] = None,
    undistort: bool = True,
    verbose: bool = False,
    metrics=None,
    chunk: int = 0,
):
    """RGB-D frame-to-frame tracking (odometrizeUsingDepth mode).  Depth
    pixels with no measurement get sigma 1.0, valid ones ``depth_sigma``
    (transform.cpp:74 convention).  Returns (timestamps, poses, secs).

    ``chunk`` > 1: chunked device-side driver (see ``run_monocular``) —
    ships raw uint8 gray + uint16 depth counts per chunk and runs
    ``rgbd_run_raw`` (conversions + sigma synthesis on device)."""
    from dvo_tpu.utils.datasets import TUM_DEPTH_SCALE

    srcmap = build_undistort_map(calib) if undistort and calib.distortion is not None else None
    K = jnp.asarray(calib.K)
    items = list(sequence)[:max_frames]
    use_chunk = bool(chunk and chunk > 1) and len(items) > chunk
    loaders: list = []
    # Chunked mode: compose undistortion with the 2**culls pre-cull stride
    # so the loader emits base-resolution frames directly (exact — see
    # _composed_cull_map; 4**culls less traffic and remap work).
    st_ = 2 ** cfg.pyramid.culls if use_chunk else 1
    gmap = (
        _composed_cull_map(srcmap, items[0].gray_path, st_)
        if use_chunk else srcmap
    )
    dmap = (
        _composed_cull_map(srcmap, items[0].depth_path, st_)
        if use_chunk else srcmap
    )
    gray_stream = _image_stream(
        [it.gray_path for it in items], 1.0 if use_chunk else 1 / 255.0,
        gmap, loaders=loaders,
    )
    depth_stream = _image_stream(
        [it.depth_path for it in items],
        1.0 if use_chunk else 1.0 / TUM_DEPTH_SCALE, dmap,
        loaders=loaders,
    )

    def prep_raw():
        """(gray u8, mask, depth u16 counts) — chunked-mode row."""
        gray, mask = next(gray_stream)
        depth, _dmask = next(depth_stream)
        return gray, mask, depth

    def prep(_item):
        gray, mask = next(gray_stream)
        depth, _dmask = next(depth_stream)
        if use_chunk:           # raw-count streams: normalize on host here,
            # quantizing gray exactly as the chunked rows do (rint -> u8).
            gray = np.rint(gray).astype(np.uint8).astype(np.float32) * np.float32(1.0 / 255.0)
            depth = depth.astype(np.float32) * np.float32(1.0 / TUM_DEPTH_SCALE)
        valid = depth > 1e-6
        sigma = np.where(valid, depth_sigma, 1.0).astype(np.float32)
        return gray, mask, depth.astype(np.float32), sigma

    poses = [np.eye(4, dtype=np.float32)]
    times = [items[0].timestamp]
    secs = []

    start_fi = 1
    if use_chunk:
        import dataclasses as _dc

        from dvo_tpu.models.odometry import rgbd_run_raw

        # HOST PRE-CULL (see run_monocular): frames arrive from the
        # composed-map streams already at base resolution; the device
        # program runs with culls=0 on identical pixels.
        culls = cfg.pyramid.culls
        cfg_dev = _dc.replace(
            cfg, pyramid=_dc.replace(cfg.pyramid, culls=0)
        ) if culls else cfg
        K_host = np.asarray(calib.K, np.float32).copy()
        if culls:
            K_host[:2] /= st_
        K_dev = jnp.asarray(K_host)

        g0, m0, d0 = prep_raw()
        mask_full = np.asarray(m0)
        mask_dev = jnp.asarray(mask_full)
        gray_c = np.rint(g0).astype(np.uint8)
        depth_c = (d0.astype(np.float32)
                   * np.float32(1.0 / TUM_DEPTH_SCALE))
        sigma_c = np.where(depth_c > 1e-6, depth_sigma, 1.0).astype(np.float32)
        state = rgbd_init(
            jnp.asarray(gray_c), mask_dev, jnp.asarray(depth_c),
            jnp.asarray(sigma_c), K_dev, cfg_dev,
        )
        h, w = gray_c.shape
        t_sec = time.perf_counter()
        n_done = [0]

        def on_frame(step_idx, row):
            fi = 1 + step_idx
            n_done[0] += 1
            poses.append(np.asarray(row.T_world))
            times.append(items[fi].timestamp)
            if metrics is not None:
                avg = (time.perf_counter() - t_sec) / n_done[0]
                metrics.log_frame(row, avg, items[fi].timestamp)
            if verbose:
                print(f"frame {fi:4d} (chunked)")

        def alloc():
            return (np.empty((chunk, h, w), np.uint8),
                    np.empty((chunk, h, w), np.uint16))

        def fill_row(bufs, k):
            g, m, d = prep_raw()
            if not np.array_equal(m, mask_full):
                raise ValueError(
                    "chunked driver requires a constant validity mask"
                )
            bufs[0][k] = np.rint(g)   # fractional luma -> nearest level
            bufs[1][k] = d            # depth counts are exact ints

        def dispatch(bufs):
            nonlocal state
            state, res = rgbd_run_raw(
                state, jnp.asarray(bufs[0]), mask_dev,
                jnp.asarray(bufs[1]), K_dev, cfg_dev, TUM_DEPTH_SCALE,
                depth_sigma,
            )
            return res

        done, chunk_walls = _run_chunks(
            len(items) - 1, chunk, alloc, fill_row, dispatch, on_frame
        )
        # Per-frame seconds from each chunk's own wall time: the first
        # chunk typically absorbs the one-time compile, so downstream
        # medians reflect steady-state throughput.
        for cw in chunk_walls:
            secs.extend([cw / chunk] * chunk)
        start_fi = 1 + done
    else:
        gray, mask, depth, sigma = prep(items[0])
        state = rgbd_init(
            jnp.asarray(gray), jnp.asarray(mask), jnp.asarray(depth),
            jnp.asarray(sigma), K, cfg,
        )

    for fi in range(start_fi, len(items)):
        item = items[fi]
        gray, mask, depth, sigma = prep(item)
        if use_chunk:
            # Tail frames arrive pre-culled from the composed-map streams;
            # enforce the same constant-mask requirement as fill_row.
            if not np.array_equal(np.asarray(mask), mask_full):
                raise ValueError(
                    "chunked driver requires a constant validity mask"
                )
            t0 = time.perf_counter()
            state, res = rgbd_step(
                state, jnp.asarray(gray), mask_dev,
                jnp.asarray(depth), jnp.asarray(sigma), K_dev, cfg_dev,
            )
        else:
            t0 = time.perf_counter()
            state, res = rgbd_step(
                state, jnp.asarray(gray), jnp.asarray(mask),
                jnp.asarray(depth), jnp.asarray(sigma), K, cfg,
            )
        jax.block_until_ready(res.T_world)
        secs.append(time.perf_counter() - t0)
        poses.append(np.asarray(res.T_world))
        times.append(item.timestamp)
        if metrics is not None:
            metrics.log_frame(res, secs[-1], item.timestamp)
        if verbose:
            print(f"frame {int(state.frame_count)-1:4d} {secs[-1]*1e3:7.1f} ms")
    for ld in loaders:
        ld.close()
    return np.asarray(times), np.stack(poses), np.asarray(secs)


def run_kinect(
    sequence,
    kcalib: KinectCalibration = None,
    cfg: DVOConfig = None,
    mode: str = "mono",
    max_frames: Optional[int] = None,
    undistort: bool = True,
    verbose: bool = False,
    metrics=None,
    chunk: int = 0,
    gray_cull: int = 2,
):
    """Kinect v2 dual-camera pipeline (reference KinectLoader::getMappedImages,
    loader.cpp:90-101 + test/kinect-vo.cpp): undistort color and depth with
    their own intrinsics, register the color image into the depth camera's
    frame via the extrinsic (``map_depth_to_gray``), then run VO at depth
    resolution with the depth camera's K.

    ``mode="mono"``: full pipeline seeded with the first frame's measured
    depth (kinect-vo.cpp).  ``mode="rgbd"``: frame-to-frame tracking with
    measured depth every frame (test/sequence.cpp).

    The registration is part of the jitted device program — the host only
    decodes and undistorts.  ``chunk`` > 1: chunked device-side driver
    (see ``run_monocular``) — raw uint8/uint16 chunks, registration vmapped
    inside the chunk program.

    Host pre-cull (round 5): the DEPTH stream is pre-culled by the full
    ``2**cfg.pyramid.culls`` via a composed undistort∘stride map and the
    device runs with culls=0 — EXACT (registration of the strided depth
    grid with depth_K/2**culls projects the identical rays, so the mapped
    planes equal the full-res registration's culled output pixel for
    pixel) while cutting depth traffic 4**culls and registration compute
    16x at the mono operating point.  ``gray_cull`` pre-culls the 1920x1080
    COLOR stream (~2 MB/frame at full resolution); unlike the depth cull this is an approximation — registration then
    bilinearly samples the strided gray grid with rgb_K/gray_cull — but at
    gray_cull=2 the sampled image still holds 3.7x the final tracking
    base's resolution (measured: rig accuracy gates unchanged,
    tests/test_kinect.py).  0/1 disables.  Applied identically to the
    chunked and per-frame paths, which therefore stay mutually
    bit-identical.
    """
    from dvo_tpu.ops.warp import map_depth_to_gray

    if kcalib is None:
        kcalib = KinectCalibration.kinect_v2()
    if cfg is None:
        cfg = DVOConfig.rgbd() if mode == "rgbd" else DVOConfig.monocular()
    rgb_map = (
        build_undistort_map(kcalib.rgb)
        if undistort and kcalib.rgb.distortion is not None
        else None
    )
    depth_map = (
        build_undistort_map(kcalib.depth)
        if undistort and kcalib.depth.distortion is not None
        else None
    )
    items_all = list(sequence)
    gray_cull = max(int(gray_cull), 1)
    culls = cfg.pyramid.culls
    dst = 2 ** culls
    if items_all:
        rgb_map = _composed_cull_map(
            rgb_map, items_all[0].gray_path, gray_cull
        )
        depth_map = _composed_cull_map(
            depth_map, items_all[0].depth_path, dst
        )
    if culls:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, pyramid=_dc.replace(cfg.pyramid, culls=0))
    rgb_K_h = np.asarray(kcalib.rgb.K, np.float32).copy()
    rgb_K_h[:2] /= gray_cull
    depth_K_h = np.asarray(kcalib.depth.K, np.float32).copy()
    depth_K_h[:2] /= dst
    rgb_K = jnp.asarray(rgb_K_h)
    depth_K = jnp.asarray(depth_K_h)
    invT = jnp.asarray(kcalib.invT)

    from dvo_tpu.utils.datasets import TUM_DEPTH_SCALE

    @jax.jit
    def register(gray, gray_mask, depth):
        return map_depth_to_gray(depth, gray, gray_mask, rgb_K, depth_K, invT)

    @jax.jit
    def register_chunk(grays_u8, gmask, depths_u16):
        """Registration for a whole chunk, raw counts in: u8 -> [0,1] and
        u16 -> meters by the same f32 divisions the host loader uses
        (datasets.load_gray_normalized / load_depth_meters), then the
        per-frame registration vmapped.  ``gmask`` is the constant (H, W)
        undistortion-border mask, staged once (the registration OUTPUT
        mask varies per frame with depth occupancy, but that one is
        computed on device)."""
        g = grays_u8.astype(jnp.float32) / 255.0
        d = depths_u16.astype(jnp.float32) / jnp.float32(TUM_DEPTH_SCALE)
        mapped, mask, sigma = jax.vmap(
            lambda gg, dd: map_depth_to_gray(dd, gg, gmask, rgb_K, depth_K, invT)
        )(g, d)
        return mapped, mask, d, sigma

    items = items_all[:max_frames]
    use_chunk = bool(chunk and chunk > 1) and len(items) > chunk
    # Both paths decode through the same (native-prefetch) streams at raw
    # scale so chunked and per-frame results are bit-identical.
    loaders: list = []
    gray_stream = _image_stream(
        [it.gray_path for it in items], 1.0, rgb_map, loaders=loaders
    )
    depth_stream = _image_stream(
        [it.depth_path for it in items], 1.0, depth_map, loaders=loaders
    )

    def prep_raw():
        gray, gmask = next(gray_stream)
        depth, _ = next(depth_stream)
        return gray, gmask, depth

    def prep(_item):
        gray, gmask, depth = prep_raw()
        if use_chunk:
            # Quantize gray exactly as the chunked rows do (rint -> u8) so
            # tail/init frames match the chunk frames' pixel values.
            gray = np.rint(gray).astype(np.uint8)
        gray = gray.astype(np.float32) / 255.0
        depth = depth.astype(np.float32) / np.float32(TUM_DEPTH_SCALE)
        mapped, mask, sigma = register(
            jnp.asarray(gray), jnp.asarray(gmask), jnp.asarray(depth)
        )
        return mapped, mask, jnp.asarray(depth), sigma

    mapped, mask, depth, sigma = prep(items[0])
    poses = [np.eye(4, dtype=np.float32)]
    times = [items[0].timestamp]
    secs = []

    if mode == "rgbd":
        state = rgbd_init(mapped, mask, depth, sigma, depth_K, cfg)
    else:
        state = monocular_init_with_depth(
            mapped, mask, depth, sigma, depth_K, jax.random.PRNGKey(0), cfg
        )

    start_fi = 1
    if use_chunk:
        from dvo_tpu.models.odometry import monocular_run, rgbd_run

        t_sec = time.perf_counter()
        n_done = [0]

        def on_frame(step_idx, row):
            fi = 1 + step_idx
            n_done[0] += 1
            poses.append(np.asarray(row.T_world))
            times.append(items[fi].timestamp)
            if metrics is not None:
                avg = (time.perf_counter() - t_sec) / n_done[0]
                metrics.log_frame(row, avg, items[fi].timestamp)
            if verbose:
                print(f"frame {fi:4d} (chunked)")

        probe_g, probe_m, probe_d = prep_raw()
        pending_first = [(probe_g, probe_m, probe_d)]
        gshape, dshape = probe_g.shape, probe_d.shape
        # Constant undistortion-border mask, staged once (see run_monocular).
        gmask0 = np.asarray(probe_m)
        gmask_dev = jnp.asarray(gmask0)

        def alloc():
            return (np.empty((chunk,) + gshape, np.uint8),
                    np.empty((chunk,) + dshape, np.uint16))

        def fill_row(bufs, k):
            if pending_first:
                g, m, d = pending_first.pop()
            else:
                g, m, d = prep_raw()
            if not np.array_equal(m, gmask0):
                raise ValueError(
                    "chunked driver requires a constant validity mask"
                )
            np.rint(g, out=g)   # fractional luma -> nearest gray level
            bufs[0][k] = g
            bufs[1][k] = d      # depth counts are exact ints

        def dispatch(bufs):
            nonlocal state
            mapped_c, mask_c, d_c, sigma_c = register_chunk(
                jnp.asarray(bufs[0]), gmask_dev, jnp.asarray(bufs[1])
            )
            if mode == "rgbd":
                state, res = rgbd_run(
                    state, mapped_c, mask_c, d_c, sigma_c, depth_K, cfg
                )
            else:
                state, res = monocular_run(state, mapped_c, mask_c, depth_K, cfg)
            return res

        done, chunk_walls = _run_chunks(
            len(items) - 1, chunk, alloc, fill_row, dispatch, on_frame
        )
        # Per-frame seconds from each chunk's own wall time: the first
        # chunk typically absorbs the one-time compile, so downstream
        # medians reflect steady-state throughput.
        for cw in chunk_walls:
            secs.extend([cw / chunk] * chunk)
        start_fi = 1 + done
        if start_fi < len(items):
            pending_first.append(prep_raw())

    def prep_tail():
        if use_chunk and pending_first:
            gray, gmask, d = pending_first.pop()
            gray = np.rint(gray).astype(np.uint8).astype(np.float32) / 255.0
            d = d.astype(np.float32) / np.float32(TUM_DEPTH_SCALE)
            mapped, mask, sigma = register(
                jnp.asarray(gray), jnp.asarray(gmask), jnp.asarray(d)
            )
            return mapped, mask, jnp.asarray(d), sigma
        return prep(None)

    for fi in range(start_fi, len(items)):
        item = items[fi]
        mapped, mask, depth_f, sigma = prep_tail()
        t0 = time.perf_counter()
        if mode == "rgbd":
            state, res = rgbd_step(state, mapped, mask, depth_f, sigma, depth_K, cfg)
        else:
            state, res = monocular_step(state, mapped, mask, depth_K, cfg)
        jax.block_until_ready(res.T_world)
        secs.append(time.perf_counter() - t0)
        poses.append(np.asarray(res.T_world))
        times.append(item.timestamp)
        if metrics is not None:
            metrics.log_frame(res, secs[-1], item.timestamp)
        if verbose:
            print(f"frame {int(state.frame_count)-1:4d} {secs[-1]*1e3:7.1f} ms")
    for ld in loaders:
        ld.close()
    return np.asarray(times), np.stack(poses), np.asarray(secs)
