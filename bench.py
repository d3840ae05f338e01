"""Benchmark: full per-frame VO pipeline throughput on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}.

Baseline: the reference budgets 200 ms/frame for tracking alone on its
exhibition laptop (src/track/tracker.cpp:18,68-73) with mapping on top, i.e.
<= 5 frames/s end-to-end (SURVEY.md §6).

Headline metric: the COMPLETE monocular frame (reference main.cpp path at
its native 640x480 input) — frame build (cull pyramid + gradients),
coarse-to-fine GN tracking, keyframe policy + epipolar depth mapping or
propagate, and regularization — as device-side throughput: all input chunks
are staged into device memory BEFORE the timed region, chunks dispatch
back-to-back (state threads through, so the runtime pipelines them), and
the clock stops when the final result is ready (``jax.block_until_ready``).
Input staging is excluded from the headline.

``extra`` also reports: RGB-D tracking on REAL registered kinectv2 frames
at the reference's 512x424 operating point (system.hpp:30,82), GN
iterations/s counted from the EXECUTED iteration counts the tracker
returns (early-exit aware — round 2 multiplied fps by the static iteration
cap, overcounting ~3x), the 8-stream batched mode, and end-to-end fps with
native PNG decode overlapped with device execution (the production data
plane: dvo_tpu/native prefetch threads feed chunk k+1 while the device
runs chunk k).
"""

import json
import os
import sys
import threading
import time

import numpy as np

import jax

from dvo_tpu.utils.cache import setup_compile_cache


def _progress(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)

REFERENCE_FPS = 5.0  # 200 ms/frame tracking budget, tracker.cpp:18

DATA = "/root/reference/data/logicool0"
KINECT = "/root/reference/data/kinectv2_00"


def _synth(h, w, n, seed=0):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.zeros((h, w), np.float32)
    for _ in range(8):
        fx, fy = rng.uniform(0.05, 0.5, 2)
        ph = rng.uniform(0, 6.28, 2)
        base += rng.uniform(0.3, 1.0) * np.sin(fx * xs + ph[0]) * np.sin(fy * ys + ph[1])
    base = (base - base.min()) / (base.max() - base.min())
    return [np.roll(base, i, axis=1) for i in range(n)]


def _load_frames(n):
    """Frames as uint8 [0, 255]: the pipeline normalizes on device
    (models/frame._normalize_gray), so the bench ships 4x fewer bytes per
    chunk — exactly what a production feeder would do."""
    if os.path.isdir(DATA):
        try:
            from PIL import Image

            frames = []
            for i in range(n):
                p = os.path.join(DATA, f"{i:04d}.png")
                frames.append(np.asarray(Image.open(p).convert("L"), np.uint8))
            return frames, np.array(
                [[780.0, 0, 378], [0, 796.0, 220], [0, 0, 1]], np.float32
            )
        except Exception:
            pass
    h, w = 480, 640
    return [np.clip(f * 255.0, 0, 255).astype(np.uint8) for f in _synth(h, w, n)], np.array(
        [[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]], np.float32
    )


def bench_monocular(reps=3, chunk=24, n_chunks=4):
    import jax
    import jax.numpy as jnp

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.odometry import monocular_init, monocular_run

    cfg = DVOConfig.monocular()
    total = chunk * n_chunks
    frames, K = _load_frames(total + 1)
    h, w = frames[0].shape
    Kd = jnp.asarray(K)
    mask = jnp.ones((h, w), bool)
    masks = mask  # shared (H, W) mask: shipped/staged once, broadcast in-scan
    # Stage EVERY chunk on device before timing.
    chunks = [
        jax.device_put(np.stack(frames[1 + i * chunk : 1 + (i + 1) * chunk]))
        for i in range(n_chunks)
    ]
    jax.block_until_ready(chunks)

    state0 = monocular_init(jnp.asarray(frames[0]), mask, Kd, jax.random.PRNGKey(0), cfg)
    # Warmup compiles the scanned step (both mapper branches are cond arms).
    st, res = monocular_run(state0, chunks[0], masks, Kd, cfg)
    jax.block_until_ready(res.T_world)

    fps, iters_total = [], 0
    for _ in range(reps):
        st = state0
        t0 = time.perf_counter()
        results = []
        for c in chunks:
            st, res = monocular_run(st, c, masks, Kd, cfg)
            results.append(res)
        jax.block_until_ready(res.T_world)
        fps.append(total / (time.perf_counter() - t0))
        # Executed GN iterations (early-exit aware): TrackResult.iterations
        # is (N, levels) per chunk.
        iters_total = int(
            sum(np.asarray(r.tracking.iterations).sum() for r in results)
        )
    med = float(np.median(fps))
    gn_iters_per_s = med / total * iters_total
    return med, gn_iters_per_s


def bench_e2e_decode(chunk=24, n_chunks=4):
    """End-to-end fps INCLUDING host PNG decode + host->device transfer:
    the native prefetch loader decodes chunk k+1 on its worker threads
    while the device runs chunk k (double-buffered producer/consumer).
    Falls back to PIL decode in the same overlap structure.  This is the
    number a user gets feeding real files through this host.  It mirrors
    the production path (host pre-cull, culls=0 device program), so e2e
    and CLI rows are directly comparable (CLI additionally pays the
    undistortion remap)."""
    import jax
    import jax.numpy as jnp

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.odometry import monocular_init, monocular_run

    if not os.path.isdir(DATA):
        return None
    cfg = DVOConfig.monocular()
    total = chunk * n_chunks
    paths = [os.path.join(DATA, f"{i:04d}.png") for i in range(total + 1)]
    K = np.array([[780.0, 0, 378], [0, 796.0, 220], [0, 0, 1]], np.float32)

    def decode_all(out_list, t_done):
        try:
            from dvo_tpu import native

            # scale 1.0: keep raw 8-bit values; the device normalizes.
            loader = native.PrefetchLoader(
                paths, 1.0, threads=max(2, os.cpu_count() or 2)
            )
            for _i, img, _v in loader:
                out_list.append(np.rint(img[::st_, ::st_]).astype(np.uint8))
            loader.close()
        except Exception:
            from PIL import Image

            for p in paths:
                out_list.append(np.asarray(
                    Image.open(p).convert("L"), np.uint8)[::st_, ::st_])
        t_done.append(time.perf_counter())

    # Warmup compile outside the timed region.  Host pre-cull (see
    # docstring): frames ship at base resolution with a culls=0 program.
    import dataclasses as _dc

    st_ = 2 ** cfg.pyramid.culls
    cfg = _dc.replace(cfg, pyramid=_dc.replace(cfg.pyramid, culls=0))
    K = K.copy()
    K[:2] /= st_
    h, w = 480 // st_, 640 // st_
    Kd = jnp.asarray(K)
    mask = jnp.ones((h, w), bool)
    masks = mask
    warm = np.zeros((chunk, h, w), np.uint8)
    state0 = monocular_init(jnp.zeros((h, w), jnp.uint8), mask, Kd,
                            jax.random.PRNGKey(0), cfg)
    st, res = monocular_run(state0, jnp.asarray(warm), masks, Kd, cfg)
    jax.block_until_ready(res.T_world)

    frames: list = []
    t_done: list = []
    t0 = time.perf_counter()
    producer = threading.Thread(target=decode_all, args=(frames, t_done))
    producer.start()

    def take(k):  # block until frame k is decoded
        while len(frames) <= k:
            time.sleep(0.001)
        return frames[k]

    take(0)
    st = monocular_init(jnp.asarray(take(0)), mask, Kd, jax.random.PRNGKey(0), cfg)
    for i in range(n_chunks):
        arr = np.stack([take(1 + i * chunk + j) for j in range(chunk)])
        st, res = monocular_run(st, jnp.asarray(arr), masks, Kd, cfg)
    jax.block_until_ready(res.T_world)
    e2e = total / (time.perf_counter() - t0)
    producer.join()
    decode_fps = (total + 1) / (t_done[0] - t0)
    return e2e, decode_fps


def bench_cli(n_frames=97, chunk=24):
    """Throughput of the USER-FACING runner (`python -m dvo_tpu.run --data
    logicool0`): real PNG decode + undistortion remap on the native prefetch
    threads, chunked device-side driver, packed result drain — the number a
    user actually gets from the CLI on this host.  Returns (chunked_fps, per_frame_fps) on the same 24-frame
    prefix so the speedup is attributable."""
    if not os.path.isdir(DATA):
        return None
    from dvo_tpu.config import DVOConfig
    from dvo_tpu.utils.datasets import Calibration, InfoSequence
    from dvo_tpu.utils.runner import run_monocular

    cfg = DVOConfig.monocular()
    calib = Calibration.logicool()
    seq = list(InfoSequence(os.path.join(DATA, "info.txt")))
    # Warmup: compile the chunked scan + per-frame step.
    run_monocular(seq, calib, cfg, max_frames=chunk + 2, chunk=chunk)
    run_monocular(seq, calib, cfg, max_frames=3, chunk=0)
    _, _, secs = run_monocular(seq, calib, cfg, max_frames=n_frames, chunk=chunk)
    chunked_fps = 1.0 / float(np.median(secs))
    _, _, secs_pf = run_monocular(seq, calib, cfg, max_frames=25, chunk=0)
    return chunked_fps, 1.0 / float(np.median(secs_pf))


def bench_kinect_cli(n_frames=60, chunk=24):
    """Kinect v2 dual-camera chunked CLI throughput (run_kinect mono mode:
    decode + undistort + device registration + full VO); depth is
    pre-culled exactly and color by --kinect-gray-cull."""
    kdir = os.path.join(os.path.dirname(DATA), "kinectv2_01")
    if not os.path.isdir(kdir):
        return None
    from dvo_tpu.utils.datasets import InfoSequence, KinectCalibration
    from dvo_tpu.utils.runner import run_kinect

    seq = list(InfoSequence(os.path.join(kdir, "info.txt")))
    kcal = KinectCalibration.kinect_v2()
    run_kinect(seq, kcal, mode="mono", max_frames=chunk + 2, chunk=chunk)
    _, _, secs = run_kinect(
        seq, kcal, mode="mono", max_frames=n_frames, chunk=chunk
    )
    return 1.0 / float(np.median(secs))


def bench_batched(reps=3, chunk=24, streams=8):
    """Multi-stream throughput mode: B independent monocular pipelines
    vmapped into one device program (models/odometry.monocular_run_batched).
    One stream's arrays are too small to fill a device; batching serves
    many cameras per device.  Returns aggregate frames/s across all
    streams (inputs staged on device)."""
    import jax
    import jax.numpy as jnp

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.odometry import monocular_init_batched, monocular_run_batched

    cfg = DVOConfig.monocular()
    frames, K = _load_frames(chunk + 1)
    h, w = frames[0].shape
    # Streams differ by a deterministic circular shift so no two pipelines
    # see identical inputs (keyframe cadences diverge).
    base = np.stack(frames)                                  # (N+1, H, W)
    grays = np.stack([np.roll(base, 3 * s, axis=2) for s in range(streams)])
    Kd = jnp.asarray(K)
    masks = jnp.ones((streams, chunk, h, w), bool)
    dev_grays = jax.device_put(grays[:, 1:])
    jax.block_until_ready(dev_grays)

    states = monocular_init_batched(
        jnp.asarray(grays[:, 0]), masks[:, 0], Kd, jax.random.PRNGKey(0), cfg
    )
    _, res = monocular_run_batched(states, dev_grays, masks, Kd, cfg)
    jax.block_until_ready(res.T_world)
    fps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, res = monocular_run_batched(states, dev_grays, masks, Kd, cfg)
        jax.block_until_ready(res.T_world)
        fps.append(streams * chunk / (time.perf_counter() - t0))
    return float(np.median(fps)), streams


def _kinect_frames(n):
    """Real kinectv2 RGB-D frames registered to the 512x424 depth camera via
    the device registration kernel (the production run_kinect data path) —
    structured depth and real texture, so the early-exit iteration count
    being timed is representative.  Falls back to synthetic when the
    reference data directory is absent."""
    h, w = 424, 512
    if os.path.isdir(KINECT):
        try:
            import jax
            import jax.numpy as jnp
            from PIL import Image

            from dvo_tpu.ops.warp import map_depth_to_gray
            from dvo_tpu.utils.datasets import InfoSequence, KinectCalibration

            seq = list(InfoSequence(os.path.join(KINECT, "info.txt")))[: n]
            kcal = KinectCalibration.kinect_v2()
            rgb_K = jnp.asarray(kcal.rgb.K)
            depth_K = jnp.asarray(kcal.depth.K)
            invT = jnp.asarray(kcal.invT)

            @jax.jit
            def register(gray, depth):
                return map_depth_to_gray(
                    depth, gray, jnp.ones_like(gray, dtype=bool),
                    rgb_K, depth_K, invT,
                )

            grays, depths, sigmas = [], [], []
            for it in seq:
                g = np.asarray(Image.open(it.gray_path).convert("L"),
                               np.float32) / 255.0
                d = np.asarray(Image.open(it.depth_path), np.float32) / 5000.0
                mg, _m, sg = register(jnp.asarray(g), jnp.asarray(d))
                grays.append(np.asarray(mg))
                depths.append(d)
                sigmas.append(np.asarray(sg))
            K = np.asarray(kcal.depth.K)
            return grays, depths, sigmas, K
        except Exception:
            pass
    frames = _synth(h, w, n, seed=2)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (1.6 + 0.4 * np.sin(0.03 * xs) * np.cos(0.025 * ys)).astype(np.float32)
    K = np.array([[365.0, 0, w / 2], [0, 365.0, h / 2], [0, 0, 1]], np.float32)
    return (frames, [depth] * n, [np.full((h, w), 0.1, np.float32)] * n, K)


def bench_rgbd(reps=3, chunk=64):
    import jax
    import jax.numpy as jnp

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.odometry import rgbd_init, rgbd_run

    cfg = DVOConfig.rgbd()
    grays, depths, sigmas, K = _kinect_frames(chunk + 1)
    h, w = grays[0].shape
    Kd = jnp.asarray(K)
    mask = jnp.ones((h, w), bool)

    state = rgbd_init(
        jnp.asarray(grays[0]), mask, jnp.asarray(depths[0]),
        jnp.asarray(sigmas[0]), Kd, cfg
    )
    masks = mask  # shared (H, W) mask
    dev = [
        jax.device_put(np.stack(x[1 : chunk + 1]))
        for x in (grays, depths, sigmas)
    ]
    jax.block_until_ready(dev)
    g_d, d_d, s_d = dev

    _, res = rgbd_run(state, g_d, masks, d_d, s_d, Kd, cfg)
    jax.block_until_ready(res.T_world)
    fps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, res = rgbd_run(state, g_d, masks, d_d, s_d, Kd, cfg)
        jax.block_until_ready(res.T_world)
        fps.append(chunk / (time.perf_counter() - t0))
    return float(np.median(fps))


def main():
    setup_compile_cache()
    device = jax.devices()[0]
    _progress(f"device {device.platform} {device.device_kind}; running monocular")
    mono_fps, gn_iters_per_s = bench_monocular()
    _progress(f"mono {mono_fps:.1f} fps; running rgbd")
    rgbd_fps = bench_rgbd()
    _progress(f"rgbd {rgbd_fps:.1f} fps; running batched")
    batched_fps, streams = bench_batched()
    _progress(f"batched {batched_fps:.1f} agg fps; running e2e decode")
    e2e = bench_e2e_decode()
    _progress("e2e done; running cli")
    cli = bench_cli()
    _progress("cli done; running kinect cli")
    kinect_cli = bench_kinect_cli()
    _progress("done")
    extra = {
        "rgbd_tracking_fps_512x424_real": round(rgbd_fps, 2),
        "gn_iters_per_s_executed": round(gn_iters_per_s, 1),
        f"batched_{streams}stream_agg_fps": round(batched_fps, 2),
        "reps": "median of 3, 96-frame staged device chunks",
        "sync": "jax.block_until_ready after the chunk chain",
        "staging": "input chunks pre-staged on device; see module docstring",
    }
    if e2e is not None:
        extra["e2e_fps_with_decode"] = round(e2e[0], 2)
        extra["host_decode_fps"] = round(e2e[1], 2)
    if cli is not None:
        extra["cli_fps_chunked"] = round(cli[0], 2)
        extra["cli_fps_per_frame"] = round(cli[1], 2)
    if kinect_cli is not None:
        extra["kinect_cli_fps_chunked"] = round(kinect_cli, 2)
    print(json.dumps({
        "metric": "full_pipeline_fps_per_chip",
        "value": round(mono_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(mono_fps / REFERENCE_FPS, 2),
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
