"""Live / streaming capture mode.

The reference's ``USE_CAMERA`` build (main.cpp:10,26-30) pulls frames from a
webcam and odometrizes them as they arrive, drawing the pose trail live;
its companion capture tool (test/record.cpp:21-54) writes numbered PNGs
into a directory.  This equivalent keeps the same contract with a
batch-friendly transport: a **directory watcher** consumes frames as a
producer (camera process, record.cpp, rsync, ...) drops them, feeding the
same jitted per-frame step used by the offline drivers, with an optional
per-frame callback standing in for the live trajectory window.

Nothing here blocks on device work it does not need: the step is
dispatched, the pose fetched, the callback fired — the watcher keeps
polling while the producer writes.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from dvo_tpu.config import DVOConfig


def watch_directory(
    path: str,
    suffix: str = ".png",
    poll_s: float = 0.05,
    idle_timeout_s: float = 5.0,
    stop: Optional[Callable[[], bool]] = None,
) -> Iterator[str]:
    """Yield image paths from ``path`` in sorted filename order as they
    appear (the record.cpp numbered-PNG convention sorts correctly).

    A file is yielded once its size is stable across two polls (the
    producer may still be writing it).  The generator ends after
    ``idle_timeout_s`` with no new frames, or when ``stop()`` is truthy.
    """
    seen = set()
    pending: dict = {}
    last_new = time.monotonic()
    while True:
        if stop is not None and stop():
            return
        try:
            names = sorted(os.listdir(path))
        except FileNotFoundError:
            names = []
        for name in names:
            if not name.endswith(suffix) or name in seen:
                continue
            full = os.path.join(path, name)
            try:
                size = os.path.getsize(full)
            except OSError:
                continue
            if pending.get(name) == size:
                seen.add(name)
                del pending[name]
                yield full
                # Restart the idle clock AFTER the consumer returns: time
                # the consumer spends on the frame (jit compile, tracking)
                # is not producer idleness.
                last_new = time.monotonic()
            else:
                # First sighting (or still growing) counts as activity:
                # the consumer may hold this generator suspended for longer
                # than idle_timeout_s (e.g. a jit compile) and must not
                # time out over files that arrived meanwhile.
                pending[name] = size
                last_new = time.monotonic()
        if time.monotonic() - last_new > idle_timeout_s:
            return
        time.sleep(poll_s)


def run_stream(
    frames: Iterable,
    calib,
    cfg: DVOConfig = DVOConfig.monocular(),
    seed: int = 0,
    undistort: bool = True,
    on_pose: Optional[Callable[[int, np.ndarray], None]] = None,
    trajectory_out: Optional[str] = None,
    verbose: bool = False,
):
    """Monocular VO over a stream of frames (paths or (H, W) float arrays).

    The streaming twin of ``runner.run_monocular`` (reference
    main.cpp:36-54 with USE_CAMERA): frames are consumed one at a time as
    the iterable produces them — there is no upfront ``list(sequence)``, so
    an unbounded producer (``watch_directory``, a camera process) works.

    ``on_pose(i, T_world)`` fires after every frame (the live-trajectory
    draw, main.cpp:49-54); ``trajectory_out`` appends TUM lines as they are
    produced so a consumer can tail the file live.  Returns (timestamps,
    poses (N,4,4), per-frame seconds).
    """
    import jax
    import jax.numpy as jnp

    from dvo_tpu.models.odometry import monocular_init, monocular_step
    from dvo_tpu.utils.datasets import build_undistort_map, load_gray_normalized, remap_nearest
    from dvo_tpu.utils.trajectory import tum_line

    srcmap = (
        build_undistort_map(calib)
        if undistort and getattr(calib, "distortion", None) is not None
        else None
    )
    K = jnp.asarray(calib.K)

    # Native decode+remap (dvo_tpu.native) when the .so is available —
    # streaming yields paths one at a time, so the per-file entry points are
    # used rather than the batch PrefetchLoader.
    try:
        from dvo_tpu import native as _native

        _native.load_library()
    except Exception:
        _native = None

    def prep(frame):
        if isinstance(frame, str) and _native is not None:
            try:
                gray = _native.decode_png_f32(frame, 1 / 255.0)
                if srcmap is not None:
                    gray, mask = _native.remap_nearest(gray, srcmap, border=0.0)
                else:
                    mask = np.ones_like(gray, bool)
                return jnp.asarray(gray), jnp.asarray(mask)
            except Exception:
                pass  # non-PNG or decode error -> PIL fallback below
        gray = load_gray_normalized(frame) if isinstance(frame, str) else np.asarray(frame, np.float32)
        if srcmap is not None:
            gray, mask = remap_nearest(gray, srcmap, border=0.0)
        else:
            mask = np.ones_like(gray, bool)
        return jnp.asarray(gray.astype(np.float32)), jnp.asarray(mask)

    fh = open(trajectory_out, "w") if trajectory_out else None
    state = None
    poses, times, secs = [], [], []
    try:
        for i, frame in enumerate(frames):
            ts = time.time()
            gray, mask = prep(frame)
            t0 = time.perf_counter()
            if state is None:
                state = monocular_init(gray, mask, K, jax.random.PRNGKey(seed), cfg)
                T = np.eye(4, dtype=np.float32)
            else:
                state, res = monocular_step(state, gray, mask, K, cfg)
                jax.block_until_ready(res.T_world)
                T = np.asarray(res.T_world)
            secs.append(time.perf_counter() - t0)
            poses.append(T)
            times.append(ts)
            if fh is not None:
                fh.write(tum_line(ts, T) + "\n")
                fh.flush()
            if on_pose is not None:
                on_pose(i, T)
            if verbose:
                print(f"stream frame {i:4d} {secs[-1] * 1e3:7.1f} ms", flush=True)
    finally:
        if fh is not None:
            fh.close()
    return np.asarray(times), np.stack(poses) if poses else np.zeros((0, 4, 4)), np.asarray(secs)
