#!/usr/bin/env python3
"""Smoke test of dvo_tpu on an NVIDIA GPU: the quickest proof that the
system still starts, compiles and computes the right thing on the card.

    python3 chip_smoke.py              # one GPU
    python3 chip_smoke.py --devices 4  # only the multi-card paths, 4 GPUs

Phases (one GPU):

1. device — platform, device kind, count, and the card's name and power
   limit from nvidia-smi;
2. sites — the four hot-path sites (GN linearization, epipolar depth
   update, regularize, pyramid build) and propagate at real widths, each
   compared with the same jitted function run on the CPU at HIGHEST
   matmul precision, and timed on the card;
3. mono_cli — ``python -m dvo_tpu.run`` on a generated 640x480
   monocular sequence (96 frames, chunked driver, mapping on);
4. mono_ba_pose_graph — the same CLI with ``--ba --pose-graph`` on 48
   frames;
5. rgbd_cli — the CLI on a generated 640x480 TUM-layout RGB-D sequence
   (64 frames).

With ``--devices 4`` it runs phase 1, then only the multi-card paths and
what they are compared with: four monocular streams on a four-card
``stream`` mesh against each stream alone on one card, and
``__graft_entry__.dryrun_multichip(4)`` against the unsharded step.

Every phase prints one JSON line.  A failed phase prints its error and the
script exits non-zero after the remaining phases; it prints the final
``{"ok": true, ...}`` line only when every phase passed.  Without a GPU it
exits non-zero before any phase.  Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, each stated with the precision it holds at.  GPU side: the
# program as shipped (every f32 contraction at HIGHEST); CPU side: the same
# jitted function on the host CPU device under
# jax.default_matmul_precision("highest").
TOL = {
    # GN normal equations at 256x212: ||dH|| / ||H||, ||dg|| / ||g||.
    "gn_rel": 1e-5,
    # depth_update at 160x120: observed / accepted counts, relative.
    "count_rel": 0.005,
    # ... depth and sigma on pixels written on both sides: |d| <= 1e-4 on
    # >= 99% of them (argmin near-ties may flip a few pixels).
    "depth_abs": 1e-4,
    "depth_share": 0.99,
    # regularize: max |d| over the map.
    "regularize_abs": 1e-6,
    # Monocular CLI: scale-aligned ATE bound [m] over the ~0.5 m path of
    # the generated sequence, and the first 24 frame-to-frame twists
    # against a CPU run of the same command (max abs component).
    "mono_ate_m": 0.06,
    "mono_twist_abs": 1e-3,
    # RGB-D CLI: ATE bound [m] over ~0.3 m of motion, and camera
    # translations against a CPU run of the same command [m].
    "rgbd_ate_m": 0.01,
    "rgbd_pos_abs_m": 1e-4,
    # Multi-card streams: T_world max |d| against each stream alone
    # (tests/test_parallel.py::test_stream_sharded_matches_batched).
    "streams_abs": 1e-3,
}


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------- comparisons

def rel_err(a, b) -> float:
    """Frobenius-norm relative error of ``a`` against reference ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def count_rel(a: int, b: int) -> float:
    return abs(int(a) - int(b)) / max(abs(int(b)), 1)


def written_agreement(new, old, new_ref, old_ref, tol):
    """Share of pixels written on both sides (output differs from input)
    whose outputs agree within ``tol``.  Returns (share, n_both)."""
    new, old = np.asarray(new), np.asarray(old)
    new_ref, old_ref = np.asarray(new_ref), np.asarray(old_ref)
    both = (new != old) & (new_ref != old_ref)
    n = int(both.sum())
    if n == 0:
        return 1.0, 0
    close = np.abs(new[both] - new_ref[both]) <= tol
    return float(close.mean()), n


def read_trajectory(path):
    """TUM trajectory file -> (timestamps (N,), poses (N, 4, 4))."""
    from scipy.spatial.transform import Rotation

    rows = np.loadtxt(path, ndmin=2)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = Rotation.from_quat(rows[:, 4:8]).as_matrix()
    poses[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], poses


def frame_twists(poses):
    """Frame-to-frame twists log(T_k inv(T_{k-1})), (N-1, 6)."""
    from dvo_tpu.utils import oracle

    return np.stack([
        oracle.se3_log(poses[k] @ np.linalg.inv(poses[k - 1]))
        for k in range(1, len(poses))
    ])


def pose_graph_costs(text):
    """(first, last) pose-graph cost from the runner's --verbose line
    ``pose-graph: N nodes, E edges (C closures), cost a -> b``."""
    for line in text.splitlines():
        if line.startswith("pose-graph:") and "cost" in line:
            a, b = line.rsplit("cost", 1)[1].split("->")
            return float(a), float(b)
    return None


def timed(fn, *args, n=20):
    """(cold seconds incl. compile, warm ms per call): ``n`` pipelined
    calls, synchronised once at the end."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, cold, (time.perf_counter() - t0) / n * 1e3


# ------------------------------------------------------------------- device

def require_gpu(count: int):
    """The devices to run on; exits non-zero unless JAX runs on a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX runs on {devices[0].platform}, not a GPU",
              file=sys.stderr)
        sys.exit(2)
    if len(devices) < count:
        print(f"chip_smoke: need {count} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    return devices


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_device(devices):
    lines = nvidia_smi()
    for ln in lines:
        print(ln, flush=True)
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": lines,
    }


def decoder_name():
    """Which PNG decoder the data plane uses on this host."""
    from dvo_tpu import native

    try:
        native.load_library()
        return "native"
    except native.NativeUnavailable as e:
        return f"numpy ({str(e).splitlines()[0][:120]})"


# -------------------------------------------------------------------- sites

def _frame_pair(K, size, levels, steps=3, seed=0):
    """Two rendered frames ``steps`` generator steps apart, with measured
    depth, and the ground-truth relative twist (obj vs ref)."""
    import jax.numpy as jnp

    from dvo_tpu.models.frame import build_frame_with_depth
    from dvo_tpu.utils import oracle, synth

    planes = synth.make_scene(seed)
    path = synth.camera_path(steps + 1)
    gt = synth.ground_truth(path)
    frames = []
    for k in (0, steps):
        gray, depth = synth.render(planes, K, size, path[k])
        frames.append(build_frame_with_depth(
            jnp.asarray(gray), jnp.asarray(depth > 0), jnp.asarray(depth),
            jnp.full(depth.shape, 0.1, jnp.float32),
            jnp.asarray(K, jnp.float32), levels, 0, k,
        ))
    return frames[1], frames[0], oracle.se3_log(gt[steps]).astype(np.float32)


def site_gn(dev, ref_dev, size, K, level_index):
    """GN normal equations (tracker.gn_normal_equations) on ``dev`` vs
    ``ref_dev``.  Returns (fields, passed)."""
    import jax
    import jax.numpy as jnp

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.tracker import gn_normal_equations

    cfg = DVOConfig.rgbd().tracker
    obj, ref, xi_true = _frame_pair(K, size, levels=1)
    # Linearize away from the optimum so residuals and gradients are live.
    xi = jnp.asarray(xi_true + np.float32(0.002))
    fn = jax.jit(lambda o, r, x: gn_normal_equations(o, r, x, level_index, cfg))
    args = (obj.scenes[0], ref.scenes[0], xi)
    (H, g, rs, n), cold, warm_ms = timed(fn, *jax.device_put(args, dev))
    with jax.default_matmul_precision("highest"):
        H1, g1, rs1, n1 = fn(*jax.device_put(args, ref_dev))
    f = {
        "size": list(size), "valid_px": [int(n), int(n1)],
        "H_rel": rel_err(H, H1), "g_rel": rel_err(g, g1),
        "cold_s": cold, "warm_ms": warm_ms,
    }
    ok = (int(n) == int(n1) and f["H_rel"] <= TOL["gn_rel"]
          and f["g_rel"] <= TOL["gn_rel"])
    return f, ok


def _mapping_state(K, size, seed=0):
    """A 3-keyframe ring at ``size`` (rendered; ground-truth depth with
    0.3 m noise and the bootstrap sigma 0.5) and a current frame four
    generator steps past the newest keyframe: the depth-update inputs.
    About 600 pixels pass the observation gates."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dvo_tpu.models.frame import build_frame_with_depth
    from dvo_tpu.models.history import KeyframeHistory, push
    from dvo_tpu.utils import oracle, synth

    rng = np.random.default_rng(seed)
    planes = synth.make_scene(seed)
    path = synth.camera_path(11)
    gt = synth.ground_truth(path)
    Kf = jnp.asarray(K, jnp.float32)

    def frame(k, noise):
        gray, depth = synth.render(planes, K, size, path[k])
        depth = np.maximum(
            depth + noise * rng.standard_normal(depth.shape), 0.3
        ).astype(np.float32)
        f = build_frame_with_depth(
            jnp.asarray(gray), jnp.ones(depth.shape, bool), jnp.asarray(depth),
            jnp.full(depth.shape, 0.5, jnp.float32), Kf, 1, 0, k,
        )
        return dataclasses.replace(
            f, xi=jnp.asarray(oracle.se3_log(gt[k]), jnp.float32)
        )

    w, h = size
    hist = KeyframeHistory.create(8, h, w)
    for k in (0, 3, 6):
        ref = frame(k, 0.3)
        hist = push(hist, ref)
    obj = frame(10, 0.0)
    # with_pose: exp(xi_obj) = exp(xi_ref) @ exp(rel).
    rel = jnp.asarray(
        oracle.se3_log(np.linalg.inv(gt[6]) @ gt[10]), jnp.float32
    )
    age = jnp.asarray(rng.integers(0, 3, (h, w)), jnp.int32)
    return (obj.base, obj.xi, rel, ref.base.depth, ref.base.sigma, age,
            hist, jax.random.PRNGKey(seed))


def site_mapping(dev, ref_dev, size, K):
    """depth_update, regularize and propagate on ``dev`` vs ``ref_dev``.
    Returns (fields per site, passed per site)."""
    import jax

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.mapper import depth_update, propagate, regularize

    cfg = DVOConfig.monocular()
    args = _mapping_state(K, size)
    upd = jax.jit(lambda *a: depth_update(*a, cfg.mapper))
    (d, s, age, st), cold, warm = timed(upd, *jax.device_put(args, dev))
    with jax.default_matmul_precision("highest"):
        d1, s1, age1, st1 = upd(*jax.device_put(args, ref_dev))
    old_d, old_s = np.asarray(args[3]), np.asarray(args[4])
    d_share, n_both = written_agreement(d, old_d, d1, old_d, TOL["depth_abs"])
    s_share, _ = written_agreement(s, old_s, s1, old_s, TOL["depth_abs"])
    fu = {
        "size": list(size),
        "observed": [int(st.observed), int(st1.observed)],
        "accepted": [int(st.accepted), int(st1.accepted)],
        "written_both": n_both, "depth_agree": d_share, "sigma_agree": s_share,
        "cold_s": cold, "warm_ms": warm,
    }
    ok_u = (count_rel(st.observed, st1.observed) <= TOL["count_rel"]
            and count_rel(st.accepted, st1.accepted) <= TOL["count_rel"]
            and n_both > 0 and d_share >= TOL["depth_share"]
            and s_share >= TOL["depth_share"])

    reg = jax.jit(lambda dd, ss: regularize(dd, ss, cfg.mapper))
    r, cold, warm = timed(reg, *jax.device_put((d1, s1), dev))
    r1 = reg(*jax.device_put((d1, s1), ref_dev))
    fr = {"max_abs": float(np.max(np.abs(np.asarray(r) - np.asarray(r1)))),
          "cold_s": cold, "warm_ms": warm}
    ok_r = fr["max_abs"] <= TOL["regularize_abs"]

    prop = jax.jit(lambda dd, ss, aa, x, k: propagate(
        dd, ss, aa, x, k, cfg.mapper, cfg.init))
    pargs = jax.device_put((args[3], args[4], args[5], args[2], args[0].K), dev)
    p_a, cold, warm = timed(prop, *pargs)
    p_b = prop(*pargs)
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(p_a, p_b))
    fp = {"bit_identical": same, "cold_s": cold, "warm_ms": warm}
    return ({"depth_update": fu, "regularize": fr, "propagate": fp},
            {"depth_update": ok_u, "regularize": ok_r, "propagate": same})


def site_build(dev, ref_dev, size, K, levels=3, culls=2):
    """Monocular frame build (uint8 input -> culled 3-level pyramid with
    gradients) on ``dev`` vs ``ref_dev``."""
    import jax
    import jax.numpy as jnp

    from dvo_tpu.models.frame import build_frame
    from dvo_tpu.utils import synth

    gray, _ = synth.render(synth.make_scene(0), K, size, np.eye(4))
    args = (jnp.asarray(np.rint(gray * 255).astype(np.uint8)),
            jnp.ones(gray.shape, bool), jnp.asarray(K, jnp.float32),
            jax.random.PRNGKey(0))
    fn = jax.jit(lambda g, m, k, key: build_frame(g, m, k, levels, culls, key, 0))
    f, cold, warm = timed(fn, *jax.device_put(args, dev))
    f1 = fn(*jax.device_put(args, ref_dev))
    diff = max(float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))
               for a, b in zip(jax.tree_util.tree_leaves(f), jax.tree_util.tree_leaves(f1)))
    return {"size": list(size), "levels": levels, "max_abs": diff,
            "cold_s": cold, "warm_ms": warm}, diff <= 1e-6


def phase_sites(dev, ref_dev, scale=1):
    """The four former kernel sites and propagate at real widths
    (``scale`` > 1 divides every size, for tests)."""
    from dvo_tpu.utils import synth
    from dvo_tpu.utils.datasets import KinectCalibration

    def sz(w, h):
        return (w // scale, h // scale)

    def cull(K, by):
        return np.asarray(K, np.float64) / [[by], [by], [1]]

    # RGB-D base: Kinect v2 depth intrinsics (datasets.py) culled 2x.
    k_rgbd = cull(KinectCalibration.kinect_v2().depth.K, 2 * scale)
    k_mono = cull(synth.LOGICOOL_K, 4 * scale)
    k_full = cull(synth.LOGICOOL_K, scale)
    fields, oks = {}, {}
    fields["gn_256x212"], oks["gn_256x212"] = site_gn(dev, ref_dev, sz(256, 212), k_rgbd, 3)
    fields["gn_160x120"], oks["gn_160x120"] = site_gn(dev, ref_dev, sz(160, 120), k_mono, 2)
    f, o = site_mapping(dev, ref_dev, sz(160, 120), k_mono)
    fields.update(f)
    oks.update(o)
    fields["build_640x480"], oks["build_640x480"] = site_build(dev, ref_dev, sz(640, 480), k_full)
    failed = [k for k, ok in oks.items() if not ok]
    fields["tolerances"] = {k: TOL[k] for k in
                            ("gn_rel", "count_rel", "depth_abs", "depth_share",
                             "regularize_abs")}
    return fields, failed


# --------------------------------------------------------------------- CLI

def run_cli(argv, device=None):
    """``dvo_tpu.run.main(argv)`` on ``device`` (JAX's default when None).
    Returns (report dict, captured stdout, wall seconds)."""
    import jax

    from dvo_tpu.run import main

    buf = io.StringIO()
    ctx = jax.default_device(device) if device is not None else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx, contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    check(rc == 0, f"run.main returned {rc}")
    return json.loads(text.strip().splitlines()[-1]), text, wall


def cli_timings(argv, platform):
    """Cold (empty in-memory caches), persistent-cache and warm runs of the
    CLI on the default device.  Returns (last report, timing fields)."""
    import jax

    rep, _, cold = run_cli(argv)
    check(rep["device"]["platform"] == platform, f"CLI ran on {rep['device']}")
    jax.clear_caches()    # drop compiled programs; the disk cache stays
    rep_c, _, cached = run_cli(argv)
    rep_w, _, warm = run_cli(argv)
    return rep_w, {"cold_s": cold, "cache_s": cached, "warm_s": warm,
                   "fps_cold": rep["fps"], "fps_cache": rep_c["fps"],
                   "fps_warm": rep_w["fps"]}


def phase_mono_cli(work, cpu, n=96, platform="gpu"):
    from dvo_tpu.utils import synth

    t0 = time.perf_counter()
    data = synth.write_info_sequence(os.path.join(work, "mono"), n)
    gen_s = time.perf_counter() - t0
    base = ["--data", data, "--calib", os.path.join(data, "calib.yaml"),
            "--gt", os.path.join(data, "groundtruth.txt")]
    out_gpu = os.path.join(work, "mono_gpu.txt")
    rep, times = cli_timings(base + ["--out", out_gpu], platform)
    _, poses = read_trajectory(out_gpu)
    out_cpu = os.path.join(work, "mono_cpu.txt")
    rep_cpu, _, cpu_s = run_cli(
        base + ["--out", out_cpu, "--max-frames", str(min(n, 25))], cpu)
    _, poses_cpu = read_trajectory(out_cpu)
    tw = np.abs(frame_twists(poses[:len(poses_cpu)]) - frame_twists(poses_cpu)).max()
    f = {"frames": len(poses), "ate_rmse_m": rep["ate_rmse_m"],
         "twist24_max_abs_vs_cpu": float(tw), "cpu_device": rep_cpu["device"],
         "cpu_s": cpu_s, "gen_s": gen_s, **times}
    failed = []
    if len(poses) != n or not np.all(np.isfinite(poses)):
        failed.append("poses")
    if not rep["ate_rmse_m"] <= TOL["mono_ate_m"]:
        failed.append("ate")
    if not tw <= TOL["mono_twist_abs"]:
        failed.append("twists_vs_cpu")
    if rep_cpu["device"]["platform"] != "cpu":
        failed.append("cpu_reference_device")
    return f, failed


def phase_mono_ba_pg(work, n=48):
    data = os.path.join(work, "mono")
    out = os.path.join(work, "mono_ba_pg.txt")
    rep, text, wall = run_cli([
        "--data", data, "--calib", os.path.join(data, "calib.yaml"),
        "--gt", os.path.join(data, "groundtruth.txt"), "--max-frames", str(n),
        "--ba", "--pose-graph", "--verbose", "--out", out,
    ])
    _, poses = read_trajectory(out)
    costs = pose_graph_costs(text)
    f = {"frames": len(poses), "ate_rmse_m": rep.get("ate_rmse_m"),
         "pose_graph_cost": costs, "fps": rep["fps"], "wall_s": wall,
         "device": rep["device"]}
    failed = []
    if len(poses) != n or not np.all(np.isfinite(poses)):
        failed.append("poses")
    if costs is None or not costs[1] <= costs[0]:
        failed.append("pose_graph_cost")
    return f, failed


def phase_rgbd_cli(work, cpu, n=64, platform="gpu"):
    from dvo_tpu.utils import synth

    t0 = time.perf_counter()
    data = synth.write_tum_sequence(os.path.join(work, "tum"), n)
    gen_s = time.perf_counter() - t0
    base = ["--data", data, "--format", "tum", "--mode", "rgbd",
            "--calib", os.path.join(data, "calib.yaml"),
            "--gt", os.path.join(data, "groundtruth.txt")]
    out_gpu = os.path.join(work, "rgbd_gpu.txt")
    rep, times = cli_timings(base + ["--out", out_gpu], platform)
    _, poses = read_trajectory(out_gpu)
    out_cpu = os.path.join(work, "rgbd_cpu.txt")
    rep_cpu, _, cpu_s = run_cli(base + ["--out", out_cpu], cpu)
    _, poses_cpu = read_trajectory(out_cpu)
    dpos = float(np.abs(poses[:, :3, 3] - poses_cpu[:, :3, 3]).max())
    _, gt = read_trajectory(os.path.join(data, "groundtruth.txt"))
    centres = np.stack([np.linalg.inv(T)[:3, 3] for T in gt])
    path_m = float(np.linalg.norm(np.diff(centres, axis=0), axis=1).sum())
    f = {"frames": len(poses), "ate_rmse_m": rep["ate_rmse_m"],
         "path_m": path_m, "pos_max_abs_vs_cpu_m": dpos,
         "cpu_device": rep_cpu["device"], "cpu_s": cpu_s, "gen_s": gen_s,
         **times}
    failed = []
    if len(poses) != n or not np.all(np.isfinite(poses)) or len(gt) != n:
        failed.append("poses")
    if not rep["ate_rmse_m"] <= TOL["rgbd_ate_m"]:
        failed.append("ate")
    if not dpos <= TOL["rgbd_pos_abs_m"]:
        failed.append("poses_vs_cpu")
    if rep_cpu["device"]["platform"] != "cpu":
        failed.append("cpu_reference_device")
    return f, failed


# --------------------------------------------------------------- multi-card

def phase_streams(devices, n_frames=8, size=(160, 120)):
    """Four monocular streams on a four-device ``stream`` mesh against each
    stream run alone on the first device."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dvo_tpu.config import DVOConfig, PyramidConfig
    from dvo_tpu.models.odometry import monocular_init_batched, monocular_run
    from dvo_tpu.parallel.mesh import make_mesh
    from dvo_tpu.parallel.streams import monocular_run_streams
    from dvo_tpu.utils import synth

    b = len(devices)
    K = synth.LOGICOOL_K / [[640 / size[0]], [480 / size[1]], [1]]
    grays = np.stack([
        np.stack([synth.render(synth.make_scene(s), K, size, T)[0]
                  for T in synth.camera_path(n_frames + 1)])
        for s in range(b)
    ])                                                   # (B, N+1, H, W)
    masks = np.ones(grays.shape, bool)
    # Deterministic data path, as in the CPU-mesh test: fixed-length GN
    # and promote-every-frame mapping, so reduction-order noise between two
    # compilations is not amplified by iteration-count flips or the
    # epipolar accept/reject thresholds.
    cfg = DVOConfig.monocular()
    cfg = dataclasses.replace(
        cfg, pyramid=PyramidConfig(levels=3, culls=0),
        tracker=dataclasses.replace(cfg.tracker, early_exit=False),
        mapper=dataclasses.replace(cfg.mapper, max_forward=1, min_movement=0.0),
    )
    Kj = jnp.asarray(K, jnp.float32)
    states = monocular_init_batched(
        jnp.asarray(grays[:, 0]), jnp.asarray(masks[:, 0]), Kj,
        jax.random.PRNGKey(0), cfg,
    )
    mesh = make_mesh((b,), ("stream",), devices)
    t0 = time.perf_counter()
    _, res = monocular_run_streams(
        mesh, states, jnp.asarray(grays[:, 1:]), jnp.asarray(masks[:, 1:]), Kj, cfg
    )
    sh = np.asarray(jax.block_until_ready(res.T_world))
    wall = time.perf_counter() - t0
    diffs, cross = [], []
    singles = []
    for s in range(b):
        st = jax.device_put(jax.tree_util.tree_map(lambda a: a[s], states), devices[0])
        _, r = monocular_run(st, jnp.asarray(grays[s, 1:]), jnp.asarray(masks[s, 1:]), Kj, cfg)
        singles.append(np.asarray(r.T_world))
    for s in range(b):
        diffs.append(float(np.abs(sh[s] - singles[s]).max()))
        cross.append(float(min(np.abs(sh[s] - singles[t]).max()
                               for t in range(b) if t != s)))
    f = {"streams": b, "frames": n_frames, "size": list(size),
         "max_abs_vs_single": diffs, "min_abs_vs_other_streams": cross,
         "wall_s": wall}
    failed = [] if max(diffs) <= TOL["streams_abs"] and min(cross) > 10 * max(max(diffs), 1e-4) else ["streams"]
    return f, failed


def phase_dryrun(n):
    sys.path.insert(0, ROOT)
    import __graft_entry__

    t0 = time.perf_counter()
    out = __graft_entry__.dryrun_multichip(n)
    out["wall_s"] = time.perf_counter() - t0
    return out, []


# --------------------------------------------------------------------- main

def run_phase(name, fn, *args):
    """Run one phase; print its JSON line.  Returns True when it passed."""
    t0 = time.perf_counter()
    try:
        fields, failed = fn(*args)
    except Exception as e:   # report every phase, fail at the end
        traceback.print_exc()
        emit(name, ok=False, error=f"{type(e).__name__}: {e}"[:2000],
             seconds=time.perf_counter() - t0)
        return False
    emit(name, ok=not failed, failed=failed, seconds=time.perf_counter() - t0,
         **fields)
    return not failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the multi-card paths on four GPUs")
    ap.add_argument("--work", default=os.path.join(ROOT, ".smoke"),
                    help="directory for the generated sequences")
    args = ap.parse_args(argv)

    import jax

    devices = require_gpu(args.devices)
    sys.path.insert(0, ROOT)
    from dvo_tpu.utils.cache import setup_compile_cache

    cache_dir = setup_compile_cache()
    cache_entries = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    os.makedirs(args.work, exist_ok=True)
    cpu = jax.devices("cpu")[0]

    dev_fields = phase_device(devices)
    emit("device", ok=True, decoder=decoder_name(), cache_dir=cache_dir,
         cache_entries_at_start=cache_entries, **dev_fields)
    if args.devices == 4:
        results = [
            run_phase("streams", phase_streams, devices[:4]),
            run_phase("dryrun_multichip", phase_dryrun, 4),
        ]
    else:
        results = [
            run_phase("sites", phase_sites, devices[0], cpu),
            run_phase("mono_cli", phase_mono_cli, args.work, cpu),
            run_phase("mono_ba_pose_graph", phase_mono_ba_pg, args.work),
            run_phase("rgbd_cli", phase_rgbd_cli, args.work, cpu),
        ]
    if not all(results):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
