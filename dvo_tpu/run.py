"""CLI entry point — the reference's demo app (main.cpp / test/kinect-vo.cpp)
as a batch runner: dataset in, TUM trajectory out, optional ATE.

Examples:
    python -m dvo_tpu.run --data path/to/logicool0 --mode mono \
        --out traj.txt --max-frames 100
    python -m dvo_tpu.run --data /path/to/tum/fr1_xyz --mode rgbd \
        --format tum --out traj.txt --gt groundtruth.txt
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True, help="sequence directory")
    ap.add_argument("--mode", choices=["mono", "rgbd"], default="mono")
    ap.add_argument("--format", choices=["info", "tum", "kinect", "euroc"], default="info",
                    help="info = reference info.txt (mono); tum = TUM rgb.txt/depth.txt; "
                         "kinect = info.txt with 'rgb depth' pairs + dual-camera registration; "
                         "euroc = EuRoC MAV ASL directory (mono)")
    ap.add_argument("--calib", default=None,
                    help="calibration YAML (default: logicool/TUM presets)")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--gt", default=None, help="ground-truth TUM file for ATE")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=24,
                    help="frames per device-side lax.scan chunk (the chunked "
                         "driver overlaps decode, transfer, execution, and "
                         "result drain; same trajectory as per-frame up to "
                         "float noise).  0 = per-frame dispatch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-undistort", action="store_true")
    ap.add_argument("--kinect-gray-cull", type=int, default=2,
                    help="host pre-cull stride for the kinect COLOR stream "
                         "(1 disables; depth is always pre-culled exactly — "
                         "utils.runner.run_kinect docstring)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="run on this JAX platform and fail if it has no "
                         "device (default: JAX's own choice)")
    ap.add_argument("--metrics", default=None,
                    help="write per-frame JSONL metrics to this path")
    ap.add_argument("--checkpoint", default=None,
                    help="save the final VO device state (.npz) here (mono mode)")
    ap.add_argument("--ba", action="store_true",
                    help="run windowed bundle adjustment on every keyframe "
                         "promotion (mono mode)")
    ap.add_argument("--ba-window", type=int, default=4,
                    help="BA window size in keyframes (<= history capacity)")
    ap.add_argument("--ba-iters", type=int, default=5,
                    help="BA Gauss-Newton iterations per window")
    ap.add_argument("--pose-graph", action="store_true",
                    help="global pose-graph refinement over the keyframe "
                         "trajectory at sequence end (odometry + BA-window + "
                         "re-tracked loop-closure constraints; mono mode)")
    ap.add_argument("--pose-graph-every", type=int, default=0,
                    help="with --pose-graph: additionally refine every K "
                         "keyframe promotions and write the corrections "
                         "back into the LIVE keyframe ring, so mid-run "
                         "drift repairs the mapping geometry as it happens "
                         "(0 = refine only at sequence end)")
    ap.add_argument("--plot", default=None,
                    help="write a trajectory PNG (pose trail; the reference's "
                         "glfw-drawer window as an offline plot)")
    ap.add_argument("--gallery", default=None,
                    help="write the final keyframe-ring gallery PNG "
                         "(SHOW_KEYFRAME panel; mono mode)")
    ap.add_argument("--trace", default=None,
                    help="capture a jax.profiler trace of the whole run "
                         "into this directory (view with TensorBoard/xprof)")
    ap.add_argument("--stream", action="store_true",
                    help="live mode (reference USE_CAMERA, main.cpp:10,26-30): "
                         "watch --data for new PNGs and odometrize them as "
                         "they appear; the TUM file is appended live")
    ap.add_argument("--stream-idle", type=float, default=5.0,
                    help="stop streaming after this many seconds without a "
                         "new frame")
    args = ap.parse_args(argv)

    import jax

    from dvo_tpu.utils.cache import setup_compile_cache

    if args.platform:
        # JAX names the NVIDIA platform "cuda" here; "gpu" would also ask
        # for ROCm and fail where it is absent.
        jax.config.update(
            "jax_platforms", "cuda" if args.platform == "gpu" else args.platform
        )
    # The device JAX computes on: honours a surrounding jax.default_device.
    device = jax.config.jax_default_device or jax.devices()[0]
    if isinstance(device, str):
        device = jax.devices(device)[0]
    if args.platform and device.platform != args.platform:
        raise SystemExit(
            f"--platform {args.platform}: JAX runs on {device.platform}"
        )
    setup_compile_cache()

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.utils.datasets import (
        Calibration,
        InfoSequence,
        KinectCalibration,
        TUMSequence,
    )
    from dvo_tpu.utils.runner import run_kinect, run_monocular, run_rgbd
    from dvo_tpu.utils.trajectory import ate_rmse, read_tum, write_tum

    from dvo_tpu.utils.metrics import MetricsLogger

    metrics = MetricsLogger(args.metrics)
    # mono estimates depth up to scale; ATE is evaluated with Umeyama scale
    # alignment there (kinect modes carry metric depth, no scale fit).
    ate_with_scale = args.mode == "mono" and args.format != "kinect"

    import dataclasses as _dc

    cfg_mono = DVOConfig.monocular()
    if args.ba:
        cfg_mono = _dc.replace(
            cfg_mono,
            ba=_dc.replace(
                cfg_mono.ba, enabled=True, window=args.ba_window,
                iterations=args.ba_iters,
            ),
        )

    import contextlib

    if args.trace:
        import jax

        trace_ctx = jax.profiler.trace(args.trace)
    else:
        trace_ctx = contextlib.nullcontext()

    if args.stream:
        if args.mode != "mono" or args.format != "info":
            raise SystemExit("--stream supports --mode mono --format info")
        from dvo_tpu.utils.stream import run_stream, watch_directory

        calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.logicool()
        with trace_ctx:
            ts, poses, secs = run_stream(
                watch_directory(args.data, idle_timeout_s=args.stream_idle),
                calib, cfg_mono, seed=args.seed,
                undistort=not args.no_undistort,
                trajectory_out=args.out, verbose=args.verbose,
            )
        metrics.close()
        report = {
            "frames": len(ts),
            "fps": round(float(1.0 / np.median(secs)), 2) if len(secs) else None,
            "trajectory": args.out,
            "streamed": True,
            "device": {"platform": device.platform, "kind": device.device_kind},
        }
        print(json.dumps(report))
        return 0

    if args.format == "kinect":
        import os

        seq = InfoSequence(os.path.join(args.data, "info.txt"))
        kcal = (
            KinectCalibration.from_yaml(args.calib)
            if args.calib
            else KinectCalibration.kinect_v2()
        )
        with trace_ctx:
            ts, poses, secs = run_kinect(
                seq, kcal, cfg=cfg_mono if args.mode == "mono" else None,
                mode=args.mode, max_frames=args.max_frames,
                undistort=not args.no_undistort, verbose=args.verbose,
                metrics=metrics, chunk=args.chunk,
                gray_cull=args.kinect_gray_cull,
            )
    elif args.format == "euroc":
        from dvo_tpu.utils.datasets import EuRoCSequence

        seq = EuRoCSequence(args.data)
        calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.euroc_cam0()
        if args.mode != "mono":
            raise SystemExit("EuRoC sequences are monocular; use --mode mono")
    elif args.format == "tum":
        seq = TUMSequence(args.data)
        calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.tum_freiburg1()
    else:
        import os

        seq = InfoSequence(os.path.join(args.data, "info.txt"))
        calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.logicool()

    if args.format == "kinect":
        pass
    elif args.mode == "mono":
        with trace_ctx:
            ts, poses, secs = run_monocular(
                seq, calib, cfg_mono, seed=args.seed,
                max_frames=args.max_frames, undistort=not args.no_undistort,
                verbose=args.verbose, metrics=metrics,
                checkpoint_out=args.checkpoint, gallery_out=args.gallery,
                pose_graph=args.pose_graph,
                pose_graph_every=args.pose_graph_every, chunk=args.chunk,
            )
    else:
        with trace_ctx:
            ts, poses, secs = run_rgbd(
                seq, calib, DVOConfig.rgbd(),
                max_frames=args.max_frames, undistort=not args.no_undistort,
                verbose=args.verbose, metrics=metrics, chunk=args.chunk,
            )

    metrics.close()
    write_tum(args.out, ts, poses)
    if args.plot:
        from dvo_tpu.utils.viz import plot_trajectory

        gt_xyz_plot = None
        if args.gt:
            _, gt_xyz_plot = read_tum(args.gt)
        plot_trajectory(poses, args.plot, gt=gt_xyz_plot)
    report = {
        "frames": len(ts),
        "fps": round(float(1.0 / np.median(secs)), 2) if len(secs) else None,
        "trajectory": args.out,
        "device": {"platform": device.platform, "kind": device.device_kind},
    }
    if args.chunk and len(ts) < 5 * args.chunk:
        # With few chunks the median per-frame wall still carries the
        # one-time program compile / cache load; steady state needs a
        # longer run or a warm compile cache.
        report["note"] = (
            "short run: fps includes compile/cache-load amortization; "
            "steady-state throughput needs >= 5 chunks"
        )
    if args.gt:
        gt_t, gt_xyz = read_tum(args.gt)
        est_xyz = poses[:, :3, 3]
        report["ate_rmse_m"] = round(
            ate_rmse(ts, est_xyz, gt_t, gt_xyz, with_scale=ate_with_scale), 4
        )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
