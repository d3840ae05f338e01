"""Host-utility tests: trajectory IO, ATE, dataset parsing (against
sequences from the seeded generator, utils/synth.py)."""

import os

import numpy as np
import pytest

from dvo_tpu.utils import oracle
from dvo_tpu.utils.datasets import (
    Calibration,
    InfoSequence,
    build_undistort_map,
    remap_nearest,
)
from dvo_tpu.utils.trajectory import (
    align_umeyama,
    associate,
    ate_rmse,
    read_tum,
    rotation_to_quaternion,
    write_tum,
)



def test_quaternion_roundtrip(rng):
    for _ in range(20):
        w = rng.standard_normal(3) * 0.8
        R = oracle.so3_exp(w)
        q = rotation_to_quaternion(R)
        x, y, z, qw = q
        # rebuild R from quaternion
        R2 = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * qw), 2 * (x * z + y * qw)],
            [2 * (x * y + z * qw), 1 - 2 * (x * x + z * z), 2 * (y * z - x * qw)],
            [2 * (x * z - y * qw), 2 * (y * z + x * qw), 1 - 2 * (x * x + y * y)],
        ])
        np.testing.assert_allclose(R2, R, atol=1e-6)


def test_tum_write_read_roundtrip(tmp_path, rng):
    poses = []
    ts = []
    for i in range(5):
        T = oracle.se3_exp(rng.standard_normal(6) * 0.1)
        poses.append(T)
        ts.append(float(i))
    path = str(tmp_path / "traj.txt")
    write_tum(path, ts, poses)
    t2, xyz = read_tum(path)
    np.testing.assert_allclose(t2, ts)
    np.testing.assert_allclose(xyz, [T[:3, 3] for T in poses], atol=1e-5)


def test_umeyama_recovers_transform(rng):
    pts = rng.standard_normal((50, 3))
    R = oracle.so3_exp(np.array([0.2, -0.1, 0.3]))
    t = np.array([1.0, -2.0, 0.5])
    moved = (R @ pts.T).T + t
    s, R2, t2 = align_umeyama(pts, moved)
    np.testing.assert_allclose(R2, R, atol=1e-6)
    np.testing.assert_allclose(t2, t, atol=1e-6)


def test_ate_zero_for_identical(rng):
    ts = np.arange(10.0)
    xyz = rng.standard_normal((10, 3))
    assert ate_rmse(ts, xyz, ts, xyz) < 1e-8


def test_ate_known_error(rng):
    ts = np.arange(100.0)
    xyz = np.cumsum(rng.standard_normal((100, 3)) * 0.1, axis=0)
    noisy = xyz + rng.standard_normal((100, 3)) * 0.05
    err = ate_rmse(ts, noisy, ts, xyz)
    assert 0.02 < err < 0.15, err


def test_associate():
    a = np.array([0.0, 1.0, 2.0])
    b = np.array([0.01, 1.5, 1.99])
    pairs = associate(a, b, max_difference=0.02)
    assert pairs == [(0, 0), (2, 2)]


def test_info_sequence_mono(synth_mono_seq):
    seq = InfoSequence(os.path.join(synth_mono_seq, "info.txt"))
    assert len(seq) == 12  # frames the fixture generated
    assert [it.timestamp for it in seq] == [float(i) for i in range(12)]
    first = seq.items[0]
    assert first.gray_path.endswith("0000.png")
    assert first.depth_path is None
    assert os.path.isfile(first.gray_path)


def test_info_sequence_kinect_pairs(synth_kinect_seq):
    seq = InfoSequence(os.path.join(synth_kinect_seq, "info.txt"))
    assert len(seq) == 3  # frames the fixture generated
    item = seq.items[0]
    assert item.gray_path.endswith(os.path.join("rgb", "0000.png"))
    assert item.depth_path is not None
    assert item.depth_path.endswith(os.path.join("depth", "0000.png"))
    assert os.path.isfile(item.gray_path) and os.path.isfile(item.depth_path)


def test_undistort_map_identity_without_distortion():
    calib = Calibration(
        K=np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32),
        distortion=None,
        resolution=(64, 48),
    )
    m = build_undistort_map(calib)
    np.testing.assert_array_equal(m[..., 0], np.tile(np.arange(64), (48, 1)))


def test_remap_nearest_border(rng):
    img = rng.random((10, 12)).astype(np.float32)
    srcmap = np.stack(np.meshgrid(np.arange(12), np.arange(10)), axis=-1).astype(np.float32)
    srcmap[0, 0] = (-5, -5)  # out of bounds
    out, valid = remap_nearest(img, srcmap, border=-2.0)
    assert out[0, 0] == -2.0 and not valid[0, 0]
    np.testing.assert_array_equal(out[1:], img[1:])


def test_viz_shapes(rng):
    from dvo_tpu.utils import viz

    g = rng.random((10, 12)).astype(np.float32)
    mask = np.ones((10, 12), bool)
    mask[0, 0] = False
    img = viz.visualize_gray(g, mask)
    assert img.shape == (10, 12, 3) and img.dtype == np.uint8
    assert tuple(img[0, 0]) == (255, 0, 0)  # invalid -> red (draw.cpp:16)
    d = viz.visualize_depth(1.0 + g, 0.2 + 0.3 * g)
    s = viz.visualize_sigma(g)
    a = viz.visualize_age(np.arange(120).reshape(10, 12) % 8)
    merged = viz.merge([img, d, s, a])
    assert merged.shape[0] == 10 and merged.dtype == np.uint8


def test_plot_trajectory_and_gallery(tmp_path, rng):
    """Offline trajectory plot (glfw-drawer equivalent, main.cpp:49-54) and
    keyframe-ring gallery (SHOW_KEYFRAME, system.hpp:7,34-42)."""
    import jax.numpy as jnp

    from dvo_tpu.models.frame import build_frame_with_depth
    from dvo_tpu.models.history import KeyframeHistory, push
    from dvo_tpu.utils import viz

    n = 12
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 0.5, n)
    poses[:, 2, 3] = np.linspace(0, -0.2, n)
    out = tmp_path / "traj.png"
    viz.plot_trajectory(poses, str(out), gt=poses[:, :3, 3] + 0.01)
    assert out.exists() and out.stat().st_size > 1000

    h, w = 16, 24
    K = jnp.asarray([[30.0, 0, 12], [0, 30.0, 8], [0, 0, 1]], jnp.float32)
    hist = KeyframeHistory.create(4, h, w)
    for i in range(3):
        f = build_frame_with_depth(
            jnp.full((h, w), 0.5, jnp.float32), jnp.ones((h, w), bool),
            jnp.full((h, w), 1.0 + i, jnp.float32),
            jnp.full((h, w), 0.2, jnp.float32), K, 1, 0, i,
        )
        hist = push(hist, f)
    img = viz.keyframe_gallery(hist)
    assert img.ndim == 3 and img.dtype == np.uint8
    assert img.shape[0] >= 3 * h  # one row per live keyframe


def _make_euroc_dir(root, n=4, h=48, w=64):
    """Synthetic EuRoC ASL tree: mav0/cam0/data.csv + PNGs + groundtruth."""
    import os

    from PIL import Image

    cam = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam, "data"))
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir)
    rng_ = np.random.default_rng(3)
    base = (rng_.random((h, w)) * 255).astype(np.uint8)
    rows = ["#timestamp [ns],filename"]
    gt_rows = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], ..."]
    for i in range(n):
        t_ns = 1403636579763555584 + i * 50_000_000
        name = f"{t_ns}.png"
        Image.fromarray(np.roll(base, i, axis=1)).save(
            os.path.join(cam, "data", name)
        )
        rows.append(f"{t_ns},{name}")
        gt_rows.append(f"{t_ns},{0.01*i},{0.0},{0.0},1,0,0,0")
    with open(os.path.join(cam, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")


def test_euroc_sequence(tmp_path):
    from dvo_tpu.utils.datasets import EuRoCSequence, load_gray_normalized

    root = str(tmp_path / "MH_synth")
    _make_euroc_dir(root, n=4)
    seq = EuRoCSequence(root)
    assert len(seq) == 4
    items = list(seq)
    assert abs(items[1].timestamp - items[0].timestamp - 0.05) < 1e-6
    g = load_gray_normalized(items[0].gray_path)
    assert g.shape == (48, 64) and 0.0 <= g.min() and g.max() <= 1.0

    ts, xyz = EuRoCSequence.read_groundtruth(root)
    assert ts.shape == (4,) and xyz.shape == (4, 3)
    np.testing.assert_allclose(xyz[:, 0], 0.01 * np.arange(4), atol=1e-7)


def test_euroc_cli_end_to_end(tmp_path):
    """run.py --format euroc over the synthetic ASL tree emits a TUM
    trajectory (exercises the monocular pipeline + EuRoC calibration)."""
    import json

    from dvo_tpu.run import main
    from dvo_tpu.utils.trajectory import read_tum

    root = str(tmp_path / "MH_synth")
    _make_euroc_dir(root, n=3, h=48, w=64)
    out = str(tmp_path / "traj.txt")
    # The synthetic frames are 48x64 (not 752x480): skip undistortion, whose
    # precomputed map is resolution-bound.
    rc = main([
        "--data", root, "--format", "euroc", "--mode", "mono",
        "--no-undistort", "--out", out, "--platform", "cpu",
    ])
    assert rc == 0
    ts, xyz = read_tum(out)
    assert len(ts) == 3 and np.isfinite(xyz).all()
