"""Kinect dual-camera registration tests: map_depth_to_gray semantics
(reference Transform::mapDepthtoGray, transform.cpp:53-78) and the
registered-RGB-D sequence driver on a generated Kinect-rig sequence."""

import jax
import jax.numpy as jnp
import numpy as np

from dvo_tpu.ops.warp import map_depth_to_gray


def test_identity_registration(rng):
    """Same K, identity extrinsic, same resolution: mapped gray == gray on
    pixels with depth, sigma 0.1 there and 1.0 on holes."""
    h, w = 40, 56
    gray = jnp.asarray(rng.random((h, w), np.float32))
    depth = jnp.asarray(rng.uniform(0.5, 3.0, (h, w)).astype(np.float32))
    holes = rng.random((h, w)) < 0.2
    depth = depth * jnp.asarray(~holes)
    K = jnp.asarray([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]], jnp.float32)

    mapped, mask, sigma = map_depth_to_gray(
        depth, gray, jnp.ones((h, w), bool), K, K, jnp.eye(4)
    )
    m = np.asarray(mask)
    # Float rounding can push exact-border projections a ULP outside; the
    # interior must match the hole pattern exactly.
    interior = np.zeros((h, w), bool)
    interior[1:-1, 1:-1] = True
    assert (m == ~holes)[interior].all()
    np.testing.assert_allclose(np.asarray(mapped)[m], np.asarray(gray)[m], atol=1e-5)
    np.testing.assert_allclose(np.asarray(sigma), np.where(m, 0.1, 1.0))


def test_extrinsic_shift_registration():
    """A pure-x baseline samples the gray at u + fx*tx/z: verify against a
    linear ramp image where bilinear sampling is exact."""
    h, w = 32, 48
    xs = np.arange(w, dtype=np.float32)[None].repeat(h, 0)
    gray = jnp.asarray(xs / w)
    depth_val = 2.0
    depth = jnp.full((h, w), depth_val, jnp.float32)
    fx = 60.0
    K = jnp.asarray([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], jnp.float32)
    tx = 0.1
    invT = jnp.eye(4).at[0, 3].set(tx)

    mapped, mask, _ = map_depth_to_gray(depth, gray, jnp.ones((h, w), bool), K, K, invT)
    shift = fx * tx / depth_val  # pixels
    expected = np.clip(xs + shift, 0, w - 1) / w
    m = np.asarray(mask)
    interior = np.zeros((h, w), bool)
    interior[:, : w - int(np.ceil(shift)) - 1] = True
    np.testing.assert_allclose(
        np.asarray(mapped)[m & interior], expected[m & interior], atol=1e-5
    )


def test_different_resolutions(rng):
    """Depth camera at quarter resolution of the color camera (the Kinect's
    512x424 vs 1920x1080 situation, scaled down)."""
    hg, wg = 64, 96
    hd, wd = 16, 24
    gray = jnp.asarray(rng.random((hg, wg), np.float32))
    depth = jnp.asarray(rng.uniform(1.0, 2.0, (hd, wd)).astype(np.float32))
    Kg = jnp.asarray([[120.0, 0, wg / 2], [0, 120.0, hg / 2], [0, 0, 1]], jnp.float32)
    Kd = jnp.asarray([[30.0, 0, wd / 2], [0, 30.0, hd / 2], [0, 0, 1]], jnp.float32)

    mapped, mask, _ = map_depth_to_gray(
        depth, gray, jnp.ones((hg, wg), bool), Kg, Kd, jnp.eye(4)
    )
    assert mapped.shape == (hd, wd)
    # Same optical axis, fx scaled with resolution: depth pixel (x, y) maps
    # to gray pixel (4x, 4y) up to the half-pixel center offset.
    m = np.asarray(mask)
    assert m.mean() > 0.9
    ys, xs = np.mgrid[0:hd, 0:wd]
    u = (xs - wd / 2) * 4 + wg / 2
    v = (ys - hd / 2) * 4 + hg / 2
    ui = np.clip(u.astype(int), 0, wg - 1)
    vi = np.clip(v.astype(int), 0, hg - 1)
    np.testing.assert_allclose(
        np.asarray(mapped)[m], np.asarray(gray)[vi, ui][m], atol=1e-4
    )


def test_kinect_driver_real_data(synth_kinect_seq):
    """3 frames of a generated Kinect v2 rig sequence (1920x1080 colour,
    512x424 depth, ~5 mm/frame) through the full registered pipeline
    (mono mode seeded with measured depth)."""
    import os

    from dvo_tpu.utils.datasets import InfoSequence, KinectCalibration
    from dvo_tpu.utils.runner import run_kinect

    seq = InfoSequence(os.path.join(synth_kinect_seq, "info.txt"))
    ts, poses, secs = run_kinect(
        seq, KinectCalibration.kinect_v2(), mode="mono", max_frames=3,
        undistort=False,
    )
    assert poses.shape == (3, 4, 4)
    assert np.all(np.isfinite(poses))
    # Consecutive free-motion Kinect frames: small but generally nonzero motion.
    t_step = np.linalg.norm(poses[2][:3, 3] - poses[1][:3, 3])
    assert t_step < 0.5, t_step
