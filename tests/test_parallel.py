"""Sharded-execution tests on the virtual 8-device CPU mesh: the tile-
sharded GN must reproduce the single-device numbers exactly (same math,
psum-reduced), across mesh shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvo_tpu.config import TrackerConfig
from dvo_tpu.models.frame import build_frame_with_depth
from dvo_tpu.models.tracker import gn_normal_equations, track
from dvo_tpu.parallel.mesh import make_mesh, vo_mesh
from dvo_tpu.parallel.tracking import sharded_gn_normal_equations, sharded_track

from test_tracker import make_pair


def _frames(rng, h, w, levels=2):
    ref_img, depth, sigma, K, obj_img, obj_mask, xi_true = make_pair(rng, h, w)
    mk = lambda img, m, fid: build_frame_with_depth(
        jnp.asarray(img), jnp.asarray(m), jnp.asarray(depth),
        jnp.asarray(sigma), jnp.asarray(K), levels=levels, culls=0, frame_id=fid,
    )
    return mk(obj_img, obj_mask, 1), mk(ref_img, np.ones_like(obj_mask), 0), xi_true


def test_devices_available():
    assert len(jax.devices()) >= 8, jax.devices()


@pytest.mark.parametrize("tiles", [2, 4, 8])
@pytest.mark.slow
def test_sharded_gn_matches_single_device(rng, tiles):
    obj, ref, _ = _frames(rng, 64, 96, levels=1)
    mesh = make_mesh((tiles,), ("tile",))
    cfg = TrackerConfig()
    xi = jnp.asarray([0.01, -0.005, 0.002, 0.001, 0.0, -0.001], jnp.float32)
    H1, g1, r1, c1 = gn_normal_equations(obj.scenes[0], ref.scenes[0], xi, 0, cfg)
    H2, g2, r2, c2 = sharded_gn_normal_equations(
        obj.scenes[0], ref.scenes[0], xi, 0, cfg, mesh
    )
    assert int(c1) == int(c2)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H2), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(r1), float(r2), rtol=1e-5)


def test_sharded_track_matches_single_device(rng):
    obj, ref, xi_true = _frames(rng, 64, 96, levels=2)
    mesh = make_mesh((4,), ("tile",))
    cfg = TrackerConfig(min_residual=0.0)
    xi_single = np.asarray(track(obj, ref, cfg).xi)
    xi_shard = np.asarray(
        jax.jit(
            lambda o, r: sharded_track(o, r, cfg, mesh)
        )(obj, ref)
    )
    np.testing.assert_allclose(xi_shard, xi_single, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(xi_shard, xi_true, atol=1e-3)


def test_vo_mesh_shapes():
    m = vo_mesh(8)
    assert m.shape["kf"] * m.shape["tile"] == 8
    m1 = vo_mesh(1)
    assert m1.shape["kf"] * m1.shape["tile"] == 1


@pytest.mark.slow
def test_sharded_depth_update_matches_single_device(rng):
    from dvo_tpu.config import MapperConfig
    from dvo_tpu.models.history import KeyframeHistory, push
    from dvo_tpu.models.mapper import depth_update
    from dvo_tpu.parallel.mapping import sharded_depth_update
    from test_mapper import _single_kf_setup, smooth_image

    h, w = 64, 80
    ref_img, true_depth, K, xi, obj_img, obj_mask, mk = _single_kf_setup(rng, h, w)
    ref_frame = mk(ref_img, np.ones((h, w), bool), true_depth,
                   np.full((h, w), 0.5, np.float32), 0)
    history = push(KeyframeHistory.create(4, h, w), ref_frame)
    prior = (1.6 + 0.2 * smooth_image(rng, h, w)).astype(np.float32)
    sigma0 = np.full((h, w), 0.4, np.float32)
    obj_frame = mk(obj_img, obj_mask, true_depth, sigma0, 1)
    cfg = MapperConfig(crop_x=(6, 74), crop_y=(6, 58),
                       luminance_sigma=0.25, epipolar_sigma=0.25)
    key = jax.random.PRNGKey(3)
    age0 = jnp.zeros((h, w), jnp.int32)

    d1, s1, a1, st1 = depth_update(
        obj_frame.scenes[0], jnp.asarray(xi), jnp.asarray(xi),
        jnp.asarray(prior), jnp.asarray(sigma0), age0, history, key, cfg)
    mesh = make_mesh((4,), ("tile",))
    d2, s2, a2, st2 = sharded_depth_update(
        obj_frame.scenes[0], jnp.asarray(xi), jnp.asarray(xi),
        jnp.asarray(prior), jnp.asarray(sigma0), age0, history, key, cfg, mesh)

    assert int(st1.observed) == int(st2.observed)
    assert int(st1.rejected) == int(st2.rejected)
    # Reset pixels draw tile-local noise; compare everywhere else.
    same = np.asarray(a1) == np.asarray(a2)  # ages only differ via resets
    changed_equal = np.isclose(np.asarray(d1), np.asarray(d2), atol=1e-5)
    frac = (changed_equal | ~same).mean()
    rej = int(st1.rejected)
    assert changed_equal.sum() >= d1.size - rej, (int(changed_equal.sum()), d1.size, rej)


def test_stream_sharded_matches_batched(rng):
    """Multi-stream mesh driver (parallel/streams.py): streams sharded
    over a 4-device 'stream' mesh must reproduce each stream's OWN
    single-device ``monocular_run`` trajectory (the width-1 local vmap
    compiles to effectively the same program, measured agreement ~1e-4)
    and must not mix streams up (cross-stream trajectories differ
    materially by construction: distinct content and velocity)."""
    import dataclasses as dc

    from test_image_ops import smooth_image

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.odometry import (
        monocular_init_with_depth,
        monocular_run,
    )
    from dvo_tpu.parallel.streams import monocular_run_streams, stream_mesh

    from dvo_tpu.ops.warp import warp_image

    b, n, h, w = 4, 3, 48, 64
    K = jnp.asarray(
        np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]],
                 np.float32)
    )
    # Every stream sees the SAME well-posed pixel-level motion (~1.3
    # px/frame — equally stable tracking), but at a per-stream depth
    # scale, so the recovered metric translations differ by (1 + s): the
    # trajectories are materially distinct (routing errors are loud)
    # without pushing any stream toward the basin edge, where a diverging
    # fixture run would dominate the comparison.
    img = smooth_image(rng, h, w)
    base = np.stack([img] * b)
    scale = [1.2 ** s for s in range(b)]
    depth_s = [jnp.full((h, w), 1.8 * scale[s], jnp.float32) for s in range(b)]
    xis = [
        np.asarray([0.008 * scale[s], 0.004 * scale[s], 0, 0, 0, 0], np.float32)
        for s in range(b)
    ]
    seq = np.stack([
        np.stack([
            np.asarray(warp_image(
                jnp.asarray(xis[s] * (k + 1)), jnp.asarray(base[s]),
                jnp.ones((h, w), bool), depth_s[s], K,
            )[0])
            for k in range(n)
        ])
        for s in range(b)
    ]).astype(np.float32)                      # (B, N, H, W)
    masks = jnp.ones((b, n, h, w), bool)
    cfg = DVOConfig.monocular()
    # Deterministic data path for a crisp cross-compilation comparison:
    # fixed-length masked-scan GN (no iteration-count flips) and promote-
    # every-frame mapping (the z-buffer propagate is deterministic; the
    # epipolar update's accept/reject thresholds and PRNG resets amplify
    # reduction-order noise chaotically).
    cfg = dc.replace(
        cfg,
        tracker=dc.replace(cfg.tracker, early_exit=False),
        mapper=dc.replace(cfg.mapper, max_forward=1, min_movement=0.0),
    )
    sigma0 = jnp.full((h, w), 0.1, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)

    # Ground truth: each stream run alone on one device.
    singles = []
    for s in range(b):
        st = monocular_init_with_depth(
            jnp.asarray(base[s]), masks[s, 0], depth_s[s], sigma0, K,
            keys[s], cfg
        )
        _, res = monocular_run(st, jnp.asarray(seq[s]), masks[s, 0], K, cfg)
        singles.append(np.asarray(res.T_world))

    states = jax.vmap(
        lambda g, m, d, k: monocular_init_with_depth(
            g, m, d, sigma0, K, k, cfg
        )
    )(jnp.asarray(base), masks[:, 0], jnp.stack(depth_s), keys)
    mesh = stream_mesh(4)
    _, res_sh = monocular_run_streams(mesh, states, jnp.asarray(seq), masks, K, cfg)
    sh = np.asarray(res_sh.T_world)

    for s in range(b):
        same = np.abs(sh[s] - singles[s]).max()
        assert same < 1e-3, (s, same)
        cross = min(
            np.abs(sh[s] - singles[t]).max() for t in range(b) if t != s
        )
        assert cross > 10 * max(same, 1e-4), (s, same, cross)


def test_rgbd_stream_sharded_matches_single(rng):
    """RGB-D twin of the stream-sharded routing test: 4 frame-to-frame
    tracking pipelines over a 4-device 'stream' mesh, each matching its
    own single-device run (no mapper, no PRNG — deterministic enough for
    a tight bound)."""
    import dataclasses as dc

    from test_image_ops import smooth_image

    from dvo_tpu.config import DVOConfig
    from dvo_tpu.models.odometry import rgbd_init, rgbd_run
    from dvo_tpu.ops.warp import warp_image
    from dvo_tpu.parallel.streams import rgbd_run_streams, stream_mesh

    b, n, h, w = 4, 3, 48, 64
    K = jnp.asarray(
        np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]],
                 np.float32)
    )
    img = smooth_image(rng, h, w)
    base = np.stack([img] * b)
    scale = [1.2 ** s for s in range(b)]
    depth_s = [np.full((h, w), 1.8 * scale[s], np.float32) for s in range(b)]
    xis = [
        np.asarray([0.008 * scale[s], 0.004 * scale[s], 0, 0, 0, 0], np.float32)
        for s in range(b)
    ]
    seq = np.stack([
        np.stack([
            np.asarray(warp_image(
                jnp.asarray(xis[s] * (k + 1)), jnp.asarray(base[s]),
                jnp.ones((h, w), bool), jnp.asarray(depth_s[s]), K,
            )[0])
            for k in range(n)
        ])
        for s in range(b)
    ]).astype(np.float32)
    masks = jnp.ones((b, n, h, w), bool)
    sig = np.full((h, w), 0.1, np.float32)
    cfg = DVOConfig.rgbd()
    cfg = dc.replace(cfg, pyramid=dc.replace(cfg.pyramid, levels=2, culls=0),
                     tracker=dc.replace(cfg.tracker, early_exit=False))

    singles = []
    states = []
    for s in range(b):
        st = rgbd_init(jnp.asarray(base[s]), masks[s, 0],
                       jnp.asarray(depth_s[s]), jnp.asarray(sig), K, cfg)
        states.append(st)
        _, res = rgbd_run(
            st, jnp.asarray(seq[s]), masks[s, 0],
            jnp.asarray(np.stack([depth_s[s]] * n)),
            jnp.asarray(np.stack([sig] * n)), K, cfg,
        )
        singles.append(np.asarray(res.T_world))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    mesh = stream_mesh(4)
    _, res_sh = rgbd_run_streams(
        mesh, stacked, jnp.asarray(seq), masks,
        jnp.asarray(np.stack([np.stack([depth_s[s]] * n) for s in range(b)])),
        jnp.asarray(np.stack([np.stack([sig] * n)] * b)), K, cfg,
    )
    sh = np.asarray(res_sh.T_world)
    for s in range(b):
        same = np.abs(sh[s] - singles[s]).max()
        assert same < 1e-4, (s, same)
        cross = min(
            np.abs(sh[s] - singles[t]).max() for t in range(b) if t != s
        )
        assert cross > 10 * max(same, 1e-4), (s, same, cross)
