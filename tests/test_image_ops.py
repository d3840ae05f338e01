"""Pyramid / gradients / sampling / warp vs the NumPy oracle."""

import jax.numpy as jnp
import numpy as np

from dvo_tpu.ops.image import cull_image, cull_intrinsic, gradients
from dvo_tpu.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu.ops.warp import warp_image
from dvo_tpu.utils import oracle


def smooth_image(rng, h=24, w=32):
    """Band-limited random image in [0, 1]."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(6):
        fx, fy = rng.uniform(0.02, 0.2, 2)
        ph = rng.uniform(0, 6.28, 2)
        img += rng.uniform(0.2, 1.0) * np.sin(fx * xs + ph[0]) * np.sin(fy * ys + ph[1])
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def test_cull_matches_oracle(rng):
    img = smooth_image(rng, 32, 48)
    for t in (0, 1, 2):
        ours = np.asarray(cull_image(jnp.asarray(img), t))
        ref = oracle.cull_image(img, t)
        np.testing.assert_array_equal(ours, ref)


def test_cull_intrinsic_matches_oracle():
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    for t in (0, 1, 3):
        ours = np.asarray(cull_intrinsic(jnp.asarray(K), t))
        np.testing.assert_allclose(ours, oracle.cull_intrinsic(K, t), rtol=1e-6)


def test_gradients_match_oracle(rng):
    img = smooth_image(rng)
    mask = np.ones_like(img, bool)
    mask[5:8, 10:14] = False  # invalid patch
    gx, gy, mx, my = gradients(jnp.asarray(img), jnp.asarray(mask))
    # Oracle carries INVALID inside the image itself.
    img_inv = img.copy()
    img_inv[~mask] = oracle.INVALID
    ref_gx = oracle.gradiate(img_inv, True)
    ref_gy = oracle.gradiate(img_inv, False)
    gx, gy, mx, my = map(np.asarray, (gx, gy, mx, my))
    np.testing.assert_array_equal(mx, ref_gx > oracle.INVALID)
    np.testing.assert_array_equal(my, ref_gy > oracle.INVALID)
    np.testing.assert_allclose(gx[mx], ref_gx[mx], atol=1e-6)
    np.testing.assert_allclose(gy[my], ref_gy[my], atol=1e-6)


def test_bilinear_dense_matches_oracle(rng):
    img = smooth_image(rng)
    h, w = img.shape
    pts = rng.uniform(-2, max(h, w) + 2, (200, 2)).astype(np.float32)
    vals, valid = bilinear_dense(jnp.asarray(img), jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    vals, valid = np.asarray(vals), np.asarray(valid)
    for i, (x, y) in enumerate(pts):
        ref = oracle.get_subpixel_from_dense(img, x, y)
        if ref <= oracle.INVALID:
            assert not valid[i]
        else:
            assert valid[i]
            np.testing.assert_allclose(vals[i], ref, atol=1e-5)


def test_bilinear_masked_matches_oracle(rng):
    img = smooth_image(rng)
    mask = np.ones_like(img, bool)
    mask[3:9, 4:12] = False
    img_inv = img.copy()
    img_inv[~mask] = oracle.INVALID
    h, w = img.shape
    pts = rng.uniform(0, max(h, w), (300, 2)).astype(np.float32)
    vals, valid = bilinear_masked(
        jnp.asarray(img), jnp.asarray(mask), jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1])
    )
    vals, valid = np.asarray(vals), np.asarray(valid)
    for i, (x, y) in enumerate(pts):
        ref = oracle.get_subpixel(img_inv, x, y)
        if ref <= oracle.INVALID:
            assert not valid[i], (x, y)
        else:
            assert valid[i], (x, y)
            np.testing.assert_allclose(vals[i], ref, atol=1e-5)


def test_warp_image_matches_oracle(rng):
    img = smooth_image(rng)
    h, w = img.shape
    depth = np.full((h, w), 1.5, np.float32) + 0.1 * smooth_image(rng, h, w)
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float32)
    xi = np.array([0.02, -0.01, 0.03, 0.004, -0.003, 0.002], np.float32)
    ours, mask = warp_image(
        jnp.asarray(xi), jnp.asarray(img), jnp.ones((h, w), bool), jnp.asarray(depth), jnp.asarray(K)
    )
    ours, mask = np.asarray(ours), np.asarray(mask)
    ref = oracle.warp_image(xi.astype(np.float64), img, depth, K.astype(np.float64))
    ref_valid = ref > oracle.INVALID
    # Float32-vs-float64 warps can disagree on borderline in-range decisions
    # for a handful of border pixels; demand agreement on >99% of pixels.
    agree = mask == ref_valid
    assert agree.mean() > 0.99
    both = mask & ref_valid & agree
    np.testing.assert_allclose(ours[both], ref[both], atol=1e-3)
