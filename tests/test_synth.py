"""The seeded sequence generator (utils/synth.py) and the numpy + zlib PNG
codec it writes with (utils/png.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from dvo_tpu.utils import png, synth

SMALL = dict(size=(160, 120), K=synth.LOGICOOL_K / [[4], [4], [1]])


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_generator_deterministic(tmp_path):
    a = _files(synth.write_info_sequence(str(tmp_path / "a"), 3, seed=5, **SMALL))
    b = _files(synth.write_info_sequence(str(tmp_path / "b"), 3, seed=5, **SMALL))
    c = _files(synth.write_info_sequence(str(tmp_path / "c"), 3, seed=6, **SMALL))
    assert sorted(a) == ["0000.png", "0001.png", "0002.png", "calib.yaml",
                         "groundtruth.txt", "info.txt"]
    assert a == b
    assert a["0000.png"] != c["0000.png"]
    assert a["groundtruth.txt"] == c["groundtruth.txt"]   # motion is seed-free


def _sample(kind, rng):
    if kind == "gray8":
        return rng.integers(0, 256, (37, 53), dtype=np.uint8)
    if kind == "gray16":
        return rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    return rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_roundtrip_numpy(kind, rng, tmp_path):
    img = _sample(kind, rng)
    p = str(tmp_path / "x.png")
    png.write_png(p, img)
    out = png.read_png(p)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)
    assert png.png_size(p) == img.shape[:2]


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_roundtrip_native(kind, rng, tmp_path):
    from dvo_tpu import native

    try:
        native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable here: {e}")
    img = _sample(kind, rng)
    p = str(tmp_path / "x.png")
    png.write_png(p, img)
    np.testing.assert_array_equal(native.decode_png_f32(p, 1.0), png.decode_gray(p))
    assert native.png_info(p)[:2] == (img.shape[1], img.shape[0])


def test_png_reads_adaptive_filters_and_palette(rng, tmp_path):
    """Files from another encoder: PIL's adaptive row filters (all five
    types occur on noise) and a palette image."""
    from PIL import Image

    smooth = (np.add.outer(np.arange(40), np.arange(50)) % 256).astype(np.uint8)
    cases = {
        "noise": rng.integers(0, 256, (40, 50, 3), dtype=np.uint8),
        "smooth": smooth,
        "rgba": rng.integers(0, 256, (40, 50, 4), dtype=np.uint8),
    }
    for name, arr in cases.items():
        p = str(tmp_path / f"{name}.png")
        Image.fromarray(arr).save(p, optimize=True)
        np.testing.assert_array_equal(png.read_png(p), np.asarray(Image.open(p)))
    p = str(tmp_path / "pal.png")
    pal = Image.fromarray(cases["noise"]).convert("P")
    pal.save(p)
    np.testing.assert_array_equal(png.read_png(p), np.asarray(pal.convert("RGB")))


def test_ground_truth_is_tracked_pose():
    """The ground truth is in the drivers' own pose convention: RGB-D
    tracking of frame 3 against frame 0 recovers it."""
    from dvo_tpu.config import TrackerConfig
    from dvo_tpu.models.frame import build_frame_with_depth
    from dvo_tpu.models.tracker import track
    from dvo_tpu.utils import oracle

    planes = synth.make_scene(0)
    path = synth.camera_path(4)
    K = synth.TUM_K / [[2], [2], [1]]
    frames = []
    for k in (0, 3):
        gray, depth = synth.render(planes, K, (320, 240), path[k])
        frames.append(build_frame_with_depth(
            jnp.asarray(gray), jnp.asarray(depth > 0), jnp.asarray(depth),
            jnp.full(depth.shape, 0.1, jnp.float32), jnp.asarray(K, jnp.float32),
            4, 0, k,
        ))
    xi = np.asarray(track(frames[1], frames[0], TrackerConfig(min_residual=0.0)).xi)
    want = oracle.se3_log(synth.ground_truth(path)[3])
    assert np.linalg.norm(want[:3]) > 0.01          # ~15 mm of motion
    # GN stops at a 5e-4 update norm; the opposite convention (-want)
    # would miss by ~2e-2.
    np.testing.assert_allclose(xi, want, atol=2e-3)


def test_tum_layout_reads_back(tmp_path):
    from dvo_tpu.utils.datasets import Calibration, TUMSequence
    from dvo_tpu.utils.trajectory import read_tum

    root = synth.write_tum_sequence(
        str(tmp_path / "tum"), 4, size=(160, 120), K=synth.TUM_K / [[4], [4], [1]]
    )
    seq = TUMSequence(root)
    assert len(seq) == 4 and all(it.depth_path for it in seq)
    gt_t, gt_xyz = read_tum(os.path.join(root, "groundtruth.txt"))
    np.testing.assert_allclose(gt_t, [it.timestamp for it in seq])
    assert np.all(gt_xyz[0] == 0)
    calib = Calibration.from_yaml(os.path.join(root, "calib.yaml"))
    assert calib.distortion is None and calib.resolution == (160, 120)
    np.testing.assert_allclose(calib.K, synth.TUM_K / [[4], [4], [1]], rtol=1e-6)
