"""Native C++ data plane tests (build + parity vs the numpy path), on
sequences from the seeded generator (utils/synth.py)."""

import os

import numpy as np
import pytest

from dvo_tpu import native
from dvo_tpu.utils import png


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable here: {e}")


def test_decode_gray_matches_reference_luma(lib, synth_mono_seq, tmp_path):
    # Colour input: the generated gray frame as R, G and B planes of
    # different brightness, so the luma weights matter.
    g = png.read_png(os.path.join(synth_mono_seq, "0000.png"))
    rgb = np.stack([g, g // 2, 255 - g], axis=-1)
    p = str(tmp_path / "rgb.png")
    png.write_png(p, rgb)
    img = native.decode_png_f32(p, 1 / 255.0)
    np.testing.assert_allclose(img, png.decode_gray(p) / 255.0, atol=1e-6)
    from PIL import Image

    ref = np.asarray(Image.open(p).convert("L"), np.float32) / 255.0
    assert img.shape == ref.shape
    # PIL rounds the ITU-R 601 luma to integers first; the native path keeps
    # float like cv::cvtColor — differences stay below one gray level.
    assert np.abs(img - ref).max() < 2.5 / 255.0


def test_decode_depth16_exact(lib, tmp_path):
    from dvo_tpu.utils import synth

    root = synth.write_tum_sequence(str(tmp_path / "tum"), 2, size=(160, 120),
                                    K=synth.TUM_K / [[4], [4], [1]])
    p = os.path.join(root, "depth", "0.033333.png")
    d = native.decode_png_f32(p, 1 / 5000.0)
    counts = png.read_png(p)
    assert counts.dtype == np.uint16 and counts.min() > 0
    np.testing.assert_allclose(d, counts.astype(np.float32) / 5000.0, atol=1e-6)


def test_remap_matches_python(lib, rng):
    from dvo_tpu.utils.datasets import (
        Calibration,
        build_undistort_map,
        remap_nearest as py_remap,
    )

    calib = Calibration.logicool()
    srcmap = build_undistort_map(calib)
    img = rng.random((480, 640)).astype(np.float32)
    out_n, valid_n = native.remap_nearest(img, srcmap, border=-2.0)
    out_p, valid_p = py_remap(img, srcmap, border=-2.0)
    np.testing.assert_array_equal(valid_n, valid_p)
    np.testing.assert_allclose(out_n, out_p, atol=0)


def test_prefetch_ordered_and_complete(lib, synth_mono_seq):
    paths = [os.path.join(synth_mono_seq, f"{i:04d}.png") for i in range(12)]
    pl = native.PrefetchLoader(paths, 1 / 255.0, threads=2)
    seen = []
    for idx, img, valid in pl:
        seen.append(idx)
        np.testing.assert_array_equal(img, png.decode_gray(paths[idx]) * np.float32(1 / 255.0))
    pl.close()
    assert seen == list(range(12))


def test_prefetch_with_remap(lib, synth_mono_seq):
    from dvo_tpu.utils.datasets import Calibration, build_undistort_map

    calib = Calibration.logicool()
    srcmap = build_undistort_map(calib)
    paths = [os.path.join(synth_mono_seq, f"{i:04d}.png") for i in range(3)]
    pl = native.PrefetchLoader(paths, 1 / 255.0, map_xy=srcmap, border=-2.0, threads=2)
    idx, img, valid = next(pl)
    pl.close()
    assert img.shape == (480, 640)
    assert valid.mean() > 0.8  # undistortion border only
