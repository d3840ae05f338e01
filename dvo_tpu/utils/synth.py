"""Seeded synthetic sequences with exact ground truth.

Renders a static, textured, depth-varying scene (a back wall, a floor and
two tilted boards in front) by ray casting, under a known constant camera
motion, and writes it in the layouts the CLI reads:

* ``write_info_sequence`` — a monocular ``info.txt`` sequence of 8-bit gray
  PNGs (reference loader.hpp:38-47) with a calibration YAML beside it;
* ``write_tum_sequence`` — a TUM RGB-D layout: ``rgb/``, ``depth/`` (16-bit,
  1/5000 m), ``rgb.txt``, ``depth.txt``;
* ``write_kinect_sequence`` — an ``info.txt`` of "rgb depth" pairs for the
  Kinect v2 rig (1920x1080 colour, 512x424 depth).

Each writes ``groundtruth.txt`` in the TUM line format, holding the poses
in this framework's own convention: ``T_world`` of frame k maps frame-0
camera coordinates to frame-k camera coordinates (world -> camera), as the
trajectories the drivers emit do.  PNGs are written with numpy and zlib
only (``utils/png.py``).  The same ``seed`` always gives the same bytes.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from dvo_tpu.utils import oracle
from dvo_tpu.utils.png import write_png
from dvo_tpu.utils.trajectory import write_tum

# Camera motion per frame, a body-frame twist [v; w]: about 5 mm of
# translation and 0.2 degrees of rotation, mostly a yaw.
_AXIS = np.array([0.2, 1.0, 0.1]) / np.linalg.norm([0.2, 1.0, 0.1])
DEFAULT_STEP = np.concatenate(
    [[0.004, -0.001, 0.003], np.deg2rad(0.2) * _AXIS]
)

# Logicool webcam intrinsics (reference loader.cpp:17-18), no distortion.
LOGICOOL_K = np.array([[780.0, 0, 378], [0, 796.0, 220], [0, 0, 1]])
# TUM fr1 published intrinsics, no distortion.
TUM_K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])
DEPTH_SCALE = 5000.0   # TUM 16-bit depth counts per metre

# Value-noise octaves: lattice period [m] and amplitude.
_OCTAVES = ((0.2, 1.0), (0.08, 0.7), (0.03, 0.5), (0.012, 0.35))


@dataclasses.dataclass(frozen=True)
class _Plane:
    origin: np.ndarray    # (3,) centre
    e1: np.ndarray        # (3,) unit in-plane axes
    e2: np.ndarray
    half: Tuple[float, float]   # half extents along e1, e2 [m]
    lattices: Tuple[np.ndarray, ...]   # one value-noise lattice per octave

    @property
    def normal(self) -> np.ndarray:
        return np.cross(self.e1, self.e2)


def _rot(axis, deg):
    return oracle.so3_exp(np.deg2rad(deg) * np.asarray(axis, np.float64))


def make_scene(seed: int = 0) -> List[_Plane]:
    """The planes of the scene, each with its own seeded texture."""
    rng = np.random.default_rng(seed)
    x, y = np.eye(3)[0], np.eye(3)[1]
    layout = [
        # back wall, floor, and two boards (centre, axes, half extents)
        (np.array([0.0, 0.0, 2.0]), x, y, (5.0, 4.0)),
        (np.array([0.0, 0.6, 1.5]), x, np.array([0.0, 0.0, 1.0]), (5.0, 1.5)),
        (np.array([-0.35, 0.05, 0.9]), _rot(y, 30) @ x, y, (0.3, 0.25)),
        (np.array([0.4, -0.2, 1.3]), x, _rot(x, -20) @ y, (0.4, 0.3)),
    ]
    planes = []
    for origin, e1, e2, half in layout:
        lattices = tuple(
            rng.random((int(2 * half[1] / p) + 3, int(2 * half[0] / p) + 3))
            for p, _ in _OCTAVES
        )
        planes.append(_Plane(origin, e1, e2, half, lattices))
    return planes


def _texture(plane: _Plane, u, v):
    """Value noise at plane coordinates (u, v) [m] through a steep fixed
    tone curve: blobs with sharp edges, which the semi-dense depth filter
    needs, and the same brightness from every viewpoint."""
    total = np.zeros_like(u)
    for (period, amp), lat in zip(_OCTAVES, plane.lattices):
        gx = (u + plane.half[0]) / period
        gy = (v + plane.half[1]) / period
        x0 = np.clip(np.floor(gx).astype(np.int64), 0, lat.shape[1] - 2)
        y0 = np.clip(np.floor(gy).astype(np.int64), 0, lat.shape[0] - 2)
        fx, fy = gx - x0, gy - y0
        top = lat[y0, x0] * (1 - fx) + lat[y0, x0 + 1] * fx
        bot = lat[y0 + 1, x0] * (1 - fx) + lat[y0 + 1, x0 + 1] * fx
        total += amp * (top * (1 - fy) + bot * fy)
    total /= sum(a for _, a in _OCTAVES)
    return 0.5 + 0.45 * np.tanh(8.0 * (total - 0.5))


def render(planes, K, size, T_wc) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the scene from the camera with pose ``T_wc`` (camera ->
    world).  ``size`` is (width, height).  Returns (gray float32 in [0, 1],
    depth float32 [m], 0 where no surface is hit)."""
    w, h = size
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d_cam = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], -1
    )
    R, c = T_wc[:3, :3], T_wc[:3, 3]
    d_world = d_cam @ R.T
    depth = np.full((h, w), np.inf)
    gray = np.zeros((h, w))
    for pl in planes:
        n = pl.normal
        denom = d_world @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(denom) > 1e-9, ((pl.origin - c) @ n) / denom, 1e9)
        hit = c + t[..., None] * d_world - pl.origin
        u, v = hit @ pl.e1, hit @ pl.e2
        # The ray parameter t IS the camera-frame depth (d_cam has z = 1).
        ok = (t > 1e-3) & (np.abs(u) <= pl.half[0]) & (np.abs(v) <= pl.half[1])
        ok &= t < depth
        depth = np.where(ok, t, depth)
        if ok.any():
            gray[ok] = _texture(pl, u[ok], v[ok])
    depth = np.where(np.isfinite(depth), depth, 0.0)
    return gray.astype(np.float32), depth.astype(np.float32)


def camera_path(n: int, step=DEFAULT_STEP) -> np.ndarray:
    """(n, 4, 4) camera -> world poses under a constant body-frame twist;
    frame 0 is the world frame."""
    T = np.eye(4)
    step_T = oracle.se3_exp(np.asarray(step, np.float64))
    poses = []
    for _ in range(n):
        poses.append(T.copy())
        T = T @ step_T
    return np.stack(poses)


def ground_truth(poses_wc: np.ndarray) -> np.ndarray:
    """Camera -> world poses to this framework's ``T_world`` convention
    (world -> camera, frame 0 the identity)."""
    return np.stack([np.linalg.inv(T) @ poses_wc[0] for T in poses_wc])


def _write_calib(path, K, size):
    with open(path, "w") as f:
        f.write(
            "monocular:\n"
            f"  K: [{K[0, 0]}, 0, {K[0, 2]}, 0, {K[1, 1]}, {K[1, 2]}, 0, 0, 1]\n"
            f"  resolution: [{size[0]}, {size[1]}]\n"
        )


def _for_each_frame(fn, n):
    """Run ``fn(k)`` for k < n on a few threads (numpy and zlib release the
    interpreter lock); exceptions propagate."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, range(n)))


def _u8(gray):
    return np.rint(gray * 255.0).astype(np.uint8)


def _u16(depth):
    return np.clip(np.rint(depth * DEPTH_SCALE), 0, 65535).astype(np.uint16)


def write_info_sequence(root: str, n: int, seed: int = 0, step=DEFAULT_STEP,
                        K=LOGICOOL_K, size=(640, 480)) -> str:
    """Monocular ``info.txt`` sequence with ``calib.yaml`` and
    ``groundtruth.txt`` (timestamps = line index, as ``InfoSequence``
    assigns them).  Returns ``root``."""
    os.makedirs(root, exist_ok=True)
    planes = make_scene(seed)
    poses = camera_path(n, step)
    names = [f"{k:04d}.png" for k in range(n)]

    def frame(k):
        gray, _ = render(planes, K, size, poses[k])
        write_png(os.path.join(root, names[k]), _u8(gray))

    _for_each_frame(frame, n)
    with open(os.path.join(root, "info.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    _write_calib(os.path.join(root, "calib.yaml"), K, size)
    write_tum(os.path.join(root, "groundtruth.txt"), np.arange(float(n)),
              ground_truth(poses))
    return root


def write_tum_sequence(root: str, n: int, seed: int = 0, step=DEFAULT_STEP,
                       K=TUM_K, size=(640, 480), rate_hz: float = 30.0) -> str:
    """TUM RGB-D layout at ``rate_hz`` with ``calib.yaml``.  Returns
    ``root``."""
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    planes = make_scene(seed)
    poses = camera_path(n, step)
    ts = np.arange(n) / rate_hz
    rgb_lines = [f"{t:.6f} rgb/{t:.6f}.png" for t in ts]
    depth_lines = [f"{t:.6f} depth/{t:.6f}.png" for t in ts]

    def frame(k):
        gray, depth = render(planes, K, size, poses[k])
        write_png(os.path.join(root, rgb_lines[k].split()[1]), _u8(gray))
        write_png(os.path.join(root, depth_lines[k].split()[1]), _u16(depth))

    _for_each_frame(frame, n)
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines)):
        with open(os.path.join(root, name), "w") as f:
            f.write("# timestamp filename\n" + "\n".join(lines) + "\n")
    _write_calib(os.path.join(root, "calib.yaml"), K, size)
    write_tum(os.path.join(root, "groundtruth.txt"), ts, ground_truth(poses))
    return root


def write_kinect_sequence(root: str, n: int, kcalib, seed: int = 0,
                          step=DEFAULT_STEP) -> str:
    """Kinect-rig ``info.txt`` of "rgb depth" pairs rendered through
    ``kcalib`` (``datasets.KinectCalibration``): 8-bit colour-camera gray at
    the colour resolution and 16-bit depth at the depth resolution, the
    colour camera offset by the rig extrinsic.  Returns ``root``."""
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    planes = make_scene(seed)
    poses = camera_path(n, step)
    # invT maps depth-camera to colour-camera coordinates (transform.cpp:70).
    depth_from_color = np.linalg.inv(np.asarray(kcalib.invT, np.float64))
    lines = [f"rgb/{k:04d}.png depth/{k:04d}.png" for k in range(n)]

    def frame(k):
        rp, dp = lines[k].split()
        gray, _ = render(planes, kcalib.rgb.K, kcalib.rgb.resolution,
                         poses[k] @ depth_from_color)
        _, depth = render(planes, kcalib.depth.K, kcalib.depth.resolution, poses[k])
        write_png(os.path.join(root, rp), _u8(gray))
        write_png(os.path.join(root, dp), _u16(depth))

    _for_each_frame(frame, n)
    with open(os.path.join(root, "info.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    write_tum(os.path.join(root, "groundtruth.txt"), np.arange(float(n)),
              ground_truth(poses))
    return root
