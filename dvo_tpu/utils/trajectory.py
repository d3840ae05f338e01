"""Trajectory IO + ATE evaluation.

The reference only ever *draws* its trajectory (main.cpp:49-54 via the GLFW
submodule) and publishes no accuracy numbers (SURVEY.md §6).  The rebuild
writes TUM-format files (timestamp tx ty tz qx qy qz qw) and evaluates
absolute trajectory error with the standard Horn/Umeyama alignment.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> (x, y, z, w), TUM order."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.asarray([x, y, z, w])


def tum_line(t: float, T: np.ndarray) -> str:
    """One TUM-format line: ``t tx ty tz qx qy qz qw`` for a (4, 4)
    camera-to-world transform."""
    T = np.asarray(T)
    q = rotation_to_quaternion(T[:3, :3])
    tx, ty, tz = T[:3, 3]
    return (f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")


def write_tum(path: str, timestamps: Sequence[float], poses: Sequence[np.ndarray]):
    """poses: (4, 4) camera-to-world transforms."""
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses):
            f.write(tum_line(t, T) + "\n")


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps (N,), translations (N, 3)) — ATE only needs the
    positions."""
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            p = line.split()
            if len(p) >= 4:
                ts.append(float(p[0]))
                xyz.append([float(p[1]), float(p[2]), float(p[3])])
    return np.asarray(ts), np.asarray(xyz)


def associate(t_a: np.ndarray, t_b: np.ndarray, max_difference: float = 0.02):
    """Greedy nearest-timestamp association; returns index pairs."""
    pairs = []
    used = set()
    for i, t in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - t)))
        if abs(t_b[j] - t) <= max_difference and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment est -> gt.
    Returns (s, R, t)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    C = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(
    est_t: np.ndarray,
    est_xyz: np.ndarray,
    gt_t: np.ndarray,
    gt_xyz: np.ndarray,
    with_scale: bool = False,
    max_difference: float = 0.02,
) -> float:
    """Absolute trajectory error (RMSE, meters) after timestamp association
    and Horn alignment — the TUM benchmark's evaluate_ate protocol.  For
    monocular estimates pass with_scale=True (scale is unobservable)."""
    pairs = associate(est_t, gt_t, max_difference)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associations")
    e = est_xyz[[i for i, _ in pairs]]
    g = gt_xyz[[j for _, j in pairs]]
    s, R, t = align_umeyama(e, g, with_scale)
    aligned = (s * (R @ e.T)).T + t
    return float(np.sqrt(((aligned - g) ** 2).sum(axis=1).mean()))
