"""Device mesh construction for the VO workload.

Axes:
  * ``tile`` — image-row tiles of the dense per-pixel loops (tracking GN,
    mapping epipolar march).  Collectives: ``psum`` of 6x6 normal-equation
    blocks and scalar stats — tiny payloads, one per GN iteration.
  * ``kf``   — keyframes of the BA window / map blocks.  Collectives:
    ``psum`` of the reduced camera system after Schur elimination.

The axes follow the algorithm only: devices are taken in ``jax.devices()``
order, which suits cards joined all to all.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def vo_mesh(n_devices: int | None = None) -> Mesh:
    """Default VO mesh: factor devices into (kf, tile), favouring the tile
    axis for the dense per-pixel work."""
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    kf = 1
    for cand in (4, 2):
        if n % cand == 0 and n // cand >= 2:
            kf = cand
            break
    return make_mesh((kf, n // kf), ("kf", "tile"), devices)
