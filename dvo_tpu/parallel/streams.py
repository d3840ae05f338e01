"""Multi-stream scaling over the device mesh — one (or more) cameras per
device.

Each device runs its own streams' full device-side chunked driver
(models/odometry.monocular_run), with no cross-stream communication at
all — the embarrassingly-parallel layout the reference (single-camera,
single-process; SURVEY.md §2 "parallelism strategies") never needed.

``monocular_run_streams`` shard_maps the chunked driver over a ``stream``
mesh axis: B streams on D devices run B/D per-device vmapped pipelines.
With B == D the vmap is width-1 — each device executes exactly the
single-stream program (verified for correctness on the virtual CPU mesh
in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from dvo_tpu.config import DVOConfig
from dvo_tpu.models.odometry import monocular_run


def stream_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the ``stream`` axis."""
    from dvo_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    return make_mesh((n,), ("stream",), devices)


def monocular_run_streams(mesh: Mesh, states, grays, masks, K,
                          cfg: DVOConfig = DVOConfig.monocular()):
    """Chunked multi-stream driver over the mesh: ``states`` is a stacked
    VOState with a leading B axis (``monocular_init_batched``), grays/masks
    are (B, N, H, W), K is shared (3, 3).  B must divide by the mesh's
    ``stream`` axis size; each device runs its local streams' whole-chunk
    ``lax.scan`` programs independently (zero collectives).  Returns
    (states', stacked StepResults) like ``monocular_run_batched``."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("stream"), P("stream"), P("stream"), P()),
        out_specs=(P("stream"), P("stream")),
        check_vma=False,
    )
    def body(st, g, m, k):
        return jax.vmap(
            lambda s, gg, mm: monocular_run(s, gg, mm, k, cfg)
        )(st, g, m)

    return jax.jit(body)(states, grays, masks, K)


def rgbd_run_streams(mesh: Mesh, states, grays, masks, depths, sigmas, K,
                     cfg: DVOConfig = DVOConfig.rgbd()):
    """RGB-D twin of ``monocular_run_streams``: B frame-to-frame tracking
    pipelines sharded over the ``stream`` axis (grays/masks/depths/sigmas:
    (B, N, H, W))."""
    from dvo_tpu.models.odometry import rgbd_run

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("stream"),) * 5 + (P(),),
        out_specs=(P("stream"), P("stream")),
        check_vma=False,
    )
    def body(st, g, m, d, s, k):
        return jax.vmap(
            lambda s_, gg, mm, dd, ss: rgbd_run(s_, gg, mm, dd, ss, k, cfg)
        )(st, g, m, d, s)

    return jax.jit(body)(states, grays, masks, depths, sigmas, K)
