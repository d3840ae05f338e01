"""Keyframe-sharded windowed bundle adjustment.

Host keyframes of the BA window shard over the ``kf`` mesh axis: each
device evaluates the photometric pair terms for its own host keyframes
against a replicated copy of the window images, accumulates its partial
camera system and Schur-complement contribution, and the reduced 6M x 6M
system is ``psum``-reduced across the axis (a ~7 KB payload for M = 7).  The dense
solve is replicated (tiny); inverse-depth back-substitution stays local to
each device's host pixels.

This is SURVEY.md §2's "distributed windowed bundle adjustment with
Schur-complement depth elimination, reduced camera system all-reduced via
psum" — the no-reference-counterpart capability.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from dvo_tpu import lie
from dvo_tpu.config import BAConfig
from dvo_tpu.models.ba import (
    BAResult,
    BAWindow,
    _current_window,
    coupling_dot,
    host_system,
)


def _pad_window(window: BAWindow, m_pad: int) -> BAWindow:
    """Pad with dummy keyframes (all-invalid masks) so the keyframe axis
    divides the mesh.  An all-False mask zeroes every pair term the dummy
    touches as host (valid &= mask[k]) and as target (samp_ok), so padded
    entries contribute exactly nothing; their pose blocks are held by the
    Levenberg ridge and their increments are discarded on slice-back."""
    import dataclasses

    def pad(arr):
        reps = jnp.concatenate(
            [arr, jnp.repeat(arr[-1:], m_pad, axis=0)], axis=0
        )
        return reps

    return dataclasses.replace(
        window,
        gray=pad(window.gray),
        mask=jnp.concatenate(
            [window.mask, jnp.zeros((m_pad,) + window.mask.shape[1:], bool)]
        ),
        gx=pad(window.gx), gy=pad(window.gy),
        gmask=jnp.concatenate(
            [window.gmask, jnp.zeros((m_pad,) + window.gmask.shape[1:], bool)]
        ),
        depth=pad(window.depth), sigma=pad(window.sigma), xi=pad(window.xi),
    )


def bundle_adjust_sharded(
    window: BAWindow,
    cfg: BAConfig,
    mesh: Mesh,
    axis: str = "kf",
) -> BAResult:
    """Distributed ``models.ba.bundle_adjust``: identical math, host
    keyframes sharded over ``axis``.  Windows that do not divide the axis
    are padded with inert dummy keyframes (see ``_pad_window``) — the
    north-star window of 7 runs on any mesh."""
    m_true, h, w_px = window.gray.shape
    n_dev = mesh.shape[axis]
    if m_true % n_dev:
        window = _pad_window(window, n_dev - m_true % n_dev)
    m = window.gray.shape[0]
    m_loc = m // n_dev
    n = 6 * m

    host_specs = BAWindow(
        gray=P(axis, None, None), mask=P(axis, None, None),
        gx=P(axis, None, None), gy=P(axis, None, None),
        gmask=P(axis, None, None), depth=P(axis, None, None),
        sigma=P(axis, None, None), xi=P(), K=P(),
    )
    full_spec = BAWindow(
        gray=P(), mask=P(), gx=P(), gy=P(), gmask=P(),
        depth=P(), sigma=P(), xi=P(), K=P(),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(full_spec, host_specs),
        out_specs=(P(), P(axis, None, None), P(), P()),
        check_vma=False,
    )
    def run(win_full, win_host):
        dev = lax.axis_index(axis)

        def iteration(carry, _):
            deltas, drho_loc = carry
            # Assemble full drho for window re-linearization: only this
            # device's hosts matter for its own pair terms, but depth maps
            # of *target* keyframes changed too -> all_gather the local
            # inverse-depth increments (host-sharded axis).
            drho_all = lax.all_gather(drho_loc, axis, tiled=True)       # (M,H,W)
            win_cur, T_all = _current_window(win_full, deltas, drho_all)

            def host(acc, lk):
                S_a, g_a, cost, count = acc
                k = dev * m_loc + lk
                # host_system folds each host's depth elimination into its
                # own (6M, 6M) Schur contribution — the coupling rows never
                # leave it (models/ba.py round-3 restructure).
                Sk, gk, hddk, gdk, ck, nk = host_system(win_cur, T_all, k, cfg)
                return (S_a + Sk, g_a + gk, cost + ck, count + nk), (hddk, gdk)

            acc0 = (
                jnp.zeros((n, n), jnp.float32),
                jnp.zeros((n,), jnp.float32),
                jnp.asarray(0.0, jnp.float32),
                jnp.asarray(0, jnp.int32),
            )
            (S_loc, g_loc, cost, count), (hdd_loc, gd_loc) = lax.scan(
                host, acc0, jnp.arange(m_loc)
            )

            # One psum of (6M)^2 + 6M + 2 values.
            S = lax.psum(S_loc, axis)
            g_red = lax.psum(g_loc, axis)
            cost = lax.psum(cost, axis)
            count = lax.psum(count, axis)

            S = S + cfg.damping * jnp.eye(n, dtype=S.dtype)
            S = S.at[:6, :6].add(jnp.eye(6, dtype=S.dtype))
            dc = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(S), g_red)
            # Back-substitution: recompute each local host's coupling dot
            # against the replicated dc (no stored rows).
            hdd_inv = 1.0 / (hdd_loc + cfg.depth_damping)
            bdot_loc = lax.map(
                lambda lk: coupling_dot(win_cur, T_all, dev * m_loc + lk, dc, cfg),
                jnp.arange(m_loc),
            )
            d_drho = -(gd_loc + bdot_loc) * hdd_inv

            deltas = jax.vmap(lie.compose)(deltas, dc.reshape(m, 6))
            return (deltas, drho_loc + d_drho), (cost, count)

        init = (
            jnp.zeros((m, 6), jnp.float32),
            jnp.zeros((m_loc, h, w_px), jnp.float32),
        )
        (deltas, drho_loc), (costs, counts) = lax.scan(
            iteration, init, None, length=cfg.iterations
        )

        xi = jax.vmap(lie.compose)(win_full.xi, deltas)
        safe_d = jnp.maximum(win_host.depth, 1e-3)
        depth_loc = 1.0 / jnp.maximum(1.0 / safe_d + drho_loc, 1e-4)
        return xi, depth_loc, costs, counts

    xi, depth, costs, counts = run(window, window)
    # Slice padding back off (inert dummy keyframes, see _pad_window).
    return BAResult(xi=xi[:m_true], depth=depth[:m_true], costs=costs,
                    counts=counts)
