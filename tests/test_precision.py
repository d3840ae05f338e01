"""Precision audit: every float32 contraction on the per-frame device step
asks for HIGHEST precision.  A GPU may otherwise run an f32 dot in TF32
(~3 decimal digits), which biases the 6x6 GN systems and the pose math;
on the CPU the difference is invisible, so the jaxpr is checked instead."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
from jax import lax
from jax.extend import core as jcore

from dvo_tpu.config import BAConfig, DVOConfig, MapperConfig, PyramidConfig
from dvo_tpu.models import odometry


def _dots(jaxpr, out):
    """Every dot_general equation in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dots(sub, out)
    return out


def _unguarded_f32(closed):
    bad = []
    for eqn in _dots(closed.jaxpr, []):
        if not any(v.aval.dtype == jnp.float32 for v in eqn.invars):
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, tuple) else (prec,)
        if not all(p == lax.Precision.HIGHEST for p in precs):
            bad.append(f"{eqn.source_info.traceback}"[:300])
    return bad


H, W = 48, 64
K = jnp.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], jnp.float32)


def _mono_jaxpr():
    cfg = DVOConfig(
        pyramid=PyramidConfig(levels=2, culls=0),
        mapper=MapperConfig(crop_x=(4, 60), crop_y=(4, 44)),
        ba=BAConfig(enabled=True, window=3, iterations=1),
    )
    gray, mask = jnp.zeros((H, W)), jnp.ones((H, W), bool)
    state = odometry.monocular_init(gray, mask, K, jax.random.PRNGKey(0), cfg)
    return jax.make_jaxpr(
        lambda st, g: odometry.monocular_run(st, g, mask, K, cfg)
    )(state, jnp.zeros((2, H, W)))


def _rgbd_jaxpr():
    cfg = DVOConfig.rgbd()
    gray, mask = jnp.zeros((H, W)), jnp.ones((H, W), bool)
    depth = jnp.ones((H, W))
    state = odometry.rgbd_init(gray, mask, depth, depth, K, cfg)
    return jax.make_jaxpr(
        lambda st, g, d: odometry.rgbd_run_raw(st, g, mask, d, K, cfg)
    )(state, jnp.zeros((2, H, W), jnp.uint8), jnp.zeros((2, H, W), jnp.uint16))


@pytest.mark.parametrize("build", [_mono_jaxpr, _rgbd_jaxpr],
                         ids=["monocular_run_with_ba", "rgbd_run_raw"])
def test_every_f32_dot_is_highest(build):
    closed = build()
    assert _dots(closed.jaxpr, []), "audit found no contraction at all"
    assert _unguarded_f32(closed) == []


def test_audit_flags_default_precision():
    """The audit itself: an einsum without ``precision`` is reported."""
    closed = jax.make_jaxpr(lambda a: jnp.einsum("ij,jk->ik", a, a))(
        jnp.ones((3, 3))
    )
    assert len(_unguarded_f32(closed)) == 1
