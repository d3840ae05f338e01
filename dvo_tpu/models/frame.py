"""Frame and Scene pytrees — the framework's data model.

Reference: include/system/frame.hpp.  ``Scene`` (one pyramid level,
frame.hpp:9-70) and ``Frame`` (pyramid + pose + age, frame.hpp:72-144) become
immutable pytree dataclasses of device arrays; the pointer graph
(``m_ref_frame``) and mutable in-place updates of the reference are replaced
by pure functions returning new pytrees.

Pyramid convention matches the reference (frame.cpp:30-37): scenes are
ordered coarsest-first — scenes[0] is the most decimated, scenes[levels-1]
is the base ("culled input") level.  The input is pre-decimated by
``2**culls`` before the pyramid is built (frame.hpp:99-117).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from dvo_tpu.config import InitConfig
from dvo_tpu.ops.image import cull_image, cull_intrinsic, gradients


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """One pyramid level.  Gradients are precomputed at construction — the
    reference computes them lazily (frame.hpp:52-63) but always ends up
    needing them; precomputation keeps the pytree static."""

    gray: jax.Array       # (H, W) float32, [0, 1]
    mask: jax.Array       # (H, W) bool — validity (reference INVALID=-2)
    depth: jax.Array      # (H, W) float32 [m]
    sigma: jax.Array      # (H, W) float32 [m]
    gx: jax.Array         # (H, W) central diff, NOT halved (convert.cpp:48)
    gy: jax.Array         # (H, W)
    gmask: jax.Array      # (H, W) bool — both gradients valid
    K: jax.Array          # (3, 3)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.gray.shape


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frame:
    """Image pyramid + pose state.  Reference frame.hpp:72-144.

    ``xi`` is the world pose twist, ``relative_xi`` the pose w.r.t. the
    reference keyframe (updateXi: xi = compose(ref.xi, relative_xi),
    frame.cpp:7-14).  ``age`` counts, per base-level pixel, how many
    keyframes ago the pixel's depth was born (frame.hpp:83-89)."""

    scenes: Tuple[Scene, ...]   # coarsest first
    xi: jax.Array               # (6,) world pose twist
    relative_xi: jax.Array      # (6,) twist vs ref keyframe
    age: jax.Array              # (H, W) int32 at base level
    frame_id: jax.Array         # () int32

    @property
    def base(self) -> Scene:
        """Finest level (reference Frame::top(), frame.hpp:127)."""
        return self.scenes[-1]

    @property
    def levels(self) -> int:
        return len(self.scenes)


def _make_scene(gray, mask, depth, sigma, K, with_grads: bool = True) -> Scene:
    if with_grads:
        gx, gy, mx, my = gradients(gray, mask)
        return Scene(gray=gray, mask=mask, depth=depth, sigma=sigma,
                     gx=gx, gy=gy, gmask=mx & my, K=K)
    # Gradients deferred (None = empty pytree subtree): only the REFERENCE
    # keyframe's gradients are ever read (tracker samples ref.gx/gy; the
    # mapper/BA read them from the keyframe ring), so non-keyframe frames
    # skip the stencil work and the promote branch fills it in via
    # ``with_gradients`` — a lax.cond-deferred cost paid on ~1 frame in 6.
    return Scene(gray=gray, mask=mask, depth=depth, sigma=sigma,
                 gx=None, gy=None, gmask=None, K=K)


def _pyramid(gray, mask, depth, sigma, K, levels: int,
             with_grads: bool = True) -> Tuple[Scene, ...]:
    """Coarsest-first pyramid, every level re-culled from the base
    (frame.cpp:30-37 culls the base scene by levels-1-i)."""
    scenes = []
    for i in range(levels):
        t = levels - 1 - i
        scenes.append(
            _make_scene(
                cull_image(gray, t), cull_image(mask, t),
                cull_image(depth, t), cull_image(sigma, t),
                cull_intrinsic(K, t), with_grads,
            )
        )
    return tuple(scenes)


def _normalize_gray(gray: jax.Array) -> jax.Array:
    """uint8 [0, 255] -> f32 [0, 1] on device; float inputs pass through
    (already normalized by the host loader, reference loader.cpp:61)."""
    if gray.dtype == jnp.uint8:
        return gray.astype(jnp.float32) * (1.0 / 255.0)
    return gray


def build_frame(
    gray: jax.Array,
    mask: jax.Array,
    K: jax.Array,
    levels: int,
    culls: int,
    key: jax.Array,
    frame_id,
    init: InitConfig = InitConfig(),
    with_grads: bool = True,
) -> Frame:
    """Monocular frame: depth bootstrapped from clamped Gaussian noise
    ~ N(1.5, 0.5) floored at 0.5, sigma = 0.5 (reference frame.hpp:12-22).

    ``gray`` may be uint8 (raw 8-bit camera/PNG values): normalization to
    [0, 1] then happens on device — the reference normalizes on host
    (loader.cpp:61), but shipping uint8 cuts host->device traffic 4x."""
    gray = _normalize_gray(gray)
    gray = cull_image(gray, culls)
    mask = cull_image(mask, culls)
    K = cull_intrinsic(K, culls)
    h, w = gray.shape
    depth = init.depth_mean + init.depth_std * jax.random.normal(key, (h, w))
    depth = jnp.maximum(depth, init.depth_floor)
    sigma = jnp.full((h, w), init.sigma, dtype=jnp.float32)
    return Frame(
        scenes=_pyramid(gray, mask, depth, sigma, K, levels, with_grads),
        xi=jnp.zeros(6, jnp.float32),
        relative_xi=jnp.zeros(6, jnp.float32),
        age=jnp.zeros((h, w), jnp.int32),
        frame_id=jnp.asarray(frame_id, jnp.int32),
    )


def build_frame_with_depth(
    gray: jax.Array,
    mask: jax.Array,
    depth: jax.Array,
    sigma: jax.Array,
    K: jax.Array,
    levels: int,
    culls: int,
    frame_id,
) -> Frame:
    """RGB-D frame with measured depth/sigma (reference frame.hpp:91-106).
    ``gray`` may be uint8 — see ``build_frame``."""
    gray = _normalize_gray(gray)
    gray = cull_image(gray, culls)
    mask = cull_image(mask, culls)
    depth = cull_image(depth, culls)
    sigma = cull_image(sigma, culls)
    K = cull_intrinsic(K, culls)
    h, w = gray.shape
    return Frame(
        scenes=_pyramid(gray, mask, depth, sigma, K, levels),
        xi=jnp.zeros(6, jnp.float32),
        relative_xi=jnp.zeros(6, jnp.float32),
        age=jnp.zeros((h, w), jnp.int32),
        frame_id=jnp.asarray(frame_id, jnp.int32),
    )


def with_gradients(frame: Frame) -> Frame:
    """Fill in deferred gradient planes (see ``_make_scene``); scenes that
    already carry gradients pass through unchanged."""
    scenes = []
    for s in frame.scenes:
        if s.gx is not None:
            scenes.append(s)
        else:
            gx, gy, mx, my = gradients(s.gray, s.mask)
            scenes.append(
                dataclasses.replace(s, gx=gx, gy=gy, gmask=mx & my)
            )
    return dataclasses.replace(frame, scenes=tuple(scenes))


def with_pose(frame: Frame, relative_xi: jax.Array, ref_xi: jax.Array) -> Frame:
    """updateXi: world pose = compose(ref keyframe pose, relative pose)
    (reference frame.cpp:7-14)."""
    from dvo_tpu import lie

    return dataclasses.replace(
        frame,
        relative_xi=relative_xi,
        xi=lie.compose(ref_xi, relative_xi),
    )


def with_depth(frame: Frame, depth, sigma=None, age=None) -> Frame:
    """Re-derive every pyramid level's depth (and optionally sigma) from a
    new base-level map by culling (reference frame.cpp:39-61)."""
    scenes = []
    for i, s in enumerate(frame.scenes):
        t = frame.levels - 1 - i
        scenes.append(
            dataclasses.replace(
                s,
                depth=cull_image(depth, t),
                sigma=cull_image(sigma, t) if sigma is not None else s.sigma,
            )
        )
    return dataclasses.replace(
        frame,
        scenes=tuple(scenes),
        age=age if age is not None else frame.age,
    )
