"""Typed configuration — every constant of the reference, as a named field.

The reference hard-codes its constants in anonymous namespaces scattered
through the code (SURVEY.md §5 "Config / flag system: none").  Here each one
is a dataclass field whose default is the reference value, with the source
cited so parity can be checked.  ``compat_*`` flags select faithful-vs-fixed
behavior for the reference's quirks (SURVEY.md §7 "Reference quirks").
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Image pyramid shape.  Reference: include/system/system.hpp:30,47,82.

    ``levels`` pyramid scenes are built coarsest-first; the input is first
    decimated by ``2**culls`` (reference include/system/frame.hpp:99-117,
    src/system/frame.cpp:30-37).
    """

    levels: int = 3          # monocular mode (system.hpp:47); RGB-D uses 4
    culls: int = 2           # monocular mode (system.hpp:47); RGB-D uses 1


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Coarse-to-fine photometric Gauss-Newton tracking.

    Reference constants: src/track/tracker.cpp:16-19, src/track/optimize.cpp.
    """

    max_iterations: int = 15          # tracker.cpp:19 MAXIMUM_ITERATION
    min_update_norm: float = 5e-4     # tracker.cpp:17 MINIMUM_UPDATE
    min_residual: float = 5e-3        # tracker.cpp:16 MINIMUM_RESIDUAL
    # The reference also aborts past a 200 ms wall-clock budget
    # (tracker.cpp:18,68-73).  A device program cannot branch on host time; we
    # run fixed iterations with convergence masking and *report* time instead.
    min_depth: float = 0.20           # optimize.cpp:39 depth gate [m]
    # Per-level weight numerator ("step"): level 0 -> 2.0, 1 -> 1.5, 2+ -> 1.0
    # (optimize.cpp:22-26).
    level_steps: Tuple[float, ...] = (2.0, 1.5, 1.0, 1.0)
    sigma_clamp: Tuple[float, float] = (0.01, 0.5)  # optimize.cpp:83
    # Level-2 crop: keep x in [20, 140], y in [20, 100] inclusive
    # (optimize.cpp:33-36 — absolute pixels, hard-coded for 160x120 but the
    # reference applies them verbatim at level index 2 of *any* pyramid).
    crop_level: int = 2               # level index the crop applies to
    crop_x: Tuple[int, int] = (20, 140)
    crop_y: Tuple[int, int] = (20, 100)
    # Faithful: weight applied to the residual vector B only, not to the
    # Jacobian rows A (optimize.cpp:87-89).  This scales every GN update by
    # the (sigma-dependent) weight — a 4-20x overshoot that is plausibly the
    # root cause of the reference's admitted tracking unreliability
    # (README.md:4-5).  Default is the fixed weighted-normal-equations form
    # (weight on both sides; uniform weights then cancel exactly).  Set True
    # only for single-step parity tests against the reference/oracle.
    compat_weight_b_only: bool = False
    # Levenberg damping added to J^T J diagonal (0 = faithful Gauss-Newton;
    # the reference's DECOMP_SVD pseudo-inverse is emulated by a tiny ridge).
    damping: float = 1e-6
    # Constant-velocity warm start (the reference always starts GN from
    # identity, tracker.cpp:28): seed each frame's optimization with the
    # motion prior composed from the previous relative pose and the last
    # frame-to-frame velocity.  Converges to the same optimum from a closer
    # start, so the early-exit driver executes fewer GN iterations.  The
    # prior is discarded (identity start) when its norm exceeds
    # ``warm_start_max_norm`` — a tracking glitch must not catapult the
    # next frame out of the photometric basin.
    # Default OFF (reference-faithful): in the NOISE-BOOTSTRAP monocular
    # mode the early poses are depth-noise-driven, and a velocity prior
    # built from them measurably slows the depth field's convergence
    # (kinectv2_01 gate: converged-pixel peak 86 vs 131-170 without).  The
    # RGB-D preset turns it ON — measured-depth tracking is coherent
    # frame-to-frame and its 256x212 4-level GN is where iterations cost.
    warm_start: bool = False
    warm_start_max_norm: float = 0.5
    # Iteration driver: True runs the GN loop as a ``lax.while_loop`` that
    # exits at convergence — the reference's post-update break
    # (tracker.cpp:68-73) as a real device-side early exit (typical
    # convergence is 3-6 of the 15 iterations).  False runs a fixed-length
    # ``lax.scan`` with a freeze mask: identical results, constant cost.
    early_exit: bool = True


@dataclasses.dataclass(frozen=True)
class DepthFilterConfig:
    """Gaussian inverse-variance depth fusion.  Reference src/math/gaussian.cpp."""

    # Compatibility gate: reject an observation if |d - mu| > gain * max(sigma, s)
    # where gain ramps 0.5 -> 1.0 over 0.8 m of min(d, |d - mu|)
    # (gaussian.cpp:19-21).
    gain_ramp: float = 0.8
    # On rejection in update(): reset depth to a uniform random draw capped at
    # 4.0 m and sigma to 0.5 (gaussian.cpp:22-25).  The reference constructs
    # uniform_real_distribution(2.0, 0.5) with reversed bounds — UB that in
    # practice (libstdc++) draws from [2.0, 0.5) "backwards"; we draw from
    # [0.5, 2.0] which is the evident intent (SURVEY.md §7 quirks).
    reset_depth_range: Tuple[float, float] = (0.5, 2.0)
    reset_depth_cap: float = 4.0
    reset_sigma: float = 0.5


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Keyframe policy + epipolar depth backend.

    Reference: src/map/mapper.cpp:12-13,90,122; src/map/implement.cpp:12-20.
    """

    min_movement: float = 0.02        # mapper.cpp:12 MINIMUM_MOVEMENT [m]
    max_forward: int = 6              # mapper.cpp:13 MAXIMUM_FORWARD [frames]
    # Depth-update crop: keep x in [16, 144], y in [12, 108] inclusive
    # (mapper.cpp:90, absolute pixels).
    crop_x: Tuple[int, int] = (16, 144)
    crop_y: Tuple[int, int] = (12, 108)
    # Epipolar search (implement.cpp)
    luminance_sigma: float = 0.5      # implement.cpp:12
    epipolar_sigma: float = 0.5       # implement.cpp:14
    predict_sigma: float = 0.06       # implement.cpp:17 [m]
    matching_threshold_ratio: float = 0.1   # implement.cpp:20
    ssd_window: int = 3               # implement.cpp:118 N
    max_steps: int = 100              # implement.cpp:141 step cap
    min_search_depth: float = 0.10    # implement.cpp:30 max(depth - sigma, 0.10)
    # Observation acceptance gates (mapper.cpp:122)
    accept_depth: Tuple[float, float] = (0.2, 6.0)
    accept_sigma: Tuple[float, float] = (0.0, 0.5)
    # Regularizer clamps fused depth to <= 6 m (implement.cpp:178).
    max_depth: float = 6.0
    # Keyframe ring-buffer capacity (the reference grows its history without
    # bound, frame.hpp:146-188; a fixed ring keeps shapes static for jit).
    history_capacity: int = 8
    depth_filter: DepthFilterConfig = dataclasses.field(default_factory=DepthFilterConfig)


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Monocular depth bootstrap.  Reference include/system/frame.hpp:12-22."""

    depth_mean: float = 1.5
    depth_std: float = 0.5
    depth_floor: float = 0.5
    sigma: float = 0.5
    # Propagate initializes unobserved destination pixels to depth=1, sigma=1
    # (implement.cpp:229-231).
    propagate_depth: float = 1.0
    propagate_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Windowed photometric bundle adjustment (new capability; no reference
    counterpart — SURVEY.md §7 phase 5)."""

    # Run BA inside the VO pipeline on every keyframe promotion (once the
    # ring holds a full window): refined poses/depths flow back into the
    # keyframe ring and the new reference keyframe.  The hook point mirrors
    # the reference's keyframe-creation path (mapper.cpp:16-33).
    enabled: bool = False
    window: int = 7                   # keyframes per BA window
    iterations: int = 5               # Levenberg-Marquardt outer iterations
    damping: float = 1e-4
    huber_delta: float = 0.1          # photometric robust loss threshold
    depth_damping: float = 1e-3       # ridge on the (diagonal) depth block


@dataclasses.dataclass(frozen=True)
class DVOConfig:
    """Top-level framework configuration."""

    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)

    @staticmethod
    def monocular() -> "DVOConfig":
        """Monocular mode: 3 levels, input pre-decimated 4x (system.hpp:47)."""
        return DVOConfig(pyramid=PyramidConfig(levels=3, culls=2))

    @staticmethod
    def rgbd() -> "DVOConfig":
        """RGB-D tracking mode: 4 levels, 2x decimation (system.hpp:30,82).

        Warm start on: frame-to-frame measured-depth tracking is coherent,
        so the constant-velocity prior cuts executed GN iterations (see
        TrackerConfig.warm_start for why monocular defaults off).

        min_update_norm raised to 1.5e-3 (reference default 5e-4,
        tracker.cpp:16, tuned for its 160x120 mono mode): on real
        512x424 kinect frames the GN updates contract at only ~0.9 per
        iteration and creep from 5e-3 to ~1e-3 over the full 15-iteration
        cap — so the reference threshold never fires and every frame pays
        ~48 executed iterations (measured).  At 1.5e-3 tracking stops
        ~5-8 iterations earlier per level with NO measured accuracy cost
        on the known-motion rigs (KINECT_1DEG rotation 1.052 vs 1.053
        deg/frame; KINECT_50MM translation 30.1 vs 27.8 mm, both deep
        inside the rigs' accuracy bands).  Accuracy-critical callers can
        restore the reference threshold per run."""
        return DVOConfig(
            pyramid=PyramidConfig(levels=4, culls=1),
            tracker=TrackerConfig(warm_start=True, min_update_norm=1.5e-3),
        )


# Invalid-pixel sentinel used at the *host/IO boundary* only (undistortion
# border fill, reference math/util.hpp:7).  Inside device code validity is an
# explicit boolean mask, never a magic value.
INVALID = -2.0
EPSILON = 1e-6
