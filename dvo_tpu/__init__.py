"""dvo_tpu — semi-dense direct visual odometry in JAX.

A JAX/XLA framework with the capabilities of the reference C++
implementation (KYabuuchi/direct-visual-odometry: semi-dense visual
odometry for a monocular camera, Engel/Sturm/Cremers ICCV 2013), re-designed
as jitted device programs:

- pure-functional pytrees instead of shared-mutable ``cv::Mat``;
- static shapes + validity masks instead of ``INVALID`` sentinel scalars;
- device-side Gauss-Newton loops with convergence tests instead of
  wall-clock loop exits;
- both hot loops (photometric GN normal equations; epipolar depth search
  and the Gaussian depth-filter update) as dense gather + elementwise +
  reduction code that XLA fuses;
- a ``jax.sharding.Mesh`` keyframe/tile-sharded mapping and windowed
  bundle-adjustment layer the reference never had.

Layout (mirrors SURVEY.md §2 component inventory):
  dvo_tpu.lie       — SE(3)/SO(3) (reference include/math/se3.hpp)
  dvo_tpu.config    — every constant of the reference as a typed dataclass
  dvo_tpu.ops       — image pyramid, gradients, sampling, warping, depth filter
  dvo_tpu.models    — frame pytrees, tracker, mapper, odometry, bundle adjust
  dvo_tpu.parallel  — device-mesh sharding of mapping / BA
  dvo_tpu.utils     — dataset loaders, trajectory IO, ATE evaluation, timing
  dvo_tpu.native    — C++ data-plane (PNG decode, undistort, prefetch loader)
"""

from dvo_tpu.config import DVOConfig, PyramidConfig, TrackerConfig, MapperConfig

__all__ = ["DVOConfig", "PyramidConfig", "TrackerConfig", "MapperConfig"]
__version__ = "0.1.0"
