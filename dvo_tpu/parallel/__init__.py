"""Device-mesh sharding of tracking, mapping, and bundle adjustment.

The reference is single-process shared-memory only (SURVEY.md §2 "that is
all"); this layer is a new first-class capability: image-tile sharding of
the dense per-pixel work (SP analogue) and keyframe sharding of window
residuals/BA (DP analogue), with XLA collectives between devices.
"""

from dvo_tpu.parallel.mesh import make_mesh, vo_mesh
from dvo_tpu.parallel.tracking import sharded_gn_normal_equations, sharded_track

__all__ = [
    "make_mesh",
    "vo_mesh",
    "sharded_gn_normal_equations",
    "sharded_track",
]
