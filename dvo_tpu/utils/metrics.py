"""Structured per-frame metrics and timing.

The reference scatters raw ``std::cout`` prints through the main path
(tracker.cpp:56-61, mapper.cpp:136 "valid update: N pixel", system.hpp:59-64)
and times phases with a RAII ``Timer`` (include/core/timer.hpp) — SURVEY.md
§5 calls for the same signals as structured JSONL.  ``MetricsLogger`` emits
one JSON object per frame (residuals, GN iterations, valid-pixel counts,
keyframe events, depth-filter accept/reject, wall time); ``Timer`` is the
``perf_counter`` + ``block_until_ready`` harness used by the benchmarks.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import numpy as np


class Timer:
    """Wall-clock context timer (reference core/timer.hpp as a context
    manager).  ``ms`` is valid after exit; pass ``sync`` (e.g. a device
    array) to wait for device completion before stopping the clock."""

    def __init__(self, sync=None):
        self._sync = sync
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            import jax

            jax.block_until_ready(self._sync)
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


class MetricsLogger:
    """JSONL metrics sink.  ``log_frame(result, seconds)`` extracts the
    standard per-frame signals from a StepResult; ``log(**kv)`` writes an
    arbitrary record.  No-op when constructed with path=None."""

    def __init__(self, path: Optional[str] = None):
        self._fh: Optional[IO] = open(path, "w") if path else None
        self._n = 0

    def log(self, **kv) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(kv) + "\n")
        self._fh.flush()

    def log_frame(self, result, seconds: float, timestamp: float = 0.0) -> None:
        """result: models.odometry.StepResult (device or host)."""
        if self._fh is None:
            return
        tr = result.tracking
        res = np.asarray(tr.residuals)
        active = res > 0
        self.log(
            frame=self._n,
            t=float(timestamp),
            ms=round(seconds * 1e3, 3),
            keyframe=bool(np.asarray(result.is_keyframe)),
            xi=[round(float(v), 6) for v in np.asarray(result.relative_xi)],
            gn_iters=[int(v) for v in np.asarray(tr.iterations)],
            final_residual=[
                round(float(res[l][active[l]][-1]), 6) if active[l].any() else None
                for l in range(res.shape[0])
            ],
            valid_pixels=[int(v) for v in np.asarray(tr.valid_counts).max(axis=1)],
            map_observed=int(np.asarray(result.mapping.observed)),
            map_accepted=int(np.asarray(result.mapping.accepted)),
            map_rejected=int(np.asarray(result.mapping.rejected)),
            map_aged_out=int(np.asarray(result.mapping.aged_out)),
            ba_cost=(
                round(float(np.asarray(result.ba_cost)), 6)
                if float(np.asarray(result.ba_cost)) >= 0
                else None
            ),
        )
        self._n += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
