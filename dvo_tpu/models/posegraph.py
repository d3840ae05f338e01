"""Global pose-graph refinement over the keyframe trajectory.

A capability beyond the reference (which never refines a pose after
emitting it — its trajectory is drawn and forgotten, main.cpp:49-54):
Gauss-Newton over the stacked world twists of ALL keyframes, constrained by
relative-pose measurements.  Constraints come from three sources (harvested
by utils.runner):

  * odometry: the tracked relative pose between consecutive keyframes;
  * BA windows: refined relative poses between keyframes that shared a
    windowed-BA solve (models/ba.py) — higher weight;
  * loop closures: re-tracked relative poses between non-adjacent keyframes
    that ended up spatially close (the drift-correcting ingredient).

Device shape: the problem is tiny (6N for N keyframes, N <= a few
hundred), so one jitted program runs the whole refinement — per-edge
residuals and exact 6x12 Jacobians (``jax.jacfwd`` through the Lie chain,
vmapped over edges), dense (N,6,N,6) normal-matrix assembly by batched
index-add, Cholesky solve, ``lax.scan`` over GN iterations.  No
sparse bookkeeping: at N = 256 the dense system is 1536^2 f32 = 9 MB.

Residual convention: edge e = (i, j, z) with z = log(T_i^-1 T_j) measured;
r_e(d) = log( exp(z)^-1 (T_i exp(d_i))^-1 (T_j exp(d_j)) ), so a
perfectly consistent graph has r = 0 and the gauge is fixed by pinning
node 0.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

from dvo_tpu import lie
from dvo_tpu.utils import oracle as _nplie  # host-side NumPy Lie math:
# the harvester's bookkeeping runs per node/edge on the HOST; routing
# these tiny exp/log/compose calls through jnp would dispatch one device
# op and one synchronizing fetch each.  The NumPy twins are float64
# oracles of the same math (utils/oracle.py).


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseGraphEdges:
    """E relative-pose constraints between node i and node j."""

    i: jax.Array        # (E,) int32 source node
    j: jax.Array        # (E,) int32 target node
    z: jax.Array        # (E, 6) measured twist log(T_i^-1 T_j)
    weight: jax.Array   # (E,) scalar information weight

    @property
    def size(self) -> int:
        return self.i.shape[0]


# Shared by the absolute diagonal floor and the Jacobi clamp in
# pose_graph_step — see the comment there before changing either.
_DIAG_FLOOR = 1e-8


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    iterations: int = 10
    # Levenberg lambda, RELATIVE to diag(H) — pose-graph normal matrices mix
    # translation/rotation scales and are near-singular along weakly
    # constrained directions; in f32 an absolute ridge is either crushing or
    # useless.  Adapted x4 down on accepted steps, x4 up on rejected ones.
    damping: float = 1e-4


def _edge_residual(xi_i, xi_j, z, d_i, d_j):
    """r = log(exp(z)^-1 exp(xi_i exp(d_i))^-1 (T_j exp(d_j)))."""
    T_i = lie.matmul(lie.se3_exp(xi_i), lie.se3_exp(d_i))
    T_j = lie.matmul(lie.se3_exp(xi_j), lie.se3_exp(d_j))
    M = lie.matmul(lie.matmul(lie.invert_T(lie.se3_exp(z)), lie.invert_T(T_i)), T_j)
    return lie.se3_log(M)


def _edge_terms(xi, edges: PoseGraphEdges):
    """Residuals + exact Jacobians wrt right-increments at d = 0 for every
    edge.  Returns (r (E,6), Ji (E,6,6), Jj (E,6,6))."""
    zero = jnp.zeros(6, jnp.float32)

    def one(i, j, z):
        xi_i, xi_j = xi[i], xi[j]
        r = _edge_residual(xi_i, xi_j, z, zero, zero)
        Ji = jax.jacfwd(lambda d: _edge_residual(xi_i, xi_j, z, d, zero))(zero)
        Jj = jax.jacfwd(lambda d: _edge_residual(xi_i, xi_j, z, zero, d))(zero)
        return r, Ji, Jj

    return jax.vmap(one)(edges.i, edges.j, edges.z)


def _graph_cost(xi, edges: PoseGraphEdges):
    zero = jnp.zeros(6, jnp.float32)
    r = jax.vmap(
        lambda i, j, z: _edge_residual(xi[i], xi[j], z, zero, zero)
    )(edges.i, edges.j, edges.z)
    return jnp.sum(edges.weight * jnp.sum(r * r, axis=-1))


def pose_graph_step(xi, lam, edges: PoseGraphEdges, cfg: PoseGraphConfig,
                    n_real=None):
    """One Levenberg step with Jacobi preconditioning and accept/reject.
    Returns (new_xi, new_lam, cost_at_xi).  ``n_real`` (traced): number of
    live nodes when the graph is bucket-padded (see ``optimize_pose_graph``)
    — padded nodes get an identity diagonal block (no edges touch them, so
    their raw block is all-zero and would sink the Cholesky) and solve to
    a zero update."""
    n = xi.shape[0]
    r, Ji, Jj = _edge_terms(xi, edges)
    w = edges.weight
    # Gauge: node 0 is pinned — zero its Jacobian columns.
    gi = jnp.where(edges.i == 0, 0.0, 1.0)[:, None, None]
    gj = jnp.where(edges.j == 0, 0.0, 1.0)[:, None, None]
    Ji = Ji * gi
    Jj = Jj * gj

    wJi = Ji * w[:, None, None]
    wJj = Jj * w[:, None, None]
    # Dense block assembly: H (N,6,N,6), g (N,6) by batched index-add.
    hi = lax.Precision.HIGHEST
    H = jnp.zeros((n, 6, n, 6), jnp.float32)
    H = H.at[edges.i, :, edges.i, :].add(jnp.einsum("eab,eac->ebc", wJi, Ji, precision=hi))
    H = H.at[edges.i, :, edges.j, :].add(jnp.einsum("eab,eac->ebc", wJi, Jj, precision=hi))
    H = H.at[edges.j, :, edges.i, :].add(jnp.einsum("eab,eac->ebc", wJj, Ji, precision=hi))
    H = H.at[edges.j, :, edges.j, :].add(jnp.einsum("eab,eac->ebc", wJj, Jj, precision=hi))
    g = jnp.zeros((n, 6), jnp.float32)
    g = g.at[edges.i].add(jnp.einsum("eab,ea->eb", wJi, r, precision=hi))
    g = g.at[edges.j].add(jnp.einsum("eab,ea->eb", wJj, r, precision=hi))

    A = H.reshape(6 * n, 6 * n)
    A = A.at[:6, :6].add(jnp.eye(6, dtype=A.dtype))  # gauge block
    if n_real is not None:
        padded = jnp.repeat(jnp.arange(n) >= n_real, 6)
        A = A + jnp.diag(jnp.where(padded, 1.0, 0.0).astype(A.dtype))
    diag = jnp.diagonal(A)
    # Absolute floor alongside the relative Levenberg ridge.  Zero
    # diagonals occur in practice (round-5 find): ``jacfwd`` through
    # se3_log's small-angle ``where`` branches returns a ZERO rotation-
    # block derivative at exactly-zero rotation residual (a branch-
    # gradient artifact, not true geometry — the analytic Jacobian is
    # ~identity there), so a node whose every incident edge has exactly
    # zero rotation residual (synthetic axis-aligned graphs; real
    # imagery's jittery rotations mask it) loses those diagonals, the
    # preconditioned Cholesky factors a singular matrix, d goes NaN, and
    # the isfinite guard silently zeroes EVERY step.  With the floor such
    # DOFs simply solve to a zero update — which is also the CORRECT
    # update, since their residuals are exactly zero.  _DIAG_FLOOR must
    # match the preconditioner clamp below: the pair makes a floored
    # row's scaled diagonal exactly 1 (1e-8 * 1/sqrt(1e-8)^2); clamping
    # tighter than the floor would reintroduce an ~1e4 condition spike.
    A = A + jnp.diag(lam * diag + _DIAG_FLOOR)
    # Jacobi preconditioning: the f32 Cholesky of the raw system (mixed
    # translation/rotation scales) loses enough digits to turn a near-zero-
    # residual solve into a random walk.
    D = 1.0 / jnp.sqrt(jnp.maximum(diag, _DIAG_FLOOR))
    As = A * D[:, None] * D[None, :]
    y = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(As), D * g.reshape(6 * n)
    )
    d = (-D * y).reshape(n, 6)
    d = d.at[0].set(0.0)
    d = jnp.where(jnp.all(jnp.isfinite(d)), d, jnp.zeros_like(d))

    cost = jnp.sum(w * jnp.sum(r * r, axis=-1))
    cand = jax.vmap(lie.compose)(xi, d)
    cand_cost = _graph_cost(cand, edges)
    accept = cand_cost < cost
    new_xi = jnp.where(accept, cand, xi)
    new_lam = jnp.clip(jnp.where(accept, lam * 0.25, lam * 4.0), 1e-7, 1e3)
    return new_xi, new_lam, cost


@functools.partial(jax.jit, static_argnames="cfg")
def optimize_pose_graph(
    xi, edges: PoseGraphEdges, cfg: PoseGraphConfig = PoseGraphConfig(),
    n_real=None,
):
    """Refine node twists.  Returns (xi_refined (N,6), costs (iters,)).
    ``n_real``: live-node count when inputs are bucket-padded."""

    def body(carry, _):
        x, lam = carry
        x, lam, cost = pose_graph_step(x, lam, edges, cfg, n_real=n_real)
        return (x, lam), cost

    (xi_out, _), costs = lax.scan(
        body, (xi, jnp.asarray(cfg.damping, jnp.float32)), None,
        length=cfg.iterations,
    )
    return xi_out, costs


def optimize_pose_graph_padded(xi0, e_i, e_j, e_z, e_w,
                               cfg: PoseGraphConfig = PoseGraphConfig(),
                               node_bucket: int = 64,
                               edge_bucket: int = 512):
    """Host-side wrapper: pad nodes/edges up to bucket multiples so the
    jitted solve's shapes only change at bucket boundaries.  The live
    pose-graph refinement grows by a few nodes/edges per firing; unpadded,
    EVERY firing recompiled the whole solve (measured: the dominant cost
    of --pose-graph-every through the CLI; each compile is ~10-20 s, so
    the buckets are sized to cover a typical sequence — 64 keyframes /
    512 edges — with ONE compile, reused across runs by the persistent
    cache).  Padded nodes are identity
    poses with no edges (inert — see pose_graph_step); padded edges are
    weight-0 self-loops on the pinned node (zero contribution).  Takes
    numpy lists/arrays; returns (xi_refined (N,6) numpy, costs numpy)."""
    import numpy as np

    n = len(xi0)
    e = len(e_w)
    n_pad = -(-max(n, 1) // node_bucket) * node_bucket
    e_pad = -(-max(e, 1) // edge_bucket) * edge_bucket
    xi_p = np.zeros((n_pad, 6), np.float32)
    xi_p[:n] = np.asarray(xi0, np.float32)
    i_p = np.zeros(e_pad, np.int32)
    j_p = np.zeros(e_pad, np.int32)
    z_p = np.zeros((e_pad, 6), np.float32)
    w_p = np.zeros(e_pad, np.float32)
    i_p[:e] = np.asarray(e_i, np.int32)
    j_p[:e] = np.asarray(e_j, np.int32)
    z_p[:e] = np.stack(e_z).astype(np.float32) if e else 0
    w_p[:e] = np.asarray(e_w, np.float32)
    edges = PoseGraphEdges(
        i=jnp.asarray(i_p), j=jnp.asarray(j_p),
        z=jnp.asarray(z_p), weight=jnp.asarray(w_p),
    )
    xi_ref, costs = optimize_pose_graph(
        jnp.asarray(xi_p), edges, cfg, n_real=jnp.asarray(n, jnp.int32)
    )
    return np.asarray(xi_ref)[:n], np.asarray(costs)


@jax.jit
def apply_live_correction(state, xi_ref_slot, id_slot, max_id, corr):
    """Write a chunked-driver live refinement into the device VOState.

    The chunked pipeline applies corrections two chunks after the
    triggering promotion (results drain one chunk behind execution), so by
    application time the ring may hold keyframes promoted AFTER the
    refinement was computed.  Slots are therefore addressed by frame
    identity (history.kf_id):

      * kf_id[slot] == id_slot[slot]  -> the slot still holds a refined
        node; take its refined twist (xi_ref_slot, laid out by the
        deterministic push->slot mapping slot = push % capacity);
      * kf_id[slot] > max_id          -> promoted after the refinement;
        move rigidly by the NEWEST refined node's left-correction
        ``corr = T_new @ inv(T_old)`` (its children were tracked relative
        to that node's chain);
      * otherwise (the never-refined init keyframe, or empty)  -> keep.

    The reference keyframe is the ring head, so its corrected twist is
    read back from the updated ring.  Relative state (prev_rel, vel) is
    invariant under the left-multiplication.  Depth/sigma maps are NOT
    re-scaled — see PoseGraphHarvester docstring for the measured bound on
    correction magnitudes."""
    import dataclasses as dc

    hist = state.history
    rigid = jax.vmap(
        lambda x: lie.se3_log(lie.matmul(corr, lie.se3_exp(x)))
    )(hist.xi)
    take_ref = hist.kf_id == id_slot
    take_rigid = hist.kf_id > max_id
    new_xi = jnp.where(
        take_ref[:, None], xi_ref_slot,
        jnp.where(take_rigid[:, None], rigid, hist.xi),
    )
    head_xi = new_xi[hist.head]
    return dc.replace(
        state,
        history=dc.replace(hist, xi=new_xi),
        ref=dc.replace(state.ref, xi=head_xi),
    )


# ----------------------------------------------------------- host-side utils

def chain_edges(kf_xi, weight=1.0):
    """Consecutive-keyframe odometry constraints from the emitted chain
    itself: z_k = log(T_k^-1 T_{k+1}).  These anchor the graph; alone they
    make it exactly consistent (a no-op).  The harvester therefore adds
    ALL-PAIRS BA-window edges (over-constraining the graph even on
    sequences without spatial revisits) and re-tracked loop closures —
    measured on real data (test_posegraph_live_refinement_real_50mm): the
    combination moves a real trajectory by centimetres and improves the
    rig's known straight-line geometry."""
    import numpy as np

    n = kf_xi.shape[0]
    i = np.arange(n - 1, dtype=np.int32)
    j = i + 1
    T = [_nplie.se3_exp(np.asarray(x)) for x in kf_xi]
    z = np.stack([
        _nplie.se3_log(np.linalg.inv(T[a]) @ T[b])
        for a, b in zip(i, j)
    ]).astype(np.float32)
    return i, j, z, np.full(n - 1, weight, np.float32)


def build_edges(i_list, j_list, z_list, w_list) -> PoseGraphEdges:
    """Stack harvested constraint lists into a device PoseGraphEdges."""
    import numpy as np

    return PoseGraphEdges(
        i=jnp.asarray(np.concatenate(i_list).astype(np.int32)),
        j=jnp.asarray(np.concatenate(j_list).astype(np.int32)),
        z=jnp.asarray(np.concatenate(z_list).astype(np.float32)),
        weight=jnp.asarray(np.concatenate(w_list).astype(np.float32)),
    )


@dataclasses.dataclass
class _Node:
    frame_idx: int
    T_emit: "np.ndarray"          # emitted 4x4 world pose at promotion
    gray: "np.ndarray"            # input-resolution gray (host copy)
    mask: "np.ndarray"
    depth: "np.ndarray | None" = None   # refined base-level depth (on retire)
    sigma: "np.ndarray | None" = None


class PoseGraphHarvester:
    """Host-side constraint harvesting during a monocular run.

    Call ``on_frame`` after every ``monocular_step``; call ``finalize`` at
    sequence end to (1) mine loop-closure candidates among spatially-near
    keyframe pairs and re-track them with the ordinary tracker, (2) run the
    global pose-graph GN, and (3) re-emit the refined full trajectory.

    Weights: odometry 1, BA-window 3, re-tracked closure 10 (closures are
    direct photometric alignments, not chained estimates).

    ``refine_every`` > 0 enables PERIODIC refinement: every that-many
    keyframe promotions the graph is re-optimized mid-run — including
    freshly mined loop closures — and the corrections are written back
    into the LIVE keyframe ring (``state.history.xi`` and the reference's
    pose), so drift found mid-sequence repairs the mapping
    geometry that subsequent epipolar updates and BA windows build on, not
    just the emitted file.  ``on_frame`` then returns the corrected state
    (None when nothing changed).
    """

    W_ODOM, W_BA, W_CLOSURE = 1.0, 3.0, 10.0

    def __init__(self, cfg, K, max_closures: int = 16,
                 closure_residual: float = 0.02, verbose: bool = False,
                 refine_every: int = 0, pg_cfg: "PoseGraphConfig" = None):
        import numpy as np  # noqa: F401

        self.cfg = cfg
        self.K = K
        self.max_closures = max_closures
        self.closure_residual = closure_residual
        self.verbose = verbose
        self.refine_every = refine_every
        # One solver config for BOTH the periodic live refinements and the
        # final global pass (round-4 advisor: _refine_live used to ignore
        # the cfg passed to finalize).
        self.pg_cfg = pg_cfg if pg_cfg is not None else PoseGraphConfig()
        self.nodes: list[_Node] = []
        self.e_i, self.e_j, self.e_z, self.e_w = [], [], [], []
        self.closures = 0
        self._closure_pairs: set = set()
        # Candidates already re-tracked and REJECTED: periodic refinement
        # used to re-track them at every firing (measured: a major cost of
        # --pose-graph-every on remote-device hosts).  Geometry changes
        # little between refinements; a rejected pair stays rejected.
        self._tried_pairs: set = set()
        self._closure_prog = None
        self.live_refinements = 0
        # Largest non-rigid relative-pose perturbation any refinement has
        # applied between consecutive live-ring keyframes (the quantity
        # that bounds ring-depth staleness — see _refine_nodes docstring).
        self.max_rel_corr_t = 0.0   # metres
        self.max_rel_corr_r = 0.0   # degrees
        # Deferred ring snapshots that arrived stale (slot overwritten
        # before the chunk-end fetch — see absorb_ring).
        self.stale_snaps = 0
        # Chunked-driver bookkeeping (on_chunk_row/absorb_ring): ring pushes
        # seen so far (the init keyframe is push 0) and deferred
        # (node_index, ring_slot) depth/sigma snapshot requests.
        self._pushes = 1
        self._pending_snaps: list = []

    # ------------------------------------------------------------- harvest

    def on_frame(self, frame_idx, res, state, gray, mask):
        """Harvest constraints from this frame's StepResult.  Returns a
        corrected VOState when a periodic live refinement fired (the caller
        should continue with it), else None."""
        import numpy as np

        if not bool(res.is_keyframe):
            return None
        node = _Node(
            frame_idx=frame_idx,
            T_emit=np.asarray(res.T_world),
            gray=np.asarray(gray),
            mask=np.asarray(mask),
        )
        if self.nodes:
            # Odometry edge: the tracked relative pose IS log(T_i^-1 T_j)
            # (with_pose composes xi = ref_xi o relative_xi, frame.py).
            self.e_i.append(len(self.nodes) - 1)
            self.e_j.append(len(self.nodes))
            self.e_z.append(np.asarray(res.relative_xi))
            self.e_w.append(self.W_ODOM)
            # The outgoing keyframe retired at this promotion: snapshot its
            # final refined depth/sigma from its ring slot for closure
            # re-tracking.
            hist = state.history
            slot = int((np.asarray(hist.head) - 1) % hist.capacity)
            prev = self.nodes[-1]
            prev.depth = np.asarray(hist.depth[slot])
            prev.sigma = np.asarray(hist.sigma[slot])
        self.nodes.append(node)

        # BA-window edges: refined relative poses between ALL pairs in the
        # window (not consecutive-only — all-pairs edges over-constrain the
        # graph, so refinement has corrective power even on sequences with
        # no spatial revisits).
        if float(res.ba_cost) >= 0.0 and self.cfg.ba.enabled:
            hist = state.history
            xi_all = np.asarray(hist.xi)
            head = int(np.asarray(hist.head))
            m = min(self.cfg.ba.window, len(self.nodes))
            Ts = {}
            for a in range(m):
                s = (head - (m - 1 - a)) % hist.capacity
                Ts[a] = _nplie.se3_exp(xi_all[s])
            for a in range(m - 1):
                n0 = len(self.nodes) - m + a
                if n0 < 0:
                    continue
                for b in range(a + 1, m):
                    n1 = len(self.nodes) - m + b
                    z = _nplie.se3_log(np.linalg.inv(Ts[a]) @ Ts[b])
                    self.e_i.append(n0)
                    self.e_j.append(n1)
                    self.e_z.append(z.astype(np.float32))
                    self.e_w.append(self.W_BA)

        # Periodic live refinement (module docstring).
        if (
            self.refine_every > 0
            and len(self.nodes) >= 4
            and len(self.nodes) % self.refine_every == 0
        ):
            return self._refine_live(state)
        return None

    # ------------------------------------------- harvest (chunked driver)

    def on_chunk_row(self, frame_idx, row, gray, mask, T_emit=None):
        """Chunked-driver analog of ``on_frame`` for a KEYFRAME StepResult
        row (utils.runner feeds these while draining chunk results; round-4
        forced --pose-graph onto the per-frame path).  Differences from the
        per-frame entry: the retiring keyframe's depth/sigma snapshot is
        DEFERRED (the live ring is on device; the runner fetches it once
        per chunk and calls ``absorb_ring``), and BA edges come from
        ``row.ba_window_xi`` — the refined window poses AT this promotion,
        which the chunk-end ring no longer holds once later promotions
        re-ran BA.  Returns True when a periodic live refinement is due
        (the caller refines after absorbing this chunk's ring)."""
        import numpy as np

        cap = self.cfg.mapper.history_capacity
        node = _Node(
            frame_idx=frame_idx,
            # T_emit: the (possibly retro-corrected) pose the runner
            # emitted for this frame; defaults to the raw row pose.
            T_emit=(np.asarray(T_emit) if T_emit is not None
                    else np.asarray(row.T_world)).copy(),
            gray=np.asarray(gray).copy(),
            mask=np.asarray(mask).copy(),
        )
        if self.nodes:
            self.e_i.append(len(self.nodes) - 1)
            self.e_j.append(len(self.nodes))
            self.e_z.append(np.asarray(row.relative_xi))
            self.e_w.append(self.W_ODOM)
            # The outgoing keyframe retired at this promotion; its slot is
            # the previous push's (pushes are the only head movement,
            # models/history.push).
            self._pending_snaps.append(
                (len(self.nodes) - 1, (self._pushes - 1) % cap)
            )
        self._pushes += 1
        self.nodes.append(node)

        if float(row.ba_cost) >= 0.0 and self.cfg.ba.enabled:
            win = np.asarray(row.ba_window_xi)
            m = min(len(win), len(self.nodes))
            Ts = [
                _nplie.se3_exp(win[len(win) - m + a]) for a in range(m)
            ]
            for a in range(m - 1):
                n0 = len(self.nodes) - m + a
                if n0 < 0:
                    continue
                for b in range(a + 1, m):
                    n1 = len(self.nodes) - m + b
                    z = _nplie.se3_log(np.linalg.inv(Ts[a]) @ Ts[b])
                    self.e_i.append(n0)
                    self.e_j.append(n1)
                    self.e_z.append(z.astype(np.float32))
                    self.e_w.append(self.W_BA)

        return (
            self.refine_every > 0
            and len(self.nodes) >= 4
            and len(self.nodes) % self.refine_every == 0
        )

    def absorb_ring(self, ring_depth, ring_sigma, ring_kf_id=None):
        """Resolve deferred depth/sigma snapshots from a host copy of the
        keyframe ring (fetched once per chunk).  A slot is only valid if
        it still holds the retired keyframe — a chunk that promotes more
        keyframes than the ring's capacity overwrites early retirements
        before the chunk-end fetch — so ``ring_kf_id`` (when provided) is
        checked against the node's frame id; stale slots leave the node
        without a depth snapshot (it is then simply skipped by closure
        mining, a graceful degradation counted in ``stale_snaps``)."""
        import numpy as np

        for node_idx, slot in self._pending_snaps:
            if ring_kf_id is not None:
                expect = self.nodes[node_idx].frame_idx
                if int(ring_kf_id[slot]) != int(expect):
                    self.stale_snaps += 1
                    continue
            self.nodes[node_idx].depth = np.asarray(ring_depth[slot]).copy()
            self.nodes[node_idx].sigma = np.asarray(ring_sigma[slot]).copy()
        self._pending_snaps = []

    def refine_live_chunked(self):
        """Chunked-mode periodic refinement: mine closures + optimize over
        the harvested nodes (``absorb_ring`` must have run).  Returns
        ``(xi_ref (M,6), corr (4,4))`` — the refined node twists and the
        NEWEST node's left-correction ``T_new @ inv(T_old)`` — or None.
        The runner owns application: ring/ref write-back on device (older
        slots take their node's refined pose, slots pushed since take the
        rigid ``corr``) and retroactive trajectory fixing (frames emitted
        since the newest refined keyframe composed from its OLD pose)."""
        import numpy as np

        t_old = self.nodes[-1].T_emit.copy()
        xi_ref = self._refine_nodes(track_bound=True)
        if xi_ref is None:
            return None
        corr = self.nodes[-1].T_emit @ np.linalg.inv(t_old)
        self.live_refinements += 1
        if self.verbose:
            print(
                f"pose-graph live refinement #{self.live_refinements} "
                f"(chunked): {len(self.nodes)} nodes, {len(self.e_w)} "
                f"edges, {self.closures} closures"
            )
        return xi_ref, corr

    # ------------------------------------------------------------ closures

    def _mine_closures(self):
        import numpy as np
        from dvo_tpu.models.tracker import track

        n = len(self.nodes)
        if n < 4:
            return
        ts = np.stack([nd.T_emit[:3, 3] for nd in self.nodes])
        Rs = [nd.T_emit[:3, :3] for nd in self.nodes]
        step = np.linalg.norm(np.diff(ts, axis=0), axis=1)
        radius = max(2.0 * float(np.median(step)), 1e-3)
        cands = []
        for i in range(n):
            if self.nodes[i].depth is None:
                continue
            for j in range(i + 3, n):
                d = float(np.linalg.norm(ts[i] - ts[j]))
                if d > radius:
                    continue
                ang = np.arccos(
                    np.clip((np.trace(Rs[i].T @ Rs[j]) - 1) / 2, -1, 1)
                )
                if ang > np.deg2rad(45):
                    continue
                cands.append((d, i, j))
        cands.sort()
        cands = cands[: self.max_closures]
        if not cands:
            return

        # ONE jitted program per candidate: frame builds + the re-track
        # fused, instead of eager per-op dispatch of the builds.  Compiled
        # once per node shape; results fetched in a single packed transfer.
        if self._closure_prog is None:
            t_cfg = self.cfg.tracker
            levels = self.cfg.pyramid.levels

            from dvo_tpu.models.frame import build_frame_with_depth

            @jax.jit
            def closure_prog(g_i, m_i, d_i, s_i, g_j, m_j, K):
                ref = build_frame_with_depth(g_i, m_i, d_i, s_i, K,
                                             levels, 0, 0)
                # Obj depth is unused by tracking; reuse the ref node's map.
                obj = build_frame_with_depth(g_j, m_j, d_i, s_i, K,
                                             levels, 0, 1)
                tr = track(obj, ref, t_cfg)
                it = tr.iterations[-1]
                resid = tr.residuals[-1, jnp.maximum(it - 1, 0)]
                return jnp.concatenate([tr.xi, resid[None]])

            self._closure_prog = closure_prog

        s = 2 ** self.cfg.pyramid.culls
        K = np.asarray(self.K, np.float32).copy() / s
        K[2, 2] = 1.0
        K = jnp.asarray(K)
        for d, i, j in cands:
            if (i, j) in self._closure_pairs or (i, j) in self._tried_pairs:
                continue
            self._tried_pairs.add((i, j))
            ni, nj = self.nodes[i], self.nodes[j]
            out = np.asarray(self._closure_prog(
                jnp.asarray(ni.gray[::s, ::s]), jnp.asarray(ni.mask[::s, ::s]),
                jnp.asarray(ni.depth), jnp.asarray(ni.sigma),
                jnp.asarray(nj.gray[::s, ::s]), jnp.asarray(nj.mask[::s, ::s]),
                K,
            ))
            xi, resid = out[:6], float(out[6])
            if not (0.0 <= resid < self.closure_residual):
                continue
            self.e_i.append(i)
            self.e_j.append(j)
            self.e_z.append(xi.astype(np.float32))
            self.e_w.append(self.W_CLOSURE)
            self._closure_pairs.add((i, j))
            self.closures += 1
            if self.verbose:
                print(f"closure {i}->{j} dist={d:.3f} resid={resid:.4f}")

    # ------------------------------------------------------ live refinement

    def _refine_nodes(self, track_bound: bool = False):
        """Shared refinement core: mine closures over the harvested nodes,
        optimize the graph with ``self.pg_cfg``, and move every node's
        T_emit to its refined estimate.  Returns the refined (M, 6) twists
        as numpy, or None when there is nothing to refine (no edges /
        non-finite solve).

        Depth-consistency invariant: a live
        write-back corrects ring POSES but not ring depth/sigma.  Depth
        maps are per-keyframe local (range along the keyframe's own rays),
        so they are exactly invariant under any RIGID move of the whole
        chain; only the NON-RIGID part — the change in relative pose
        between consecutive ring keyframes — perturbs the geometry that
        epipolar updates and BA assumed when fusing them.  That part is
        tracked here per refinement (``max_rel_corr_t`` metres /
        ``max_rel_corr_r`` degrees, max over consecutive live-ring pairs)
        and gated on real imagery
        (tests/test_accuracy.py::test_posegraph_live_refinement_real_50mm:
        millimetre-scale, i.e. within the depth filter's own sigma), so no
        depth re-scale is needed at these magnitudes."""
        import numpy as np

        self._mine_closures()
        if not self.e_w:
            return None
        cap = self.cfg.mapper.history_capacity
        T_before = [nd.T_emit.copy() for nd in self.nodes[-(cap + 1):]]
        xi0 = np.stack([
            _nplie.se3_log(nd.T_emit) for nd in self.nodes
        ]).astype(np.float32)
        xi_ref, _costs = optimize_pose_graph_padded(
            xi0, self.e_i, self.e_j, self.e_z, self.e_w, self.pg_cfg
        )
        if not np.all(np.isfinite(xi_ref)):
            return None
        # Node poses move to the refined estimates (closure mining and the
        # final global pass both start from here).
        for nd, x in zip(self.nodes, xi_ref):
            nd.T_emit = _nplie.se3_exp(x).astype(np.float32)
        # Non-rigid perturbation bound (docstring): per consecutive pair
        # in the live window, delta = inv(rel_old) @ rel_new.
        T_after = [nd.T_emit for nd in self.nodes[-(cap + 1):]]
        for a in range(len(T_before) - 1 if track_bound else 0):
            rel_old = np.linalg.inv(T_before[a]) @ T_before[a + 1]
            rel_new = np.linalg.inv(T_after[a]) @ T_after[a + 1]
            d = np.linalg.inv(rel_old) @ rel_new
            dt = float(np.linalg.norm(d[:3, 3]))
            dr = float(np.degrees(np.arccos(
                np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)
            )))
            self.max_rel_corr_t = max(self.max_rel_corr_t, dt)
            self.max_rel_corr_r = max(self.max_rel_corr_r, dr)
        return xi_ref

    def _refine_live(self, state):
        """Periodic mid-run refinement (per-frame driver): mine closures
        over the nodes so far, optimize the graph, and write the
        corrections back into the LIVE keyframe ring (history.xi + the
        reference keyframe's pose) so subsequent tracking, mapping, and BA
        build on corrected geometry.  Returns the corrected VOState, or
        None when there is nothing to correct."""
        import dataclasses as dc

        import numpy as np

        xi_ref = self._refine_nodes(track_bound=True)
        if xi_ref is None:
            return None
        # Write back into the live ring: the newest min(count, capacity)
        # nodes occupy slots head, head-1, ... (history.born_slot layout).
        hist = state.history
        head = int(np.asarray(hist.head))
        live = min(int(np.asarray(hist.count)), len(self.nodes))
        xi_arr = np.asarray(hist.xi).copy()
        for k in range(live):
            slot = (head - k) % hist.capacity
            xi_arr[slot] = xi_ref[len(self.nodes) - 1 - k]
        self.live_refinements += 1
        if self.verbose:
            print(
                f"pose-graph live refinement #{self.live_refinements}: "
                f"{len(self.nodes)} nodes, {len(self.e_w)} edges, "
                f"{self.closures} closures"
            )
        return dc.replace(
            state,
            history=dc.replace(hist, xi=jnp.asarray(xi_arr)),
            ref=dc.replace(state.ref, xi=jnp.asarray(xi_ref[-1])),
        )

    # ------------------------------------------------------------ finalize

    def finalize(self, times, poses, state=None,
                 pg_cfg: PoseGraphConfig = None):
        """Mine closures, optimize, and return the refined (N, 4, 4)
        trajectory (the input when fewer than 2 keyframes exist)."""
        import numpy as np

        if len(self.nodes) < 2:
            return np.asarray(poses), np.zeros(0, np.float32)
        # The newest keyframe never retired: snapshot it from the live ring.
        if state is not None and self.nodes[-1].depth is None:
            hist = state.history
            slot = int(np.asarray(hist.head))
            self.nodes[-1].depth = np.asarray(hist.depth[slot])
            self.nodes[-1].sigma = np.asarray(hist.sigma[slot])
        self._mine_closures()

        xi0 = np.stack([
            _nplie.se3_log(nd.T_emit) for nd in self.nodes
        ]).astype(np.float32)
        xi_ref, costs = optimize_pose_graph_padded(
            xi0, self.e_i, self.e_j, self.e_z, self.e_w,
            pg_cfg if pg_cfg is not None else self.pg_cfg,
        )
        refined = apply_refinement(
            times, poses, [nd.frame_idx for nd in self.nodes],
            np.asarray(xi_ref),
        )
        return refined, np.asarray(costs)


def apply_refinement(times, poses, kf_frame_idx, kf_xi_refined):
    """Re-emit a full trajectory after pose-graph refinement: each frame's
    pose is corrected by its most recent keyframe's correction,
    T'_f = T'_kf (T_kf^-1 T_f) — relative motion since the keyframe is
    trusted as tracked.  ``poses``: (N,4,4) original; ``kf_frame_idx``:
    frame index of each keyframe node; ``kf_xi_refined``: (M,6).
    Returns (N,4,4)."""
    import numpy as np

    poses = np.asarray(poses)
    out = poses.copy()
    kf_T_new = [_nplie.se3_exp(np.asarray(x)) for x in kf_xi_refined]
    kf_idx = list(kf_frame_idx)
    cur = -1
    for f in range(len(poses)):
        while cur + 1 < len(kf_idx) and kf_idx[cur + 1] <= f:
            cur += 1
        if cur < 0:
            continue
        base = kf_idx[cur]
        corr = kf_T_new[cur] @ np.linalg.inv(poses[base])
        out[f] = corr @ poses[f]
    return out
