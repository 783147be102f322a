"""SE(3) pose-graph optimization (PGO) as one jitted batched Gauss-Newton.

Capability parity with the reference's global optimization stage — an
external srrg2_solver ``Solver`` (10 GN iterations, sparse block Cholesky,
RobustifierSaturated policy) over local-map SE3 variables and closure
factors (reference srrg2_proslam configurations/kitti.conf:420-444, usage
graph()->addVariable/addFactor at tests/test_loop_closing.cpp:9-17) —
redesigned accelerator-first:

  * the factor graph is a fixed-capacity edge array (i, j, Z_ij, weight,
    mask), never pointer-wired objects;
  * residuals/Jacobians of ALL factors are evaluated in one batch:
    e = log(Z^-1 T_i^-1 T_j), with the small-residual adjoint Jacobians
    J_j = Ad(Z^-1 T_i^-1), J_i = -J_j (left perturbation T <- exp(eps) T);
  * the normal equations are scatter-added into a dense [6N, 6N] H — for
    the local-map counts of this system (tens to low hundreds) a dense
    on-chip Cholesky beats any sparse structure, and the batched residual
    reduction is psum-ready for factor-sharded multi-device execution
    (parallel/).

Gauge freedom is fixed by an identity prior on pose 0 (the reference
anchors the first local map instead of removing it from the system).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import config as cfg
from . import se3


@cfg.register
class PGOConfig:
    """Mirrors the reference global Solver setup (kitti.conf:420-444)."""

    iterations: int = 10
    damping: float = 1e-3
    chi_threshold: float = 25.0     # RobustifierSaturated policy
    anchor_weight: float = 1e6      # gauge prior on pose 0
    # linear solver: "dense" Cholesky-style solve of the full 6Nx6N system
    # (exact; fine to ~512 poses) or matrix-free "cg" with a block-Jacobi
    # preconditioner (memory O(E) instead of O(N^2); scales to very large
    # graphs and its matvec is a factor-sharded psum)
    solver: str = "dense"
    cg_iterations: int = 100
    cg_tolerance: float = 1e-6
    # trust-region safeguard: each pose's update is clamped to this twist
    # norm per GN iteration.  Large graphs with accumulated loop error
    # otherwise produce Newton steps (hundreds of meters) far outside the
    # linearization's validity and diverge.  Clamping per pose (not globally)
    # keeps one far-off pose from throttling progress everywhere else.
    max_step: float = 1.0


class PoseGraph(NamedTuple):
    """Fixed-capacity SE3 pose graph.

    poses: [N, 4, 4] variable estimates (world_from_localmap);
    edges_*: [E] factor arrays with Z = measured j_in_i.
    """

    poses: jnp.ndarray          # [N, 4, 4]
    pose_valid: jnp.ndarray     # [N] bool
    edge_i: jnp.ndarray         # [E] int32
    edge_j: jnp.ndarray         # [E] int32
    edge_Z: jnp.ndarray         # [E, 4, 4] measured T_i^-1 T_j
    edge_weight: jnp.ndarray    # [E] float32 information scale
    edge_valid: jnp.ndarray     # [E] bool

    @property
    def capacity(self):
        return self.poses.shape[0]

    @property
    def edge_capacity(self):
        return self.edge_i.shape[0]


def empty_graph(num_poses: int, num_edges: int) -> PoseGraph:
    return PoseGraph(
        poses=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (num_poses, 4, 4)),
        pose_valid=jnp.zeros((num_poses,), bool),
        edge_i=jnp.zeros((num_edges,), jnp.int32),
        edge_j=jnp.zeros((num_edges,), jnp.int32),
        edge_Z=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (num_edges, 4, 4)),
        edge_weight=jnp.zeros((num_edges,), jnp.float32),
        edge_valid=jnp.zeros((num_edges,), bool),
    )


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) adjoint for twist order [v, w]: [[R, [t]x R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = se3.skew(t) @ R
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def factor_terms(poses: jnp.ndarray, graph: PoseGraph, chi_threshold: float):
    """Batched residuals + adjoint Jacobians for all edges.

    Returns (e [E,6], A [E,6,6], w [E]) with A = Ad(Z^-1 T_i^-1); the
    robust weight folds the saturated kernel and the edge information scale.
    """
    Ti = poses[graph.edge_i]
    Tj = poses[graph.edge_j]
    M = se3.inverse(graph.edge_Z) @ se3.inverse(Ti) @ Tj
    e = se3.log(M)
    A = adjoint(se3.inverse(graph.edge_Z) @ se3.inverse(Ti))
    chi = jnp.sum(e * e, axis=-1) * graph.edge_weight
    kw = jnp.minimum(1.0, chi_threshold / jnp.maximum(chi, 1e-12))
    w = jnp.where(graph.edge_valid, graph.edge_weight * kw, 0.0)
    return e, A, w, chi


def _edge_blocks(poses, graph: PoseGraph, chi_threshold: float):
    """Per-edge weighted block AtA [E,6,6] and gradient terms Ate [E,6].

    Shared assembly for the dense and CG solver paths (a robustifier change
    lands in both automatically).
    """
    e, A, w, chi = factor_terms(poses, graph, chi_threshold)
    AtA = jnp.einsum("eki,ekj,e->eij", A, A, w)
    Ate = jnp.einsum("eki,ek,e->ei", A, e, w)
    chi_total = jnp.sum(jnp.where(graph.edge_valid,
                                  jnp.minimum(chi, chi_threshold), 0.0))
    return AtA, Ate, chi_total


def _prior_diag(graph: PoseGraph, anchor_weight: float):
    """Gauge anchor on pose 0 + tiny prior on invalid poses (keeps H SPD)."""
    N = graph.capacity
    return jnp.where(jnp.arange(N) == 0, anchor_weight,
                     jnp.where(graph.pose_valid, 0.0, 1.0))


def normal_equations(poses: jnp.ndarray, graph: PoseGraph,
                     chi_threshold: float, anchor_weight: float):
    """Assemble the dense [6N, 6N] GN system by block scatter-add.

    Factor-sharded callers psum the returned (H, b) — the reduction is a
    plain sum over edges.
    """
    N = graph.capacity
    # block contributions: H_ii += A^T A, H_jj += A^T A, H_ij -= A^T A
    AtA, Ate, chi_total = _edge_blocks(poses, graph, chi_threshold)

    H = jnp.zeros((N, N, 6, 6), jnp.float32)
    H = H.at[graph.edge_i, graph.edge_i].add(AtA)
    H = H.at[graph.edge_j, graph.edge_j].add(AtA)
    H = H.at[graph.edge_i, graph.edge_j].add(-AtA)
    H = H.at[graph.edge_j, graph.edge_i].add(-AtA)
    b = jnp.zeros((N, 6), jnp.float32)
    b = b.at[graph.edge_j].add(Ate)
    b = b.at[graph.edge_i].add(-Ate)

    prior = _prior_diag(graph, anchor_weight)
    H = H.at[jnp.arange(N), jnp.arange(N)].add(
        prior[:, None, None] * jnp.eye(6)
    )
    return H, b, chi_total


def _solve_cg(graph: PoseGraph, AtA, b, prior, damping: float,
              iterations: int, tolerance: float):
    """Matrix-free preconditioned CG on the graph Laplacian-like system.

    The matvec is two gathers + one segment scatter over the edge list —
    memory O(E) (never materializing the [N,N,6,6] Hessian) and, with the
    edge arrays sharded across a mesh, a psum-reduced collective: the
    large-graph path the dense solve cannot take.
    """
    N = graph.capacity
    i_idx, j_idx = graph.edge_i, graph.edge_j

    def matvec(x):
        d = x[i_idx] - x[j_idx]
        t = jnp.einsum("eij,ej->ei", AtA, d)
        y = jnp.zeros((N, 6), jnp.float32).at[i_idx].add(t).at[j_idx].add(-t)
        return y + (prior + damping)[:, None] * x

    # block-Jacobi preconditioner: per-pose 6x6 diagonal blocks
    D = jnp.zeros((N, 6, 6), jnp.float32).at[i_idx].add(AtA).at[j_idx].add(AtA)
    D = D + (prior + damping)[:, None, None] * jnp.eye(6)
    D_inv = jnp.linalg.inv(D)

    def precond(r):
        return jnp.einsum("nij,nj->ni", D_inv, r)

    x0 = jnp.zeros((N, 6), jnp.float32)
    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    b_norm2 = jnp.maximum(jnp.sum(b * b), 1e-30)

    def cond(carry):
        _, r, _, _ = carry
        return jnp.sum(r * r) > tolerance * tolerance * b_norm2

    def body(carry):
        x, r, p, rz = carry
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(jnp.abs(denom) < 1e-30, 0.0, rz / denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 1e-30, rz_new / rz, 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    # bounded while_loop: exits as soon as the residual passes the tolerance
    # instead of paying a full matvec + preconditioner apply per remaining
    # iteration (iteration counter folded into the residual check is not
    # needed — fori over while keeps the trip count <= iterations)
    def outer(i, carry):
        return jax.lax.cond(cond(carry), body, lambda c: c, carry)

    x, _, _, _ = jax.lax.fori_loop(0, iterations, outer, (x0, r0, p0, rz0))
    return x


@partial(jax.jit, static_argnames="config")
def optimize(graph: PoseGraph, config: PGOConfig):
    """Run ``config.iterations`` GN steps; returns (graph', chi_final)."""
    N = graph.capacity

    def dense_step(poses):
        H, b, chi = normal_equations(
            poses, graph, config.chi_threshold, config.anchor_weight
        )
        Hd = H.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
        Hd = Hd + config.damping * jnp.eye(6 * N)
        # symmetric Jacobi scaling: the anchor prior plus a long chain makes
        # cond(H) exceed f32 otherwise (observed divergence at N=256)
        s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(Hd), 1e-12))
        Hs = Hd * s[:, None] * s[None, :]
        dx = -(s * jnp.linalg.solve(Hs, s * b.reshape(-1))).reshape(N, 6)
        return dx, chi

    def cg_step(poses):
        AtA, Ate, chi = _edge_blocks(poses, graph, config.chi_threshold)
        b = jnp.zeros((N, 6)).at[graph.edge_j].add(Ate) \
                             .at[graph.edge_i].add(-Ate)
        prior = _prior_diag(graph, config.anchor_weight)
        dx = _solve_cg(graph, AtA, -b, prior, config.damping,
                       config.cg_iterations, config.cg_tolerance)
        return dx, chi

    if config.solver not in ("dense", "cg"):
        raise ValueError(
            f"PGOConfig.solver must be 'dense' or 'cg', got {config.solver!r}"
        )
    step = cg_step if config.solver == "cg" else dense_step

    def body(_, carry):
        poses, _ = carry
        dx, chi = step(poses)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        # trust region: clamp each pose's twist to max_step individually so
        # one far-off pose does not throttle the rest of the graph
        norms = jnp.linalg.norm(dx, axis=-1, keepdims=True)
        dx = dx * jnp.minimum(1.0, config.max_step / jnp.maximum(norms, 1e-12))
        new_poses = jax.vmap(lambda d, T: se3.exp(d) @ T)(dx, poses)
        return new_poses, chi

    poses, chi = jax.lax.fori_loop(
        0, config.iterations, body, (graph.poses, jnp.float32(0))
    )
    return graph._replace(poses=poses), chi


def edge_t_residuals(graph: PoseGraph) -> jnp.ndarray:
    """Per-factor translational residual (meters) at the current poses, [E].

    The closure-acceptance backstop's statistic (models/loop_closure.py
    ``backstop_max_edge_residual``), read two ways after the speculative
    PGO: (a) each NEW closure edge's own residual — the robustified solver
    leaves a false closure unsatisfied (its edge keeps a large residual)
    while a true one converges onto its measurement; (b) the mean over the
    PRE-EXISTING factors — a lone false closure the solver DID follow
    bends the whole chain against its own odometry.
    """
    Ti = graph.poses[graph.edge_i]
    Tj = graph.poses[graph.edge_j]
    M = se3.inverse(graph.edge_Z) @ se3.inverse(Ti) @ Tj
    return jnp.linalg.norm(M[..., :3, 3], axis=-1)


def mean_edge_residual(graph: PoseGraph, edge_mask: jnp.ndarray) -> jnp.ndarray:
    """Mean translational factor residual (meters) over masked valid edges."""
    t_err = edge_t_residuals(graph)
    w = graph.edge_valid & edge_mask
    return (jnp.sum(jnp.where(w, t_err, 0.0))
            / jnp.maximum(jnp.sum(w), 1))


def grow(graph: PoseGraph, pose_capacity: int, edge_capacity: int) -> PoseGraph:
    """Return a copy with enlarged capacities (double-and-copy semantics).

    Host-side capacity lifecycle: long sequences outgrow the initial
    fixed-capacity arrays, and the orchestrator grows them instead of
    crashing (the reference's pointer-graph grows implicitly).
    """
    n_old, e_old = graph.capacity, graph.edge_capacity
    n_new = max(pose_capacity, n_old)
    e_new = max(edge_capacity, e_old)
    if n_new == n_old and e_new == e_old:
        return graph
    out = empty_graph(n_new, e_new)
    return out._replace(
        poses=out.poses.at[:n_old].set(graph.poses),
        pose_valid=out.pose_valid.at[:n_old].set(graph.pose_valid),
        edge_i=out.edge_i.at[:e_old].set(graph.edge_i),
        edge_j=out.edge_j.at[:e_old].set(graph.edge_j),
        edge_Z=out.edge_Z.at[:e_old].set(graph.edge_Z),
        edge_weight=out.edge_weight.at[:e_old].set(graph.edge_weight),
        edge_valid=out.edge_valid.at[:e_old].set(graph.edge_valid),
    )


def add_pose(graph: PoseGraph, index, T: jnp.ndarray) -> PoseGraph:
    return graph._replace(
        poses=graph.poses.at[index].set(T),
        pose_valid=graph.pose_valid.at[index].set(True),
    )


def add_edge(graph: PoseGraph, slot, i, j, Z: jnp.ndarray,
             weight: float = 1.0) -> PoseGraph:
    return graph._replace(
        edge_i=graph.edge_i.at[slot].set(i),
        edge_j=graph.edge_j.at[slot].set(j),
        edge_Z=graph.edge_Z.at[slot].set(Z),
        edge_weight=graph.edge_weight.at[slot].set(weight),
        edge_valid=graph.edge_valid.at[slot].set(True),
    )
