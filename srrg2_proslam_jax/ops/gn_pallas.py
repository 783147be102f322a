"""Fused Gauss-Newton burst as ONE Pallas kernel (Triton route, GPU).

The tracker's alignment is a serial chain of tiny dependent steps: per
iteration a residual/Jacobian sweep over ~1k correspondences, a (H, b)
reduction, a damped 6x6 solve and an SE3 exp-compose (reference solver
loop: srrg2_solver iterations driven by MultiAligner3DQR, SURVEY.md §3.3).
As XLA ops every iteration is several kernel launches, and with a positive
``epsilon`` the loop is a ``lax.while_loop`` whose predicate the GPU reads
back on the host each iteration.  The arithmetic is a few µs on one SM, so
the chain is bound by launches and syncs.

This kernel runs the WHOLE burst in one program (one block, one launch):

  * the 8 correspondence planes (x, y, z, zu_l, zv, zu_r, weight, mask)
    are swept in ``_TILE``-wide tiles per iteration, accumulating the 21
    unique H entries, the 6 of b and 3 statistics as per-lane partial sums
    that are reduced across the block once per iteration;
  * the damped 6x6 solve is a scalar Cholesky after Jacobi scaling of H by
    its diagonal (the scaled system has unit diagonal, so the f32 pivots
    stay O(1) whatever the magnitude of the weights); a non-positive pivot
    gives a NaN step that the degenerate-solve guard zeroes, like the XLA
    path's ``gn_step_dx``;
  * SE3 exp/compose run on scalars with the f32-stable coefficient forms of
    ops/se3.py;
  * termination carries the sticky stop flag of ``gn_iterate(unroll=True)``:
    once the applied twist drops below epsilon no further update applies,
    which is also what the early-exit ``while_loop`` returns.

Only the rectified-stereo factor (the production tracker's hot slice) is
fused; other factors and the vmapped loop-closure validation keep the XLA
path (ops/gn.py), which stays the reference (tests/test_gn_pallas.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .gn import GNStats
from .pinhole import Camera

_TILE = 256     # lanes per sweep step: 1 element per thread at 8 warps
_NUM_WARPS = 8


def _cholesky_solve6(H, b, damping):
    """dx = -(H + damping I)^-1 b on scalars, Jacobi-scaled Cholesky.

    H: 6x6 nested lists (symmetric), b: list of 6.
    """
    s = [jax.lax.rsqrt(H[i][i] + damping) for i in range(6)]
    A = [[H[i][j] * s[i] * s[j] for j in range(6)] for i in range(6)]
    for i in range(6):
        A[i][i] = A[i][i] + damping * s[i] * s[i]
    L = [[None] * 6 for _ in range(6)]
    inv_diag = [None] * 6
    for j in range(6):
        d = A[j][j] - sum(L[j][k] * L[j][k] for k in range(j))
        ljj = jnp.sqrt(d)      # NaN on a non-positive pivot -> guarded
        inv_diag[j] = 1.0 / ljj
        for i in range(j + 1, 6):
            L[i][j] = (A[i][j] - sum(L[i][k] * L[j][k] for k in range(j))
                       ) * inv_diag[j]
    y = [None] * 6
    for i in range(6):
        y[i] = (b[i] * s[i] - sum(L[i][k] * y[k] for k in range(i))
                ) * inv_diag[i]
    z = [None] * 6
    for i in reversed(range(6)):
        z[i] = (y[i] - sum(L[k][i] * z[k] for k in range(i + 1, 6))
                ) * inv_diag[i]
    return [-z[i] * s[i] for i in range(6)]


def _exp_coeffs(theta2):
    """f32-stable A, B, C of se3 exp (ops/se3.py::_exp_coefficients)."""
    eps = 1e-8
    theta = jnp.sqrt(theta2 + eps)
    small = theta2 < 1e-2
    A = jnp.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                  jnp.sin(theta) / theta)
    half_sin = jnp.sin(0.5 * theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                  2.0 * half_sin * half_sin / (theta2 + eps))
    C = jnp.where(small,
                  1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                  (theta - jnp.sin(theta)) / (theta2 * theta + eps))
    return A, B, C


def _mat3_vec(m, v):
    return [m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2]
            for i in range(3)]


def _exp_compose(dx, Xr, Xt):
    """(exp(dx) @ X) on scalars: Xr rows 3x3, Xt list of 3."""
    v, w = dx[:3], dx[3:]
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    A, B, C = _exp_coeffs(theta2)
    zero = jnp.zeros_like(theta2)
    W = [[zero, -w[2], w[1]], [w[2], zero, -w[0]], [-w[1], w[0], zero]]
    W2 = [[sum(W[i][k] * W[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    Rd = [[eye[i][j] + A * W[i][j] + B * W2[i][j] for j in range(3)]
          for i in range(3)]
    Vm = [[eye[i][j] + B * W[i][j] + C * W2[i][j] for j in range(3)]
          for i in range(3)]
    td = _mat3_vec(Vm, v)
    Rn = [[sum(Rd[i][k] * Xr[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    tn = [sum(Rd[i][k] * Xt[k] for k in range(3)) + td[i] for i in range(3)]
    return Rn, tn


# upper-triangle (i, j) pairs of H, then b, then (chi, inliers, terms)
_H_PAIRS = [(i, j) for i in range(6) for j in range(i, 6)]
_N_ACC = len(_H_PAIRS) + 6 + 3


def _make_kernel(cam: Camera, n_tiles: int, iterations: int, damping: float,
                 min_inliers: int, epsilon: float, chi_threshold: float):
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    bpx = float(cam.baseline_px)
    range_min = float(cam.range_min)

    def sweep(planes_ref, Xr, Xt):
        """Per-lane partial sums of H, b and the stats over all tiles."""
        def tile(t, accs):
            sl = pl.ds(pl.multiple_of(t * _TILE, _TILE), _TILE)
            x, y, z, m0, m1, m2, w_in, mask = (
                planes_ref[k, sl] for k in range(8))
            px = Xr[0][0] * x + Xr[0][1] * y + Xr[0][2] * z + Xt[0]
            py = Xr[1][0] * x + Xr[1][1] * y + Xr[1][2] * z + Xt[1]
            pz = Xr[2][0] * x + Xr[2][1] * y + Xr[2][2] * z + Xt[2]
            iz = 1.0 / jnp.maximum(pz, 1e-3)
            iz2 = iz * iz
            u_l = fx * px * iz + cx
            r0 = u_l - m0
            r1 = fy * py * iz + cy - m1
            r2 = u_l - bpx * iz - m2
            # projection Jacobian rows wrt the camera-frame point; the
            # pose Jacobian is Jp @ [I | -skew(p)]
            a0 = fx * iz
            c0 = -fx * px * iz2
            b1 = fy * iz
            c1 = -fy * py * iz2
            c2 = (-fx * px + bpx) * iz2

            # J[d, 3:] = -(Jp[d] @ skew(p)); None marks a structural zero
            J0 = (a0, None, c0, c0 * py, a0 * pz - c0 * px, -a0 * py)
            J1 = (None, b1, c1, c1 * py - b1 * pz, -c1 * px, b1 * px)
            J2 = (a0, None, c2, c2 * py, a0 * pz - c2 * px, -a0 * py)

            mz = (mask > 0.5) & (pz > range_min)
            chi = (r0 * r0 + r1 * r1 + r2 * r2) * w_in
            kw = jnp.minimum(1.0, chi_threshold / jnp.maximum(chi, 1e-12))
            wgt = jnp.where(mz, w_in * kw, 0.0)

            def wdot3(a, b):
                terms = [p * q for p, q in zip(a, b)
                         if p is not None and q is not None]
                if not terms:       # structurally zero entry (e.g. H[0][1])
                    return None
                return sum(terms[1:], terms[0]) * wgt

            cols = [(J0[i], J1[i], J2[i]) for i in range(6)]
            res = (r0, r1, r2)
            new = [wdot3(cols[i], cols[j]) for i, j in _H_PAIRS]
            new += [wdot3(cols[i], res) for i in range(6)]
            new += [jnp.where(mz, jnp.minimum(chi, chi_threshold), 0.0),
                    jnp.where(mz & (chi <= chi_threshold), 1.0, 0.0),
                    jnp.where(mz, 1.0, 0.0)]
            return tuple(a if n is None else a + n
                         for a, n in zip(accs, new))

        zeros = tuple(jnp.zeros((_TILE,), jnp.float32)
                      for _ in range(_N_ACC))
        accs = jax.lax.fori_loop(0, n_tiles, tile, zeros)
        return [jnp.sum(a) for a in accs]

    def kernel(planes_ref, x_ref, out_ref):
        lane = jax.lax.broadcasted_iota(jnp.int32, (16,), 0)
        x0 = x_ref[...]

        def entry(k):
            return jnp.sum(jnp.where(lane == k, x0, 0.0))

        Xr = [[entry(4 * i + j) for j in range(3)] for i in range(3)]
        Xt = [entry(4 * i + 3) for i in range(3)]
        dx_norm = jnp.float32(jnp.inf)
        stats = [jnp.float32(0.0)] * 3
        for _ in range(iterations):
            live = dx_norm > epsilon
            sums = sweep(planes_ref, Xr, Xt)
            H = [[None] * 6 for _ in range(6)]
            for (i, j), s in zip(_H_PAIRS, sums):
                H[i][j] = H[j][i] = s
            b = sums[len(_H_PAIRS):len(_H_PAIRS) + 6]
            step_stats = sums[len(_H_PAIRS) + 6:]
            dx = _cholesky_solve6(H, b, damping)
            # degenerate-solve guard (gn_step_dx): |d| < 1e30 is False for
            # both inf and NaN
            finite = jnp.abs(dx[0]) < 1e30
            for k in range(1, 6):
                finite = finite & (jnp.abs(dx[k]) < 1e30)
            dx = [jnp.where(finite, d, 0.0) for d in dx]
            Rn, tn = _exp_compose(dx, Xr, Xt)
            ok = step_stats[2] >= float(min_inliers)
            apply = live & ok
            Xr = [[jnp.where(apply, Rn[i][j], Xr[i][j]) for j in range(3)]
                  for i in range(3)]
            Xt = [jnp.where(apply, tn[i], Xt[i]) for i in range(3)]
            step = jnp.sqrt(sum(d * d for d in dx))
            dx_norm = jnp.where(live, jnp.where(ok, step, 0.0), dx_norm)
            stats = [jnp.where(live, new, old)
                     for new, old in zip(step_stats, stats)]
        vals = [v for i in range(3) for v in (*Xr[i], Xt[i])] + stats
        out = jnp.zeros((16,), jnp.float32)
        for k, v in enumerate(vals):
            out = jnp.where(lane == k, v, out)
        out_ref[...] = out

    return kernel


@partial(jax.jit, static_argnames=(
    "cam", "iterations", "damping", "min_inliers", "epsilon",
    "chi_threshold", "interpret"))
def gn_burst_stereo(
    X0: jnp.ndarray,          # [4, 4] moving-in-fixed initial estimate
    pts_moving: jnp.ndarray,  # [C, 3] map points (moving frame)
    meas_uvu: jnp.ndarray,    # [C, 3] measured (uL, vL, uR)
    weights: jnp.ndarray,     # [C] information scaling
    mask: jnp.ndarray,        # [C] bool
    cam: Camera,
    iterations: int,
    damping: float = 1e-6,
    min_inliers: int = 6,
    epsilon: float = 0.0,
    chi_threshold: float = 25.0,
    interpret: bool = False,
):
    """Fused burst: gn_iterate(stereo_projective_system) in one kernel.

    Returns (X, GNStats) like ops/gn.py::gn_iterate.  Padding rows carry
    mask 0 and contribute nothing.
    """
    C = pts_moving.shape[0]
    n_tiles = max(1, -(-C // _TILE))
    pad = n_tiles * _TILE - C
    planes = jnp.concatenate([
        pts_moving.T, meas_uvu.T, weights[None], mask[None],
    ]).astype(jnp.float32)
    planes = jnp.pad(planes, ((0, 0), (0, pad)))
    x_flat = jnp.pad(X0[:3, :].reshape(12).astype(jnp.float32), (0, 4))

    kernel = _make_kernel(cam, n_tiles, iterations, float(damping),
                          int(min_inliers), float(epsilon),
                          float(chi_threshold))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((16,), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="gn_burst_stereo",
    )(planes, x_flat)
    X = jnp.concatenate([
        out[:12].reshape(3, 4),
        jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32),
    ], 0)
    stats = GNStats(
        chi_total=out[12],
        num_inliers=out[13].astype(jnp.int32),
        num_terms=out[14].astype(jnp.int32),
    )
    return X, stats
