"""Statistical noise-tier tests for every landmark estimator (VERDICT r1 #8).

Mirrors the reference's synthetic statistical methodology
(tests/fixtures.hpp:17-88 ``Statistics`` accumulator; :91-421
``Synthetic::generateContinousTransitions`` driving four noise regimes) —
seeded synthetic trajectories observed by a realistic pinhole (fx=450,
600x400, 250 px stereo baseline, fixtures.hpp:325,335-347), with
mean+variance bounds on the final landmark error under:

  * zero        — exact transforms, exact measurements
  * transition  — the filter predicts through NOISY camera transforms
  * measurement — exact transforms, pixel/depth noise on measurements
  * full        — both noise sources at once

applied to all three EKF measurement models (projective, projective_depth,
stereo — including the 2-measurement projective model), the weighted-mean
estimator, and the pose-based smoother.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.ops import ekf, pinhole, se3
from srrg2_proslam_jax.ops import landmark_estimators as le

CAM = pinhole.Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0,
                     rows=400, cols=600, baseline_px=250.0)
N_LM = 80
N_STEPS = 20

# noise magnitudes (reference tiers: measurement noise ~1 px, transition
# noise a small SE3 jitter on the prediction transform)
MEAS_PX = 1.0
TRANS_T = 0.01   # m of translation jitter on the predict transform
TRANS_R = 0.002  # rad


class Statistics:
    """Running mean/variance accumulator (fixtures.hpp:17-88 analog)."""

    def __init__(self):
        self.n = 0
        self._sum = 0.0
        self._sum2 = 0.0

    def add(self, values):
        v = np.asarray(values, dtype=np.float64).ravel()
        self.n += v.size
        self._sum += v.sum()
        self._sum2 += (v * v).sum()

    @property
    def mean(self):
        return self._sum / max(self.n, 1)

    @property
    def variance(self):
        m = self.mean
        return max(self._sum2 / max(self.n, 1) - m * m, 0.0)

    @property
    def std(self):
        return float(np.sqrt(self.variance))


def _world(rng):
    """Random in-view landmarks, like the reference's 100-point world."""
    z = rng.uniform(4.0, 15.0, N_LM)
    u = rng.uniform(80, 520, N_LM)
    v = rng.uniform(60, 340, N_LM)
    p = np.stack([(u - CAM.cx) / CAM.fx * z, (v - CAM.cy) / CAM.fy * z, z], 1)
    return jnp.asarray(p, jnp.float32)


def _transforms(rng):
    """Per-step (true, noisy) world->sensor transforms; points stay in view."""
    out = []
    for _ in range(N_STEPS):
        xi = np.concatenate([rng.randn(3) * 0.08, rng.randn(3) * 0.015])
        T = se3.exp(jnp.asarray(xi, jnp.float32))
        dxi = np.concatenate([rng.randn(3) * TRANS_T, rng.randn(3) * TRANS_R])
        T_noisy = se3.exp(jnp.asarray(dxi, jnp.float32)) @ T
        out.append((T, T_noisy))
    return out


def _measure(p_cam, model):
    if model == "projective":
        uv, _ = pinhole.project(CAM, p_cam)
        return uv
    if model == "projective_depth":
        uv, _ = pinhole.project(CAM, p_cam)
        return jnp.concatenate([uv, p_cam[:, 2:3]], axis=1)
    uvu, _ = pinhole.project_stereo(CAM, p_cam)
    return jnp.concatenate([uvu, uvu[:, 1:2]], axis=1)


def _meas_noise(rng, shape, model):
    n = rng.randn(*shape) * MEAS_PX
    if model == "projective_depth":
        n[:, 2] = rng.randn(shape[0]) * 0.02  # depth noise in meters
    return jnp.asarray(n, jnp.float32)


def run_ekf_tier(rng, model, tier):
    p_true = _world(rng)
    p = p_true + jnp.asarray(rng.randn(N_LM, 3) * 0.5, jnp.float32)
    P = jnp.broadcast_to(jnp.eye(3) * 4.0, (N_LM, 3, 3))
    cfg = ekf.LandmarkEKFConfig(maximum_distance_geometry_m2=100.0,
                                maximum_covariance_norm_squared=1e6)
    for T, T_noisy in _transforms(rng):
        meas = _measure(se3.transform_points(T, p_true), model)
        if tier in ("measurement", "full"):
            meas = meas + _meas_noise(rng, np.asarray(meas).shape, model)
        T_filter = T_noisy if tier in ("transition", "full") else T
        r = ekf.ekf_update_batch(p, P, meas, jnp.ones(N_LM, bool),
                                 T_filter, CAM, model, cfg)
        p, P = r.position, r.covariance
    return np.linalg.norm(np.asarray(p - p_true), axis=1)


# (mean bound, std bound) per (model, tier) — calibrated at ~2x the observed
# seeded statistics, mirroring the reference's per-tier assertion tables
_EKF_BOUNDS = {
    ("stereo", "zero"): (0.02, 0.02),
    ("stereo", "transition"): (0.30, 0.25),
    ("stereo", "measurement"): (0.15, 0.15),
    ("stereo", "full"): (0.35, 0.30),
    ("projective_depth", "zero"): (0.02, 0.02),
    ("projective_depth", "transition"): (0.30, 0.25),
    ("projective_depth", "measurement"): (0.15, 0.15),
    ("projective_depth", "full"): (0.35, 0.30),
    # bearing-only: depth is weakly observable from small parallax — the
    # bounds certify improvement over the 0.5 m initial perturbation
    ("projective", "zero"): (0.30, 0.35),
    ("projective", "transition"): (0.50, 0.50),
    ("projective", "measurement"): (0.40, 0.45),
    ("projective", "full"): (0.60, 0.60),
}


@pytest.mark.parametrize("model", ["projective", "projective_depth", "stereo"])
@pytest.mark.parametrize("tier", ["zero", "transition", "measurement", "full"])
def test_ekf_noise_tiers(model, tier, rng):
    stats = Statistics()
    stats.add(run_ekf_tier(rng, model, tier))
    mean_bound, std_bound = _EKF_BOUNDS[(model, tier)]
    assert stats.mean < mean_bound, (model, tier, stats.mean)
    assert stats.std < std_bound, (model, tier, stats.std)


def test_ekf_noise_ordering(rng):
    """More noise must not make the filter better on average (sanity of the
    tier construction itself, not of the filter)."""
    zero = Statistics()
    zero.add(run_ekf_tier(rng, "stereo", "zero"))
    full = Statistics()
    full.add(run_ekf_tier(rng, "stereo", "full"))
    assert zero.mean < full.mean


def run_weighted_mean_tier(rng, tier):
    p_true = _world(rng)
    p = p_true + jnp.asarray(rng.randn(N_LM, 3) * 0.5, jnp.float32)
    counts = jnp.zeros(N_LM, jnp.int32)
    cfg = le.WeightedMeanConfig(maximum_distance_geometry_m2=100.0)
    for T, T_noisy in _transforms(rng):
        # world-frame point measurement: unproject through the (possibly
        # wrong) transform the tracker believes in
        p_cam = se3.transform_points(T, p_true)
        if tier in ("measurement", "full"):
            p_cam = p_cam + jnp.asarray(rng.randn(N_LM, 3) * 0.02, jnp.float32)
        T_back = T_noisy if tier in ("transition", "full") else T
        p_meas = se3.transform_points(se3.inverse(T_back), p_cam)
        r = le.weighted_mean_update_batch(p, counts, p_meas,
                                          jnp.ones(N_LM, bool), cfg)
        p = r.position
        counts = counts + r.accepted.astype(jnp.int32)
    return np.linalg.norm(np.asarray(p - p_true), axis=1)


_WM_BOUNDS = {
    "zero": (0.06, 0.06),
    "transition": (0.30, 0.25),
    "measurement": (0.08, 0.08),
    "full": (0.30, 0.25),
}


@pytest.mark.parametrize("tier", ["zero", "transition", "measurement", "full"])
def test_weighted_mean_noise_tiers(tier, rng):
    stats = Statistics()
    stats.add(run_weighted_mean_tier(rng, tier))
    mean_bound, std_bound = _WM_BOUNDS[tier]
    assert stats.mean < mean_bound, (tier, stats.mean)
    assert stats.std < std_bound, (tier, stats.std)


def run_smoother_tier(rng, tier):
    p_true = _world(rng)
    p = p_true + jnp.asarray(rng.randn(N_LM, 3) * 0.5, jnp.float32)
    buf = le.empty_measurement_buffer(N_LM, capacity=8)
    cfg = le.SmootherConfig(maximum_distance_geometry_m2=100.0)
    for T, T_noisy in _transforms(rng)[:8]:
        p_cam = se3.transform_points(T, p_true)
        uv, _ = pinhole.project(CAM, p_cam)
        if tier in ("measurement", "full"):
            uv = uv + jnp.asarray(rng.randn(N_LM, 2) * MEAS_PX, jnp.float32)
            p_cam = p_cam.at[:, 2].add(
                jnp.asarray(rng.randn(N_LM) * 0.02, jnp.float32))
        T_rec = T_noisy if tier in ("transition", "full") else T
        buf = le.add_measurements(buf, uv, p_cam, T_rec,
                                  jnp.ones(N_LM, bool))
    r = le.smoother_update_batch(p, buf, jnp.zeros(N_LM, jnp.int32),
                                 jnp.ones(N_LM, bool), CAM, cfg)
    return np.linalg.norm(np.asarray(r.position - p_true), axis=1)


_SM_BOUNDS = {
    "zero": (0.01, 0.01),
    "transition": (0.30, 0.25),
    "measurement": (0.05, 0.05),
    "full": (0.30, 0.25),
}


@pytest.mark.parametrize("tier", ["zero", "transition", "measurement", "full"])
def test_smoother_noise_tiers(tier, rng):
    stats = Statistics()
    stats.add(run_smoother_tier(rng, tier))
    mean_bound, std_bound = _SM_BOUNDS[tier]
    assert stats.mean < mean_bound, (tier, stats.mean)
    assert stats.std < std_bound, (tier, stats.std)
