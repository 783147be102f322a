import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops import se3


def random_twists(rng, n, t_scale=1.0, w_scale=0.5):
    v = rng.randn(n, 3) * t_scale
    w = rng.randn(n, 3) * w_scale
    return jnp.asarray(np.concatenate([v, w], axis=1), dtype=jnp.float32)


def test_exp_log_roundtrip(rng):
    xi = random_twists(rng, 64)
    T = se3.exp(xi)
    xi_back = se3.log(T)
    # float32 trig round-trip: ~1e-3 relative accuracy is the expected regime
    np.testing.assert_allclose(np.asarray(xi_back), np.asarray(xi), atol=6e-3)


def test_exp_zero_is_identity():
    T = se3.exp(jnp.zeros(6))
    np.testing.assert_allclose(np.asarray(T), np.eye(4), atol=1e-6)


def test_inverse_compose(rng):
    T = se3.exp(random_twists(rng, 16))
    eye = np.asarray(se3.compose(T, se3.inverse(T)))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape), atol=1e-4)


def test_rotation_orthonormal(rng):
    T = se3.exp(random_twists(rng, 16))
    R = np.asarray(se3.rotation(T))
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_transform_points(rng):
    T = se3.exp(random_twists(rng, 1))[0]
    pts = jnp.asarray(rng.randn(10, 3), dtype=jnp.float32)
    out = se3.transform_points(T, pts)
    expected = (np.asarray(T)[:3, :3] @ np.asarray(pts).T).T + np.asarray(T)[:3, 3]
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-5)


def test_error_metric(rng):
    A = se3.exp(random_twists(rng, 1))[0]
    t_err, angle = se3.error_t_and_angle(A, A)
    assert float(jnp.max(t_err)) < 1e-5
    assert float(angle) < 1e-3
