"""Matcher tests on synthetic descriptor worlds.

Mirrors the SyntheticWorldWithDescriptorsSE3 strategy of the reference
(tests/test_aligners.cpp:47-64): fabricate random descriptors, copy them
along ground-truth correspondences so matching is exact, then assert the
matchers recover the GT assignment."""
import numpy as np
import jax.numpy as jnp

from srrg2_proslam_jax.ops import hamming, matching


def random_desc(rng, n):
    bits = rng.randint(0, 2, size=(n, 256)).astype(np.uint8)
    return jnp.asarray(hamming.bits_to_signed(jnp.asarray(bits)))


def corrupt(rng, desc, n_flips):
    d = np.asarray(desc).copy()
    for i in range(d.shape[0]):
        idx = rng.choice(256, size=n_flips, replace=False)
        d[i, idx] = -d[i, idx]
    return jnp.asarray(d)


def test_pack_unpack_roundtrip(rng):
    bits = jnp.asarray(rng.randint(0, 2, size=(16, 256)).astype(np.uint8))
    packed = hamming.pack_bits(bits)
    assert packed.shape == (16, 8)
    np.testing.assert_array_equal(np.asarray(hamming.unpack_bits(packed)), np.asarray(bits))


def test_distance_matrix_matches_numpy(rng):
    a = random_desc(rng, 32)
    b = random_desc(rng, 48)
    D = np.asarray(hamming.distance_matrix(a, b))
    an = (np.asarray(a) > 0).astype(np.int32)
    bn = (np.asarray(b) > 0).astype(np.int32)
    ref = (an[:, None, :] != bn[None, :, :]).sum(-1)
    np.testing.assert_array_equal(D, ref)


def test_bruteforce_exact_permutation(rng):
    n = 64
    desc_a = random_desc(rng, n)
    perm = rng.permutation(n)
    desc_b = desc_a[jnp.asarray(perm)]
    valid = jnp.ones(n, bool)
    m = matching.match_bruteforce(desc_a, valid, desc_b, valid,
                                  matching.BruteforceMatcherConfig())
    # identical descriptors: every point must match its permuted slot
    assert int(m.count) == n
    np.testing.assert_array_equal(np.asarray(m.idx), np.argsort(perm))


def test_bruteforce_rejects_invalid_rows(rng):
    desc = random_desc(rng, 32)
    valid_a = jnp.arange(32) < 16
    m = matching.match_bruteforce(desc, valid_a, desc, jnp.ones(32, bool),
                                  matching.BruteforceMatcherConfig())
    assert not bool(jnp.any(m.mask[16:]))
    assert int(m.count) == 16


def test_bruteforce_noise_tolerance(rng):
    n = 64
    desc_a = random_desc(rng, n)
    desc_b = corrupt(rng, desc_a, 10)  # 10-bit corruption << 50 threshold
    valid = jnp.ones(n, bool)
    m = matching.match_bruteforce(desc_a, valid, desc_b, valid,
                                  matching.BruteforceMatcherConfig())
    idx = np.asarray(m.idx)
    mask = np.asarray(m.mask)
    assert mask.sum() > 0.8 * n
    np.testing.assert_array_equal(idx[mask], np.arange(n)[mask])


def test_epipolar_stereo_synthetic(rng):
    """Left/right features with known disparity: matcher recovers pairs."""
    n = 80
    u_l = rng.uniform(120, 500, n).astype(np.float32)
    v = rng.uniform(20, 380, n).astype(np.float32)
    disparity = rng.uniform(2, 80, n).astype(np.float32)
    uv_left = jnp.asarray(np.stack([u_l, v], 1))
    uv_right = jnp.asarray(np.stack([u_l - disparity, v], 1))
    desc = random_desc(rng, n)
    perm = rng.permutation(n)
    m = matching.match_epipolar(
        uv_left, desc, jnp.ones(n, bool),
        uv_right[jnp.asarray(perm)], desc[jnp.asarray(perm)], jnp.ones(n, bool),
        matching.EpipolarMatcherConfig(),
    )
    assert int(m.count) == n
    np.testing.assert_array_equal(np.asarray(m.idx), np.argsort(perm))


def test_epipolar_rejects_negative_disparity(rng):
    uv_left = jnp.asarray([[100.0, 50.0]])
    uv_right = jnp.asarray([[150.0, 50.0]])  # right of left: impossible
    desc = random_desc(rng, 1)
    m = matching.match_epipolar(uv_left, desc, jnp.ones(1, bool),
                                uv_right, desc, jnp.ones(1, bool),
                                matching.EpipolarMatcherConfig())
    assert int(m.count) == 0


def test_projective_staged_radius(rng):
    """Map projections offset by 15 px: stage 0 (r=10) fails, stage 1 wins."""
    n = 50
    uv = jnp.asarray(rng.uniform(50, 400, size=(n, 2)).astype(np.float32))
    offset = jnp.asarray([[15.0, 0.0]])
    desc = random_desc(rng, n)
    config = matching.ProjectiveMatcherConfig()
    m, stage = matching.match_projective(
        uv, desc, jnp.ones(n, bool),
        uv + offset, desc, jnp.ones(n, bool),
        config,
    )
    assert int(stage) == 1
    assert int(m.count) == n
    np.testing.assert_array_equal(np.asarray(m.idx), np.arange(n))


def test_projective_tight_stage_when_close(rng):
    n = 50
    uv = jnp.asarray(rng.uniform(50, 400, size=(n, 2)).astype(np.float32))
    desc = random_desc(rng, n)
    m, stage = matching.match_projective(
        uv, desc, jnp.ones(n, bool),
        uv + 2.0, desc, jnp.ones(n, bool),
        matching.ProjectiveMatcherConfig(),
    )
    assert int(stage) == 0
    assert int(m.count) == n


def test_adapt_stereo_batch_matches_single_rows(rng):
    """The natively-batched stereo adaptor (chunked mode) must reproduce
    the per-pair adaptor row for row (the batch path re-implements the
    sub-pixel/assembly tail without vmap for speed)."""
    import numpy as np
    from srrg2_proslam_jax.io import synthetic as syn
    from srrg2_proslam_jax.models.frontend import (
        StereoAdaptorConfig, adapt_stereo, adapt_stereo_batch,
    )

    cam = syn.synthetic_camera(rows=240, cols=320)
    planes = syn.make_room()
    poses = syn.loop_trajectory()[:3]
    imgs = [syn.render_stereo(cam, jnp.asarray(T), planes)[:2]
            for T in poses]
    a = jnp.stack([i[0] for i in imgs])
    b = jnp.stack([i[1] for i in imgs])
    acfg = StereoAdaptorConfig()
    mb = adapt_stereo_batch(a, b, acfg)
    for i in range(3):
        ms = adapt_stereo(a[i], b[i], acfg)
        np.testing.assert_array_equal(np.asarray(ms.valid),
                                      np.asarray(mb.valid[i]))
        np.testing.assert_allclose(np.asarray(ms.points),
                                   np.asarray(mb.points[i]), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(ms.desc),
                                      np.asarray(mb.desc[i]))
