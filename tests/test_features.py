"""FAST-9/16 + BRIEF-256 frontend against plain numpy references.

The XLA path (ops/features.py) is the only implementation, so it is pinned
here against brute-force loops: the FAST score of every interior pixel,
batched detection against per-image detection, exact per-region top-k
selection, and the gather-path descriptors against a numpy sampler.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from srrg2_proslam_jax.ops import features as F


def _fast_numpy(img, threshold):
    """Brute-force FAST-9/16 score: max over the 16 circular 9-arcs of the
    arc-min brighter (or darker) difference; 0 below the threshold."""
    H, W = img.shape
    out = np.zeros_like(img)
    for y in range(3, H - 3):
        for x in range(3, W - 3):
            c = img[y, x]
            ring = np.array([img[y + dy, x + dx] for dy, dx in F._FAST_OFFSETS])
            best = 0.0
            for diff in (ring - c, c - ring):
                for r in range(16):
                    arc = [diff[(r + k) % 16] for k in range(F._ARC_LENGTH)]
                    best = max(best, min(arc))
            out[y, x] = best if best > threshold else 0.0
    return out


@pytest.mark.parametrize("shape", [(24, 40), (31, 45)])
def test_fast_scores_match_bruteforce(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    got = np.asarray(F.fast_scores(jnp.asarray(img), 15.0))
    want = _fast_numpy(img, 15.0)
    # interior only: jnp.roll wraps at the edges, which the detector's
    # BORDER margin never reads
    np.testing.assert_allclose(got[3:-3, 3:-3], want[3:-3, 3:-3], atol=1e-4)
    assert (want > 0).sum() > 20          # the image has corners


def test_detect_batch_matches_per_image(rng):
    cfg = F.FeatureExtractorConfig(max_keypoints=144)
    imgs = rng.uniform(0, 255, (4, 72, 96)).astype(np.float32)
    uv_b, resp_b, valid_b = F.detect_keypoints_batch(jnp.asarray(imgs), cfg)
    for i in range(4):
        uv, resp, valid = F.detect_keypoints(jnp.asarray(imgs[i]), cfg)
        np.testing.assert_array_equal(np.asarray(uv_b[i]), np.asarray(uv))
        np.testing.assert_array_equal(np.asarray(resp_b[i]),
                                      np.asarray(resp))
        np.testing.assert_array_equal(np.asarray(valid_b[i]),
                                      np.asarray(valid))
    assert int(valid_b.sum()) > 100


def test_top_k_selection_is_exact(rng):
    """Each grid region yields exactly its k highest post-NMS scores."""
    cfg = F.FeatureExtractorConfig(max_keypoints=36, grid_rows=3,
                                   grid_cols=3)
    H, W = 96, 96
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    uv, resp, valid = F.detect_keypoints(img, cfg)

    # numpy replica of the post-NMS, border-masked score map
    raw = np.asarray(F.fast_scores(img, cfg.detector_threshold))
    pooled = np.asarray(F._maxpool2d(jnp.asarray(raw), cfg.nms_window))
    score = np.where(raw >= pooled, raw, 0.0)
    inner = np.zeros_like(score, bool)
    inner[F.BORDER:H - F.BORDER, F.BORDER:W - F.BORDER] = True
    score = np.where(inner, score, 0.0)
    k = cfg.max_keypoints // 9
    rows = np.asarray(uv[:, 1]).round().astype(int)
    cols = np.asarray(uv[:, 0]).round().astype(int)
    resp = np.asarray(resp)
    for g in range(9):
        r0, c0 = (g // 3) * 32, (g % 3) * 32
        want = np.sort(score[r0:r0 + 32, c0:c0 + 32].ravel())[::-1][:k]
        got = np.sort(resp[g * k:(g + 1) * k])[::-1]
        np.testing.assert_array_equal(got, want)
    # every selected keypoint lies at its reported response (sub-pixel
    # offsets are at most half a pixel)
    sel = resp > 0
    np.testing.assert_array_equal(score[rows[sel], cols[sel]], resp[sel])


def _brief_numpy(image, uv, window):
    smooth = np.asarray(F._boxfilter(jnp.asarray(image), window))
    H, W = image.shape
    out = np.empty((len(uv), 256), np.int8)
    for n, (u, v) in enumerate(uv):
        y = int(np.clip(int(v), F.BORDER, H - F.BORDER - 1))
        x = int(np.clip(int(u), F.BORDER, W - F.BORDER - 1))
        for k in range(256):
            (pdy, pdx), (qdy, qdx) = F._BRIEF_PAIRS[k]
            a = smooth[y + pdy, x + pdx]
            b = smooth[y + qdy, x + qdx]
            out[n, k] = 1 if a < b else -1
    return out


def test_descriptors_match_numpy_sampler(rng):
    H, W = 80, 120
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    cfg = F.FeatureExtractorConfig()
    n = 24
    uv = np.stack([rng.uniform(F.BORDER, W - F.BORDER, n),
                   rng.uniform(F.BORDER, H - F.BORDER, n)], 1)
    got = np.asarray(F.compute_descriptors(
        jnp.asarray(img), jnp.asarray(uv, jnp.float32), jnp.ones(n, bool),
        cfg))
    np.testing.assert_array_equal(got, _brief_numpy(img, uv,
                                                    cfg.smoothing_window))


def test_descriptors_mask_invalid_rows(rng):
    H, W = 80, 120
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    cfg = F.FeatureExtractorConfig()
    uv = jnp.asarray(np.full((6, 2), 40.0, np.float32))
    valid = jnp.asarray([True, False, True, False, False, True])
    desc = np.asarray(F.compute_descriptors(img, uv, valid, cfg))
    assert (desc[~np.asarray(valid)] == -1).all()
    assert (desc[np.asarray(valid)] == 1).any()
    # the batched frontend masks the same way
    feats = F.extract_features_batch(img[None], F.FeatureExtractorConfig(
        max_keypoints=36))
    d = np.asarray(feats.desc[0])
    assert (d[~np.asarray(feats.valid[0])] == -1).all()
