"""Native C++ decoder/prefetcher must bit-match the PIL reference path."""
import os

import numpy as np
import pytest
from PIL import Image

from srrg2_proslam_jax.io import datasets, native

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")

FILES = [
    os.path.join(ROOT, "kitti", "city", "image_left_0.png"),     # gray8 PNG
    os.path.join(ROOT, "icl", "image_rgb_0.png"),                # color PNG
    os.path.join(ROOT, "icl", "image_depth_0.pgm"),              # 16-bit PGM
    os.path.join(ROOT, "scene_flow", "image_left.png"),          # rgb PNG
]

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native IO library not built")


@needs_native
@pytest.mark.parametrize("path", FILES)
def test_native_decode_matches_pil(path):
    a = native.decode(path)
    ref = np.asarray(Image.open(path))
    assert a is not None
    assert a.shape == ref.shape
    np.testing.assert_array_equal(a, ref)


@needs_native
def test_prefetcher_in_order():
    paths = [os.path.join(ROOT, "kitti", "city", f"image_left_{i}.png")
             for i in range(5)]
    refs = [native.decode(p) for p in paths]
    pf = native.Prefetcher(paths, n_threads=3, window=2)
    out = list(pf)
    assert len(out) == 5
    for a, b in zip(out, refs):
        np.testing.assert_array_equal(a, b)


@needs_native
def test_load_gray_uses_native_consistently():
    # the public loader must produce the same float32 image either way
    path = FILES[0]
    a = datasets.load_gray(path)
    ref = np.asarray(Image.open(path)).astype(np.float32)
    np.testing.assert_allclose(a, ref, atol=0.5)
    assert a.dtype == np.float32


def test_load_gray_fallback_without_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    a = datasets.load_gray(FILES[0])
    assert a.dtype == np.float32 and a.ndim == 2
