"""IO tests: PCD round-trips through both the NumPy and the native C++
paths, and cross-consistency between them."""

import os

import numpy as np
import pytest

from gp_compressor_jax.io import native, pcd


def _cloud(n=500, seed=0):
    r = np.random.default_rng(seed)
    pts = r.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    cols = r.integers(0, 256, size=(n, 3)).astype(np.float32)
    return pts, cols


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_numpy_roundtrip(tmp_path, binary):
    pts, cols = _cloud()
    path = os.path.join(tmp_path, "a.pcd")
    pcd.write(path, pts, cols, binary=binary)
    back_pts, back_cols = pcd.read(path)
    assert np.allclose(back_pts, pts, atol=1e-5)
    assert np.array_equal(back_cols, cols)


def test_pcd_numpy_roundtrip_no_rgb(tmp_path):
    pts, _ = _cloud()
    path = os.path.join(tmp_path, "b.pcd")
    pcd.write(path, pts, None)
    back_pts, back_cols = pcd.read(path)
    assert np.allclose(back_pts, pts, atol=1e-5)
    assert back_cols is None


def test_native_library_builds():
    assert native.available(), "native IO library failed to build"


@pytest.mark.parametrize("binary", [True, False])
def test_native_matches_numpy(tmp_path, binary):
    if not native.available():
        pytest.skip("no native lib")
    pts, cols = _cloud(seed=1)
    p1 = os.path.join(tmp_path, "np.pcd")
    p2 = os.path.join(tmp_path, "nat.pcd")
    pcd.write(p1, pts, cols, binary=binary)
    native.write_pcd(p2, pts, cols, binary=binary)

    for p in (p1, p2):
        a_pts, a_cols = pcd.read(p)
        b_pts, b_cols = native.read_pcd(p)
        assert np.allclose(a_pts, b_pts, atol=1e-5)
        assert np.allclose(a_cols, b_cols, atol=0)
    if binary:
        # binary writers must agree byte-for-byte
        assert open(p1, "rb").read() == open(p2, "rb").read()


def test_native_artifact_byte_identical(tmp_path):
    """The C++ artifact writer must produce byte-identical files to the
    Python implementation (golden cross-check)."""
    if not native.available():
        pytest.skip("no native lib")
    from gp_compressor_jax.io import artifact as artifact_io

    r = np.random.default_rng(7)
    n, sz, l = 9, 8, 64
    art = artifact_io.Artifact(
        res=0.2, sz=sz,
        D=r.standard_normal((l, 16)).astype(np.float32),
        RGB_D=r.standard_normal((l, 12)).astype(np.float32),
        words_max=5, RGB_words_max=4,
        means=r.standard_normal((n, 3)).astype(np.float32),
        quats=r.standard_normal((n, 4)).astype(np.float32),
        rgb_means=r.standard_normal((n, 3)).astype(np.float32),
        X=r.standard_normal((n, 5)).astype(np.float32),
        I=r.integers(0, 16, size=(n, 5)).astype(np.int32),
        nw=r.integers(0, 6, size=n).astype(np.int32),
        RGB_X=r.standard_normal((3 * n, 4)).astype(np.float32),
        RGB_I=r.integers(0, 12, size=(3 * n, 4)).astype(np.int32),
        RGB_nw=r.integers(0, 5, size=3 * n).astype(np.int32),
        W=r.uniform(size=(n, sz * sz)) > 0.4,
    )
    py = os.path.join(tmp_path, "py")
    nat = os.path.join(tmp_path, "nat")
    artifact_io.write(py, art)
    assert native.write_artifact(nat, art)
    for suffix in (".pccode", "depth.pcdict", "rgb.pcdict"):
        a = open(py + suffix, "rb").read()
        b = open(nat + suffix, "rb").read()
        assert a == b, f"{suffix}: {len(a)} vs {len(b)} bytes"
    # and the python reader parses the native file
    back = artifact_io.read(nat)
    assert np.allclose(back.D, art.D)
    assert np.array_equal(back.W, art.W)
