"""Dictionary codec tests: OMP solve quality, K-SVD convergence, artifact
round-trip, end-to-end K-SVD compress/decompress."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import (CompressorConfig, KSVDConfig, PatchConfig)
from gp_compressor_jax.models import dictionary
from gp_compressor_jax.io import artifact as artifact_io
from gp_compressor_jax.utils import synthetic
from gp_compressor_jax.workloads import ksvd_compressor


def test_omp_recovers_sparse_signals():
    """Signals that ARE k-sparse in a random dictionary must be recovered
    (near-)exactly by masked OMP with full masks."""
    r = np.random.default_rng(0)
    l, K, n, k = 64, 32, 40, 3
    D = r.standard_normal((l, K))
    D /= np.linalg.norm(D, axis=0)
    X_true = np.zeros((n, K))
    for i in range(n):
        sel = r.choice(K, size=k, replace=False)
        X_true[i, sel] = r.standard_normal(k)
    S = X_true @ D.T
    cfg = KSVDConfig(dict_size=K, words_max=k, proj_error=1e-10)
    code = dictionary.omp_encode(jnp.asarray(D), jnp.asarray(S),
                                 jnp.ones((n, l)), jnp.ones(n, bool), cfg)
    S_rec = np.asarray(dictionary.reconstruct(jnp.asarray(D), code))
    # OMP with exact-sparse signals and incoherent atoms recovers most
    # signals; allow a few greedy failures
    errs = np.linalg.norm(S_rec - S, axis=1) / np.linalg.norm(S, axis=1)
    assert np.median(errs) < 1e-6
    assert (errs < 1e-6).mean() > 0.7


def test_omp_respects_mask():
    """Masked-out entries must not influence the code: corrupting them
    changes nothing."""
    r = np.random.default_rng(1)
    l, K, n = 36, 20, 10
    D = r.standard_normal((l, K))
    D /= np.linalg.norm(D, axis=0)
    S = r.standard_normal((n, l))
    W = (r.uniform(size=(n, l)) > 0.3).astype(float)
    cfg = KSVDConfig(dict_size=K, words_max=4, proj_error=1e-8)
    c1 = dictionary.omp_encode(jnp.asarray(D), jnp.asarray(S),
                               jnp.asarray(W), jnp.ones(n, bool), cfg)
    S2 = S + (1 - W) * 100.0 * r.standard_normal((n, l))
    c2 = dictionary.omp_encode(jnp.asarray(D), jnp.asarray(S2),
                               jnp.asarray(W), jnp.ones(n, bool), cfg)
    assert np.allclose(np.asarray(c1.X), np.asarray(c2.X), atol=1e-9)
    assert np.array_equal(np.asarray(c1.I), np.asarray(c2.I))


def test_omp_stops_at_proj_error():
    r = np.random.default_rng(2)
    l, K, n = 25, 16, 8
    D = r.standard_normal((l, K))
    D /= np.linalg.norm(D, axis=0)
    # first atom alone explains the signal
    S = np.outer(r.standard_normal(n), D[:, 0] * 0) + D[:, 3][None, :] * 2.0
    cfg = KSVDConfig(dict_size=K, words_max=6, proj_error=1e-6)
    code = dictionary.omp_encode(jnp.asarray(D), jnp.asarray(S),
                                 jnp.ones((n, l)), jnp.ones(n, bool), cfg)
    assert np.all(np.asarray(code.nw) <= 2)


def test_ksvd_reduces_error_and_converges():
    r = np.random.default_rng(3)
    l, K, n, k = 49, 24, 200, 3
    D_true = r.standard_normal((l, K))
    D_true /= np.linalg.norm(D_true, axis=0)
    X_true = np.zeros((n, K))
    for i in range(n):
        sel = r.choice(K, size=k, replace=False)
        X_true[i, sel] = r.standard_normal(k) * 3
    S = X_true @ D_true.T + 0.01 * r.standard_normal((n, l))
    W = (r.uniform(size=(n, l)) > 0.2).astype(float)
    cfg = KSVDConfig(dict_size=K, words_max=k, proj_error=1e-8,
                     stop_diff=1e-5, max_iters=15)
    res = dictionary.ksvd(jnp.asarray(S), jnp.asarray(W),
                          jnp.ones(n, bool), cfg, jax.random.key(0))
    base = float(np.mean(np.sum((S * W) ** 2, axis=1)))
    # Calibration: with 20% masking, even encoding against the TRUE
    # dictionary leaves ~4% residual because of the reference's
    # unit-diagonal masked-Gram approximation
    # (src/orthogonal_matching_pursuit.cpp:86) which we reproduce by
    # default. K-SVD must land within ~2x of that floor.
    assert float(res.error) < 0.10 * base, (float(res.error), base)

    # the exact-diagonal upgrade must beat the reference approximation
    cfg_x = KSVDConfig(dict_size=K, words_max=k, proj_error=1e-8,
                       stop_diff=1e-5, max_iters=15, exact_gram_diag=True)
    code_true = dictionary.omp_encode(jnp.asarray(D_true), jnp.asarray(S),
                                      jnp.asarray(W), jnp.ones(n, bool), cfg_x)
    err_exact = float(dictionary.masked_error(
        jnp.asarray(D_true), code_true, jnp.asarray(S), jnp.asarray(W),
        jnp.ones(n)))
    code_ref = dictionary.omp_encode(jnp.asarray(D_true), jnp.asarray(S),
                                     jnp.asarray(W), jnp.ones(n, bool), cfg)
    err_ref = float(dictionary.masked_error(
        jnp.asarray(D_true), code_ref, jnp.asarray(S), jnp.asarray(W),
        jnp.ones(n)))
    assert err_exact < 0.25 * err_ref, (err_exact, err_ref)


def test_ksvd_blocked_atom_sweep_matches_serial_quality():
    """atom_block > 1 (Jacobi-within-block dictionary update, the device
    latency fix) must reach the same error regime as the reference's
    serial Gauss-Seidel sweep on a recoverable sparse problem."""
    r = np.random.default_rng(9)
    l, K, n, k = 49, 24, 200, 3
    D_true = r.standard_normal((l, K))
    D_true /= np.linalg.norm(D_true, axis=0)
    X_true = np.zeros((n, K))
    for i in range(n):
        sel = r.choice(K, size=k, replace=False)
        X_true[i, sel] = r.standard_normal(k) * 3
    S = X_true @ D_true.T + 0.01 * r.standard_normal((n, l))
    W = (r.uniform(size=(n, l)) > 0.2).astype(float)
    args = (jnp.asarray(S), jnp.asarray(W), jnp.ones(n, bool))

    cfg1 = KSVDConfig(dict_size=K, words_max=k, proj_error=1e-8,
                      stop_diff=1e-5, max_iters=15)
    cfg8 = KSVDConfig(dict_size=K, words_max=k, proj_error=1e-8,
                      stop_diff=1e-5, max_iters=15, atom_block=8)
    res1 = dictionary.ksvd(*args, cfg1, jax.random.key(0))
    res8 = dictionary.ksvd(*args, cfg8, jax.random.key(0))
    base = float(np.mean(np.sum((S * W) ** 2, axis=1)))
    assert float(res8.error) < 0.10 * base, (float(res8.error), base)
    # within 1.5x of the serial sweep's converged masked MSE
    assert float(res8.error) < 1.5 * float(res1.error) + 1e-6, (
        float(res8.error), float(res1.error))
    # block size not dividing dict_size exercises the padded last block
    cfg7 = KSVDConfig(dict_size=K, words_max=k, proj_error=1e-8,
                      stop_diff=1e-5, max_iters=15, atom_block=7)
    res7 = dictionary.ksvd(*args, cfg7, jax.random.key(0))
    assert float(res7.error) < 0.10 * base


def test_artifact_roundtrip(tmp_path):
    r = np.random.default_rng(4)
    n, sz, l = 7, 6, 36
    art = artifact_io.Artifact(
        res=0.15, sz=sz,
        D=r.standard_normal((l, 12)).astype(np.float32),
        RGB_D=r.standard_normal((l, 9)).astype(np.float32),
        words_max=4, RGB_words_max=3,
        means=r.standard_normal((n, 3)).astype(np.float32),
        quats=r.standard_normal((n, 4)).astype(np.float32),
        rgb_means=r.standard_normal((n, 3)).astype(np.float32),
        X=r.standard_normal((n, 4)).astype(np.float32),
        I=r.integers(0, 12, size=(n, 4)).astype(np.int32),
        nw=r.integers(0, 5, size=n).astype(np.int32),
        RGB_X=r.standard_normal((3 * n, 3)).astype(np.float32),
        RGB_I=r.integers(0, 9, size=(3 * n, 3)).astype(np.int32),
        RGB_nw=r.integers(0, 4, size=3 * n).astype(np.int32),
        W=r.uniform(size=(n, sz * sz)) > 0.5,
    )
    name = os.path.join(tmp_path, "test")
    artifact_io.write(name, art)
    back = artifact_io.read(name)
    assert back.res == np.float32(art.res) and back.sz == art.sz
    assert np.allclose(back.D, art.D) and np.allclose(back.RGB_D, art.RGB_D)
    assert np.allclose(back.means, art.means)
    assert np.allclose(back.quats, art.quats)
    assert np.array_equal(back.nw, art.nw)
    for i in range(n):
        w = art.nw[i]
        assert np.allclose(back.X[i, :w], art.X[i, :w])
        assert np.array_equal(back.I[i, :w], art.I[i, :w])
    assert np.array_equal(back.W, art.W)
    for i in range(3 * n):
        w = art.RGB_nw[i]
        assert np.allclose(back.RGB_X[i, :w], art.RGB_X[i, :w])
        assert np.array_equal(back.RGB_I[i, :w], art.RGB_I[i, :w])


def test_ksvd_pipeline_end_to_end(tmp_path):
    """Compress -> artifact file -> decompress; geometric sanity + RMS."""
    pts, cols = synthetic.room_cloud(n=6000, seed=5)
    cfg = CompressorConfig(
        patch=PatchConfig(res=0.3, sz=10, max_patches=512,
                          max_points_per_patch=256),
        ksvd=KSVDConfig(dict_size=40, words_max=6, proj_error=1e-4,
                        stop_diff=1e-4, max_iters=8),
        rgb_ksvd=KSVDConfig(dict_size=60, words_max=8, proj_error=1e-1,
                            stop_diff=1e-1, max_iters=8),
    )
    comp = ksvd_compressor.compress(jnp.asarray(pts, jnp.float64),
                                    jnp.asarray(cols, jnp.float64),
                                    jnp.ones(pts.shape[0], bool),
                                    cfg, jax.random.key(0))
    rms = ksvd_compressor.rms_error(comp)
    # corner voxels mix surfaces (bimodal depth in one 2.5-D patch) and
    # dominate the in-sample RMS — same operating point as the GP path
    assert rms < 0.08, rms

    # in-memory decompress
    w, c, ok = ksvd_compressor.decompress(comp)
    w = np.asarray(w)[np.asarray(ok)]
    assert np.isfinite(w).all() and w.shape[0] > 500

    # file round-trip decompress
    art = ksvd_compressor.to_artifact(comp)
    name = os.path.join(tmp_path, "scene")
    artifact_io.write(name, art)
    art2 = artifact_io.read(name)
    pts2, cols2 = ksvd_compressor.decompress_artifact(art2)
    assert pts2.shape[0] == w.shape[0]
    # same reconstruction through both paths
    d = np.sort(np.linalg.norm(pts2 - w[np.lexsort(w.T)][np.argsort(np.argsort(np.lexsort(pts2.T)))], axis=1)) if False else None
    # order-insensitive comparison: sorted rows equal
    def srt(a):
        return a[np.lexsort(a.T[::-1])]
    assert np.allclose(srt(pts2), srt(w), atol=1e-4)
