"""Exact-GP oracle tests: closed-form checks, mask invariance, batching."""

import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.models import exact_gp
from gp_compressor_jax.ops.kernels import RBFParams

KP = RBFParams(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))
S20 = 0.1


def _dense_reference(X, y, Xs):
    """Direct NumPy solve of the textbook equations
    (gaussian_process.cpp:15-45 semantics)."""
    d2 = ((X[:, None] - X[None, :]) ** 2).sum(-1)
    K = 100.0 * np.exp(-0.5 * d2) + S20 * np.eye(len(X))
    a = np.linalg.solve(K, y)
    d2s = ((X[:, None] - Xs[None, :]) ** 2).sum(-1)
    Ks = 100.0 * np.exp(-0.5 * d2s)
    mean = Ks.T @ a
    var = 100.0 - np.einsum('nm,nk,km->m', Ks, np.linalg.inv(K), Ks)
    return mean, var


def test_matches_dense_solve():
    r = np.random.default_rng(0)
    X = r.normal(size=(20, 2))
    y = np.sin(X[:, 0]) + 0.1 * r.normal(size=20)
    Xs = r.normal(size=(7, 2))
    st = exact_gp.fit(KP, S20, jnp.asarray(X), jnp.asarray(y)[:, None],
                      jnp.ones(20))
    mean, var = exact_gp.predict(KP, st, jnp.asarray(Xs))
    rmean, rvar = _dense_reference(X, y, Xs)
    assert np.allclose(np.asarray(mean)[:, 0], rmean, atol=1e-8)
    assert np.allclose(np.asarray(var), rvar, atol=1e-6)


def test_mask_invariance():
    """Padded rows must not affect predictions."""
    r = np.random.default_rng(1)
    X = r.normal(size=(10, 2))
    y = r.normal(size=(10, 1))
    Xs = r.normal(size=(5, 2))
    st_full = exact_gp.fit(KP, S20, jnp.asarray(X), jnp.asarray(y), jnp.ones(10))
    m1, v1 = exact_gp.predict(KP, st_full, jnp.asarray(Xs))

    Xp = np.vstack([X, r.normal(size=(6, 2))])
    yp = np.vstack([y, r.normal(size=(6, 1))])
    mask = np.concatenate([np.ones(10), np.zeros(6)])
    st_pad = exact_gp.fit(KP, S20, jnp.asarray(Xp), jnp.asarray(yp),
                          jnp.asarray(mask))
    m2, v2 = exact_gp.predict(KP, st_pad, jnp.asarray(Xs))
    assert np.allclose(np.asarray(m1), np.asarray(m2), atol=1e-9)
    assert np.allclose(np.asarray(v1), np.asarray(v2), atol=1e-9)


def test_interpolates_training_data():
    """With tiny noise the posterior mean passes through the data."""
    r = np.random.default_rng(2)
    X = r.uniform(-1, 1, size=(15, 2))
    y = np.cos(2 * X[:, 0]) * X[:, 1]
    st = exact_gp.fit(KP, 1e-8, jnp.asarray(X), jnp.asarray(y)[:, None],
                      jnp.ones(15))
    mean, var = exact_gp.predict(KP, st, jnp.asarray(X))
    assert np.allclose(np.asarray(mean)[:, 0], y, atol=1e-4)
    assert np.all(np.asarray(var) < 1e-4)


def test_batched_fit_predict():
    r = np.random.default_rng(3)
    X = r.normal(size=(4, 12, 2))
    y = r.normal(size=(4, 12, 1))
    mask = np.ones((4, 12))
    Xs = r.normal(size=(4, 6, 2))
    st = exact_gp.fit_batch(KP, S20, jnp.asarray(X), jnp.asarray(y),
                            jnp.asarray(mask))
    mean, var = exact_gp.predict_batch(KP, st, jnp.asarray(Xs))
    assert mean.shape == (4, 6, 1) and var.shape == (4, 6)
    for b in range(4):
        stb = exact_gp.fit(KP, S20, jnp.asarray(X[b]), jnp.asarray(y[b]),
                           jnp.ones(12))
        mb, vb = exact_gp.predict(KP, stb, jnp.asarray(Xs[b]))
        assert np.allclose(np.asarray(mean[b]), np.asarray(mb), atol=1e-9)
        assert np.allclose(np.asarray(var[b]), np.asarray(vb), atol=1e-9)
