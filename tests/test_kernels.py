"""Math-core unit tests: RBF kernel forms vs autodiff, noise models vs
autodiff of the log density — the L1 contract of SURVEY.md §1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_compressor_jax.ops import kernels, noise
from gp_compressor_jax.ops.kernels import RBFParams

KP = RBFParams(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))


def rng(seed=0):
    return np.random.default_rng(seed)


def test_gram_matches_direct():
    r = rng()
    X = jnp.asarray(r.normal(size=(7, 2)))
    Z = jnp.asarray(r.normal(size=(5, 2)))
    K = kernels.gram(KP, X, Z)
    for i in range(7):
        for j in range(5):
            d2 = float(jnp.sum((X[i] - Z[j]) ** 2))
            assert np.isclose(float(K[i, j]), 100.0 * np.exp(-0.5 * d2), rtol=1e-12)


def test_kdiag():
    X = jnp.zeros((4, 2))
    assert np.allclose(np.asarray(kernels.kdiag(KP, X)), 100.0)


def test_gram_dx_matches_autodiff():
    r = rng(1)
    X = jnp.asarray(r.normal(size=(3, 2)))
    Z = jnp.asarray(r.normal(size=(4, 2)))
    D = kernels.gram_dx(KP, X, Z)

    def kfun(x, z):
        return KP.sigmaf_sq * jnp.exp(-0.5 / KP.l_sq * jnp.sum((x - z) ** 2))

    for i in range(3):
        for j in range(4):
            g = jax.grad(kfun)(X[i], Z[j])
            assert np.allclose(np.asarray(D[i, j]), np.asarray(g), atol=1e-10)


def test_gram_dtheta_matches_autodiff():
    r = rng(2)
    X = jnp.asarray(r.normal(size=(3, 2)))
    Z = jnp.asarray(r.normal(size=(4, 2)))
    D = kernels.gram_dtheta(KP, X, Z)

    def kfun(p, x, z):
        return p[0] * jnp.exp(-0.5 / p[1] * jnp.sum((x - z) ** 2))

    p0 = jnp.array([100.0, 1.0])
    for i in range(3):
        for j in range(4):
            g = jax.grad(kfun)(p0, X[i], Z[j])
            assert np.allclose(np.asarray(D[i, j]), np.asarray(g), atol=1e-10)


def test_gaussian_noise_matches_autodiff():
    """dx_ln / dx2_ln are d/dm and d2/dm2 of ln integral N(y; m, s20 + s2)
    (reference closed forms src/gaussian_noise.cpp:9-18)."""
    gn = noise.GaussianNoise(s20=jnp.asarray(0.1))
    y, m, s2 = jnp.asarray([1.3]), jnp.asarray([0.4]), jnp.asarray(2.0)

    def ln_p(mm):
        return jnp.sum(noise.gaussian_log_pdf(y, mm, gn.s20 + s2))

    g1 = jax.grad(ln_p)(m)
    g2 = jax.grad(lambda mm: jax.grad(ln_p)(mm)[0])(m)[0]
    assert np.allclose(np.asarray(gn.dx_ln(y, m, s2)), np.asarray(g1), atol=1e-12)
    assert np.allclose(float(gn.dx2_ln(y, m, s2)), float(g2), atol=1e-12)


def test_probit_noise_finite():
    pn = noise.ProbitNoise(s20=jnp.asarray(0.1))
    y = jnp.asarray([1.0])
    m = jnp.asarray([0.3])
    s2 = jnp.asarray(0.5)
    assert np.isfinite(float(pn.dx_ln(y, m, s2)[0]))
    assert np.isfinite(float(pn.dx2_ln(y, m, s2)))
