"""ops.linalg_f32: elementwise-only Cholesky/solves used by the
calibration posterior (the XLA Cholesky HLO's internal blocked matmuls run
at a backend-default precision below f32 — bf16, TF32 — which the near-rank-1
reference-constant Grams cannot survive; see ops/linalg_f32.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_compressor_jax.ops import linalg_f32


def _spd(n, seed=0, jitter=None):
    r = np.random.default_rng(seed)
    A = r.standard_normal((n, n))
    K = A @ A.T + (jitter if jitter is not None else n) * np.eye(n)
    return K


@pytest.mark.parametrize("n", [1, 5, 48, 64])
def test_cholesky_matches_numpy(n):
    K = _spd(n, seed=n)
    L = np.asarray(linalg_f32.cholesky(jnp.asarray(K)))
    Lref = np.linalg.cholesky(K)
    np.testing.assert_allclose(L, Lref, rtol=5e-6, atol=5e-6)


def test_solves_match_numpy():
    n = 48
    K = _spd(n, seed=3)
    L = np.linalg.cholesky(K)
    b = np.random.default_rng(1).standard_normal((n, 4))
    x = np.asarray(linalg_f32.cho_solve(jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(K, b), rtol=1e-5,
                               atol=1e-8)
    y = np.asarray(linalg_f32.solve_lower(jnp.asarray(L), jnp.asarray(b)))
    import scipy.linalg as sla
    np.testing.assert_allclose(y, sla.solve_triangular(L, b, lower=True),
                               rtol=1e-5, atol=1e-8)
    y1 = np.asarray(linalg_f32.solve_lower(jnp.asarray(L),
                                           jnp.asarray(b[:, 0])))
    np.testing.assert_allclose(y1, y[:, 0], rtol=1e-6)


def test_indefinite_produces_nan():
    n = 16
    K = _spd(n, seed=2) - 5 * n * np.eye(n)
    L = np.asarray(linalg_f32.cholesky(jnp.asarray(K)))
    assert np.isnan(L).any()


def test_cholesky_gradient_matches_reference():
    """d/dK sum(log diag chol(K)) == 0.5 K^-1 (symmetrized) for symmetric
    perturbations — validates AD through the fori_loop algorithm."""
    n = 12
    K = jnp.asarray(_spd(n, seed=5))

    def f(K):
        return jnp.sum(jnp.log(jnp.diagonal(linalg_f32.cholesky(K))))

    g = np.asarray(jax.grad(f)(K))
    Kinv = np.linalg.inv(np.asarray(K))
    # gradient w.r.t. an unconstrained K feeds only the lower triangle +
    # diagonal; compare action on symmetric perturbations
    r = np.random.default_rng(7)
    for _ in range(3):
        dK = r.standard_normal((n, n))
        dK = (dK + dK.T) / 2
        ana = np.sum(g * dK)
        ref = 0.5 * np.trace(Kinv @ dK)
        np.testing.assert_allclose(ana, ref, rtol=2e-4, atol=1e-7)


def test_closed_form_vjps_match_unrolled_ad():
    """The custom VJPs (Murray closed-form Cholesky adjoint, triangular-
    solve adjoints) must reproduce plain reverse AD through the fori_loop
    implementations for an arbitrary scalar functional."""
    n, k = 10, 3
    K = jnp.asarray(_spd(n, seed=11))
    r = np.random.default_rng(3)
    b = jnp.asarray(r.standard_normal((n, k)))
    w = jnp.asarray(r.standard_normal((n, k)))
    wl = jnp.asarray(r.standard_normal((n, n)))

    def with_custom(K, b):
        L = linalg_f32.cholesky(K)
        return (jnp.sum(wl * L)
                + jnp.sum(w * linalg_f32.solve_lower(L, b))
                + jnp.sum(w * linalg_f32.solve_lower_t(L, b))
                + jnp.sum(w * linalg_f32.cho_solve(L, b)))

    def with_unrolled(K, b):
        L = linalg_f32._chol_impl(K)
        return (jnp.sum(wl * L)
                + jnp.sum(w * linalg_f32._solve_lower_impl(L, b))
                + jnp.sum(w * linalg_f32._solve_lower_t_impl(L, b))
                + jnp.sum(w * linalg_f32._solve_lower_t_impl(
                    L, linalg_f32._solve_lower_impl(L, b))))

    gK1, gb1 = jax.grad(with_custom, argnums=(0, 1))(K, b)
    gK2, gb2 = jax.grad(with_unrolled, argnums=(0, 1))(K, b)
    np.testing.assert_allclose(np.asarray(gb1), np.asarray(gb2),
                               rtol=1e-6, atol=1e-9)
    # the closed-form Cholesky adjoint returns the SYMMETRIZED gradient;
    # unrolled AD through the algorithm feeds only tril(K). Compare their
    # action on symmetric perturbations (the only ones a Gram sees).
    g1 = np.asarray(gK1)
    g2 = np.asarray(gK2)
    for _ in range(3):
        dK = np.random.default_rng(5).standard_normal((n, n))
        dK = (dK + dK.T) / 2
        np.testing.assert_allclose(np.sum(g1 * dK), np.sum(g2 * dK),
                                   rtol=2e-5, atol=1e-8)


def test_vjps_under_vmap():
    """vmapped custom-VJP grads (the patch-bank shape) stay correct."""
    B, n = 4, 8
    Ks = jnp.stack([jnp.asarray(_spd(n, seed=20 + i)) for i in range(B)])
    ys = jnp.asarray(np.random.default_rng(9).standard_normal((B, n)))

    def nll(K, y):
        L = linalg_f32.cholesky(K)
        a = linalg_f32.cho_solve(L, y)
        return jnp.sum(y * a) + 2 * jnp.sum(jnp.log(jnp.diagonal(L)))

    def total(Ks, ys):
        return jnp.sum(jax.vmap(nll)(Ks, ys))

    def total_unrolled(Ks, ys):
        def nll_u(K, y):
            L = linalg_f32._chol_impl(K)
            a = linalg_f32._solve_lower_t_impl(
                L, linalg_f32._solve_lower_impl(L, y))
            return jnp.sum(y * a) + 2 * jnp.sum(jnp.log(jnp.diagonal(L)))
        return jnp.sum(jax.vmap(nll_u)(Ks, ys))

    gK1, g1 = jax.grad(total, argnums=(0, 1))(Ks, ys)
    gK2, g2 = jax.grad(total_unrolled, argnums=(0, 1))(Ks, ys)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-6, atol=1e-9)
    # K cotangent under vmap — the exact shape the NUTS/MAP patch-bank
    # posterior differentiates. The closed-form adjoint symmetrizes while
    # unrolled AD feeds only tril(K): compare the action on symmetric
    # perturbations, as in test_closed_form_vjps_match_unrolled_ad.
    rng = np.random.default_rng(5)
    for _ in range(3):
        dK = rng.standard_normal((B, n, n))
        dK = (dK + dK.transpose(0, 2, 1)) / 2
        np.testing.assert_allclose(np.sum(np.asarray(gK1) * dK),
                                   np.sum(np.asarray(gK2) * dK),
                                   rtol=2e-5, atol=1e-8)
