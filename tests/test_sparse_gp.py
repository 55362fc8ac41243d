"""Sparse-GP parity tests.

The padded/masked device state (models.sparse_gp) must track the serial
float64 oracle (models.oracle, an independent re-derivation of
src/sparse_gp.hpp:90-295) update-for-update, including full/sparse branch
selection, capacity deletion and downdates; and must approximate the exact
Cholesky GP (the reference's in-tree oracle, src/gaussian_process.cpp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_compressor_jax.config import GPConfig
from gp_compressor_jax.models import exact_gp, sparse_gp
from gp_compressor_jax.models.oracle import SerialSOGP
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.ops.noise import GaussianNoise

KP = RBFParams(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))


def make(capacity=100, slots=128, dout=1, s20=1e-1):
    cfg = GPConfig(capacity=capacity, slots=slots, dout=dout, s20=s20,
                   dtype=jnp.float64)
    return cfg, GaussianNoise(s20=jnp.asarray(s20))


def dense_state(state):
    """Extract the active sub-blocks in slot order for oracle comparison."""
    act = np.asarray(state.active)
    idx = np.nonzero(act)[0]
    return (np.asarray(state.bv)[idx],
            np.asarray(state.alpha)[idx],
            np.asarray(state.C)[np.ix_(idx, idx)],
            np.asarray(state.Q)[np.ix_(idx, idx)])


def sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


def test_first_point_closed_form():
    """First insertion: alpha = y/(k**+s20), C = -1/(k**+s20), Q = 1/k**
    (src/sparse_gp.hpp:100-113) — must fall out of the general update."""
    cfg, noise = make()
    st = sparse_gp.init(cfg)
    st = sparse_gp.add_point(KP, noise, cfg, st, jnp.array([0.3, -0.2]),
                             jnp.array([1.7]))
    bv, alpha, C, Q = dense_state(st)
    assert bv.shape == (1, 2)
    assert np.isclose(alpha[0, 0], 1.7 / 100.1, atol=1e-12)
    assert np.isclose(C[0, 0], -1.0 / 100.1, atol=1e-12)
    assert np.isclose(Q[0, 0], 1.0 / 100.0, atol=1e-12)


@pytest.mark.parametrize("n,capacity", [(30, 100), (60, 25), (120, 40)])
def test_matches_serial_oracle_well_conditioned(n, capacity):
    """Update-for-update parity incl. deletions, same insertion order.

    Points are spread over several lengthscales so the BV Gram stays
    well-conditioned and Q (its inverse) is numerically stable — in this
    regime the padded/masked implementation must track the oracle to
    near machine precision, including every full/sparse branch and
    capacity-deletion decision.
    """
    r = np.random.default_rng(42)
    X = r.uniform(-5.0, 5.0, size=(n, 2))
    y = np.sin(1.5 * X[:, 0]) * np.cos(X[:, 1]) + 0.05 * r.normal(size=n)

    cfg, noise = make(capacity=capacity, slots=max(capacity + 1, 64))
    st = sparse_gp.init(cfg)
    st = sparse_gp.add_points(KP, noise, cfg, st, jnp.asarray(X),
                              jnp.asarray(y)[:, None])

    o = SerialSOGP(capacity=capacity)
    o.add_measurements(X, y)

    assert int(sparse_gp.size(st)) == o.size
    bv, alpha, C, Q = dense_state(st)
    # Our masked delete keeps surviving slots in place while the oracle
    # swap-compacts, so compare as sets of BVs and via predictions.
    assert np.allclose(sorted_rows(bv), sorted_rows(o.bv), atol=1e-8)

    Xs = r.uniform(-5.0, 5.0, size=(17, 2))
    mean, var = sparse_gp.predict(KP, cfg.s20, st, jnp.asarray(Xs))
    omean, ovar = o.predict(Xs)
    assert np.allclose(np.asarray(mean), omean, atol=1e-8)
    assert np.allclose(np.asarray(var), ovar, atol=1e-8)


def test_tracks_serial_oracle_ill_conditioned():
    """The reference's own operating regime: patch coords within one
    lengthscale (l_sq=1, |uv| <= 0.5) make the BV Gram ill-conditioned, so
    Q = K^-1 updates are chaotic — two float64 implementations of the same
    equations legitimately diverge in *which* points become BVs. What must
    agree is the posterior itself: predictions and BV budget, not raw state.
    (This is why GP-path RMSE, not state equality, is the end-to-end
    metric — SURVEY.md §6.)"""
    r = np.random.default_rng(42)
    n, capacity = 200, 40
    X = r.uniform(-0.5, 0.5, size=(n, 2))
    y = np.sin(4 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * r.normal(size=n)

    cfg, noise = make(capacity=capacity, slots=64)
    st = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                              jnp.asarray(X), jnp.asarray(y)[:, None])
    o = SerialSOGP(capacity=capacity)
    o.add_measurements(X, y)

    assert abs(int(sparse_gp.size(st)) - o.size) <= 4
    Xs = r.uniform(-0.4, 0.4, size=(50, 2))
    mean, _ = sparse_gp.predict(KP, cfg.s20, st, jnp.asarray(Xs))
    omean, _ = o.predict(Xs)
    # both are approximations of the same smooth posterior mean
    assert np.sqrt(np.mean((np.asarray(mean)[:, 0] - omean[:, 0]) ** 2)) < 0.05


def test_matches_serial_oracle_vector_output():
    """dout=3 field GP (sparse_gp_field semantics, with the delete_bv
    scaling bug fixed — src/sparse_gp_field.hpp:250)."""
    r = np.random.default_rng(7)
    n = 120
    X = r.uniform(-5.0, 5.0, size=(n, 2))
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1]),
                  0.1 * X[:, 0] * X[:, 1]], axis=-1) + 0.05 * r.normal(size=(n, 3))

    cfg, noise = make(capacity=30, slots=64, dout=3, s20=1e-1)
    st = sparse_gp.init(cfg)
    st = sparse_gp.add_points(KP, noise, cfg, st, jnp.asarray(X), jnp.asarray(Y))

    o = SerialSOGP(capacity=30, dout=3)
    o.add_measurements(X, Y)

    assert int(sparse_gp.size(st)) == o.size
    Xs = r.uniform(-5.0, 5.0, size=(9, 2))
    mean, var = sparse_gp.predict(KP, cfg.s20, st, jnp.asarray(Xs))
    omean, ovar = o.predict(Xs)
    assert np.allclose(np.asarray(mean), omean, atol=1e-7)
    assert np.allclose(np.asarray(var), ovar, atol=1e-7)


def test_padding_mask_is_noop():
    cfg, noise = make(capacity=50, slots=64)
    r = np.random.default_rng(3)
    X = r.uniform(-0.5, 0.5, size=(40, 2))
    y = r.normal(size=(40, 1))
    st1 = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                               jnp.asarray(X), jnp.asarray(y))
    Xp = np.vstack([X, np.zeros((24, 2))])
    yp = np.vstack([y, np.ones((24, 1))])
    mask = np.concatenate([np.ones(40), np.zeros(24)]).astype(bool)
    st2 = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                               jnp.asarray(Xp), jnp.asarray(yp),
                               jnp.asarray(mask))
    for a, b in zip(st1, st2):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=0)


def test_approximates_exact_gp():
    """With capacity >= n and well-separated points, sparse == exact GP.

    This is the reference's own oracle relationship: gaussian_process is the
    exact semantics the sparse path approximates (SURVEY.md §3.5).
    """
    r = np.random.default_rng(11)
    n = 40
    X = r.uniform(-0.5, 0.5, size=(n, 2))
    y = np.sin(4 * X[:, 0]) + 0.05 * r.normal(size=n)

    cfg, noise = make(capacity=100, slots=128)
    st = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                              jnp.asarray(X), jnp.asarray(y)[:, None])
    est = exact_gp.fit(KP, cfg.s20, jnp.asarray(X), jnp.asarray(y)[:, None],
                       jnp.ones(n))
    Xs = r.uniform(-0.5, 0.5, size=(25, 2))
    smean, svar = sparse_gp.predict(KP, cfg.s20, st, jnp.asarray(Xs))
    emean, evar = exact_gp.predict(KP, est, jnp.asarray(Xs))
    # sparse predictive var includes observation noise s20; exact is latent
    # tolerance reflects the sparse approximation itself, not fp error:
    # in this correlated regime the online posterior differs from the batch
    # posterior by a few percent of the function scale
    dmean = np.abs(np.asarray(smean)[:, 0] - np.asarray(emean)[:, 0])
    assert np.median(dmean) < 2e-2 and dmean.max() < 0.25, dmean
    dvar = np.abs(np.asarray(svar) - np.asarray(evar) - cfg.s20)
    assert np.median(dvar) < 5e-2 and dvar.max() < 0.3, dvar


def test_batched_matches_single():
    # well-spread points: vmap changes fp reduction order, and in the
    # ill-conditioned regime that flips data-dependent branches (see
    # test_tracks_serial_oracle_ill_conditioned) — here we verify the
    # batching itself is exact.
    cfg, noise = make(capacity=20, slots=32)
    r = np.random.default_rng(5)
    B, n = 6, 50
    X = r.uniform(-5.0, 5.0, size=(B, n, 2))
    Y = r.normal(size=(B, n, 1))
    mask = np.ones((B, n), bool)
    states = sparse_gp.init_batch(cfg, B)
    out = sparse_gp.add_points_batch(KP, noise, cfg, states, jnp.asarray(X),
                                     jnp.asarray(Y), jnp.asarray(mask))
    for b in range(B):
        stb = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                                   jnp.asarray(X[b]), jnp.asarray(Y[b]))
        for a, s in zip(jax.tree.leaves(stb), [l[b] for l in jax.tree.leaves(out)]):
            assert np.allclose(np.asarray(a), np.asarray(s), atol=1e-12)


def test_likelihood_dx_matches_finite_difference():
    cfg, noise = make(capacity=60, slots=64)
    r = np.random.default_rng(13)
    X = r.uniform(-0.4, 0.4, size=(60, 2))
    y = np.sin(3 * X[:, 0]) + 0.05 * r.normal(size=60)
    st = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                              jnp.asarray(X), jnp.asarray(y)[:, None])
    Xq = r.uniform(-0.3, 0.3, size=(5, 2))
    yq = r.normal(size=(5, 1))
    dX = np.asarray(sparse_gp.likelihood_dx(KP, cfg.s20, st, jnp.asarray(Xq),
                                            jnp.asarray(yq)))
    eps = 1e-4  # larger eps: the density spans orders of magnitude and
    # centered differences at 1e-6 suffer catastrophic cancellation

    def dens(xq, yv):
        m, v = sparse_gp.predict(KP, cfg.s20, st, jnp.asarray(xq[None]))
        m, v = float(m[0, 0]), float(v[0])
        return np.exp(-0.5 * np.log(2 * np.pi * v) - 0.5 * (yv - m) ** 2 / v)

    for i in range(5):
        fd_y = (dens(Xq[i], yq[i, 0] + eps) - dens(Xq[i], yq[i, 0] - eps)) / (2 * eps)
        assert np.isclose(dX[i, 0], fd_y, rtol=2e-2, atol=1e-8)
        for d in range(2):
            dx = np.zeros(2)
            dx[d] = eps
            fd = (dens(Xq[i] + dx, yq[i, 0]) - dens(Xq[i] - dx, yq[i, 0])) / (2 * eps)
            assert np.isclose(dX[i, 1 + d], fd, rtol=2e-2, atol=1e-8)


def test_log_likelihood_matches_density():
    cfg, noise = make(capacity=30, slots=32)
    r = np.random.default_rng(17)
    X = r.uniform(-0.4, 0.4, size=(30, 2))
    y = r.normal(size=(30, 1))
    st = sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg),
                              jnp.asarray(X), jnp.asarray(y))
    Xq = jnp.asarray(r.uniform(-0.3, 0.3, size=(4, 2)))
    yq = jnp.asarray(r.normal(size=(4, 1)))
    ll = sparse_gp.log_likelihood(KP, cfg.s20, st, Xq, yq)
    li = sparse_gp.likelihood(KP, cfg.s20, st, Xq, yq)
    assert np.allclose(np.exp(np.asarray(ll)), np.asarray(li), rtol=1e-10)


def test_float32_stability_with_noise_floor_threshold():
    """f32 operating point: eps_tol above the f32 cancellation noise floor
    plus the s2 >= gamma invariant clamp must keep every patch finite and
    accurate on correlated (reference-regime) data."""
    r = np.random.default_rng(21)
    B, n = 64, 150
    X = r.uniform(-0.075, 0.075, size=(B, n, 2))           # res=0.15 patches
    f = (np.sin(8 * X[..., 0]) * 0.03 + 0.02 * np.cos(11 * X[..., 1]))
    Y = (f + 0.004 * r.standard_normal((B, n)))[..., None]
    cfg = GPConfig(capacity=30, slots=32, eps_tol=2.0, dtype=jnp.float32)
    noise = GaussianNoise(s20=jnp.asarray(0.1, jnp.float32))
    states = sparse_gp.init_batch(cfg, B)
    states = sparse_gp.add_points_batch(
        KP, noise, cfg, states, jnp.asarray(X, jnp.float32),
        jnp.asarray(Y, jnp.float32), jnp.ones((B, n), bool))
    states, n_bad = sparse_gp.sanitize_batch(states)
    # the rare patch can still leave the stable manifold; sanitize resets it
    assert int(n_bad) <= 3, int(n_bad)
    mean, var = sparse_gp.predict_batch(KP, cfg.s20, states,
                                        jnp.asarray(X, jnp.float32))
    rmse = float(jnp.sqrt(jnp.mean((mean - jnp.asarray(Y, jnp.float32)) ** 2)))
    assert np.isfinite(rmse) and rmse < 0.1, rmse


def test_sanitize_batch_resets_nonfinite():
    cfg = GPConfig(capacity=10, slots=16, dtype=jnp.float64)
    states = sparse_gp.init_batch(cfg, 4)
    C = states.C.at[2, 0, 0].set(jnp.nan)
    alpha = states.alpha.at[1, 0, 0].set(jnp.inf)
    states = states._replace(C=C, alpha=alpha,
                             active=states.active.at[:, 0].set(True))
    fixed, n_bad = sparse_gp.sanitize_batch(states)
    assert int(n_bad) == 2
    assert np.isfinite(np.asarray(fixed.C)).all()
    assert not bool(fixed.active[1].any()) and not bool(fixed.active[2].any())
    assert bool(fixed.active[0, 0]) and bool(fixed.active[3, 0])


def test_per_point_eps_tol_forces_and_blocks():
    """eps_tol as a per-point vector: -inf forces a full update (the point
    becomes a BV), +inf forces the sparse projection (it never does)."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import GPConfig
    from gp_compressor_jax.ops.kernels import RBFParams
    from gp_compressor_jax.ops.noise import GaussianNoise

    cfg = GPConfig(capacity=10, slots=16, dtype=jnp.float64)
    kp = RBFParams(sigmaf_sq=jnp.asarray(1.0), l_sq=jnp.asarray(0.01))
    noise = GaussianNoise(s20=jnp.asarray(0.1))
    X = jnp.asarray([[0.0, 0.0], [0.05, 0.0], [0.1, 0.0], [0.0, 0.05]])
    Y = jnp.asarray([[0.1], [0.2], [0.15], [0.05]])
    big = jnp.asarray(1e300)
    eps = jnp.asarray([-1e300, 1e300, -1e300, 1e300])
    st = sparse_gp.add_points(kp, noise, cfg, sparse_gp.init(cfg), X, Y,
                              eps_tol=eps)
    assert int(sparse_gp.size(st)) == 2
    bv = np.asarray(st.bv)[np.asarray(st.active)]
    assert any(np.allclose(b, [0.0, 0.0]) for b in bv)
    assert any(np.allclose(b, [0.1, 0.0]) for b in bv)
