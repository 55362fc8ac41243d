"""Bayesian layer tests: HMC on known distributions, hyperparameter
recovery from synthetic GP draws, VI ELBO convergence, SMC pose tracking,
chain diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_compressor_jax.config import HMCConfig, SMCConfig
from gp_compressor_jax.inference import hmc, smc, vi
from gp_compressor_jax.ops import kernels
from gp_compressor_jax.ops.kernels import RBFParams


def test_hmc_samples_gaussian():
    """HMC must reproduce the moments of a correlated Gaussian."""
    cov = jnp.asarray([[1.0, 0.6], [0.6, 2.0]])
    prec = jnp.linalg.inv(cov)

    def logpost(th):
        return -0.5 * th @ prec @ th

    cfg = HMCConfig(num_warmup=200, num_samples=500, num_chains=4)
    theta0 = jax.random.normal(jax.random.key(1), (4, 2))
    samples, acc, eps = jax.jit(
        lambda t0, k: hmc.hmc_sample_chains(logpost, t0, k, cfg))(
            theta0, jax.random.key(0))
    s = np.asarray(samples).reshape(-1, 2)
    assert float(jnp.mean(acc)) > 0.5
    assert np.abs(s.mean(0)).max() < 0.15
    emp = np.cov(s.T)
    assert np.abs(emp - np.asarray(cov)).max() < 0.35, emp


def test_hmc_recovers_lengthscale():
    """Posterior over theta concentrates near the generating kernel."""
    r = np.random.default_rng(0)
    B, n = 8, 48
    true = RBFParams(sigmaf_sq=jnp.asarray(2.0), l_sq=jnp.asarray(0.25))
    s20_true = 0.01
    X = r.uniform(-1, 1, size=(B, n, 2))
    Y = np.zeros((B, n))
    for b in range(B):
        K = np.array(kernels.gram(true, jnp.asarray(X[b]), jnp.asarray(X[b])))
        K += s20_true * np.eye(n)
        Y[b] = r.multivariate_normal(np.zeros(n), K)
    logpost = hmc.make_patch_logpost(jnp.asarray(X), jnp.asarray(Y),
                                     jnp.ones((B, n)),
                                     prior_mean=(0.0, -1.0, -4.0),
                                     prior_std=4.0)
    cfg = HMCConfig(num_warmup=150, num_samples=150, num_chains=2)
    theta0 = jnp.asarray([[0.5, -0.5, -4.0], [1.0, -2.0, -5.0]])
    samples, acc, _ = hmc.hmc_sample_chains(logpost, theta0,
                                            jax.random.key(2), cfg)
    s = np.asarray(samples).reshape(-1, 3)
    # log l_sq posterior mean near ln 0.25 = -1.386
    assert abs(s[:, 1].mean() - np.log(0.25)) < 0.5, s.mean(0)
    # log s20 near ln 0.01 = -4.6
    assert abs(s[:, 2].mean() - np.log(0.01)) < 1.0, s.mean(0)


def test_rhat_near_one_for_stationary_chains():
    r = np.random.default_rng(1)
    x = jnp.asarray(r.standard_normal((4, 400, 3)))
    rh = hmc.split_rhat(x)
    assert np.all(np.asarray(rh) < 1.05)
    ess = hmc.effective_sample_size(x)
    assert np.all(np.asarray(ess) > 400)


def test_advi_fits_gaussian():
    cov = jnp.asarray([[0.5, 0.0], [0.0, 2.0]])
    prec = jnp.linalg.inv(cov)
    mu = jnp.asarray([1.0, -2.0])

    def logpost(th):
        d = th - mu
        return -0.5 * d @ prec @ d

    res = vi.fit_advi(logpost, jnp.zeros(2), jax.random.key(0), steps=400)
    assert np.allclose(np.asarray(res.mean), np.asarray(mu), atol=0.3)
    assert np.allclose(np.exp(2 * np.asarray(res.log_std)),
                       np.asarray(jnp.diagonal(cov)), rtol=0.4)
    # ELBO improves
    tr = np.asarray(res.elbo_trace)
    assert tr[-50:].mean() > tr[:50].mean()


def test_smc_tracks_pose():
    """Particles must concentrate near the pose that maximizes a synthetic
    likelihood centered at a known offset."""
    target = jnp.asarray([0.02, -0.01, 0.015, 0.0, 0.0, 0.0])

    def loglik(poses):
        return -0.5 * jnp.sum(((poses - target) / 0.01) ** 2, axis=-1)

    cfg = SMCConfig(num_particles=256, pose_proposal_std_t=0.005,
                    pose_proposal_std_r=0.002)
    st = smc.init_particles(cfg, jax.random.key(0))
    key = jax.random.key(1)
    for i in range(15):
        key, sub = jax.random.split(key)
        st, mean_pose = smc.smc_step(st, loglik, cfg, sub)
    err = np.linalg.norm(np.asarray(mean_pose[:3] - target[:3]))
    assert err < 0.01, (np.asarray(mean_pose), err)


def test_checkpoint_roundtrip(tmp_path):
    import os

    from gp_compressor_jax.config import GPConfig
    from gp_compressor_jax.io import checkpoint
    from gp_compressor_jax.models import sparse_gp
    from gp_compressor_jax.ops.noise import GaussianNoise

    cfg = GPConfig(capacity=10, slots=16, dtype=jnp.float64)
    kp = RBFParams(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))
    r = np.random.default_rng(0)
    st = sparse_gp.add_points(kp, GaussianNoise(s20=jnp.asarray(0.1)), cfg,
                              sparse_gp.init(cfg),
                              jnp.asarray(r.uniform(-1, 1, (20, 2))),
                              jnp.asarray(r.normal(size=(20, 1))))
    path = os.path.join(tmp_path, "gp.npz")
    checkpoint.save(path, st, meta={"kind": "sogp"})
    back = checkpoint.load(path, sparse_gp.init(cfg))
    for a, b in zip(st, back):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert checkpoint.load_meta(path)["kind"] == "sogp"


def test_nuts_samples_gaussian():
    from gp_compressor_jax.inference import nuts

    cov = jnp.asarray([[1.0, 0.7], [0.7, 2.0]])
    prec = jnp.linalg.inv(cov)

    def logpost(th):
        return -0.5 * th @ prec @ th

    cfg = HMCConfig(num_warmup=150, num_samples=400, max_tree_depth=6)
    theta0 = jax.random.normal(jax.random.key(3), (4, 2))
    samples, acc, eps = jax.jit(
        lambda t0, k: nuts.nuts_sample_chains(logpost, t0, k, cfg))(
            theta0, jax.random.key(4))
    s = np.asarray(samples).reshape(-1, 2)
    assert float(jnp.mean(acc)) > 0.5, float(jnp.mean(acc))
    assert np.abs(s.mean(0)).max() < 0.2, s.mean(0)
    emp = np.cov(s.T)
    assert np.abs(emp - np.asarray(cov)).max() < 0.4, emp
    rh = hmc.split_rhat(jnp.asarray(samples))
    assert np.all(np.asarray(rh) < 1.1), rh
