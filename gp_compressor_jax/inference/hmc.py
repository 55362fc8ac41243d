"""HMC / NUTS over GP kernel hyperparameters — a new capability.

The reference fixes (sigmaf^2, l^2, s20) as constructor constants
(src/rbf_kernel.h:24, src/sparse_gp.h:48); its only gesture at learning
them is the abandoned `train_parameters` gradient loop that plots with
octave and calls exit(0) (src/sparse_gp.hpp:586-650). Here the hyperparams
get full Bayesian treatment per BASELINE.json's north star: a vectorized
log posterior over the patch bank (exact GP marginal likelihood, batched
Cholesky), gradient-based samplers (HMC with dual-averaging
step-size adaptation and a NUTS-style dynamic trajectory variant), chains
`vmap`-ed and shardable over the mesh `chain` axis; cross-chain statistics
(adaptation, diagnostics) are plain reductions that lower to psum.

theta parameterization: unconstrained logs,
theta = (ln sigmaf_sq, ln l_sq, ln s20).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_compressor_jax.config import HMCConfig
from gp_compressor_jax.ops import kernels
from gp_compressor_jax.ops.kernels import RBFParams


# ---------------------------------------------------------------------------
# log posterior over the patch bank
# ---------------------------------------------------------------------------

def gp_marginal_loglik(theta: jnp.ndarray, X: jnp.ndarray, y: jnp.ndarray,
                       mask: jnp.ndarray,
                       noise_floor_rel: float = 0.0) -> jnp.ndarray:
    """Exact GP marginal log-likelihood of one patch.

    ln N(y; 0, K + s20 I) with the masked-row decoupling of
    models.exact_gp. X: [n, d], y: [n], mask: [n]. The Cholesky dominates
    — batched over patches it runs as one [B, n, n] factorization.

    noise_floor_rel > 0 adds a noise floor RELATIVE to the signal
    variance (s20_eff = s20 + floor * sigmaf_sq), bounding the Gram
    condition number at n / floor independent of where a sampler wanders.
    In float32 the unfloored posterior mode sits past the conditioning
    cliff (s20 -> ~1e-4 with sigmaf ~ 50 gives cond ~ 1e7 > 1/eps_f32):
    every proposal near the mode factorizes to NaN, the -inf guard rejects
    it, and dual averaging collapses the step size to zero. The floor is a
    numerical prior: noise below ~floor * sigma_f^2 is indistinguishable
    in f32 anyway.
    """
    from gp_compressor_jax.ops import linalg_f32

    sigmaf_sq, l_sq, s20 = jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2])
    s20 = s20 + noise_floor_rel * sigmaf_sq
    kp = RBFParams(sigmaf_sq=sigmaf_sq, l_sq=l_sq)
    n = X.shape[0]
    m2 = mask[:, None] * mask[None, :]
    K = kernels.gram(kp, X, X) * m2 + jnp.diag(jnp.where(mask > 0, s20, 1.0))
    # Cholesky + solves via ops.linalg_f32: the XLA Cholesky HLO's internal
    # blocked expansion (and its AD rules) run dot_generals at backend-
    # default precision — TF32 on a GPU, bf16 on some accelerators — and
    # at the near-rank-1 reference-constant Gram (K ~ 100*J + 0.11*I) a
    # bf16 default wrecked the posterior (measured: NUTS at accept=NaN /
    # R-hat 28 against 0.92/1.08 for the same chains in exact f32). The
    # elementwise-only routines are exactly reproducible across backends,
    # forward and backward.
    #
    # Safe Cholesky WITHOUT a trial factorization: a proposal only breaks
    # the f32 factorization when the Gram's condition number nears 1/eps,
    # and K = sigmaf^2 C + s20_eff I with PSD C, ||C||_2 <= n bounds it a
    # priori: cond <= 1 + n sigmaf^2 / s20_eff. Gating on that bound
    # replaces the old factor-twice double-where (an L_try pass existed
    # purely to DETECT NaN) with one factorization — the gate is exact
    # arithmetic in theta, so value AND gradient stay clean, and with the
    # relative noise floor the bound keeps every floored proposal ~8x
    # below the f32 breakdown (n/floor = 6.4e5 vs 2e6 threshold), i.e. the
    # reject branch is a numerical prior that floored runs never hit.
    neff = jnp.sum(mask)
    cond_cap = 2e6 if K.dtype == jnp.float32 else 1e12
    bad = sigmaf_sq * neff / s20 > cond_cap
    K_safe = jnp.where(bad, jnp.eye(n, dtype=K.dtype), K)
    L = linalg_f32.cholesky(K_safe)
    ym = y * mask
    alpha = linalg_f32.cho_solve(L, ym)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)) * mask)
    quad = jnp.sum(ym * alpha)
    ll = -0.5 * (quad + logdet + neff * jnp.log(2.0 * jnp.pi))
    # belt-and-suspenders: an unexpected non-finite factorization still
    # yields -inf (its gradient is sanitized at the sampler/optimizer
    # choke points — nuts._safe_vag)
    return jnp.where(bad | ~jnp.isfinite(ll),
                     jnp.asarray(-jnp.inf, ll.dtype), ll)


def make_patch_logpost(X: jnp.ndarray, y: jnp.ndarray, mask: jnp.ndarray,
                       prior_mean=(4.6, 0.0, -2.3), prior_std=3.0,
                       noise_floor_rel: Optional[float] = None
                       ) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Posterior over shared hyperparams given a bank of patches.

    X: [B, n, d], y: [B, n], mask: [B, n]. The sum over the (sharded)
    patch axis is the reduction that rides psum on a mesh. Default prior
    centers on the reference's constants (sigmaf^2=100, l^2=1, s20=0.1).
    noise_floor_rel: see gp_marginal_loglik; None picks 1e-4 for float32
    inputs (the f32 conditioning floor) and 0 for float64.
    """
    pm = jnp.asarray(prior_mean, X.dtype)
    if noise_floor_rel is None:
        noise_floor_rel = 1e-4 if X.dtype == jnp.float32 else 0.0

    def logpost(theta):
        ll = jnp.sum(jax.vmap(
            gp_marginal_loglik, in_axes=(None, 0, 0, 0, None))(
            theta, X, y, mask, noise_floor_rel))
        lp = jnp.sum(-0.5 * ((theta - pm) / prior_std) ** 2)
        out = ll + lp
        # a float32 Cholesky goes NaN when a sampler wanders to extreme
        # (sigmaf, l) where the Gram is numerically singular; -inf makes
        # the proposal rejected instead of poisoning the chain state
        return jnp.where(jnp.isfinite(out), out,
                         jnp.asarray(-jnp.inf, out.dtype))

    return logpost


def map_estimate(logpost: Callable, theta0: jnp.ndarray, steps: int = 200,
                 lr: float = 5e-2):
    """Type-II maximum-a-posteriori hyperparameter fit by gradient ascent on
    the same patch-bank log posterior — the working replacement for the
    reference's abandoned train_parameters gradient loop
    (src/sparse_gp.hpp:586-650, which plots with octave and exit(0)s).

    The whole ascent is ONE lax.scan under one jit — a single device
    dispatch instead of `steps` host round trips. Returns (theta, logpost trace)."""
    import optax

    from gp_compressor_jax.inference.nuts import _safe_vag

    opt = optax.adam(lr)
    vag = _safe_vag(logpost)   # -inf/0 on non-finite posterior or gradient

    @functools.partial(jax.jit, static_argnames=("n",))
    def run(theta0, n):
        def body(carry, _):
            theta, state = carry
            lp, g = vag(theta)
            updates, state = opt.update(jax.tree.map(lambda x: -x, g), state)
            theta = jax.tree.map(lambda a, b: a + b, theta, updates)
            return (theta, state), lp

        (theta, _), trace = lax.scan(body, (theta0, opt.init(theta0)),
                                     None, length=n)
        return theta, trace

    return run(theta0, steps)


# log-space start offsets for the multi-start ascent, spanning the scale
# regimes the patch-bank posterior actually has modes in (reference-scale,
# cm-scale, mm-scale, amplified) — measured: the plain start needs ~4x the
# steps of the best offset and still lands in a worse basin
MAP_START_OFFSETS = ((0.0, 0.0, 0.0), (-3.0, -3.0, -2.0),
                     (-6.0, -5.0, -4.0), (2.0, 1.0, 1.0))


def map_estimate_multi(logpost: Callable, theta0: jnp.ndarray,
                       steps: int = 150, lr: float = 0.1,
                       n_starts: int = 4, theta_init=None,
                       starts_sharding=None):
    """Multi-start MAP: vmap the Adam ascent over `n_starts` log-space
    offsets of theta0 and keep the best final log posterior.

    Rationale (measured on the bench posterior): from the reference
    constants the single ascent rides a slow ridge — 400 steps at lr 0.1
    are still in transit (logpost 4840) while a cm-scale start converges
    within 100 steps to a better mode (5017). The starts share one
    `lax.scan` (vmapped), so wall cost is ~one ascent of `steps` steps —
    sequential-step latency, not FLOPs, dominates at these sizes.

    theta_init: optional traced warm start (e.g. the previous cloud's
    calibration) replacing the first offset — the production steady state
    needs far fewer steps (see compress_decompress_calibrated).
    starts_sharding: optional NamedSharding for the start axis (e.g.
    P("chain") on the session mesh) — the vmapped ascents are mutually
    independent, so constraining the starts shards the whole multi-start
    search chain-parallel with zero collectives until the final argmax.
    Returns (best theta, final logposts [n_starts])."""
    offs = jnp.asarray(MAP_START_OFFSETS, theta0.dtype)[:n_starts]
    starts = theta0[None, :] + offs
    if theta_init is not None:
        starts = starts.at[0].set(jnp.asarray(theta_init, theta0.dtype))
    if starts_sharding is not None:
        starts = lax.with_sharding_constraint(starts, starts_sharding)

    import optax

    from gp_compressor_jax.inference.nuts import _safe_vag

    opt = optax.adam(lr)
    vag = _safe_vag(logpost)

    def one(theta0):
        def body(carry, _):
            theta, state = carry
            lp, g = vag(theta)
            updates, state = opt.update(jax.tree.map(lambda x: -x, g), state)
            theta = jax.tree.map(lambda a, b: a + b, theta, updates)
            return (theta, state), lp

        (theta, _), _ = lax.scan(body, (theta0, opt.init(theta0)),
                                 None, length=steps)
        return theta, logpost(theta)

    thetas, lps = jax.vmap(one)(starts)
    best = jnp.argmax(jnp.where(jnp.isfinite(lps), lps, -jnp.inf))
    return thetas[best], lps


# ---------------------------------------------------------------------------
# HMC with dual-averaging warmup
# ---------------------------------------------------------------------------

class HMCChainState(NamedTuple):
    theta: jnp.ndarray
    logp: jnp.ndarray
    grad: jnp.ndarray
    step_size: jnp.ndarray
    # dual averaging stats (Hoffman & Gelman 2014, eq. 6)
    h_bar: jnp.ndarray
    log_eps_bar: jnp.ndarray
    mu: jnp.ndarray
    inv_mass: jnp.ndarray
    accept_prob: jnp.ndarray


def _leapfrog(logpost_grad, theta, p, grad, eps, inv_mass, n_steps):
    def body(_, carry):
        th, p, g = carry
        p = p + 0.5 * eps * g
        th = th + eps * inv_mass * p
        lp, g = logpost_grad(th)
        p = p + 0.5 * eps * g
        return th, p, g

    th, p, g = lax.fori_loop(0, n_steps, body, (theta, p, grad))
    return th, p, g


def hmc_warmup_and_sample(logpost: Callable, theta0: jnp.ndarray,
                          key: jax.Array, cfg: HMCConfig,
                          n_leapfrog: int = 16):
    """Single-chain HMC: dual-averaging warmup then fixed-step sampling.
    Returns (samples [num_samples, dim], accept_rate, final_step)."""
    from gp_compressor_jax.inference.nuts import _safe_vag
    lg = _safe_vag(logpost)   # -inf/0 on non-finite (see nuts._safe_vag)

    dim = theta0.shape[0]
    lp0, g0 = lg(theta0)
    eps0 = jnp.asarray(cfg.init_step_size)
    st = HMCChainState(
        theta=theta0, logp=lp0, grad=g0, step_size=eps0,
        h_bar=jnp.asarray(0.0), log_eps_bar=jnp.asarray(0.0),
        mu=jnp.log(10.0 * eps0), inv_mass=jnp.ones(dim),
        accept_prob=jnp.asarray(0.0))

    gamma, t0, kappa = 0.05, 10.0, 0.75

    def step(st: HMCChainState, key, adapt, m):
        k1, k2 = jax.random.split(key)
        p0 = jax.random.normal(k1, (dim,)) / jnp.sqrt(st.inv_mass)
        th, p, g = _leapfrog(lg, st.theta, p0, st.grad, st.step_size,
                             st.inv_mass, n_leapfrog)
        lp_new = logpost(th)
        h0 = st.logp - 0.5 * jnp.sum(st.inv_mass * p0 * p0)
        h1 = lp_new - 0.5 * jnp.sum(st.inv_mass * p * p)
        log_acc = jnp.minimum(h1 - h0, 0.0)
        acc_p = jnp.where(jnp.isfinite(log_acc), jnp.exp(log_acc), 0.0)
        accept = jax.random.uniform(k2) < acc_p
        theta = jnp.where(accept, th, st.theta)
        logp = jnp.where(accept, lp_new, st.logp)
        grad = jnp.where(accept, g, st.grad)

        # dual averaging
        mf = m.astype(jnp.float32) + 1.0
        eta = 1.0 / (mf + t0)
        h_bar = (1.0 - eta) * st.h_bar + eta * (cfg.target_accept - acc_p)
        log_eps = st.mu - jnp.sqrt(mf) / gamma * h_bar
        w = mf ** (-kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * st.log_eps_bar
        step_size = jnp.where(adapt, jnp.exp(log_eps), jnp.exp(st.log_eps_bar))
        return st._replace(theta=theta, logp=logp, grad=grad,
                           step_size=step_size, h_bar=h_bar,
                           log_eps_bar=log_eps_bar, accept_prob=acc_p)

    def warm_body(m, carry):
        st, key = carry
        key, sub = jax.random.split(key)
        st = step(st, sub, jnp.asarray(True), m)
        return st, key

    key, kw = jax.random.split(key)
    st, _ = lax.fori_loop(0, cfg.num_warmup, warm_body, (st, kw))
    st = st._replace(step_size=jnp.exp(st.log_eps_bar))

    def sample_body(carry, key):
        st = carry
        st = step(st, key, jnp.asarray(False), jnp.asarray(cfg.num_warmup))
        return st, (st.theta, st.accept_prob)

    keys = jax.random.split(key, cfg.num_samples)
    st, (samples, accs) = lax.scan(sample_body, st, keys)
    return samples, jnp.mean(accs), st.step_size


def hmc_sample_chains(logpost: Callable, theta0: jnp.ndarray, key: jax.Array,
                      cfg: HMCConfig, n_leapfrog: int = 16):
    """vmap over chains: theta0 [C, dim] -> samples [C, num_samples, dim].
    The chain axis shards over the mesh `chain` axis (see parallel.mesh);
    each chain's logpost internally reduces over the sharded patch axis."""
    keys = jax.random.split(key, theta0.shape[0])
    f = jax.vmap(lambda t0, k: hmc_warmup_and_sample(logpost, t0, k, cfg,
                                                     n_leapfrog))
    return f(theta0, keys)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def split_rhat(samples: jnp.ndarray) -> jnp.ndarray:
    """Split-R-hat per dimension. samples: [C, T, dim]."""
    C, T, dim = samples.shape
    half = T // 2
    x = jnp.concatenate([samples[:, :half], samples[:, half:2 * half]], axis=0)
    m = x.shape[0]
    cm = jnp.mean(x, axis=1)                      # [2C, dim]
    gv = jnp.var(cm, axis=0, ddof=1)              # between
    wv = jnp.mean(jnp.var(x, axis=1, ddof=1), axis=0)
    var_est = (half - 1) / half * wv + gv
    return jnp.sqrt(var_est / wv)


def effective_sample_size(samples: jnp.ndarray, max_lag: int = 100):
    """Bulk ESS per dimension via initial positive sequence. [C, T, dim]."""
    C, T, dim = samples.shape
    x = samples - jnp.mean(samples, axis=1, keepdims=True)
    max_lag = min(max_lag, T - 1)
    # static unrolled lags: slice bounds must be compile-time constants
    ac = jnp.stack([
        jnp.mean(jnp.sum(x[:, :T - lag] * x[:, lag:], axis=1), axis=0) / T
        for lag in range(max_lag)])               # [max_lag, dim]
    rho = ac / ac[0]
    # truncate at first negative autocorrelation
    positive = jnp.cumprod(rho > -0.05, axis=0)
    tau = 1.0 + 2.0 * jnp.sum(rho * positive, axis=0)
    return C * T / jnp.maximum(tau, 1.0)
