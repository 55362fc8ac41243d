"""No-U-Turn Sampler over GP hyperparameters.

Dynamic-trajectory HMC (Hoffman & Gelman 2014) with multinomial progressive
sampling and biased trajectory selection (Betancourt 2017), dual-averaging
step-size warmup shared with inference.hmc.

Implementation note: hyperparameter spaces here are tiny (dim = 3), so the
trajectory stores *every* leapfrog state in a [2^max_depth, dim] buffer and
performs the sub-tree U-turn checks by direct indexing — far simpler than
the checkpoint-stack formulation and free at this dimensionality. The whole
sampler jits; chains `vmap` and shard over the mesh `chain` axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_compressor_jax.config import HMCConfig


def _mv(inv_mass, p):
    """inv_mass @ p — inv_mass is a [dim] diagonal or a [dim, dim] DENSE
    inverse metric (posterior covariance estimate). Dense is the cure for
    the patch-bank posterior's correlated ridge: with a unit metric the
    bench transitions averaged ~80 leapfrogs (measured r5); the metric is
    3x3, so the extra matvec is free."""
    if inv_mass.ndim == 2:
        return jnp.matmul(inv_mass, p, precision=jax.lax.Precision.HIGHEST)
    return inv_mass * p


def _sample_momentum(key, inv_mass, dim, dtype=jnp.float32):
    """p ~ N(0, inv_mass^-1) for either metric form."""
    z = jax.random.normal(key, (dim,), dtype)
    if inv_mass.ndim == 2:
        from gp_compressor_jax.ops import linalg_f32
        L = linalg_f32.cholesky(inv_mass)       # inv_mass = L L^T
        return linalg_f32.solve_lower_t(L, z)   # cov(p) = (L L^T)^-1
    return z / jnp.sqrt(inv_mass)


class _Z(NamedTuple):
    theta: jnp.ndarray
    p: jnp.ndarray
    logp: jnp.ndarray
    grad: jnp.ndarray

    def energy(self, inv_mass):
        return self.logp - 0.5 * jnp.sum(self.p * _mv(inv_mass, self.p))


def _safe_vag(logpost):
    """value_and_grad with non-finite sanitization: any theta where the
    posterior (or its gradient) is non-finite evaluates to logp = -inf,
    grad = 0. Without this, a single huge leapfrog that overflows theta to
    +-inf makes the PRIOR's gradient -(theta - mu)/sigma^2 infinite, the
    next momentum NaN, and the NaN reaches the accept statistic -> dual
    averaging h_bar -> step size: the chain then silently freezes at its
    init (every NaN proposal is rejected) and split-R-hat explodes
    (measured: accept = NaN, R-hat 18 on the frozen chain). -inf/0
    instead makes such trajectories ordinary rejected divergences.
    """
    vag = jax.value_and_grad(logpost)

    def lg(th):
        v, g = vag(th)
        bad = ~(jnp.isfinite(v) & jnp.all(jnp.isfinite(g)))
        v = jnp.where(bad, -jnp.inf, v)
        g = jnp.where(bad, 0.0, g)
        return v, g

    return lg


def _leapfrog(lg, z: _Z, eps, inv_mass) -> _Z:
    p = z.p + 0.5 * eps * z.grad
    theta = z.theta + eps * _mv(inv_mass, p)
    logp, grad = lg(theta)
    p = p + 0.5 * eps * grad
    return _Z(theta, p, logp, grad)


def _uturn(theta_m, p_m, theta_p, p_p, inv_mass):
    d = theta_p - theta_m
    return (jnp.sum(d * _mv(inv_mass, p_m)) < 0.0) | \
           (jnp.sum(d * _mv(inv_mass, p_p)) < 0.0)


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def nuts_step(logpost: Callable, theta0, key, eps, inv_mass,
              max_depth: int = 8):
    """One NUTS transition. Returns (theta, accept_stat, n_leapfrog).

    FLAT iterative formulation: ONE `lax.while_loop` whose body is exactly
    one leapfrog plus O(max_depth) statically-unrolled predicated
    bookkeeping ops. The earlier nested form (doubling while_loop -> leaf
    fori_loop -> per-leaf dynamic U-turn fori_loop) spent several times
    the leapfrog cost in loop machinery; three nested dynamic loops per
    leaf collapse to one loop iteration per leapfrog.

    Semantics are the same dynamic-trajectory multinomial NUTS (Betancourt
    2017): subtree j has 2^j leaves; the doubling boundary work (direction
    draw, biased trajectory acceptance, endpoint update, whole-trajectory
    U-turn test) runs predicated on the subtree-complete flag. Sub-U-turn
    checks index the current subtree's state buffer ([2^(max_depth-1), dim]
    — leaves 0..i_sub of the ACTIVE subtree only, so no cross-subtree
    staleness). A subtree that turns or diverges mid-build exits
    immediately (the nested form burned the remaining leaves of the
    subtree; both discard it unmerged)."""
    lg = _safe_vag(logpost)
    dim = theta0.shape[0]
    Smax = 1 << max(max_depth - 1, 0)         # largest subtree's leaf count

    kp, kd0, key = jax.random.split(key, 3)
    p0 = _sample_momentum(kp, inv_mass, dim, theta0.dtype)
    logp0, grad0 = lg(theta0)
    z0 = _Z(theta0, p0, logp0, grad0)
    H0 = z0.energy(inv_mass)

    class Carry(NamedTuple):
        # trajectory level
        z_minus: _Z
        z_plus: _Z
        z_sample: _Z
        log_w_total: jnp.ndarray   # log sum of merged subtree weights
        stop: jnp.ndarray
        diverged: jnp.ndarray
        sum_acc: jnp.ndarray       # accept-stat accumulator
        n_lf: jnp.ndarray
        depth: jnp.ndarray         # subtrees completed so far
        # current-subtree level
        z_cur: _Z                  # last integrated state
        i_sub: jnp.ndarray         # leaves already completed in the subtree
        go_right: jnp.ndarray
        z_prop: _Z                 # subtree's multinomial proposal
        log_w_sub: jnp.ndarray
        thetas: jnp.ndarray        # [Smax, dim] subtree state buffer
        ps: jnp.ndarray

    carry0 = Carry(
        z0, z0, z0, jnp.asarray(0.0), jnp.asarray(False), jnp.asarray(False),
        jnp.asarray(0.0), jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        z0, jnp.asarray(0, jnp.int32), jax.random.bernoulli(kd0), z0,
        jnp.asarray(-jnp.inf), jnp.zeros((Smax, dim), theta0.dtype),
        jnp.zeros((Smax, dim), theta0.dtype))

    def body(c: Carry) -> Carry:
        k_take, k_acc, k_dir = jax.random.split(
            jax.random.fold_in(key, c.n_lf), 3)
        step_eps = jnp.where(c.go_right, eps, -eps)
        dirsign = jnp.where(c.go_right, 1.0, -1.0)

        z = _leapfrog(lg, c.z_cur, step_eps, inv_mass)
        dh = z.energy(inv_mass) - H0
        div = dh < -1000.0
        lw = jnp.where(jnp.isfinite(dh), dh, -jnp.inf)
        # progressive multinomial sampling within the subtree
        log_w_sub = jnp.logaddexp(c.log_w_sub, lw)
        take = jnp.log(jax.random.uniform(k_take)) < (lw - log_w_sub)
        z_prop = _tree_where(take, z, c.z_prop)
        sum_acc = c.sum_acc + jnp.minimum(1.0, jnp.exp(dh))
        i = c.i_sub
        thetas = c.thetas.at[i].set(z.theta)
        ps = c.ps.at[i].set(z.p)

        # sub-U-turn checks, statically unrolled: leaf i closes blocks of
        # size 2^k whenever (i+1) % 2^k == 0 (which implies 2^k <= the
        # current subtree size); compare against the block's first leaf.
        # The U-turn displacement must be in TIME order: for a backward
        # subtree the first-integrated leaf is the latest in time, so the
        # sign flips with the direction.
        sub_turn = jnp.asarray(False)
        for k in range(1, max_depth):
            blk = 1 << k
            closes = ((i + 1) % blk) == 0
            first = jnp.maximum(i + 1 - blk, 0)
            d = (z.theta - thetas[first]) * dirsign
            ut = (jnp.sum(d * _mv(inv_mass, ps[first])) < 0.0) | \
                 (jnp.sum(d * _mv(inv_mass, z.p)) < 0.0)
            sub_turn = sub_turn | (closes & ut)

        n_sub = jnp.left_shift(1, c.depth)
        done_leaves = (i + 1) >= n_sub
        bad = sub_turn | div
        sub_done = done_leaves | bad

        # ---- doubling-boundary work, predicated on subtree completion.
        # biased trajectory sampling between old trajectory and new subtree
        ok = done_leaves & ~bad
        accept_sub = jnp.log(jax.random.uniform(k_acc)) < \
            (log_w_sub - c.log_w_total)
        z_sample = _tree_where(ok & accept_sub, z_prop, c.z_sample)
        log_w_total = jnp.where(
            ok, jnp.logaddexp(c.log_w_total, log_w_sub), c.log_w_total)
        z_minus = _tree_where(c.go_right | ~ok, c.z_minus, z)
        z_plus = _tree_where(c.go_right & ok, z, c.z_plus)
        whole_turn = _uturn(z_minus.theta, z_minus.p, z_plus.theta,
                            z_plus.p, inv_mass)
        depth = c.depth + jnp.where(sub_done, 1, 0).astype(jnp.int32)
        stop = jnp.where(sub_done,
                         bad | whole_turn | (depth >= max_depth), c.stop)

        # ---- set up the next iteration (next leaf or next subtree)
        go_next = jax.random.bernoulli(k_dir)
        go_right = jnp.where(sub_done, go_next, c.go_right)
        z_start = _tree_where(go_next, z_plus, z_minus)
        z_cur = _tree_where(sub_done, z_start, z)
        i_sub = jnp.where(sub_done, 0, i + 1).astype(jnp.int32)
        log_w_sub = jnp.where(sub_done, -jnp.inf, log_w_sub)
        z_prop = _tree_where(sub_done, z_cur, z_prop)
        return Carry(z_minus, z_plus, z_sample, log_w_total, stop,
                     c.diverged | div, sum_acc, c.n_lf + 1, depth,
                     z_cur, i_sub, go_right, z_prop, log_w_sub, thetas, ps)

    carry = lax.while_loop(lambda c: ~c.stop, body, carry0)

    acc_stat = carry.sum_acc / jnp.maximum(carry.n_lf, 1)
    return carry.z_sample.theta, acc_stat, carry.n_lf


def find_reasonable_step_size(logpost: Callable, theta0, key, inv_mass,
                              eps0, max_doublings: int = 30):
    """Hoffman & Gelman (2014) Algorithm 4: double/halve eps until the
    one-leapfrog acceptance ratio crosses 1/2. Costs ~10 single leapfrogs
    and saves the dual-averaging warmup from starting orders of magnitude
    off scale — a blind eps that is 100x too large makes every early
    warmup trajectory a full 2^max_depth-leapfrog divergent tree."""
    lg = _safe_vag(logpost)
    p0 = _sample_momentum(key, inv_mass, theta0.shape[0], theta0.dtype)
    logp0, grad0 = lg(theta0)
    z0 = _Z(theta0, p0, logp0, grad0)
    H0 = z0.energy(inv_mass)

    def logr_at(eps):
        z = _leapfrog(lg, z0, eps, inv_mass)
        logr = z.energy(inv_mass) - H0
        return jnp.where(jnp.isfinite(logr), logr, -jnp.inf)

    eps0 = jnp.asarray(eps0, theta0.dtype)
    logr0 = logr_at(eps0)
    a = jnp.where(logr0 > jnp.log(0.5), 1.0, -1.0).astype(theta0.dtype)

    def cond(c):
        eps, logr, it = c
        return (a * logr > -a * jnp.log(2.0)) & (it < max_doublings)

    def body(c):
        eps, logr, it = c
        eps = eps * jnp.exp2(a)
        return eps, logr_at(eps), it + 1

    eps, _, _ = lax.while_loop(cond, body,
                               (eps0, logr0, jnp.asarray(0, jnp.int32)))
    # non-finite logpost(theta0) makes logr -inf for EVERY eps: the search
    # would burn all halvings and return eps0 * 2^-30, seeding dual
    # averaging with mu = log(10 eps) absurdly small. Keep the
    # caller's eps0 unchanged in that regime — warmup adapts from there.
    return jnp.where(jnp.isfinite(logp0), eps, eps0)


def nuts_warmup_and_sample(logpost: Callable, theta0: jnp.ndarray,
                           key: jax.Array, cfg: HMCConfig,
                           adapt_mass: bool = False,
                           dense_mass: bool = False):
    """Warmup then sampling, single chain.
    Returns (samples [num_samples, dim], mean accept-stat, step size).

    Warmup is two-phase (Stan-style windowed adaptation, simplified):
    phase 1 (half the budget) dual-averages the step size under a unit
    mass matrix while collecting draws; the second half of those draws
    estimates a DIAGONAL mass matrix (inv_mass = posterior variance,
    shrunk toward identity), and phase 2 re-adapts the step size under it.
    Rationale (measured on the bench patch-bank posterior): the log-scale
    hyperparameters have posterior scales spanning ~10x, so unit-mass
    trajectories need 1-2 extra tree doublings to traverse the slow
    direction — mass adaptation halves the leapfrogs/sample, which is the
    whole cost (each leapfrog is a latency-bound [B, n, n] elementwise
    Cholesky sweep forward + backward). adapt_mass defaults OFF: on the
    bench patch-bank posterior (3 log-scale dims of comparable posterior
    scale) the adapted mass bought no tree-depth reduction while the
    doubled warmup budget it needs cut end-to-end samples/s in half
    (measured round 4: 25.9/s at warmup 120 + mass vs ~49/s unit-mass at
    warmup 50) — enable it for posteriors with real scale anisotropy."""
    dim = theta0.shape[0]
    gamma, t0, kappa = 0.05, 10.0, 0.75

    def da_phase(theta, inv_mass, n, key, collect: bool):
        """Dual-averaging warmup phase of n steps; optionally collect
        draws. Returns (theta, adapted eps, draws [n, dim] or None)."""
        key, kf = jax.random.split(key)
        eps0 = find_reasonable_step_size(logpost, theta, kf, inv_mass,
                                         cfg.init_step_size)
        mu = jnp.log(10.0 * eps0)

        def body(carry, m):
            theta, eps, h_bar, log_eps_bar, key = carry
            key, sub = jax.random.split(key)
            theta, acc, _ = nuts_step(logpost, theta, sub, eps, inv_mass,
                                      cfg.max_tree_depth)
            mf = m.astype(jnp.float32) + 1.0
            eta = 1.0 / (mf + t0)
            h_bar = (1.0 - eta) * h_bar + eta * (cfg.target_accept - acc)
            log_eps = mu - jnp.sqrt(mf) / gamma * h_bar
            w = mf ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            carry = (theta, jnp.exp(log_eps), h_bar, log_eps_bar, key)
            return carry, (theta if collect else None)

        (theta, _, _, log_eps_bar, _), draws = lax.scan(
            body, (theta, eps0, jnp.asarray(0.0), jnp.asarray(0.0), key),
            jnp.arange(n))
        return theta, jnp.exp(log_eps_bar), draws

    key, k1 = jax.random.split(key)
    inv_mass = jnp.ones(dim)

    def fused_run(theta, inv_mass, n_warm, n_samp, key):
        """find_reasonable eps + warmup + sampling as ONE lax.scan (one
        compiled loop, one dispatch) — dual averaging runs predicated on
        m < n_warm, after which eps freezes at exp(log_eps_bar).
        Returns (theta, eps, thetas [n_warm+n_samp, dim], accs)."""
        key, kf = jax.random.split(key)
        eps0 = find_reasonable_step_size(logpost, theta, kf, inv_mass,
                                         cfg.init_step_size)
        mu = jnp.log(10.0 * eps0)

        def fused_body(carry, mk):
            m, k = mk
            theta, eps, h_bar, log_eps_bar = carry
            theta, acc, nlf = nuts_step(logpost, theta, k, eps, inv_mass,
                                        cfg.max_tree_depth)
            adapt = m < n_warm
            mf = m.astype(jnp.float32) + 1.0
            eta = 1.0 / (mf + t0)
            h_new = (1.0 - eta) * h_bar + eta * (cfg.target_accept - acc)
            log_eps = mu - jnp.sqrt(mf) / gamma * h_new
            w = mf ** (-kappa)
            leb_new = w * log_eps + (1.0 - w) * log_eps_bar
            h_bar = jnp.where(adapt, h_new, h_bar)
            log_eps_bar = jnp.where(adapt, leb_new, log_eps_bar)
            # the step AFTER the last warmup transition (and every later
            # one) runs at the averaged step size
            eps = jnp.where(m + 1 < n_warm, jnp.exp(log_eps),
                            jnp.exp(log_eps_bar))
            return (theta, eps, h_bar, log_eps_bar), (theta, acc, nlf)

        total = n_warm + n_samp
        keys = jax.random.split(key, total)
        (theta, eps, _, _), (thetas, accs, nlfs) = lax.scan(
            fused_body,
            (theta, eps0, jnp.asarray(0.0), jnp.asarray(0.0)),
            (jnp.arange(total), keys))
        return theta, eps, thetas, accs

    if dense_mass:
        # two-phase DENSE-metric adaptation: phase 1 runs unit-metric and
        # its settled half estimates the posterior covariance, which
        # becomes the inverse metric for phase 2 + sampling. On the bench
        # patch-bank posterior the log-scale dims ride a correlated ridge
        # a diagonal metric cannot absorb (measured: diagonal adaptation
        # gives no tree-depth win); the dense 3x3 metric is what collapses
        # the ~80-leapfrog transitions.
        n1 = max(cfg.num_warmup // 2, 10)
        key, k2 = jax.random.split(key)
        theta, _, draws, _ = fused_run(theta0, inv_mass, n1, 0, k1)
        tail = draws[n1 // 2:]
        m = tail.shape[0]
        xc = tail - jnp.mean(tail, axis=0)
        Sigma = jnp.matmul(xc.T, xc, precision=jax.lax.Precision.HIGHEST) \
            / jnp.maximum(m - 1, 1)
        # Stan-style shrinkage toward a small identity: guards the
        # few-draw estimate and keeps the metric PD for the f32 Cholesky
        Sigma = (m / (m + 5.0)) * Sigma \
            + 1e-3 * (5.0 / (m + 5.0)) * jnp.eye(dim, dtype=Sigma.dtype)
        n2 = cfg.num_warmup - n1
        theta, eps, thetas, accs = fused_run(theta, Sigma, n2,
                                             cfg.num_samples, k2)
        return thetas[n2:], jnp.mean(accs[n2:]), eps

    if not adapt_mass:
        theta, eps, thetas, accs = fused_run(theta0, inv_mass,
                                             cfg.num_warmup,
                                             cfg.num_samples, k1)
        n_warm = cfg.num_warmup
        return thetas[n_warm:], jnp.mean(accs[n_warm:]), eps

    if adapt_mass and cfg.num_warmup >= 100:
        # a short phase-1 window (e.g. 25 draws at warmup=50) can estimate
        # a near-zero variance on an axis where the chain barely moved —
        # the clipped inv_mass then freezes that axis and the chain never
        # mixes (measured: accept 0.77, split-R-hat 8.3 at warmup=50).
        # Only adapt with a real budget, and floor every axis at 1% of the
        # largest so no direction can collapse.
        n1 = cfg.num_warmup // 2
        theta, eps, draws = da_phase(theta0, inv_mass, n1, k1, collect=True)
        # variance over the settled half of phase 1, shrunk toward identity
        # (Stan's regularization) — guards the few-draw estimate
        tail = draws[n1 // 2:]
        m = tail.shape[0]
        var = jnp.var(tail, axis=0)
        inv_mass = (m / (m + 5.0)) * var + 1e-3 * (5.0 / (m + 5.0))
        inv_mass = jnp.clip(inv_mass, 1e-2 * jnp.max(inv_mass), 1e6)
        key, k2 = jax.random.split(key)
        theta, eps, _ = da_phase(theta, inv_mass,
                                 cfg.num_warmup - n1, k2, collect=False)
    else:
        theta, eps, _ = da_phase(theta0, inv_mass, cfg.num_warmup, k1,
                                 collect=False)

    def sample_body(carry, k):
        theta = carry
        theta, acc, nlf = nuts_step(logpost, theta, k, eps, inv_mass,
                                    cfg.max_tree_depth)
        return theta, (theta, acc, nlf)

    keys = jax.random.split(key, cfg.num_samples)
    _, (samples, accs, nlfs) = lax.scan(sample_body, theta, keys)
    return samples, jnp.mean(accs), eps


def nuts_sample_chains(logpost: Callable, theta0: jnp.ndarray,
                       key: jax.Array, cfg: HMCConfig,
                       dense_mass: bool = False):
    """theta0: [C, dim] -> samples [C, num_samples, dim]; chains vmap and
    shard over the mesh chain axis. dense_mass: per-chain two-phase dense
    metric adaptation (see nuts_warmup_and_sample)."""
    keys = jax.random.split(key, theta0.shape[0])
    f = jax.vmap(lambda t0, k: nuts_warmup_and_sample(
        logpost, t0, k, cfg, dense_mass=dense_mass))
    return f(theta0, keys)
