"""Sparse online Gaussian process (Csató–Opper) as fixed-shape state.

Reference semantics: an online sparse GP with a fixed basis-vector budget.
State alpha (N), C (N x N), Q (N x N inverse Gram), BV (d x N); per-point
Bayesian update with novelty gamma = k** - k^T Q k; a *full* update grows all
state by one rank (reference: src/sparse_gp.hpp:164-203), a *sparse* update
projects onto the existing BVs when gamma < eps_tol (src/sparse_gp.hpp:155-163);
BV deletion by minimum score alpha_i^2 / (Q_ii + C_ii) when over capacity
(src/sparse_gp.hpp:206-223, Csató eq. 3.26) plus geometric deletion when
1/Q_ii < 1e-9 (src/sparse_gp.hpp:228-242); removal is a rank-1 downdate
(src/sparse_gp.hpp:253-295). Predict: f* = k^T alpha,
sigma^2 = s20 + k** + k^T C k (src/sparse_gp.hpp:313-351).

Fixed-shape reformulation (NOT a translation):

  * The dynamically-sized Eigen state becomes a capacity-padded record
    `SOGPState` with a per-slot `active` mask. "Append" writes into the
    first inactive slot; "delete" is a masked rank-1 downdate that zeroes a
    row/column and clears the mask bit — no conservativeResize, no
    swap-with-last compaction, no data-dependent shapes. The reference's
    empty-state special case (src/sparse_gp.hpp:100-113) falls out of the
    general full update on an all-zero state, so there is a single
    branch-free code path.
  * Points are inserted under `lax.scan`; thousands of patches are `vmap`-ed
    so every rank-1 op becomes a batched [B, slots, slots] contraction; the
    patch axis shards over a device mesh. (pallas_kernels.sogp_train fuses
    the same recursion into one kernel that keeps each patch's state
    on-chip.)
  * Scalar-output (depth) and vector-output (RGB field,
    src/sparse_gp_field.hpp) GPs are one code path with dout in {1, 3}.
    Note: the reference field delete_bv multiplies instead of divides by
    (q* + c*) (src/sparse_gp_field.hpp:250 vs src/sparse_gp.hpp:285) — an
    upstream bug we deliberately do NOT replicate; both douts use the
    correct division here.
  * Likelihood input-derivatives for registration come from `jax.grad` of
    the predictive density instead of the hand-derived forms
    (src/sparse_gp.hpp:478-508); the tests verify they agree.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_compressor_jax.config import GPConfig
from gp_compressor_jax.ops import kernels
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.ops.noise import GaussianNoise, NoiseModel

# All state-update contractions run at HIGHEST precision: a GPU's default
# f32 matmul may run in TF32, whose 10-bit mantissa is far below the
# cancellation level of gamma = k** - k^T Q k and of the rank-1 C/Q
# updates. These are [slots]-sized matvecs (no tensor-core work), so full
# float32 costs nothing.
_HI = jax.lax.Precision.HIGHEST


def _mv(M, v):
    return jnp.einsum('...ij,...j->...i', M, v, precision=_HI)


class SOGPState(NamedTuple):
    """Capacity-padded sparse-GP state for one patch.

    Shapes (cap1 = config.slots):
      bv:     [cap1, dim]   basis-vector inputs
      alpha:  [cap1, dout]  weight vector(s)
      C:      [cap1, cap1]  negative-precision-like matrix
      Q:      [cap1, cap1]  inverse Gram over the BVs
      active: [cap1] bool   slot occupancy mask
    Inactive slots are exactly zero in every array, which makes all updates
    closed over the masked subspace.
    """

    bv: jnp.ndarray
    alpha: jnp.ndarray
    C: jnp.ndarray
    Q: jnp.ndarray
    active: jnp.ndarray

    @property
    def slots(self) -> int:
        return self.C.shape[-1]


def init(cfg: GPConfig) -> SOGPState:
    dt = cfg.dtype
    return SOGPState(
        bv=jnp.zeros((cfg.slots, cfg.dim), dt),
        alpha=jnp.zeros((cfg.slots, cfg.dout), dt),
        C=jnp.zeros((cfg.slots, cfg.slots), dt),
        Q=jnp.zeros((cfg.slots, cfg.slots), dt),
        active=jnp.zeros((cfg.slots,), bool),
    )


def init_batch(cfg: GPConfig, n: int) -> SOGPState:
    """A bank of n patch GPs (leading batch axis on every leaf)."""
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape), init(cfg))


def size(state: SOGPState) -> jnp.ndarray:
    return jnp.sum(state.active, axis=-1)


def _select(pred, new: SOGPState, old: SOGPState) -> SOGPState:
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), new, old)


def _delete_bv(state: SOGPState, loc: jnp.ndarray) -> SOGPState:
    """Masked rank-1 removal of slot `loc` (no compaction).

    Equivalent to the swap-with-last + shrink in the reference
    (src/sparse_gp.hpp:253-295): for the surviving slots
      alpha -= alpha*_loc (Q_:loc + C_:loc) / (q* + c*)
      C     += Q_:loc Q_:loc^T / q* - (Q+C)_:loc (Q+C)_:loc^T / (q* + c*)
      Q     -= Q_:loc Q_:loc^T / q*
    then row/col loc is zeroed and the slot deactivated.
    """
    dt = state.C.dtype
    cap1 = state.slots
    oh = jax.nn.one_hot(loc, cap1, dtype=dt)
    astar = jnp.take(state.alpha, loc, axis=0)    # [dout]
    Ccol = jnp.take(state.C, loc, axis=1)
    Qcol = jnp.take(state.Q, loc, axis=1)
    cstar = jnp.take(Ccol, loc, axis=0)
    qstar = jnp.take(Qcol, loc, axis=0)
    keep = 1.0 - oh
    Cs = Ccol * keep                              # column loc, entry loc zeroed
    Qs = Qcol * keep
    qc = Qs + Cs
    denom = qstar + cstar
    alpha = state.alpha - jnp.outer(qc, astar) / denom
    C = state.C + jnp.outer(Qs, Qs) / qstar - jnp.outer(qc, qc) / denom
    Q = state.Q - jnp.outer(Qs, Qs) / qstar
    kk = keep[:, None] * keep[None, :]
    return SOGPState(
        bv=state.bv * keep[:, None],
        alpha=alpha * keep[:, None],
        C=C * kk,
        Q=Q * kk,
        active=state.active & (jnp.arange(cap1) != loc),
    )


def _capacity_scores(state: SOGPState) -> jnp.ndarray:
    """Csató eq. 3.26 scores |alpha_i|^2 / (Q_ii + C_ii); +inf when inactive
    (src/sparse_gp.hpp:210-217, field norm src/sparse_gp_field.hpp:178)."""
    diag = jnp.diagonal(state.Q) + jnp.diagonal(state.C)
    s = jnp.sum(state.alpha ** 2, axis=-1) / diag
    return jnp.where(state.active, s, jnp.inf)


def _geometric_scores(state: SOGPState) -> jnp.ndarray:
    """1 / Q_ii; +inf when inactive (src/sparse_gp.hpp:228-234)."""
    return jnp.where(state.active, 1.0 / jnp.diagonal(state.Q), jnp.inf)


def add_point(kp: RBFParams, noise: NoiseModel, cfg: GPConfig,
              state: SOGPState, x: jnp.ndarray, y: jnp.ndarray,
              valid=True, eps_tol=None) -> SOGPState:
    """One Csató–Opper update. x: [dim], y: [dout], valid: bool (no-op pad).

    Computes both the sparse and full updates and selects — under `vmap`
    a `lax.cond` lowers to the same select, so this is explicit about cost.

    eps_tol: optional TRACED override of cfg.eps_tol (the novelty
    threshold), so calibrated runs with data-dependent hyperparameters
    share one compiled program.
    """
    dt = state.C.dtype
    cap1 = state.slots
    act = state.active.astype(dt)

    kstar = kernels.kdiag(kp, x[None])[0]
    k = kernels.gram(kp, x[None], state.bv)[0] * act        # [cap1]
    m = jnp.einsum('ij,i->j', state.alpha, k, precision=_HI)  # [dout]
    Ck = _mv(state.C, k)
    s2 = kstar + jnp.einsum('i,i->', k, Ck, precision=_HI)
    e_hat = _mv(state.Q, k)
    gamma = kstar - jnp.einsum('i,i->', k, e_hat, precision=_HI)
    gamma = jnp.where(gamma < cfg.gamma_tiny, 0.0, gamma)    # src/sparse_gp.hpp:146
    # Exact-arithmetic invariant, enforced for float32 robustness: the
    # latent predictive variance always dominates the residual novelty,
    # s2 >= gamma >= 0. Rounding in the C/Q quadratics can violate it,
    # and then the sparse-update gain eta = 1/(1 + gamma*r)
    # = (s20+s2)/(s20+s2-gamma) loses its bound and alpha explodes — the
    # NaN the reference only comments about (src/sparse_gp.hpp:124-129).
    # With the clamp, eta <= 1 + eps_tol/s20 unconditionally.
    s2 = jnp.maximum(s2, gamma)
    r = noise.dx2_ln(y, m, s2)                               # scalar
    q = noise.dx_ln(y, m, s2)                                # [dout]

    # --- sparse update (project onto existing BVs), src/sparse_gp.hpp:155-163
    eta = 1.0 / (1.0 + gamma * r)
    s_hat = Ck + e_hat
    alpha_s = state.alpha + jnp.outer(s_hat, q) * eta
    C_s = state.C + (r * eta) * jnp.outer(s_hat, s_hat)

    # --- full update (activate a new slot), src/sparse_gp.hpp:164-203
    slot = jnp.argmin(act)                                   # first free slot
    oh = jax.nn.one_hot(slot, cap1, dtype=dt)
    s_f = Ck + oh
    alpha_f = state.alpha + jnp.outer(s_f, q)
    C_f = state.C + r * jnp.outer(s_f, s_f)
    e_f = e_hat - oh
    Q_f = state.Q + jnp.outer(e_f, e_f) / jnp.maximum(gamma, cfg.gamma_tiny)
    bv_f = state.bv * (1.0 - oh)[:, None] + jnp.outer(oh, x)
    active_f = state.active | (jnp.arange(cap1) == slot)

    if cfg.novelty_mode == "geometric":
        # conditioning-free streaming novelty (GPConfig.novelty_mode):
        # admit iff farther than geom_dmin from every current BV — i.e.
        # every kernel value below kappa — and under the BV budget. A
        # pathological admit with f32-clamped gamma = 0 self-heals: the
        # 1/gamma_tiny Q update trips the geometric deletion immediately.
        kappa = kp.sigmaf_sq * jnp.exp(
            jnp.asarray(-0.5 * cfg.geom_dmin ** 2, dt) / kp.l_sq)
        admit = (jnp.sum(act) < cfg.geom_max_bv) & (jnp.max(k) < kappa) \
            & (gamma > cfg.geom_gamma_min_rel * kp.sigmaf_sq)
        use_sparse = ~admit
    else:
        use_sparse = gamma < (cfg.eps_tol if eps_tol is None else eps_tol)
    new = SOGPState(
        bv=jnp.where(use_sparse, state.bv, bv_f),
        alpha=jnp.where(use_sparse, alpha_s, alpha_f),
        C=jnp.where(use_sparse, C_s, C_f),
        Q=jnp.where(use_sparse, state.Q, Q_f),
        active=jnp.where(use_sparse, state.active, active_f),
    )

    # --- capacity deletion: one add grows by at most one, so one delete
    # suffices (reference loops, src/sparse_gp.hpp:206-223)
    over = size(new) > cfg.capacity
    sc = _capacity_scores(new)
    new = _select(over, _delete_bv(new, jnp.argmin(sc)), new)

    # --- geometric deletions (src/sparse_gp.hpp:228-242). The reference
    # loops until clean; more than one per added point is pathological, so a
    # small fixed number of conditional deletes bounds the scan body.
    for _ in range(cfg.max_geometric_deletes):
        g = _geometric_scores(new)
        pred = (jnp.min(g) < cfg.geom_tol) & (size(new) > 1)
        new = _select(pred, _delete_bv(new, jnp.argmin(g)), new)

    return _select(valid, new, state)


def add_points(kp: RBFParams, noise: NoiseModel, cfg: GPConfig,
               state: SOGPState, X: jnp.ndarray, Y: jnp.ndarray,
               mask: Optional[jnp.ndarray] = None,
               key: Optional[jax.Array] = None, eps_tol=None) -> SOGPState:
    """Insert a chunk of points under `lax.scan`.

    X: [n, dim], Y: [n, dout], mask: [n] validity (padding), key: optional
    PRNG key for the insertion-order shuffle the reference applies so that
    neighbouring points are not added consecutively
    (src/sparse_gp.hpp:43-56,62-63).

    eps_tol may be a traced scalar (one threshold for all points) or a
    [n] vector (per-point thresholds — e.g. -inf to FORCE a point into
    the basis and +inf to force a sparse projection, the mechanism behind
    geometric basis preselection).
    """
    n = X.shape[0]
    if mask is None:
        mask = jnp.ones((n,), bool)
    per_point = eps_tol is not None and getattr(eps_tol, "ndim", 0) == 1
    if key is not None:
        perm = jax.random.permutation(key, n)
        X, Y, mask = X[perm], Y[perm], mask[perm]
        if per_point:
            eps_tol = eps_tol[perm]

    if per_point:
        def step(st, inp):
            x, y, v, e = inp
            return add_point(kp, noise, cfg, st, x, y, v, eps_tol=e), None

        state, _ = lax.scan(step, state, (X, Y, mask, eps_tol))
        return state

    def step(st, inp):
        x, y, v = inp
        return add_point(kp, noise, cfg, st, x, y, v, eps_tol=eps_tol), None

    state, _ = lax.scan(step, state, (X, Y, mask))
    return state


def add_points_batch(kp: RBFParams, noise: NoiseModel, cfg: GPConfig,
                     states: SOGPState, X: jnp.ndarray, Y: jnp.ndarray,
                     mask: jnp.ndarray,
                     keys: Optional[jax.Array] = None,
                     eps_tol=None) -> SOGPState:
    """vmap over the patch axis: X [B, n, dim], Y [B, n, dout], mask [B, n].

    This is the batched shape of the reference's serial per-leaf training
    loop (src/gp_compressor.cpp:132-172): every scan step performs batched
    [B, slots, slots] rank-1 algebra.

    eps_tol: scalar, or [B, n] per-(patch, point) novelty thresholds.
    """
    per_point = eps_tol is not None and getattr(eps_tol, "ndim", 0) == 2
    if keys is None:
        if per_point:
            f = jax.vmap(lambda st, x, y, m, e: add_points(
                kp, noise, cfg, st, x, y, m, eps_tol=e))
            return f(states, X, Y, mask, eps_tol)
        f = jax.vmap(lambda st, x, y, m: add_points(
            kp, noise, cfg, st, x, y, m, eps_tol=eps_tol))
        return f(states, X, Y, mask)
    if per_point:
        f = jax.vmap(lambda st, x, y, m, k, e: add_points(
            kp, noise, cfg, st, x, y, m, k, eps_tol=e))
        return f(states, X, Y, mask, keys, eps_tol)
    f = jax.vmap(lambda st, x, y, m, k: add_points(
        kp, noise, cfg, st, x, y, m, k, eps_tol=eps_tol))
    return f(states, X, Y, mask, keys)


def predict(kp: RBFParams, s20, state: SOGPState,
            Xstar: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Posterior predictive mean [m, dout] and *observation* variance [m]
    (includes s20): f* = k^T alpha, var = s20 + k** + k^T C k
    (src/sparse_gp.hpp:313-351). An empty GP returns (0, k** + s20) which
    the masked algebra produces automatically. Variance is clamped at 0 as
    the reference does on numerical instability (src/sparse_gp.hpp:334-337).
    """
    act = state.active.astype(state.C.dtype)
    K = kernels.gram(kp, Xstar, state.bv) * act[None, :]     # [m, cap1]
    mean = jnp.einsum('mi,id->md', K, state.alpha, precision=_HI)
    KC = jnp.einsum('mi,ij->mj', K, state.C, precision=_HI)
    # exact-arithmetic invariant enforced for float32: the latent variance
    # k** + k^T C k is >= 0, so the observation variance is >= s20 — a
    # clamp at 0 (the reference's choice) feeds log(0)/division-by-zero
    # into every density/gradient consumer
    latent = kernels.kdiag(kp, Xstar) + jnp.sum(KC * K, axis=-1)
    return mean, s20 + jnp.maximum(latent, 0.0)


def predict_confidence(kp: RBFParams, s20, state: SOGPState, Xstar):
    """Reference `conf=true` branch: 100 * (1 - var / (k** + s20))
    (src/sparse_gp.hpp:339-345)."""
    mean, var = predict(kp, s20, state, Xstar)
    conf = 100.0 * (1.0 - var / (kernels.kdiag(kp, Xstar) + s20))
    return mean, conf


predict_batch = jax.vmap(predict, in_axes=(None, None, 0, 0))


def log_likelihood(kp: RBFParams, s20, state: SOGPState,
                   X: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Per-point predictive log density ln N(y; mu(x), var(x))
    (src/sparse_gp.hpp:358-387,398-405). X: [m, dim], y: [m, dout] -> [m]."""
    mean, var = predict(kp, s20, state, X)
    ll = (-0.5 * jnp.log(2.0 * jnp.pi * var)[:, None]
          - 0.5 * (y - mean) ** 2 / var[:, None])
    return jnp.sum(ll, axis=-1)


def likelihood(kp: RBFParams, s20, state: SOGPState, X, y) -> jnp.ndarray:
    """Predictive density (not log), src/sparse_gp.hpp:409-427."""
    return jnp.exp(log_likelihood(kp, s20, state, X, y))


def likelihood_dx(kp: RBFParams, s20, state: SOGPState,
                  X: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Gradient of the predictive *density* w.r.t. (y, x): [m, 1 + dim]
    per output channel summed — matches sparse_gp::likelihood_dx /
    compute_derivatives (src/sparse_gp.hpp:430-508) via `jax.grad` instead
    of hand-derived algebra. Column 0 is d/dy, columns 1..dim are d/dx.
    """

    def density(x, yv):
        mean, var = predict(kp, s20, state, x[None])
        lp = jnp.sum(-0.5 * jnp.log(2.0 * jnp.pi * var)
                     - 0.5 * (yv - mean[0]) ** 2 / var)
        return jnp.exp(lp)

    gx = jax.vmap(jax.grad(density, argnums=(1, 0)))(X, y)
    dy, dx = gx
    return jnp.concatenate([jnp.sum(dy, axis=-1, keepdims=True), dx], axis=-1)


def reset(state: SOGPState) -> SOGPState:
    """src/sparse_gp.hpp:573-582."""
    return jax.tree.map(jnp.zeros_like, state)


def sanitize_batch(states: SOGPState, kp: Optional[RBFParams] = None,
                   s20=None, max_pred: float = 1e3,
                   probes: Optional[jnp.ndarray] = None):
    """Reset patches whose state went non-finite or predicts garbage;
    returns (states, n_bad).

    Float32 failure containment: the Csató recursion is only conditionally
    stable, and a patch whose C/Q left the stable manifold (ill-conditioned
    data + rounding) would otherwise poison every prediction. The reference
    merely prints "C has become Nan" and keeps going
    (src/sparse_gp.hpp:245-247); here the patch is reset to the empty GP
    (predicts the prior) and counted, which is also the hook for
    failure-detection metrics. When kernel params are given, health is
    judged on the patch's own predictions at its BV sites — the quantity
    that actually reaches users — rather than raw state magnitudes.
    """
    bad = jnp.zeros(states.C.shape[0], bool)
    for leaf in (states.bv, states.alpha, states.C, states.Q):
        axes = tuple(range(1, leaf.ndim))
        bad = bad | ~jnp.all(jnp.isfinite(leaf), axis=axes)
    if kp is not None:
        # probe across the patch footprint, not just the BV sites — a
        # diverged alpha can cancel exactly at its own BVs while predicting
        # garbage millimetres away
        sites = states.bv
        if probes is not None:
            B = states.bv.shape[0]
            sites = jnp.concatenate(
                [sites, jnp.broadcast_to(probes, (B,) + probes.shape)], axis=1)
        mean, var = predict_batch(kp, s20, states, sites)
        pred_ok = jnp.all(jnp.isfinite(mean) & (jnp.abs(mean) < max_pred),
                          axis=(1, 2)) & jnp.all(jnp.isfinite(var), axis=1)
        bad = bad | ~pred_ok

    def fix(a):
        return jnp.where(bad.reshape((-1,) + (1,) * (a.ndim - 1)),
                         jnp.zeros_like(a), a)

    return jax.tree.map(fix, states), jnp.sum(bad)
