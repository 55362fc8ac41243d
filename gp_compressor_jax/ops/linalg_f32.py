"""Precision-exact small-matrix Cholesky and triangular solves.

Why this exists: `jnp.linalg.cholesky` / `triangular_solve` may lower to
XLA HLOs whose internal blocked expansions run dot_generals at the BACKEND
default precision — reduced-precision passes (bf16 on some accelerators,
TF32 on a GPU) that a JAX-level
`default_matmul_precision` context does not reach (the expansion happens
inside the XLA compiler, and the AD rules for the primitives emit further
default-precision matmuls at backward-trace time). For the near-rank-1
Grams this framework factors at reference constants (K ~ 100*J + 0.11*I,
sigma_f^2=100 / l=1 m on 0.15 m patches), a 0.4% relative error swamps the
s20 diagonal: measured with a bf16 default, NUTS ran at accept=NaN /
split-R-hat 28 while identical chains in exact f32 mixed at 0.92 / 1.08.
(Whether the GPU's native factorization needs this is an open question:
ROADMAP C4.)

These routines use ONLY elementwise arithmetic and rank-1 outer products
inside `lax.fori_loop` — no dot_general anywhere, forward or backward — so
f32 on any accelerator behaves exactly like f32 on CPU. They are written for the
n <= ~128 matrices of the calibration/inference paths (the sequential
column loop is latency-bound, irrelevant at these sizes) and are fully
differentiable (fixed trip counts, elementwise ops).

An indefinite pivot produces sqrt(negative) = NaN which propagates to the
whole factor — exactly the signal the callers' double-where safe-Cholesky
guards key on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_HI = jax.lax.Precision.HIGHEST

# Unroll factor for the sequential column/row loops. The loops are
# latency-bound (per-iteration control overhead dominates the [B, n]-sized
# elementwise work); unrolling lets XLA fuse runs of iterations
# into straight-line kernels. 8 keeps compile time sane at n <= 128.
_UNROLL = 8

# All three routines carry CLOSED-FORM custom VJPs (Murray 2016, "Differen-
# tiation of the Cholesky decomposition", and the standard triangular-solve
# adjoints). Without them, reverse AD of the fori_loop forward unrolls an
# n-step backward pass that stashes the full [n, n] iterate per step —
# ~n^3 floats of device-memory residual traffic and another n sequential
# micro-steps per solve, which dominated the MAP/NUTS wall. The adjoints
# below reuse the SAME elementwise solves (so they stay exact f32) plus
# explicit HIGHEST-precision matmuls (JAX-level dots honor `precision`;
# only backend-default dots and HLO-internal expansions are not).


def _chol_impl(K: jnp.ndarray) -> jnp.ndarray:
    n = K.shape[-1]
    ii = jnp.arange(n)

    def body(j, A):
        d = jnp.sqrt(A[j, j])                          # NaN if pivot < 0
        col = jnp.where(ii >= j, A[:, j] / d, 0.0)     # col[j] = d
        tail = jnp.where(ii > j, col, 0.0)
        A = A - tail[:, None] * tail[None, :]          # trailing update
        A = A.at[:, j].set(col)
        return A

    L = lax.fori_loop(0, n, body, K, unroll=_UNROLL)
    return jnp.tril(L)


def _solve_lower_impl(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    n = L.shape[0]

    def body(i, x):
        s = jnp.sum(L[i].reshape((n,) + (1,) * (b.ndim - 1)) * x, axis=0)
        xi = (b[i] - s) / L[i, i]
        return x.at[i].set(xi)

    return lax.fori_loop(0, n, body, jnp.zeros_like(b), unroll=_UNROLL)


def _solve_lower_t_impl(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    n = L.shape[0]

    def body(t, x):
        i = n - 1 - t
        s = jnp.sum(L[:, i].reshape((n,) + (1,) * (b.ndim - 1)) * x, axis=0)
        xi = (b[i] - s) / L[i, i]
        return x.at[i].set(xi)

    return lax.fori_loop(0, n, body, jnp.zeros_like(b), unroll=_UNROLL)


@jax.custom_vjp
def cholesky(K: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky of a symmetric positive-definite [n, n] matrix by the
    right-looking rank-1 algorithm. NaN-propagating on indefinite input."""
    return _chol_impl(K)


def _chol_fwd(K):
    L = _chol_impl(K)
    return L, L


def _chol_bwd(L, Lbar):
    # Kbar = 0.5 (S + S^T), S = L^-T Phi(L^T Lbar) L^-1,
    # Phi = tril with halved diagonal
    P = jnp.matmul(L.T, Lbar, precision=_HI)
    P = jnp.tril(P) - 0.5 * jnp.diag(jnp.diagonal(P))
    Y = _solve_lower_t_impl(L, P)                     # L^T Y = P
    S_t = _solve_lower_t_impl(L, Y.T)                 # S^T = L^-T Y^T
    return (0.5 * (S_t + S_t.T),)


cholesky.defvjp(_chol_fwd, _chol_bwd)


@jax.custom_vjp
def solve_lower(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L x = b by forward substitution. b: [n] or [n, k]."""
    return _solve_lower_impl(L, b)


def _sl_fwd(L, b):
    x = _solve_lower_impl(L, b)
    return x, (L, x)


def _sl_bwd(res, xbar):
    L, x = res
    bbar = _solve_lower_t_impl(L, xbar)               # L^T bbar = xbar
    x2 = x if x.ndim == 2 else x[:, None]
    b2 = bbar if bbar.ndim == 2 else bbar[:, None]
    Lbar = -jnp.tril(jnp.matmul(b2, x2.T, precision=_HI))
    return Lbar, bbar


solve_lower.defvjp(_sl_fwd, _sl_bwd)


@jax.custom_vjp
def solve_lower_t(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T x = b by back substitution. b: [n] or [n, k]."""
    return _solve_lower_t_impl(L, b)


def _slt_fwd(L, b):
    x = _solve_lower_t_impl(L, b)
    return x, (L, x)


def _slt_bwd(res, xbar):
    L, x = res
    bbar = _solve_lower_impl(L, xbar)                 # L bbar = xbar
    x2 = x if x.ndim == 2 else x[:, None]
    b2 = bbar if bbar.ndim == 2 else bbar[:, None]
    Lbar = -jnp.tril(jnp.matmul(x2, b2.T, precision=_HI))
    return Lbar, bbar


solve_lower_t.defvjp(_slt_fwd, _slt_bwd)


def cho_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = b given the lower factor."""
    return solve_lower_t(L, solve_lower(L, b))
