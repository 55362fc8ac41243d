"""Exact (dense Cholesky) Gaussian process — the correctness oracle.

Reference semantics: build the full RBF Gram + sigma_n^2 I, LLT-factor,
alpha = K^-1 y; predict mean K*^T alpha and variance k** - v^T v with
v = L^-1 K* (reference: src/gaussian_process.cpp:15-45). The reference
builds this as an "exact oracle" library for the sparse GP without ever
invoking it in a workload; here it plays the same role (parity tests) *and*
is a batched production path: `vmap`/`pjit` over a bank of padded patches
turns the per-element double loop (src/gaussian_process.cpp:58-69) into a
batched Gram + Cholesky.

Masked semantics: rows with mask=0 are decoupled by placing a unit diagonal
in their Gram rows and zeroing their targets, so one static shape serves
patches of any true size.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gp_compressor_jax.ops import kernels
from gp_compressor_jax.ops.kernels import RBFParams


class ExactGPState(NamedTuple):
    X: jnp.ndarray      # [n, d] training inputs (padded)
    mask: jnp.ndarray   # [n] 1.0 for real rows
    chol: jnp.ndarray   # [n, n] lower Cholesky of masked (K + s20 I)
    alpha: jnp.ndarray  # [n, dout] = (K + s20 I)^-1 y


def fit(params: RBFParams, s20, X: jnp.ndarray, y: jnp.ndarray,
        mask: jnp.ndarray) -> ExactGPState:
    """Factor the masked Gram and solve for alpha.

    y: [n, dout]; mask: [n]. Equivalent to gaussian_process::add_measurements
    (src/gaussian_process.cpp:15-26) for the unmasked rows.
    """
    from gp_compressor_jax.ops import linalg_f32

    n = X.shape[0]
    m2 = mask[:, None] * mask[None, :]
    K = kernels.gram(params, X, X) * m2
    # decouple masked-out rows with a unit diagonal; real rows get + s20
    diag = jnp.where(mask > 0, s20, 1.0)
    K = K + jnp.diag(diag)
    # elementwise-only Cholesky/solves: the XLA Cholesky HLO's internal
    # blocked matmuls may run at a backend-default precision below f32,
    # which the near-rank-1 reference-constant Gram cannot survive — see
    # ops/linalg_f32.py
    L = linalg_f32.cholesky(K)
    ym = y * mask[:, None]
    alpha = linalg_f32.cho_solve(L, ym)
    return ExactGPState(X=X, mask=mask, chol=L, alpha=alpha)


def predict(params: RBFParams, state: ExactGPState,
            Xstar: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Posterior mean [m, dout] and latent variance [m] at Xstar.

    Mirrors gaussian_process::predict_measurements
    (src/gaussian_process.cpp:28-45): f* = K*^T alpha,
    V* = k** - v^T v, v = L^-1 K*.
    """
    from gp_compressor_jax.ops import linalg_f32

    Ks = kernels.gram(params, state.X, Xstar) * state.mask[:, None]   # [n, m]
    mean = jnp.einsum('nm,nd->md', Ks, state.alpha,
                      precision=jax.lax.Precision.HIGHEST)
    v = linalg_f32.solve_lower(state.chol, Ks)                         # [n, m]
    var = kernels.kdiag(params, Xstar) - jnp.sum(v * v, axis=0)
    return mean, var


# Batched versions over a leading patch axis.
fit_batch = jax.vmap(fit, in_axes=(None, None, 0, 0, 0))
predict_batch = jax.vmap(predict, in_axes=(None, 0, 0))
