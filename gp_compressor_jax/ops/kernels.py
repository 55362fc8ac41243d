"""Batched RBF (squared-exponential) kernel primitives.

Reference semantics: k(xi, xj) = p0 * exp(-||xi - xj||^2 / (2 p1)) with
p = (sigmaf_sq, l_sq) (reference: src/rbf_kernel.cpp:15-18, defaults
src/rbf_kernel.h:24). The reference materialises Gram matrices and input /
hyperparameter derivatives with per-column loops
(src/rbf_kernel.cpp:21-71,88-104); here every variant is a pure, batched,
`vmap`/`jit`-friendly expression.
Derivatives come from closed forms validated against `jax.grad` in the tests.

All functions are dtype-polymorphic (follow their inputs) so the same code
runs float64 under the CPU test oracle and float32 on the GPU.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RBFParams(NamedTuple):
    """Kernel hyperparameters. Kept as a pytree so HMC/VI can differentiate
    and sample over them (new capability vs. fixed constants in the
    reference, src/rbf_kernel.h:24)."""

    sigmaf_sq: jnp.ndarray  # signal variance p0
    l_sq: jnp.ndarray       # squared lengthscale p1


def sqdist(X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared distances. X: [n, d], Z: [m, d] -> [n, m].

    Patch inputs are d=2, so the difference form is both cheaper than the
    |x|^2+|z|^2-2xz matmul expansion and numerically exact — critically, it
    avoids a reduced-precision default matmul (TF32 on a GPU), whose short
    mantissa would feed catastrophic cancellation into the novelty gamma
    (see models.sparse_gp). For large d, switch to the expansion with
    precision=HIGHEST.
    """
    if X.shape[-1] <= 4:
        diff = X[..., :, None, :] - Z[..., None, :, :]
        return jnp.sum(diff * diff, axis=-1)
    xx = jnp.sum(X * X, axis=-1)[:, None]
    zz = jnp.sum(Z * Z, axis=-1)[None, :]
    cross = jnp.matmul(X, Z.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(xx + zz - 2.0 * cross, 0.0)


def gram(params: RBFParams, X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray:
    """Cross-Gram matrix K[i, j] = k(X[i], Z[j]).  [n, d] x [m, d] -> [n, m].

    Reference: rbf_kernel::construct_covariance_fast (src/rbf_kernel.cpp:61-71)
    — there a per-BV loop, here one fused batched expression.
    """
    return params.sigmaf_sq * jnp.exp(-0.5 / params.l_sq * sqdist(X, Z))


def kdiag(params: RBFParams, X: jnp.ndarray) -> jnp.ndarray:
    """k(x, x) for each row — constant sigmaf_sq for the RBF kernel."""
    return jnp.full(X.shape[:-1], params.sigmaf_sq, dtype=X.dtype)


def gram_dx(params: RBFParams, X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray:
    """d k(x_i, z_j) / d x_i — shape [n, m, d].

    Reference: rbf_kernel::kernel_dx / kernels_fast (src/rbf_kernel.cpp:21-46):
    dk/dx = -(p0/p1) * (x - z) * exp(-|x-z|^2 / (2 p1)).
    """
    diff = X[:, None, :] - Z[None, :, :]                    # [n, m, d]
    e = jnp.exp(-0.5 / params.l_sq * jnp.sum(diff * diff, axis=-1))
    return (-params.sigmaf_sq / params.l_sq) * diff * e[..., None]


def gram_dtheta(params: RBFParams, X: jnp.ndarray, Z: jnp.ndarray) -> jnp.ndarray:
    """d k(x_i, z_j) / d (sigmaf_sq, l_sq) — shape [n, m, 2].

    Reference: rbf_kernel::kernel_dtheta (src/rbf_kernel.cpp:49-58):
      dk/dp0 = exp(-r2 / (2 p1))
      dk/dp1 = p0 * r2 / (2 p1^2) * exp(-r2 / (2 p1))
    """
    r2 = sqdist(X, Z)
    e = jnp.exp(-0.5 / params.l_sq * r2)
    dk_dp0 = e
    dk_dp1 = params.sigmaf_sq * 0.5 / (params.l_sq ** 2) * r2 * e
    return jnp.stack([dk_dp0, dk_dp1], axis=-1)
