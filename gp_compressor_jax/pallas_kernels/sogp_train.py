"""Fused SOGP training kernel (Pallas through Triton) — the framework's hot op.

The XLA path (models.sparse_gp.add_points_batch) is a `lax.scan` over the
points of a bank, vmapped over patches: every scan step reads and writes the
whole [B, S, S] C and Q state in device memory, so a P-point bank moves
about 2 * P * B * S^2 floats of state traffic per GP. This kernel runs one
patch per program (the grid is over patches) and keeps that patch's whole
state — C, Q, alpha, the basis vectors and the active mask — in registers
as loop carries for the entire point loop. State is read once and written
once; each point step is matrix-vector work and rank-1 updates on [S, S]
blocks, which is plain CUDA-core arithmetic (no tensor-core shapes at
S = 32).

Each program reads its own trip count (last valid row + 1) and the
hyperparameter row, so rows past a patch's last point cost nothing and a
calibrated run (traced hyperparameters) reuses one compiled kernel.

Semantics match models.sparse_gp.add_point: the same full/sparse select,
capacity deletion, bounded geometric deletions, the s2 >= gamma clamp and
`novelty_mode="geometric"`. The branches are scalar `lax.cond`s, uniform
within a program, so a point pays only for the branch it takes (in the
steady state almost every point is a sparse update and no deletion fires).
Gaussian noise only — the probit occupancy channel trains through the XLA
path.

`train_patches` is the one entry the workloads call: it picks the kernel or
the XLA scan by an explicit shape rule (`kernel_covers`), never by device.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gp_compressor_jax.config import GPConfig
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.models.sparse_gp import SOGPState
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.ops.noise import GaussianNoise

# Slot widths the kernel is built for, with the warps each program gets,
# chosen by measurement on an H100 (PERF.md): each point step is a chain of
# small reductions, and reductions across warps go through shared memory,
# so the fewest warps that hold C and Q without spilling win — one warp
# (64 registers a thread for both) at 32 slots, more for wider states.
_NUM_WARPS = {16: 1, 32: 1, 64: 4, 128: 8}
_NUM_STAGES = 1
_N_PRM = 4          # hyperparameter row: sigma_f^2, l^2, s20, eps_tol


def kernel_covers(cfg: GPConfig, dtype) -> bool:
    """Shape rule: True where the fused kernel trains this GP; everything
    else (other slot widths, float64 states) takes the XLA scan."""
    return cfg.slots in _NUM_WARPS and jnp.dtype(dtype) == jnp.float32


def _kernel(cfg: GPConfig, dout: int, n_points: int,
            prm_ref, cnt_ref, X_ref, Y_ref, V_ref, bv_ref, al_ref, C_ref,
            Q_ref, act_ref, bv_o, al_o, C_o, Q_o, act_o):
    S = cfg.slots
    sf, l_sq, s20, eps_tol = prm_ref[0], prm_ref[1], prm_ref[2], prm_ref[3]
    idx = lax.broadcasted_iota(jnp.int32, (S,), 0)
    eye = (lax.broadcasted_iota(jnp.int32, (S, S), 0)
           == lax.broadcasted_iota(jnp.int32, (S, S), 1))

    def diag(M):
        return jnp.sum(jnp.where(eye, M, 0.0), axis=1)

    def outer(a, b):
        return a[:, None] * b[None, :]

    def mv(M, v):
        return jnp.sum(M * v[None, :], axis=1)

    def delete(st, loc):
        """Masked rank-1 removal of slot `loc` (sparse_gp._delete_bv)."""
        bx, by, al, C, Q, act, dQ = st
        oh = (idx == loc).astype(C.dtype)
        keep = 1.0 - oh
        Ccol = mv(C, oh)
        Qcol = mv(Q, oh)
        cstar = jnp.sum(Ccol * oh)
        qstar = jnp.sum(Qcol * oh)
        Cs = Ccol * keep
        Qs = Qcol * keep
        qc = Qs + Cs
        den = qstar + cstar
        al = tuple((a - qc * jnp.sum(a * oh) / den) * keep for a in al)
        kk = outer(keep, keep)
        C = (C + outer(Qs, Qs) / qstar - outer(qc, qc) / den) * kk
        Q = (Q - outer(Qs, Qs) / qstar) * kk
        return bx * keep, by * keep, al, C, Q, act * keep, diag(Q)

    def update(p, st):
        bx, by, al, C, Q, act, dQ = st
        x0 = X_ref[p, 0]
        x1 = X_ref[p, 1]
        dx = bx - x0
        dy = by - x1
        k = sf * jnp.exp(-0.5 / l_sq * (dx * dx + dy * dy)) * act
        m = tuple(jnp.sum(a * k) for a in al)
        Ck = mv(C, k)
        s2 = sf + jnp.sum(k * Ck)
        e_hat = mv(Q, k)
        gamma = sf - jnp.sum(k * e_hat)
        gamma = jnp.where(gamma < cfg.gamma_tiny, 0.0, gamma)
        s2 = jnp.maximum(s2, gamma)         # f32 invariant (see sparse_gp)
        r = -1.0 / (s20 + s2)
        q = tuple((Y_ref[p, d] - m[d]) / (s20 + s2) for d in range(dout))

        if cfg.novelty_mode == "geometric":
            kappa = sf * jnp.exp(-0.5 * cfg.geom_dmin ** 2 / l_sq)
            admit = ((jnp.sum(act) < cfg.geom_max_bv) & (jnp.max(k) < kappa)
                     & (gamma > cfg.geom_gamma_min_rel * sf))
            use_sparse = ~admit
        else:
            use_sparse = gamma < eps_tol

        def sparse(st):
            bx, by, al, C, Q, act, dQ = st
            eta = 1.0 / (1.0 + gamma * r)
            s_hat = Ck + e_hat
            al = tuple(a + s_hat * qd * eta for a, qd in zip(al, q))
            C = C + (r * eta) * outer(s_hat, s_hat)
            return bx, by, al, C, Q, act, dQ

        def full(st):
            bx, by, al, C, Q, act, dQ = st
            oh = idx == lax.argmin(act, 0, jnp.int32)   # first free slot
            ohf = oh.astype(C.dtype)
            s_f = Ck + ohf
            al = tuple(a + s_f * qd for a, qd in zip(al, q))
            C = C + r * outer(s_f, s_f)
            e_f = e_hat - ohf
            Q = Q + outer(e_f, e_f) / jnp.maximum(gamma, cfg.gamma_tiny)
            return (jnp.where(oh, x0, bx), jnp.where(oh, x1, by), al, C, Q,
                    jnp.maximum(act, ohf), diag(Q))

        st = lax.cond(use_sparse, sparse, full, st)

        # capacity deletion: one add grows by at most one, so one delete
        def cap_delete(st):
            al, C, act, dQ = st[2], st[3], st[5], st[6]
            sc = sum(a * a for a in al) / (dQ + diag(C))
            return delete(st, lax.argmin(jnp.where(act > 0, sc, jnp.inf), 0,
                                         jnp.int32))

        st = lax.cond(jnp.sum(st[5]) > cfg.capacity, cap_delete,
                      lambda s: s, st)
        for _ in range(cfg.max_geometric_deletes):
            g = jnp.where(st[5] > 0, 1.0 / st[6], jnp.inf)
            st = lax.cond((jnp.min(g) < cfg.geom_tol) & (jnp.sum(st[5]) > 1),
                          lambda s: delete(s, lax.argmin(g, 0, jnp.int32)),
                          lambda s: s, st)
        return st

    def body(p, st):
        return lax.cond(V_ref[p] != 0, functools.partial(update, p),
                        lambda s: s, st)

    C = C_ref[...]
    Q = Q_ref[...]
    st = (bv_ref[:, 0], bv_ref[:, 1],
          tuple(al_ref[:, d] for d in range(dout)), C, Q, act_ref[...],
          diag(Q))
    n = jnp.minimum(cnt_ref[...], n_points)
    bx, by, al, C, Q, act, _ = lax.fori_loop(0, n, body, st)
    bv_o[:, 0] = bx
    bv_o[:, 1] = by
    for d in range(dout):
        al_o[:, d] = al[d]
    C_o[...] = C
    Q_o[...] = Q
    act_o[...] = act


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def add_points_batch_pallas(kp: RBFParams, cfg: GPConfig, states: SOGPState,
                            X: jnp.ndarray, Y: jnp.ndarray,
                            mask: jnp.ndarray,
                            interpret: bool = False,
                            s20=None, eps_tol=None) -> SOGPState:
    """Drop-in for sparse_gp.add_points_batch (Gaussian noise, no shuffle —
    permute X/Y/mask outside if desired). X: [B, P, 2], Y: [B, P, D],
    mask: [B, P].

    s20 / eps_tol: optional TRACED overrides of the config constants; they
    ride the hyperparameter row, so a calibrated run (traced
    hyperparameters from MAP/HMC) reuses the same compiled kernel.
    interpret: run the kernel in the Pallas interpreter (CPU tests)."""
    B, P, _ = X.shape
    D = Y.shape[-1]
    S = cfg.slots
    dt = states.C.dtype
    sf = jnp.asarray(kp.sigmaf_sq, dt)
    l2 = jnp.asarray(kp.l_sq, dt)
    prm = jnp.stack([
        sf, l2,
        jnp.asarray(cfg.s20 if s20 is None else s20, dt),
        jnp.asarray(cfg.eps_tol if eps_tol is None else eps_tol, dt)])
    # per-patch trip count: last valid row + 1 (any mask pattern)
    last = P - 1 - jnp.argmax(mask[:, ::-1], axis=1)
    cnt = jnp.where(jnp.any(mask, axis=1), last + 1, 0).astype(jnp.int32)

    def per_patch(*shape):
        return pl.BlockSpec((None,) + shape,
                            lambda i: (i,) + (0,) * len(shape))

    state_specs = [per_patch(S, 2), per_patch(S, D), per_patch(S, S),
                   per_patch(S, S), per_patch(S)]
    out_shape = [jax.ShapeDtypeStruct((B, S, 2), dt),
                 jax.ShapeDtypeStruct((B, S, D), dt),
                 jax.ShapeDtypeStruct((B, S, S), dt),
                 jax.ShapeDtypeStruct((B, S, S), dt),
                 jax.ShapeDtypeStruct((B, S), dt)]
    bv, alpha, C, Q, act = pl.pallas_call(
        functools.partial(_kernel, cfg, D, P),
        out_shape=out_shape,
        grid=(B,),
        in_specs=[pl.BlockSpec((_N_PRM,), lambda i: (0,)), per_patch(),
                  per_patch(P, 2), per_patch(P, D), per_patch(P),
                  *state_specs],
        out_specs=state_specs,
        input_output_aliases={5: 0, 6: 1, 7: 2, 8: 3, 9: 4},
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS[S], num_stages=_NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="sogp_train",
    )(prm, cnt, X.astype(dt), Y.astype(dt), mask.astype(jnp.int32),
      states.bv, states.alpha, states.C, states.Q, states.active.astype(dt))
    return SOGPState(bv=bv, alpha=alpha, C=C, Q=Q, active=act > 0.5)


def train_patches(kp: RBFParams, s20, cfg: GPConfig, states: SOGPState,
                  X: jnp.ndarray, Y: jnp.ndarray, mask: jnp.ndarray, *,
                  eps_tol=None, keys: Optional[jax.Array] = None,
                  use_kernel: bool = False, interpret: bool = False,
                  mesh=None) -> SOGPState:
    """Train a bank of patch GPs: the fused kernel where `use_kernel` and
    the shape rule (`kernel_covers`) allow it, else the XLA scan.

    s20: noise variance, traced or None (cfg.s20). keys: optional [B] PRNG
    keys for the reference's shuffle-before-insert; both paths apply the
    same per-patch permutation. mesh: run the kernel patch-parallel over
    the mesh's `data` axis (the XLA scan partitions by propagation)."""
    if not (use_kernel and kernel_covers(cfg, states.C.dtype)):
        s20 = jnp.asarray(cfg.s20) if s20 is None else s20
        return sparse_gp.add_points_batch(kp, GaussianNoise(s20=s20), cfg,
                                          states, X, Y, mask, keys,
                                          eps_tol=eps_tol)
    if keys is not None:
        perm = jax.vmap(lambda k: jax.random.permutation(k, X.shape[1]))(keys)
        X = jnp.take_along_axis(X, perm[..., None], axis=1)
        Y = jnp.take_along_axis(Y, perm[..., None], axis=1)
        mask = jnp.take_along_axis(mask, perm, axis=1)
    if mesh is None:
        return add_points_batch_pallas(kp, cfg, states, X, Y, mask,
                                       interpret=interpret, s20=s20,
                                       eps_tol=eps_tol)
    # a pallas_call is an opaque custom call GSPMD cannot partition; the
    # grid is per-patch independent, so each device running the kernel on
    # its local patch shard is exact. Hyperparameters replicate.
    from jax.sharding import PartitionSpec

    dt = states.C.dtype
    s20 = jnp.asarray(cfg.s20 if s20 is None else s20, dt)
    eps = jnp.asarray(cfg.eps_tol if eps_tol is None else eps_tol, dt)

    def body(kp, states, X, Y, M, s20, eps):
        return add_points_batch_pallas(kp, cfg, states, X, Y, M,
                                       interpret=interpret, s20=s20,
                                       eps_tol=eps)

    d, r = PartitionSpec("data"), PartitionSpec()
    return jax.shard_map(body, mesh=mesh, in_specs=(r, d, d, d, d, r, r),
                         out_specs=d, check_vma=False)(
        kp, states, X, Y, mask, s20, eps)
