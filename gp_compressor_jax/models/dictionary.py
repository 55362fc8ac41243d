"""Dictionary codec: batched masked OMP + K-SVD.

Reference semantics:
  * orthogonal_matching_pursuit::omp_match_vector
    (src/orthogonal_matching_pursuit.cpp:33-97): greedy argmax of
    |residual^T D| over unused atoms, then re-solve the coefficients of all
    selected atoms against the *masked* signal via an incrementally-updated
    inverse Gram with *unit diagonal* ("assuming ||x_k+1|| = 1" — the
    masked atom norm is in fact not 1; the reference keeps it anyway,
    :86,92, and we reproduce that choice). Stop at words_max atoms or
    residual^2 < proj_error (:50-52).
  * ksvd_decomposition (src/ksvd_decomposition.cpp): loop { replace unused
    atoms with random normalized data columns (:169-184); OMP-code every
    patch (:51-64); per-atom Gauss-Seidel update via the largest singular
    pair of the masked residual restricted to the atom's users, computed by
    NIPALS power iteration (:66-148) } until the masked MSE change drops
    below stop_diff (:27-49).

Batched form: every per-patch loop becomes a batched matmul over all n
patches at once — correlations [n, l] @ [l, K], the k x k
coefficient solves are identity-padded [n, kmax, kmax] batched solves, and
the per-atom NIPALS runs on full-width masked residual matrices with
column-selection weights instead of dynamic gathers. The sequential
structure that remains (greedy atom order, Gauss-Seidel atom sweep) is a
short `lax.scan`, exactly as SURVEY.md §7.6 prescribes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_compressor_jax.config import KSVDConfig

# Every contraction runs at HIGHEST precision: a GPU's default f32 matmul
# may run in TF32 (10-bit mantissa), which would move the OMP atom choices
# and the NIPALS singular pairs away from the f32 codec the CPU computes.
# The products are small ([n, l] @ [l, K] at K <= 600), so full f32 is
# cheap.
_HI = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class OMPCode(NamedTuple):
    X: jnp.ndarray   # [n, kmax] coefficients
    I: jnp.ndarray   # [n, kmax] atom indices
    nw: jnp.ndarray  # [n] number of words used


def omp_encode(D: jnp.ndarray, S: jnp.ndarray, W: jnp.ndarray,
               valid: jnp.ndarray, cfg: KSVDConfig) -> OMPCode:
    """Batched masked OMP. D: [l, K], S: [n, l], W: [n, l] float mask,
    valid: [n] (padding patches are no-ops)."""
    n, l = S.shape
    K = D.shape[1]
    kmax = cfg.words_max
    dt = S.dtype

    Sm = S * W                                    # masked signals
    r0 = Sm
    used0 = jnp.zeros((n, K), bool)
    I0 = jnp.zeros((n, kmax), jnp.int32)
    X0 = jnp.zeros((n, kmax), dt)
    G0 = jnp.broadcast_to(jnp.eye(kmax, dtype=dt), (n, kmax, kmax))
    c0 = jnp.zeros((n, kmax), dt)
    nw0 = jnp.zeros((n,), jnp.int32)

    def step(carry, k):
        r, used, I, X, G, c, nw = carry
        active = (jnp.sum(r * r, axis=1) >= cfg.proj_error) & valid    # [n]

        w = _mm(r, D)                                              # [n, K]
        w = jnp.where(used | ~jnp.isfinite(w), 0.0, w)
        ind = jnp.argmax(jnp.abs(w), axis=1).astype(jnp.int32)         # [n]

        used_n = used | (jax.nn.one_hot(ind, K, dtype=jnp.int32) > 0) & active[:, None]
        I_n = I.at[:, k].set(jnp.where(active, ind, I[:, k]))

        d_new = D.T[ind]                                               # [n, l]
        d_new_m = d_new * W
        # Gram row against previously selected atoms (masked new vs raw
        # old == symmetric masked Gram since the 0/1 mask is idempotent)
        Dsel = jnp.take(D.T, I_n, axis=0)                              # [n, kmax, l]
        g = jnp.einsum('nl,nkl->nk', d_new_m, Dsel,
                       precision=_HI)                                  # [n, kmax]
        below = jnp.arange(kmax) < k
        g = jnp.where(below, g, 0.0)
        G_n = G.at[:, k, :].set(jnp.where(active[:, None], g, G[:, k, :]))
        G_n = G_n.at[:, :, k].set(jnp.where(active[:, None], g, G_n[:, :, k]))
        if cfg.exact_gram_diag:
            diag = jnp.einsum('nl,nl->n', d_new_m, d_new, precision=_HI)
            G_n = G_n.at[:, k, k].set(jnp.maximum(diag, 1e-12))
        else:
            G_n = G_n.at[:, k, k].set(1.0)      # reference's unit diagonal
        c_n = c.at[:, k].set(jnp.where(
            active, jnp.einsum('nl,nl->n', Sm, d_new, precision=_HI), c[:, k]))

        # identity-padded [kmax, kmax] solve == solve over first k+1 atoms
        sel = jnp.arange(kmax) <= k
        Gk = jnp.where(sel[None, :, None] & sel[None, None, :], G_n,
                       jnp.broadcast_to(jnp.eye(kmax, dtype=dt), (n, kmax, kmax)))
        ck = jnp.where(sel[None, :], c_n, 0.0)
        x = jnp.linalg.solve(Gk, ck[..., None])[..., 0]                # [n, kmax]
        X_n = jnp.where(active[:, None], x, X)

        # masked residual with the re-solved coefficients
        recon = jnp.einsum('nk,nkl->nl', X_n, jnp.take(D.T, I_n, axis=0),
                           precision=_HI)
        r_n = Sm - recon * W
        r_n = jnp.where(active[:, None], r_n, r)

        nw_n = nw + active.astype(jnp.int32)
        new = (r_n, used_n.astype(bool), I_n, X_n, G_n, c_n, nw_n)
        old = (r, used, I, X, G, c, nw)
        out = jax.tree.map(lambda a, b: jnp.where(
            active.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), new, old)
        return out, None

    carry = (r0, used0, I0, X0, G0, c0, nw0)
    (r, used, I, X, G, c, nw), _ = lax.scan(step, carry, jnp.arange(kmax))
    return OMPCode(X=X, I=I, nw=nw)


def mp_encode(D: jnp.ndarray, S: jnp.ndarray, W: jnp.ndarray,
              valid: jnp.ndarray, cfg: KSVDConfig) -> OMPCode:
    """Plain matching pursuit (no coefficient re-solve) — the reference's
    mp_match_vector variant (src/orthogonal_matching_pursuit.cpp:99-127):
    each step takes the greedy atom with its raw correlation coefficient
    and subtracts its masked contribution from the residual."""
    n, l = S.shape
    K = D.shape[1]
    kmax = cfg.words_max
    dt = S.dtype
    Sm = S * W

    def step(carry, k):
        r, used, I, X, nw = carry
        active = (jnp.sum(r * r, axis=1) >= cfg.proj_error) & valid
        w = _mm(r, D)
        w = jnp.where(used | ~jnp.isfinite(w), 0.0, w)
        ind = jnp.argmax(jnp.abs(w), axis=1).astype(jnp.int32)
        coef = jnp.take_along_axis(w, ind[:, None], axis=1)[:, 0]
        used = used | ((jax.nn.one_hot(ind, K, dtype=jnp.int32) > 0)
                       & active[:, None])
        I = I.at[:, k].set(jnp.where(active, ind, I[:, k]))
        X = X.at[:, k].set(jnp.where(active, coef, X[:, k]))
        d_sel = D.T[ind] * W                                   # masked atom
        r = jnp.where(active[:, None], r - coef[:, None] * d_sel, r)
        nw = nw + active.astype(jnp.int32)
        return (r, used, I, X, nw), None

    carry = (Sm, jnp.zeros((n, K), bool), jnp.zeros((n, kmax), jnp.int32),
             jnp.zeros((n, kmax), dt), jnp.zeros((n,), jnp.int32))
    (r, used, I, X, nw), _ = lax.scan(step, carry, jnp.arange(kmax))
    return OMPCode(X=X, I=I, nw=nw)


def reconstruct(D: jnp.ndarray, code: OMPCode) -> jnp.ndarray:
    """S_rec[n, l] = sum_k X[n,k] D[:, I[n,k]] over the used words."""
    kmax = code.X.shape[1]
    usek = jnp.arange(kmax)[None, :] < code.nw[:, None]
    Dsel = jnp.take(D.T, code.I, axis=0)                  # [n, kmax, l]
    return jnp.einsum('nk,nkl->nl', code.X * usek, Dsel, precision=_HI)


def masked_error(D, code, S, W, valid):
    """Mean over patches of the squared masked residual norm
    (ksvd_decomposition::compute_error, src/ksvd_decomposition.cpp:151-167)."""
    R = (S - reconstruct(D, code)) * W * valid[:, None]
    nv = jnp.maximum(jnp.sum(valid), 1.0)
    return jnp.sum(R * R) / nv


def _power_iteration(A: jnp.ndarray, iters: int):
    """Largest singular pair of A [l, n] by NIPALS
    (ksvd_decomposition::nipals_largest_singular, :66-89). Returns
    (u [l] unit, v [n] unit, sigma). Fixed iteration count — the reference
    breaks early at 1% relative convergence purely as a CPU shortcut."""
    l = A.shape[0]
    u0 = jnp.full((l,), 1.0 / jnp.sqrt(jnp.asarray(l, A.dtype)), A.dtype)

    def body(_, u):
        v = _mm(A.T, u)
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-30)
        return _mm(A, v)

    u = lax.fori_loop(0, iters, body, u0)
    lam = jnp.sum(u * u)
    sigma = jnp.sqrt(lam)
    u = u / jnp.maximum(sigma, 1e-30)
    v = _mm(A.T, u)
    v = v / jnp.maximum(jnp.linalg.norm(v), 1e-30)
    return u, v, sigma


class KSVDResult(NamedTuple):
    D: jnp.ndarray       # [l, K]
    code: OMPCode
    error: jnp.ndarray   # final masked MSE
    iters: jnp.ndarray   # sweeps performed (int; traced on the device path)


def _replace_unused(D, usage_count, S, valid, key, cfg):
    """Unused atoms <- random normalized (masked) data columns
    (ksvd_decomposition::replace_unused, :169-184)."""
    n, l = S.shape
    K = D.shape[1]
    # sample a random valid patch per atom (with replacement — the
    # reference draws without replacement; collision odds are negligible
    # for n >> K and irrelevant to convergence)
    p = valid.astype(S.dtype)
    p = p / jnp.sum(p)
    idx = jax.random.choice(key, n, shape=(K,), p=p)
    cand = S[idx]                                          # [K, l]
    norm = jnp.linalg.norm(cand, axis=1, keepdims=True)
    cand = jnp.where(norm > 0, cand / jnp.maximum(norm, 1e-30), cand)
    unused = (usage_count == 0)[None, :]                   # [1, K] over columns
    return jnp.where(unused, cand.T, D)


def _atom_sweep(D, code, S, W, valid, cfg):
    """Dictionary update over all atoms
    (ksvd_decomposition::optimize_dictionary, :91-148), with the masked
    residual R = W o (S - D X) maintained incrementally and per-atom column
    selection done by weights instead of gathers.

    cfg.atom_block == 1 is the reference's pure Gauss-Seidel order; larger
    blocks update `atom_block` atoms per scan step Jacobi-style against the
    block-start residual (see KSVDConfig.atom_block) — the rank-1 residual
    corrections are linear, so the block applies them jointly."""
    n, l = S.shape
    K = D.shape[1]
    kmax = code.X.shape[1]
    blk = max(1, min(cfg.atom_block, K))
    usek = (jnp.arange(kmax)[None, :] < code.nw[:, None]) & valid[:, None]
    Xeff = code.X * usek

    R = (S - reconstruct(D, code)) * W * valid[:, None]    # [n, l]

    def one_atom(R, D, Xeff, j):
        """Updated (u [l], xj_new [n], using [n], kpos [n], old xj, dj)
        for atom j against residual R; no-op payload for padded j >= K."""
        real = j < K
        jc = jnp.minimum(j, K - 1)
        using = jnp.any((code.I == jc) & usek, axis=1) & real  # [n]
        kpos = jnp.argmax((code.I == jc) & usek, axis=1)       # [n]
        xj = jnp.take_along_axis(Xeff, kpos[:, None], axis=1)[:, 0] * using

        dj = D[:, jc]                                      # [l]
        # masked residual with atom j's contribution restored, restricted
        # to its users: A = sel o (R + W o (x_j d_j^T))
        A = (R + (xj[:, None] * dj[None, :]) * W) * using[:, None]  # [n, l]
        u, v, sigma = _power_iteration(A.T, cfg.power_iters)
        xj_new = sigma * v * using
        any_user = jnp.any(using)
        u = jnp.where(any_user, u, dj)
        xj_new = jnp.where(any_user, xj_new, xj)
        return u, xj_new, using, kpos, xj, dj

    if blk == 1:
        def step(carry, j):
            R, D, Xeff = carry
            u, xj_new, using, kpos, xj, dj = one_atom(R, D, Xeff, j)
            R_new = R + ((xj[:, None] * dj[None, :]) -
                         (xj_new[:, None] * u[None, :])) * W * using[:, None]
            D_new = D.at[:, j].set(u)
            Xeff_new = jnp.where(
                (jnp.arange(kmax)[None, :] == kpos[:, None]) & using[:, None],
                xj_new[:, None], Xeff)
            return (R_new, D_new, Xeff_new), None

        (R, D, Xeff), _ = lax.scan(step, (R, D, Xeff), jnp.arange(K))
    else:
        nblocks = (K + blk - 1) // blk
        jblocks = jnp.arange(nblocks * blk, dtype=jnp.int32).reshape(
            nblocks, blk)                                  # pad j >= K no-op

        def step(carry, jb):
            R, D, Xeff = carry
            u_b, xn_b, us_b, kp_b, xo_b, dj_b = jax.vmap(
                one_atom, in_axes=(None, None, None, 0))(R, D, Xeff, jb)
            # joint residual correction: sum of the block's rank-1 deltas
            # (each computed vs the block-start R — Jacobi within block)
            usf = us_b.astype(R.dtype)                     # [blk, n]
            old = jnp.einsum('bn,bl->nl', xo_b * usf, dj_b, precision=_HI)
            new = jnp.einsum('bn,bl->nl', xn_b * usf, u_b, precision=_HI)
            R_new = R + (old - new) * W
            # padded j >= K scatter out of bounds and drop (a clipped index
            # would race the real j = K-1 update in the same block)
            D_new = D.at[:, jnp.where(jb < K, jb, K)].set(u_b.T, mode='drop')
            upd = (jnp.arange(kmax)[None, None, :] == kp_b[:, :, None]) \
                & us_b[:, :, None]                         # [blk, n, kmax]
            Xeff_new = jnp.where(jnp.any(upd, axis=0),
                                 jnp.sum(jnp.where(upd, xn_b[:, :, None], 0.0),
                                         axis=0), Xeff)
            return (R_new, D_new, Xeff_new), None

        (R, D, Xeff), _ = lax.scan(step, (R, D, Xeff), jblocks)
    return D, code._replace(X=jnp.where(usek, Xeff, code.X)), R


def _ksvd_sweep(D, key, S, W, valid, cfg):
    """One outer K-SVD iteration: OMP-code every patch, Gauss-Seidel atom
    sweep, masked MSE, then swap unused atoms for random data columns
    (ksvd_decomposition::decompose body, src/ksvd_decomposition.cpp:27-49).
    Returns (D_next, code, err, mean_words)."""
    dt = S.dtype
    code = omp_encode(D, S, W, valid, cfg)
    usage = jax.ops.segment_sum(
        (jnp.arange(cfg.words_max)[None, :] < code.nw[:, None])
        .astype(jnp.int32).reshape(-1),
        code.I.reshape(-1), num_segments=cfg.dict_size)
    D2, code2, R = _atom_sweep(D, code, S, W, valid, cfg)
    err = masked_error(D2, code2, S, W, valid.astype(dt))
    D3 = _replace_unused(D2, usage, S, valid, key, cfg)
    return D3, code2, err, jnp.mean(code.nw * valid)


@functools.partial(jax.jit, static_argnames=("cfg",))
def ksvd_device(S: jnp.ndarray, W: jnp.ndarray, valid: jnp.ndarray,
                cfg: KSVDConfig, key: jax.Array) -> KSVDResult:
    """Whole K-SVD decomposition as ONE device program: the stop_diff early
    exit runs inside a `lax.while_loop` instead of fetching the masked MSE
    to host every outer iteration. Semantics match the host
    loop: sweep until |err_i - err_{i-1}| < stop_diff or max_iters."""
    n, l = S.shape
    dt = S.dtype
    W = W.astype(dt)
    valid = valid.astype(bool)
    key, k0 = jax.random.split(key)
    D0 = _replace_unused(jnp.zeros((l, cfg.dict_size), dt),
                         jnp.zeros(cfg.dict_size, jnp.int32), S, valid, k0,
                         cfg)
    kmax = cfg.words_max
    code0 = OMPCode(X=jnp.zeros((n, kmax), dt),
                    I=jnp.zeros((n, kmax), jnp.int32),
                    nw=jnp.zeros((n,), jnp.int32))
    inf = jnp.asarray(jnp.inf, dt)

    def cond(c):
        _, _, err, last, it, _ = c
        return (it < cfg.max_iters) & \
            ~((it > 0) & (jnp.abs(err - last) < cfg.stop_diff))

    def body(c):
        D, code, err, _, it, key = c
        key, ks = jax.random.split(key)
        D2, code2, e2, _ = _ksvd_sweep(D, ks, S, W, valid, cfg)
        return (D2, code2, e2, err, it + 1, key)

    D, _, _, _, it, _ = lax.while_loop(
        cond, body, (D0, code0, inf, inf, jnp.asarray(0, jnp.int32), key))
    # final encode against the settled dictionary
    code = omp_encode(D, S, W, valid, cfg)
    err = masked_error(D, code, S, W, valid.astype(dt))
    return KSVDResult(D=D, code=code, error=err, iters=it)


def ksvd(S: jnp.ndarray, W: jnp.ndarray, valid: jnp.ndarray,
         cfg: KSVDConfig, key: jax.Array,
         verbose: bool = False) -> KSVDResult:
    """Full K-SVD decomposition (ksvd_decomposition::decompose, :27-49).

    S: [n, l] patch rows, W: [n, l] float mask, valid: [n] patch validity.
    Default path is ksvd_device (one device program, on-device early exit);
    verbose=True falls back to a host-level loop that prints the per-
    iteration masked MSE / mean words like the reference
    (src/ksvd_decomposition.cpp:42-44).
    """
    if not verbose:
        return ksvd_device(S, W, valid, cfg, key)
    dt = S.dtype
    W = W.astype(dt)
    valid = valid.astype(bool)
    key, k0 = jax.random.split(key)
    D = _replace_unused(jnp.zeros((S.shape[1], cfg.dict_size), dt),
                        jnp.zeros(cfg.dict_size, jnp.int32), S, valid, k0, cfg)
    sweep = jax.jit(_ksvd_sweep, static_argnames=("cfg",))
    last = jnp.inf
    it = 0
    for it in range(1, cfg.max_iters + 1):
        key, ks = jax.random.split(key)
        D, code, err, mean_words = sweep(D, ks, S, W, valid, cfg)
        print(f"ksvd iter {it}: masked MSE {float(err):.6f}, "
              f"mean words {float(mean_words):.2f}")
        if abs(float(err) - float(last)) < cfg.stop_diff:
            break
        last = err
    code = jax.jit(omp_encode, static_argnames=("cfg",))(D, S, W, valid, cfg)
    err = masked_error(D, code, S, W, valid.astype(dt))
    return KSVDResult(D=D, code=code, error=err, iters=it)
