"""Fused SOGP training kernel (Pallas through Triton) vs the XLA scan path.

On the CPU the kernel runs in the Pallas interpreter, and its Triton
lowering is checked down to a verified Triton module; the compile for the
card and the parity at bench widths run in `python chip_smoke.py` (and in
the `gpu`-marked test below where a card is present).

Two regimes: a strict microtest with no deletion churn (results must agree
to float32 accumulation error), and the realistic smooth-surface regime
where per-op rounding differences can flip chaotic deletion choices in a
few patches — there parity is statistical (sizes, median prediction
agreement, equal reconstruction quality).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_compressor_jax.config import GPConfig
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.ops.noise import GaussianNoise
from gp_compressor_jax.pallas_kernels import sogp_train

KP = RBFParams(sigmaf_sq=jnp.asarray(100.0, jnp.float32),
               l_sq=jnp.asarray(1.0, jnp.float32))
NOISE = GaussianNoise(s20=jnp.asarray(0.1, jnp.float32))


def _run_both(cfg, X, Y, mask):
    ref = sparse_gp.add_points_batch(KP, NOISE, cfg,
                                     sparse_gp.init_batch(cfg, X.shape[0]),
                                     X, Y, mask)
    out = sogp_train.add_points_batch_pallas(
        KP, cfg, sparse_gp.init_batch(cfg, X.shape[0]), X, Y, mask,
        interpret=True)
    return ref, out


@pytest.mark.parametrize("dout", [1, 3])
def test_strict_parity_no_churn(dout):
    """Well-separated points, capacity ample: no deletions, branch
    decisions robust — states must agree to f32 accumulation error."""
    r = np.random.default_rng(0)
    B, P = 130, 12
    cfg = GPConfig(capacity=14, slots=16, dout=dout, eps_tol=1e-4,
                   dtype=jnp.float32)
    X = jnp.asarray(r.uniform(-20, 20, size=(B, P, 2)), jnp.float32)
    Y = jnp.asarray(r.normal(size=(B, P, dout)), jnp.float32)
    mask = jnp.asarray(r.uniform(size=(B, P)) > 0.2)
    ref, out = _run_both(cfg, X, Y, mask)
    assert np.array_equal(np.asarray(ref.active), np.asarray(out.active))
    for name, a, b in [("bv", ref.bv, out.bv), ("alpha", ref.alpha, out.alpha),
                       ("C", ref.C, out.C), ("Q", ref.Q, out.Q)]:
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                           rtol=1e-3), name


def test_statistical_parity_realistic_regime():
    """Smooth depth surfaces with capacity churn: both paths must deliver
    the same BV budgets and equally good posteriors."""
    r = np.random.default_rng(3)
    B, P = 140, 80
    cfg = GPConfig(capacity=8, slots=16, dout=1, eps_tol=2.0,
                   dtype=jnp.float32)
    X = jnp.asarray(r.uniform(-0.075, 0.075, size=(B, P, 2)), jnp.float32)
    f = 0.03 * np.sin(8 * np.asarray(X[..., 0])) \
        + 0.02 * np.cos(11 * np.asarray(X[..., 1]))
    Y = jnp.asarray((f + 0.004 * r.standard_normal((B, P)))[..., None],
                    jnp.float32)
    mask = jnp.ones((B, P), bool)
    ref, out = _run_both(cfg, X, Y, mask)

    sa = np.asarray(sparse_gp.size(ref))
    sb = np.asarray(sparse_gp.size(out))
    assert (sa == sb).mean() > 0.9
    m1, _ = sparse_gp.predict_batch(KP, cfg.s20, ref, X)
    m2, _ = sparse_gp.predict_batch(KP, cfg.s20, out, X)
    rmse1 = float(jnp.sqrt(jnp.mean((m1 - Y) ** 2)))
    rmse2 = float(jnp.sqrt(jnp.mean((m2 - Y) ** 2)))
    assert abs(rmse1 - rmse2) < 0.2 * max(rmse1, 1e-3), (rmse1, rmse2)
    d = np.abs(np.asarray(m1) - np.asarray(m2))
    assert np.median(d) < 5e-3, np.median(d)


def test_geometric_novelty_parity_and_selection():
    """GPConfig.novelty_mode='geometric': both paths must admit the same
    (farthest-point-style) basis and agree on the resulting state; the
    admitted BVs must respect the separation and budget rules."""
    r = np.random.default_rng(7)
    B, P = 130, 40
    res = 0.15
    cfg = GPConfig(capacity=14, slots=16, dout=1, dtype=jnp.float32,
                   novelty_mode="geometric", geom_dmin=0.05, geom_max_bv=3,
                   geom_gamma_min_rel=1e-2)
    half = res / 2
    X = jnp.asarray(r.uniform(-half, half, size=(B, P, 2)), jnp.float32)
    Y = jnp.asarray(0.01 * r.normal(size=(B, P, 1)), jnp.float32)
    mask = jnp.asarray(r.uniform(size=(B, P)) > 0.1)
    ref, out = _run_both(cfg, X, Y, mask)
    assert np.array_equal(np.asarray(ref.active), np.asarray(out.active))
    # a gamma within f32 rounding of the admission floor can flip between
    # the two paths' summation orders (knife-edge, same as the capacity
    # churn caveat above): require identical BV picks on >= 95% of patches
    # and strict state agreement there
    same = np.all(np.asarray(ref.bv) == np.asarray(out.bv), axis=(1, 2))
    assert same.mean() >= 0.95, same.mean()
    # at sf=100/l=1 conditioning the recursion amplifies per-op rounding
    # order differences through the state, so raw-state comparison is
    # meaningless; compare what reaches users — predictions on the
    # footprint — on the same-decision patches
    probes = jnp.asarray(r.uniform(-half, half, size=(24, 2)), jnp.float32)
    Bp = jnp.broadcast_to(probes, (B, 24, 2))
    m_ref, v_ref = sparse_gp.predict_batch(KP, cfg.s20, ref, Bp)
    m_out, v_out = sparse_gp.predict_batch(KP, cfg.s20, out, Bp)
    dm = np.abs(np.asarray(m_ref)[same] - np.asarray(m_out)[same])
    assert np.median(dm) < 1e-3, np.median(dm)
    assert dm.max() < 2e-2, dm.max()     # well under the 0.01 data scale
    # equally good in-sample fits on the training points
    tm_ref, _ = sparse_gp.predict_batch(KP, cfg.s20, ref, X)
    tm_out, _ = sparse_gp.predict_batch(KP, cfg.s20, out, X)
    mask_np = np.asarray(mask)
    e_ref = np.sqrt(np.mean((np.asarray(tm_ref)[..., 0] -
                             np.asarray(Y)[..., 0])[mask_np] ** 2))
    e_out = np.sqrt(np.mean((np.asarray(tm_out)[..., 0] -
                             np.asarray(Y)[..., 0])[mask_np] ** 2))
    assert abs(e_ref - e_out) < 0.1 * max(e_ref, e_out), (e_ref, e_out)
    # no divergence anywhere, either path
    for st in (ref, out):
        for leaf in (st.alpha, st.C, st.Q):
            assert np.isfinite(np.asarray(leaf)).all()
    # selection invariants: budget respected, pairwise separation >= dmin
    sizes = np.asarray(sparse_gp.size(ref))
    assert sizes.max() <= cfg.geom_max_bv
    assert sizes.min() >= 1           # every patch has valid points
    bv = np.asarray(ref.bv)
    act = np.asarray(ref.active)
    for b_ in range(B):
        pts = bv[b_][act[b_]]
        if len(pts) >= 2:
            d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            assert d.min() >= cfg.geom_dmin - 1e-6


# ---- the wrapper: shape rule, dispatch, padding ---------------------------

@pytest.mark.parametrize("slots,dtype,covered", [
    (16, jnp.float32, True), (32, jnp.float32, True),
    (64, jnp.float32, True), (128, jnp.float32, True),
    (24, jnp.float32, False), (101, jnp.float32, False),
    (256, jnp.float32, False), (32, jnp.float64, False)])
def test_kernel_shape_rule(slots, dtype, covered):
    cfg = GPConfig(capacity=min(14, slots - 1), slots=slots, dtype=dtype)
    assert sogp_train.kernel_covers(cfg, dtype) is covered


def _has_pallas_call(fn, *args):
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("slots,dtype", [(32, jnp.float32),
                                         (24, jnp.float32),
                                         (32, jnp.float64)])
def test_train_patches_dispatch_follows_shape_rule(slots, dtype):
    """use_kernel=True takes the kernel exactly where the shape rule covers
    the GP; elsewhere it is the XLA scan, bit for bit."""
    r = np.random.default_rng(1)
    B, P = 6, 10
    cfg = GPConfig(capacity=8, slots=slots, dtype=dtype, eps_tol=1e-4)
    kp = RBFParams(jnp.asarray(100.0, dtype), jnp.asarray(1.0, dtype))
    X = jnp.asarray(r.uniform(-5, 5, (B, P, 2)), dtype)
    Y = jnp.asarray(r.normal(size=(B, P, 1)), dtype)
    M = jnp.asarray(r.uniform(size=(B, P)) > 0.3)
    st0 = sparse_gp.init_batch(cfg, B)

    def run(use):
        return lambda X, Y, M: sogp_train.train_patches(
            kp, None, cfg, st0, X, Y, M, use_kernel=use, interpret=True)

    covered = sogp_train.kernel_covers(cfg, dtype)
    assert _has_pallas_call(run(True), X, Y, M) is covered
    assert not _has_pallas_call(run(False), X, Y, M)
    a, b = run(True)(X, Y, M), run(False)(X, Y, M)
    assert a.C.shape == b.C.shape == (B, slots, slots)
    assert a.alpha.shape == (B, slots, 1) and a.active.dtype == jnp.bool_
    if not covered:
        for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    else:
        assert np.array_equal(np.asarray(a.active), np.asarray(b.active))
        np.testing.assert_allclose(np.asarray(a.C), np.asarray(b.C),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("pattern", ["prefix", "interleaved", "empty_rows"])
def test_kernel_trip_count_and_padding(pattern):
    """Each program loops to its patch's last valid row: prefix masks,
    padding interleaved with data (scatter-shuffled banks) and all-empty
    patches (whose state must pass through untouched, even when it is not
    the empty GP) all match the XLA scan."""
    r = np.random.default_rng(5)
    B, P, S = 9, 16, 16
    X = jnp.asarray(r.uniform(-20, 20, (B, P, 2)), jnp.float32)
    Y = jnp.asarray(r.normal(size=(B, P, 3)), jnp.float32)
    n = r.integers(0, P + 1, B)
    if pattern == "prefix":
        M = np.arange(P)[None] < n[:, None]
    elif pattern == "interleaved":
        M = r.uniform(size=(B, P)) > 0.5
    else:
        M = np.arange(P)[None] < n[:, None]
        M[::3] = False
    cfg3 = GPConfig(capacity=12, slots=S, dout=3, eps_tol=1e-4,
                    dtype=jnp.float32)
    # a non-empty starting state: first train on 4 points everywhere
    warm = np.zeros((B, P), bool)
    warm[:, :4] = True
    st0 = sparse_gp.add_points_batch(KP, NOISE, cfg3,
                                     sparse_gp.init_batch(cfg3, B), X, Y,
                                     jnp.asarray(warm))
    M = jnp.asarray(M)
    ref = sparse_gp.add_points_batch(KP, NOISE, cfg3, st0, X[:, ::-1],
                                     Y[:, ::-1], M)
    out = sogp_train.add_points_batch_pallas(KP, cfg3, st0, X[:, ::-1],
                                             Y[:, ::-1], M, interpret=True)
    assert np.array_equal(np.asarray(ref.active), np.asarray(out.active))
    for f in ("bv", "alpha", "C", "Q"):
        np.testing.assert_allclose(np.asarray(getattr(ref, f)),
                                   np.asarray(getattr(out, f)),
                                   rtol=1e-3, atol=1e-4, err_msg=f)
    empty = ~np.asarray(M).any(axis=1)
    for f in ("bv", "alpha", "C", "Q", "active"):
        np.testing.assert_array_equal(np.asarray(getattr(out, f))[empty],
                                      np.asarray(getattr(st0, f))[empty])


def test_train_patches_shuffle_keys_match_the_scan():
    """With per-patch shuffle keys both paths insert in the same order."""
    r = np.random.default_rng(2)
    B, P = 7, 12
    cfg = GPConfig(capacity=10, slots=16, eps_tol=1e-4, dtype=jnp.float32)
    X = jnp.asarray(r.uniform(-20, 20, (B, P, 2)), jnp.float32)
    Y = jnp.asarray(r.normal(size=(B, P, 1)), jnp.float32)
    M = jnp.asarray(r.uniform(size=(B, P)) > 0.2)
    keys = jax.random.split(jax.random.key(3), B)
    st0 = sparse_gp.init_batch(cfg, B)
    a = sogp_train.train_patches(KP, jnp.float32(0.1), cfg, st0, X, Y, M,
                                 keys=keys, use_kernel=True, interpret=True)
    b = sogp_train.train_patches(KP, jnp.float32(0.1), cfg, st0, X, Y, M,
                                 keys=keys)
    assert np.array_equal(np.asarray(a.active), np.asarray(b.active))
    np.testing.assert_allclose(np.asarray(a.alpha), np.asarray(b.alpha),
                               rtol=1e-3, atol=1e-4)


# ---- the GPU route: lowering here, compile + parity on the card ------------

@pytest.mark.parametrize("slots,dout,mode", [
    (16, 1, "geometric"), (32, 1, "gamma"), (32, 3, "gamma"),
    (64, 3, "gamma"), (128, 1, "gamma")])
def test_kernel_lowers_to_a_verified_triton_module(slots, dout, mode):
    """The kernel's Pallas->Triton lowering runs on the CPU (the GPU's own
    compiler does not): every covered width must lower to a Triton module
    that passes MLIR verification — power-of-two tensors, supported
    primitives, i32 argmins."""
    from jax._src.pallas.triton import lowering

    cfg = GPConfig(capacity=min(30, slots - 2), slots=slots, dout=dout,
                   novelty_mode=mode, dtype=jnp.float32)
    B, P = 4, 256
    kp = RBFParams(jnp.float32(100.0), jnp.float32(1.0))
    with jax.enable_x64(False):
        jaxpr = jax.make_jaxpr(
            lambda st, X, Y, M: sogp_train.add_points_batch_pallas(
                kp, cfg, st, X, Y, M))(
            sparse_gp.init_batch(cfg, B), jnp.zeros((B, P, 2), jnp.float32),
            jnp.zeros((B, P, dout), jnp.float32),
            jnp.zeros((B, P), bool))

    def calls(jp):
        for e in jp.eqns:
            if e.primitive.name == "pallas_call":
                yield e
            for v in e.params.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    yield from calls(sub)

    (eqn,) = list(calls(jaxpr.jaxpr))
    res = lowering.lower_jaxpr_to_triton_module(
        eqn.params["jaxpr"], eqn.params["grid_mapping"], "cuda")
    assert res.module.operation.verify()
    assert list(res.grid) == [B]


@pytest.mark.gpu
def test_kernel_matches_scan_on_the_card(gpu_device):
    """Compiled for the card (not interpreted): strict-regime parity at the
    bench width S = 32."""
    r = np.random.default_rng(0)
    B, P = 256, 64
    cfg = GPConfig(capacity=30, slots=32, eps_tol=1e-4, dtype=jnp.float32)
    with jax.default_device(gpu_device):
        X = jnp.asarray(r.uniform(-20, 20, (B, P, 2)), jnp.float32)
        Y = jnp.asarray(r.normal(size=(B, P, 1)), jnp.float32)
        M = jnp.asarray(np.argsort(r.uniform(size=(B, P)), 1) < 24)
        st0 = sparse_gp.init_batch(cfg, B)
        a = sparse_gp.add_points_batch(KP, NOISE, cfg, st0, X, Y, M)
        b = sogp_train.add_points_batch_pallas(KP, cfg, st0, X, Y, M)
    assert np.array_equal(np.asarray(a.active), np.asarray(b.active))
    np.testing.assert_allclose(np.asarray(a.C), np.asarray(b.C),
                               rtol=1e-3, atol=1e-4)
