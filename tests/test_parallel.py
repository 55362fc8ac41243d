"""Multi-chip sharding tests on the virtual 8-device CPU mesh — the
pattern the reference cannot express at all (single thread, SURVEY.md §2.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gp_compressor_jax.config import GPConfig, MeshConfig
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.ops.noise import GaussianNoise
from gp_compressor_jax.parallel import mesh as mesh_lib

KP = RBFParams(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))


def test_mesh_shapes():
    assert len(jax.devices()) == 8
    m = mesh_lib.make_mesh(MeshConfig(chain_size=2))
    assert m.devices.shape == (4, 2)
    m1 = mesh_lib.make_mesh(MeshConfig())
    assert m1.devices.shape == (8, 1)


def test_sharded_training_matches_single_device():
    """Patch-axis sharding must not change results: same batched training
    on 8 devices vs 1."""
    cfg = GPConfig(capacity=10, slots=16, dtype=jnp.float64)
    noise = GaussianNoise(s20=jnp.asarray(0.1))
    r = np.random.default_rng(0)
    B, n = 16, 30
    X = jnp.asarray(r.uniform(-5, 5, size=(B, n, 2)))
    Y = jnp.asarray(r.normal(size=(B, n, 1)))
    mask = jnp.ones((B, n), bool)

    ref = sparse_gp.add_points_batch(KP, noise, cfg,
                                     sparse_gp.init_batch(cfg, B), X, Y, mask)

    m = mesh_lib.make_mesh(MeshConfig())
    sh = mesh_lib.patch_sharding(m)
    Xs = jax.device_put(X, sh)
    Ys = jax.device_put(Y, sh)
    ms = jax.device_put(mask, sh)
    states = jax.device_put(sparse_gp.init_batch(cfg, B), sh)

    @jax.jit
    def train(states, X, Y, mask):
        return sparse_gp.add_points_batch(KP, noise, cfg, states, X, Y, mask)

    out = train(states, Xs, Ys, ms)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_global_reduction_over_sharded_patches():
    """A global RMSE over the sharded patch axis (the registration /
    bench reduction) lowers to a cross-device collective and matches the
    unsharded value."""
    cfg = GPConfig(capacity=10, slots=16, dtype=jnp.float64)
    noise = GaussianNoise(s20=jnp.asarray(0.1))
    r = np.random.default_rng(1)
    B, n = 24, 20
    X = jnp.asarray(r.uniform(-5, 5, size=(B, n, 2)))
    Y = jnp.asarray(r.normal(size=(B, n, 1)))
    mask = jnp.ones((B, n), bool)

    m = mesh_lib.make_mesh(MeshConfig())
    sh = mesh_lib.patch_sharding(m)

    @jax.jit
    def train_and_rmse(states, X, Y, mask):
        st = sparse_gp.add_points_batch(KP, noise, cfg, states, X, Y, mask)
        mean, _ = sparse_gp.predict_batch(KP, cfg.s20, st, X)
        return jnp.sqrt(jnp.mean((mean - Y) ** 2))

    ref = train_and_rmse(sparse_gp.init_batch(cfg, B), X, Y, mask)
    out = train_and_rmse(jax.device_put(sparse_gp.init_batch(cfg, B), sh),
                         jax.device_put(X, sh), jax.device_put(Y, sh),
                         jax.device_put(mask, sh))
    assert np.isclose(float(ref), float(out), atol=1e-12)


def test_chain_axis_hmc_sharding():
    """HMC chains shard over the chain axis and sample independently."""
    from gp_compressor_jax.config import HMCConfig
    from gp_compressor_jax.inference import hmc

    def logpost(th):
        return -0.5 * jnp.sum(th ** 2)

    m = mesh_lib.make_mesh(MeshConfig(chain_size=2))
    csh = NamedSharding(m, P("chain"))
    theta0 = jax.device_put(jnp.zeros((2, 3)), csh)
    cfg = HMCConfig(num_warmup=50, num_samples=50)
    samples, acc, _ = jax.jit(
        lambda t0, k: hmc.hmc_sample_chains(logpost, t0, k, cfg))(
            theta0, jax.random.key(0))
    assert samples.shape == (2, 50, 3)
    assert np.isfinite(np.asarray(samples)).all()


def test_graft_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


# ---------------------------------------------------------------------------
# the REAL pipeline on the mesh: compress_decompress
# and register() — global sort/claim/segment front end included — must run
# sharded with parity against the single-device program.
# ---------------------------------------------------------------------------

from gp_compressor_jax.config import (CompressorConfig, PatchConfig,
                                      RegistrationConfig, rgb_gp_config)
from gp_compressor_jax.utils import synthetic
from gp_compressor_jax.workloads import compressor, registration

PIPE_CFG = CompressorConfig(
    patch=PatchConfig(res=0.5, sz=8, max_patches=128,
                      max_points_per_patch=128,
                      approx_sphere_moments=True, bank_order="center_out"),
    depth_gp=GPConfig(capacity=20, slots=32, eps_tol=2.0),
    rgb_gp=rgb_gp_config(slots=32, capacity=20),
)


def _small_cloud(n=5000, seed=3):
    pts, cols = synthetic.room_cloud(n=n, seed=seed)
    return (jnp.asarray(pts), jnp.asarray(cols),
            jnp.ones((pts.shape[0],), bool))


def test_compress_decompress_sharded_parity():
    """The headline one-jit program (value-sort banking, claim tables,
    segment sums, batched GP train, grid decompress) under a data-axis
    mesh == the single-device run."""
    pts, cols, valid = _small_cloud()
    key = jax.random.key(7)
    comp1, out1 = compressor.compress_decompress(pts, cols, valid, PIPE_CFG,
                                                 key)
    rmse1 = compressor.reconstruction_rmse(comp1, PIPE_CFG)

    m = mesh_lib.make_mesh(MeshConfig())
    sh = NamedSharding(m, P("data"))
    pts_s = jax.device_put(pts, sh)
    cols_s = jax.device_put(cols, sh)
    valid_s = jax.device_put(valid, sh)
    comp8, out8 = compressor.compress_decompress(pts_s, cols_s, valid_s,
                                                 PIPE_CFG, key, mesh=m)
    rmse8 = compressor.reconstruction_rmse(comp8, PIPE_CFG)

    # integer front-end outputs are order-deterministic: exact
    assert int(comp1.patch.n_leaves) == int(comp8.patch.n_leaves)
    np.testing.assert_array_equal(np.asarray(comp1.patch.claims),
                                  np.asarray(comp8.patch.claims))
    np.testing.assert_array_equal(np.asarray(comp1.patch.mask),
                                  np.asarray(comp8.patch.mask))
    # float outputs: identical up to f32 reduction reordering
    np.testing.assert_allclose(float(rmse1), float(rmse8),
                               rtol=1e-4, atol=1e-6)
    w1, c1, v1 = np.asarray(out1[0]), np.asarray(out1[1]), np.asarray(out1[2])
    w8, c8, v8 = np.asarray(out8[0]), np.asarray(out8[1]), np.asarray(out8[2])
    np.testing.assert_array_equal(v1, v8)
    np.testing.assert_allclose(w1[v1], w8[v8], atol=1e-4)
    np.testing.assert_allclose(c1[v1], c8[v8], atol=0.2)
    # the patch banks really are sharded over the mesh, not replicated
    shd = comp8.depth_gp.alpha.sharding
    assert not shd.is_fully_replicated


def test_register_sharded_parity():
    """register() (claims + banks + density gradients + twist psum under
    lax.while_loop) on the mesh == single device."""
    pts, cols, valid = _small_cloud(n=4000, seed=5)
    comp = compressor.compress(pts, cols, valid, PIPE_CFG, jax.random.key(0))

    # small rigid perturbation of the same cloud as the scan
    import gp_compressor_jax.geometry.transforms as transforms
    w = jnp.asarray([0.004, -0.003, 0.002], pts.dtype)
    t = jnp.asarray([0.008, -0.006, 0.004], pts.dtype)
    Rp = transforms.euler_xyz(w)
    scan = transforms.apply(pts, Rp, t)

    rcfg = RegistrationConfig(max_steps=8, min_steps=2, reclaim_every=2,
                              step_mode="rprop")
    st1, _ = registration.register(comp, scan, cols, valid, PIPE_CFG, rcfg)

    m = mesh_lib.make_mesh(MeshConfig())
    st8, _ = registration.register(comp, scan, cols, valid, PIPE_CFG, rcfg,
                                   mesh=m)
    assert int(st1.step_nbr) == int(st8.step_nbr)
    np.testing.assert_allclose(np.asarray(st1.t_cloud),
                               np.asarray(st8.t_cloud), atol=2e-6)
    np.testing.assert_allclose(np.asarray(st1.R_cloud),
                               np.asarray(st8.R_cloud), atol=2e-6)
    np.testing.assert_allclose(np.asarray(st1.delta),
                               np.asarray(st8.delta), rtol=2e-4, atol=1e-8)


def test_bench_shape_sharding_aot():
    """At BENCH shapes (2048 patches, 120k points,
    bench slots/banks) the compiled sharded calibrated pipeline must keep
    the patch banks, the GP train state and the decompress output
    data-partitioned — not all-gathered — and register() must compile on
    the mesh at the same scale. AOT compile only (~15 s on the CPU
    mesh)."""
    import dataclasses

    from gp_compressor_jax.parallel.aot_check import aot_shard_report

    cfg = CompressorConfig(
        patch=PatchConfig(res=0.15, sz=20, max_patches=2048,
                          max_points_per_patch=256,
                          approx_sphere_moments=True,
                          bank_order="center_out"),
        depth_gp=GPConfig(capacity=30, slots=32, eps_tol=2.0),
        rgb_gp=dataclasses.replace(rgb_gp_config(slots=32, capacity=30),
                                   eps_tol=2.0))
    m = mesh_lib.make_mesh(MeshConfig())
    rep = aot_shard_report(
        cfg, 120_000, m,
        rcfg=RegistrationConfig(max_steps=80, step_mode="rprop"))
    flags = rep["calibrated_pipeline"]["output_shardings"]
    bad = {k: v for k, v in flags.items() if v != "partitioned"}
    assert not bad, f"replicated bank/train/decompress leaves: {bad}"
    mem = rep["calibrated_pipeline"]["memory_per_device"]
    assert "temp_bytes" in mem, mem
    # partitioned state: per-device temp must be far below the unsharded
    # program's working set (the [B, G] decompress intermediates alone are
    # ~100 MB unsharded; 8-way partitioned stays well under half that)
    assert mem["temp_bytes"] < 512 * 1024 * 1024, mem
    assert "temp_bytes" in rep["register"]["memory_per_device"]


def test_pallas_train_shardmap_interpret_parity():
    """The fused Pallas kernel wrapped in shard_map over the data axis
    (interpret mode on the CPU mesh) == the single-device kernel call."""
    from gp_compressor_jax.geometry import patches as patches_mod

    pts, cols, valid = _small_cloud(n=3000, seed=11)
    batch = compressor.project(pts, cols, valid, PIPE_CFG)
    key = jax.random.key(2)

    comp1 = compressor.train(batch, PIPE_CFG, key, use_pallas=True,
                             banks_shuffled=True, pallas_interpret=True)
    m = mesh_lib.make_mesh(MeshConfig())
    comp8 = compressor.train(batch, PIPE_CFG, key, use_pallas=True,
                             banks_shuffled=True, pallas_interpret=True,
                             mesh=m)
    for a, b in zip(jax.tree.leaves(comp1.depth_gp),
                    jax.tree.leaves(comp8.depth_gp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
