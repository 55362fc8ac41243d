"""Coverage for smaller API surfaces: confidence predictions, reset,
voxel key round-trips, MapState checkpointing, profiling utilities."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import (CompressorConfig, GPConfig,
                                      MappingConfig, PatchConfig,
                                      rgb_gp_config)
from gp_compressor_jax.geometry import voxel
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.ops.noise import GaussianNoise
from gp_compressor_jax.utils import profiling

KP = RBFParams(sigmaf_sq=jnp.asarray(100.0), l_sq=jnp.asarray(1.0))


def _trained_state():
    cfg = GPConfig(capacity=20, slots=32, dtype=jnp.float64)
    noise = GaussianNoise(s20=jnp.asarray(0.1))
    r = np.random.default_rng(0)
    X = jnp.asarray(r.uniform(-2, 2, size=(30, 2)))
    y = jnp.asarray(r.normal(size=(30, 1)))
    return cfg, sparse_gp.add_points(KP, noise, cfg, sparse_gp.init(cfg), X, y)


def test_predict_confidence_formula():
    """conf = 100 * (1 - var / (k** + s20)) (src/sparse_gp.hpp:339-345)."""
    cfg, st = _trained_state()
    Xs = jnp.asarray(np.random.default_rng(1).uniform(-2, 2, size=(7, 2)))
    mean, var = sparse_gp.predict(KP, cfg.s20, st, Xs)
    mean2, conf = sparse_gp.predict_confidence(KP, cfg.s20, st, Xs)
    expected = 100.0 * (1.0 - np.asarray(var) / (100.0 + cfg.s20))
    assert np.allclose(np.asarray(conf), expected, atol=1e-9)
    assert np.allclose(np.asarray(mean), np.asarray(mean2))
    # trained regions are more confident than the empty-GP baseline (0)
    assert np.asarray(conf).max() > 0


def test_reset_empties_state():
    cfg, st = _trained_state()
    st2 = sparse_gp.reset(st)
    assert int(sparse_gp.size(st2)) == 0
    mean, var = sparse_gp.predict(KP, cfg.s20, st2, jnp.zeros((3, 2)))
    assert np.allclose(np.asarray(mean), 0.0)
    assert np.allclose(np.asarray(var), 100.0 + cfg.s20)


def test_voxel_linearize_roundtrip():
    dims = jnp.asarray([13, 7, 29], jnp.int32)
    r = np.random.default_rng(2)
    keys3 = jnp.asarray(np.stack([
        r.integers(0, 13, 50), r.integers(0, 7, 50),
        r.integers(0, 29, 50)], -1), jnp.int32)
    lin = voxel.linearize(keys3, dims)
    back = voxel.delinearize(lin, dims)
    assert np.array_equal(np.asarray(back), np.asarray(keys3))
    # out-of-grid keys map to the fill sentinel
    bad = jnp.asarray([[13, 0, 0], [0, -1, 0]], jnp.int32)
    lb = voxel.linearize(bad, dims)
    assert np.all(np.asarray(lb) == np.iinfo(np.int32).max)


def test_mapstate_checkpoint_roundtrip(tmp_path):
    from gp_compressor_jax.io import checkpoint
    from gp_compressor_jax.utils import synthetic
    from gp_compressor_jax.workloads import mapping

    cfg = CompressorConfig(
        patch=PatchConfig(res=0.3, sz=8, max_patches=256,
                          max_points_per_patch=128),
        depth_gp=GPConfig(capacity=20, slots=24, dtype=jnp.float64),
        rgb_gp=rgb_gp_config(slots=24, capacity=20, dtype=jnp.float64),
    )
    mcfg = MappingConfig(min_points_new_patch=30, max_ray_steps=32)
    state = mapping.map_init(cfg, mcfg, [-1, -1, -1], [4, 4, 4],
                             dtype=jnp.float64)
    pts, cols = synthetic.room_cloud(n=3000, seed=5)
    state, _ = mapping.add_cloud(state, jnp.asarray(pts, jnp.float64),
                                 jnp.asarray(cols, jnp.float64),
                                 jnp.ones(len(pts), bool), cfg, mcfg,
                                 jax.random.key(0))
    path = os.path.join(tmp_path, "map.npz")
    checkpoint.save(path, state, meta={"kind": "map", "scans": 1})
    fresh = mapping.map_init(cfg, mcfg, [-1, -1, -1], [4, 4, 4],
                             dtype=jnp.float64)
    back = checkpoint.load(path, fresh)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert checkpoint.load_meta(path)["scans"] == 1
    # the restored map keeps serving predictions
    w, c, ok = mapping.map_cloud(back, cfg)
    assert int(jnp.sum(ok)) > 0


def test_phase_timer_and_metric_logger(tmp_path):
    t = profiling.PhaseTimer()
    x = jnp.ones((8, 8))
    with t.phase("mul", sync=lambda: x):
        y = x * 2
    rep = t.report()
    assert "mul" in rep and rep["mul"] >= 0
    path = os.path.join(tmp_path, "metrics.jsonl")
    log = profiling.MetricLogger(path)
    log.log(rmse=0.5, step=1)
    log.log(rmse=jnp.asarray(0.25), step=2)
    log.close()
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 2 and '"rmse": 0.25' in lines[1]


def test_checkpoint_validates_treedef_and_shapes(tmp_path):
    from gp_compressor_jax.io import checkpoint

    tree = {"a": jnp.arange(4.0), "b": (jnp.eye(2), jnp.zeros(3))}
    path = os.path.join(tmp_path, "t.npz")
    checkpoint.save(path, tree)
    # same structure loads
    back = checkpoint.load(path, jax.tree.map(jnp.zeros_like, tree))
    assert np.array_equal(np.asarray(back["a"]), np.arange(4.0))
    # different tree structure with the same leaf count must raise
    import pytest
    bad_struct = {"a": jnp.zeros(4), "c": (jnp.zeros((2, 2)), jnp.zeros(3))}
    with pytest.raises(ValueError, match="treedef mismatch"):
        checkpoint.load(path, bad_struct)
    # shape mismatch must raise
    bad_shape = {"a": jnp.zeros(5), "b": (jnp.zeros((2, 2)), jnp.zeros(3))}
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, bad_shape)
    # leaf-count mismatch must raise (treedef check catches it first in
    # strict mode; the count check guards strict=False too)
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.load(path, {"a": jnp.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(path, {"a": jnp.zeros(4)}, strict=False)


def test_checkpoint_sampler_state_resume(tmp_path):
    """HMC chain state + typed PRNG key survive a checkpoint round trip and
    the resumed sampler reproduces the uninterrupted chain bit-for-bit."""
    from gp_compressor_jax.inference.hmc import HMCChainState
    from gp_compressor_jax.io import checkpoint

    dim = 3
    st = HMCChainState(
        theta=jnp.asarray([4.6, 0.0, -2.3]), logp=jnp.asarray(-12.5),
        grad=jnp.asarray([0.1, -0.2, 0.3]), step_size=jnp.asarray(0.05),
        h_bar=jnp.asarray(0.01), log_eps_bar=jnp.asarray(-3.0),
        mu=jnp.asarray(-1.6), inv_mass=jnp.ones(dim),
        accept_prob=jnp.asarray(0.83))
    key = jax.random.key(42)
    path = os.path.join(tmp_path, "sampler.npz")
    checkpoint.save(path, (st, key), meta={"kind": "hmc"})
    st2, key2 = checkpoint.load(path, (jax.tree.map(jnp.zeros_like, st),
                                       jax.random.key(0)))
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the restored key drives identical randomness
    assert np.array_equal(
        np.asarray(jax.random.normal(key, (5,))),
        np.asarray(jax.random.normal(key2, (5,))))
