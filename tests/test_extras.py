"""Tests for auxiliary components: plain MP encoder, MAP hyperparameter
fit, headless visualization, CLI smoke tests."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import KSVDConfig
from gp_compressor_jax.inference import hmc
from gp_compressor_jax.models import dictionary
from gp_compressor_jax.ops import kernels
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.utils import viz


def test_mp_encode_reduces_residual():
    r = np.random.default_rng(0)
    l, K, n = 36, 24, 30
    D = r.standard_normal((l, K))
    D /= np.linalg.norm(D, axis=0)
    S = r.standard_normal((n, l))
    W = np.ones((n, l))
    cfg = KSVDConfig(dict_size=K, words_max=6, proj_error=1e-10)
    code = dictionary.mp_encode(jnp.asarray(D), jnp.asarray(S),
                                jnp.asarray(W), jnp.ones(n, bool), cfg)
    rec = np.asarray(dictionary.reconstruct(jnp.asarray(D), code))
    res = np.linalg.norm(S - rec, axis=1)
    base = np.linalg.norm(S, axis=1)
    assert np.all(res < base)          # strictly reduces every residual
    # OMP should be at least as good
    code2 = dictionary.omp_encode(jnp.asarray(D), jnp.asarray(S),
                                  jnp.asarray(W), jnp.ones(n, bool), cfg)
    rec2 = np.asarray(dictionary.reconstruct(jnp.asarray(D), code2))
    res2 = np.linalg.norm(S - rec2, axis=1)
    assert res2.mean() <= res.mean() * 1.05


def test_map_estimate_recovers_hyperparams():
    r = np.random.default_rng(1)
    B, n = 6, 40
    true = RBFParams(sigmaf_sq=jnp.asarray(2.0), l_sq=jnp.asarray(0.3))
    X = r.uniform(-1, 1, size=(B, n, 2))
    Y = np.zeros((B, n))
    for b in range(B):
        K = np.array(kernels.gram(true, jnp.asarray(X[b]), jnp.asarray(X[b])))
        Y[b] = r.multivariate_normal(np.zeros(n), K + 0.01 * np.eye(n))
    logpost = hmc.make_patch_logpost(jnp.asarray(X), jnp.asarray(Y),
                                     jnp.ones((B, n)),
                                     prior_mean=(0.0, -1.0, -4.0),
                                     prior_std=4.0)
    theta, trace = hmc.map_estimate(logpost, jnp.asarray([0.0, 0.0, -2.0]),
                                    steps=300)
    assert float(trace[-1]) > float(trace[0])
    est = np.exp(np.asarray(theta))
    assert abs(np.log(est[1] / 0.3)) < 0.8, est      # lengthscale in range
    assert abs(np.log(est[2] / 0.01)) < 1.5, est     # noise in range


def test_render_cloud_and_plot(tmp_path):
    r = np.random.default_rng(2)
    pts = r.normal(size=(500, 3))
    cols = r.integers(0, 255, size=(500, 3)).astype(float)
    p1 = os.path.join(tmp_path, "cloud.png")
    viz.render_cloud(p1, pts, cols)
    with open(p1, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    p2 = os.path.join(tmp_path, "curves.svg")
    viz.plot_series(p2, {"rmse": [1.0, 0.5, 0.2], "ll": [0.1, 0.4, 0.9]},
                    title="metrics")
    content = open(p2).read()
    assert "<svg" in content and "polyline" in content


def test_cli_gp_compress_smoke(tmp_path):
    out = os.path.join(tmp_path, "recon.pcd")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "gp_compressor_jax.cli", "gp-compress",
         "--n-points", "3000", "--res", "0.3", "--sz", "6",
         "--capacity", "16", "--max-patches", "256", "--max-ppp", "96",
         "--out", out],
        capture_output=True, text=True, timeout=560, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RMS error" in res.stdout
    assert os.path.exists(out)
