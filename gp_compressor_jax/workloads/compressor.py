"""GP compression / decompression workload.

Reference: gp_compressor (src/gp_compressor.cpp) — project the cloud into
per-voxel patches, train a depth sparse GP and an RGB field GP per patch
(`train_processes`, :121-175), then regenerate the cloud by predicting both
GPs on a regular sz x sz grid per patch and rotating back to world
(`load_compressed`, :267-386).

Patch projection is the batched front-end (geometry.patches.build_patches);
training runs every patch at once, through the fused kernel or the XLA scan
(pallas_kernels.sogp_train.train_patches); decompression is two batched Gram+matmul predictions over all
patches at once. The patch axis is shardable over a mesh (parallel.mesh).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from gp_compressor_jax.config import CompressorConfig
from gp_compressor_jax.geometry import patches as patches_mod
from gp_compressor_jax.models import sparse_gp
from gp_compressor_jax.models.sparse_gp import SOGPState
from gp_compressor_jax.ops.kernels import RBFParams
from gp_compressor_jax.pallas_kernels import sogp_train


class CompressedCloud(NamedTuple):
    """The in-memory compressed artifact: patch geometry + GP states.

    The reference never serialises GP state (save_compressed ignores its
    filename, src/gp_compressor.cpp:21-27); we do — see io.checkpoint.
    """

    patch: patches_mod.PatchBatch
    depth_gp: SOGPState    # batched [B, ...]
    rgb_gp: SOGPState      # batched [B, ...]


def default_params(cfg: CompressorConfig) -> Tuple[RBFParams, RBFParams]:
    depth_kp = RBFParams(sigmaf_sq=jnp.asarray(cfg.depth_gp.sigmaf_sq),
                         l_sq=jnp.asarray(cfg.depth_gp.l_sq))
    rgb_kp = RBFParams(sigmaf_sq=jnp.asarray(cfg.rgb_gp.sigmaf_sq),
                       l_sq=jnp.asarray(cfg.rgb_gp.l_sq))
    return depth_kp, rgb_kp


@functools.partial(jax.jit, static_argnames=("cfg",))
def project(points: jnp.ndarray, colors: jnp.ndarray, valid: jnp.ndarray,
            cfg: CompressorConfig,
            shuffle_key=None) -> patches_mod.PatchBatch:
    """project_cloud equivalent (src/gp_compressor.cpp:177-249).

    shuffle_key: randomise in-bank point order at scatter time (see
    build_patches) so training needs no separate permutation pass."""
    return patches_mod.build_patches(points, colors, valid, cfg.patch,
                                     shuffle_key=shuffle_key)


def _constrain_batch(batch: patches_mod.PatchBatch, mesh):
    """Force the patch-banked arrays onto the mesh's `data` axis at the
    project->train stage boundary (the grid's lookup tables and the
    point-axis claims stay whatever GSPMD propagates)."""
    from gp_compressor_jax.parallel import mesh as mesh_lib

    B = batch.mask.shape[0]
    c = lambda t: mesh_lib.constrain_leading(t, mesh, B)
    return batch._replace(
        rotations=c(batch.rotations), means=c(batch.means),
        rgb_means=c(batch.rgb_means), W=c(batch.W), X=c(batch.X),
        y=c(batch.y), rgb=c(batch.rgb), mask=c(batch.mask),
        counts=c(batch.counts))


@functools.partial(jax.jit, static_argnames=("cfg", "use_pallas",
                                              "banks_shuffled", "full_probes",
                                              "mesh", "pallas_interpret"))
def train(batch: patches_mod.PatchBatch, cfg: CompressorConfig,
          key: jax.Array,
          depth_kp: Optional[RBFParams] = None,
          rgb_kp: Optional[RBFParams] = None,
          use_pallas: bool = False,
          banks_shuffled: bool = False,
          depth_s20=None, depth_eps=None,
          full_probes: bool = False,
          mesh=None, pallas_interpret: bool = False) -> CompressedCloud:
    """train_processes equivalent (src/gp_compressor.cpp:121-175): feed each
    patch's claimed points into its depth GP and RGB field GP, with the
    reference's shuffle-before-insert (src/sparse_gp.hpp:43-56).

    use_pallas=True routes the online updates through the fused Triton
    kernel (pallas_kernels.sogp_train) wherever its shape rule covers the
    GP; other widths take the XLA scan.
    banks_shuffled=True promises the banks were already scatter-time
    shuffled (project(..., shuffle_key=...)), skipping the expensive
    [B, P] permutation gathers here.
    depth_s20 / depth_eps: optional TRACED overrides of the depth GP's
    noise floor and novelty threshold — lets a calibrate->train pipeline
    stay one compiled program instead of retracing per calibration.
    full_probes=True forces full-grid health probes (use when the
    length-scale may calibrate below the patch footprint).
    mesh: optional jax.sharding.Mesh — shards the patch-bank axis over its
    `data` axis (the kernel goes through shard_map; the XLA paths
    partition via propagation from the constrained banks).
    pallas_interpret runs the kernel in the Pallas interpreter (CPU
    tests only)."""
    dkp, ckp = default_params(cfg)
    depth_kp = depth_kp if depth_kp is not None else dkp
    rgb_kp = rgb_kp if rgb_kp is not None else ckp
    d_s20 = jnp.asarray(cfg.depth_gp.s20) if depth_s20 is None else depth_s20
    B = batch.mask.shape[0]
    kd, kc = jax.random.split(key)

    if mesh is not None:
        batch = _constrain_batch(batch, mesh)
    dstates = sparse_gp.init_batch(cfg.depth_gp, B)
    cstates = sparse_gp.init_batch(cfg.rgb_gp, B)
    # shuffle-before-insert here unless the banks already carry their
    # insertion order (scatter-time shuffle or a deterministic bank_order)
    dkeys = None if banks_shuffled else jax.random.split(kd, B)
    ckeys = None if banks_shuffled else jax.random.split(kc, B)
    dstates = sogp_train.train_patches(
        depth_kp, d_s20, cfg.depth_gp, dstates, batch.X, batch.y, batch.mask,
        eps_tol=depth_eps, keys=dkeys, use_kernel=use_pallas,
        interpret=pallas_interpret, mesh=mesh)
    cstates = sogp_train.train_patches(
        rgb_kp, jnp.asarray(cfg.rgb_gp.s20), cfg.rgb_gp, cstates, batch.X,
        batch.rgb, batch.mask, keys=ckeys, use_kernel=use_pallas, interpret=pallas_interpret,
        mesh=mesh)
    # a 1/5 subsample of the prediction grid suffices as health probes
    # when the length-scale covers the patch footprint (a diverged patch
    # then blows up everywhere, not at isolated cells); with a short
    # calibrated length-scale (l < res) a blow-up can be local to a few
    # grid cells, so probe the full grid in that regime
    grid = patches_mod.prediction_grid(cfg.patch, batch.X.dtype)
    dfull = full_probes or cfg.depth_gp.l_sq < cfg.patch.res ** 2
    dprobes = grid if dfull else grid[::5]
    cprobes = grid[::5] if cfg.rgb_gp.l_sq >= cfg.patch.res ** 2 else grid
    # health bounds ~10x beyond any legitimate posterior: depth lives
    # within +-res of the patch plane, colors within +-255 of the mean
    dstates, _ = sparse_gp.sanitize_batch(dstates, depth_kp, d_s20,
                                          max_pred=10.0 * cfg.patch.res,
                                          probes=dprobes)
    cstates, _ = sparse_gp.sanitize_batch(cstates, rgb_kp, cfg.rgb_gp.s20,
                                          max_pred=2.5e3, probes=cprobes)
    return CompressedCloud(patch=batch, depth_gp=dstates, rgb_gp=cstates)


@functools.partial(jax.jit, static_argnames=("cfg",))
def decompress(comp: CompressedCloud, cfg: CompressorConfig,
               depth_kp: Optional[RBFParams] = None,
               rgb_kp: Optional[RBFParams] = None,
               depth_s20=None):
    """load_compressed equivalent (src/gp_compressor.cpp:267-386).

    Returns (points [B*G, 3], colors [B*G, 3] in 0..255, valid [B*G]),
    plus per-patch centers and normals like the reference's ncenters /
    normals clouds (:374-379).
    """
    dkp, ckp = default_params(cfg)
    depth_kp = depth_kp if depth_kp is not None else dkp
    rgb_kp = rgb_kp if rgb_kp is not None else ckp
    batch = comp.patch
    B = batch.mask.shape[0]
    grid_uv = patches_mod.prediction_grid(cfg.patch, batch.X.dtype)   # [G,2]
    G = grid_uv.shape[0]

    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    dmean, _ = sparse_gp.predict_batch(
        depth_kp, d_s20, comp.depth_gp,
        jnp.broadcast_to(grid_uv, (B, G, 2)))                          # [B,G,1]
    cmean, _ = sparse_gp.predict_batch(
        rgb_kp, cfg.rgb_gp.s20, comp.rgb_gp,
        jnp.broadcast_to(grid_uv, (B, G, 2)))                          # [B,G,3]

    world = patches_mod.reproject(batch, dmean[..., 0], grid_uv)       # [B,G,3]
    colors = cmean + batch.rgb_means[:, None, :]
    # flatten_colors semantics (src/gp_compressor.cpp:251-265): NaN/inf->255,
    # clamp to [0, 255]
    colors = jnp.where(jnp.isfinite(colors), colors, 255.0)
    colors = jnp.clip(colors, 0.0, 255.0)

    # patches with an empty GP emit nothing (src/gp_compressor.cpp:299-301)
    patch_ok = (sparse_gp.size(comp.depth_gp) > 0) & \
               (jnp.arange(B) < batch.n_leaves)
    valid = jnp.broadcast_to(patch_ok[:, None], (B, G))
    centers = batch.means
    normals = batch.rotations[:, :, 0]
    return (world.reshape(B * G, 3), colors.reshape(B * G, 3),
            valid.reshape(B * G), centers, normals, patch_ok)


@functools.partial(jax.jit, static_argnames=("cfg",))
def reconstruction_rmse(comp: CompressedCloud, cfg: CompressorConfig,
                        depth_kp: Optional[RBFParams] = None,
                        depth_s20=None):
    """In-sample depth RMS over the actual projected points — the
    instrumentation the reference left commented out
    (src/gp_compressor.cpp:303-315) and prints at :381."""
    dkp, _ = default_params(cfg)
    depth_kp = depth_kp if depth_kp is not None else dkp
    d_s20 = cfg.depth_gp.s20 if depth_s20 is None else depth_s20
    batch = comp.patch
    mean, _ = sparse_gp.predict_batch(depth_kp, d_s20,
                                      comp.depth_gp, batch.X)          # [B,P,1]
    err2 = jnp.sum(jnp.where(batch.mask, (mean[..., 0] - batch.y[..., 0]) ** 2,
                             0.0))
    n = jnp.maximum(jnp.sum(batch.mask), 1)
    return jnp.sqrt(err2 / n)


def compress(points, colors, valid, cfg: CompressorConfig, key,
             use_pallas: bool = False, mesh=None,
             pallas_interpret: bool = False) -> CompressedCloud:
    """Full save_compressed pipeline (src/gp_compressor.cpp:21-27)."""
    ks, kt = jax.random.split(key)
    batch = project(points, colors, valid, cfg, shuffle_key=ks)
    return train(batch, cfg, kt, use_pallas=use_pallas, banks_shuffled=True,
                 mesh=mesh, pallas_interpret=pallas_interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "use_pallas", "mesh",
                                              "pallas_interpret"))
def compress_decompress(points, colors, valid, cfg: CompressorConfig, key,
                        use_pallas: bool = False, mesh=None,
                        pallas_interpret: bool = False):
    """save_compressed + load_compressed fused into ONE jit — the
    production round-trip path. The nested project/train/decompress jits
    inline under this trace, so the whole pipeline is a single device
    dispatch with no host round trip between stages.

    mesh: optional device mesh — the front end's point-axis global ops
    (sort/unique/segment-sum) partition under GSPMD from the input
    sharding, the patch banks are constrained to the `data` axis at the
    project->train boundary (see train), and decompress/reductions ride
    the propagated patch sharding with psum collectives. The
    single-device program is the mesh=None special case of the same code.

    Returns (CompressedCloud, decompress outputs)."""
    comp = compress(points, colors, valid, cfg, key, use_pallas=use_pallas,
                    mesh=mesh, pallas_interpret=pallas_interpret)
    out = decompress(comp, cfg)
    return comp, out


@functools.partial(jax.jit, static_argnames=("n_patches", "n_points"))
def calib_subsample(batch: patches_mod.PatchBatch, n_patches: int,
                    n_points: int):
    """Select a dense, spatially stratified calibration subsample from a
    patch bank.

    Banks may be scatter-time shuffled (padding interleaved with data), so
    taking the first rows/slots can yield mostly-invalid entries — a
    near-flat marginal-likelihood surface that MAP/NUTS then wanders on.
    And banks may be ORDERED (PatchConfig.bank_order="center_out"): the
    first n valid points are then the n most central ones — a radially
    biased set whose marginal likelihood prefers much shorter length
    scales (measured: NUTS R-hat blew up to 31 on the first-n sample).
    So: take the n_patches patches with the most claimed points, compact
    each one's valid points to the front, and STRIDE the compacted order
    (idx_j = floor(j*count/n)) — under any bank order this covers the
    patch's span instead of a contiguous prefix.
    Returns (X [B, n, 2], y [B, n], mask [B, n])."""
    counts = jnp.sum(batch.mask, axis=1)
    _, top = jax.lax.top_k(counts, n_patches)
    Xb = batch.X[top]
    yb = batch.y[top, :, 0]
    mb = batch.mask[top]
    order = jnp.argsort(~mb, axis=1, stable=True)         # valid first [B, P]
    cnt = jnp.sum(mb, axis=1).astype(jnp.int32)           # [B]
    j = jnp.arange(n_points, dtype=jnp.int32)             # [n]
    # stride only when the patch has MORE than n points; otherwise take
    # the compacted prefix as-is (the strided formula would select
    # duplicates and skip points when cnt < n)
    strided = jnp.minimum((j[None, :] * jnp.maximum(cnt, 1)[:, None])
                          // n_points, jnp.maximum(cnt - 1, 0)[:, None])
    pos = jnp.where(cnt[:, None] > n_points, strided,
                    jnp.minimum(j[None, :], order.shape[1] - 1))
    sel = jnp.take_along_axis(order, pos, axis=1)         # [B, n]
    X = jnp.take_along_axis(Xb, sel[:, :, None], axis=1)
    y = jnp.take_along_axis(yb, sel, axis=1)
    m = jnp.take_along_axis(mb, sel, axis=1) & (j[None, :] < cnt[:, None])
    return X, y, m


@functools.partial(jax.jit, static_argnames=(
    "cfg", "use_pallas", "calib_patches", "calib_points", "calib_steps",
    "calib_starts", "mesh", "pallas_interpret"))
def compress_decompress_calibrated(points, colors, valid,
                                   cfg: CompressorConfig, key,
                                   use_pallas: bool = False,
                                   calib_patches: int = 32,
                                   calib_points: int = 64,
                                   calib_steps: int = 150,
                                   calib_lr: float = 0.1,
                                   calib_starts: int = 4,
                                   theta_init=None,
                                   mesh=None, pallas_interpret: bool = False):
    """The north-star round trip (BASELINE.json: compress+decompress with
    Bayesian-calibrated hyperparameters) in ONE device dispatch.

    project -> multi-start MAP ascent of the exact-GP marginal posterior
    over (sigma_f^2, l^2, s20) on a patch-bank subsample
    (hmc.map_estimate_multi: 4 vmapped starts reach a better mode in 150
    steps than a single 400-step ascent) -> sparse-GP training with the
    TRACED calibrated values (they ride the kernel's hyperparameter row /
    the scan's carried scalars) -> grid decompression. Unlike the staged
    compress_calibrated, nothing is fetched to host between stages and a
    new calibration never retraces the train program.

    theta_init: optional traced warm start (previous cloud's calibration,
    the production steady state) — pair with calib_steps ~40 and
    calib_starts=1 for a warm refresh at a fraction of the cold cost.
    mesh: optional device mesh — patch banks shard over `data` (see
    compress_decompress) and the independent MAP starts shard over
    `chain` when the mesh carries that axis.

    Returns (CompressedCloud, depth RBFParams, s20 [traced scalar],
    decompress outputs)."""
    from gp_compressor_jax.inference import hmc

    ks, kt = jax.random.split(key)
    batch = project(points, colors, valid, cfg, shuffle_key=ks)
    B = min(calib_patches, batch.X.shape[0])
    n = min(calib_points, batch.X.shape[1])
    Xc, yc, mc = calib_subsample(batch, B, n)
    calib_dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    logpost = hmc.make_patch_logpost(
        jnp.asarray(Xc, calib_dt), jnp.asarray(yc, calib_dt),
        jnp.asarray(mc, calib_dt))
    import numpy as np
    theta0 = jnp.asarray([np.log(cfg.depth_gp.sigmaf_sq),
                          np.log(cfg.depth_gp.l_sq),
                          np.log(cfg.depth_gp.s20)], calib_dt)
    starts_sh = None
    if mesh is not None and "chain" in mesh.axis_names:
        from jax.sharding import NamedSharding, PartitionSpec
        starts_sh = NamedSharding(mesh, PartitionSpec("chain"))
    theta, _ = hmc.map_estimate_multi(logpost, theta0, steps=calib_steps,
                                      lr=calib_lr, n_starts=calib_starts,
                                      theta_init=theta_init,
                                      starts_sharding=starts_sh)
    dt = batch.X.dtype
    sf, l2, s20 = [jnp.asarray(v, dt) for v in jnp.exp(theta)]
    depth_kp = RBFParams(sigmaf_sq=sf, l_sq=l2)
    # keep the RELATIVE novelty floor: eps_tol's natural scale is sigmaf_sq
    # (see compress_calibrated below)
    eps_cal = cfg.depth_gp.eps_tol * sf / cfg.depth_gp.sigmaf_sq
    comp = train(batch, cfg, kt, depth_kp=depth_kp, use_pallas=use_pallas,
                 banks_shuffled=True, depth_s20=s20, depth_eps=eps_cal,
                 full_probes=True, mesh=mesh,
                 pallas_interpret=pallas_interpret)
    out = decompress(comp, cfg, depth_kp=depth_kp, depth_s20=s20)
    return comp, depth_kp, s20, out


def compress_calibrated(points, colors, valid, cfg: CompressorConfig, key,
                        use_pallas: bool = False, method: str = "map",
                        calib_patches: int = 32, calib_points: int = 64,
                        calib_steps: int = 400, calib_lr: float = 0.1):
    """Compress with Bayesian-calibrated depth hyperparameters — the
    north-star configuration (BASELINE.json: "compress+decompress with
    HMC-calibrated hyperparameters"). The reference carries hard-coded
    constants everywhere (src/rbf_kernel.h:24, src/sparse_gp.h:48).

    Runs MAP (default, deterministic) or 2-chain HMC over the exact-GP
    marginal likelihood of a patch-bank subsample, then trains the sparse
    GPs with the calibrated (sigma_f^2, l^2, s20).
    Returns (CompressedCloud, depth RBFParams, calibrated s20).
    """
    import numpy as np

    from gp_compressor_jax.config import HMCConfig
    from gp_compressor_jax.inference import hmc

    batch = project(points, colors, valid, cfg)
    B = min(calib_patches, batch.X.shape[0])
    n = min(calib_points, batch.X.shape[1])
    Xc, yc, mc = calib_subsample(batch, B, n)
    # device-clean dtype: float64 only where x64 is actually enabled (CPU
    # tests); with x64 off the exact-GP marginal runs float32 — the
    # difference-form Gram plus the s20 diagonal keep the [n, n] Cholesky
    # conditioned (kappa ~ sigmaf^2 n / s20 ~ 6e4 << 1/eps_f32)
    calib_dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    logpost = hmc.make_patch_logpost(
        jnp.asarray(Xc, calib_dt), jnp.asarray(yc, calib_dt),
        jnp.asarray(mc, calib_dt))
    theta0 = jnp.asarray([np.log(cfg.depth_gp.sigmaf_sq),
                          np.log(cfg.depth_gp.l_sq),
                          np.log(cfg.depth_gp.s20)])
    if method == "hmc":
        hcfg = HMCConfig(num_warmup=calib_steps, num_samples=calib_steps,
                         num_chains=2)
        kcal, key = jax.random.split(key)
        samples, _, _ = hmc.hmc_sample_chains(
            logpost, jnp.stack([theta0, theta0 + 0.3]), kcal, hcfg)
        theta = jnp.mean(samples.reshape(-1, 3), axis=0)
    else:
        # lr 0.1 x 400 steps reaches the cm-scale posterior basin from the
        # reference-constant start (lr 0.05 is still in transit at 400);
        # the whole ascent is one fused lax.scan dispatch
        theta, _ = hmc.map_estimate(logpost, theta0, steps=calib_steps,
                                    lr=calib_lr)
    sf, l2, s20 = jnp.exp(theta)

    dt = batch.X.dtype
    depth_kp = RBFParams(sigmaf_sq=jnp.asarray(sf, dt),
                         l_sq=jnp.asarray(l2, dt))
    # keep the noise in the config scale the trainers read; the novelty
    # threshold is an ABSOLUTE gamma bound (src/sparse_gp.hpp:30) whose
    # natural scale is sigmaf_sq — rescale it so the calibrated run keeps
    # the same RELATIVE novelty floor (an eps_tol tuned for sigmaf^2=100
    # would otherwise reject every BV once sigmaf^2 calibrates to ~1e-3)
    eps_cal = cfg.depth_gp.eps_tol * float(sf) / cfg.depth_gp.sigmaf_sq
    cal_cfg = dataclasses.replace(cfg, depth_gp=dataclasses.replace(
        cfg.depth_gp, sigmaf_sq=float(sf), l_sq=float(l2), s20=float(s20),
        eps_tol=eps_cal))
    comp = train(batch, cal_cfg, key, depth_kp=depth_kp,
                 use_pallas=use_pallas)
    return comp, depth_kp, float(s20), cal_cfg
