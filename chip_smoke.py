"""Smoke run of the GP compress/register/map path on one GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-cards # four cards: the sharded pipelines only

One process. It drives the system's public entry points once each at the
benchmark's headline deployment (config.headline_config(): a seeded
300,000-point synthetic room, res 0.15, sz 20, 2048 patches of up to 256
points, 32 slots), with the fused Triton training kernel compiled for the
card, and checks every phase against the same card's XLA-scan path or a
host reference:

  kernel        fused kernel vs sparse_gp.add_points_batch at bench widths
                (strict and realistic regimes, f64 host oracle), both timed
  headline      compressor.compress_decompress, kernel vs XLA scan; plane
                frames and banks identical across two runs
  calibrated    compress_decompress_calibrated, cold and warm
  registration  registration.register of a perturbed 300k-point scan
  mapping       add_cloud_fused + add_clouds, dropped counters at 0
  cli           cli.main(["gp-compress", ...]) in-process (128 slots)
  inference     NUTS (4 chains), ADVI, SMC pose refinement
  ksvd          the K-SVD codec at the bench size

It exits non-zero when JAX finds no GPU (it never falls back to the CPU and
never runs a kernel in interpret mode) and when any phase fails; its last
line is then absent. On success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_POINTS = 300_000
EXPECTED_PATCHES = 1675     # leaves of room_cloud(300_000, seed=0) at res 0.15


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    """Card name and power limit, read without JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def train_path(gcfg) -> str:
    """Which path `use_pallas=True` trains this GP with (the shape rule)."""
    from gp_compressor_jax.pallas_kernels import sogp_train

    return ("triton" if sogp_train.kernel_covers(gcfg, np.float32)
            else "xla_scan")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def aot(name, fn, *args, **kwargs):
    """Lower and compile a jitted entry once, print its memory analysis,
    return the compiled callable (called with the dynamic arguments)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **kwargs).compile()
    ma = compiled.memory_analysis()
    log(f"[{name}] compile_s={time.perf_counter() - t0:.1f} memory_analysis:"
        f" argument={ma.argument_size_in_bytes} output={ma.output_size_in_bytes}"
        f" temp={ma.temp_size_in_bytes}"
        f" generated_code={ma.generated_code_size_in_bytes}")
    return compiled


def timed(f, *args, n=5):
    """Median wall time of n warm calls, each ending in block_until_ready."""
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def peak(dev, phase):
    log(f"[{phase}] peak_bytes_in_use="
        f"{dev.memory_stats().get('peak_bytes_in_use')}")


# ---------------------------------------------------------------- phases

def phase_kernel(ctx):
    """Fused kernel vs the XLA scan at bench widths (B=2048, S=32, P=256,
    D=1 and D=3), plus the S=128 width the CLI uses.

    Tolerances: both paths do the same f32 arithmetic (no matmul, so TF32
    plays no part), but in other orders, and a knife-edge BV decision or
    deletion can flip between them.
      strict (well-separated points, no deletion churn): `active` equal,
        bv/alpha/C/Q within atol 1e-4, rtol 1e-3 — f32 accumulation error
        of the rank-1 recursion over <= 24 points;
      realistic (the bench's own banks): >= 90% of patch sizes equal,
        median prediction difference < 5e-3 (m for depth), RMSE within
        20% — a flipped decision changes a patch, not the field;
      host: 16 bench patches against the f64 serial oracle, median
        prediction difference < 5e-3 m (f32 vs f64 conditioning at the
        reference constants).
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.models import oracle, sparse_gp
    from gp_compressor_jax.ops.noise import GaussianNoise
    from gp_compressor_jax.pallas_kernels import sogp_train
    from gp_compressor_jax.workloads import compressor

    cfg, batch = ctx["cfg"], ctx["batch"]
    B, P, _ = batch.X.shape

    def paths(gcfg, kp):
        st0 = sparse_gp.init_batch(gcfg, B)
        noise = GaussianNoise(jnp.asarray(gcfg.s20, jnp.float32))
        xla = jax.jit(lambda X, Y, M: sparse_gp.add_points_batch(
            kp, noise, gcfg, st0, X, Y, M))
        ker = jax.jit(lambda X, Y, M: sogp_train.add_points_batch_pallas(
            kp, gcfg, st0, X, Y, M))
        return xla, ker

    dkp, ckp = compressor.default_params(cfg)
    r = np.random.default_rng(0)
    for name, gcfg, kp, Y in (("depth", cfg.depth_gp, dkp, batch.y),
                              ("rgb", cfg.rgb_gp, ckp, batch.rgb)):
        check(sogp_train.kernel_covers(gcfg, jnp.float32),
              f"kernel must cover the bench {name} GP")
        xla, ker = paths(gcfg, kp)
        t_x = timed(xla, batch.X, Y, batch.mask)
        t_k = timed(ker, batch.X, Y, batch.mask)
        log(f"[kernel] {name} B={B} S={gcfg.slots} P={P} D={gcfg.dout}: "
            f"triton_ms={t_k * 1e3:.4f} xla_scan_ms={t_x * 1e3:.4f}")

        # strict regime: well-separated points, <= 24 per patch
        D = gcfg.dout
        Xs = jnp.asarray(r.uniform(-20, 20, (B, P, 2)), jnp.float32)
        Ys = jnp.asarray(r.normal(size=(B, P, D)), jnp.float32)
        rank = np.argsort(r.uniform(size=(B, P)), axis=1)
        Ms = jnp.asarray(rank < 24)
        a, b = xla(Xs, Ys, Ms), ker(Xs, Ys, Ms)
        check(np.array_equal(np.asarray(a.active), np.asarray(b.active)),
              f"{name} strict: active differs")
        for f in ("bv", "alpha", "C", "Q"):
            check(np.allclose(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)),
                              atol=1e-4, rtol=1e-3), f"{name} strict: {f}")

        # realistic regime: the bench banks
        a, b = xla(batch.X, Y, batch.mask), ker(batch.X, Y, batch.mask)
        sa, sb = np.asarray(sparse_gp.size(a)), np.asarray(sparse_gp.size(b))
        m1 = np.asarray(sparse_gp.predict_batch(kp, gcfg.s20, a, batch.X)[0])
        m2 = np.asarray(sparse_gp.predict_batch(kp, gcfg.s20, b, batch.X)[0])
        msk = np.asarray(batch.mask)
        y = np.asarray(Y)
        e1 = math.sqrt(np.mean(((m1 - y) ** 2)[msk]))
        e2 = math.sqrt(np.mean(((m2 - y) ** 2)[msk]))
        dd = np.abs(m1 - m2)[msk]
        log(f"[kernel] {name} realistic: sizes_equal={(sa == sb).mean():.4f}"
            f" median_pred_diff={np.median(dd):.3g} rmse_xla={e1:.6g}"
            f" rmse_triton={e2:.6g}")
        check((sa == sb).mean() >= 0.9, f"{name}: patch sizes differ")
        check(np.median(dd) < 5e-3, f"{name}: predictions differ")
        check(abs(e1 - e2) <= 0.2 * e1, f"{name}: RMSE differs")
        for leaf in jax.tree.leaves(b):
            check(bool(jnp.all(jnp.isfinite(leaf))), f"{name}: non-finite")

        if name == "depth":
            # host reference: f64 serial oracle on 16 patches
            n_pts = msk.sum(1)
            diffs = []
            Xn = np.asarray(batch.X)
            for i in np.argsort(-n_pts)[::100][:16]:
                sel = msk[i]
                gp = oracle.SerialSOGP(capacity=gcfg.capacity, s20=gcfg.s20,
                                       sigmaf_sq=gcfg.sigmaf_sq,
                                       l_sq=gcfg.l_sq, eps_tol=gcfg.eps_tol)
                gp.add_measurements(Xn[i][sel], y[i][sel])
                mo, _ = gp.predict(Xn[i][sel])
                diffs.append(np.abs(mo[:, 0] - m2[i][sel][:, 0]))
            med = float(np.median(np.concatenate(diffs)))
            log(f"[kernel] depth host-oracle median_pred_diff={med:.3g}")
            check(med < 5e-3, "kernel disagrees with the f64 host oracle")

    # the CLI's width: 128 slots (capacity 100)
    gcfg = dataclasses.replace(cfg.depth_gp, slots=128, capacity=100)
    xla, ker = paths(gcfg, dkp)
    t_x = timed(xla, batch.X, batch.y, batch.mask, n=3)
    t_k = timed(ker, batch.X, batch.y, batch.mask, n=3)
    log(f"[kernel] depth B={B} S=128 P={P}: triton_ms={t_k * 1e3:.4f} "
        f"xla_scan_ms={t_x * 1e3:.4f}")


def phase_headline(ctx):
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.workloads import compressor

    pts, cols, valid, cfg = ctx["pts"], ctx["cols"], ctx["valid"], ctx["cfg"]
    key = jax.random.key(0)
    res = {}
    for use in (True, False):
        name = "headline/" + ("triton" if use else "xla_scan")
        c = aot(name, compressor.compress_decompress, pts, cols, valid, cfg,
                key, use_pallas=use)
        t = timed(lambda k: c(pts, cols, valid, k), key)
        comp, out = c(pts, cols, valid, key)
        rmse = float(compressor.reconstruction_rmse(comp, cfg))
        n = int(comp.patch.n_leaves)
        log(f"[{name}] wall_s={t:.6f} points_per_s={N_POINTS / t:.1f} "
            f"rmse_m={rmse:.6f} n_patches={n}")
        check(n == EXPECTED_PATCHES, f"n_patches {n} != {EXPECTED_PATCHES}")
        check(math.isfinite(rmse) and rmse < 0.05, f"{name}: rmse {rmse}")
        check(bool(jnp.all(jnp.isfinite(jnp.where(out[2][:, None], out[0],
                                                  0.0)))),
              f"{name}: non-finite output points")
        res[use] = (c, comp, rmse)
    check(abs(res[True][2] - res[False][2]) <= 0.01 * res[False][2],
          "triton and XLA-scan headline RMSE differ by more than 1%")
    # reproducibility: same cloud, same key, two runs -> identical frames
    c = res[True][0]
    a = c(pts, cols, valid, key)[0]
    b = c(pts, cols, valid, key)[0]
    same = {f: bool(np.array_equal(np.asarray(getattr(a.patch, f)),
                                   np.asarray(getattr(b.patch, f))))
            for f in ("rotations", "X", "y", "mask")}
    log(f"[headline] two runs identical: {same}")
    check(all(same.values()), "plane frames/banks differ between runs")
    ctx["comp"] = res[True][1]
    ctx["rmse"] = res[True][2]


def phase_calibrated(ctx):
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.workloads import compressor

    pts, cols, valid, cfg = ctx["pts"], ctx["cols"], ctx["valid"], ctx["cfg"]
    key = jax.random.key(1)
    cold = aot("calibrated/cold", compressor.compress_decompress_calibrated,
               pts, cols, valid, cfg, key, use_pallas=True)
    t = timed(lambda k: cold(pts, cols, valid, k), key, n=3)
    comp, kp, s20, out = cold(pts, cols, valid, key)
    rmse = float(compressor.reconstruction_rmse(comp, cfg, depth_kp=kp,
                                                depth_s20=s20))
    log(f"[calibrated/cold] wall_s={t:.6f} rmse_m={rmse:.6f} "
        f"sigmaf_sq={float(kp.sigmaf_sq):.4g} l_sq={float(kp.l_sq):.4g} "
        f"s20={float(s20):.4g}")
    check(math.isfinite(rmse) and rmse < ctx["rmse"],
          f"calibrated rmse {rmse} not below the constants' {ctx['rmse']}")
    # warm start from this calibration: the steady state on a scan stream
    dyn = dict(calib_lr=0.05,
               theta_init=jnp.log(jnp.stack([kp.sigmaf_sq, kp.l_sq, s20])))
    warm = aot("calibrated/warm", compressor.compress_decompress_calibrated,
               pts, cols, valid, cfg, key, use_pallas=True, calib_steps=40,
               calib_starts=1, **dyn)
    t = timed(lambda k: warm(pts, cols, valid, k, **dyn), jax.random.key(2),
              n=3)
    comp_w, kp_w, s20_w, _ = warm(pts, cols, valid, jax.random.key(2), **dyn)
    rmse_w = float(compressor.reconstruction_rmse(comp_w, cfg,
                                                  depth_kp=kp_w,
                                                  depth_s20=s20_w))
    log(f"[calibrated/warm] wall_s={t:.6f} rmse_m={rmse_w:.6f}")
    check(math.isfinite(rmse_w) and abs(rmse_w - rmse) <= 0.2 * rmse,
          "warm calibrated rmse strays from cold")
    ctx["cal"] = (comp, kp, s20)


def phase_registration(ctx):
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import RegistrationConfig
    from gp_compressor_jax.geometry import transforms
    from gp_compressor_jax.workloads import registration

    pts, cols, valid, cfg = ctx["pts"], ctx["cols"], ctx["valid"], ctx["cfg"]
    comp, kp, s20 = ctx["cal"]
    R_true = transforms.euler_xyz(jnp.asarray([0.004, -0.003, 0.005]))
    t_true = jnp.asarray([0.012, -0.009, 0.006])
    moved = transforms.apply(pts, R_true, t_true)
    rcfg = RegistrationConfig(max_steps=80, step_mode="rprop")
    c = aot("registration", registration.register, comp, moved, cols, valid,
            cfg, rcfg, depth_kp=kp, depth_s20=s20)
    t = timed(lambda m: c(comp, m, cols, valid, depth_kp=kp, depth_s20=s20),
              moved, n=3)
    st, out = c(comp, moved, cols, valid, depth_kp=kp, depth_s20=s20)
    terr, rerr = registration.registration_error(st.R_cloud, st.t_cloud,
                                                 R_true, t_true)
    err0 = float(jnp.mean(jnp.linalg.norm(moved - pts, axis=1)))
    err1 = float(jnp.mean(jnp.linalg.norm(out - pts, axis=1)))
    log(f"[registration] wall_s={t:.6f} steps={int(st.step_nbr)} "
        f"trans_err_m={float(terr):.5f} rot_err_rad={float(rerr):.5f} "
        f"mean_err_m {err0:.5f} -> {err1:.5f}")
    check(math.isfinite(float(terr)) and math.isfinite(float(rerr)),
          "non-finite pose error")
    check(err1 < 0.5 * err0, "registration removed under half the motion")


def phase_mapping(ctx):
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from gp_compressor_jax.config import MappingConfig, RegistrationConfig
    from gp_compressor_jax.workloads import mapping

    pts, cols, valid, cfg = ctx["pts"], ctx["cols"], ctx["valid"], ctx["cfg"]
    _, kp, s20 = ctx["cal"]
    # bench.py's mapping row: carve cap at the 99th-percentile ray length,
    # an 8-step registration polish per scan on a 4x subsample
    lo = np.asarray(pts.min(0)) - 0.3
    hi = np.asarray(pts.max(0)) + 0.3
    p99 = float(np.percentile(np.linalg.norm(np.asarray(pts), axis=1), 99))
    steps = min(mapping.required_ray_steps(lo, hi, cfg.patch.res),
                int(1.2 * p99 / cfg.patch.res) + 2)
    mcfg = MappingConfig(min_points_new_patch=50, max_ray_steps=steps,
                         carve_stride=8, drop_on_reg_cap=False, reg_stride=4)
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    eps = cfg.depth_gp.eps_tol * kp.sigmaf_sq / cfg.depth_gp.sigmaf_sq
    calib = dict(depth_kp=kp, depth_s20=s20, depth_eps=eps)
    Ns = 150_000
    scans = [(pts[i::2][:Ns], cols[i::2][:Ns], valid[i::2][:Ns])
             for i in (0, 1)]
    state = mapping.map_init(cfg, mcfg, lo, hi, dtype=pts.dtype)
    c = aot("mapping/add_cloud_fused", mapping.add_cloud_fused, state,
            *scans[0], cfg, mcfg, jax.random.key(0), rcfg=rcfg,
            use_pallas=True, **calib)
    state, _, _, info0 = c(state, *scans[0], jax.random.key(0), **calib)
    SP, SC, SV = (jnp.stack([scans[(1 + s) % 2][j] for s in range(4)])
                  for j in range(3))
    c = aot("mapping/add_clouds", mapping.add_clouds, state, SP, SC, SV, cfg,
            mcfg, jax.random.key(1), rcfg=rcfg, use_pallas=True, **calib)
    t = timed(lambda k: c(state, SP, SC, SV, k, **calib), jax.random.key(1),
              n=3)
    state2, diverged, reg_steps, info = c(state, SP, SC, SV,
                                          jax.random.key(1), **calib)
    mpts, _, mok = mapping.map_cloud(state2, cfg, depth_kp=kp, depth_s20=s20)
    mp = np.asarray(mpts)[np.asarray(mok)]
    ref = np.concatenate([np.asarray(s[0]) for s in scans])
    d, _ = cKDTree(ref).query(mp, k=1)
    map_rmse = float(np.sqrt(np.mean(d ** 2)))
    dropped = {k: int(jnp.sum(info[k]) + jnp.sum(info0[k]))
               for k in ("bank_dropped", "pend_dropped", "patch_overflow")}
    log(f"[mapping] wall_s_per_scan={t / 4:.6f} n_patches="
        f"{int(state2.n_patches)} map_rmse_m={map_rmse:.5f} "
        f"dropped={dropped} diverged={np.asarray(diverged).tolist()}")
    check(all(v == 0 for v in dropped.values()), f"dropped evidence {dropped}")
    check(np.isfinite(mp).all() and map_rmse < 0.05, f"map rmse {map_rmse}")
    ctx["map"] = (state2, mcfg, rcfg, scans)


def phase_cli(ctx):
    from gp_compressor_jax import cli
    from gp_compressor_jax.config import GPConfig

    log(f"[cli] 128-slot GPs train with: {train_path(GPConfig(slots=128))}")
    with tempfile.TemporaryDirectory(dir=ctx["tmp"]) as d:
        out = os.path.join(d, "room.pcd")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["gp-compress", "--n-points", str(N_POINTS), "--res",
                      "0.15", "--sz", "20", "--max-patches", "2048",
                      "--max-ppp", "256", "--fused-train", "--out", out])
        text = buf.getvalue()
        log("\n".join("[cli] " + ln for ln in text.splitlines()))
        rms = [float(ln.split(":")[1]) for ln in text.splitlines()
               if ln.startswith("RMS error")]
        check(len(rms) == 1 and math.isfinite(rms[0]), "cli RMS missing")
        check(os.path.getsize(out) > 0, "cli wrote no cloud")


def phase_inference(ctx):
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import HMCConfig, SMCConfig
    from gp_compressor_jax.geometry import transforms
    from gp_compressor_jax.inference import hmc, nuts, vi
    from gp_compressor_jax.workloads import compressor, mapping, registration

    batch, cfg = ctx["batch"], ctx["cfg"]
    Xc, yc, mc = compressor.calib_subsample(batch, 16, 48)
    logpost = hmc.make_patch_logpost(Xc, yc, mc.astype(Xc.dtype))
    theta0 = jnp.asarray([np.log(100.0), 0.0, np.log(0.1)], jnp.float32)
    hcfg = HMCConfig(num_warmup=20, num_samples=20, num_chains=4)
    th0 = theta0[None] + 0.2 * jax.random.normal(jax.random.key(7), (4, 3))
    t0 = time.perf_counter()
    samples, acc, _ = jax.block_until_ready(
        nuts.nuts_sample_chains(logpost, th0, jax.random.key(1), hcfg))
    log(f"[nuts] 4 chains x 20 samples wall_s(incl. compile)="
        f"{time.perf_counter() - t0:.2f} accept={float(jnp.mean(acc)):.3f}")
    check(bool(jnp.all(jnp.isfinite(samples))), "NUTS samples non-finite")
    check(0.0 < float(jnp.mean(acc)) <= 1.0, "NUTS accept rate")

    theta_map, _ = hmc.map_estimate_multi(logpost, theta0, steps=150,
                                          lr=0.1, n_starts=4)
    res = jax.block_until_ready(
        vi.fit_advi(logpost, theta_map, jax.random.key(3), steps=100))
    log(f"[advi] final_elbo={float(jnp.mean(res.elbo_trace[-10:])):.4g}")
    check(bool(jnp.all(jnp.isfinite(res.elbo_trace))), "ADVI ELBO non-finite")

    state, mcfg, rcfg, scans = ctx["map"]
    _, kp, s20 = ctx["cal"]
    R_true = transforms.euler_xyz(jnp.asarray([0.012, -0.008, 0.010]))
    t_true = jnp.asarray([0.05, -0.04, 0.03])
    moved = transforms.apply(scans[1][0], R_true, t_true)
    st, out_reg = registration.register(
        mapping._map_as_compressed(state, cfg), moved, scans[1][1],
        scans[1][2], cfg, rcfg, depth_kp=kp, depth_s20=s20)
    scfg = SMCConfig(num_particles=256, pose_proposal_std_t=0.012,
                     pose_proposal_std_r=0.004)
    (R2, t2), _, trace = jax.block_until_ready(mapping.smc_refine_pose(
        state, out_reg, scans[1][1], scans[1][2], cfg, scfg,
        jax.random.key(3), n_iters=8, depth_kp=kp, depth_s20=s20))
    e_reg = float(jnp.mean(jnp.linalg.norm(out_reg - scans[1][0], axis=1)))
    e_smc = float(jnp.mean(jnp.linalg.norm(
        transforms.apply(out_reg, R2, t2) - scans[1][0], axis=1)))
    log(f"[smc] 256 particles x 8 iters mean_err_m {e_reg:.5f} -> "
        f"{e_smc:.5f}")
    check(math.isfinite(e_smc) and bool(jnp.all(jnp.isfinite(trace))),
          "SMC non-finite")


def phase_ksvd(ctx):
    """K-SVD codec on the card at the bench size. The dictionary
    contractions run at HIGHEST precision, so TF32 plays no part (measured:
    on a 20k-point cloud the card's in-sample RMS was within 0.3% of the
    CPU backend's). Check: finite, and under 2 cm — the depth pipeline's
    proj_error 5e-3 stop keeps the in-sample RMS near 1.4 cm on this
    cloud."""
    import jax

    from gp_compressor_jax.workloads import ksvd_compressor

    pts, cols, valid, cfg = ctx["pts"], ctx["cols"], ctx["valid"], ctx["cfg"]
    t0 = time.perf_counter()
    comp = jax.block_until_ready(
        ksvd_compressor.compress(pts, cols, valid, cfg, jax.random.key(0)))
    rms = ksvd_compressor.rms_error(comp)
    log(f"[ksvd] 300k wall_s(incl. compile)={time.perf_counter() - t0:.2f} "
        f"rms_m={rms:.6f} depth_iters={int(comp.depth.iters)} "
        f"rgb_iters={int(comp.rgb.iters)}")
    check(math.isfinite(rms) and rms < 0.02, f"K-SVD rms {rms}")


def phase_four_cards(ctx):
    """compress_decompress_calibrated and register on a 4-GPU `data` mesh
    against the same calls on one card of this process.

    Tolerances: x64 is off, so the sharded program's f32 reductions (RMSE
    sums, MAP gradients over the subsample) group differently from the
    single-card one; the plane frames are summed in a fixed order on both
    (geometry.patches.ordered_segment_sum), so the banks agree and the
    remaining difference is f32 summation order: RMSE within 2%,
    calibrated hyperparameters within 5%, pose within 1 mm / 1e-3 rad.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from gp_compressor_jax.config import MeshConfig, RegistrationConfig
    from gp_compressor_jax.geometry import transforms
    from gp_compressor_jax.parallel import mesh as mesh_lib
    from gp_compressor_jax.workloads import compressor, registration

    pts, cols, valid, cfg = ctx["pts"], ctx["cols"], ctx["valid"], ctx["cfg"]
    check(len(jax.devices()) == 4, "--four-cards needs four GPUs")
    mesh = mesh_lib.make_mesh(MeshConfig())
    log(f"[four_cards] mesh {dict(mesh.shape)}")
    key = jax.random.key(1)
    R_true = transforms.euler_xyz(jnp.asarray([0.004, -0.003, 0.005]))
    t_true = jnp.asarray([0.012, -0.009, 0.006])
    moved = transforms.apply(pts, R_true, t_true)
    rcfg = RegistrationConfig(max_steps=80, step_mode="rprop")
    res = {}
    for m in (None, mesh):
        tag = "one_card" if m is None else "four_cards"
        if m is None:
            args = (pts, cols, valid)
        else:
            sh = NamedSharding(m, PartitionSpec("data"))
            args = tuple(jax.device_put(a, sh) for a in (pts, cols, valid))
        c = aot(f"four_cards/calibrated/{tag}",
                compressor.compress_decompress_calibrated, *args, cfg, key,
                use_pallas=True, mesh=m)
        t = timed(lambda k: c(*args, k), key, n=3)
        comp, kp, s20, out = c(*args, key)
        rmse = float(compressor.reconstruction_rmse(comp, cfg, depth_kp=kp,
                                                    depth_s20=s20))
        spec = comp.depth_gp.C.sharding
        n_shards = len({str(s.index)
                        for s in comp.depth_gp.C.addressable_shards})
        log(f"[four_cards/{tag}] calibrated wall_s={t:.6f} rmse_m={rmse:.6f}"
            f" sigmaf_sq={float(kp.sigmaf_sq):.5g} l_sq={float(kp.l_sq):.5g}"
            f" bank_sharding={spec} distinct_bank_shards={n_shards}")
        if m is not None:
            check(n_shards == 4, "banks are not sharded over the 4 cards")
        mv = moved if m is None else jax.device_put(moved, sh)
        cr = aot(f"four_cards/register/{tag}", registration.register, comp,
                 mv, args[1], args[2], cfg, rcfg, depth_kp=kp,
                 depth_s20=s20, mesh=m)
        t_r = timed(lambda x: cr(comp, x, args[1], args[2], depth_kp=kp,
                                 depth_s20=s20), mv, n=3)
        st, _ = cr(comp, mv, args[1], args[2], depth_kp=kp, depth_s20=s20)
        terr, rerr = registration.registration_error(
            st.R_cloud, st.t_cloud, R_true, t_true)
        log(f"[four_cards/{tag}] register wall_s={t_r:.6f} "
            f"steps={int(st.step_nbr)} trans_err_m={float(terr):.6f} "
            f"rot_err_rad={float(rerr):.6f}")
        res[tag] = (rmse, float(kp.sigmaf_sq), float(kp.l_sq),
                    np.asarray(st.R_cloud), np.asarray(st.t_cloud))
    a, b = res["one_card"], res["four_cards"]
    check(abs(a[0] - b[0]) <= 0.02 * a[0], "sharded RMSE differs")
    check(abs(a[1] - b[1]) <= 0.05 * a[1] and abs(a[2] - b[2]) <= 0.05 * a[2],
          "sharded calibration differs")
    check(np.abs(a[4] - b[4]).max() < 1e-3 and np.abs(a[3] - b[3]).max()
          < 1e-3, "sharded pose differs")


# ------------------------------------------------------------------ main

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run the sharded pipelines on four GPUs and compare "
                        "them with one card (no other phase)")
    args = p.parse_args(argv)

    import jax

    devs = jax.devices()
    log(f"platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)}")
    if devs[0].platform != "gpu":
        log("chip_smoke.py needs a GPU; JAX found none")
        return 1
    log(f"nvidia-smi: {nvidia_smi()}")

    import jax.numpy as jnp

    from gp_compressor_jax.config import headline_config
    from gp_compressor_jax.utils import synthetic
    from gp_compressor_jax.utils.cache import setup_compilation_cache
    from gp_compressor_jax.workloads import compressor

    setup_compilation_cache()
    cfg = headline_config()
    log(f"[paths] every phase but headline/xla_scan and cli trains depth "
        f"({cfg.depth_gp.slots} slots) with {train_path(cfg.depth_gp)} and "
        f"RGB ({cfg.rgb_gp.slots} slots) with {train_path(cfg.rgb_gp)}")
    pts_np, cols_np = synthetic.room_cloud(n=N_POINTS, seed=0)
    ctx = dict(cfg=cfg, pts=jnp.asarray(pts_np), cols=jnp.asarray(cols_np),
               valid=jnp.ones(N_POINTS, bool), tmp=tempfile.gettempdir())
    if args.four_cards:
        phases = [phase_four_cards]
    else:
        ctx["batch"] = jax.block_until_ready(compressor.project(
            ctx["pts"], ctx["cols"], ctx["valid"], cfg,
            shuffle_key=jax.random.key(0)))
        phases = [phase_kernel, phase_headline, phase_calibrated,
                  phase_registration, phase_mapping, phase_cli,
                  phase_inference, phase_ksvd]
    t_all = time.perf_counter()
    for ph in phases:
        t0 = time.perf_counter()
        ph(ctx)
        log(f"[{ph.__name__}] ok in {time.perf_counter() - t0:.1f}s")
        peak(devs[0], ph.__name__)
    log(f"all phases ok in {time.perf_counter() - t_all:.1f}s")
    log(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
