"""Headline benchmark: GP-path compress+decompress throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
Run it on a machine with a GPU: it exits non-zero when JAX finds none, and
when any row fails.

Workload: the test_gp_compress configuration (res 0.15, sz 20 —
src/test_gp_compress.cpp:21) on a Kinect-scale synthetic cloud (~300k
points; the reference reads TUM scans of the same size), at
config.headline_config(). Timed section = patch projection + online GP
training of every patch (depth + RGB, through the fused Triton kernel) +
grid prediction/reprojection, i.e. save_compressed + load_compressed
(src/gp_compressor.cpp:21-27,267-386). Every timing waits for the device
with `jax.block_until_ready`.

Baseline: the reference publishes no numbers (BASELINE.md), so the baseline
is the measured single-CPU throughput of the serial float64 oracle
(models/oracle.py — the same per-point O(N^2) loop the C++ runs), sampled
on a subset and cached in baseline_cpu.json. vs_baseline = device / CPU
points-per-second.

Besides the headline, "extra" carries the other workload rows, all in this
one process:
  calibrated — compress+decompress with MAP-calibrated hyperparameters
               (reference constants: src/rbf_kernel.h:24, src/sparse_gp.h:48)
  nuts       — NUTS samples/s over the patch-bank hyperparameter posterior
  registration — gradient-ascent scan-to-map alignment steps/s + recovered
               pose error (src/gp_registration.cpp:73-92)
  mapping    — full register->insert->carve scans/s, one fused dispatch
               per scan (src/gp_mapping.cpp:12-35)
  smc, ksvd  — SMC pose refinement and the K-SVD codec
Usage: python bench.py [--headline-only]
"""

import argparse
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(REPO, "baseline_cpu.json")

N_POINTS = 300_000
CAPACITY = 100       # reference default (src/sparse_gp.h:48) for the CPU
                     # baseline; the device run uses headline_config()


def measure_cpu_baseline(pts, cols, res, sz, seed=0):
    """Serial reference-semantics throughput (points/s) on this host CPU.

    Times the hot path (per-point sparse GP updates for depth+RGB GPs plus
    the sz x sz grid predictions) on a sample of patches, exactly as the
    reference's serial leaf loop does (src/gp_compressor.cpp:121-175).
    """
    from gp_compressor_jax.models.oracle import SerialSOGP

    r = np.random.default_rng(seed)
    # cheap voxel binning on host to get realistic patch point sets
    keys = np.floor((pts - pts.min(0)) / res).astype(np.int64)
    lin = (keys[:, 0] << 42) + (keys[:, 1] << 21) + keys[:, 2]
    uniq, inv, counts = np.unique(lin, return_inverse=True, return_counts=True)
    # sample ~12 patches across the size distribution
    order = np.argsort(counts)
    sel = order[np.linspace(len(order) // 2, len(order) - 1, 12).astype(int)]
    grid = np.stack(np.meshgrid(np.arange(sz), np.arange(sz), indexing='ij'),
                    -1).reshape(-1, 2)
    Xstar = res * ((grid + 0.5) / sz - 0.5)

    t0 = time.perf_counter()
    n_done = 0
    for si in sel:
        idx = np.nonzero(inv == si)[0]
        uv = r.uniform(-res / 2, res / 2, size=(len(idx), 2))
        depth = 0.02 * r.standard_normal(len(idx))
        rgb = cols[idx] - cols[idx].mean(0)
        gp = SerialSOGP(capacity=CAPACITY, s20=1e-1)
        gp.add_measurements(uv, depth)
        cgp = SerialSOGP(capacity=CAPACITY, s20=1e2, dout=3)
        cgp.add_measurements(uv, rgb)
        gp.predict(Xstar)
        cgp.predict(Xstar)
        n_done += len(idx)
    dt = time.perf_counter() - t0
    return n_done / dt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--headline-only", action="store_true",
                   help="skip the extra workload rows")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{dev.platform!r} ({dev.device_kind})")

    from gp_compressor_jax.config import headline_config
    from gp_compressor_jax.utils import synthetic
    from gp_compressor_jax.utils.cache import setup_compilation_cache
    from gp_compressor_jax.workloads import compressor

    setup_compilation_cache()
    cfg = headline_config()
    pts_np, cols_np = synthetic.room_cloud(n=N_POINTS, seed=0)

    # ---- CPU baseline (cached) ----
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            cpu_pps = json.load(f)["cpu_points_per_s"]
    else:
        cpu_pps = measure_cpu_baseline(pts_np, cols_np, cfg.patch.res,
                                       cfg.patch.sz)
        with open(BASELINE_CACHE, "w") as f:
            json.dump({"cpu_points_per_s": cpu_pps,
                       "config": {"res": cfg.patch.res, "sz": cfg.patch.sz,
                                  "capacity": CAPACITY},
                       "note": "serial float64 oracle, reference semantics"},
                      f, indent=1)

    pts = jnp.asarray(pts_np)
    cols = jnp.asarray(cols_np)
    valid = jnp.ones(pts.shape[0], bool)

    def pipeline(key):
        return jax.block_until_ready(compressor.compress_decompress(
            pts, cols, valid, cfg, key, use_pallas=True))

    comp, out = pipeline(jax.random.key(0))          # warmup / compile
    n_claimed = int(jnp.sum(comp.patch.mask))
    times = []
    rmses = []
    for i in range(5):
        t0 = time.perf_counter()
        comp, out = pipeline(jax.random.key(i))
        times.append(time.perf_counter() - t0)
        rmses.append(float(compressor.reconstruction_rmse(comp, cfg)))
    dt = float(np.median(times))
    pps = N_POINTS / dt
    # bank_order="center_out" makes BV selection deterministic: the rmse
    # is key-independent (the spread is kept as the regression guard)
    rmse = float(np.mean(rmses))

    result = {
        "metric": "gp_compress_decompress_throughput",
        "value": round(pps, 1),
        "unit": "points/s",
        "vs_baseline": round(pps / cpu_pps, 2),
        "extra": {
            "wall_s": round(dt, 5),
            "wall_spread_s": [round(min(times), 5), round(max(times), 5)],
            "cpu_baseline_points_per_s": round(cpu_pps, 1),
            "n_points": N_POINTS,
            "n_patches": int(comp.patch.n_leaves),
            "n_claimed_in_banks": n_claimed,
            "in_sample_rmse_m": round(rmse, 4),
            "rmse_spread_m": [round(min(rmses), 4), round(max(rmses), 4)],
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }
    if not args.headline_only:
        for name, fn in (("calibrated", bench_calibrated),
                         ("nuts", bench_nuts),
                         ("registration", bench_registration),
                         ("mapping", bench_mapping), ("smc", bench_smc),
                         ("ksvd", bench_ksvd)):
            result["extra"][name] = fn(pts, cols, valid, cfg, comp)
    print(json.dumps(result))


def bench_calibrated(pts, cols, valid, cfg, comp):
    """North-star configuration: compress+decompress with MAP-calibrated
    (sigmaf^2, l^2, s20) — BASELINE.json:5. The whole
    calibrate->train->decompress round trip is ONE jit (the calibrated
    hyperparameters stay traced: the kernel's hyperparameter row), so
    unlike the staged compress_calibrated a fresh calibration costs no
    retrace and no host fetches.

    Two operating points are timed: COLD (fresh cloud, 4-start 150-step
    MAP) and WARM (theta warm-started from the previous cloud's
    calibration, 40 steps — the production steady state on a scan
    stream)."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.workloads import compressor

    def run_cold(key):
        return compressor.compress_decompress_calibrated(
            pts, cols, valid, cfg, key, use_pallas=True,
            calib_patches=32, calib_points=64, calib_steps=150,
            calib_lr=0.1, calib_starts=4)

    def run_warm(key, theta_init):
        return compressor.compress_decompress_calibrated(
            pts, cols, valid, cfg, key, use_pallas=True,
            calib_patches=32, calib_points=64, calib_steps=40,
            calib_lr=0.05, calib_starts=1, theta_init=theta_init)

    c, kp, s20, out = run_cold(jax.random.key(0))         # warmup/compile
    jax.block_until_ready(out[0])
    cold_times = []
    for i in range(2):
        t0 = time.perf_counter()
        c, kp, s20, out = run_cold(jax.random.key(i + 1))  # fresh keys: no
        jax.block_until_ready(out[0])                                      # retrace by design
        cold_times.append(time.perf_counter() - t0)
    cold = min(cold_times)
    rmse = float(compressor.reconstruction_rmse(c, cfg, depth_kp=kp,
                                                depth_s20=s20))
    theta_prev = jnp.log(jnp.stack([kp.sigmaf_sq, kp.l_sq, s20]))
    cw, kpw, s20w, outw = run_warm(jax.random.key(9), theta_prev)  # compile
    jax.block_until_ready(outw[0])
    warm_times = []
    for i in range(2):
        t0 = time.perf_counter()
        cw, kpw, s20w, outw = run_warm(jax.random.key(10 + i), theta_prev)
        jax.block_until_ready(outw[0])
        warm_times.append(time.perf_counter() - t0)
    warm = min(warm_times)
    warm_rmse = float(compressor.reconstruction_rmse(cw, cfg, depth_kp=kpw,
                                                     depth_s20=s20w))
    return {
        "points_per_s": round(N_POINTS / warm, 1),
        "wall_s": round(warm, 3),
        "in_sample_rmse_m": round(warm_rmse, 4),
        "cold_points_per_s": round(N_POINTS / cold, 1),
        "cold_wall_s": round(cold, 3),
        "cold_rmse_m": round(rmse, 4),
        "sigmaf_sq": round(float(kpw.sigmaf_sq), 5),
        "l_sq": round(float(kpw.l_sq), 5),
        "s20": round(float(s20w), 6),
    }


def bench_nuts(pts, cols, valid, cfg, comp):
    """NUTS samples/s over the patch-bank hyperparameter posterior —
    BASELINE.json's primary Bayesian metric."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import HMCConfig
    from gp_compressor_jax.inference import hmc, nuts
    from gp_compressor_jax.workloads import compressor

    batch = comp.patch
    Bc, n = 16, 48
    # dense valid-first subsample: the banks are scatter-time shuffled, so
    # raw [:Bc, :n] slices are mostly padding — a near-flat posterior that
    # chains wander on (observed max_rhat ~20)
    Xc, yc, mc = compressor.calib_subsample(batch, Bc, n)
    logpost = hmc.make_patch_logpost(Xc, yc, mc.astype(batch.X.dtype))
    hcfg = HMCConfig(num_warmup=50, num_samples=100, num_chains=4)
    theta0 = jnp.asarray([np.log(100.0), 0.0, np.log(0.1)], batch.X.dtype)
    th0 = theta0[None, :] + 0.2 * jax.random.normal(
        jax.random.key(7), (hcfg.num_chains, 3), batch.X.dtype)

    samples, acc, _ = nuts.nuts_sample_chains(logpost, th0, jax.random.key(1),
                                              hcfg)                 # compile
    jax.block_until_ready(samples)
    # >= 3 timed repeats, median + spread
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        samples, acc, _ = nuts.nuts_sample_chains(logpost, th0,
                                                  jax.random.key(2 + i), hcfg)
        jax.block_until_ready(samples)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    rhat = hmc.split_rhat(samples)

    # chain-axis parallel row: 16 vmapped chains on the same posterior and
    # warmup; R-hat over all 16 chains is a stronger diagnostic than the
    # 4-chain row's. Trajectory length is the per-transition cost on this
    # posterior, so the lever left is the batch axis.
    hcfg16 = HMCConfig(num_warmup=50, num_samples=100, num_chains=16)
    th16 = theta0[None, :] + 0.2 * jax.random.normal(
        jax.random.key(8), (hcfg16.num_chains, 3), batch.X.dtype)
    s16, a16, _ = nuts.nuts_sample_chains(logpost, th16, jax.random.key(11),
                                          hcfg16)
    jax.block_until_ready(s16)
    walls16 = []
    for i in range(3):
        t0 = time.perf_counter()
        s16, a16, _ = nuts.nuts_sample_chains(logpost, th16,
                                              jax.random.key(12 + i), hcfg16)
        jax.block_until_ready(s16)
        walls16.append(time.perf_counter() - t0)
    wall16 = float(np.median(walls16))
    rhat16 = hmc.split_rhat(s16)

    # ADVI on the same posterior, one lax.scan dispatch, warm-started from
    # the multi-start MAP mode: 300 cold Adam steps from the reference
    # constants stop mid-transit along the posterior ridge. The row is
    # gated on an ELBO plateau so an unconverged run is never reported as
    # a mode.
    from gp_compressor_jax.inference import vi

    theta_map, _ = hmc.map_estimate_multi(logpost, theta0, steps=150,
                                          lr=0.1, n_starts=4)
    vi_steps = 300
    res = vi.fit_advi(logpost, theta_map, jax.random.key(3), steps=vi_steps)
    jax.block_until_ready(res.elbo_trace)
    vi_walls = []
    for i in range(2):
        t0 = time.perf_counter()
        res = vi.fit_advi(logpost, theta_map, jax.random.key(4 + i),
                          steps=vi_steps)
        jax.block_until_ready(res.elbo_trace)
        vi_walls.append(time.perf_counter() - t0)
    vi_wall = float(np.median(vi_walls))
    plateaued = bool(vi.elbo_plateaued(res.elbo_trace))

    return {
        "samples_per_s": round(hcfg.num_chains * hcfg.num_samples / wall, 1),
        "wall_s": round(wall, 3),
        "wall_spread_s": [round(min(walls), 3), round(max(walls), 3)],
        "chains": hcfg.num_chains,
        "accept": round(float(jnp.mean(acc)), 3),
        "max_rhat": round(float(jnp.max(rhat)), 3),
        "logpost_patches": Bc,
        "chains16": {
            "samples_per_s": round(hcfg16.num_chains * hcfg16.num_samples
                                   / wall16, 1),
            "wall_s": round(wall16, 3),
            "wall_spread_s": [round(min(walls16), 3),
                              round(max(walls16), 3)],
            "chains": hcfg16.num_chains,
            "accept": round(float(jnp.mean(a16)), 3),
            "max_rhat": round(float(jnp.max(rhat16)), 3),
        },
        "advi": {"steps_per_s": round(vi_steps / vi_wall, 1),
                 "wall_s": round(vi_wall, 3),
                 "final_elbo": round(float(jnp.mean(res.elbo_trace[-20:])), 1),
                 "elbo_plateaued": plateaued,
                 "map_warm_start": True,
                 "mode_sigmaf_sq": (round(float(jnp.exp(res.mean[0])), 5)
                                    if plateaued else "UNCONVERGED"),
                 "mode_l_sq": (round(float(jnp.exp(res.mean[1])), 5)
                               if plateaued else "UNCONVERGED")},
    }


def bench_registration(pts, cols, valid, cfg, comp):
    """Scan-to-map registration at bench scale: full 300k-point scan vs the
    compressed map, perturbed by a known rigid motion.

    Headline row: the CALIBRATED map (the north-star operating point — the
    MAP-fit l ~ 4 cm density field is sharp at the surface) walked with
    sign-based iRprop- per-axis steps (RegistrationConfig.step_mode docs).
    The reference-constants l = 1 m field is too flat and biased for
    cm-scale motion: a direct sweep of its mean-likelihood objective puts
    the argmax about 3 cm off the true pose, while the calibrated field's
    argmax is at truth. The ref_constants row's ceiling is therefore
    structural to the reference's own objective, not an optimizer artifact
    (that row ships for parity). Full-precision geometry matmuls
    (transforms.py) and the oscillation-damped step rule (a fixed step
    ping-pongs at its trust radius) are load-bearing here."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import RegistrationConfig
    from gp_compressor_jax.geometry import transforms
    from gp_compressor_jax.workloads import compressor, registration

    ang = jnp.asarray([0.004, -0.003, 0.005], pts.dtype)
    t_true = jnp.asarray([0.012, -0.009, 0.006], pts.dtype)
    R_true = transforms.euler_xyz(ang)
    moved = transforms.apply(pts, R_true, t_true)
    err0 = float(jnp.mean(jnp.linalg.norm(moved - pts, axis=1)))

    comp_c, kpc, s20c, _ = compressor.compress_decompress_calibrated(
        pts, cols, valid, cfg, jax.random.key(0), use_pallas=True,
        calib_patches=32, calib_points=64, calib_steps=150,
        calib_lr=0.1, calib_starts=4)
    rcfg = RegistrationConfig(max_steps=80, step_mode="rprop")

    def run():
        return registration.register(comp_c, moved, cols, valid, cfg, rcfg,
                                     depth_kp=kpc, depth_s20=s20c)

    st, out = run()
    jax.block_until_ready(out)                                            # compile
    walls = []
    for _ in range(3):                # median of >= 3
        t0 = time.perf_counter()
        st, out = run()
        jax.block_until_ready(out)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    steps = int(st.step_nbr)
    terr, rerr = registration.registration_error(st.R_cloud, st.t_cloud,
                                                 R_true, t_true)
    # alignment error in point space (the gp-accuracy metric): how much of
    # the injected motion the registration actually removed
    err1 = float(jnp.mean(jnp.linalg.norm(out - pts, axis=1)))

    # parity row: reference constants, reference fixed-step rule at the
    # implied scaled tolerance
    rcfg_ref = RegistrationConfig(max_steps=40, step=0.005,
                                  grad_tol_step_ref=0.1)
    st_r, out_r = registration.register(comp, moved, cols, valid, cfg,
                                        rcfg_ref)
    jax.block_until_ready(out_r)
    err1_ref = float(jnp.mean(jnp.linalg.norm(out_r - pts, axis=1)))
    return {
        "steps_per_s": round(steps / wall, 1),
        "steps": steps,
        "wall_s": round(wall, 3),
        "wall_spread_s": [round(min(walls), 3), round(max(walls), 3)],
        "n_scan_points": int(pts.shape[0]),
        "initial_mean_err_m": round(err0, 4),
        "final_mean_err_m": round(err1, 4),
        "removed_pct": round(100 * (1 - err1 / err0), 1),
        "trans_err_m": round(float(terr), 4),
        "rot_err_rad": round(float(rerr), 4),
        "reclaim_every": rcfg.reclaim_every,
        "map": "calibrated",
        "step_mode": rcfg.step_mode,
        "ref_constants": {
            "steps": int(st_r.step_nbr),
            "final_mean_err_m": round(err1_ref, 4),
            "removed_pct": round(100 * (1 - err1_ref / err0), 1),
        },
    }


def bench_mapping(pts, cols, valid, cfg, comp):
    """Incremental mapping: register->insert->carve scans/s over a stream
    of 150k-point scans (one fused device dispatch per scan)."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import MappingConfig, RegistrationConfig
    from gp_compressor_jax.workloads import mapping

    lo = np.asarray(jnp.min(pts, 0)) - 0.3
    hi = np.asarray(jnp.max(pts, 0)) + 0.3
    # carve cap: 99th-percentile camera->point distance instead of the
    # world-box diagonal (73 steps) — rays longer than the cap just skip
    # their far free-space tail, the least valuable evidence
    p99 = float(np.percentile(np.linalg.norm(np.asarray(pts), axis=1), 99))
    steps = min(mapping.required_ray_steps(lo, hi, cfg.patch.res),
                int(1.2 * p99 / cfg.patch.res) + 2)
    # registration here is a fixed per-scan polish BUDGET on an already-
    # tracked stream — cap hits are routine, not divergence, so
    # drop_on_reg_cap=False (measured: the default dropped 3 of 4 scans
    # and left the map at 0.157 m chamfer RMSE). reg_stride 4: the polish
    # registers a 37k subsample with proportionally smaller banks.
    # carve_stride=8 halves the carve walk's DDA steps against stride 4
    # at a statistically identical map_rmse (see MappingConfig).
    mcfg = MappingConfig(min_points_new_patch=50, max_ray_steps=steps,
                         carve_stride=8, drop_on_reg_cap=False,
                         reg_stride=4)
    # CALIBRATED mapping: hyperparameters are MAP-fit once on the
    # seed scan, then the whole stream — registration density field,
    # incremental training, sanitation, prediction — runs on that ONE
    # consistent set. At the reference constants the l = 1 m density
    # field's optimum sits 2-3 cm off the true pose, so every per-scan
    # polish SMEARED the map (measured map chamfer RMSE 0.08-0.09 m);
    # the calibrated sharp field with iRprop- polish registers unperturbed
    # scans to mm drift.
    from gp_compressor_jax.workloads import compressor as compressor_mod
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    state = mapping.map_init(cfg, mcfg, lo, hi, dtype=pts.dtype)

    n_scans, Ns = 4, 150_000
    scans = [(pts[i::2][:Ns], cols[i::2][:Ns], valid[i::2][:Ns])
             for i in (0, 1)]

    _, kpc, s20c, _ = compressor_mod.compress_decompress_calibrated(
        *scans[0], cfg, jax.random.key(5), use_pallas=True,
        calib_patches=32, calib_points=64, calib_steps=150,
        calib_lr=0.1, calib_starts=4)
    eps_c = cfg.depth_gp.eps_tol * kpc.sigmaf_sq / cfg.depth_gp.sigmaf_sq
    calib = dict(depth_kp=kpc, depth_s20=s20c, depth_eps=eps_c)

    # seed the map with one scan, then fold the stream in ONE dispatch
    # (mapping.add_clouds)
    state, _, _, _ = mapping.add_cloud_fused(state, *scans[0], cfg, mcfg,
                                             jax.random.key(0), rcfg=rcfg,
                                             use_pallas=True, **calib)
    jax.block_until_ready(state.means)
    SP = jnp.stack([scans[(1 + s) % 2][0] for s in range(n_scans)])
    SC = jnp.stack([scans[(1 + s) % 2][1] for s in range(n_scans)])
    SV = jnp.stack([scans[(1 + s) % 2][2] for s in range(n_scans)])

    state2, diverged, reg_steps, info = mapping.add_clouds(
        state, SP, SC, SV, cfg, mcfg, jax.random.key(1), rcfg=rcfg,
        use_pallas=True, **calib)                   # compile
    jax.block_until_ready(state2.means)
    walls = []
    for i in range(3):                # median of >= 3
        t0 = time.perf_counter()
        state2, diverged, reg_steps, info = mapping.add_clouds(
            state, SP, SC, SV, cfg, mcfg, jax.random.key(2 + i), rcfg=rcfg,
            use_pallas=True, **calib)
        jax.block_until_ready(state2.means)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    # ---- map-quality gate: one-sided chamfer RMSE
    # from the predicted map cloud to the observed scan points. Outside the
    # timed window; a corner-cut map (diverged patches, dropped evidence)
    # shows up directly here.
    mpts, _, mok = mapping.map_cloud(state2, cfg, depth_kp=kpc,
                                     depth_s20=s20c)
    mp = np.asarray(mpts)[np.asarray(mok)]
    finite = np.isfinite(mp).all(axis=1)
    n_nonfinite = int((~finite).sum())
    mp = mp[finite]
    ref = np.concatenate([np.asarray(s[0]) for s in scans])
    try:
        from scipy.spatial import cKDTree
        d, _ = cKDTree(ref).query(mp, k=1)
        map_rmse = float(np.sqrt(np.mean(d ** 2)))
    except Exception:
        map_rmse = float("nan")
    return {
        "scans_per_s": round(n_scans / wall, 3),
        "wall_s_per_scan": round(wall / n_scans, 3),
        "wall_spread_s": [round(min(walls), 3), round(max(walls), 3)],
        "points_per_scan": Ns,
        "n_patches": int(state2.n_patches),
        "ray_steps": steps,
        "carve_stride": mcfg.carve_stride,
        "last_reg_steps": int(reg_steps[-1]),
        "map_rmse_m": round(map_rmse, 4),
        "map_points_nonfinite": n_nonfinite,
        "bank_dropped": int(jnp.sum(info["bank_dropped"])),
        "pend_dropped": int(jnp.sum(info["pend_dropped"])),
        "patch_overflow": int(jnp.sum(info["patch_overflow"])),
    }


def bench_smc(pts, cols, valid, cfg, comp):
    """SMC pose refinement against the map (SURVEY 2.5 SMC row): the
    divergence-fallback scenario. A scan is displaced well
    beyond the mapping stream's 8-step polish budget; gradient registration
    at that budget leaves a cm-scale residual, and the particle refinement
    (mapping.smc_refine_pose, one lax.scan dispatch) closes it — directly
    upgrading the reference's drop-on-divergence behavior
    (src/gp_mapping.cpp:22-27, which throws the scan away)."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.config import (MappingConfig, RegistrationConfig,
                                          SMCConfig)
    from gp_compressor_jax.geometry import transforms
    from gp_compressor_jax.workloads import compressor as compressor_mod
    from gp_compressor_jax.workloads import mapping, registration

    lo = np.asarray(jnp.min(pts, 0)) - 0.3
    hi = np.asarray(jnp.max(pts, 0)) + 0.3
    p99 = float(np.percentile(np.linalg.norm(np.asarray(pts), axis=1), 99))
    steps = min(mapping.required_ray_steps(lo, hi, cfg.patch.res),
                int(1.2 * p99 / cfg.patch.res) + 2)
    mcfg = MappingConfig(min_points_new_patch=50, max_ray_steps=steps,
                         carve_stride=8, drop_on_reg_cap=False, reg_stride=4)
    rcfg = RegistrationConfig(max_steps=8, min_steps=2, step_mode="rprop",
                              bank_points=64)
    Ns = 150_000
    scan0 = (pts[0::2][:Ns], cols[0::2][:Ns], valid[0::2][:Ns])
    scan1 = (pts[1::2][:Ns], cols[1::2][:Ns], valid[1::2][:Ns])

    _, kpc, s20c, _ = compressor_mod.compress_decompress_calibrated(
        *scan0, cfg, jax.random.key(5), use_pallas=True,
        calib_patches=32, calib_points=64, calib_steps=150,
        calib_lr=0.1, calib_starts=4)
    eps_c = cfg.depth_gp.eps_tol * kpc.sigmaf_sq / cfg.depth_gp.sigmaf_sq
    state = mapping.map_init(cfg, mcfg, lo, hi, dtype=pts.dtype)
    state, _, _, _ = mapping.add_cloud_fused(
        state, *scan0, cfg, mcfg, jax.random.key(0), rcfg=rcfg,
        use_pallas=True, depth_kp=kpc, depth_s20=s20c, depth_eps=eps_c)
    jax.block_until_ready(state.means)

    # displacement ~4x the 8-step rprop budget can remove
    ang = jnp.asarray([0.012, -0.008, 0.010], pts.dtype)
    t_true = jnp.asarray([0.05, -0.04, 0.03], pts.dtype)
    R_true = transforms.euler_xyz(ang)
    moved = transforms.apply(scan1[0], R_true, t_true)
    err0 = float(jnp.mean(jnp.linalg.norm(moved - scan1[0], axis=1)))

    comp_m = mapping._map_as_compressed(state, cfg)
    st, out_reg = registration.register(comp_m, moved, scan1[1], scan1[2],
                                        cfg, rcfg, depth_kp=kpc,
                                        depth_s20=s20c)
    jax.block_until_ready(out_reg)
    err_reg = float(jnp.mean(jnp.linalg.norm(out_reg - scan1[0], axis=1)))

    scfg = SMCConfig(num_particles=256, pose_proposal_std_t=0.012,
                     pose_proposal_std_r=0.004)
    n_iters = 16

    def run(key):
        return mapping.smc_refine_pose(state, out_reg, scan1[1], scan1[2],
                                       cfg, scfg, key, n_iters=n_iters,
                                       depth_kp=kpc, depth_s20=s20c)

    (R2, t2), _, trace = run(jax.random.key(3))
    jax.block_until_ready(trace)                                         # compile
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        (R2, t2), _, trace = run(jax.random.key(4 + i))
        jax.block_until_ready(trace)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    out_smc = transforms.apply(out_reg, R2, t2)
    err_smc = float(jnp.mean(jnp.linalg.norm(out_smc - scan1[0], axis=1)))
    return {
        "particles_per_s": round(scfg.num_particles * n_iters / wall, 1),
        "wall_s": round(wall, 3),
        "wall_spread_s": [round(min(walls), 3), round(max(walls), 3)],
        "particles": scfg.num_particles,
        "iters": n_iters,
        "injected_err_m": round(err0, 4),
        "after_reg_budget_err_m": round(err_reg, 4),
        "after_smc_err_m": round(err_smc, 4),
        "reg_steps": int(st.step_nbr),
    }


def bench_ksvd(pts, cols, valid, cfg, comp):
    """K-SVD compression pipeline on the device (the reference's second
    workload, src/pointcloud_compressor.cpp:20-29 at the test_compress
    demo config: dict 200/600, words 10/20, src/test_compress.cpp:18).
    The whole dictionary learning loop (OMP coding + Gauss-Seidel atom
    sweeps + stop_diff early exit) runs on-device
    (dictionary.ksvd_device)."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.workloads import ksvd_compressor

    def run(key):
        return ksvd_compressor.compress(pts, cols, valid, cfg, key)

    comp_k = run(jax.random.key(0))                        # warmup/compile
    jax.block_until_ready((comp_k.depth.error, comp_k.rgb.error))
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        comp_k = run(jax.random.key(i + 1))
        jax.block_until_ready((comp_k.depth.error, comp_k.rgb.error))
        times.append(time.perf_counter() - t0)
    wall = min(times)
    rms = ksvd_compressor.rms_error(comp_k)
    return {
        "points_per_s": round(N_POINTS / wall, 1),
        "wall_s": round(wall, 3),
        "in_sample_rms_m": round(rms, 4),
        "depth_iters": int(comp_k.depth.iters),
        "rgb_iters": int(comp_k.rgb.iters),
        "depth_mse": round(float(comp_k.depth.error), 6),
        "dict_size": cfg.ksvd.dict_size,
        "words_max": cfg.ksvd.words_max,
    }


if __name__ == "__main__":
    main()
