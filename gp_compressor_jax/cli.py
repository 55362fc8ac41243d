"""Command-line demos mirroring the reference's L6 executables.

Reference demos (SURVEY.md §2.4): test_compress / test_decompress (K-SVD
pipeline), test_gp_compress (GP pipeline), test_gp_registration,
test_gp_accuracy (quantitative registration eval), test_gp_mapping_no_vis.
Their hardcoded absolute dataset paths become arguments; when no cloud is
given, the synthetic room generator stands in for the TUM/SUN3D scans.
PCLVisualizer windows become PCD outputs viewable in any cloud viewer.

Usage: python -m gp_compressor_jax.cli <command> [options]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_cloud(args):
    import numpy as np

    if args.cloud:
        from gp_compressor_jax.io import native
        pts, cols = native.read_pcd(args.cloud)
        if cols is None:
            cols = np.full_like(pts, 128.0)
        return pts, cols
    from gp_compressor_jax.utils import synthetic
    return synthetic.room_cloud(n=args.n_points, seed=args.seed)


def _gp_config(args):
    import jax.numpy as jnp

    from gp_compressor_jax.config import (CompressorConfig, GPConfig,
                                          KSVDConfig, PatchConfig,
                                          rgb_gp_config, rgb_ksvd_config)
    # padded state width: the next power of two that fits capacity + 1,
    # the widths the fused training kernel is built for
    slots = max(32, 1 << args.capacity.bit_length())
    return CompressorConfig(
        patch=PatchConfig(res=args.res, sz=args.sz,
                          max_patches=args.max_patches,
                          max_points_per_patch=args.max_ppp),
        depth_gp=GPConfig(capacity=args.capacity, slots=slots,
                          eps_tol=args.eps_tol),
        rgb_gp=rgb_gp_config(slots=slots, capacity=args.capacity),
        ksvd=KSVDConfig(dict_size=args.dict_size, words_max=args.words_max),
        rgb_ksvd=rgb_ksvd_config(dict_size=args.rgb_dict_size,
                                 words_max=args.rgb_words_max),
    )


def cmd_gp_compress(args):
    """test_gp_compress equivalent (src/test_gp_compress.cpp)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gp_compressor_jax.io import native
    from gp_compressor_jax.workloads import compressor

    pts_np, cols_np = _load_cloud(args)
    cfg = _gp_config(args)
    print(f"Size of original point cloud: {len(pts_np)}")
    t0 = time.time()
    comp = compressor.compress(jnp.asarray(pts_np), jnp.asarray(cols_np),
                               jnp.ones(len(pts_np), bool), cfg,
                               jax.random.key(args.seed),
                               use_pallas=args.fused_train)
    from gp_compressor_jax.models import sparse_gp
    szs = np.asarray(sparse_gp.size(comp.depth_gp))
    print(f"Number of patches: {int(comp.patch.n_leaves)}")
    print(f"Mean added: {szs[szs > 0].mean():.2f}")    # src/gp_compressor.cpp:173
    print(f"Max added: {szs.max()}")                   # src/gp_compressor.cpp:174
    world, colors, ok, *_ = compressor.decompress(comp, cfg)
    rmse = float(compressor.reconstruction_rmse(comp, cfg))
    print(f"RMS error: {rmse:.5f}")                    # src/gp_compressor.cpp:381
    w = np.asarray(world)[np.asarray(ok)]
    c = np.asarray(colors)[np.asarray(ok)]
    print(f"Size of transformed point cloud: {len(w)}")
    print(f"Wall time: {time.time() - t0:.2f}s")
    if args.out:
        native.write_pcd(args.out, w, c)
        print(f"wrote {args.out}")
    if args.checkpoint:
        from gp_compressor_jax.io import checkpoint
        checkpoint.save(args.checkpoint, comp, meta={"kind": "gp_compressed"})
        print(f"wrote {args.checkpoint}")


def cmd_compress(args):
    """test_compress equivalent (K-SVD pipeline, src/test_compress.cpp)."""
    import jax
    import jax.numpy as jnp

    from gp_compressor_jax.io import artifact as artifact_io
    from gp_compressor_jax.workloads import ksvd_compressor

    pts_np, cols_np = _load_cloud(args)
    cfg = _gp_config(args)
    print(f"Size of original point cloud: {len(pts_np)}")
    comp = ksvd_compressor.compress(jnp.asarray(pts_np), jnp.asarray(cols_np),
                                    jnp.ones(len(pts_np), bool), cfg,
                                    jax.random.key(args.seed), verbose=True)
    print(f"RMS error: {ksvd_compressor.rms_error(comp):.5f}")
    art = ksvd_compressor.to_artifact(comp)
    artifact_io.write(args.name, art)
    print(f"wrote {args.name}.pccode, {args.name}depth.pcdict, "
          f"{args.name}rgb.pcdict")


def cmd_decompress(args):
    """test_decompress equivalent (src/test_decompress.cpp)."""
    from gp_compressor_jax.io import artifact as artifact_io, native
    from gp_compressor_jax.workloads import ksvd_compressor

    art = artifact_io.read(args.name)
    pts, cols = ksvd_compressor.decompress_artifact(art)
    print(f"Size of transformed point cloud: {len(pts)}")
    if args.out:
        native.write_pcd(args.out, pts, cols)
        print(f"wrote {args.out}")


def _read_scan(path):
    import numpy as np

    from gp_compressor_jax.io import native
    pts, cols = native.read_pcd(path)
    if cols is None:
        cols = np.full_like(pts, 128.0)
    return pts, cols


def _gp_accuracy_tum(args):
    """test_gp_accuracy on a real TUM-format dataset directory
    (<dataset>/pointclouds/*.pcd + <dataset>/groundtruth.txt):
    register frame pairs (i, i+stride) with the second frame voxel-filtered
    at 1 cm, score the estimated motion against the timestamp-aligned
    ground truth (src/test_gp_accuracy.cpp:93-186)."""
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from gp_compressor_jax.config import RegistrationConfig
    from gp_compressor_jax.io import tum
    from gp_compressor_jax.workloads import compressor, registration

    cfg = _gp_config(args)
    files = tum.list_scan_files(os.path.join(args.dataset, "pointclouds"))
    gt_path = os.path.join(args.dataset, "groundtruth.txt")
    times, pos, quat = tum.read_ground_truth(gt_path)
    stride = args.frame_stride
    rcfg = RegistrationConfig(step=args.step, max_steps=args.max_steps)
    results = []
    for i in range(0, min(args.n_pairs * stride, len(files) - stride),
                   stride):
        p1, c1 = _read_scan(files[i])
        p2, c2 = _read_scan(files[i + stride])
        p2, c2 = tum.voxel_filter(p2, c2, leaf=0.01)   # :126-129
        comp = compressor.compress(jnp.asarray(p1), jnp.asarray(c1),
                                   jnp.ones(len(p1), bool), cfg,
                                   jax.random.key(args.seed))
        t0 = time.time()
        state, _ = registration.register(
            comp, jnp.asarray(p2), jnp.asarray(c2),
            jnp.ones(len(p2), bool), cfg, rcfg)
        q_gt, t_gt = tum.ground_truth_delta(
            times, pos, quat,
            tum.timestamp_from_filename(files[i]),
            tum.timestamp_from_filename(files[i + stride]))
        q_err, t_err = tum.pair_errors(np.asarray(state.R_cloud),
                                       np.asarray(state.t_cloud), q_gt, t_gt)
        res = {"pair": [i, i + stride], "steps": int(state.step_nbr),
               "trans_err_m": round(t_err, 5), "rot_err": round(q_err, 5),
               "gt_trans_m": round(float(np.linalg.norm(t_gt)), 5),
               "mean_likelihood": round(float(state.mean_likelihood), 4),
               "wall_s": round(time.time() - t0, 2)}
        print(json.dumps(res))
        results.append(res)
    if results:
        print(json.dumps({
            "mean_trans_err_m": round(float(np.mean(
                [r["trans_err_m"] for r in results])), 5),
            "mean_rot_err": round(float(np.mean(
                [r["rot_err"] for r in results])), 5),
            "n_pairs": len(results)}))


def cmd_gp_accuracy(args):
    """test_gp_accuracy equivalent (src/test_gp_accuracy.cpp): real
    TUM-format dataset when --dataset is given, else synthetic ground
    truth: perturb, register, report per-step errors."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gp_compressor_jax.config import RegistrationConfig
    from gp_compressor_jax.utils import synthetic
    from gp_compressor_jax.workloads import compressor, registration

    if args.dataset:
        return _gp_accuracy_tum(args)

    pts_np, cols_np = _load_cloud(args)
    half = len(pts_np) // 2
    cfg = _gp_config(args)
    comp = compressor.compress(jnp.asarray(pts_np[:half]),
                               jnp.asarray(cols_np[:half]),
                               jnp.ones(half, bool), cfg,
                               jax.random.key(args.seed))
    rng = np.random.default_rng(args.seed)
    rotvec = args.rot_mag * rng.standard_normal(3)
    t_true = args.trans_mag * rng.standard_normal(3)
    scan, R_true = synthetic.rigid_transform(pts_np[half:], rotvec, t_true)
    rcfg = RegistrationConfig(step=args.step, max_steps=args.max_steps)
    t0 = time.time()
    state, aligned = registration.register(
        comp, jnp.asarray(scan), jnp.asarray(cols_np[half:]),
        jnp.ones(len(scan), bool), cfg, rcfg)
    err0 = np.linalg.norm(scan - pts_np[half:], axis=1).mean()
    err1 = np.linalg.norm(np.asarray(aligned) - pts_np[half:], axis=1).mean()
    out = {
        "steps": int(state.step_nbr),
        "initial_mean_err_m": round(float(err0), 5),
        "final_mean_err_m": round(float(err1), 5),
        "mean_likelihood": round(float(state.mean_likelihood), 4),
        "wall_s": round(time.time() - t0, 2),
    }
    if args.baseline == "icp":
        # independent comparator (the reference's NDT role,
        # ndt/test_ndt_accuracy.cpp:91-188): point-to-plane ICP on the
        # same pair with the same error metric
        from gp_compressor_jax.geometry import transforms
        from gp_compressor_jax.workloads import icp

        t0 = time.time()
        res = icp.icp_register(comp, jnp.asarray(scan),
                               jnp.ones(len(scan), bool), cfg)
        icp_aligned = np.asarray(transforms.apply(jnp.asarray(scan),
                                                  res.R, res.t))
        ierr = np.linalg.norm(icp_aligned - pts_np[half:], axis=1).mean()
        out["icp"] = {
            "iters": int(res.iters),
            "final_mean_err_m": round(float(ierr), 5),
            "rms_plane_residual_m": round(float(res.rms_residual), 5),
            "n_matched": int(res.n_matched),
            "wall_s": round(time.time() - t0, 2),
        }
    print(json.dumps(out))


def cmd_calibrate(args):
    """Bayesian hyperparameter calibration over the cloud's patch bank —
    the working replacement for the reference's abandoned train_parameters
    (src/sparse_gp.hpp:586-650). Prints HMC posterior means (or a MAP fit
    with --map) for (sigma_f^2, l^2, s20)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gp_compressor_jax.config import HMCConfig
    from gp_compressor_jax.inference import hmc
    from gp_compressor_jax.workloads import compressor

    pts_np, cols_np = _load_cloud(args)
    cfg = _gp_config(args)
    batch = compressor.project(jnp.asarray(pts_np), jnp.asarray(cols_np),
                               jnp.ones(len(pts_np), bool), cfg)
    # stratified dense subsample (calib_subsample): raw [:B, :n] slices of
    # the padded banks are mostly masked rows — a near-flat posterior the
    # chains wander on (measured: R-hat ~50 on a 20k-point cloud)
    B = min(args.n_calib_patches, int(batch.n_leaves))
    n = min(args.n_calib_points, batch.X.shape[1])
    X, y, mask = compressor.calib_subsample(batch, B, n)
    logpost = hmc.make_patch_logpost(X, y, mask.astype(X.dtype))

    theta0 = jnp.asarray([np.log(100.0), 0.0, np.log(0.1)])
    if args.map:
        theta, trace = hmc.map_estimate(logpost, theta0, steps=args.steps)
        est = np.exp(np.asarray(theta))
        print(json.dumps({"method": "map", "sigmaf_sq": est[0],
                          "l_sq": est[1], "s20": est[2],
                          "logpost": float(trace[-1])}))
    else:
        hcfg = HMCConfig(num_warmup=args.steps, num_samples=args.steps,
                         num_chains=2)
        t0 = jnp.stack([theta0, theta0 + 0.5])
        samples, acc, _ = hmc.hmc_sample_chains(logpost, t0,
                                                jax.random.key(args.seed), hcfg)
        s = np.asarray(samples).reshape(-1, 3)
        rhat = np.asarray(hmc.split_rhat(jnp.asarray(samples)))
        print(json.dumps({
            "method": "hmc", "accept": float(np.asarray(acc).mean()),
            "sigmaf_sq": float(np.exp(s[:, 0]).mean()),
            "l_sq": float(np.exp(s[:, 1]).mean()),
            "s20": float(np.exp(s[:, 2]).mean()),
            "rhat": rhat.round(3).tolist(),
        }))


def cmd_gp_mapping(args):
    """test_gp_mapping_no_vis equivalent (src/test_gp_mapping_no_vis.cpp):
    feed a sequence of scans, save the map cloud periodically."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gp_compressor_jax.config import MappingConfig, RegistrationConfig
    from gp_compressor_jax.io import native
    from gp_compressor_jax.utils import synthetic
    from gp_compressor_jax.workloads import mapping

    cfg = _gp_config(args)
    rcfg = RegistrationConfig(step=args.step, max_steps=args.max_steps)

    if args.dataset:
        # stream a TUM-format scan directory (test_gp_mapping_no_vis,
        # src/test_gp_mapping_no_vis.cpp:34-69)
        import os

        from gp_compressor_jax.io import tum
        files = tum.list_scan_files(os.path.join(args.dataset,
                                                 "pointclouds"))
        if args.n_scans > 0:
            files = files[:args.n_scans]
        scans = (_read_scan(f) for f in files)
        pts0, _ = _read_scan(files[0])
        m = args.world_margin
        lo, hi = pts0.min(0) - m, pts0.max(0) + m
    else:
        pts0, _ = synthetic.room_cloud(n=args.n_points, seed=args.seed)
        lo, hi = pts0.min(0) - 0.5, pts0.max(0) + 0.5
        scans = (synthetic.room_cloud(n=args.n_points, seed=args.seed + k)
                 for k in range(args.n_scans))

    steps = mapping.required_ray_steps(lo, hi, args.res)
    mcfg = MappingConfig(max_ray_steps=steps)
    state = mapping.map_init(cfg, mcfg, lo, hi)
    for k, (pts, cols) in enumerate(scans):
        state, info = mapping.add_cloud(
            state, jnp.asarray(pts), jnp.asarray(cols),
            jnp.ones(len(pts), bool), cfg, mcfg, jax.random.key(k), rcfg)
        print(f"scan {k}: {info}")
        if args.out and (k + 1) % args.save_every == 0:
            w, c, ok = mapping.map_cloud(state, cfg)
            w = np.asarray(w)[np.asarray(ok)]
            c = np.asarray(c)[np.asarray(ok)]
            native.write_pcd(args.out, w, c)
            print(f"wrote {args.out} ({len(w)} points)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="gp_compressor_jax")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, res=0.15, sz=20):
        sp.add_argument("--cloud", help="input .pcd (default: synthetic room)")
        sp.add_argument("--n-points", type=int, default=100_000)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--res", type=float, default=res)
        sp.add_argument("--sz", type=int, default=sz)
        sp.add_argument("--capacity", type=int, default=100)
        sp.add_argument("--eps-tol", type=float, default=1e-6)
        sp.add_argument("--max-patches", type=int, default=4096)
        sp.add_argument("--max-ppp", type=int, default=256)
        sp.add_argument("--dict-size", type=int, default=200)
        sp.add_argument("--words-max", type=int, default=10)
        sp.add_argument("--rgb-dict-size", type=int, default=600)
        sp.add_argument("--rgb-words-max", type=int, default=20)

    sp = sub.add_parser("gp-compress", help="GP compress+decompress demo")
    common(sp)
    sp.add_argument("--out", help="output .pcd")
    sp.add_argument("--checkpoint", help="output .npz GP state")
    sp.add_argument("--fused-train", action="store_true",
                    help="train the patch GPs with the fused Triton kernel "
                         "(GPU; widths it does not cover take the XLA scan)")
    sp.set_defaults(fn=cmd_gp_compress)

    sp = sub.add_parser("compress", help="K-SVD compression demo")
    common(sp)
    sp.add_argument("--name", default="test", help="artifact basename")
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress", help="K-SVD decompression demo")
    sp.add_argument("--name", default="test")
    sp.add_argument("--out", help="output .pcd")
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("gp-accuracy", help="registration accuracy eval")
    common(sp, res=0.3, sz=10)
    sp.add_argument("--step", type=float, default=0.005)
    sp.add_argument("--max-steps", type=int, default=150)
    sp.add_argument("--trans-mag", type=float, default=0.02)
    sp.add_argument("--rot-mag", type=float, default=0.005)
    sp.add_argument("--dataset", help="TUM-format dir (pointclouds/*.pcd + "
                    "groundtruth.txt); default: synthetic ground truth")
    sp.add_argument("--frame-stride", type=int, default=5,
                    help="pair stride (src/test_gp_accuracy.cpp:110)")
    sp.add_argument("--baseline", choices=["none", "icp"], default="none",
                    help="also run an independent comparator on the same "
                         "pair (the reference's NDT role)")
    sp.add_argument("--n-pairs", type=int, default=1)
    sp.set_defaults(fn=cmd_gp_accuracy)

    sp = sub.add_parser("calibrate", help="Bayesian hyperparameter calibration")
    common(sp, res=0.3, sz=10)
    sp.add_argument("--map", action="store_true", help="MAP fit instead of HMC")
    sp.add_argument("--steps", type=int, default=150)
    sp.add_argument("--n-calib-patches", type=int, default=32)
    sp.add_argument("--n-calib-points", type=int, default=64)
    sp.set_defaults(fn=cmd_calibrate)

    sp = sub.add_parser("gp-mapping", help="incremental mapping demo")
    common(sp, res=0.2, sz=15)
    sp.add_argument("--dataset", help="TUM-format dir to stream "
                    "(src/test_gp_mapping_no_vis.cpp); default: synthetic")
    sp.add_argument("--world-margin", type=float, default=3.0,
                    help="map box inflation around the first scan [m]")
    sp.add_argument("--n-scans", type=int, default=5)
    sp.add_argument("--step", type=float, default=0.005)
    sp.add_argument("--max-steps", type=int, default=60)
    sp.add_argument("--save-every", type=int, default=2)
    sp.add_argument("--out", help="output .pcd")
    sp.set_defaults(fn=cmd_gp_mapping)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
