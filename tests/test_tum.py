"""Real-dataset eval path: TUM ground-truth parsing, timestamp alignment,
voxel prefilter, and the gp-accuracy / gp-mapping CLI running end-to-end on
a TUM-format directory (generated fixture)."""

import json
import os

import numpy as np
import pytest

from gp_compressor_jax.io import tum


def test_read_ground_truth_and_alignment(tmp_path):
    path = os.path.join(tmp_path, "groundtruth.txt")
    with open(path, "w") as f:
        f.write("# header\n# header\n# timestamp tx ty tz qx qy qz qw\n")
        for k in range(5):
            f.write(f"{100.0 + k} {k} 0 0 0 0 0 1\n")
    times, pos, quat = tum.read_ground_truth(path)
    assert times.shape == (5,) and pos.shape == (5, 3) and quat.shape == (5, 4)
    # last-at-or-before semantics (src/test_gp_accuracy.cpp:66-79)
    assert tum.find_closest_timestamp(times, 102.5) == 2
    assert tum.find_closest_timestamp(times, 99.0) == 0
    assert tum.find_closest_timestamp(times, 1e9) == 4
    assert tum.find_closest_timestamp(times, 103.0) == 3


def test_timestamp_from_filename():
    assert tum.timestamp_from_filename(
        "/data/pointclouds/1305031910.765238.pcd") == pytest.approx(
            1305031910.765238)
    assert tum.timestamp_from_filename("cloud_123.500000.pcd") == 123.5


def test_voxel_filter_averages_per_leaf():
    pts = np.asarray([[0.001, 0.0, 0.0], [0.003, 0.0, 0.0],
                      [0.5, 0.5, 0.5]])
    cols = np.asarray([[0.0, 0, 0], [10.0, 0, 0], [20.0, 0, 0]])
    out, outc = tum.voxel_filter(pts, cols, leaf=0.01)
    assert out.shape == (2, 3)
    np.testing.assert_allclose(out[0], [0.002, 0.0, 0.0], atol=1e-9)
    np.testing.assert_allclose(outc[0, 0], 5.0)


def test_ground_truth_delta_identity_frame():
    times = np.asarray([0.0, 1.0])
    pos = np.asarray([[0.0, 0, 0], [0.1, -0.2, 0.3]])
    quat = np.asarray([[0.0, 0, 0, 1.0], [0.0, 0, 0, 1.0]])
    q_gt, t_gt = tum.ground_truth_delta(times, pos, quat, 0.0, 1.0)
    np.testing.assert_allclose(q_gt, [0, 0, 0, 1], atol=1e-12)
    np.testing.assert_allclose(t_gt, [0.1, -0.2, 0.3], atol=1e-12)


def test_fixture_roundtrip_and_gt_consistency(tmp_path):
    """The generated fixture's scans + groundtruth must be self-consistent:
    applying the gt relative motion to scan2 must align it with scan1."""
    d, poses = tum.make_fixture(str(tmp_path), n_frames=3, n_points=2000)
    files = tum.list_scan_files(os.path.join(d, "pointclouds"))
    assert len(files) == 3
    times, pos, quat = tum.read_ground_truth(
        os.path.join(d, "groundtruth.txt"))
    from gp_compressor_jax.io import native
    p1, _ = native.read_pcd(files[0])
    p2, _ = native.read_pcd(files[1])
    q_gt, t_gt = tum.ground_truth_delta(
        times, pos, quat, tum.timestamp_from_filename(files[0]),
        tum.timestamp_from_filename(files[1]))
    from gp_compressor_jax.geometry import rotation as rot_mod
    R_gt = np.asarray(rot_mod.quaternion_to_matrix(np.asarray(q_gt)))
    aligned = p2 @ R_gt.T + t_gt
    # same underlying world points + per-frame noise (2 x 0.002 sd)
    err = np.linalg.norm(aligned - p1, axis=1).mean()
    assert err < 0.01, err


def test_cli_gp_accuracy_on_tum_fixture(tmp_path, capsys):
    d, _ = tum.make_fixture(str(tmp_path), n_frames=3, n_points=6000)
    from gp_compressor_jax import cli
    cli.main(["gp-accuracy", "--dataset", d, "--res", "0.4", "--sz", "8",
              "--capacity", "15", "--max-patches", "256", "--max-ppp", "128",
              "--eps-tol", "2.0", "--frame-stride", "1", "--n-pairs", "2",
              "--step", "0.01", "--max-steps", "120"])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["n_pairs"] == 2
    # the plumbing test: timestamp alignment + gt deltas + registration
    # must run end-to-end and IMPROVE on the raw inter-frame motion
    # (registration accuracy itself is pinned in tests/test_registration.py)
    per_pair = [json.loads(l) for l in out[:-1]]
    for r in per_pair:
        assert r["trans_err_m"] < r["gt_trans_m"], r
        assert r["rot_err"] < 0.008, r


def test_cli_gp_mapping_on_tum_fixture(tmp_path, capsys):
    d, _ = tum.make_fixture(str(tmp_path), n_frames=3, n_points=5000)
    out_pcd = os.path.join(tmp_path, "map.pcd")
    from gp_compressor_jax import cli
    cli.main(["gp-mapping", "--dataset", d, "--res", "0.4", "--sz", "8",
              "--capacity", "15", "--max-patches", "512", "--max-ppp", "128",
              "--eps-tol", "2.0", "--step", "0.01", "--max-steps", "30",
              "--save-every", "3", "--out", out_pcd])
    out = capsys.readouterr().out
    assert "scan 2" in out
    assert os.path.exists(out_pcd)
