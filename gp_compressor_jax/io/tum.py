"""TUM RGB-D dataset plumbing: ground-truth trajectories, timestamp
alignment, scan-directory streaming, voxel prefilter.

Reference: test_gp_accuracy reads `groundtruth.txt` (skipping its 3-line
header), parses each line as `timestamp tx ty tz qx qy qz qw`
(src/test_gp_accuracy.cpp:38-64), aligns each scan to the LAST ground-truth
entry at-or-before the scan's filename timestamp (`find_closest_timestamp`,
:66-79; `get_timestamp_from_filename` slices the 17-char stamp before
".pcd", :81-88), sorts the `pointclouds/` directory lexicographically
(read_files, :17-36 — lexicographic == chronological for fixed-width TUM
stamps), and voxel-prefilters the second scan at 1 cm (:126-129).
test_gp_mapping_no_vis streams the same directory through gp_mapping
(src/test_gp_mapping_no_vis.cpp:34-69).

All host-side NumPy: dataset IO never touches the device.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

_STAMP_RE = re.compile(r"(\d+\.\d+)")


def read_ground_truth(path: str):
    """-> (times [T] float64, pos [T, 3], quat [T, 4] in (x, y, z, w)).

    Skips the first 3 lines like the reference (TUM files carry a 3-line
    '#' header; src/test_gp_accuracy.cpp:50-55)."""
    times, pos, quat = [], [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if i < 3:
                continue
            parts = line.split()
            if len(parts) < 8 or parts[0].startswith("#"):
                continue
            v = [float(x) for x in parts[:8]]
            times.append(v[0])
            pos.append(v[1:4])
            quat.append(v[4:8])
    return (np.asarray(times), np.asarray(pos).reshape(-1, 3),
            np.asarray(quat).reshape(-1, 4))


def find_closest_timestamp(times: np.ndarray, t: float) -> int:
    """Index of the last entry with time <= t (first entry if t precedes
    the trajectory) — src/test_gp_accuracy.cpp:66-79."""
    i = int(np.searchsorted(times, t, side="right"))
    return min(max(i - 1, 0), len(times) - 1)


def timestamp_from_filename(path: str) -> float:
    """The float stamp embedded in a TUM scan filename
    (src/test_gp_accuracy.cpp:81-88 slices chars [-21, -4); here: the last
    decimal literal in the basename, robust to prefix/extension)."""
    m = _STAMP_RE.findall(os.path.basename(path))
    if not m:
        raise ValueError(f"no timestamp in filename: {path}")
    return float(m[-1])


def list_scan_files(dirname: str, ext: str = ".pcd"):
    """Sorted scan paths of a TUM pointclouds directory
    (src/test_gp_accuracy.cpp:17-36)."""
    files = sorted(os.path.join(dirname, f) for f in os.listdir(dirname)
                   if f.endswith(ext) and not f.startswith("."))
    return files


# ---------------------------------------------------------------------------
# quaternions — (x, y, z, w) layout matching Eigen's coeffs()/the artifact
# ---------------------------------------------------------------------------

def q_conj(q: np.ndarray) -> np.ndarray:
    return np.asarray([-q[0], -q[1], -q[2], q[3]])


def q_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.asarray([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def q_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def ground_truth_delta(times, pos, quat, t_first: float, t_second: float):
    """Ground-truth relative motion frame2 -> frame1 for timestamp-aligned
    TUM camera-to-world poses (w = R_k s + p_k): rotation q1^-1 * q2 and
    translation R1^T (p2 - p1) — what a registration aligning scan2 onto
    scan1's map converges to.

    Documented divergence (PARITY.md): the reference computes the rotation
    identically (src/test_gp_accuracy.cpp:140-141) but uses t_gt = p1 - p2
    (:142) — the world-frame difference with a sign flip and no rotation
    into frame 1, which only matches the true relative translation when
    R1 = I; it was used for plotted curves, never asserted."""
    from gp_compressor_jax.geometry import rotation as rot_mod
    import numpy as _np

    i1 = find_closest_timestamp(times, t_first)
    i2 = find_closest_timestamp(times, t_second)
    q1 = q_normalize(quat[i1])
    q_gt = q_normalize(q_mul(q_conj(q1), q_normalize(quat[i2])))
    R1 = _np.asarray(rot_mod.quaternion_to_matrix(_np.asarray(q1)))
    t_gt = R1.T @ (pos[i2] - pos[i1])
    return q_gt, t_gt


def pair_errors(R_est: np.ndarray, t_est: np.ndarray,
                q_gt: np.ndarray, t_gt: np.ndarray):
    """Per-step metrics (src/test_gp_accuracy.cpp:163-169):
    quat_err = |vec(q_est^-1 q_gt)|, t_err = |t_est - t_gt|."""
    from gp_compressor_jax.geometry import rotation
    q_est = np.asarray(rotation.matrix_to_quaternion(
        np.asarray(R_est, np.float64)))
    dq = q_normalize(q_mul(q_conj(q_est), q_gt))
    return float(np.linalg.norm(dq[:3])), float(np.linalg.norm(t_est - t_gt))


def voxel_filter(points: np.ndarray, colors: Optional[np.ndarray],
                 leaf: float = 0.01):
    """PCL VoxelGrid equivalent: average position (and color) per occupied
    leaf (the 1 cm prefilter of src/test_gp_accuracy.cpp:126-129)."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(axis=0)
    keys = np.floor((pts - lo) / leaf).astype(np.int64)
    dims = keys.max(axis=0) + 1
    lin = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    uniq, inv = np.unique(lin, return_inverse=True)
    cnt = np.bincount(inv).astype(np.float64)
    out = np.stack([np.bincount(inv, pts[:, d]) for d in range(3)],
                   axis=1) / cnt[:, None]
    if colors is None:
        return out.astype(points.dtype), None
    cols = np.asarray(colors, np.float64)
    outc = np.stack([np.bincount(inv, cols[:, d]) for d in range(3)],
                    axis=1) / cnt[:, None]
    return out.astype(points.dtype), outc.astype(colors.dtype)


def make_fixture(dirname: str, n_frames: int = 4, n_points: int = 3000,
                 seed: int = 0):
    """Generate a tiny TUM-format dataset (pointclouds/*.pcd +
    groundtruth.txt) from the synthetic room with a known smooth camera
    trajectory — the in-repo stand-in for rgbd_dataset_freiburg1_room so
    the real-data eval path is testable without external downloads.
    Returns (dirname, list of (R, t) world poses per frame)."""
    from gp_compressor_jax.geometry import rotation as rot_mod
    from gp_compressor_jax.io import pcd
    from gp_compressor_jax.utils import synthetic

    os.makedirs(os.path.join(dirname, "pointclouds"), exist_ok=True)
    pts, cols = synthetic.room_cloud(n=n_points, seed=seed)
    rng = np.random.default_rng(seed)
    base_t = 1305031910.0
    lines = ["# ground truth trajectory",
             "# file: synthetic fixture", "# timestamp tx ty tz qx qy qz qw"]
    poses = []
    for k in range(n_frames):
        ang = 0.01 * k * np.asarray([0.3, -0.2, 0.5])
        cx, sx = np.cos(ang), np.sin(ang)
        Rx = np.asarray([[1, 0, 0], [0, cx[0], -sx[0]], [0, sx[0], cx[0]]])
        Ry = np.asarray([[cx[1], 0, sx[1]], [0, 1, 0], [-sx[1], 0, cx[1]]])
        Rz = np.asarray([[cx[2], -sx[2], 0], [sx[2], cx[2], 0], [0, 0, 1]])
        R = Rx @ Ry @ Rz
        t = 0.02 * k * np.asarray([1.0, -0.5, 0.25])
        poses.append((R, t))
        # the scan as seen from this pose: world -> camera frame
        scan = (pts - t) @ R
        scan = scan + 0.002 * rng.standard_normal(scan.shape)
        stamp = base_t + 0.9 * k
        pcd.write(os.path.join(dirname, "pointclouds", f"{stamp:.6f}.pcd"),
                  scan.astype(np.float32), cols)
        q = np.asarray(rot_mod.matrix_to_quaternion(R))
        lines.append(f"{stamp:.6f} {t[0]} {t[1]} {t[2]} "
                     f"{q[0]} {q[1]} {q[2]} {q[3]}")
    with open(os.path.join(dirname, "groundtruth.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return dirname, poses
