"""Patch plane rotations.

Reference: gp_compressor::compute_rotation (src/gp_compressor.cpp:29-64)
fits a total-least-squares plane through the homogeneous coordinates of a
patch's sphere points via thin SVD, takes the smallest right singular
vector's first three components as the normal, flips it toward its dominant
axis and builds a right-handed frame whose *first* column is the normal
(depth axis) using an axis-aligned cross-product convention.

Batched form: the per-patch m x 4 SVD becomes a batched 4x4 symmetric
eigendecomposition of the accumulated second-moment matrix
M = sum_h h h^T (h = [x, y, z, 1]) — the smallest eigenvector of M equals
the smallest right singular vector of the stacked homogeneous matrix, and
segment-summed M matrices let thousands of patches solve at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def frame_from_normal(normal: jnp.ndarray) -> jnp.ndarray:
    """Build the reference's rotation matrix from a plane normal. [3] -> [3,3].

    Columns: R[:,0] = normal (flipped positive along its dominant axis),
    R[:,1] = unit(axis x normal) where axis is z/x/y for dominant x/y/z,
    R[:,2] = normal x R[:,1]  (src/gp_compressor.cpp:38-63).
    """
    a = jnp.abs(normal)
    # dominant axis: 0, 1 or 2 (ties broken toward z like the C++ else-chain)
    dom = jnp.where((a[0] > a[1]) & (a[0] > a[2]), 0,
                    jnp.where((a[1] > a[0]) & (a[1] > a[2]), 1, 2))
    sign = jnp.where(normal[dom] < 0, -1.0, 1.0)
    n = normal * sign
    basis = jnp.stack([
        jnp.array([0.0, 0.0, 1.0], dtype=normal.dtype),   # dom=x -> cross with z
        jnp.array([1.0, 0.0, 0.0], dtype=normal.dtype),   # dom=y -> cross with x
        jnp.array([0.0, 1.0, 0.0], dtype=normal.dtype),   # dom=z -> cross with y
    ])
    axis = basis[dom]
    c1 = jnp.cross(axis, n)
    c1 = c1 / jnp.linalg.norm(c1)
    c2 = jnp.cross(n, c1)
    return jnp.stack([n, c1, c2], axis=-1)


def jacobi_eigh_batch(M: jnp.ndarray, sweeps: int = 5):
    """Batched symmetric eigendecomposition of tiny [B, n, n] matrices by
    cyclic Jacobi rotations — pure elementwise vector math with a fixed
    sweep count, instead of jnp.linalg.eigh's iterative solver, for
    n = 4.

    Returns (w [B, n] ascending, V [B, n, n] with columns as eigenvectors).
    Quadratic convergence: `sweeps`=5 reaches f32 machine precision for
    n <= 4 (validated against jnp.linalg.eigh in tests/test_patches.py).
    """
    Bb, n, _ = M.shape
    dt = M.dtype
    # normalize scale so the a_pq ~ 0 guard has an absolute threshold
    scale = jnp.maximum(jnp.max(jnp.abs(M), axis=(1, 2), keepdims=True),
                        jnp.asarray(1e-30, dt))
    A = M / scale
    V = jnp.broadcast_to(jnp.eye(n, dtype=dt), (Bb, n, n))
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = A[:, p, q]
                app = A[:, p, p]
                aqq = A[:, q, q]
                small = jnp.abs(apq) <= 1e-12
                theta = (aqq - app) / (2.0 * jnp.where(small, 1.0, apq))
                t = jnp.sign(theta) / (jnp.abs(theta)
                                       + jnp.sqrt(1.0 + theta * theta))
                t = jnp.where(theta == 0, 1.0, t)
                c = 1.0 / jnp.sqrt(1.0 + t * t)
                s = jnp.where(small, 0.0, t * c)
                c = jnp.where(small, 1.0, c)
                # G = I with G[p,p]=G[q,q]=c, G[p,q]=s, G[q,p]=-s
                # (annihilates A'[p,q] in A' = G^T A G). Applied as explicit
                # row/column mixes — pure elementwise [B, n] vector math the
                # compiler fuses across the whole sweep chain, instead of
                # ~90 tiny batched [B, 4, 4] matmuls; elementwise f32 also
                # never touches a reduced-precision matmul path (TF32), so
                # no precision= is needed.
                cc, sc = c[:, None], s[:, None]
                Acp, Acq = A[:, :, p], A[:, :, q]
                A = A.at[:, :, p].set(cc * Acp - sc * Acq)
                A = A.at[:, :, q].set(sc * Acp + cc * Acq)
                Arp, Arq = A[:, p, :], A[:, q, :]
                A = A.at[:, p, :].set(cc * Arp - sc * Arq)
                A = A.at[:, q, :].set(sc * Arp + cc * Arq)
                Vcp, Vcq = V[:, :, p], V[:, :, q]
                V = V.at[:, :, p].set(cc * Vcp - sc * Vcq)
                V = V.at[:, :, q].set(sc * Vcp + cc * Vcq)
    w = jnp.diagonal(A, axis1=1, axis2=2) * scale[:, :, 0]
    order = jnp.argsort(w, axis=1)
    w = jnp.take_along_axis(w, order, axis=1)
    V = jnp.take_along_axis(V, order[:, None, :], axis=2)
    return w, V


def rotation_from_moment(M: jnp.ndarray, npoints: jnp.ndarray,
                         min_points: int = 4) -> jnp.ndarray:
    """Patch frame from the 4x4 homogeneous second-moment matrix.

    M: [4, 4] = sum over sphere points of [x,y,z,1][x,y,z,1]^T; npoints the
    count. Below `min_points` the reference returns identity
    (src/gp_compressor.cpp:31-34).
    """
    # smallest eigenvector of symmetric M == smallest right singular vector
    # of the stacked [n, 4] homogeneous point matrix (same Gram).
    w, V = jnp.linalg.eigh(M)
    plane = V[:, 0]                      # eigenvalues ascending
    normal = plane[:3]
    norm = jnp.linalg.norm(normal)
    normal = normal / jnp.where(norm > 0, norm, 1.0)
    R = frame_from_normal(normal)
    eye = jnp.eye(3, dtype=M.dtype)
    bad = (npoints < min_points) | (norm <= 0)
    return jnp.where(bad, eye, R)


def _finish_rotation(plane, npoints, min_points, dt):
    normal = plane[:3]
    norm = jnp.linalg.norm(normal)
    normal = normal / jnp.where(norm > 0, norm, 1.0)
    R = frame_from_normal(normal)
    eye = jnp.eye(3, dtype=dt)
    bad = (npoints < min_points) | (norm <= 0)
    return jnp.where(bad, eye, R)


def rotation_from_moment_batch(M: jnp.ndarray, npoints: jnp.ndarray,
                               min_points: int = 4) -> jnp.ndarray:
    """[B, 4, 4] moments -> [B, 3, 3] frames via the batched Jacobi solver."""
    _, V = jacobi_eigh_batch(M)
    return jax.vmap(_finish_rotation, in_axes=(0, 0, None, None))(
        V[:, :, 0], npoints, min_points, M.dtype)


def matrix_to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w) — Eigen coeffs() order used
    by the artifact format (src/dictionary_representation.cpp:197-202).
    Branch-free Shepperd-style construction, safe under jit."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    # four candidate constructions; pick the numerically largest pivot
    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                    1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22])
    case = jnp.argmax(qw)
    s = jnp.sqrt(jnp.maximum(qw[case], 1e-12)) * 2.0

    q0 = jnp.array([(m21 - m12), (m02 - m20), (m10 - m01), qw[0]]) / s
    q1 = jnp.array([qw[1], (m01 + m10), (m02 + m20), (m21 - m12)]) / s
    q2 = jnp.array([(m01 + m10), qw[2], (m12 + m21), (m02 - m20)]) / s
    q3 = jnp.array([(m02 + m20), (m12 + m21), qw[3], (m10 - m01)]) / s
    q = jnp.stack([q0, q1, q2, q3])[case]
    return q / jnp.linalg.norm(q)


def quaternion_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > 0, 2.0 / n, 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])
