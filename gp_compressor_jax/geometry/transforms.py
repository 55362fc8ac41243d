"""Rigid-body transform helpers for registration and mapping.

Reference: gp_registration's small-angle gradient step builds
R = Rx(step d3) Ry(step d4) Rz(step d5), t = step d0:3
(src/gp_registration.cpp:51-58) and chains per-point gradients through the
6-DoF twist Jacobian J = [I | -[x]_x] (src/gp_registration.cpp:40-49).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# EVERY matmul here runs at HIGHEST precision. A GPU's default f32 dot may
# run in TF32 (10-bit mantissa): `points @ R.T` at that precision
# quantizes metre-scale coordinates to ~1 mm, a noise floor under
# mm-scale registration, and every 3x3 rotation composition injects
# ~1e-3 rad of orientation noise (a bf16 default, measured, put a 9 mm
# floor under registration). These are O(N*9) FLOP ops — full precision
# costs nothing.
_HI = jax.lax.Precision.HIGHEST


def rot_x(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rot_z(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def euler_xyz(angles):
    """R = Rx(a0) Ry(a1) Rz(a2) — the reference's composition order
    (src/gp_registration.cpp:53-56)."""
    return matmul3(matmul3(rot_x(angles[0]), rot_y(angles[1])),
                   rot_z(angles[2]))


def matmul3(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """3x3 (or batched) rotation composition at full f32 precision."""
    return jnp.matmul(A, B, precision=_HI)


def transform_jacobian(x: jnp.ndarray) -> jnp.ndarray:
    """J(x) = [ I_3 | -[x]_x ] as a [3, 6]: d(R x + t)/d(t, omega) at
    identity — matches get_transform_jacobian's explicit entries
    (src/gp_registration.cpp:40-49: J[0,4]=x2, J[0,5]=-x1, J[1,3]=-x2,
    J[1,5]=x0, J[2,3]=x1, J[2,4]=-x0)."""
    z = jnp.zeros((), x.dtype)
    return jnp.array([
        [1.0, 0.0, 0.0, z, x[2], -x[1]],
        [0.0, 1.0, 0.0, -x[2], z, x[0]],
        [0.0, 0.0, 1.0, x[1], -x[0], z],
    ])


def apply(points: jnp.ndarray, R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """p -> R p + t for [N, 3] (gp_registration::transform_pointcloud,
    src/gp_registration.cpp:24-38)."""
    return jnp.matmul(points, R.T, precision=_HI) + t


def rotation_angle(R: jnp.ndarray):
    """Geodesic angle of a rotation matrix (registration error metric)."""
    c = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return jnp.arccos(c)
