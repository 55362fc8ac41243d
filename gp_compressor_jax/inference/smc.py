"""Sequential Monte Carlo over scan poses — a new capability for mapping.

The reference's gp_mapping trusts a single gradient-ascent pose per scan
(src/gp_mapping.cpp:18-27). Here a particle population over 6-DoF pose
perturbations is weighted by the map's GP data likelihood, resampled
systematically when the effective sample size collapses, and jittered by a
random-walk proposal. Particles carry only 6 numbers, so the particle axis
`vmap`s trivially; the weight normalization and ESS are plain reductions
over it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from gp_compressor_jax.config import SMCConfig
from gp_compressor_jax.geometry import transforms


class ParticleState(NamedTuple):
    poses: jnp.ndarray       # [P, 6] (t, rotvec) perturbations
    log_weights: jnp.ndarray  # [P]


def init_particles(cfg: SMCConfig, key: jax.Array,
                   dtype=jnp.float32) -> ParticleState:
    P = cfg.num_particles
    kt, kr = jax.random.split(key)
    t = cfg.pose_proposal_std_t * jax.random.normal(kt, (P, 3), dtype)
    r = cfg.pose_proposal_std_r * jax.random.normal(kr, (P, 3), dtype)
    poses = jnp.concatenate([t, r], axis=-1)
    poses = poses.at[0].set(0.0)        # keep the identity hypothesis
    return ParticleState(poses=poses,
                         log_weights=jnp.zeros((P,), dtype))


def pose_matrices(poses: jnp.ndarray):
    """[P, 6] -> (R [P, 3, 3], t [P, 3]) via the small-angle Euler
    composition the registration step uses (transforms.euler_xyz)."""
    R = jax.vmap(transforms.euler_xyz)(poses[:, 3:])
    return R, poses[:, :3]


def ess(log_weights: jnp.ndarray) -> jnp.ndarray:
    w = jax.nn.softmax(log_weights)
    return 1.0 / jnp.sum(w * w)


def systematic_resample(state: ParticleState, key: jax.Array) -> ParticleState:
    """Systematic resampling; the cumulative-weight inversion is a vector
    searchsorted, collective-friendly when particles shard."""
    P = state.poses.shape[0]
    w = jax.nn.softmax(state.log_weights)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / P)
    u = u0 + jnp.arange(P) / P
    idx = jnp.searchsorted(cum, u)
    idx = jnp.clip(idx, 0, P - 1)
    return ParticleState(poses=state.poses[idx],
                         log_weights=jnp.zeros_like(state.log_weights))


def smc_step(state: ParticleState, loglik_fn: Callable[[jnp.ndarray], jnp.ndarray],
             cfg: SMCConfig, key: jax.Array) -> Tuple[ParticleState, jnp.ndarray]:
    """One SMC iteration: jitter -> reweight -> maybe resample.

    loglik_fn: [P, 6] poses -> [P] data log likelihoods (e.g. the mean GP
    log-density of the scan under each hypothesized pose).
    Returns (state, weighted-mean pose).
    """
    kj, kr = jax.random.split(key)
    jit_t = cfg.pose_proposal_std_t * jax.random.normal(
        kj, state.poses[:, :3].shape, state.poses.dtype)
    kj2 = jax.random.fold_in(kj, 1)
    jit_r = cfg.pose_proposal_std_r * jax.random.normal(
        kj2, state.poses[:, 3:].shape, state.poses.dtype)
    poses = state.poses + jnp.concatenate([jit_t, jit_r], axis=-1)
    poses = poses.at[0].set(state.poses[0])       # elitist identity track

    ll = loglik_fn(poses)
    logw = state.log_weights + ll
    logw = logw - jax.scipy.special.logsumexp(logw)
    st = ParticleState(poses=poses, log_weights=logw)

    P = poses.shape[0]
    do_resample = ess(logw) < cfg.ess_threshold * P
    resampled = systematic_resample(st, kr)
    st = jax.tree.map(lambda a, b: jnp.where(do_resample, a, b), resampled, st)

    w = jax.nn.softmax(st.log_weights)
    mean_pose = jnp.sum(w[:, None] * st.poses, axis=0)
    return st, mean_pose
