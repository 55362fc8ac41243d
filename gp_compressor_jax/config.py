"""Typed configuration tree for the whole framework.

The reference has no config system — constructor defaults and magic numbers
(reference: src/gp_compressor.h:65, src/sparse_gp.h:48, src/rbf_kernel.h:24,
src/gp_registration.cpp:10, src/gp_mapping.cpp:7). Here every tunable lives
in one dataclass tree so that workloads, tests and benchmarks share a single
source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Sparse-GP engine configuration.

    Defaults mirror the reference: capacity=100, s20=1e-1
    (src/sparse_gp.h:48), RBF params (sigmaf_sq, l_sq) = (100, 1)
    (src/rbf_kernel.h:24), eps_tol=1e-6 (src/sparse_gp.hpp:30).
    The RGB field GP uses s20=1e2 and eps_tol=1e-4
    (src/sparse_gp_field.h:43, src/sparse_gp_field.hpp:16).
    """

    capacity: int = 100          # max number of retained basis vectors
    slots: int = 128             # padded state size; must be >= capacity + 1.
                                 # a power of two keeps the fused training
                                 # kernel's [slots, slots] blocks legal.
    dim: int = 2                 # input dimension (u, v in the patch plane)
    dout: int = 1                # output dimension (1 = depth, 3 = RGB)
    sigmaf_sq: float = 100.0     # RBF signal variance
    l_sq: float = 1.0            # RBF squared lengthscale
    s20: float = 1e-1            # observation noise variance
    eps_tol: float = 1e-6        # novelty threshold: gamma below => sparse update
    novelty_mode: str = "gamma"
    # "gamma": the reference's novelty test gamma >= eps_tol
    #   (src/sparse_gp.hpp:155). At its constants (sigma_f^2=100, l=1 m on
    #   0.15 m patches) gamma cancels ~7 decimal digits, so f32 must hold
    #   eps_tol ~2.0 and admits only ~1 BV/patch (r3 headline: RMSE 0.0208
    #   vs 0.015 f64).
    # "geometric": conditioning-FREE streaming novelty — admit a point as
    #   a basis vector iff it lies at least geom_dmin from every current
    #   BV (equivalently max_i k_i < sigma_f^2 exp(-dmin^2/2 l^2), pure
    #   values the update already computes) and the patch holds fewer than
    #   geom_max_bv BVs; all other points get the usual sparse projection.
    #   This is greedy farthest-point basis selection in streaming form:
    #   exactly the points f64's gamma test admits at these constants, but
    #   computed without the catastrophic cancellation (measured: forced
    #   2-point geometric bases reach f64-level RMSE in f32). eps_tol is
    #   ignored in this mode.
    geom_dmin: float = 0.05      # [m] minimum BV separation ("geometric")
    geom_max_bv: int = 3         # BV budget per patch ("geometric")
    geom_gamma_min_rel: float = 1e-2
    # Admission sanity floor: a geometric admit additionally requires the
    # measured gamma > geom_gamma_min_rel * sigma_f^2. The true gamma of a
    # k-th well-separated BV shrinks like sigma_f^2 (d^2/2l^2)^(k-1); an
    # admit whose gamma sits near the f32 evaluation error of the
    # k^T Q k cancellation makes the ONGOING C/Q recursion drift
    # unboundedly (measured on uniform 0.15 m patches at the reference
    # constants: floor 1e-4 -> 26/130 patches NaN, 3e-3 -> 5, 1e-2 -> 0
    # with mean_bv 2.45). The floor makes the mode self-limiting: it
    # admits exactly as many BVs as the f32 recursion can carry at the
    # operating hyperparameters.
    gamma_tiny: float = 1e-12    # numerical floor (src/sparse_gp.hpp:146)
    geom_tol: float = 1e-9       # geometric deletion threshold (src/sparse_gp.hpp:228)
    max_geometric_deletes: int = 2  # per added point (reference loops unboundedly;
                                    # >1 per point is pathological in practice)
    dtype: jnp.dtype = jnp.float32

    def __post_init__(self):
        assert self.slots >= self.capacity + 1, "slots must fit capacity+1 BVs"


def rgb_gp_config(slots: int = 128, capacity: int = 100,
                  dtype: jnp.dtype = jnp.float32) -> GPConfig:
    """Field-GP (RGB) defaults, reference src/sparse_gp_field.h:43."""
    return GPConfig(capacity=capacity, slots=slots, dout=3, s20=1e2,
                    eps_tol=1e-4, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Voxel-patching front end (octree replacement).

    `res`/`sz` defaults follow test_gp_compress (src/test_gp_compress.cpp:21).
    `max_patches` and `max_points_per_patch` are static padding bounds —
    a fixed-shape concept with no reference counterpart (the octree grows
    dynamically there).
    """

    res: float = 0.15            # voxel edge length [m]
    sz: int = 20                 # patch grid resolution (sz x sz predictions)
    max_patches: int = 1024      # static bound on number of leaves
    max_points_per_patch: int = 512  # static bound on claimed points per leaf
    min_points_for_rotation: int = 4  # below: identity rotation (gp_compressor.cpp:31)
    max_cells: int = 1 << 20
    # static budget for the dense voxel-key -> leaf lookup table (O(1)
    # gathers instead of searchsorted); 0 disables it
    approx_sphere_moments: bool = False
    # True: plane fits use all points of the 27-voxel neighbourhood instead
    # of the exact radius-filtered sphere (src/gp_compressor.cpp:220) —
    # one scatter-add over points plus a per-leaf neighbour gather instead
    # of 27 scatter passes — far less front-end work, with a slightly
    # wider support for the (already statistical) plane fit.
    bank_order: str = "shuffle"
    # In-bank (= online insertion) point order. "shuffle" reproduces the
    # reference's shuffle-before-insert (src/sparse_gp.hpp:43-56) — but at
    # the reference constants only 1-2 points per patch pass the f32
    # novelty floor, so WHICH points the shuffle feeds first decides the
    # output (measured RMSE spread 0.021-0.041 across keys). The
    # deterministic orders make BV selection reproducible:
    #   "native"     — claim-sorted original point order
    #   "center_out" — ascending (u^2+v^2): most central point first
    #   "edge_in"    — descending (u^2+v^2): patch corners first
    # PARITY.md divergence: deterministic order replaces the shuffle.


@dataclasses.dataclass(frozen=True)
class KSVDConfig:
    """Dictionary codec. Defaults = the DEPTH pipeline of the test_compress
    demo (src/test_compress.cpp:18): res .15, sz 20, dict 200, words 10,
    proj_error 5e-3, stop_diff 1e-5. The RGB pipeline's constants differ by
    SEVEN orders of magnitude (rgb_ksvd_config below) because color
    residuals live at 0-255 scale — using the depth constants for RGB makes
    the stop criterion unreachable (rgb_iters pinned at max_iters)."""

    dict_size: int = 200
    words_max: int = 10
    proj_error: float = 5e-3     # residual^2 stop for OMP
    stop_diff: float = 1e-5      # K-SVD outer-loop stopping criterion
    max_iters: int = 30          # static bound on K-SVD outer iterations
    power_iters: int = 20        # NIPALS iterations (ksvd_decomposition.cpp:70)
    power_threshold: float = 0.01
    atom_block: int = 1
    # Atoms updated per dictionary-sweep step. 1 reproduces the reference's
    # pure Gauss-Seidel atom order (src/ksvd_decomposition.cpp:93); > 1
    # updates each block of atoms Jacobi-style against the block-start
    # residual (the standard approximate-K-SVD parallelization — atoms
    # rarely share users at words_max << dict_size, so the within-block
    # coupling is weak). The sweep's wall cost is sequential-step latency,
    # not FLOPs: block 16 cuts a 600-atom sweep from 600 to 38 scan steps.
    exact_gram_diag: bool = False
    # False reproduces the reference's "assuming ||x_k+1|| = 1" unit-diagonal
    # masked Gram (src/orthogonal_matching_pursuit.cpp:86), which biases
    # coefficients when many cells are masked; True uses the true masked
    # atom norms (the exact masked least-squares solve).


def rgb_ksvd_config(dict_size: int = 600, words_max: int = 20) -> KSVDConfig:
    """RGB-pipeline K-SVD constants of the test_compress demo
    (src/test_compress.cpp:18): proj_error 5e4, stop_diff 1e3 — scaled to
    0-255 color residuals (a 20x20 patch with ~10 RMS color residual per
    channel has masked residual^2 ~ 1e4-1e5)."""
    return KSVDConfig(dict_size=dict_size, words_max=words_max,
                      proj_error=5e4, stop_diff=1e3)


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """GP-gradient registration. Defaults: src/gp_registration.cpp:10,67-71."""

    step: float = 1e-1
    max_steps: int = 300
    min_steps: int = 10
    grad_tol: float = 0.1        # convergence: |dt|<tol and |dr|<tol
    grad_tol_step_ref: Optional[float] = None
    # The reference calibrated grad_tol=0.1 FOR step=0.1
    # (src/gp_registration.cpp:10,69): the pair fixes where on the
    # gradient-decay curve the ascent stops. Running a smaller step with
    # the same absolute tolerance stops the loop proportionally earlier in
    # MOTION terms (step=0.005 at tol=0.1 removed only 39% of the injected
    # error). Setting grad_tol_step_ref makes the loop
    # use the effective tolerance grad_tol * step / grad_tol_step_ref —
    # i.e. the threshold the reference pairing implies for the chosen step.
    # None (default) keeps grad_tol absolute: mapping treats a
    # hit-the-step-cap registration as a dropped scan
    # (src/gp_mapping.cpp:22-27), so a scaled tolerance there would turn
    # routine near-converged polishing runs into "divergence".
    color_blend: float = 1.0     # alpha: 1 => depth-only gradient (gp_registration.cpp:198)
    blend_mode: str = "alpha"
    # "alpha": the compiled-in constant blend above.
    # "likelihood": the reference's COMPUTE_LIKELIHOOD variant
    # (src/gp_registration.cpp:191-196) — per-point cross-weighting
    # dX = l * dCX + cl * dX (the depth likelihood weights the COLOR
    # gradient and vice versa, exactly as written upstream).
    max_motion: Optional[float] = None
    # Per-step motion cap: rescale step*delta so the translation norm (m)
    # and rotation-vector norm (rad) each stay <= max_motion. The raw
    # density-gradient magnitude has no natural units (it scales with the
    # GP's predictive variance), so a fixed step is only stable in a
    # narrow window — measured at bench scale, step 0.02 diverged to 40x
    # the initial error while step 0.005 crawled. The cap makes the
    # iteration a trust region: direction from the reference's gradient
    # (src/gp_registration.cpp:214-215), length bounded. None = reference
    # behavior.
    # Re-run the scan->map claims pass every k-th gradient step. The
    # reference re-bins every step (k=1); between re-claims, banked points
    # ride the accumulated transform and are merely re-clipped against
    # their claiming patch, so per-step motion (~step * gradient, mm scale)
    # cannot silently leave stale assignments for long. The claims pass is
    # ~95% of a step's device time (PARITY.md divergence 10).
    reclaim_every: int = 4
    step_mode: str = "fixed"
    # "fixed": the reference's constant-step gradient ascent
    # (src/gp_registration.cpp:214-215) with the optional max_motion trust
    # region above.
    # "rprop": sign-based iRprop- per-twist-axis steps. The density
    # gradient's magnitude spans ~200x between the reference-constant and
    # the calibrated (sharp, l~4 cm) fields, so any fixed step either
    # crawls or ping-pongs at the trust-region radius (measured at bench
    # scale: cap 0.002 oscillates +-2 mm forever around an optimum it
    # reached in 2 steps). iRprop- carries a per-axis motion size eta[6]
    # (init rprop_eta0, clipped to [rprop_eta_min, rprop_eta_max]),
    # moves eta*sign(delta), grows eta by 1.2 while the gradient sign
    # holds, halves it and skips the axis on a sign flip. Scale-free in
    # the gradient magnitude; converges geometrically once inside the
    # basin. Stops when every eta < rprop_tol (a motion tolerance in
    # m/rad — scale-free counterpart of the reference's grad_tol).
    rprop_eta0: float = 1e-3
    rprop_eta_min: float = 1e-6
    rprop_eta_max: float = 4e-3
    rprop_tol: float = 2e-5
    bank_points: Optional[int] = None
    # Per-patch registration bank capacity override. The gradient step's
    # cost is O(max_patches * bank_points) BANK SLOTS regardless of scan
    # size; mapping's per-scan polish registers a strided scan subsample
    # (MappingConfig.reg_stride), so its banks can be proportionally
    # smaller. None = the compressor's max_points_per_patch.


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    min_points_new_patch: int = 100   # min_nbr (src/gp_mapping.cpp:7)
    max_ray_steps: int = 64           # static bound on voxel ray traversal
    carve_stride: int = 1
    # Free-space carving traces every k-th scan ray (reference: every point,
    # src/gp_mapping.cpp:160). The DDA walk's per-step cost is O(N_rays)
    # (one [N] scatter-max per voxel step), and free-space evidence is
    # massively redundant — a 150k-ray scan re-marks each crossed grid cell
    # hundreds of times — so stride 4-8 keeps the free mask statistically
    # identical while cutting the carve's device time by the same factor.
    # 1 reproduces the reference exactly (used by the parity tests).
    drop_on_reg_cap: bool = True
    # The reference drops a scan whose registration hits the step cap
    # (src/gp_mapping.cpp:22-27) — sensible at its 300-step budget, where
    # a cap hit IS pathological. When mapping runs registration with a
    # small per-scan step BUDGET (e.g. max_steps=12 to polish an already
    # tracked stream), a cap hit is routine, and dropping would silently
    # discard most scans (measured: 3 of 4 bench scans dropped, map
    # chamfer RMSE 0.157 m). False = always insert; registration caps act
    # as a compute budget, not a divergence test.
    reg_stride: int = 1
    # Register every k-th scan point (the INSERT still consumes the full
    # scan). The registration delta is a mean over the scan; on a 150k
    # scan a 4x subsample leaves the mean's direction statistically
    # unchanged while shrinking the claims/rebank passes AND (with
    # RegistrationConfig.bank_points) the per-step bank by ~4x. 1 =
    # register the full scan (reference cadence).
    spill_bank: int = 128
    # Width of the overflow training bank: claimed points whose in-patch
    # rank exceeds max_points_per_patch land here instead of being
    # silently dropped (the reference inserts EVERY claimed point,
    # src/gp_mapping.cpp:293-343; r3 dropped 1784/stream; width 64 still
    # dropped 96 at the bench densities — 128 measures zero). The spill
    # train pass is lax.cond-gated, so the steady state (no patch over
    # the main bound) pays nothing. 0 disables (r3 behaviour); points
    # beyond max_points_per_patch + spill_bank are still counted dropped.
    table_update_max: int = 96
    # Static bound on the INCREMENTAL persistent-claim-table update
    # (registration.update_claim_tables): up to this many leaves becoming
    # patches in one insertion are folded in by recomputing only their
    # 27-neighbourhood rows; past it the insert falls back to a full table
    # rebuild, many times the cost — in practice only the first scan.


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """NUTS/HMC over kernel hyperparameters — new capability."""

    num_chains: int = 8
    num_warmup: int = 200
    num_samples: int = 200
    max_tree_depth: int = 8
    target_accept: float = 0.8
    init_step_size: float = 0.1


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    """SMC over scan poses for mapping — new capability."""

    num_particles: int = 64
    ess_threshold: float = 0.5
    pose_proposal_std_t: float = 0.01
    pose_proposal_std_r: float = 0.005


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Patch axis shards over `data`; chains/particles
    over `chain`."""

    data_axis: str = "data"
    chain_axis: str = "chain"
    data_size: Optional[int] = None   # None => all devices on data axis
    chain_size: int = 1


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    patch: PatchConfig = dataclasses.field(default_factory=PatchConfig)
    depth_gp: GPConfig = dataclasses.field(default_factory=GPConfig)
    rgb_gp: GPConfig = dataclasses.field(default_factory=rgb_gp_config)
    ksvd: KSVDConfig = dataclasses.field(default_factory=KSVDConfig)
    rgb_ksvd: KSVDConfig = dataclasses.field(
        default_factory=lambda: rgb_ksvd_config())


def headline_config() -> CompressorConfig:
    """The benchmark's headline deployment (bench.py, chip_smoke.py): the
    test_gp_compress constants res 0.15 / sz 20 (src/test_gp_compress.cpp:21)
    on a Kinect-scale cloud of ~300k points.

    - max_patches 2048: the synthetic bench room bins into 1675 leaves, and
      every bank op scales with the padded bound.
    - eps_tol 2.0, capacity 30, 32 slots: in float32 the novelty
      gamma = k** - k^T Q k carries O(sigma_f^2 * ||Q|| * eps_f32)
      cancellation noise once the BV Gram correlates (0.15 m patches under
      a 1 m length scale with sigma_f^2 = 100), so the threshold sits above
      that floor (2% of k**). Float64 RMSE is essentially unchanged by it —
      the 1 m length scale oversmooths 0.15 m patches whatever the basis —
      and the BV budget tops out well under 32, so the padded state shrinks
      from 128 to 32 slots.
    - bank_order "center_out": at these constants only 1-2 points per patch
      pass the novelty floor, so a shuffled insertion order makes BV
      selection (and RMSE) depend on the key; center-out is deterministic.
    - atom_block 16: Jacobi-within-block K-SVD dictionary sweeps (the sweep
      is latency-bound, see KSVDConfig.atom_block), with the test_compress
      demo's stopping constants per pipeline (src/test_compress.cpp:18).
    """
    return CompressorConfig(
        patch=PatchConfig(res=0.15, sz=20, max_patches=2048,
                          max_points_per_patch=256,
                          approx_sphere_moments=True,
                          bank_order="center_out"),
        depth_gp=GPConfig(capacity=30, slots=32, eps_tol=2.0),
        rgb_gp=dataclasses.replace(rgb_gp_config(slots=32, capacity=30),
                                   eps_tol=2.0),
        ksvd=KSVDConfig(atom_block=16),
        rgb_ksvd=dataclasses.replace(rgb_ksvd_config(), atom_block=16),
    )
