"""gp_compressor_jax — a probabilistic point-cloud inference engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
nilsbore/gp_compressor (the C++ reference, see SURVEY.md): sparse Gaussian-process patch
regression over voxel-partitioned colored point clouds (RBF kernels,
Gaussian / probit noise) powering

  * compression / decompression      (reference: src/gp_compressor.cpp)
  * K-SVD + OMP dictionary coding    (reference: src/ksvd_decomposition.cpp)
  * GP-gradient scan registration    (reference: src/gp_registration.cpp)
  * online incremental mapping       (reference: src/gp_mapping.cpp)

plus a Bayesian layer the reference lacks: HMC/NUTS and VI over kernel
hyperparameters and SMC over scan poses, sharded across a device mesh.

Design: every patch GP is a capacity-padded, mask-active state record
(`models.sparse_gp.SOGPState`) updated by pure functions under `lax.scan`,
`vmap`-ed over thousands of patches and sharded over `jax.sharding.Mesh`
axes. The octree is replaced by static voxel binning + 27-neighborhood
gathers; all hot paths are batched array programs, with a Pallas (Triton)
kernel where XLA's code moves too many bytes: the SOGP training loop, which
keeps each patch's state on-chip for the whole point stream
(pallas_kernels.sogp_train).
"""

__version__ = "0.1.0"

from gp_compressor_jax import config  # noqa: F401
