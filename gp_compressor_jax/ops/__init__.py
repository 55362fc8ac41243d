from gp_compressor_jax.ops import kernels, noise  # noqa: F401
