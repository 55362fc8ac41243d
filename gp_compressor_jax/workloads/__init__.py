from gp_compressor_jax.workloads import compressor  # noqa: F401
