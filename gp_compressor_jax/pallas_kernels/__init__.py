from gp_compressor_jax.pallas_kernels import sogp_train  # noqa: F401
