from gp_compressor_jax.parallel import mesh  # noqa: F401
