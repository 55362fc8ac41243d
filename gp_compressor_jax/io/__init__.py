from gp_compressor_jax.io import artifact, pcd  # noqa: F401
