from gp_compressor_jax.utils import synthetic  # noqa: F401
