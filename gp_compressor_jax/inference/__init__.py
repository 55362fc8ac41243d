from gp_compressor_jax.inference import hmc, smc, vi  # noqa: F401
