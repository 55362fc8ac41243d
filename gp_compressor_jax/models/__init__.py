from gp_compressor_jax.models import exact_gp, sparse_gp  # noqa: F401
