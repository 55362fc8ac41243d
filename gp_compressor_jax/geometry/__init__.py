from gp_compressor_jax.geometry import patches, rotation, transforms, voxel  # noqa: F401
