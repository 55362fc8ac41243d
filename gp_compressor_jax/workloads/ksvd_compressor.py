"""K-SVD compression workload (no GPs) — the reference's second pipeline.

Reference: pointcloud_compressor / pointcloud_decompressor
(src/pointcloud_compressor.cpp, src/pointcloud_decompressor.cpp): rasterize
patches to grid images, learn masked dictionaries for depth and stacked RGB
channels via K-SVD, serialize the artifact, and reconstruct by summing the
sparse codes and reprojecting masked cells.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gp_compressor_jax.config import CompressorConfig, KSVDConfig, PatchConfig
from gp_compressor_jax.geometry import patches as patches_mod
from gp_compressor_jax.models import dictionary
from gp_compressor_jax.models.dictionary import KSVDResult, OMPCode


class KSVDCompressed(NamedTuple):
    """The in-memory form of the .pccode/.pcdict artifact (schema:
    src/dictionary_representation.h:12-41)."""

    raster: patches_mod.RasterBatch
    depth: KSVDResult            # dictionary [G, K] + codes over patches
    rgb: KSVDResult              # stacked channels: 3n patch-columns
    cfg: CompressorConfig


def compress(points: jnp.ndarray, colors: jnp.ndarray, valid: jnp.ndarray,
             cfg: CompressorConfig, key: jax.Array,
             verbose: bool = False) -> KSVDCompressed:
    """pointcloud_compressor::save_compressed minus the file write
    (src/pointcloud_compressor.cpp:20-29)."""
    raster = jax.jit(patches_mod.build_raster_patches,
                     static_argnames=("cfg",))(points, colors, valid, cfg.patch)
    B = raster.S.shape[0]
    pvalid = jnp.arange(B) < raster.n_leaves

    kd, kc = jax.random.split(key)
    depth = dictionary.ksvd(raster.S, raster.W.astype(raster.S.dtype),
                            pvalid, cfg.ksvd, kd, verbose=verbose)

    # stacked RGB: 3n patches of length G with replicated masks
    # (compress_colors, src/pointcloud_compressor.cpp:172-180)
    Srgb = jnp.concatenate([raster.RGB[:, :, 0], raster.RGB[:, :, 1],
                            raster.RGB[:, :, 2]], axis=0)
    Wrgb = jnp.concatenate([raster.W] * 3, axis=0).astype(raster.S.dtype)
    vrgb = jnp.concatenate([pvalid] * 3, axis=0)
    rgb = dictionary.ksvd(Srgb, Wrgb, vrgb, cfg.rgb_ksvd, kc, verbose=verbose)
    return KSVDCompressed(raster=raster, depth=depth, rgb=rgb, cfg=cfg)


def decompress(comp: KSVDCompressed):
    """pointcloud_decompressor::load_compressed minus the file read
    (src/pointcloud_decompressor.cpp:15-21,43-118). Returns
    (points [B*G, 3], colors [B*G, 3], valid [B*G])."""
    cfg = comp.cfg
    raster = comp.raster
    B, G = raster.S.shape
    S_rec = dictionary.reconstruct(comp.depth.D, comp.depth.code)      # [B, G]
    RGB_flat = dictionary.reconstruct(comp.rgb.D, comp.rgb.code)       # [3B, G]
    RGB_rec = jnp.stack([RGB_flat[:B], RGB_flat[B:2 * B], RGB_flat[2 * B:]],
                        axis=-1)                                       # [B, G, 3]
    return patches_mod.raster_reproject(raster, S_rec, RGB_rec,
                                        cfg.patch.sz, cfg.patch.res)


def to_artifact(comp: KSVDCompressed):
    """Strip padding and convert to the host-side artifact record
    (schema: src/dictionary_representation.h:12-41)."""
    import numpy as np

    from gp_compressor_jax.geometry import rotation
    from gp_compressor_jax.io.artifact import Artifact

    raster = comp.raster
    n = int(raster.n_leaves)
    B = raster.S.shape[0]
    quats = np.asarray(jax.vmap(rotation.matrix_to_quaternion)(
        raster.rotations[:n]), np.float32)
    rgb_sel = np.concatenate([np.arange(n), B + np.arange(n),
                              2 * B + np.arange(n)])
    return Artifact(
        res=float(comp.cfg.patch.res), sz=comp.cfg.patch.sz,
        D=np.asarray(comp.depth.D, np.float32),
        RGB_D=np.asarray(comp.rgb.D, np.float32),
        words_max=comp.cfg.ksvd.words_max,
        RGB_words_max=comp.cfg.rgb_ksvd.words_max,
        means=np.asarray(raster.means[:n], np.float32),
        quats=quats,
        rgb_means=np.asarray(raster.rgb_means[:n], np.float32),
        X=np.asarray(comp.depth.code.X[:n], np.float32),
        I=np.asarray(comp.depth.code.I[:n], np.int32),
        nw=np.asarray(comp.depth.code.nw[:n], np.int32),
        RGB_X=np.asarray(comp.rgb.code.X, np.float32)[rgb_sel],
        RGB_I=np.asarray(comp.rgb.code.I, np.int32)[rgb_sel],
        RGB_nw=np.asarray(comp.rgb.code.nw, np.int32)[rgb_sel],
        W=np.asarray(raster.W[:n], bool),
    )


def decompress_artifact(art) -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct a cloud from a (possibly file-loaded) artifact — the
    standalone pointcloud_decompressor path, host NumPy (no patch banks
    needed). Returns (points [m, 3], colors [m, 3])."""
    from gp_compressor_jax.geometry import rotation

    n = art.means.shape[0]
    G = art.sz * art.sz
    usek = np.arange(art.words_max)[None, :] < art.nw[:, None]
    S = np.einsum('nk,lnk->nl', art.X * usek, art.D[:, art.I])
    usek3 = np.arange(art.RGB_words_max)[None, :] < art.RGB_nw[:, None]
    RGBf = np.einsum('nk,lnk->nl', art.RGB_X * usek3, art.RGB_D[:, art.RGB_I])
    pts = []
    cols = []
    Rms = np.asarray(jax.vmap(rotation.quaternion_to_matrix)(
        jnp.asarray(art.quats)))
    m = np.arange(G)
    x, y = m // art.sz, m % art.sz
    u = (x + 0.5) * art.res / art.sz - art.res / 2.0
    v = (y + 0.5) * art.res / art.sz - art.res / 2.0
    for i in range(n):
        occ = art.W[i]
        local = np.stack([S[i, occ], u[occ], v[occ]], axis=-1)
        pts.append(local @ Rms[i].T + art.means[i])
        c = np.stack([RGBf[i, occ], RGBf[n + i, occ], RGBf[2 * n + i, occ]],
                     axis=-1) + art.rgb_means[i]
        cols.append(np.clip(c, 0, 255))
    return np.concatenate(pts), np.concatenate(cols)


def rms_error(comp: KSVDCompressed) -> float:
    """In-sample RMS at the projected points vs reconstructed cell values
    (pointcloud_compressor::compute_rms_error,
    src/pointcloud_compressor.cpp:182-205)."""
    raster = comp.raster
    B, G = raster.S.shape
    S_rec = dictionary.reconstruct(comp.depth.D, comp.depth.code)      # [B, G]
    claimed = raster.claims >= 0
    idx = jnp.where(claimed, raster.claims, 0)
    rec = S_rec[idx, raster.cells]
    err2 = jnp.where(claimed, (rec - raster.depth_demeaned) ** 2, 0.0)
    n = jnp.maximum(jnp.sum(claimed), 1)
    return float(jnp.sqrt(jnp.sum(err2) / n))
