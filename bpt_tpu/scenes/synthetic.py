"""Seed-generated meshes for benchmarks, smoke runs and tests.

They need no asset on disk: the same arguments give the same triangles.
"""

from __future__ import annotations

import numpy as np

from bpt_tpu.io.gltf import GLTFModel

# The reference's 2048^2 vertex data texture holds at most 524,288 triangles
# (GLTF_Model_Path_Tracing.js:291-295); a 512^2 grid of quads hits the cap.
CAPACITY_SIDE = 512


def heightfield_model(n_side: int = CAPACITY_SIDE, rugged: bool = False,
                      seed: int = 3) -> GLTFModel:
    """2 * n_side^2 triangles of a sinusoidal height field under the glTF
    demo camera; ``rugged`` adds multi-octave displacement and per-vertex
    jitter from ``seed`` (triangle sizes and orientations then vary wildly)."""
    xs = np.linspace(-45, 45, n_side + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = -20.0 + 4.0 * np.sin(X * 0.4) * np.cos(Z * 0.3)
    if rugged:
        rng = np.random.default_rng(seed)
        Y = Y + 2.0 * np.sin(X * 2.3 + Z * 1.7) * np.cos(Z * 2.9) \
              + 0.8 * np.sin(X * 9.1) * np.sin(Z * 8.3) \
              + rng.normal(0, 0.35, Y.shape)
        X = X + rng.normal(0, 0.03, X.shape)
        Z = Z + rng.normal(0, 0.03, Z.shape)
    P = np.stack([X, Y, Z], -1).astype(np.float32)
    a = P[:-1, :-1].reshape(-1, 3)
    b = P[1:, :-1].reshape(-1, 3)
    c = P[1:, 1:].reshape(-1, 3)
    d = P[:-1, 1:].reshape(-1, 3)
    p0 = np.concatenate([a, a])
    p1 = np.concatenate([c, d])
    p2 = np.concatenate([b, c])
    n = np.cross(p1 - p0, p2 - p0)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    z2 = np.zeros((len(p0), 2), np.float32)
    return GLTFModel(p0=p0, p1=p1, p2=p2, n0=n, n1=n, n2=n, uv0=z2, uv1=z2,
                     uv2=z2, albedo=None, normal_map=None,
                     metallic_roughness=None, emissive=None)


def textured_blob_model(n_tris: int = 24, seed: int = 0, tex_size: int = 16) -> GLTFModel:
    """A blob of random triangles with random UVs, a random albedo map and a
    diffuse metallic-roughness map — the textured-PBR family at a size that
    covers many pixels under the glTF demo camera."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 18, (n_tris, 1, 3)).astype(np.float32)
    tri = (c + rng.normal(0, 9, (n_tris, 3, 3))).astype(np.float32)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True) + 1e-9
    uv = rng.uniform(0, 1, (n_tris, 3, 2)).astype(np.float32)
    albedo = rng.uniform(0.2, 0.9, (tex_size, tex_size, 3)).astype(np.float32)
    mr = np.zeros((8, 8, 3), np.float32)
    return GLTFModel(p0=tri[:, 0], p1=tri[:, 1], p2=tri[:, 2], n0=nrm,
                     n1=nrm, n2=nrm, uv0=uv[:, 0], uv1=uv[:, 1],
                     uv2=uv[:, 2], albedo=albedo, normal_map=None,
                     metallic_roughness=mr, emissive=None)
