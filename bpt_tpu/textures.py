"""Texture sampling (bilinear, repeat wrap) — the GLSL texture() analog.

Gather-based so XLA lowers it to batched dynamic-gathers from HBM; textures
stay resident on device like the reference's sampler uniforms.
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_bilinear(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample with REPEAT wrap on both axes.

    tex: (H, W, C) with v=0 at row 0 (callers pre-flip if their asset
    convention differs); uv: (..., 2) in [0, 1] (any values; wrapped).
    Returns (..., C).
    """
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0i + 1, h)
    c00 = tex[y0i, x0i]
    c01 = tex[y0i, x1i]
    c10 = tex[y1i, x0i]
    c11 = tex[y1i, x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def quad_pack(tex) -> jnp.ndarray:
    """Pack overlapping 2x2 texel quads: out[y, x] = concat(tex[y, x],
    tex[y, x+1], tex[y+1, x], tex[y+1, x+1]) with REPEAT wrap, giving a
    (H, W, 4C) table where ONE row fetch yields all four bilinear taps.

    Why: one gather of a 4C-wide row replaces four gathers of C-wide rows
    (4x memory for 4x fewer gathers); whether that pays on the GPU is not
    measured yet.

    jnp ops throughout, so packing is differentiable: optimizing a texture
    (inverse rendering) can re-pack per step and gradients flow back
    through the roll/concat to the raw map.
    """
    t = jnp.asarray(tex)
    return jnp.concatenate(
        [t, jnp.roll(t, -1, 1), jnp.roll(t, -1, 0), jnp.roll(jnp.roll(t, -1, 0), -1, 1)],
        axis=-1,
    )


def sample_bilinear_packed(qtex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample from a quad_pack'ed (H, W, 4C) table — one gather per
    sample, arithmetic identical to sample_bilinear (same texels, weights,
    and combine order), so results are bit-equal."""
    h, w = qtex.shape[0], qtex.shape[1]
    c = qtex.shape[2] // 4
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    row = jnp.take(qtex.reshape(h * w, 4 * c), y0i * w + x0i, axis=0)
    c00 = row[..., 0 * c:1 * c]
    c01 = row[..., 1 * c:2 * c]
    c10 = row[..., 2 * c:3 * c]
    c11 = row[..., 3 * c:4 * c]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def sample_mesh_tex(raw, packed, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample preferring the quad-packed table when present."""
    if packed is not None:
        return sample_bilinear_packed(packed, uv)
    return sample_bilinear(raw, uv)


def perturb_normal(n_obj: jnp.ndarray, normal_map: jnp.ndarray, uv: jnp.ndarray,
                   normal_scale=(1.0, 1.0), packed=None) -> jnp.ndarray:
    """Tangent-space normal mapping with an ad-hoc ONB — perturbNormal
    (/root/reference/js/GLTFModelPathTracing_FragmentShader.js:72-92).

    ``n_obj``: (..., 3) *object-space* shading normal (the reference applies
    the perturbation before the world transform, :327-331).  The tangent
    frame is the same cross-trick ONB the samplers use (no UV-derived
    tangents in the reference either).  The reference's ST-flip check is a
    mathematical no-op with this construction — T = cross(N, S) makes
    cross(S, T) == N exactly — so it is omitted.  normal_scale mirrors the
    vec2(1,1) call site (:329).
    """
    import jax.numpy as jnp

    nl = n_obj / jnp.sqrt(jnp.maximum((n_obj * n_obj).sum(-1, keepdims=True), 1e-20))
    up = jnp.where(
        (jnp.abs(nl[..., 1:2]) < 0.9),
        jnp.asarray([0.0, 1.0, 0.0]),
        jnp.asarray([1.0, 0.0, 0.0]),
    )
    s = jnp.cross(up, nl)
    s = s / jnp.sqrt(jnp.maximum((s * s).sum(-1, keepdims=True), 1e-20))
    t = jnp.cross(nl, s)
    map_n = sample_mesh_tex(normal_map, packed, uv)[..., :3] * 2.0 - 1.0
    map_n = map_n / jnp.sqrt(jnp.maximum((map_n * map_n).sum(-1, keepdims=True), 1e-20))
    mx = map_n[..., 0:1] * normal_scale[0]
    my = map_n[..., 1:2] * normal_scale[1]
    mz = map_n[..., 2:3]
    out = s * mx + t * my + nl * mz
    return out / jnp.sqrt(jnp.maximum((out * out).sum(-1, keepdims=True), 1e-20))


def sample_nearest(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor sample with REPEAT wrap (texelFetch-style)."""
    h, w = tex.shape[0], tex.shape[1]
    xi = jnp.mod(jnp.floor(uv[..., 0] * w).astype(jnp.int32), w)
    yi = jnp.mod(jnp.floor(uv[..., 1] * h).astype(jnp.int32), h)
    return tex[yi, xi]
