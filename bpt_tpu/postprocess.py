"""screenOutput pass: edge-aware denoise → average → Reinhard → gamma.

Vectorized stencil re-implementation of the reference's final shader
(/root/reference/js/PathTracingCommon.js:19-310).  The per-pixel gated
neighbor sums become shifted-array selects over the whole image — a pure
elementwise program that XLA fuses, and the piece that needs halo exchange when
the image is tile-sharded (see bpt_tpu.parallel).

Border behavior: the GLSL texelFetch out-of-bounds result is undefined; we
use edge-clamp (nearest valid pixel), which keeps border averages neutral.
"""

from __future__ import annotations

import jax.numpy as jnp

# The 5x5 "plus-then-diagonal" gated kernel: 8 groups of (gate offset,
# [child offsets]) in the shader's accumulation order
# (PathTracingCommon.js:76-211).  Offsets are (dx, dy) with +y = up.
_GROUPS_5X5 = (
    ((-1, 0), ((-2, 0), (-2, 1))),  # left
    ((1, 0), ((2, 0), (2, -1))),  # right
    ((0, 1), ((0, 2), (1, 2))),  # above
    ((0, -1), ((0, -2), (-1, -2))),  # below
    ((-1, 1), ((-2, 2), (-1, 2))),  # upper-left
    ((1, 1), ((2, 2), (2, 1))),  # upper-right
    ((-1, -1), ((-2, -1), (-2, -2))),  # lower-left
    ((1, -1), ((1, -2), (2, -2))),  # lower-right
)

_OFFSETS_3X3 = ((-1, 0), (1, 0), (0, 1), (0, -1), (-1, 1), (1, 1), (-1, -1), (1, -1))


def _shift(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """Value of the pixel at (x+dx, y+dy), edge-clamped.  img: (H, W, C),
    row 0 = bottom (gl_FragCoord convention), so +dy = +row."""
    padded = jnp.pad(img, ((2, 2), (2, 2), (0, 0)), mode="edge")
    h, w = img.shape[0], img.shape[1]
    return padded[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]


def denoise(accum: jnp.ndarray) -> jnp.ndarray:
    """Edge-aware blur of the (H, W, 4) accumulation buffer → (H, W, 3).

    Pass 1 (all pixels): center + every soft (alpha < 1) neighbor reachable
    through its gate neighbor, averaged (PathTracingCommon.js:76-211).
    Pass 2 (edge pixels, alpha > 0 or == -1): 3x3 gated average blended 50/50
    with the center (:214-290).
    """
    rgb = accum[..., :3]
    alpha = accum[..., 3:4]

    total = rgb
    count = jnp.ones_like(alpha)
    for gate_off, children in _GROUPS_5X5:
        gate_px = _shift(accum, *gate_off)
        gate_ok = gate_px[..., 3:4] < 1.0
        total = total + jnp.where(gate_ok, gate_px[..., :3], 0.0)
        count = count + gate_ok.astype(alpha.dtype)
        for child_off in children:
            child_px = _shift(accum, *child_off)
            child_ok = gate_ok & (child_px[..., 3:4] < 1.0)
            total = total + jnp.where(child_ok, child_px[..., :3], 0.0)
            count = count + child_ok.astype(alpha.dtype)
    filtered = total / count

    total9 = rgb
    count9 = jnp.ones_like(alpha)
    for off in _OFFSETS_3X3:
        px = _shift(accum, *off)
        ok = px[..., 3:4] < 1.0
        total9 = total9 + jnp.where(ok, px[..., :3], 0.0)
        count9 = count9 + ok.astype(alpha.dtype)
    filtered9 = 0.5 * (total9 / count9) + 0.5 * rgb

    is_edge = (alpha > 0.0) | (alpha == -1.0)
    return jnp.where(is_edge, filtered9, filtered)


def reinhard(color: jnp.ndarray, exposure) -> jnp.ndarray:
    """Reinhard tonemap (PathTracingCommon.js:33-37)."""
    c = color * exposure
    return jnp.clip(c / (1.0 + c), 0.0, 1.0)


def screen_output(
    accum: jnp.ndarray,
    one_over_sample_counter,
    tone_mapping_exposure=1.0,
    apply_denoise: bool = True,
) -> jnp.ndarray:
    """Full final pass: (H, W, 4) running-sum buffer → (H, W, 3) display rgb.

    Converged sharp pixels bypass the blur: alpha == 1.01 once
    1/N < 0.005, and *all* pixels once 1/N < 0.0002
    (PathTracingCommon.js:293-296).
    """
    inv_n = jnp.asarray(one_over_sample_counter, accum.dtype)
    rgb = accum[..., :3]
    alpha = accum[..., 3:4]
    if apply_denoise:
        filtered = denoise(accum)
        bypass = ((alpha == 1.01) & (inv_n < 0.005)) | (inv_n < 0.0002)
        filtered = jnp.where(bypass, rgb, filtered)
    else:
        filtered = rgb
    averaged = filtered * inv_n
    toned = reinhard(averaged, tone_mapping_exposure)
    return jnp.clip(jnp.power(jnp.maximum(toned, 0.0), 0.4545), 0.0, 1.0)
