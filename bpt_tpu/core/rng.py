"""Deterministic per-pixel RNG streams (hash RNG + blue-noise decision stream).

The reference uses two generators (/root/reference/js/PathTracingCommon.js:481-551):

(a) ``rng()`` — iq's uvec2 hash, seeded per pixel per frame as
    ``seed = uvec2(uFrameCounter, uFrameCounter+1) * uvec2(gl_FragCoord)``
    (PathTracingCommon.js:1265).  Used for AA jitter, DoF aperture points,
    hemisphere/lobe directions and light-surface points.

(b) ``blueNoise_rand()`` — alternates the R/G channels of a per-(pixel,frame)
    texel fetched from a 256x256 RGBA blue-noise texture at
    ``(gl_FragCoord.xy + floor(uRandomVec2*256)) mod 256``
    (PathTracingCommon.js:489-498, 1273).  Used for branch decisions
    (diffuse-vs-NEE, Fresnel reflect-vs-refract) to reduce visible noise.

We reproduce both bit-exactly as *counter-free, fixed-schedule* streams: every
potential draw site in the integrator consumes a draw on every lane, so the
stream position is a static function of (pixel, frame, site) rather than of
the data-dependent branch history.  That is the property that makes the CPU
jnp reference, the jitted GPU path, the Pallas megakernel and every sharded
layout consume *identical* random numbers — the keystone of the allclose
validation required by /root/repo/BASELINE.json.  (The reference's stateful,
branch-dependent call order cannot be reproduced lane-parallel without
per-lane counters; the fixed schedule keeps the estimator unbiased and the
marginal distribution of each draw unchanged.)

All seed math is uint32 with wrapping overflow, exactly as GLSL uvec2.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# np (not jnp) scalar: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize (which
# must run first on multi-host deployments importing bpt_tpu.parallel)
_MAGIC = np.uint32(1103515245)
_INV_U32_MAX = float(1.0 / 4294967295.0)  # 1 / float(0xffffffffU)


class RngState(NamedTuple):
    """Per-lane uvec2 hash state; fields broadcast over any pixel shape."""

    sx: jnp.ndarray  # uint32
    sy: jnp.ndarray  # uint32


def rng_seed(frame_counter, px, py) -> RngState:
    """seed = uvec2(uFrameCounter, uFrameCounter+1) * uvec2(gl_FragCoord).

    ``gl_FragCoord.xy`` is the pixel center (px+0.5, py+0.5); the uvec2 cast
    truncates to integer pixel coordinates (PathTracingCommon.js:1265).
    ``px``/``py`` must be the *absolute* image coordinates, never tile-local
    ones, so sharded layouts reproduce the single-device stream.
    """
    f = jnp.asarray(frame_counter).astype(jnp.uint32)
    px = jnp.asarray(px).astype(jnp.uint32)
    py = jnp.asarray(py).astype(jnp.uint32)
    return RngState(sx=f * px, sy=(f + jnp.uint32(1)) * py)


def rng_next(state: RngState) -> tuple[jnp.ndarray, RngState]:
    """One draw of iq's hash (PathTracingCommon.js:502-508). Returns ([0,1), state).

    Float construction: mantissa bit-trick `bitcast((n >> 9) | 0x3F800000) - 1`
    instead of the GLSL's `float(n) / float(0xffffffffU)` — the bitcast is
    exact, cheap, and identical in every backend and in the Pallas kernel.
    Keeps the top 23 bits of the hash; marginal distribution is uniform
    [0, 1).  The jnp path uses the SAME construction so Pallas kernels and
    the reference integrator consume identical draws.
    """
    sx = state.sx + jnp.uint32(1)
    sy = state.sy + jnp.uint32(1)
    qx = _MAGIC * ((sx >> 1) ^ sy)
    qy = _MAGIC * ((sy >> 1) ^ sx)
    n = _MAGIC * (qx ^ (qy >> 3))
    bits = (n >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
    value = jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0
    return value, RngState(sx, sy)


def rng_next2(state: RngState) -> tuple[jnp.ndarray, jnp.ndarray, RngState]:
    a, state = rng_next(state)
    b, state = rng_next(state)
    return a, b, state


# ---------------------------------------------------------------------------
# Blue-noise decision stream
# ---------------------------------------------------------------------------

class BlueNoise(NamedTuple):
    """Per-pixel decision-texel channels and a draw cursor.

    The reference's ``blueNoise_rand()`` alternates only the R and G channels
    of the per-(pixel, frame) texel (channel = counter mod 2,
    PathTracingCommon.js:493).  We cycle all four channels (counter mod 4):
    with the fixed draw schedule (2 gates/bounce) the reference's mod-2 walk
    would hand every bounce the *same* pair of values; mod-4 halves that
    correlation at zero cost.  Parity only has to hold between our own CPU
    reference and the GPU/Pallas paths, which share this stream exactly.
    """

    r: jnp.ndarray
    g: jnp.ndarray
    b: jnp.ndarray
    a: jnp.ndarray
    count: jnp.ndarray  # int32 draw counter (starts at 0 == first call)


_BLUE_NOISE_PNG = "/root/reference/textures/BlueNoise_RGBA256.png"
_bn_cache: dict = {}


def blue_noise_table(size: int = 256, path: str | None = None) -> np.ndarray:
    """(size, size, 4) float32 decision-noise table.

    Loads the reference's pre-baked 256x256 RGBA blue-noise asset
    (textures/BlueNoise_RGBA256.png — the texture behind blueNoise_rand's
    visible-noise quality, README.md:45) when present and the size matches.
    The asset path can be overridden with the BPT_BLUE_NOISE_PATH environment
    variable (deployments without the reference checkout).  Falls back — with
    a loud warning, since output differs across environments otherwise — to
    synthesized interleaved-gradient noise (Jimenez 2014, a closed-form
    blue-noise substitute for threshold decisions with per-channel phase
    offsets) when the asset or PIL is unavailable.
    """
    import os

    key = (size, path)
    if key in _bn_cache:
        return _bn_cache[key]
    p = path or os.environ.get("BPT_BLUE_NOISE_PATH") or _BLUE_NOISE_PNG
    if size == 256 and os.path.exists(p):
        try:
            from PIL import Image  # optional: only needed to read the asset

            with Image.open(p) as im:
                arr = np.asarray(im.convert("RGBA"), np.float32) / 255.0
            if arr.shape[:2] == (size, size):
                _bn_cache[key] = arr
                return arr
        except Exception:
            pass
        import warnings

        warnings.warn(
            f"blue-noise asset not loadable from {p!r} (set BPT_BLUE_NOISE_PATH"
            " to relocate it); falling back to synthesized IGN noise — decision"
            " noise, and therefore rendered output, will differ from"
            " environments that have the asset",
            stacklevel=2,
        )
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    chans = []
    # Per-channel offsets: shift the lattice by large co-prime strides.
    for ox, oy in ((0.0, 0.0), (97.0, 31.0), (53.0, 151.0), (211.0, 71.0)):
        v = np.modf(52.9829189 * np.modf(0.06711056 * (x + ox) + 0.00583715 * (y + oy))[0])[0]
        chans.append(v)
    out = np.stack(chans, axis=-1).astype(np.float32)
    _bn_cache[key] = out
    return out


def blue_noise_fetch(table: jnp.ndarray, px, py, rand_vec2) -> BlueNoise:
    """Fetch the per-pixel decision texel.

    GLSL: texelFetch(blueNoise, ivec2(mod(gl_FragCoord.xy +
    floor(uRandomVec2*256), 256)), 0)  (PathTracingCommon.js:1273).
    ``rand_vec2`` is the host-supplied per-frame offset pair in [0,1).
    """
    size = table.shape[0]
    ox = jnp.floor(rand_vec2[0] * size).astype(jnp.int32)
    oy = jnp.floor(rand_vec2[1] * size).astype(jnp.int32)
    ix = jnp.mod(jnp.asarray(px).astype(jnp.int32) + ox, size)
    iy = jnp.mod(jnp.asarray(py).astype(jnp.int32) + oy, size)
    texel = table[iy, ix]  # gather: (..., 4)
    r = jnp.mod(texel[..., 0], 1.0)
    g = jnp.mod(texel[..., 1], 1.0)
    b = jnp.mod(texel[..., 2], 1.0)
    a = jnp.mod(texel[..., 3], 1.0)
    return BlueNoise(r=r, g=g, b=b, a=a, count=jnp.zeros(jnp.shape(r), jnp.int32))


def bn_next(state: BlueNoise) -> tuple[jnp.ndarray, BlueNoise]:
    """Next decision value: cycles the R, G, B, A channels (see BlueNoise doc).

    Fixed schedule: every call site consumes on every lane (see module doc).
    """
    c = state.count & 3
    value = jnp.where(
        c == 0, state.r, jnp.where(c == 1, state.g, jnp.where(c == 2, state.b, state.a))
    )
    return value, state._replace(count=state.count + 1)
