"""Vector / matrix helpers over trailing-dim-3 JAX arrays.

All functions broadcast over arbitrary leading (pixel/ray) dimensions so the
same code runs scalar on CPU, vectorized over a full image under `jit`, and
inside `shard_map` tiles.  Semantics follow the GLSL built-ins the reference
shaders rely on (`reflect`, `refract`, `mix`, `smoothstep`) and the
inverse-transpose normal transform used throughout its `SceneIntersect`
functions (e.g. /root/reference/js/BabylonPathTracing_FragmentShader.js:70).

The reference represents "infinity" as 1.0e6 (PathTracingCommon.js:329); we
keep that sentinel so miss tests and comparisons match the reference exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Sentinel miss distance, matching `#define INFINITY 1000000.0`
# (/root/reference/js/PathTracingCommon.js:329).
INFINITY = 1.0e6


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dot product over the trailing axis, keepdims dropped: (..., 3) -> (...)."""
    return jnp.sum(a * b, axis=-1)


def safe_sqrt(x, floor: float = 1e-20) -> jnp.ndarray:
    """sqrt clamped away from 0 with a *where* (not max) on the input.

    d(sqrt)/dx -> inf at 0, and `jnp.where(mask, sqrt(max(x, 0)), y)` still
    propagates NaN through the masked branch in reverse mode (inf * 0).  The
    double-where keeps every masked-geometry gradient finite — load-bearing
    for the inverse-rendering paths (camera fov/aperture, object transforms).
    Value change is negligible: sqrt(1e-20) = 1e-10.
    """
    return jnp.sqrt(jnp.where(x > floor, x, floor))


def safe_inv(x, floor: float = 1e-12) -> jnp.ndarray:
    """1/x with the input clamped away from 0 (sign-preserving).

    Rays parallel to an axis (rd component == 0) make slab/plane tests
    divide by zero; the resulting inf is masked in the *values* but NaN-
    poisons reverse-mode gradients through the mask (inf * 0).  Clamping
    makes the masked lanes' t huge (≥ 1e12 ≫ INFINITY sentinel) so they
    still miss, while keeping every gradient finite.
    """
    ax = jnp.abs(x)
    return jnp.sign(jnp.where(x == 0.0, 1.0, x)) / jnp.where(ax > floor, ax, floor)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize: returns v/|v| with a tiny epsilon to avoid NaN on |v|=0.

    GLSL normalize(0) is undefined; masked-lane code paths here can feed zero
    vectors through, so we must stay finite for autodiff.
    """
    return v * jax.lax.rsqrt(jnp.maximum(dot(v, v), eps))[..., None]


def reflect(incident: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """GLSL reflect: I - 2*dot(N,I)*N."""
    return incident - 2.0 * dot(n, incident)[..., None] * n


def refract(incident: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """GLSL refract. Returns 0 on total internal reflection (as GLSL does).

    eta broadcasts over leading dims: (...,) or scalar.
    """
    eta = jnp.asarray(eta)[..., None] if jnp.ndim(eta) else jnp.asarray(eta)
    cosi = dot(n, incident)[..., None]
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * incident - (eta * cosi + jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k < 0.0, 0.0, refr)


def transform_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 matrix to points: (m @ [p, 1]).xyz.

    `m` is (..., 4, 4) in row-vector-on-the-right convention matching GLSL's
    column-major `mat4 * vec4` (i.e. result_i = sum_j m[i][j] * v[j] after
    accounting for GLSL storing columns — we store the mathematical matrix).
    Written as elementwise products and a sum, not a contraction: a float32
    matmul may run in TF32 on a GPU, which keeps ~3 digits — enough to make
    secondary rays self-intersect.
    """
    return jnp.sum(m[..., :3, :3] * p[..., None, :], axis=-1) + m[..., :3, 3]


def transform_dir(m: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 matrix to directions: (m @ [d, 0]).xyz (no translation)."""
    return jnp.sum(m[..., :3, :3] * d[..., None, :], axis=-1)


def normal_to_world(inv_m: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Object-space normal -> world via transpose of the inverse matrix.

    Reference: `normalize(transpose(mat3(uLeftSphereInvMatrix)) * hitNormal)`
    (/root/reference/js/BabylonPathTracing_FragmentShader.js:70).
    """
    return normalize(jnp.sum(inv_m[..., :3, :3] * n[..., :, None], axis=-2))


def orthonormal_basis(w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's cross-trick ONB used by all its direction samplers.

    U = normalize(cross(|w.y| < 0.9 ? (0,1,0) : (1,0,0), w)); V = cross(w, U)
    (/root/reference/js/PathTracingCommon.js:527-528).
    """
    up_y = jnp.abs(w[..., 1]) < 0.9
    helper = jnp.where(
        up_y[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], w.dtype), w.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], w.dtype), w.shape),
    )
    u = normalize(cross(helper, w))
    v = cross(w, u)
    return u, v


def face_forward(n: jnp.ndarray, ray_dir: jnp.ndarray) -> jnp.ndarray:
    """nl = dot(n, rayDirection) < 0 ? n : -n  (the shading normal `nl`).

    Reference: BabylonPathTracing_FragmentShader.js:163.
    """
    return jnp.where(dot(n, ray_dir)[..., None] < 0.0, n, -n)


def smoothstep(edge0, edge1, x):
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def mix(a, b, t):
    """GLSL mix / lerp."""
    return a + (b - a) * t
