"""Edge-sampled silhouette gradients for sphere transforms.

The detached-sampling estimator (SURVEY §7 hard part #2) differentiates the
*integrand* exactly but drops the *boundary* term: moving a sphere moves its
silhouette, and the visibility jump across it carries a gradient that
interior AD cannot see — the documented bias that kept
tests/test_gradients.py's transform test sign-only.  This module adds the
missing term with the standard edge-sampling estimator of differentiable
rendering (Li et al. 2018's boundary integral, specialized to the one shape
whose silhouette is closed-form):

    dL/dθ |boundary = ∮_edge  w(x) · (L_in(x) − L_out(x)) · (v(x)·n̂(x)) dl

where the integral runs over the sphere's IMAGE-SPACE silhouette, w is the
loss's weight at pixel x (dLoss/dI, known in closed form for linear losses),
L_in/L_out are radiances just inside/outside the edge, v = ∂x/∂θ is the
image-space edge velocity, and n̂ the outward edge normal.  For a sphere of
center c(θ), radius r seen from o, the 3-D silhouette is the circle

    center c' = c − (r²/d)·a,  radius r' = r·sqrt(1 − r²/d²),
    a = (c − o)/d,  d = |c − o|,

so edge points, their projections, and their velocities are all exact
(velocities via jax.jvp through this construction — no rasterized edge
detection).  L_in/L_out are estimated by the full path tracer on rays
through film points offset ±ε pixels along n̂, with COMMON RANDOM NUMBERS
per edge sample so the in/out difference is low-variance.

No reference analog (the reference does not differentiate at all); this is
the capability this build exists for.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bpt_tpu.camera import Camera, film_extents
from bpt_tpu.core.rng import RngState, blue_noise_fetch
from bpt_tpu.core.vecmath import normalize
from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.integrator.radiance import calculate_radiance
from bpt_tpu.scenes.types import Scene

# float32 contractions at full precision: on a GPU the default may be TF32
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _project(camera: Camera, p, width: int, height: int):
    """World point -> continuous pixel coordinates (gl_FragCoord space)."""
    ulen, vlen = film_extents(camera, width, height)
    rel = p - camera.position
    z = _einsum("...k,k->...", rel, camera.forward)
    x = _einsum("...k,k->...", rel, camera.right) / (ulen * z)
    y = _einsum("...k,k->...", rel, camera.up) / (vlen * z)
    # ndc -> pixel center coords
    return jnp.stack([(x + 1.0) * 0.5 * width, (y + 1.0) * 0.5 * height], -1)


def _rays_through(camera: Camera, pix, width: int, height: int):
    """Pinhole rays through continuous film coords pix (..., 2)."""
    ulen, vlen = film_extents(camera, width, height)
    ndc_x = pix[..., 0] / width * 2.0 - 1.0
    ndc_y = pix[..., 1] / height * 2.0 - 1.0
    rd = normalize(
        ndc_x[..., None] * camera.right * ulen
        + ndc_y[..., None] * camera.up * vlen
        + camera.forward
    )
    ro = jnp.broadcast_to(camera.position, rd.shape)
    return ro, rd


def _silhouette_points(camera: Camera, center, radius, phis):
    """3-D silhouette circle points of the sphere, one per angle."""
    o = camera.position
    a = center - o
    d = jnp.sqrt(jnp.maximum(jnp.sum(a * a), 1e-12))
    a = a / d
    # ONB about the view axis
    h = jnp.where(jnp.abs(a[1]) < 0.9, jnp.asarray([0.0, 1.0, 0.0]),
                  jnp.asarray([1.0, 0.0, 0.0]))
    u = normalize(jnp.cross(h, a))
    v = jnp.cross(a, u)
    rr = radius * jnp.sqrt(jnp.maximum(1.0 - (radius / d) ** 2, 1e-8))
    cprime = center - (radius ** 2 / d) * a
    return (cprime[None]
            + rr * (jnp.cos(phis)[:, None] * u[None] + jnp.sin(phis)[:, None] * v[None]))


def sphere_silhouette_gradient(
    scene_fn,
    theta,
    center_fn,
    camera: Camera,
    cfg: IntegratorConfig,
    width: int,
    height: int,
    weight_fn,
    frame_counter,
    rand_vec2,
    blue_noise,
    n_samples: int = 512,
    n_paths: int = 8,
    eps_px: float = 0.35,
):
    """Boundary term of d/dθ [ Σ_pixels weight(x) · I(x) ] for a sphere whose
    center/radius depend on the scalar θ.

    scene_fn(θ) -> Scene (for radiance just inside/outside the edge —
    evaluated at the CURRENT θ).  center_fn(θ) -> (center (3,), radius) —
    the closed-form silhouette geometry; differentiated with jvp for edge
    velocities.  weight_fn(pix (...,2)) -> dLoss/dI(x) (3,) weights at
    continuous pixel positions.  n_paths: RNG replicates per edge sample
    (common random numbers across the in/out pair).

    Returns the scalar boundary gradient; add it to the interior (detached-
    sampling AD) gradient for the full derivative.
    """
    scene = scene_fn(theta)
    phis = (jnp.arange(n_samples) + 0.5) / n_samples * 2.0 * jnp.pi

    def pix_of(th):
        c, r = center_fn(th)
        pts = _silhouette_points(camera, c, r, phis)
        return _project(camera, pts, width, height)

    pix, vel = jax.jvp(pix_of, (theta,), (jnp.ones_like(theta),))  # (N,2) ×2

    # outward image-space normal: radial from the projected occluder center
    c0, r0 = center_fn(theta)
    c_pix = _project(camera, c0[None], width, height)[0]
    nrm = pix - c_pix[None]
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)

    # arc length per sample in pixels (local, handles the projected ellipse)
    dpix = (jnp.roll(pix, -1, axis=0) - jnp.roll(pix, 1, axis=0)) * 0.5
    dl = jnp.linalg.norm(dpix, axis=-1)

    pin = pix - eps_px * nrm
    pout = pix + eps_px * nrm

    def radiance(p):
        ro, rd = _rays_through(camera, p, width, height)
        # common random numbers: per-sample pseudo-pixel ids shared by the
        # in/out pair (variance of L_in − L_out collapses to the visibility
        # jump); replicate over n_paths frames and average
        sx = (jnp.arange(p.shape[0], dtype=jnp.uint32) * 7919 + 13) % 104729
        acc = 0.0
        for k in range(n_paths):
            rng = RngState(sx=sx * jnp.uint32(k + 3), sy=sx + jnp.uint32(17 * k))
            bn = blue_noise_fetch(jnp.asarray(blue_noise), sx % 256,
                                  (sx // 7) % 256, jnp.asarray(rand_vec2))
            res, _, _ = calculate_radiance(
                scene, cfg, ro, rd, rng, bn, frame_counter
            )
            acc = acc + res.color
        return acc / n_paths

    l_in = radiance(pin)
    l_out = radiance(pout)
    w = weight_fn(pix)  # (N, 3)
    vn = jnp.sum(vel * nrm, axis=-1)  # (N,)
    # boundary integrand: moving the edge outward by vn replaces L_out with
    # L_in over a strip of width vn·dl pixels
    contrib = jnp.sum(w * (l_in - l_out), axis=-1) * vn * dl
    return jnp.sum(contrib)
