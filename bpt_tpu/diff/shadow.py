"""Edge-sampled SHADOW boundary gradients for sphere blockers under the
quad light (the second boundary family; diff/silhouette.py handles the
direct-visibility silhouette).

The NEE estimator samples one light point y per (pixel, frame) at each
diffuse vertex x; its visibility V(x, y) is a step function of the blocker
position, so interior AD misses the shadow's motion exactly as it misses
the silhouette's.  The jump set for a receiver x is the sphere's
silhouette AS SEEN FROM x, mapped along the tangent rays onto the light
plane — a closed curve whose geometry and velocity are closed-form, so the
missing term is an exact edge integral (no rasterized edge detection, no
extra path tracing):

    dE(x)/dθ = −(1/A) ∮_{curve ∩ light rect} g(x, y) · (v(y)·n̂(y)) dl

where g = ρ(x) · w_quad(x, y) · e is the lit-side NEE integrand (the
blocked side contributes exactly 0: radiance.py kills failed shadow rays),
A = |v1−v0|·|v3−v0| is the full quad measure (the reference samples the
[0.1, 0.9] sub-rectangle of the SAME affine map, lights.py:26-31), v is
the curve's velocity under the blocker parameter θ (jax.jvp through the
tangent-cone construction), and n̂ the outward in-plane normal.

The per-pixel 50/50 indirect-vs-NEE branch is decided by the DETERMINISTIC
blue-noise gate (radiance.py: go_indirect = gate1 < 0.5), so the estimator
includes exactly the pixels whose first diffuse vertex took the NEE branch
— matched-RNG finite differences see the same set.

No reference analog (the reference does not differentiate at all).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bpt_tpu.camera import Camera
from bpt_tpu.core.rng import blue_noise_fetch
from bpt_tpu.core.vecmath import normalize
from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.scenes.types import Scene

# float32 contractions at full precision: on a GPU the default may be TF32
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def quad_shadow_boundary_gradient(
    scene_fn,
    theta,
    center_fn,
    camera: Camera,
    cfg: IntegratorConfig,
    width: int,
    height: int,
    weight_fn,
    pix,
    frame_counter,
    rand_vec2,
    blue_noise,
    n_phi: int = 256,
):
    """Shadow-edge boundary term of d/dθ [ Σ_pixels weight(x)·I(x) ] for a
    sphere blocker center_fn(θ) -> (center (3,), radius) under the scene's
    quad light (cfg.light_index / last quad), for ONE frame's draws.

    ``pix``: (P, 2) integer-center pixel coords of the receiver window.
    The receiver x is the frame's EXACT first hit: the ray-gen draws
    (tent AA + DoF) are replayed through the real RNG schedule and the
    scene intersected, so the estimator sees the same receivers matched-RNG
    finite differences see (the shadow-curve geometry is sensitive to x
    near the contact region, so pixel-center receivers bias the term).
    Receivers must be static diffuse surfaces (non-diffuse or sphere-0
    first hits are masked out).  ``weight_fn(pix) -> (P, 3)`` is dLoss/dI.
    Average over frames and ADD to interior AD (plus the direct silhouette
    term when the window touches the silhouette)."""
    from bpt_tpu.camera import generate_rays
    from bpt_tpu.core.rng import rng_seed
    from bpt_tpu.core.vecmath import face_forward
    from bpt_tpu.integrator.intersect import scene_intersect
    from bpt_tpu.scenes.types import DIFFUSE

    scene = scene_fn(theta)
    quads = scene.quads
    li = cfg.light_index if cfg.light_index >= 0 else quads.v0.shape[0] - 1
    lv0 = quads.v0[li]
    lv1 = quads.v1[li]
    lv3 = quads.v3[li]
    ln = normalize(quads.normal[li])
    e_light = quads.color[li]
    e1 = lv1 - lv0
    e3 = lv3 - lv0
    l1 = jnp.sqrt(jnp.sum(e1 * e1))
    l3 = jnp.sqrt(jnp.sum(e3 * e3))
    area_full = l1 * l3

    # exact per-frame receivers: replay ray-gen + first intersection
    px_i = pix[..., 0].astype(jnp.int32)
    py_i = pix[..., 1].astype(jnp.int32)
    rng = rng_seed(jnp.asarray(frame_counter, jnp.float32), px_i, py_i)
    ro, rd, rng = generate_rays(camera, px_i, py_i, width, height, rng)
    hit = scene_intersect(scene, ro, rd)
    x = ro + rd * hit.t[..., None]
    nl = face_forward(normalize(hit.normal), rd)
    rho = hit.color
    valid = (hit.t < 1.0e5) & (hit.mat_type == DIFFUSE)

    # deterministic NEE gate at the first diffuse vertex (radiance.py:
    # go_indirect = gate1 < 0.5, gate1 = blue-noise channel 0)
    bnv = blue_noise_fetch(jnp.asarray(blue_noise), px_i, py_i,
                           jnp.asarray(rand_vec2))
    took_nee = bnv.r >= 0.5  # bounce-0 gate1 is the R channel (bn_next)
    valid = valid & took_nee

    phis = (jnp.arange(n_phi) + 0.5) / n_phi * 2.0 * jnp.pi

    def curve(th):
        """Silhouette-from-x tangent points extended to the light plane:
        (P, F, 3) points y and the ray parameter (for facing checks)."""
        c, r = center_fn(th)
        a = c[None] - x  # (P, 3)
        d = jnp.sqrt(jnp.maximum(jnp.sum(a * a, -1, keepdims=True), 1e-12))
        a = a / d
        h = jnp.where(jnp.abs(a[:, 1:2]) < 0.9,
                      jnp.asarray([0.0, 1.0, 0.0]), jnp.asarray([1.0, 0.0, 0.0]))
        u = normalize(jnp.cross(h, a))
        v = jnp.cross(a, u)
        rr = r * jnp.sqrt(jnp.maximum(1.0 - (r / d[:, 0]) ** 2, 1e-8))  # (P,)
        cp = c[None] - (r ** 2 / d) * a  # (P, 3)
        pt = (cp[:, None]
              + rr[:, None, None] * (jnp.cos(phis)[None, :, None] * u[:, None]
                                     + jnp.sin(phis)[None, :, None] * v[:, None]))
        dirv = pt - x[:, None]  # (P, F, 3)
        denom = _einsum("pfk,k->pf", dirv, ln)
        tt = _einsum("pk,k->p", lv0[None] - x, ln)[:, None] / jnp.where(
            jnp.abs(denom) < 1e-9, jnp.where(denom < 0, -1e-9, 1e-9), denom)
        return x[:, None] + tt[..., None] * dirv, tt

    (y, tt), (vy, _) = jax.jvp(curve, (theta,), (jnp.ones_like(theta),))

    # in-plane tangent / arc length / outward normal
    dy = (jnp.roll(y, -1, axis=1) - jnp.roll(y, 1, axis=1)) * 0.5
    dl = jnp.sqrt(jnp.maximum(jnp.sum(dy * dy, -1), 1e-18))
    nrm = jnp.cross(jnp.broadcast_to(ln, y.shape), dy)
    nrm = nrm / jnp.maximum(
        jnp.sqrt(jnp.sum(nrm * nrm, -1, keepdims=True)), 1e-12)
    # orient outward (away from the blocked region): radial from the
    # central projection of the sphere center
    c0, _r0 = center_fn(theta)
    dir_c = c0[None] - x
    den_c = _einsum("pk,k->p", dir_c, ln)
    t_c = _einsum("pk,k->p", lv0[None] - x, ln) / jnp.where(
        jnp.abs(den_c) < 1e-9, jnp.where(den_c < 0, -1e-9, 1e-9), den_c)
    y_c = x + t_c[:, None] * dir_c  # (P, 3) blocked-region center
    sgn = jnp.sign(_einsum("pfk,pfk->pf", nrm, y - y_c[:, None]))
    nrm = nrm * jnp.where(sgn == 0.0, 1.0, sgn)[..., None]

    # inside the sampled sub-rectangle, in front of the receiver, and on
    # the lit face of the light
    s1 = _einsum("pfk,k->pf", y - lv0[None, None], e1) / (l1 * l1)
    s3 = _einsum("pfk,k->pf", y - lv0[None, None], e3) / (l3 * l3)
    inside = ((s1 > 0.1) & (s1 < 0.9) & (s3 > 0.1) & (s3 < 0.9)
              & (tt > 0.0) & valid[:, None])

    # lit-side NEE integrand at y (lights.quad_light_from_uniforms)
    dirl = y - x[:, None]
    d2 = jnp.sum(dirl * dirl, -1)
    dirl = dirl / jnp.sqrt(jnp.maximum(d2, 1e-18))[..., None]
    r2 = area_full
    cos_a_max = jnp.sqrt(jnp.maximum(1.0 - jnp.clip(r2 / jnp.maximum(d2, 1e-20), 0.0, 1.0), 0.0))
    dot_nl = jnp.maximum(0.0, _einsum("pfk,pk->pf", dirl, nl))
    w_quad = jnp.clip(
        2.0 * (1.0 - cos_a_max)
        * jnp.maximum(0.0, -_einsum("pfk,k->pf", dirl, ln)) * dot_nl,
        0.0, 1.0,
    )
    g = rho[:, None] * w_quad[..., None] * e_light[None, None]  # (P,F,3)

    wpx = weight_fn(pix)  # (P, 3)
    vn = jnp.sum(vy * nrm, -1)
    contrib = -jnp.sum(wpx[:, None] * g, -1) * vn * dl * inside / area_full
    total = jnp.sum(contrib)

    # ---- clamped-edge ATOM masses --------------------------------------
    # The reference clamps each uniform to [0.1, 0.9] (lights.py:26-31), so
    # 10% of each axis's probability collapses onto the sub-rectangle's
    # edge LINES (0.36 of the total mass sits on edges+corners).  Along an
    # edge line the sample position is uniform in the OTHER axis's u; V
    # flips where the shadow curve crosses the line, so each crossing
    # carries a 1-D boundary term: 0.1 (the collapsed axis mass) x g x
    # d(crossing position in u)/dtheta x orientation.  Crossings are found
    # between adjacent phi samples of the same curve; the crossing
    # velocity follows from the implicit function theorem on
    # s_edge(phi, theta) = const using the already-computed theta- and
    # phi-derivatives.
    ds1_dth = _einsum("pfk,k->pf", vy, e1) / (l1 * l1)
    ds3_dth = _einsum("pfk,k->pf", vy, e3) / (l3 * l3)
    ds1_dph = _einsum("pfk,k->pf", dy, e1) / (l1 * l1)
    ds3_dph = _einsum("pfk,k->pf", dy, e3) / (l3 * l3)
    # blocked-region center in (s1, s3) coordinates (for orientation)
    sc1 = _einsum("pk,k->p", y_c - lv0[None], e1) / (l1 * l1)
    sc3 = _einsum("pk,k->p", y_c - lv0[None], e3) / (l3 * l3)

    def edge_term(s_e, s_o, ds_e_dth, ds_o_dth, ds_e_dph, ds_o_dph,
                  lvl, sc_o, scale_o):
        """One edge line s_e == lvl: sum over curve crossings.

        s_e/s_o: (P, F) edge-axis / other-axis coords; velocity of the
        crossing along the edge (in the OTHER axis's unit coordinate) is
        ds_o*/dth = ds_o_dth - ds_o_dph * (ds_e_dth / ds_e_dph)."""
        f_e = s_e - lvl
        nxt = lambda a: jnp.roll(a, -1, axis=1)
        cross = (f_e * nxt(f_e) < 0.0) & valid[:, None]
        # linear interp factor to the crossing
        tau = f_e / jnp.where(jnp.abs(f_e - nxt(f_e)) < 1e-12, 1e-12,
                              f_e - nxt(f_e))
        lerp = lambda a: a + tau * (nxt(a) - a)
        s_o_x = lerp(s_o)
        in_seg = (s_o_x > 0.1) & (s_o_x < 0.9) & (lerp(tt) > 0.0)
        dph = jnp.where(jnp.abs(lerp(ds_e_dph)) < 1e-9,
                        jnp.where(lerp(ds_e_dph) < 0, -1e-9, 1e-9),
                        lerp(ds_e_dph))
        v_o = lerp(ds_o_dth) - lerp(ds_o_dph) * (lerp(ds_e_dth) / dph)
        # orientation: moving the crossing toward +s_o converts the side
        # nearer the blocked center from lit to blocked
        sigma = jnp.sign(s_o_x - sc_o[:, None])
        g_x = lerp(jnp.sum(g * wpx[:, None], -1))
        term = -0.1 * g_x * v_o * sigma * scale_o
        return jnp.sum(jnp.where(cross & in_seg, term, 0.0))

    # scale_o: v_o is in the other axis's NORMALIZED coordinate; the edge
    # band's collapsed mass is 0.1 of U per unit of the other axis's u —
    # already unit-normalized, so scale 1.  Two lines per axis.
    for lvl in (0.1, 0.9):
        total = total + edge_term(s1, s3, ds1_dth, ds3_dth, ds1_dph,
                                  ds3_dph, lvl, sc3, 1.0)
        total = total + edge_term(s3, s1, ds3_dth, ds1_dth, ds3_dph,
                                  ds1_dph, lvl, sc1, 1.0)
    return total
