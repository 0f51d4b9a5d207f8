"""Wavefront radiance estimator — the `CalculateRadiance` analog.

The reference compiles one SIMT megakernel per demo
(/root/reference/js/BabylonPathTracing_FragmentShader.js:117-344,
PhysicalSkyModel_FragmentShader.js:117-374,
GLTFModelPathTracing_FragmentShader.js:351-609,
HDRIEnvironmentPathTracing_FragmentShader.js:371-663,
TransformedQuadricGeometry_FragmentShader.js:322-542) whose per-pixel bounce
loop takes data-dependent branches.  Under XLA that becomes a *wavefront*: the
bounce loop is unrolled (static trip count), every material branch is
evaluated branchlessly across the whole pixel array, and per-lane alive /
branch masks select the surviving update.  The static
:class:`~bpt_tpu.integrator.config.IntegratorConfig` plays the role of the
per-demo shader composition: Python-level branches on it mean XLA compiles
exactly one demo's megakernel, with no dead code.

RNG discipline (see bpt_tpu.core.rng): every draw site consumes on every lane
on every bounce, so the stream position is a static function of
(pixel, frame, bounce, site).  Draw order per bounce:

  blue-noise:  gate1 (P / 50-50 decision), gate2 (clearcoat base 50-50)
  hash:        hem.r, hem.phi            (cosine-hemisphere site)
               [quad.x, quad.y, quad.z]  (iff nee == "quad")
               [lobe.cos, lobe.phi]      (iff nee in ("sun", "env") or the
                                          metal roughness lobe is on — for
                                          nee == "env" the pair feeds the
                                          inverse-CDF env sample)

Discrete decisions (blue-noise gates, material selection, NEE light-point
picks) are detached from the gradient graph (`stop_gradient`) — the
"detached sampling" estimator mandated by /root/repo/BASELINE.json; the
continuous integrand (BSDF factors, Fresnel, light weights, env radiance)
stays differentiable w.r.t. camera/material/light/transform parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bpt_tpu.core.fresnel import calc_fresnel_reflectance
from bpt_tpu.core.rng import BlueNoise, RngState, bn_next, rng_next
from bpt_tpu.core.sampling import cos_hemisphere_from_uniforms, specular_lobe_from_uniforms
from bpt_tpu.core.vecmath import (
    INFINITY,
    dot,
    face_forward,
    normalize,
    reflect,
    refract,
)
from bpt_tpu.env import get_hdr_color
from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.integrator.intersect import scene_intersect
from bpt_tpu.lights import quad_light_from_uniforms
from bpt_tpu.scenes.types import (
    CLEARCOAT_DIFFUSE,
    DIFFUSE,
    LIGHT,
    METAL,
    PBR_MATERIAL,
    TRANSPARENT,
    Scene,
)
from bpt_tpu.sky import get_sky_color
from bpt_tpu.textures import sample_mesh_tex


class RadianceResult(NamedTuple):
    """Per-pixel integrator outputs (the GLSL out-params of CalculateRadiance
    plus the radiance return value)."""

    color: jnp.ndarray  # (..., 3) radiance estimate, >= 0
    object_normal: jnp.ndarray  # (..., 3) first-hit shading normal
    object_color: jnp.ndarray  # (..., 3) first-hit material color
    object_id: jnp.ndarray  # (...,) first-hit object id (-INFINITY on miss)
    pixel_sharpness: jnp.ndarray  # (...,) denoiser flag (0 / -1 / 1.01)


def _sg(x):
    return jax.lax.stop_gradient(x)


def _where3(c, a, b):
    return jnp.where(c[..., None], a, b)


def calculate_radiance(
    scene: Scene,
    cfg: IntegratorConfig,
    ray_origin: jnp.ndarray,
    ray_dir: jnp.ndarray,
    rng: RngState,
    bn: BlueNoise,
    frame_counter,
) -> tuple[RadianceResult, RngState, BlueNoise]:
    """Trace one path per lane for up to cfg.bounces bounces.

    ray_origin/ray_dir: (..., 3) primary rays.  Returns the per-pixel result
    plus the advanced RNG states (so callers can continue the streams).
    """
    shape = ray_origin.shape[:-1]
    f32 = ray_origin.dtype
    eps = cfg.eps_intersect

    ro = ray_origin
    rd = ray_dir
    accum = jnp.zeros(shape + (3,), f32)
    mask = jnp.ones(shape + (3,), f32)
    alive = jnp.ones(shape, bool)
    spec = jnp.ones(shape, bool)  # bounceIsSpecular
    sample_light = jnp.zeros(shape, bool)
    coat_hit = jnp.zeros(shape, bool)  # coatTypeIntersected
    d_count = jnp.zeros(shape, jnp.int32)  # diffuseCount
    prev_mat = jnp.full(shape, -100, jnp.int32)
    sharp = jnp.zeros(shape, f32)  # pixelSharpness
    obj_normal = jnp.zeros(shape + (3,), f32)
    obj_color = jnp.zeros(shape + (3,), f32)
    obj_id = jnp.full(shape, -INFINITY, f32)

    has_quad_light = scene.quads is not None and cfg.nee == "quad"
    if has_quad_light:
        li = cfg.light_index if cfg.light_index >= 0 else scene.quads.v0.shape[0] - 1
        lv0, lv1, lv2, lv3 = (scene.quads.v0[li], scene.quads.v1[li], scene.quads.v2[li], scene.quads.v3[li])
        l_normal = normalize(scene.quads.normal[li])
    sun_dir = scene.env.sun_direction if scene.env is not None else None
    use_lobe = cfg.nee in ("sun", "env") or cfg.metal_roughness_lobe

    frame_counter = jnp.asarray(frame_counter, f32)

    for bounce in range(cfg.bounces):
        hit = scene_intersect(scene, ro, rd, active=(alive if bounce else None))
        miss = hit.t >= INFINITY

        n = normalize(hit.normal)
        nl = face_forward(n, rd)
        x = ro + rd * hit.t[..., None]

        hit_color = hit.color
        mat = hit.mat_type

        # ---- environment on miss -------------------------------------------
        if cfg.env == "none":
            # Cornell / quadric demos: miss is black, lane just ends
            # (BabylonPathTracing_FragmentShader.js:158-159).
            alive = alive & ~miss
        else:
            m = alive & miss
            env_color = (
                get_sky_color(rd, sun_dir)
                if cfg.env == "sky"
                else get_hdr_color(scene.env.hdr_image, rd, scene.env.hdr_exposure)
            )
            sun_cos = dot(rd, jnp.broadcast_to(sun_dir, rd.shape))
            if bounce == 0:
                # Primary ray hits sky (PhysicalSkyModel_FragmentShader.js:161-168).
                accum = _where3(m, env_color, accum)
                sharp = jnp.where(m, 1.01, sharp)
            else:
                # First-match case chain (:169-192; HDRI variant :412-436).
                c2 = (d_count == 0) & spec
                c3 = sample_light
                c4 = (d_count == 1) & (prev_mat == TRANSPARENT) & spec
                if cfg.env == "hdri":
                    c4 = c4 & (bounce < 3)
                c5 = d_count > 0
                if cfg.nee == "env":
                    # env importance sampling covers the WHOLE environment at
                    # every diffuse vertex, so BSDF-sampled env hits after a
                    # diffuse bounce would double count: c5 contributes 0
                    # (the sun-disc clip generalized to the full map).
                    sun_clip = jnp.zeros_like(sun_cos)
                else:
                    sun_clip = jnp.where(sun_cos < 0.99, 1.0, 0.0)
                chosen = jnp.where(
                    c2[..., None] | c3[..., None],
                    mask * env_color,
                    jnp.where(
                        c4[..., None],
                        mask * env_color,
                        jnp.where(c5[..., None], mask * env_color * sun_clip[..., None], 0.0),
                    ),
                )
                # Priority: c2 > c3 > c4 > c5 — c2/c3 share the same value, and
                # c4 beats c5 in the where-nest above, matching the else-if chain.
                accum = _where3(m, chosen, accum)
                sharp = jnp.where(m & c2, 1.01, sharp)
                if cfg.env == "hdri":
                    sharp = jnp.where(m & ~c2 & ~c3 & c4 & (sun_cos > 0.99), 1.01, sharp)
            alive = alive & ~miss

        lane = alive  # live, surface-hitting lanes from here on

        # ---- first-hit records for the edge detector -----------------------
        if bounce == 0:
            obj_normal = _where3(lane, nl, obj_normal)
            obj_color = _where3(lane, hit_color, obj_color)
            obj_id = jnp.where(lane, hit.object_id, obj_id)
        if bounce == 1:
            after_metal = lane & (prev_mat == METAL)
            obj_normal = _where3(after_metal, nl, obj_normal)
            obj_id = jnp.where(after_metal, hit.object_id, obj_id)

        # ---- light hit terminates (BabylonPathTracing_FragmentShader.js:179-190)
        if has_quad_light:
            is_light = lane & (mat == LIGHT)
            sharp = jnp.where(is_light & (d_count == 0), 1.01, sharp)
            accum = _where3(is_light & (spec | sample_light), mask * hit_color, accum)
            alive = alive & ~is_light
            lane = alive

        # ---- failed shadow ray terminates (:194) ---------------------------
        failed_shadow = lane & sample_light
        alive = alive & ~failed_shadow
        lane = alive

        # ---- PBR texture decode (GLTFModelPathTracing_FragmentShader.js:434-462)
        mr_g = jnp.zeros(shape, f32)  # metallicRoughness.g for the METAL lobe
        mesh = scene.mesh
        if mesh is not None and mesh.albedo is not None:
            is_pbr = lane & (mat == PBR_MATERIAL)
            albedo = jnp.power(jnp.maximum(sample_mesh_tex(mesh.albedo, mesh.albedo_q, hit.uv), 0.0), 2.2)
            hit_color = _where3(is_pbr, albedo, hit_color)
            if mesh.emissive is not None:
                emission = jnp.power(jnp.maximum(sample_mesh_tex(mesh.emissive, mesh.emissive_q, hit.uv), 0.0), 2.2)
                max_emission = jnp.max(emission, axis=-1)
                emissive_hit = is_pbr & spec & (max_emission > 0.01)
                sharp = jnp.where(emissive_hit, 1.01, sharp)
                accum = _where3(emissive_hit, mask * emission, accum)
                alive = alive & ~emissive_hit
                lane = alive
                is_pbr = is_pbr & ~emissive_hit
            mat = jnp.where(is_pbr, DIFFUSE, mat)
            if mesh.metallic_roughness is not None:
                mr = jnp.power(jnp.maximum(sample_mesh_tex(mesh.metallic_roughness, mesh.metallic_roughness_q, hit.uv), 0.0), 2.2)
                mat = jnp.where(is_pbr & (mr[..., 1] > 0.01), CLEARCOAT_DIFFUSE, mat)
                mat = jnp.where(is_pbr & (mr[..., 2] > 0.01), METAL, mat)
                mr_g = jnp.where(is_pbr, mr[..., 1], mr_g)

        # ---- fixed-schedule RNG draws for this bounce ----------------------
        gate1, bn = bn_next(bn)
        gate2, bn = bn_next(bn)
        gate1 = _sg(gate1)
        gate2 = _sg(gate2)
        hem_r, rng = rng_next(rng)
        hem_p, rng = rng_next(rng)
        hem_dir = cos_hemisphere_from_uniforms(nl, _sg(hem_r), _sg(hem_p))
        if has_quad_light:
            qx, rng = rng_next(rng)
            qy, rng = rng_next(rng)
            qz, rng = rng_next(rng)
            light_dir, light_weight = quad_light_from_uniforms(
                x, nl, lv0, lv1, lv2, lv3, l_normal, _sg(qx), _sg(qy), _sg(qz)
            )
        if use_lobe:
            lc, rng = rng_next(rng)
            lp, rng = rng_next(rng)
            lc, lp = _sg(lc), _sg(lp)
        if cfg.nee == "sun":
            sun_b = jnp.broadcast_to(sun_dir, rd.shape)
            sun_nee_dir = specular_lobe_from_uniforms(sun_b, cfg.sun_lobe_roughness, lc, lp)
            sun_cos_w = jnp.maximum(0.0, dot(sun_nee_dir, nl))
            if cfg.sun_weight_mode == "hdri":
                sp = scene.env.sun_power
                sun_weight = sun_cos_w * (sp * sp * 1.0e-7)
            else:
                sun_weight = sun_cos_w * 0.05
        if cfg.nee == "env":
            # HDRI importance sampling (BASELINE mandate; no reference
            # analog): inverse-CDF draw over the luminance x sin(theta)
            # marginals, Lambertian weight cos/(pi*pdf) — the env radiance
            # itself is picked up by the shadow ray's miss (case c3), so the
            # estimator is albedo/pi * L * cos / pdf, unbiased for direct
            # env lighting at every diffuse/coat vertex.
            from bpt_tpu.env import EnvCDF, sample_env_cdf

            if scene.env is None or scene.env.env_cdf is None:
                raise ValueError(
                    "nee='env' needs scene.env.env_cdf — build it with "
                    "bpt_tpu.env.build_env_cdf (hdri_scene does this)")
            env_nee_dir, env_pdf = sample_env_cdf(
                EnvCDF(*scene.env.env_cdf), lc, lp
            )
            env_cos_w = jnp.maximum(0.0, dot(env_nee_dir, nl))
            env_weight = env_cos_w / (jnp.pi * jnp.maximum(env_pdf, 1e-8))

        b_diff = lane & (mat == DIFFUSE)
        b_metal = lane & (mat == METAL)
        b_trans = lane & (mat == TRANSPARENT)
        b_coat = lane & (mat == CLEARCOAT_DIFFUSE)

        # ==== DIFFUSE (BabylonPathTracing_FragmentShader.js:199-224) ========
        d_count_diff = d_count + 1
        mask_diff = mask * hit_color
        go_indirect_d = (d_count_diff <= cfg.diffuse_indirect_max) & (gate1 < 0.5)
        if cfg.nee == "quad":
            nee_dir, nee_w = light_dir, light_weight
        elif cfg.nee == "env":
            nee_dir, nee_w = env_nee_dir, env_weight
        else:
            nee_dir, nee_w = sun_nee_dir, sun_weight
        rd_diff = _where3(go_indirect_d, hem_dir, nee_dir)
        mask_diff = jnp.where(go_indirect_d[..., None], mask_diff, mask_diff * nee_w[..., None])
        ro_diff = x + nl * eps
        sl_diff = ~go_indirect_d

        # ==== METAL (:227-235; lobe variant GLTF...js:492-500) ==============
        mask_metal = mask * hit_color
        refl = reflect(rd, nl)
        if cfg.metal_roughness_lobe:
            rd_metal = specular_lobe_from_uniforms(refl, mr_g, lc, lp)
        else:
            rd_metal = refl
        ro_metal = x + nl * eps

        # ==== TRANSPARENT (:238-284) ========================================
        re_t, ratio_t = calc_fresnel_reflectance(rd, n, 1.0, 1.5)
        tr_t = 1.0 - re_t
        p_t = 0.25 + 0.5 * re_t
        go_reflect_t = _sg(gate1 < p_t)
        # reflect path
        mask_t_refl = mask * (re_t / p_t)[..., None]
        # transmit path: Beer-Lambert when exiting a solid (distance(n, nl) > 0.1)
        inside = dot(n, rd) >= 0.0
        if cfg.transparent_tint:
            # Quadric demo tints by surface color instead
            # (TransformedQuadricGeometry_FragmentShader.js:469-471).
            absorb = hit_color
        else:
            absorb = jnp.where(
                inside[..., None],
                jnp.exp(jnp.log(jnp.clip(hit_color, 0.01, 0.99)) * 0.01 * hit.t[..., None]),
                1.0,
            )
        mask_t_refr = mask * absorb * (tr_t / (1.0 - p_t))[..., None]
        rd_t = _where3(go_reflect_t, reflect(rd, nl), refract(rd, nl, ratio_t))
        ro_t = _where3(go_reflect_t, x + nl * eps, x - nl * eps)
        mask_t = _where3(go_reflect_t, mask_t_refl, mask_t_refr)
        spec_t = jnp.where(go_reflect_t, spec, spec | (d_count == 1))
        sharp_t = jnp.where(
            (d_count == 0) & ~coat_hit & (not cfg.camera_is_moving),
            1.01,
            jnp.where(d_count > 0, 0.0, -1.0),
        )

        # ==== CLEARCOAT_DIFFUSE (:287-337) ==================================
        re_c, _ = calc_fresnel_reflectance(rd, nl, 1.0, 1.4)
        tr_c = 1.0 - re_c
        p_c = 0.25 + 0.5 * re_c
        go_reflect_c = _sg(gate1 < p_c)
        mask_c_refl = mask * (re_c / p_c)[..., None]
        sharp_c_refl = jnp.where(
            d_count == 0, jnp.where(frame_counter > 500.0, 1.01, -1.0), 0.0
        )
        # base (diffuse substrate)
        d_count_coat = d_count + 1
        mask_c_base = mask * (tr_c / (1.0 - p_c))[..., None] * hit_color
        go_indirect_c = (d_count_coat <= cfg.diffuse_indirect_max) & (gate2 < 0.5)
        rd_c_base = _where3(go_indirect_c, hem_dir, nee_dir)
        mask_c_base = jnp.where(go_indirect_c[..., None], mask_c_base, mask_c_base * nee_w[..., None])
        # `bounces < 3` guards against noisy coat-after-glass pixels (:333).
        sl_coat = ~go_indirect_c & (bounce < 3)

        rd_coat = _where3(go_reflect_c, reflect(rd, nl), rd_c_base)
        mask_coat = _where3(go_reflect_c, mask_c_refl, mask_c_base)
        d_count_c = jnp.where(go_reflect_c, d_count, d_count_coat)
        spec_c = jnp.where(go_reflect_c, spec, False)
        sl_c = jnp.where(go_reflect_c, False, sl_coat)
        sharp_c = jnp.where(go_reflect_c, sharp_c_refl, 0.0)

        # ---- merge the four branches ---------------------------------------
        new_rd = rd
        new_ro = ro
        new_mask = mask
        new_spec = spec
        new_sl = jnp.zeros(shape, bool)
        new_dc = d_count
        new_sharp = sharp

        new_rd = _where3(b_diff, rd_diff, new_rd)
        new_ro = _where3(b_diff, ro_diff, new_ro)
        new_mask = _where3(b_diff, mask_diff, new_mask)
        new_spec = jnp.where(b_diff, False, new_spec)
        new_sl = jnp.where(b_diff, sl_diff, new_sl)
        new_dc = jnp.where(b_diff, d_count_diff, new_dc)

        new_rd = _where3(b_metal, rd_metal, new_rd)
        new_ro = _where3(b_metal, ro_metal, new_ro)
        new_mask = _where3(b_metal, mask_metal, new_mask)

        new_rd = _where3(b_trans, rd_t, new_rd)
        new_ro = _where3(b_trans, ro_t, new_ro)
        new_mask = _where3(b_trans, mask_t, new_mask)
        new_spec = jnp.where(b_trans, spec_t, new_spec)
        new_sharp = jnp.where(b_trans, sharp_t, new_sharp)

        new_rd = _where3(b_coat, rd_coat, new_rd)
        new_ro = _where3(b_coat, x + nl * eps, new_ro)
        new_mask = _where3(b_coat, mask_coat, new_mask)
        new_spec = jnp.where(b_coat, spec_c, new_spec)
        new_sl = jnp.where(b_coat, sl_c, new_sl)
        new_dc = jnp.where(b_coat, d_count_c, new_dc)
        new_sharp = jnp.where(b_coat, sharp_c, new_sharp)
        coat_hit = coat_hit | b_coat

        # Unknown material ids on live lanes fall through with the ray
        # unchanged, like GLSL reaching the loop end — they self-terminate via
        # the same intersection next bounce; mark them dead instead to save work.
        known = b_diff | b_metal | b_trans | b_coat
        alive = alive & known

        rd = _where3(lane, new_rd, rd)
        ro = _where3(lane, new_ro, ro)
        mask = _where3(lane, new_mask, mask)
        spec = jnp.where(lane, new_spec, spec)
        sample_light = jnp.where(lane, new_sl, sample_light)
        d_count = jnp.where(lane, new_dc, d_count)
        sharp = jnp.where(lane, new_sharp, sharp)
        prev_mat = jnp.where(lane, mat, prev_mat)

    result = RadianceResult(
        color=jnp.maximum(accum, 0.0),
        object_normal=obj_normal,
        object_color=obj_color,
        object_id=obj_id,
        pixel_sharpness=sharp,
    )
    return result, rng, bn
