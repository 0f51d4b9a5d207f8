"""Fused-path (Pallas megakernel, differentiable=True) gradients on the
NAMED glTF demo assets — the round-3 gap: the path-replay VJP was only ever
gradient-tested on cornell and synthetic blobs.

Oracle: matched-RNG central differences of the SAME fused forward (the
fixed draw schedule makes FD noise-free), so per-triangle-decision deltas
vs the wavefront cannot contaminate the comparison.  The per-pixel gradient
image dC/dθ for a scalar θ is obtained by FD; reverse-mode AD through the
custom VJP is checked against it via K random weight-plane projections
grad⟨W_k, C⟩ == ⟨W_k, dC/dθ⟩ — if AD deviated from FD on even 1% of
pixels, independent random projections would miss it with probability ~0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig
from bpt_tpu.kernels.megakernel import trace_image_pallas
from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
from bpt_tpu.textures import quad_pack

BN = jnp.asarray(blue_noise_table())
RV = jnp.asarray([0.3, 0.7], jnp.float32)
RES = 32


def _load(name, scale, flip, tex_size=None):
    from bpt_tpu.io import load_gltf

    path = os.path.join("/root/reference/models", name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not mounted")
    model = load_gltf(path, initial_scale=scale, flip_z=flip)
    if tex_size is not None and model.albedo is not None:
        ah, aw = model.albedo.shape[:2]
        t = tex_size
        model = model._replace(
            albedo=model.albedo[:: max(ah // t, 1), :: max(aw // t, 1)][:t, :t]
        )
    return model


def _fused(scene, cfg, differentiable):
    return trace_image_pallas(
        scene, gltf_camera(), cfg, RES, RES, 2.0, RV, BN,
        interpret=True, differentiable=differentiable,
    ).color


@pytest.mark.parametrize("name,scale,flip", [
    ("Duck.gltf", 10.0, False),
    ("DamagedHelmet.gltf", 15.0, True),
])
def test_fused_named_asset_tint_gradient(name, scale, flip):
    """Global albedo tint through the fused deferred-PBR composition:
    reverse-mode AD == matched-RNG FD image under random projections."""
    model = _load(name, scale, flip, tex_size=64)
    mesh0 = mesh_from_model(model, mat_type=1)
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)

    def color(tint, differentiable):
        alb = jnp.asarray(model.albedo) * tint
        mesh = mesh0._replace(albedo=alb, albedo_q=quad_pack(alb))
        return _fused(gltf_scene(mesh), cfg, differentiable)

    t0 = jnp.asarray(1.0)
    h = 1e-3
    fd_img = (np.asarray(color(t0 + h, False))
              - np.asarray(color(t0 - h, False))) / (2 * h)
    assert np.abs(fd_img).max() > 1e-3  # the tint genuinely moves pixels

    rng = np.random.default_rng(0)
    ws = jnp.asarray(rng.normal(size=(4, RES, RES, 3)), jnp.float32)
    grads = jax.grad(
        lambda t: jnp.stack([jnp.mean(w * color(t, True)) for w in ws])
        .sum()  # one backward for all projections (they're checked jointly)
    )(t0)
    proj_fd = np.asarray([np.mean(np.asarray(w) * fd_img) for w in ws]).sum()
    np.testing.assert_allclose(np.asarray(grads), proj_fd, rtol=2e-3,
                               err_msg=f"{name} tint grad (AD vs FD)")


def test_fused_albedo_map_texel_gradients_duck():
    """The per-texel albedo MAP — the actual inverse-rendering parameter of
    apps/inverse_rendering.py — through the fused kernel's deferred
    composition (quad_pack -> per-bounce UV planes -> Π albedo^flag):
    reverse-mode texel gradients == matched-RNG FD probes of the hottest
    texels."""
    model = _load("Duck.gltf", 10.0, False, tex_size=32)
    mesh0 = mesh_from_model(model, mat_type=1)
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    w_plane = jnp.asarray(
        np.random.default_rng(1).normal(size=(RES, RES, 3)), jnp.float32
    )

    def loss(albedo, differentiable):
        mesh = mesh0._replace(albedo=albedo, albedo_q=quad_pack(albedo))
        return jnp.mean(w_plane * _fused(gltf_scene(mesh), cfg, differentiable))

    a0 = jnp.asarray(model.albedo)
    g = jax.grad(lambda a: loss(a, True))(a0)
    g_np = np.asarray(g)
    assert np.isfinite(g_np).all()
    flat = np.abs(g_np).reshape(-1)
    assert (flat > 0).sum() > 10, "albedo-map gradient must be nonzero"
    # FD-probe the 4 largest-gradient texel channels
    order = np.argsort(flat)[::-1][:4]
    h = 5e-3
    for idx in order:
        yi, xi, ci = np.unravel_index(idx, g_np.shape)
        e = jnp.zeros_like(a0).at[yi, xi, ci].set(h)
        fd = (float(loss(a0 + e, False)) - float(loss(a0 - e, False))) / (2 * h)
        np.testing.assert_allclose(
            g_np[yi, xi, ci], fd, rtol=2e-2, atol=1e-8,
            err_msg=f"albedo texel ({yi},{xi},{ci}) grad",
        )


def test_fused_albedo_map_texel_gradients_helmet():
    """VERDICT r4 task 7: the per-texel albedo-MAP probes on DamagedHelmet —
    the only asset with emissive + normal map + metal lobe simultaneously
    (Duck exercises none of those interactions)."""
    model = _load("DamagedHelmet.gltf", 15.0, True, tex_size=32)
    mesh0 = mesh_from_model(model, mat_type=1)
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    w_plane = jnp.asarray(
        np.random.default_rng(3).normal(size=(RES, RES, 3)), jnp.float32
    )

    def loss(albedo, differentiable):
        mesh = mesh0._replace(albedo=albedo, albedo_q=quad_pack(albedo))
        return jnp.mean(w_plane * _fused(gltf_scene(mesh), cfg, differentiable))

    a0 = jnp.asarray(model.albedo)
    g = jax.grad(lambda a: loss(a, True))(a0)
    g_np = np.asarray(g)
    assert np.isfinite(g_np).all()
    flat = np.abs(g_np).reshape(-1)
    assert (flat > 0).sum() > 10, "albedo-map gradient must be nonzero"
    order = np.argsort(flat)[::-1][:4]
    h = 5e-3
    for idx in order:
        yi, xi, ci = np.unravel_index(idx, g_np.shape)
        e = jnp.zeros_like(a0).at[yi, xi, ci].set(h)
        fd = (float(loss(a0 + e, False)) - float(loss(a0 - e, False))) / (2 * h)
        np.testing.assert_allclose(
            g_np[yi, xi, ci], fd, rtol=2e-2, atol=1e-8,
            err_msg=f"helmet albedo texel ({yi},{xi},{ci}) grad",
        )


def test_fused_emissive_map_gradients_helmet():
    """The deferred emissive-terminal term (color += em_w * emissive^2.2,
    megakernel._compose_result): per-texel emissive-MAP gradients through
    plain AD of the composition, FD-probed on the hottest texels.

    The stock gltf_camera views the helmet from BEHIND (the 26
    emissive-flagged triangles all face +z, centroids z in [-1.8, 6.7]);
    a front-facing close camera makes them cover real pixels at RES=32."""
    from bpt_tpu.camera import Camera

    model = _load("DamagedHelmet.gltf", 15.0, True, tex_size=32)
    if model.emissive is None:
        pytest.skip("helmet emissive map missing")
    # block-MAX downsample: the emissive regions cover only ~2% of texels,
    # so a strided subsample misses them entirely (zero flags, zero grads)
    eh, ew = model.emissive.shape[:2]
    t = 32
    em = np.asarray(model.emissive)[: eh // t * t, : ew // t * t]
    em = em.reshape(t, eh // t, t, ew // t, -1).max(axis=(1, 3))
    model = model._replace(emissive=em.astype(np.float32))
    mesh0 = mesh_from_model(model, mat_type=1)
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    cam = Camera.look(position=(0.0, 5.0, 30.0), yaw=float(np.pi), fov=0.8,
                      focus_distance=25.0)
    w_plane = jnp.asarray(
        np.random.default_rng(4).normal(size=(RES, RES, 3)), jnp.float32
    )

    def loss(emissive, differentiable):
        mesh = mesh0._replace(emissive=emissive, emissive_q=quad_pack(emissive))
        c = trace_image_pallas(
            gltf_scene(mesh), cam, cfg, RES, RES, 2.0, RV, BN,
            interpret=True, differentiable=differentiable,
        ).color
        return jnp.mean(w_plane * c)

    e0 = jnp.asarray(model.emissive)
    g = jax.grad(lambda e: loss(e, True))(e0)
    g_np = np.asarray(g)
    assert np.isfinite(g_np).all()
    flat = np.abs(g_np).reshape(-1)
    assert (flat > 0).sum() > 4, "emissive-map gradient must be nonzero"
    order = np.argsort(flat)[::-1][:3]
    h = 5e-3
    for idx in order:
        yi, xi, ci = np.unravel_index(idx, g_np.shape)
        e = jnp.zeros_like(e0).at[yi, xi, ci].set(h)
        fd = (float(loss(e0 + e, False)) - float(loss(e0 - e, False))) / (2 * h)
        np.testing.assert_allclose(
            g_np[yi, xi, ci], fd, rtol=2e-2, atol=1e-8,
            err_msg=f"helmet emissive texel ({yi},{xi},{ci}) grad",
        )


def test_fused_inverse_rendering_step_reduces_loss():
    """apps/inverse_rendering.py's fused (pallas=True) fwd+bwd path: a few
    Adam steps on the albedo map reduce the loss."""
    from bpt_tpu.diff.inverse import optimize, render_avg

    model = _load("Duck.gltf", 10.0, False, tex_size=16)
    mesh0 = mesh_from_model(model, mat_type=1)
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    cam = gltf_camera()

    def build(params):
        mesh = mesh0._replace(
            albedo=params["albedo"], albedo_q=quad_pack(params["albedo"])
        )
        return gltf_scene(mesh), cam

    true_albedo = jnp.asarray(model.albedo)
    target = render_avg(build({"albedo": true_albedo})[0], cam, cfg, RES,
                        (2.0,), RV, BN, pallas=True, interpret=True)
    init = {"albedo": jnp.full_like(true_albedo, 0.5)}
    result = optimize(build, init, target, cfg, RES, steps=3, lr=0.1,
                      frames=(2.0,), pallas=True, interpret=True)
    losses = np.asarray(result.losses)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
