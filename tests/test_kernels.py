"""Pallas megakernel parity vs the jnp reference integrator.

Runs in interpreter mode on CPU (same program, same RNG draws); the Triton
compile for the GPU is exercised by tests/test_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig
from bpt_tpu.integrator.frame import trace_image
from bpt_tpu.kernels.megakernel import trace_image_pallas
from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu.scenes.types import TRANSPARENT

RES = 64
BN = jnp.asarray(blue_noise_table())
RV = jnp.asarray([0.3, 0.7], jnp.float32)


@pytest.mark.parametrize("right_mat", [3, TRANSPARENT])
def test_megakernel_matches_jnp_reference(right_mat):
    scene = cornell_scene(right_sphere_mat=right_mat)
    camera = cornell_camera()
    cfg = IntegratorConfig(bounces=4)
    ref = trace_image(scene, camera, cfg, RES, RES, 2.0, RV, BN)
    got = trace_image_pallas(
        scene, camera, cfg, RES, RES, 2.0, RV, BN, interpret=True
    )
    a = np.asarray(ref.color)
    b = np.asarray(got.color)
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"color parity {close.mean():.4f}"
    # first-hit records are pre-RNG-divergence -> near-exact (a few
    # silhouette lanes differ at ~3e-5 from matmul association order)
    np.testing.assert_allclose(
        np.asarray(ref.object_normal), np.asarray(got.object_normal), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_array_equal(np.asarray(ref.object_id), np.asarray(got.object_id))
    sh_match = (np.asarray(ref.pixel_sharpness) == np.asarray(got.pixel_sharpness)).mean()
    assert sh_match > 0.99, f"sharpness parity {sh_match:.4f}"


def test_megakernel_path_replay_grads():
    """Fused path-replay VJP vs central finite differences of the SAME
    Pallas forward (matched RNG ⇒ FD is noise-free): light emission (linear,
    FD-exact), a wall albedo (polynomial), and a Beer-Lambert glass sphere."""
    scene = cornell_scene(right_sphere_mat=TRANSPARENT)
    camera = cornell_camera()
    cfg = IntegratorConfig(bounces=3)
    res = 32
    wvec = jnp.asarray([1.0, 2.0, 3.0])

    def loss(light_c, wall_c, sph_c, differentiable):
        quads = scene.quads._replace(
            color=scene.quads.color.at[5].set(light_c).at[2].set(wall_c)
        )
        spheres = scene.spheres._replace(color=scene.spheres.color.at[1].set(sph_c))
        s = scene._replace(quads=quads, spheres=spheres)
        r = trace_image_pallas(
            s, camera, cfg, res, res, 2.0, RV, BN,
            interpret=True, differentiable=differentiable,
        )
        return jnp.mean(r.color * wvec)

    lc = jnp.asarray([10.0, 10.0, 10.0])
    wc = scene.quads.color[2]
    sc = jnp.asarray([0.4, 0.9, 0.6])
    g_lc, g_wc, g_sc = jax.grad(loss, argnums=(0, 1, 2))(lc, wc, sc, True)

    h = 1e-2
    for arg, g, name in ((0, g_lc, "light"), (1, g_wc, "wall"), (2, g_sc, "sphere")):
        ch = 1 if arg == 1 else 0
        args = [lc, wc, sc]
        e = jnp.zeros(3).at[ch].set(h)
        hi = loss(*(a + e if i == arg else a for i, a in enumerate(args)), False)
        lo = loss(*(a - e if i == arg else a for i, a in enumerate(args)), False)
        fd = (hi - lo) / (2 * h)
        np.testing.assert_allclose(
            np.asarray(g[ch]), np.asarray(fd), rtol=2e-2, atol=1e-7,
            err_msg=f"path-replay grad vs FD: {name}",
        )


def test_megakernel_sky_parity():
    """Pallas env='sky' (Preetham miss + sun-lobe NEE) vs the jnp integrator."""
    from bpt_tpu.scenes.sky_scene import physical_sky_scene, sky_camera
    from bpt_tpu.scenes.types import TRANSPARENT as _T

    scene = physical_sky_scene(right_sphere_mat=_T)
    camera = sky_camera()
    cfg = IntegratorConfig(bounces=4, env="sky", nee="sun")
    ref = trace_image(scene, camera, cfg, RES, RES, 2.0, RV, BN)
    got = trace_image_pallas(
        scene, camera, cfg, RES, RES, 2.0, RV, BN, interpret=True
    )
    a = np.asarray(ref.color)
    b = np.asarray(got.color)
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() > 0.995, f"sky color parity {close.mean():.4f}"
    np.testing.assert_array_equal(np.asarray(ref.object_id), np.asarray(got.object_id))
    sh_match = (np.asarray(ref.pixel_sharpness) == np.asarray(got.pixel_sharpness)).mean()
    assert sh_match > 0.99, f"sharpness parity {sh_match:.4f}"


def test_megakernel_dof_parity():
    scene = cornell_scene()
    from bpt_tpu.camera import Camera

    camera = Camera.look(
        position=(0.0, -20.0, -120.0), fov=0.8, aperture_size=1.0, focus_distance=100.0
    )
    cfg = IntegratorConfig(bounces=2)
    ref = trace_image(scene, camera, cfg, RES, RES, 5.0, RV, BN)
    got = trace_image_pallas(
        scene, camera, cfg, RES, RES, 5.0, RV, BN, interpret=True
    )
    close = np.isclose(np.asarray(ref.color), np.asarray(got.color), rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > 0.995


# ---------------------------------------------------------------------------
# mesh (glTF-family) and HDRI-family fused paths
# ---------------------------------------------------------------------------

def _synthetic_mesh(mat_type=1, T=21):
    """Random triangle blob — exercises the escape-linked in-kernel walk."""
    from bpt_tpu.io.gltf import GLTFModel
    from bpt_tpu.scenes.gltf_scene import mesh_from_model

    rng = np.random.default_rng(0)
    c = rng.normal(0, 8, (T, 1, 3)).astype(np.float32)
    tri = (c + rng.normal(0, 3, (T, 3, 3))).astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    z2 = np.zeros((T, 2), np.float32)
    model = GLTFModel(p0=tri[:, 0], p1=tri[:, 1], p2=tri[:, 2], n0=n, n1=n,
                      n2=n, uv0=z2, uv1=z2, uv2=z2, albedo=None,
                      normal_map=None, metallic_roughness=None, emissive=None)
    return mesh_from_model(model, mat_type=mat_type)


def _lane_stats(ref, out):
    d = np.abs(np.asarray(ref.color) - np.asarray(out.color)).max(-1)
    return float(np.mean(d > 1e-3)), float(np.quantile(d, 0.95))


def test_megakernel_mesh_parity():
    """Fused in-loop BVH walk vs the wavefront integrator (glTF demo family).

    Tolerance is statistical, not elementwise: the walk shares the wavefront's
    Möller-Trumbore formulas but not its operation order, so lanes whose
    nearest-hit decision is an FP tie (silhouettes, coincident surfaces of
    the random soup) may scatter differently and diverge chaotically — the
    same reason two GPUs' images differ at isolated pixels.
    """
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

    scene = gltf_scene(_synthetic_mesh(mat_type=1))
    cfg = IntegratorConfig(bounces=2)
    cam = gltf_camera()
    h, w = 32, 128
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    out = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                             interpret=True)
    frac_bad, q95 = _lane_stats(ref, out)
    assert frac_bad < 0.01, frac_bad
    assert q95 < 1e-4, q95
    idm = np.mean(np.asarray(ref.object_id) != np.asarray(out.object_id))
    assert idm < 0.02, idm


def test_megakernel_hdri_parity():
    """Deferred-equirect HDRI path (miss-weight/direction planes + outside
    Get_HDR_Color composition) vs the wavefront integrator."""
    from apps.hdri_environment import synthetic_hdr
    from bpt_tpu.scenes.gltf_scene import hdri_camera, hdri_scene

    scene = hdri_scene(_synthetic_mesh(mat_type=1), synthetic_hdr(32, 64),
                       sun_power=4.0)
    cfg = IntegratorConfig(bounces=3, env="hdri", nee="sun",
                           sun_weight_mode="hdri", sun_lobe_roughness=0.03,
                           diffuse_indirect_max=2)
    cam = hdri_camera()
    h, w = 32, 128
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    out = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                             interpret=True)
    frac_bad, q95 = _lane_stats(ref, out)
    assert frac_bad < 0.02, frac_bad
    assert q95 < 1e-3, q95


def test_megakernel_hdri_env_nee_parity():
    """nee='env' (HDRI CDF importance sampling) on the FUSED path: the
    per-bounce inverse-CDF draws are precomputed outside the kernel from the
    same fixed-schedule RNG positions (megakernel._env_nee_planes), so fused
    and wavefront consume the identical env samples."""
    from apps.hdri_environment import synthetic_hdr
    from bpt_tpu.scenes.gltf_scene import hdri_camera, hdri_scene

    scene = hdri_scene(_synthetic_mesh(mat_type=1), synthetic_hdr(32, 64),
                       sun_power=4.0)
    cfg = IntegratorConfig(bounces=3, env="hdri", nee="env",
                           diffuse_indirect_max=2)
    cam = hdri_camera()
    h, w = 32, 128
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    out = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                             interpret=True)
    frac_bad, q95 = _lane_stats(ref, out)
    assert frac_bad < 0.02, frac_bad
    assert q95 < 1e-3, q95
    # env NEE actually fires: some shadow rays reach the env (nonzero color
    # beyond what primary misses alone produce)
    assert float(np.mean(np.asarray(out.color).max(-1) > 0.0)) > 0.5


def _textured_mesh(mr_value, emissive_value=None, T=21):
    """Random blob with per-vertex UVs, per-texel-varying albedo and spatially
    CONSTANT decision maps — per-triangle baked decisions then agree exactly
    with the wavefront's per-texel decisions, so fused/wavefront parity is
    the usual FP-tie-only story."""
    from bpt_tpu.io.gltf import GLTFModel
    from bpt_tpu.scenes.gltf_scene import mesh_from_model

    rng = np.random.default_rng(7)
    c = rng.normal(0, 8, (T, 1, 3)).astype(np.float32)
    tri = (c + rng.normal(0, 3, (T, 3, 3))).astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    uv = rng.uniform(0, 1, (T, 3, 2)).astype(np.float32)
    albedo = rng.uniform(0.1, 1.0, (32, 32, 3)).astype(np.float32)
    mr = np.tile(np.asarray(mr_value, np.float32), (8, 8, 1))
    em = (
        None if emissive_value is None
        else np.tile(np.asarray(emissive_value, np.float32), (8, 8, 1))
    )
    model = GLTFModel(p0=tri[:, 0], p1=tri[:, 1], p2=tri[:, 2], n0=n, n1=n,
                     n2=n, uv0=uv[:, 0], uv1=uv[:, 1], uv2=uv[:, 2],
                     albedo=albedo, normal_map=None,
                     metallic_roughness=mr, emissive=em)
    return mesh_from_model(model, mat_type=1)


@pytest.mark.parametrize("mr,lobe", [
    ((0.0, 0.25, 0.0), False),   # roughness>0.01 -> CLEARCOAT class
    ((0.0, 0.3, 0.8), True),     # metalness>0.01 -> METAL + roughness lobe
])
def test_megakernel_textured_pbr_parity(mr, lobe):
    """Fused deferred-PBR path (per-bounce albedo UV planes + baked
    decisions) vs the wavefront integrator with constant decision maps."""
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

    scene = gltf_scene(_textured_mesh(mr))
    cfg = IntegratorConfig(bounces=3, metal_roughness_lobe=lobe)
    cam = gltf_camera()
    h, w = 32, 128
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    out = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                             interpret=True)
    frac_bad, q95 = _lane_stats(ref, out)
    assert frac_bad < 0.02, frac_bad
    assert q95 < 1e-3, q95


def test_megakernel_textured_emissive_parity():
    """Emissive-terminal deferral: constant emissive map terminates specular
    paths as a light with the texel-exact emission value."""
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

    scene = gltf_scene(_textured_mesh((0.0, 0.25, 0.0),
                                      emissive_value=(0.4, 0.2, 0.1)))
    cfg = IntegratorConfig(bounces=3)
    cam = gltf_camera()
    h, w = 32, 128
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    out = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                             interpret=True)
    frac_bad, q95 = _lane_stats(ref, out)
    assert frac_bad < 0.02, frac_bad
    assert q95 < 1e-3, q95
    # emissive-terminated lanes exist and match
    assert float(np.mean(np.asarray(out.color).max(-1) > 0.0)) > 0.2


@pytest.mark.parametrize("mat,tint", [(4, True), (TRANSPARENT, True), (1, True)])
def test_megakernel_quadric_parity(mat, tint):
    """Fused transformed-quadric family (12 in-kernel unit intersectors incl.
    the 500-step torus march) vs the jnp integrator — the
    Transformed_Quadric_Geometry demo config (transparent_tint)."""
    from bpt_tpu.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

    scene = quadric_geometry_scene(shape_k=0.35, all_shapes_mat=mat)
    camera = quadric_camera()
    cfg = IntegratorConfig(bounces=3, transparent_tint=tint)
    h, w = 64, 128
    ref = trace_image(scene, camera, cfg, w, h, 2.0, RV, BN)
    got = trace_image_pallas(scene, camera, cfg, w, h, 2.0, RV, BN,
                             interpret=True)
    frac_bad, q95 = _lane_stats(ref, got)
    # quadric silhouettes + the torus SDF march give more FP-tie lanes than
    # the Cornell test; tolerance is statistical like the mesh test
    assert frac_bad < 0.02, frac_bad
    assert q95 < 1e-3, q95
    idm = np.mean(np.asarray(ref.object_id) != np.asarray(got.object_id))
    assert idm < 0.02, idm


def test_megakernel_hdri_gradient_parity():
    """env='hdri' differentiable fused path (mw cotangent folded into the
    path-replay backward + outer equirect composition) vs jax.grad through
    the wavefront integrator: material-color and hdr_exposure gradients."""
    from apps.hdri_environment import synthetic_hdr
    from bpt_tpu.scenes.gltf_scene import hdri_camera, hdri_scene

    base = hdri_scene(_synthetic_mesh(mat_type=1), synthetic_hdr(16, 32),
                      sun_power=4.0)
    cfg = IntegratorConfig(bounces=2, env="hdri", nee="sun",
                           sun_weight_mode="hdri", sun_lobe_roughness=0.03,
                           diffuse_indirect_max=2)
    cam = hdri_camera()
    h, w = 32, 128
    wvec = jnp.asarray([1.0, 2.0, 3.0])

    def loss(wall_c, exposure, pallas):
        quads = base.quads._replace(color=base.quads.color.at[1].set(wall_c))
        env = base.env._replace(hdr_exposure=exposure)
        s = base._replace(quads=quads, env=env)
        if pallas:
            r = trace_image_pallas(s, cam, cfg, w, h, 2.0, RV, BN,
                                   interpret=True,
                                   differentiable=True)
        else:
            r = trace_image(s, cam, cfg, w, h, 2.0, RV, BN)
        return jnp.mean(r.color * wvec)

    wc = base.quads.color[1]
    ex = jnp.asarray(1.3, jnp.float32)
    g_wc_p, g_ex_p = jax.grad(loss, argnums=(0, 1))(wc, ex, True)
    g_wc_r, g_ex_r = jax.grad(loss, argnums=(0, 1))(wc, ex, False)
    # same draws, same program -> gradients match to FP-accumulation noise
    np.testing.assert_allclose(np.asarray(g_ex_p), np.asarray(g_ex_r),
                               rtol=2e-2, err_msg="hdr_exposure grad")
    np.testing.assert_allclose(np.asarray(g_wc_p), np.asarray(g_wc_r),
                               rtol=5e-2, atol=1e-5, err_msg="wall color grad")


def test_megakernel_mesh_subpacket_parity():
    """The pixel block that shares one BVH cursor does not change any
    lane's hits: an (8, 16) and a (2, 64) block give the same image."""
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

    scene = gltf_scene(_synthetic_mesh(mat_type=1))
    cfg = IntegratorConfig(bounces=2)
    cam = gltf_camera()
    h, w = 32, 128
    square = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                                interpret=True, block=(8, 16))
    wide = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                              interpret=True, block=(2, 64))
    # identical walk math, identical RNG -> identical results (the block
    # only changes which lanes share a cursor, not any lane's hits)
    np.testing.assert_array_equal(np.asarray(square.color), np.asarray(wide.color))
    np.testing.assert_array_equal(np.asarray(square.object_id), np.asarray(wide.object_id))


# ---------------------------------------------------------------------------
# the Triton-route wrapper: block shapes, padding, backend choice
# ---------------------------------------------------------------------------

def _family(name):
    """(scene, camera, cfg) of one fused family at test scale."""
    if name == "cornell":
        return cornell_scene(right_sphere_mat=TRANSPARENT), cornell_camera(), IntegratorConfig(bounces=3)
    if name == "sky":
        from bpt_tpu.scenes.sky_scene import physical_sky_scene, sky_camera

        return physical_sky_scene(), sky_camera(), IntegratorConfig(bounces=3, env="sky", nee="sun")
    if name == "quadric":
        from bpt_tpu.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

        return (quadric_geometry_scene(shape_k=0.35), quadric_camera(),
                IntegratorConfig(bounces=2, transparent_tint=True))
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

    return (gltf_scene(_textured_mesh((0.0, 0.3, 0.8))), gltf_camera(),
            IntegratorConfig(bounces=2, metal_roughness_lobe=True))


@pytest.mark.parametrize("family,w,h", [
    ("cornell", 40, 72),
    ("cornell", 130, 1),
    ("sky", 40, 72),
    ("quadric", 72, 40),
    ("textured_mesh", 40, 72),
])
def test_megakernel_parity_at_non_block_sizes(family, w, h):
    """Images whose sides are no multiple of the pixel block are padded to
    whole blocks and cropped back: every pixel is traced, and matches the
    wavefront integrator."""
    scene, cam, cfg = _family(family)
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    got = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN, interpret=True)
    assert got.color.shape == (h, w, 3) and got.object_id.shape == (h, w)
    frac_bad, q95 = _lane_stats(ref, got)
    assert frac_bad < 0.02, frac_bad
    assert q95 < 1e-3, q95
    idm = np.mean(np.asarray(ref.object_id) != np.asarray(got.object_id))
    assert idm < 0.02, idm


@pytest.mark.parametrize("h,w,expect", [
    (1024, 1024, (8, 16)),
    (72, 40, (8, 16)),
    (1, 130, (1, 128)),
    (3, 5, (4, 8)),
])
def test_block_shape_is_power_of_two(h, w, expect):
    from bpt_tpu.kernels.megakernel import block_shape

    bh, bw = block_shape(h, w)
    assert (bh, bw) == expect
    assert bh & (bh - 1) == 0 and bw & (bw - 1) == 0
    assert bh * bw <= 128


def test_padding_and_cropping_are_block_independent():
    """Per-lane math is keyed by the absolute pixel, so two block shapes
    (different paddings: a 72x40 image pads to 72x48 with (8, 16) blocks
    and to 72x128 with (1, 128) blocks) must give bit-identical cropped
    images."""
    scene, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=2)
    w, h = 40, 72
    a = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN, interpret=True,
                           block=(8, 16))
    b = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN, interpret=True,
                           block=(1, 128))
    assert a.color.shape == b.color.shape == (h, w, 3)
    np.testing.assert_array_equal(np.asarray(a.color), np.asarray(b.color))
    np.testing.assert_array_equal(np.asarray(a.object_id), np.asarray(b.object_id))
    np.testing.assert_array_equal(np.asarray(a.pixel_sharpness),
                                  np.asarray(b.pixel_sharpness))


def test_fused_path_refuses_cpu_without_interpret():
    """No hidden fallback: off the GPU the kernel runs only when the caller
    asks for the interpreter."""
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="interpret=True"):
        trace_image_pallas(cornell_scene(), cornell_camera(), IntegratorConfig(bounces=1),
                           16, 16, 2.0, RV, BN)


def _pallas_backends(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn.params["backend"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_pallas_backends(inner))
    return out


def test_every_pallas_call_names_triton():
    """Read from the jaxpr: the forward and the differentiable call both
    lower through pallas_call with backend="triton"."""
    scene, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=1)

    def fwd(lc, differentiable):
        s = scene._replace(quads=scene.quads._replace(color=scene.quads.color.at[5].set(lc)))
        return jnp.mean(trace_image_pallas(s, cam, cfg, 16, 8, 2.0, RV, BN, interpret=True,
                                           differentiable=differentiable).color)

    lc = scene.quads.color[5]
    backends = _pallas_backends(jax.make_jaxpr(lambda x: fwd(x, False))(lc).jaxpr)
    backends += _pallas_backends(jax.make_jaxpr(jax.grad(lambda x: fwd(x, True)))(lc).jaxpr)
    assert len(backends) >= 2
    assert set(backends) == {"triton"}, backends


@pytest.mark.parametrize("family,variant", [
    ("cornell", "fwd"),
    ("cornell", "grad"),
    ("sky", "fwd"),
    ("quadric", "fwd"),
    ("mesh", "fwd"),
    ("mesh", "grad"),
    ("textured_mesh", "grad"),
    ("hdri_env", "fwd"),
])
def test_triton_lowering_verifies(family, variant):
    """Every kernel variant lowers to a Triton module that passes MLIR
    verification — on the CPU, before any card compiles it (the GPU-side
    parse rejects modules that fail this, e.g. mistyped selects)."""
    from jax._src.pallas.triton import lowering as triton_lowering

    from bpt_tpu.kernels import megakernel as mk

    if family == "mesh":
        from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

        scene = gltf_scene(_synthetic_mesh())
        cam, cfg = gltf_camera(), IntegratorConfig(bounces=2)
    elif family == "hdri_env":
        from apps.hdri_environment import synthetic_hdr
        from bpt_tpu.scenes.gltf_scene import hdri_camera, hdri_scene

        scene = hdri_scene(_synthetic_mesh(), synthetic_hdr(16, 32))
        cam = hdri_camera()
        cfg = IntegratorConfig(bounces=2, env="hdri", nee="env", diffuse_indirect_max=2)
    else:
        scene, cam, cfg = _family(family)
    h = w = 16
    packs, camp, scal = mk._setup_inputs(scene, cam, cfg, w, h, 2.0, 0)
    bn = mk._blue_noise_planes(BN, h, w, RV)
    if cfg.nee == "env":
        bn = jnp.concatenate([bn, mk._env_nee_planes(scene, cfg, 2.0, h, w)], 0)
    textured = scene.mesh is not None and scene.mesh.albedo is not None

    def fwd(p, c, s, b):
        return mk._pallas_forward(p, c, s, b, cfg, h, w, h, mk.block_shape(h, w), False,
                                  param_grads=variant == "grad",
                                  fast_quads=mk._all_parallelograms(scene.quads),
                                  mesh_textured=textured)

    jaxpr = jax.make_jaxpr(fwd)(packs, camp, scal, bn).jaxpr
    eqns = [e for e in jaxpr.eqns if e.primitive.name == "pallas_call"]
    if not eqns:  # the jitted wrapper nests the call one level down
        eqns = [e for q in jaxpr.eqns for v in q.params.values()
                for e in getattr(getattr(v, "jaxpr", None), "eqns", [])
                if e.primitive.name == "pallas_call"]
    assert len(eqns) == 1
    (eqn,) = eqns
    res = triton_lowering.lower_jaxpr_to_triton_module(
        eqn.params["jaxpr"], eqn.params["grid_mapping"], "cuda")
    assert res.module.operation.verify()


def test_megakernel_vjp_at_non_block_size():
    """Path-replay VJP on a padded image (24x40 with (8, 16) blocks pads the
    width): the gradient of the cropped image equals jax.grad through the
    wavefront integrator (same draws, same program)."""
    scene, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=2)
    w, h = 40, 24
    wvec = jnp.asarray([1.0, 2.0, 3.0])

    def loss(lc, wc, pallas):
        quads = scene.quads._replace(color=scene.quads.color.at[5].set(lc).at[1].set(wc))
        s = scene._replace(quads=quads)
        if pallas:
            r = trace_image_pallas(s, cam, cfg, w, h, 2.0, RV, BN, interpret=True,
                                   differentiable=True)
        else:
            r = trace_image(s, cam, cfg, w, h, 2.0, RV, BN)
        return jnp.mean(r.color * wvec)

    args = (scene.quads.color[5], scene.quads.color[1])
    g_p = jax.grad(loss, argnums=(0, 1))(*args, True)
    g_r = jax.grad(loss, argnums=(0, 1))(*args, False)
    for a, b in zip(g_p, g_r):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-2, atol=1e-7)


def test_split_mixed_decision_triangles():
    """A half-metal / half-diffuse MR map across two big triangles: the
    per-triangle decision bake misclassifies half of each triangle, and
    split_mixed subdivision shrinks the misclassified area — fused output
    converges toward the wavefront's per-texel decisions, while the
    wavefront image itself is unchanged (splits are exact)."""
    from bpt_tpu.io.gltf import GLTFModel
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    # floor quad; MR map: left half metal, right half plain diffuse
    p = np.array(
        [
            [[-50, -20, -50], [50, -20, 50], [50, -20, -50]],
            [[-50, -20, -50], [-50, -20, 50], [50, -20, 50]],
        ],
        np.float32,
    )
    ny = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (2, 3, 1))
    uvs = np.array([[[0, 0], [1, 1], [1, 0]], [[0, 0], [0, 1], [1, 1]]], np.float32)
    mr = np.zeros((32, 32, 3), np.float32)
    mr[:, 16:, 2] = 0.8  # metalness on the right half (u > 0.5)
    albedo = np.full((8, 8, 3), 0.7, np.float32)
    model = GLTFModel(p0=p[:, 0], p1=p[:, 1], p2=p[:, 2], n0=ny[:, 0],
                      n1=ny[:, 1], n2=ny[:, 2], uv0=uvs[:, 0], uv1=uvs[:, 1],
                      uv2=uvs[:, 2], albedo=albedo, normal_map=None,
                      metallic_roughness=mr, emissive=None)
    from bpt_tpu.camera import Camera

    cam = Camera.look(position=(0.0, 30.0, 0.0), pitch=1.5707, fov=0.5)
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    h, w = 32, 128

    def mismatch(depth):
        scene = gltf_scene(mesh_from_model(model, mat_type=1, split_mixed=depth))
        ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
        out = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN,
                                 interpret=True)
        d = np.abs(np.asarray(ref.color) - np.asarray(out.color)).max(-1)
        return float((d > 1e-3).mean())

    m0 = mismatch(0)
    m4 = mismatch(4)
    assert m0 > 0.05, f"unsplit bake should misclassify visibly, got {m0}"
    assert m4 < m0 / 2.5, f"subdivision must shrink the mismatch: {m0} -> {m4}"


def test_fused_pack_bakes_vertex_normal_map():
    """The fused dense pack's vertex normals carry the normal-map bake:
    fused first-hit normals move with the map while the wavefront applies
    the same perturbation per texel (identical where the map is constant
    per vertex-neighborhood)."""
    from bpt_tpu.io.gltf import GLTFModel
    from bpt_tpu.scenes.gltf_scene import gltf_scene, mesh_from_model

    # floor quad (+y geometric), constant tilted normal map -> exact parity
    p = np.array(
        [
            [[-50, -20, -50], [50, -20, 50], [50, -20, -50]],
            [[-50, -20, -50], [-50, -20, 50], [50, -20, 50]],
        ],
        np.float32,
    )
    ny = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (2, 3, 1))
    uvs = np.array([[[0, 0], [1, 1], [1, 0]], [[0, 0], [0, 1], [1, 1]]], np.float32)
    tilt = np.full((8, 8, 3), 0.5, np.float32)
    tilt[..., 0] = 0.8  # tangent-space +x tilt
    tilt[..., 2] = 1.0

    def scene_with(nm):
        model = GLTFModel(p0=p[:, 0], p1=p[:, 1], p2=p[:, 2], n0=ny[:, 0],
                          n1=ny[:, 1], n2=ny[:, 2], uv0=uvs[:, 0],
                          uv1=uvs[:, 1], uv2=uvs[:, 2],
                          albedo=np.full((4, 4, 3), 0.7, np.float32),
                          normal_map=nm, metallic_roughness=None, emissive=None)
        return gltf_scene(mesh_from_model(model, mat_type=1))

    from bpt_tpu.camera import Camera

    cam = Camera.look(position=(0.0, 30.0, 0.0), pitch=1.5707, fov=0.5)
    cfg = IntegratorConfig(bounces=1)
    h, w = 32, 128
    out_t = trace_image_pallas(scene_with(tilt), cam, cfg, w, h, 2.0, RV, BN,
                               interpret=True)
    ref_t = trace_image(scene_with(tilt), cam, cfg, w, h, 2.0, RV, BN)
    hitm = np.asarray(out_t.object_id) == 8.0  # mesh id: 2 spheres + 6 quads
    assert hitm.mean() > 0.8
    # fused (vertex-baked) == wavefront (per-texel) for a constant map
    np.testing.assert_allclose(
        np.asarray(out_t.object_normal)[hitm],
        np.asarray(ref_t.object_normal)[hitm], rtol=1e-4, atol=1e-5)
    # and the perturbation is real: normals are visibly tilted off +y
    assert (np.asarray(out_t.object_normal)[hitm][:, 1] < 0.95).all()
