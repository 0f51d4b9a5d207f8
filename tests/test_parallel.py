"""Sharded-rendering equivalence and gradient-psum tests on the virtual
8-device CPU mesh — the Mesh(1) ⊆ Mesh(N) requirement from SURVEY.md §4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig
from bpt_tpu.integrator.frame import render_frame
from bpt_tpu.parallel import make_mesh, sharded_render_frame
from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

# Small res / bounce count: XLA-CPU compile time of the unrolled bounce loop
# dominates this test, and sharding correctness is independent of both.
RES = 32
BN = jnp.asarray(blue_noise_table())
RV = jnp.asarray([0.3, 0.7], jnp.float32)
CFG = IntegratorConfig(bounces=2)


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    return cornell_scene(), cornell_camera()


def test_sharded_equals_single_device(setup):
    scene, camera = setup
    prev = jnp.zeros((RES, RES, 4), jnp.float32)
    single = render_frame(scene, camera, CFG, prev, 2.0, False, RV, BN)
    for n in (2, 4, 8):
        mesh = make_mesh(jax.devices()[:n])
        # shard_map must run under jit — eager mode interprets op-by-op
        step = jax.jit(
            lambda sc, cam, pr, fc: sharded_render_frame(sc, cam, CFG, pr, fc, False, RV, BN, mesh)
        )
        sharded = step(scene, camera, prev, 2.0)
        # same RNG draws, same branches — only compilation-fusion float noise
        # (observed max ~3e-6) differs between the eager single-device run
        # and the jitted SPMD program
        np.testing.assert_allclose(
            np.asarray(single), np.asarray(sharded), rtol=1e-4, atol=1e-5,
            err_msg=f"Mesh({n}) must match the single-device render",
        )


def test_sharded_gradient_psum(setup):
    """Gradients of a replicated scene parameter through the sharded render
    must equal the single-device gradients (AD inserts the psum)."""
    scene, camera = setup
    prev = jnp.zeros((RES, RES, 4), jnp.float32)
    mesh = make_mesh(jax.devices())

    def loss_single(light_color):
        s = scene._replace(quads=scene.quads._replace(
            color=scene.quads.color.at[5].set(light_color)))
        out = render_frame(s, camera, CFG, prev, 2.0, False, RV, BN)
        return jnp.mean(out[..., :3])

    def loss_sharded(light_color):
        s = scene._replace(quads=scene.quads._replace(
            color=scene.quads.color.at[5].set(light_color)))
        out = sharded_render_frame(s, camera, CFG, prev, 2.0, False, RV, BN, mesh)
        return jnp.mean(out[..., :3])

    lc = jnp.asarray([10.0, 10.0, 10.0])
    g1 = np.asarray(jax.jit(jax.grad(loss_single))(lc))
    g8 = np.asarray(jax.jit(jax.grad(loss_sharded))(lc))
    assert np.abs(g1).sum() > 0, "light emission must have nonzero gradient"
    np.testing.assert_allclose(g8, g1, rtol=1e-5)


def test_pallas_megakernel_under_shard_map():
    """The fused Pallas kernel (interpret mode) runs under shard_map on a
    4-device row-sharded mesh through its full_height/row_offset seam and
    reproduces the unsharded fused render exactly — per-lane math is keyed
    by the absolute pixel, so row sharding cannot change any lane's result."""
    from jax.sharding import PartitionSpec as P

    from bpt_tpu.integrator.radiance import RadianceResult
    from bpt_tpu.kernels.megakernel import trace_image_pallas
    from test_kernels import _textured_mesh
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene

    scene = gltf_scene(_textured_mesh((0.0, 0.3, 0.8)))
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    cam = gltf_camera()
    h, w = 32, 128
    ref = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN, interpret=True)
    n = 4
    mesh = make_mesh(jax.devices()[:n])
    shard_rows = h // n

    def tile_fn(scene, camera, rv, bnt):
        row0 = jax.lax.axis_index("tiles") * shard_rows
        return trace_image_pallas(scene, camera, cfg, w, shard_rows, 2.0, rv, bnt,
                                  interpret=True, full_height=h, row_offset=row0)

    fn = jax.jit(jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=RadianceResult(
            color=P("tiles"), object_normal=P("tiles"),
            object_color=P("tiles"), object_id=P("tiles"),
            pixel_sharpness=P("tiles"),
        ),
        check_vma=False,
    ))
    out = fn(scene, cam, RV, BN)
    # same draws, same per-lane math; only jit-vs-eager fusion noise in the
    # texel composition differs (observed max ~1e-5, same as the wavefront
    # sharded test)
    np.testing.assert_allclose(np.asarray(out.color), np.asarray(ref.color),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.object_id),
                                  np.asarray(ref.object_id))


def test_fused_vjp_gradient_psum_under_shard_map():
    """The fused path-replay VJP under a row-sharded shard_map (scene
    replicated, dynamic row_offset): AD psums the light-emission and
    albedo-map gradients to the single-device values."""
    from jax.sharding import PartitionSpec as P

    from bpt_tpu.kernels.megakernel import trace_image_pallas
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
    from bpt_tpu.scenes.synthetic import textured_blob_model
    from bpt_tpu.textures import quad_pack

    scene = gltf_scene(mesh_from_model(textured_blob_model(), mat_type=1))
    cfg = IntegratorConfig(bounces=2, metal_roughness_lobe=True)
    cam = gltf_camera()
    h, w = 16, 32
    n = 4
    mesh = make_mesh(jax.devices()[:n])
    shard_rows = h // n

    def with_params(s, albedo, light):
        m = s.mesh._replace(albedo=albedo, albedo_q=quad_pack(albedo))
        q = s.quads._replace(color=s.quads.color.at[-1].set(light))
        return s._replace(mesh=m, quads=q)

    def loss_single(albedo, light):
        r = trace_image_pallas(with_params(scene, albedo, light), cam, cfg, w, h, 2.0,
                               RV, BN, interpret=True, differentiable=True)
        return jnp.mean(r.color)

    def loss_sharded(albedo, light):
        def tile(albedo, light, s, camera, rv, bnt):
            row0 = jax.lax.axis_index("tiles") * shard_rows
            r = trace_image_pallas(with_params(s, albedo, light), camera, cfg, w,
                                   shard_rows, 2.0, rv, bnt, interpret=True,
                                   differentiable=True, full_height=h, row_offset=row0)
            return jax.lax.psum(jnp.mean(r.color), "tiles") / n

        return jax.shard_map(tile, mesh=mesh, in_specs=(P(),) * 6, out_specs=P(),
                             check_vma=False)(albedo, light, scene, cam, RV, BN)

    args = (scene.mesh.albedo, scene.quads.color[-1])
    g1 = jax.jit(jax.grad(loss_single, argnums=(0, 1)))(*args)
    g4 = jax.jit(jax.grad(loss_sharded, argnums=(0, 1)))(*args)
    assert float(jnp.abs(g1[0]).sum()) > 0 and float(jnp.abs(g1[1]).sum()) > 0
    for a, b in zip(g4, g1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-7)


def test_sharded_denoiser_halo_exchange(setup):
    """screen_output (5x5 + 3x3 stencils) under jit with a row-sharding
    constraint equals the unsharded result exactly — proves XLA's SPMD
    partitioner materializes the 2-pixel halos across the 8 shards
    (the claim at bpt_tpu/parallel/sharding.py module docstring)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bpt_tpu.parallel import make_mesh
    from bpt_tpu.postprocess import screen_output

    scene, camera = setup
    mesh = make_mesh()
    # an accumulation buffer with structure: a few frames of a real render
    prev = jnp.zeros((RES, RES, 4), jnp.float32)
    for f in range(3):
        prev = render_frame(scene, camera, CFG, prev, float(f + 1), False, RV, BN)
    inv_n = jnp.asarray(1.0 / 3.0, jnp.float32)

    ref = np.asarray(screen_output(prev, inv_n))

    sharded_in = jax.device_put(prev, NamedSharding(mesh, P("tiles")))

    @jax.jit
    def sharded_out(buf):
        buf = jax.lax.with_sharding_constraint(buf, NamedSharding(mesh, P("tiles")))
        out = screen_output(buf, inv_n)
        return jax.lax.with_sharding_constraint(out, NamedSharding(mesh, P("tiles")))

    out = sharded_out(sharded_in)
    # result really is row-sharded over the 8 devices
    assert len(out.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(out), ref)
