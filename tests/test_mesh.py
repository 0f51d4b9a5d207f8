"""glTF loading, BVH build/traversal, and mesh-scene integration tests.

Uses the reference's shipped model assets as fixtures (read-only data), like
the reference's own debug pages do (SURVEY.md §4).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.accel.builder import build_bvh, triangle_aabbs
from bpt_tpu.accel.traverse import traverse_bvh
from bpt_tpu.core.vecmath import INFINITY, normalize
from bpt_tpu.geometry.triangles import bvh_triangle_intersect

MODELS = "/root/reference/models"
needs_models = pytest.mark.skipif(not os.path.isdir(MODELS), reason="reference models not mounted")


def random_soup(n=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3))
    offsets = rng.normal(0, 0.5, (n, 2, 3))
    p0 = centers.astype(np.float32)
    p1 = (centers + offsets[:, 0]).astype(np.float32)
    p2 = (centers + offsets[:, 1]).astype(np.float32)
    return p0, p1, p2


def test_bvh_build_invariants():
    p0, p1, p2 = random_soup(100)
    mn, mx, _ = triangle_aabbs(p0, p1, p2)
    bvh = build_bvh(mn, mx)
    n_nodes = bvh.node_tri.shape[0]
    assert n_nodes == 2 * 100 - 1
    leaves = bvh.node_tri[bvh.node_tri >= 0]
    assert sorted(leaves.tolist()) == list(range(100)), "every triangle in exactly one leaf"
    inner = np.where(bvh.node_tri < 0)[0]
    # right child stored, left child implicit at i+1 and inside bounds
    assert (bvh.node_right[inner] > inner).all()
    assert (bvh.node_right[inner] < n_nodes).all()
    # parent AABB contains both children's AABBs
    for i in inner[:20]:
        for child in (i + 1, bvh.node_right[i]):
            assert (bvh.node_min[i] <= bvh.node_min[child] + 1e-5).all()
            assert (bvh.node_max[i] >= bvh.node_max[child] - 1e-5).all()


def test_traversal_matches_brute_force():
    p0, p1, p2 = random_soup(128, seed=3)
    mn, mx, _ = triangle_aabbs(p0, p1, p2)
    bvh = build_bvh(mn, mx)
    rng = np.random.default_rng(7)
    ro = jnp.asarray(rng.uniform(-20, 20, (64, 3)), jnp.float32)
    rd = normalize(jnp.asarray(rng.normal(size=(64, 3)), jnp.float32))

    t, tri, u, v = traverse_bvh(
        jnp.asarray(bvh.node_tri), jnp.asarray(bvh.node_right),
        jnp.asarray(bvh.node_min), jnp.asarray(bvh.node_max),
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
        ro, rd, jnp.asarray(False), 28,
    )
    tb, _, _ = bvh_triangle_intersect(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
        ro[:, None, :], rd[:, None, :], double_sided=True,
    )
    t_brute = np.asarray(tb).min(axis=1)
    np.testing.assert_allclose(np.asarray(t), t_brute, rtol=1e-5)


@needs_models
def test_teapot_loads_and_metal_reflects():
    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.integrator.frame import trace_image
    from bpt_tpu.io import load_gltf
    from bpt_tpu.core.rng import blue_noise_table
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
    from bpt_tpu.scenes.types import METAL

    model = load_gltf(os.path.join(MODELS, "UtahTeapot.glb"), initial_scale=130.0)
    assert model.triangle_count == 992
    # winding consistent with vertex normals (single-sided culling correctness)
    geo_n = np.cross(model.p1 - model.p0, model.p2 - model.p0)
    avg_n = model.n0 + model.n1 + model.n2
    assert ((geo_n * avg_n).sum(-1) >= 0).mean() > 0.99

    mesh = mesh_from_model(model, mat_type=METAL)
    scene = gltf_scene(mesh)
    cfg = IntegratorConfig(bounces=4)
    res = trace_image(
        scene, gltf_camera(), cfg, 48, 48, 1.0,
        jnp.asarray([0.3, 0.7], jnp.float32), jnp.asarray(blue_noise_table()),
    )
    img = np.asarray(res.color)
    assert np.isfinite(img).all() and img.max() > 0
    # the mesh is visible: some first-hit ids equal the mesh object id (8:
    # 2 spheres + 6 quads precede it)
    assert (np.asarray(res.object_id) == 8.0).any()


@needs_models
def test_duck_textured_pbr_path():
    from bpt_tpu.io import load_gltf

    model = load_gltf(os.path.join(MODELS, "Duck.gltf"), initial_scale=10.0, flip_z=False)
    assert model.triangle_count > 1000
    assert model.albedo is not None and model.albedo.ndim == 3
    assert (model.uv0 >= -1).all()


@needs_models
def test_describe_gltf_and_forced_material_index():
    """The debugging-demo loader surface: asset introspection + force-sharing
    one material's texture set across the merged model
    (Debugging_GLTF_Loading.js:227-255)."""
    from bpt_tpu.io import describe_gltf, load_gltf

    path = os.path.join(MODELS, "testBookCase.gltf")
    info = describe_gltf(path)
    assert len(info["meshes"]) == 150 and len(info["materials"]) == 150
    assert all(p["mode"] == 4 for m in info["meshes"] for p in m["primitives"])

    # material[9] has no baseColorTexture -> untextured model when forced.
    assert info["materials"][9]["baseColorTexture"] is None
    untextured = load_gltf(path, material_index=9)
    assert untextured.albedo is None
    # material[2] uses image 1; the default pick (first textured) uses image 0.
    forced = load_gltf(path, material_index=2)
    default = load_gltf(path)
    assert forced.albedo is not None and default.albedo is not None
    assert forced.albedo.shape != default.albedo.shape or not np.array_equal(
        forced.albedo, default.albedo
    )
    assert forced.triangle_count == default.triangle_count == 4304


def test_bvh4_pack_covers_every_triangle_once():
    """pack_bvh4: every triangle sits in exactly one inlined leaf, every
    leaf owns whole rows inside the table, and every escape link points
    forward."""
    from bpt_tpu.accel.cluster import pack_bvh4

    n = 300
    p0, p1, p2 = random_soup(n, seed=11)
    mn, mx, _ = triangle_aabbs(p0, p1, p2)
    z2 = np.zeros((n, 2), np.float32)
    z3 = np.zeros((n, 3), np.float32)
    pk = pack_bvh4(build_bvh(mn, mx), p0, p1, p2, z3, z3, z3, z2, z2, z2, leaf_size=16)
    order = np.asarray(pk.tri_order)
    assert sorted(order[order >= 0].tolist()) == list(range(n))
    nodes = np.asarray(pk.nodes_f)
    assert nodes.shape == (pk.n_nodes, 32)
    esc = nodes[:, 28].astype(int)
    assert (esc > np.arange(pk.n_nodes)).all() and (esc <= pk.n_nodes).all()
    meta = nodes[:, 24:28]
    leaves = (-meta[meta < 0]).astype(int)
    row0, nrows = leaves // 32, leaves % 32
    assert (nrows > 0).all() and (row0 + nrows <= pk.n_rows).all()
    assert pk.tris.shape == (pk.n_rows, 128) and len(order) == 4 * pk.n_rows


def test_perturb_normal_identity_and_tilt():
    """perturbNormal semantics (GLTFModelPathTracing_FragmentShader.js:72-92):
    a flat (0.5, 0.5, 1) map is the identity; tilting the map's x channel
    rotates the normal toward the cross-trick tangent S = cross(up, n)."""
    from bpt_tpu.textures import perturb_normal

    n = normalize(jnp.asarray([[0.3, 0.1, 0.9], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]))
    uv = jnp.full((3, 2), 0.5)
    flat = jnp.full((4, 4, 3), 0.5).at[..., 2].set(1.0)
    out = perturb_normal(n, flat, uv)
    np.testing.assert_allclose(np.asarray(out), np.asarray(n), rtol=1e-5, atol=1e-6)

    # map normal tilted toward +x in tangent space
    tilted = jnp.full((4, 4, 3), 0.5).at[..., 0].set(1.0).at[..., 2].set(1.0)
    out_t = np.asarray(perturb_normal(n, tilted, uv))
    nn = np.asarray(n)
    for i in range(3):
        up = np.array([0.0, 1.0, 0.0]) if abs(nn[i, 1]) < 0.9 else np.array([1.0, 0.0, 0.0])
        s = np.cross(up, nn[i])
        s /= np.linalg.norm(s)
        mapn = np.array([0.5, 0.0, 0.5])
        mapn /= np.linalg.norm(mapn)
        expect = s * mapn[0] + nn[i] * mapn[2]
        expect /= np.linalg.norm(expect)
        np.testing.assert_allclose(out_t[i], expect, rtol=1e-5, atol=1e-6)


def test_normal_map_changes_mesh_shading_normal():
    """A synthetic bump map visibly perturbs a mesh's first-hit normals on
    both BVH walk backends, and a flat map does not."""
    from bpt_tpu.integrator.intersect import scene_intersect
    from bpt_tpu.io.gltf import GLTFModel
    from bpt_tpu.scenes.gltf_scene import mesh_from_model
    from bpt_tpu.scenes.types import Scene

    # one big floor quad split in two triangles, normals +y, uv spanning [0,1]
    # wound so the geometric normal faces +y (rays come from above;
    # textured meshes are backface-culled)
    p = np.array(
        [
            [[-50, -20, -50], [50, -20, 50], [50, -20, -50]],
            [[-50, -20, -50], [-50, -20, 50], [50, -20, 50]],
        ],
        np.float32,
    )
    uvs = np.array(
        [[[0, 0], [1, 1], [1, 0]], [[0, 0], [0, 1], [1, 1]]], np.float32
    )
    ny = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (2, 3, 1))
    rng = np.random.default_rng(3)
    bump = 0.5 + 0.3 * rng.standard_normal((16, 16, 3)).astype(np.float32)
    bump[..., 2] = 1.0
    flat = np.full((16, 16, 3), 0.5, np.float32)
    flat[..., 2] = 1.0

    def mk(nm):
        model = GLTFModel(
            p0=p[:, 0], p1=p[:, 1], p2=p[:, 2], n0=ny[:, 0], n1=ny[:, 1],
            n2=ny[:, 2], uv0=uvs[:, 0], uv1=uvs[:, 1], uv2=uvs[:, 2],
            albedo=np.full((4, 4, 3), 0.8, np.float32), normal_map=nm,
            metallic_roughness=None, emissive=None,
        )
        return Scene(mesh=mesh_from_model(model, mat_type=1))

    ro = jnp.asarray(np.stack(np.broadcast_arrays(
        np.zeros((8, 8), np.float32), 20.0, np.zeros((8, 8), np.float32)), -1))
    py, px = np.mgrid[0:8, 0:8].astype(np.float32)
    # avoid the quad's triangle-seam diagonal (x == z): FP-tie lanes miss
    rd = normalize(jnp.asarray(np.stack(
        [(px - 3.7) / 8, -np.ones_like(px), (py - 4.2) / 9], -1)))

    h_flat = scene_intersect(mk(flat), ro, rd)
    h_bump = scene_intersect(mk(bump), ro, rd)
    assert np.all(np.asarray(h_flat.t) < INFINITY)
    # flat map == identity
    np.testing.assert_allclose(
        np.asarray(h_flat.normal), np.tile([0.0, 1.0, 0.0], (8, 8, 1)), atol=1e-5
    )
    # bump map perturbs most lanes away from +y
    dev = 1.0 - np.asarray(h_bump.normal)[..., 1]
    assert (dev > 1e-3).mean() > 0.8, dev


def test_xla_walk_matches_brute_force_on_heightfield():
    """The XLA wavefront walk on a seed heightfield (a 32,768-triangle subset
    of the 524,288-triangle capacity mesh's construction) returns the
    brute-force closest hit for every lane."""
    from bpt_tpu.geometry.triangles import bvh_triangle_intersect
    from bpt_tpu.scenes.synthetic import heightfield_model

    m = heightfield_model(n_side=128, rugged=True)
    p0, p1, p2 = m.p0, m.p1, m.p2
    mn, mx, _ = triangle_aabbs(p0, p1, p2)
    bvh = build_bvh(mn, mx)
    rng = np.random.default_rng(5)
    n = 96
    ro = jnp.asarray(np.stack([rng.uniform(-30, 30, n), np.full(n, 40.0),
                               rng.uniform(-30, 30, n)], -1), jnp.float32)
    rd = normalize(jnp.asarray(np.stack([rng.normal(0, 0.1, n), -np.ones(n),
                                         rng.normal(0, 0.1, n)], -1), jnp.float32))
    t, tri, _, _ = traverse_bvh(
        jnp.asarray(bvh.node_tri), jnp.asarray(bvh.node_right),
        jnp.asarray(bvh.node_min), jnp.asarray(bvh.node_max),
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
        ro, rd, jnp.asarray(False), 28,
    )
    assert (np.asarray(tri) >= 0).all()  # downward rays all hit the field
    tb, _, _ = bvh_triangle_intersect(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
        ro[:, None, :], rd[:, None, :], double_sided=True,
    )
    np.testing.assert_allclose(np.asarray(t), np.asarray(tb).min(axis=1), rtol=1e-5)
