"""Material enum and scene pytrees (struct-of-arrays device data).

Material ids copy the reference's enum values
(/root/reference/js/PathTracingCommon.js:330-350); only the ids exercised by
the shipped demos (0-4, 10) drive integrator behavior, exactly as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

# Material type ids (PathTracingCommon.js:330-350).  The reference defines
# the full enum but its shipped demos exercise only 0-4 and 10; the remaining
# ids are declared for enum parity and, as in the reference's demo shaders,
# have no dispatch branch of their own.
SPOT_LIGHT = -2
POINT_LIGHT = -1
LIGHT = 0
DIFFUSE = 1
TRANSPARENT = 2
METAL = 3
CLEARCOAT_DIFFUSE = 4
CARCOAT = 5
TRANSLUCENT = 6
SPECSUB = 7
CHECK = 8
WATER = 9
PBR_MATERIAL = 10
WOOD = 11
SEAFLOOR = 12
TERRAIN = 13
CLOTH = 14
LIGHTWOOD = 15
DARKWOOD = 16
PAINTING = 17
METALCOAT = 18

# Environment kinds (static config, not traced).
ENV_NONE = "none"
ENV_SKY = "sky"
ENV_HDRI = "hdri"


class Quads(NamedTuple):
    """Axis-aligned-or-not quad list; the light is one of these (index
    `light_index` in Scene).  Mirrors the GLSL `Quad` struct
    (BabylonPathTracing_FragmentShader.js:20)."""

    normal: jnp.ndarray  # (N, 3)
    v0: jnp.ndarray  # (N, 3)
    v1: jnp.ndarray  # (N, 3)
    v2: jnp.ndarray  # (N, 3)
    v3: jnp.ndarray  # (N, 3)
    color: jnp.ndarray  # (N, 3) — emission radiance for LIGHT-typed quads
    mat_type: jnp.ndarray  # (N,) int32


class UnitSpheres(NamedTuple):
    """Unit spheres instanced by inverse object matrices
    (BabylonPathTracing_FragmentShader.js:61-92)."""

    inv_matrix: jnp.ndarray  # (N, 4, 4)
    color: jnp.ndarray  # (N, 3)
    mat_type: jnp.ndarray  # (N,) int32


class Quadrics(NamedTuple):
    """The transformed-quadric-geometry shape set.

    One entry per shape in the fixed order of
    `bpt_tpu.geometry.quadrics.UNIT_INTERSECTORS` (the reference's
    SceneIntersect order).  `shape_k` is the shared shape parameter uShapeK;
    `mat_type`/`color` broadcast the uniforms uAllShapesMatType etc.
    """

    inv_matrix: jnp.ndarray  # (12, 4, 4)
    shape_k: jnp.ndarray  # scalar
    color: jnp.ndarray  # (12, 3)
    mat_type: jnp.ndarray  # (12,) int32


class TriangleMesh(NamedTuple):
    """De-indexed triangle soup + flat BVH, the device-array analog of the
    reference's two 2048^2 float data textures
    (GLTF_Model_Path_Tracing.js:287-497).

    BVH layout invariant (BVH_Fast_Builder.js:389-404): node i's left child is
    i+1; `tri_or_inner` >= 0 is a leaf holding that triangle id, < 0 an inner
    node whose right child is `right_child[i]`.
    """

    # Triangle vertex data, already in model object space (RH->LH flipped,
    # pre-scaled by the model's initial scale).
    p0: jnp.ndarray  # (T, 3)
    p1: jnp.ndarray
    p2: jnp.ndarray
    n0: jnp.ndarray  # (T, 3) unit vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # (T, 2); (-1, -1) when the model has no UVs
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    # Flat BVH (M nodes).
    node_tri: jnp.ndarray  # (M,) int32: triangle id for leaves, -1 for inner
    node_right: jnp.ndarray  # (M,) int32: right-child id for inner nodes
    node_min: jnp.ndarray  # (M, 3)
    node_max: jnp.ndarray  # (M, 3)
    # Instance transform (world -> object), like uGLTF_Model_InvMatrix.
    inv_matrix: jnp.ndarray  # (4, 4)
    # Uniform material applied when there is no albedo texture
    # (uModelMaterialType, GLTFModelPathTracing_FragmentShader.js:336).
    mat_type: jnp.ndarray  # scalar int32
    # Optional PBR texture maps (None when absent). (H, W, 3) linear-decoded
    # at sample time like the shader's pow(tex, 2.2).
    albedo: Optional[jnp.ndarray] = None
    normal_map: Optional[jnp.ndarray] = None
    metallic_roughness: Optional[jnp.ndarray] = None
    emissive: Optional[jnp.ndarray] = None
    # Escape-linked BVH4 pack for the fused megakernel's in-loop walk
    # (bpt_tpu.accel.cluster.pack_bvh4): 32-float inner-node records with
    # four child boxes and inlined leaves; 4 triangle records per 128-float
    # row.  None -> the fused path refuses the scene (the wavefront walks
    # the flat BVH above).
    fz_nodes_f: Optional[jnp.ndarray] = None  # (N4, 32) f32
    fz_tris: Optional[jnp.ndarray] = None  # (R, 128) f32
    # Quad-packed (H, W, 12) twins of the PBR maps (textures.quad_pack):
    # one gather per bilinear sample instead of four — the sampling paths
    # prefer these when present (results are bit-equal).
    albedo_q: Optional[jnp.ndarray] = None
    normal_map_q: Optional[jnp.ndarray] = None
    metallic_roughness_q: Optional[jnp.ndarray] = None
    emissive_q: Optional[jnp.ndarray] = None


class Environment(NamedTuple):
    """Sun / sky / HDRI light parameters (all differentiable).

    Which pieces are *used* is decided by the static IntegratorConfig, not by
    traced values.
    """

    sun_direction: jnp.ndarray  # (3,) unit, pointing *toward* the sun
    sun_power: jnp.ndarray  # scalar (uSunPower, HDRI scenes)
    hdr_image: Optional[jnp.ndarray] = None  # (H, W, 3) float equirect
    hdr_exposure: jnp.ndarray = None  # scalar (uHDRExposure)
    #: Luminance-CDF tables for nee == "env" (bpt_tpu.env.build_env_cdf);
    #: None when only sun NEE is used.
    env_cdf: Optional[tuple] = None


class Scene(NamedTuple):
    """Everything the integrator needs, as one pytree.

    `light_index` is a static int (the reference hard-codes quads[5] as the
    light, BabylonPathTracing_FragmentShader.js:127) — kept in the pytree as a
    plain int leaf via closure in the builders.
    """

    quads: Optional[Quads] = None
    spheres: Optional[UnitSpheres] = None
    quadrics: Optional[Quadrics] = None
    mesh: Optional[TriangleMesh] = None
    env: Optional[Environment] = None


def make_quad(normal, v0, v1, v2, v3, color, mat_type):
    """Convenience row constructor for numpy-side scene assembly."""
    import numpy as np

    return (
        np.asarray(normal, np.float32),
        np.asarray(v0, np.float32),
        np.asarray(v1, np.float32),
        np.asarray(v2, np.float32),
        np.asarray(v3, np.float32),
        np.asarray(color, np.float32),
        np.int32(mat_type),
    )


def quads_from_rows(rows) -> Quads:
    import numpy as np

    cols = list(zip(*rows))
    return Quads(
        normal=jnp.asarray(np.stack(cols[0])),
        v0=jnp.asarray(np.stack(cols[1])),
        v1=jnp.asarray(np.stack(cols[2])),
        v2=jnp.asarray(np.stack(cols[3])),
        v3=jnp.asarray(np.stack(cols[4])),
        color=jnp.asarray(np.stack(cols[5])),
        mat_type=jnp.asarray(np.stack(cols[6])),
    )
