"""Closest-hit over the whole scene (the SceneIntersect analog).

Evaluates every primitive group against every live ray and keeps the nearest
hit per lane — the branch-free wavefront formulation of the reference's
sequential if-chains (BabylonPathTracing_FragmentShader.js:47-112,
TransformedQuadricGeometry_FragmentShader.js:77-317,
GLTFModelPathTracing_FragmentShader.js:116-346).

Object-id numbering follows the reference's objectCount order per group:
spheres, quadrics, quads, then the mesh — ids feed the edge detector only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from bpt_tpu.core.vecmath import INFINITY, normal_to_world, normalize, transform_dir, transform_point
from bpt_tpu.geometry.quadrics import UNIT_INTERSECTORS, unit_sphere_intersect
from bpt_tpu.geometry.triangles import quad_intersect, triangle_intersect
from bpt_tpu.scenes.types import Scene, TRANSPARENT


class Hit(NamedTuple):
    t: jnp.ndarray  # (...,) distance, INFINITY on miss
    normal: jnp.ndarray  # (..., 3) unit world-space geometric/shading normal
    color: jnp.ndarray  # (..., 3)
    mat_type: jnp.ndarray  # (...,) int32
    object_id: jnp.ndarray  # (...,) float32 (edge-detector id; -INF on miss)
    uv: jnp.ndarray  # (..., 2) texture coords (mesh hits only)


def _empty_hit(shape, dtype=jnp.float32) -> Hit:
    return Hit(
        t=jnp.full(shape, INFINITY, dtype),
        normal=jnp.zeros(shape + (3,), dtype),
        color=jnp.zeros(shape + (3,), dtype),
        mat_type=jnp.full(shape, -100, jnp.int32),
        object_id=jnp.full(shape, -INFINITY, dtype),
        uv=jnp.zeros(shape + (2,), dtype),
    )


def _merge(best: Hit, t, normal, color, mat_type, object_id, uv=None) -> Hit:
    closer = t < best.t
    c3 = closer[..., None]
    return Hit(
        t=jnp.where(closer, t, best.t),
        normal=jnp.where(c3, normal, best.normal),
        color=jnp.where(c3, color, best.color),
        mat_type=jnp.where(closer, mat_type, best.mat_type),
        object_id=jnp.where(closer, object_id, best.object_id),
        uv=jnp.where(c3, uv, best.uv) if uv is not None else best.uv,
    )


def _intersect_unit_spheres(spheres, ro, rd, best: Hit, id_base: int) -> Hit:
    """Matrix-instanced unit spheres (BabylonPathTracing_FragmentShader.js:61-92).

    The object-space transform is elementwise products and sums over the
    (rays x 4x4) batch (float32 throughout — no reduced-precision matmul).
    """
    n_spheres = spheres.inv_matrix.shape[0]
    for i in range(n_spheres):  # static, tiny (2 in all demos)
        inv = spheres.inv_matrix[i]
        ro_o = transform_point(inv, ro)
        rd_o = transform_dir(inv, rd)
        t, n_obj = unit_sphere_intersect(ro_o, rd_o)
        n_world = normal_to_world(inv, normalize(n_obj))
        best = _merge(
            best,
            t,
            n_world,
            jnp.broadcast_to(spheres.color[i], ro.shape),
            jnp.broadcast_to(spheres.mat_type[i], t.shape),
            jnp.full_like(t, float(id_base + i)),
        )
    return best


def _intersect_quadrics(quadrics, ro, rd, best: Hit, id_base: int) -> Hit:
    """The 12-shape quadric set (TransformedQuadricGeometry_FragmentShader.js:77-317)."""
    for i, (_, fn) in enumerate(UNIT_INTERSECTORS):
        inv = quadrics.inv_matrix[i]
        ro_o = transform_point(inv, ro)
        rd_o = transform_dir(inv, rd)
        t, n_obj = fn(ro_o, rd_o, quadrics.shape_k)
        n_world = normal_to_world(inv, normalize(n_obj))
        best = _merge(
            best,
            t,
            n_world,
            jnp.broadcast_to(quadrics.color[i], ro.shape),
            jnp.broadcast_to(quadrics.mat_type[i], t.shape),
            jnp.full_like(t, float(id_base + i)),
        )
    return best


def _intersect_quads(quads, ro, rd, best: Hit, id_base: int) -> Hit:
    """All quads at once: broadcast rays (P, 1, 3) against quads (Nq, 3)."""
    ro_b = ro[..., None, :]
    rd_b = rd[..., None, :]
    t = quad_intersect(quads.v0, quads.v1, quads.v2, quads.v3, ro_b, rd_b, double_sided=False)
    idx = jnp.argmin(t, axis=-1)
    t_min = jnp.take_along_axis(t, idx[..., None], axis=-1)[..., 0]
    normal = normalize(quads.normal[idx])
    color = quads.color[idx]
    mat = quads.mat_type[idx]
    return _merge(best, t_min, normal, color, mat, idx.astype(jnp.float32) + float(id_base))


def scene_intersect(scene: Scene, ro: jnp.ndarray, rd: jnp.ndarray,
                    active: jnp.ndarray | None = None) -> Hit:
    """Nearest hit over all primitive groups; (..., 3) rays of any batch shape.

    ``active`` (bool, optional): lanes still alive.  Pure elementwise
    intersectors ignore it (their dead-lane results are masked by the
    caller anyway), but the packet BVH walks use it so terminated lanes'
    stale rays cannot drag the shared cursor through extra subtrees."""
    best = _empty_hit(ro.shape[:-1], ro.dtype)
    id_base = 0
    if scene.spheres is not None:
        best = _intersect_unit_spheres(scene.spheres, ro, rd, best, id_base)
        id_base += scene.spheres.inv_matrix.shape[0]
    if scene.quadrics is not None:
        best = _intersect_quadrics(scene.quadrics, ro, rd, best, id_base)
        id_base += scene.quadrics.inv_matrix.shape[0]
    if scene.quads is not None:
        best = _intersect_quads(scene.quads, ro, rd, best, id_base)
        id_base += scene.quads.v0.shape[0]
    if scene.mesh is not None:
        from bpt_tpu.accel.traverse import intersect_mesh_bvh

        best = intersect_mesh_bvh(scene.mesh, ro, rd, best, id_base, active=active)
        id_base += 1
    return best
