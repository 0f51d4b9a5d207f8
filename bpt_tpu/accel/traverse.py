"""Vectorized BVH traversal (the SceneIntersect BVH walk as plain XLA).

The reference walks the BVH per pixel with a 28-entry stack of
(nodeID, boxT) pairs, visiting the nearer child first and pushing the
farther one (/root/reference/js/GLTFModelPathTracing_FragmentShader.js:95,
206-298).  Here the same ordered DFS runs as a *masked wavefront*: every
live lane pops/visits one node per `lax.while_loop` step, all node/triangle
reads are batched per-lane gathers, and lanes that finish idle until the
whole front drains.  Per-lane stacks are (..., DEPTH) arrays.

The ray is intersected in model object space with an *unnormalized*
direction (like the reference, :201-204), so returned t values are directly
comparable with world-space hits from other primitive groups.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bpt_tpu.core.vecmath import INFINITY, cross, dot, normal_to_world, normalize, safe_inv, transform_dir, transform_point
from bpt_tpu.integrator.intersect import Hit, _merge
from bpt_tpu.scenes.types import PBR_MATERIAL, TRANSPARENT, TriangleMesh

MAX_STACK_DEPTH = 28  # reference stack size; builder trees may demand more


def _aabb_t(node_min, node_max, ro, inv_dir, t_best):
    """Slab test returning entry-t, INFINITY when missed / behind / farther
    than the current best (pathtracing_boundingbox_intersect semantics plus
    the `boxT < t_best` traversal cull)."""
    near = (node_min - ro) * inv_dir
    far = (node_max - ro) * inv_dir
    tmin = jnp.minimum(near, far)
    tmax = jnp.maximum(near, far)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    hit = (jnp.maximum(t0, 0.0) <= t1) & (t0 < t_best)
    return jnp.where(hit, t0, INFINITY)


def _tri_t_uv(p0, p1, p2, ro, rd, cull_backface):
    """Möller–Trumbore with a *traced* backface-cull flag (the reference culls
    unless the model is untextured TRANSPARENT, GLTF...js:284-287)."""
    edge1 = p1 - p0
    edge2 = p2 - p0
    pvec = cross(rd, edge2)
    raw_det = dot(edge1, pvec)
    inv_det = safe_inv(raw_det)
    tvec = ro - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(rd, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) | (t <= 0.0)
    miss = miss | (cull_backface & (raw_det < 0.0))
    miss = miss | jnp.isnan(t)
    return jnp.where(miss, INFINITY, t), u, v


def traverse_bvh(
    node_tri, node_right, node_min, node_max, p0, p1, p2, ro, rd, cull_backface, stack_depth: int
):
    """Closest triangle hit: returns (t, tri_id, u, v) per lane.

    ro/rd: (..., 3) object-space rays (rd unnormalized).  All node and
    triangle data are gathered per lane per step.
    """
    shape = ro.shape[:-1]
    inv_dir = safe_inv(rd)

    stack_node = jnp.zeros(shape + (stack_depth,), jnp.int32)
    stack_t = jnp.full(shape + (stack_depth,), INFINITY, ro.dtype)

    root_t = _aabb_t(node_min[0], node_max[0], ro, inv_dir, jnp.full(shape, INFINITY, ro.dtype))
    stack_t = stack_t.at[..., 0].set(root_t)
    ptr = jnp.where(root_t < INFINITY, 1, 0).astype(jnp.int32)

    t_best = jnp.full(shape, INFINITY, ro.dtype)
    tri_best = jnp.full(shape, -1, jnp.int32)
    u_best = jnp.zeros(shape, ro.dtype)
    v_best = jnp.zeros(shape, ro.dtype)

    def cond(state):
        ptr, *_ = state
        return jnp.any(ptr > 0)

    def body(state):
        ptr, stack_node, stack_t, t_best, tri_best, u_best, v_best = state
        active = ptr > 0
        top = jnp.maximum(ptr - 1, 0)
        node = jnp.take_along_axis(stack_node, top[..., None], axis=-1)[..., 0]
        box_t = jnp.take_along_axis(stack_t, top[..., None], axis=-1)[..., 0]
        ptr = jnp.where(active, ptr - 1, ptr)

        # Lanes whose popped entry is already farther than their best hit
        # skip it (the reference's `if (stackLevels[...].y >= hitT) continue`).
        visit = active & (box_t < t_best)

        tri = jnp.take(node_tri, node, axis=0)
        is_leaf = visit & (tri >= 0)
        is_inner = visit & (tri < 0)

        # --- leaf: one triangle test (batched gather of 3 vertices) --------
        tid = jnp.maximum(tri, 0)
        t, u, v = _tri_t_uv(
            jnp.take(p0, tid, axis=0),
            jnp.take(p1, tid, axis=0),
            jnp.take(p2, tid, axis=0),
            ro,
            rd,
            cull_backface,
        )
        closer = is_leaf & (t < t_best)
        t_best = jnp.where(closer, t, t_best)
        tri_best = jnp.where(closer, tri, tri_best)
        u_best = jnp.where(closer, u, u_best)
        v_best = jnp.where(closer, v, v_best)

        # --- inner: test both children, near-first push --------------------
        left = node + 1
        right = jnp.take(node_right, node, axis=0)
        t_l = _aabb_t(
            jnp.take(node_min, left, axis=0), jnp.take(node_max, left, axis=0), ro, inv_dir, t_best
        )
        t_r = _aabb_t(
            jnp.take(node_min, right, axis=0), jnp.take(node_max, right, axis=0), ro, inv_dir, t_best
        )
        near_is_left = t_l <= t_r
        near_node = jnp.where(near_is_left, left, right)
        far_node = jnp.where(near_is_left, right, left)
        near_t = jnp.minimum(t_l, t_r)
        far_t = jnp.maximum(t_l, t_r)

        # push far first, then near (so near pops first)
        push_far = is_inner & (far_t < INFINITY)
        idx = jnp.minimum(ptr, stack_depth - 1)
        stack_node = jnp.where(
            push_far[..., None] & (jax.lax.broadcasted_iota(jnp.int32, stack_node.shape, stack_node.ndim - 1) == idx[..., None]),
            far_node[..., None],
            stack_node,
        )
        stack_t = jnp.where(
            push_far[..., None] & (jax.lax.broadcasted_iota(jnp.int32, stack_t.shape, stack_t.ndim - 1) == idx[..., None]),
            far_t[..., None],
            stack_t,
        )
        ptr = jnp.where(push_far, jnp.minimum(ptr + 1, stack_depth), ptr)

        push_near = is_inner & (near_t < INFINITY)
        idx = jnp.minimum(ptr, stack_depth - 1)
        stack_node = jnp.where(
            push_near[..., None] & (jax.lax.broadcasted_iota(jnp.int32, stack_node.shape, stack_node.ndim - 1) == idx[..., None]),
            near_node[..., None],
            stack_node,
        )
        stack_t = jnp.where(
            push_near[..., None] & (jax.lax.broadcasted_iota(jnp.int32, stack_t.shape, stack_t.ndim - 1) == idx[..., None]),
            near_t[..., None],
            stack_t,
        )
        ptr = jnp.where(push_near, jnp.minimum(ptr + 1, stack_depth), ptr)

        return ptr, stack_node, stack_t, t_best, tri_best, u_best, v_best

    state = (ptr, stack_node, stack_t, t_best, tri_best, u_best, v_best)
    _, _, _, t_best, tri_best, u_best, v_best = jax.lax.while_loop(cond, body, state)
    return t_best, tri_best, u_best, v_best


def intersect_mesh_bvh(mesh: TriangleMesh, ro: jnp.ndarray, rd: jnp.ndarray, best: Hit, id_base: int, active: jnp.ndarray | None = None) -> Hit:
    """Model-space BVH walk + deferred attribute fetch, merged into `best`.

    Mirrors the glTF SceneIntersect's model section
    (GLTFModelPathTracing_FragmentShader.js:201-344): ray to object space via
    the inverse model matrix, traversal, then ONE barycentric attribute
    interpolation for the winning triangle.  hitColor is forced to white
    (:334 — slots 6-7 are reserved-but-unused in the reference too);
    material type is PBR_MATERIAL when an albedo texture exists, else the
    model's uniform material (:336-343).
    """
    ro_o = transform_point(mesh.inv_matrix, ro)
    rd_o = transform_dir(mesh.inv_matrix, rd)  # NOT normalized (t commensurate)

    has_albedo = mesh.albedo is not None
    # Double-sided iff untextured TRANSPARENT (GLTF...js:284-287).
    cull = jnp.logical_not((~jnp.asarray(has_albedo)) & (mesh.mat_type == TRANSPARENT))

    stack_depth = MAX_STACK_DEPTH
    t, tri, u, v = traverse_bvh(
        mesh.node_tri,
        mesh.node_right,
        mesh.node_min,
        mesh.node_max,
        mesh.p0,
        mesh.p1,
        mesh.p2,
        ro_o,
        rd_o,
        cull,
        stack_depth,
    )

    hit_ok = tri >= 0
    tid = jnp.maximum(tri, 0)
    w = 1.0 - u - v
    n = (
        jnp.take(mesh.n0, tid, axis=0) * w[..., None]
        + jnp.take(mesh.n1, tid, axis=0) * u[..., None]
        + jnp.take(mesh.n2, tid, axis=0) * v[..., None]
    )
    uv = (
        jnp.take(mesh.uv0, tid, axis=0) * w[..., None]
        + jnp.take(mesh.uv1, tid, axis=0) * u[..., None]
        + jnp.take(mesh.uv2, tid, axis=0) * v[..., None]
    )
    n = normalize(n)
    if mesh.normal_map is not None:
        # tangent-space normal mapping on the object-space smooth normal
        # (GLTFModelPathTracing_FragmentShader.js:327-331)
        from bpt_tpu.textures import perturb_normal

        n = perturb_normal(n, mesh.normal_map, uv, packed=mesh.normal_map_q)
    n_world = normal_to_world(mesh.inv_matrix, n)

    mat = jnp.where(
        jnp.asarray(has_albedo), jnp.int32(PBR_MATERIAL), mesh.mat_type.astype(jnp.int32)
    )
    t = jnp.where(hit_ok, t, INFINITY)
    return _merge(
        best,
        t,
        n_world,
        jnp.ones(ro.shape, ro.dtype),  # hitColor = vec3(1)
        jnp.broadcast_to(mat, t.shape),
        jnp.full_like(t, float(id_base)),
        uv=uv,
    )
