"""Fused Pallas ray-block megakernel for the Cornell-, quadric-, sky-,
glTF- and HDRI-family scenes (quads + matrix-instanced unit spheres + the 12
transformed quadrics + one BVH triangle mesh; quad-light NEE with env
"none", sun-lobe NEE with the Preetham env "sky", sun or env-CDF NEE with
env "hdri").

This is the reference's own GPU design (BabylonPathTracing_FragmentShader.js
+ pathtracing_default_main) compiled through Pallas' Triton route: one lane
per path, ray-gen → N-bounce radiance → first-hit records in one program,
with ALL per-path state (ray, mask, accumulated color, flags) in registers
for the whole bounce loop — no device-memory round trips between bounces,
which is what the unfused XLA wavefront pays for.  A program owns a small
power-of-two block of pixels; its loops (the torus march, the BVH walk)
stop when the slowest lane OF THE BLOCK finishes, not the slowest lane of
the image.

Layout: everything is component-form SoA — a 3-vector is three
(block_rows, block_cols) planes.  Small scene tables (quad vertices, sphere
inverse matrices, camera, the mesh BVH) stay in global memory and are read
by scalar loads.

RNG parity: the kernel consumes exactly the same fixed draw schedule as
bpt_tpu.integrator.radiance (4 ray-gen draws, then per bounce: blue-noise
gates ch (2b)%4,(2b+1)%4, hemisphere 2, quad-light 3), with the same
uint32 hash and mantissa-bitcast float construction — outputs match the jnp
reference to float tolerance (see tests/test_kernels.py).

Differentiation (path-replay, fused): with ``param_grads=True`` the SAME
forward kernel also emits, per object j and channel c, the plane
``s[j,c] = Σ_bounces-hitting-j ∂log f_b / ∂ color[j,c]`` — the path-replay
backpropagation sum computed during the forward replay itself (every
throughput factor is either independent of material color, linear in it,
or Beer-Lambert exp(k·log c), so ∂log f/∂c is 1/c resp. k/c).  The
custom_vjp backward is then pure elementwise math + a reduction:
``∂L/∂c[j] = Σ_pixels adj·color·s[j]`` (+ the first-hit record term via the
object-id plane) — no second kernel, no per-bounce residuals, O(1) memory
in bounce depth.  Exact for the integrator's detached-sampling estimator
wherever color > 0 (a zero channel zeroes the path's radiance, and its
gradient is detached — the documented PRB bias).  Camera/geometry params
fall back to the jnp integrator's AD (same draws ⇒ same program).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.scenes.types import (
    CLEARCOAT_DIFFUSE,
    DIFFUSE,
    LIGHT,
    METAL,
    TRANSPARENT,
    Scene,
)

INFINITY = 1.0e6
TWO_PI = 6.28318530717958648


# ---------------------------------------------------------------------------
# component-form vector helpers ((TH, W) planes)
# ---------------------------------------------------------------------------

def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _select(mask, a, b):
    """where(mask, a, b) for two constants, as planes: the Triton route
    mistypes a select between two broadcast scalar literals."""
    shape = mask.shape
    return jnp.where(mask, jnp.full(shape, a, jnp.float32), jnp.full(shape, b, jnp.float32))


def _any(mask):
    """Block-wide any() as a max-reduction (the Triton route lowers float
    reductions; it has no boolean reduce)."""
    return jnp.max(_select(mask, 1.0, 0.0)) > 0.0


def _rsqrt_safe(x):
    return jax.lax.rsqrt(jnp.maximum(x, 1e-20))


def _normalize(x, y, z):
    inv = _rsqrt_safe(_dot(x, y, z, x, y, z))
    return x * inv, y * inv, z * inv


def _safe_sqrt(x):
    return jnp.sqrt(jnp.where(x > 1e-20, x, 1e-20))


def _safe_inv(x):
    ax = jnp.abs(x)
    return jnp.sign(jnp.where(x == 0.0, 1.0, x)) / jnp.where(ax > 1e-12, ax, 1e-12)


def _reflect(ix, iy, iz, nx, ny, nz):
    d = 2.0 * _dot(nx, ny, nz, ix, iy, iz)
    return ix - d * nx, iy - d * ny, iz - d * nz


def _rng_next(sx, sy):
    """One hash draw; returns (value in [0,1), sx, sy). Matches core.rng.

    Python int literals (not jnp scalars) so the traced kernel has no
    captured array constants, which pallas_call rejects.
    """
    sx = sx + 1
    sy = sy + 1
    qx = ((sx >> 1) ^ sy) * 1103515245
    qy = ((sy >> 1) ^ sx) * 1103515245
    n = (qx ^ (qy >> 3)) * 1103515245
    bits = (n >> 9) | 0x3F800000
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0, sx, sy


def _tent(x):
    return jnp.where(
        x < 0.5, _safe_sqrt(2.0 * x) - 1.0, 1.0 - _safe_sqrt(2.0 - 2.0 * x)
    )


# ---------------------------------------------------------------------------
# component-form unit-space quadric intersectors
#
# Mirrors bpt_tpu.geometry.quadrics (itself mirroring the GLSL includes of
# /root/reference/js/PathTracingCommon.js:646-1163) with every vec3 as three
# (TH, W) planes.  Each returns (t, nx, ny, nz); t = INFINITY on miss; the
# normal is the unnormalized object-space gradient.
# ---------------------------------------------------------------------------

def _solve_quadratic_c(a, b, c):
    inv_a = _safe_inv(a)
    b = b * inv_a
    c = c * inv_a
    nhb = -b * 0.5
    u2 = nhb * nhb - c
    real = u2 >= 0.0
    u = jnp.where(real, _safe_sqrt(u2), 0.0)
    nhb = jnp.where(real, nhb, 0.0)
    return nhb - u, nhb + u


def _pick2(t0, n0, ok0, t1, n1, ok1):
    t = jnp.where(ok0, t0, jnp.where(ok1, t1, INFINITY))
    n = tuple(
        jnp.where(ok0, a, jnp.where(ok1, b, m))
        for a, b, m in zip(n0, n1, (t * 0.0, t * 0.0 + 1.0, t * 0.0))
    )
    return t, n[0], n[1], n[2]


def _prio_chain(cands):
    """GLSL if-chain: first valid candidate wins (reversed-select loop)."""
    t_out = jnp.full_like(cands[0][0], INFINITY)
    nx = t_out * 0.0
    ny = nx + 1.0
    nz = nx
    for tc, (cx, cy, cz), ok in reversed(cands):
        t_out = jnp.where(ok, tc, t_out)
        nx = jnp.where(ok, cx, nx)
        ny = jnp.where(ok, cy, ny)
        nz = jnp.where(ok, cz, nz)
    return t_out, nx, ny, nz


def _hit_at(ro, rd, t):
    return tuple(o + d * t for o, d in zip(ro, rd))


def _q_sphere(ro, rd, k):
    a = _dot(*rd, *rd)
    b = 2.0 * _dot(*rd, *ro)
    c = _dot(*ro, *ro) - 1.0
    t0, t1 = _solve_quadratic_c(a, b, c)
    return _pick2(t0, _hit_at(ro, rd, t0), t0 > 0.0, t1, _hit_at(ro, rd, t1), t1 > 0.0)


def _cyl_parts(ro, rd, r2_minus=1.0):
    a = rd[0] * rd[0] + rd[2] * rd[2]
    b = 2.0 * (rd[0] * ro[0] + rd[2] * ro[2])
    c = ro[0] * ro[0] + ro[2] * ro[2] - r2_minus
    return _solve_quadratic_c(a, b, c)


def _cyl_n(h):
    return (2.0 * h[0], h[1] * 0.0, 2.0 * h[2])


def _q_cylinder(ro, rd, k):
    t0, t1 = _cyl_parts(ro, rd)
    h0 = _hit_at(ro, rd, t0)
    h1 = _hit_at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (jnp.abs(h0[1]) <= 1.0)
    ok1 = (t1 > 0.0) & (jnp.abs(h1[1]) <= 1.0)
    return _pick2(t0, _cyl_n(h0), ok0, t1, _cyl_n(h1), ok1)


def _q_cone(ro, rd, k):
    k = jnp.clip(k, 0.01, 1.0)
    j = 1.0 / k
    h = j * 2.0 - 1.0
    kq = k * 0.25
    a = j * rd[0] * rd[0] + j * rd[2] * rd[2] - kq * rd[1] * rd[1]
    b = 2.0 * (j * rd[0] * ro[0] + j * rd[2] * ro[2] - kq * rd[1] * (ro[1] - h))
    c = j * ro[0] * ro[0] + j * ro[2] * ro[2] - kq * (ro[1] - h) * (ro[1] - h)
    t0, t1 = _solve_quadratic_c(a, b, c)

    def nrm(hh):
        return (2.0 * hh[0] * j, 2.0 * (h - hh[1]) * kq, 2.0 * hh[2] * j)

    h0 = _hit_at(ro, rd, t0)
    h1 = _hit_at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (jnp.abs(h0[1]) <= 1.0)
    ok1 = (t1 > 0.0) & (jnp.abs(h1[1]) <= 1.0)
    return _pick2(t0, nrm(h0), ok0, t1, nrm(h1), ok1)


def _q_paraboloid(ro, rd, k):
    kp = 0.5
    a = rd[0] * rd[0] + rd[2] * rd[2]
    b = 2.0 * (rd[0] * ro[0] + rd[2] * ro[2]) + kp * rd[1]
    c = ro[0] * ro[0] + ro[2] * ro[2] + kp * (ro[1] - 1.0)
    t0, t1 = _solve_quadratic_c(a, b, c)

    def nrm(hh):
        return (2.0 * hh[0], hh[1] * 0.0 + 0.5, 2.0 * hh[2])

    h0 = _hit_at(ro, rd, t0)
    h1 = _hit_at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (jnp.abs(h0[1]) <= 1.0)
    ok1 = (t1 > 0.0) & (jnp.abs(h1[1]) <= 1.0)
    return _pick2(t0, nrm(h0), ok0, t1, nrm(h1), ok1)


def _q_hyperboloid(ro, rd, k):
    k = (k * k * k * k + 0.0012) * 1000.0
    j = k - 1.0
    a = k * rd[0] * rd[0] + k * rd[2] * rd[2] - j * rd[1] * rd[1]
    b = 2.0 * (k * rd[0] * ro[0] + k * rd[2] * ro[2] - j * rd[1] * ro[1])
    c = k * ro[0] * ro[0] + k * ro[2] * ro[2] - j * ro[1] * ro[1] - 1.0

    t0, t1 = _solve_quadratic_c(a, b, c)

    def nrm(hh):
        return (2.0 * hh[0] * k, -2.0 * hh[1] * j, 2.0 * hh[2] * k)

    h0 = _hit_at(ro, rd, t0)
    h1 = _hit_at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (jnp.abs(h0[1]) <= 1.0)
    ok1 = (t1 > 0.0) & (jnp.abs(h1[1]) <= 1.0)
    return _pick2(t0, nrm(h0), ok0, t1, nrm(h1), ok1)


def _q_capsule(ro, rd, k):
    k = k + 0.25
    a_s = _dot(*rd, *rd)

    def cap(off):
        ey = ro[1] - off
        b = 2.0 * (rd[0] * ro[0] + rd[1] * ey + rd[2] * ro[2])
        c = ro[0] * ro[0] + ey * ey + ro[2] * ro[2] - 1.0
        return _solve_quadratic_c(a_s, b, c)

    s0t0, s0t1 = cap(k)
    s1t0, s1t1 = cap(-k)
    t0, t1 = _cyl_parts(ro, rd)

    def cap_n(t, off):
        hh = _hit_at(ro, rd, t)
        return (2.0 * hh[0], 2.0 * (hh[1] - off), 2.0 * hh[2])

    def hy(t):
        return ro[1] + rd[1] * t

    cands = [
        (s0t0, cap_n(s0t0, k), (s0t0 > 0.0) & (hy(s0t0) >= k)),
        (s1t0, cap_n(s1t0, -k), (s1t0 > 0.0) & (hy(s1t0) <= -k)),
        (t0, _cyl_n(_hit_at(ro, rd, t0)), (t0 > 0.0) & (jnp.abs(hy(t0)) <= k)),
        (s0t1, cap_n(s0t1, k), (s0t1 > 0.0) & (hy(s0t1) >= k)),
        (s1t1, cap_n(s1t1, -k), (s1t1 > 0.0) & (hy(s1t1) <= -k)),
        (t1, _cyl_n(_hit_at(ro, rd, t1)), (t1 > 0.0) & (jnp.abs(hy(t1)) <= k)),
    ]
    return _prio_chain(cands)


def _q_flattened_ring(ro, rd, k):
    k = k - 0.01
    t0, t1 = _cyl_parts(ro, rd)
    c0, c1 = _cyl_parts(ro, rd, r2_minus=k)
    inv_rdy = _safe_inv(rd[1])
    d0 = -(ro[1] - 1.0) * inv_rdy
    d1 = -(ro[1] + 1.0) * inv_rdy

    def disk_ok(d):
        hh = _hit_at(ro, rd, d)
        x2z2 = hh[0] * hh[0] + hh[2] * hh[2]
        return (d > 0.0) & (x2z2 <= 1.0) & (x2z2 > k)

    def side_ok(t):
        return (t > 0.0) & (jnp.abs(ro[1] + rd[1] * t) <= 1.0)

    z = ro[0] * 0.0
    up = (z, z + 1.0, z)
    down = (z, z - 1.0, z)
    cands = [
        (t0, _cyl_n(_hit_at(ro, rd, t0)), side_ok(t0)),
        (d0, up, (rd[1] < 0.0) & disk_ok(d0)),
        (d1, down, (rd[1] > 0.0) & disk_ok(d1)),
        (c0, _cyl_n(_hit_at(ro, rd, c0)), side_ok(c0)),
        (c1, _cyl_n(_hit_at(ro, rd, c1)), side_ok(c1)),
        (t1, _cyl_n(_hit_at(ro, rd, t1)), side_ok(t1)),
        (d0, up, (rd[1] > 0.0) & disk_ok(d0)),
        (d1, down, (rd[1] < 0.0) & disk_ok(d1)),
    ]
    return _prio_chain(cands)


def _q_box(ro, rd, k):
    inv = tuple(_safe_inv(d) for d in rd)
    near = tuple((-1.0 - o) * i for o, i in zip(ro, inv))
    far = tuple((1.0 - o) * i for o, i in zip(ro, inv))
    tmin = tuple(jnp.minimum(n, f) for n, f in zip(near, far))
    tmax = tuple(jnp.maximum(n, f) for n, f in zip(near, far))
    t0 = jnp.maximum(jnp.maximum(tmin[0], tmin[1]), tmin[2])
    t1 = jnp.minimum(jnp.minimum(tmax[0], tmax[1]), tmax[2])

    def enter_n(i):
        a, b = (i + 1) % 3, (i + 2) % 3
        ge = (tmin[i] >= tmin[a]) & (tmin[i] >= tmin[b])
        return -jnp.sign(rd[i]) * _select(ge, 1.0, 0.0)

    def exit_n(i):
        a, b = (i + 1) % 3, (i + 2) % 3
        le = (tmax[i] <= tmax[a]) & (tmax[i] <= tmax[b])
        return -jnp.sign(rd[i]) * _select(le, 1.0, 0.0)

    ok = t0 < t1
    ok0 = ok & (t0 > 0.0)
    ok1 = ok & (t1 > 0.0)
    return _pick2(
        t0, (enter_n(0), enter_n(1), enter_n(2)), ok0,
        t1, (exit_n(0), exit_n(1), exit_n(2)), ok1,
    )


def _q_pyramid_frustum(ro, rd, k):
    k = jnp.clip(k, 0.01, 1.0)
    j = 1.0 / k
    h = j * 2.0 - 1.0
    kq = k * 0.25

    def side(main, other):
        a = j * rd[main] * rd[main] - kq * rd[1] * rd[1]
        b = 2.0 * (j * rd[main] * ro[main] - kq * rd[1] * (ro[1] - h))
        c = j * ro[main] * ro[main] - kq * (ro[1] - h) * (ro[1] - h)
        t0, t1 = _solve_quadratic_c(a, b, c)

        def valid(t):
            hh = _hit_at(ro, rd, t)
            inside_other = (j * hh[other] * hh[other] - kq * (hh[1] - h) * (hh[1] - h)) <= 0.0
            return (
                (t > 0.0)
                & (jnp.abs(hh[0]) <= 1.0)
                & (jnp.abs(hh[2]) <= 1.0)
                & (hh[1] <= 1.0)
                & inside_other
            )

        def nrm(t):
            hh = _hit_at(ro, rd, t)
            cm = 2.0 * hh[main] * j
            cy = 2.0 * (hh[1] - h) * -kq
            z = cy * 0.0
            return (cm, cy, z) if main == 0 else (z, cy, cm)

        ok0 = valid(t0)
        ok1 = valid(t1) & ~ok0
        return _pick2(t0, nrm(t0), ok0, t1, nrm(t1), ok1)

    xt, xnx, xny, xnz = side(0, 2)
    zt, znx, zny, znz = side(2, 0)
    use_x = xt <= zt
    return (
        jnp.where(use_x, xt, zt),
        jnp.where(use_x, xnx, znx),
        jnp.where(use_x, xny, zny),
        jnp.where(use_x, xnz, znz),
    )


def _plane_y0(ro, rd):
    return -ro[1] * _safe_inv(rd[1])


def _q_disk(ro, rd, k):
    t = _plane_y0(ro, rd)
    hh = _hit_at(ro, rd, t)
    ok = (t > 0.0) & (hh[0] * hh[0] + hh[2] * hh[2] <= 1.0)
    z = t * 0.0
    return jnp.where(ok, t, INFINITY), z, z + 1.0, z


def _q_rectangle(ro, rd, k):
    t = _plane_y0(ro, rd)
    hh = _hit_at(ro, rd, t)
    ok = (t > 0.0) & (jnp.abs(hh[0]) <= 1.0) & (jnp.abs(hh[2]) <= 1.0)
    z = t * 0.0
    return jnp.where(ok, t, INFINITY), z, z + 1.0, z


def _map_torus_c(px, py, pz, k):
    ring = _safe_sqrt(px * px + pz * pz) - (1.0 - k)
    return _safe_sqrt(ring * ring + py * py) - k


def _q_torus(ro, rd, k, max_steps=500):
    """Analytic bound + frozen-lane SDF march (PathTracingCommon.js:1101-1163);
    semantics of geometry.quadrics.unit_torus_intersect."""
    k = 1.0 - jnp.clip(k, 0.01, 0.99)
    t0, t1 = _cyl_parts(ro, rd)
    tc = jnp.where(
        (t0 > 0.0) & (jnp.abs(ro[1] + rd[1] * t0) <= k),
        t0,
        jnp.where((t1 > 0.0) & (jnp.abs(ro[1] + rd[1] * t1) <= k), t1, INFINITY),
    )
    inv_rdy = _safe_inv(rd[1])

    def disk(off):
        d = -(ro[1] + off) * inv_rdy
        hh = _hit_at(ro, rd, d)
        ok = (d > 0.0) & (hh[0] * hh[0] + hh[2] * hh[2] <= 1.0)
        return jnp.where(ok, d, INFINITY)

    t_start = jnp.minimum(jnp.minimum(disk(k), disk(-k)), tc)
    bounded = t_start < INFINITY
    t_m0 = jnp.where(bounded, t_start, 0.0)

    def cond(carry):
        # early exit once every lane froze (converged or out of range):
        # most tiles finish in tens of steps, not the 500-step worst case
        step, t, d = carry
        live = (jnp.abs(d) >= 0.01) & (t - t_m0 <= 8.0)
        return (step < max_steps) & _any(live)

    def body(carry):
        step, t, d = carry
        live = (jnp.abs(d) >= 0.01) & (t - t_m0 <= 8.0)
        d_new = _map_torus_c(ro[0] + rd[0] * t, ro[1] + rd[1] * t, ro[2] + rd[2] * t, k)
        t = jnp.where(live & (jnp.abs(d_new) >= 0.01), t + d_new, t)
        d = jnp.where(live, d_new, d)
        return step + 1, t, d

    _, t_m, d_m = jax.lax.while_loop(
        cond, body, (jnp.int32(0), t_m0, jnp.full_like(t_m0, INFINITY))
    )
    converged = bounded & (jnp.abs(d_m) < 0.01)
    px, py, pz = _hit_at(ro, rd, t_m)
    e = 0.5773 * 0.0002
    offs = ((e, -e, -e), (-e, -e, e), (-e, e, -e), (e, e, e))
    nx = px * 0.0
    ny = nx
    nz = nx
    for ox, oy, oz in offs:
        m = _map_torus_c(px + ox, py + oy, pz + oz, k)
        nx = nx + ox * m
        ny = ny + oy * m
        nz = nz + oz * m
    return (
        jnp.where(converged, t_m, INFINITY),
        jnp.where(converged, nx, 0.0),
        jnp.where(converged, ny, 1.0),
        jnp.where(converged, nz, 0.0),
    )


def _safe_inv_slab(x):
    """1/x for the AABB slab test: zeros map to a huge finite value whose
    sign is immaterial under the min/max slab ordering."""
    return jnp.where(jnp.abs(x) < 1e-20, 1e20, 1.0 / jnp.where(x == 0.0, 1.0, x))


def _mesh_walk(ro_o, rd_o, cull, nodes_ref, tris_ref, n_nodes, t_init, active=None, textured=False):
    """Escape-linked BVH4 walk of ONE block of rays — the fused-kernel analog
    of the reference's 28-deep per-pixel stack traversal
    (GLTFModelPathTracing_FragmentShader.js:206-298).  The block shares one
    scalar node cursor: every slab test / triangle test is a block-wide
    vector op on node and leaf values read by scalar loads from global
    memory, and subtrees no lane enters are skipped through the escape link
    (see bpt_tpu.accel.cluster.Bvh4BVH).

    ro_o/rd_o: component tuples of (rows, cols) object-space planes (rd
    unnormalized so t is world-commensurate).  cull: traced bool scalar.
    t_init: current closest-hit plane — subtrees and triangles beyond it are
    pruned, and only strictly closer mesh hits are reported.  active (bool
    plane or None): lanes allowed to steer the shared cursor; inactive
    lanes' results are garbage the caller already masks out.

    Returns (t, nx, ny, nz, u, v, hit) with the interpolated *object-space*
    shading normal (unnormalized) and texture UV; hit = lane found a
    triangle closer than t_init.  With ``textured=True`` three more planes
    follow hit: the winning triangle's baked PBR decision attributes
    (mat_class, roughness, emissive_flag — record floats 24..26, see
    scenes.gltf_scene.bake_triangle_attrs).
    """
    rox, roy, roz = ro_o
    rdx, rdy, rdz = rd_o
    invx = _safe_inv_slab(rdx)
    invy = _safe_inv_slab(rdy)
    invz = _safe_inv_slab(rdz)
    zeros = jnp.zeros(rox.shape, jnp.float32)
    n_extra = 3 if textured else 0

    def interp(c5, closer, u, v, rec):
        """Merge one triangle's interpolated normal/UV (+ baked attrs) into
        the lanes where it is the new closest hit; rec(c) reads its record."""
        nx, ny, nz, us, vs, *attrs = c5
        w = 1.0 - u - v
        inx = w * rec(9) + u * rec(12) + v * rec(15)
        iny = w * rec(10) + u * rec(13) + v * rec(16)
        inz = w * rec(11) + u * rec(14) + v * rec(17)
        iu = w * rec(18) + u * rec(20) + v * rec(22)
        iv = w * rec(19) + u * rec(21) + v * rec(23)
        nx = jnp.where(closer, inx, nx)
        ny = jnp.where(closer, iny, ny)
        nz = jnp.where(closer, inz, nz)
        us = jnp.where(closer, iu, us)
        vs = jnp.where(closer, iv, vs)
        if textured:
            # baked PBR decision attrs (class, rough, emissive)
            attrs = [jnp.where(closer, rec(24 + a), attrs[a]) for a in range(3)]
        return (nx, ny, nz, us, vs, *attrs)

    def mt_rows(row0, nrows, st):
        """Möller-Trumbore over dense rows [row0, row0 + nrows), four
        32-float triangle records per row."""

        def row_body(k, st):
            r = row0 + k

            def record(j, st):
                t_best, *rest = st

                def rec(c):
                    return tris_ref[r, 32 * j + c]

                p0x, p0y, p0z = rec(0), rec(1), rec(2)
                e1x, e1y, e1z = rec(3) - p0x, rec(4) - p0y, rec(5) - p0z
                e2x, e2y, e2z = rec(6) - p0x, rec(7) - p0y, rec(8) - p0z
                pvx = rdy * e2z - rdz * e2y
                pvy = rdz * e2x - rdx * e2z
                pvz = rdx * e2y - rdy * e2x
                det = e1x * pvx + e1y * pvy + e1z * pvz
                inv_det = _safe_inv_slab(det)
                tvx, tvy, tvz = rox - p0x, roy - p0y, roz - p0z
                u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
                qvx = tvy * e1z - tvz * e1y
                qvy = tvz * e1x - tvx * e1z
                qvz = tvx * e1y - tvy * e1x
                v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
                t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
                miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0) | (t <= 0.0)
                miss = miss | (cull & (det < 0.0))
                closer = jnp.logical_not(miss) & (t < t_best)
                t_best = jnp.where(closer, t, t_best)
                rest = interp(tuple(rest), closer, u, v, rec)
                return (t_best, *rest)

            return jax.lax.fori_loop(0, 4, record, st)

        return jax.lax.fori_loop(0, nrows, row_body, st)

    def step(i, t_best):
        """Record i: slab-test the 4 child boxes -> (per-child any-hit
        scalars, per-child meta scalars, escape)."""
        ms = []
        for k in range(4):
            def N(c, o=6 * k):
                return nodes_ref[i, o + c]

            tx0 = (N(0) - rox) * invx
            tx1 = (N(3) - rox) * invx
            ty0 = (N(1) - roy) * invy
            ty1 = (N(4) - roy) * invy
            tz0 = (N(2) - roz) * invz
            tz1 = (N(5) - roz) * invz
            tmin = jnp.maximum(
                jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
                jnp.minimum(tz0, tz1),
            )
            tmax = jnp.minimum(
                jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
                jnp.maximum(tz0, tz1),
            )
            hit = (jnp.maximum(tmin, 0.0) <= tmax) & (tmin < t_best)
            if active is not None:
                # dead lanes (terminated paths) must not drag the block into
                # subtrees: their stale rays still intersect boxes otherwise
                hit = hit & active
            ms.append(_any(hit))
        meta = [nodes_ref[i, 24 + k] for k in range(4)]
        esc = nodes_ref[i, 28].astype(jnp.int32)
        return ms, meta, esc

    def body(c):
        i, *st = c
        ms, meta, esc = step(i, st[0])
        hits = [m.astype(jnp.int32) for m in ms]

        def child(k, st):
            # leaf children are processed in a loop (one copy of the leaf
            # code): meta < 0 is an inlined leaf, -(row_start * 32 + rows)
            hit = jnp.where(k == 0, hits[0], jnp.where(
                k == 1, hits[1], jnp.where(k == 2, hits[2], hits[3]))) > 0
            meta_k = nodes_ref[i, 24 + k]
            enc = (-meta_k).astype(jnp.int32)
            row0 = enc // 32
            nrows = enc - row0 * 32
            def leaf_fn(s):
                return mt_rows(row0, nrows, s)

            return jax.lax.cond(hit & (meta_k < 0.0), leaf_fn, lambda s: s, st)

        st = jax.lax.fori_loop(0, 4, child, tuple(st))
        # descend into the FIRST hit inner child; later hit inner children
        # are reached through the sibling escape chain
        next_i = esc
        for k in (3, 2, 1, 0):
            next_i = jnp.where(ms[k] & (meta[k] > 0.0),
                               meta[k].astype(jnp.int32), next_i)
        return (next_i, *st)

    carry = (jnp.int32(0), t_init, zeros, zeros, zeros, zeros, zeros)
    carry = carry + (zeros,) * n_extra
    _, t_best, nx, ny, nz, us, vs, *attrs = jax.lax.while_loop(
        lambda c: c[0] < n_nodes, body, carry)
    return (t_best, nx, ny, nz, us, vs, t_best < t_init, *attrs)

def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _acos01(x):
    """acos for x in [0, 1]: Abramowitz & Stegun 4.4.45 (|err| < 6.8e-5 rad).
    One polynomial for every backend; the error is far inside the sky's
    tolerance."""
    return _safe_sqrt(1.0 - x) * (
        1.5707288 + x * (-0.2121144 + x * (0.0742610 - 0.0187293 * x))
    )


def _pow_c(x, p):
    """x**p for x >= 0 via exp/log."""
    return jnp.exp(p * jnp.log(jnp.maximum(x, 1e-20)))


def _sky_color_c(rdx, rdy, rdz, sunx, suny, sunz, sun_e, gamma, blend):
    """Preetham sky in component form — Get_Sky_Color
    (PathTracingCommon.js:430-475), same math as bpt_tpu.sky.get_sky_color.

    rd* are unit-direction planes; sun* are scalars; sun_e (sun
    intensity), gamma (sunfade exponent) and blend (horizon mix weight) are
    precomputed host-side scalars (pure functions of the sun direction).
    Returns (r, g, b) radiance planes.
    """
    import math

    from bpt_tpu import sky as _sky

    import numpy as _np

    mie_const = _np.array([1.8399918514433978e14, 2.7798023919660528e14, 4.0790479543861094e14])
    total_mie = 0.434 * ((0.2 * _sky.TURBIDITY) * 10e-18) * mie_const
    rayleigh = _np.array([5.804542996261093e-6, 1.3562911419845635e-5, 3.0265902468824876e-5])
    rayleigh_at = [float(v) * _sky.RAYLEIGH_COEFFICIENT for v in rayleigh]
    mie_at = [float(v) * _sky.MIE_COEFFICIENT for v in total_mie]
    night = (0.0, 0.0003, 0.00075)

    cos_vs = rdx * sunx + rdy * suny + rdz * sunz
    x_uv = jnp.clip(jnp.maximum(0.0, rdy), 0.0, 1.0)
    zenith = _acos01(x_uv)
    # cos(zenith) == x_uv by construction
    inverse = 1.0 / (
        x_uv + 0.15 * _pow_c(jnp.maximum(93.885 - zenith * (180.0 / math.pi), 1e-6), -1.253)
    )
    r_opt = _sky.RAYLEIGH_ZENITH_LENGTH * inverse
    m_opt = _sky.MIE_ZENITH_LENGTH * inverse

    r_phase = 3.0 / (16.0 * math.pi) * (1.0 + (cos_vs * 0.5 + 0.5) ** 2)
    g2 = _sky.MIE_DIRECTIONAL_G * _sky.MIE_DIRECTIONAL_G
    hg_x = jnp.maximum(0.0, 1.0 - 2.0 * _sky.MIE_DIRECTIONAL_G * cos_vs + g2)
    hg_den = hg_x * _safe_sqrt(hg_x)
    m_phase = (1.0 / (4.0 * math.pi)) * ((1.0 - g2) / jnp.maximum(hg_den, 1e-20))

    sundisk = _smoothstep(
        _sky.SUN_ANGULAR_DIAMETER_COS, _sky.SUN_ANGULAR_DIAMETER_COS + 0.00002, cos_vs
    )

    out = []
    for c in range(3):
        fex = jnp.exp(-(rayleigh_at[c] * r_opt + mie_at[c] * m_opt))
        ratio = (rayleigh_at[c] * r_phase + mie_at[c] * m_phase) / (
            rayleigh_at[c] + mie_at[c]
        )
        y = jnp.maximum(sun_e * ratio * (1.0 - fex), 0.0)
        lin = y * _safe_sqrt(y)
        lin = lin * (
            (1.0 - blend) + blend * _safe_sqrt(jnp.maximum(sun_e * ratio * fex, 0.0))
        )
        l0 = 0.1 * fex + sun_e * 19000.0 * fex * sundisk
        tex = (lin + l0) * 0.04 + night[c]
        out.append(_pow_c(tex, gamma))
    return out[0], out[1], out[2]


# In the reference's SceneIntersect order
# (TransformedQuadricGeometry_FragmentShader.js:77-317) — must match
# bpt_tpu.geometry.quadrics.UNIT_INTERSECTORS.
_QUADRIC_INTERSECTORS = (
    _q_sphere,
    _q_cylinder,
    _q_cone,
    _q_paraboloid,
    _q_hyperboloid,
    _q_capsule,
    _q_flattened_ring,
    _q_box,
    _q_pyramid_frustum,
    _q_disk,
    _q_rectangle,
    _q_torus,
)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _make_kernel(cfg: IntegratorConfig, n_quads: int, n_spheres: int, n_quadrics: int, block_rows: int, block_cols: int, width: int, height: int, param_grads: bool = False, has_mesh: bool = False, n_nodes: int = 0, fast_quads: bool = False, mesh_textured: bool = False):
    """Kernel body for one (block_rows, block_cols) pixel block.  ``width``
    and ``height`` are the FULL image's (NDC); a row-sharded call adds its
    first absolute row from scalars[10]."""
    eps = cfg.eps_intersect
    light_i = cfg.light_index if cfg.light_index >= 0 else n_quads - 1
    n_obj = n_spheres + n_quadrics + n_quads
    env_sky = cfg.env == "sky"
    env_hdri = cfg.env == "hdri"
    has_quad_light = cfg.nee == "quad"
    # env importance-sampling NEE (wavefront radiance.py:267-284): the
    # inverse-CDF draw is a pure function of (pixel, frame, bounce) under the
    # fixed schedule, so it is precomputed OUTSIDE the kernel
    # (trace_image_pallas) and arrives as 4 extra planes per bounce appended
    # to the blue-noise stack: direction xyz + weight-base 1/(pi*max(pdf,eps)).
    env_nee = cfg.nee == "env"
    assert not (env_nee and has_quad_light)
    use_lobe = (cfg.nee in ("sun", "env")) or cfg.metal_roughness_lobe
    shape = (block_rows, block_cols)

    def kernel(*args):
        # cam (16,): pos3 right3 up3 fwd3 ulen vlen aperture focus
        # scalars (17,): frame_counter, camera_is_moving (0/1), shape_k,
        #   sun_dir xyz, sun_power, sky sun_e, sky gamma, sky horizon blend,
        #   first absolute image row of this call, sun ONB u xyz, v xyz
        # quads (n_quads, 20): n3 v0..v3(12) color3 mat pad
        # [spheres] (n_spheres, 21): inv 4x4 row-major (16) color3 mat pad
        # [quadrics] (12, 20): inv(16) color3 mat, UNIT_INTERSECTORS order
        # [mesh] mesh_s (18,): inv(16) mat cull; nodes (N4, 32) BVH4
        #   records; tris (R, 128) triangle rows (accel.cluster.Bvh4BVH)
        # bn (n_draw, BR, BC) block; then 11 (BR, BC) outputs (+6 miss-weight
        # /dir planes when env == "hdri": the equirect fetch is deferred to
        # XLA — a path misses at most once, so one set of planes is exact);
        # param_grads appends one (n_sg, BR, BC) ∂log-throughput output:
        # n_obj linear-hit-count planes (+ n_obj Beer Σ0.01·t planes when
        # absorption is on); the 1/color factors are applied in f_bwd
        cam_ref, scalars_ref, quads_ref = args[0:3]
        i_arg = 3
        sph_ref = qdr_ref = None
        if n_spheres:
            sph_ref = args[i_arg]
            i_arg += 1
        if n_quadrics:
            qdr_ref = args[i_arg]
            i_arg += 1
        mesh_s_ref = mnodes_ref = mtris_ref = None
        if has_mesh:
            mesh_s_ref, mnodes_ref, mtris_ref = args[i_arg:i_arg + 3]
            i_arg += 3
        bn_ref = args[i_arg]
        i_arg += 1
        (col_r, col_g, col_b, onx, ony, onz, ocr, ocg, ocb, oid, osh) = args[i_arg:i_arg + 11]
        i_arg += 11
        if env_hdri:
            (mw_r_o, mw_g_o, mw_b_o, md_x_o, md_y_o, md_z_o) = args[i_arg:i_arg + 6]
            i_arg += 6
        if mesh_textured:
            # deferred PBR records: per-bounce albedo-factor UVs (u < 0 ⇒
            # no factor this bounce) + one emissive-terminal record
            # (throughput + UV) — the texel fetches happen outside the
            # kernel, exactly once per plane (see trace_image_pallas).
            alb_ref = args[i_arg]  # (2 * bounces, BR, BC): u, v per bounce
            i_arg += 1
            (em_r_o, em_g_o, em_b_o, em_u_o, em_v_o) = args[i_arg:i_arg + 5]
            i_arg += 5
        maybe_sg = args[i_arg:]
        f32 = jnp.float32

        frame = scalars_ref[0]
        fu = frame.astype(jnp.int32).astype(jnp.uint32)
        row0 = pl.program_id(0) * block_rows + scalars_ref[10].astype(jnp.int32)
        col0 = pl.program_id(1) * block_cols
        py_i = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + row0
        px_i = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + col0
        px_f = px_i.astype(f32)
        py_f = py_i.astype(f32)
        # --- RNG seeds (absolute pixel coords) ---------------------------
        sx = fu * px_i.astype(jnp.uint32)
        sy = (fu + 1) * py_i.astype(jnp.uint32)

        zeros = jnp.zeros(shape, f32)
        ones = jnp.ones(shape, f32)
        # --- ray-gen: tent AA + thin-lens DoF (4 draws) ------------------
        tx, sx, sy = _rng_next(sx, sy)
        ty, sx, sy = _rng_next(sx, sy)
        ox = _tent(tx)
        oy = _tent(ty)
        ndc_x = ((px_f + 0.5 + ox) / width) * 2.0 - 1.0
        ndc_y = ((py_f + 0.5 + oy) / height) * 2.0 - 1.0
        ulen = cam_ref[12]
        vlen = cam_ref[13]
        rdx = ndc_x * cam_ref[3] * ulen + ndc_y * cam_ref[6] * vlen + cam_ref[9]
        rdy = ndc_x * cam_ref[4] * ulen + ndc_y * cam_ref[7] * vlen + cam_ref[10]
        rdz = ndc_x * cam_ref[5] * ulen + ndc_y * cam_ref[8] * vlen + cam_ref[11]
        rdx, rdy, rdz = _normalize(rdx, rdy, rdz)
        ra, sx, sy = _rng_next(sx, sy)
        rr, sx, sy = _rng_next(sx, sy)
        angle = ra * TWO_PI
        radius = rr * cam_ref[14]
        sr = _safe_sqrt(radius)
        apx = (jnp.cos(angle) * cam_ref[3] + jnp.sin(angle) * cam_ref[6]) * sr
        apy = (jnp.cos(angle) * cam_ref[4] + jnp.sin(angle) * cam_ref[7]) * sr
        apz = (jnp.cos(angle) * cam_ref[5] + jnp.sin(angle) * cam_ref[8]) * sr
        focus = cam_ref[15]
        rdx, rdy, rdz = _normalize(focus * rdx - apx, focus * rdy - apy, focus * rdz - apz)
        rox = cam_ref[0] + apx
        roy = cam_ref[1] + apy
        roz = cam_ref[2] + apz

        # --- per-path state ----------------------------------------------
        acc_r = zeros
        acc_g = zeros
        acc_b = zeros
        m_r = ones
        m_g = ones
        m_b = ones
        alive = ones > 0.0
        spec = ones > 0.0
        samp_l = zeros > 1.0
        coat = zeros > 1.0
        d_cnt = jnp.zeros(shape, jnp.int32)
        sharp = zeros
        obj_nx = zeros
        obj_ny = zeros
        obj_nz = zeros
        obj_cr = zeros
        obj_cg = zeros
        obj_cb = zeros
        obj_id = jnp.full(shape, -INFINITY, f32)
        prev_metal = zeros > 1.0
        if env_sky or env_hdri:
            # only the env miss chains read prev_trans; keeping the carry in
            # the Cornell-family compile costs real vector ops per bounce
            prev_trans = zeros > 1.0

        if has_quad_light:
            lv0x = quads_ref[light_i, 3]
            lv0y = quads_ref[light_i, 4]
            lv0z = quads_ref[light_i, 5]
            lv2x = quads_ref[light_i, 9]
            lv2y = quads_ref[light_i, 10]
            lv2z = quads_ref[light_i, 11]
            lv1x = quads_ref[light_i, 6]
            lv1y = quads_ref[light_i, 7]
            lv1z = quads_ref[light_i, 8]
            lv3x = quads_ref[light_i, 12]
            lv3y = quads_ref[light_i, 13]
            lv3z = quads_ref[light_i, 14]
            # light normal (normalized host-side)
            lnx = quads_ref[light_i, 0]
            lny = quads_ref[light_i, 1]
            lnz = quads_ref[light_i, 2]
        if env_sky or env_hdri:
            sunx = scalars_ref[3]
            suny = scalars_ref[4]
            sunz = scalars_ref[5]
            if env_sky:
                sky_sun_e = scalars_ref[7]
                sky_gamma = scalars_ref[8]
                sky_blend = scalars_ref[9]
            # ONB about the sun (computed in _setup_inputs)
            sux, suy, suz = scalars_ref[11], scalars_ref[12], scalars_ref[13]
            svx, svy, svz = scalars_ref[14], scalars_ref[15], scalars_ref[16]

        if env_hdri:
            # deferred-env records: weight + direction at the (single) miss
            mw_r = zeros
            mw_g = zeros
            mw_b = zeros
            md_x = zeros
            md_y = zeros
            md_z = zeros

        if mesh_textured:
            # emissive-terminal record (throughput + UV); the per-bounce
            # albedo-factor records (u-or-minus-one, v) go straight to alb_ref
            em_w_r = zeros
            em_w_g = zeros
            em_w_b = zeros
            em_u = zeros
            em_v = zeros

        # path-replay ∂log-throughput accumulators.  One plane per OBJECT
        # (not per object-channel): every linear throughput factor equals
        # the hit object's color *constant* color[j, c], so the per-channel
        # 1/color division is deferred to the host-side backward — the
        # kernel only counts hits (and, for Beer-Lambert, sums 0.01·t).
        sg = [zeros for _ in range(n_obj)] if param_grads else None
        sgb = (
            [zeros for _ in range(n_obj)]
            if param_grads and not cfg.transparent_tint
            else None
        )

        # The bounce loop is a fori_loop (not unrolled): one copy of the
        # intersect/shade code keeps the Triton compile time bounded.  State
        # that crosses bounces rides the carry dict below.
        names = [
            "rox", "roy", "roz", "rdx", "rdy", "rdz", "m_r", "m_g", "m_b",
            "acc_r", "acc_g", "acc_b", "alive", "spec", "samp_l", "coat",
            "d_cnt", "sharp", "prev_metal", "obj_nx", "obj_ny", "obj_nz",
            "obj_cr", "obj_cg", "obj_cb", "obj_id", "sx", "sy",
        ]
        if env_sky or env_hdri:
            names.append("prev_trans")
        if env_hdri:
            names += ["mw_r", "mw_g", "mw_b", "md_x", "md_y", "md_z"]
        if mesh_textured:
            names += ["em_w_r", "em_w_g", "em_w_b", "em_u", "em_v"]
        scope = locals()
        carry = {k: scope[k] for k in names}
        if param_grads:
            carry["sg"] = tuple(sg)
            if sgb is not None:
                carry["sgb"] = tuple(sgb)

        def bounce_body(bounce, state):
            rox, roy, roz, rdx, rdy, rdz = (state[k] for k in names[0:6])
            m_r, m_g, m_b, acc_r, acc_g, acc_b = (state[k] for k in names[6:12])
            alive, spec, samp_l, coat, d_cnt, sharp, prev_metal = (state[k] for k in names[12:19])
            obj_nx, obj_ny, obj_nz, obj_cr, obj_cg, obj_cb, obj_id = (state[k] for k in names[19:26])
            sx, sy = state["sx"], state["sy"]
            prev_trans = state.get("prev_trans")
            mw_r, mw_g, mw_b, md_x, md_y, md_z = (state.get(k) for k in ("mw_r", "mw_g", "mw_b", "md_x", "md_y", "md_z"))
            em_w_r, em_w_g, em_w_b, em_u, em_v = (state.get(k) for k in ("em_w_r", "em_w_g", "em_w_b", "em_u", "em_v"))
            sg = list(state["sg"]) if "sg" in state else None
            sgb = list(state["sgb"]) if "sgb" in state else None
            first = bounce == 0

            # ---- scene intersect: all quads + spheres, keep nearest -----
            t_best = jnp.full(shape, INFINITY, f32)
            nx = zeros
            ny = ones
            nz = zeros
            hc_r = zeros
            hc_g = zeros
            hc_b = zeros
            mat = jnp.full(shape, -100.0, f32)
            hid = jnp.full(shape, -INFINITY, f32)

            oid_counter = 0
            for s in range(n_spheres):
                # object space transform by the 4x4 inverse matrix (scalars)
                def M(r, c, _s=s):
                    return sph_ref[_s, r * 4 + c]

                ro_ox = M(0, 0) * rox + M(0, 1) * roy + M(0, 2) * roz + M(0, 3)
                ro_oy = M(1, 0) * rox + M(1, 1) * roy + M(1, 2) * roz + M(1, 3)
                ro_oz = M(2, 0) * rox + M(2, 1) * roy + M(2, 2) * roz + M(2, 3)
                rd_ox = M(0, 0) * rdx + M(0, 1) * rdy + M(0, 2) * rdz
                rd_oy = M(1, 0) * rdx + M(1, 1) * rdy + M(1, 2) * rdz
                rd_oz = M(2, 0) * rdx + M(2, 1) * rdy + M(2, 2) * rdz
                a = _dot(rd_ox, rd_oy, rd_oz, rd_ox, rd_oy, rd_oz)
                b = 2.0 * _dot(rd_ox, rd_oy, rd_oz, ro_ox, ro_oy, ro_oz)
                c = _dot(ro_ox, ro_oy, ro_oz, ro_ox, ro_oy, ro_oz) - 1.0
                inv_a = _safe_inv(a)
                nb = -b * inv_a * 0.5
                u2 = nb * nb - c * inv_a
                real = u2 >= 0.0
                u = jnp.where(real, _safe_sqrt(u2), 0.0)
                nbv = jnp.where(real, nb, 0.0)
                t0 = nbv - u
                t1 = nbv + u
                t_s = jnp.where(t0 > 0.0, t0, jnp.where(t1 > 0.0, t1, INFINITY))
                hx = ro_ox + rd_ox * t_s
                hy = ro_oy + rd_oy * t_s
                hz = ro_oz + rd_oz * t_s
                # world normal: transpose(inv) @ n_obj (n_obj = hit point)
                wnx = M(0, 0) * hx + M(1, 0) * hy + M(2, 0) * hz
                wny = M(0, 1) * hx + M(1, 1) * hy + M(2, 1) * hz
                wnz = M(0, 2) * hx + M(1, 2) * hy + M(2, 2) * hz
                wnx, wny, wnz = _normalize(wnx, wny, wnz)
                closer = t_s < t_best
                t_best = jnp.where(closer, t_s, t_best)
                nx = jnp.where(closer, wnx, nx)
                ny = jnp.where(closer, wny, ny)
                nz = jnp.where(closer, wnz, nz)
                hc_r = jnp.where(closer, sph_ref[s, 16], hc_r)
                hc_g = jnp.where(closer, sph_ref[s, 17], hc_g)
                hc_b = jnp.where(closer, sph_ref[s, 18], hc_b)
                mat = jnp.where(closer, sph_ref[s, 19], mat)
                hid = jnp.where(closer, f32(oid_counter), hid)
                oid_counter += 1

            for qi in range(n_quadrics):
                # object space via the shape's 4x4 inverse matrix (scalars),
                # TransformedQuadricGeometry_FragmentShader.js:77-317 order
                def M(r, c, _q=qi):
                    return qdr_ref[_q, r * 4 + c]

                ro_o = (
                    M(0, 0) * rox + M(0, 1) * roy + M(0, 2) * roz + M(0, 3),
                    M(1, 0) * rox + M(1, 1) * roy + M(1, 2) * roz + M(1, 3),
                    M(2, 0) * rox + M(2, 1) * roy + M(2, 2) * roz + M(2, 3),
                )
                rd_o = (
                    M(0, 0) * rdx + M(0, 1) * rdy + M(0, 2) * rdz,
                    M(1, 0) * rdx + M(1, 1) * rdy + M(1, 2) * rdz,
                    M(2, 0) * rdx + M(2, 1) * rdy + M(2, 2) * rdz,
                )
                t_s, qnx, qny, qnz = _QUADRIC_INTERSECTORS[qi](
                    ro_o, rd_o, scalars_ref[2]
                )
                # world normal: transpose(inv3x3) @ n_obj, then normalize
                wnx = M(0, 0) * qnx + M(1, 0) * qny + M(2, 0) * qnz
                wny = M(0, 1) * qnx + M(1, 1) * qny + M(2, 1) * qnz
                wnz = M(0, 2) * qnx + M(1, 2) * qny + M(2, 2) * qnz
                wnx, wny, wnz = _normalize(wnx, wny, wnz)
                closer = t_s < t_best
                t_best = jnp.where(closer, t_s, t_best)
                nx = jnp.where(closer, wnx, nx)
                ny = jnp.where(closer, wny, ny)
                nz = jnp.where(closer, wnz, nz)
                hc_r = jnp.where(closer, qdr_ref[qi, 16], hc_r)
                hc_g = jnp.where(closer, qdr_ref[qi, 17], hc_g)
                hc_b = jnp.where(closer, qdr_ref[qi, 18], hc_b)
                mat = jnp.where(closer, qdr_ref[qi, 19], mat)
                hid = jnp.where(closer, f32(oid_counter), hid)
                oid_counter += 1

            for q in range(n_quads):
                def Q(j, _q=q):
                    return quads_ref[_q, j]

                if fast_quads:
                    # Parallelogram fast path (statically verified host-side:
                    # v2 - v1 == v3 - v0 for every quad): ONE plane
                    # intersection + dual-basis inside test, analytically
                    # identical to the two Möller-Trumbore fans below —
                    # including the cull (both fans' dets equal -rd·(e1×e3))
                    # — at ~1/3 the vector-op count.  The scalar algebra is
                    # per block, outside the per-lane work.
                    e1x, e1y, e1z = Q(6) - Q(3), Q(7) - Q(4), Q(8) - Q(5)
                    e3x, e3y, e3z = Q(12) - Q(3), Q(13) - Q(4), Q(14) - Q(5)
                    ngx = e1y * e3z - e1z * e3y
                    ngy = e1z * e3x - e1x * e3z
                    ngz = e1x * e3y - e1y * e3x
                    # dual basis (handles skewed parallelograms): a/b are the
                    # e1/e3 parameters of the hit point
                    d1x = e3y * ngz - e3z * ngy
                    d1y = e3z * ngx - e3x * ngz
                    d1z = e3x * ngy - e3y * ngx
                    d3x = ngy * e1z - ngz * e1y
                    d3y = ngz * e1x - ngx * e1z
                    d3z = ngx * e1y - ngy * e1x
                    den1 = e1x * d1x + e1y * d1y + e1z * d1z
                    den3 = e3x * d3x + e3y * d3y + e3z * d3z
                    k1 = 1.0 / jnp.where(jnp.abs(den1) > 1e-20, den1, 1.0)
                    k3 = 1.0 / jnp.where(jnp.abs(den3) > 1e-20, den3, 1.0)
                    c0 = Q(3) * ngx + Q(4) * ngy + Q(5) * ngz
                    denom = rdx * ngx + rdy * ngy + rdz * ngz
                    ron = rox * ngx + roy * ngy + roz * ngz
                    tt = (c0 - ron) * _safe_inv(denom)
                    hxq = rox + rdx * tt - Q(3)
                    hyq = roy + rdy * tt - Q(4)
                    hzq = roz + rdz * tt - Q(5)
                    aa = (hxq * d1x + hyq * d1y + hzq * d1z) * k1
                    bb = (hxq * d3x + hyq * d3y + hzq * d3z) * k3
                    miss = (
                        (tt <= 0.0)
                        | (aa < 0.0) | (aa > 1.0)
                        | (bb < 0.0) | (bb > 1.0)
                        | (denom > 0.0)  # backface cull: det = -rd·ng < 0
                    )
                    t_q = jnp.where(miss, INFINITY, tt)
                else:
                    # two Möller-Trumbore fans: (v0,v1,v2) and (v0,v2,v3)
                    t_q = jnp.full(shape, INFINITY, f32)
                    for (ax_, ay_, az_, bx_, by_, bz_) in (
                        (Q(6) - Q(3), Q(7) - Q(4), Q(8) - Q(5), Q(9) - Q(3), Q(10) - Q(4), Q(11) - Q(5)),
                        (Q(9) - Q(3), Q(10) - Q(4), Q(11) - Q(5), Q(12) - Q(3), Q(13) - Q(4), Q(14) - Q(5)),
                    ):
                        pvx, pvy, pvz = _cross(rdx, rdy, rdz, bx_, by_, bz_)
                        det = ax_ * pvx + ay_ * pvy + az_ * pvz
                        inv_det = _safe_inv(det)
                        tvx = rox - Q(3)
                        tvy = roy - Q(4)
                        tvz = roz - Q(5)
                        uu = _dot(tvx, tvy, tvz, pvx, pvy, pvz) * inv_det
                        qvx, qvy, qvz = _cross(tvx, tvy, tvz, ax_, ay_, az_)
                        vv = _dot(rdx, rdy, rdz, qvx, qvy, qvz) * inv_det
                        tt = (bx_ * qvx + by_ * qvy + bz_ * qvz) * inv_det
                        miss = (uu < 0.0) | (uu > 1.0) | (vv < 0.0) | (uu + vv > 1.0) | (tt <= 0.0)
                        miss = miss | (det < 0.0)  # backface cull like the jnp path
                        t_q = jnp.minimum(t_q, jnp.where(miss, INFINITY, tt))
                closer = t_q < t_best
                t_best = jnp.where(closer, t_q, t_best)
                nx = jnp.where(closer, Q(0), nx)
                ny = jnp.where(closer, Q(1), ny)
                nz = jnp.where(closer, Q(2), nz)
                hc_r = jnp.where(closer, Q(15), hc_r)
                hc_g = jnp.where(closer, Q(16), hc_g)
                hc_b = jnp.where(closer, Q(17), hc_b)
                mat = jnp.where(closer, Q(18), mat)
                hid = jnp.where(closer, f32(oid_counter), hid)
                oid_counter += 1

            if has_mesh:
                # BVH mesh, walked last so t_best already prunes subtrees
                # (SceneIntersect model section,
                # GLTFModelPathTracing_FragmentShader.js:201-344).
                def MM(r, c):
                    return mesh_s_ref[r * 4 + c]

                mro_x = MM(0, 0) * rox + MM(0, 1) * roy + MM(0, 2) * roz + MM(0, 3)
                mro_y = MM(1, 0) * rox + MM(1, 1) * roy + MM(1, 2) * roz + MM(1, 3)
                mro_z = MM(2, 0) * rox + MM(2, 1) * roy + MM(2, 2) * roz + MM(2, 3)
                mrd_x = MM(0, 0) * rdx + MM(0, 1) * rdy + MM(0, 2) * rdz
                mrd_y = MM(1, 0) * rdx + MM(1, 1) * rdy + MM(1, 2) * rdz
                mrd_z = MM(2, 0) * rdx + MM(2, 1) * rdy + MM(2, 2) * rdz
                cull_m = mesh_s_ref[17] > 0.5
                walk = _mesh_walk(
                    (mro_x, mro_y, mro_z), (mrd_x, mrd_y, mrd_z),
                    cull_m, mnodes_ref, mtris_ref, n_nodes, t_best,
                    active=alive,
                    textured=mesh_textured,
                )
                t_m, mnx, mny, mnz, m_u, m_v, hit_m = walk[:7]
                hit_m = hit_m & alive
                # world shading normal: transpose(inv3x3) @ n_obj
                wnx = MM(0, 0) * mnx + MM(1, 0) * mny + MM(2, 0) * mnz
                wny = MM(0, 1) * mnx + MM(1, 1) * mny + MM(2, 1) * mnz
                wnz = MM(0, 2) * mnx + MM(1, 2) * mny + MM(2, 2) * mnz
                wnx, wny, wnz = _normalize(wnx, wny, wnz)
                t_best = jnp.where(hit_m, t_m, t_best)
                nx = jnp.where(hit_m, wnx, nx)
                ny = jnp.where(hit_m, wny, ny)
                nz = jnp.where(hit_m, wnz, nz)
                # hitColor forced to white — slots 6-7 reserved-but-unused in
                # the reference too (GLTFModelPathTracing_FragmentShader.js:334);
                # textured albedo is DEFERRED (uv planes), so hc stays white
                # on the fused path too.
                hc_r = jnp.where(hit_m, 1.0, hc_r)
                hc_g = jnp.where(hit_m, 1.0, hc_g)
                hc_b = jnp.where(hit_m, 1.0, hc_b)
                if mesh_textured:
                    # per-triangle baked decisions (wavefront decode analog,
                    # radiance.py PBR block / GLTF...js:434-462): class is
                    # the already-thresholded DIFFUSE/METAL/CLEARCOAT id
                    cls_pl, rough_pl, emis_pl = walk[7:10]
                    mat = jnp.where(hit_m, cls_pl, mat)
                    pbr_hit = hit_m
                    # wrap UVs to [0,1) NOW: sampling REPEAT-wraps anyway
                    # (exactly — the pixel index shifts by a whole texture
                    # period), and it keeps the deferred records' u >= 0 so
                    # the -1 'no factor' sentinel cannot collide with
                    # legitimate negative glTF UVs
                    m_u = m_u - jnp.floor(m_u)
                    m_v = m_v - jnp.floor(m_v)
                else:
                    mat = jnp.where(hit_m, mesh_s_ref[16], mat)
                hid = jnp.where(hit_m, f32(oid_counter), hid)
                oid_counter += 1

            miss = t_best >= INFINITY
            # n is unit for all sources; face-forward
            flip = _dot(nx, ny, nz, rdx, rdy, rdz) < 0.0
            nlx = jnp.where(flip, nx, -nx)
            nly = jnp.where(flip, ny, -ny)
            nlz = jnp.where(flip, nz, -nz)
            xx = rox + rdx * t_best
            xy = roy + rdy * t_best
            xz = roz + rdz * t_best

            if env_sky:
                # environment on miss: Preetham sky with the reference's
                # first-match case chain (PhysicalSkyModel_FragmentShader.js:
                # 157-193), mirroring integrator.radiance exactly.
                m_env = alive & miss
                sky_r, sky_g, sky_b = _sky_color_c(
                    rdx, rdy, rdz, sunx, suny, sunz, sky_sun_e, sky_gamma, sky_blend
                )
                # (on the first bounce c2 holds on every lane and the
                # throughput is 1, so this is the primary-miss case too)
                cos_vs = rdx * sunx + rdy * suny + rdz * sunz
                c2 = (d_cnt == 0) & spec
                c3 = samp_l
                c4 = (d_cnt == 1) & prev_trans & spec
                c5 = d_cnt > 0
                sun_clip = _select(cos_vs < 0.99, 1.0, 0.0)
                full = c2 | c3 | c4
                env_w = jnp.where(full, 1.0, jnp.where(c5, sun_clip, 0.0))
                acc_r = jnp.where(m_env, m_r * sky_r * env_w, acc_r)
                acc_g = jnp.where(m_env, m_g * sky_g * env_w, acc_g)
                acc_b = jnp.where(m_env, m_b * sky_b * env_w, acc_b)
                sharp = jnp.where(m_env & c2, 1.01, sharp)

            if env_hdri:
                # HDRI miss: record direction + throughput-weighted case
                # weight; the equirect fetch happens outside the kernel.
                # Case chain = HDRIEnvironmentPathTracing_FragmentShader.js:
                # 412-437 (c4 additionally gated bounces < 3).
                m_env = alive & miss
                # (on the first bounce c2 holds on every lane and the
                # throughput is 1: the primary-miss case)
                cos_vs = rdx * sunx + rdy * suny + rdz * sunz
                c2 = (d_cnt == 0) & spec
                c3 = samp_l
                c4 = (d_cnt == 1) & prev_trans & spec & (bounce < 3)
                c5 = d_cnt > 0
                if env_nee:
                    # env NEE covers the whole map at every diffuse
                    # vertex — BSDF-sampled env hits after a diffuse
                    # bounce would double count (radiance.py:166-172)
                    sun_clip = zeros
                else:
                    sun_clip = _select(cos_vs < 0.99, 1.0, 0.0)
                full = c2 | c3 | c4
                env_w = jnp.where(full, 1.0, jnp.where(c5, sun_clip, 0.0))
                mw_r = jnp.where(m_env, m_r * env_w, mw_r)
                mw_g = jnp.where(m_env, m_g * env_w, mw_g)
                mw_b = jnp.where(m_env, m_b * env_w, mw_b)
                sharp = jnp.where(m_env & c2, 1.01, sharp)
                sharp = jnp.where(
                    m_env & ~c2 & ~c3 & c4 & (cos_vs > 0.99), 1.01, sharp
                )
                md_x = jnp.where(m_env, rdx, md_x)
                md_y = jnp.where(m_env, rdy, md_y)
                md_z = jnp.where(m_env, rdz, md_z)

            alive = alive & ~miss
            lane = alive

            # ---- first-hit records --------------------------------------
            l0 = lane & first
            obj_nx = jnp.where(l0, nlx, obj_nx)
            obj_ny = jnp.where(l0, nly, obj_ny)
            obj_nz = jnp.where(l0, nlz, obj_nz)
            obj_cr = jnp.where(l0, hc_r, obj_cr)
            obj_cg = jnp.where(l0, hc_g, obj_cg)
            obj_cb = jnp.where(l0, hc_b, obj_cb)
            obj_id = jnp.where(l0, hid, obj_id)
            am = lane & prev_metal & (bounce == 1)
            obj_nx = jnp.where(am, nlx, obj_nx)
            obj_ny = jnp.where(am, nly, obj_ny)
            obj_nz = jnp.where(am, nlz, obj_nz)
            obj_id = jnp.where(am, hid, obj_id)

            # ---- light hit ----------------------------------------------
            if has_quad_light:
                is_light = lane & (mat == f32(LIGHT))
                sharp = jnp.where(is_light & (d_cnt == 0), 1.01, sharp)
                lit = is_light & (spec | samp_l)
                acc_r = jnp.where(lit, m_r * hc_r, acc_r)
                acc_g = jnp.where(lit, m_g * hc_g, acc_g)
                acc_b = jnp.where(lit, m_b * hc_b, acc_b)
                alive = alive & ~is_light
                lane = alive
            else:
                lit = zeros > 1.0

            # ---- failed shadow ray --------------------------------------
            alive = alive & ~(lane & samp_l)
            lane = alive

            # ---- PBR emissive terminal (deferred value fetch) -----------
            if mesh_textured:
                # decision from the baked per-triangle flag; the emission
                # VALUE is fetched texel-exact outside the kernel
                # (radiance.py emissive block / GLTF...js:439-447)
                em_hit = lane & pbr_hit & spec & (emis_pl > 0.5)
                em_w_r = jnp.where(em_hit, m_r, em_w_r)
                em_w_g = jnp.where(em_hit, m_g, em_w_g)
                em_w_b = jnp.where(em_hit, m_b, em_w_b)
                em_u = jnp.where(em_hit, m_u, em_u)
                em_v = jnp.where(em_hit, m_v, em_v)
                sharp = jnp.where(em_hit, 1.01, sharp)
                alive = alive & ~em_hit
                lane = alive

            # ---- fixed-schedule draws -----------------------------------
            ch1 = (2 * bounce) & 3  # (2b) % 4; bitwise on the traced bounce
            ch2 = (2 * bounce + 1) & 3
            gate1 = bn_ref[ch1]
            gate2 = bn_ref[ch2]
            hr, sx, sy = _rng_next(sx, sy)
            hp, sx, sy = _rng_next(sx, sy)
            # cosine hemisphere about nl
            r_ = _safe_sqrt(hr)
            phi = hp * TWO_PI
            hx_ = r_ * jnp.cos(phi)
            hy_ = r_ * jnp.sin(phi)
            hz_ = _safe_sqrt(1.0 - hx_ * hx_ - hy_ * hy_)
            # ONB about nl (cross-trick)
            up_y = jnp.abs(nly) < 0.9
            helx = jnp.where(up_y, zeros, ones)
            hely = jnp.where(up_y, ones, zeros)
            ux, uy, uz = _cross(helx, hely, zeros, nlx, nly, nlz)
            ux, uy, uz = _normalize(ux, uy, uz)
            vx, vy, vz = _cross(nlx, nly, nlz, ux, uy, uz)
            hemx = hx_ * ux + hy_ * vx + hz_ * nlx
            hemy = hx_ * uy + hy_ * vy + hz_ * nly
            hemz = hx_ * uz + hy_ * vz + hz_ * nlz
            hemx, hemy, hemz = _normalize(hemx, hemy, hemz)
            if has_quad_light:
                # quad light sample (3 draws)
                qx_, sx, sy = _rng_next(sx, sy)
                qy_, sx, sy = _rng_next(sx, sy)
                qz_, sx, sy = _rng_next(sx, sy)
                rpx = lv0x + (lv2x - lv0x) * jnp.clip(qx_, 0.1, 0.9)
                rpy = lv0y + (lv2y - lv0y) * jnp.clip(qy_, 0.1, 0.9)
                rpz = lv0z + (lv2z - lv0z) * jnp.clip(qz_, 0.1, 0.9)
                dlx = rpx - xx
                dly = rpy - xy
                dlz = rpz - xz
                e1 = _safe_sqrt(
                    (lv1x - lv0x) ** 2 + (lv1y - lv0y) ** 2 + (lv1z - lv0z) ** 2
                )
                e2 = _safe_sqrt(
                    (lv3x - lv0x) ** 2 + (lv3y - lv0y) ** 2 + (lv3z - lv0z) ** 2
                )
                r2 = e1 * e2
                d2 = _dot(dlx, dly, dlz, dlx, dly, dlz)
                cos_a_max = _safe_sqrt(1.0 - jnp.clip(r2 / jnp.maximum(d2, 1e-20), 0.0, 1.0))
                dlx, dly, dlz = _normalize(dlx, dly, dlz)
                dot_nl = jnp.maximum(0.0, _dot(nlx, nly, nlz, dlx, dly, dlz))
                lw = 2.0 * (1.0 - cos_a_max) * jnp.maximum(
                    0.0, -(dlx * lnx + dly * lny + dlz * lnz)
                ) * dot_nl
                lw = jnp.clip(lw, 0.0, 1.0)
            # lobe draws shared by sun/env NEE and the PBR metal lobe,
            # exactly as the wavefront's single use_lobe draw site
            # (radiance.py) — with nee == "env" the pair is still consumed
            # in-kernel (stream parity + the metal lobe), while the env
            # sample they seed was computed host-side from the SAME draws.
            if use_lobe:
                lc_, sx, sy = _rng_next(sx, sy)
                lp_, sx, sy = _rng_next(sx, sy)
            if env_nee:
                # precomputed inverse-CDF sample planes for this bounce
                dlx = bn_ref[4 + 4 * bounce + 0]
                dly = bn_ref[4 + 4 * bounce + 1]
                dlz = bn_ref[4 + 4 * bounce + 2]
                # Lambertian weight cos/(pi*pdf) (radiance.py:283-284)
                lw = (
                    jnp.maximum(0.0, _dot(dlx, dly, dlz, nlx, nly, nlz))
                    * bn_ref[4 + 4 * bounce + 3]
                )
            elif not has_quad_light:
                # sun NEE: specular lobe about uSunDirection, roughness 0.1,
                # weight cosθ·0.05 (PhysicalSkyModel_FragmentShader.js:250-256)
                import math as _math

                rough = cfg.sun_lobe_roughness
                exponent = 7.0 * (1.0 - _math.sqrt(rough))
                power = 1.0 / (_math.exp(exponent) + 1.0)
                ct = _pow_c(lc_, power)
                st = _safe_sqrt(1.0 - ct * ct)
                phi_l = lp_ * TWO_PI
                lx = (
                    sux * (jnp.cos(phi_l) * st)
                    + svx * (jnp.sin(phi_l) * st)
                    + sunx * ct
                )
                ly = (
                    suy * (jnp.cos(phi_l) * st)
                    + svy * (jnp.sin(phi_l) * st)
                    + suny * ct
                )
                lz = (
                    suz * (jnp.cos(phi_l) * st)
                    + svz * (jnp.sin(phi_l) * st)
                    + sunz * ct
                )
                dlx = sunx + (lx - sunx) * rough
                dly = suny + (ly - suny) * rough
                dlz = sunz + (lz - sunz) * rough
                dlx, dly, dlz = _normalize(dlx, dly, dlz)
                cos_w = jnp.maximum(0.0, _dot(dlx, dly, dlz, nlx, nly, nlz))
                if cfg.sun_weight_mode == "hdri":
                    sp = scalars_ref[6]
                    lw = cos_w * (sp * sp * 1.0e-7)
                else:
                    lw = cos_w * 0.05

            # ---- material branches --------------------------------------
            b_diff = lane & (mat == f32(DIFFUSE))
            b_metal = lane & (mat == f32(METAL))
            b_trans = lane & (mat == f32(TRANSPARENT))
            b_coat = lane & (mat == f32(CLEARCOAT_DIFFUSE))

            # DIFFUSE
            dcnt_d = d_cnt + 1
            go_ind = (dcnt_d <= cfg.diffuse_indirect_max) & (gate1 < 0.5)
            rd_dx = jnp.where(go_ind, hemx, dlx)
            rd_dy = jnp.where(go_ind, hemy, dly)
            rd_dz = jnp.where(go_ind, hemz, dlz)
            mw = jnp.where(go_ind, 1.0, lw)
            md_r = m_r * hc_r * mw
            md_g = m_g * hc_g * mw
            md_b = m_b * hc_b * mw
            sl_d = ~go_ind

            # METAL (perfect mirror in the Cornell family)
            rfx, rfy, rfz = _reflect(rdx, rdy, rdz, nlx, nly, nlz)
            if cfg.metal_roughness_lobe:
                # randomDirectionInSpecularLobe(reflect, roughness) with the
                # per-lane baked PBR roughness (0 off-mesh ⇒ exact mirror),
                # mirroring core.sampling.specular_lobe_from_uniforms
                mrough = jnp.clip(rough_pl if mesh_textured else zeros, 0.0, 1.0)
                mexp = 7.0 * (1.0 - _safe_sqrt(mrough))
                mct = _pow_c(lc_, 1.0 / (jnp.exp(mexp) + 1.0))
                mst = _safe_sqrt(1.0 - mct * mct)
                mphi = lp_ * TWO_PI
                r_up = jnp.abs(rfy) < 0.9
                rhx = _select(r_up, 0.0, 1.0)
                rhy = _select(r_up, 1.0, 0.0)
                rux, ruy, ruz = _cross(rhx, rhy, zeros, rfx, rfy, rfz)
                rux, ruy, ruz = _normalize(rux, ruy, ruz)
                rvx, rvy, rvz = _cross(rfx, rfy, rfz, rux, ruy, ruz)
                lbx = rux * (jnp.cos(mphi) * mst) + rvx * (jnp.sin(mphi) * mst) + rfx * mct
                lby = ruy * (jnp.cos(mphi) * mst) + rvy * (jnp.sin(mphi) * mst) + rfy * mct
                lbz = ruz * (jnp.cos(mphi) * mst) + rvz * (jnp.sin(mphi) * mst) + rfz * mct
                rmx, rmy, rmz = _normalize(
                    rfx + (lbx - rfx) * mrough,
                    rfy + (lby - rfy) * mrough,
                    rfz + (lbz - rfz) * mrough,
                )
            else:
                rmx, rmy, rmz = rfx, rfy, rfz

            # TRANSPARENT: Fresnel with geometric n
            cosi = jnp.clip(_dot(rdx, rdy, rdz, nx, ny, nz), -1.0, 1.0)
            inside = cosi > 0.0
            ei = _select(inside, 1.5, 1.0)
            et = _select(inside, 1.0, 1.5)
            ratio = ei / et
            sint = ratio * _safe_sqrt(1.0 - cosi * cosi)
            tir = sint >= 1.0
            cost = _safe_sqrt(1.0 - sint * sint)
            cia = jnp.abs(cosi)
            rs = (et * cia - ei * cost) / jnp.maximum(et * cia + ei * cost, 1e-20)
            rp = (ei * cia - et * cost) / jnp.maximum(ei * cia + et * cost, 1e-20)
            re_t = jnp.where(tir, 1.0, jnp.clip(0.5 * (rs * rs + rp * rp), 0.0, 1.0))
            p_t = 0.25 + 0.5 * re_t
            go_refl_t = gate1 < p_t
            # refract(rd, nl, ratio)
            cosr = _dot(nlx, nly, nlz, rdx, rdy, rdz)
            kk = 1.0 - ratio * ratio * (1.0 - cosr * cosr)
            sq = _safe_sqrt(kk)
            tdx = ratio * rdx - (ratio * cosr + sq) * nlx
            tdy = ratio * rdy - (ratio * cosr + sq) * nly
            tdz = ratio * rdz - (ratio * cosr + sq) * nlz
            tdx = jnp.where(kk < 0.0, 0.0, tdx)
            tdy = jnp.where(kk < 0.0, 0.0, tdy)
            tdz = jnp.where(kk < 0.0, 0.0, tdz)
            if cfg.transparent_tint:
                ab_r, ab_g, ab_b = hc_r, hc_g, hc_b
            else:
                ab_r = jnp.where(inside, jnp.exp(jnp.log(jnp.clip(hc_r, 0.01, 0.99)) * 0.01 * t_best), 1.0)
                ab_g = jnp.where(inside, jnp.exp(jnp.log(jnp.clip(hc_g, 0.01, 0.99)) * 0.01 * t_best), 1.0)
                ab_b = jnp.where(inside, jnp.exp(jnp.log(jnp.clip(hc_b, 0.01, 0.99)) * 0.01 * t_best), 1.0)
            tr_t = 1.0 - re_t
            mt_refl = re_t / p_t
            mt_refr = tr_t / (1.0 - p_t)
            mt_r = jnp.where(go_refl_t, m_r * mt_refl, m_r * ab_r * mt_refr)
            mt_g = jnp.where(go_refl_t, m_g * mt_refl, m_g * ab_g * mt_refr)
            mt_b = jnp.where(go_refl_t, m_b * mt_refl, m_b * ab_b * mt_refr)
            rd_tx = jnp.where(go_refl_t, rfx, tdx)
            rd_ty = jnp.where(go_refl_t, rfy, tdy)
            rd_tz = jnp.where(go_refl_t, rfz, tdz)
            off_t = jnp.where(go_refl_t, eps, -eps)
            # bool select as logical ops
            spec_t = spec | (~go_refl_t & (d_cnt == 1))
            sharp_t = jnp.where(
                (d_cnt == 0) & ~coat & (not cfg.camera_is_moving),
                1.01,
                _select(d_cnt > 0, 0.0, -1.0),
            )

            # CLEARCOAT (Fresnel with nl, IOR 1.4)
            cosc = jnp.clip(_dot(rdx, rdy, rdz, nlx, nly, nlz), -1.0, 1.0)
            in_c = cosc > 0.0
            ei_c = _select(in_c, 1.4, 1.0)
            et_c = _select(in_c, 1.0, 1.4)
            ratio_c = ei_c / et_c
            sint_c = ratio_c * _safe_sqrt(1.0 - cosc * cosc)
            cost_c = _safe_sqrt(1.0 - sint_c * sint_c)
            cca = jnp.abs(cosc)
            rs_c = (et_c * cca - ei_c * cost_c) / jnp.maximum(et_c * cca + ei_c * cost_c, 1e-20)
            rp_c = (ei_c * cca - et_c * cost_c) / jnp.maximum(ei_c * cca + et_c * cost_c, 1e-20)
            re_c = jnp.where(sint_c >= 1.0, 1.0, jnp.clip(0.5 * (rs_c * rs_c + rp_c * rp_c), 0.0, 1.0))
            p_c = 0.25 + 0.5 * re_c
            go_refl_c = gate1 < p_c
            dcnt_c = d_cnt + 1
            go_ind_c = (dcnt_c <= cfg.diffuse_indirect_max) & (gate2 < 0.5)
            mc_base = (1.0 - re_c) / (1.0 - p_c)
            mw_c = jnp.where(go_ind_c, 1.0, lw)
            mc_r = jnp.where(go_refl_c, m_r * re_c / p_c, m_r * mc_base * hc_r * mw_c)
            mc_g = jnp.where(go_refl_c, m_g * re_c / p_c, m_g * mc_base * hc_g * mw_c)
            mc_b = jnp.where(go_refl_c, m_b * re_c / p_c, m_b * mc_base * hc_b * mw_c)
            rd_cx = jnp.where(go_refl_c, rfx, jnp.where(go_ind_c, hemx, dlx))
            rd_cy = jnp.where(go_refl_c, rfy, jnp.where(go_ind_c, hemy, dly))
            rd_cz = jnp.where(go_refl_c, rfz, jnp.where(go_ind_c, hemz, dlz))
            dcnt_sel_c = jnp.where(go_refl_c, d_cnt, dcnt_c)
            spec_c = go_refl_c & spec
            sl_c = ~go_refl_c & ~go_ind_c & (bounce < 3)
            sharp_c = jnp.where(
                go_refl_c,
                jnp.where(d_cnt == 0, _select(frame > 500.0, 1.01, -1.0), 0.0),
                0.0,
            )

            if mesh_textured:
                # deferred albedo factor: branches that multiply throughput
                # by hit_color on a textured-mesh hit (DIFFUSE, METAL,
                # CLEARCOAT base) — composed outside as Π albedo(uv_b)^flag
                alb_f = pbr_hit & (b_diff | b_metal | (b_coat & ~go_refl_c))
                alb_ref[2 * bounce], alb_ref[2 * bounce + 1] = (
                    jnp.where(alb_f, m_u, -1.0), jnp.where(alb_f, m_v, 0.0)
                )

            # ---- merge --------------------------------------------------
            new_rdx = jnp.where(b_diff, rd_dx, jnp.where(b_metal, rmx, jnp.where(b_trans, rd_tx, jnp.where(b_coat, rd_cx, rdx))))
            new_rdy = jnp.where(b_diff, rd_dy, jnp.where(b_metal, rmy, jnp.where(b_trans, rd_ty, jnp.where(b_coat, rd_cy, rdy))))
            new_rdz = jnp.where(b_diff, rd_dz, jnp.where(b_metal, rmz, jnp.where(b_trans, rd_tz, jnp.where(b_coat, rd_cz, rdz))))
            off = jnp.where(b_trans, off_t, eps)
            new_rox = xx + nlx * off
            new_roy = xy + nly * off
            new_roz = xz + nlz * off
            new_mr = jnp.where(b_diff, md_r, jnp.where(b_metal, m_r * hc_r, jnp.where(b_trans, mt_r, jnp.where(b_coat, mc_r, m_r))))
            new_mg = jnp.where(b_diff, md_g, jnp.where(b_metal, m_g * hc_g, jnp.where(b_trans, mt_g, jnp.where(b_coat, mc_g, m_g))))
            new_mb = jnp.where(b_diff, md_b, jnp.where(b_metal, m_b * hc_b, jnp.where(b_trans, mt_b, jnp.where(b_coat, mc_b, m_b))))
            new_spec = ~b_diff & ((b_trans & spec_t) | (b_coat & spec_c) | (~b_trans & ~b_coat & spec))
            new_sl = (b_diff & sl_d) | (~b_diff & b_coat & sl_c)
            new_dc = jnp.where(b_diff, dcnt_d, jnp.where(b_coat, dcnt_sel_c, d_cnt))
            new_sharp = jnp.where(b_trans, sharp_t, jnp.where(b_coat, sharp_c, sharp))
            coat = coat | b_coat
            known = b_diff | b_metal | b_trans | b_coat
            alive = alive & known

            rdx = jnp.where(lane, new_rdx, rdx)
            rdy = jnp.where(lane, new_rdy, rdy)
            rdz = jnp.where(lane, new_rdz, rdz)
            rox = jnp.where(lane, new_rox, rox)
            roy = jnp.where(lane, new_roy, roy)
            roz = jnp.where(lane, new_roz, roz)
            m_r = jnp.where(lane, new_mr, m_r)
            m_g = jnp.where(lane, new_mg, m_g)
            m_b = jnp.where(lane, new_mb, m_b)
            spec = (lane & new_spec) | (~lane & spec)
            samp_l = (lane & new_sl) | (~lane & samp_l)
            d_cnt = jnp.where(lane, new_dc, d_cnt)
            sharp = jnp.where(lane, new_sharp, sharp)
            prev_metal = (lane & b_metal) | (~lane & prev_metal)
            if env_sky or env_hdri:
                prev_trans = (lane & b_trans) | (~lane & prev_trans)

            if param_grads:
                # every factor touching the hit object's color this bounce:
                # DIFFUSE m*=hc·w, METAL m*=hc, CLEARCOAT base m*=base·hc·w,
                # TRANSPARENT tinted refract m*=hc·tr/(1-p)  → ∂log f/∂c = 1/c;
                # light hit acc=m·e → 1/e;  Beer-Lambert exp(0.01·t·log clip c)
                # → 0.01·t/c gated to the clip's linear region.  The 1/c (and
                # the per-channel clip gate) are applied host-side in f_bwd —
                # c is the hit object's color constant, not per-lane data.
                g_lin = b_diff | b_metal | (b_coat & ~go_refl_c) | lit
                if cfg.transparent_tint:
                    g_lin = g_lin | (b_trans & ~go_refl_t)
                g_lin_f = _select(g_lin, 1.0, 0.0)
                if not cfg.transparent_tint:
                    beer_f = jnp.where(
                        b_trans & ~go_refl_t & inside, 0.01 * t_best, 0.0
                    )
                for j in range(n_obj):
                    mj = hid == f32(j)
                    sg[j] = sg[j] + jnp.where(mj, g_lin_f, 0.0)
                    if not cfg.transparent_tint:
                        sgb[j] = sgb[j] + jnp.where(mj, beer_f, 0.0)

            out = {k: v for k, v in locals().items() if k in names}
            if sg is not None:
                out["sg"] = tuple(sg)
            if sgb is not None:
                out["sgb"] = tuple(sgb)
            return out

        state = jax.lax.fori_loop(0, cfg.bounces, bounce_body, carry)
        acc_r, acc_g, acc_b, sharp = (state[k] for k in ("acc_r", "acc_g", "acc_b", "sharp"))
        obj_nx, obj_ny, obj_nz, obj_cr, obj_cg, obj_cb, obj_id = (state[k] for k in names[19:26])
        if env_hdri:
            mw_r, mw_g, mw_b, md_x, md_y, md_z = (state[k] for k in ("mw_r", "mw_g", "mw_b", "md_x", "md_y", "md_z"))
        if mesh_textured:
            em_w_r, em_w_g, em_w_b, em_u, em_v = (state[k] for k in ("em_w_r", "em_w_g", "em_w_b", "em_u", "em_v"))
        sg = list(state["sg"]) if param_grads else None
        sgb = list(state["sgb"]) if "sgb" in state else None

        col_r[:] = jnp.maximum(acc_r, 0.0)
        col_g[:] = jnp.maximum(acc_g, 0.0)
        col_b[:] = jnp.maximum(acc_b, 0.0)
        onx[:] = obj_nx
        ony[:] = obj_ny
        onz[:] = obj_nz
        ocr[:] = obj_cr
        ocg[:] = obj_cg
        ocb[:] = obj_cb
        oid[:] = obj_id
        osh[:] = sharp
        if env_hdri:
            mw_r_o[:] = mw_r
            mw_g_o[:] = mw_g
            mw_b_o[:] = mw_b
            md_x_o[:] = md_x
            md_y_o[:] = md_y
            md_z_o[:] = md_z
        if mesh_textured:
            em_r_o[:] = em_w_r
            em_g_o[:] = em_w_g
            em_b_o[:] = em_w_b
            em_u_o[:] = em_u
            em_v_o[:] = em_v
        if param_grads:
            sg_ref = maybe_sg[0]
            for j in range(n_obj):
                sg_ref[j] = sg[j]
                if sgb is not None:
                    sg_ref[n_obj + j] = sgb[j]

    return kernel


# ---------------------------------------------------------------------------
# host-side wrapper
# ---------------------------------------------------------------------------

def pack_scene(scene: Scene):
    """Scene pytree -> scalar-table packs (quads (Nq,20), spheres (Ns,21)
    or None, quadrics (12,20) or None)."""
    q = scene.quads
    from bpt_tpu.core.vecmath import normalize as _n

    qn = jnp.asarray(_n(q.normal))
    quads = jnp.concatenate(
        [qn, q.v0, q.v1, q.v2, q.v3, q.color, q.mat_type.astype(jnp.float32)[:, None],
         jnp.zeros((q.v0.shape[0], 1), jnp.float32)],
        axis=1,
    )
    sph = qdr = None
    if scene.spheres is not None:
        s = scene.spheres
        sph = jnp.concatenate(
            [s.inv_matrix.reshape(-1, 16), s.color, s.mat_type.astype(jnp.float32)[:, None],
             jnp.zeros((s.color.shape[0], 1), jnp.float32)],
            axis=1,
        )
    if scene.quadrics is not None:
        d = scene.quadrics
        qdr = jnp.concatenate(
            [d.inv_matrix.reshape(-1, 16), d.color,
             d.mat_type.astype(jnp.float32)[:, None]],
            axis=1,
        )
    return quads, sph, qdr


def pack_mesh(scene: Scene):
    """TriangleMesh -> kernel inputs (mesh_s (18,) f32, nodes, tris)
    or None.  mesh_s = inv 4x4 row-major, mat_type, backface-cull flag
    (cull unless untextured TRANSPARENT,
    GLTFModelPathTracing_FragmentShader.js:284-287)."""
    m = scene.mesh
    if m is None:
        return None
    if m.fz_nodes_f is None:
        raise ValueError("mesh lacks the BVH4 pack (fz_*); "
                         "rebuild it with scenes.gltf_scene.mesh_from_model")
    mt = m.mat_type.astype(jnp.float32)
    has_albedo = m.albedo is not None
    cull = jnp.where(
        (not has_albedo) & (m.mat_type == TRANSPARENT), 0.0, 1.0
    ).astype(jnp.float32)
    mesh_s = jnp.concatenate(
        [m.inv_matrix.reshape(16).astype(jnp.float32), mt[None], cull[None]]
    )
    return mesh_s, m.fz_nodes_f, m.fz_tris


def pack_cornell_scene(scene: Scene):
    """Back-compat alias: (quads, spheres) packs of the Cornell family."""
    quads, sph, _ = pack_scene(scene)
    return quads, sph


def pack_camera(camera, width: int, height: int):
    from bpt_tpu.camera import film_extents

    ulen, vlen = film_extents(camera, width, height)
    return jnp.concatenate(
        [
            camera.position,
            camera.right,
            camera.up,
            camera.forward,
            jnp.stack([ulen, vlen, camera.aperture_size, camera.focus_distance]),
        ]
    ).astype(jnp.float32)


def _all_parallelograms(quads) -> bool:
    """Static host-side check gating the kernel's single-plane quad fast
    path: every quad must satisfy v2 - v1 == v3 - v0 (a parallelogram, as
    all reference demo quads do).  Returns False when the vertices are
    traced (e.g. differentiating w.r.t. quad geometry) or non-concrete —
    the kernel then keeps the generic two-fan Möller-Trumbore."""
    import numpy as np

    if quads is None:
        return False
    try:
        v0, v1, v2, v3 = (np.asarray(v) for v in (quads.v0, quads.v1, quads.v2, quads.v3))
    except Exception:
        return False
    return bool(np.allclose(v2 - v1, v3 - v0, atol=1e-5))


def _blue_noise_planes(blue_noise, height, width, rand_vec2):
    """Per-pixel decision texel: (4, H, W).

    The fetch index is (pixel + shared_offset) mod size — a uniform SHIFT of
    the whole table, not a per-pixel gather — so it lowers to roll + tile
    (pure data movement; XLA's per-element gather costs ~15 cycles/texel and
    would dominate small frames)."""
    size = blue_noise.shape[0]
    ox = jnp.floor(rand_vec2[0] * size).astype(jnp.int32)
    oy = jnp.floor(rand_vec2[1] * size).astype(jnp.int32)
    rolled = jnp.roll(jnp.mod(blue_noise, 1.0), shift=(-oy, -ox), axis=(0, 1))
    reps_y = -(-height // size)
    reps_x = -(-width // size)
    tiled = jnp.tile(rolled, (reps_y, reps_x, 1))[:height, :width]
    return jnp.moveaxis(tiled, -1, 0)


def _env_nee_planes(scene, cfg, frame_counter, height, width):
    """Precomputed env importance-sampling draws for the fused kernel.

    The fixed RNG schedule makes the per-bounce lobe pair (lc, lp) a pure
    function of (pixel, frame): draw j of iq's hash uses state
    (frame*px + j, (frame+1)*py + j).  For the HDRI family (no quad light,
    use_lobe on) the pair sits at draws 4 + 4b + {3, 4} — 4 ray-gen draws,
    then hem 2 + lobe 2 per bounce.  Replaying those draws host-side and
    pushing them through `sample_env_cdf` gives the EXACT sample the
    wavefront integrator (radiance.py:267-284) takes in-loop, so fused and
    wavefront keep float-level parity; the kernel consumes the same lc/lp
    draws for stream position and reads the resulting direction/pdf from
    these planes (the CDF search stays out of the kernel).

    Returns (4 * bounces, H, W): per bounce [dir.x, dir.y, dir.z,
    1/(pi*max(pdf, 1e-8))].
    """
    from bpt_tpu.core.rng import RngState, rng_next
    from bpt_tpu.env import EnvCDF, sample_env_cdf

    fu = jnp.asarray(frame_counter, jnp.float32).astype(jnp.int32).astype(jnp.uint32)
    px = jax.lax.broadcasted_iota(jnp.uint32, (height, width), 1)
    py = jax.lax.broadcasted_iota(jnp.uint32, (height, width), 0)
    sx0 = fu * px
    sy0 = (fu + jnp.uint32(1)) * py
    cdf = EnvCDF(*scene.env.env_cdf)
    planes = []
    for b in range(cfg.bounces):
        j = jnp.uint32(4 + 4 * b + 2)  # draws consumed before lc
        st = RngState(sx0 + j, sy0 + j)
        lc, st = rng_next(st)
        lp, _ = rng_next(st)
        d, pdf = sample_env_cdf(cdf, lc, lp)
        wb = 1.0 / (jnp.pi * jnp.maximum(pdf, 1e-8))
        planes.extend([d[..., 0], d[..., 1], d[..., 2], wb])
    return jax.lax.stop_gradient(jnp.stack(planes))


BLOCK_LANES = 128


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def block_shape(height: int, width: int, lanes: int = BLOCK_LANES) -> tuple:
    """Pixel block of one kernel program: power-of-two sides, ``lanes``
    pixels (fewer only for images smaller than that), at most 8 rows tall —
    a compact block keeps the shared BVH cursor's subtree union small, and
    one lane per thread leaves each path its registers."""
    rows = min(8, _next_pow2(height), lanes)
    cols = min(lanes // rows, _next_pow2(width))
    return rows, cols


def use_interpreter(interpret: bool) -> bool:
    """The one place the fused path picks its backend: the Triton kernel on
    a GPU, the Pallas interpreter only when the caller asks for it."""
    if interpret:
        return True
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"the fused Pallas kernel compiles for the GPU through Triton, but "
            f"the default backend is {backend!r}; pass interpret=True to run "
            "it in the Pallas interpreter")
    return False


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width", "img_height", "block", "interpret", "param_grads", "fast_quads", "mesh_textured"))
def _pallas_forward(packs, cam, scalars, bn_planes, cfg, height, width, img_height, block, interpret=False, param_grads=False, fast_quads=False, mesh_textured=False):
    """One fused pallas_call over ``height`` rows of an ``img_height`` x
    ``width`` image (the first absolute row rides scalars[10]).  The image
    is padded to whole blocks and every output plane cropped back, so any
    size is traced."""
    quads, sph, qdr, mesh = packs
    n_quads = quads.shape[0]
    n_spheres = sph.shape[0] if sph is not None else 0
    n_quadrics = qdr.shape[0] if qdr is not None else 0
    n_obj = n_quads + n_spheres + n_quadrics
    has_mesh = mesh is not None
    bh, bw = block
    hp = -(-height // bh) * bh
    wp = -(-width // bw) * bw
    n_out = 17 if cfg.env == "hdri" else 11
    kernel = _make_kernel(cfg, n_quads, n_spheres, n_quadrics, bh, bw, width, img_height, param_grads, has_mesh=has_mesh, n_nodes=mesh[1].shape[0] if has_mesh else 0, fast_quads=fast_quads, mesh_textured=mesh_textured)
    plane = jax.ShapeDtypeStruct((hp, wp), jnp.float32)
    plane_spec = pl.BlockSpec((bh, bw), lambda i, j: (i, j))
    out_shape = [plane] * n_out
    out_specs = [plane_spec] * n_out
    if mesh_textured:
        # per-bounce albedo UVs (one stacked output) + emissive terminal
        out_shape.append(jax.ShapeDtypeStruct((2 * cfg.bounces, hp, wp), jnp.float32))
        out_specs.append(pl.BlockSpec((2 * cfg.bounces, bh, bw), lambda i, j: (0, i, j)))
        out_shape += [plane] * 5
        out_specs += [plane_spec] * 5
    if param_grads:
        n_sg = n_obj if cfg.transparent_tint else 2 * n_obj
        out_shape.append(jax.ShapeDtypeStruct((n_sg, hp, wp), jnp.float32))
        out_specs.append(pl.BlockSpec((n_sg, bh, bw), lambda i, j: (0, i, j)))
    # scene tables are whole-array refs in global memory, read by scalar loads
    inputs = [cam, scalars, quads]
    if n_spheres:
        inputs.append(sph)
    if n_quadrics:
        inputs.append(qdr)
    if has_mesh:
        inputs.extend(mesh)
    in_specs = [pl.BlockSpec()] * len(inputs)
    # 4 blue-noise planes, + 4 env-NEE sample planes per bounce when
    # cfg.nee == "env" (see _make_kernel)
    inputs.append(jnp.pad(bn_planes, ((0, 0), (0, hp - height), (0, wp - width))))
    in_specs.append(pl.BlockSpec((bn_planes.shape[0], bh, bw), lambda i, j: (0, i, j)))
    outs = pl.pallas_call(
        kernel,
        grid=(hp // bh, wp // bw),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=max(1, bh * bw // 32)),
        name="bpt_megakernel",
    )(*inputs)
    return [o[..., :height, :width] for o in outs]


# ---------------------------------------------------------------------------
# custom-VJP (path-replay parameter gradients, see module docstring)
# ---------------------------------------------------------------------------

def _zeros_ct(x):
    """Zero cotangent matching JAX's convention: float0 for integer leaves."""
    import numpy as np

    if x is None:
        return None
    if jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)


@functools.lru_cache(maxsize=64)
def _prb_fn(cfg: IntegratorConfig, height: int, width: int, img_height: int, block: tuple, interpret: bool, fast_quads: bool = False, mesh_textured: bool = False):
    """Returns radiance(packs, cam, scalars, bn) differentiable w.r.t.
    the packed material-color columns (quads[:,15:18], sph[:,16:19]) — the
    emission/albedo parameters of the Cornell-family inverse problem
    (BASELINE.json config #1/#5 shape).  With env "hdri", the deferred
    miss-weight planes carry the same ∂log-throughput sum, so env-terminated
    paths contribute material gradients too (the outer equirect composition
    adds exact HDR/exposure gradients by plain AD).  Other leaves get zero
    cotangents; use the jnp integrator for camera/geometry gradients."""

    kw = dict(cfg=cfg, height=height, width=width, img_height=img_height,
              block=block, interpret=interpret, fast_quads=fast_quads,
              mesh_textured=mesh_textured)
    env_hdri = cfg.env == "hdri"
    # index of the emissive-terminal throughput planes among the outputs
    em_idx = (17 if env_hdri else 11) + 1 if mesh_textured else None
    # full-precision reductions: a TF32 contraction keeps ~3 digits
    hi = jax.lax.Precision.HIGHEST

    @jax.custom_vjp
    def f(packs, cam, scalars, bn_planes):
        return tuple(_pallas_forward(packs, cam, scalars, bn_planes, **kw))

    def f_fwd(packs, cam, scalars, bn_planes):
        *outs, sgrad = _pallas_forward(
            packs, cam, scalars, bn_planes, param_grads=True, **kw
        )
        mw = (outs[11], outs[12], outs[13]) if env_hdri else None
        emw = (outs[em_idx], outs[em_idx + 1], outs[em_idx + 2]) if em_idx else None
        quads, sph, qdr, _mesh = packs
        # (n_obj, 3) material colors in object-id order (spheres, quadrics,
        # quads) — the constants the kernel's hit counts implicitly divide by.
        parts = []
        if sph is not None:
            parts.append(sph[:, 16:19])
        if qdr is not None:
            parts.append(qdr[:, 16:19])
        parts.append(quads[:, 15:18])
        colors = jnp.concatenate(parts, axis=0)
        zeros = jax.tree.map(_zeros_ct, (packs, cam, scalars, bn_planes),
                             is_leaf=lambda x: x is None)
        res = (outs[0], outs[1], outs[2], outs[9], mw, emw, sgrad, colors, zeros)
        return tuple(outs), res

    def f_bwd(res, cot):
        cr, cg, cb, oid_plane, mw, emw, sgrad, colors, zeros = res
        (zq, zs, zqd, zmesh), zcam, zscalars, zbn = zeros
        n_s = zs.shape[0] if zs is not None else 0
        n_qd = zqd.shape[0] if zqd is not None else 0
        n_q = zq.shape[0]
        n_obj = n_q + n_s + n_qd
        adj_col = jnp.stack(cot[0:3])  # (3, H, W) radiance cotangent
        color = jnp.stack([cr, cg, cb])
        weighted = adj_col * color
        if env_hdri:
            # env-terminated paths: mw = m * env_w shares the path's
            # ∂log-throughput planes
            weighted = weighted + jnp.stack(cot[11:14]) * jnp.stack(mw)
        if emw is not None:
            # emissive-terminated paths likewise: em_w = m at termination
            weighted = weighted + jnp.stack(cot[em_idx:em_idx + 3]) * jnp.stack(emw)
        inv_c = 1.0 / jnp.maximum(colors, 1e-8)  # (n_obj, 3)
        # ∂log f/∂c = 1/c per linear hit; + 0.01·t/c in the Beer clip's
        # linear region (kernel planes carry the counts / Σ0.01·t).
        gcol = jnp.einsum("chw,jhw->jc", weighted, sgrad[:n_obj], precision=hi) * inv_c
        if sgrad.shape[0] > n_obj:  # Beer-Lambert planes (absorption mode)
            beer_gate = ((colors > 0.01) & (colors < 0.99)).astype(jnp.float32)
            gcol = gcol + jnp.einsum(
                "chw,jhw->jc", weighted, sgrad[n_obj:], precision=hi
            ) * beer_gate * inv_c
        # first-hit object_color record: d record_c / d color[j,c] = [oid == j]
        adj_oc = jnp.stack(cot[6:9])
        onehot = (oid_plane[None] == jnp.arange(n_obj, dtype=jnp.float32)[:, None, None])
        gcol = gcol + jnp.einsum("chw,jhw->jc", adj_oc, onehot.astype(jnp.float32),
                                 precision=hi)
        # object-id order: spheres, quadrics, quads (intersect.py numbering)
        gq = zq.at[:, 15:18].set(gcol[n_s + n_qd:])
        gs = zs.at[:, 16:19].set(gcol[:n_s]) if zs is not None else None
        gqd = zqd.at[:, 16:19].set(gcol[n_s:n_s + n_qd]) if zqd is not None else None
        return ((gq, gs, gqd, zmesh), zcam, zscalars, zbn)

    f.defvjp(f_fwd, f_bwd)
    return f


def _setup_inputs(scene: Scene, camera, cfg: IntegratorConfig, width, img_height,
                  frame_counter, row_offset):
    """Packing/validation for the fused entry point: (packs, cam, scalars)."""
    assert cfg.env in ("none", "sky", "hdri")
    assert cfg.nee in ("quad", "sun", "env")
    assert (cfg.env == "none") == (cfg.nee == "quad")
    if cfg.nee == "env":
        assert cfg.env == "hdri" and scene.env is not None and scene.env.env_cdf is not None, (
            "nee='env' needs an HDRI environment with a built env_cdf "
            "(bpt_tpu.env.build_env_cdf; hdri_scene does this)")
    if cfg.metal_roughness_lobe:
        assert scene.mesh is not None and scene.mesh.albedo is not None, (
            "metal_roughness_lobe needs a textured mesh (per-lane roughness)"
        )
    packs = pack_scene(scene) + (pack_mesh(scene),)
    cam = pack_camera(camera, width, img_height)
    shape_k = (
        jnp.asarray(scene.quadrics.shape_k, jnp.float32)
        if scene.quadrics is not None
        else jnp.asarray(0.5, jnp.float32)
    )
    if scene.env is not None and scene.env.sun_direction is not None:
        sun = jnp.asarray(scene.env.sun_direction, jnp.float32)
        sun_power = jnp.asarray(scene.env.sun_power, jnp.float32)
    else:
        sun = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
        sun_power = jnp.asarray(1.0, jnp.float32)
    if cfg.env == "sky":
        # Scalar sky terms (pure functions of the sun direction) computed
        # once outside the kernel instead of in every lane.
        from bpt_tpu import sky as _sky

        sun_e = _sky.sun_intensity(sun[1])
        sunfade = 1.0 - jnp.clip(1.0 - jnp.exp(sun[1] / 450000.0), 0.0, 1.0)
        sky_gamma = 1.0 / (1.2 + 1.2 * sunfade)
        sky_blend = jnp.clip((1.0 - sun[1]) ** 5, 0.0, 1.0)
    else:
        sun_e = sky_gamma = sky_blend = jnp.asarray(0.0, jnp.float32)
    # ONB about the sun (cross-trick, PathTracingCommon.js:527-528)
    s_up = jnp.abs(sun[1]) < 0.9
    helper = jnp.where(s_up, jnp.asarray([0.0, 1.0, 0.0]), jnp.asarray([1.0, 0.0, 0.0]))
    su = jnp.cross(helper, sun)
    su = su / jnp.sqrt(jnp.maximum(jnp.sum(su * su), 1e-20))
    sv = jnp.cross(sun, su)
    scalars = jnp.stack(
        [
            jnp.asarray(frame_counter, jnp.float32),
            jnp.asarray(0.0, jnp.float32),
            shape_k,
            sun[0],
            sun[1],
            sun[2],
            sun_power,
            jnp.asarray(sun_e, jnp.float32),
            jnp.asarray(sky_gamma, jnp.float32),
            jnp.asarray(sky_blend, jnp.float32),
            jnp.asarray(row_offset, jnp.float32),
            *su,
            *sv,
        ]
    )
    return packs, cam, scalars


def trace_image_pallas(
    scene: Scene,
    camera,
    cfg: IntegratorConfig,
    width: int,
    height: int,
    frame_counter,
    rand_vec2,
    blue_noise,
    interpret: bool = False,
    differentiable: bool = False,
    fast_quads: bool | None = None,
    block: tuple | None = None,
    full_height: int | None = None,
    row_offset=0,
):
    """Pallas forward of the Cornell-, quadric-, sky-, glTF- and HDRI-family
    radiance pass.

    Returns the same RadianceResult as integrator.frame.trace_image (same
    RNG schedule, float-level parity).  Covers scenes built from quads +
    matrix-instanced unit spheres + the 12-shape transformed-quadric set +
    one BVH triangle mesh (walked in-loop by the escape-linked BVH4 walk),
    with env 'none' + quad NEE (Cornell / Transformed_Quadric_Geometry /
    GLTF_Model demos), env 'sky' + sun NEE (Physical_Sky_Model: Preetham
    miss shading with the 5-case chain), or env 'hdri' + sun NEE or env-CDF
    NEE (HDRI_Environment: the kernel defers the equirect fetch by emitting
    miss-weight/direction planes — a path misses at most once — and this
    wrapper composes ``color += miss_w * Get_HDR_Color``; for nee='env' the
    inverse-CDF samples are precomputed outside the kernel from the same
    fixed-schedule draws, see ``_env_nee_planes``).

    The kernel compiles for the GPU through Triton; ``interpret=True`` runs
    it in the Pallas interpreter instead (any backend).  Without it, a
    non-GPU backend raises.  ``block`` overrides the (rows, cols) pixel
    block of one program (powers of two; default ``block_shape``).

    Row sharding: ``full_height`` is the whole image's height and
    ``row_offset`` (traced or static) the first absolute row of this call's
    ``height`` rows — the RNG, NDC and draw planes are keyed by absolute
    pixel coordinates, so shards of a ``shard_map`` reproduce the
    unsharded image.

    With ``differentiable=True`` the call carries the fused path-replay
    custom_vjp: gradients flow to quad/sphere/quadric material colors (incl.
    the light emission) at ~forward cost; env 'hdri' additionally gets exact
    HDR-image/exposure gradients through the outer equirect composition.
    Other leaves get zero cotangents.

    Textured (PBR) meshes run fused too: the kernel walks the BVH in-loop,
    takes material decisions from per-triangle baked attributes
    (scenes.gltf_scene.bake_triangle_attrs), and DEFERS the albedo/emissive
    texel fetches via per-bounce UV planes composed here — values are
    bilinear-texel-exact, decisions are per-triangle (the documented
    approximation; the wavefront path decides per texel).
    """
    interpret = use_interpreter(interpret)
    img_height = height if full_height is None else full_height
    packs, cam, scalars = _setup_inputs(scene, camera, cfg, width, img_height,
                                        frame_counter, row_offset)
    bn_planes = _blue_noise_planes(jnp.asarray(blue_noise), img_height, width,
                                   jnp.asarray(rand_vec2))
    if cfg.nee == "env":
        bn_planes = jnp.concatenate(
            [bn_planes, _env_nee_planes(scene, cfg, frame_counter, img_height, width)],
            axis=0,
        )
    if img_height != height:
        # draw planes are built for the FULL image and row-sliced, so a
        # row shard consumes the draws of its absolute pixels
        bn_planes = jax.lax.dynamic_slice_in_dim(bn_planes, row_offset, height, axis=1)
    block = tuple(block) if block is not None else block_shape(height, width)
    if fast_quads is None:
        # NB: under jit tracing the vertices are tracers and this resolves
        # to False — callers with a concrete scene (attach_pallas_path,
        # bench) should decide once and pass fast_quads explicitly.
        fast_quads = _all_parallelograms(scene.quads)
    mesh_textured = scene.mesh is not None and scene.mesh.albedo is not None
    if differentiable:
        f = _prb_fn(cfg, height, width, img_height, block, interpret,
                    fast_quads, mesh_textured)
        outs = f(packs, cam, scalars, bn_planes)
    else:
        outs = _pallas_forward(
            packs, cam, scalars, bn_planes, cfg, height, width, img_height,
            block, interpret, fast_quads=fast_quads, mesh_textured=mesh_textured,
        )
    return _compose_result(outs, scene, cfg, mesh_textured)


def _compose_result(outs, scene, cfg, mesh_textured):
    """Composition tail of the fused path: deferred env and texel fetches."""
    from bpt_tpu.integrator.radiance import RadianceResult

    (cr, cg, cb, onx, ony, onz, ocr, ocg, ocb, oid, osh) = outs[:11]
    color = jnp.stack([cr, cg, cb], axis=-1)
    n_base = 11
    if cfg.env == "hdri":
        # deferred equirect fetch: exactly one env lookup per path, outside
        # the kernel (Get_HDR_Color, HDRIEnvironmentPathTracing_
        # FragmentShader.js:351-360) — differentiable in image/exposure.
        from bpt_tpu.env import get_hdr_color

        mw = jnp.stack(outs[11:14], axis=-1)
        mdir = jnp.stack(outs[14:17], axis=-1)
        color = color + mw * get_hdr_color(
            scene.env.hdr_image, mdir, scene.env.hdr_exposure
        )
        n_base = 17
    if mesh_textured:
        # Deferred PBR composition.  Every path contributes radiance at
        # exactly ONE terminal event, so the per-bounce albedo factors
        # (which always precede it) factor out of the kernel exactly:
        # color_total = (kernel_color [+ env] + em_w·emission) · Π albedo.
        # Texel values are bilinear-exact (sRGB pow 2.2 decode,
        # GLTFModelPathTracing_FragmentShader.js:434-447); only the
        # branch DECISIONS are per-triangle (bake_triangle_attrs).
        from bpt_tpu.textures import sample_mesh_tex

        if scene.mesh.emissive is not None:
            em_w = jnp.stack(outs[n_base + 1:n_base + 4], axis=-1)
            em_uv = jnp.stack(outs[n_base + 4:n_base + 6], axis=-1)
            emission = jnp.power(
                jnp.maximum(sample_mesh_tex(scene.mesh.emissive,
                                            scene.mesh.emissive_q, em_uv), 0.0), 2.2
            )
            color = color + em_w * emission
        prod = jnp.ones_like(color)
        for b in range(cfg.bounces):
            au = outs[n_base][2 * b]
            av = outs[n_base][2 * b + 1]
            has_f = (au >= 0.0)[..., None]
            alb = jnp.power(
                jnp.maximum(
                    sample_mesh_tex(scene.mesh.albedo, scene.mesh.albedo_q,
                                    jnp.stack([au, av], -1)),
                    0.0,
                ),
                2.2,
            )
            prod = prod * jnp.where(has_f, alb, 1.0)
        color = color * prod
    return RadianceResult(
        color=color,
        object_normal=jnp.stack([onx, ony, onz], axis=-1),
        object_color=jnp.stack([ocr, ocg, ocb], axis=-1),
        object_id=oid,
        pixel_sharpness=osh,
    )
