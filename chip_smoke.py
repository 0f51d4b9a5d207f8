"""Smoke run of the path tracer's main paths on one GPU, at full size.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # only the row-sharded path, 4 cards

Phase 0  the card's name and power limit (nvidia-smi, no JAX), and JAX must
         see a GPU: on any other platform the script exits non-zero.
Phase 1  Cornell box 1024^2, 6 bounces, through ProgressiveRenderer.render:
         a few samples, a camera move (sample counter back to 1), display()
         with the denoiser; then the same samples through a renderer with
         the fused kernel attached (attach_pallas_path), against the first.
Phase 2  the 524,288-triangle seed heightfield and a seed textured mesh at
         1024^2 through the XLA wavefront BVH walk.
Phase 3  a few diff.inverse.optimize steps on Cornell at 512^2: the loss
         must decrease.
Phase 4  the fused Triton megakernel, compiled at 1024^2 for each family it
         serves, against the XLA wavefront with the same draws; both
         timed (median of 5 after a warm-up).
--four-cards: __graft_entry__.dryrun_multichip(4) at 1024: the sharded
         render and the psum'd albedo-map gradient of the textured mesh
         against one card, on the wavefront and on the fused kernel's row
         seam.

Each phase prints what it measured; any failure ends the run with a
non-zero exit code.  A line before the last counts the compiles that the
persistent compilation cache served; the last is one JSON object naming the
device.
"""

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances of the fused-vs-wavefront comparison (phase 4).  Both sides
# compute in float32 with no contraction (the 3x3 transforms are written as
# elementwise products and sums); the VJP reductions run at HIGHEST.
PIXEL_TOL = 1e-3      # |delta| above this counts as a differing pixel ...
PIXEL_FRAC = 0.01     # ... at most 1% of them: FP-tie path flips at silhouettes
MEAN_RTOL = 1e-4      # relative difference of the image means
OID_MATCH = 0.995     # object_id agreement
GRAD_RTOL = 1e-3      # path-replay VJP vs the wavefront's AD

SIZE = 1024           # image side of phases 1, 2, 4 and --four-cards
INVERSE_SIZE = 512    # image side of phase 3


# compiles that consulted the persistent cache, and those it served
CACHE_EVENTS = collections.Counter()


def log(msg):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    """A phase's check failed (raised, not asserted: `python -O` keeps it)."""


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def phase0():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        sys.exit(f"phase 0: nvidia-smi failed ({e}); no GPU to smoke-test")
    for line in out.stdout.strip().splitlines():
        log(f"phase 0: card {line.strip()}")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"phase 0: JAX found platform {dev.platform!r}, not a GPU")
    from bpt_tpu.utils.compile_cache import enable_compile_cache

    jax.monitoring.register_event_listener(
        lambda event, **_: CACHE_EVENTS.update([event.rsplit("/", 1)[-1]]))
    log(f"phase 0: jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
        f"compile cache {enable_compile_cache()}")
    return dev


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def median_time(fn, *args, repeats=5):
    """Median host-clock time of ``repeats`` calls after one warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    times = [timed(fn, *args)[1] for _ in range(repeats)]
    return float(np.median(times))


def image_diff(a, b):
    """Share of pixels off by more than PIXEL_TOL, and the relative
    difference of the image means."""
    frac = float(np.mean(np.abs(a - b).max(-1) > PIXEL_TOL))
    rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(a.mean())), 1e-12)
    return frac, rel


def phase1():
    import jax.numpy as jnp

    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.kernels.integration import attach_pallas_path
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

    size = SIZE
    cfg = IntegratorConfig(bounces=6)
    r = ProgressiveRenderer(cornell_scene(), cfg, size, size)
    cam = cornell_camera()
    _, dt = timed(r.render, cam, 4)
    check(float(r.state.sample_counter) == 4.0, f"sample counter {r.state.sample_counter} after 4 spp")
    wave = np.asarray(r.state.accum[..., :3]) / 4.0
    moved = cam._replace(position=cam.position + jnp.asarray([1.0, 0.0, 0.0]))
    _, dt2 = timed(r.render_sample, moved)
    check(float(r.state.sample_counter) == 1.0, "camera move must reset the sample counter")
    img = np.asarray(r.display(apply_denoise=True))
    check(img.shape == (size, size, 3) and np.isfinite(img).all() and img.max() > 0,
          "display() must be finite and nonzero")
    log(f"phase 1: cornell {size}^2 6 bounces: 4 spp in {dt:.2f}s (incl. compile), "
        f"moved-camera sample in {dt2:.2f}s, counter reset to 1, denoised display "
        f"mean {img.mean():.4f}")

    # the fused kernel through the renderer (--pallas): traced frame counter,
    # the batched scan and the accumulation protocol; same seed, same draws
    rp = ProgressiveRenderer(cornell_scene(), cfg, size, size)
    attach_pallas_path(rp)
    _, dt = timed(rp.render, cam, 4)
    fused = np.asarray(rp.state.accum[..., :3]) / 4.0
    check(float(rp.state.sample_counter) == 4.0 and np.isfinite(fused).all()
          and fused.max() > 0, "fused renderer: 4 spp must be finite and nonzero")
    frac, rel = image_diff(wave, fused)
    log(f"phase 1: cornell {size}^2 6 bounces through attach_pallas_path: 4 spp in "
        f"{dt:.2f}s (incl. compile); vs the wavefront renderer: pixels |d|>{PIXEL_TOL}: "
        f"{frac:.4%} (max {PIXEL_FRAC:.0%}), mean rel diff {rel:.2e} (max {MEAN_RTOL:.0e})")
    check(frac <= PIXEL_FRAC and rel <= MEAN_RTOL,
          "fused renderer outside the tolerances of the wavefront renderer")


def phase2():
    import jax
    import jax.numpy as jnp

    from bpt_tpu.core.rng import blue_noise_table
    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.integrator.frame import trace_image
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
    from bpt_tpu.scenes.synthetic import heightfield_model, textured_blob_model

    size = SIZE
    bn = jnp.asarray(blue_noise_table())
    rv = jnp.asarray([0.3, 0.7], jnp.float32)
    cam = gltf_camera()
    for name, model, cfg in (
        ("heightfield", heightfield_model(), IntegratorConfig(bounces=4)),
        ("textured mesh", textured_blob_model(),
         IntegratorConfig(bounces=4, metal_roughness_lobe=True)),
    ):
        t0 = time.perf_counter()
        mesh = mesh_from_model(model, mat_type=1)
        build = time.perf_counter() - t0
        scene = gltf_scene(mesh)
        f = jax.jit(lambda s: trace_image(s, cam, cfg, size, size, 2.0, rv, bn))
        res, dt = timed(f, scene)
        _, dt2 = timed(f, scene)
        c = np.asarray(res.color)
        mesh_px = float(np.mean(np.asarray(res.object_id) == 8.0))  # 2 spheres + 6 quads
        check(c.shape == (size, size, 3) and np.isfinite(c).all() and c.max() > 0,
              f"{name}: image must be finite and nonzero")
        check(mesh_px > 0.01, f"{name} covers no pixels")
        log(f"phase 2: {name} ({model.triangle_count} tris, BVH build {build:.1f}s) "
            f"{size}^2 XLA walk: {dt2 * 1e3:.1f} ms/frame (first call {dt:.1f}s), "
            f"mesh covers {mesh_px:.1%} of pixels, mean {c.mean():.4f}")


def phase3():
    import jax.numpy as jnp

    from bpt_tpu.diff.inverse import optimize, render_avg
    from bpt_tpu.core.rng import blue_noise_table
    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

    size = INVERSE_SIZE
    scene0, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=4)

    def build(params):
        q = scene0.quads
        return scene0._replace(quads=q._replace(color=q.color.at[0].set(params["wall"]))), cam

    true = {"wall": scene0.quads.color[0]}
    target = render_avg(build(true)[0], cam, cfg, size, (1.0, 2.0),
                        jnp.asarray([0.3, 0.7], jnp.float32), jnp.asarray(blue_noise_table()))
    t0 = time.perf_counter()
    res = optimize(build, {"wall": jnp.asarray([0.3, 0.3, 0.3])}, target, cfg, size,
                   steps=4, lr=0.1)
    losses = np.asarray(res.losses)
    dt = time.perf_counter() - t0
    check(np.isfinite(losses).all() and losses[-1] < losses[0], f"losses {losses} must decrease")
    log(f"phase 3: inverse rendering {size}^2 4 bounces, 4 Adam steps in {dt:.1f}s: "
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")


def fused_cases():
    """(name, scene, camera, cfg) of every family the fused kernel serves."""
    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

    from apps.hdri_environment import synthetic_hdr
    from bpt_tpu.scenes.gltf_scene import (
        gltf_camera, gltf_scene, hdri_camera, hdri_scene, mesh_from_model)
    from bpt_tpu.scenes.sky_scene import physical_sky_scene, sky_camera
    from bpt_tpu.scenes.synthetic import heightfield_model, textured_blob_model

    return [
        ("cornell", cornell_scene(), cornell_camera(), IntegratorConfig(bounces=4)),
        ("quadric", quadric_geometry_scene(shape_k=0.35), quadric_camera(),
         IntegratorConfig(bounces=4, transparent_tint=True)),
        ("sky", physical_sky_scene(), sky_camera(),
         IntegratorConfig(bounces=4, env="sky", nee="sun")),
        ("hdri env-NEE", hdri_scene(mesh_from_model(textured_blob_model(), mat_type=1),
                                    synthetic_hdr(), sun_power=4.0),
         hdri_camera(), IntegratorConfig(bounces=4, env="hdri", nee="env",
                                         diffuse_indirect_max=2)),
        ("heightfield", gltf_scene(mesh_from_model(heightfield_model(), mat_type=1)),
         gltf_camera(), IntegratorConfig(bounces=4)),
        ("textured mesh", gltf_scene(mesh_from_model(textured_blob_model(), mat_type=1)),
         gltf_camera(), IntegratorConfig(bounces=4, metal_roughness_lobe=True)),
    ]


def compare_images(name, ref, got):
    a, b = np.asarray(ref.color), np.asarray(got.color)
    check(b.shape == a.shape and np.isfinite(b).all(), f"{name}: bad fused output")
    frac, rel = image_diff(a, b)
    oid = float(np.mean(np.asarray(ref.object_id) == np.asarray(got.object_id)))
    log(f"phase 4: {name}: pixels |d|>{PIXEL_TOL}: {frac:.4%} (max {PIXEL_FRAC:.0%}), "
        f"mean rel diff {rel:.2e} (max {MEAN_RTOL:.0e}), object_id equal {oid:.4%} "
        f"(min {OID_MATCH:.1%}) [float32, no contractions]")
    check(frac <= PIXEL_FRAC and rel <= MEAN_RTOL and oid >= OID_MATCH,
          f"{name}: fused image outside the tolerances")


def phase4():
    import jax
    import jax.numpy as jnp

    from bpt_tpu.core.rng import blue_noise_table
    from bpt_tpu.integrator.frame import trace_image
    from bpt_tpu.kernels.megakernel import _all_parallelograms, trace_image_pallas

    size = SIZE
    bn = jnp.asarray(blue_noise_table())
    rv = jnp.asarray([0.3, 0.7], jnp.float32)
    cases = fused_cases()
    for name, scene, cam, cfg in cases:
        fq = _all_parallelograms(scene.quads)
        fused = jax.jit(lambda s: trace_image_pallas(
            s, cam, cfg, size, size, 2.0, rv, bn, fast_quads=fq))
        ref = jax.jit(lambda s: trace_image(s, cam, cfg, size, size, 2.0, rv, bn))
        t0 = time.perf_counter()
        compiled = fused.lower(scene).compile()
        log(f"phase 4: {name} fused kernel compiled in {time.perf_counter() - t0:.1f}s; "
            f"{compiled.memory_analysis()}")
        t0 = time.perf_counter()
        ref = ref.lower(scene).compile()
        ref_compile = time.perf_counter() - t0
        got, exp = compiled(scene), ref(scene)
        compare_images(name, exp, got)
        t_fused = median_time(compiled, scene)
        t_ref = median_time(ref, scene)
        log(f"phase 4: {name} {size}^2 {cfg.bounces} bounces forward, median of 5: "
            f"fused {t_fused * 1e3:.2f} ms, XLA wavefront {t_ref * 1e3:.2f} ms "
            f"(compiled in {ref_compile:.1f}s)")

    # path-replay VJP vs the wavefront's AD: light emission of the Cornell box
    name, scene, cam, cfg = cases[0]

    def loss(lc, fused):
        s = scene._replace(quads=scene.quads._replace(
            color=scene.quads.color.at[-1].set(lc)))
        if fused:
            r = trace_image_pallas(s, cam, cfg, size, size, 2.0, rv, bn,
                                   differentiable=True, fast_quads=True)
        else:
            r = trace_image(s, cam, cfg, size, size, 2.0, rv, bn)
        return jnp.mean(r.color * jnp.asarray([1.0, 2.0, 3.0]))

    lc = scene.quads.color[-1]
    g_fused = np.asarray(jax.jit(jax.grad(lambda x: loss(x, True)))(lc))
    g_ref = np.asarray(jax.jit(jax.grad(lambda x: loss(x, False)))(lc))
    log(f"phase 4: {name} VJP d loss/d light: fused {g_fused}, wavefront {g_ref} "
        f"(rtol {GRAD_RTOL}; reductions at HIGHEST)")
    np.testing.assert_allclose(g_fused, g_ref, rtol=GRAD_RTOL)


def four_cards():
    import jax

    from __graft_entry__ import dryrun_multichip

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, JAX sees {len(jax.devices())}")
    dryrun_multichip(4, size=SIZE)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded path over four cards")
    args = ap.parse_args()
    dev = phase0()
    import jax

    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        phase1()
        phase2()
        phase3()
        phase4()
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    log(f"compile cache: {CACHE_EVENTS['cache_hits']} of "
        f"{CACHE_EVENTS['compile_requests_use_cache']} compiles were served by the "
        f"persistent cache")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
