"""Benchmark: rays/s of the fused Triton megakernel and of the XLA wavefront.

    python bench.py                                   # Cornell fwd+bwd, 1024^2, 4 bounces, 8 frames
    python bench.py --scene quadric --forward-only
    python bench.py --scene heightfield --forward-only --frames 1
    python bench.py --path pallas,xla                 # both paths, one process

Prints one JSON line per path.  K progressive frames run inside ONE
dispatch (lax.scan), the real workload shape; fwd+bwd differentiates the
K-frame scan w.r.t. the light emission (inverse-rendering shape).  Each
line gives the median of ``--repeats`` timed dispatches after a warm-up,
the compile time separately, and the device as JAX reports it beside the
card's name and power limit.

Accounting: rays = H * W * bounces * K — one SceneIntersect wavefront per
pixel per bounce per frame (NEE shadow rays ride the same wavefront; the
backward sweep is NOT counted extra, so the number is conservative for a
fwd+bwd step).

A measurement needs the GPU: on any other backend the script exits
non-zero.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp


def build_scene(args):
    """(scene, camera, cfg) of the named benchmark scene."""
    from bpt_tpu.integrator import IntegratorConfig

    if args.scene == "cornell":
        from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

        return cornell_scene(), cornell_camera(), IntegratorConfig(bounces=args.bounces)
    if args.scene == "quadric":
        from bpt_tpu.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

        # the Transformed_Quadric_Geometry demo config (transparent_tint)
        return (quadric_geometry_scene(shape_k=0.35), quadric_camera(),
                IntegratorConfig(bounces=args.bounces, transparent_tint=True))
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
    from bpt_tpu.scenes.synthetic import heightfield_model

    mesh = mesh_from_model(heightfield_model(rugged=args.rugged), mat_type=1)
    return gltf_scene(mesh), gltf_camera(), IntegratorConfig(bounces=args.bounces)


def make_step(path, scene, camera, cfg, args):
    """Jitted (light_color, frame0) -> image sum (fwd) or (image, grad)."""
    from bpt_tpu.core.rng import blue_noise_table
    from bpt_tpu.integrator.frame import trace_image
    from bpt_tpu.kernels.megakernel import _all_parallelograms, trace_image_pallas

    h = w = args.size
    bn = jnp.asarray(blue_noise_table())
    rv = jnp.asarray([0.3, 0.7], jnp.float32)
    fast_quads = _all_parallelograms(scene.quads)

    def trace(s, fc):
        if path == "pallas":
            return trace_image_pallas(
                s, camera, cfg, w, h, fc, rv, bn,
                differentiable=not args.forward_only, fast_quads=fast_quads).color
        return trace_image(s, camera, cfg, w, h, fc, rv, bn).color

    def k_frames(light_color, frame0):
        quads = scene.quads._replace(color=scene.quads.color.at[-1].set(light_color))
        s = scene._replace(quads=quads)

        def body(acc, fc):
            return acc + trace(s, fc), None

        if path == "xla" and not args.forward_only:
            # per-frame rematerialization: the wavefront's K-frame fwd+bwd
            # would otherwise hold every frame's residuals; the fused
            # path-replay VJP keeps only ~(n_obj*3) planes per frame
            body = jax.checkpoint(body)
        out, _ = jax.lax.scan(body, jnp.zeros((h, w, 3), jnp.float32),
                              frame0 + jnp.arange(0.0, args.frames))
        return jnp.mean(out), out

    if args.forward_only:
        return jax.jit(lambda lc, f0: k_frames(lc, f0)[1])

    def fwd_bwd(lc, f0):
        (_, out), grad = jax.value_and_grad(k_frames, has_aux=True)(lc, f0)
        return out, grad

    return jax.jit(fwd_bwd)


def measure(path, scene, camera, cfg, args, device):
    step = make_step(path, scene, camera, cfg, args)
    lc = scene.quads.color[-1]
    f0 = jnp.asarray(2.0, jnp.float32)
    t0 = time.perf_counter()
    compiled = step.lower(lc, f0).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(lc, f0))  # warm-up
    times = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(lc, jnp.asarray(2.0 + (i + 1) * args.frames, jnp.float32)))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    rays = args.size * args.size * args.bounces * args.frames
    kind = "fwd" if args.forward_only else "fwd+bwd"
    return {
        "metric": f"rays/s {kind} {args.size}x{args.size} {args.bounces} bounces "
                  f"{args.frames} frames ({args.scene}, {path})",
        "value": rays / med,
        "unit": "rays/s",
        "median_s": med,
        "times_s": times,
        "compile_s": compile_s,
        **device,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", choices=("cornell", "quadric", "heightfield"), default="cornell")
    p.add_argument("--path", default="pallas",
                   help="comma list of 'pallas' (fused Triton megakernel) and "
                        "'xla' (wavefront integrator)")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--frames", type=int, default=8, help="frames fused per dispatch")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--forward-only", action="store_true")
    p.add_argument("--rugged", action="store_true",
                   help="heightfield: multi-octave displaced + jittered variant")
    args = p.parse_args()

    from bpt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    # a card set below its maximum power runs slower under load
    device["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0].strip()
    scene, camera, cfg = build_scene(args)
    for path in args.path.split(","):
        print(json.dumps(measure(path, scene, camera, cfg, args, device)), flush=True)


if __name__ == "__main__":
    main()
