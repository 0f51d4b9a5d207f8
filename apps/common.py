"""Shared CLI plumbing for the demo apps (the reference's HTML pages analog).

Each app mirrors one reference demo page: build the scene, run the
progressive renderer for N samples, tonemap, write a PNG.  The dat.GUI
config surface becomes argparse flags; the "any param change resets
accumulation" contract is automatic (a fresh renderer per run).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--size", type=int, default=256, help="image is size x size")
    p.add_argument("--spp", type=int, default=32, help="progressive samples")
    p.add_argument("--bounces", type=int, default=6)
    p.add_argument("--out", type=str, default=None, help="output PNG path")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--interpret", action="store_true",
                   help="run the fused Pallas kernel (--pallas) in the Pallas "
                        "interpreter instead of compiling it for the GPU; "
                        "needed with --cpu")
    return p


def maybe_force_cpu(args) -> None:
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")


def run_and_save(renderer, camera, args, default_name: str) -> np.ndarray:
    from bpt_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # warm-up render so the reported rate is post-compile (the first pass
    # pays the one-time jit and kernel compiles)
    t0 = time.time()
    renderer.render(camera, spp=args.spp)
    compile_s = time.time() - t0
    t0 = time.time()
    renderer.render(camera, spp=args.spp)
    img = np.asarray(renderer.display(apply_denoise=not args.no_denoise, exposure=args.exposure))
    dt = time.time() - t0
    rays = args.size * args.size * args.bounces * args.spp
    print(
        f"{default_name}: {args.size}x{args.size} {args.spp}spp {args.bounces}b "
        f"in {dt:.1f}s ({rays/dt/1e6:.1f} Mrays/s; compile+warm-up render {compile_s:.1f}s)"
    )
    out = args.out or f"{default_name}.png"
    try:
        from PIL import Image

        Image.fromarray((np.flipud(img) * 255).astype(np.uint8)).save(out)
        print(f"wrote {out}")
    except ImportError:
        np.save(out + ".npy", img)
        print(f"PIL unavailable; wrote {out}.npy")
    return img
