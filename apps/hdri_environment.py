"""Demo 5 — HDRI environment + glTF model.

Reference page: /root/reference/HDRI_Environment_Path_Tracing.html.  The
reference's five .hdr assets are missing from its snapshot
(.MISSING_LARGE_BLOBS), so --hdr accepts any equirect Radiance file; with
none given, a procedurally generated sky-with-sun environment is used.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from apps.common import base_parser, maybe_force_cpu, run_and_save


def synthetic_hdr(h=256, w=512, sun_uv=(0.7, 0.3), sun_power=40.0):
    """Equirect gradient sky + bright sun disc (stand-in for the missing assets)."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    v /= h
    u /= w
    sky = np.stack(
        [0.2 + 0.3 * (1 - v), 0.35 + 0.4 * (1 - v), 0.7 + 0.3 * (1 - v)], axis=-1
    )
    d2 = ((u - sun_uv[0]) * 2) ** 2 + (v - sun_uv[1]) ** 2
    sun = np.exp(-d2 * 4000.0)[..., None] * np.array([1.0, 0.95, 0.8]) * sun_power
    return (sky + sun).astype(np.float32)


def main():
    p = base_parser("HDRI environment path tracer")
    p.add_argument("--nee", choices=("sun", "env"), default="sun",
                   help="'sun' = reference sun-lobe NEE; 'env' = luminance-"
                        "CDF importance sampling (fused path precomputes the "
                        "inverse-CDF draw planes per bounce)")
    p.add_argument("--pallas", action="store_true",
                   help="fused Pallas megakernel (textured models use the "
                        "deferred-PBR composition)")
    p.add_argument("--model", default="duck")
    p.add_argument("--models-dir", default="/root/reference/models")
    p.add_argument("--hdr", default=None, help="path to an equirect .hdr")
    p.add_argument("--hdr-exposure", type=float, default=1.0)
    p.add_argument("--sun-power", type=float, default=4.0)
    args = p.parse_args()
    maybe_force_cpu(args)

    from apps.gltf_model import PRESETS
    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.io import load_gltf, read_hdr
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.gltf_scene import hdri_camera, hdri_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    mesh = mesh_from_model(model, mat_type=3)
    hdr = read_hdr(args.hdr) if args.hdr else synthetic_hdr()
    scene = hdri_scene(mesh, hdr, hdr_exposure=args.hdr_exposure, sun_power=args.sun_power)
    cfg = IntegratorConfig(
        bounces=args.bounces, env="hdri", nee=args.nee, sun_weight_mode="hdri",
        sun_lobe_roughness=0.03, diffuse_indirect_max=2,
        metal_roughness_lobe=model.albedo is not None,
    )
    r = ProgressiveRenderer(scene, cfg, args.size, args.size)
    if args.pallas:
        from bpt_tpu.kernels.integration import attach_pallas_path

        attach_pallas_path(r, interpret=args.interpret)
    run_and_save(r, hdri_camera(), args, f"hdri_{args.model}")


if __name__ == "__main__":
    main()
