"""Demo 4 — glTF model with BVH (Cornell box host).

Reference page: /root/reference/GLTF_Model_Path_Tracing.html.  Model presets
match the reference's picker (GLTF_Model_Path_Tracing.js:892-925).
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apps.common import base_parser, maybe_force_cpu, run_and_save

PRESETS = {
    # name: (path, initial_scale, flip_z/RH->LH)
    "teapot": ("UtahTeapot.glb", 130.0, True),
    "bunny": ("StanfordBunny.glb", 0.05, True),
    "duck": ("Duck.gltf", 10.0, False),
    "helmet": ("DamagedHelmet.gltf", 15.0, True),
}


def main():
    p = base_parser("glTF model path tracer")
    p.add_argument("--pallas", action="store_true",
                   help="fused Pallas megakernel (textured models use the "
                        "deferred-PBR composition)")
    p.add_argument("--model", choices=sorted(PRESETS), default="teapot")
    p.add_argument("--models-dir", default="/root/reference/models")
    p.add_argument("--mat", type=int, default=3, help="model material when untextured")
    args = p.parse_args()
    maybe_force_cpu(args)

    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.io import load_gltf
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    print(f"{args.model}: {model.triangle_count} triangles, textured={model.albedo is not None}")
    mesh = mesh_from_model(model, mat_type=args.mat)
    scene = gltf_scene(mesh)
    cfg = IntegratorConfig(bounces=args.bounces, metal_roughness_lobe=model.albedo is not None)
    r = ProgressiveRenderer(scene, cfg, args.size, args.size)
    if args.pallas:
        from bpt_tpu.kernels.integration import attach_pallas_path

        attach_pallas_path(r, interpret=args.interpret)
    run_and_save(r, gltf_camera(), args, f"gltf_{args.model}")


if __name__ == "__main__":
    main()
