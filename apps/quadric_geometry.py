"""Demo 2 — transformed quadric geometry (12 shapes).

Reference page: /root/reference/Transformed_Quadric_Geometry.html.
BASELINE config #2 (with camera-gradient support via bpt_tpu.diff).
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apps.common import base_parser, maybe_force_cpu, run_and_save


def main():
    p = base_parser("Transformed quadric geometry path tracer")
    p.add_argument("--shape-k", type=float, default=0.5)
    p.add_argument("--mat", type=int, default=4, help="material for all shapes")
    p.add_argument("--pallas", action="store_true", help="use the fused Pallas megakernel")
    args = p.parse_args()
    maybe_force_cpu(args)

    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

    scene = quadric_geometry_scene(shape_k=args.shape_k, all_shapes_mat=args.mat)
    cfg = IntegratorConfig(bounces=args.bounces, transparent_tint=True)
    r = ProgressiveRenderer(scene, cfg, args.size, args.size)
    if args.pallas:
        from bpt_tpu.kernels.integration import attach_pallas_path

        attach_pallas_path(r, interpret=args.interpret)
    run_and_save(r, quadric_camera(), args, "quadric_geometry")


if __name__ == "__main__":
    main()
