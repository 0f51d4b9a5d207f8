"""Demo 1 — Cornell box + two spheres (Babylon_Path_Tracing demo).

Reference page: /root/reference/Babylon_Path_Tracing.html; scene semantics
from js/BabylonPathTracing_FragmentShader.js.  BASELINE config #1.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apps.common import base_parser, maybe_force_cpu, run_and_save


def main():
    p = base_parser("Cornell box path tracer")
    p.add_argument("--light-plane", type=int, default=6, choices=range(1, 7))
    p.add_argument("--light-radius", type=float, default=50.0)
    p.add_argument("--right-sphere-mat", type=int, default=3,
                   help="1 diffuse, 2 transparent, 3 metal, 4 clearcoat")
    p.add_argument("--pallas", action="store_true", help="use the fused Pallas megakernel")
    args = p.parse_args()
    maybe_force_cpu(args)

    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

    scene = cornell_scene(
        quad_light_plane=args.light_plane,
        quad_light_radius=args.light_radius,
        right_sphere_mat=args.right_sphere_mat,
    )
    cfg = IntegratorConfig(bounces=args.bounces)
    r = ProgressiveRenderer(scene, cfg, args.size, args.size)
    if args.pallas:
        from bpt_tpu.kernels.integration import attach_pallas_path

        attach_pallas_path(r, interpret=args.interpret)
    run_and_save(r, cornell_camera(), args, "cornell_box")


if __name__ == "__main__":
    main()
