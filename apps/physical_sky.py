"""Demo 3 — Preetham physical sky (sun-lit open Cornell box).

Reference page: /root/reference/Physical_Sky_Model.html.  BASELINE config #3.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apps.common import base_parser, maybe_force_cpu, run_and_save


def main():
    p = base_parser("Physical sky path tracer")
    p.add_argument("--sun-rx", type=float, default=298.0, help="sun rotation X, degrees")
    p.add_argument("--sun-ry", type=float, default=318.0, help="sun rotation Y, degrees")
    p.add_argument("--pallas", action="store_true", help="use the fused Pallas megakernel")
    args = p.parse_args()
    maybe_force_cpu(args)

    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.sky_scene import physical_sky_scene, sky_camera

    scene = physical_sky_scene(args.sun_rx, args.sun_ry)
    cfg = IntegratorConfig(bounces=args.bounces, env="sky", nee="sun")
    r = ProgressiveRenderer(scene, cfg, args.size, args.size)
    if args.pallas:
        from bpt_tpu.kernels.integration import attach_pallas_path

        attach_pallas_path(r, interpret=args.interpret)
    run_and_save(r, sky_camera(), args, "physical_sky")


if __name__ == "__main__":
    main()
