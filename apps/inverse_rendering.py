"""Demo 6 — inverse rendering (BASELINE config #5 scaled to the CLI).

Renders a target image of a textured glTF model (DamagedHelmet by default),
re-initializes the albedo map to gray, and recovers it by gradient descent
through the full path tracer — the capability the reference doesn't have.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from apps.common import base_parser, maybe_force_cpu


def main():
    p = base_parser("Inverse rendering: recover a PBR albedo map")
    p.add_argument("--model", default="helmet")
    p.add_argument("--models-dir", default="/root/reference/models")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--tex-size", type=int, default=64, help="optimized map resolution")
    p.add_argument("--pallas", action="store_true",
                   help="fused megakernel fwd+bwd (path-replay VJP + "
                        "deferred-composition texture gradients)")
    args = p.parse_args()
    maybe_force_cpu(args)

    import jax.numpy as jnp

    from apps.gltf_model import PRESETS
    from bpt_tpu.diff.inverse import optimize
    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.io import load_gltf
    from bpt_tpu.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    assert model.albedo is not None, "model must be textured for albedo recovery"
    # downsample the true albedo to the optimization resolution
    t = args.tex_size
    ah, aw = model.albedo.shape[:2]
    true_albedo = model.albedo[:: max(ah // t, 1), :: max(aw // t, 1)][:t, :t]
    mesh0 = mesh_from_model(model, mat_type=1)
    camera = gltf_camera()
    cfg = IntegratorConfig(bounces=args.bounces, metal_roughness_lobe=True)

    def build(params):
        from bpt_tpu.textures import quad_pack

        # replace BOTH the raw map and its quad-packed twin (the sampling
        # paths prefer the packed table; quad_pack is differentiable)
        mesh = mesh0._replace(
            albedo=params["albedo"], albedo_q=quad_pack(params["albedo"])
        )
        return gltf_scene(mesh), camera

    from bpt_tpu.diff.inverse import render_avg
    from bpt_tpu.core.rng import blue_noise_table

    bn = jnp.asarray(blue_noise_table())
    rv = jnp.asarray([0.3, 0.7], jnp.float32)
    target_scene, _ = build({"albedo": jnp.asarray(true_albedo)})
    target = render_avg(target_scene, camera, cfg, args.size, (1.0, 2.0), rv, bn,
                        pallas=args.pallas, interpret=args.interpret)

    init = {"albedo": jnp.full_like(jnp.asarray(true_albedo), 0.5)}
    clip = lambda p: {"albedo": jnp.clip(p["albedo"], 0.0, 1.0)}
    result = optimize(
        build, init, target, cfg, args.size, steps=args.steps, lr=args.lr,
        param_clip=clip, pallas=args.pallas, interpret=args.interpret,
    )
    losses = np.asarray(result.losses)
    err0 = float(np.abs(np.asarray(init["albedo"]) - true_albedo).mean())
    err1 = float(np.abs(np.asarray(result.params["albedo"]) - true_albedo).mean())
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f} over {args.steps} steps")
    print(f"albedo mean abs error: {err0:.4f} -> {err1:.4f}")
    assert losses[-1] < losses[0], "optimization must reduce the loss"


if __name__ == "__main__":
    main()
