"""Inverse rendering: optimize scene parameters (incl. PBR texture maps) to
match target images — BASELINE config #5's machinery.

The loop is plain JAX: render with matched RNG per step, MSE against the
targets, optax updates, everything jittable and shardable (the loss can use
bpt_tpu.parallel.sharded render paths; parameter gradients then psum
automatically through shard_map AD).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import optax

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.integrator.frame import trace_image


class OptimizeResult(NamedTuple):
    params: dict
    losses: jnp.ndarray  # (steps,)


def render_avg(scene, camera, cfg, size, frames, rand_vec2, blue_noise,
               pallas: bool = False, interpret: bool = False):
    """Average of several 1-spp frames — the render op used on both sides of
    the inverse-rendering loss (matched RNG: frame ids are shared).

    ``pallas=True`` runs the fused megakernel with its path-replay custom
    VJP instead of the wavefront integrator: texture-map gradients (the
    albedo recovery parameter) flow through the kernel's deferred texel
    composition by plain AD, material-color gradients through the
    path-replay planes.  ``interpret`` passes through to the kernel (the
    Pallas interpreter instead of the GPU compile)."""
    if pallas:
        from bpt_tpu.kernels.megakernel import trace_image_pallas

        def one(f):
            return trace_image_pallas(
                scene, camera, cfg, size, size, f, rand_vec2, blue_noise,
                interpret=interpret, differentiable=True,
            ).color
    else:
        def one(f):
            return trace_image(
                scene, camera, cfg, size, size, f, rand_vec2, blue_noise
            ).color

    acc = 0.0
    for f in frames:
        acc = acc + one(f)
    return acc / len(frames)


def optimize(
    build_scene: Callable[[dict], tuple],
    init_params: dict,
    target: jnp.ndarray,
    cfg: IntegratorConfig,
    size: int,
    steps: int = 50,
    lr: float = 2e-2,
    frames: Sequence[float] = (1.0, 2.0),
    param_clip=None,
    pallas: bool = False,
    interpret: bool = False,
) -> OptimizeResult:
    """Adam loop: params -> scene -> render -> MSE(target).

    build_scene(params) -> (scene, camera).  `param_clip` optionally maps the
    raw params pytree to a valid domain (e.g. clamp albedo to [0, 1]) after
    each update, keeping the optimization in the feasible set.
    ``pallas=True``: fused-megakernel fwd+bwd (see render_avg).
    """
    bn = jnp.asarray(blue_noise_table())
    rv = jnp.asarray([0.3, 0.7], jnp.float32)
    target = jnp.asarray(target)

    def loss_fn(params):
        scene, camera = build_scene(params)
        img = render_avg(scene, camera, cfg, size, frames, rv, bn,
                         pallas=pallas, interpret=interpret)
        return jnp.mean((img - target) ** 2)

    opt = optax.adam(lr)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if param_clip is not None:
            params = param_clip(params)
        return params, opt_state, loss

    params = init_params
    opt_state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(loss)
    return OptimizeResult(params=params, losses=jnp.stack(losses))
