"""Wiring the Pallas megakernel into the progressive renderer.

`attach_pallas_path(renderer)` swaps a ProgressiveRenderer's jitted step for
one whose radiance pass is the fused Pallas kernel; edge detection and the
accumulation protocol are shared with the jnp path (finish_frame), so the
renderer's behavior — including denoiser alpha flags and motion resets — is
unchanged up to float tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bpt_tpu.integrator.frame import finish_frame
from bpt_tpu.kernels.megakernel import trace_image_pallas
from bpt_tpu.renderer import ProgressiveRenderer, RenderState


def attach_pallas_path(renderer: ProgressiveRenderer, interpret: bool = False) -> None:
    """Swap the renderer's step for the fused Pallas kernel.

    The kernel compiles for the GPU, or runs in the Pallas interpreter when
    ``interpret=True`` (passed through to ``megakernel.trace_image_pallas``)."""
    cfg = renderer.cfg
    height, width = renderer.height, renderer.width
    # static scene facts must be decided here, while the scene is concrete —
    # inside the jitted step the quad vertices are tracers and the
    # parallelogram fast path would silently stay off
    from bpt_tpu.kernels.megakernel import _all_parallelograms

    fast_quads = _all_parallelograms(renderer.scene.quads)

    # the compiled step is bound to the attach-time decision; if the caller
    # later swaps in a scene whose quads are NOT parallelograms, the fast
    # path would silently return wrong quad hits — re-validate whenever a
    # different quad object shows up (advisor r3 finding)
    # keyed by id() AND holding the object: a bare id() can be reused by
    # CPython after the original quads is collected, silently skipping the
    # re-validation this guard exists for (advisor r4 finding)
    _seen_quads = {id(renderer.scene.quads): renderer.scene.quads}

    def _scene_guard(scene):
        key = id(scene.quads)
        if _seen_quads.get(key) is scene.quads:
            return
        if fast_quads and not _all_parallelograms(scene.quads):
            raise ValueError(
                "attach_pallas_path compiled the parallelogram quad fast path "
                "for the attach-time scene, but this scene's quads are not "
                "parallelograms — re-attach the Pallas path for this scene"
            )
        _seen_quads[key] = scene.quads

    def step_state_pallas(scene, camera, _cfg, state, camera_is_moving, rand_vec2, blue_noise):
        moving = jnp.asarray(camera_is_moving, bool)
        was_still = state.sample_counter != 1.0
        frame_counter = jnp.where(moving & was_still, 1.0, state.frame_counter + 1.0)
        sample_counter = jnp.where(moving, 1.0, state.sample_counter + 1.0)
        result = trace_image_pallas(
            scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
            interpret=interpret, fast_quads=fast_quads,
        )
        accum = finish_frame(result, state.accum, frame_counter, moving)
        return RenderState(accum=accum, sample_counter=sample_counter, frame_counter=frame_counter)

    renderer._raw_step = step_state_pallas
    renderer._scan_cache = None  # rebuild the fused-sample scan on demand
    renderer._scene_guard = _scene_guard
    renderer._step = jax.jit(step_state_pallas, static_argnums=(2,))
