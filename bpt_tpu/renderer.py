"""Progressive renderer: explicit, checkpointable accumulation state + FSM.

The reference's render loop (/root/reference/js/Babylon_Path_Tracing.js:374-622)
drives a state machine over two mutable GPU render targets:
still camera → uSampleCounter += 1; any motion / dynamic scene → sample
counter resets to 1 and the *first* moving frame sets uFrameCounter = 1,
which makes the shader clear the accumulation history
(Babylon_Path_Tracing.js:582-605).  Camera motion is detected by comparing
all 16 floats of the camera world matrix (:480-492).

Here that becomes a functional `RenderState` pytree threaded through a jitted
`step` — which is also exactly what makes progressive rendering resumable /
checkpointable (the buffer + two counters are the whole state, cf. SURVEY §5)
and shardable (the buffer is just a device array a Mesh can partition).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from bpt_tpu.camera import Camera
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.integrator.frame import render_frame
from bpt_tpu.postprocess import screen_output
from bpt_tpu.scenes.types import Scene


class RenderState(NamedTuple):
    """Everything progressive rendering needs to resume — nothing hidden."""

    accum: jnp.ndarray  # (H, W, 4) running radiance sum + alpha edge flags
    sample_counter: jnp.ndarray  # float32 scalar (uSampleCounter)
    frame_counter: jnp.ndarray  # float32 scalar (uFrameCounter)


def init_state(height: int, width: int, dtype=jnp.float32) -> RenderState:
    return RenderState(
        accum=jnp.zeros((height, width, 4), dtype),
        sample_counter=jnp.asarray(0.0, jnp.float32),
        frame_counter=jnp.asarray(0.0, jnp.float32),
    )


def step_state(
    scene: Scene,
    camera: Camera,
    cfg: IntegratorConfig,
    state: RenderState,
    camera_is_moving,
    rand_vec2,
    blue_noise: jnp.ndarray,
) -> RenderState:
    """One progressive frame (pure function; jit/shard_map-able).

    Counter FSM (Babylon_Path_Tracing.js:582-605): while moving,
    sample_counter pins to 1 and frame_counter resets to 1 *only on the first
    moving frame* — encoded here as: moving ? (1, 1 if prev moving-streak
    just started else +1). We detect "just started" by sample_counter > 1.
    """
    moving = jnp.asarray(camera_is_moving, bool)
    was_still = state.sample_counter != 1.0
    frame_counter = jnp.where(
        moving & was_still, 1.0, state.frame_counter + 1.0
    )
    sample_counter = jnp.where(moving, 1.0, state.sample_counter + 1.0)
    accum = render_frame(
        scene, camera, cfg, state.accum, frame_counter, moving, rand_vec2, blue_noise
    )
    return RenderState(accum=accum, sample_counter=sample_counter, frame_counter=frame_counter)


class ProgressiveRenderer:
    """Host-side driver: owns static config, jits the step, tracks motion.

    The dat.GUI "dirty flag" protocol (any scene/camera parameter change ⇒
    reset accumulation, Babylon_Path_Tracing.js:382-450) maps to
    `camera_moved`: pass a new Camera each frame and the 16-float world-matrix
    comparison decides resets, exactly like the reference.
    """

    def __init__(
        self,
        scene: Scene,
        cfg: IntegratorConfig,
        height: int,
        width: int,
        blue_noise: Optional[jnp.ndarray] = None,
        seed: int = 0,
    ):
        self.scene = scene
        self.cfg = cfg
        self.height = height
        self.width = width
        self.blue_noise = (
            blue_noise if blue_noise is not None else jnp.asarray(blue_noise_table())
        )
        self.state = init_state(height, width)
        self._np_rng = np.random.default_rng(seed)
        self._last_cam_matrix: Optional[np.ndarray] = None
        self._raw_step = step_state  # swapped by kernels.integration
        self._step = jax.jit(step_state, static_argnums=(2,))
        self._scan_cache = None
        # optional concrete-scene validator installed by attach_pallas_path:
        # re-checks attach-time static scene facts (e.g. the parallelogram
        # quad fast path) when a different scene object is passed later
        self._scene_guard = None

    def camera_moved(self, camera: Camera) -> bool:
        m = np.asarray(camera.world_matrix())
        moved = self._last_cam_matrix is None or not np.array_equal(m, self._last_cam_matrix)
        self._last_cam_matrix = m
        return moved

    def render_sample(self, camera: Camera, force_reset: bool = False) -> RenderState:
        """Advance one frame; returns the new state (also stored)."""
        moving = self.camera_moved(camera) or force_reset
        if self._scene_guard is not None:
            self._scene_guard(self.scene)
        rand_vec2 = jnp.asarray(self._np_rng.random(2), jnp.float32)
        self.state = self._step(
            self.scene, camera, self.cfg, self.state, moving, rand_vec2, self.blue_noise
        )
        return self.state

    def render(self, camera: Camera, spp: int, batch: int = 8) -> jnp.ndarray:
        """Render spp progressive samples from scratch and return display rgb.

        Samples are fused ``batch`` at a time into a single jitted
        `lax.scan` dispatch (the camera is static within `render`, so the
        per-sample FSM reduces to sample_counter += 1): one device round
        trip per batch instead of per sample — per-dispatch latency
        otherwise dominates small frames.  Set
        ``batch=1`` to recover strict sample-at-a-time stepping.
        """
        self.state = init_state(self.height, self.width)
        self._last_cam_matrix = None
        if batch <= 1:
            for _ in range(spp):
                self.render_sample(camera)
            return self.display()
        # first sample via the normal step (it handles the reset protocol)
        self.render_sample(camera)
        done = 1
        scan = self._get_scan()
        while done < spp:
            k = min(batch, spp - done)
            rvs = jnp.asarray(self._np_rng.random((k, 2)), jnp.float32)
            self.state = scan(self.scene, camera, self.cfg, self.state, rvs, self.blue_noise)
            done += k
        return self.display()

    def _get_scan(self):
        if self._scan_cache is None:
            raw = self._raw_step

            @functools.partial(jax.jit, static_argnums=(2,))
            def scan_fn(scene, camera, cfg, state, rvs, bn):
                def body(st, rv):
                    return raw(scene, camera, cfg, st, False, rv, bn), None

                out, _ = jax.lax.scan(body, state, rvs)
                return out

            self._scan_cache = scan_fn
        return self._scan_cache

    def display(self, apply_denoise: bool = True, exposure: float = 1.0) -> jnp.ndarray:
        inv_n = 1.0 / jnp.maximum(self.state.sample_counter, 1.0)
        return screen_output(self.state.accum, inv_n, exposure, apply_denoise)
