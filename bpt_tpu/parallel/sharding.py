"""Tile-sharded SPMD rendering over a `jax.sharding.Mesh`.

The reference's entire parallel model is the GPU rasterizer's implicit
per-pixel SPMD with zero inter-pixel communication during tracing
(SURVEY.md §2.6).  The multi-device equivalent: shard the image's row axis
across devices with `shard_map`, replicate the scene/BVH (they are small
relative to HBM), and keep each shard's RNG keyed by *absolute* pixel
coordinates so `Mesh(1) ⊆ Mesh(N)` renders are bitwise-identical.

Communication inventory (all that this workload needs):
  * none during tracing — rays are embarrassingly parallel;
  * `psum` of scene-parameter gradients in inverse rendering — inserted
    automatically by AD through `shard_map` for replicated inputs;
  * halo exchange for the 5x5 denoise stencil — handled by running the
    postprocess under `jit` with sharding constraints, letting XLA's SPMD
    partitioner insert the (2-row) collective-permute halos.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bpt_tpu.camera import Camera
from bpt_tpu.core.rng import blue_noise_fetch, rng_seed
from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.integrator.frame import detect_edges, trace_image
from bpt_tpu.integrator.radiance import RadianceResult
from bpt_tpu.scenes.types import Scene


def make_mesh(devices=None, axis: str = "tiles") -> Mesh:
    """1-D device mesh over the image-tile (data-parallel) axis."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def sharded_trace(
    scene: Scene,
    camera: Camera,
    cfg: IntegratorConfig,
    height: int,
    width: int,
    frame_counter,
    rand_vec2,
    blue_noise: jnp.ndarray,
    mesh: Mesh,
    axis: str = "tiles",
) -> RadianceResult:
    """One 1-spp frame, rows sharded over `mesh`; result sharded the same way.

    height must divide evenly into mesh.size tiles of even row count (the
    2x2-quad edge detector must not straddle tile boundaries).
    """
    n = mesh.shape[axis]
    tile_rows = height // n
    assert tile_rows * n == height and tile_rows % 2 == 0, (
        f"height {height} must split into {n} even-row tiles"
    )

    def tile_fn(scene, camera, frame_counter, rand_vec2, blue_noise):
        row0 = jax.lax.axis_index(axis) * tile_rows
        return trace_image(
            scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
            tile_rows=tile_rows, row_offset=row0,
        )

    fn = jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=RadianceResult(
            color=P(axis), object_normal=P(axis), object_color=P(axis),
            object_id=P(axis), pixel_sharpness=P(axis),
        ),
        check_vma=False,
    )
    return fn(scene, camera, jnp.asarray(frame_counter, jnp.float32), rand_vec2, blue_noise)


def sharded_render_frame(
    scene: Scene,
    camera: Camera,
    cfg: IntegratorConfig,
    previous: jnp.ndarray,
    frame_counter,
    camera_is_moving,
    rand_vec2,
    blue_noise: jnp.ndarray,
    mesh: Mesh,
    axis: str = "tiles",
) -> jnp.ndarray:
    """Sharded analog of integrator.frame.render_frame: (H,W,4) -> (H,W,4).

    The entire per-frame step — trace, per-tile edge detection (2x2 quad
    pairs never straddle even-row tile boundaries), accumulation protocol —
    runs inside one `shard_map`, so no cross-device communication happens at
    all: the reference's zero-communication per-pixel SPMD, tile-scaled.
    """
    height, width = previous.shape[0], previous.shape[1]
    n = mesh.shape[axis]
    tile_rows = height // n
    assert tile_rows * n == height and tile_rows % 2 == 0, (
        f"height {height} must split into {n} even-row tiles"
    )

    def tile_fn(scene, camera, prev_tile, frame_counter, moving, rand_vec2, blue_noise):
        row0 = jax.lax.axis_index(axis) * tile_rows
        result = trace_image(
            scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
            tile_rows=tile_rows, row_offset=row0,
        )
        normal_diff, object_diff, color_diff = detect_edges(result)
        sharp = result.pixel_sharpness
        sharp = jnp.where(
            (color_diff >= 1.0) | (normal_diff >= 1.0) | (object_diff >= 1.0), 1.01, sharp
        )
        prev = jnp.where(frame_counter == 1.0, 0.0, prev_tile)
        prev_rgb = jnp.where(moving, prev[..., :3] * 0.5, prev[..., :3])
        prev_a = jnp.where(moving, 0.0, prev[..., 3])
        cur_rgb = jnp.where(moving, result.color * 0.5, result.color)
        cur_a = jnp.zeros_like(sharp)
        cur_a = jnp.where(sharp == 1.01, 1.01, cur_a)
        cur_a = jnp.where(sharp == -1.0, -1.0, cur_a)
        cur_a = jnp.where(prev_a == 1.01, 1.01, cur_a)
        cur_a = jnp.where(prev_a == -1.0, 0.0, cur_a)
        return jnp.concatenate([prev_rgb + cur_rgb, cur_a[..., None]], axis=-1)

    fn = jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(), P(), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(
        scene,
        camera,
        previous,
        jnp.asarray(frame_counter, jnp.float32),
        jnp.asarray(camera_is_moving, bool),
        rand_vec2,
        blue_noise,
    )
