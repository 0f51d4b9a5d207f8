"""Wavefront path-tracing integrator (the CalculateRadiance analog).

The reference's per-pixel SIMT megakernel becomes a fully vectorized,
masked-lane wavefront over the whole pixel array: every bounce intersects all
live rays, evaluates all material branches branchlessly and selects by
material id.  The same code runs as the CPU jnp reference, jitted on one GPU,
and inside `shard_map` tiles.
"""

from bpt_tpu.integrator.config import IntegratorConfig
from bpt_tpu.integrator.intersect import Hit, scene_intersect
from bpt_tpu.integrator.radiance import calculate_radiance
from bpt_tpu.integrator.frame import render_frame, trace_image
