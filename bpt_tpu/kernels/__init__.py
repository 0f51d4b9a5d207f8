"""The fused Pallas megakernel (the compiled-fragment-shader tier).

`megakernel.trace_image_pallas` traces ray-gen → N bounces → first-hit
records in one Triton-route kernel per pixel block, with a path-replay
custom VJP; `integration.attach_pallas_path` wires it into the progressive
renderer.  See bpt_tpu.integrator for the semantics it reproduces
draw-for-draw.
"""
