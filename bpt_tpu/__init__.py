"""bpt_tpu — a differentiable path-tracing framework in JAX.

A from-scratch JAX/Pallas re-design of the capabilities of
Kuldaen/Babylon.js-PathTracing-Renderer (a WebGL2 fragment-shader progressive
path tracer hosted by Babylon.js).  This is NOT a port: the reference's GLSL
megakernels become fused, vectorized wavefront integrators (jnp on the XLA
compute path, Pallas kernels for the hot loops), its per-pixel fragment SPMD
becomes tile-sharded SPMD over a `jax.sharding.Mesh`, and its host JS becomes
a functional renderer with explicit, checkpointable state.

Subpackage map (reference analog in parentheses):
  core        math / RNG / filters            (PathTracingCommon.js includes)
  geometry    analytic intersectors           (pathtracing_unit_*_intersect)
  integrator  bounce-loop radiance estimators (CalculateRadiance megakernels)
  scenes      scene data + SetupScene analogs (per-demo *_FragmentShader.js)
  accel       BVH build + traversal           (BVH_Fast_Builder.js + GPU walk)
  io          glTF 2.0 / Radiance .hdr / PNG  (babylon.glTFFileLoader, loadHDR)
  kernels     fused Pallas (Triton) megakernel (the compiled fragment shader)
  parallel    mesh sharding, halo exchange    (N/A in reference; new)
  diff        gradient estimators             (N/A in reference; new)
  utils       config, profiling               (dat.GUI / stats.js analogs)
"""

from bpt_tpu import core, geometry
from bpt_tpu.camera import Camera, generate_rays
from bpt_tpu.renderer import ProgressiveRenderer, RenderState

__version__ = "0.1.0"
