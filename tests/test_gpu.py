"""The fused Triton kernel compiled for the card (no interpreter) against
the wavefront integrator.  Skipped off the GPU; run on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig
from bpt_tpu.integrator.frame import trace_image
from bpt_tpu.kernels.megakernel import trace_image_pallas
from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

BN = jnp.asarray(blue_noise_table())
RV = jnp.asarray([0.3, 0.7], jnp.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("w,h", [(256, 256), (130, 1), (40, 72)])
def test_triton_megakernel_matches_wavefront(gpu, w, h):
    scene, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=4)
    ref = trace_image(scene, cam, cfg, w, h, 2.0, RV, BN)
    got = trace_image_pallas(scene, cam, cfg, w, h, 2.0, RV, BN)
    d = np.abs(np.asarray(ref.color) - np.asarray(got.color)).max(-1)
    assert np.mean(d > 1e-3) <= 0.01
    assert np.mean(np.asarray(ref.object_id) == np.asarray(got.object_id)) >= 0.995


@pytest.mark.gpu
def test_triton_vjp_matches_wavefront_grad(gpu):
    scene, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=3)

    def loss(lc, fused):
        s = scene._replace(quads=scene.quads._replace(color=scene.quads.color.at[5].set(lc)))
        if fused:
            r = trace_image_pallas(s, cam, cfg, 128, 128, 2.0, RV, BN, differentiable=True)
        else:
            r = trace_image(s, cam, cfg, 128, 128, 2.0, RV, BN)
        return jnp.mean(r.color * jnp.asarray([1.0, 2.0, 3.0]))

    lc = scene.quads.color[5]
    g_f = jax.grad(lambda x: loss(x, True))(lc)
    g_r = jax.grad(lambda x: loss(x, False))(lc)
    np.testing.assert_allclose(np.asarray(g_f), np.asarray(g_r), rtol=1e-3)
