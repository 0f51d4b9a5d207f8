"""Auxiliary subsystems: checkpoint/resume, postprocess, env CDF, HDR codec."""

import os

import jax.numpy as jnp
import numpy as np

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.env import build_env_cdf, get_hdr_color, sample_env_cdf, sun_direction_from_hdr
from bpt_tpu.integrator import IntegratorConfig
from bpt_tpu.io.hdr import read_hdr, write_hdr
from bpt_tpu.postprocess import denoise, reinhard, screen_output
from bpt_tpu.renderer import ProgressiveRenderer, init_state, step_state
from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu.utils.checkpoint import load_render_state, save_render_state


def test_checkpoint_roundtrip_resumes_progressive_render(tmp_path):
    scene, camera = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=2)
    bn = jnp.asarray(blue_noise_table())
    rv = jnp.asarray([0.3, 0.7], jnp.float32)

    state = init_state(32, 32)
    for _ in range(3):
        state = step_state(scene, camera, cfg, state, False, rv, bn)
    path = save_render_state(str(tmp_path / "ckpt"), state)
    restored = load_render_state(path)
    np.testing.assert_array_equal(np.asarray(state.accum), np.asarray(restored.accum))
    assert float(restored.sample_counter) == 3.0

    # resuming from the checkpoint == never stopping
    cont_a = step_state(scene, camera, cfg, state, False, rv, bn)
    cont_b = step_state(scene, camera, cfg, restored, False, rv, bn)
    np.testing.assert_array_equal(np.asarray(cont_a.accum), np.asarray(cont_b.accum))


def test_denoise_blurs_soft_keeps_sharp():
    h = w = 16
    accum = np.zeros((h, w, 4), np.float32)
    accum[..., :3] = 1.0
    accum[8, 8, :3] = 10.0  # bright noisy outlier, soft (alpha 0)
    out_soft = np.asarray(denoise(jnp.asarray(accum)))
    assert out_soft[8, 8, 0] < 10.0, "soft outlier must be blurred down"
    accum[8, 8, 3] = 1.01  # flagged sticky-sharp: neighbors skip it...
    out_sharp = np.asarray(denoise(jnp.asarray(accum)))
    assert out_sharp[8, 7, 0] < out_soft[8, 7, 0], "neighbors must exclude sharp pixel"


def test_screen_output_range_and_bypass():
    accum = np.abs(np.random.default_rng(0).normal(1.0, 0.3, (16, 16, 4))).astype(np.float32)
    accum[..., 3] = 0.0
    out = np.asarray(screen_output(jnp.asarray(accum), 1.0 / 8.0))
    assert out.min() >= 0.0 and out.max() <= 1.0
    # fully converged: all pixels bypass the blur
    out_conv = np.asarray(screen_output(jnp.asarray(accum), 0.0001))
    expect = np.asarray(reinhard(jnp.asarray(accum[..., :3]) * 0.0001, 1.0)) ** 0.4545
    np.testing.assert_allclose(out_conv, np.clip(expect, 0, 1), atol=1e-5)


def test_hdr_roundtrip_and_sun_estimate(tmp_path):
    img = np.abs(np.random.default_rng(1).normal(0.5, 0.3, (32, 64, 3))).astype(np.float32)
    img[20, 50] = [80.0, 75.0, 60.0]  # the "sun"
    path = str(tmp_path / "test.hdr")
    write_hdr(path, img)
    back = read_hdr(path)
    assert back.shape == img.shape
    # RGBE shares one exponent across RGB: small channels in a texel with a
    # large peak quantize at peak/64 — allow that absolute error
    np.testing.assert_allclose(back, img, rtol=0.02, atol=0.02)

    sun = sun_direction_from_hdr(img)
    np.testing.assert_allclose(np.linalg.norm(sun), 1.0, atol=1e-5)
    # looking up the estimated direction must land near the bright texel
    val = np.asarray(get_hdr_color(jnp.asarray(img), jnp.asarray(sun), 1.0))
    assert val.sum() > 100.0, f"sun lookup got {val}"


def test_env_cdf_importance_sampling_targets_bright_region():
    img = np.full((64, 128, 3), 0.01, np.float32)
    img[10:14, 30:34] = 50.0  # bright patch
    cdf = build_env_cdf(img)
    u = np.random.default_rng(2).random((256, 2)).astype(np.float32)
    dirs, pdf = sample_env_cdf(cdf, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
    # most samples should look up into the bright patch
    vals = np.asarray(get_hdr_color(jnp.asarray(img), dirs, 1.0))
    assert (vals.sum(-1) > 1.0).mean() > 0.8
    assert (np.asarray(pdf) > 0).all()


def test_batched_render_equals_per_sample_stepping():
    """render(spp, batch=k) fuses still-camera samples into one lax.scan
    dispatch; the rand_vec2 stream and counter FSM are identical to
    sample-at-a-time stepping, so the accumulation is bit-equal."""
    import numpy as np

    from bpt_tpu.integrator import IntegratorConfig
    from bpt_tpu.renderer import ProgressiveRenderer
    from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

    scene, cam = cornell_scene(), cornell_camera()
    cfg = IntegratorConfig(bounces=2)
    r1 = ProgressiveRenderer(scene, cfg, 24, 24, seed=7)
    r2 = ProgressiveRenderer(scene, cfg, 24, 24, seed=7)
    img1 = np.asarray(r1.render(cam, spp=7, batch=1))
    img2 = np.asarray(r2.render(cam, spp=7, batch=3))
    assert float(r1.state.sample_counter) == float(r2.state.sample_counter) == 7.0
    np.testing.assert_array_equal(np.asarray(r1.state.accum), np.asarray(r2.state.accum))
    np.testing.assert_array_equal(img1, img2)
