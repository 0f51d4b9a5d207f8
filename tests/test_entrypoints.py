"""Entry-point plumbing: the compile-cache helper, chip_smoke.py's refusal
off the GPU, the multi-device dry run, and the float32 transforms'
precision."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from bpt_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restore_cache_dir(old):
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_repo_dir_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        _restore_cache_dir(old)


def test_compile_cache_defers_to_env_and_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        _restore_cache_dir(old)


def test_chip_smoke_refuses_cpu_platform():
    """On a CPU platform the smoke script exits non-zero with a message and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert "phase 0" in p.stderr
    assert '"ok"' not in p.stdout


def test_dryrun_multichip_matches_one_device(capsys):
    """The dry run that ``chip_smoke.py --four-cards`` runs at 1024 on four
    cards, here on four virtual CPU devices: the sharded render, its
    AD-psum'd albedo-map gradient and the fused kernel's row seam (forward
    and path-replay VJP) each equal one device."""
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(line.endswith(" ok") for line in lines), lines


def test_transforms_match_float64_reference():
    """transform_point / transform_dir / normal_to_world in float32 equal a
    float64 numpy reference to 1e-6 relative — no reduced-precision
    contraction on any backend."""
    from bpt_tpu.core.vecmath import normal_to_world, transform_dir, transform_point

    rng = np.random.default_rng(0)
    m = rng.normal(size=(5, 1, 4, 4)).astype(np.float32)
    v = rng.normal(size=(5, 64, 3)).astype(np.float32) * 50.0
    m64, v64 = m.astype(np.float64), v.astype(np.float64)
    ref_p = np.einsum("...ij,...j->...i", m64[..., :3, :3], v64) + m64[..., :3, 3]
    ref_d = np.einsum("...ij,...j->...i", m64[..., :3, :3], v64)
    ref_n = np.einsum("...ji,...j->...i", m64[..., :3, :3], v64)
    ref_n /= np.linalg.norm(ref_n, axis=-1, keepdims=True)
    got_p = np.asarray(transform_point(jnp.asarray(m), jnp.asarray(v)))
    got_d = np.asarray(transform_dir(jnp.asarray(m), jnp.asarray(v)))
    got_n = np.asarray(normal_to_world(jnp.asarray(m), jnp.asarray(v)))
    scale = np.abs(m64[..., :3, :]).sum(-1).max() * np.abs(v64).max()
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(got_n, ref_n, rtol=1e-6, atol=1e-6)
