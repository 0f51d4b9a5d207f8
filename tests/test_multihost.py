"""Multi-process (multi-"host") sharding equivalence.

Spawns N real processes, each with its own set of virtual CPU devices,
joined via `jax.distributed` — the CPU stand-in for several GPU hosts
(SURVEY.md §2.6 / BASELINE multi-host mandate).  Each process renders its
row shards of the Cornell frame through the UNCHANGED sharded entry point
and dumps them; the parent compares against the single-process 8-device
reference render bit-for-bit (absolute-pixel RNG keying makes sharded
layouts exact, not approximate).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

proc_id, n_procs, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

from bpt_tpu.parallel.multihost import initialize, make_multihost_mesh, host_row_range

initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=n_procs,
           process_id=proc_id)
assert jax.process_count() == n_procs
assert len(jax.devices()) == 8, len(jax.devices())

import jax.numpy as jnp
from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig
from bpt_tpu.parallel import sharded_render_frame
from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

mesh = make_multihost_mesh()
cfg = IntegratorConfig(bounces=2)
scene = cornell_scene()
camera = cornell_camera()
H, W = 32, 16
prev = jnp.zeros((H, W, 4), jnp.float32)
bn = jnp.asarray(blue_noise_table())
rv = jnp.asarray([0.3, 0.7], jnp.float32)

out = sharded_render_frame(scene, camera, cfg, prev, 2.0, False, rv, bn, mesh)
r0, r1 = host_row_range(H, mesh)
# each process materializes its addressable shards only
local = np.concatenate(
    [np.asarray(s.data) for s in sorted(out.addressable_shards, key=lambda s: s.index[0].start)],
    axis=0,
)
np.save(f"{outdir}/shard_{proc_id}.npy", local)
np.save(f"{outdir}/range_{proc_id}.npy", np.asarray([r0, r1]))
# 2-D (hosts, chips) mesh must also build
m2 = make_multihost_mesh(hierarchical=True)
assert m2.shape == {"hosts": n_procs, "chips": 8 // n_procs}
print("worker", proc_id, "ok")
"""


@pytest.mark.parametrize("n_procs", [2])
def test_multiprocess_mesh_matches_single_process(n_procs):
    per_proc = 8 // n_procs
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        with open(script, "w") as f:
            f.write(_WORKER)
        import socket

        with socket.socket() as s:  # grab a free port (avoids collisions)
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={per_proc}"
        )
        env["JAX_PLATFORMS"] = "cpu"
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs = [
            subprocess.Popen(
                [sys.executable, script, str(i), str(n_procs), port, td],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for i in range(n_procs)
        ]
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-3000:]

        # single-process 8-device reference
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        from bpt_tpu.core.rng import blue_noise_table
        from bpt_tpu.integrator import IntegratorConfig
        from bpt_tpu.parallel import make_mesh, sharded_render_frame
        from bpt_tpu.scenes.cornell import cornell_camera, cornell_scene

        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("test session lacks 8 virtual devices")
        cfg = IntegratorConfig(bounces=2)
        scene = cornell_scene()
        camera = cornell_camera()
        H, W = 32, 16
        prev = jnp.zeros((H, W, 4), jnp.float32)
        bn = jnp.asarray(blue_noise_table())
        rv = jnp.asarray([0.3, 0.7], jnp.float32)
        ref = np.asarray(
            sharded_render_frame(scene, camera, cfg, prev, 2.0, False, rv, bn,
                                 make_mesh(devs[:8]))
        )
        for i in range(n_procs):
            local = np.load(os.path.join(td, f"shard_{i}.npy"))
            r0, r1 = np.load(os.path.join(td, f"range_{i}.npy"))
            np.testing.assert_array_equal(local, ref[r0:r1])
