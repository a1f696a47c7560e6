"""Multi-process mesh: the CPU stand-in for a multi-host cluster.

Spawns a 2-process jax.distributed cluster (4 virtual CPU devices each = 8
global), builds the (dcn, batch) hybrid mesh, and runs the public sweep over
it -- SURVEY.md section 5 'distributed communication backend'.  Exercises
initialize_distributed / multihost_mesh / put_global / fetch_global.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster_sweep():
    nproc = 2
    port = _free_port()
    env = dict(os.environ)
    # clean slate: CPU backend, 4 virtual devices each
    env.pop("PYTHONSTARTUP", None)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"

    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multihost_worker.py"),
             str(i), str(nproc), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK p{i}/{nproc}" in out, out[-2000:]


def test_initialize_distributed_noop_single_process():
    """Without a coordinator configured it must be a safe no-op."""
    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        initialize_distributed,
    )

    assert initialize_distributed() is False


def test_multihost_mesh_single_process_fallback():
    import jax

    from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

    m = pm.multihost_mesh()
    # single process: plain 1-D local mesh over the 8 virtual devices
    assert m is not None and tuple(m.axis_names) == ("batch",)
    assert int(np.prod(list(m.shape.values()))) == len(jax.devices())


def test_put_and_fetch_global_single_process_roundtrip():
    from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

    m = pm.default_mesh()
    sh = pm.batch_sharding(m)
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    arr = pm.put_global(x, sh)
    assert arr.sharding.is_fully_addressable
    np.testing.assert_array_equal(pm.fetch_global(arr), x)


def test_batch_sharding_honors_axis_name():
    """Round-2 review fix: the axis_name parameter was silently ignored
    (the sharding always folded over every mesh axis)."""
    import jax
    from jax.sharding import PartitionSpec

    from psa_simulation_ode_rk_mvp_dispersion.parallel.mesh import (
        batch_sharding,
    )

    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    mesh = jax.sharding.Mesh(devs, ("dcn", "batch"))
    assert batch_sharding(mesh).spec == PartitionSpec(("dcn", "batch"))
    assert batch_sharding(mesh, axis_name="batch").spec == PartitionSpec("batch")
    assert batch_sharding(mesh, axis_name=("dcn",)).spec == PartitionSpec("dcn")
    with pytest.raises(ValueError, match="not in mesh axes"):
        batch_sharding(mesh, axis_name="nope")
