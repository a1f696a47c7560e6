"""Device-mesh helpers for sharded batch solves.

The reference has no parallelism at all (serial Python loops,
``scan_mismtach.py:126/:357/:694``); the scaling model here is:

    batch of independent ODE instances
        -> vmap (one XLA program, one chip)
        -> shard the batch axis over a 1-D device Mesh (pjit/NamedSharding)

Every instance is independent, so the sharded program is embarrassingly SPMD:
no collectives in the hot loop; the only cross-device traffic is the final
gather of per-instance reductions (gain scalars) over the device links.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

BATCH_AXIS = "batch"


def default_mesh(
    n_devices: Optional[int] = None, *, axis_name: str = BATCH_AXIS
) -> Optional[Mesh]:
    """A 1-D mesh over (up to) all local devices; None on a single device
    (plain vmap is already optimal there)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else min(n_devices, len(devs))
    if n <= 1:
        return None
    return Mesh(np.asarray(devs[:n]), (axis_name,))


def batch_sharding(mesh: Mesh, *, axis_name=None) -> NamedSharding:
    """Sharding that splits the leading (batch) axis over the mesh.

    ``axis_name=None`` (default) folds the batch over EVERY mesh axis: the
    plain split on a 1-D mesh, both axes on a multihost (dcn, batch) mesh.
    Pass an axis name (or tuple of names) to split over just those axes and
    leave the others free (e.g. a model-parallel wave axis)."""
    if axis_name is None:
        axes = tuple(mesh.axis_names)
    else:
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(
                f"axis_name {missing} not in mesh axes {tuple(mesh.axis_names)}"
            )
    spec = PartitionSpec(axes if len(axes) > 1 else axes[0])
    return NamedSharding(mesh, spec)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    auto_detect: bool = True,
    **kwargs,
) -> bool:
    """Guarded ``jax.distributed.initialize``: returns True if a multi-process
    runtime is (now) active, False for the single-process case.

    Safe to call unconditionally: no-ops when already initialized.  With no
    explicit coordinator (arguments or JAX_COORDINATOR_ADDRESS /
    COORDINATOR_ADDRESS env vars) and ``auto_detect=True``, a bare
    ``jax.distributed.initialize()`` is attempted so cloud cluster
    auto-detection (GKE, Slurm, cloud metadata) still engages; its failure
    on a plain single-host machine is caught and reported as False.  On CPU
    clusters set ``JAX_CPU_COLLECTIVES_IMPLEMENTATION=gloo`` (or pass
    ``cluster_detection_method``) before the first backend query.
    """
    import jax

    # NOTE: don't touch jax.process_count()/jax.devices() before initialize --
    # any backend query locks in the single-process runtime.
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    import os

    have_cfg = (
        coordinator_address is not None
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if not have_cfg:
        if not auto_detect:
            return False
        try:
            # engages jax's own cluster auto-detection (GKE / Slurm /
            # cloud); raises on a plain single-host machine
            jax.distributed.initialize(**kwargs)
        except Exception:  # noqa: BLE001 -- no cluster detected
            return False
        return jax.process_count() > 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError:
        # already initialized (e.g. by the launcher)
        pass
    return jax.process_count() > 1


def multihost_mesh(
    *,
    axis_name: str = BATCH_AXIS,
    dcn_axis_name: str = "dcn",
) -> Optional[Mesh]:
    """Mesh spanning every process: a (process, local-device) 2-D mesh with
    the slow cross-host links isolated on ``dcn_axis_name``.

    The sweep workload is embarrassingly parallel, so both axes carry the
    batch; keeping them separate lets any collective-bearing model (e.g. the
    comb's wave axis) stay inside a host while the batch rides DCN.  Returns
    a 1-D local mesh (or None) when only one process is present.
    """
    import jax

    if jax.process_count() <= 1:
        return default_mesh(axis_name=axis_name)
    # Group devices by owning process: the process boundary IS the DCN
    # boundary on multi-host pods (and on the CPU cluster stand-in, where
    # devices carry no slice_index for mesh_utils.create_hybrid_device_mesh).
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    grid = np.asarray(devs).reshape(jax.process_count(), -1)
    return Mesh(grid, (dcn_axis_name, axis_name))


def put_global(arr: np.ndarray, sharding: NamedSharding):
    """Place a host array onto a (possibly multi-process) sharding.

    Single-process meshes use a plain ``device_put``.  When the mesh spans
    processes (some devices not addressable here), every process must hold
    the same global host array; each contributes its addressable shards via
    ``jax.make_array_from_callback``.
    """
    import jax
    import jax.numpy as jnp

    arr = np.asarray(arr)
    if sharding.is_fully_addressable:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def put_global_tree(tree, sharding: NamedSharding):
    """``put_global`` over every array leaf of a pytree."""
    import jax

    return jax.tree_util.tree_map(lambda x: put_global(x, sharding), tree)


def fetch_global(x) -> np.ndarray:
    """Fetch a device array to host numpy, all-gathering across processes
    when the array is not fully addressable locally."""
    import jax

    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def pad_batch(arr: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis up to a multiple (edge-replicating the last row so
    padded instances stay numerically benign); returns (padded, original_n)."""
    n = arr.shape[0]
    if multiple <= 1 or n % multiple == 0:
        return arr, n
    pad = multiple - (n % multiple)
    pad_rows = np.repeat(arr[-1:], pad, axis=0)
    return np.concatenate([arr, pad_rows], axis=0), n
