"""Worker for the multi-process (multi-host analog) mesh test.

Launched by ``test_multihost.py`` as N separate processes, each with its own
4-virtual-CPU-device backend, forming a jax.distributed cluster: the CPU
stand-in for a multi-host cluster (DCN axis = process boundary).  Each worker
runs the SAME global sweep over a process-spanning mesh and checks the
all-gathered result against its local unsharded solve.
"""

import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    import jax

    import numpy as np

    from psa_simulation_ode_rk_mvp_dispersion.parallel import mesh as pm

    ok = pm.initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert ok, "initialize_distributed returned False in a cluster run"
    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * len(jax.local_devices())

    import psa
    from psa_simulation_ode_rk_mvp_dispersion.parallel import sweep as sw

    mesh = pm.multihost_mesh()
    assert mesh is not None and "dcn" in mesh.axis_names, mesh

    disp = psa.dispersion_params_from_D_S(
        lambda_ref_m=1552e-9, D=0.1, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km",
    )
    cfg = psa.custom_simulation_config(z_max=10.0, dz=0.2, save_every=5)
    lam3 = np.linspace(1549e-9, 1561e-9, 13)  # deliberately not /8
    kwargs = dict(
        cfg=cfg, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9, lambda_signal_m=lam3,
        gamma=0.0115, alpha=1.15e-4, p_in=[0.5, 0.5, 1e-7, 1e-7],
        dispersion=disp, length_unit="m",
    )
    sharded = sw.gain_spectrum(mesh=mesh, **kwargs)
    plain = sw.gain_spectrum(**kwargs)
    assert np.all(sharded.ok)
    np.testing.assert_allclose(sharded.gain, plain.gain, rtol=1e-10)

    # rk45 over the multihost mesh too
    import dataclasses

    kwargs45 = dict(kwargs, cfg=dataclasses.replace(cfg, integrator="rk45"))
    s45 = sw.gain_spectrum(mesh=mesh, **kwargs45)
    p45 = sw.gain_spectrum(**kwargs45)
    np.testing.assert_allclose(s45.gain, p45.gain, rtol=1e-10)

    print(f"MULTIHOST_OK p{pid}/{nproc} mesh={dict(mesh.shape)}", flush=True)


if __name__ == "__main__":
    main()
