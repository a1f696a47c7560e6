"""Config validation tests (parity with reference tests.py:26-88 TestConfig)."""

import pytest

import psa
from psa_simulation_ode_rk_mvp_dispersion.config import (
    SimulationConfig,
    custom_simulation_config,
    default_simulation_config,
    validate_config,
)


def test_default_config_is_valid():
    cfg = default_simulation_config()
    validate_config(cfg)
    assert cfg.z_max == 0.5
    assert cfg.dz == 1e-3
    assert cfg.integrator == "rk4"
    assert cfg.save_every == 10
    assert cfg.check_nan is True


def test_custom_config_roundtrip():
    cfg = custom_simulation_config(z_max=2.0, dz=0.01, save_every=5)
    validate_config(cfg)
    assert cfg.z_max == 2.0
    assert cfg.dz == 0.01
    assert cfg.save_every == 5


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(z_max=-1.0, dz=1e-3),
        dict(z_max=0.0, dz=1e-3),
        dict(z_max=1.0, dz=-1e-3),
        dict(z_max=1.0, dz=0.0),
        dict(z_max=1.0, dz=2.0),              # dz > z_max
        dict(z_max=1.0, dz=1e-3, integrator="euler"),
        dict(z_max=1.0, dz=1e-3, save_every=0),
        dict(z_max=1.0, dz=1e-3, save_every=-3),
        dict(z_max=1.0, dz=1e-3, precision="float16"),
    ],
)
def test_invalid_configs_rejected(kwargs):
    cfg = custom_simulation_config(**kwargs)
    with pytest.raises(ValueError):
        validate_config(cfg)


def test_rk45_accepted():
    cfg = custom_simulation_config(z_max=1.0, dz=1e-3, integrator="rk45")
    validate_config(cfg)


def test_rk45_invalid_tolerances_rejected():
    cfg = custom_simulation_config(z_max=1.0, dz=1e-3, integrator="rk45", rtol=0.0)
    with pytest.raises(ValueError):
        validate_config(cfg)


def test_constants():
    assert psa.constants.c == 299_792_458.0
