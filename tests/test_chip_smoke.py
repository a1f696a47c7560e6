"""chip_smoke.py's comparison helpers and workloads, its refusal to run
without a GPU, the compile-cache rule, and the CLI without matplotlib."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs
import psa
from psa_simulation_ode_rk_mvp_dispersion.utils import precision as prec

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("a,ref,want", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.1, 2.0], [1.0, 2.0], 0.1),
    ([1.0, -2.2], [1.0, -2.0], 0.1),
    ([1.0 + 1e-3j], [1.0], 1e-3),
])
def test_max_rel(a, ref, want):
    assert cs.max_rel(a, ref) == pytest.approx(want, rel=1e-9, abs=1e-15)


def test_rel_l2_takes_the_worst_lane():
    ref = np.ones((3, 4, 2))
    a = ref.copy()
    a[1] *= 1.0 + 1e-6
    a[2, 0, 0] += 0.5
    want = 0.5 / np.sqrt(8.0)
    assert cs.rel_l2(a, ref) == pytest.approx(want, rel=1e-12)
    assert cs.rel_l2(ref, ref) == 0.0


def test_linear_gain_inverts_db():
    np.testing.assert_allclose(cs.linear_gain([0.0, 10.0, 30.0]),
                               [1.0, 10.0, 1000.0], rtol=1e-15)


@pytest.mark.parametrize("err,ok", [
    (0.0, True), (1e-10, True), (1e-9, True), (2e-9, False),
    (float("nan"), False), (float("inf"), False),
])
def test_check_holds_errors_to_their_tolerance(err, ok):
    if ok:
        cs.check("x", err, 1e-9)
    else:
        with pytest.raises(AssertionError, match="x: error"):
            cs.check("x", err, 1e-9)


def test_refuses_to_run_on_a_cpu_only_process(capsys):
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_four_gpu_option_also_refuses_on_cpu():
    with pytest.raises(SystemExit) as exc:
        cs.main(["--gpus", "4"])
    assert exc.value.code not in (0, None)


def test_headline_configuration_is_the_reference_sweep():
    kw = cs.headline_kwargs(psa)
    cfg = kw["cfg"]
    assert (cfg.z_max, cfg.dz, cfg.save_every, cfg.precision) == (
        500.0, 0.2, 10, "x64")
    assert int(round(cfg.z_max / cfg.dz)) == 2500
    lam = cs.headline_wavelengths(cs.N_HEADLINE)
    assert lam.size == 10_000 and lam[0] == 1540e-9 and lam[-1] == 1650e-9


@pytest.mark.parametrize("name", ["comb", "gnlse", "gnlse_raman", "vgnlse",
                                  "lle"])
def test_family_workloads_keep_the_first_lanes(name):
    """``lanes=k`` returns the first k instances of the full batch (the
    CPU reference solves exactly the lanes it is compared with)."""
    if name == "comb":
        cfg, co, A0 = cs.comb_workload(psa, lanes=3)
        assert A0.shape == (3, cs.COMB["n_lines"])
        full = np.linspace(5e-3, 15e-3, cs.COMB["batch"])
        np.testing.assert_array_equal(co.gamma, full[:3])
    elif name.startswith("gnlse"):
        cfg, co, A0, nl = cs.gnlse_workload(psa, raman=name.endswith("raman"),
                                            lanes=3)
        assert A0.shape == (3, cs.GNLSE["n_samples"])
        assert (nl is not None) == name.endswith("raman")
        assert np.abs(A0[0]).max() < np.abs(A0[2]).max()
    elif name == "vgnlse":
        cfg, co, A0 = cs.vgnlse_workload(psa, lanes=3)
        assert A0.shape == (3, 2, cs.GNLSE["n_samples"])
    else:
        cfg, co, A0 = cs.lle_workload(psa, lanes=3)
        assert A0.shape == (3, cs.LLE["n_samples"])
        full = np.linspace(cs.LLE["det_lo"], cs.LLE["det_hi"], cs.LLE["batch"])
        np.testing.assert_array_equal(np.asarray(co.detuning), full[:3])
    assert cfg.precision == "x64" and np.all(np.isfinite(A0))


# ---------------------------------------------------------------------------
# Compile cache: JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache
# ---------------------------------------------------------------------------

@pytest.fixture
def _restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_defaults_to_the_checkout(monkeypatch, tmp_path,
                                                _restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)          # independent of the working dir
    want = str(ROOT / ".jax_cache")
    assert prec.compile_cache_dir() == want
    jax.config.update("jax_compilation_cache_dir", None)
    assert prec.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path,
                                               _restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "untouched")
    assert prec.compile_cache_dir() == str(tmp_path)
    assert prec.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == "untouched"


def test_compile_cache_is_ignored_by_git():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


# ---------------------------------------------------------------------------
# The CLI writes its artifacts without matplotlib
# ---------------------------------------------------------------------------

def test_cli_spectrum_without_matplotlib(monkeypatch, tmp_path, capsys):
    from psa_simulation_ode_rk_mvp_dispersion.__main__ import main

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    rc = main(["--no-show", "--quiet", "--save-dir", str(tmp_path),
               "spectrum", "--points", "4"])
    assert rc == 0
    with np.load(tmp_path / "gain_spectrum.npz") as d:
        assert d["gain"].shape == (4,) and np.all(np.isfinite(d["gain"]))
    assert not (tmp_path / "gain_spectrum.png").exists()
    assert "plot skipped (plot_gain_spectrum)" in capsys.readouterr().err


def test_plot_functions_skip_without_matplotlib(monkeypatch, capsys):
    from psa_simulation_ode_rk_mvp_dispersion import plotting

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plotting.plot_lines([0.0, 1.0], [1.0, 2.0], show=False) is None
    assert "matplotlib is not installed" in capsys.readouterr().err
