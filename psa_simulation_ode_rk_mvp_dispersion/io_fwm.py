"""Result persistence: compressed NPZ + JSON metadata + CSV summaries.

Capability parity with reference ``io_fwm.py`` (``save_result_npz``/
``load_result_npz`` :73-170, ``save_metadata_json``/``load_metadata_json``
:177-213, ``save_summary_csv`` :219-294, ``save_run_bundle`` :297-328) --
with the same on-disk NPZ layout (keys ``z``, ``A``, ``metadata_json``) so
archives written by the reference load here unchanged, and vice versa.

Framework extensions:

- :func:`make_run_metadata` records structured provenance with every result:
  UTC timestamp, package/jax versions, backend + device kind, precision tier,
  and the numerical config -- the observability upgrade over the reference's
  bare timestamp (``io_fwm.py:53-66``).
- Batched results: ``save_sweep_npz``/``load_sweep_npz`` persist a whole
  sweep (x grid, gain, dbeta, ok mask) as one artifact.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime as _dt
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

WAVE_LABELS: Tuple[str, str, str, str] = ("pump 1", "pump 2", "signal", "idler")


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _as_path(path, suffix: Optional[str] = None) -> Path:
    p = Path(path).expanduser()
    if suffix is not None and p.suffix.lower() != suffix:
        p = p.with_suffix(suffix)
    return p


def _check_writable(p: Path, overwrite: bool) -> None:
    if p.exists() and not overwrite:
        raise FileExistsError(f"File already exists: {p}")
    p.parent.mkdir(parents=True, exist_ok=True)


def _json_default(obj: Any) -> Any:
    """Serializer for config objects, numpy values, enums, paths."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "value") and hasattr(obj, "name"):  # Enum
        return obj.value
    # jax arrays and anything array-like
    try:
        return np.asarray(obj).tolist()
    except Exception as e:  # noqa: BLE001
        raise TypeError(
            f"Object of type {type(obj).__name__} is not JSON serializable"
        ) from e


def _utc_now() -> str:
    return _dt.datetime.now(_dt.timezone.utc).replace(microsecond=0).isoformat()


def make_run_metadata(
    extra: Optional[Dict[str, Any]] = None,
    *,
    config: Any = None,
    include_device_info: bool = True,
) -> Dict[str, Any]:
    """Structured provenance metadata for a result artifact."""
    md: Dict[str, Any] = {"timestamp_utc": _utc_now()}
    try:
        from . import __version__

        md["psa_version"] = __version__
    except Exception:  # noqa: BLE001
        pass
    if include_device_info:
        try:
            import jax

            md["jax_version"] = jax.__version__
            md["backend"] = jax.default_backend()
            devs = jax.devices()
            md["n_devices"] = len(devs)
            md["device_kind"] = devs[0].device_kind if devs else None
        except Exception:  # noqa: BLE001
            pass
    if config is not None:
        md["config"] = json.loads(json.dumps(config, default=_json_default))
    if extra:
        md.update(extra)
    return md


def _finalize_metadata(metadata: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    md = dict(metadata) if metadata else {}
    md.setdefault("timestamp_utc", _utc_now())
    return md


# ---------------------------------------------------------------------------
# NPZ trajectories (reference-compatible layout)
# ---------------------------------------------------------------------------

def save_result_npz(
    path,
    z: np.ndarray,
    A: np.ndarray,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    overwrite: bool = False,
) -> Path:
    """Save (z, A) to compressed NPZ with metadata embedded as a JSON string
    (keys ``z``/``A``/``metadata_json`` -- reference-compatible)."""
    p = _as_path(path, ".npz")
    _check_writable(p, overwrite)

    z = np.asarray(z, dtype=float)
    A = np.asarray(A)
    if z.ndim != 1:
        raise ValueError("z must be a 1D array")
    if A.ndim != 2:
        raise ValueError("A must be a 2D array")
    if A.shape[0] != z.shape[0]:
        raise ValueError("A.shape[0] must match z.shape[0]")

    md_json = json.dumps(_finalize_metadata(metadata), ensure_ascii=False,
                         default=_json_default)
    np.savez_compressed(p, z=z, A=A, metadata_json=np.array(md_json))
    return p


def load_result_npz(path) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Load (z, A, metadata) from NPZ (reference or this framework)."""
    p = _as_path(path)
    if not p.exists():
        raise FileNotFoundError(f"No such file: {p}")
    with np.load(p, allow_pickle=False) as data:
        if "z" not in data or "A" not in data:
            raise ValueError("NPZ file does not contain required keys: 'z' and 'A'")
        z = np.array(data["z"], dtype=float)
        A = np.array(data["A"])
        metadata: Dict[str, Any] = {}
        if "metadata_json" in data:
            try:
                metadata = json.loads(str(data["metadata_json"])) or {}
            except Exception:  # noqa: BLE001
                metadata = {}
    return z, A, metadata


# ---------------------------------------------------------------------------
# JSON metadata
# ---------------------------------------------------------------------------

def save_metadata_json(
    path, metadata: Dict[str, Any], *, overwrite: bool = False
) -> Path:
    p = _as_path(path, ".json")
    _check_writable(p, overwrite)
    with p.open("w", encoding="utf-8") as f:
        json.dump(_finalize_metadata(metadata), f, ensure_ascii=False, indent=2,
                  default=_json_default)
    return p


def load_metadata_json(path) -> Dict[str, Any]:
    p = _as_path(path)
    if not p.exists():
        raise FileNotFoundError(f"No such file: {p}")
    with p.open("r", encoding="utf-8") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# CSV summary (powers + phases per stored z)
# ---------------------------------------------------------------------------

def save_summary_csv(
    path,
    z: np.ndarray,
    A: np.ndarray,
    *,
    wave_labels: Tuple[str, ...] = WAVE_LABELS,
    overwrite: bool = False,
) -> Path:
    """Human-readable CSV: z, P_<wave>..., phi_<wave>... per stored sample.

    Generalized over the reference (``io_fwm.py:219-294``): accepts any
    (N, M) state, not only M=4."""
    p = _as_path(path, ".csv")
    _check_writable(p, overwrite)

    z = np.asarray(z, dtype=float)
    A = np.asarray(A)
    if z.ndim != 1:
        raise ValueError("z must be a 1D array")
    if A.ndim != 2:
        raise ValueError("A must be a 2D array")
    if A.shape[0] != z.shape[0]:
        raise ValueError("A.shape[0] must match z.shape[0]")
    if len(wave_labels) != A.shape[1]:
        raise ValueError(f"wave_labels must have length {A.shape[1]}")

    P = np.abs(A) ** 2
    phi = np.angle(A)
    headers = (
        ["z"]
        + [f"P_{lbl}" for lbl in wave_labels]
        + [f"phi_{lbl}" for lbl in wave_labels]
    )
    with p.open("w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(headers)
        for i in range(z.shape[0]):
            w.writerow(
                [float(z[i])]
                + [float(v) for v in P[i]]
                + [float(v) for v in phi[i]]
            )
    return p


# ---------------------------------------------------------------------------
# Bundles
# ---------------------------------------------------------------------------

def save_run_bundle(
    output_dir,
    run_name: str,
    z: np.ndarray,
    A: np.ndarray,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    overwrite: bool = False,
) -> Dict[str, Path]:
    """Save <name>.npz + <name>.csv + <name>.json in one call."""
    out = Path(output_dir).expanduser()
    out.mkdir(parents=True, exist_ok=True)
    md = _finalize_metadata(metadata)
    return {
        "npz": save_result_npz(out / f"{run_name}.npz", z, A, metadata=md,
                               overwrite=overwrite),
        "csv": save_summary_csv(out / f"{run_name}.csv", z, A, overwrite=overwrite),
        "json": save_metadata_json(out / f"{run_name}.json", md, overwrite=overwrite),
    }


# ---------------------------------------------------------------------------
# Sweep artifacts (framework extension)
# ---------------------------------------------------------------------------

def save_sweep_npz(
    path,
    sweep,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    overwrite: bool = False,
) -> Path:
    """Persist a ``SweepResult`` (x, gain, dbeta, ok + metadata)."""
    p = _as_path(path, ".npz")
    _check_writable(p, overwrite)
    md = _finalize_metadata(metadata)
    md.setdefault("gain_unit", sweep.gain_unit)
    md.setdefault("elapsed_s", sweep.elapsed_s)
    md.setdefault("points_per_s", sweep.points_per_s)
    arrays = dict(
        x=np.asarray(sweep.x, dtype=float),
        gain=np.asarray(sweep.gain, dtype=float),
        ok=np.asarray(sweep.ok, dtype=np.int8),
        metadata_json=np.array(
            json.dumps(md, ensure_ascii=False, default=_json_default)
        ),
    )
    if sweep.dbeta is not None:
        arrays["dbeta"] = np.asarray(sweep.dbeta, dtype=float)
    np.savez_compressed(p, **arrays)
    return p


def load_sweep_npz(path):
    """Load a sweep artifact -> (x, gain, dbeta|None, ok, metadata)."""
    p = _as_path(path)
    if not p.exists():
        raise FileNotFoundError(f"No such file: {p}")
    with np.load(p, allow_pickle=False) as data:
        x = np.array(data["x"])
        gain = np.array(data["gain"])
        dbeta = np.array(data["dbeta"]) if "dbeta" in data else None
        ok = np.array(data["ok"]).astype(bool)
        metadata: Dict[str, Any] = {}
        if "metadata_json" in data:
            try:
                metadata = json.loads(str(data["metadata_json"])) or {}
            except Exception:  # noqa: BLE001
                metadata = {}
    return x, gain, dbeta, ok, metadata


def save_gain_map_npz(
    path,
    gain_map,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    overwrite: bool = False,
) -> Path:
    """Persist a 2-D ``GainMapResult`` (x, pump_powers, gain, ok + metadata)
    -- artifact parity with 1-D sweeps (``save_sweep_npz``)."""
    p = _as_path(path, ".npz")
    _check_writable(p, overwrite)
    md = _finalize_metadata(metadata)
    md.setdefault("gain_unit", gain_map.gain_unit)
    md.setdefault("elapsed_s", gain_map.elapsed_s)
    md.setdefault("points_per_s", gain_map.points_per_s)
    np.savez_compressed(
        p,
        x=np.asarray(gain_map.x, dtype=float),
        pump_powers=np.asarray(gain_map.pump_powers, dtype=float),
        gain=np.asarray(gain_map.gain, dtype=float),
        ok=np.asarray(gain_map.ok, dtype=np.int8),
        metadata_json=np.array(
            json.dumps(md, ensure_ascii=False, default=_json_default)
        ),
    )
    return p


def load_gain_map_npz(path):
    """Load a gain-map artifact -> ``(GainMapResult, metadata)``."""
    from .parallel.sweep import GainMapResult

    p = _as_path(path)
    if not p.exists():
        raise FileNotFoundError(f"No such file: {p}")
    with np.load(p, allow_pickle=False) as data:
        metadata: Dict[str, Any] = {}
        if "metadata_json" in data:
            try:
                metadata = json.loads(str(data["metadata_json"])) or {}
            except Exception:  # noqa: BLE001
                metadata = {}
        gm = GainMapResult(
            x=np.array(data["x"]),
            pump_powers=np.array(data["pump_powers"]),
            gain=np.array(data["gain"]),
            ok=np.array(data["ok"]).astype(bool),
            gain_unit=str(metadata.get("gain_unit", "db")),
            elapsed_s=float(metadata.get("elapsed_s", 0.0)),
            points_per_s=float(metadata.get("points_per_s", 0.0)),
        )
    return gm, metadata
