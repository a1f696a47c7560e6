"""In-kernel runtime checks (the sanitizer analog; SURVEY.md section 5).

The reference has nothing to race (single-threaded) and relies on eager
validation + a per-step NaN exception.  Under jit the framework's production
path uses *masked* failure flags (``ops/integrators.py``); this module adds
the opt-in debugging layer on top: functional checks via
``jax.experimental.checkify`` that travel through ``scan``/``vmap``/``jit``
and surface as structured errors on the host.

    from psa_simulation_ode_rk_mvp_dispersion.utils.debug import (
        checked_rhs, run_checked)

    rhs_dbg = checked_rhs(rhs_yaman, name="rhs_yaman")   # asserts finiteness
    err, out = run_checked(lambda y0: integrate_fixed_grid(
        rhs_dbg, y0, coeffs, z0=0., dz=dz, n_steps=n), y0)
    err.throw()   # raises with the failing check's message, if any
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked_rhs(rhs: Callable, *, name: str = "rhs") -> Callable:
    """Wrap an ``f(z, y, params)`` RHS with finiteness checks on its output.

    The check fires inside jit/scan/vmap (checkify threads the error state);
    use :func:`run_checked` (or ``checkify.checkify`` directly) to execute.
    """

    def wrapped(z, y, params):
        out = rhs(z, y, params)
        if jnp.iscomplexobj(out):
            fin = jnp.all(jnp.isfinite(out.real)) & jnp.all(jnp.isfinite(out.imag))
        else:
            fin = jnp.all(jnp.isfinite(out))
        checkify.check(fin, f"{name}: non-finite derivative produced")
        return out

    return wrapped


def run_checked(fn: Callable, *args, **kwargs):
    """Execute ``fn`` under checkify (float + user checks) and return
    ``(error, result)``; call ``error.throw()`` to raise on failure.

    Adds automatic NaN/div-by-zero instrumentation to every float op --
    slow; debugging only.
    """
    checked = checkify.checkify(
        fn, errors=checkify.user_checks | checkify.float_checks
    )
    return checked(*args, **kwargs)
