"""Short import alias: ``import psa`` -> the full framework package."""
import sys

import psa_simulation_ode_rk_mvp_dispersion as _pkg

sys.modules[__name__] = _pkg
