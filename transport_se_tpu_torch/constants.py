"""Physical constants.

The port's own copy of `transport_se_tpu/constants.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

Values match the reference model so that verification norms are comparable
(reference: src/share/physical_constants.F90:16-35).  Note the reference uses
rearth = 6.376e6 m (not the more common 6.371e6) and the DCMIP test formulas
inherit it via `use physical_constants, only: a=>rearth`
(src/share/dcmip_123_mod.F90:56).
"""

DD_PI = 3.141592653589793238462643383279

REARTH = 6.376e6          # m, radius of earth used by the SE operators
RREARTH = 1.0 / REARTH
G = 9.80616               # m s^-2
RGAS = 287.04             # J kg^-1 K^-1  (dry air)
CP = 1005.0
P0 = 100000.0             # Pa, reference surface pressure
KAPPA = RGAS / CP
OMEGA = 7.292e-5          # rad/s (unused by the transport-only path)

# DCMIP constant-temperature atmosphere (src/share/dcmip_wrapper_mod.F90:28-29)
T0 = 300.0                # K
SCALE_HEIGHT = RGAS * T0 / G   # H = Rd*T0/g  (m)
