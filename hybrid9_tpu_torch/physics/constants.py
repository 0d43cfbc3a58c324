"""Physical constants for the HYBRID9 land-surface model (PyTorch port).

A copy of ``hybrid9_tpu/physics/constants.py`` (reference: SOURCE/
SHARED.f90:308-367), so the port never imports the JAX package.  Values
are plain Python floats; torch casts them to the working dtype where they
meet a tensor, so the same physics runs in float32 (production) or
float64 (validation).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Basic numerics (SHARED.f90:308-315).
# ---------------------------------------------------------------------------
ZERO = 0.0
ONE = 1.0
PI = 3.14159  # (ratio) — reference value, deliberately low precision.

# ---------------------------------------------------------------------------
# Water / air properties (SHARED.f90:319-359).
# ---------------------------------------------------------------------------
RHOW = 1000.0                       # Density of liquid water      (kg/m^3)
MAIR = 28.9655                      # Molar mass of dry air        (g/mol)
MWAT = 18.015                       # Molar mass of water          (g/mol)
GASC = 8.314510                     # Universal gas constant       (J/K/mol)
RGAS = 1000.0 * GASC / MAIR         # Specific gas constant, air   (J/K/kg)
STBO = 5.67e-8                      # Stefan-Boltzmann constant    (W/m^2/K^4)
MRAT = MWAT / MAIR                  # Molar mass ratio water/air   (-)
BYMRAT = 1.0 / MRAT                 # Inverse molar mass ratio     (-)
DELTX = BYMRAT - 1.0                # Humidity coeff. in Tv        (-)
LHE = 2.5008e6                      # Latent heat of evap at 0 C   (J/kg)
RVAP = 1000.0 * GASC / MWAT         # Specific gas constant, vapour(J/K/kg)
TF = 273.16                         # Freezing point of water      (K)
LFUS = 3.337e5                      # Latent heat of fusion        (J/kg)

# ---------------------------------------------------------------------------
# Soil numerics (SHARED.f90:294-300, 367, 506; HYDROLOGY.f90:135).
# ---------------------------------------------------------------------------
NSOIL_LAYERS = 8                    # Number of hydrologically active layers.
NLEVGRND = 9                        # Soil layers + virtual aquifer layer.
SMPMIN = -1.0e8                     # Min. soil matric potential     (mm)
TRUNC = 1.0e-8                      # Truncation tolerance           (-)
WATMIN = 0.01                       # Minimum soil moisture          (mm)

# ---------------------------------------------------------------------------
# Surface/ET parameters (HYDROLOGY.f90:35, 182-188, 1024).
# ---------------------------------------------------------------------------
CP_AIR = 1010.0                     # Specific heat of dry air     (J/kg/K)
RSC_MAX = 1.0e8                     # Cap on canopy stomatal resistance
                                    # (s/m): prevents f32 overflow -> NaN
                                    # when beta underflows (DEVIATIONS.md)
HKDEPTH = 1.0 / 2.5                 # TOPMODEL decay depth scale     (m)
FFF = 1.0 / HKDEPTH                 # TOPMODEL decay factor          (/m)
RSUB_TOP_MAX = 5.5e-3               # Max. topographic baseflow      (mm/s)

# ---------------------------------------------------------------------------
# Vegetation parameters (SHARED.f90:63-75; INIT.f90:154).
# ---------------------------------------------------------------------------
NPLANTS_MAX = 1                     # Max plants per cell (reference: 1).
NGPTS = 1                           # Number of generalised plant types.
PLOT_AREA = 1.0                     # Plot area                      (m^2)
SLA = 23.0e-3                       # Specific leaf area             (m^2/g)

# ---------------------------------------------------------------------------
# Time (EXECUTE/driver.txt:2; INIT.f90:214).
# ---------------------------------------------------------------------------
SDAY = 86400.0                      # Seconds per day                (s)
NISURF_DEFAULT = 48                 # Surface substeps per day (dt = 1800 s)
