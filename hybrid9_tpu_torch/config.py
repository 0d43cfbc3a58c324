"""Run configuration for the PyTorch port of HYBRID9.

A numpy-only copy of the parts of ``hybrid9_tpu/config.py`` that the
day loop and ``run.Simulation`` read: the canonical vertical grid
(``CANONICAL_ZI_MM``, ``LayerGrid``) and ``Config`` with the flagship
physics switches at the JAX package's defaults.  The TPU knobs
``use_pallas``, ``pallas_block`` and ``pallas_interpret`` become one
``use_kernel`` switch; donation and the compilation cache have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .physics import constants as c

# Canonical 0.5-degree soil-interface depths in mm, surface down to the
# aquifer interface (reference: EXECUTE/driver.txt:17-26).  zi[0] = 0 is the
# surface; zi[9] = 5000 mm creates the virtual aquifer layer.
CANONICAL_ZI_MM: Tuple[float, ...] = (
    0.0, 45.0, 91.0, 166.0, 289.0, 493.0, 829.0, 1383.0, 2296.0, 5000.0,
)


def exponential_interfaces(n_soil: int, z_bottom_mm: float = 2296.0,
                           z_aquifer_mm: float = 5000.0,
                           top_dz_mm: float = 20.0) -> Tuple[float, ...]:
    """Geometrically growing soil-interface depths for ``n_soil`` layers
    (e.g. the 20-layer single-column configuration): thicknesses grow
    from ``top_dz_mm`` so the column bottoms out at ``z_bottom_mm``, with
    one final interface at ``z_aquifer_mm`` forming the aquifer layer."""
    def total(r: float) -> float:
        if abs(r - 1.0) < 1e-12:
            return top_dz_mm * n_soil
        return top_dz_mm * (r ** n_soil - 1.0) / (r - 1.0)

    lo, hi = 1.0, 4.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if total(mid) < z_bottom_mm:
            lo = mid
        else:
            hi = mid
    r = 0.5 * (lo + hi)
    dz = top_dz_mm * r ** np.arange(n_soil)
    zi = np.concatenate([[0.0], np.cumsum(dz)])
    zi[-1] = z_bottom_mm
    return tuple(float(z) for z in zi) + (float(z_aquifer_mm),)


@dataclasses.dataclass(frozen=True)
class LayerGrid:
    """Vertical layer geometry derived from interface depths.

    Mirrors the derivation at SOURCE/INIT.f90:252-263: layer thicknesses
    ``dz[i] = zi[i+1] - zi[i]`` and node (centre) depths
    ``zc[i] = zi[i+1] - dz[i]/2``.  All depths in mm, positive downward.
    """

    zi: np.ndarray   # [nlevgrnd + 1] interface depths, zi[0] = 0     (mm)
    dz: np.ndarray   # [nlevgrnd] layer thicknesses                   (mm)
    zc: np.ndarray   # [nlevgrnd] layer node depths                   (mm)

    @classmethod
    def from_interfaces(cls, zi_mm: Sequence[float] = CANONICAL_ZI_MM
                        ) -> "LayerGrid":
        zi = np.asarray(zi_mm, dtype=np.float64)
        if zi[0] != 0.0 or np.any(np.diff(zi) <= 0.0):
            raise ValueError("zi must start at 0 and increase monotonically")
        dz = np.diff(zi)
        zc = zi[1:] - dz / 2.0
        return cls(zi=zi, dz=dz, zc=zc)

    @property
    def nlevgrnd(self) -> int:
        return int(self.dz.shape[0])

    @property
    def nsoil(self) -> int:
        """Hydrologically active soil layers (excludes aquifer layer)."""
        return self.nlevgrnd - 1


@dataclasses.dataclass(frozen=True)
class Config:
    """Declarative run configuration.

    The fields the day loop and ``run.Simulation`` read, with the JAX
    package's defaults.  ``use_kernel`` selects the hand-written CUDA day
    kernel: None takes it exactly when the tensors are on a CUDA device,
    True demands it (and raises on CPU tensors), False takes the plain
    PyTorch twin everywhere.  A switch whose code is not ported yet
    (two-layer snow, the Muskingum and packed routers, lateral
    groundwater, ``vegetation=False``, a network or soil file) is kept
    with its default and raises ``NotImplementedError`` where it is read.
    """

    nisurf: int = c.NISURF_DEFAULT    # Surface substeps per day.
    resolution_deg: float = 0.5       # Lon/lat cell size (0.5 or 0.25).
    zi_mm: Tuple[float, ...] = CANONICAL_ZI_MM
    soil_source: str = "synthetic"    # "synthetic" | "netcdf" | "raw".
    dtype: str = "float32"            # Working dtype for the physics.
    cell_block: int = 1024            # Pad n_land to a multiple of this.
    use_kernel: Optional[bool] = None  # CUDA day kernel; None = on CUDA.
    zd09_every: int = 8               # Refresh the ZD09 equilibrium and
                                      # specific-yield profiles every N
                                      # substeps (1 = exact reference).

    # --- Lateral flow ------------------------------------------------------
    lateral_routing: bool = True      # Route runoff through the D8 net
                                      # (physics/routing.py).
    routing_scheme: str = "kinematic"  # "kinematic" (sub-daily wave at
                                      # physical celerity), "linear" or
                                      # "muskingum".
    routing_form: str = "auto"        # "auto": "grid" (dense [ny, nx]
                                      # roll stencil) for the sub-daily
                                      # schemes, "packed" for linear.
    routing_network_path: Optional[str] = None  # None = synthetic DEM.
    routing_substeps: int = 8         # Sub-daily transfer steps per day.
    routing_celerity: float = 0.8     # Kinematic ref celerity c0 (m/s).
    lateral_groundwater: bool = False  # Aquifer exchange between cells.

    # --- Snow, frozen soil, carbon, vegetation -----------------------------
    snow: bool = True                 # Daily snowpack (physics/snow.py):
                                      # rain/snow partition + degree-day
                                      # melt feeding the hydrology.
    snow_scheme: str = "degree-day"   # "degree-day" or "twolayer".
    snow_ddf: float = 3.0             # Degree-day melt factor (mm/K/day).
    snow_albedo: bool = True          # Snow-albedo radiative feedback
                                      # (step.snow_absorptivity).
    snow_alpha: float = 0.70          # Snow shortwave albedo (-).
    snow_masking_swe: float = 10.0    # SWE at 50% snow cover (mm).
    frozen_soil: bool = True          # Frozen-ground hydraulic impedance.
    soil_ice: bool = True             # Prognostic soil-ice store: daily
                                      # explicit phase change and
                                      # impedance from the ice fraction.
                                      # False = temperature-ramp proxy.
    carbon: bool = True               # Soil-carbon cascade (physics/
                                      # carbon.py); needs vegetation.
    vegetation: bool = True           # Daily GROW dynamics.

    def layer_grid(self) -> LayerGrid:
        return LayerGrid.from_interfaces(self.zi_mm)

    @property
    def dt(self) -> float:
        """Substep length in seconds (reference: INIT.f90:214)."""
        return c.SDAY / float(self.nisurf)

    @property
    def nx(self) -> int:
        return int(round(360.0 / self.resolution_deg))

    @property
    def ny(self) -> int:
        return int(round(180.0 / self.resolution_deg))
