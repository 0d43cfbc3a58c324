"""Raw soil-archive ingest: HWSD texture + BNU 30-arc-sec properties.

Port of ``hybrid9_tpu/data/soil_raw.py`` (numpy and host I/O only).  The
end-to-end, archive-scale analog of the reference's INIT-time soil
pipeline (SOURCE/INIT.f90:473-726):

1. read the HWSD texture classification at model resolution
   (READ_NET_CDF_2DI call, INIT.f90:473-479),
2. for each soil layer, hyperslab-read the BNU 30-arc-sec saturated
   properties (theta_s, k_s, lambda, psi_s) at ``factor``x the model
   resolution and box-average them onto the model grid
   (INIT.f90:492-600) — here band-chunked over latitude so host memory
   stays bounded at any archive size, with the regrid running through
   the threaded native library (io/native.py h9_box_average),
3. convert units and derive bsw = 1/lambda (INIT.f90:602-631),
4. read Fmax with the reference's missing-value default 3809/10000
   (INIT.f90:652-680),

and write the preprocessed per-layer file that ``load_soil``'s NetCDF
branch consumes (the one-time offline product the reference recomputes
at every model start).  File naming follows a per-variable-per-layer
convention ``<var>_l<layer>.nc4`` configurable via ``pattern``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from ..grids.grid import cell_centres
from ..io import native, netcdf
from ..utils.logging import get_logger
from .soil import FMAX_DEFAULT, convert_bnu_units

log = get_logger(__name__)

# BNU archive variable set, in archive units (INIT.f90:492-631).
RAW_VARIABLES = ("theta_s", "k_s", "lambda", "psi_s")

DEFAULT_PATTERN = "{var}_l{layer}.nc4"


def bnu_layer_path(base_dir: str, var: str, layer: int,
                   pattern: str = DEFAULT_PATTERN) -> str:
    """Path of the BNU archive file for ``var`` at soil ``layer`` (1-based)."""
    return os.path.join(base_dir, pattern.format(var=var, layer=layer))


def regrid_fine_variable(path: str, var: str, ny: int, nx: int,
                         band_coarse_rows: int = 32) -> np.ndarray:
    """Box-average one fine-grid archive variable onto the model grid.

    Band-chunked over latitude: each iteration hyperslab-reads
    ``band_coarse_rows x factor`` fine rows (the analog of the
    reference's per-tile NF90_GET_VAR hyperslab, INIT.f90:538-571) and
    regrids them with the NaN-aware box average (INIT.f90:579-600), so
    peak host memory is one band, not the whole 30-arc-sec field.
    """
    fy, fx = netcdf.variable_shape(path, var)
    if fy % ny or fx % nx or (fy // ny) != (fx // nx):
        raise ValueError(
            f"{path}:{var} shape {(fy, fx)} is not an integer multiple "
            f"of the model grid {(ny, nx)}")
    factor = fy // ny
    out = np.empty((ny, nx), np.float64)
    for r0 in range(0, ny, band_coarse_rows):
        r1 = min(ny, r0 + band_coarse_rows)
        band = netcdf.read_variable(
            path, var, (slice(r0 * factor, r1 * factor),))
        band = np.asarray(band, np.float64)
        band[~np.isfinite(band) | (band >= 9.9e19)] = np.nan
        out[r0:r1] = native.box_average(band, factor)
    return out


def prepare_soil(hwsd_path: str, bnu_dir: str, out_path: str,
                 n_layers: int = 8,
                 fmax_path: Optional[str] = None,
                 tex_var: str = "soil_tex",
                 fmax_var: str = "fmax",
                 pattern: str = DEFAULT_PATTERN,
                 band_coarse_rows: int = 32) -> str:
    """Raw archives -> the preprocessed soil file ``load_soil`` reads.

    Returns ``out_path``.  The output holds, at model resolution:
    ``soil_tex`` (HWSD classes), per-layer ``theta_s`` (-), ``hksat``
    (mm/s), ``lambda`` (-), ``psi_s`` (mm), and ``fmax`` (-) — model
    units throughout, i.e. the conversions of INIT.f90:602-631 are
    already applied.  ``load_soil`` derives bsw and the -31 bar
    residual water itself (data/soil.py).
    """
    t0 = time.perf_counter()
    soil_tex = np.asarray(netcdf.read_variable(hwsd_path, tex_var),
                          np.float64)
    # Missing texture (fill values) means no soil: class 0 (HYBRID9.f90:
    # 122-123 computes only soil_tex > 0 and /= 13).
    soil_tex = np.where(np.isfinite(soil_tex) & (soil_tex < 9.9e19),
                        soil_tex, 0.0)
    ny, nx = soil_tex.shape
    lon, lat = cell_centres(180.0 / ny)

    stacks: Dict[str, np.ndarray] = {
        v: np.empty((ny, nx, n_layers), np.float64) for v in RAW_VARIABLES}
    for layer in range(1, n_layers + 1):
        t_l = time.perf_counter()
        for var in RAW_VARIABLES:
            path = bnu_layer_path(bnu_dir, var, layer, pattern)
            stacks[var][:, :, layer - 1] = regrid_fine_variable(
                path, var, ny, nx, band_coarse_rows)
        log.info("regridded layer %d/%d (%.1fs)", layer, n_layers,
                 time.perf_counter() - t_l)

    theta_s, hksat, lambda_, psi_s, _bsw = convert_bnu_units(
        stacks["theta_s"], stacks["k_s"], stacks["lambda"],
        stacks["psi_s"])

    if fmax_path is not None:
        fmax = np.asarray(netcdf.read_variable(fmax_path, fmax_var),
                          np.float64)
        fmax = np.where(np.isfinite(fmax) & (fmax >= 0.0)
                        & (fmax < 9.9e19), fmax, FMAX_DEFAULT)
    else:
        # Reference default when the field is missing (INIT.f90:652-680).
        fmax = np.full((ny, nx), FMAX_DEFAULT)

    fields = {
        "soil_tex": soil_tex,
        "theta_s": theta_s,
        "hksat": hksat,
        "lambda": lambda_,
        "psi_s": psi_s,
        "fmax": fmax,
    }
    units = {"theta_s": "mm3 mm-3", "hksat": "mm s-1", "lambda": "-",
             "psi_s": "mm", "fmax": "-", "soil_tex": "HWSD class"}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    netcdf.write_grid_file(out_path, fields, lon, lat, units=units,
                           layer_dim=n_layers)
    log.info("prepared soil file %s (%d layers, %dx%d grid, %.1fs)",
             out_path, n_layers, ny, nx, time.perf_counter() - t0)
    return out_path
