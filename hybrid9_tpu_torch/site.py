"""Single-column site mode: the LCLIM / INTERACTIVE analog.

Port of ``hybrid9_tpu/site.py``, the replacement for the reference's
site-scale validation harness (SOURCE/HYBRID9.f90:339-484, the LCLIM
branch; the INTERACTIVE focus-cell mode, INIT.f90:220-236): one column,
driven by site climate (a CSV file or the synthetic generator), with a
spin-up loop and daily CSV diagnostics in the reference's column layout
(HYBRID9.f90:223-228: year, doy, evap_day, evap_grnd_day, theta(1..4),
theta_ma(1), LAI, LAI_litter, w_i, fT).

Two engines (``engine=`` in :func:`run_site`):

- ``"oracle"`` (default): the float64 numpy column oracle
  (physics/reference_column.py), on the host.
- ``"kernel"``: the model's own tensor code (``hydrology_substep`` and
  ``grow_daily``) on one column, on the card unless ``device`` names
  another.  The JAX package compiled a whole year of this engine into
  one scan; here a Python loop over days and substeps issues every
  operation for the single column, so on the card the host's launches
  set its speed.

Sub-daily observation rows may carry an ``evap_obs`` column (observed
ET, mm per substep, HYBRID9.f90:449); it is summed to a daily
``evap_obs`` CSV column for comparison and never fed to the physics.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from . import calendar
from .config import Config, LayerGrid
from .data.soil import residual_theta
from .data.synthetic import synthetic_forcing_day, synthetic_soil_params
from .physics import constants as c
from .physics import reference_column as ref
from .physics.drainage import compute_specific_yields
from .physics.grow import grow_daily
from .physics.hydrology import Geometry, hydrology_substep
from .physics.layers import stack, unstack
from .physics.snow import SnowParams, snow_step
from .physics.soilwater import compute_equilibrium_zq
from .run import resolve_device
from .state import SoilParams, initial_state
from .utils.logging import get_logger

log = get_logger(__name__)

CSV_HEADER = ["year", "doy", "evap_day", "evap_grnd_day", "theta1",
              "theta2", "theta3", "theta4", "theta_ma1", "lai",
              "lai_litter", "w_i", "f_t"]

# Debug-site library: the reference keeps a commented catalogue of focus
# points for INTERACTIVE runs (EXECUTE/driver.txt:28-60); the same sites
# as (lon_east, lat_north) for Config.site_lon/site_lat.
DEBUG_SITES: Dict[str, tuple] = {
    "vaira": (-120.95, 38.41),          # Vaira Ranch, CA (LCLIM site)
    "sarawak": (114.0, 2.5),            # Borneo rainforest
    "kalahari": (21.5, -23.0),          # semi-arid (NISURF stability site)
    "cambridge": (0.1, 52.2),           # temperate maritime
    "harvard_forest": (-72.17, 42.54),  # temperate deciduous
    "sahara": (10.0, 23.0),             # hyper-arid
    "indonesia": (117.0, 0.5),          # humid tropics
}

#: The names of the kernel engine's per-substep forcing fields.
_FD_KEYS = ("tak", "rh", "rnet", "par", "forc_rain", "lamb", "huss", "ps")


@dataclasses.dataclass
class SiteResult:
    daily: List[Dict[str, float]]
    # ref.ColumnState (oracle engine) or state.ModelState (kernel engine)
    state: object


def _initial_column(params: ref.ColumnParams, grid: LayerGrid
                    ) -> ref.ColumnState:
    """Fresh-init column state (INIT.f90:707-811)."""
    nl = grid.nsoil
    dz = grid.dz[:nl]
    h2osoi = 0.4 * params.theta_s * dz
    s = np.full(nl, 0.4)
    smp = np.maximum(c.SMPMIN, params.psi_s * s ** (-params.bsw))
    plant_mass = 1.0
    foliage = 0.0435
    length = np.cbrt(400.0 * plant_mass / 3.142e-3)
    rdepth = 0.3 * length
    decay = np.exp(np.log(0.1) / (rdepth / 10.0))
    rootr = np.array([decay ** (grid.zi[i] / 10.0)
                      - decay ** (grid.zi[i + 1] / 10.0)
                      for i in range(nl)])
    return ref.ColumnState(
        h2osoi=h2osoi, zwt=(grid.zi[nl] + 5000.0) / 1000.0, wa=4000.0,
        smp=smp, lai=foliage * c.SLA, lai_litter=0.001, rootr=rootr,
        plant_mass=plant_mass, plant_foliage_mass=foliage)


# The reference's prescribed Vaira Ranch LAI phenology, embedded in its
# LCLIM loop per calendar year (HYBRID9.f90:380-417): {doy: LAI}.  Shed
# foliage (a waypoint below the current LAI) moves to the litter layer as
# in the reference.
VAIRA_LAI_WAYPOINTS: Dict[int, Dict[int, float]] = {
    2002: {1: 0.88, 59: 1.17, 79: 1.87, 94: 2.23, 108: 2.55,
           122: 1.43, 136: 0.001, 357: 0.61},
    2003: {29: 0.96, 52: 1.58, 76: 1.82, 95: 2.63, 106: 2.52,
           120: 1.86, 141: 0.76, 158: 0.001},
}


def read_lclim_daily_csv(path: str,
                         rsds: float = 0.0, rlds: float = 0.0
                         ) -> tuple:
    """Read a reference-format positional daily LCLIM file.

    The reference's unit-10 record (HYBRID9.f90:368-379): one header
    line, then per day ``doy, evap_obs (mm/day), pr (mm/day), tas (C),
    rh (%), huss (kg/kg), ps (Pa)``, whitespace- or comma-separated, no
    names.  Daily radiation is not in the record (the reference takes
    Rnet/PAR from the sub-daily file only, HYBRID9.f90:431-433), so
    ``rsds``/``rlds`` fill those fields: pair this reader with
    :func:`read_lclim_subdaily_csv` as the reference pairs units 10 and
    11.

    Returns ``(days, evap_obs)``: the record as ``List[ref.DailyForcing]``
    (record order; pr mm/day -> mm/s, tas C -> K) and ``{record index
    (1-based): observed daily ET in mm/day}``.
    """
    days: List[ref.DailyForcing] = []
    obs: Dict[int, float] = {}
    with open(path) as f:
        next(f)                              # header (READ (10,*))
        for line in f:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            vals = [float(v) for v in parts[:7]]
            _doy, evap_obs_day, pr_day, tas_c, rh, huss, ps = vals
            days.append(ref.DailyForcing(
                tas=tas_c + c.TF, rlds=rlds, rsds=rsds, huss=huss,
                ps=ps, pr=pr_day / c.SDAY, rhs=rh))
            obs[len(days)] = evap_obs_day
    return days, obs


def read_lclim_subdaily_csv(path: str, nisurf: int) -> Dict[int, list]:
    """Read a reference-format positional sub-daily LCLIM file.

    The reference's unit-11 record (HYBRID9.f90:426-460): one header
    line, then ``nisurf`` rows a day of 37 positional columns, of which
    the reference uses (1-based) 12 (observed LE, W/m^2), 14 (Rnet,
    W/m^2), 16 (PAR, W/m^2), 22 (air T, C), 25 (RH, %) and 35 (precip,
    mm per substep).  Returns ``{doy: [override dict per substep]}`` as
    :func:`read_site_subdaily_csv` does; observed LE becomes mm per
    substep through the reference's latent heat, lamb = (2503 - 2.386
    (T - tf)) kJ/kg (HYBRID9.f90:445-450).
    """
    dt = c.SDAY / nisurf
    out: Dict[int, list] = {}
    rows: List[List[float]] = []
    with open(path) as f:
        next(f)                              # header (READ (11,*))
        for line in f:
            parts = line.replace(",", " ").split()
            if parts:
                rows.append([float(v) for v in parts])
    for i, r in enumerate(rows):
        doy = i // nisurf + 1
        step = i % nisurf
        if doy not in out:
            out[doy] = [{} for _ in range(nisurf)]
        tak = r[21] + c.TF                   # column 22 (C -> K)
        lamb = (2503.0 - 2.386 * (tak - c.TF)) * 1.0e3
        evap_obs_flux = (r[11] / lamb) * 1.0e3 / c.RHOW   # mm/s
        out[doy][step] = dict(
            tak=tak,
            rh=r[24],                        # column 25 (%)
            rnet=r[13],                      # column 14 (W/m^2)
            par=r[15],                       # column 16 (W/m^2)
            forc_rain=r[34] / dt,            # column 35 (mm/substep)
            evap_obs=evap_obs_flux * dt,     # mm per substep
        )
    return out


def read_site_climate_csv(path: str) -> List[ref.DailyForcing]:
    """Read daily site climate from CSV with named columns (any order):
    tas [K], rlds, rsds [W/m^2], huss [kg/kg], ps [Pa], pr [kg/m^2/s],
    rhs [%], the PGF variables at daily cadence (the named analog of the
    reference's positional LCLIM files, HYBRID9.f90:368-379)."""
    days = []
    with open(path) as f:
        for row in csv.DictReader(f):
            days.append(ref.DailyForcing(
                tas=float(row["tas"]), rlds=float(row["rlds"]),
                rsds=float(row["rsds"]), huss=float(row["huss"]),
                ps=float(row["ps"]), pr=float(row["pr"]),
                rhs=float(row["rhs"])))
    return days


def read_site_subdaily_csv(path: str, nisurf: int):
    """Read sub-daily site climate overrides from CSV.

    Columns (header): ``doy``, ``step`` (1..nisurf), and any of ``tak``
    [K], ``rh`` [%], ``rnet`` [W/m^2], ``par`` [W/m^2], ``ppt``
    [mm/substep] and ``evap_obs`` [mm/substep], the named analog of the
    reference's positional LCLIM sub-daily rows (HYBRID9.f90:426-460).
    Returns ``{doy: [override dict per substep]}``; ``ppt`` becomes a
    rain flux (mm/s).
    """
    dt = c.SDAY / nisurf
    out: Dict[int, list] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            doy = int(row["doy"])
            step = int(row["step"]) - 1
            if doy not in out:
                out[doy] = [{} for _ in range(nisurf)]
            ov = {}
            for k in ("tak", "rh", "rnet", "par"):
                if row.get(k) not in (None, ""):
                    ov[k] = float(row[k])
            if row.get("ppt") not in (None, ""):
                ov["forc_rain"] = float(row["ppt"]) / dt
            if row.get("evap_obs") not in (None, ""):
                # Observed ET (mm per substep; HYBRID9.f90:449), kept for
                # the daily comparison column and stripped before the
                # overrides reach the physics.
                ov["evap_obs"] = float(row["evap_obs"])
            out[doy][step] = ov
    return out


def _split_obs(subdaily: Optional[Dict[int, list]]
               ) -> tuple[Optional[Dict[int, list]], Dict[int, float]]:
    """Strip the ``evap_obs`` entries out of sub-daily override dicts.
    Returns (physics-only overrides, {doy: observed daily ET in mm})."""
    if not subdaily:
        return subdaily, {}
    clean: Dict[int, list] = {}
    obs: Dict[int, float] = {}
    for doy, steps in subdaily.items():
        clean_steps = []
        total = 0.0
        seen = False
        for ov in steps:
            ov = dict(ov)
            if "evap_obs" in ov:
                total += ov.pop("evap_obs")
                seen = True
            clean_steps.append(ov)
        clean[doy] = clean_steps
        if seen:
            obs[doy] = total
    return clean, obs


def run_site(cfg: Config,
             climate: Optional[Iterable[ref.DailyForcing]] = None,
             params: Optional[ref.ColumnParams] = None,
             lai_waypoints: Optional[Dict[int, float]] = None,
             subdaily: Optional[Dict[int, list]] = None,
             grow: bool = True,
             csv_out: Optional[str] = None,
             engine: str = "oracle",
             evap_obs_daily: Optional[Dict[int, float]] = None,
             record_year_days: Optional[int] = None,
             device=None) -> SiteResult:
    """Run the single-column site simulation.

    ``cfg.spinup_years`` repeats of the climate record precede the scored
    one (the reference's iLOOP spin-up, HYBRID9.f90:341).
    ``lai_waypoints`` prescribes LAI on given days of the record, shed
    foliage going to the litter layer as the reference does for the Vaira
    phenology (HYBRID9.f90:380-417).  ``subdaily`` maps day of year to
    per-substep forcing overrides (:func:`read_site_subdaily_csv`);
    ``grow=False`` turns the daily GROW call off (the LCLIM mode with
    prescribed LAI, HYBRID9.f90:473-475).  ``engine`` picks the float64
    numpy oracle (``"oracle"``) or the model's tensor code
    (``"kernel"``), which runs on ``device``: the card unless the caller
    names another, such as ``"cpu"``.

    ``record_year_days`` is the record's own year length for the (year,
    doy) labels: a multi-year record without leap days (a repeated
    365-day climatology) passes 365 so that the labels roll with the
    record.  ``None`` takes the Gregorian calendar from
    ``cfg.start_year``.
    """
    grid = cfg.layer_grid()
    nl = grid.nsoil
    if params is None:
        raw = synthetic_soil_params(1, seed=17, n_layers=nl)
        params = ref.ColumnParams(
            theta_s=raw["theta_s"][0], hksat=raw["hksat"][0],
            bsw=raw["bsw"][0], psi_s=raw["psi_s"][0],
            fmax=float(raw["fmax"][0]))
    if climate is None:
        climate = [
            ref.DailyForcing(**{k: float(v[0]) for k, v in
                                synthetic_forcing_day(
                                    1, d + 1, seed=17,
                                    lat=np.array([cfg.site_lat])).items()})
            for d in range(365)]
    climate = list(climate)
    subdaily, evap_obs = _split_obs(subdaily)

    if engine == "kernel":
        daily, state = _run_site_kernel(cfg, grid, params, climate,
                                        lai_waypoints, subdaily, grow,
                                        resolve_device(device))
    elif engine == "oracle":
        daily, state = _run_site_oracle(cfg, grid, params, climate,
                                        lai_waypoints, subdaily, grow)
    else:
        raise ValueError(f"unknown site engine {engine!r} "
                         "(expected 'oracle' or 'kernel')")

    # Label rows with the calendar (year, doy): the engines emit 1-based
    # record positions, which are days of the year only for a one-year
    # record; a multi-year record rolls the year (HYBRID9.f90:339-484
    # spans syr..eyr).
    year, doy = cfg.start_year, 1
    for row in daily:
        row["year"], row["doy"] = year, doy
        doy += 1
        year_len = (record_year_days if record_year_days is not None
                    else calendar.days_in_year(year))
        if doy > year_len:
            year, doy = year + 1, 1

    if evap_obs_daily:
        # Daily observed ET from a daily record (the reference's unit-10
        # evap_obs_day, HYBRID9.f90:370); sub-daily observations win where
        # both exist.  Both key by 1-based record position.
        merged = dict(evap_obs_daily)
        merged.update(evap_obs)
        evap_obs = merged
    has_obs = bool(evap_obs)
    if has_obs:
        for i, row in enumerate(daily):
            row["evap_obs"] = evap_obs.get(i + 1, float("nan"))

    if csv_out:
        header = CSV_HEADER + (["evap_obs"] if has_obs else [])
        with open(csv_out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for row in daily:
                w.writerow([row["year"], row["doy"]]
                           + [f"{row[k]:.4f}" for k in header[2:]])
        log.info("wrote %d daily rows to %s", len(daily), csv_out)

    return SiteResult(daily=daily, state=state)


def _run_site_oracle(cfg: Config, grid: LayerGrid,
                     params: ref.ColumnParams, climate: list,
                     lai_waypoints, subdaily, grow: bool):
    """Site loop on the float64 numpy column oracle."""
    nl = grid.nsoil
    state = _initial_column(params, grid)
    zi, dz, zc = grid.zi, grid.dz, grid.zc
    dt = cfg.dt
    daily: List[Dict[str, float]] = []

    n_loops = max(1, cfg.spinup_years + 1)
    for loop in range(n_loops):
        scored = loop == n_loops - 1
        for d, forcing in enumerate(climate):
            doy = d + 1
            if lai_waypoints and doy in lai_waypoints:
                new_lai = lai_waypoints[doy]
                if new_lai < state.lai:
                    state.lai_litter += state.lai - new_lai
                state.lai = new_lai
            out = ref.run_day(state, params, forcing, zi, dz.copy(),
                              zc.copy(), dt, cfg.nisurf,
                              subdaily=(subdaily or {}).get(doy),
                              grow=grow)
            if scored:
                theta = state.h2osoi[:nl] / dz[:nl]
                daily.append(dict(
                    year=cfg.start_year, doy=doy,
                    evap_day=out["evap_day"],
                    evap_grnd_day=out["evap_grnd_day"],
                    theta1=theta[0], theta2=theta[1], theta3=theta[2],
                    theta4=theta[3], theta_ma1=0.0,
                    lai=state.lai, lai_litter=state.lai_litter,
                    w_i=out["w_i"], f_t=out["f_t"],
                    max_residual=out["max_residual"],
                ))
    return daily, state


def _kernel_soil_params(params: ref.ColumnParams, dtype: torch.dtype,
                        device) -> SoilParams:
    """ColumnParams -> a one-cell SoilParams (the site is an n=1 batch)."""
    bsw = np.asarray(params.bsw, np.float64)
    lam = 1.0 / bsw
    theta_m = residual_theta(np.asarray(params.theta_s, np.float64),
                             np.asarray(params.psi_s, np.float64), lam)

    def one(x):
        return torch.tensor(np.asarray(x, np.float64)[None, :], dtype=dtype,
                            device=device)

    return SoilParams(
        theta_s=one(params.theta_s), hksat=one(params.hksat),
        lambda_=one(lam), bsw=one(params.bsw), psi_s=one(params.psi_s),
        theta_m=one(theta_m),
        fmax=torch.tensor([float(params.fmax)], dtype=dtype, device=device))


def _fd_step_arrays(forcing: ref.DailyForcing, overrides, nisurf: int
                    ) -> Dict[str, np.ndarray]:
    """The day's per-substep derived forcing as ``[nisurf, 1]`` float64
    arrays, with the sub-daily observation overrides applied as the
    oracle applies them (reference_column.run_day; HYBRID9.f90:426-460),
    the latent heat recomputed where an observed air temperature
    replaces the daily one."""
    base = ref.derived_forcing(forcing)
    rows = []
    for ns in range(nisurf):
        fd = dict(base)
        if overrides is not None:
            ov = overrides[ns]
            fd.update(ov)
            if "tak" in ov and "lamb" not in ov:
                fd["lamb"] = (2503.0 - 2.386 * (fd["tak"] - c.TF)) * 1.0e3
        rows.append(fd)
    return {k: np.array([[r[k]] for r in rows]) for k in _FD_KEYS}


def _snow_substep_rain(forc_rain, swe, tas, snow_p):
    """The daily snow update with the day's sub-daily rain redistributed.

    ``forc_rain`` is ``[nisurf, n]`` in mm/s; ``snow_step`` runs on the
    day-mean flux and returns the effective rainfall ``pr_eff`` as a flux
    but the day's melt in mm/day, so the melt is turned back into a flux
    before it meets the sub-daily rain.  The day's liquid (unsnowed) rain
    keeps its sub-daily pattern, rescaled to ``pr_eff - melt_flux``, and
    melt is released evenly over the day.  Per day, in mm:
    ``mean(forc_rain')*SDAY + (swe' - swe) + capped ==
    mean(forc_rain)*SDAY``.  Returns ``(swe_new, forc_rain_new,
    capped_mm)``.
    """
    pr_day = torch.mean(forc_rain, dim=0)            # mm/s day-mean
    swe_new, pr_eff, melt, capped = snow_step(swe, tas, pr_day, snow_p)
    melt_flux = melt / c.SDAY                        # mm/day -> mm/s
    rain_share = torch.clamp(pr_eff - melt_flux, min=0.0) \
        / torch.clamp(pr_day, min=1.0e-12)
    return (swe_new, forc_rain * rain_share + melt_flux[None, :],
            capped)


def _run_site_kernel(cfg: Config, grid: LayerGrid,
                     params: ref.ColumnParams, climate: list,
                     lai_waypoints, subdaily, grow: bool, device):
    """Site loop on the model's tensor code for one column on ``device``.

    The analog of the reference's LCLIM branch (HYBRID9.f90:339-484):
    ``hydrology_substep`` and ``grow_daily``, batched at n=1, with the
    observed sub-daily rows replacing the daily derivation.  The record's
    derived forcing, daily air temperature and prescribed LAI (NaN =
    none) go to the device once; each day runs the snow store (on the
    day-mean rain, with the sub-daily pattern rescaled; no albedo, site
    radiation being observed), ``nisurf`` substeps with the ZD09 and
    specific-yield profiles refreshed every ``cfg.zd09_every``, and the
    growth diagnostics ``w_i`` and ``f_t`` from the day's final smp and
    the pre-growth roots.  The scored loop's daily outputs come to the
    host in one copy at its end.
    """
    dtype = getattr(torch, cfg.dtype)
    nl = grid.nsoil
    geom = Geometry.from_layer_grid(grid)
    sp = _kernel_soil_params(params, dtype, device)
    state = initial_state(sp, grid.dz, grid.zi, dtype, device)
    soil, veg, swe = state.soil, state.veg, state.swe
    dt = cfg.dt
    zi_arr = torch.tensor(np.asarray(grid.zi), dtype=dtype, device=device)
    ndays = len(climate)
    zd = int(cfg.zd09_every)
    snow_p = SnowParams(ddf=cfg.snow_ddf) if cfg.snow else None

    per_day = [_fd_step_arrays(f, (subdaily or {}).get(d + 1), cfg.nisurf)
               for d, f in enumerate(climate)]
    fd_year = {k: torch.tensor(np.stack([p[k] for p in per_day]),
                               dtype=dtype, device=device) for k in _FD_KEYS}
    tas_year = torch.tensor([[f.tas] for f in climate], dtype=dtype,
                            device=device)
    lai_year = np.full((ndays, 1), np.nan)
    for doy, v in (lai_waypoints or {}).items():
        if 1 <= doy <= ndays:
            lai_year[doy - 1, 0] = v
    lai_year = torch.tensor(lai_year, dtype=dtype, device=device)
    p_ts, p_ps, p_bs = (unstack(sp.theta_s), unstack(sp.psi_s),
                        unstack(sp.bsw))

    n_loops = max(1, cfg.spinup_years + 1)
    for _loop in range(n_loops):
        outs = []
        for d in range(ndays):
            tas, lai_new = tas_year[d], lai_year[d]
            # Prescribed-LAI waypoint (HYBRID9.f90:380-417): shed foliage
            # goes to the litter layer.
            have = torch.isfinite(lai_new)
            cur = veg.lai
            shed = torch.where(have & (lai_new < cur), cur - lai_new, 0.0)
            veg = veg.replace(lai=torch.where(have, lai_new, cur),
                              lai_litter=veg.lai_litter + shed)
            fd_steps = {k: v[d] for k, v in fd_year.items()}
            snow_capped = torch.zeros_like(soil.zwt)
            if snow_p is not None:
                swe, new_rain, snow_capped = _snow_substep_rain(
                    fd_steps["forc_rain"], swe, tas, snow_p)
                fd_steps["forc_rain"] = new_rain
            zero = torch.zeros_like(soil.zwt)
            evap = evap_grnd = rnf = max_res = zero
            zq = sy = None
            for it in range(cfg.nisurf):
                if zd > 1 and it % zd == 0:
                    zq = stack(compute_equilibrium_zq(soil.zwt, p_ts, p_ps,
                                                      p_bs, geom.zi))
                    sy = stack(compute_specific_yields(soil.zwt, p_ts, p_ps,
                                                       p_bs))
                fd = {k: v[it] for k, v in fd_steps.items()}
                soil, fx = hydrology_substep(soil, veg, sp, fd, geom, dt,
                                             zq=zq, sy=sy)
                evap = evap + (fx.qflx_evap_grnd + fx.qflx_tran_veg) * dt
                evap_grnd = evap_grnd + fx.qflx_evap_grnd * dt
                rnf = rnf + (fx.qflx_surf + fx.rsub_top) * dt
                max_res = torch.maximum(max_res, torch.abs(fx.residual))
            rnf = rnf + snow_capped
            if grow:
                # Growth-constraint diagnostics from the day's smp and the
                # pre-growth roots, the values grow_daily itself uses
                # (GROW.f90:55-72); zeros without growth, as the oracle.
                wi_l = torch.clamp((-150000.0 - soil.smp) / (-100000.0),
                                   0.0, 1.0)
                w_i = torch.sum(veg.rootr * wi_l, dim=-1)
                t = tas - c.TF
                ft_warm = torch.clamp(
                    1.0 - (torch.abs(t - 18.0) / 21.0) ** 2, min=0.0)
                ft_cool = torch.clamp(
                    1.0 - (torch.abs(t - 18.0) / 25.0) ** 2, 0.0, 1.0)
                f_t = torch.where(t > 18.0, ft_warm, ft_cool)
                veg, _npp, _lf = grow_daily(veg, soil.smp, tas, zi_arr)
            else:
                w_i = f_t = zero
            outs.append(torch.cat([evap, evap_grnd, max_res, w_i, f_t,
                                   veg.lai, veg.lai_litter,
                                   soil.h2osoi_liq[0]]))
    outs = torch.stack(outs).double().cpu().numpy()

    dz = grid.dz[:nl]
    daily: List[Dict[str, float]] = []
    for d in range(ndays):
        (evap, evap_grnd, max_res, w_i, f_t, lai,
         lai_litter), h2osoi = outs[d, :7], outs[d, 7:]
        theta = h2osoi / dz
        daily.append(dict(
            year=cfg.start_year, doy=d + 1,
            evap_day=float(evap), evap_grnd_day=float(evap_grnd),
            theta1=float(theta[0]), theta2=float(theta[1]),
            theta3=float(theta[2]), theta4=float(theta[3]),
            theta_ma1=0.0, lai=float(lai), lai_litter=float(lai_litter),
            w_i=float(w_i), f_t=float(f_t), max_residual=float(max_res),
        ))
    final = state.replace(soil=soil, veg=veg, swe=swe)
    return daily, final
