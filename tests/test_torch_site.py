"""The port's site mode against the JAX package and its own oracle.

Mirrors tests/test_site_lclim.py and tests/test_site_kernel.py on short
records (30 days, ``nisurf`` 8, where the JAX tests run a year): the
LCLIM readers give the JAX package's records; ``site --engine oracle``
writes the JAX package's CSV to the printed digit; the kernel engine (the
port's tensor code on one column, on the CPU here) matches the port's
numpy oracle at the tolerances of tests/test_site_kernel.py, in float64
and in float32, with sub-daily overrides, observed ET, prescribed LAI
and the daily snow store; and it matches the JAX package's kernel engine.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import site as j_site
from hybrid9_tpu.cli import main as j_main
from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.physics import reference_column as j_ref
from hybrid9_tpu.physics.snow import SnowParams as JSnowParams
from hybrid9_tpu_torch import site
from hybrid9_tpu_torch.cli import main
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics import reference_column as ref
from hybrid9_tpu_torch.physics.snow import SnowParams

NISURF = 8
NDAYS = 30
TRACK_KEYS = ("evap_day", "evap_grnd_day", "theta1", "theta2", "theta3",
              "theta4", "lai", "w_i", "f_t")


def _cfg(cls=Config, **kw):
    """Exact mode for oracle comparisons: the oracle refreshes the ZD09
    profile every substep and has no snow store."""
    base = dict(spinup_years=0, nisurf=NISURF, dtype="float64",
                zd09_every=1, snow=False)
    base.update(kw)
    return cls(**base)


def _climate(module, ndays=NDAYS, cold=False):
    """The default site's synthetic record (seed 17, Vaira's latitude),
    or a cold-winter one whose first third is below freezing."""
    if cold:
        return [module.DailyForcing(
            tas=263.0 if d < ndays // 3 else 288.0, rlds=300.0, rsds=180.0,
            huss=0.006, ps=101325.0, pr=4.0 / c.SDAY, rhs=70.0)
            for d in range(ndays)]
    from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_day
    return [module.DailyForcing(**{k: float(v[0]) for k, v in
                                   synthetic_forcing_day(
                                       1, d + 1, seed=17,
                                       lat=np.array([38.41])).items()})
            for d in range(ndays)]


def _compare(oracle, kernel, days, atol=1e-7, rtol=1e-5):
    assert len(oracle.daily) == len(kernel.daily) == days
    for key in TRACK_KEYS:
        a = np.array([r[key] for r in oracle.daily])
        b = np.array([r[key] for r in kernel.daily])
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                   err_msg=f"site engine mismatch: {key}")


# --- readers (tests/test_site_lclim.py) -------------------------------------

def _write_lclim_daily(path, ndays=10):
    rows = ["doy evap pr tas rh huss ps   (positional header)"]
    for d in range(1, ndays + 1):
        rows.append(f"{d} {1.5 + 0.1 * d} {2.0 if d % 3 == 0 else 0.0} "
                    f"{12.0 + d * 0.5} {65.0} {0.008} {101300.0}")
    path.write_text("\n".join(rows) + "\n")


def _write_lclim_subdaily(path, ndays=10, nisurf=NISURF):
    lines = [" ".join(f"c{i}" for i in range(37))]
    for d in range(1, ndays + 1):
        for s in range(nisurf):
            cols = [0.0] * 37
            daylight = max(0.0, np.sin(np.pi * (s + 0.5) / nisurf))
            cols[11] = 60.0 * daylight            # 12: obs LE (W/m^2)
            cols[13] = 250.0 * daylight           # 14: Rnet (W/m^2)
            cols[15] = 120.0 * daylight           # 16: PAR (W/m^2)
            cols[21] = 10.0 + 8.0 * daylight      # 22: T (C)
            cols[24] = 70.0 - 20.0 * daylight     # 25: RH (%)
            cols[34] = 0.4 if (d % 3 == 0 and s == 2) else 0.0  # 35: mm
            lines.append(" ".join(f"{v:.4f}" for v in cols))
    path.write_text("\n".join(lines) + "\n")


def _write_subdaily_obs(path):
    with open(path, "w") as f:
        f.write("doy,step,tak,rnet,ppt,evap_obs\n")
        for step in range(1, NISURF + 1):
            f.write(f"10,{step},300.0,400.0,1.0,0.25\n")


def test_readers_equal_the_jax_packages(tmp_path):
    daily, sub, obs = (tmp_path / "d.csv", tmp_path / "s.csv",
                       tmp_path / "o.csv")
    _write_lclim_daily(daily)
    _write_lclim_subdaily(sub)
    _write_subdaily_obs(obs)
    days, evap = site.read_lclim_daily_csv(daily)
    j_days, j_evap = j_site.read_lclim_daily_csv(daily)
    assert [vars(d) for d in days] == [vars(d) for d in j_days]
    assert evap == j_evap
    assert days[0].tas == pytest.approx(12.5 + c.TF)
    assert days[2].pr == pytest.approx(2.0 / c.SDAY)
    for read in ("read_lclim_subdaily_csv", "read_site_subdaily_csv"):
        path = sub if "lclim" in read else obs
        got = getattr(site, read)(path, NISURF)
        assert got == getattr(j_site, read)(path, NISURF)
        assert site._split_obs(got) == j_site._split_obs(got)
    with open(tmp_path / "clim.csv", "w") as f:
        w = csv.writer(f)
        w.writerow(["tas", "rlds", "rsds", "huss", "ps", "pr", "rhs"])
        w.writerow([280.0, 300.0, 150.0, 0.006, 101000.0, 1e-5, 70.0])
    assert [vars(d) for d in site.read_site_climate_csv(
        tmp_path / "clim.csv")] == [vars(d) for d in
                                    j_site.read_site_climate_csv(
                                        tmp_path / "clim.csv")]
    assert site.DEBUG_SITES == j_site.DEBUG_SITES
    assert site.VAIRA_LAI_WAYPOINTS == j_site.VAIRA_LAI_WAYPOINTS
    assert site.CSV_HEADER == j_site.CSV_HEADER


def _write_climate_csv(path, days):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tas", "rlds", "rsds", "huss", "ps", "pr", "rhs"])
        for d in days:
            w.writerow([repr(getattr(d, k)) for k in
                        ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")])


@pytest.mark.parametrize("extra", [[], ["--spinup", "1", "--noleap"]],
                         ids=["plain", "spinup"])
def test_site_oracle_cli_writes_the_jax_packages_csv(tmp_path, extra):
    """``site --engine oracle`` on the same climate and observations:
    the CSV the JAX package writes, byte for byte."""
    clim = tmp_path / "clim.csv"
    _write_climate_csv(clim, _climate(ref, ndays=20))
    obs = tmp_path / "obs.csv"
    _write_subdaily_obs(obs)
    argv = ["site", "--climate", str(clim), "--subdaily", str(obs),
            "--nisurf", str(NISURF), "--engine", "oracle", *extra]
    assert main(argv + ["--csv-out", str(tmp_path / "port.csv")]) == 0
    assert j_main(argv + ["--csv-out", str(tmp_path / "jax.csv")]) == 0
    got = (tmp_path / "port.csv").read_text()
    assert got == (tmp_path / "jax.csv").read_text()
    assert len(got.splitlines()) == 21 and "evap_obs" in got.splitlines()[0]


# --- the kernel engine (tests/test_site_kernel.py) --------------------------

def test_kernel_engine_matches_oracle_f64():
    cfg = _cfg(spinup_years=1)
    climate = _climate(ref)
    oracle = site.run_site(cfg, climate=climate, engine="oracle")
    kernel = site.run_site(cfg, climate=climate, engine="kernel",
                           device="cpu")
    _compare(oracle, kernel, NDAYS)
    assert max(r["max_residual"] for r in kernel.daily) < 0.1
    assert kernel.state.soil.zwt.device.type == "cpu"


def test_kernel_engine_float32_tracks_oracle():
    """float32 on one column stays within 5e-3 in theta of the float64
    oracle (tests/test_site_kernel.py's tolerance)."""
    cfg = _cfg(dtype="float32")
    climate = _climate(ref)
    oracle = site.run_site(cfg, climate=climate, engine="oracle")
    kernel = site.run_site(cfg, climate=climate, engine="kernel",
                           device="cpu")
    assert kernel.state.soil.zwt.dtype == torch.float32
    for key in ("theta1", "theta2", "theta3", "theta4"):
        np.testing.assert_allclose(
            [r[key] for r in kernel.daily], [r[key] for r in oracle.daily],
            atol=5e-3, err_msg=f"f32 site drift: {key}")


def test_kernel_engine_subdaily_obs_and_lai_waypoints(tmp_path):
    """Sub-daily overrides and prescribed LAI steer the kernel engine as
    they steer the oracle, and ``evap_obs`` becomes a CSV column."""
    path = tmp_path / "obs.csv"
    _write_subdaily_obs(path)
    sub = site.read_site_subdaily_csv(str(path), NISURF)
    cfg = _cfg()
    climate = _climate(ref)
    way = {5: 2.5, 20: 0.5}
    out_o, out_k = tmp_path / "o.csv", tmp_path / "k.csv"
    oracle = site.run_site(cfg, climate=climate, subdaily=sub, grow=False,
                           lai_waypoints=way, csv_out=str(out_o),
                           engine="oracle")
    kernel = site.run_site(cfg, climate=climate, subdaily=sub, grow=False,
                           lai_waypoints=way, csv_out=str(out_k),
                           engine="kernel", device="cpu")
    _compare(oracle, kernel, NDAYS)
    assert kernel.daily[5]["lai"] == pytest.approx(2.5)
    assert kernel.daily[20]["lai"] == pytest.approx(0.5)
    plain = site.run_site(cfg, climate=climate, grow=False,
                          lai_waypoints=way, engine="kernel", device="cpu")
    assert kernel.daily[9]["evap_day"] != pytest.approx(
        plain.daily[9]["evap_day"], rel=1e-6)
    for res, out in ((oracle, out_o), (kernel, out_k)):
        assert res.daily[9]["evap_obs"] == pytest.approx(0.25 * NISURF)
        assert np.isnan(res.daily[11]["evap_obs"])
        with open(out) as f:
            rows = list(csv.DictReader(f))
        assert float(rows[9]["evap_obs"]) == pytest.approx(2.0)
    assert out_o.read_text().splitlines()[0] == \
        out_k.read_text().splitlines()[0]


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9),
                                        ("float32", 5e-4)])
def test_kernel_engine_matches_jax_kernel_engine(dtype, rtol):
    """The port's kernel engine against the JAX package's, with the
    production knobs on (``zd09_every`` 4, the daily snow store) on a
    cold record that banks and melts snow, and sub-daily overrides."""
    kw = dict(dtype=dtype, zd09_every=4, snow=True, spinup_years=1)
    obs = {10: [dict(tak=290.0, rnet=300.0, forc_rain=1e-4)] * NISURF}
    got = site.run_site(_cfg(**kw), climate=_climate(ref, cold=True),
                        subdaily=obs, engine="kernel", device="cpu")
    want = j_site.run_site(_cfg(JConfig, **kw),
                           climate=_climate(j_ref, cold=True),
                           subdaily=obs, engine="kernel")
    atol = 1e-12 if dtype == "float64" else 5e-3
    for key in TRACK_KEYS + ("lai_litter", "max_residual"):
        np.testing.assert_allclose([r[key] for r in got.daily],
                                   [r[key] for r in want.daily],
                                   rtol=rtol, atol=atol, err_msg=key)
    np.testing.assert_allclose(float(got.state.swe[0]),
                               float(want.state.swe[0]), rtol=rtol,
                               atol=atol)
    assert max(r["max_residual"] for r in got.daily) < 0.1


def test_snow_substep_rain_matches_jax_and_conserves():
    """The daily snow with the sub-daily rain rescaled: melt (mm/day) is
    a flux before it meets the rain pattern, and the day's water is
    conserved: mean(rain')*SDAY + d(swe) + capped == mean(rain)*SDAY."""
    n = 3
    pat = np.zeros((NISURF, n))
    pat[3] = 8.0 / (c.SDAY / NISURF)
    pat[4] = 4.0 / (c.SDAY / NISURF)
    swe0 = np.array([50.0, 0.0, 5.0])
    tas = np.array([c.TF + 10.0, c.TF - 10.0, c.TF + 20.0])
    got = site._snow_substep_rain(torch.tensor(pat), torch.tensor(swe0),
                                  torch.tensor(tas), SnowParams(ddf=3.0))
    want = j_site._snow_substep_rain(jnp.asarray(pat), jnp.asarray(swe0),
                                     jnp.asarray(tas), JSnowParams(ddf=3.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)
    swe1, rain1, capped = (x.numpy() for x in got)
    day_in = pat.mean(axis=0) * c.SDAY
    day_out = rain1.mean(axis=0) * c.SDAY
    np.testing.assert_allclose(day_out + swe1 - swe0 + capped, day_in,
                               atol=1e-9)
    assert day_out[0] <= day_in[0] + 3.0 * 10.0 + 1e-9
    np.testing.assert_allclose(day_out[1], 0.0, atol=1e-12)


def test_kernel_engine_snow_on_conserves_water():
    """With the snow store on, a record that banks snow and melts it
    keeps the residual bound every day and makes no water."""
    cfg = _cfg(snow=True)
    kernel = site.run_site(cfg, climate=_climate(ref, cold=True),
                           engine="kernel", device="cpu")
    assert max(r["max_residual"] for r in kernel.daily) < 0.1
    total_et = sum(r["evap_day"] for r in kernel.daily)
    assert 0.0 < total_et < 4.0 * NDAYS + 2000.0
    assert float(kernel.state.swe[0]) == 0.0        # melted by the end


def test_lclim_end_to_end_cli_on_the_cpu(tmp_path):
    """A reference-format record through ``site --engine kernel
    --device cpu``: the Vaira-2002 phenology pins LAI, evap_obs is a
    column, and the CSV agrees with the oracle engine's."""
    pd, ps = tmp_path / "daily.csv", tmp_path / "sub.csv"
    _write_lclim_daily(pd)
    _write_lclim_subdaily(ps)
    argv = ["site", "--lclim-daily", str(pd), "--lclim-subdaily", str(ps),
            "--lclim-year", "2002", "--nisurf", str(NISURF)]
    rows = {}
    for engine, dev in (("kernel", ["--device", "cpu"]), ("oracle", [])):
        out = tmp_path / f"{engine}.csv"
        assert main(argv + ["--engine", engine, "--csv-out", str(out),
                            *dev]) == 0
        with open(out) as f:
            rows[engine] = list(csv.DictReader(f))
    k = rows["kernel"]
    assert len(k) == 10 and "evap_obs" in k[0]
    assert float(k[0]["lai"]) == pytest.approx(
        site.VAIRA_LAI_WAYPOINTS[2002][1], abs=1e-3)
    for r in k:
        assert np.isfinite(float(r["evap_day"]))
    # The kernel engine runs the production knobs (zd09_every=8, snow)
    # where the oracle is exact: ET agrees to well under a mm a day.
    np.testing.assert_allclose([float(r["evap_day"]) for r in k],
                               [float(r["evap_day"])
                                for r in rows["oracle"]], atol=0.5)


def test_engines_and_devices_that_are_refused():
    with pytest.raises(ValueError):
        site.run_site(_cfg(), climate=_climate(ref, 2), engine="fortran")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            site.run_site(_cfg(), climate=_climate(ref, 2), engine="kernel")
