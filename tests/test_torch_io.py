"""The port's host I/O and forcing against the JAX package.

Mirrors the I/O tests of test_infra.py, test_forcing_netcdf.py,
test_soil_raw.py and test_native.py: the calendar and PGF paths, NetCDF
files written by one package and read by the other, Config files, the
NetCDF and synthetic forcing providers and the prefetch, soil from a
preprocessed file and from a raw archive, routing networks from files,
the native host library, checkpoints, the annual and focus writers, and
the device forcing generator, including the ``(seed, year)`` keying it
shares with the JAX package.
"""

import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu import calendar as j_calendar
from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.data import forcing as j_forcing
from hybrid9_tpu.data.device_forcing import generate_block as j_generate
from hybrid9_tpu.data.soil import load_soil as j_load_soil
from hybrid9_tpu.data.synthetic import \
    synthesize_raw_soil_archive as j_synthesize_raw_soil_archive
from hybrid9_tpu.grids import routing as j_net
from hybrid9_tpu.grids.grid import make_land_grid as j_make_land_grid
from hybrid9_tpu.io import native as j_native
from hybrid9_tpu.io import netcdf as j_netcdf
from hybrid9_tpu.io.writer import FocusCSVWriter as JFocusCSVWriter
from hybrid9_tpu_torch import calendar
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data import device_forcing, forcing
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import synthesize_raw_soil_archive
from hybrid9_tpu_torch.grids import routing as t_net
from hybrid9_tpu_torch.grids.grid import (cell_centres, make_land_grid,
                                          synthetic_land_mask)
from hybrid9_tpu_torch.io import native, netcdf
from hybrid9_tpu_torch.io.checkpoint import Checkpointer
from hybrid9_tpu_torch.io.writer import (AnnualWriter, FocusCSVWriter,
                                         to_host)
from hybrid9_tpu_torch.parallel.sharding import CellSharding
from hybrid9_tpu_torch.state import SoilParams, initial_state

from _torch_port import tree_np

T32, T64 = torch.float32, torch.float64


def _equal(a: dict, b: dict) -> bool:
    """Two dicts of numpy arrays are equal, key by key and bit by bit."""
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


# --- calendar, paths, Config ----------------------------------------------

def test_calendar_matches_jax():
    assert np.array_equal(calendar.time_boy_table(),
                          j_calendar.time_boy_table())
    for year in (1860, 1900, 1901, 1904, 2000, 2011, 2012, 2100, 2300):
        assert calendar.days_in_year(year) == j_calendar.days_in_year(year)
        assert calendar.time_boy(year) == j_calendar.time_boy(year)
    for idec in range(1, 13):
        assert calendar.decade_year_span(idec) \
            == j_calendar.decade_year_span(idec)
    assert calendar.decade_year_span(12) == (2011, 2012)
    with pytest.raises(ValueError):
        calendar.time_boy(1859)
    with pytest.raises(ValueError):
        calendar.decade_of_year(1900)


def test_pgf_decade_path_matches_jax():
    for year in (1901, 1905, 1910, 1911, 2011, 2012):
        for var in forcing.PGF_VARIABLES:
            assert forcing.pgf_decade_path("/d", var, year) \
                == j_forcing.pgf_decade_path("/d", var, year)
    assert forcing.pgf_decade_path("/d", "pr", 2011) \
        == "/d/pr_pgfv2.1_2011_2012.nc4"
    assert forcing.PGF_VARIABLES == j_forcing.PGF_VARIABLES


def test_config_json_round_trip_and_jax_files(caplog):
    cfg = Config(dtype="float64", start_year=1950, zi_mm=(0.0, 10.0, 50.0),
                 forcing="pgf", forcing_path="/f/{var}.nc", use_kernel=False)
    assert Config.from_json(cfg.to_json()) == cfg
    jcfg = JConfig(dtype="float64", resolution_deg=4.0, end_year=1920,
                   use_pallas=True, donate_state=True, interactive=True,
                   routing_manning=0.05, lateral_k=2e-6, zd09_every=1)
    with caplog.at_level(logging.INFO, logger="hybrid9_tpu_torch"):
        got = Config.from_json(jcfg.to_json())
    dropped = [r for r in caplog.records if "TPU-only" in r.getMessage()]
    assert len(dropped) == 1
    for f in dataclasses.fields(got):
        if f.name != "use_kernel":
            assert getattr(got, f.name) == getattr(jcfg, f.name), f.name
    assert got.use_kernel is None
    with pytest.raises(ValueError, match="unknown keys"):
        Config.from_json(json.dumps(dict(json.loads(cfg.to_json()),
                                         nisurff=3)))


# --- NetCDF files and the native library ----------------------------------

def test_netcdf_files_cross_between_the_packages(tmp_path):
    lon, lat = cell_centres(12.0)
    rng = np.random.RandomState(0)
    f2 = rng.rand(lat.size, lon.size)
    f2[0, :3] = np.nan
    f3 = rng.rand(lat.size, lon.size, 4)
    for write, read, name in ((netcdf.write_grid_file,
                               j_netcdf.read_grid_file, "port.nc"),
                              (j_netcdf.write_grid_file,
                               netcdf.read_grid_file, "jax.nc")):
        path = str(tmp_path / name)
        write(path, {"a": f2, "b": f3}, lon, lat, units={"a": "mm"},
              layer_dim=4)
        back = read(path, ["a", "b"])
        np.testing.assert_array_equal(
            back["a"], np.where(np.isfinite(f2), f2.astype(np.float32), np.nan))
        np.testing.assert_array_equal(back["b"], f3.astype(np.float32))
        assert netcdf.variable_shape(path, "b") == (4, lat.size, lon.size)
    with open(tmp_path / "port.nc", "rb") as a, \
            open(tmp_path / "jax.nc", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("with_library", [True, False],
                         ids=["library", "numpy"])
def test_native_functions_match_jax(monkeypatch, with_library):
    if not with_library:
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    rng = np.random.RandomState(1)
    fine = rng.rand(60, 120)
    fine[::7, ::3] = np.nan
    np.testing.assert_allclose(native.box_average(fine, 6),
                               j_native.box_average(fine, 6), rtol=1e-12,
                               equal_nan=True)
    idx = np.sort(rng.choice(5000, 700, replace=False)).astype(np.int64)
    for dtype in (np.float32, np.float64):
        src = rng.rand(5000).astype(dtype)
        packed = native.pack_gather(src, idx, 768, fill=-5.0)
        assert np.array_equal(packed, j_native.pack_gather(src, idx, 768,
                                                           fill=-5.0))
        assert np.array_equal(native.scatter(packed, idx, 5000),
                              j_native.scatter(packed, idx, 5000),
                              equal_nan=True)
    brick = rng.rand(3, 50, 100)
    assert np.array_equal(native.pack_forcing_block(brick, idx, 768)[:, :700],
                          j_native.pack_forcing_block(brick, idx,
                                                      768)[:, :700])


# --- forcing providers ------------------------------------------------------

@pytest.fixture(scope="module")
def pgf_archive(tmp_path_factory):
    """A tiny PGF-like archive: one NetCDF-3 file per variable,
    [time, lat, lon], and the land grid it is read onto."""
    tmp = tmp_path_factory.mktemp("pgf")
    mask = synthetic_land_mask(resolution_deg=12.0, seed=2)
    ny, nx = mask.shape
    rng = np.random.RandomState(0)
    from scipy.io import netcdf_file
    for var in forcing.PGF_VARIABLES:
        arr = rng.rand(25, ny, nx).astype(np.float32) * 100.0 + 200.0
        with netcdf_file(str(tmp / f"{var}_1901.nc"), "w") as f:
            f.createDimension("time", 25)
            f.createDimension("lat", ny)
            f.createDimension("lon", nx)
            f.createVariable(var, "f", ("time", "lat", "lon"))[:] = arr
    return str(tmp / "{var}_{year}.nc"), mask


@pytest.mark.parametrize("dtype", [T32, T64], ids=["f32", "f64"])
def test_netcdf_provider_is_bitwise_jaxs(pgf_archive, dtype):
    pattern, mask = pgf_archive
    grid = make_land_grid(mask, 12.0, pad_multiple=32)
    jgrid = j_make_land_grid(mask, 12.0, pad_multiple=32)
    jd = jnp.float32 if dtype == T32 else jnp.float64
    got = forcing.NetCDFForcingProvider(pattern, grid, dtype=dtype,
                                        device="cpu")(1901, 3, 5)
    want = j_forcing.NetCDFForcingProvider(pattern, jgrid,
                                           dtype=jd)(1901, 3, 5)
    for k in forcing.PGF_VARIABLES:
        g = tree_np(getattr(got, k))
        assert g.dtype == np.dtype(jd) and g.shape == (5, grid.n_padded)
        assert np.array_equal(g, np.asarray(getattr(want, k))), k
    n = grid.n_padded
    slabs = [(0, n // 2), (n // 2, n), (n - 8, n)]
    for lo, hi in slabs:
        p = forcing.NetCDFForcingProvider(pattern, grid, dtype=dtype,
                                          device="cpu", cell_range=(lo, hi))
        jp = j_forcing.NetCDFForcingProvider(pattern, jgrid, dtype=jd,
                                             cell_range=(lo, hi))
        assert (p.row_lo, p.row_hi, p.n_real) == (jp.row_lo, jp.row_hi,
                                                  jp.n_real)
        g, w = p(1901, 1, 6), jp(1901, 1, 6)
        for k in forcing.PGF_VARIABLES:
            assert np.array_equal(tree_np(getattr(g, k)),
                                  np.asarray(getattr(w, k))), (lo, k)


def test_synthetic_provider_and_prefetch(pgf_archive):
    """The host synthetic provider is JAX's block rounded alike; the
    prefetched block equals the direct one; the prefetch thread does not
    outlive ``close``."""
    lat = np.linspace(-50.0, 70.0, 40)
    for dtype, jd in ((T32, jnp.float32), (T64, jnp.float64)):
        got = forcing.SyntheticForcingProvider(40, seed=2, lat=lat,
                                               dtype=dtype,
                                               device="cpu")(1903, 40, 3)
        want = j_forcing.SyntheticForcingProvider(40, seed=2, lat=lat,
                                                  dtype=jd)(1903, 40, 3)
        assert np.array_equal(tree_np(got.tas), np.asarray(want.tas))
        assert np.array_equal(tree_np(got.pr), np.asarray(want.pr))
    inner = forcing.SyntheticForcingProvider(40, seed=2, lat=lat,
                                             device="cpu")
    pre = forcing.PrefetchingProvider(inner)
    pre.prefetch(1903, 40, 3)
    pre.prefetch(1903, 40, 3)
    assert len(pre._pending) == 1
    got = pre(1903, 40, 3)
    assert not pre._pending
    assert _equal(tree_np(got), tree_np(inner(1903, 40, 3)))
    assert np.array_equal(tree_np(pre(1903, 41, 2).rhs),
                          tree_np(inner(1903, 41, 2).rhs))
    pattern, mask = pgf_archive
    grid = make_land_grid(mask, 12.0, pad_multiple=32)
    nc = forcing.PrefetchingProvider(forcing.NetCDFForcingProvider(
        pattern, grid, device="cpu"))
    nc.prefetch(1901, 1, 10)
    assert np.array_equal(tree_np(nc(1901, 1, 10).pr),
                          tree_np(nc.provider(1901, 1, 10).pr))
    for p in (pre, nc):
        p.close()
        assert all(not t.is_alive() for t in p._pool._threads)


def test_providers_default_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forcing.SyntheticForcingProvider(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_forcing.DeviceSyntheticForcingProvider(8)
    # A rank's provider delivers its slab on its device, and only that.
    slab = CellSharding(lo=4, hi=8, n=8, devices=(torch.device("cpu"),),
                        rank=1, world=2)
    whole = forcing.SyntheticForcingProvider(8, device="cpu")
    mine = forcing.SyntheticForcingProvider(8, device="cpu",
                                            cell_slice=slice(4, 8))
    block = forcing.HostShardedProvider(mine, slab, 8)(1901, 1, 3)
    assert np.array_equal(tree_np(block.tas), tree_np(whole(1901, 1, 3).tas)[
        :, 4:8])
    with pytest.raises(ValueError, match="a block of 8 cells"):
        forcing.HostShardedProvider(whole, slab, 8)(1901, 1, 3)


# --- the device generator ---------------------------------------------------

def test_device_generator_is_deterministic_and_physical():
    lat = np.linspace(-55.0, 65.0, 4000)
    p = device_forcing.DeviceSyntheticForcingProvider(4000, seed=3, lat=lat,
                                                      device="cpu")
    a, b = p(1901, 150, 20), p(1901, 150, 20)
    assert _equal(tree_np(a), tree_np(b))
    c = p(1902, 150, 20)
    assert not np.array_equal(tree_np(a.tas), tree_np(c.tas))
    f = tree_np(a)
    assert all(v.shape == (20, 4000) and v.dtype == np.float32
               and np.isfinite(v).all() for v in f.values())
    # The formulas' ranges and clips, and the noise's moments.
    days = 150 + np.arange(20)[:, None]
    phase = 2.0 * np.pi * (days - 15) / 365.0
    season = np.cos(phase) * np.where(lat >= 0.0, -1.0, 1.0)
    tas_noise = f["tas"] - (288.0 - 0.4 * np.abs(lat) + 10.0 * season)
    assert abs(tas_noise.mean()) < 0.05 and abs(tas_noise.std() - 2.0) < 0.05
    assert f["rsds"].min() >= 5.0 and f["rsds"].max() <= 420.0
    assert f["rlds"].min() >= 120.0 and f["rlds"].max() <= 460.0
    assert f["rhs"].min() >= 20.0 and f["rhs"].max() <= 100.0
    wet = f["pr"] > 0.0
    assert abs(wet.mean() - 0.35) < 0.01
    assert abs(f["pr"][wet].mean() - 6.0e-5) < 3.0e-6
    np.testing.assert_allclose(f["ps"], np.broadcast_to(
        101325.0 - 40.0 * np.abs(lat), (20, 4000)), rtol=1e-6)
    assert (f["huss"] > 0.0).all() and (f["huss"] < 0.05).all()
    f64 = tree_np(device_forcing.DeviceSyntheticForcingProvider(
        4000, seed=3, lat=lat, dtype=T64, device="cpu")(1901, 150, 20))
    assert f64["tas"].dtype == np.float64


@pytest.mark.parametrize("package", ["jax", "port"])
def test_device_generator_keys_by_seed_and_year_only(package):
    """The keying both packages share: the noise of a block is keyed by
    ``(seed, year)`` and its length alone, so two blocks of one length in
    one year draw the same weather noise.  Precipitation has no seasonal
    term and comes out equal; temperature differs by the seasonal term
    only."""
    lat = np.linspace(-55.0, 65.0, 64)
    if package == "jax":
        def gen(start, n, year=1901):
            return tree_np(j_generate(0, year, start, n, 64,
                                      jnp.asarray(lat, jnp.float32)))
    else:
        t_lat = torch.tensor(lat, dtype=T32)

        def gen(start, n, year=1901):
            return tree_np(device_forcing.generate_block(0, year, start, n,
                                                         64, t_lat))
    a, b = gen(1, 30), gen(31, 30)
    assert np.array_equal(a["pr"], b["pr"])
    phase = 2.0 * np.pi * (np.arange(30)[:, None] - 14) / 365.0
    sign = np.where(lat >= 0.0, -1.0, 1.0)
    shift = 10.0 * (np.cos(phase + 2.0 * np.pi * 30 / 365.0)
                    - np.cos(phase)) * sign
    np.testing.assert_allclose(b["tas"] - a["tas"], shift, atol=2e-3)
    assert not np.array_equal(a["pr"], gen(1, 30, year=1902)["pr"])


# --- soil and networks from files -------------------------------------------

def _soil_file(path, res=12.0, seed=0):
    rng = np.random.RandomState(seed)
    lon, lat = cell_centres(res)
    ny, nx = lat.size, lon.size
    fields = dict(soil_tex=rng.randint(0, 14, (ny, nx)).astype(np.float64),
                  theta_s=rng.uniform(0.3, 0.5, (ny, nx, 8)),
                  hksat=rng.uniform(1e-4, 1e-2, (ny, nx, 8)),
                  **{"lambda": rng.uniform(0.1, 0.4, (ny, nx, 8))},
                  psi_s=-rng.uniform(100.0, 700.0, (ny, nx, 8)),
                  fmax=rng.uniform(0.1, 0.5, (ny, nx)))
    fields["fmax"][0, :4] = np.nan    # missing: the reference's default
    netcdf.write_grid_file(path, fields, lon, lat, layer_dim=8)
    return fields


def _same_soil(got, want):
    (grid, params), (jgrid, jparams) = got, want
    assert np.array_equal(grid.land_idx, jgrid.land_idx)
    assert grid.n_padded == jgrid.n_padded
    assert np.array_equal(grid.soil_tex, jgrid.soil_tex)
    p, jp = tree_np(params), tree_np(jparams)
    for k in jp:
        assert np.array_equal(p[k], jp[k]), k


def test_load_soil_from_netcdf_matches_jax(tmp_path):
    path = str(tmp_path / "soil.nc")
    fields = _soil_file(path)
    kw = dict(resolution_deg=12.0, soil_source="netcdf", soil_path=path,
              cell_block=32)
    got = load_soil(Config(**kw), T32, "cpu")
    _same_soil(got, j_load_soil(JConfig(**kw), jnp.float32))
    grid, params = got
    assert grid.n_land == ((fields["soil_tex"] > 0)
                           & (fields["soil_tex"] != 13)).sum()
    fmax = tree_np(params.fmax)[:grid.n_land]
    assert np.isfinite(fmax).all() and (fmax == np.float32(0.3809)).any()


def _raw_kw(arch):
    return dict(resolution_deg=12.0, soil_source="raw", cell_block=32,
                soil_hwsd_path=arch["hwsd"], soil_bnu_dir=arch["bnu_dir"],
                soil_fmax_path=arch["fmax"])


def test_raw_soil_archive_is_bitwise_jaxs(tmp_path):
    h5py = pytest.importorskip("h5py")
    kw = dict(resolution_deg=12.0, factor=6, n_layers=8, seed=3)
    got = synthesize_raw_soil_archive(str(tmp_path / "port"), **kw)
    want = j_synthesize_raw_soil_archive(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(want["bnu_dir"]))
    assert sorted(os.listdir(got["bnu_dir"])) == names and len(names) == 34
    for name in names:
        a, b = (os.path.join(d, name) for d in (got["bnu_dir"],
                                                 want["bnu_dir"]))
        if name.endswith(".nc4"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert list(fa) == list(fb)
                assert all(np.array_equal(fa[k][()], fb[k][()], equal_nan=True)
                           for k in fa), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    for k in ("mask", "soil_tex"):
        assert np.array_equal(got[k], want[k])
    assert all(np.array_equal(got["truth"][k], want["truth"][k],
                              equal_nan=True) for k in want["truth"])


def test_load_soil_from_raw_archive_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    kw = dict(resolution_deg=12.0, factor=6, n_layers=8, seed=3)
    got = load_soil(Config(output_path=str(tmp_path / "port"), **_raw_kw(
        synthesize_raw_soil_archive(str(tmp_path / "raw"), **kw))), T64,
        "cpu")
    want = j_load_soil(JConfig(output_path=str(tmp_path / "jax"), **_raw_kw(
        j_synthesize_raw_soil_archive(str(tmp_path / "jraw"), **kw))),
        jnp.float64)
    _same_soil(got, want)
    assert os.path.exists(tmp_path / "port" / "soil_prep.nc")
    with pytest.raises(ValueError, match="soil_hwsd_path"):
        load_soil(Config(soil_source="raw"), T32, "cpu")


def _network_file(path, grid, which, seed=0):
    rng = np.random.RandomState(seed)
    fields = {}
    if "flowdir" in which:
        codes = np.array([0, 1, 2, 4, 8, 16, 32, 64, 128, 3], np.float64)
        flow = codes[rng.randint(0, codes.size, (grid.ny, grid.nx))]
        flow[0, 0] = np.nan
        fields["flowdir"] = flow
    if "elevation" in which:
        fields["elevation"] = rng.uniform(0.0, 3000.0, (grid.ny, grid.nx))
    netcdf.write_grid_file(path, fields, grid.lon, grid.lat)


@pytest.mark.parametrize("which", [("flowdir",), ("elevation",),
                                   ("flowdir", "elevation")],
                         ids=lambda w: "+".join(w))
def test_load_network_from_a_file_matches_jax(tmp_path, which):
    mask = synthetic_land_mask(12.0, seed=1)
    grid = make_land_grid(mask, 12.0, 32)
    jgrid = j_make_land_grid(mask, 12.0, 32)
    path = str(tmp_path / "net.nc")
    _network_file(path, grid, which)
    down, elev = t_net.load_network(grid, path)
    j_down, j_elev = j_net.load_network(jgrid, path)
    assert down.dtype == np.int32 and np.array_equal(down, j_down)
    assert (elev is None) == (j_elev is None)
    if elev is not None:
        assert np.array_equal(elev, j_elev)
    n = grid.n_land
    assert ((down[:n] >= 0) & (down[:n] <= grid.n_padded)).all()
    assert (down[n:] == grid.n_padded).all()
    assert np.array_equal(t_net.direction_codes(grid, down),
                          j_net.direction_codes(jgrid, j_down))


def test_flowdir_cycles_go_to_the_outlet():
    mask = np.zeros((15, 30), bool)
    mask[5, 10:13] = True
    grid = make_land_grid(mask, 12.0, 4)
    flow = np.zeros((15, 30))
    flow[5, 10], flow[5, 11], flow[5, 12] = 1, 16, 16   # E, W, W: a cycle
    down = t_net.downstream_from_flowdir(grid, flow)
    assert np.array_equal(down, j_net.downstream_from_flowdir(
        j_make_land_grid(mask, 12.0, 4), flow))
    assert down[0] == down[1] == grid.n_padded and down[2] == 1
    with pytest.raises(ValueError, match="flowdir shape"):
        t_net.downstream_from_flowdir(grid, flow[:3])


def test_network_file_needs_a_variable(tmp_path):
    grid = make_land_grid(synthetic_land_mask(12.0), 12.0, 32)
    path = str(tmp_path / "empty.nc")
    netcdf.write_grid_file(path, {"other": np.zeros((grid.ny, grid.nx))},
                           grid.lon, grid.lat)
    with pytest.raises(ValueError, match="flowdir"):
        t_net.load_network(grid, path)


# --- checkpoints ------------------------------------------------------------

def _state(dtype, n=16):
    from hybrid9_tpu_torch.data.synthetic import synthetic_soil_params
    lg = Config().layer_grid()
    params = SoilParams.from_numpy(synthetic_soil_params(n, seed=0), dtype,
                                   "cpu")
    state = initial_state(params, lg.dz, lg.zi, dtype, "cpu")
    rng = np.random.RandomState(0)
    return state.map(lambda x: x + torch.as_tensor(
        rng.uniform(0.0, 1.0, tuple(x.shape)), dtype=x.dtype)), params, lg


@pytest.mark.parametrize("dtype", [T32, T64], ids=["f32", "f64"])
def test_checkpoint_round_trip(tmp_path, dtype):
    state, params, lg = _state(dtype)
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.latest_year() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(state)
    for year in (1901, 1902, 1903, 1904):
        ck.save(year, state)
    ck.wait()
    assert ck.years() == [1902, 1903, 1904] and ck.latest_year() == 1904
    template = initial_state(params, lg.dz, lg.zi, dtype, "cpu")
    year, got = Checkpointer(str(tmp_path / "ck")).restore(template)
    assert year == 1904
    a, b = tree_np(got), tree_np(state)
    leaves = jax_free_leaves(a), jax_free_leaves(b)
    assert all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(*leaves))
    assert not any(n.endswith(".tmp") for n in os.listdir(ck.path))
    # Restored onto another dtype: cast like the template.
    other = T64 if dtype == T32 else T32
    _, cast = ck.restore(initial_state(params.map(lambda x: x.to(other)),
                                       lg.dz, lg.zi, other, "cpu"), 1903)
    assert cast.soil.h2osoi_liq.dtype == other
    np.testing.assert_array_equal(tree_np(cast.soil.zwt),
                                  tree_np(state.soil.zwt).astype(
                                      tree_np(cast.soil.zwt).dtype))
    # A checkpoint of one process is refused by a rank of two.
    rank1 = CellSharding(lo=4, hi=8, n=8, devices=(torch.device("cpu"),),
                         rank=1, world=2)
    with pytest.raises(ValueError, match="written by 1 rank.*has 2"):
        ck.restore(template, sharding=rank1)
    ck.close()


def jax_free_leaves(tree):
    return [x for v in tree.values()
            for x in (jax_free_leaves(v) if isinstance(v, dict) else [v])]


def test_checkpoint_schema_migration(tmp_path):
    """A file written before a state field existed restores that field
    from the template (the snowpack temperatures at freezing, not 0 K);
    a field the state no longer has is dropped; a nested field lost on
    its own is filled alone."""
    from hybrid9_tpu_torch.physics import constants as c
    state, params, lg = _state(T32)
    ck = Checkpointer(str(tmp_path / "old"))
    ck.save(1904, state)
    path = os.path.join(ck.path, "year_1904.pt")
    raw = torch.load(path, weights_only=True)
    for k in ("swe", "h2osoi_ice", "snowpack"):
        raw["state"].pop(k)
    raw["state"]["carbon"].pop("c_soil_slow")
    raw["state"]["retired_field"] = torch.zeros(16)
    torch.save(raw, path)
    template = initial_state(params, lg.dz, lg.zi, T32, "cpu")
    year, got = ck.restore(template)
    assert year == 1904
    assert torch.equal(got.soil.h2osoi_liq, state.soil.h2osoi_liq)
    assert torch.equal(got.carbon.c_litter, state.carbon.c_litter)
    assert torch.equal(got.swe, template.swe)
    assert torch.equal(got.h2osoi_ice, template.h2osoi_ice)
    assert torch.equal(got.carbon.c_soil_slow, template.carbon.c_soil_slow)
    assert float(got.snowpack.t_surf.min()) == pytest.approx(c.TF)


# --- writers -----------------------------------------------------------------

def test_to_host_takes_one_copy_of_every_field():
    x = torch.arange(12, dtype=T32).reshape(4, 3)
    y = torch.arange(4, dtype=T64)
    z = np.ones(4)
    out = to_host(dict(x=x, y=y, z=z))
    assert list(out) == ["x", "y", "z"]
    assert out["x"].dtype == np.float64 and out["x"].shape == (4, 3)
    assert np.array_equal(out["x"], x.numpy()) and np.array_equal(
        out["y"], y.numpy()) and np.array_equal(out["z"], z)


def test_annual_writer_takes_tensors_or_numpy(tmp_path):
    grid = make_land_grid(synthetic_land_mask(12.0), 12.0, 32)
    rng = np.random.RandomState(0)
    means = dict(theta=rng.rand(grid.n_padded, 8),
                 tas=rng.rand(grid.n_padded))
    a = AnnualWriter(str(tmp_path / "np"), grid).write_annual(1901, means)
    b = AnnualWriter(str(tmp_path / "t"), grid).write_annual(
        1901, {k: torch.tensor(v) for k, v in means.items()})
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_focus_writer_writes_jaxs_csv(tmp_path):
    rng = np.random.RandomState(0)
    rows = {k: rng.rand(3) for k in FocusCSVWriter.COLUMNS[2:]}
    wt = rng.rand(3, 4)
    j = JFocusCSVWriter(str(tmp_path / "jax"))
    j.append(1901, 5, dict(rows, wt_substeps=wt))
    j.close()
    t = FocusCSVWriter(str(tmp_path / "port"))
    t.append(1901, 5, {**{k: torch.tensor(v) for k, v in rows.items()},
                       "wt_substeps": torch.tensor(wt)})
    t.close()
    for name in ("focus_daily.csv", "focus_wt.csv"):
        with open(tmp_path / "jax" / name) as fj, \
                open(tmp_path / "port" / name) as ft:
            assert fj.read() == ft.read()
