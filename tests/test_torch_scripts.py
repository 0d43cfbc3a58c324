"""The port's study and soak programs (``hybrid9_tpu_torch.scripts``) and
``utils/profiling``.

Against the JAX package where a program has arithmetic of its own: the
zd09 drift analysis (the JAX program and the port on one seeded npz give
equal JSON), the Vaira record's synthesis and dry-down, the NISURF
study's zig-zag score and ``device_sync``.  The physics under the
programs is held against JAX by the year, switch, assimilation and site
tests.  The port alone, on the CPU at 24 degrees with 1 substep a day:
each program's own checks hold (one year of the soak, the run and each
router's soak; a few days of the DA soak and of the zd09 bisection).
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hybrid9_tpu_torch.data import synthetic
from hybrid9_tpu_torch.data.forcing import (PGF_VARIABLES,
                                            NetCDFForcingProvider,
                                            pgf_decade_path)
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.io import netcdf
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.scripts import (da_soak, flagship_run, flagship_soak,
                                       halo_rehearsal, nisurf_study,
                                       pgf_scale_test,
                                       router_compare, soil_scale_test,
                                       vaira_chain, zd09_cell_probe,
                                       zd09_debug, zd09_drift)
from hybrid9_tpu_torch.state import initial_state
from hybrid9_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# A 24-degree grid (31 land cells in one block of 32) and 1 substep a
# day: a year of the flagship physics in some 5 s on one CPU thread.  The
# programs' own checks (a clean year, a written file) do not depend on the
# substeps.
SMALL = dict(resolution_deg=24.0, cell_block=32, nisurf=1,
             routing_substeps=1)


def _jax_script(name):
    """A JAX program of ``scripts/`` as a module (its import sets no JAX
    state)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_zd09_drift_analysis_matches_jax(tmp_path, monkeypatch):
    """``--from-raw`` on one seeded npz: the JAX program and the port print
    the same verdict, exit alike and write equal JSON; neither touches the
    repository's zd09_drift.json, and the port's default output is
    another file."""
    rng = np.random.RandomState(5)
    years, n = 6, 400
    k1 = {"evap": 500.0 + 40.0 * rng.randn(years, n),     # varying
          "rnf": 100.0 + 10.0 * rng.randn(years, n),      # varying
          "zwt": np.repeat(5.0 + rng.rand(1, n), years, 0),  # static
          "swe": np.zeros((years, n))}                    # inert
    k1["zwt"][:, :20] += 0.5 * rng.randn(years, 20)       # a few vary
    k8 = {f: v.copy() for f, v in k1.items()}
    k8["evap"] += 0.2 * rng.randn(years, n)               # passes
    k8["rnf"] += 3.0 * rng.randn(years, n)                # fails
    k8["zwt"] += 1e-4 * rng.rand(years, n)
    raw = tmp_path / "raw.npz"
    np.savez(raw, **{f"k{k}_{f}": arm[f] for k, arm in ((1, k1), (8, k8))
                     for f in k1})
    record = os.path.join(ROOT, "zd09_drift.json")
    before = _sha(record)

    jax_out = tmp_path / "jax.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    j = subprocess.run([sys.executable, "scripts/zd09_drift.py",
                        "--from-raw", str(raw), "--out", str(jax_out)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    port_out = tmp_path / "port.json"
    rc = zd09_drift.main(["--from-raw", str(raw), "--out", str(port_out)])
    assert rc == j.returncode == 1, j.stdout + j.stderr
    with open(jax_out) as a, open(port_out) as b:
        want, got = json.load(a), json.load(b)
    assert got == want
    verdict = {f: e["passes_bound"]
               for f, e in got["reference"]["fields"].items()}
    assert verdict == {"evap": True, "rnf": False, "swe": True,
                       "zwt": True}
    monkeypatch.chdir(tmp_path)
    assert zd09_drift.main(["--from-raw", str(raw)]) == 1
    with open(tmp_path / "zd09_drift_torch.json") as f:
        assert json.load(f) == want
    assert not (tmp_path / "zd09_drift.json").exists()
    assert _sha(record) == before


def test_tier1_queue_simulates_xdist_loadfile(tmp_path, capsys):
    """``scripts/tier1_queue.py`` on a three-file junit, by hand: the files
    queue by test count (b: 4 tests of 1 s, the port's c: 3 of 3 s, a: 1
    of 6 s); on two workers b and c start at once, b's worker is down to
    2 tests at 2 s and takes a first (3 s would be c's), which starts at
    4 s and ends at 10 s; the floor is 19 s over 2, the port's share
    9 s over 10.  On six workers every file has a worker and c ends
    last, at 9 s."""
    cases = ([("tests.test_b", 1.0)] * 4 + [("tests.test_torch_c", 3.0)] * 3
             + [("tests.test_a", 6.0)])
    xml = tmp_path / "run.xml"
    xml.write_text(
        '<testsuites><testsuite name="pytest">' + "".join(
            f'<testcase classname="{c}" name="t{i}" time="{t}" />'
            for i, (c, t) in enumerate(cases)) + "</testsuite></testsuites>")
    spec = importlib.util.spec_from_file_location(
        "tier1_queue", os.path.join(ROOT, "scripts", "tier1_queue.py"))
    queue = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(queue)
    files = queue.read_junit([str(xml)])
    assert queue.queue(files) == ["tests/test_b.py", "tests/test_torch_c.py",
                                  "tests/test_a.py"]
    assert queue.simulate(files, 2) == {
        "tests/test_b.py": (0, 0.0, 4.0),
        "tests/test_torch_c.py": (1, 0.0, 9.0),
        "tests/test_a.py": (0, 4.0, 10.0)}
    two = queue.summary(files, queue.simulate(files, 2), 2)
    assert (two["floor_s"], two["simulated_end_s"], two["last_file"]) == (
        9.5, 10.0, "tests/test_a.py")
    assert (two["tests"], two["seconds"], two["port_seconds"],
            two["port_share"]) == (8, 19.0, 9.0, 0.9)
    assert queue.main([str(xml)]) == 0
    six = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert six["simulated_end_s"] == 9.0 and six["last_file"] == \
        "tests/test_torch_c.py"
    assert six["floor_s"] == pytest.approx(19.0 / 6)
    assert (six["workers"], six["limit_s"]) == (6, 1470.0)


def test_vaira_chain_synthesis_matches_jax(tmp_path):
    """At seed 11 the port's unit-10 and unit-11 files are byte for byte
    the JAX program's, and the dry-down day is JAX's on the same
    series."""
    j_vaira = _jax_script("vaira_chain")
    want = j_vaira.climatology(np.random.default_rng(11))
    got = vaira_chain.climatology(np.random.default_rng(11))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    paths = {}
    for tag, module, (days, obs, _) in (("jax", j_vaira, want),
                                        ("port", vaira_chain, got)):
        paths[tag] = (tmp_path / f"{tag}_daily.txt",
                      tmp_path / f"{tag}_sub.txt")
        module.write_lclim_files(days, obs, *paths[tag])
    for a, b in zip(paths["jax"], paths["port"]):
        assert a.read_bytes() == b.read_bytes()
    rng = np.random.RandomState(2)
    for series in (want[1], want[1] * rng.uniform(0.5, 1.5, want[1].size),
                   rng.rand(want[1].size)):
        for yi in range(len(vaira_chain.YEARS)):
            assert vaira_chain.drydown_day(series, yi) == \
                j_vaira.drydown_day(series, yi)


def test_nisurf_longest_alternation_matches_jax():
    """The zig-zag score equals the JAX program's on seeded series (the
    JAX module turns on float64 and the CPU when imported, so it runs in
    a child process)."""
    rng = np.random.RandomState(9)
    walk = np.cumsum(rng.randn(365) * 1e-3)
    zigzag = 0.2 + 1e-3 * (-1.0) ** np.arange(365)
    zigzag[100:110] = 0.2
    noisy = zigzag + 5e-5 * rng.randn(365)
    series = [walk, zigzag, noisy, np.zeros(30), rng.rand(50) * 3e-4]
    amps = (1.0e-4, 1.0e-3)
    code = ("import json, sys\n"
            "import numpy as np\n"
            "sys.path.insert(0, 'scripts')\n"
            "import nisurf_study as m\n"
            "series = [np.array(s) for s in json.loads(sys.argv[1])]\n"
            "print(json.dumps([[m.longest_alternation(s, a) for s in "
            "series] for a in json.loads(sys.argv[2])]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, json.dumps([s.tolist() for s in series]),
         json.dumps(amps)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = [[nisurf_study.longest_alternation(s, a) for s in series]
           for a in amps]
    assert got == want
    assert max(max(row) for row in got) > 10     # the zig-zag is seen


def test_profiling_matches_jax():
    """``device_sync`` is the JAX package's float on the same array."""
    from hybrid9_tpu.utils import profiling as j_profiling
    import jax.numpy as jnp

    # Quarter-integer values: both sums are exact in any order.
    x = np.random.RandomState(4).randint(-4000, 4000, (64, 8)) / 4.0
    y = np.ones(3)
    assert profiling.device_sync({"b": torch.tensor(y),
                                  "a": torch.tensor(x, dtype=torch.float32)}
                                 ) == j_profiling.device_sync(
        {"b": jnp.asarray(y), "a": jnp.asarray(x, jnp.float32)})


@pytest.mark.parametrize("program", [
    da_soak, flagship_run, flagship_soak, halo_rehearsal, nisurf_study,
    pgf_scale_test,
    router_compare, soil_scale_test, vaira_chain, zd09_cell_probe,
    zd09_debug, zd09_drift])
def test_programs_need_the_card_unless_asked(program, tmp_path,
                                             monkeypatch):
    """With no ``--device`` a program runs on the card: where there is
    none it raises before any work and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the programs would run on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        program.main([])
    assert os.listdir(tmp_path) == []


def test_flagship_soak_year_is_clean(capsys):
    cfg = dataclasses.replace(flagship_soak.soak_config(1), **SMALL)
    with torch.inference_mode():      # no autograd bookkeeping: faster
        assert flagship_soak.soak(cfg, CPU)
    assert "1 flagship years" in capsys.readouterr().out


def test_flagship_run_writes_its_file(tmp_path):
    out = str(tmp_path / "flagship")
    cfg = dataclasses.replace(flagship_run.flagship_config(1, out), **SMALL,
                              checkpoint_every_years=1)
    with torch.inference_mode():
        s = flagship_run.run_flagship(cfg, CPU)
    assert s["files"] == 1 and os.path.exists(os.path.join(out,
                                                           "axy1901.nc"))
    assert os.path.exists(os.path.join(out, "ckpt", "year_1901.pt"))
    assert s["worst_residual_mm"] < 0.1 and np.isfinite(
        s["final_swe_mean_mm"])


@pytest.mark.parametrize("scheme", router_compare.SCHEMES)
def test_router_compare_soak_is_clean(scheme):
    cfg = dataclasses.replace(router_compare.Config(
        start_year=1901, end_year=1901, routing_scheme=scheme,
        forcing="device-synthetic", write_annual=False), **SMALL)
    with torch.inference_mode():
        s = router_compare.soak_scheme(cfg, CPU)
        assert s["clean"], s
        grid, params = load_soil(cfg, torch.float32, CPU)
        seconds, checksum = router_compare.time_scheme(cfg, grid, params, 2)
    assert seconds > 0.0 and np.isfinite(checksum)


def test_halo_rehearsal_audit_holds(capsys):
    """The rehearsal at 6 degrees (30 rows) in 8 uneven bands of the CPU:
    the census of a routed day is the predicted one and both forms are
    timed."""
    assert halo_rehearsal.main(["--device", "cpu", "--resolution", "6",
                                "--bands", "8", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert '"halo": 112' in out and "audit OK at 30 rows" in out
    assert "grid   routed day" in out and "packed routed day" in out


def test_da_soak_health_checks_hold(capsys):
    """A few cycles at 24 degrees: the posterior is finite, the never
    observed cells keep their prior draw bitwise, no spread grows and none
    collapses."""
    cfg = router_compare.Config(**SMALL)
    args = da_soak.arguments(["--days", "3", "--members", "4", "--device",
                              "cpu"])
    failures = da_soak.soak(cfg, args, CPU)
    out = capsys.readouterr().out
    assert failures == [], out
    assert "[ok] unobserved cells bit-static" in out
    assert "4 members x 32 cells" in out


def test_zd09_debug_matrix_and_cell_probe(tmp_path, monkeypatch):
    """A few reference-scope days stay finite; on the last state the
    isolation matrix runs the twin at k=8 and k=1 (finite, the two
    cadences apart); the cell probe replays a column of that state's
    snapshot substep by substep."""
    cfg = dataclasses.replace(zd09_debug.debug_config(), resolution_deg=24.0,
                              cell_block=32, nisurf=8)
    grid, params = load_soil(cfg, torch.float32, CPU)
    lg = cfg.layer_grid()
    state = initial_state(params, lg.dz, lg.zi, torch.float32, CPU)
    geom = Geometry.from_layer_grid(lg)
    provider = zd09_debug.SyntheticForcingProvider(
        grid.n_padded, seed=0, lat=grid.cell_lat, device=CPU)
    found, prev, f_day, new_state, days = zd09_debug.scan(
        cfg, params, geom, state, provider, grid.n_land, max_days=3)
    assert found is None and days == 3
    twin = tuple(row for row in zd09_debug.MATRIX if not row[2])
    matrix = zd09_debug.isolation_matrix(prev, f_day, params, geom, cfg,
                                         twin)
    assert set(matrix) == {"k=8 twin", "k=1 twin"}
    for st, diags in matrix.values():
        assert bool(zd09_debug.finite_cells(st).all())
        assert float(diags["max_abs_residual"].max()) < 0.1
    assert torch.equal(matrix["k=8 twin"][0].soil.zwt, new_state.soil.zwt)
    assert not torch.equal(matrix["k=1 twin"][0].soil.h2osoi_liq,
                           matrix["k=8 twin"][0].soil.h2osoi_liq)

    snap = dict(h2osoi=prev.soil.h2osoi_liq, zwt=prev.soil.zwt,
                wa=prev.soil.wa, smp=prev.soil.smp, lai=prev.veg.lai,
                lai_litter=prev.veg.lai_litter, rootr=prev.veg.rootr,
                **{f"forc_{k}": getattr(f_day, k)
                   for k in zd09_cell_probe.FORCING_KEYS})
    snap = {k: v.numpy() for k, v in snap.items()}
    for k in (8, 1):
        rows = zd09_cell_probe.probe(snap, params, cfg, 3, k)
        assert len(rows) == cfg.nisurf
        assert sum(r["refreshed"] for r in rows) == cfg.nisurf // k
        assert all(np.isfinite(r["wa"]) and abs(r["residual"]) < 0.1
                   for r in rows)


def test_archive_writers_without_h5py(tmp_path, monkeypatch):
    """Without ``h5py`` the raw soil archive is NetCDF-3 with the HDF5
    archive's names and values (and ``prepare_soil``'s product is the
    same); the PGF scale test's NetCDF-3 decade files read back through
    ``NetCDFForcingProvider`` as the packed synthetic fields."""
    pytest.importorskip("h5py")
    kw = dict(resolution_deg=12.0, factor=3, n_layers=2, seed=11,
              band_coarse_rows=4)
    hdf = synthetic.synthesize_raw_soil_archive(str(tmp_path / "h5"), **kw)
    monkeypatch.setitem(sys.modules, "h5py", None)
    nc3 = synthetic.synthesize_raw_soil_archive(str(tmp_path / "nc3"), **kw)
    monkeypatch.undo()
    for name in sorted(os.listdir(hdf["bnu_dir"])):
        if not name.endswith(".nc4"):
            continue
        var = name.split("_l")[0]
        a, b = (os.path.join(d["bnu_dir"], name) for d in (hdf, nc3))
        with open(b, "rb") as f:
            assert f.read(3) == b"CDF"
        assert netcdf.variable_shape(a, var) == netcdf.variable_shape(b, var)
        np.testing.assert_array_equal(
            netcdf.read_variable(a, var, (slice(6, 15),)),
            netcdf.read_variable(b, var, (slice(6, 15),)))
    from hybrid9_tpu_torch.data.soil_raw import prepare_soil
    prods = [prepare_soil(d["hwsd"], d["bnu_dir"],
                          str(tmp_path / f"{tag}.nc"), n_layers=2,
                          fmax_path=d["fmax"])
             for tag, d in (("h5", hdf), ("nc3", nc3))]
    for name in ("theta_s", "hksat", "psi_s"):
        np.testing.assert_array_equal(
            *(netcdf.read_grid_file(p, [name])[name] for p in prods))

    base = str(tmp_path / "pgf")
    ny, nx, ndays = 15, 30, 70
    pgf_scale_test.make_archive(base, ndays=ndays, ny=ny, nx=nx)
    cfg = dataclasses.replace(pgf_scale_test.pgf_config(base, 1),
                              resolution_deg=12.0, cell_block=32)
    grid, _ = load_soil(cfg, torch.float32, CPU)
    assert sorted(os.listdir(base)) == sorted(
        os.path.basename(pgf_decade_path(base, v, 1901))
        for v in PGF_VARIABLES)
    block = NetCDFForcingProvider(base, grid, torch.float32,
                                  CPU).host_block(1901, 60, 10)
    lat = 90.0 - 0.25 - 0.5 * np.arange(ny)
    lat2d = np.repeat(lat[:, None], nx, 1).astype(np.float32)
    bank = np.random.RandomState(0).standard_normal(
        (16, ny, nx)).astype(np.float32)
    for d in range(10):
        want = pgf_scale_test.synth_day_fields(60 + d, lat2d, bank)
        for var, x in block.items():
            np.testing.assert_array_equal(
                x[d, :grid.n_land],
                want[var].astype(np.float32).reshape(-1)[grid.land_idx])
