"""Real multi-process runs of the port on the CPU (``torch.distributed``
over gloo), against one process and the JAX package.

The Config is ``tests/test_multiprocess.py``'s ``CFG`` with the dense
kinematic router on (two routing substeps) and float64: the 12-degree
grid, at ``nisurf=2`` (that file's 4 halved: ranks and slabs do not
depend on the substeps).  Every child runs under ``ATEN_CPU_CAPABILITY=
default``: with AVX kernels a cell's last bit depends on its place in
the tensor (ROADMAP §C), which would part a slab from the whole axis.

* ``run --shard`` as 2 ranks writes 1901 and a resumed 1902 bitwise the
  one-process run's (files, and every annual mean in float64, which the
  children record), with one set of focus CSVs and no part file left;
  the one-process year is the JAX package's ``Simulation.run`` at rtol
  1e-9 (one JAX year in this process while the children run); a
  checkpoint of 2 ranks is refused by 1.
* ``ensemble --shard`` and ``assimilate --shard`` as 2 ranks are bitwise
  the one-process commands; ``calibrate --per-cell --shard`` agrees at
  rtol 1e-9 (its loss sums in another order).
* With ``soil_source="raw"`` rank 0 regrids the archive and rank 1 waits
  for the file.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.data.forcing import SyntheticForcingProvider as JProvider
from hybrid9_tpu.data.soil import load_soil as j_load_soil
from hybrid9_tpu.io.writer import AnnualWriter as JAnnualWriter
from hybrid9_tpu.run import Simulation as JSimulation
from hybrid9_tpu_torch.cli import main
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.data.synthetic import synthesize_raw_soil_archive

from _torch_port import read_nc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(resolution_deg=12.0, start_year=1901, end_year=1901,
           forcing_block_days=366, cell_block=32, nisurf=2,
           frozen_soil=False, snow=False, lateral_routing=True,
           routing_substeps=2, lateral_groundwater=False,
           checkpoint_every_years=1, dtype="float64")
LOOP = (["ensemble", "--members", "4", "--days", "4"],
        ["assimilate", "--members", "4", "--days", "3", "--obs-twin", "0.5"],
        ["calibrate", "--per-cell", "--days", "2", "--steps", "2",
         "--obs-twin", "0.4", "--fields", "hksat"])
OUT = {"ensemble": "ensemble.nc", "assimilate": "assimilate.npz",
       "calibrate": "calibrate.npz"}
TIMEOUT_S = 300

# A rank's driver: the given commands in turn through ``cli.main`` (a
# ["load_soil", config] step loads the soil alone), every year's float64
# annual means recorded per rank.
CHILD = r"""
import json, os, sys
import numpy as np
import torch
from hybrid9_tpu_torch import cli, run
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.parallel.launch import initialize_distributed

run_year = run.Simulation.run_year

def recorded(self, year, *args, **kwargs):
    means = run_year(self, year, *args, **kwargs)
    np.savez(os.path.join(self.cfg.output_path,
                          f"means{year}.{self.host_lo}.npz"), **means)
    return means

run.Simulation.run_year = recorded
for argv in json.loads(sys.argv[1]):
    if argv[0] == "load_soil":
        initialize_distributed()
        with open(argv[1]) as f:
            grid, params = load_soil(Config.from_json(f.read()),
                                     torch.float64, "cpu")
        print("soil", grid.n_land, repr(float(params.hksat.sum())))
    else:
        assert cli.main(argv) == 0, argv
"""


def _config(root, name, **kw):
    """A Config file written by the JAX package."""
    cfg = JConfig(**{**CFG, "use_pallas": False,
                     "output_path": str(root / name),
                     "checkpoint_path": str(root / f"{name}_ck"), **kw})
    path = root / f"{name}.json"
    path.write_text(cfg.to_json())
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(steps, n_ranks):
    """``n_ranks`` processes running ``steps``, joined as one group."""
    port = str(_free_port())
    procs = []
    for rank in range(n_ranks):
        env = dict(os.environ, WORLD_SIZE=str(n_ranks), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, ATEN_CPU_CAPABILITY="default",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, json.dumps(steps)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _loop(root, name, shard):
    return [argv + ["--config", str(root / f"{name}.json"), "--device",
                    "cpu", "--out", str(root / f"{name}_{OUT[argv[0]]}")]
            + (["--shard"] if shard else []) for argv in LOOP]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every group, run one JAX year here meanwhile, and wait."""
    root = tmp_path_factory.mktemp("mp")
    arch = synthesize_raw_soil_archive(str(root / "raw"), resolution_deg=12.0,
                                       factor=6, seed=3)
    _config(root, "soil", soil_source="raw", soil_hwsd_path=arch["hwsd"],
            soil_bnu_dir=arch["bnu_dir"], soil_fmax_path=arch["fmax"])
    _config(root, "two")
    _config(root, "resumed", start_year=1902, end_year=1902,
            checkpoint_path=str(root / "two_ck"))
    _config(root, "one", end_year=1902)
    for name in ("loop1", "loop2"):
        _config(root, name)
    cli = ["--device", "cpu", "--focus", "vaira"]
    groups = {
        "two": _launch([["run", "--config", str(root / "two.json"),
                         "--shard", *cli],
                        ["run", "--config", str(root / "resumed.json"),
                         "--shard", "--resume", *cli]], 2),
        "one": _launch([["run", "--config", str(root / "one.json"), *cli]],
                       1),
        "loop2": _launch([["load_soil", str(root / "soil.json")]]
                         + _loop(root, "loop2", True), 2),
        "loop1": _launch(_loop(root, "loop1", False), 1),
    }
    try:
        jcfg = JConfig(**dict(CFG, use_pallas=False,
                              output_path=str(root / "jax")))
        jgrid, jparams = j_load_soil(jcfg, jnp.float64)
        jsim = JSimulation(jcfg, jparams, land_grid=jgrid)
        jsim.run(JProvider(jgrid.n_padded, seed=0, lat=jgrid.cell_lat,
                           dtype=jnp.float64),
                 writer=JAnnualWriter(jcfg.output_path, jgrid))
        logs = {}
        for name, procs in groups.items():
            logs[name] = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
            for rank, (p, out) in enumerate(zip(procs, logs[name])):
                assert p.returncode == 0, f"{name} rank {rank}:\n{out[-4000:]}"
    finally:
        for procs in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return root, logs, jsim.annual_results[0]


def _means(out, year):
    """The year's float64 annual means of every rank, in cell order."""
    parts = sorted((int(f.split(".")[1]), f) for f in os.listdir(out)
                   if f.startswith(f"means{year}."))
    loaded = [np.load(os.path.join(out, f)) for _, f in parts]
    return {k: np.concatenate([d[k] for d in loaded]) for k in loaded[0]}


def _same_files(a, b):
    got, got_dims = read_nc(a)
    want, want_dims = read_nc(b)
    assert got_dims == want_dims and list(got) == list(want)
    for k, (dims, units, data) in want.items():
        assert got[k][:2] == (dims, units) and np.array_equal(got[k][2],
                                                               data), k


def test_two_ranks_write_the_one_rank_year(runs):
    root, logs, _ = runs
    _same_files(root / "two" / "axy1901.nc", root / "one" / "axy1901.nc")
    got, want = _means(root / "two", 1901), _means(root / "one", 1901)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert sorted(f for f in os.listdir(root / "two")
                  if not f.startswith("means")) == [
        "axy1901.nc", "focus_daily.csv", "focus_wt.csv",
        "init_diagnostics.nc"]
    for name, rows in (("focus_daily.csv", 365),
                       ("focus_wt.csv", 365 * CFG["nisurf"])):
        lines = (root / "one" / name).read_text().splitlines()
        assert (root / "two" / name).read_text().splitlines() == \
            lines[:1 + rows]
    # Each rank integrated its own 64 cells and gathered once a day.
    for rank, out in enumerate(logs["two"]):
        assert (f"run done: process {rank}/2, 0 day-kernel launches, "
                "collectives {'routing': 365} in 365 days") in out


def test_one_rank_year_is_jaxs(runs):
    root, _, jax_means = runs
    got = _means(root / "one", 1901)
    assert set(got) == set(jax_means)
    for k, want in jax_means.items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


def test_two_rank_resume_is_bitwise(runs):
    root, logs, _ = runs
    assert sorted(f for f in os.listdir(root / "resumed")
                  if not f.startswith("means")) == [
        "axy1902.nc", "focus_daily.csv", "focus_wt.csv"]
    _same_files(root / "resumed" / "axy1902.nc", root / "one" / "axy1902.nc")
    got, want = _means(root / "resumed", 1902), _means(root / "one", 1902)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    lines = (root / "one" / "focus_daily.csv").read_text().splitlines()
    assert (root / "resumed" / "focus_daily.csv").read_text().splitlines() \
        == lines[:1] + lines[366:]
    assert sorted(os.listdir(root / "two_ck")) == [
        f"year_{y}.rank{r}of2.pt" for y in (1901, 1902) for r in (0, 1)]
    assert "restored sharded checkpoint for year 1901" in logs["two"][1]


def test_restore_under_another_world_size_raises(runs):
    root, _, _ = runs
    with pytest.raises(ValueError, match="written by 2 rank.*this run has 1"):
        main(["run", "--config", str(root / "resumed.json"), "--resume",
              "--device", "cpu"])


def test_sharded_ensemble_is_bitwise(runs):
    root, _, _ = runs
    _same_files(root / "loop2_ensemble.nc", root / "loop1_ensemble.nc")


@pytest.mark.parametrize("command,rtol", [("assimilate", 0.0),
                                          ("calibrate", 1e-9)])
def test_sharded_filter_and_fit_match_one_process(runs, command, rtol):
    root, _, _ = runs
    got = np.load(root / f"loop2_{command}.npz")
    want = np.load(root / f"loop1_{command}.npz")
    assert got.files == want.files
    for k in want.files:
        if rtol == 0.0:
            assert np.array_equal(got[k], want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_rank_one_waits_for_rank_zeros_soil(runs, tmp_path):
    root, logs, _ = runs
    with open(root / "soil.json") as f:
        cfg = Config.from_json(f.read())
    grid, params = load_soil(
        dataclasses.replace(cfg, output_path=str(tmp_path)), torch.float64,
        "cpu")
    want = f"soil {grid.n_land} {float(params.hksat.sum())!r}"
    assert all(want in out for out in logs["loop2"])
    assert "waiting for process 0 to write" in logs["loop2"][1]
    assert "waiting for process 0" not in logs["loop2"][0]
