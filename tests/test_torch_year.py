"""The port's year loop as a whole against the JAX package.

``Simulation.run`` in both packages for 1901-1902 on the 12-degree grid
(``Config()``'s physics, ``nisurf=2``, float64, a checkpoint every year,
a focus cell), from the same numpy soil and the same initial state
(carried across by ``weights.from_reference``), fed by the host synthetic
provider of each package: every annual mean of both years at rtol 1e-9;
the files both write (``axy<year>.nc``, ``init_diagnostics.nc``, the
focus CSVs) alike; and a 1902 resumed from the port's 1901 checkpoint
bitwise the straight 1902.  The port reads its forcing in 30-day blocks,
so its year carries its state and sums across blocks; the JAX package
reads a year in one block (the forcing of a day does not depend on its
block), which compiles its block step once.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.data.forcing import SyntheticForcingProvider as JProvider
from hybrid9_tpu.data.soil import load_soil as j_load_soil
from hybrid9_tpu.io.checkpoint import Checkpointer as JCheckpointer
from hybrid9_tpu.io.writer import AnnualWriter as JAnnualWriter
from hybrid9_tpu.io.writer import write_init_diagnostics as j_write_init
from hybrid9_tpu.run import Simulation as JSimulation
from hybrid9_tpu_torch.config import Config
from hybrid9_tpu_torch.data.forcing import SyntheticForcingProvider
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.io.checkpoint import Checkpointer
from hybrid9_tpu_torch.io.writer import AnnualWriter, write_init_diagnostics
from hybrid9_tpu_torch.run import Simulation
from hybrid9_tpu_torch.state import initial_state

from _torch_port import assert_same_grid_files, to_port, tree_np

YEARS = (1901, 1902)
RUN_KW = dict(resolution_deg=12.0, cell_block=32, nisurf=2, dtype="float64",
              start_year=YEARS[0], end_year=YEARS[1], forcing_block_days=30,
              checkpoint_every_years=1, interactive=True)
T64 = torch.float64


def _port_run(cfg, state, grid, params, writer=True):
    """The port's ``Simulation.run`` from ``state``; returns the
    simulation."""
    sim = Simulation(cfg, params, state=state, land_grid=grid)
    if writer:
        write_init_diagnostics(cfg.output_path, grid, params)
    sim.run(SyntheticForcingProvider(grid.n_padded, seed=0,
                                     lat=grid.cell_lat, dtype=T64,
                                     device="cpu"),
            writer=AnnualWriter(cfg.output_path, grid) if writer else None,
            checkpointer=Checkpointer(cfg.checkpoint_path))
    return sim


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' two-year runs, and the port's 1902 resumed from
    its 1901 checkpoint."""
    root = tmp_path_factory.mktemp("year")
    jcfg = JConfig(use_pallas=False, output_path=str(root / "jax"),
                   checkpoint_path=str(root / "jax_ck"),
                   **dict(RUN_KW, forcing_block_days=366))
    jgrid, jparams = j_load_soil(jcfg, jnp.float64)
    jsim = JSimulation(jcfg, jparams, land_grid=jgrid)
    state0 = to_port(jsim.state)
    j_write_init(jcfg.output_path, jgrid, jparams)
    jsim.run(JProvider(jgrid.n_padded, seed=0, lat=jgrid.cell_lat,
                       dtype=jnp.float64),
             writer=JAnnualWriter(jcfg.output_path, jgrid),
             checkpointer=JCheckpointer(jcfg.checkpoint_path))

    cfg = Config(output_path=str(root / "port"),
                 checkpoint_path=str(root / "port_ck"), **RUN_KW)
    with torch.inference_mode():      # no autograd bookkeeping: faster
        grid, params = load_soil(cfg, T64, "cpu")
        sim = _port_run(cfg, state0, grid, params)

        ck = Checkpointer(cfg.checkpoint_path)
        lg = cfg.layer_grid()
        year, state = ck.restore(initial_state(params, lg.dz, lg.zi, T64,
                                               "cpu"), year=YEARS[0])
        rcfg = Config(**dict(RUN_KW, start_year=YEARS[0] + 1,
                             interactive=False),
                      output_path=str(root / "resumed"),
                      checkpoint_path=str(root / "resumed_ck"))
        resumed = _port_run(rcfg, state, grid, params, writer=False)
    return dict(jsim=jsim, sim=sim, resumed=resumed, restored_year=year,
                jdir=jcfg.output_path, dir=cfg.output_path, ck=ck)


def test_annual_means_match_jax(runs):
    got, want = runs["sim"].annual_results, runs["jsim"].annual_results
    assert len(got) == len(want) == 2
    for year, g, w in zip(YEARS, got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-9,
                                       atol=1e-9, err_msg=f"{year} {k}")
        assert g["max_abs_residual"][:runs["sim"].n_land].max() < 0.1
        assert g["discharge"].max() > 0.0 and g["swe"].max() > 0.0
    # The two years differ: the state carried over, the forcing moved on.
    assert not np.array_equal(got[0]["theta"], got[1]["theta"])


def test_year_timings_are_recorded(runs):
    t = runs["sim"].timings
    assert [x["year"] for x in t] == list(YEARS)
    for x in t:
        assert x["seconds"] > 0.0 and 0.0 <= x["forcing_wait_s"]
        assert x["write_s"] > 0.0 and x["checkpoint_s"] > 0.0


@pytest.mark.parametrize("name", ["axy1901.nc", "axy1902.nc",
                                  "init_diagnostics.nc"])
def test_output_files_match_jax(runs, name):
    assert_same_grid_files(os.path.join(runs["dir"], name),
                           os.path.join(runs["jdir"], name), 1e-6, 1e-12)


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], np.float64)


@pytest.mark.parametrize("name", ["focus_daily.csv", "focus_wt.csv"])
def test_focus_csvs_match_jax(runs, name):
    head, got = _read_csv(os.path.join(runs["dir"], name))
    j_head, want = _read_csv(os.path.join(runs["jdir"], name))
    assert head == j_head and got.shape == want.shape
    # 730 days, or 730 days of nisurf substeps.
    assert got.shape[0] == 730 * (RUN_KW["nisurf"] if name == "focus_wt.csv"
                                  else 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_focus_cell_is_jaxs(runs):
    assert runs["sim"].focus_idx == runs["jsim"].focus_idx is not None
    assert runs["resumed"].focus_idx is None


def test_resumed_year_is_bitwise_the_straight_one(runs):
    assert runs["restored_year"] == YEARS[0]
    assert runs["ck"].years() == list(YEARS)
    got = runs["resumed"].annual_results
    assert len(got) == 1
    want = runs["sim"].annual_results[1]
    for k, v in want.items():
        assert np.array_equal(got[0][k], v), k
    a, b = tree_np(runs["resumed"].state), tree_np(runs["sim"].state)

    def leaves(t):
        return [x for v in t.values()
                for x in (leaves(v) if isinstance(v, dict) else [v])]

    assert all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
