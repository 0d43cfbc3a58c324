"""The closed-loop commands of the port's command line: ``calibrate``
(site column and ``--config``), ``ensemble`` and ``assimilate``, as
``tests/test_calibrate_cli.py`` and ``tests/test_calibrate.py`` hold the
JAX package's, on the CPU (``--device cpu``) from a Config file the JAX
package writes: the same output files, names and keys, and the same
properties.  The global twin fits are shortened to 2 days (JAX: 10) of 2
substeps (JAX: 4) and 12 and 7 steps (JAX: 40 and 30); their recovery
still holds.
"""

import json
import os

import numpy as np
import pytest
import torch

from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu.data.synthetic import synthetic_forcing_day
from hybrid9_tpu_torch.cli import main
from hybrid9_tpu_torch.io import netcdf

CPU = ["--device", "cpu"]

# Small tensors beside other test processes: one intra-op thread.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("cal")
    cfg = JConfig(resolution_deg=24.0, start_year=1901, end_year=1901,
                  forcing_block_days=92, cell_block=16, nisurf=2,
                  use_pallas=False, output_path=str(d))
    p = d / "cfg.json"
    p.write_text(cfg.to_json())
    return str(p), str(d)


def test_calibrate_global_twin_scalar(cfg_path):
    """A known hksat multiplier is recovered from model-made obs."""
    p, d = cfg_path
    out = os.path.join(d, "fit.json")
    rc = main(["calibrate", "--config", p, "--obs-twin", "0.4",
               "--fields", "hksat", "--days", "2", "--steps", "12",
               "--lr", "0.15", "--out", out, *CPU])
    assert rc == 0
    with open(out) as f:
        fit = json.load(f)
    assert set(fit) == {"multipliers", "loss_initial", "loss_final"}
    assert fit["loss_final"] < 0.05 * fit["loss_initial"]
    assert fit["multipliers"]["hksat"] == pytest.approx(np.exp(0.4),
                                                        rel=0.15)


def test_calibrate_global_per_cell(cfg_path):
    """``--per-cell`` fits one multiplier per packed cell and writes an npz
    of them."""
    p, d = cfg_path
    out = os.path.join(d, "fit_cells.npz")
    rc = main(["calibrate", "--config", p, "--obs-twin", "0.3",
               "--per-cell", "--fields", "hksat", "--days", "2",
               "--steps", "7", "--lr", "0.15", "--out", out, *CPU])
    assert rc == 0
    with np.load(out) as z:
        assert set(z.files) == {"hksat", "loss_history", "n_land"}
        mult = z["hksat"]
        n_land = int(z["n_land"])
        hist = z["loss_history"]
    assert mult.ndim == 1 and mult.shape[0] >= n_land
    assert hist.shape == (8,) and hist[-1] < hist[0]
    med = float(np.median(mult[:n_land]))
    assert 1.05 < med < np.exp(0.3) * 1.3


def test_ensemble_cli(cfg_path):
    p, d = cfg_path
    out = os.path.join(d, "ens.nc")
    rc = main(["ensemble", "--config", p, "--members", "4", "--days", "8",
               "--out", out, *CPU])
    assert rc == 0
    names = [f"{v}_{s}" for v in ("evap", "runoff", "npp")
             for s in ("mean", "std", "control")]
    back = netcdf.read_grid_file(out, names)
    land = np.isfinite(back["evap_mean"])
    assert land.sum() > 0
    for k in names:
        assert np.array_equal(np.isfinite(back[k]), land), k
    assert np.nanmax(back["evap_std"]) > 0.0
    assert np.all(np.isfinite(back["evap_control"][land]))


def test_assimilate_cli_twin(cfg_path):
    """``assimilate --obs-twin``: the posterior moves toward the known
    hksat log-multiplier and the npz has the JAX package's keys."""
    p, d = cfg_path
    out = os.path.join(d, "enkf.npz")
    rc = main(["assimilate", "--config", p, "--obs-twin", "0.5",
               "--days", "20", "--members", "12", "--out", out, *CPU])
    assert rc == 0
    with np.load(out) as z:
        assert set(z.files) == {"theta_mean", "theta_std",
                                "hksat_multiplier", "y_pred_mean", "n_land"}
        tm = z["theta_mean"]
        ts = z["theta_std"]
        mult = z["hksat_multiplier"]
        n_land = int(z["n_land"])
        assert z["y_pred_mean"].shape == (20, n_land)
    assert tm.shape == (n_land,) and np.all(np.isfinite(tm))
    assert np.all(np.isfinite(ts)) and np.all(ts >= 0.0)
    top = np.sort(mult)[n_land // 2:]
    assert float(np.median(top)) > 1.05
    assert np.all(np.abs(tm) <= 2.0)


def test_cli_calibrate_smoke(tmp_path):
    """The site ``calibrate`` command: climate and obs CSVs in, the fitted
    multipliers' JSON out (the JAX package's keys).  At 4 substeps a day
    (the JAX package's smoke takes 8): the command's wiring does not
    depend on them."""
    cpath = tmp_path / "climate.csv"
    opath = tmp_path / "obs.csv"
    out = tmp_path / "fit.json"
    cols = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")
    with open(cpath, "w") as f:
        f.write(",".join(cols) + "\n")
        for d in range(8):
            day = synthetic_forcing_day(1, 150 + d, seed=5)
            f.write(",".join(f"{float(day[k][0]):.8g}" for k in cols) + "\n")
    with open(opath, "w") as f:
        f.write("doy,evap_obs\n")
        for d in range(8):
            f.write(f"{d + 1},1.5\n")
    rc = main(["calibrate", "--climate", str(cpath), "--obs", str(opath),
               "--fields", "hksat,bsw", "--steps", "2", "--lr", "0.05",
               "--nisurf", "4", "--out", str(out), *CPU])
    assert rc == 0
    fit = json.loads(out.read_text())
    assert set(fit) == {"multipliers", "loss_initial", "loss_final", "steps",
                        "obs_days"}
    assert set(fit["multipliers"]) == {"hksat", "bsw"}
    assert fit["obs_days"] == 8 and fit["steps"] == 2
    assert np.isfinite(fit["loss_final"])
