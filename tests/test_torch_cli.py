"""The port's command line against the JAX package's.

``main(["run", ...])`` of both packages from Config files written by the
JAX package, alike but for the forcing block (a year for JAX, 120 days
for the port), on the CPU: two years on the 12-degree grid in float32
(the default dtype) with a focus site and yearly checkpoints.  The files
both write have the same variables, dimensions, units and fill positions
and values within the float32 tolerance of a two-year run; ``--resume``
from the 1901 checkpoint writes an ``axy1902.nc`` byte for byte the
straight run's.  Then ``info``, the card as the default device, and
the refusal of unknown arguments.
"""

import os

import numpy as np
import pytest
import torch

from hybrid9_tpu.cli import main as j_main
from hybrid9_tpu.config import Config as JConfig
from hybrid9_tpu_torch.cli import DEBUG_SITES, main

from _torch_port import assert_same_grid_files


def _config_file(root, name, forcing_block_days=120):
    """A Config file written by the JAX package."""
    cfg = JConfig(resolution_deg=12.0, cell_block=32, nisurf=2,
                  routing_substeps=2, start_year=1901, end_year=1902,
                  forcing_block_days=forcing_block_days,
                  checkpoint_every_years=1, use_pallas=False,
                  output_path=str(root / name),
                  checkpoint_path=str(root / f"{name}_ck"))
    path = root / f"{name}.json"
    path.write_text(cfg.to_json())
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    # The JAX command line reads a year in one block, which compiles its
    # block step once; the port's reads 120-day blocks.  A day's forcing
    # does not depend on its block.
    assert j_main(["run", "--config",
                   _config_file(root, "jax", forcing_block_days=366),
                   "--cache-dir", "", "--focus", "vaira"]) == 0
    # The straight run is the command as a user gives it; the resumed one
    # runs without autograd bookkeeping, which is faster.
    port = _config_file(root, "port")
    assert main(["run", "--config", port, "--device", "cpu",
                 "--focus", "vaira"]) == 0
    # The resumed run finds the straight run's 1901 checkpoint, as a run
    # stopped after 1901 leaves it, and writes elsewhere.
    resumed = _config_file(root, "resumed")
    os.mkdir(root / "resumed_ck")
    os.rename(root / "port_ck" / "year_1901.pt",
              root / "resumed_ck" / "year_1901.pt")
    with torch.inference_mode():
        assert main(["run", "--config", resumed, "--device", "cpu",
                     "--resume"]) == 0
    return root


@pytest.mark.parametrize("name", ["axy1901.nc", "axy1902.nc",
                                  "init_diagnostics.nc"])
def test_run_writes_what_the_jax_command_line_writes(runs, name):
    assert_same_grid_files(runs / "port" / name, runs / "jax" / name, 5e-3,
                           5e-3)


def test_focus_site_csvs_match_jax(runs):
    for name, rows in (("focus_daily.csv", 730), ("focus_wt.csv", 1460)):
        got = np.loadtxt(runs / "port" / name, delimiter=",", skiprows=1)
        want = np.loadtxt(runs / "jax" / name, delimiter=",", skiprows=1)
        assert got.shape == want.shape and got.shape[0] == rows
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_resume_writes_the_straight_runs_year(runs):
    assert sorted(os.listdir(runs / "resumed")) == ["axy1902.nc"]
    assert sorted(os.listdir(runs / "resumed_ck")) == ["year_1901.pt",
                                                      "year_1902.pt"]
    with open(runs / "resumed" / "axy1902.nc", "rb") as a, \
            open(runs / "port" / "axy1902.nc", "rb") as b:
        assert a.read() == b.read()


def test_focus_sites_are_jaxs():
    from hybrid9_tpu.site import DEBUG_SITES as J_SITES
    assert DEBUG_SITES == J_SITES


def test_info_names_torch_and_the_cards(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "hybrid9_tpu_torch" in out and "torch" in out
    assert "visible card" in out


def test_run_needs_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    path = _config_file(tmp_path, "c")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", "--config", path])


def test_unknown_arguments_are_refused():
    with pytest.raises(SystemExit):
        main(["run", "--cache-dir", "x"])
