"""Season-length global DA soak at production scale.

Port of ``scripts/da_soak.py``.  Runs the sequential EnSRF
(assimilate.py) at production scale: the global grid, 16 members folded
into the cell axis, the CUDA day kernel's forecast, for N daily cycles
of a twin-experiment observation record, then audits ensemble health:

  - posterior spread in observed cells tightened but bounded away from
    collapse (RTPS floor) and never above the prior sample spread;
  - cells NEVER observed keep a bit-static multiplier ensemble (the
    unbounded-spread failure mode);
  - innovation magnitude stationary-or-shrinking (late vs early);
  - all posterior fields finite.

The small-grid version of this audit runs in the tests
(tests/test_torch_assimilate.py); this program is the production-scale
leg, and doubles as the fits-on-one-card demonstration for 0.25 degrees
(``--resolution 0.25 --days 2``: a 16-member ensemble at 277,504 cells,
about 4.5 M folded cells in one launch of the kernel a day).

Usage: python -m hybrid9_tpu_torch.scripts.da_soak [--days 90]
           [--members 16] [--resolution 0.5]
Exit 0 iff every health check passes.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..assimilate import EnKFConfig, assimilate, first_draw
from ..calibrate import simulate_daily_et
from ..config import Config
from ..data.forcing import SyntheticForcingProvider
from ..data.soil import load_soil
from ..physics.hydrology import Geometry
from ..run import resolve_device
from ..state import initial_state


def soak(cfg: Config, s: argparse.Namespace, device) -> list:
    """The soak of ``cfg``'s grid on ``device`` with the program's
    arguments ``s`` (:func:`arguments`): the twin record at log
    multiplier ``s.truth``, ``s.days`` cycles of the filter with half the
    land cells observed, then the health checks, each printed.  Returns
    the names of the checks that failed."""
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, device)
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, dtype, device)
    geom = Geometry.from_layer_grid(lg)
    n = grid.n_padded
    m = s.members
    ndays = s.days
    provider = SyntheticForcingProvider(n, seed=0, lat=grid.cell_lat,
                                        dtype=dtype, device=device)
    forcing = provider(cfg.start_year, 1, ndays)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    print(f"da_soak: {m} members x {n} cells ({grid.n_land} land) "
          f"x {ndays} days = {m * n} folded cells on {kind}", flush=True)

    t0 = time.perf_counter()
    with torch.no_grad():
        obs = simulate_daily_et(
            {"hksat": torch.full((), s.truth, dtype=dtype, device=device)},
            params, state0, forcing, geom, cfg.nisurf,
            vegetation=cfg.vegetation)
    float(obs.sum())
    print(f"twin record generated in {time.perf_counter()-t0:.1f}s "
          f"(truth log-mult {s.truth})", flush=True)

    # Half the land cells are NEVER observed; padding lanes never.
    mask = np.zeros((ndays, n), bool)
    observed = np.arange(grid.n_land) % 2 == 0
    mask[:, :grid.n_land] = observed[None, :]

    t0 = time.perf_counter()
    res = assimilate(params, state0, forcing, obs, geom, n_members=m,
                     nisurf=cfg.nisurf,
                     obs_mask=torch.tensor(mask, device=device),
                     theta_spread=s.spread, seed=s.seed,
                     vegetation=cfg.vegetation, use_kernel=cfg.use_kernel,
                     zd09_every=cfg.zd09_every,
                     cfg=EnKFConfig(obs_err_std=s.obs_err, rtps=s.rtps))
    ts = res["theta_std"][:grid.n_land].cpu().numpy()  # D2H closes timing
    tm = res["theta_mean"][:grid.n_land].cpu().numpy()
    elapsed = time.perf_counter() - t0
    rate = m * n * ndays / elapsed
    kernel = (device.type == "cuda" if cfg.use_kernel is None
              else cfg.use_kernel)
    print(f"{ndays} DA cycles in {elapsed:.1f}s "
          f"({rate/1e6:.1f} M member-cell-days/s, "
          f"{elapsed / ndays * 1e3:.1f} ms a cycle, kernel={kernel})",
          flush=True)

    # The prior the filter drew: the same generator, seed and device.
    theta0 = first_draw(torch.Generator(device=device).manual_seed(s.seed),
                        m, n, s.spread, dtype)
    std0 = torch.std(theta0, dim=0, correction=0)[:grid.n_land].cpu().numpy()

    failures = []

    def check(name, ok, detail=""):
        print(f"  [{'ok' if ok else 'FAIL'}] {name} {detail}")
        if not ok:
            failures.append(name)

    check("posterior finite", bool(np.all(np.isfinite(ts))
                                   and np.all(np.isfinite(tm))))
    static = np.array_equal(ts[~observed], std0[~observed])
    check("unobserved cells bit-static", static,
          f"({int((~observed).sum())} cells, {ndays} cycles)")
    tso, std0o = ts[observed], std0[observed]
    check("no spread growth", bool(np.all(tso <= std0o + 1e-6)),
          f"(max post/prior = {float(np.max(tso/std0o)):.3f})")
    check("no collapse", np.median(tso) > 0.02,
          f"(median posterior spread {np.median(tso):.3f})")
    if ndays >= 10:
        # Convergence checks need a season, not a smoke run: a 2-cycle
        # fits-on-one-card demo (--resolution 0.25 --days 2) cannot
        # tighten spread or recover the truth yet.
        check("spread tightened",
              np.median(tso) < 0.9 * np.median(std0o),
              f"(median {np.median(std0o):.3f} -> {np.median(tso):.3f})")
        err = (res["y_pred_mean"] - obs).abs().cpu().numpy()
        err = err[:, :grid.n_land][:, observed]
        third = max(1, ndays // 3)
        early = float(np.mean(err[:third]))
        late = float(np.mean(err[-third:]))
        check("innovations stationary", late <= early * 1.05,
              f"({early:.4g} -> {late:.4g} mm/day)")
        check("posterior toward truth",
              float(np.mean(tm[observed])) > 0.25 * s.truth,
              f"(mean obs-cell log-mult "
              f"{float(np.mean(tm[observed])):.3f}, truth {s.truth})")
    else:
        print(f"  (short run: {ndays} cycles — convergence checks "
              "skipped; this is the fits-on-one-card demo)")

    print("da_soak:", "ALL PASS" if not failures else
          f"FAILED: {failures}")
    return failures


def arguments(argv=None) -> argparse.Namespace:
    """The program's arguments (``argv``, or the command line's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=90)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--resolution", type=float, default=0.5)
    ap.add_argument("--spread", type=float, default=0.3)
    ap.add_argument("--obs-err", type=float, default=0.1)
    ap.add_argument("--rtps", type=float, default=0.6)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--truth", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = arguments(argv)
    failures = soak(Config(resolution_deg=args.resolution), args,
                    resolve_device(args.device))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
