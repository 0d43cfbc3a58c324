"""The traffic kinds: what a cell's window calls in the program, and how
its answers are sampled for the reference.

A workload file names its ``kind`` and the parameters below; a new cell
of an existing kind is a new data file.  This module is the only one of
the benchmark that imports the program (``hybrid9_tpu_torch``): the
entries the window drives, and the state types they take.

- ``ensemble``: whole calls of ``ensemble.run_ensemble_annual``, one
  forcing block of ``days`` a call, ``members`` perturbed-parameter
  members (``sigma`` log-normal multipliers on ``fields``, member 0 the
  control) folded into the cell axis; the blocks, years ``start_year``
  on, are cycled ``blocks`` at a time.  Keys: ``members``, ``fields``,
  ``sigma``, ``days``, ``start_year``, ``blocks``, ``warmup_days``,
  ``trace_calls``, ``sample_columns``.
- ``assimilate``: a stream of ``assimilate.assimilate`` windows of
  ``days`` each, every window a call from the initial state, its daily-ET
  observations (uniform in ``obs_range`` mm/day, each land cell observed
  with probability ``obs_fraction`` a day) and prior drawn from the seed
  for a cycle of ``windows`` that the stream repeats.  Keys: ``members``,
  ``days``, ``spread``, ``obs_err``, ``rtps``, ``obs_range``,
  ``obs_fraction``, ``start_year``, ``windows``, ``warmup_days``,
  ``trace_calls``, ``sample_windows``, ``sample_cells``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import inputs
from .inputs import STREAMS

#: The forcing fields a reference task reads, and the soil parameters.
_FORCING = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")
_PARAMS = ("theta_s", "hksat", "bsw", "psi_s")


class Cell:
    """A configuration's inputs from the seed, on ``device``, as the
    benchmark's tensors and as the program's types."""

    def __init__(self, config: dict, workload: dict, seed: int, device):
        from hybrid9_tpu_torch.physics.hydrology import Geometry

        self.config, self.workload = config, workload
        self.seed, self.device = seed, torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        lat, self.n_land = inputs.land_latitudes(
            config["resolution_deg"], config["land_fraction"],
            config["cell_block"])
        self.n = lat.shape[0]
        self.lat = torch.tensor(lat, dtype=self.dtype, device=self.device)
        self.geo = inputs.geometry(config["zi_mm"])
        self.nl = self.geo["nl"]
        self.params = inputs.soil(seed, self.n, self.nl, self.dtype,
                                  self.device)
        self.state0 = inputs.initial_state(self.params, self.geo)
        self.geom = Geometry(zi=tuple(self.geo["zi"]),
                             dz_soil=tuple(self.geo["dz"][:self.nl]),
                             zc_soil=tuple(self.geo["zc"][:self.nl]))
        self.program_params = _soil_params(self.params)
        self.program_state0 = _model_state(self.state0)
        self.step_kw = dict(nisurf=config["nisurf"],
                            vegetation=config["vegetation"],
                            use_kernel=config["use_kernel"],
                            zd09_every=config["zd09_every"])

    def column(self, cell: int) -> dict:
        """One cell's soil parameters and start state as Python numbers,
        read from the benchmark's own tensors."""
        p = {k: self.params[k][cell].double().tolist() for k in _PARAMS}
        p["fmax"] = float(self.params["fmax"][cell])
        s = self.state0
        return dict(p, h=s["h2osoi_liq"][cell].double().tolist(),
                    smp=s["smp"][cell].double().tolist(),
                    rootr=s["rootr"][cell].double().tolist(),
                    t_soil=s["t_soil"][cell].double().tolist(),
                    **{k: float(s[k][cell]) for k in (
                        "zwt", "wa", "lai", "lai_litter", "plant_mass",
                        "plant_foliage_mass")})

    def task(self, kind: str, column: dict, forcing: dict, cell: int):
        """A reference task for ``cell`` over a forcing block's days."""
        days = forcing["tas"].shape[0]
        host = {k: forcing[k][:, cell].double().tolist() for k in _FORCING}
        return dict(kind=kind, zi=self.geo["zi"], column=column,
                    nisurf=self.config["nisurf"],
                    zd09_every=self.config["zd09_every"],
                    forcing=[{k: host[k][d] for k in _FORCING}
                             for d in range(days)])

    def model_days(self, calls: int) -> int:
        return calls * self.days

    def free(self):
        """Drop the program's inputs and every tensor on the card."""
        for k in list(vars(self)):
            if k not in ("config", "workload", "seed", "device", "dtype",
                         "n", "n_land", "geo", "nl"):
                delattr(self, k)
        torch.cuda.empty_cache()


def _soil_params(p: dict):
    from hybrid9_tpu_torch.state import SoilParams
    return SoilParams(**p)


def _model_state(s: dict):
    from hybrid9_tpu_torch.state import (CarbonState, ModelState,
                                         SnowpackState, SoilState, VegState)
    n, nl = s["t_soil"].shape
    dtype, device = s["t_soil"].dtype, s["t_soil"].device
    soil = SoilState(**{k: s[k] for k in ("h2osoi_liq", "zwt", "wa", "smp",
                                          "h2osoi_liq_ma")})
    veg = VegState(**{k: s[k] for k in (
        "plant_mass", "plant_foliage_mass", "plant_length", "rdepth", "lai",
        "lai_litter", "rootr", "c_labile", "n_labile", "p_labile")})
    zeros = torch.zeros((n,), dtype=dtype, device=device)
    return ModelState(soil=soil, veg=veg, river_store=zeros,
                      t_soil=s["t_soil"], swe=zeros,
                      h2osoi_ice=torch.zeros((n, nl), dtype=dtype,
                                             device=device),
                      snowpack=SnowpackState.zeros(n, dtype, device),
                      carbon=CarbonState.initial(n, dtype, device))


def _forcing(block: dict):
    from hybrid9_tpu_torch.state import Forcing
    return Forcing(**block)


class Ensemble(Cell):
    """Whole annual calls of the folded perturbed-parameter ensemble."""

    def __init__(self, config, workload, seed, device):
        super().__init__(config, workload, seed, device)
        w = workload
        self.m, self.days = w["members"], w["days"]
        self.blocks = [inputs.forcing_block(seed, w["start_year"] + k, 1,
                                            self.days, self.lat)
                       for k in range(w["blocks"])]
        self.program_blocks = [_forcing(b) for b in self.blocks]
        g = inputs.generator(self.device, seed, STREAMS["members"])
        self.theta = {}
        for f in w["fields"]:
            t = w["sigma"] * torch.randn((self.m,), generator=g,
                                         dtype=self.dtype, device=self.device)
            t[0] = 0.0
            self.theta[f] = t
        self.cell_days_per_call = self.m * self.n * self.days

    def _run(self, block):
        from hybrid9_tpu_torch.ensemble import run_ensemble_annual
        return run_ensemble_annual(self.theta, self.program_params,
                                   self.program_state0, block, self.geom,
                                   **self.step_kw)

    def warm_up(self):
        """One short call at the cell's own widths."""
        w = self.workload["warmup_days"]
        out = self._run(self.program_blocks[0].map(lambda x: x[:w]))
        out["evap"].cpu()

    def call(self, k: int) -> dict:
        """Call ``k``: block ``k mod blocks``; the host copy of the
        ``[members, cells]`` totals closes it."""
        out = self._run(self.program_blocks[k % len(self.blocks)])
        return {q: v.cpu() for q, v in out.items()}

    def answers(self, results: list, rng: np.random.Generator,
                judged_by_control: bool = False):
        """``(tasks, judged)``: a sample of member-cells of one finished
        call drawn by ``rng``, the reference's tasks for them and the
        program's totals there (None for the control, which judges the
        reference's own tasks in lower precision)."""
        call = int(rng.integers(len(results)))
        block = self.blocks[call % len(self.blocks)]
        cells = rng.choice(self.n_land, self.workload["sample_columns"],
                           replace=False)
        members = rng.integers(self.m, size=len(cells))
        tasks, judged = [], {q: [] for q in ("evap", "runoff", "npp")}
        for cell, j in zip(cells.tolist(), members.tolist()):
            col = self.column(cell)
            for f, t in self.theta.items():
                mult = float(torch.exp(t[j].double()))
                col[f] = [v * mult for v in col[f]]
            tasks.append(self.task("year", col, block, cell))
            if not judged_by_control:
                for q in judged:
                    judged[q].append(float(results[call][q][j, cell]))
        return tasks, (None if judged_by_control else judged)

    @staticmethod
    def compare(judged: dict, refs: list, gap) -> dict:
        return {f"{q}_gap": gap(judged[q], [r[q] for r in refs])
                for q in ("evap", "runoff", "npp")}

    @staticmethod
    def from_control(refs: list) -> dict:
        return {q: [r[q] for r in refs] for q in ("evap", "runoff", "npp")}

    @staticmethod
    def finite(result: dict) -> bool:
        return all(bool(torch.isfinite(v).all()) for v in result.values())


class Assimilation(Cell):
    """A stream of assimilation windows, each a call from the initial
    state."""

    def __init__(self, config, workload, seed, device):
        super().__init__(config, workload, seed, device)
        w = workload
        self.m, self.days = w["members"], w["days"]
        k_windows = w["windows"]
        land = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        land[:self.n_land] = True
        self.blocks, self.obs, self.mask = [], [], []
        for k in range(k_windows):
            self.blocks.append(inputs.forcing_block(
                seed, w["start_year"], 1 + k * self.days, self.days,
                self.lat))
            g = inputs.generator(self.device, seed, STREAMS["obs"], k)
            lo, hi = w["obs_range"]
            shape = (self.days, self.n)
            self.obs.append(torch.rand(shape, generator=g, dtype=self.dtype,
                                       device=self.device) * (hi - lo) + lo)
            self.mask.append((torch.rand(shape, generator=g,
                                         device=self.device)
                              < w["obs_fraction"]) & land[None, :])
        self.program_blocks = [_forcing(b) for b in self.blocks]
        self.prior_seeds = [inputs.stream_seed(seed, STREAMS["prior"], k)
                            for k in range(k_windows)]
        rng = np.random.default_rng(
            inputs.stream_seed(seed, STREAMS["sample"]))
        self.sampled = sorted(rng.choice(
            k_windows, w["sample_windows"], replace=False).tolist())
        self.kept = {}
        self.cell_days_per_call = self.m * self.n * self.days

    def _run(self, k: int, days=None):
        from hybrid9_tpu_torch.assimilate import EnKFConfig, assimilate
        w = self.workload
        days = days or self.days
        return assimilate(
            self.program_params, self.program_state0,
            self.program_blocks[k].map(lambda x: x[:days]),
            self.obs[k][:days], self.geom, n_members=self.m,
            obs_mask=self.mask[k][:days], theta_spread=w["spread"],
            seed=self.prior_seeds[k],
            cfg=EnKFConfig(obs_err_std=w["obs_err"], rtps=w["rtps"]),
            **self.step_kw)

    def warm_up(self):
        """One short window at the cell's own widths."""
        out = self._run(0, self.workload["warmup_days"])
        out["theta_mean"].cpu()

    def call(self, k: int) -> dict:
        """Window ``k``: window ``k mod windows`` of the cycle; the host
        copy of the posterior and the predicted ET closes it.  The folded
        state of the first pass of each sampled window is kept for the
        check."""
        i = k % len(self.blocks)
        res = self._run(i)
        out = {q: res[q].cpu()
               for q in ("theta_mean", "theta_std", "y_pred_mean")}
        if i in self.sampled and i not in self.kept:
            self.kept[i] = res["state"]
        out["window"] = i
        return out

    def prior(self, i: int) -> torch.Tensor:
        """Window ``i``'s ``[members, cells]`` prior log-multipliers,
        drawn as the program draws them from the window's seed."""
        g = torch.Generator(device=self.device).manual_seed(
            self.prior_seeds[i])
        return self.workload["spread"] * torch.randn(
            (self.m, self.n), generator=g, dtype=self.dtype,
            device=self.device)

    def keep_sampled_rows(self, cells: dict):
        """Copy the kept states' rows of ``cells`` (window -> cells) to
        the host: the folded row of member ``j`` of cell ``c`` is
        ``c * members + j``."""
        rows = {}
        for i, cs in cells.items():
            st = self.kept[i]
            idx = torch.tensor([c * self.m + j for c in cs
                                for j in range(self.m)], device=self.device)
            rows[i] = dict(
                h=st.soil.h2osoi_liq[idx].double().cpu().numpy(),
                wa=st.soil.wa[idx].double().cpu().numpy(),
                t_soil=st.t_soil[idx].double().cpu().numpy())
        return rows

    def answers(self, results: list, rng: np.random.Generator,
                judged_by_control: bool = False):
        """``(tasks, judged)``: for each sampled window, cells drawn by
        ``rng`` with all their members; the program's posterior, state
        and predicted ET there (None for the control)."""
        by_window = {}
        for r in results:
            by_window.setdefault(r["window"], r)
        cells = {i: rng.choice(self.n_land, self.workload["sample_cells"],
                               replace=False).tolist()
                 for i in self.sampled}
        rows = None if judged_by_control else self.keep_sampled_rows(cells)
        w = self.workload
        tasks = []
        judged = {q: [] for q in ("theta_mean", "theta_std", "state",
                                  "t_soil", "y_pred")}
        for i, cs in cells.items():
            prior = self.prior(i)
            for k, cell in enumerate(cs):
                task = self.task("window", self.column(cell), self.blocks[i],
                                 cell)
                task.update(
                    theta=prior[:, cell].double().tolist(),
                    obs=self.obs[i][:, cell].double().tolist(),
                    mask=self.mask[i][:, cell].tolist(),
                    obs_err_std=w["obs_err"], rtps=w["rtps"],
                    theta_bounds=(-2.0, 2.0))
                tasks.append(task)
                if judged_by_control:
                    continue
                r = by_window[i]
                judged["theta_mean"].append(float(r["theta_mean"][cell]))
                judged["theta_std"].append(float(r["theta_std"][cell]))
                judged["y_pred"].append(
                    r["y_pred_mean"][:, cell].double().tolist())
                sl = slice(k * self.m, (k + 1) * self.m)
                judged["state"].append(np.concatenate(
                    [rows[i]["h"][sl].ravel(), rows[i]["wa"][sl]]).tolist())
                judged["t_soil"].append(rows[i]["t_soil"][sl].tolist())
        return tasks, (None if judged_by_control else judged)

    @staticmethod
    def _ref(refs: list) -> dict:
        return dict(
            theta_mean=[r["theta_mean"] for r in refs],
            theta_std=[r["theta_std"] for r in refs],
            y_pred=[r["y_pred_mean"] for r in refs],
            state=[[v for mb in r["members"] for v in mb["h"]]
                   + [mb["wa"] for mb in r["members"]] for r in refs],
            t_soil=[[mb["t_soil"] for mb in r["members"]] for r in refs])

    @classmethod
    def compare(cls, judged: dict, refs: list, gap) -> dict:
        ref = cls._ref(refs)
        return {f"{q}_gap": gap(judged[q], ref[q]) for q in judged}

    @classmethod
    def from_control(cls, refs: list) -> dict:
        return cls._ref(refs)

    @staticmethod
    def finite(result: dict) -> bool:
        return all(bool(torch.isfinite(result[q]).all())
                   for q in ("theta_mean", "theta_std", "y_pred_mean"))


KINDS = dict(ensemble=Ensemble, assimilate=Assimilation)


def run_window(cell: Cell, seconds: float) -> tuple:
    """Calls one after another until ``seconds`` have passed since the
    first began.  Returns ``(results, [(start, end)] per call)``."""
    results, times = [], []
    t_first = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        results.append(cell.call(len(results)))
        t1 = time.perf_counter()
        times.append((t0, t1))
        if t1 - t_first >= seconds:
            return results, times
