#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. device: a CUDA card is required (there is no CPU path); prints its
   name and, as ``nvidia-smi`` gives them, its name and power limit;
2. build: compiles ``hybrid9_tpu_torch/csrc/day_kernel.cu`` with nvcc for
   sm_90a, one unit of compilation for the fixed builds and the C entries
   and one for each register build of ``day_kernel_any`` (whose layer
   count is a run-time argument), all at once, and prints the build
   seconds (each unit's too), the registers, stack frame and spills of
   each kernel instance, and what the card holds of each (resident blocks
   an SM, shared memory a block); for ``day_kernel_any`` beside what
   ``day_kernel.any_residency`` predicts, a register build at its
   capacity and at the fewest layers it serves, the all-shared form at
   10 layers;
3. kernel vs plain twin on the card: n = 4,096 cells, one day,
   zd09_every in {1, 8}, with and without the frozen-soil impedance,
   nl in {8, 20}, every output of the day: in float32 at the tolerances
   of tests/test_pallas_day.py on the reference case's states and on
   columns spread across regimes (water tables inside and below the
   column, near-dry layers), and in float64 at 1e-9, the residual
   included, on the same columns with water tables on the column bottom
   too.  In float32 a one-ulp difference between two programs (nvcc's
   FMA contraction is one) can flip a knife-edge cell's branch and move
   it by millimetres; such cells, found from the twin alone
   (``knife_edge_cells``), are held to finiteness and the water balance.
   Then ``day_kernel_any`` against the twin at nl in {3, 9, 11, 12, 13,
   16, 24, 30, 32} (the ends of each register build's range and the
   all-shared form beside them) and {8, 20}, zd09_every=8, with and
   without imp: float64 on the varied
   columns at 1e-9, float32 on the varied columns off the interfaces with
   the knife-edge cells set aside and those of ``float32_noise_cells`` and
   ``rounding_explained`` (at most 5 % in all), at 5 layers and fewer on
   the reference states; its residency at each count;
   the edge states of tests/test_edge_states.py (``check_case(...,
   "edge")``) at nl in {8, 10, 20} through the fixed builds and
   ``day_kernel_any``, float64 at 1e-9 and float32 off knife edges (about
   half of those columns are); 64 layers in both dtypes, finite and
   conserving; 2 layers and one past ``layer_cap`` refused before any
   launch; and the hot climate, two years at 318 K on 64 reference cells
   through ``day_step`` on the kernel (730 launches, finite, plant mass
   and root depth positive, every residual under 0.1 mm);
4. reference-scope path: ``build_reference_case(66_560, "float32")`` (no
   device named: the card); the kernel against its twin on that case's
   first day; a 10-day synthetic forcing block from day 152 through
   ``block_step`` (kernel by default) and ``annual_means``; checks the
   launch count, finiteness, the water balance and physical ranges, and
   holds the first 3 days against the same block through the plain twin;
5. timing at 66,560 cells: the kernel day, the plain-twin day and the
   whole ``day_step``, in cell-days/s beside the card's name and power
   limit;
6. flagship path, the main path: ``build_flagship_case()`` (``Config()``
   as it stands at 0.5 degrees: 69,632 cells, float32, snow with the
   albedo feedback, frozen soil, soil ice, carbon, dense kinematic
   routing); a 30-day synthetic block from 1 January through
   ``block_step(**step_kwargs())``: one kernel launch per day, finite
   state and annual means, water balance, physical ranges, and every
   extra seen at work (snow, soil ice, impedance below 1, discharge,
   respiration, the routed water balance of one day); the first 3 days
   against the same block through the plain twin; the kernel with the
   impedance operand and the absorptivity against its twin on the first
   day and on the winter state the block ends in; the focus-cell trace the
   kernel writes, on the debug sites' cells (``cli.DEBUG_SITES``): every
   other output bitwise the day without a focus, the trace against the
   twin's on that cell at zwt's tolerance off knife edges;
7. sharded launcher: ``hydrology_day_sharded`` over ``[cuda:0]`` and
   ``[cuda:0] * 4`` at 69,632 cells and at a cell count 4 does not
   divide: bitwise (``torch.equal``) the unsharded kernel day, and held
   against its plain version (``use_kernel=False``) at the kernel's
   tolerances with the knife-edge cells set aside; then 5
   flagship days through ``block_step(devices=[cuda:0] * 4)``: four
   launches per day, bitwise the unsharded block (the resident path of
   phase 17);
8. timing at 69,632 cells: the flagship ``day_step``, the kernel day with
   and without the impedance operand (on the winter state and on the
   first day's state) and with a focus cell, the sharded day with 1 and
   4 slabs and their plain versions; then the kernel day on the first
   33,792 to 69,632 cells of the first day's state (one thread block more
   must not cost a round of blocks more) and on 282,624 cells, the
   0.25-degree grid's count, made by tiling that state;
9. the bound of the day on this card: the bytes the day must move over
   the memory rate against its operations over the float32 rate, the
   operations counted from the kernel's source along the path each of
   this run's cells takes (``day_kernel.day_operations``);
10. the year path at full width, through the command line
   (``cli.main(["run", ...])``, ``Config()`` at 0.5 degrees, the card as
   the default device): 1901-1902 with ``forcing="device-synthetic"``, a
   focus site and a checkpoint a year (365 kernel launches a year; every
   annual field finite on land and fill over the ocean, theta in
   (0, theta_s], the land residual under 0.1 mm; the focus CSVs); 1902
   resumed from the 1901 checkpoint into another directory without a
   focus, its ``axy1902.nc`` byte for byte the straight run's; one year
   of host ``synthetic`` forcing through the prefetch, in one block and in
   30-day blocks; 30 days of a NetCDF-3 PGF-style archive written here,
   read back bitwise.  Each year's seconds, cell-days/s, forcing wait,
   output and checkpoint seconds, and the restore's, come from the
   run's own log records (``run.YEAR_LOG``, ``run.OUTPUT_LOG``,
   ``cli.RESUME_LOG``);
11. the switches of ``Config`` at full width (69,632 cells, the flagship
   case's soil): hydrology-only, two-layer snow, lateral groundwater,
   Muskingum-Cunge on the grid, the packed kinematic router and the
   packed linear reservoir, each a 30-day block from 1 January through
   ``block_step(**step_kwargs())``: one launch a day, finite state, the
   residual, the switch seen at work (LAI and carbon unchanged; ``swe``
   the pack total with liquid or cold content; a lateral exchange that
   sums to zero over land; discharge and the routed water balance of one
   day), the first 3 days against the plain twin, the packed blocks run
   twice and bitwise equal, and ``day_step`` timed;
12. the carbon spin-up through the command line (``run
   --spinup-carbon 2``, on-card forcing): each rehearsal year's seconds,
   max |d slow| and mean NEE from ``spinup.SPINUP_LOG``, 365 launches a
   rehearsal year and in the year after;
13. site mode through the command line (``site --engine kernel`` on the
   card, 10 summer days at nisurf 48): the daily CSV against ``--engine
   oracle`` (theta within 5e-3), and ms per site-day on the card and
   with ``--device cpu``;
14. the closed loop through the command line at 0.5 degrees, float32:
   ``ensemble --members 8`` for the whole default year (365 kernel
   launches at 557,056 cells, a finite file with spread on land, member 0
   against the control run unfolded, the first folded day against the
   folded plain twin with knife-edge cells set aside), ``assimilate
   --members 16 --days 5 --obs-twin 0.5`` (5 launches at 1,114,112
   cells, a finite posterior within the clamp, the padding lanes'
   multipliers bitwise their first draw from the card's generator),
   ``calibrate --obs-twin 0.4 --fields hksat --days 1 --steps 2`` with a
   scalar and a per-cell theta (no kernel launch, finite gradients, the
   loss falls; one Adam step's seconds and the fit's peak memory), the
   kernel wrapper raising under autograd, and the site ``calibrate`` of
   tests/test_calibrate.py, cut to 4 days, on the card and the CPU; the kernel day at both
   folded widths with its rounds, the ensemble day and year, and a DA
   cycle's forecast and analysis;
15. multiple processes on the one card: ``python -m hybrid9_tpu_torch
   run --shard`` of ``Config()`` at 0.5 degrees (device-synthetic
   forcing) launched as 1, 2 and 4 ranks of a gloo group
   (``multi_rank_path``): each rank launches the day kernel once a day on
   its slab and gathers the router's operands once a day; the 2- and
   4-rank ``axy1901.nc`` bitwise the 1-rank file with no part file left;
   1902 resumed by 2 ranks from the 2-rank run's checkpoint bitwise its
   straight 1902; that checkpoint refused under 1 rank; each rank's
   seconds a year, collectives a day and peak memory; then ``ensemble``,
   ``assimilate`` and ``calibrate --per-cell`` with ``--shard`` as 2
   ranks at 2 degrees and 4 substeps against one process.  A rank that
   fails fails the phase;
16. the study programs, each through ``python -m
   hybrid9_tpu_torch.scripts.<name>`` in a child process on the card, one
   after another (``study_path``): ``flagship_soak --years 2`` (every
   year clean), ``flagship_run --years 2`` (two annual files, the worst
   residual under 0.1 mm), ``router_compare --iters 10 --soak-years 1``
   (ms a day per scheme, each soak clean), ``da_soak --resolution 0.25
   --days 2`` (16 members of the 0.25-degree grid, 4,440,064 cells, in
   one kernel launch a day), ``zd09_drift --ks 1,8 --years 2`` at
   reference scope (the JSON written, every number finite, the verdict
   recorded); each leg's launches, cells and mean kernel ms; then
   ``zd09_debug``'s isolation matrix on a reference-scope day: kernel
   against twin at k=8 and k=1, knife-edge cells set aside as in phase 3;
17. device slabs of one process on the card (``slab_path``): 5 flagship
   days through ``block_step(devices=[cuda:0] * k)`` at k = 4 and 3
   (uneven), the cells resident on their slabs and the router split into
   row bands with halo rows: bitwise (``torch.equal``) the unsharded
   block, k launches a day, the census of halo rows and reshards; the
   routed water balance of a resident day; 30 days of
   ``Simulation(devices=[cuda:0] * 4)``'s run loop, its annual file byte
   for byte one slab's; the flagship day at 1, 2 and 4 slabs and
   unsharded (``scripts.slab_timing``: ms, launches, host syncs a day,
   none added by the slabs); ``scripts.halo_rehearsal`` at 0.5 degrees in
   8 bands, exit 0, its two routed days;
18. the closed loop and the carbon spin-up on device slabs of one process
   (``slab_loop_path``), ``[cuda:0] * k`` at k = 4 and 3 against the
   unsharded drivers: 10 days of ``run_ensemble_annual`` (8 members,
   557,056 folded cells) and 5 cycles of ``assimilate`` (16 members,
   1,114,112 cells) bitwise, k kernel launches a day and nothing
   exchanged before the one join of the outputs; a 1-step per-cell
   ``calibrate`` at 2 degrees within ``LOOP_FIT_RTOL`` of the unsharded
   fit, its gradients finite; one rehearsal year of ``spinup_carbon`` on
   ``Simulation(devices=[cuda:0] * k)`` at k = 4, 1 and 2 bitwise the
   unsharded year's report and state, k launches a day; ``ensemble``,
   ``assimilate`` and ``calibrate --config`` through ``cli.main``, with
   ``--shard`` on 3 slabs of the card (as on a box of 3 cards) the files
   the commands write without it; the ensemble day, the DA cycle and its
   forecast (ms, launches, host syncs), the fit's Adam step and peak
   memory and the rehearsal year's seconds at k = 1, 2, 4 and unsharded;
19. a global year at 10 layers through the command line
   (``layer_year_path``): a raw soil archive of 10 layers at 0.5 degrees,
   ``prep-soil --layers 10``, ``run --years 1901 1901`` on
   ``exponential_interfaces(10)`` (365 launches of ``day_kernel_any``, the
   annual file and every day's residual checked); then 30 days in this
   process, ``day_kernel_any`` against the twin on the winter state at full
   width, its ms (its all-shared form's, and both in float64) against the
   fixed nl=8 build's and its own at nl=8 on the flagship winter state, in
   turns, and the two ratios to the fixed build; each register build
   against the all-shared form at the ends of its range (``build_times``);
   the bound at 10 layers, and 5 days of ``block_step(devices=[cuda:0] *
   3)`` bitwise the unsharded block;
20. the soil-heat kernel against its plain twin on the same tensors
   (``soil_heat_path``): every build at 3, 8, 10, 20, 32 and 40 layers,
   winter and varied states, with and without the ice store and
   ``sw_abs``, float64 within 1e-10 and float32 with no layer flipped
   across the freezing band and within 1e-3 K; then at the main path's
   widths (69,632 cells at 8 and 10 layers with the ice store, the
   folded 557,056 at 8 and 10 and 1,114,112 at 8 without), each timed
   with its twin by CUDA events beside its byte bound.  Every path above
   that runs ``day_step``, ``block_step`` or slabs on the card launches
   the soil-heat kernel as often as the day kernel (``read_launches``).

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import logging
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.optim import optimizer

from hybrid9_tpu_torch import calendar, cli, kernels
from hybrid9_tpu_torch.calibrate import apply_multipliers
from hybrid9_tpu_torch.config import (CANONICAL_ZI_MM, Config, LayerGrid,
                                      exponential_interfaces)
from hybrid9_tpu_torch.data.synthetic import (synthesize_raw_soil_archive,
                                              synthetic_forcing_block,
                                              synthetic_forcing_day,
                                              synthetic_soil_params)
from hybrid9_tpu_torch.entry import (build_flagship_case,
                                     build_reference_case)
from hybrid9_tpu_torch.data.device_forcing import \
    DeviceSyntheticForcingProvider
from hybrid9_tpu_torch.data.forcing import (PGF_VARIABLES,
                                            NetCDFForcingProvider)
from hybrid9_tpu_torch.data.soil import load_soil
from hybrid9_tpu_torch.ensemble import fold
from hybrid9_tpu_torch.io.netcdf import read_grid_file
from hybrid9_tpu_torch.io.writer import ANNUAL_UNITS
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics import day_kernel, soil_heat
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.physics.lateral import lateral_groundwater_step
from hybrid9_tpu_torch.physics.soiltemp import freeze_impedance_from_ice
from hybrid9_tpu_torch.run import OUTPUT_LOG, YEAR_LOG, Simulation
from hybrid9_tpu_torch.spinup import SPINUP_LOG
from hybrid9_tpu_torch.state import (AnnualAccumulators, Forcing, SoilParams,
                                     initial_state)
from hybrid9_tpu_torch.step import (annual_means, block_step, day_step,
                                    snow_absorptivity)

N_CELLS = 66_560          # reference scope: padded global 0.5-degree land
N_FLAGSHIP = 69_632       # Config() defaults: the 0.5-degree land grid
N_QUARTER_DEGREE = 282_624  # the 0.25-degree land grid's cell count
N_CHECK = 4_096           # cells for the kernel-vs-twin cases
REFERENCE_DAYS = 10
FLAGSHIP_DAYS = 30
SHARDED_DAYS = 5
SLABS = 4
YEARS = (1901, 1902)      # the year path's run
PGF_DAYS = 30
FOCUS_SITE = "vaira"
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory and
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67.0e12
# (rtol, atol) per output: float32 at the tolerances of
# tests/test_pallas_day.py, the two daily sums it leaves out held like
# evap_day.  The matric potential smp = psi_s * s**-bsw moves bsw times
# as fast, relatively, as the water it is computed from, so its relative
# tolerance is h2osoi_liq's times the layer's bsw (2.2-8.6 in the
# synthetic soils); that also covers the near-dry layers up to the SMPMIN
# clamp at -1e8 mm, and |smp| >= |psi_s| keeps the 1 mm atol small.
F32_TOL = dict(h2osoi_liq=(5e-4, 5e-3), zwt=(5e-4, 1e-5),
               wa=(5e-4, 5e-3), smp=(5e-4, 1.0),
               evap_day=(5e-3, 1e-3), evap_grnd_day=(5e-3, 1e-3),
               rnf_day=(5e-3, 1e-3))
# float64 also holds max_abs_residual against the twin's, as the CPU
# tests hold the twin's against JAX.
F64_TOL = dict({k: (1e-9, 1e-9) for k in F32_TOL},
               max_abs_residual=(1e-6, 1e-9))
MAX_RESIDUAL_MM = 0.1
# Float32 knife edges (see knife_edge_cells): a water table ending this
# close to the column bottom, in metres; at most this share of a case's
# cells may be knife edges.
KNIFE_EDGE_M = 0.005
MAX_KNIFE_EDGE_SHARE = 0.05
# A float32 twin day this share of F32_TOL from the float64 day of the
# same inputs is ill-conditioned (see float32_noise_cells).
F32_NOISE_SHARE = 0.5


def _fields(soil, diags):
    """The soil state and every daily sum but the residual."""
    return dict(h2osoi_liq=soil.h2osoi_liq, zwt=soil.zwt, wa=soil.wa,
                smp=soil.smp, **{k: v for k, v in diags.items()
                                 if k != "max_abs_residual"})


def _outside(got, want, tol, bsw):
    """Per field, the [n] mask of cells where ``got`` is not finite or is
    outside ``tol`` of ``want`` (smp's rtol scaled by ``bsw``)."""
    out = {}
    for name in got:
        rtol, atol = tol[name]
        a, b = got[name].double(), want[name].double()
        if name == "smp":
            rtol = rtol * bsw.double()
        bad = ~torch.isfinite(a) | ((a - b).abs() > atol + rtol * b.abs())
        out[name] = bad if bad.dim() == 1 else bad.any(dim=1)
    return out


def _compare(label, got, want, tol, bsw, held=None):
    """Raise unless every field of ``got`` is finite and within ``tol`` of
    ``want`` in every cell of the mask ``held`` (default: all); return
    the max |got - want| of h2osoi_liq over those cells."""
    if held is None:
        held = torch.ones_like(got["zwt"], dtype=torch.bool)
    for name, bad in _outside(got, want, tol, bsw).items():
        bad = bad & held | ~torch.isfinite(got[name]).reshape(
            bad.shape[0], -1).all(dim=1)
        if bool(bad.any()):
            d = (got[name].double() - want[name].double()).abs()
            d = d if d.dim() == 1 else d.amax(dim=1)
            raise RuntimeError(
                f"{label}: {name} off by up to {float(d[bad].max()):.3e} "
                f"at {int(bad.sum())} cells (rtol {tol[name][0]}, atol "
                f"{tol[name][1]})")
    d = (got["h2osoi_liq"].double() - want["h2osoi_liq"].double()).abs()
    return float(d.amax(dim=1)[held].max())


def twin_days(variants, veg, forcing, geom, dt=1800.0, nisurf=48, **kw):
    """The plain twin's day of each ``(soil, params)`` of ``variants``,
    beside ``veg``, ``forcing`` and ``kw``, as one twin day of the cells
    that many times over: the day is cell-local, so each cell's day is the
    one it has alone, and the twin, bound by its launches, takes about the
    time of one day.  Returns a ``(SoilState, diags)`` pair a variant."""
    k, n = len(variants), variants[0][0].zwt.shape[0]

    def cat(objs):
        return type(objs[0])(**{f.name: torch.cat([getattr(o, f.name)
                                                    for o in objs])
                                for f in dataclasses.fields(objs[0])})

    def rep(x):
        return torch.cat([x] * k) if isinstance(x, torch.Tensor) else x
    soil, diags = day_kernel.hydrology_day_plain(
        cat([v[0] for v in variants]), veg.map(rep),
        cat([v[1] for v in variants]), forcing.map(rep), geom, dt, nisurf,
        **{key: rep(v) for key, v in kw.items()})
    return [(soil.map(lambda x, i=i: x[i * n:(i + 1) * n]),
             {key: v[i * n:(i + 1) * n] for key, v in diags.items()})
            for i in range(k)]


def _nudged_soils(soil):
    """The soil water and water table nudged one ulp up, then down."""
    def nudge(x, toward):
        return torch.nextafter(x, torch.full_like(x, toward))
    return [soil.replace(h2osoi_liq=nudge(soil.h2osoi_liq, toward),
                         zwt=nudge(soil.zwt, toward))
            for toward in (float("inf"), float("-inf"))]


def _knife_edges(want, nudged, geom, params):
    """knife_edge_cells of the twin's day ``want`` and its nudged days."""
    bottom = geom.zi[len(geom.dz_soil)] / 1000.0
    edge = (want[0].zwt.double() - bottom).abs() < KNIFE_EDGE_M
    base = _fields(*want)
    for day in nudged:
        for bad in _outside(_fields(*day), base, F32_TOL,
                            params.bsw).values():
            edge |= bad
    return edge


def knife_edge_cells(soil, veg, params, forcing, geom, want, dt=1800.0,
                     nisurf=48, **kw):
    """Float32 cells on a knife edge, found from the plain twin alone: its
    water table ends within KNIFE_EDGE_M of the column bottom, where the
    ``zwt > zi/1000`` branch switches between the in-column and the
    below-column drainage, or its day moves beyond F32_TOL when the
    initial soil water and water table are nudged one ulp up or down.  On
    such a cell a one-ulp difference between two float32 programs (nvcc's
    FMA contraction is one) can flip a branch and move it by millimetres
    within the day.  Both nudged days are one :func:`twin_days` call."""
    nudged = twin_days([(s, params) for s in _nudged_soils(soil)], veg,
                       forcing, geom, dt, nisurf, **kw)
    return _knife_edges(want, nudged, geom, params)


def twin_and_knife_edges(soil, veg, params, forcing, geom, dt=1800.0,
                         nisurf=48, **kw):
    """The plain twin's day of these inputs and its
    :func:`knife_edge_cells`, from one :func:`twin_days` call."""
    want, *nudged = twin_days(
        [(soil, params)] + [(s, params) for s in _nudged_soils(soil)], veg,
        forcing, geom, dt, nisurf, **kw)
    return want, _knife_edges(want, nudged, geom, params)


def float32_noise_cells(soil, veg, params, forcing, geom, want, dt=1800.0,
                        nisurf=48, **kw):
    """Float32 cells whose plain-twin day ``want`` lies more than
    F32_NOISE_SHARE of F32_TOL from the float64 day of the same inputs:
    float32 rounding alone moves them that far, so no two float32
    programs need agree on them within F32_TOL (on the exponential grids,
    a near-dry top layer of 20 mm under a bare canopy's evaporation, and
    tables crossing many thin layers in a day)."""
    def up(x):
        return x.double() if isinstance(x, torch.Tensor) else x
    exact = day_kernel.hydrology_day_plain(
        soil.map(up), veg.map(up), params.map(up), forcing.map(up), geom,
        dt, nisurf, **{k: up(v) for k, v in kw.items()})
    part = {k: (rtol * F32_NOISE_SHARE, atol * F32_NOISE_SHARE)
            for k, (rtol, atol) in F32_TOL.items()}
    noisy = torch.zeros_like(soil.zwt, dtype=torch.bool)
    for bad in _outside(_fields(*want), _fields(*exact), part,
                        params.bsw).values():
        noisy |= bad
    return noisy


def rounding_explained(got, want, soil, veg, params, forcing, geom, held,
                       dt=1800.0, nisurf=48, **kw):
    """The float32 cells of ``held`` whose day ``got`` lies outside F32_TOL
    of the plain twin's ``want`` but within F32_TOL of the twin's day from
    inputs one ulp away (``theta_s``, ``psi_s``, ``bsw``, ``hksat``, the
    soil water or the water table nudged up or down, one at a time): knife
    edges that a perturbation of the size of a rounding flips, so that
    ``got`` is the twin's day to rounding.  The twelve nudged days are one
    :func:`twin_days` call, made only if there is such a cell; any that
    none explains stays held."""
    def outside(a, b):
        bad = torch.zeros_like(held)
        for x in _outside(_fields(*a), _fields(*b), F32_TOL,
                          params.bsw).values():
            bad |= x
        return bad

    left = outside(got, want) & held
    explained = torch.zeros_like(held)
    if not bool(left.any()):
        return explained
    variants = []
    for name in ("theta_s", "psi_s", "bsw", "hksat", "h2osoi_liq", "zwt"):
        owner = soil if name in ("h2osoi_liq", "zwt") else params
        x = getattr(owner, name)
        for toward in (float("inf"), float("-inf")):
            nudged = owner.replace(**{name: torch.nextafter(
                x, torch.full_like(x, toward))})
            variants.append((nudged, params) if owner is soil
                            else (soil, nudged))
    for day in twin_days(variants, veg, forcing, geom, dt, nisurf, **kw):
        explained |= left & ~outside(got, day)
    return explained


def check_day(label, got, want, bsw, held=None):
    """Hold a kernel day ``got`` against the twin's day ``want`` (each a
    ``(SoilState, diags)`` pair): every output at its tolerance in the
    cells of ``held`` (default: all), the water balance within
    MAX_RESIDUAL_MM in all, and in float64 the residual against the
    twin's.  Returns (max |diff| of h2osoi_liq in mm, max residual in
    mm)."""
    fields = [_fields(*got), _fields(*want)]
    tol = F32_TOL
    if got[0].h2osoi_liq.dtype == torch.float64:
        tol = F64_TOL
        for f, day in zip(fields, (got, want)):
            f["max_abs_residual"] = day[1]["max_abs_residual"]
    err = _compare(label, *fields, tol, bsw, held)
    res = float(got[1]["max_abs_residual"].max())
    if not res < MAX_RESIDUAL_MM:
        raise RuntimeError(f"{label}: residual {res} mm")
    return err, res


# Kernel-vs-twin regimes: float32 on the reference states and on columns
# across regimes off the interfaces; float64 on columns across regimes
# with water tables on the column-bottom interface too; both on the edge
# states.
CHECK_REGIMES = ((torch.float32, "reference"),
                 (torch.float32, "varied_off_interfaces"),
                 (torch.float64, "varied"),
                 (torch.float32, "edge"),
                 (torch.float64, "edge"))
# The three forcings of the edge states (tests/test_edge_states.py):
# deluge, dry heat and frozen calm.
EDGE_FORCINGS = (
    dict(tas=288.0, rlds=350.0, rsds=180.0, huss=8e-3, ps=101325.0,
         pr=5.0e-4, rhs=95.0),
    dict(tas=313.0, rlds=380.0, rsds=400.0, huss=4e-3, ps=98000.0,
         pr=0.0, rhs=12.0),
    dict(tas=258.0, rlds=180.0, rsds=30.0, huss=8e-4, ps=102000.0,
         pr=0.0, rhs=70.0))
EDGE_COLUMNS = 64


def edge_columns(nl, grid):
    """The columns of tests/test_edge_states.py::_build_edge_ensemble on
    the branch boundaries of the drainage and water-table walks, at ``nl``
    layers: ``zwt`` exactly on an interface (interfaces 1 to nl + 1 in
    turn, each one at nl = 8 as there, every one of them at nl <= 35), at
    0, at the 80 m clamp and 1e-6 m below the column; every layer at
    WATMIN; a saturated column; the bottom or the top layer at half
    WATMIN.  Float64 numpy arrays (params, h2osoi, zwt, wa, smp, lai,
    lai_litter, rootr), one row a column."""
    zi, dz = grid.zi, grid.dz
    n = EDGE_COLUMNS
    p = synthetic_soil_params(n, seed=42, n_layers=nl)
    rng = np.random.RandomState(42)
    h2osoi = rng.uniform(0.3, 0.9, size=(n, nl)) * p["theta_s"] \
        * dz[None, :nl]
    zwt = np.empty(n)
    for i in range(n):
        k = i % 16
        if k < 9:
            zwt[i] = zi[1 + (i // 16 * 9 + k) % (nl + 1)] / 1000.0
        elif k == 9:
            zwt[i] = 0.0
        elif k == 10:
            zwt[i] = 80.0
        elif k == 11:
            zwt[i] = zi[nl] / 1000.0 + 1e-6
        elif k == 12:
            h2osoi[i] = np.full(nl, c.WATMIN)
            zwt[i] = 1.0
        elif k == 13:
            h2osoi[i] = p["theta_s"][i] * dz[:nl]
            zwt[i] = 0.05
        elif k == 14:
            h2osoi[i, nl - 1] = 0.5 * c.WATMIN
            zwt[i] = 3.0
        else:
            h2osoi[i, 0] = 0.5 * c.WATMIN
            zwt[i] = 0.2
    wa = np.where(np.arange(n) % 3 == 0, 5000.0, 3000.0)
    s = np.clip(h2osoi / dz[None, :nl] / p["theta_s"], 0.01, 1.0)
    smp = np.maximum(c.SMPMIN, p["psi_s"] * s ** (-p["bsw"]))
    lai = np.where(np.arange(n) % 4 == 0, 0.001, 2.0)
    return (p, h2osoi, zwt, wa, smp, lai, np.full(n, 0.2),
            np.full((n, nl), 1.0 / nl))


#: A float32 layer that moves by more than this (K) against the twin took
#: the other side of the freezing band's crossing test (one ulp decides
#: it, and some 0.5 K follows); rounding alone moves a layer by 1e-4 K.
SOIL_HEAT_FLIP_K = 1.0e-2


def soil_heat_case(n: int, nl: int, dtype, device, regime: str = "varied",
                   seed: int = 0) -> dict:
    """Inputs of a soil-heat day at ``n`` cells and ``nl`` layers on the
    canonical 8-layer grid or the exponential grid of ``nl`` layers: the
    keyword arguments of ``physics.soil_heat.soil_heat`` but ``soil_ice``,
    ``latent_ramp`` and ``use_kernel``.  ``"winter"``: soil and air within
    a few kelvin of freezing; ``"varied"``: 262-305 K soil under 250-315 K
    air.  Water fills 5-95 % of the pores, the ice store up to half the
    liquid; ``sw_abs`` in 0.3-0.92."""
    if regime not in ("winter", "varied"):
        raise ValueError(f"unknown regime {regime!r}")
    zi = CANONICAL_ZI_MM if nl == 8 else exponential_interfaces(nl)
    geom = Geometry.from_layer_grid(LayerGrid.from_interfaces(zi))
    rng = np.random.RandomState(seed)
    dz = np.asarray(geom.dz_soil)
    theta_s = rng.uniform(0.35, 0.55, (n, nl))
    liq = rng.uniform(0.05, 0.95, (n, nl)) * theta_s * dz
    ice = rng.uniform(0.0, 0.5, (n, nl)) * liq
    if regime == "winter":
        t_soil = c.TF + rng.uniform(-6.0, 4.0, (n, nl))
        tas = c.TF + rng.uniform(-20.0, 5.0, n)
    else:
        t_soil = rng.uniform(262.0, 305.0, (n, nl))
        tas = rng.uniform(250.0, 315.0, n)
    forcing = Forcing.from_numpy(
        dict(tas=tas, rsds=rng.uniform(0.0, 350.0, n),
             rlds=rng.uniform(150.0, 420.0, n),
             ps=rng.uniform(7.0e4, 1.04e5, n), huss=np.full(n, 5.0e-3),
             pr=np.zeros(n), rhs=np.full(n, 60.0)), dtype, device)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return dict(t_soil=t(t_soil), liq=t(liq), ice=t(ice),
                theta_s=t(theta_s), lai=t(rng.uniform(0.0, 7.0, n)),
                forcing=forcing, geom=geom, dt=c.SDAY,
                sw_abs=t(rng.uniform(0.3, 0.92, n)))


def soil_heat_run(fn, inputs: dict, soil_ice: bool,
                  with_sw_abs: bool = True):
    """``fn`` (``soil_heat_cuda`` or ``soil_heat_plain``) on ``inputs``:
    the ice store and the band as the day step runs them."""
    kw = dict(inputs, soil_ice=soil_ice,
              latent_ramp=0.0 if soil_ice else 2.0)
    if not with_sw_abs:
        kw["sw_abs"] = None
    return fn(**kw)


def compare_soil_heat(got, want) -> dict:
    """Kernel outputs ``got`` against the twin's ``want`` (``(t_soil,
    liq, ice)``): the share of cells bitwise equal in every output, the
    widest gap of each output over the twin's largest magnitude of it,
    and for the temperature the layers that moved by more than
    ``SOIL_HEAT_FLIP_K`` and the widest gap (K) in the columns that hold
    none of them (a flipped layer moves its neighbours by a few mK)."""
    same = torch.ones(got[0].shape[0], dtype=torch.bool,
                      device=got[0].device)
    rel = []
    for g, w in zip(got, want):
        same &= (g == w).all(dim=1)
        scale = float(w.abs().max())
        rel.append(float((g - w).abs().max()) / scale if scale else 0.0)
    gap = (got[0] - want[0]).abs()
    flipped = gap > SOIL_HEAT_FLIP_K
    clean = ~flipped.any(dim=1)
    return dict(bitwise_cells=float(same.double().mean()), rel_gap=rel,
                flipped_layers=int(flipped.sum()),
                layers=int(gap.numel()),
                t_gap_outside_flips=float(gap[clean].max()))


#: Phase 20's limits of the soil-heat kernel against its twin: float64
#: within SOIL_HEAT_F64_REL of each output's largest magnitude; float32
#: with no layer flipped, every temperature within SOIL_HEAT_F32_K and
#: the water and ice within SOIL_HEAT_F32_REL of their largest magnitude.
SOIL_HEAT_F64_REL = 1.0e-10
SOIL_HEAT_F32_K = 1.0e-3
SOIL_HEAT_F32_REL = 1.0e-5
#: Layer counts of the accuracy sweep: the register build of capacity 8
#: at both ends, capacity 16 at 10 layers, capacity 32 at 20 and at its
#: top, and the run-time form above it; at SOIL_HEAT_CHECK_CELLS cells.
SOIL_HEAT_NLS = (3, 8, 10, 20, 32, 40)
SOIL_HEAT_CHECK_CELLS = 65_536
SOIL_HEAT_REPS = 50
SOIL_HEAT_PLAIN_REPS = 2


def soil_heat_within(label, out, dtype):
    """Raise unless :func:`compare_soil_heat`'s ``out`` is within phase
    20's limits in ``dtype``."""
    if dtype == torch.float64:
        ok = max(out["rel_gap"]) <= SOIL_HEAT_F64_REL
    else:
        ok = (out["flipped_layers"] == 0
              and out["t_gap_outside_flips"] <= SOIL_HEAT_F32_K
              and max(out["rel_gap"][1:]) <= SOIL_HEAT_F32_REL)
    if not ok:
        raise RuntimeError(f"soil-heat kernel vs twin, {label}: {out}")


def soil_heat_widths():
    """The main path's soil-heat launches: (label, cells, layers, ice
    store, ``sw_abs`` tensor).  The flagship's day and the 10-layer
    year's run the ice store under snow's absorptivity; the benchmark's
    folded ensembles and assimilation the freezing band without them."""
    return (("flagship", N_FLAGSHIP, 8, True, True),
            ("10-layer year", N_FLAGSHIP, LAYER_YEAR_NL, True, True),
            ("ensemble nl=8", ENSEMBLE_MEMBERS * N_FLAGSHIP, 8, False,
             False),
            ("ensemble nl=10", ENSEMBLE_MEMBERS * N_FLAGSHIP, 10, False,
             False),
            ("assimilation nl=8", DA_MEMBERS * N_FLAGSHIP, 8, False, False))


def soil_heat_path(dev, smi):
    """Phase 20: the soil-heat kernel (``soil_heat.soil_heat_cuda``)
    against its plain twin (``soil_heat_plain``) on the same CUDA tensors.
    First every build, at SOIL_HEAT_NLS layers on SOIL_HEAT_CHECK_CELLS
    cells of the winter and the varied state, with and without the ice
    store and ``sw_abs``, in both dtypes; then at the main path's widths
    (:func:`soil_heat_widths`, float32, the winter state), where each
    launch is also timed with the twin by CUDA events behind a sleeping
    kernel (``_time_cuda(..., queued=True)``), beside the least time its
    bytes allow (``soil_heat.cell_bytes`` over PEAK_BYTES_PER_S).  Every
    comparison within phase 20's limits (:func:`soil_heat_within`), one
    launch a kernel call and none a twin call.  Returns the summary."""
    sweep = dict(cases=0, bitwise_cases=0, max_rel_f64=0.0,
                 max_t_gap_f32=0.0, flipped_layers=0)
    for dtype in (torch.float64, torch.float32):
        for nl in SOIL_HEAT_NLS:
            for regime in ("winter", "varied"):
                inputs = soil_heat_case(SOIL_HEAT_CHECK_CELLS, nl, dtype,
                                        dev, regime, seed=nl)
                for soil_ice in (False, True):
                    for sw in (True, False):
                        label = (f"{str(dtype)[6:]} nl={nl} {regime} "
                                 f"soil_ice={soil_ice} sw_abs={sw}")
                        before = soil_heat.launches
                        got = soil_heat_run(soil_heat.soil_heat_cuda, inputs,
                                            soil_ice, sw)
                        want = soil_heat_run(soil_heat.soil_heat_plain,
                                             inputs, soil_ice, sw)
                        if soil_heat.launches != before + 1:
                            raise RuntimeError(
                                f"soil-heat kernel vs twin, {label}: "
                                f"{soil_heat.launches - before} launches")
                        out = compare_soil_heat(got, want)
                        soil_heat_within(label, out, dtype)
                        sweep["cases"] += 1
                        sweep["bitwise_cases"] += out["bitwise_cells"] == 1.0
                        sweep["flipped_layers"] += out["flipped_layers"]
                        key = ("max_rel_f64" if dtype == torch.float64
                               else "max_t_gap_f32")
                        sweep[key] = max(sweep[key], max(out["rel_gap"])
                                         if dtype == torch.float64 else
                                         out["t_gap_outside_flips"])
    print(f"soil-heat kernel vs twin, every build ({SOIL_HEAT_NLS} layers, "
          f"{SOIL_HEAT_CHECK_CELLS} cells): " + json.dumps(sweep))
    widths = {}
    for label, n, nl, soil_ice, sw in soil_heat_widths():
        inputs = soil_heat_case(n, nl, torch.float32, dev, "winter", seed=n)
        out = compare_soil_heat(
            soil_heat_run(soil_heat.soil_heat_cuda, inputs, soil_ice, sw),
            soil_heat_run(soil_heat.soil_heat_plain, inputs, soil_ice, sw))
        soil_heat_within(label, out, torch.float32)
        ms, wall_ms = _time_cuda(lambda: soil_heat_run(
            soil_heat.soil_heat_cuda, inputs, soil_ice, sw)[0],
            SOIL_HEAT_REPS, queued=True)
        plain_ms, plain_wall_ms = _time_cuda(lambda: soil_heat_run(
            soil_heat.soil_heat_plain, inputs, soil_ice, sw)[0],
            SOIL_HEAT_PLAIN_REPS, queued=True)
        nbytes = n * soil_heat.cell_bytes(nl, 4, soil_ice, sw)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        widths[label] = dict(
            cells=n, nl=nl, soil_ice=soil_ice, sw_abs=sw,
            build=soil_heat.instance_name(
                soil_heat.capacity(torch.float32, nl)),
            bitwise_cells=out["bitwise_cells"],
            max_abs_err_k=out["t_gap_outside_flips"],
            flipped_layers=out["flipped_layers"], ms=ms, wall_ms=wall_ms,
            plain_ms=plain_ms, plain_wall_ms=plain_wall_ms, bytes=nbytes,
            bound_ms=bound_ms, bandwidth_share=bound_ms / ms)
        print(f"soil-heat kernel, {label} ({n} cells, nl={nl}, f32, "
              f"soil_ice={soil_ice}, sw_abs={sw}): bitwise share "
              f"{out['bitwise_cells']}, max|kernel-twin| "
              f"{out['t_gap_outside_flips']:.3e} K; {ms * 1e3:.1f} us by "
              f"events ({wall_ms:.3f} ms issued), twin {plain_ms:.3f} ms "
              f"({plain_wall_ms:.3f} ms issued), bound {bound_ms * 1e3:.1f} "
              f"us ({bound_ms / ms:.0%} of it) ({smi})")
    return dict(sweep=sweep, widths=widths)


def check_case(n, nl, dtype, device, regime, seed=0):
    """Inputs of a kernel-vs-twin case on the canonical 8-layer grid or
    the exponential one of ``nl`` layers, with a random frozen-soil
    impedance.

    ``regime="reference"``: the reference case's initial state (water
    tables 5 m below the column) under day-180 forcing, the inputs of
    tests/test_pallas_day.py.  ``"varied"``: columns across regimes, with
    water tables inside, on the bottom of, and below the column and
    layers from near-dry (matric potential at the SMPMIN clamp) to
    near-saturated.  ``"varied_off_interfaces"``: the same columns but
    for the tables placed exactly on the column bottom, which keep their
    random depth (in float32 every one of those is a knife edge).
    ``"edge"``: the columns of :func:`edge_columns` under each of the
    three EDGE_FORCINGS, 192 cells repeated to ``n``.
    """
    if regime not in ("reference", "varied", "varied_off_interfaces",
                      "edge"):
        raise ValueError(f"unknown regime {regime!r}")
    zi = CANONICAL_ZI_MM if nl == 8 else exponential_interfaces(nl)
    grid = LayerGrid.from_interfaces(zi)
    rng = np.random.RandomState(seed + 1)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if regime == "edge":
        (raw, h2osoi, zwt, wa, smp, lai, litter,
         rootr) = edge_columns(nl, grid)
        pick = np.arange(n) % (EDGE_COLUMNS * len(EDGE_FORCINGS))
        col, regime_of = pick % EDGE_COLUMNS, pick // EDGE_COLUMNS
        params = SoilParams.from_numpy({k: v[col] for k, v in raw.items()},
                                       dtype, device)
        state = initial_state(params, grid.dz, grid.zi, dtype, device)
        soil = state.soil.replace(h2osoi_liq=t(h2osoi[col]),
                                  zwt=t(zwt[col]), wa=t(wa[col]),
                                  smp=t(smp[col]))
        veg = state.veg.replace(lai=t(lai[col]), lai_litter=t(litter[col]),
                                rootr=t(rootr[col]))
        forcing = Forcing.from_numpy(
            {k: np.array([f[k] for f in EDGE_FORCINGS])[regime_of]
             for k in EDGE_FORCINGS[0]}, dtype, device)
        imp = t(rng.uniform(0.05, 1.0, (n, nl)))
        return soil, veg, params, forcing, \
            Geometry.from_layer_grid(grid), imp
    raw = synthetic_soil_params(n, seed=seed, n_layers=nl)
    params = SoilParams.from_numpy(raw, dtype, device)
    state = initial_state(params, grid.dz, grid.zi, dtype, device)
    soil = state.soil
    if regime != "reference":
        zwt = 10.0 ** rng.uniform(np.log10(0.03), np.log10(12.0), n)
        if regime == "varied":
            zwt[::8] = grid.zi[nl] / 1000.0
        frac = rng.uniform(0.02, 0.98, (n, nl))
        smp = np.maximum(c.SMPMIN, raw["psi_s"] * frac ** (-raw["bsw"]))
        soil = soil.replace(
            h2osoi_liq=t(frac * raw["theta_s"] * grid.dz[None, :nl]),
            zwt=t(zwt), smp=t(smp))
    forcing = Forcing.from_numpy(synthetic_forcing_day(n, 180, seed=1),
                                 dtype, device)
    imp = t(rng.uniform(0.05, 1.0, (n, nl)))
    geom = Geometry.from_layer_grid(grid)
    return soil, state.veg, params, forcing, geom, imp


def check_kernel(label, case, regime, zd09_every, use_imp,
                 instances=(None,)):
    """One kernel-vs-twin case on the inputs ``case`` of
    :func:`check_case`: the kernel day against the plain twin's, once for
    each of ``instances`` (None: through the dispatch; False: the build
    for the layer count; True: ``day_kernel_any``), each a launch, all
    against one twin day.  In the float32 regimes but the reference one
    the cells of :func:`knife_edge_cells` are set aside, held only to
    finiteness and the water balance, and for ``day_kernel_any`` those of
    :func:`float32_noise_cells` and :func:`rounding_explained` too.  They
    may be at most MAX_KNIFE_EDGE_SHARE of the case but in the edge
    regime, whose columns sit on the branches by design (about half of
    its float32 cells are knife edges).  Returns (max |diff| of
    h2osoi_liq in mm over the instances, max residual in mm, the most
    cells set aside for an instance)."""
    soil, veg, params, forcing, geom, imp = case
    kw = dict(imp=imp if use_imp else None, zd09_every=zd09_every)
    rest = (veg, params, forcing, geom, 1800.0, 48)
    edge = noisy = None
    if regime != "reference" and soil.zwt.dtype == torch.float32:
        want, edge = twin_and_knife_edges(soil, *rest[:4], **kw)
    else:
        want = day_kernel.hydrology_day_plain(soil, *rest, **kw)
    fixed = len(geom.dz_soil) in day_kernel.FIXED_NLS
    err = res = 0.0
    n_edge = 0
    for any_nl in instances:
        if any_nl is None:
            got = day_kernel.hydrology_day(soil, *rest, use_kernel=True,
                                           **kw)
        else:
            got = day_kernel.hydrology_day_cuda(soil, *rest, any_nl=any_nl,
                                                **kw)
        aside = edge
        if edge is not None and (any_nl or not fixed):
            if noisy is None:
                noisy = edge | float32_noise_cells(soil, *rest[:4], want,
                                                   **kw)
            aside = noisy | rounding_explained(got, want, soil, *rest[:4],
                                               ~noisy, **kw)
        if aside is not None:
            n_edge = max(n_edge, int(aside.sum()))
            if regime != "edge" and \
                    int(aside.sum()) > MAX_KNIFE_EDGE_SHARE * aside.numel():
                raise RuntimeError(f"{label}: {int(aside.sum())} of "
                                   f"{aside.numel()} cells on a knife edge")
        e, r = check_day(label if any_nl is None else
                         f"{label} any_nl={any_nl}", got, want, params.bsw,
                         None if aside is None else ~aside)
        err, res = max(err, e), max(res, r)
    return err, res, n_edge


def _ptxas_summary(log: str) -> list:
    """(dtype, nl, imp, registers, stack frame, spill stores, spill loads)
    per kernel instance, from nvcc -Xptxas -v.  For ``day_kernel_any``
    ``nl`` is None, ``capacity`` is its layer capacity (0: the all-shared
    form) and ``exact`` whether it is a register build's instance for nl
    equal to the capacity."""
    out = []
    for block in re.split(r"Compiling entry function", log)[1:]:
        m = re.search(r"day_kernelI([fd])Li(\d+)ELb([01])E", block)
        m_any = re.search(r"day_kernel_anyI([fd])Lb([01])ELi(\d+)ELb([01])E",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        if (m or m_any) and regs:
            entry = dict(dtype="f32" if (m or m_any).group(1) == "f"
                         else "f64",
                         nl=int(m.group(2)) if m else None,
                         imp=(m.group(3) if m else m_any.group(2)) == "1",
                         registers=int(regs.group(1)),
                         stack_frame=int(spill.group(1)) if spill else 0,
                         spill_stores=int(spill.group(2)) if spill else 0,
                         spill_loads=int(spill.group(3)) if spill else 0)
            if m_any:
                entry.update(capacity=int(m_any.group(3)),
                             exact=m_any.group(4) == "1")
            out.append(entry)
    return out


#: Clock cycles a second of ``torch.cuda._sleep``'s spin at the H100's
#: highest clock, so a sleep of this many cycles a second lasts at least
#: that long.
SLEEP_CYCLES_PER_S = 2.0e9


def _time_cuda(fn, reps, queued=False):
    """Mean ms per call of ``fn`` (which returns a tensor) by CUDA events
    and by the host clock; the timed window closes with a device-to-host
    checksum and a synchronize.  With ``queued`` the timed calls wait on
    the card behind a sleeping kernel that outlasts their issue, so the
    events time the device's work alone, not the host's pace; the host's
    ms are then those of the same calls issued without it."""
    fn()
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        issue = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if queued:
        torch.cuda._sleep(int(2 * issue * SLEEP_CYCLES_PER_S) + 10_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    checksum = float(out.sum())
    torch.cuda.synchronize()
    wall = issue if queued else time.perf_counter() - t0
    if not np.isfinite(checksum):
        raise RuntimeError("non-finite checksum in a timed run")
    return start.elapsed_time(stop) / reps, wall * 1e3 / reps


def day_bound(day_args, imp, zd09_every):
    """The least time this card could take for the hydrology day on these
    inputs: the larger of bytes over the memory rate (each input read
    once, each output written once) and operations over the float32 rate
    outside the tensor cores.  The operations are the kernel's own along
    the path each cell takes (``day_kernel.day_operations``: adds,
    subtracts, multiplies and divides, and each pow or exp as one), by
    where each cell's water table stands in these inputs.  Returns a dict
    with ``bound_ms``, ``bound_by`` and the counts."""
    soil, _, _, _, geom, _, nisurf = day_args
    n, nl = soil.h2osoi_liq.shape
    item = soil.h2osoi_liq.element_size()
    layered_in = 7 + (imp is not None)      # h2osoi, smp, rootr, 4 params
    # zwt, wa, lai, litter, fmax, the raw forcing and the absorptivity
    flat_in = 5 + len(day_kernel._FORCING_KEYS) + 1
    values = n * (layered_in * nl + flat_in + 2 * nl + 6)
    interfaces_m = torch.tensor(geom.zi[1:nl + 1], dtype=soil.zwt.dtype,
                                device=soil.zwt.device) / 1000.0
    jwt = (soil.zwt[:, None] > interfaces_m).sum(dim=1)
    arithmetic, transcendental = (int(x.sum()) for x in (
        day_kernel.day_operations(nl, nisurf, zd09_every, imp is not None,
                                  jwt)))
    bytes_ms = values * item / PEAK_BYTES_PER_S * 1e3
    ops_ms = (arithmetic + transcendental) / PEAK_F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, operations_ms=ops_ms,
                bytes=values * item,
                arithmetic_per_cell_day=arithmetic / n,
                transcendental_per_cell_day=transcendental / n,
                cells_with_table_below_column=int((jwt == nl).sum()))


def _all_finite(label, named):
    for key, x in named:
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{label}: non-finite {key}")


def _state_leaves(state):
    leaves = []
    state.map(lambda x: leaves.append(x) or x)
    return leaves


#: The soil-heat kernel's launches on each path that :func:`read_launches`
#: read, by the path's label (the ``kernels`` line reports them).
HEAT_LAUNCHES = {}


def zero_launches():
    """Set the day kernel's and the soil-heat kernel's launch counts to 0
    before a path runs."""
    day_kernel.launches = 0
    soil_heat.launches = 0


def read_launches(label):
    """The day kernel's launches since :func:`zero_launches`, once the
    soil-heat kernel is found to have launched as often: each model day
    that ``day_step``, ``block_step`` or a slab path runs on the card
    launches each once (once a slab), and a day on the twin neither.
    Keeps the soil-heat count in HEAT_LAUNCHES under ``label``."""
    launches = day_kernel.launches
    HEAT_LAUNCHES[label] = soil_heat.launches
    if soil_heat.launches != launches:
        raise RuntimeError(f"{label}: {soil_heat.launches} soil-heat kernel "
                           f"launches beside {launches} of the day kernel")
    return launches


def check_block(label, state, means, days, launches):
    """The checks every driven block must pass: one kernel launch per day,
    finite state and annual means, the water balance, and theta and zwt
    in their physical ranges.  Returns a one-line summary."""
    if launches != days:
        raise RuntimeError(f"{label} launched the day kernel {launches} "
                           f"times in {days} days")
    _all_finite(label, list(means.items())
                + [(f"state[{i}]", x)
                   for i, x in enumerate(_state_leaves(state))])
    res = float(means["max_abs_residual"].max())
    theta = means["theta"]
    zwt = state.soil.zwt
    if not res < MAX_RESIDUAL_MM:
        raise RuntimeError(f"{label}: residual {res} mm")
    if not (float(theta.min()) > 0.0 and float(theta.max()) < 0.55):
        raise RuntimeError(f"{label}: theta in [{float(theta.min())}, "
                           f"{float(theta.max())}]")
    if not (float(zwt.min()) >= 0.0 and float(zwt.max()) <= 80.0):
        raise RuntimeError(f"{label}: zwt in [{float(zwt.min())}, "
                           f"{float(zwt.max())}]")
    return (f"{launches} kernel launches, max residual {res:.3e} mm, theta "
            f"[{float(theta.min()):.4f}, {float(theta.max()):.4f}], zwt "
            f"[{float(zwt.min()):.3f}, {float(zwt.max()):.3f}] m, mean evap "
            f"{float(means['evap'].mean()):.4e} mm/s")


def compare_blocks(label, got, want, bsw, held=None):
    """Two ``(state, acc)`` results of the same block, kernel against
    plain twin, at F32_TOL on the soil state and the summed daily
    fluxes."""
    return _compare(label, *[_fields(s.soil, dict(evap_day=a.evap_sum,
                                                  rnf_day=a.rnf_sum))
                             for s, a in (got, want)], F32_TOL, bsw, held)


def check_sharded(label, day_args, kw, devices, held=None):
    """``hydrology_day_sharded`` over ``devices``: one kernel launch per
    slab; bitwise the unsharded kernel day on every output; and held
    against its plain version (the same call with ``use_kernel=False``)
    as :func:`check_day` holds a kernel day, in the cells of ``held``.
    Returns the max |sharded - plain| of h2osoi_liq in mm."""
    before = day_kernel.launches
    got = day_kernel.hydrology_day_sharded(*day_args, devices=devices, **kw)
    rose = day_kernel.launches - before
    if rose != len(devices):
        raise RuntimeError(f"{label}: {rose} kernel launches for "
                           f"{len(devices)} slabs")
    plain = day_kernel.hydrology_day_sharded(
        *day_args, devices=devices, use_kernel=False, **kw)
    if day_kernel.launches != before + rose:
        raise RuntimeError(f"{label}: the plain version launched the kernel")
    err = check_day(f"{label} vs its plain version", got, plain,
                    day_args[2].bsw, held)[0]
    want = day_kernel.hydrology_day_cuda(*day_args, **kw)

    def outputs(day):
        return dict(_fields(*day), h2osoi_liq_ma=day[0].h2osoi_liq_ma,
                    max_abs_residual=day[1]["max_abs_residual"])

    got = outputs(got)
    for name, x in outputs(want).items():
        y = got[name]
        if y.device != x.device or not torch.equal(x, y):
            raise RuntimeError(f"{label}: {name} is not bitwise the "
                               f"unsharded kernel's")
    return err


def check_focus(label, day_args, kw, cells, held):
    """The kernel's focus-cell trace on ``day_args``: with each focus cell
    of ``cells`` every other output of the kernel day is bitwise that of
    the day without a focus; the trace ends at the cell's new water
    table; and where ``held`` (off knife edges) it is held against the
    plain twin's trace of that cell (run on the cell alone: the physics
    is cell-local) at zwt's tolerance.  Returns (max |kernel - twin| of
    the held traces in m, number of cells held)."""
    def outputs(day):
        return dict(_fields(*day), max_abs_residual=day[1][
            "max_abs_residual"])

    base = outputs(day_kernel.hydrology_day_cuda(*day_args, **kw))
    soil, veg, params, forcing = day_args[:4]
    tol = F64_TOL if soil.zwt.dtype == torch.float64 else F32_TOL
    err, n_held = 0.0, 0
    for cell in cells:
        got = day_kernel.hydrology_day_cuda(*day_args, focus_idx=cell, **kw)
        trace = got[1].pop("wt_substeps")
        for name, x in outputs(got).items():
            if not torch.equal(x, base[name]):
                raise RuntimeError(f"{label}: {name} with focus {cell} is "
                                   f"not bitwise the day without a focus")
        if trace.shape != (day_args[6],) or not torch.equal(
                trace[-1], got[0].zwt[cell]):
            raise RuntimeError(f"{label}: the trace of cell {cell} does not "
                               f"end at its water table")
        if not bool(held[cell]):
            continue

        def one(x):
            return x[cell:cell + 1]
        extra = {k: (one(v) if isinstance(v, torch.Tensor) else v)
                 for k, v in kw.items()}
        want = day_kernel.hydrology_day_plain(
            soil.map(one), veg.map(one), params.map(one), forcing.map(one),
            *day_args[4:], focus_idx=0, **extra)[1]["wt_substeps"]
        rtol, atol = tol["zwt"]
        d = (trace.double() - want.double()).abs()
        if bool((d > atol + rtol * want.double().abs()).any()):
            raise RuntimeError(f"{label}: the trace of cell {cell} is off "
                               f"the twin's by {float(d.max()):.3e} m")
        err, n_held = max(err, float(d.max())), n_held + 1
    return err, n_held


class YearLog(logging.Handler):
    """Collects the year loop's log records by their arguments
    (``run.YEAR_LOG``, ``run.OUTPUT_LOG``, ``cli.RESUME_LOG``), with the
    day kernel's launch count at the end of each year."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.years, self.outputs, self.restores = [], {}, []

    def emit(self, record):
        if record.msg == YEAR_LOG:
            year, days, seconds, rate, wait, res = record.args
            self.years.append(dict(
                year=year, days=days, seconds=seconds, cell_days_per_s=rate,
                forcing_wait_s=wait, max_residual_mm=res,
                launches=day_kernel.launches))
        elif record.msg == OUTPUT_LOG:
            year, write_s, checkpoint_s = record.args
            self.outputs[year] = dict(write_s=write_s,
                                      checkpoint_s=checkpoint_s)
        elif record.msg == cli.RESUME_LOG:
            self.restores.append(dict(year=record.args[0],
                                      seconds=record.args[1]))


def run_years(tmp, name, log, argv=(), **cfg_kw):
    """``cli.main(["run", ...])`` on a Config file of ``cfg_kw`` with its
    output and checkpoints under ``tmp/name``, the kernel's count set to
    0 just before; returns (wall seconds, launches, the years' records
    with their launches per year, the output directory)."""
    out = os.path.join(tmp, name)
    cfg = Config(output_path=out, checkpoint_path=out + "_ck", **cfg_kw)
    path = out + ".json"
    with open(path, "w") as f:
        f.write(cfg.to_json())
    first = len(log.years)
    zero_launches()
    t0 = time.perf_counter()
    rc = cli.main(["run", "--config", path, *argv])
    wall = time.perf_counter() - t0
    launches = read_launches(f"year path {name}")
    if rc != 0:
        raise RuntimeError(f"year path {name}: exit code {rc}")
    years = log.years[first:]
    before = 0
    for y in years:
        y["launches"], before = y["launches"] - before, y["launches"]
        y.update(log.outputs.get(y["year"], {}))
    return wall, launches, years, out


def check_annual_file(label, path, land, theta_s):
    """An annual file as the year path must write it: every field finite
    on land and fill (NaN when read) over the ocean; theta in
    (0, theta_s] (with 1e-6 relative slack for the float32 rounding of
    the two written means); the land water balance within
    MAX_RESIDUAL_MM.  Returns (max residual, theta min, theta max)."""
    fields = read_grid_file(path, list(ANNUAL_UNITS))
    for name, x in fields.items():
        on_land = x[land]
        if not np.isfinite(on_land).all():
            raise RuntimeError(f"{label}: {name} is not finite on land")
        if np.isfinite(x[~land]).any():
            raise RuntimeError(f"{label}: {name} is not fill over the ocean")
    theta = fields["theta"][land]
    cap = theta_s[land] * (1.0 + 1e-6)
    if not (theta.min() > 0.0 and (theta <= cap).all()):
        raise RuntimeError(f"{label}: theta in [{theta.min()}, "
                           f"{theta.max()}] against theta_s")
    res = float(fields["max_abs_residual"][land].max())
    if not res < MAX_RESIDUAL_MM:
        raise RuntimeError(f"{label}: residual {res} mm")
    return res, float(theta.min()), float(theta.max())


def year_path(tmp, dev, smi, argv=(), **cfg_kw):
    """Phase 10, the year loop at full width through the command line:
    two flagship years with on-device forcing, a focus site and a
    checkpoint a year; 1902 resumed from the 1901 checkpoint into another
    directory, without a focus; one year of host forcing through the
    prefetch, in one block and in 30-day blocks; and 30 days of a
    NetCDF-3 PGF-style archive written here and read back.  ``cfg_kw``
    and ``argv`` are for rehearsals on a small grid: the card runs
    ``Config()`` as it stands.  Returns the phase's summary."""
    log = YearLog()
    logger = logging.getLogger("hybrid9_tpu_torch")
    logger.addHandler(log)
    try:
        wall, launches, years, out = run_years(
            tmp, "straight", log, ["--focus", FOCUS_SITE, *argv],
            forcing="device-synthetic", start_year=YEARS[0],
            end_year=YEARS[1], checkpoint_every_years=1, **cfg_kw)
        ndays = [y["days"] for y in years]
        if len(years) != 2 or [y["launches"] for y in years] != ndays or \
                launches != sum(ndays):
            raise RuntimeError(f"year path: {launches} kernel launches, "
                               f"by year {years}")
        init = read_grid_file(os.path.join(out, "init_diagnostics.nc"),
                              ["land_mask", "theta_s"])
        land = init["land_mask"] == 1.0
        files = {y: check_annual_file(f"axy{y}.nc",
                                      os.path.join(out, f"axy{y}.nc"),
                                      land, init["theta_s"])
                 for y in YEARS}
        with open(os.path.join(out, "focus_daily.csv")) as f:
            daily = f.read().splitlines()[1:]
        with open(os.path.join(out, "focus_wt.csv")) as f:
            wt = np.array([r.split(",") for r in f.read().splitlines()[1:]],
                          np.float64)
        nisurf = Config(**cfg_kw).nisurf
        if len(daily) != sum(ndays) or wt.shape != (sum(ndays) * nisurf, 4) \
                or not np.isfinite(wt).all():
            raise RuntimeError(f"focus CSVs: {len(daily)} days, trace "
                               f"{wt.shape}")
        print(f"year path: {YEARS[0]}-{YEARS[1]}, device-synthetic forcing, "
              f"focus {FOCUS_SITE}: {launches} kernel launches ("
              f"{[y['launches'] for y in years]} by year), {wall:.2f} s "
              f"wall; files (max residual mm, theta min, max): "
              + json.dumps(files) + f"; focus CSVs {len(daily)} days, "
              f"{wt.shape[0]} substeps")

        # 1902 again from the 1901 checkpoint, in another directory.
        os.makedirs(os.path.join(tmp, "resumed_ck"))
        shutil.copy(os.path.join(out + "_ck", f"year_{YEARS[0]}.pt"),
                    os.path.join(tmp, "resumed_ck"))
        r_wall, r_launches, r_years, r_out = run_years(
            tmp, "resumed", log, ["--resume", *argv],
            forcing="device-synthetic", start_year=YEARS[0],
            end_year=YEARS[1], checkpoint_every_years=1, **cfg_kw)
        if r_launches != ndays[1] or [y["year"] for y in r_years] != \
                [YEARS[1]]:
            raise RuntimeError(f"resumed year path: {r_launches} launches, "
                               f"years {r_years}")
        name = f"axy{YEARS[1]}.nc"
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(r_out, name), "rb") as b:
            if a.read() != b.read():
                raise RuntimeError(f"resumed {name} is not byte for byte "
                                   f"the straight run's")
        print(f"year path resumed from {YEARS[0]}: {r_launches} launches, "
              f"{name} byte for byte the straight run's (which had a focus "
              f"cell; this one has none); restore "
              f"{log.restores[-1]['seconds']:.3f} s")

        host = {}
        for block_days in (366, 30):
            h_wall, h_launches, h_years, h_out = run_years(
                tmp, f"host_{block_days}", log, argv, forcing="synthetic",
                start_year=YEARS[0], end_year=YEARS[0],
                forcing_block_days=block_days, **cfg_kw)
            if h_launches != ndays[0]:
                raise RuntimeError(f"host-forcing year: {h_launches} "
                                   f"launches")
            check_annual_file(f"host forcing, {block_days}-day blocks",
                              os.path.join(h_out, f"axy{YEARS[0]}.nc"),
                              land, init["theta_s"])
            host[block_days] = dict(h_years[0], wall_s=h_wall)

        # 30 days of a PGF-style archive (NetCDF-3), read back bitwise.
        grid, _ = load_soil(Config(**cfg_kw), torch.float32, dev)
        blk = DeviceSyntheticForcingProvider(
            grid.n_padded, seed=7, lat=grid.cell_lat,
            device=dev)(YEARS[0], 1, PGF_DAYS)
        from scipy.io import netcdf_file
        pgf_dir = os.path.join(tmp, "pgf")
        os.makedirs(pgf_dir)
        n_land = grid.n_land
        for var in PGF_VARIABLES:
            packed = getattr(blk, var).cpu().numpy()
            brick = np.full((PGF_DAYS, grid.ny * grid.nx), 1.0e20,
                            np.float32)
            brick[:, grid.land_idx] = packed[:, :n_land]
            with netcdf_file(os.path.join(pgf_dir, f"{var}_{YEARS[0]}.nc"),
                             "w") as f:
                f.createDimension("time", PGF_DAYS)
                f.createDimension("lat", grid.ny)
                f.createDimension("lon", grid.nx)
                f.createVariable(var, "f", ("time", "lat", "lon"))[:] = \
                    brick.reshape(PGF_DAYS, grid.ny, grid.nx)
        t0 = time.perf_counter()
        back = NetCDFForcingProvider(os.path.join(pgf_dir, "{var}_{year}.nc"),
                                     grid, device=dev)(YEARS[0], 1, PGF_DAYS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        read_s = time.perf_counter() - t0
        for var in PGF_VARIABLES:
            got, want = getattr(back, var), getattr(blk, var)
            if got.device != want.device or not torch.equal(
                    got[:, :n_land], want[:, :n_land]) or not torch.equal(
                    got[:, n_land:], got[:, :1].expand(-1, got.shape[1]
                                                       - n_land)):
                raise RuntimeError(f"PGF archive: {var} read back is not "
                                   f"what was written")
        print(f"PGF-style archive, {PGF_DAYS} days x {grid.ny}x{grid.nx}, "
              f"NetCDF-3: read back bitwise in {read_s:.3f} s")
    finally:
        logger.removeHandler(log)
    summary = dict(launches=launches, years=years, resumed=r_years[0],
                   restore_s=log.restores[-1]["seconds"], host=host,
                   pgf_read_s=read_s, wall_s=wall)
    print(f"year path timings ({smi}): " + json.dumps(summary))
    return summary


#: Phase 11's switches: name and the Config fields that turn it on.
SWITCHES = (("hydrology_only", dict(vegetation=False)),
            ("twolayer_snow", dict(snow_scheme="twolayer")),
            ("lateral_groundwater", dict(lateral_groundwater=True)),
            ("muskingum_grid", dict(routing_scheme="muskingum")),
            ("kinematic_packed", dict(routing_form="packed")),
            ("linear_packed", dict(routing_scheme="linear")))
SPINUP_YEARS = 2
SITE_DAYS = 10
SITE_FIRST_DOY = 180          # summer: no snow, off the ZD09 knife edges


def _at_work(name, sim, start, state, means, day):
    """Phase 11's sign that switch ``name`` ran, on the state ``state``
    and annual means ``means`` the 30-day block from ``start`` left and
    one more ``day`` (its (state, diags)).  Returns what it saw."""
    if name == "hydrology_only":
        seen = dict(lai_unchanged=bool(torch.equal(state.veg.lai,
                                                   start.veg.lai)),
                    carbon_unchanged=bool(torch.equal(
                        state.carbon.c_soil_slow, start.carbon.c_soil_slow)),
                    max_rh=float(means["rh"].abs().max()),
                    max_npp=float(means["npp"].abs().max()))
        ok = (seen["lai_unchanged"] and seen["carbon_unchanged"]
              and seen["max_rh"] == 0.0 and seen["max_npp"] == 0.0)
    elif name == "twolayer_snow":
        pack = state.snowpack
        seen = dict(swe_is_pack_total=bool(torch.equal(
                        state.swe, pack.swe_surf + pack.swe_base
                        + pack.w_liq)),
                    snow_cells=int((state.swe > 0).sum()),
                    liquid_cells=int((pack.w_liq > 0).sum()),
                    cold_cells=int((pack.t_surf < c.TF).sum()))
        ok = (seen["swe_is_pack_total"] and seen["snow_cells"] > 0
              and seen["liquid_cells"] + seen["cold_cells"] > 0)
    elif name == "lateral_groundwater":
        _, net = lateral_groundwater_step(state.soil.wa, state.soil.zwt,
                                          sim.lateral)
        land = net[:sim.n_land].double()
        seen = dict(exchange_cells=int((land != 0).sum()),
                    exchange_abs_sum_mm=float(land.abs().sum()),
                    exchange_sum_mm=float(land.sum()))
        ok = (seen["exchange_cells"] > 0 and abs(seen["exchange_sum_mm"])
              <= 1e-5 * seen["exchange_abs_sum_mm"])
    else:
        seen, ok = {}, True
    # Every path routes: discharge, and the routed water balance of one
    # day over land.
    new, d = day
    land = slice(0, sim.n_land)
    water = [x[land].double().sum() for x in (
        new.river_store, state.river_store, d["discharge"], d["rnf_day"])]
    balance = float(water[0] - water[1] + water[2] - water[3])
    scale = float(water[1] + d["rnf_day"][land].double().abs().sum())
    seen.update(annual_discharge_mm=float(means["discharge"].sum()),
                routed_balance_mm=balance, routed_scale_mm=scale)
    if not (ok and seen["annual_discharge_mm"] > 0.0
            and abs(balance) <= 1e-5 * scale):
        raise RuntimeError(f"switch {name}: not seen at work ({seen})")
    return seen


def switch_paths(flag, fblock, f31, smi, **cfg_kw):
    """Phase 11: each of SWITCHES on ``Config()`` at full width (the
    flagship case's soil and grid), a FLAGSHIP_DAYS block from 1 January
    through ``block_step(**step_kwargs())`` with the kernel's count set
    to 0 just before: one launch a day, finite state, the residual, the
    switch at work; its first 3 days against the plain twin at the
    kernel's tolerances; the packed routers' blocks run twice and held
    bitwise; ``day_step`` timed on the state the block leaves.
    ``cfg_kw`` is for rehearsals on a small grid.  Returns {name:
    summary}."""
    dev = fblock.tas.device
    out = {}
    for name, switch in SWITCHES:
        t0 = time.perf_counter()
        sim = Simulation(Config(**cfg_kw, **switch), flag.sim.params,
                         land_grid=flag.land_grid)
        set_up_s = time.perf_counter() - t0
        n = sim.n
        kw = sim.step_kwargs()
        run = dict(params=sim.params, geom=sim.geom, dt=sim.cfg.dt,
                   nisurf=sim.cfg.nisurf)
        acc0 = AnnualAccumulators.zeros(n, torch.float32, dev)
        zero_launches()
        t0 = time.perf_counter()
        state, acc = block_step(sim.state, acc0, fblock, **run, **kw)
        means = annual_means(acc, sim.cfg.nisurf)
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        launches = read_launches(f"switch {name}")
        summary = check_block(f"switch {name}", state, means, FLAGSHIP_DAYS,
                              launches)
        day = day_step(state, f31, sim.params, sim.geom, sim.cfg.dt,
                       sim.cfg.nisurf, **kw)
        seen = _at_work(name, sim, sim.state, state, means, day)
        short = fblock.map(lambda x: x[:3])
        err = compare_blocks(
            f"switch {name} vs plain twin, 3 days",
            block_step(sim.state, acc0, short, **run, **kw),
            block_step(sim.state, acc0, short, **run,
                       **dict(kw, use_kernel=False)), sim.params.bsw)
        repeat = None
        if name.endswith("packed"):
            again = block_step(sim.state, acc0, fblock, **run, **kw)
            repeat = all(torch.equal(x, y) for x, y in zip(
                _state_leaves(state) + _state_leaves(acc),
                _state_leaves(again[0]) + _state_leaves(again[1])))
            if not repeat:
                raise RuntimeError(f"switch {name}: the block run twice is "
                                   f"not bitwise the same")
        step_ms, step_wall_ms = _time_cuda(
            lambda: day_step(state, f31, sim.params, sim.geom, sim.cfg.dt,
                             sim.cfg.nisurf, **kw)[0].soil.h2osoi_liq, 10)
        out[name] = dict(launches=launches, block_s=block_s,
                         set_up_s=set_up_s, max_abs_err_3_days=err,
                         repeat_bitwise=repeat, day_step_ms=step_ms,
                         day_step_wall_ms=step_wall_ms,
                         router=type(sim.routing).__name__, **seen)
        print(f"switch {name}: {FLAGSHIP_DAYS} days x {n} cells in "
              f"{block_s:.2f} s (set-up {set_up_s:.1f} s), {summary}; vs "
              f"plain twin, 3 days: max|diff| h2osoi {err:.3e} mm; "
              f"day_step {step_ms:.3f} ms event, {step_wall_ms:.3f} ms wall "
              f"({smi}); " + json.dumps(seen)
              + ("" if repeat is None else "; repeated bitwise"))
    return out


class SpinupLog(logging.Handler):
    """The spin-up's rehearsal years (``spinup.SPINUP_LOG``), each with
    the day kernel's launch count when it was logged."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.years = []

    def emit(self, record):
        if record.msg == SPINUP_LOG:
            year, of, dslow, nee, seconds = record.args
            self.years.append(dict(year=year, of=of, max_dslow=dslow,
                                   mean_nee=nee, seconds=seconds,
                                   launches=day_kernel.launches))


def spinup_path(tmp, smi, argv=(), **cfg_kw):
    """Phase 12: ``cli.main(["run", "--spinup-carbon", ...])`` on
    ``Config()`` at full width with on-card forcing: SPINUP_YEARS
    rehearsal years, then the run's year; each rehearsal year is one
    launch a day, and so is the year after.  Returns the phase's
    summary."""
    slog, ylog = SpinupLog(), YearLog()
    logger = logging.getLogger("hybrid9_tpu_torch")
    logger.addHandler(slog)
    logger.addHandler(ylog)
    try:
        wall, launches, years, out = run_years(
            tmp, "spinup", ylog, ["--spinup-carbon", str(SPINUP_YEARS),
                                  *argv],
            forcing="device-synthetic", start_year=YEARS[0],
            end_year=YEARS[0], **cfg_kw)
    finally:
        logger.removeHandler(slog)
        logger.removeHandler(ylog)
    ndays = years[0]["days"] if years else 0
    by_year, before = [], 0
    for y in slog.years:
        by_year.append(y["launches"] - before)
        before = y["launches"]
    by_year.append(launches - before)
    if len(slog.years) != SPINUP_YEARS or by_year != [ndays] * (
            SPINUP_YEARS + 1):
        raise RuntimeError(f"spin-up path: launches by year {by_year}, "
                           f"{len(slog.years)} rehearsal years")
    for y in slog.years:
        if not (np.isfinite(y["max_dslow"]) and np.isfinite(y["mean_nee"])):
            raise RuntimeError(f"spin-up path: {y}")
    init = read_grid_file(os.path.join(out, "init_diagnostics.nc"),
                          ["land_mask", "theta_s"])
    check_annual_file("spin-up path", os.path.join(out, f"axy{YEARS[0]}.nc"),
                      init["land_mask"] == 1.0, init["theta_s"])
    summary = dict(launches=launches, launches_by_year=by_year,
                   rehearsal_years=slog.years, run_year=years[0],
                   wall_s=wall)
    print(f"spin-up path ({smi}): " + json.dumps(summary))
    return summary


def site_path(tmp, smi, device_argv=()):
    """Phase 13: ``cli.main(["site", "--engine", "kernel", ...])`` on the
    card (``device_argv`` empty) over SITE_DAYS summer days of the default
    site's synthetic climate written here as a CSV, nisurf 48; its daily
    CSV against ``--engine oracle`` at tests/test_site_kernel.py's
    float32 tolerance (theta within 5e-3); then the kernel engine on the
    CPU for its time.  Returns the phase's summary."""
    clim = os.path.join(tmp, "site_climate.csv")
    keys = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")
    with open(clim, "w") as f:
        f.write(",".join(keys) + "\n")
        for d in range(SITE_FIRST_DOY, SITE_FIRST_DOY + SITE_DAYS):
            day = synthetic_forcing_day(1, d, seed=17,
                                        lat=np.array([Config().site_lat]))
            f.write(",".join(repr(float(day[k][0])) for k in keys) + "\n")
    rows, secs = {}, {}
    for label, argv in (("kernel", ["--engine", "kernel", *device_argv]),
                        ("oracle", ["--engine", "oracle"]),
                        ("kernel_cpu", ["--engine", "kernel", "--device",
                                        "cpu"])):
        path = os.path.join(tmp, f"site_{label}.csv")
        t0 = time.perf_counter()
        rc = cli.main(["site", "--climate", clim, "--nisurf", "48",
                       "--csv-out", path, *argv])
        secs[label] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"site path {label}: exit code {rc}")
        with open(path) as f:
            header = f.readline().strip().split(",")
            rows[label] = np.array([r.split(",") for r in
                                    f.read().splitlines()], np.float64)
    theta = [header.index(f"theta{i}") for i in range(1, 5)]
    worst = {}
    for label in ("kernel", "kernel_cpu"):
        got = rows[label]
        if got.shape != (SITE_DAYS, len(header)) or \
                not np.isfinite(got).all():
            raise RuntimeError(f"site path {label}: rows {got.shape}")
        worst[label] = float(np.abs(got[:, theta]
                                    - rows["oracle"][:, theta]).max())
        if not worst[label] < 5e-3:
            raise RuntimeError(f"site path {label}: theta off the oracle by "
                               f"{worst[label]}")
    summary = dict(days=SITE_DAYS, nisurf=48,
                   ms_per_site_day=secs["kernel"] / SITE_DAYS * 1e3,
                   ms_per_site_day_cpu=secs["kernel_cpu"] / SITE_DAYS * 1e3,
                   ms_per_site_day_oracle=secs["oracle"] / SITE_DAYS * 1e3,
                   max_theta_err=worst["kernel"],
                   max_theta_err_cpu=worst["kernel_cpu"])
    print(f"site path ({smi}): " + json.dumps(summary))
    return summary


#: Phase 14: the closed loop at 0.5 degrees.
ENSEMBLE_MEMBERS = 8          # the ensemble command's default
DA_MEMBERS = 16               # the assimilate command's default
DA_DAYS = 5                   # of the command's default 25
FIT_DAYS = 1                  # of calibrate --config's default 60
FIT_STEPS = 2                 # of its default 100
FOLDED_CHECK_DAYS = 1
SITE_FIT_DAYS = 4             # of the site fit of tests/test_calibrate.py
DA_FOLDED_CHECK_DAYS = 1      # the first forecast at 16 x 69,632 cells


class LoopLog(logging.Handler):
    """The closed-loop commands' log records by their arguments
    (``cli.ENSEMBLE_LOG``, ``cli.TWIN_LOG``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.ensemble, self.twin = [], []

    def emit(self, record):
        if record.msg == cli.ENSEMBLE_LOG:
            self.ensemble.append(record.args)
        elif record.msg == cli.TWIN_LOG:
            self.twin.append(record.args)


class KernelWidths:
    """While active, records the cell count of every launch of the day
    kernel through its wrapper (the wrapper still counts the launch)."""

    def __init__(self):
        self.widths = []
        self._wrapped = day_kernel.hydrology_day_cuda

    def __enter__(self):
        wrapped = self._wrapped

        def record(soil, *args, **kw):
            self.widths.append(soil.h2osoi_liq.shape[0])
            return wrapped(soil, *args, **kw)
        day_kernel.hydrology_day_cuda = record
        return self

    def __exit__(self, *exc):
        day_kernel.hydrology_day_cuda = self._wrapped


def _rounds(cells, dtype):
    """Rounds of resident blocks the main instance (nl 8, no ``imp``)
    takes for ``cells`` on this card; None off the card."""
    if not torch.cuda.is_available():
        return None
    sms, blocks, threads, _ = day_kernel.instance_residency(
        kernels.day_kernel_lib(), dtype, 8, False)
    return day_kernel.rounds(cells, sms, blocks, threads)


def _run_cli(argv, label):
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{label}: exit code {rc}")
    return wall


def _annual_control(cfg, params, state0, forcing, geom, fields):
    """The ensemble's member 0 run unfolded: ``day_step`` over the year on
    ``apply_multipliers(params, zeros)`` with the command's switches,
    summed as ``run_ensemble_annual`` sums."""
    p = apply_multipliers(params, {f: torch.zeros(
        (), dtype=params.hksat.dtype, device=params.hksat.device)
        for f in fields})
    state = state0
    ev = rn = np_ = torch.zeros_like(state0.veg.lai)
    for d in range(forcing.tas.shape[0]):
        state, diags = day_step(state, forcing.map(lambda x: x[d]), p, geom,
                                cfg.dt, cfg.nisurf, use_kernel=cfg.use_kernel,
                                zd09_every=cfg.zd09_every,
                                vegetation=cfg.vegetation)
        ev = ev + diags["evap_day"]
        rn = rn + diags["rnf_day"]
        np_ = np_ + diags["npp"]
    return dict(evap=ev, runoff=rn, npp=np_)


def _folded_days_vs_twin(label, cfg, params_m, state_m, forcing, geom, m,
                         days):
    """The first ``days`` folded days, kernel against plain twin at the
    hydrology day (each day from the twin's state), with the knife-edge
    cells set aside as in phase 3.  Returns (max |diff| of h2osoi in mm,
    knife-edge cells)."""
    err, n_edge = 0.0, 0
    kw = dict(zd09_every=cfg.zd09_every)
    for d in range(days):
        f_m = forcing.map(lambda x: fold(x[d], m))
        args = (state_m.soil, state_m.veg, params_m, f_m, geom, cfg.dt,
                cfg.nisurf)
        want = day_kernel.hydrology_day_plain(*args, **kw)
        edge = knife_edge_cells(*args[:5], want, cfg.dt, cfg.nisurf, **kw)
        if int(edge.sum()) > MAX_KNIFE_EDGE_SHARE * edge.numel():
            raise RuntimeError(f"{label}: {int(edge.sum())} of "
                               f"{edge.numel()} cells on a knife edge")
        got = day_kernel.hydrology_day_cuda(*args, **kw)
        err = max(err, check_day(f"{label}, day {d + 1}", got, want,
                                 params_m.bsw, ~edge)[0])
        n_edge += int(edge.sum())
        if d + 1 < days:
            state_m = day_step(state_m, f_m, params_m, geom, cfg.dt,
                               cfg.nisurf, use_kernel=False,
                               zd09_every=cfg.zd09_every,
                               vegetation=cfg.vegetation)[0]
    return err, n_edge


def closed_loop_path(tmp, dev, smi, argv=(), **cfg_kw):
    """Phase 14: the closed loop through the command line on ``Config()``
    at 0.5 degrees (``cfg_kw`` and ``argv`` are for rehearsals on a small
    grid): ``ensemble --members 8`` for the full default year (one kernel
    launch a day at 8 x 69,632 cells; member 0 against the control run
    unfolded; the first folded days against the twin), ``assimilate
    --members 16 --days 5 --obs-twin 0.5`` (one launch a cycle at 16 x
    69,632 cells; the first forecast against the twin at that width; the
    padding lanes' multipliers bitwise their first draw), and
    ``calibrate --obs-twin 0.4 --fields hksat --days 1 --steps 2`` with a
    scalar and a per-cell theta (no kernel launch; finite gradients; the
    loss falls), the kernel wrapper raising under autograd, and the site
    ``calibrate`` on the card and the CPU.  Returns the phase's
    summary."""
    from hybrid9_tpu_torch import assimilate as da
    from hybrid9_tpu_torch.ensemble import (_fold_problem,
                                            perturbed_multipliers)
    cfg = Config(output_path=tmp, **cfg_kw)
    path = os.path.join(tmp, "loop.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, dev)
    n, n_land = grid.n_padded, grid.n_land
    lg = cfg.layer_grid()
    state0 = initial_state(params, lg.dz, lg.zi, dtype, dev)
    geom = Geometry.from_layer_grid(lg)
    log = LoopLog()
    logger = logging.getLogger("hybrid9_tpu_torch")
    logger.addHandler(log)
    out = {}
    try:
        # --- ensemble, the full default year ----------------------------
        ens_path = os.path.join(tmp, "ensemble.nc")
        fields = ("hksat", "bsw", "psi_s")
        zero_launches()
        with KernelWidths() as w:
            wall = _run_cli(["ensemble", "--config", path, "--members",
                             str(ENSEMBLE_MEMBERS), "--out", ens_path, *argv],
                            "ensemble")
        launches = read_launches("ensemble")
        ndays = calendar.days_in_year(cfg.start_year)
        m_cells = ENSEMBLE_MEMBERS * n
        if launches != ndays or w.widths != [m_cells] * ndays:
            raise RuntimeError(f"ensemble: {launches} launches at widths "
                               f"{sorted(set(w.widths))}")
        names = [f"{v}_{s}" for v in ("evap", "runoff", "npp")
                 for s in ("mean", "std", "control")]
        back = read_grid_file(ens_path, names)
        land = np.isfinite(back["evap_mean"])
        if int(land.sum()) != n_land:
            raise RuntimeError(f"ensemble file: {int(land.sum())} land "
                               f"cells of {n_land}")
        for k in names:
            if not np.array_equal(np.isfinite(back[k]), land):
                raise RuntimeError(f"ensemble file: {k} not finite on land "
                                   f"and fill over the ocean")
        spread_share = float((back["evap_std"][land] > 0).mean())
        if not spread_share > 0.5:
            raise RuntimeError(f"ensemble: evap spread > 0 on "
                               f"{spread_share:.3f} of land")
        forcing = cli._stacked_forcing(cfg, grid, ndays, dtype, dev)
        control = _annual_control(cfg, params, state0, forcing, geom, fields)
        bitwise, ctrl_err = True, 0.0
        for k, x in control.items():
            got = torch.tensor(back[f"{k}_control"][land], dtype=dtype)
            want = torch.tensor(grid.scatter(x.cpu().numpy())[land])
            bitwise &= bool(torch.equal(got, want))
            ctrl_err = max(ctrl_err, float((got.double()
                                            - want.double()).abs().max()))
            rtol, atol = F32_TOL["evap_day"]
            if not bool(((got.double() - want.double()).abs()
                         <= atol + rtol * want.double().abs()).all()):
                raise RuntimeError(f"ensemble member 0: {k} off the control "
                                   f"by {ctrl_err}")
        gen = torch.Generator(device=dev).manual_seed(0)
        theta = perturbed_multipliers(gen, ENSEMBLE_MEMBERS, fields=fields,
                                      sigma=0.3, dtype=dtype)
        params_m, state_m = _fold_problem(theta, params, state0,
                                          ENSEMBLE_MEMBERS)
        fold_err, fold_edge = _folded_days_vs_twin(
            f"folded kernel vs twin, {m_cells} cells", cfg, params_m,
            state_m, forcing, geom, ENSEMBLE_MEMBERS, FOLDED_CHECK_DAYS)
        f_m = forcing.map(lambda x: fold(x[0], ENSEMBLE_MEMBERS))
        kday = (state_m.soil, state_m.veg, params_m, f_m, geom, cfg.dt,
                cfg.nisurf)
        k_ms = _time_cuda(lambda: day_kernel.hydrology_day_cuda(
            *kday, zd09_every=cfg.zd09_every)[0].h2osoi_liq, 10)[0]
        step_ms, step_wall_ms = _time_cuda(lambda: day_step(
            state_m, f_m, params_m, geom, cfg.dt, cfg.nisurf,
            use_kernel=cfg.use_kernel, zd09_every=cfg.zd09_every,
            vegetation=cfg.vegetation)[0].soil.h2osoi_liq, 10)
        year_s = log.ensemble[-1][3]
        bound = day_bound(kday, None, cfg.zd09_every)
        out["ensemble"] = dict(
            members=ENSEMBLE_MEMBERS, cells=m_cells, days=ndays,
            launches=launches, year_s=year_s, wall_s=wall,
            kernel_ms=k_ms, day_step_ms=step_ms,
            day_step_wall_ms=step_wall_ms,
            day_step_cell_days_per_s=m_cells / (step_ms * 1e-3),
            member0_bitwise=bitwise, member0_max_abs_err=ctrl_err,
            spread_share_of_land=spread_share,
            folded_vs_twin_max_abs_err=fold_err,
            folded_knife_edge_cells=fold_edge, rounds=_rounds(m_cells, dtype),
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        print(f"closed loop, ensemble: {ENSEMBLE_MEMBERS} members x {n} "
              f"cells ({m_cells} folded) x {ndays} days: {launches} kernel "
              f"launches at {m_cells} cells, year {year_s:.3f} s ({wall:.2f} "
              f"s wall with set-up and output); member 0 "
              f"{'bitwise' if bitwise else 'within F32_TOL of'} the control "
              f"(max |diff| {ctrl_err:.3e}); folded kernel vs twin, "
              f"{FOLDED_CHECK_DAYS} days: {fold_err:.3e} mm ({fold_edge} "
              f"knife-edge cells); kernel day {k_ms:.3f} ms, day_step "
              f"{step_ms:.3f} ms ({m_cells / (step_ms * 1e-3):.4g} "
              f"cell-days/s) ({smi})")

        # --- assimilation -------------------------------------------------
        da_path = os.path.join(tmp, "enkf.npz")
        record = {}
        wrapped = da.assimilate

        def keep(*a, **kw):
            record.update(wrapped(*a, **kw))
            record["args"] = (a, kw)
            return record
        da.assimilate = keep
        zero_launches()
        try:
            with KernelWidths() as w:
                wall = _run_cli(["assimilate", "--config", path, "--members",
                                 str(DA_MEMBERS), "--days", str(DA_DAYS),
                                 "--obs-twin", "0.5", "--out", da_path,
                                 *argv], "assimilate")
        finally:
            da.assimilate = wrapped
        launches = read_launches("assimilate")
        d_cells = DA_MEMBERS * n
        if launches != DA_DAYS or w.widths != [d_cells] * DA_DAYS:
            raise RuntimeError(f"assimilate: {launches} launches at widths "
                               f"{sorted(set(w.widths))}")
        with np.load(da_path) as z:
            tm, ts = z["theta_mean"], z["theta_std"]
        if not (np.isfinite(tm).all() and np.isfinite(ts).all()
                and np.abs(tm).max() <= 2.0 and tm.shape == (n_land,)):
            raise RuntimeError(f"assimilate: posterior {tm.shape}, |theta| "
                               f"max {np.abs(tm).max()}")
        first = da.first_draw(torch.Generator(device=dev).manual_seed(0),
                              DA_MEMBERS, n, 0.3, dtype)
        pad = slice(n_land, n)
        if n > n_land and not (
                torch.equal(record["theta_mean"][pad], first.mean(dim=0)[pad])
                and torch.equal(record["theta_std"][pad],
                                first.std(dim=0, correction=0)[pad])):
            raise RuntimeError("assimilate: the padding lanes' multipliers "
                               "moved off their first draw")
        (a_params, a_state0, a_forcing, a_obs, a_geom), a_kw = record["args"]
        m = DA_MEMBERS
        params_t = a_params.map(lambda x: fold(x, m))
        # The first forecast, kernel against twin at 16 x 69,632 cells:
        # the first draw's hksat multipliers, as _enkf_cycle applies them.
        da_err, da_edge = _folded_days_vs_twin(
            f"folded kernel vs twin, {d_cells} cells", cfg,
            apply_multipliers(params_t, {"hksat": first.T.reshape(n * m)}),
            a_state0.map(lambda x: fold(x, m)), a_forcing, a_geom, m,
            DA_FOLDED_CHECK_DAYS)
        # One cycle on the final state, whole and its forecast alone.
        theta_m = first.clone()
        state_m = record["state"]
        f_day = a_forcing.map(lambda x: x[DA_DAYS - 1])
        p = apply_multipliers(params_t, {"hksat": theta_m.T.reshape(n * m)})
        f_m = f_day.map(lambda x: fold(x, m))
        mask = a_kw["obs_mask"][DA_DAYS - 1]
        enkf = a_kw["cfg"]

        def cycle():
            return da._enkf_cycle(state_m, theta_m, params_t, f_day,
                                  a_obs[DA_DAYS - 1], mask, a_geom, cfg.dt, m,
                                  cfg.nisurf, cfg.vegetation, cfg.use_kernel,
                                  cfg.zd09_every, enkf)[1]
        cycle_ms = _time_cuda(cycle, 10)[0]
        forecast_ms = _time_cuda(lambda: day_step(
            state_m, f_m, p, geom, cfg.dt, cfg.nisurf,
            use_kernel=cfg.use_kernel, zd09_every=cfg.zd09_every,
            vegetation=cfg.vegetation)[0].soil.h2osoi_liq, 10)[0]
        k16_ms = _time_cuda(lambda: day_kernel.hydrology_day_cuda(
            state_m.soil, state_m.veg, p, f_m, geom, cfg.dt, cfg.nisurf,
            zd09_every=cfg.zd09_every)[0].h2osoi_liq, 10)[0]
        out["assimilate"] = dict(
            members=m, cells=d_cells, days=DA_DAYS, launches=launches,
            wall_s=wall, twin_obs_s=log.twin[-1][1],
            theta_mean_land=float(tm.mean()),
            theta_std_land_median=float(np.median(ts)),
            cycle_ms=cycle_ms, forecast_ms=forecast_ms,
            analysis_ms=cycle_ms - forecast_ms, kernel_ms=k16_ms,
            rounds=_rounds(d_cells, dtype),
            folded_vs_twin_max_abs_err=da_err,
            folded_knife_edge_cells=da_edge)
        print(f"closed loop, assimilate: {m} members x {n} cells ({d_cells} "
              f"folded) x {DA_DAYS} days: {launches} kernel launches at "
              f"{d_cells} cells, {wall:.2f} s wall, twin obs "
              f"{log.twin[-1][1]:.2f} s; posterior log-mult mean "
              f"{float(tm.mean()):.4f}, padding lanes bitwise their first "
              f"draw; folded kernel vs twin, {DA_FOLDED_CHECK_DAYS} day: "
              f"{da_err:.3e} mm ({da_edge} knife-edge cells); cycle "
              f"{cycle_ms:.3f} ms (forecast {forecast_ms:.3f}, analysis "
              f"{cycle_ms - forecast_ms:.3f}), kernel day "
              f"{k16_ms:.3f} ms ({smi})")

        # --- calibration --------------------------------------------------
        fits = {}
        for label, extra in (("scalar", []), ("per_cell", ["--per-cell"])):
            marks, bad = [], []

            def pre(opt, args, kwargs):
                for group in opt.param_groups:
                    for t in group["params"]:
                        if t.grad is None or not bool(
                                torch.isfinite(t.grad).all()):
                            bad.append(t.grad is None)

            def post(opt, args, kwargs):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                marks.append(time.perf_counter())
            hooks = [optimizer.register_optimizer_step_pre_hook(pre),
                     optimizer.register_optimizer_step_post_hook(post)]
            fit_path = os.path.join(
                tmp, "fit.npz" if label == "per_cell" else "fit.json")
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            zero_launches()
            try:
                wall = _run_cli(["calibrate", "--config", path, "--obs-twin",
                                 "0.4", "--fields", "hksat", "--days",
                                 str(FIT_DAYS), "--steps", str(FIT_STEPS),
                                 "--out", fit_path, *extra, *argv],
                                f"calibrate {label}")
            finally:
                for h in hooks:
                    h.remove()
            peak, card = 0, None
            if dev.type == "cuda":
                peak = torch.cuda.max_memory_allocated(dev)
                card = torch.cuda.get_device_properties(dev).total_memory
            fit_launches = read_launches(f"calibrate {label}")
            if fit_launches != 0:
                raise RuntimeError(f"calibrate {label}: the fit launched the "
                                   f"day kernel {fit_launches} times")
            if bad or len(marks) != FIT_STEPS:
                raise RuntimeError(f"calibrate {label}: gradients not finite "
                                   f"({len(bad)}) or {len(marks)} steps")
            if label == "per_cell":
                with np.load(fit_path) as z:
                    hist = z["loss_history"]
            else:
                with open(fit_path) as f:
                    fit = json.load(f)
                hist = np.array([fit["loss_initial"], fit["loss_final"]])
            if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
                raise RuntimeError(f"calibrate {label}: loss {hist}")
            fits[label] = dict(days=FIT_DAYS, steps=FIT_STEPS, wall_s=wall,
                               launches=fit_launches,
                               step_s=marks[-1] - marks[-2],
                               loss_first=float(hist[0]),
                               loss_last=float(hist[-1]),
                               peak_bytes=peak, card_bytes=card)
            print(f"closed loop, calibrate {label}: {FIT_DAYS} days x "
                  f"{FIT_STEPS} steps at {n} cells, no kernel launch, finite "
                  f"gradients, loss {hist[0]:.4g} -> {hist[-1]:.4g}; one "
                  f"Adam step {fits[label]['step_s']:.2f} s, peak memory "
                  f"{peak / 1e9:.2f} GB of {(card or 0) / 1e9:.1f} ({smi})")
        out["calibrate"] = fits

        # The kernel has no backward: under autograd it raises.
        before = day_kernel.launches
        tracked = params.replace(hksat=params.hksat.clone().requires_grad_())
        f1 = forcing.map(lambda x: x[0])
        try:
            day_kernel.hydrology_day_cuda(state0.soil, state0.veg, tracked,
                                          f1, geom, cfg.dt, cfg.nisurf)
        except RuntimeError as e:
            if "use_kernel=False" not in str(e):
                raise
        else:
            raise RuntimeError("the day kernel ran under autograd")
        if day_kernel.launches != before:
            raise RuntimeError("the refused call launched the day kernel")
        print("closed loop: the day kernel's wrapper raises under autograd "
              "(naming use_kernel=False) and launches nothing")

        # The site fit of tests/test_calibrate.py, on the card and the CPU.
        clim, obs = (os.path.join(tmp, x) for x in ("fit_clim.csv",
                                                     "fit_obs.csv"))
        keys = ("tas", "rlds", "rsds", "huss", "ps", "pr", "rhs")
        with open(clim, "w") as f:
            f.write(",".join(keys) + "\n")
            for d in range(SITE_FIT_DAYS):
                day = synthetic_forcing_day(1, 150 + d, seed=5)
                f.write(",".join(f"{float(day[k][0]):.8g}" for k in keys)
                        + "\n")
        with open(obs, "w") as f:
            f.write("doy,evap_obs\n" + "".join(f"{d + 1},1.5\n"
                                               for d in range(
                                                   SITE_FIT_DAYS)))
        site = {}
        for label, dargv in (("card", list(argv)),
                             ("cpu", ["--device", "cpu"])):
            fit_path = os.path.join(tmp, f"site_fit_{label}.json")
            secs = _run_cli(["calibrate", "--climate", clim, "--obs", obs,
                             "--fields", "hksat,bsw", "--steps", "2", "--lr",
                             "0.05", "--nisurf", "8", "--out", fit_path,
                             *dargv], f"site calibrate {label}")
            with open(fit_path) as f:
                fit = json.load(f)
            if fit["obs_days"] != SITE_FIT_DAYS or \
                    not np.isfinite(fit["loss_final"]):
                raise RuntimeError(f"site calibrate {label}: {fit}")
            site[label] = dict(seconds=secs, **fit)
        out["site_calibrate"] = site
        print(f"closed loop, site calibrate ({SITE_FIT_DAYS} days, 2 steps, "
              f"nisurf 8): "
              f"{site['card']['seconds']:.2f} s on the card, "
              f"{site['cpu']['seconds']:.2f} s with --device cpu ({smi})")
    finally:
        logger.removeHandler(log)
    print(f"closed loop ({smi}): " + json.dumps(out))
    return out


#: Phase 15: the ranks of ``run --shard`` on one card, and the grid of the
#: closed-loop legs (phase 14 runs those commands at full width).
RANKS = (1, 2, 4)
LOOP_GRID_DEG = 2.0
LOOP_DA_DAYS = 3
# The fit's loss sums each rank's cells and then the ranks', in another
# order than one process's sum: float32 sums of some 10^4 terms differ by
# up to log2(terms) ulps, about 1e-6 relative; the per-cell multipliers
# take only their own cell's gradient and are expected bitwise.
LOOP_FIT_RTOL = 1e-5
RANK_TIMEOUT_S = 600
_REPO = os.path.dirname(os.path.abspath(__file__))
# A rank's driver of several commands in one process, as ``python -m
# hybrid9_tpu_torch`` runs one.
_COMMANDS = ("import json, sys\n"
             "from hybrid9_tpu_torch import cli\n"
             "for argv in json.loads(sys.argv[1]):\n"
             "    if cli.main(argv) != 0:\n"
             "        sys.exit(argv[0] + ' failed')\n")
_RANK_RE = re.compile(r"run done: process (\d+)/(\d+), (\d+) day-kernel "
                      r"launches, collectives (\{.*\}) in (\d+) days, peak "
                      r"device memory ([\d.]+) GB")
_YEAR_RE = re.compile(r"year (\d+): (\d+) days in ([\d.]+)s \(([\d.]+) "
                      r"cell-days/s\)")


def launch_ranks(groups, tmp, timeout=RANK_TIMEOUT_S):
    """Each ``(label, n, cmd)`` of ``groups`` (``cmd``: arguments of
    ``python``) as ``n`` ranks of one gloo group on this machine
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``: the ranks share the one card), the groups at once.
    Returns (``{label: each rank's log}``, wall seconds of them all); any
    rank that fails or outlives ``timeout`` fails the phase, and every
    rank is stopped."""
    started = []
    t0 = time.perf_counter()
    try:
        for label, n, cmd in groups:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = str(s.getsockname()[1])
            for r in range(n):
                env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                           LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=port)
                path = os.path.join(tmp, f"{label}.rank{r}.log")
                with open(path, "w") as f:
                    started.append((label, r, n, path, subprocess.Popen(
                        [sys.executable, *cmd], cwd=_REPO, env=env,
                        stdout=f, stderr=subprocess.STDOUT)))
        deadline = time.monotonic() + timeout
        for *_, p in started:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for *_, p in started:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    logs = {}
    for label, r, n, path, p in started:
        with open(path) as f:
            text = f.read()
        if p.returncode != 0:
            raise RuntimeError(f"{label}: rank {r} of {n} exited with "
                               f"{p.returncode}:\n{text[-3000:]}")
        logs.setdefault(label, []).append(text)
    return logs, wall


def _rank_record(text):
    """A rank's ``cli.RANK_LOG`` and ``run.YEAR_LOG`` records."""
    m = _RANK_RE.findall(text)
    if len(m) != 1:
        raise RuntimeError(f"a rank's log has {len(m)} summary lines")
    rank, world, launches, coll, days, peak = m[0]
    years = [dict(year=int(y), days=int(d), seconds=float(s),
                  cell_days_per_s=float(c))
             for y, d, s, c in _YEAR_RE.findall(text)]
    return dict(rank=int(rank), world=int(world), launches=int(launches),
                collectives=ast.literal_eval(coll), days=int(days),
                peak_gb=float(peak), years=years)


def _same_netcdf(label, a, b):
    """Every variable of two NetCDF-3 files bitwise (fill included)."""
    from scipy.io import netcdf_file
    with netcdf_file(a, "r", mmap=False) as fa, \
            netcdf_file(b, "r", mmap=False) as fb:
        if list(fa.variables) != list(fb.variables):
            raise RuntimeError(f"{label}: variables differ")
        for k in fa.variables:
            if not np.array_equal(fa.variables[k][:], fb.variables[k][:]):
                raise RuntimeError(f"{label}: {k} is not bitwise")
        return len(fa.variables)


def multi_rank_path(tmp, smi, argv=(), kernel=True, **cfg_kw):
    """Phase 15, the multi-process layer on one card through the command
    line: ``run --shard`` of ``Config()`` at 0.5 degrees (device-synthetic
    forcing, 1901) as 1, 2 and 4 ranks sharing the card over gloo, each
    rank launching the day kernel once a day on its slab; every field of
    the 2- and 4-rank ``axy1901.nc`` bitwise the 1-rank file's, no part
    file left; the 2-rank run goes on to 1902 with a checkpoint a year,
    and 1902 resumed by 2 ranks from the 1901 checkpoint is bitwise it; a
    1-rank restore of that checkpoint raises.  Then at LOOP_GRID_DEG
    degrees and LOOP_FIT_NISURF substeps (as phase 18's command legs: the
    plain days of the twin and the fit are host-bound) ``ensemble --shard
    --members 8``, ``assimilate --shard --members 16 --days 3`` (bitwise)
    and ``calibrate --per-cell --shard --days 1 --steps 2``
    (LOOP_FIT_RTOL) as 2 ranks against one process.
    ``cfg_kw``, ``argv`` and ``kernel=False`` (no launch expected) are for
    rehearsals on the CPU.  Returns the phase's summary."""
    def config(name, **kw):
        out = os.path.join(tmp, name)
        cfg = Config(**{**dict(output_path=out, checkpoint_path=out + "_ck",
                               start_year=YEARS[0], end_year=YEARS[0],
                               forcing="device-synthetic",
                               checkpoint_every_years=0), **cfg_kw, **kw})
        with open(out + ".json", "w") as f:
            f.write(cfg.to_json())
        return out

    ranks = {}
    for n in RANKS:
        kw = (dict(end_year=YEARS[1], checkpoint_every_years=1) if n == 2
              else {})
        out = config(f"ranks{n}", **kw)
        logs, wall = launch_ranks(
            [("run", n, ["-m", "hybrid9_tpu_torch", "run", "--config",
                         out + ".json", "--shard", *argv])], tmp)
        logs = logs["run"]
        recs = [_rank_record(t) for t in logs]
        days = recs[0]["days"]
        for r, rec in enumerate(recs):
            want = days if kernel else 0
            if (rec["rank"], rec["world"]) != (r, n) or \
                    rec["launches"] != want or \
                    rec["collectives"] != {"routing": days}:
                raise RuntimeError(f"run as {n} ranks: rank {r} made "
                                   f"{rec['launches']} launches and "
                                   f"collectives {rec['collectives']} in "
                                   f"{days} days")
        if any(".part" in f for f in os.listdir(out)):
            raise RuntimeError(f"run as {n} ranks: part files left")
        fields = _same_netcdf(f"axy{YEARS[0]}.nc of {n} ranks",
                              os.path.join(out, f"axy{YEARS[0]}.nc"),
                              os.path.join(tmp, "ranks1",
                                           f"axy{YEARS[0]}.nc"))
        ranks[n] = dict(
            wall_s=wall, days=days,
            launches_per_rank=[rec["launches"] for rec in recs],
            collectives_per_day_per_rank=[
                sum(rec["collectives"].values()) / days for rec in recs],
            peak_gb_per_rank=[rec["peak_gb"] for rec in recs],
            year_s_per_rank={y["year"]: [rec["years"][i]["seconds"]
                                         for rec in recs]
                             for i, y in enumerate(recs[0]["years"])})
        print(f"multi-rank run, {n} rank(s) on one card: axy{YEARS[0]}.nc "
              f"({fields} variables) bitwise the 1-rank file, no part file "
              f"left; " + json.dumps(ranks[n]) + f" ({smi})")
    init = read_grid_file(os.path.join(tmp, "ranks1", "init_diagnostics.nc"),
                          ["land_mask", "theta_s"])
    check_annual_file("axy1901.nc of 1 rank",
                      os.path.join(tmp, "ranks1", f"axy{YEARS[0]}.nc"),
                      init["land_mask"] == 1.0, init["theta_s"])

    # 1902 resumed by 2 ranks from the 2-rank run's 1901 checkpoint.
    straight = os.path.join(tmp, "ranks2")
    resumed = config("resumed2", end_year=YEARS[1], checkpoint_every_years=1)
    os.makedirs(resumed + "_ck")
    for r in range(2):
        shutil.copy(os.path.join(straight + "_ck",
                                 f"year_{YEARS[0]}.rank{r}of2.pt"),
                    resumed + "_ck")
    logs, r_wall = launch_ranks(
        [("resume", 2, ["-m", "hybrid9_tpu_torch", "run", "--config",
                        resumed + ".json", "--shard", "--resume", *argv])],
        tmp)
    logs = logs["resume"]
    r_recs = [_rank_record(t) for t in logs]
    if any(rec["launches"] != (r_recs[0]["days"] if kernel else 0)
           for rec in r_recs) or not all(
               f"restored sharded checkpoint for year {YEARS[0]}" in t
               for t in logs):
        raise RuntimeError(f"2-rank resume: {r_recs}")
    name = f"axy{YEARS[1]}.nc"
    _same_netcdf(f"resumed {name}", os.path.join(resumed, name),
                 os.path.join(straight, name))
    # The same checkpoint under 1 rank: refused, naming both sizes.
    try:
        cli.main(["run", "--config", resumed + ".json", "--shard",
                  "--resume", *argv])
    except ValueError as e:
        refused = str(e)
        if "written by 2 rank(s); this run has 1" not in refused:
            raise
    else:
        raise RuntimeError("a 2-rank checkpoint restored under 1 rank")
    print(f"multi-rank resume: {name} of 2 ranks resumed from "
          f"{YEARS[0]} bitwise the straight 2-rank run's, "
          f"{r_recs[0]['launches']} launches a rank; under 1 rank: "
          f"{refused}")

    # The closed loop at LOOP_GRID_DEG degrees: 2 ranks against one
    # process, side by side on the card (phase 14 runs these commands at
    # full width and times them).
    groups, outs = [], {}
    for n in (1, 2):
        out = config(f"loop{n}", resolution_deg=LOOP_GRID_DEG,
                     nisurf=LOOP_FIT_NISURF)
        files = [os.path.join(tmp, f"loop{n}_{k}") for k in
                 ("ensemble.nc", "enkf.npz", "fit.npz")]
        shard = ["--shard"] if n == 2 else []
        cmds = [["ensemble", "--config", out + ".json", "--members",
                 str(ENSEMBLE_MEMBERS), "--out", files[0], *shard, *argv],
                ["assimilate", "--config", out + ".json", "--members",
                 str(DA_MEMBERS), "--days", str(LOOP_DA_DAYS), "--obs-twin",
                 "0.5", "--out", files[1], *shard, *argv],
                ["calibrate", "--config", out + ".json", "--per-cell",
                 "--obs-twin", "0.4", "--fields", "hksat", "--days",
                 str(FIT_DAYS), "--steps", str(FIT_STEPS), "--out", files[2],
                 *shard, *argv]]
        groups.append((f"loop{n}", n, ["-c", _COMMANDS, json.dumps(cmds)]))
        outs[n] = files
    loop = dict(wall_s=launch_ranks(groups, tmp)[1])
    _same_netcdf("ensemble --shard of 2 ranks", outs[2][0], outs[1][0])
    with np.load(outs[2][1]) as a, np.load(outs[1][1]) as b:
        off = [k for k in b.files if not np.array_equal(a[k], b[k])]
        if off:
            raise RuntimeError(f"assimilate --shard of 2 ranks: {off} not "
                               f"bitwise")
    fit_err = 0.0
    with np.load(outs[2][2]) as a, np.load(outs[1][2]) as b:
        for k in b.files:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            err = float(np.max(np.abs(x - y) / np.maximum(np.abs(y),
                                                           1e-30)))
            fit_err = max(fit_err, err)
            if err > LOOP_FIT_RTOL:
                raise RuntimeError(f"calibrate --shard of 2 ranks: {k} off "
                                   f"by {err} relative")
        loop["fit_multipliers_bitwise"] = bool(np.array_equal(a["hksat"],
                                                              b["hksat"]))
    loop["fit_max_rel_err"] = fit_err
    print(f"multi-rank closed loop at {LOOP_GRID_DEG} degrees, 2 ranks "
          f"against one process: ensemble --members {ENSEMBLE_MEMBERS} and "
          f"assimilate --members {DA_MEMBERS} --days {LOOP_DA_DAYS} bitwise; "
          f"calibrate --per-cell within {fit_err:.3e} relative (limit "
          f"{LOOP_FIT_RTOL}); " + json.dumps(loop))
    summary = dict(ranks=ranks, resume=dict(bitwise=True, wall_s=r_wall,
                                            launches_per_rank=[
                                                rec["launches"]
                                                for rec in r_recs]),
                   restore_under_one_rank_raises=True, closed_loop=loop)
    print(f"multi-rank ({smi}): " + json.dumps(summary))
    return summary


#: Phase 16: the study programs, each a child process on the card, with
#: the arguments of each leg (``python -m hybrid9_tpu_torch.scripts.<name>``)
#: and the day-kernel launches it must make.
STUDY_YEARS = 2
STUDY_ITERS = 10
STUDY_DA_DAYS = 2
ZD09_DEBUG_DAYS = 10
# The hydrology day's outputs among ``day_step``'s diagnostics.
HYDROLOGY_DIAGS = ("evap_day", "evap_grnd_day", "rnf_day",
                   "max_abs_residual")
STUDY_TIMEOUT_S = 600
# A leg's child: the program as ``python -m`` runs it, with the kernel
# wrapper timed by CUDA events around each call (its launch count is the
# wrapper's own); the last line is the leg's record.
_STUDY_LEG = """
import json, runpy, sys, time
import torch
from hybrid9_tpu_torch.physics import day_kernel
name, argv = sys.argv[1], json.loads(sys.argv[2])
real = day_kernel.hydrology_day_cuda
events, cells = [], set()
def timed(soil, *args, **kw):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = real(soil, *args, **kw)
    stop.record()
    events.append((start, stop))
    cells.add(int(soil.h2osoi_liq.shape[0]))
    return out
day_kernel.hydrology_day_cuda = timed
sys.argv = [name, *argv]
t0 = time.perf_counter()
try:
    runpy.run_module("hybrid9_tpu_torch.scripts." + name,
                     run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
seconds = time.perf_counter() - t0
if events:
    torch.cuda.synchronize()
ms = [a.elapsed_time(b) for a, b in events]
print("STUDY_LEG " + json.dumps(dict(
    rc=rc, seconds=seconds, launches=day_kernel.launches,
    cells=sorted(cells), kernel_ms=sum(ms) / len(ms) if ms else None)))
"""


def run_leg(name, argv, tmp, launches, ok_rcs=(0,)):
    """Run the study program ``name`` with ``argv`` in a child process,
    alone on the card; raise unless it exited with one of ``ok_rcs`` and
    made ``launches`` kernel launches.  Returns (its record, its
    output)."""
    path = os.path.join(tmp, f"{name}.log")
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _STUDY_LEG, name,
             json.dumps(list(argv))], cwd=_REPO, stdout=f,
            stderr=subprocess.STDOUT)
    try:
        proc.wait(timeout=STUDY_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.startswith("STUDY_LEG ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: the leg's process exited with "
                           f"{proc.returncode}:\n{text[-3000:]}")
    rec = json.loads(lines[-1][len("STUDY_LEG "):])
    if rec["rc"] not in ok_rcs:
        raise RuntimeError(f"{name}: exit code {rec['rc']}:\n"
                           f"{text[-3000:]}")
    if rec["launches"] != launches:
        raise RuntimeError(f"{name}: {rec['launches']} kernel launches, "
                           f"{launches} expected:\n{text[-3000:]}")
    return rec, text


def _number(pattern, text, label):
    """The float of ``pattern``'s one group in ``text``, all its
    matches."""
    found = [float(v) for v in re.findall(pattern, text)]
    if not found:
        raise RuntimeError(f"{label}: no match of {pattern!r}")
    return found


def zd09_matrix_leg(dev, kernel=True, **cfg_kw):
    """``zd09_debug``'s scan for ZD09_DEBUG_DAYS reference-scope days at
    0.5 degrees from 1901 (the kernel on the card; the launches counted),
    then its isolation matrix on the last day's state: the kernel's day
    against the twin's at k=8 and at k=1, every hydrology output at phase
    3's float32 tolerances with the knife-edge cells set aside, and
    finite.  ``kernel=False`` (the twin's rows only, no launch) and
    ``cfg_kw`` (fields of the Config) are for rehearsals on a small grid
    on the CPU.  Returns the leg's record."""
    from hybrid9_tpu_torch.scripts import zd09_debug
    cfg = dataclasses.replace(zd09_debug.debug_config(), **cfg_kw)
    grid, params = load_soil(cfg, torch.float32, dev)
    lg = cfg.layer_grid()
    state = initial_state(params, lg.dz, lg.zi, torch.float32, dev)
    geom = Geometry.from_layer_grid(lg)
    provider = zd09_debug.SyntheticForcingProvider(
        grid.n_padded, seed=0, lat=grid.cell_lat, device=dev)
    zero_launches()
    t0 = time.perf_counter()
    found, prev, f_day, _, days = zd09_debug.scan(
        cfg, params, geom, state, provider, grid.n_land,
        max_days=ZD09_DEBUG_DAYS)
    launches = read_launches("zd09_debug scan")
    rec = dict(launches=launches, cells=[grid.n_padded], days=days,
               seconds=time.perf_counter() - t0)
    if found is not None or launches != (days if kernel else 0):
        raise RuntimeError(f"zd09_debug scan: {found}, {launches} "
                           f"launches in {days} days")
    matrix = zd09_debug.MATRIX if kernel else tuple(
        row for row in zd09_debug.MATRIX if not row[2])
    results = zd09_debug.isolation_matrix(prev, f_day, params, geom, cfg,
                                          matrix)
    for label, (st, _) in results.items():
        if not bool(zd09_debug.finite_cells(st).all()):
            raise RuntimeError(f"zd09_debug matrix: {label} not finite")

    def hydrology(label):
        st, diags = results[label]
        return st.soil, {d: diags[d] for d in HYDROLOGY_DIAGS}

    for k in (8, 1) if kernel else ():
        want = hydrology(f"k={k} twin")
        got = hydrology(f"k={k} kernel")
        edge = knife_edge_cells(prev.soil, prev.veg, params, f_day, geom,
                                want, cfg.dt, cfg.nisurf, zd09_every=k)
        if int(edge.sum()) > MAX_KNIFE_EDGE_SHARE * grid.n_padded:
            raise RuntimeError(f"zd09_debug matrix k={k}: "
                               f"{int(edge.sum())} knife-edge cells")
        err = check_day(f"zd09_debug matrix, kernel vs twin at k={k}",
                        got, want, params.bsw, ~edge)[0]
        rec[f"k{k}_max_abs_err"] = err
        rec[f"k{k}_knife_edge_cells"] = int(edge.sum())
    return rec


def study_path(tmp, dev, smi):
    """Phase 16, the study programs on the card, each through its own
    ``python -m hybrid9_tpu_torch.scripts.<name>`` in a child process,
    one after another so that each leg's times are its own:
    ``flagship_soak --years 2`` (every year clean), ``flagship_run
    --years 2`` (two annual files, the worst residual under 0.1 mm),
    ``router_compare --iters 10 --soak-years 1`` (ms a day per scheme,
    each soak clean), ``da_soak --resolution 0.25 --days 2`` (16 members
    of the 0.25-degree grid folded into one launch a day) and
    ``zd09_drift --ks 1,8 --years 2 --scope reference`` (the JSON written,
    both arms and every drift number finite; the verdict recorded: two
    years cannot decide it, so exit 1, "bound exceeded", is taken too);
    then ``zd09_debug``'s isolation matrix in this process.  Each leg's
    kernel launches, cells and mean kernel ms (CUDA events around the
    wrapper) are recorded.  The programs' functions are rehearsed on the
    CPU by ``tests/test_torch_scripts.py``, the matrix by
    :func:`zd09_matrix_leg` with ``kernel=False``.  Returns the phase's
    summary."""
    def days(years):
        return sum(calendar.days_in_year(1901 + i) for i in range(years))

    out = os.path.join(tmp, "flagship")
    drift_json = os.path.join(tmp, "zd09_drift_torch.json")
    legs = {}
    rec, text = run_leg("flagship_soak", ["--years", str(STUDY_YEARS)], tmp,
                        days(STUDY_YEARS))
    if "ALL CLEAN" not in text:
        raise RuntimeError(f"flagship_soak: not clean:\n{text[-2000:]}")
    legs["flagship_soak"] = rec

    rec, text = run_leg("flagship_run", ["--years", str(STUDY_YEARS),
                                         "--out", out], tmp,
                        days(STUDY_YEARS))
    files = sorted(f for f in os.listdir(out) if f.startswith("axy"))
    worst = _number(r"worst residual ([\d.eE+-]+) mm", text,
                    "flagship_run")[0]
    if len(files) != STUDY_YEARS or not worst < MAX_RESIDUAL_MM:
        raise RuntimeError(f"flagship_run: {files}, worst residual "
                           f"{worst} mm")
    legs["flagship_run"] = dict(rec, files=files, worst_residual_mm=worst)

    schemes = ("linear", "kinematic", "muskingum")
    rec, text = run_leg("router_compare", ["--iters", str(STUDY_ITERS),
                                           "--soak-years", "1"], tmp,
                        len(schemes) * (3 + STUDY_ITERS + days(1)))
    ms = {s: _number(rf"{s}\s*: +([\d.]+) ms/day", text,
                     "router_compare")[0] for s in schemes}
    clean = re.findall(r"soak (\w+)\s*: .* (CLEAN|VIOLATION)", text)
    if sorted(clean) != sorted((s, "CLEAN") for s in schemes):
        raise RuntimeError(f"router_compare soaks: {clean}")
    legs["router_compare"] = dict(rec, ms_per_day=ms)

    rec, text = run_leg("da_soak", ["--resolution", "0.25", "--days",
                                    str(STUDY_DA_DAYS)], tmp, STUDY_DA_DAYS)
    folded = int(_number(r"= (\d+) folded cells", text, "da_soak")[0])
    cycle_ms = _number(r"([\d.]+) ms a cycle", text, "da_soak")[0]
    if rec["cells"] != [folded]:
        raise RuntimeError(f"da_soak: kernel cells {rec['cells']}, "
                           f"{folded} folded")
    legs["da_soak"] = dict(rec, folded_cells=folded, cycle_ms=cycle_ms)

    rec, text = run_leg("zd09_drift", ["--ks", "1,8", "--years",
                                       str(STUDY_YEARS), "--scope",
                                       "reference", "--out", drift_json],
                        tmp, 2 * days(STUDY_YEARS), ok_rcs=(0, 1))
    with open(drift_json) as f:
        doc = json.load(f)["reference"]
    numbers = [v for e in doc["fields"].values() for v in e.values()
               if not isinstance(v, bool)]
    if "NON-FINITE" in text or not np.isfinite(numbers).all():
        raise RuntimeError(f"zd09_drift: non-finite arms or drift:\n"
                           f"{text[-2000:]}")
    legs["zd09_drift"] = dict(rec, all_pass=doc["all_pass"], verdict={
        f: e["passes_bound"] for f, e in doc["fields"].items()})

    legs["zd09_debug"] = zd09_matrix_leg(dev)
    for name, rec in legs.items():
        print(f"study {name}: " + json.dumps(rec) + f" ({smi})")
    return legs


SLAB_DAYS = 5
SLAB_COUNTS = (4, 3)          # even and uneven cuts of 69,632 cells
SLAB_TIMED = (1, 2, 4)
SLAB_RUN_DAYS = 30
REHEARSAL_BANDS = 8
REHEARSAL_ITERS = 5
# The rehearsal's day-kernel launches: a census day of each routing form
# and of none, then a warm day and REHEARSAL_ITERS timed days of each
# form, REHEARSAL_BANDS slabs each.
REHEARSAL_LAUNCHES = REHEARSAL_BANDS * (3 + 2 * (1 + REHEARSAL_ITERS))


def _leaves_equal(label, got, want):
    for i, (x, y) in enumerate(zip(got, want)):
        if x.device != y.device or not torch.equal(x, y):
            raise RuntimeError(f"{label}: leaf {i} is not bitwise the "
                               f"unsharded path's")


def slab_path(tmp, flag, fblock, winter, dev, smi, kernel=True):
    """Phase 17, device slabs of one process (``DeviceSlabs``), as
    ``[cuda:0] * k``: SLAB_DAYS flagship days from 1 January through
    ``block_step(devices=[dev] * k)`` for k in SLAB_COUNTS, bitwise the
    unsharded block (every state field and sum), k day-kernel launches a
    day and the census of the exchanges (the router's ``2 (k - 1)`` halo
    rows a substep and two reshards a day, the two gathers that end the
    block, nothing else); the routed water balance of one resident day
    from the winter state; SLAB_RUN_DAYS days of
    ``Simulation(devices=[dev] * 4)``'s run loop (on-card forcing made
    slab by slab), its annual file byte for byte one slab's; the
    flagship day at k in SLAB_TIMED through ``scripts.slab_timing`` (ms,
    launches, host synchronisations a day against the unsharded day's;
    the forms in turns);
    and ``scripts.halo_rehearsal`` at 0.5 degrees in REHEARSAL_BANDS
    bands in a child process, exit 0.  ``kernel=False`` (no launch
    expected, nothing timed) is for rehearsals on the CPU.  Returns the
    phase's summary."""
    from hybrid9_tpu_torch.io.writer import AnnualWriter
    from hybrid9_tpu_torch.parallel import sharding as parallel
    from hybrid9_tpu_torch.scripts import slab_timing
    from hybrid9_tpu_torch.step import slab_day_step

    sim = flag.sim
    cfg = sim.cfg
    n = sim.n
    frun = dict(params=sim.params, geom=sim.geom, dt=cfg.dt,
                nisurf=cfg.nisurf)
    block = fblock.map(lambda x: x[:SLAB_DAYS])
    acc0 = AnnualAccumulators.zeros(n, sim.dtype, dev)
    want = block_step(sim.state, acc0, block, **frun, **flag.step_kwargs)
    want = _state_leaves(want[0]) + _state_leaves(want[1])
    out = dict(blocks={})
    for k in SLAB_COUNTS:
        parallel.collectives.clear()
        zero_launches()
        got = block_step(sim.state, acc0, block, **frun,
                         **dict(flag.step_kwargs, devices=[dev] * k))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = read_launches(f"{k} slabs")
        census = dict(parallel.collectives)
        if launches != (SLAB_DAYS * k if kernel else 0):
            raise RuntimeError(f"{k} slabs: {launches} kernel launches in "
                               f"{SLAB_DAYS} days")
        expected = {"halo": 2 * (k - 1) * cfg.routing_substeps * SLAB_DAYS,
                    "reshard": 2 * SLAB_DAYS, "state": 2}
        if census != expected:
            raise RuntimeError(f"{k} slabs: exchanges {census}, expected "
                               f"{expected}")
        _leaves_equal(f"{k} slabs", _state_leaves(got[0])
                      + _state_leaves(got[1]), want)
        out["blocks"][k] = dict(launches=launches, census=census)
        print(f"slab path: {SLAB_DAYS} flagship days on {k} slabs of "
              f"{dev} ({n} cells): bitwise the unsharded block, "
              f"{launches} kernel launches, exchanges {json.dumps(census)}")

    # The routed water balance of one resident day from the winter state.
    slabs = parallel.DeviceSlabs.create(n, [dev] * SLAB_COUNTS[0])
    f31 = Forcing.from_numpy(
        synthetic_forcing_block(SLAB_DAYS, n, seed=1,
                                start_doy=1 + FLAGSHIP_DAYS,
                                lat=flag.land_grid.cell_lat),
        sim.dtype, dev)
    states, diags = slab_day_step(
        slabs, slabs.put(winter), slabs.put(f31.map(lambda x: x[0])),
        slabs.put(sim.params), sim.geom, cfg.dt, cfg.nisurf,
        **flag.step_kwargs)
    land = slice(0, flag.land_grid.n_land)

    def joined(parts):
        return torch.cat(parts)[land].double().sum()

    water = [joined([s.river_store for s in states]),
             winter.river_store[land].double().sum(),
             joined([d["discharge"] for d in diags]),
             joined([d["rnf_day"] for d in diags])]
    balance = float(water[0] - water[1] + water[2] - water[3])
    scale = float(water[1] + torch.cat([d["rnf_day"] for d in diags])[
        land].double().abs().sum())
    if not abs(balance) <= 1e-5 * scale:
        raise RuntimeError(f"slab path: routed water balance off by "
                           f"{balance} mm of {scale} mm")
    out["routed_balance_mm"] = balance
    print(f"slab path: routed water balance of a resident day on "
          f"{slabs.k} slabs {balance:.3e} mm of {scale:.3e} mm")

    # The run loop of Simulation on 4 slabs and on one: the annual file.
    provider = DeviceSyntheticForcingProvider(
        n, seed=0, lat=flag.land_grid.cell_lat, dtype=sim.dtype, device=dev)
    files, run = {}, {}
    for k in (SLAB_COUNTS[0], 1):
        sim_k = Simulation(cfg, sim.params, land_grid=flag.land_grid,
                           devices=[dev] * k)
        zero_launches()
        t0 = time.perf_counter()
        acc = sim_k.accumulators()
        acc, _ = sim_k.advance(sim_k.forcing_block(provider, YEARS[0], 1,
                                                   SLAB_RUN_DAYS), acc)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches(f"Simulation on {k} slabs")
        if launches != (SLAB_RUN_DAYS * k if kernel else 0):
            raise RuntimeError(f"Simulation on {k} slabs: {launches} "
                               f"launches in {SLAB_RUN_DAYS} days")
        means = sim_k.host_means(acc)
        files[k] = AnnualWriter(os.path.join(tmp, f"slabs{k}"),
                                flag.land_grid).write_annual(YEARS[0], means)
        run[k] = dict(seconds=seconds, launches=launches,
                      max_residual_mm=float(means["max_abs_residual"][
                          land].max()))
    with open(files[SLAB_COUNTS[0]], "rb") as a, open(files[1], "rb") as b:
        if a.read() != b.read():
            raise RuntimeError("Simulation on 4 slabs: the annual file is "
                               "not byte for byte one slab's")
    out["run_loop"] = run
    print(f"slab path: {SLAB_RUN_DAYS} days of Simulation(devices=[{dev}] "
          f"* {SLAB_COUNTS[0]}) through its run loop, annual file byte for "
          f"byte one slab's: " + json.dumps(run) + f" ({smi})")
    if not kernel:
        return out

    # The flagship day on the resident path at k slabs, and unsharded.
    costs = slab_timing.in_turns(
        flag, winter, f31, [None] + [[dev] * k for k in SLAB_TIMED])
    base = costs[0]["host_syncs_a_day"]
    for c in costs[1:]:
        if c["host_syncs_a_day"] > base:
            raise RuntimeError(f"{c['slabs']} slabs: {c['host_syncs_a_day']}"
                               f" host syncs a day, the unsharded day "
                               f"{base}")
    out["day_costs"] = costs
    for c in costs:
        print(f"timing: flagship day on {c['slabs']} slab(s) (0: "
              f"unsharded): " + json.dumps(c) + f" ({smi})")

    rec, text = run_leg("halo_rehearsal", ["--device", str(dev),
                                           "--bands", str(REHEARSAL_BANDS),
                                           "--iters", str(REHEARSAL_ITERS)],
                        tmp, REHEARSAL_LAUNCHES)
    if "audit OK at 360 rows" not in text:
        raise RuntimeError(f"halo_rehearsal: no audit line:\n{text[-3000:]}")
    out["rehearsal"] = dict(
        seconds=rec["seconds"],
        grid_ms=_number(r"grid   routed day: ([\d.]+) ms", text,
                        "rehearsal")[0],
        packed_ms=_number(r"packed routed day: ([\d.]+) ms", text,
                          "rehearsal")[0])
    print("halo rehearsal at 0.5 degrees: exit 0, " + json.dumps(
        out["rehearsal"]) + f" ({smi})")
    return out


#: Phase 18: the closed loop and the carbon spin-up on device slabs of one
#: process (``[cuda:0] * k``), against the unsharded drivers.
LOOP_SLAB_COUNTS = (4, 3)     # even and uneven cuts of 69,632 cells
LOOP_TIMED = (1, 2, 4)        # slab counts timed beside the unsharded forms
LOOP_ENS_DAYS = 10
LOOP_DA_CYCLES = 5
# The fit's check runs the plain day at 4 substeps, not 48: its forward,
# recomputation and backward cost some 9 s a day of the card's host time
# whatever the cell count, and the check runs it 1 + 4 + 3 times, and the
# commands' legs twice more.  ``scripts.slab_timing --parts fit`` times the
# step at the default 48.
LOOP_FIT_NISURF = 4


def _outputs(out: dict) -> list:
    """A driver's outputs as a flat list of tensors (a state's leaves
    included), in key order."""
    return [x for k in sorted(out) for x in (
        [out[k]] if isinstance(out[k], torch.Tensor)
        else _state_leaves(out[k]))]


class CensusAtJoin:
    """While active, records the exchanges counted by
    ``parallel.sharding.collectives`` when the first
    ``DeviceSlabs.gather`` begins: everything a driver exchanged before it
    joins its outputs.  The census starts at zero."""

    def __enter__(self):
        from hybrid9_tpu_torch.parallel import sharding as parallel
        self.parallel, self.seen = parallel, []
        self._gather = gather = parallel.DeviceSlabs.gather
        seen = self.seen

        def first(slabs, *args, **kw):
            if not seen:
                seen.append(dict(parallel.collectives))
            return gather(slabs, *args, **kw)
        parallel.DeviceSlabs.gather = first
        parallel.collectives.clear()
        return self

    def __exit__(self, *exc):
        self.parallel.DeviceSlabs.gather = self._gather


def slab_loop_path(tmp, flag, dev, smi, kernel=True, **cfg_kw):
    """Phase 18, the closed loop and the carbon spin-up on device slabs
    of one process, as ``[dev] * k`` (``cfg_kw`` is for rehearsals on a
    small grid; ``kernel=False``, no launch expected and nothing timed, for
    rehearsals on the CPU).  At k in LOOP_SLAB_COUNTS against the
    unsharded drivers on ``Config()`` at 0.5 degrees: LOOP_ENS_DAYS days of
    ``run_ensemble_annual`` (8 members) and LOOP_DA_CYCLES cycles of
    ``assimilate`` (16 members, observations made by the kernel day under
    hksat log-multiplier 0.5), every output bitwise, k kernel launches a
    day and nothing exchanged before the one join of the outputs; a
    1-step per-cell ``calibrate`` of hksat at LOOP_GRID_DEG degrees over
    FIT_DAYS days (LOOP_FIT_NISURF substeps) within LOOP_FIT_RTOL of the
    unsharded fit, its gradients finite, no kernel launch.  One
    rehearsal year of ``spinup_carbon`` on ``Simulation(devices=[dev] *
    k)`` (``flag``'s configuration) at k = 4 and in LOOP_TIMED, each
    bitwise the unsharded year's report and state, k launches a day, the
    state never gathered.  ``ensemble``, ``assimilate`` and ``calibrate
    --config`` through ``cli.main`` at LOOP_GRID_DEG degrees, each exit
    0, and with ``--shard`` on ``[dev] * LOOP_SLAB_COUNTS[-1]`` (the
    one-process sharding a box of that many cards gives) the file of the
    command without ``--shard``: bitwise, the fit's within LOOP_FIT_RTOL.
    Timed at k in LOOP_TIMED and unsharded
    (``scripts.slab_timing``): the ensemble day, the DA forecast and
    cycle in turns (ms, launches, host syncs a day: none added by the
    slabs), the fit's step and peak memory, the rehearsal year's seconds.
    Returns the phase's summary."""
    from hybrid9_tpu_torch import assimilate as da
    from hybrid9_tpu_torch import ensemble as ens
    from hybrid9_tpu_torch.parallel import sharding as parallel
    from hybrid9_tpu_torch.scripts import slab_timing as st

    cuda = dev.type == "cuda"
    prob = st.loop_problem(Config(output_path=tmp, **cfg_kw), dev,
                           LOOP_ENS_DAYS)
    n = prob.params.n_cells
    out = dict(cells=n)

    def against_unsharded(label, run, days):
        """``run(devices)`` unsharded and at k in LOOP_SLAB_COUNTS: every
        output bitwise, ``days`` launches a slab, the exchanges before
        and at the join."""
        want = _outputs(run(None))
        got = {}
        for k in LOOP_SLAB_COUNTS:
            zero_launches()
            with CensusAtJoin() as census:
                res = run([dev] * k)
                if cuda:
                    torch.cuda.synchronize()
            launches = read_launches(f"{label} on {k} slabs")
            joined = dict(parallel.collectives)
            if kernel and launches != days * k:
                raise RuntimeError(f"{label} on {k} slabs: {launches} kernel "
                                   f"launches in {days} days")
            if census.seen != [{}] or joined != {"result": 1}:
                raise RuntimeError(f"{label} on {k} slabs: exchanges "
                                   f"{census.seen} before the join, "
                                   f"{joined} in all")
            _leaves_equal(f"{label} on {k} slabs", _outputs(res), want)
            got[k] = dict(launches=launches, census=joined)
        print(f"slab loop: {label} on {list(got)} slabs of {dev}: bitwise "
              f"the unsharded run, " + json.dumps(got))
        return got

    def ensemble(devices):
        return ens.run_ensemble_annual(prob.theta, prob.params, prob.state0,
                                       prob.forcing, prob.geom,
                                       devices=devices, **prob.step)
    out["ensemble"] = against_unsharded(
        f"ensemble, {ENSEMBLE_MEMBERS} members x {n} cells x "
        f"{LOOP_ENS_DAYS} days", ensemble, LOOP_ENS_DAYS)

    def cycles(x):
        return x[:LOOP_DA_CYCLES]

    def assimilate(devices):
        return da.assimilate(prob.params, prob.state0,
                             prob.forcing.map(cycles),
                             cycles(prob.obs), prob.geom,
                             n_members=DA_MEMBERS,
                             obs_mask=cycles(prob.mask), theta_spread=0.3,
                             seed=0, cfg=st.ENKF, devices=devices,
                             **prob.step)
    out["assimilate"] = against_unsharded(
        f"assimilate, {DA_MEMBERS} members x {n} cells x {LOOP_DA_CYCLES} "
        f"cycles", assimilate, LOOP_DA_CYCLES)

    # The fit: unsharded, then at k in LOOP_SLAB_COUNTS.
    fit_kw = dict(cfg_kw, resolution_deg=LOOP_GRID_DEG,
                  nisurf=LOOP_FIT_NISURF)
    fprob = st.fit_problem(Config(**fit_kw), dev, FIT_DAYS)
    fits = {0: st.fit_step(fprob, None)}
    for k in LOOP_SLAB_COUNTS:
        fits[k] = st.fit_step(fprob, [dev] * k)
    want = fits[0]["result"]
    hist = want.loss_history
    if not (bool(torch.isfinite(hist).all())
            and float(hist[-1]) < float(hist[0])):
        raise RuntimeError(f"slab loop fit: loss {hist.tolist()}")
    fit_err = 0.0
    for k, got in fits.items():
        if not got["grads_finite"] or got["launches"]:
            raise RuntimeError(f"fit on {k} slabs: gradients finite "
                               f"{got['grads_finite']}, {got['launches']} "
                               f"kernel launches")
        res = got["result"]
        for label, x, y in (("loss history", res.loss_history, hist),
                            ("theta", res.theta["hksat"],
                             want.theta["hksat"])):
            err = float(((x.double() - y.double()).abs()
                         / y.double().abs().clamp(min=1e-30)).max())
            fit_err = max(fit_err, err)
            if x.shape != y.shape or err > LOOP_FIT_RTOL:
                raise RuntimeError(f"fit on {k} slabs: {label} off the "
                                   f"unsharded fit by {err} relative")
    out["fit"] = dict(cells=fprob.params.n_cells, days=FIT_DAYS,
                      nisurf=LOOP_FIT_NISURF, max_rel_err=fit_err,
                      loss=hist.tolist(), by_slabs={
                          k: dict(step_s=v["step_s"],
                                  peak_bytes=v["peak_bytes"])
                          for k, v in fits.items()})
    print(f"slab loop: 1-step per-cell calibrate of hksat at {LOOP_GRID_DEG} "
          f"degrees ({fprob.params.n_cells} cells, {FIT_DAYS} days, nisurf "
          f"{LOOP_FIT_NISURF}) on {list(LOOP_SLAB_COUNTS)} slabs within "
          f"{fit_err:.3e} relative of the unsharded fit (limit "
          f"{LOOP_FIT_RTOL}), finite gradients, no kernel launch; step "
          f"seconds and peak bytes by slabs (0: unsharded): "
          + json.dumps(out["fit"]["by_slabs"]) + f" ({smi})")

    # One rehearsal year of the spin-up, unsharded and on slabs.
    sim0 = flag.sim
    ndays = calendar.days_in_year(sim0.cfg.start_year)
    spins = {}
    for k in (0,) + tuple(sorted({LOOP_SLAB_COUNTS[0], *LOOP_TIMED},
                                 reverse=True)):
        parallel.collectives.clear()
        got = st.rehearsal_year(sim0.cfg, sim0.params, flag.land_grid,
                                None if k == 0 else [dev] * k)
        census = dict(parallel.collectives)
        if kernel and got["launches"] != ndays * max(k, 1):
            raise RuntimeError(f"spin-up on {k} slabs: {got['launches']} "
                               f"launches in a rehearsal year")
        if k and (census.get("result") != 2 or "state" in census):
            raise RuntimeError(f"spin-up on {k} slabs: exchanges {census}")
        got["leaves"] = _state_leaves(got.pop("sim").state)
        if k:
            if got["report"] != spins[0]["report"]:
                raise RuntimeError(f"spin-up on {k} slabs: report "
                                   f"{got['report']}, unsharded "
                                   f"{spins[0]['report']}")
            _leaves_equal(f"spin-up on {k} slabs", got["leaves"],
                          spins[0]["leaves"])
        spins[k] = got
    out["spinup"] = {k: dict(seconds=v["seconds"], launches=v["launches"])
                     for k, v in spins.items()}
    print(f"slab loop: one rehearsal year of spinup_carbon on "
          f"Simulation(devices=[{dev}] * k) bitwise the unsharded year "
          f"(report {json.dumps(spins[0]['report'])}); seconds and launches "
          f"by slabs (0: unsharded): " + json.dumps(out["spinup"])
          + f" ({smi})")

    # The commands in one process, without --shard and with --shard as a
    # box of LOOP_SLAB_COUNTS[-1] cards would run them: cli._sharding's
    # one-process sharding holds [dev] * k, so the twin observations and
    # the drivers run on k slabs of the card.
    path = os.path.join(tmp, "slab_loop.json")
    with open(path, "w") as f:
        f.write(Config(output_path=tmp, **fit_kw).to_json())
    device_argv = [] if cuda else ["--device", str(dev)]
    k = LOOP_SLAB_COUNTS[-1]
    sharding = cli._sharding

    def k_cards(shard, n, device):
        got = sharding(shard, n, device)
        return got and dataclasses.replace(got, devices=(dev,) * k)
    walls = {}
    for name, argv, suffix in (
            ("ensemble", ["--members", str(ENSEMBLE_MEMBERS), "--days", "3"],
             ".nc"),
            ("assimilate", ["--members", str(DA_MEMBERS), "--days", "2",
                            "--obs-twin", "0.5"], ".npz"),
            ("calibrate", ["--per-cell", "--obs-twin", "0.4", "--fields",
                           "hksat", "--days", "1", "--steps", "1"], ".npz")):
        outs = {}
        for shard in (False, True):
            written = os.path.join(tmp, f"cli_{name}_{shard}{suffix}")
            flags = ["--shard"] if shard else []
            cli._sharding = k_cards if shard else sharding
            parallel.collectives.clear()
            try:
                walls[f"{name}{' --shard' if shard else ''}"] = _run_cli(
                    [name, "--config", path, *flags, *argv, *device_argv,
                     "--out", written], f"{name} {' '.join(flags)}")
            finally:
                cli._sharding = sharding
            joins = parallel.collectives.get("result", 0)
            if joins != (1 if name == "ensemble" else 2) * shard:
                raise RuntimeError(f"{name} {flags}: {joins} joins of slab "
                                   f"outputs")
            outs[shard] = written
        if name == "ensemble":
            _same_netcdf(f"ensemble --shard on {k} slabs", outs[True],
                         outs[False])
            continue
        limit = 0.0 if name == "assimilate" else LOOP_FIT_RTOL
        with np.load(outs[False]) as want, np.load(outs[True]) as got:
            for key in want.files:
                x, y = got[key], want[key]
                err = float(np.max(np.abs(x - y) / np.maximum(
                    np.abs(y), 1e-30))) if x.shape == y.shape else np.inf
                if err > limit:
                    raise RuntimeError(f"{name} --shard on {k} slabs: {key} "
                                       f"off the command without --shard "
                                       f"by {err} relative")
    out["cli_shard_wall_s"] = walls
    print(f"slab loop: ensemble, assimilate and calibrate --config in one "
          f"process at {LOOP_GRID_DEG} degrees, nisurf {LOOP_FIT_NISURF}, "
          f"exit 0; with --shard on {k} slabs of {dev} (as on a box of {k} "
          f"cards) the twin observations and the drivers joined on the "
          f"slabs, the files bitwise the command's without --shard (the "
          f"fit's within {LOOP_FIT_RTOL}); wall seconds "
          + json.dumps(walls))

    # The closed loop's days at k in LOOP_TIMED and unsharded, in turns.
    forms = [None] + [[dev] * k for k in LOOP_TIMED]
    if not kernel:
        for devices in forms:
            for name, run in st.loop_days(prob, devices).items():
                _all_finite(f"{name} on {devices}", [("ET", run())])
        return out
    timed = st.loop_costs(prob, forms)
    for name, got in timed.items():
        for c in got[1:]:
            if c["host_syncs_a_day"] > got[0]["host_syncs_a_day"]:
                raise RuntimeError(f"{name} on {c['slabs']} slabs: "
                                   f"{c['host_syncs_a_day']} host syncs a "
                                   f"day, unsharded "
                                   f"{got[0]['host_syncs_a_day']}")
        print(f"timing: {name} by slabs (0: unsharded): "
              + json.dumps(got) + f" ({smi})")
    out["timed"] = timed
    return out

#: Phase 3's layer counts without a build of their own, held on
#: day_kernel_any alone; it is held at FIXED_NLS too, and the edge states
#: at EDGE_NLS through both instances where the count has a build.  They
#: reach the ends of each register build's counts (kernels.ANY_BUILDS: in
#: float32 3-8, 9-10, 12, 13-16, 20-22 and 24, 30-32; in float64 10-12; 8
#: and 20 through any_nl, 10 in the edge states and phase 19) and the
#: all-shared form beside them (11 in float32; 3, 9, 13 and up in
#: float64).
LAYER_COUNTS = (3, 9, 11, 12, 13, 16, 24, 30, 32)
EDGE_NLS = (8, 10, 20)
#: At this many layers or fewer, 5-7 % of the float32 varied columns end
#: their day within KNIFE_EDGE_M of the base of the thick bottom layer,
#: above MAX_KNIFE_EDGE_SHARE: float32 is held on the reference states.
COARSE_NL = 5
#: day_kernel_any past the counts the checks hold cell by cell: launched
#: in both dtypes, finite and conserving (its thin layers put a tenth of
#: the float64 varied columns on knife edges of their own).
WIDE_NL = 64
HOT_DAYS = 730


def regimes_at(nl):
    """CHECK_REGIMES at ``nl`` layers: the float32 varied columns only
    above COARSE_NL layers (the float32 reference states hold below)."""
    return tuple((d, r) for d, r in CHECK_REGIMES
                 if not (d == torch.float32 and r == "varied_off_interfaces"
                         and nl <= COARSE_NL))


def layer_count_checks(dev, n=N_CHECK):
    """The layer counts of phase 3 without a build of their own:
    ``day_kernel_any`` against the plain twin at LAYER_COUNTS
    (``zd09_every=8``, with and without imp; at FIXED_NLS phase 3's first
    checks hold it beside the fixed builds): float64 on the varied
    columns at F64_TOL, float32 on the varied columns off the interfaces
    at F32_TOL with the cells :func:`check_kernel` sets aside for it, or
    on the reference states at COARSE_NL layers and fewer; each count's
    residency; the edge states with imp at EDGE_NLS through both
    instances where the count has a build of its own
    (tests/test_torch_cuda.py runs both imp flags and both zd09_every);
    WIDE_NL layers in both dtypes (finite, the water balance); and a count
    below ``MIN_NL`` or above ``layer_cap`` refused before any launch.
    Returns the summary."""
    out = dict(counts={}, edge={}, residency={}, wide={})
    lib = kernels.day_kernel_lib()
    for nl in LAYER_COUNTS:
        for dtype, regime in ((torch.float64, "varied"),
                              (torch.float32, "reference" if nl <= COARSE_NL
                               else "varied_off_interfaces")):
            case = check_case(n, nl, dtype, dev, regime)
            name = str(dtype)[6:]
            for use_imp in (False, True):
                label = (f"check {name} {regime} nl={nl} zd09_every=8 "
                         f"imp={use_imp}, day_kernel_any")
                err, res, n_edge = check_kernel(label, case, regime, 8,
                                                use_imp, instances=(True,))
                out["counts"][f"{name} nl={nl} imp={use_imp}"] = dict(
                    max_abs_err=err, max_residual=res, set_aside=n_edge)
                print(f"{label}: ok, max|kernel-twin| h2osoi {err:.3e} mm, "
                      f"max residual {res:.3e} mm, {n_edge} cells set aside")
    for nl in LAYER_COUNTS + day_kernel.FIXED_NLS:
        for dtype in (torch.float32, torch.float64):
            form = day_kernel.kernel_instance(dtype, nl, any_nl=True)
            sms, blocks, threads, nbytes = day_kernel.instance_residency(
                lib, dtype, nl, True, form=form)
            out["residency"][f"{str(dtype)[6:]} nl={nl}"] = dict(
                form=form, resident_blocks_per_sm=blocks,
                predicted_blocks_per_sm=day_kernel.any_residency(
                    dtype, nl, form, N_FLAGSHIP)["warps"],
                threads_per_block=threads, shared_bytes_per_block=nbytes,
                rounds_at_flagship_cells=day_kernel.rounds(
                    N_FLAGSHIP, sms, blocks, threads))
    for nl in EDGE_NLS:
        instances = (False, True) if nl in day_kernel.FIXED_NLS else (True,)
        for dtype in (torch.float32, torch.float64):
            case = check_case(EDGE_COLUMNS * len(EDGE_FORCINGS), nl, dtype,
                              dev, "edge")
            for use_imp in (True,):
                label = (f"check {str(dtype)[6:]} edge nl={nl} zd09_every=8 "
                         f"imp={use_imp}, any_nl in {instances}")
                err, res, n_edge = check_kernel(label, case, "edge", 8,
                                                use_imp, instances)
                out["edge"][f"{str(dtype)[6:]} nl={nl} imp={use_imp}"] = \
                    dict(max_abs_err=err, max_residual=res,
                         set_aside=n_edge)
                print(f"{label}: ok, max|kernel-twin| h2osoi {err:.3e} mm, "
                      f"max residual {res:.3e} mm, {n_edge} of "
                      f"{case[0].zwt.numel()} cells set aside")
    for dtype in (torch.float32, torch.float64):
        soil, veg, params, forcing, geom, imp = check_case(
            n, WIDE_NL, dtype, dev, "varied")
        soil1, diags = day_kernel.hydrology_day_cuda(
            soil, veg, params, forcing, geom, 1800.0, 48, imp=imp,
            zd09_every=8)
        label = f"{WIDE_NL} layers, {str(dtype)[6:]}"
        _all_finite(label, list(diags.items())
                    + [("h2osoi_liq", soil1.h2osoi_liq), ("zwt", soil1.zwt),
                       ("smp", soil1.smp), ("wa", soil1.wa)])
        res = float(diags["max_abs_residual"].max())
        if not res < MAX_RESIDUAL_MM:
            raise RuntimeError(f"{label}: residual {res} mm")
        _, blocks, threads, nbytes = day_kernel.instance_residency(
            lib, dtype, WIDE_NL, True)
        out["wide"][str(dtype)[6:]] = dict(
            nl=WIDE_NL, max_residual=res, resident_blocks_per_sm=blocks,
            threads_per_block=threads, shared_bytes_per_block=nbytes)
        print(f"{label}: day_kernel_any finite, max residual {res:.3e} mm, "
              f"{threads} threads and {nbytes} shared bytes a block, "
              f"{blocks} blocks an SM")
    before = day_kernel.launches
    soil, veg, params, forcing, geom, _ = check_case(64, 2, torch.float32,
                                                     dev, "reference")
    refused = []
    for call in (
            lambda: day_kernel.hydrology_day_cuda(soil, veg, params, forcing,
                                                  geom, 1800.0, 48),
            lambda: day_kernel.kernel_instance(
                torch.float32, day_kernel.layer_cap(torch.float32) + 1),
            lambda: day_kernel.kernel_instance(
                torch.float64, day_kernel.layer_cap(torch.float64) + 1)):
        try:
            call()
        except ValueError as e:
            refused.append(str(e))
        else:
            raise RuntimeError("a layer count the kernel does not take "
                               "was not refused")
    if day_kernel.launches != before:
        raise RuntimeError("a refused layer count launched the kernel")
    out["refused"] = refused
    print("refused before any launch: " + "; ".join(refused))
    return out


def hot_climate(dev):
    """The hot climate of tests/test_run_e2e.py::test_hot_climate_stability
    on the kernel: two years at 318 K and pr = 3e-4 on 64 reference cells
    in float32 through ``day_step`` (one launch a day): the state finite,
    plant mass and root depth positive, every day's residual under
    MAX_RESIDUAL_MM.  Returns the summary."""
    case = build_reference_case(64, device=dev)
    hot = case.forcing.replace(tas=torch.full_like(case.forcing.tas, 318.0),
                               pr=torch.full_like(case.forcing.pr, 3.0e-4))
    state, cfg = case.state, case.cfg
    worst = torch.zeros_like(state.soil.zwt[0])
    zero_launches()
    t0 = time.perf_counter()
    for _ in range(HOT_DAYS):
        state, diags = day_step(state, hot, case.params, case.geom, cfg.dt,
                                cfg.nisurf, use_kernel=True)
        worst = torch.maximum(worst, diags["max_abs_residual"].max())
    launches = read_launches("hot climate")
    seconds = time.perf_counter() - t0
    _all_finite("hot climate", [(f"state[{i}]", x) for i, x in
                                enumerate(_state_leaves(state))])
    out = dict(days=HOT_DAYS, launches=launches, seconds=seconds,
               max_residual=float(worst),
               min_plant_mass=float(state.veg.plant_mass.min()),
               min_rdepth=float(state.veg.rdepth.min()))
    if launches != HOT_DAYS or not out["max_residual"] < MAX_RESIDUAL_MM \
            or not (out["min_plant_mass"] > 0 and out["min_rdepth"] > 0):
        raise RuntimeError(f"hot climate: {out}")
    print(f"hot climate, {HOT_DAYS} days at 318 K on 64 cells: "
          + json.dumps(out))
    return out


#: Phase 19: the layer count and year of the 10-layer global run.
LAYER_YEAR_NL = 10
LAYER_YEAR = 1901
LAYER_CHECK_DAYS = 30


def build_times(dev, n):
    """Each register build of ``day_kernel_any`` against its all-shared
    form, in turns, at the fewest and the most layers it serves
    (``kernels.ANY_BUILDS``), on ``n`` varied columns with imp
    (``zd09_every=8``): ms of each and their ratio, by build and count."""
    out = {}
    for real, cap, counts in kernels.ANY_BUILDS:
        dtype = torch.float32 if real == "float" else torch.float64
        for nl in sorted({min(counts), max(counts)}):
            soil, veg, params, forcing, geom, imp = check_case(
                n, nl, dtype, dev, "varied")
            forms = {f: (lambda f=f: day_kernel.hydrology_day_cuda(
                soil, veg, params, forcing, geom, 1800.0, 48, imp=imp,
                zd09_every=8, form=f)[0].h2osoi_liq)
                for f in (cap, day_kernel.ALL_SHARED)}
            times = {f: [] for f in forms}
            for order in (list(forms), list(forms)[::-1]):
                for f in order:
                    times[f].append(_time_cuda(forms[f], 10)[0])
            ms = {f: float(np.mean(v)) for f, v in times.items()}
            out[f"{str(dtype)[6:]} capacity={cap} nl={nl}"] = dict(
                ms=ms[cap], shared_ms=ms[day_kernel.ALL_SHARED],
                ratio=ms[cap] / ms[day_kernel.ALL_SHARED])
    print("register builds against the all-shared form, ms at the ends of "
          "each build's range: " + json.dumps(out))
    return out


def layer_year_path(tmp, dev, smi, flag_winter, argv=(),
                    resolution_deg=0.5, **cfg_kw):
    """Phase 19, a global year at LAYER_YEAR_NL layers through the command
    line: a raw soil archive of that many layers at ``resolution_deg``
    (``synthesize_raw_soil_archive``, factor 2: NetCDF-3 without h5py),
    ``prep-soil --layers 10``, then ``run --config run10.json --years
    1901 1901`` with ``Config()`` on ``exponential_interfaces(10)`` and the
    prepared file (forcing on the card, as phase 10's): every day one
    launch of ``day_kernel_any``, the annual file and every day's residual
    checked.  Then, in this process on the same soil: 30 days from 1
    January through ``block_step``, the kernel against the twin on the
    winter state they end in (day 31, imp and sw_abs; the cells of
    :func:`knife_edge_cells`, :func:`float32_noise_cells` and
    :func:`rounding_explained` set aside); the kernel's ms there (its
    all-shared form's, and both in float64 on the same state) against the
    fixed nl=8 build's and ``day_kernel_any``'s at nl=8 on the flagship
    winter state ``flag_winter`` (``(args, kw)`` of phase 6's winter day),
    in turns, with the two ratios to the fixed build; :func:`build_times`;
    the bound by operations; and 5 days of
    ``block_step(devices=[dev] * 3)``, bitwise the unsharded block with 3
    launches a day.  ``argv`` and ``cfg_kw`` are for rehearsals on a small
    grid.  Returns the summary."""
    t0 = time.perf_counter()
    arch = synthesize_raw_soil_archive(
        os.path.join(tmp, "raw"), resolution_deg=resolution_deg, factor=2,
        n_layers=LAYER_YEAR_NL)
    soil_path = os.path.join(tmp, f"soil{LAYER_YEAR_NL}.nc")
    _run_cli(["prep-soil", "--hwsd", arch["hwsd"], "--bnu-dir",
              arch["bnu_dir"], "--fmax", arch["fmax"], "--out", soil_path,
              "--layers", str(LAYER_YEAR_NL)], "prep-soil")
    prep_s = time.perf_counter() - t0
    layer_kw = dict(zi_mm=tuple(exponential_interfaces(LAYER_YEAR_NL)),
                    soil_source="netcdf", soil_path=soil_path,
                    resolution_deg=resolution_deg, **cfg_kw)
    log = YearLog()
    logger = logging.getLogger("hybrid9_tpu_torch")
    logger.addHandler(log)
    try:
        wall, launches, years, out = run_years(
            tmp, f"year{LAYER_YEAR_NL}", log,
            ["--years", str(LAYER_YEAR), str(LAYER_YEAR), *argv],
            forcing="device-synthetic", start_year=LAYER_YEAR,
            end_year=LAYER_YEAR, **layer_kw)
    finally:
        logger.removeHandler(log)
    ndays = calendar.days_in_year(LAYER_YEAR)
    if launches != ndays or len(years) != 1:
        raise RuntimeError(f"{LAYER_YEAR_NL}-layer year: {launches} kernel "
                           f"launches, years {years}")
    init = read_grid_file(os.path.join(out, "init_diagnostics.nc"),
                          ["land_mask", "theta_s"])
    land = init["land_mask"] == 1.0
    file_res, theta_min, theta_max = check_annual_file(
        f"{LAYER_YEAR_NL}-layer axy{LAYER_YEAR}.nc",
        os.path.join(out, f"axy{LAYER_YEAR}.nc"), land, init["theta_s"])
    year = years[0]
    if not year["max_residual_mm"] < MAX_RESIDUAL_MM:
        raise RuntimeError(f"{LAYER_YEAR_NL}-layer year: residual "
                           f"{year['max_residual_mm']} mm")
    print(f"{LAYER_YEAR_NL}-layer year {LAYER_YEAR} through the command line "
          f"({int(land.sum())} land cells): {launches} kernel launches, "
          f"{year['seconds']:.3f} s in run_year ({wall:.2f} s wall), worst "
          f"daily residual {year['max_residual_mm']:.3e} mm, theta "
          f"[{theta_min:.4f}, {theta_max:.4f}]; archive and prep-soil "
          f"{prep_s:.1f} s ({smi})")

    # The same soil in this process: 30 days to the winter state.
    cfg = Config(output_path=os.path.join(tmp, "check"), **layer_kw)
    dtype = getattr(torch, cfg.dtype)
    grid, params = load_soil(cfg, dtype, dev)
    sim = Simulation(cfg, params, land_grid=grid)
    n = sim.n
    if len(sim.geom.dz_soil) != LAYER_YEAR_NL or \
            sim.use_kernel != (dev.type == "cuda"):
        raise RuntimeError(f"{LAYER_YEAR_NL}-layer Simulation: "
                           f"{len(sim.geom.dz_soil)} layers, use_kernel="
                           f"{sim.use_kernel}")
    lat = grid.cell_lat
    block = Forcing.from_numpy(
        synthetic_forcing_block(LAYER_CHECK_DAYS, n, seed=1, start_doy=1,
                                lat=lat), dtype, dev)
    acc0 = AnnualAccumulators.zeros(n, dtype, dev, nsoil=LAYER_YEAR_NL)
    run = dict(params=sim.params, geom=sim.geom, dt=cfg.dt,
               nisurf=cfg.nisurf)
    winter, _ = block_step(sim.state, acc0, block, **run,
                           **sim.step_kwargs())
    f31 = Forcing.from_numpy(
        synthetic_forcing_day(n, 1 + LAYER_CHECK_DAYS, seed=1, lat=lat),
        dtype, dev)
    args = (winter.soil, winter.veg, sim.params, f31, sim.geom, cfg.dt,
            cfg.nisurf)
    kw = dict(imp=freeze_impedance_from_ice(winter.soil.h2osoi_liq,
                                            winter.h2osoi_ice),
              sw_abs=snow_absorptivity(winter.swe, *sim.snow_albedo),
              zd09_every=cfg.zd09_every)
    want = day_kernel.hydrology_day_plain(*args, **kw)
    got = day_kernel.hydrology_day_cuda(*args, **kw)
    edge = knife_edge_cells(*args[:5], want, **kw)
    edge |= float32_noise_cells(*args[:5], want, **kw)
    edge |= rounding_explained(got, want, *args[:5], ~edge, **kw)
    if int(edge.sum()) > MAX_KNIFE_EDGE_SHARE * n:
        raise RuntimeError(f"{LAYER_YEAR_NL}-layer winter state: "
                           f"{int(edge.sum())} of {n} cells set aside")
    err = check_day(f"{LAYER_YEAR_NL}-layer kernel vs twin, winter state",
                    got, want, sim.params.bsw, ~edge)[0]
    print(f"{LAYER_YEAR_NL}-layer kernel vs twin, {n} cells, winter state "
          f"(day {1 + LAYER_CHECK_DAYS}, imp and sw_abs): ok, max|kernel-"
          f"twin| h2osoi {err:.3e} mm ({int(edge.sum())} cells set aside)")

    # Times in turns: day_kernel_any at nl=10 here (its register build, the
    # all-shared form, and both in float64), the fixed nl=8 build and
    # day_kernel_any at nl=8 on the flagship winter state.
    f_args, f_kw = flag_winter

    def double(x):
        return x.double()

    args64 = tuple(a.map(double) for a in args[:4]) + args[4:]
    kw64 = dict(kw, imp=kw["imp"].double(), sw_abs=kw["sw_abs"].double())

    def day(a, k, **extra):
        return lambda: day_kernel.hydrology_day_cuda(
            *a, **k, **extra)[0].h2osoi_liq

    shared = dict(form=day_kernel.ALL_SHARED)
    forms = dict(any_nl10=day(args, kw), fixed_nl8=day(f_args, f_kw),
                 any_nl8=day(f_args, f_kw, any_nl=True),
                 shared_nl10=day(args, kw, **shared),
                 f64_nl10=day(args64, kw64),
                 f64_shared_nl10=day(args64, kw64, **shared))
    times = {k: [] for k in forms}
    for order in (list(forms), list(forms)[::-1]):
        for k in order:
            times[k].append(_time_cuda(forms[k], 20))
    ms = {k: float(np.mean([t[0] for t in v])) for k, v in times.items()}
    ratios = dict(nl10=ms["any_nl10"] / ms["fixed_nl8"],
                  nl8=ms["any_nl8"] / ms["fixed_nl8"])
    plain_ms = _time_cuda(lambda: day_kernel.hydrology_day_plain(
        *args, **kw)[0].h2osoi_liq, 1)[0]
    bound = day_bound(args, kw["imp"], cfg.zd09_every)
    lib = kernels.day_kernel_lib()
    sms, blocks, threads, nbytes = day_kernel.instance_residency(
        lib, dtype, LAYER_YEAR_NL, True) if dev.type == "cuda" else \
        (0, 0, 0, 0)
    print(f"{LAYER_YEAR_NL}-layer kernel day: {ms['any_nl10']:.3f} ms "
          f"({n} cells, winter state; the all-shared form "
          f"{ms['shared_nl10']:.3f} ms; float64 {ms['f64_nl10']:.3f} ms, "
          f"all-shared {ms['f64_shared_nl10']:.3f} ms); on the flagship "
          f"winter state the fixed nl=8 build {ms['fixed_nl8']:.3f} ms, "
          f"day_kernel_any at nl=8 {ms['any_nl8']:.3f} ms; plain twin "
          f"{plain_ms:.1f} ms; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}; {blocks} blocks of {threads} threads an SM "
          f"({smi}); passes: " + json.dumps(times))
    print(f"day_kernel_any against the fixed nl=8 build in the same passes: "
          f"{ratios['nl10']:.3f} at nl=10, {ratios['nl8']:.3f} at nl=8 "
          f"({smi})")
    builds = build_times(dev, n) if dev.type == "cuda" else {}

    # The resident slabs at nl=10: bitwise the unsharded block.
    short = block.map(lambda x: x[:SLAB_DAYS])
    k = 3
    zero_launches()
    got = block_step(sim.state, acc0, short, **run,
                     **dict(sim.step_kwargs(), devices=[dev] * k))
    slab_launches = read_launches(f"{LAYER_YEAR_NL}-layer slabs")
    whole = block_step(sim.state, acc0, short, **run, **sim.step_kwargs())
    _leaves_equal(f"{LAYER_YEAR_NL}-layer block on {k} slabs",
                  _state_leaves(got[0]) + _state_leaves(got[1]),
                  _state_leaves(whole[0]) + _state_leaves(whole[1]))
    if dev.type == "cuda" and slab_launches != SLAB_DAYS * k:
        raise RuntimeError(f"{LAYER_YEAR_NL}-layer slabs: {slab_launches} "
                           f"launches in {SLAB_DAYS} days of {k} slabs")
    print(f"{LAYER_YEAR_NL}-layer block on {k} slabs of the card, "
          f"{SLAB_DAYS} days: {slab_launches} launches, bitwise the "
          f"unsharded block")
    return dict(nl=LAYER_YEAR_NL, cells=n, land_cells=int(land.sum()),
                launches=launches, year_s=year["seconds"], wall_s=wall,
                max_residual=year["max_residual_mm"],
                file_max_residual=file_res, prep_s=prep_s,
                max_abs_err=err, set_aside=int(edge.sum()), ms=ms["any_nl10"],
                fixed_nl8_ms=ms["fixed_nl8"], any_nl8_ms=ms["any_nl8"],
                shared_ms=ms["shared_nl10"], f64_ms=ms["f64_nl10"],
                f64_shared_ms=ms["f64_shared_nl10"], ratios=ratios,
                builds=builds,
                plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"],
                arithmetic_per_cell_day=bound["arithmetic_per_cell_day"],
                transcendental_per_cell_day=bound[
                    "transcendental_per_cell_day"],
                resident_blocks_per_sm=blocks, threads_per_block=threads,
                shared_bytes_per_block=nbytes,
                rounds=day_kernel.rounds(n, sms, blocks, threads)
                if blocks else None,
                slab_launches=slab_launches, slabs=k,
                slabs_bitwise_unsharded=True)


def build_phase():
    """Phase 2: build the day-kernel library and print the build, each
    unit's seconds and, for every kernel instance, its registers, stack
    frame and spills and what the card holds of it.  Returns the
    instances' records (:func:`_ptxas_summary` with the residency)."""
    t0 = time.perf_counter()
    kernels.day_kernel_lib()
    load_s = time.perf_counter() - t0
    info = kernels.build_info
    print(f"build: nvcc {info.get('seconds', 0.0):.1f} s, load "
          f"{load_s:.1f} s ({info.get('path', 'library already built')}); "
          f"seconds by unit: " + json.dumps(
              {k: round(v, 1) for k, v in info.get("units", {}).items()}))
    ptxas = _ptxas_summary(info.get("log", ""))
    lib = kernels.day_kernel_lib()
    for p in ptxas:
        dtype = torch.float32 if p["dtype"] == "f32" else torch.float64
        form, nl = day_kernel.FIXED, p["nl"]
        if nl is None:
            # day_kernel_any: a register build's exact instance at its
            # capacity, its other one at the fewest layers it serves (below
            # the capacity), the all-shared form at the 10-layer count.
            form = p["capacity"]
            served = day_kernel.any_capacities(dtype).get(form)
            nl = (form if p["exact"] else min(min(served), form - 1)) \
                if form else LAYER_YEAR_NL
            p.update(at_nl=nl, predicted=day_kernel.any_residency(
                dtype, nl, form, N_FLAGSHIP, with_imp=p["imp"]))
        sms, blocks, threads, nbytes = day_kernel.instance_residency(
            lib, dtype, nl, p["imp"], form=form)
        p.update(sms=sms, resident_blocks_per_sm=blocks,
                 threads_per_block=threads, shared_bytes_per_block=nbytes,
                 rounds_at_flagship_cells=day_kernel.rounds(
                     N_FLAGSHIP, sms, blocks, threads))
        print("ptxas: " + json.dumps(p))
    return ptxas


def any_builds(ptxas, times):
    """Each form of ``day_kernel_any`` with imp, for the kernels line:
    its range, registers, spills and resident warps an SM (phase 2) and
    its ms against the all-shared form (:func:`build_times`)."""
    out = {}
    for p in ptxas:
        if p["nl"] is not None or not p["imp"]:
            continue
        form = p["capacity"]
        dtype = torch.float32 if p["dtype"] == "f32" else torch.float64
        name = f"{str(dtype)[6:]} " + (f"capacity={form}" if form
                                       else "all-shared")
        build = out.setdefault(name, dict(
            counts=list(day_kernel.any_capacities(dtype)[form])
            if form else None,
            times={k.split(" ")[-1]: v for k, v in times.items()
                   if k.startswith(name + " ")}))
        build["exact" if p.get("exact") else "any"] = dict(
            at_nl=p["at_nl"], registers=p["registers"],
            spill_stores=p["spill_stores"], spill_loads=p["spill_loads"],
            resident_blocks_per_sm=p["resident_blocks_per_sm"])
    return out


def main() -> None:
    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke "
                         "test runs on a GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    dev = torch.device("cuda", 0)
    clock, phase_s = [time.perf_counter()], {}

    def lap(phase):
        """Seconds since the last lap, under ``phase``."""
        now = time.perf_counter()
        phase_s[phase] = round(now - clock[0], 1)
        clock[0] = now

    # 2. Build.
    ptxas = build_phase()

    lap("1-2")

    # 3. Kernel against plain twin: the fixed builds on every regime but
    # the edge states, then day_kernel_any at every layer count, the edge
    # states on both, and the hot climate.
    for dtype, regime in CHECK_REGIMES:
        if regime == "edge":
            continue
        for nl in day_kernel.FIXED_NLS:
            case = check_case(N_CHECK, nl, dtype, dev, regime)
            for k in (1, 8):
                for use_imp in (False, True):
                    label = (f"check {str(dtype)[6:]} {regime} nl={nl} "
                             f"zd09_every={k} imp={use_imp}")
                    err, res, n_edge = check_kernel(
                        label, case, regime, k, use_imp,
                        (None, True) if k == 8 else (None,))
                    print(f"{label}: ok, max|kernel-twin| h2osoi "
                          f"{err:.3e} mm, max residual {res:.3e} mm, "
                          f"{n_edge} knife-edge cells")
    t0 = time.perf_counter()
    layers = layer_count_checks(dev)
    hot = hot_climate(dev)
    print(f"phase 3, layer counts, edge states and hot climate: "
          f"{time.perf_counter() - t0:.1f} s")

    lap("3")

    # 4. Reference-scope path: first the kernel against its twin at that
    # path's shapes and inputs.
    case = build_reference_case(N_CELLS, "float32")
    if case.state.soil.h2osoi_liq.device.type != "cuda":
        raise RuntimeError("build_reference_case() did not use the card")
    cfg = case.cfg
    st = case.state
    day_args = (st.soil, st.veg, case.params, case.forcing, case.geom,
                cfg.dt, cfg.nisurf)
    kw = dict(zd09_every=cfg.zd09_every)
    ref_err = check_day(
        "kernel vs twin at the reference path's shapes",
        day_kernel.hydrology_day_cuda(*day_args, **kw),
        day_kernel.hydrology_day_plain(*day_args, **kw), case.params.bsw)[0]
    print(f"kernel vs twin, {N_CELLS} cells, f32, nl=8, zd09_every="
          f"{cfg.zd09_every}: ok, max|kernel-twin| h2osoi {ref_err:.3e} mm")
    block = Forcing.from_numpy(
        synthetic_forcing_block(REFERENCE_DAYS, N_CELLS, seed=1,
                                start_doy=152), torch.float32, dev)
    acc0 = AnnualAccumulators.zeros(N_CELLS, torch.float32, dev)
    run = dict(params=case.params, geom=case.geom, dt=cfg.dt,
               nisurf=cfg.nisurf, zd09_every=cfg.zd09_every)
    zero_launches()
    t0 = time.perf_counter()
    state, acc = block_step(case.state, acc0, block,
                            use_kernel=cfg.use_kernel, **run)
    means = annual_means(acc, cfg.nisurf)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    ref_launches = read_launches("reference path")
    summary = check_block("reference path", state, means, REFERENCE_DAYS,
                          ref_launches)
    print(f"reference path: {REFERENCE_DAYS} days x {N_CELLS} cells in "
          f"{block_s:.2f} s, {summary}")

    short = block.map(lambda x: x[:3])
    err = compare_blocks(
        "reference path vs plain twin, 3 days",
        block_step(case.state, acc0, short, **run),
        block_step(case.state, acc0, short, use_kernel=False, **run),
        case.params.bsw)
    print(f"reference path vs plain twin, 3 days: ok, max|diff| h2osoi "
          f"{err:.3e} mm")

    lap("4")

    # 5. Timing at N_CELLS (plain, kernel, kernel, plain).
    times = dict(kernel=[], plain=[])
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            times["kernel"].append(_time_cuda(
                lambda: day_kernel.hydrology_day_cuda(
                    *day_args, **kw)[0].h2osoi_liq, 20))
        else:
            times["plain"].append(_time_cuda(
                lambda: day_kernel.hydrology_day_plain(
                    *day_args, **kw)[0].h2osoi_liq, 2))
    step_ms = _time_cuda(
        lambda: day_step(st, case.forcing, case.params, case.geom, cfg.dt,
                         cfg.nisurf, **kw)[0].soil.h2osoi_liq, 10)[0]
    ref_kernel_ms = float(np.mean([t[0] for t in times["kernel"]]))
    ref_plain_ms = float(np.mean([t[0] for t in times["plain"]]))

    def timing(label, ms, n, what):
        print(f"timing: {label}: {ms:.3f} ms, {n / (ms * 1e-3):.4g} "
              f"cell-days/s ({n} cells, f32, {what}; {smi})")

    ref_what = f"reference scope, zd09_every={cfg.zd09_every}"
    timing("kernel day", ref_kernel_ms, N_CELLS, ref_what)
    timing("plain-twin day", ref_plain_ms, N_CELLS, ref_what)
    timing("day_step with kernel", step_ms, N_CELLS, ref_what)
    print("timing passes (event ms, wall ms): " + json.dumps(times))

    lap("5")

    # 6. Flagship path, the main path.
    t0 = time.perf_counter()
    flag = build_flagship_case()
    sim = flag.sim
    fcfg = sim.cfg
    n = sim.n
    if sim.device.type != "cuda" or n != N_FLAGSHIP or not sim.use_kernel:
        raise RuntimeError(f"build_flagship_case(): {n} cells on "
                           f"{sim.device}, use_kernel={sim.use_kernel}")
    if not (fcfg.snow and fcfg.snow_albedo and fcfg.frozen_soil
            and fcfg.soil_ice and fcfg.carbon and fcfg.lateral_routing
            and flag.step_kwargs["routing"] is not None):
        raise RuntimeError("the flagship case is not Config()'s defaults")
    print(f"flagship case: {n} cells ({flag.land_grid.n_land} land), "
          f"{fcfg.ny}x{fcfg.nx} routing grid, built in "
          f"{time.perf_counter() - t0:.1f} s")
    lat = flag.land_grid.cell_lat
    fblock = Forcing.from_numpy(
        synthetic_forcing_block(FLAGSHIP_DAYS, n, seed=1, start_doy=1,
                                lat=lat), torch.float32, dev)
    facc0 = AnnualAccumulators.zeros(n, torch.float32, dev)
    frun = dict(params=sim.params, geom=sim.geom, dt=fcfg.dt,
                nisurf=fcfg.nisurf)
    zero_launches()
    t0 = time.perf_counter()
    winter, facc = block_step(sim.state, facc0, fblock, **frun,
                              **flag.step_kwargs)
    fmeans = annual_means(facc, fcfg.nisurf)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    flag_launches = read_launches("flagship path")
    summary = check_block("flagship path", winter, fmeans, FLAGSHIP_DAYS,
                          flag_launches)
    print(f"flagship path: {FLAGSHIP_DAYS} days x {n} cells in "
          f"{block_s:.2f} s, {summary}")

    # The extras at work, on the winter state the block ends in and on
    # one more day from it.
    imp = freeze_impedance_from_ice(winter.soil.h2osoi_liq,
                                    winter.h2osoi_ice)
    sw_abs = snow_absorptivity(winter.swe, *sim.snow_albedo)
    f31 = Forcing.from_numpy(
        synthetic_forcing_day(n, 1 + FLAGSHIP_DAYS, seed=1, lat=lat),
        torch.float32, dev)
    day31, d31 = day_step(winter, f31, sim.params, sim.geom, fcfg.dt,
                          fcfg.nisurf, **flag.step_kwargs)
    seen = dict(
        snow_cells=int((winter.swe > 0).sum()),
        ice_cells=int((winter.h2osoi_ice > 0).any(dim=1).sum()),
        impeded_layers=int((imp < 1).sum()),
        min_imp=float(imp.min()),
        min_sw_abs=float(sw_abs.min()),
        discharge_cells=int((d31["discharge"] > 0).sum()),
        annual_discharge_mm=float(fmeans["discharge"].sum()),
        rh_cells=int((d31["rh"] > 0).sum()),
        annual_rh=float(fmeans["rh"].sum()),
        carbon_moved=float((winter.carbon.c_litter - 100.0).abs().max()))
    for key in ("snow_cells", "ice_cells", "impeded_layers",
                "discharge_cells", "annual_discharge_mm", "rh_cells",
                "annual_rh", "carbon_moved"):
        if not seen[key] > 0:
            raise RuntimeError(f"flagship path: {key} = {seen[key]}; an "
                               f"extra did not run ({seen})")
    if not seen["min_sw_abs"] < 0.92:
        raise RuntimeError(f"flagship path: no snow albedo ({seen})")
    land = slice(0, flag.land_grid.n_land)
    water = [x[land].double().sum() for x in (
        day31.river_store, winter.river_store, d31["discharge"],
        d31["rnf_day"])]
    balance = float(water[0] - water[1] + water[2] - water[3])
    scale = float(water[1] + d31["rnf_day"][land].double().abs().sum())
    if not abs(balance) <= 1e-5 * scale:
        raise RuntimeError(f"flagship path: routed water balance off by "
                           f"{balance} mm of {scale} mm")
    print("flagship extras: " + json.dumps(seen) + f"; routed water "
          f"balance of day {1 + FLAGSHIP_DAYS}: {balance:.3e} mm of "
          f"{scale:.3e} mm")

    fshort = fblock.map(lambda x: x[:3])
    err = compare_blocks(
        "flagship path vs plain twin, 3 days",
        block_step(sim.state, facc0, fshort, **frun, **flag.step_kwargs),
        block_step(sim.state, facc0, fshort, **frun,
                   **dict(flag.step_kwargs, use_kernel=False)),
        sim.params.bsw)
    print(f"flagship path vs plain twin, 3 days: ok, max|diff| h2osoi "
          f"{err:.3e} mm")

    # The kernel with the impedance operand and the absorptivity at the
    # flagship shapes: on the first day (no snow or ice yet: imp is 1 and
    # sw_abs 0.92 everywhere) and on the winter state, where knife-edge
    # cells are set aside as in phase 3.
    s0 = sim.state
    f1 = fblock.map(lambda x: x[0])
    first_args = (s0.soil, s0.veg, sim.params, f1, sim.geom, fcfg.dt,
                  fcfg.nisurf)
    first_kw = dict(
        imp=freeze_impedance_from_ice(s0.soil.h2osoi_liq, s0.h2osoi_ice),
        sw_abs=snow_absorptivity(s0.swe, *sim.snow_albedo),
        zd09_every=fcfg.zd09_every)
    flag_err = check_day(
        "kernel vs twin, flagship first day",
        day_kernel.hydrology_day_cuda(*first_args, **first_kw),
        day_kernel.hydrology_day_plain(*first_args, **first_kw),
        sim.params.bsw)[0]
    winter_args = (winter.soil, winter.veg, sim.params, f31, sim.geom,
                   fcfg.dt, fcfg.nisurf)
    winter_kw = dict(imp=imp, sw_abs=sw_abs, zd09_every=fcfg.zd09_every)
    want = day_kernel.hydrology_day_plain(*winter_args, **winter_kw)
    edge = knife_edge_cells(*winter_args[:5], want, **winter_kw)
    if int(edge.sum()) > MAX_KNIFE_EDGE_SHARE * n:
        raise RuntimeError(f"flagship winter state: {int(edge.sum())} of "
                           f"{n} cells on a knife edge")
    winter_err = check_day(
        "kernel vs twin, flagship winter state",
        day_kernel.hydrology_day_cuda(*winter_args, **winter_kw), want,
        sim.params.bsw, ~edge)[0]
    print(f"kernel vs twin with imp and sw_abs, {n} cells, f32, nl=8: ok, "
          f"max|kernel-twin| h2osoi {flag_err:.3e} mm on the first day, "
          f"{winter_err:.3e} mm on the winter state ({int(edge.sum())} "
          f"knife-edge cells set aside)")

    # The focus-cell trace the kernel writes, on the cells of the debug
    # sites: on the first day and on the winter state.
    sites = {name: flag.land_grid.cell_index_of(lon, lat)
             for name, (lon, lat) in cli.DEBUG_SITES.items()}
    focus_cell = sites[FOCUS_SITE]
    cells = sorted(set(sites.values()))
    first_focus = check_focus("focus trace, flagship first day", first_args,
                              first_kw, cells,
                              torch.ones(n, dtype=torch.bool, device=dev))
    winter_focus = check_focus("focus trace, flagship winter state",
                               winter_args, winter_kw, cells, ~edge)
    focus_err = max(first_focus[0], winter_focus[0])
    print(f"focus trace from the kernel, {len(cells)} debug-site cells: "
          f"other outputs bitwise the day without a focus; against the "
          f"twin's trace {first_focus[0]:.3e} m on the first day "
          f"({first_focus[1]} cells), {winter_focus[0]:.3e} m on the winter "
          f"state ({winter_focus[1]} cells off knife edges)")

    lap("6")

    # 7. Sharded launcher: bitwise the unsharded kernel, and against its
    # plain version.
    sharded_err = 0.0
    for label, args in (
            (f"sharded day, {n} cells", winter_args),
            (f"sharded day, {n - 2} cells",
             tuple(x.map(lambda t: t[:n - 2]) for x in winter_args[:4])
             + winter_args[4:])):
        m = args[0].zwt.shape[0]
        kw_m = dict(winter_kw, imp=imp[:m], sw_abs=sw_abs[:m])
        errs = [check_sharded(f"{label}, {len(devices)} slabs", args, kw_m,
                              devices, ~edge[:m])
                for devices in ([dev], [dev] * SLABS)]
        sharded_err = max(sharded_err, *errs)
        print(f"{label}: ok, 1 and {SLABS} slabs bitwise the unsharded "
              f"kernel day; max|sharded-plain| h2osoi {max(errs):.3e} mm")
    sblock = fblock.map(lambda x: x[:SHARDED_DAYS])
    zero_launches()
    got = block_step(sim.state, facc0, sblock, **frun,
                     **dict(flag.step_kwargs, devices=[dev] * SLABS))
    torch.cuda.synchronize()
    sharded_launches = read_launches("sharded flagship path")
    if sharded_launches != SHARDED_DAYS * SLABS:
        raise RuntimeError(
            f"sharded flagship path: {sharded_launches} kernel launches in "
            f"{SHARDED_DAYS} days of {SLABS} slabs")
    want = block_step(sim.state, facc0, sblock, **frun, **flag.step_kwargs)
    for i, (x, y) in enumerate(zip(
            _state_leaves(got[0]) + _state_leaves(got[1]),
            _state_leaves(want[0]) + _state_leaves(want[1]))):
        if not torch.equal(x, y):
            raise RuntimeError(f"sharded flagship path: leaf {i} is not "
                               f"bitwise the unsharded path's")
    print(f"sharded flagship path: {SHARDED_DAYS} days x {SLABS} slabs, "
          f"{sharded_launches} launches, bitwise the unsharded path")

    lap("7")

    # 8. Timing at the flagship shapes, on the winter state and, for the
    # kernel, on the first day's state too (the kernel's branches make its
    # time depend on the state); plain versions once each, kernel forms
    # in turns.
    def day_fn(fn, **extra):
        return lambda: fn(*winter_args, **dict(winter_kw, **extra))[
            0].h2osoi_liq

    def first_fn(**extra):
        return lambda: day_kernel.hydrology_day_cuda(
            *first_args, **dict(first_kw, **extra))[0].h2osoi_liq

    no_imp = dict(imp=None)
    forms = dict(
        imp=day_fn(day_kernel.hydrology_day_cuda),
        imp_focus=day_fn(day_kernel.hydrology_day_cuda, focus_idx=focus_cell),
        no_imp=day_fn(day_kernel.hydrology_day_cuda, **no_imp),
        first_day_imp=first_fn(),
        first_day_no_imp=first_fn(**no_imp),
        sharded_1=day_fn(day_kernel.hydrology_day_sharded, devices=[dev]),
        sharded_4=day_fn(day_kernel.hydrology_day_sharded,
                         devices=[dev] * SLABS))
    ftimes = {k: [] for k in forms}
    for order in (list(forms), list(forms)[::-1]):
        for k in order:
            ftimes[k].append(_time_cuda(forms[k], 20))
    fms = {k: float(np.mean([t[0] for t in v])) for k, v in ftimes.items()}
    flag_plain_ms = _time_cuda(day_fn(day_kernel.hydrology_day_plain), 1)[0]
    sharded_plain_ms = _time_cuda(
        day_fn(day_kernel.hydrology_day_sharded, devices=[dev] * SLABS,
               use_kernel=False), 1)[0]
    fstep_ms, fstep_wall_ms = _time_cuda(
        lambda: day_step(winter, f31, sim.params, sim.geom, fcfg.dt,
                         fcfg.nisurf, **flag.step_kwargs)[0].soil.h2osoi_liq,
        10)
    flag_what = f"flagship, zd09_every={fcfg.zd09_every}"
    timing("flagship day_step with kernel", fstep_ms, n, flag_what)
    timing("kernel day with imp", fms["imp"], n, flag_what)
    timing("kernel day with imp and a focus cell", fms["imp_focus"], n,
           flag_what)
    timing("kernel day without imp", fms["no_imp"], n, flag_what)
    timing("kernel day with imp, first day's state", fms["first_day_imp"],
           n, flag_what)
    timing("kernel day without imp, first day's state",
           fms["first_day_no_imp"], n, flag_what)
    timing("sharded day, 1 slab", fms["sharded_1"], n, flag_what)
    timing(f"sharded day, {SLABS} slabs", fms["sharded_4"], n, flag_what)
    timing("plain-twin day with imp", flag_plain_ms, n, flag_what)
    timing(f"plain sharded day, {SLABS} slabs", sharded_plain_ms, n,
           flag_what)
    print(f"flagship day_step wall {fstep_wall_ms:.3f} ms; timing passes "
          f"(event ms, wall ms): " + json.dumps(ftimes))

    # The kernel day by cell count (the card holds 71,808 cells of the
    # main-path instance at once, so no count up to the flagship's pays a
    # second round of blocks), and the next grid's count.
    def first_cells(m):
        def cut(x):
            return x[:m]
        return lambda: day_kernel.hydrology_day_cuda(
            *[a.map(cut) for a in first_args[:4]], *first_args[4:],
            **dict(first_kw, imp=first_kw["imp"][:m],
                   sw_abs=first_kw["sw_abs"][:m]))[0].h2osoi_liq

    by_count = {m: _time_cuda(first_cells(m), 20)[0]
                for m in (33_792, 66_560, 67_584, 67_712, n)}

    def tiled(x):
        return torch.cat([x] * (N_QUARTER_DEGREE // n)
                         + [x[:N_QUARTER_DEGREE % n]])

    big_args = tuple(a.map(tiled) for a in first_args[:4]) + first_args[4:]
    big_kw = dict(first_kw, imp=tiled(first_kw["imp"]),
                  sw_abs=tiled(first_kw["sw_abs"]))
    by_count[N_QUARTER_DEGREE] = _time_cuda(
        lambda: day_kernel.hydrology_day_cuda(
            *big_args, **big_kw)[0].h2osoi_liq, 10)[0]
    print("kernel day with imp by cell count, first day's state, ms "
          f"({smi}): " + json.dumps(by_count))

    lap("8")

    # 9. The bound of the flagship day on this card.
    bound = day_bound(winter_args, imp, fcfg.zd09_every)
    print("bound of the flagship kernel day: " + json.dumps(bound))

    lap("9")

    # 10. The year loop at full width, through the command line.
    with tempfile.TemporaryDirectory() as tmp:
        year = year_path(tmp, dev, smi)

    lap("10")

    # 11. The switches of Config at full width.
    switches = switch_paths(flag, fblock, f31, smi)

    lap("11")

    # 12. The carbon spin-up, and 13. site mode, through the command line.
    with tempfile.TemporaryDirectory() as tmp:
        spin = spinup_path(tmp, smi)
        site = site_path(tmp, smi)

    lap("12-13")

    # 14. The closed loop: ensemble, assimilation, calibration.
    with tempfile.TemporaryDirectory() as tmp:
        loop = closed_loop_path(tmp, dev, smi)

    lap("14")

    # 15. Several processes on the card: run --shard as 1, 2 and 4 ranks.
    with tempfile.TemporaryDirectory() as tmp:
        ranks = multi_rank_path(tmp, smi)

    lap("15")

    # 16. The study programs, each in a child process.
    with tempfile.TemporaryDirectory() as tmp:
        study = study_path(tmp, dev, smi)

    lap("16")

    # 17. Device slabs of one process: the resident path.
    with tempfile.TemporaryDirectory() as tmp:
        slab = slab_path(tmp, flag, fblock, winter, dev, smi)

    lap("17")

    # 18. The closed loop and the spin-up on device slabs of one process.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        slab_loop = slab_loop_path(tmp, flag, dev, smi)
        print(f"phase 18: {time.perf_counter() - t0:.1f} s ({smi})")

    lap("18")

    # 19. A global year at 10 layers through the command line.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        layer_year = layer_year_path(tmp, dev, smi, (winter_args, winter_kw))
        print(f"phase 19: {time.perf_counter() - t0:.1f} s ({smi})")

    lap("19")

    # 20. The soil-heat kernel against its twin, and its time.
    heat = soil_heat_path(dev, smi)

    lap("20")
    print(f"phase seconds ({smi}): " + json.dumps(phase_s))

    common = dict(route="cuda",
                  source="hybrid9_tpu_torch/csrc/day_kernel.cu",
                  bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                  library_ms=None)
    print(json.dumps({"kernels": [
        dict(common, name="hydrology_day",
             replaces="hybrid9_tpu/physics/pallas_day.py:36",
             launches=flag_launches, max_abs_err=max(flag_err, winter_err),
             ms=fms["imp"], first_day_ms=fms["first_day_imp"],
             focus_ms=fms["imp_focus"], focus_max_abs_err_m=focus_err,
             plain_ms=flag_plain_ms,
             year_path=dict(launches=year["launches"],
                            launches_by_year=[y["launches"]
                                              for y in year["years"]],
                            resumed_launches=year["resumed"]["launches"]),
             switch_paths={k: v["launches"] for k, v in switches.items()},
             switch_max_abs_err=max(v["max_abs_err_3_days"]
                                    for v in switches.values()),
             spinup_path=dict(launches=spin["launches"],
                              launches_by_year=spin["launches_by_year"]),
             site_ms_per_day=site["ms_per_site_day"],
             closed_loop=dict(
                 ensemble=dict(launches=loop["ensemble"]["launches"],
                               cells=loop["ensemble"]["cells"],
                               ms=loop["ensemble"]["kernel_ms"],
                               rounds=loop["ensemble"]["rounds"],
                               bound_ms=loop["ensemble"]["bound_ms"]),
                 assimilate=dict(launches=loop["assimilate"]["launches"],
                                 cells=loop["assimilate"]["cells"],
                                 ms=loop["assimilate"]["kernel_ms"],
                                 rounds=loop["assimilate"]["rounds"],
                                 max_abs_err=loop["assimilate"][
                                     "folded_vs_twin_max_abs_err"]),
                 calibrate_launches={k: v["launches"] for k, v in
                                     loop["calibrate"].items()},
                 member0_bitwise=loop["ensemble"]["member0_bitwise"],
                 folded_max_abs_err=loop["ensemble"][
                     "folded_vs_twin_max_abs_err"]),
             multi_rank=dict(
                 {f"ranks_{n}": dict(
                     launches_per_rank=v["launches_per_rank"],
                     year_s_per_rank=v["year_s_per_rank"],
                     collectives_per_day_per_rank=v[
                         "collectives_per_day_per_rank"],
                     peak_gb_per_rank=v["peak_gb_per_rank"])
                  for n, v in ranks["ranks"].items()},
                 bitwise_across_ranks=True,
                 resume_bitwise=ranks["resume"]["bitwise"],
                 restore_under_one_rank_raises=ranks[
                     "restore_under_one_rank_raises"],
                 closed_loop_fit_max_rel_err=ranks["closed_loop"][
                     "fit_max_rel_err"]),
             scripts_path={name: dict(
                 launches=leg["launches"], cells=leg["cells"],
                 kernel_ms=leg.get("kernel_ms"),
                 **{k: leg[k] for k in ("k8_max_abs_err", "k1_max_abs_err")
                    if k in leg}) for name, leg in study.items()},
             reference_path=dict(launches=ref_launches, max_abs_err=ref_err,
                                 ms=ref_kernel_ms, plain_ms=ref_plain_ms,
                                 cells=N_CELLS),
             slab_path=dict(
                 days=SLAB_DAYS,
                 launches={f"slabs_{k}": v["launches"]
                           for k, v in slab["blocks"].items()},
                 run_loop_launches={f"slabs_{k}": v["launches"]
                                    for k, v in slab["run_loop"].items()},
                 day_launches={f"slabs_{c['slabs']}": c[
                     "day_kernel_launches_a_day"]
                     for c in slab["day_costs"]},
                 bitwise_unsharded=True),
             slab_loop_path=dict(
                 ensemble_launches={f"slabs_{k}": v["launches"] for k, v in
                                    slab_loop["ensemble"].items()},
                 assimilate_launches={f"slabs_{k}": v["launches"] for k, v in
                                      slab_loop["assimilate"].items()},
                 spinup_launches={f"slabs_{k}": v["launches"] for k, v in
                                  slab_loop["spinup"].items()},
                 ensemble_days=LOOP_ENS_DAYS, da_cycles=LOOP_DA_CYCLES,
                 fit_max_rel_err=slab_loop["fit"]["max_rel_err"],
                 bitwise_unsharded=True),
             layer_counts=dict(
                 name="day_kernel_any", nl=LAYER_YEAR_NL,
                 cells=layer_year["cells"],
                 launches=layer_year["launches"],
                 max_abs_err=layer_year["max_abs_err"],
                 ms=layer_year["ms"], plain_ms=layer_year["plain_ms"],
                 bound_ms=layer_year["bound_ms"],
                 bound_by=layer_year["bound_by"], library_ms=None,
                 fixed_nl8_ms=layer_year["fixed_nl8_ms"],
                 any_nl8_ms=layer_year["any_nl8_ms"],
                 ratios_to_fixed_nl8=layer_year["ratios"],
                 shared_ms=layer_year["shared_ms"],
                 f64_ms=layer_year["f64_ms"],
                 f64_shared_ms=layer_year["f64_shared_ms"],
                 builds=any_builds(ptxas, layer_year["builds"]),
                 year_s=layer_year["year_s"],
                 max_residual=layer_year["max_residual"],
                 rounds=layer_year["rounds"],
                 slab_launches=layer_year["slab_launches"],
                 slabs_bitwise_unsharded=True,
                 checks_max_abs_err={k: v["max_abs_err"] for k, v in
                                     layers["counts"].items()},
                 edge_max_abs_err={k: v["max_abs_err"] for k, v in
                                   layers["edge"].items()},
                 residency=layers["residency"],
                 hot_climate=dict(launches=hot["launches"],
                                  max_residual=hot["max_residual"]))),
        dict(common, name="hydrology_day_sharded",
             replaces="hybrid9_tpu/physics/pallas_day.py:220",
             launches=sharded_launches, max_abs_err=sharded_err,
             ms=fms["sharded_4"], plain_ms=sharded_plain_ms,
             slabs=SLABS, one_slab_ms=fms["sharded_1"],
             resident_path="launches hydrology_day once a slab a day "
                           "(phase 17), not this launcher"),
        dict(route="cuda", name="soil_heat",
             source="hybrid9_tpu_torch/csrc/soil_heat.cu",
             replaces=None,
             fuses="hybrid9_tpu/physics/soiltemp.py, left to XLA's fusion",
             launches=dict(HEAT_LAUNCHES),
             max_abs_err=max(w["max_abs_err_k"]
                             for w in heat["widths"].values()),
             ms=heat["widths"]["ensemble nl=8"]["ms"],
             plain_ms=heat["widths"]["ensemble nl=8"]["plain_ms"],
             bound_ms=heat["widths"]["ensemble nl=8"]["bound_ms"],
             bound_by="bytes", library_ms=None, widths=heat["widths"],
             builds=heat["sweep"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
