#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. device: a CUDA card is required (there is no CPU path); prints its
   name and, as ``nvidia-smi`` gives them, its name and power limit;
2. build: compiles ``hybrid9_tpu_torch/csrc/day_kernel.cu`` with nvcc for
   sm_90a and prints the build seconds, the registers and spills of each
   kernel instance, and what the card holds of each (resident blocks an
   SM, shared memory a block);
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
   (``knife_edge_cells``), are held to finiteness and the water balance;
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
   day and on the winter state the block ends in;
7. sharded launcher: ``hydrology_day_sharded`` over ``[cuda:0]`` and
   ``[cuda:0] * 4`` at 69,632 cells and at a cell count 4 does not
   divide: bitwise (``torch.equal``) the unsharded kernel day, and held
   against its plain version (``use_kernel=False``) at the kernel's
   tolerances with the knife-edge cells set aside; then 5
   flagship days through ``block_step(devices=[cuda:0] * 4)``: four
   launches per day, bitwise the unsharded block;
8. timing at 69,632 cells: the flagship ``day_step``, the kernel day with
   and without the impedance operand (on the winter state and on the
   first day's state), the sharded day with 1 and 4 slabs and their plain
   versions; then the kernel day on the first 33,792 to 69,632 cells of
   the first day's state (one thread block more must not cost a round of
   blocks more) and on 282,624 cells, the 0.25-degree grid's count, made
   by tiling that state;
9. the bound of the day on this card: the bytes the day must move over
   the memory rate against its operations over the float32 rate, the
   operations counted from the kernel's source along the path each of
   this run's cells takes (``day_kernel.day_operations``).

The line before the last is a JSON summary of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import time

import numpy as np
import torch

from hybrid9_tpu_torch import kernels
from hybrid9_tpu_torch.config import (CANONICAL_ZI_MM, LayerGrid,
                                      exponential_interfaces)
from hybrid9_tpu_torch.data.synthetic import (synthetic_forcing_block,
                                              synthetic_forcing_day,
                                              synthetic_soil_params)
from hybrid9_tpu_torch.entry import (build_flagship_case,
                                     build_reference_case)
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.physics.soiltemp import freeze_impedance_from_ice
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


def knife_edge_cells(soil, veg, params, forcing, geom, want, **kw):
    """Float32 cells on a knife edge, found from the plain twin alone: its
    water table ends within KNIFE_EDGE_M of the column bottom, where the
    ``zwt > zi/1000`` branch switches between the in-column and the
    below-column drainage, or its day moves beyond F32_TOL when the
    initial soil water and water table are nudged one ulp up or down.  On
    such a cell a one-ulp difference between two float32 programs (nvcc's
    FMA contraction is one) can flip a branch and move it by millimetres
    within the day."""
    bottom = geom.zi[len(geom.dz_soil)] / 1000.0
    edge = (want[0].zwt.double() - bottom).abs() < KNIFE_EDGE_M
    base = _fields(*want)
    for toward in (float("inf"), float("-inf")):
        def nudge(x):
            return torch.nextafter(x, torch.full_like(x, toward))
        nudged = day_kernel.hydrology_day_plain(
            soil.replace(h2osoi_liq=nudge(soil.h2osoi_liq),
                         zwt=nudge(soil.zwt)),
            veg, params, forcing, geom, 1800.0, 48, **kw)
        for bad in _outside(_fields(*nudged), base, F32_TOL,
                            params.bsw).values():
            edge |= bad
    return edge


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
# with water tables on the column-bottom interface too.
CHECK_REGIMES = ((torch.float32, "reference"),
                 (torch.float32, "varied_off_interfaces"),
                 (torch.float64, "varied"))


def check_case(n, nl, dtype, device, regime, seed=0):
    """Inputs of a kernel-vs-twin case on the canonical 8-layer grid or
    the 20-layer one, with a random frozen-soil impedance.

    ``regime="reference"``: the reference case's initial state (water
    tables 5 m below the column) under day-180 forcing, the inputs of
    tests/test_pallas_day.py.  ``"varied"``: columns across regimes, with
    water tables inside, on the bottom of, and below the column and
    layers from near-dry (matric potential at the SMPMIN clamp) to
    near-saturated.  ``"varied_off_interfaces"``: the same columns but
    for the tables placed exactly on the column bottom, which keep their
    random depth (in float32 every one of those is a knife edge).
    """
    if regime not in ("reference", "varied", "varied_off_interfaces"):
        raise ValueError(f"unknown regime {regime!r}")
    zi = CANONICAL_ZI_MM if nl == 8 else exponential_interfaces(nl)
    grid = LayerGrid.from_interfaces(zi)
    raw = synthetic_soil_params(n, seed=seed, n_layers=nl)
    params = SoilParams.from_numpy(raw, dtype, device)
    state = initial_state(params, grid.dz, grid.zi, dtype, device)
    rng = np.random.RandomState(seed + 1)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

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


def check_kernel(label, case, regime, zd09_every, use_imp):
    """One kernel-vs-twin case on the inputs ``case`` of
    :func:`check_case`: the kernel day (one launch through the dispatch)
    against the plain twin's.  In the float32 varied regime the cells of
    :func:`knife_edge_cells` are held only to finiteness and the water
    balance, and may be at most MAX_KNIFE_EDGE_SHARE of the case.
    Returns (max |diff| of h2osoi_liq in mm, max residual in mm, number
    of knife-edge cells)."""
    soil, veg, params, forcing, geom, imp = case
    kw = dict(imp=imp if use_imp else None, zd09_every=zd09_every)
    rest = (veg, params, forcing, geom, 1800.0, 48)
    got = day_kernel.hydrology_day(soil, *rest, use_kernel=True, **kw)
    want = day_kernel.hydrology_day_plain(soil, *rest, **kw)
    held = None
    n_edge = 0
    if regime != "reference" and soil.zwt.dtype == torch.float32:
        edge = knife_edge_cells(soil, *rest[:4], want, **kw)
        n_edge = int(edge.sum())
        if n_edge > MAX_KNIFE_EDGE_SHARE * edge.numel():
            raise RuntimeError(f"{label}: {n_edge} of {edge.numel()} "
                               f"cells on a knife edge")
        held = ~edge
    return check_day(label, got, want, params.bsw, held) + (n_edge,)


def _ptxas_summary(log: str) -> list:
    """(dtype, nl, imp, registers, spill stores, spill loads) per kernel
    instance, from nvcc -Xptxas -v."""
    out = []
    for block in re.split(r"Compiling entry function", log)[1:]:
        m = re.search(r"day_kernelI([fd])Li(\d+)ELb([01])E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if m and regs:
            out.append(dict(dtype="f32" if m.group(1) == "f" else "f64",
                            nl=int(m.group(2)), imp=m.group(3) == "1",
                            registers=int(regs.group(1)),
                            spill_stores=int(spill.group(1)) if spill else 0,
                            spill_loads=int(spill.group(2)) if spill else 0))
    return out


def _time_cuda(fn, reps):
    """Mean ms per call of ``fn`` (which returns a tensor) by CUDA events
    and by the host clock; the timed window closes with a device-to-host
    checksum and a synchronize."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    checksum = float(out.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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

    # 2. Build.
    t0 = time.perf_counter()
    kernels.day_kernel_lib()
    load_s = time.perf_counter() - t0
    info = kernels.build_info
    print(f"build: nvcc {info.get('seconds', 0.0):.1f} s, load "
          f"{load_s:.1f} s ({info.get('path', 'library already built')})")
    ptxas = _ptxas_summary(info.get("log", ""))
    lib = kernels.day_kernel_lib()
    for p in ptxas:
        sms, blocks, threads, nbytes = day_kernel.instance_residency(
            lib, torch.float32 if p["dtype"] == "f32" else torch.float64,
            p["nl"], p["imp"])
        p.update(sms=sms, resident_blocks_per_sm=blocks,
                 threads_per_block=threads, shared_bytes_per_block=nbytes,
                 rounds_at_flagship_cells=day_kernel.rounds(
                     N_FLAGSHIP, sms, blocks, threads))
        print("ptxas: " + json.dumps(p))

    # 3. Kernel against plain twin.
    for dtype, regime in CHECK_REGIMES:
        for nl in (8, 20):
            case = check_case(N_CHECK, nl, dtype, dev, regime)
            for k in (1, 8):
                for use_imp in (False, True):
                    label = (f"check {str(dtype)[6:]} {regime} nl={nl} "
                             f"zd09_every={k} imp={use_imp}")
                    err, res, n_edge = check_kernel(label, case, regime, k,
                                                    use_imp)
                    print(f"{label}: ok, max|kernel-twin| h2osoi "
                          f"{err:.3e} mm, max residual {res:.3e} mm, "
                          f"{n_edge} knife-edge cells")

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
    day_kernel.launches = 0
    t0 = time.perf_counter()
    state, acc = block_step(case.state, acc0, block,
                            use_kernel=cfg.use_kernel, **run)
    means = annual_means(acc, cfg.nisurf)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    ref_launches = day_kernel.launches
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
    day_kernel.launches = 0
    t0 = time.perf_counter()
    winter, facc = block_step(sim.state, facc0, fblock, **frun,
                              **flag.step_kwargs)
    fmeans = annual_means(facc, fcfg.nisurf)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    flag_launches = day_kernel.launches
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
    day_kernel.launches = 0
    got = block_step(sim.state, facc0, sblock, **frun,
                     **dict(flag.step_kwargs, devices=[dev] * SLABS))
    torch.cuda.synchronize()
    sharded_launches = day_kernel.launches
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

    # 9. The bound of the flagship day on this card.
    bound = day_bound(winter_args, imp, fcfg.zd09_every)
    print("bound of the flagship kernel day: " + json.dumps(bound))

    common = dict(route="cuda",
                  source="hybrid9_tpu_torch/csrc/day_kernel.cu",
                  bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                  library_ms=None)
    print(json.dumps({"kernels": [
        dict(common, name="hydrology_day",
             replaces="hybrid9_tpu/physics/pallas_day.py:36",
             launches=flag_launches, max_abs_err=max(flag_err, winter_err),
             ms=fms["imp"], first_day_ms=fms["first_day_imp"],
             plain_ms=flag_plain_ms,
             reference_path=dict(launches=ref_launches, max_abs_err=ref_err,
                                 ms=ref_kernel_ms, plain_ms=ref_plain_ms,
                                 cells=N_CELLS)),
        dict(common, name="hydrology_day_sharded",
             replaces="hybrid9_tpu/physics/pallas_day.py:220",
             launches=sharded_launches, max_abs_err=sharded_err,
             ms=fms["sharded_4"], plain_ms=sharded_plain_ms,
             slabs=SLABS, one_slab_ms=fms["sharded_1"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
