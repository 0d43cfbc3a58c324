#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits
non-zero:

1. device: a CUDA card is required (there is no CPU path); prints its
   name and, as ``nvidia-smi`` gives them, its name and power limit;
2. build: compiles ``hybrid9_tpu_torch/csrc/day_kernel.cu`` with nvcc for
   sm_90a and prints the build seconds and the registers and spills of
   each kernel instance;
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
4. main path: ``build_reference_case(66_560, "float32", "cuda")``; the
   kernel against its twin on that case's first day (the summary's
   ``max_abs_err``, max |kernel - twin| of h2osoi_liq in mm); a
   30-day synthetic forcing block from day 152 through ``block_step``
   (kernel by default) and ``annual_means``; checks the launch count,
   finiteness, the water balance and physical ranges, and holds the first
   3 days against the same block through the plain twin;
5. timing at 66,560 cells: the kernel day, the plain-twin day and the
   whole ``day_step``, in cell-days/s beside the card's name and power
   limit.

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
from hybrid9_tpu_torch.entry import build_reference_case
from hybrid9_tpu_torch.physics import constants as c
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.state import (AnnualAccumulators, Forcing, SoilParams,
                                     initial_state)
from hybrid9_tpu_torch.step import annual_means, block_step, day_step

N_CELLS = 66_560          # padded global 0.5-degree land grid
N_CHECK = 4_096           # cells for the kernel-vs-twin cases
BLOCK_DAYS = 30
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
    for p in ptxas:
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

    # 4. Main path: first the kernel against its twin at the main path's
    # shapes and inputs (its max |diff| is the summary's max_abs_err).
    case = build_reference_case(N_CELLS, "float32", dev)
    cfg = case.cfg
    st = case.state
    day_args = (st.soil, st.veg, case.params, case.forcing, case.geom,
                cfg.dt, cfg.nisurf)
    kw = dict(zd09_every=cfg.zd09_every)
    max_err = check_day(
        "kernel vs twin at the main path's shapes",
        day_kernel.hydrology_day_cuda(*day_args, **kw),
        day_kernel.hydrology_day_plain(*day_args, **kw), case.params.bsw)[0]
    print(f"kernel vs twin, {N_CELLS} cells, f32, nl=8, zd09_every="
          f"{cfg.zd09_every}: ok, max|kernel-twin| h2osoi {max_err:.3e} mm")
    block = Forcing.from_numpy(
        synthetic_forcing_block(BLOCK_DAYS, N_CELLS, seed=1, start_doy=152),
        torch.float32, dev)
    acc0 = AnnualAccumulators.zeros(N_CELLS, dtype=torch.float32,
                                    device=dev)
    run = dict(params=case.params, geom=case.geom, dt=cfg.dt,
               nisurf=cfg.nisurf, zd09_every=cfg.zd09_every)
    day_kernel.launches = 0
    t0 = time.perf_counter()
    state, acc = block_step(case.state, acc0, block,
                            use_kernel=cfg.use_kernel, **run)
    means = annual_means(acc, cfg.nisurf)
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    launches = day_kernel.launches
    if launches != BLOCK_DAYS:
        raise RuntimeError(f"main path launched the day kernel {launches} "
                           f"times in {BLOCK_DAYS} days")
    for key, x in list(means.items()) + [("state.h2osoi_liq",
                                         state.soil.h2osoi_liq),
                                        ("state.zwt", state.soil.zwt),
                                        ("state.t_soil", state.t_soil)]:
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"main path: non-finite {key}")
    res = float(means["max_abs_residual"].max())
    theta = means["theta"]
    zwt = state.soil.zwt
    if not res < MAX_RESIDUAL_MM:
        raise RuntimeError(f"main path: residual {res} mm")
    if not (float(theta.min()) > 0.0 and float(theta.max()) < 0.55):
        raise RuntimeError(f"main path: theta in [{float(theta.min())}, "
                           f"{float(theta.max())}]")
    if not (float(zwt.min()) >= 0.0 and float(zwt.max()) <= 80.0):
        raise RuntimeError(f"main path: zwt in [{float(zwt.min())}, "
                           f"{float(zwt.max())}]")
    print(f"main path: {BLOCK_DAYS} days x {N_CELLS} cells in "
          f"{block_s:.2f} s, {launches} kernel launches, max residual "
          f"{res:.3e} mm, theta [{float(theta.min()):.4f}, "
          f"{float(theta.max()):.4f}], zwt [{float(zwt.min()):.3f}, "
          f"{float(zwt.max()):.3f}] m, mean evap "
          f"{float(means['evap'].mean()):.4e} mm/s")

    short = block.map(lambda x: x[:3])
    got = block_step(case.state, acc0, short, **run)
    want = block_step(case.state, acc0, short, use_kernel=False, **run)
    err = _compare("main path vs plain twin, 3 days",
                   *[_fields(s.soil, dict(evap_day=a.evap_sum,
                                          rnf_day=a.rnf_sum))
                     for s, a in (got, want)], F32_TOL, case.params.bsw)
    print(f"main path vs plain twin, 3 days: ok, max|diff| h2osoi "
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
                    *day_args, **kw)[0].h2osoi_liq, 3))
    step_ms = _time_cuda(
        lambda: day_step(st, case.forcing, case.params, case.geom, cfg.dt,
                         cfg.nisurf, **kw)[0].soil.h2osoi_liq, 10)[0]
    kernel_ms = float(np.mean([t[0] for t in times["kernel"]]))
    plain_ms = float(np.mean([t[0] for t in times["plain"]]))
    for label, ms in (("kernel day", kernel_ms), ("plain-twin day", plain_ms),
                      ("day_step with kernel", step_ms)):
        print(f"timing: {label}: {ms:.3f} ms, "
              f"{N_CELLS / (ms * 1e-3):.4g} cell-days/s "
              f"({N_CELLS} cells, f32, zd09_every={cfg.zd09_every}; {smi})")
    print("timing passes (event ms, wall ms): " + json.dumps(times))

    print(json.dumps({"kernels": [{
        "name": "hydrology_day",
        "route": "cuda",
        "source": "hybrid9_tpu_torch/csrc/day_kernel.cu",
        "replaces": "hybrid9_tpu/physics/pallas_day.py:36",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
