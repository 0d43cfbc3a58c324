"""The CUDA day kernel measured on one GPU, alone and beside other builds.

    python3 scripts/day_kernel_sweep.py [--source LABEL=PATH.cu ...]
        [--others] [--reps 20] [--out DIR]

``csrc/day_kernel.cu`` fixes how each instance is built (``Build`` in the
source: rolled or unrolled layer loops, what lives in shared memory, the
resident blocks ``__launch_bounds__`` asks for).  To try another build,
copy the source, change the copy and name it with ``--source``: this
script compiles the package's source and every such copy at once, and for
each build prints the registers and spills of its float32 nl=8 instances
(``nvcc -Xptxas -v``), its shared memory a block and the resident warps an
SM (the occupancy the library reports), holds one day against the plain
twin on the flagship's winter state, and times the kernel day, all builds
in turns, forward then backward, at 69,632 cells on the winter state and
on the first day's state (with the impedance operand) and at 66,560 cells
at reference scope (without).  A copy keeps the C interface of the
package's source.

Then, on the package's own build: the winter state under the first day's
forcing and the reverse; either state with the other's soil water; the
winter state tiled to 282,624 cells; with ``--others`` the instances off
the main path (nl=20, float64) at 4,096 and 33,792 cells; the time
against the warps a scheduler holds (k x 16,896 cells); and the
instructions of a cell-day counted from ``cuobjdump -sass``, over the
rate at which the card's schedulers dispatch them.

Needs a CUDA device; prints the card's name and power limit; writes
``day_kernel_sweep.json`` and the main kernel's SASS into ``--out``
(default ``sweep_out/`` beside the package).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hybrid9_tpu_torch import kernels  # noqa: E402
from hybrid9_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_forcing_block, synthetic_forcing_day)
from hybrid9_tpu_torch.entry import (build_flagship_case,  # noqa: E402
                                     build_reference_case)
from hybrid9_tpu_torch.physics import day_kernel as dk  # noqa: E402
from hybrid9_tpu_torch.physics.soiltemp import (  # noqa: E402
    freeze_impedance_from_ice)
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing  # noqa: E402
from hybrid9_tpu_torch.step import block_step, snow_absorptivity  # noqa: E402


def _ptxas(log: str) -> dict:
    """``{with_imp: (registers, spill stores, spill loads)}`` of the
    float32 nl=8 instances in an ``nvcc -Xptxas -v`` log."""
    return {p["imp"]: (p["registers"], p["spill_stores"], p["spill_loads"])
            for p in chip_smoke._ptxas_summary(log)
            if p["dtype"] == "f32" and p["nl"] == 8}


@contextlib.contextmanager
def using(lib):
    """The package's wrapper launching ``lib`` instead of its own build."""
    own = kernels.day_kernel_lib
    kernels.day_kernel_lib = lambda: lib
    try:
        yield
    finally:
        kernels.day_kernel_lib = own


def count_instructions(text: str, layers: int = 8, substeps: int = 48):
    """Instructions of one cell-day, reckoned from the SASS ``text`` of
    one kernel: the substep loop is the innermost backward branch that
    spans more than half the kernel; a backward branch inside it is a
    rolled layer loop.  ``per_cell_day_low`` counts every instruction of
    the substep loop once, times ``substeps``, plus the rest once;
    ``per_cell_day_high`` counts each rolled loop ``layers`` times.  Both
    count both sides of every branch, and the profile refresh and the
    table walks that most substeps skip, which overcounts; both leave out
    the slow paths of division (the CALLs), which undercounts on frozen
    columns."""
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", text)]
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops, calls = [], 0
    for i, (_, op) in enumerate(ins):
        m = re.search(r"\b(BRA|CALL\.REL\.NOINC)\b.*?(0x[0-9a-f]+)", op)
        if not m or int(m.group(2), 16) not in index:
            continue
        j = index[int(m.group(2), 16)]
        if m.group(1) == "BRA" and j < i:
            loops.append((j, i))
        elif m.group(1) != "BRA":
            calls += 1
    total = len(ins)
    spans = [(lo, hi) for lo, hi in loops if hi - lo > total // 2]
    if not spans:
        return {"static_instructions": total,
                "error": "no loop spanning half the kernel"}
    lo, hi = min(spans, key=lambda s: s[1] - s[0])
    body = hi - lo + 1
    inner = [(a, b) for a, b in loops if lo < a and b < hi]
    # Outermost inner loops only: a loop nested in another counts once.
    inner = [(a, b) for a, b in inner
             if not any(c <= a and b <= d and (c, d) != (a, b)
                        for c, d in inner)]
    rolled = sum(b - a + 1 for a, b in inner)
    return dict(static_instructions=total, substep_loop=body,
                rolled_loops=[b - a + 1 for a, b in sorted(inner)],
                in_rolled_loops=rolled,
                division_slow_path_calls=calls,
                per_cell_day_low=body * substeps + total - body,
                per_cell_day_high=(body + rolled * (layers - 1)) * substeps
                + total - body)


def sass_instructions(lib_path, out: Path) -> dict:
    """:func:`count_instructions` of the float32 nl=8 instance with the
    impedance operand in a built library, through ``cuobjdump -sass``;
    the kernel's SASS is also written into ``out``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"error": "no cuobjdump in the toolkit"}
    proc = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        return {"error": proc.stderr[-300:]}
    for text in re.split(r"\n\s*Function : ", proc.stdout)[1:]:
        if re.search(r"day_kernelIfLi8ELb1E", text.split("\n", 1)[0]):
            (out / "day_kernel_f32_nl8_imp.sass").write_text(text)
            return count_instructions(text)
    return {"error": "kernel not found in the SASS"}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", action="append", default=[],
                        metavar="LABEL=PATH",
                        help="a changed copy of csrc/day_kernel.cu to "
                             "build and time beside the package's")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=str(ROOT / "sweep_out"),
                        help="directory for the JSON record and the SASS")
    parser.add_argument("--others", action="store_true",
                        help="also time the instances off the main path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("day_kernel_sweep: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)

    # Build everything at once.
    jobs = {"package": lambda: kernels.build(
        "h9day", [kernels.DAY_KERNEL_SOURCE])}
    for item in args.source:
        label, path = item.split("=", 1)
        jobs[label] = (lambda p=Path(path).resolve(): kernels.build(
            "h9sweep", [p]))
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        futures = {k: pool.submit(f) for k, f in jobs.items()}
        paths = {}
        for k, fut in futures.items():
            try:
                paths[k] = fut.result()
            except RuntimeError as e:
                print(f"build of {k} FAILED:\n{str(e)[-3000:]}")
    if "package" not in paths:
        raise SystemExit("the package's own build failed")
    rows = {}
    for k, path in paths.items():
        info = kernels.build_logs.get(str(path), {})
        rows[k] = dict(build_s=info.get("seconds"),
                       ptxas=_ptxas(info.get("log", "")))
    libs = {k: kernels.bind_day_kernel(p) for k, p in paths.items()}

    # The inputs: the flagship's first day and the winter state 30 days
    # leave, and the reference scope.
    flag = build_flagship_case()
    sim, fcfg, n = flag.sim, flag.sim.cfg, flag.sim.n
    lat = flag.land_grid.cell_lat
    fblock = Forcing.from_numpy(
        synthetic_forcing_block(30, n, seed=1, start_doy=1, lat=lat),
        torch.float32, dev)
    winter, _ = block_step(
        sim.state, AnnualAccumulators.zeros(n, torch.float32, dev), fblock,
        params=sim.params, geom=sim.geom, dt=fcfg.dt, nisurf=fcfg.nisurf,
        **flag.step_kwargs)
    f31 = Forcing.from_numpy(synthetic_forcing_day(n, 31, seed=1, lat=lat),
                             torch.float32, dev)
    f1 = fblock.map(lambda x: x[0])

    def day_inputs(state, forcing):
        return ((state.soil, state.veg, sim.params, forcing, sim.geom,
                 fcfg.dt, fcfg.nisurf),
                dict(imp=freeze_impedance_from_ice(state.soil.h2osoi_liq,
                                                   state.h2osoi_ice),
                     sw_abs=snow_absorptivity(state.swe, *sim.snow_albedo),
                     zd09_every=fcfg.zd09_every))

    def timed(inputs_, reps=args.reps):
        d_args, d_kw = inputs_
        return chip_smoke._time_cuda(lambda: dk.hydrology_day_cuda(
            *d_args, **d_kw)[0].h2osoi_liq, reps)[0]

    ref = build_reference_case(chip_smoke.N_CELLS, "float32")
    inputs = {
        "winter": day_inputs(winter, f31),
        "first_day": day_inputs(sim.state, f1),
        "reference": ((ref.state.soil, ref.state.veg, ref.params,
                       ref.forcing, ref.geom, ref.cfg.dt, ref.cfg.nisurf),
                      dict(zd09_every=ref.cfg.zd09_every)),
    }

    # Each build against the plain twin on the winter state.
    w_args, w_kw = inputs["winter"]
    want = dk.hydrology_day_plain(*w_args, **w_kw)
    edge = chip_smoke.knife_edge_cells(*w_args[:5], want, **w_kw)
    print(f"winter state: {int(edge.sum())} knife-edge cells set aside")
    first = None
    for k, lib in libs.items():
        try:
            with using(lib):
                _, blocks, block, nbytes = dk.instance_residency(
                    lib, torch.float32, 8, True)
                got = dk.hydrology_day_cuda(*w_args, **w_kw)
            torch.cuda.synchronize()
            rows[k].update(shared_bytes=nbytes,
                           warps_per_sm=blocks * block // 32,
                           max_abs_err=chip_smoke.check_day(
                               k, got, want, sim.params.bsw, ~edge)[0])
        except RuntimeError as e:
            rows[k]["failed"] = str(e)[:300]
            print(f"{k}: FAILED: {e}")
            continue
        if first is None:
            first = got
        rows[k]["cells_not_bitwise_the_first_build"] = int(
            (got[0].h2osoi_liq != first[0].h2osoi_liq).any(dim=1).sum())

    # Times, all builds in turns, forward then backward.
    good = [k for k in libs if "failed" not in rows[k]]
    for which in inputs:
        for order in (good, good[::-1]):
            for k in order:
                with using(libs[k]):
                    rows[k].setdefault(f"{which}_ms", []).append(
                        timed(inputs[which]))

    print(f"{'build':22s} regs(imp,no) spill(st,ld) smem/blk warps/SM  "
          f"winter  first  reference  err mm   ({card})")
    for k in libs:
        r = rows[k]
        px = r["ptxas"]
        regs = "/".join(str(px[i][0]) for i in (True, False) if i in px)
        spill = "/".join(f"{px[i][1]},{px[i][2]}" for i in (True, False)
                         if i in px)
        ms = ["-".join(f"{x:.3f}" for x in r.get(f"{w}_ms", []))
              for w in inputs]
        print(f"{k:22s} {regs:>11s} {spill:>12s} "
              f"{r.get('shared_bytes', 0):8d} "
              f"{r.get('warps_per_sm', 0):8d}  {ms[0]}  {ms[1]}  {ms[2]}  "
              f"{r.get('max_abs_err', float('nan')):.2e}")

    # From here on, the package's build.
    # State against forcing: four numbers.
    cross = {f"{s_name}, {f_name}": timed(day_inputs(state, forcing))
             for s_name, state in (("winter_state", winter),
                                   ("first_day_state", sim.state))
             for f_name, forcing in (("day31_forcing", f31),
                                     ("day1_forcing", f1))}
    print("state x forcing, ms per day: " + json.dumps(cross))

    # What of the winter state costs: the first day's state with the
    # winter's soil water and potential, and the reverse.
    swap = {}
    for s_name, state, other in (("winter_state", winter, sim.state),
                                 ("first_day_state", sim.state, winter)):
        mixed = state.replace(soil=state.soil.replace(
            h2osoi_liq=other.soil.h2osoi_liq, smp=other.soil.smp))
        swap[f"{s_name} with the other's soil water"] = timed(
            day_inputs(mixed, f31))
    print("soil water swapped, ms per day: " + json.dumps(swap))

    # The winter state tiled to the 0.25-degree cell count.
    def tiled(x):
        m = chip_smoke.N_QUARTER_DEGREE
        return torch.cat([x] * (m // n) + [x[:m % n]])

    big = (tuple(a.map(tiled) for a in w_args[:4]) + w_args[4:],
           dict(w_kw, imp=tiled(w_kw["imp"]), sw_abs=tiled(w_kw["sw_abs"])))
    quarter = {f"winter state tiled, {chip_smoke.N_QUARTER_DEGREE} cells":
               timed(big, 10)}
    print("0.25-degree cell count, ms per day: " + json.dumps(quarter))

    # The instances off the main path.
    others = {}
    if args.others:
        for dtype, nl in ((torch.float32, 20), (torch.float64, 8),
                          (torch.float64, 20)):
            for m in (4_096, 33_792):
                soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
                    m, nl, dtype, dev, "varied")
                res = dk.instance_residency(libs["package"], dtype, nl, True)
                others[f"{str(dtype)[6:]} nl={nl}, {m} cells ({res[1]} warps "
                       f"an SM)"] = timed(
                    ((soil, veg, params, forcing, geom, 1800.0, 48),
                     dict(imp=imp, zd09_every=8)), 5)
        print("instances off the main path, ms per day: "
              + json.dumps(others, indent=1))

    # Warps a scheduler against time: k x 16,896 cells put k warps on
    # each of the card's 528 schedulers.  Where the time rises in
    # proportion the kernel is bound by the schedulers' instruction slots,
    # and the rise per warp is what a warp's cell-days cost in them.
    sms = dk.instance_residency(libs["package"], torch.float32, 8, True)[0]
    per_scheduler = sms * 4 * 32
    by_warps = {}
    for name in ("first_day", "winter"):
        d_args, d_kw = inputs[name]
        for k in range(1, 6):
            m = min(n, k * per_scheduler)

            def cut(x, m=m):
                return x[:m]

            by_warps[f"{name}, {k} warps a scheduler, {m} cells"] = timed(
                (tuple(a.map(cut) for a in d_args[:4]) + d_args[4:],
                 dict(d_kw, imp=d_kw["imp"][:m], sw_abs=d_kw["sw_abs"][:m])))
    print("warps a scheduler, ms per day: " + json.dumps(by_warps))

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    sass = sass_instructions(paths["package"], out)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    if clock and "per_cell_day_low" in sass:
        # One warp instruction a cycle on each of an SM's 4 schedulers.
        sass["max_sm_clock_mhz"] = float(clock[0])
        for which in ("low", "high"):
            sass[f"instruction_floor_ms_{which}"] = (
                sass[f"per_cell_day_{which}"] * -(-n // 32)
                / (sms * 4 * float(clock[0]) * 1e6) * 1e3)
    print("instructions, f32 nl=8 with imp: " + json.dumps(sass))

    (out / "day_kernel_sweep.json").write_text(json.dumps(
        dict(card=card, cells=n, rows=rows, cross=cross, swap=swap,
             quarter=quarter, by_warps=by_warps, others=others, sass=sass),
        indent=1, default=str))


if __name__ == "__main__":
    main()
