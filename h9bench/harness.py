"""One run of one cell: set-up, the window (or the traced window), the
check against the reference, and the result line.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and metrics; the cell's files are found by name:
``configs/<config>.json`` (through the configuration's ``file``),
``workloads/<traffic>.json`` (the traffic mix the cell names),
``limits/<cell>.json`` (the limit of each number compared) and
``metrics/<metric>.py`` (a reader of the traced window).  Adding a cell
or a metric adds files and entries.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import inputs, reference, roofline, trace, traffic

HERE = Path(__file__).resolve().parent
#: Top-level modules that may not be loaded in the process that prints a
#: result: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "hybrid9_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration's entry, and the end-to-end and
    per-layer metrics it reports, from ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=config,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def load_reader(name: str):
    """The reader ``metrics/<name>.py``: ``read(trace)`` gives the
    metric's value or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h9bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sample(cell, results: list, seed: int, control: bool):
    rng = np.random.default_rng(
        inputs.stream_seed(seed, inputs.STREAMS["sample"], 1))
    tasks, judged = cell.answers(results, rng, judged_by_control=control)
    cell.free()
    refs = reference.run_tasks(tasks, "float64")
    errors = [r["error"] for r in refs if "error" in r]
    if errors:
        print(f"reference failed: {errors[0]}", file=sys.stderr)
    return tasks, judged, refs, errors


def _checks(values: dict, limits: dict) -> dict:
    return {name: dict(value=values.get(name, math.nan), limit=limit)
            for name, limit in limits.items()}


def check(cell, results: list, limits: dict, seed: int) -> dict:
    """The numbers compared, each ``{"value", "limit"}``: a sample of the
    window's answers drawn from the seed against the plain reference, run
    once the program's state is freed."""
    tasks, judged, refs, errors = _sample(cell, results, seed, False)
    values = {} if errors else cell.compare(judged, refs, reference.gap)
    return _checks(values, limits)


def control_check(cell, limits: dict, seed: int, arithmetic: str) -> dict:
    """The control: the reference in ``arithmetic`` judged in the
    program's place on the answers a run with this seed samples (every
    one of the cell's answers is one column's, so the sample's are those
    of the whole cell).  A column on which the control fails with an
    arithmetic error counts as ``crashed``; the numbers are read over the
    columns it finished."""
    fake = [dict(window=k) for k in range(len(cell.blocks))]
    tasks, _, refs, errors = _sample(cell, fake, seed, True)
    ctrl = reference.run_tasks(tasks, arithmetic)
    ran = [i for i, r in enumerate(ctrl) if "error" not in r]
    values = {}
    if ran and not errors:
        values = cell.compare(type(cell).from_control([ctrl[i] for i in ran]),
                              [refs[i] for i in ran], reference.gap)
    return dict(checks=_checks(values, limits), crashed=len(tasks) - len(ran),
                columns=len(tasks))


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(spec: dict, config: dict, workload: dict, limits: dict,
             seed: int, seconds: float, traced: bool, device,
             t0: float) -> dict:
    """Set-up, the window and the check of one run on ``device``; the
    result's keys but ``device``."""
    import torch

    t_start = time.perf_counter()
    cell = traffic.KINDS[workload["kind"]](config, workload, seed, device)
    t_inputs = time.perf_counter()
    cell.warm_up()
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
        if traced:
            trace.start_tracing()
    setup_s = time.perf_counter() - t0
    print(f"set-up seconds: start {t_start - t0:.3f}, inputs "
          f"{t_inputs - t_start:.3f}, warm-up {t0 + setup_s - t_inputs:.3f}",
          file=sys.stderr)
    metrics = {}
    breakdown = None
    if traced:
        readers = {m["name"]: load_reader(m["name"])
                   for m in spec["per_layer"]}
        brackets = {}
        with trace.spans(readers, brackets):
            results, events, window_s = trace.profile(
                cell.call, workload["trace_calls"])
        least = roofline.least_cell_day(cell.nl, config["nisurf"],
                                        config["zd09_every"],
                                        cell.lat.element_size())
        tr, breakdown = trace.reduce(
            events, window_s, cell.model_days(len(results)),
            cell.cell_days_per_call * len(results), least["seconds"],
            brackets)
        del events
        for m in spec["per_layer"]:
            value = readers[m["name"]].read(tr)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        busy = dict(busy_s=tr.busy_s, window_s=tr.window_s)
        trace.write(str(Path("h9bench_out") / f"{spec['cell']['name']}-"
                        f"{seed}.trace.json.gz"), tr, breakdown)
    else:
        results, times = traffic.run_window(cell, seconds)
        span = times[-1][1] - times[0][0]
        values = dict(
            cell_days_per_s=cell.cell_days_per_call * len(results) / span,
            setup_s=setup_s,
            da_window_ms_p95=float(np.percentile(
                [(b - a) * 1e3 for a, b in times], 95)))
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(value=values[m["name"]],
                                      unit=m["unit"])
        busy = {}
        print("call seconds " + " ".join(f"{b - a:.4f}" for a, b in times),
              file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    failed = sum(not cell.finite(r) for r in results)
    checks = check(cell, results, limits, seed)
    out = dict(correct=failed == 0 and passed(checks),
               attempted=len(results), failed=failed, metrics=metrics,
               peak=peak, busy=busy, checks=checks)
    if breakdown is not None:
        out["breakdown"] = breakdown
    return out


def result_line(out: dict, device: dict) -> dict:
    """The last line's object: the driver's keys, then the numbers
    compared beside their limits, last."""
    result = dict(correct=out["correct"], attempted=out["attempted"],
                  failed=out["failed"], metrics=out["metrics"], device=device)
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(prog="h9bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="",
                   help="judge the reference in this arithmetic "
                        "(bfloat16) in the program's place, without a "
                        "window; prints the numbers compared")
    args = p.parse_args(argv)

    spec = cell_spec(load_json("BENCHMARK.json"), args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h9bench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    config = load_json(spec["config"]["file"])
    workload = load_json(HERE / "workloads"
                         / f"{spec['cell']['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{args.workload}.json")
    device = torch.device("cuda", 0)
    if args.control:
        cell = traffic.KINDS[workload["kind"]](config, workload, args.seed,
                                               device)
        got = control_check(cell, limits, args.seed, args.control)
        print(json.dumps(dict(control=args.control, seed=args.seed,
                              workload=args.workload,
                              correct=passed(got["checks"]), **got)))
        return 0
    out = run_cell(spec, config, workload, limits, args.seed, args.seconds,
                   bool(args.trace), device, t0)
    found = forbidden_modules()
    if found:
        print(f"h9bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=chips, memory_peak_bytes=out["peak"],
               power_limit=power_limit(), **out["busy"])
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result_line(out, dev)))
    return 0
