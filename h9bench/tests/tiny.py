"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: a
24-degree grid of 32 cells, few members, days and sampled answers.  Only
the scale is cut; the traffic's kind, widths and switches stay."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 12345


def load(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def cell(name: str):
    """``(spec, config, workload, limits)`` of cell ``name`` at a tiny
    size, with its real limits."""
    from h9bench import harness

    spec = harness.cell_spec(load("BENCHMARK.json"), name)
    config = dict(load(spec["config"]["file"]), resolution_deg=24.0,
                  cell_block=32)
    workload = load(f"h9bench/workloads/{spec['cell']['traffic']}.json")
    if workload["kind"] == "ensemble":
        workload.update(members=3, days=4, blocks=2, warmup_days=1,
                        sample_columns=8)
    else:
        workload.update(members=4, days=2, windows=2, warmup_days=1,
                        sample_windows=1, sample_cells=6)
    return spec, config, workload, load(f"h9bench/limits/{name}.json")


def run(name: str, seed: int = SEED) -> dict:
    """One run of the tiny cell on the CPU, past the look for a card."""
    import time
    from h9bench import harness

    spec, config, workload, limits = cell(name)
    return harness.run_cell(spec, config, workload, limits, seed, 0.01,
                            False, "cpu", time.perf_counter())
