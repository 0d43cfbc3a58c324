#!/usr/bin/env python3
"""The forms of ``day_kernel_any`` timed against each other, by layer count.

    python3 scripts/day_kernel_forms.py [--counts 3-33] [--dtype float32]
        [--cells 68608] [--reps 10] [--out FILE.json]

``day_kernel_any`` (``hybrid9_tpu_torch/csrc/day_kernel.cu``) runs a day
of any layer count on a register build whose capacity holds the count, or
on its all-shared form; ``kernels.ANY_BUILDS`` gives each register build
the range of counts it serves.  For every count of ``--counts`` this
script builds ``chip_smoke.check_case``'s varied columns (with the
impedance operand, ``zd09_every=8``) at ``--cells`` cells on the first
CUDA device, and times, in turns (forward, then backward), every register
build that holds the count and the all-shared form, each a mean over
``--reps`` launches by CUDA events.  It prints one JSON line a count (ms
by form, the form the wrapper chooses, and the fastest) and the card's
name and power limit, and writes them all to ``--out``: the measurement
behind each build's range.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hybrid9_tpu_torch.physics import day_kernel as dk  # noqa: E402


def counts(text: str) -> list:
    """``"3-8,10"`` -> ``[3, 4, 5, 6, 7, 8, 10]``."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def time_forms(nl: int, dtype, n: int, reps: int, dev) -> dict:
    """ms of each form of ``day_kernel_any`` that takes ``nl`` layers."""
    soil, veg, params, forcing, geom, imp = chip_smoke.check_case(
        n, nl, dtype, dev, "varied")
    forms = [cap for cap in dk.any_capacities(dtype) if nl <= cap]
    forms.append(dk.ALL_SHARED)
    fns = {f: (lambda f=f: dk.hydrology_day_cuda(
        soil, veg, params, forcing, geom, 1800.0, 48, imp=imp, zd09_every=8,
        form=f)[0].h2osoi_liq) for f in forms}
    times = {f: [] for f in forms}
    for order in (forms, forms[::-1]):
        for f in order:
            times[f].append(chip_smoke._time_cuda(fns[f], reps)[0])
    ms = {f: sum(v) / len(v) for f, v in times.items()}
    return dict(nl=nl, dtype=str(dtype)[6:], cells=n,
                ms={("all-shared" if f == dk.ALL_SHARED else
                     f"capacity={f}"): m for f, m in ms.items()},
                chosen=dk.kernel_instance(dtype, nl, any_nl=True),
                fastest=min(ms, key=ms.get))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--counts", default="3-33")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "float64"))
    parser.add_argument("--cells", type=int, default=68_608)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("day_kernel_forms: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    rows = []
    for nl in counts(args.counts):
        rows.append(time_forms(nl, dtype, args.cells, args.reps, dev))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows),
                                             indent=1))


if __name__ == "__main__":
    main()
