#!/usr/bin/env python3
"""SHA-256 of the flagship path's block on the card, to hold two trees'
kernels bitwise against each other.

    python scripts/flagship_block_digest.py

runs what ``chip_smoke.py`` phase 6 runs, ``build_flagship_case()`` and 30
days of synthetic forcing from 1 January (seed 1) through
``block_step(**step_kwargs())``, on the first CUDA device, and prints one
JSON line: the digest of every leaf of the final state and the annual
sums, the kernel's launches and the card.  Run from the root of each tree
(``PYTHONPATH=.``) in one call: equal digests mean the two trees' flagship
days are bitwise the same on that card.
"""

import hashlib
import json
import subprocess

import torch

from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.physics import day_kernel
from hybrid9_tpu_torch.state import AnnualAccumulators, Forcing
from hybrid9_tpu_torch.step import block_step

DAYS = 30


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flagship_block_digest: needs a CUDA device")
    flag = build_flagship_case()
    sim = flag.sim
    block = Forcing.from_numpy(
        synthetic_forcing_block(DAYS, sim.n, seed=1, start_doy=1,
                                lat=flag.land_grid.cell_lat),
        torch.float32, sim.device)
    acc = AnnualAccumulators.zeros(sim.n, torch.float32, sim.device)
    day_kernel.launches = 0
    state, acc = block_step(sim.state, acc, block, sim.params, sim.geom,
                            sim.cfg.dt, sim.cfg.nisurf, **flag.step_kwargs)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    leaves = []
    for tree in (state, acc):
        tree.map(lambda x: leaves.append(x) or x)
    for x in leaves:
        digest.update(x.detach().contiguous().cpu().numpy().tobytes())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(sha256=digest.hexdigest(), leaves=len(leaves),
                          days=DAYS, launches=day_kernel.launches,
                          cells=sim.n, card=smi)))


if __name__ == "__main__":
    main()
