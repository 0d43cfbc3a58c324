"""Where the port's reference-scope day goes on one CUDA GPU.

    python3 scripts/gpu_day_breakdown.py

At 66,560 cells in float32: times the CUDA day kernel at zd09_every 8
and 1 (alternating), the whole ``day_step`` with the kernel, and
profiles ``day_step`` with torch.profiler: device-busy share of the
profiled window, launches per day and device time by kernel name.  Needs
a CUDA device; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hybrid9_tpu_torch.entry import build_reference_case  # noqa: E402
from hybrid9_tpu_torch.physics import day_kernel  # noqa: E402
from hybrid9_tpu_torch.step import day_step  # noqa: E402

N_CELLS = 66_560


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gpu_day_breakdown: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    case = build_reference_case(N_CELLS, "float32", "cuda")
    st, cfg = case.state, case.cfg
    args = (st.soil, st.veg, case.params, case.forcing, case.geom, cfg.dt,
            cfg.nisurf)

    for k in (8, 1, 1, 8):
        ms = _event_ms(lambda: day_kernel.hydrology_day_cuda(
            *args, zd09_every=k), 20)
        print(f"kernel day, zd09_every={k}: {ms:.3f} ms, "
              f"{N_CELLS / (ms * 1e-3):.4g} cell-days/s ({card})")

    def step():
        return day_step(st, case.forcing, case.params, case.geom, cfg.dt,
                        cfg.nisurf, zd09_every=cfg.zd09_every)

    print(f"day_step with kernel: {_event_ms(step, 10):.3f} ms ({card})")

    days = 5
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(days):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    print(f"profiled {days} day_steps: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(kernels) / days:.0f} kernel launches per day")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, n + 1)
    print("device ms per day by kernel (top 12):")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"  {t / days:8.3f} ms  {n // days:5d} launches  {name[:90]}")


if __name__ == "__main__":
    main()
