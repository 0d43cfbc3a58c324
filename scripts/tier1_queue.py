#!/usr/bin/env python3
"""The Tier-1 suite's time budget, read from junit XML files.

    python3 scripts/tier1_queue.py RUN.xml [MORE.xml ...]

The Tier-1 command (ROADMAP.md, "Tier-1 verify") runs ``tests/`` under
pytest-xdist with ``-n 6 --dist loadfile``.  xdist then queues whole
files, the files with the most tests first (``--loadscopereorder``, on by
default; files with as many tests keep their collection order), gives
every worker one file, and gives a worker the next file in the queue as
soon as it has 2 tests or fewer left to run.  The JAX package's slowest
files have few tests, so they start late.

For each test file found in the XML files this prints its test count, its
seconds (the sum of its test cases' junit times: setup, call and teardown,
so module fixtures included, module imports not), its place in that
queue, and when the simulated run starts and ends it on which worker.
Then the seconds of the port's files (``tests/test_torch_*``) and of the
others, the port's share (its seconds over the others': both scale with
the host's speed, so the share of one whole-suite run does not depend on
the host), the floor (all seconds over the workers: no packing ends
sooner) and the simulated run's end, against the limit.  The last line
is the same summary as one JSON object.

A file found in more than one XML file is taken from the last one, so
``tier1_queue.py whole_suite.xml port_only.xml`` reads the whole suite
with the port's files of another run in their place.  Runs only on the
host; reads nothing but its arguments.
"""

from __future__ import annotations

import argparse
import heapq
import json
import sys
import xml.etree.ElementTree as ET

LOW_WATERMARK = 2        # xdist's LoadScopeScheduling._reschedule
PORT_PREFIX = "tests/test_torch_"
WORKERS = 6              # the Tier-1 command's ``-n 6``
LIMIT_S = 1470.0         # and its ``timeout 1470``


def file_of(classname: str) -> str:
    """``tests.test_x`` or ``tests.test_x.TestY`` -> ``tests/test_x.py``."""
    parts = classname.split(".")
    last = max(i for i, p in enumerate(parts) if p.startswith("test"))
    return "/".join(parts[:last + 1]) + ".py"


def read_junit(paths) -> dict:
    """``{file: [seconds of each test case, in the order it ran]}`` from
    the junit XML files ``paths``; a later file replaces an earlier one's
    test files."""
    files: dict = {}
    for path in paths:
        found: dict = {}
        for case in ET.parse(path).getroot().iter("testcase"):
            name = file_of(case.get("classname", ""))
            found.setdefault(name, []).append(float(case.get("time", 0.0)))
        files.update(found)
    return files


def queue(files: dict) -> list:
    """The files in xdist's ``loadfile`` order: most tests first, ties in
    collection order (pytest collects a directory's files by name)."""
    return sorted(sorted(files), key=lambda f: -len(files[f]))


def simulate(files: dict, workers: int) -> dict:
    """``{file: (worker, start, end)}`` of a run in which each worker runs
    its tests one after another and takes the next queued file when it has
    ``LOW_WATERMARK`` tests or fewer left."""
    order = queue(files)
    pending = [[] for _ in range(workers)]     # (file, seconds) per worker
    placed: dict = {}

    def assign(w):
        if order:
            f = order.pop(0)
            pending[w].extend((f, s) for s in files[f])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= LOW_WATERMARK:
            assign(w)
    # One event each time a worker is free: (time, worker, after a test).
    events = [(0.0, w, False) for w in range(workers)]
    while events:
        t, w, done = heapq.heappop(events)
        if done and len(pending[w]) <= LOW_WATERMARK:
            assign(w)
        if not pending[w]:
            continue
        f, s = pending[w].pop(0)
        placed[f] = (w, placed[f][1] if f in placed else t, t + s)
        heapq.heappush(events, (t + s, w, True))
    return placed


def summary(files: dict, placed: dict, workers: int) -> dict:
    """The sums, the floor and the simulated end of ``files``, run as
    ``placed`` (``simulate``'s result) on ``workers`` workers."""
    secs = {f: sum(v) for f, v in files.items()}
    port = sum(s for f, s in secs.items() if f.startswith(PORT_PREFIX))
    end_file = max(placed, key=lambda f: placed[f][2]) if placed else None
    end = placed[end_file][2] if placed else 0.0
    total = sum(secs.values())
    return dict(files=len(files), tests=sum(map(len, files.values())),
                seconds=total, port_seconds=port, other_seconds=total - port,
                port_share=port / (total - port) if total > port else None,
                workers=workers, floor_s=total / workers,
                simulated_end_s=end, last_file=end_file, limit_s=LIMIT_S)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", nargs="+", help="junit XML files")
    args = ap.parse_args(argv)
    files = read_junit(args.xml)
    placed = simulate(files, WORKERS)
    print(f"{'#':>3} {'file':<42} {'tests':>5} {'seconds':>9} "
          f"{'worker':>6} {'start':>8} {'end':>8}")
    for i, f in enumerate(queue(files)):
        w, start, end = placed[f]
        print(f"{i:>3} {f:<42} {len(files[f]):>5} {sum(files[f]):>9.1f} "
              f"{w:>6} {start:>8.1f} {end:>8.1f}")
    s = summary(files, placed, WORKERS)
    share = (f"{s['port_share']:.3f}" if s["port_share"] is not None
             else "n/a")
    print(f"port files {s['port_seconds']:.1f} s, other files "
          f"{s['other_seconds']:.1f} s (port share {share}), {s['tests']} "
          f"tests in {s['files']} files")
    print(f"floor {s['floor_s']:.1f} s ({s['seconds']:.1f} s over "
          f"{WORKERS} workers); simulated end {s['simulated_end_s']:.1f}"
          f" s ({s['last_file']} last); limit {LIMIT_S:.0f} s")
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
