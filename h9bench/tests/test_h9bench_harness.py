"""The run's interface: the last line, the refusal without a card, the
traced window's reduction, and (on the card only) one short run."""

import json
import os
import subprocess
import sys

import pytest

from tiny import ROOT, load


def test_last_line_has_the_drivers_keys_then_the_checks():
    from h9bench import harness

    checks = {"evap_gap": dict(value=1e-5, limit=1e-3)}
    out = dict(correct=True, attempted=3, failed=0,
               metrics={"setup_s": dict(value=12.0, unit="s")}, peak=1,
               busy={}, checks=checks)
    device = dict(platform="gpu", kind="card", count=1, memory_peak_bytes=1)
    line = harness.result_line(out, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    traced = harness.result_line(dict(out, breakdown=dict(
        device_ops=[], idle_gaps=[])), device)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]


def test_no_card_no_result():
    """Without a card the run exits with an error and prints nothing on
    standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run(
        [sys.executable, "h9bench/run.py", "--workload", "ens8_nl8",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout == ""


class _Event:
    def __init__(self, name, device, start, dur, corr):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_reduction():
    from h9bench import trace

    events = [
        _Event("cudaLaunchKernel", False, 0, 10, 1),
        _Event("day_kernel<float, 8, false>", True, 20, 100, 1),
        _Event("cudaLaunchKernel", False, 150, 10, 2),
        _Event("elementwise_kernel", True, 200, 50, 2),
        _Event("cudaMemcpyAsync", False, 240, 100, 3),
        _Event("Memcpy DtoH", True, 300, 20, 3),
    ]
    tr, bd = trace.reduce(events, 1e-6, 2, 10, 1e-9,
                          {"span": [(140, 180)]})
    assert len(tr.kernels) == 2
    assert tr.busy_s == pytest.approx(170e-9)
    assert tr.least_s == pytest.approx(1e-8)
    assert tr.spans["span"] == (pytest.approx(50e-9), 1)
    gaps = dict(bd["idle_gaps"])
    assert gaps["host: between CUDA calls"] == pytest.approx(80e-9)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(50e-9)
    assert bd["device_ops"][0][0].startswith("day_kernel")
    from h9bench import harness
    roof = harness.load_reader("day_kernel_roofline").read(tr)
    assert roof == pytest.approx(100.0 * 1e-8 / 100e-9)
    assert harness.load_reader("day_kernel_any_roofline").read(tr) is None
    assert harness.load_reader("launches_per_day").read(tr) == 1.0


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = subprocess.run(
        [sys.executable, "h9bench/run.py", "--workload", "da16_nl8",
         "--seed", str(2**31 + 7), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(load("BENCHMARK.json")["end_to_end"][0]) >= {"name"}
    assert os.path.exists(os.path.join(ROOT, "h9bench", "run.py"))
