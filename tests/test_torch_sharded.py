"""The port's sharded day launcher (``hydrology_day_sharded``).

It cuts the cell axis into one contiguous slab per entry of a device
list and runs the same hydrology day on each slab.  Held here on the CPU
with the plain twin:

- against ``pallas_hydrology_day_sharded`` of the JAX package, run in
  interpret mode over the 8-virtual-device CPU mesh as
  tests/test_pallas_day.py runs it, in float32 at that file's tolerances;
- bitwise against the unsharded day for 1, 2, 3 and 8 slabs of a ragged
  cell count (days of 16 substeps).  The physics is cell-local, so a slab
  boundary must not change a bit.  PyTorch's AVX kernels compute a
  tensor's vector body with SLEEF and its last few elements with libm,
  which differ in the last ulp, so moving a slab boundary moves that
  tail: the bitwise check therefore runs in a child process on ATen's
  scalar kernels (``ATEN_CPU_CAPABILITY=default``), and in this process
  every slab is held bitwise against the twin run on that slab alone and
  within a few ulps of the unsharded day.

On the card the launcher is held bitwise against the unsharded CUDA
kernel by chip_smoke.py and tests/test_torch_cuda.py.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hybrid9_tpu.physics.hydrology import Geometry as JGeometry
from hybrid9_tpu.physics.pallas_day import pallas_hydrology_day_sharded
from hybrid9_tpu_torch.entry import build_reference_case
from hybrid9_tpu_torch.physics import constants as c, day_kernel
from hybrid9_tpu_torch.physics.hydrology import Geometry
from hybrid9_tpu_torch.step import day_step

from _torch_port import DT, F32_TOL, NISURF, check_day, day_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAGGED = 203           # divisible by none of 2, 3, 8
SLABS = [1, 2, 3, 8]
SOIL_FIELDS = ("h2osoi_liq", "zwt", "wa", "smp", "h2osoi_liq_ma")
# Substeps of the days cut into slabs, each SDAY / SUBSTEPS long: a
# slab's cells compute what they compute alone at any count; 16 keep two
# ZD09 refreshes at zd09_every=8.  The day against the JAX package's
# sharded kernel keeps its 48.
SUBSTEPS = 16


@pytest.mark.parametrize("n,k,want", [
    (203, 1, [(0, 203)]),
    (203, 2, [(0, 101), (101, 203)]),
    (203, 3, [(0, 67), (67, 135), (135, 203)]),
    (16, 4, [(0, 4), (4, 8), (8, 12), (12, 16)]),
    (69_634, 4, [(0, 17_408), (17_408, 34_816), (34_816, 52_225),
                 (52_225, 69_634)]),
])
def test_slab_bounds(n, k, want):
    """Contiguous slabs covering the axis; the remainder goes to the last
    slabs."""
    assert day_kernel.slab_bounds(n, k) == want


def test_slab_bounds_rejects_more_slabs_than_cells():
    with pytest.raises(ValueError, match="slabs"):
        day_kernel.slab_bounds(3, 4)
    with pytest.raises(ValueError, match="slabs"):
        day_kernel.slab_bounds(3, 0)


@functools.lru_cache(maxsize=None)
def _ragged_case(dtype):
    """The ragged day's arguments (built once a dtype; nothing writes to
    them)."""
    case = build_reference_case(N_RAGGED, dtype, "cpu")
    rng = np.random.RandomState(0)
    td = getattr(torch, dtype)
    kw = dict(imp=torch.tensor(rng.uniform(0.05, 1.0, (N_RAGGED, 8)),
                               dtype=td),
              sw_abs=torch.tensor(rng.uniform(0.3, 0.92, N_RAGGED), dtype=td),
              zd09_every=8)
    st = case.state
    return (st.soil, st.veg, case.params, case.forcing, case.geom,
            c.SDAY / SUBSTEPS, SUBSTEPS), kw


@functools.lru_cache(maxsize=None)
def _unsharded(dtype):
    """The ragged day unsharded, on the twin."""
    args, kw = _ragged_case(dtype)
    return _flat(day_kernel.hydrology_day_plain(*args, **kw))


@pytest.mark.parametrize("focus", [0, 100, N_RAGGED - 1])
def test_sharded_day_routes_the_focus_to_its_slab(focus):
    """The focus cell goes, at its local index, to the one slab that holds
    it: the trace is the twin's on that slab alone, and the focus changes
    no other output."""
    args, kw = _ragged_case("float64")
    soil, veg, params, forcing = args[:4]
    devices = ["cpu"] * 3
    got = day_kernel.hydrology_day_sharded(*args, devices=devices,
                                           focus_idx=focus, **kw)
    plain = _flat(day_kernel.hydrology_day_sharded(*args, devices=devices,
                                                   **kw))
    trace = got[1]["wt_substeps"]
    assert trace.shape == (args[6],)
    assert set(_flat(got)) == set(plain) | {"wt_substeps"}
    for name, x in plain.items():
        assert torch.equal(_flat(got)[name], x), name
    (lo, hi), = [b for b in day_kernel.slab_bounds(N_RAGGED, 3)
                 if b[0] <= focus < b[1]]

    def cut(x):
        return x[lo:hi]
    alone = day_kernel.hydrology_day_plain(
        soil.map(cut), veg.map(cut), params.map(cut), forcing.map(cut),
        *args[4:], imp=cut(kw["imp"]), sw_abs=cut(kw["sw_abs"]),
        zd09_every=8, focus_idx=focus - lo)
    assert torch.equal(trace, alone[1]["wt_substeps"])
    assert torch.equal(trace[-1], alone[0].zwt[focus - lo])


def _flat(day):
    soil, diags = day
    return dict({f: getattr(soil, f) for f in SOIL_FIELDS}, **diags)


@pytest.mark.parametrize("k", SLABS)
def test_sharded_day_is_the_twin_on_each_slab(k):
    """Every operand is cut on its leading axis (``imp`` and ``sw_abs``
    too) and the results are joined in order: each slab of the sharded
    day is bitwise the twin's day on that slab alone, and the whole is
    within a few ulps of the unsharded day."""
    args, kw = _ragged_case("float64")
    got = _flat(day_kernel.hydrology_day_sharded(
        *args, devices=["cpu"] * k, **kw))
    whole = _unsharded("float64")
    for name in whole:
        assert got[name].shape == whole[name].shape
        torch.testing.assert_close(got[name], whole[name], rtol=1e-11,
                                   atol=1e-11, msg=name)
    soil, veg, params, forcing = args[:4]
    for lo, hi in day_kernel.slab_bounds(N_RAGGED, k):
        def cut(x):
            return x[lo:hi]
        alone = _flat(day_kernel.hydrology_day_plain(
            soil.map(cut), veg.map(cut), params.map(cut), forcing.map(cut),
            *args[4:], imp=cut(kw["imp"]), sw_abs=cut(kw["sw_abs"]),
            zd09_every=8))
        for name in alone:
            assert torch.equal(got[name][lo:hi], alone[name]), (name, lo)


_CHILD = r"""
import json, sys
import torch
from hybrid9_tpu_torch import state as t_state
from hybrid9_tpu_torch.data.synthetic import synthetic_forcing_block
from hybrid9_tpu_torch.entry import build_flagship_case
from hybrid9_tpu_torch.step import block_step
sys.path.insert(0, "tests")
import test_torch_sharded as me

out = {}
for dtype in ("float64", "float32"):
    args, kw = me._ragged_case(dtype)
    whole = me._flat(me.day_kernel.hydrology_day_plain(*args, **kw))
    for k in me.SLABS:
        got = me._flat(me.day_kernel.hydrology_day_sharded(
            *args, devices=["cpu"] * k, **kw))
        out[f"{dtype}-{k}"] = sorted(
            name for name in whole if not torch.equal(got[name], whole[name]))

case = build_flagship_case("cpu", "float64", resolution_deg=4.0)
sim = case.sim
block = t_state.Forcing.from_numpy(
    synthetic_forcing_block(2, sim.n, seed=3, start_doy=1,
                            lat=case.land_grid.cell_lat),
    torch.float64, "cpu")
runs = []
for devices in (None, ["cpu", "cpu", "cpu"]):
    acc = t_state.AnnualAccumulators.zeros(sim.n, torch.float64, "cpu")
    kw = dict(case.step_kwargs, devices=devices)
    runs.append(block_step(sim.state, acc, block, sim.params, sim.geom,
                           me.c.SDAY / me.SUBSTEPS, me.SUBSTEPS, **kw))
leaves = [[], []]
for i, (state, acc) in enumerate(runs):
    state.map(lambda x: leaves[i].append(x) or x)
    acc.map(lambda x: leaves[i].append(x) or x)
out["flagship"] = [i for i, (a, b) in enumerate(zip(*leaves))
                   if not torch.equal(a, b)]
out["flagship_leaves"] = len(leaves[0])
out["capability"] = torch.backends.cpu.get_cpu_capability()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def scalar_kernel_run():
    """What differed, bitwise, between the sharded and the unsharded day
    in a child process on ATen's scalar CPU kernels."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ATEN_CPU_CAPABILITY"] = "default"
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["capability"] in ("DEFAULT", "NO AVX"), res["capability"]
    return res


@pytest.mark.parametrize("k", SLABS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_day_is_bitwise_the_unsharded_day(scalar_kernel_run, dtype,
                                                  k):
    assert scalar_kernel_run[f"{dtype}-{k}"] == []


def test_sharded_flagship_block_is_bitwise_the_unsharded_block(
        scalar_kernel_run):
    """Two flagship days (16 substeps) through ``block_step(devices=[cpu]
    * 3)``: every state field and annual sum bitwise equal to the
    unsharded run."""
    assert scalar_kernel_run["flagship_leaves"] > 40
    assert scalar_kernel_run["flagship"] == []


def test_sharded_day_matches_pallas_sharded_on_the_cpu_mesh():
    """float32, 8 x 256 cells, with the impedance operand and the
    absorptivity: the port over eight CPU slabs against the JAX package's
    shard_map'd Pallas kernel in interpret mode on the 8-device mesh."""
    global_n = 8 * 256
    j, t, geom = day_case(8, "float32", varied=False, n=global_n)
    rng = np.random.RandomState(7)
    a = rng.uniform(0.3, 0.92, global_n)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("cells",))
    soil_j, diags_j = pallas_hydrology_day_sharded(
        j["soil"], j["veg"], j["params"], j["forcing"], JGeometry(*geom),
        DT, NISURF, mesh=mesh, block=256, interpret=True, imp=j["imp"],
        zd09_every=8, sw_abs=jnp.asarray(a, jnp.float32))
    got = day_kernel.hydrology_day_sharded(
        t["soil"], t["veg"], t["params"], t["forcing"], Geometry(*geom),
        DT, NISURF, devices=["cpu"] * 8, imp=t["imp"], zd09_every=8,
        sw_abs=torch.tensor(a, dtype=torch.float32))
    check_day(*got, dict(h2osoi_liq=soil_j.h2osoi_liq, zwt=soil_j.zwt,
                         wa=soil_j.wa, **diags_j), F32_TOL)


def test_day_step_takes_a_device_list():
    case = build_reference_case(50, "float64", "cpu")
    args = (case.state, case.forcing, case.params, case.geom, case.cfg.dt,
            case.cfg.nisurf)
    before = day_kernel.launches
    got, gd = day_step(*args, zd09_every=8, devices=["cpu"] * 3)
    want, wd = day_step(*args, zd09_every=8)
    # No kernel launch is counted where the twin ran.
    assert day_kernel.launches == before
    torch.testing.assert_close(got.soil.h2osoi_liq, want.soil.h2osoi_liq,
                               rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(gd["evap_day"], wd["evap_day"], rtol=1e-11,
                               atol=1e-11)
    assert got.soil.h2osoi_liq.shape == (50, 8)


def test_sharded_day_has_no_fallback_from_the_kernel():
    args, kw = _ragged_case("float32")
    with pytest.raises(ValueError, match="CUDA"):
        day_kernel.hydrology_day_sharded(*args, devices=["cpu", "cpu"],
                                         use_kernel=True, **kw)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_sharded_day_moves_no_slab_to_another_kind_of_device(use_kernel):
    """A device list naming another type of device than the inputs' raises:
    the launcher settles kernel or twin from the inputs and never carries
    a slab to the host (or off it) behind the caller."""
    args, kw = _ragged_case("float32")
    with pytest.raises(ValueError, match="cannot be cut over"):
        day_kernel.hydrology_day_sharded(*args, devices=["cpu", "meta"],
                                         use_kernel=use_kernel, **kw)


@pytest.mark.parametrize("nl,zd09_every,with_imp,jwt,want", [
    (8, 8, True, 8, (45470, 1204)),
    (8, 8, False, 8, (45038, 1204)),
    (8, 1, True, 8, (53144, 2596)),
    (8, 8, True, 0, (43652, 1018)),
    (20, 8, True, 20, (100622, 2644)),
])
def test_day_operations_counts_the_kernels_taken_path(nl, zd09_every,
                                                      with_imp, jwt, want):
    """The operation count of a cell-day, from the kernel's source: pinned
    per instance, the same for an int and for a tensor of table positions,
    and one multiply per layer and one for infiltration for the impedance
    operand."""
    got = day_kernel.day_operations(nl, NISURF, zd09_every, with_imp, jwt)
    assert got == want
    per_cell = day_kernel.day_operations(nl, NISURF, zd09_every, with_imp,
                                         torch.tensor([jwt, jwt]))
    assert [x.tolist() for x in per_cell] == [[want[0]] * 2, [want[1]] * 2]
    bare = day_kernel.day_operations(nl, NISURF, zd09_every, False, jwt)
    assert got[0] - bare[0] == int(with_imp) * NISURF * (nl + 1)
