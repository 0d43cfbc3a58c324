"""What the CUDA day kernel's wrapper decides in Python, on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Its launch geometry, what it refuses of an instance and
which tensors it accepts are pure functions of ``physics/day_kernel.py``
and are held here: the grid, a block per 32 cells and a cell a thread,
covers every cell exactly once for cell counts around a warp, around the
0.5-degree grid and at the 0.25-degree grid; the main-path build holds
the 0.5-degree grid in one round; an instance that wants more shared
memory than a block may use is refused; slab views go in without a copy
and anything else raises.  Layer counts with a build of their own go to
it, every other count from 3 to the cap (at least 64 in both dtypes) to
``day_kernel_any``, whose rows may start on any element: to the register
build whose range holds the count, else the all-shared form, whatever the
impedance operand; fewer than 3 layers and more than the cap raise before
any launch.  The words a thread and the warps an SM each form should hold,
and the rounds the grid takes, are held against hand-worked values; the
source lists the register builds the wrapper knows, and each is a unit of
compilation of its own.
"""

import re
import sys

import pytest
import torch

from hybrid9_tpu_torch import kernels
from hybrid9_tpu_torch.physics import day_kernel as dk

CELL_COUNTS = [1, 31, 33, 69_630, 69_632, 282_624]


@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("n", CELL_COUNTS)
def test_grid_visits_every_cell_exactly_once(n, block):
    """Thread ``t`` of the grid takes cell ``t`` if ``t < n``: the grid
    has a thread for every cell and no block without one."""
    grid = dk.launch_grid(n, block)
    assert (grid - 1) * block < n <= grid * block
    cells = [t for t in range(grid * block) if t < n]
    assert cells == list(range(n))


@pytest.mark.parametrize("bad", [dict(n=0), dict(block=0), dict(sms=0),
                                 dict(blocks_per_sm=0)])
def test_grid_refuses_nonsense(bad):
    with pytest.raises(ValueError, match=r"must both be\s+>= 1"):
        dk.rounds(**dict(dict(n=64, sms=4, blocks_per_sm=2, block=32),
                         **bad))


# Resident one-warp blocks an SM: the main-path build, a build capped at
# 128 registers, an instance at the register cap.
@pytest.mark.parametrize("blocks_per_sm,want", [
    (17, [1, 1, 1, 1, 1, 4]), (16, [1, 1, 1, 2, 2, 5]),
    (8, [1, 1, 1, 3, 3, 9])])
def test_rounds_on_an_h100(blocks_per_sm, want):
    """17 warps on each of 132 SMs hold the 0.5-degree grid at once; the
    0.25-degree grid takes four rounds."""
    assert [dk.rounds(n, 132, blocks_per_sm, 32)
            for n in CELL_COUNTS] == want


class _Library:
    """Stands where the built library stands: answers ``h9_day_residency``
    with what it was given, and counts the calls."""

    def __init__(self, rc=0, answer=(132, 17, 32, 12_544)):
        self.rc, self.answer, self.calls = rc, answer, 0

    def h9_day_residency(self, itemsize, nl, with_imp, form, out):
        self.calls += 1
        self.form = form
        out[:] = self.answer
        return self.rc


@pytest.fixture
def device_0(monkeypatch):
    """Device 0 is current, and nothing is known of any library yet."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(dk, "_residency", {})


def test_residency_is_asked_once_per_instance(device_0):
    lib = _Library()
    for _ in range(3):
        assert dk.instance_residency(lib, torch.float32, 8, True) == \
            (132, 17, 32, 12_544)
    assert lib.calls == 1
    dk.instance_residency(lib, torch.float32, 8, False)
    assert lib.calls == 2
    # day_kernel_any: once per layer count, apart from the fixed build.
    for nl in (10, 10, 8, 8):
        dk.instance_residency(lib, torch.float32, nl, False, any_nl=True)
    assert lib.calls == 4


@pytest.mark.parametrize("nbytes", [232_448, 232_449])
def test_instance_must_fit_a_blocks_shared_memory(device_0, nbytes):
    lib = _Library(answer=(132, 1, 32, nbytes))
    if nbytes <= dk.SHARED_BYTES_MAX == 232_448:
        assert dk.instance_residency(lib, torch.float64, 20, True)[3] == \
            nbytes
    else:
        with pytest.raises(RuntimeError, match="limit 232448"):
            dk.instance_residency(lib, torch.float64, 20, True)


def test_residency_raises_from_the_return_code(device_0):
    with pytest.raises(RuntimeError, match="error 701"):
        dk.instance_residency(_Library(rc=701), torch.float32, 8, True)


def _tensor(n, nl, dtype=torch.float32):
    return torch.arange(n * nl, dtype=dtype).reshape(n, nl)


@pytest.mark.parametrize("dtype,nl", [(torch.float32, 8), (torch.float32, 20),
                                      (torch.float64, 8), (torch.float64, 20)])
def test_contiguous_tensors_and_slab_views_go_in_as_they_are(dtype, nl):
    x = _tensor(64, nl, dtype)
    dev = x.device
    assert kernels.cell_stride(x, "x", 64, nl, dtype, dev) == nl
    for lo, hi in ((0, 64), (5, 38), (63, 64), (1, 2)):
        view = x[lo:hi]
        assert view.data_ptr() == x.data_ptr() + lo * nl * x.element_size()
        assert kernels.cell_stride(view, "x", hi - lo, nl, dtype, dev) == nl
    flat = x[:, 0]
    assert kernels.cell_stride(flat, "flat", 64, None, dtype, dev) == nl
    assert kernels.cell_stride(flat[3:9], "flat", 6, None, dtype, dev) == nl


def test_rows_of_a_wider_tensor_go_in_if_aligned():
    wide = _tensor(32, 16)
    dev = wide.device
    f32 = torch.float32
    assert kernels.cell_stride(wide[:, :8], "x", 32, 8, f32, dev) == 16
    assert kernels.cell_stride(wide[:, 8:], "x", 32, 8, f32, dev) == 16
    assert kernels.cell_stride(wide[::2, :8], "x", 16, 8, f32, dev) == 32
    with pytest.raises(ValueError, match="16-byte"):
        kernels.cell_stride(wide[:, 1:9], "x", 32, 8, f32, dev)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.cell_stride(_tensor(32, 10)[:, :8], "x", 32, 8, f32, dev)


@pytest.mark.parametrize("make,match", [
    (lambda: _tensor(8, 32).t(), "rows of x are not contiguous"),
    (lambda: _tensor(32, 16)[:, ::2], "rows of x are not contiguous"),
    (lambda: _tensor(32, 8).double(), "expected"),
    (lambda: _tensor(32, 4), "expected"),
    (lambda: _tensor(31, 8), "expected"),
])
def test_views_the_kernel_cannot_read_are_refused(make, match):
    with pytest.raises(ValueError, match=match):
        kernels.cell_stride(make(), "x", 32, 8, torch.float32,
                            torch.device("cpu"))


def test_wrapper_refuses_cpu_tensors_before_anything_else():
    """No fallback: the CUDA wrapper raises on CPU tensors, whatever
    their layout."""
    from hybrid9_tpu_torch.entry import build_reference_case
    case = build_reference_case(32, "float32", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        dk.hydrology_day_cuda(case.state.soil, case.state.veg, case.params,
                              case.forcing, case.geom, case.cfg.dt,
                              case.cfg.nisurf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_layer_counts_go_to_their_instance(dtype):
    """The fixed builds at 8 and 20 layers, ``day_kernel_any`` at every
    other count from 3 up to at least 64 and wherever it is asked for."""
    for nl in dk.FIXED_NLS:
        assert dk.kernel_instance(dtype, nl) == dk.FIXED
        assert dk.kernel_instance(dtype, nl, any_nl=True) != dk.FIXED
    for nl in range(dk.MIN_NL, 65):
        if nl not in dk.FIXED_NLS:
            assert dk.kernel_instance(dtype, nl) != dk.FIXED


# The form of day_kernel_any for each layer count (any_nl at 8 and 20):
# the register build whose range holds it, else the all-shared form.
_ANY_FORMS = {
    torch.float32: [(range(3, 9), 8), (range(9, 11), 10), (range(12, 13), 12),
                    (range(13, 17), 16), ((20, 21, 22, 24), 24),
                    (range(30, 33), 32)],
    torch.float64: [(range(10, 13), 12)]}


@pytest.mark.parametrize("with_imp", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_form_chosen_for_every_layer_count(dtype, with_imp, device_0):
    """Every count from 3 to 64 and the cap, as the wrapper asks the
    library for its residency: the same form with and without imp."""
    lib = _Library()
    for nl in list(range(dk.MIN_NL, 65)) + [dk.layer_cap(dtype)]:
        want = next((cap for counts, cap in _ANY_FORMS[dtype]
                     if nl in counts), dk.ALL_SHARED)
        dk.instance_residency(lib, dtype, nl, with_imp, any_nl=True)
        assert (nl, lib.form) == (nl, want)
        if nl not in dk.FIXED_NLS:
            dk.instance_residency(lib, dtype, nl, with_imp)
            assert (nl, lib.form) == (nl, want)
    assert sorted(dk.any_capacities(dtype)) == \
        [cap for _, cap in _ANY_FORMS[dtype]]


@pytest.mark.parametrize("nl,form,ok", [
    (9, 10, True), (10, 10, True), (11, 10, False), (10, dk.ALL_SHARED, True),
    (10, dk.FIXED, False), (8, dk.FIXED, True), (3, 32, True), (10, 7, False),
    (2_325, dk.ALL_SHARED, False)])
def test_a_form_asked_for_is_checked_against_the_count(nl, form, ok):
    """A register build takes every count up to its capacity (its range
    is only what the wrapper chooses it for); a form without a build, or
    a count it does not take, raises."""
    if ok:
        assert dk.kernel_instance(torch.float32, nl, form=form) == form
    else:
        with pytest.raises(ValueError):
            dk.kernel_instance(torch.float32, nl, form=form)


# (dtype, nl, cells, form, imp) -> (words a thread, warps an SM, rounds),
# worked by hand: a register build's 10 nl - 1 words and a one-warp block
# of them plus the 1,024 bytes the SM reserves, against the SM's 233,472
# bytes; its registers (96 at capacities 8 and 10, 128 at 12, 168 at 16,
# 255 above and in float64) against 16,384 a scheduler; the all-shared
# form's 14 nl - 1 words (nl more with imp) and 8 nl + 4 of geometry a
# block, at 115 and 195 registers.
_RESIDENCY = {
    (torch.float32, 10, 68_608, 10, True): (99, 17, 1),
    (torch.float32, 10, 68_608, 12, True): (99, 16, 2),
    (torch.float32, 10, 68_608, 16, True): (99, 12, 2),
    (torch.float32, 10, 68_608, 24, True): (99, 8, 3),
    (torch.float32, 10, 68_608, 32, True): (99, 8, 3),
    (torch.float32, 10, 68_608, dk.ALL_SHARED, True): (149, 11, 2),
    (torch.float32, 10, 68_608, dk.ALL_SHARED, False): (139, 12, 2),
    (torch.float32, 8, 69_632, 8, True): (79, 20, 1),
    (torch.float32, 8, 69_632, 10, True): (79, 20, 1),
    (torch.float32, 8, 69_632, 12, True): (79, 16, 2),
    (torch.float32, 8, 69_632, 16, True): (79, 12, 2),
    (torch.float32, 8, 69_632, 32, True): (79, 8, 3),
    (torch.float32, 8, 69_632, dk.ALL_SHARED, True): (119, 14, 2),
    (torch.float64, 10, 68_608, 12, True): (99, 8, 3),
    (torch.float64, 10, 68_608, dk.ALL_SHARED, True): (149, 5, 4),
}


@pytest.mark.parametrize("key", list(_RESIDENCY),
                         ids=lambda k: f"{str(k[0])[6:]}-nl{k[1]}-form{k[3]}"
                                       f"-imp{int(k[4])}")
def test_predicted_residency_of_each_form(key):
    """At 10 layers the capacity-10 build holds 17 warps an SM, so the
    10-layer grid's 68,608 cells run in one round (the all-shared form
    holds 11 and takes two); at 8 layers the capacity-8 build holds the
    0.5-degree grid's 69,632 cells in one round too."""
    dtype, nl, n, form, imp = key
    got = dk.any_residency(dtype, nl, form, n, with_imp=imp)
    assert (got["words"], got["warps"], got["rounds"]) == _RESIDENCY[key]
    assert got["warps"] == min(got["warps_by_shared"],
                               got["warps_by_registers"])


def test_the_sources_builds_are_the_wrappers():
    """``H9_ANY_BUILDS`` in the source lists the register builds of
    ``kernels.ANY_BUILDS``, and each has a unit of compilation."""
    text = kernels.DAY_KERNEL_SOURCE.read_text()
    listed = re.search(r"#define H9_ANY_BUILDS\(X\)(.*?)\n\n", text, re.S)
    builds = re.findall(r"X\((\w+), (\d+)\)", listed.group(1))
    assert [(r, int(c)) for r, c in builds] == \
        [(r, c) for r, c, _ in kernels.ANY_BUILDS]
    assert kernels.DAY_KERNEL_UNITS[0] == ()
    assert [u for u in kernels.DAY_KERNEL_UNITS[1:]] == [
        (f"-DH9_ANY_REAL={r}", f"-DH9_ANY_CAP={c}")
        for r, c, _ in kernels.ANY_BUILDS]


def test_the_day_kernel_builds_each_unit_and_links_them(tmp_path, monkeypatch):
    """With a stand-in for nvcc that records its arguments: one ``-c``
    compile a unit, with that unit's macros, and one ``-shared`` link of
    every object into the library, whose name changes with the units."""
    fake = tmp_path / "nvcc"
    log = tmp_path / "calls"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) "
                    "+ '\\n')\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').write('built')\n"
                    "print('ptxas info    : Used 96 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "build_info", {})
    path = kernels.build_day_kernel()
    assert path.read_text() == "built"
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    links = [c for c in calls if "-shared" in c]
    assert len(compiles) == len(kernels.DAY_KERNEL_UNITS) and len(links) == 1
    for unit in kernels.DAY_KERNEL_UNITS:
        assert sum(all(f in c.split() for f in unit) and
                   ("-DH9_ANY_CAP" in c) == bool(unit)
                   for c in compiles) == 1
    assert all(o in links[0] for o in
               [c.split("-o ")[1].split()[0] for c in compiles])
    assert len(kernels.build_info["units"]) == len(kernels.DAY_KERNEL_UNITS)
    assert kernels.build_info["log"].count("Used 96 registers") == \
        len(kernels.DAY_KERNEL_UNITS)
    one = kernels.build("h9day", [kernels.DAY_KERNEL_SOURCE])
    assert one != path


@pytest.mark.parametrize("dtype,cap", [(torch.float32, 2_324),
                                       (torch.float64, 1_161)])
def test_layer_cap_is_where_one_cell_fills_a_block(dtype, cap):
    """The cap is where one cell's vectors filled a one-thread block of
    the all-shared form as it was first laid out (25 words a layer and 8
    with imp), and is kept: the form now holds 23 nl + 3 words there (its
    bands' aquifer row, smp and sy left shared memory), so at the cap it
    fits SHARED_BYTES_MAX with room to spare."""
    item = torch.empty((), dtype=dtype).element_size()
    assert dk.layer_cap(dtype) == cap >= 64
    assert (25 * cap + 8) * item <= dk.SHARED_BYTES_MAX \
        < (25 * (cap + 1) + 8) * item
    words = dk.any_words(cap, dk.ALL_SHARED) + 8 * cap + 4
    assert words == 23 * cap + 3
    assert words * item <= dk.SHARED_BYTES_MAX
    assert dk.kernel_instance(dtype, cap) == dk.ALL_SHARED
    with pytest.raises(ValueError, match=f"above the cap of {cap} layers"):
        dk.kernel_instance(dtype, cap + 1)


@pytest.mark.parametrize("nl", [0, 1, 2])
def test_fewer_than_three_layers_are_refused(nl):
    with pytest.raises(ValueError, match="at least 3 layers"):
        dk.kernel_instance(torch.float32, nl)


def test_a_dtype_without_a_build_is_refused():
    with pytest.raises(ValueError, match="no instance"):
        dk.kernel_instance(torch.float16, 10)


def test_slab_views_of_10_layers_need_no_alignment_for_day_kernel_any():
    """A slab ``x[lo:hi]`` of a ``[n, 10]`` float32 tensor starts on an
    8-byte address when ``lo`` is odd: ``day_kernel_any`` reads it in
    place, a fixed build would refuse it."""
    x = _tensor(64, 10)
    for lo, hi in ((0, 64), (1, 33), (31, 64), (63, 64)):
        view = x[lo:hi]
        assert view.data_ptr() % 16 == (8 if lo % 2 else 0)
        assert kernels.cell_stride(view, "x", hi - lo, 10, torch.float32,
                                   x.device, aligned=False) == 10
        if lo % 2:
            with pytest.raises(ValueError, match="16-byte"):
                kernels.cell_stride(view, "x", hi - lo, 10, torch.float32,
                                    x.device)
    with pytest.raises(ValueError, match="rows of x are not contiguous"):
        kernels.cell_stride(_tensor(64, 20)[:, ::2], "x", 64, 10,
                            torch.float32, x.device, aligned=False)


def test_grid_rounds_and_operations_at_10_layers():
    """The launch geometry does not depend on the layer count; the
    operations of a cell-day at 10 layers with the table below the
    column are 54,662 arithmetic and 1,444 transcendental, 0.0584 ms for
    69,632 cells at 67 TFLOP/s."""
    assert dk.launch_grid(69_632, 32) == 2_176
    assert dk.rounds(69_632, 132, 9, 32) == 2
    arith, trans = dk.day_operations(10, 48, 8, True, 10)
    assert (arith, trans) == (54_662, 1_444)
    jwt = torch.tensor([10, 3, 0])
    a3, t3 = dk.day_operations(10, 48, 8, True, jwt)
    assert int(a3[0]) == arith and int(t3[0]) == trans
    assert bool((a3[1:] < arith).all())
    assert abs((arith + trans) * 69_632 / 67e12 * 1e3 - 0.0584) < 1e-4
