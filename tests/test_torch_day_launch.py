"""What the CUDA day kernel's wrapper decides in Python, on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Its launch geometry, what it refuses of an instance and
which tensors it accepts are pure functions of ``physics/day_kernel.py``
and are held here: the grid, a block per 32 cells and a cell a thread,
covers every cell exactly once for cell counts around a warp, around the
0.5-degree grid and at the 0.25-degree grid; the main-path build holds
the 0.5-degree grid in one round; an instance that wants more shared
memory than a block may use is refused; slab views go in without a copy
and anything else raises.
"""

import pytest
import torch

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

    def h9_day_residency(self, itemsize, nl, with_imp, out):
        self.calls += 1
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
    assert dk.cell_stride(x, "x", 64, nl, dtype, dev) == nl
    for lo, hi in ((0, 64), (5, 38), (63, 64), (1, 2)):
        view = x[lo:hi]
        assert view.data_ptr() == x.data_ptr() + lo * nl * x.element_size()
        assert dk.cell_stride(view, "x", hi - lo, nl, dtype, dev) == nl
    flat = x[:, 0]
    assert dk.cell_stride(flat, "flat", 64, None, dtype, dev) == nl
    assert dk.cell_stride(flat[3:9], "flat", 6, None, dtype, dev) == nl


def test_rows_of_a_wider_tensor_go_in_if_aligned():
    wide = _tensor(32, 16)
    dev = wide.device
    assert dk.cell_stride(wide[:, :8], "x", 32, 8, torch.float32, dev) == 16
    assert dk.cell_stride(wide[:, 8:], "x", 32, 8, torch.float32, dev) == 16
    assert dk.cell_stride(wide[::2, :8], "x", 16, 8, torch.float32, dev) == 32
    with pytest.raises(ValueError, match="16-byte"):
        dk.cell_stride(wide[:, 1:9], "x", 32, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="16-byte"):
        dk.cell_stride(_tensor(32, 10)[:, :8], "x", 32, 8, torch.float32, dev)


@pytest.mark.parametrize("make,match", [
    (lambda: _tensor(8, 32).t(), "rows of x are not contiguous"),
    (lambda: _tensor(32, 16)[:, ::2], "rows of x are not contiguous"),
    (lambda: _tensor(32, 8).double(), "expected"),
    (lambda: _tensor(32, 4), "expected"),
    (lambda: _tensor(31, 8), "expected"),
])
def test_views_the_kernel_cannot_read_are_refused(make, match):
    with pytest.raises(ValueError, match=match):
        dk.cell_stride(make(), "x", 32, 8, torch.float32, torch.device("cpu"))


def test_wrapper_refuses_cpu_tensors_before_anything_else():
    """No fallback: the CUDA wrapper raises on CPU tensors, whatever
    their layout."""
    from hybrid9_tpu_torch.entry import build_reference_case
    case = build_reference_case(32, "float32", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        dk.hydrology_day_cuda(case.state.soil, case.state.veg, case.params,
                              case.forcing, case.geom, case.cfg.dt,
                              case.cfg.nisurf)
