"""The least time the card could take for the hydrology day.

Frozen copies, from commit 4b4e2efbab26aa9d426bea47f8b90395f66dc63b, of
``hybrid9_tpu_torch/physics/day_kernel.py::day_operations`` (operations of
one cell-day counted along a thread's path through ``csrc/day_kernel.cu``)
and of ``chip_smoke.py::day_bound`` (each input read once, each output
written once; the larger of operations over the float32 rate and bytes
over the memory rate).  They stay as they are when the program's kernel
changes, so the work counted is the same whatever implements it.

Where the work depends on where a cell's water table stands, the count
here takes the water table where the day costs least (``least_cell_day``):
the least time is then a bound for any state, read without looking inside
the program.  Over the water-table positions of an 8-layer column at 48
substeps the count varies by 4.5 % (4.1 % at 10 layers).
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): device
# memory and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67.0e12
#: The raw forcing fields the kernel reads.
FORCING_FIELDS = 7


def day_operations(nl: int, nisurf: int, zd09_every: int, with_imp: bool,
                   jwt: int) -> tuple:
    """``(arithmetic, transcendental)`` operations of one cell-day whose
    water table lies below ``jwt`` interfaces at the start of the day
    (``nl``: below the column): every add, subtract, multiply and divide
    once, every ``pow``/``exp`` once; compares, selects, min/max,
    negations and loads left out.  The data-dependent walks count their
    least, one layer; the watmin borrowing counts nothing.  See the
    program's ``day_kernel.day_operations`` at the frozen commit for the
    count by section."""
    below = int(jwt == nl)
    inside = 1 - below
    arith = 92 * nl + 119 + int(with_imp) * (nl + 1) + 60 * below \
        + 33 * inside
    trans = 2 * nl + 2 + 3 * below + inside
    saturated = inside * (nl - 1 - jwt)
    refresh_arith = 1 + 5 * nl + 17 * jwt + 21 * inside + 4 * saturated
    refresh_trans = nl + 3 * jwt + 2 * inside + saturated
    refreshes = -(-nisurf // zd09_every)
    if zd09_every == 1:
        arith, trans = arith + 5, trans + 1
    return (56 + nisurf * arith + refreshes * refresh_arith,
            4 + nisurf * trans + refreshes * refresh_trans)


def day_bytes(nl: int, itemsize: int, with_imp: bool = False) -> int:
    """Bytes of one cell-day read once and written once: the layered
    inputs (water, potential, roots, four soil parameters, the impedance),
    the per-cell inputs (table, aquifer, LAI, litter, fmax, the raw
    forcing, the absorptivity) and the outputs (two layered fields, six
    per-cell values)."""
    layered_in = 7 + int(with_imp)
    flat_in = 5 + FORCING_FIELDS + 1
    return (layered_in * nl + flat_in + 2 * nl + 6) * itemsize


def least_cell_day(nl: int, nisurf: int, zd09_every: int, itemsize: int,
                   with_imp: bool = False) -> dict:
    """The least seconds one cell-day can take on the card, with what
    bounds it and the counts."""
    ops = min(sum(day_operations(nl, nisurf, zd09_every, with_imp, jwt))
              for jwt in range(nl + 1))
    nbytes = day_bytes(nl, itemsize, with_imp)
    ops_s = ops / PEAK_F32_OPS_PER_S
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return dict(seconds=max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                operations=ops, bytes=nbytes)
