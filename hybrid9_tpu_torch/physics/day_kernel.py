"""One model day of hydrology: the CUDA day kernel and its plain twin.

Port of ``hybrid9_tpu/physics/pallas_day.py``.  The TPU ran the day's
``nisurf`` substeps as one Pallas kernel over VMEM-resident cell blocks;
here ``csrc/day_kernel.cu`` runs them with one CUDA thread per cell, and
``hydrology_day_plain`` is the same loop in plain torch (the port of
``step._xla_day_substeps``).  ``hydrology_day`` dispatches: CUDA tensors
go to the kernel, CPU tensors to the twin, with no fallback between them.

What bounds the kernel on an H100 is waiting on a cell's long dependent
chain, then instruction fetch and dispatch (see the note at the head of the
source).  Its design answers with residency and small code: blocks of
one warp, the 0.5-degree grid's 2,176 warps resident at once (17 on each
of 132 SMs at 96 registers a thread), the layer loops kept as loops over
vectors in shared memory, and the state read and written ``[n, nl]`` as
the model holds it, so that a day is one launch.  What the wrapper
decides on the host is plain Python here and tested on the CPU: the
grid (:func:`launch_grid`), the tensors it accepts (:func:`cell_stride`)
and what it refuses of an instance (:func:`instance_residency`).

``hydrology_day_sharded`` is the port of
``pallas_hydrology_day_sharded``: it cuts the cell axis into one slab
per entry of a device list and runs the same day on each slab's device.

Reference: the NISURF loop at SOURCE/HYBRID9.f90:193-211.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..state import Forcing, SoilParams, SoilState, VegState
from .drainage import compute_specific_yields
from .et import daily_et_context
from .hydrology import Geometry, derive_forcing, substep_values
from .layers import stack, unstack
from .soilwater import compute_equilibrium_zq

# Layer counts and dtypes the kernel is instantiated for.
KERNEL_NLS = (8, 20)
KERNEL_DTYPES = (torch.float32, torch.float64)

#: Number of CUDA day-kernel launches in this process.
launches = 0

DayResult = Tuple[SoilState, Dict[str, torch.Tensor]]


def hydrology_day_plain(soil: SoilState, veg: VegState, params: SoilParams,
                        forcing: Forcing, geom: Geometry, dt: float,
                        nisurf: int, imp: Optional[torch.Tensor] = None,
                        zd09_every: int = 1,
                        sw_abs: Optional[torch.Tensor] = None) -> DayResult:
    """``nisurf`` hydrology substeps in plain torch.

    With ``zd09_every > 1`` the ZD09 and specific-yield profiles are
    refreshed when ``it % zd09_every == 0`` (from ``it = 0``; the counter
    restarts each day), as in the JAX package.  ``imp`` is the optional
    ``[n, nl]`` frozen-soil impedance and ``sw_abs`` the optional ``[n]``
    shortwave absorptivity (0.92 without it).  Returns the new
    SoilState and the daily sums ``evap_day``, ``evap_grnd_day``,
    ``rnf_day`` (mm) and ``max_abs_residual`` (mm).
    """
    fd = derive_forcing(forcing, sw_abs)
    et_ctx = daily_et_context(fd, veg.lai)
    h, smp = unstack(soil.h2osoi_liq), unstack(soil.smp)
    zwt, wa = soil.zwt, soil.wa
    rootr = unstack(veg.rootr)
    p_ts, p_hk, p_ps, p_bs = (unstack(params.theta_s),
                              unstack(params.hksat),
                              unstack(params.psi_s), unstack(params.bsw))
    imp_l = None if imp is None else unstack(imp)
    evap = evap_grnd = rnf = max_res = torch.zeros_like(zwt)
    zq = sy = None
    for it in range(nisurf):
        if zd09_every > 1 and it % zd09_every == 0:
            zq = compute_equilibrium_zq(zwt, p_ts, p_ps, p_bs, geom.zi)
            sy = compute_specific_yields(zwt, p_ts, p_ps, p_bs)
        out = substep_values(h, smp, zwt, wa, rootr, veg.lai,
                             veg.lai_litter, p_ts, p_hk, p_ps, p_bs,
                             params.fmax, fd, geom, dt, imp=imp_l, zq=zq,
                             et_ctx=et_ctx, sy=sy)
        h, smp, zwt, wa = out["h"], out["smp"], out["zwt"], out["wa"]
        evap = evap + (out["qflx_evap_grnd"] + out["qflx_tran_veg"]) * dt
        evap_grnd = evap_grnd + out["qflx_evap_grnd"] * dt
        rnf = rnf + (out["qflx_surf"] + out["rsub_top"]) * dt
        max_res = torch.maximum(max_res, torch.abs(out["residual"]))
    new_soil = SoilState(h2osoi_liq=stack(h), zwt=zwt, wa=wa,
                         smp=stack(smp), h2osoi_liq_ma=soil.h2osoi_liq_ma)
    return new_soil, dict(evap_day=evap, evap_grnd_day=evap_grnd,
                          rnf_day=rnf, max_abs_residual=max_res)


def day_operations(nl: int, nisurf: int, zd09_every: int, with_imp: bool,
                   jwt):
    """``(arithmetic, transcendental)`` operations of one cell-day of
    ``csrc/day_kernel.cu``, counted from its source along the path a
    thread takes: every add, subtract, multiply and divide once, every
    ``pow``/``exp`` once; compares, selects, min/max, negations and loads
    are left out, and so is the side of a branch the thread does not keep.
    ``jwt`` is the cell's number of layer interfaces above its water table
    at the start of the day (``nl``: table below the column), an int or an
    integer tensor.  The data-dependent walks (drainage, baseflow) count
    their least, one layer; the watmin borrowing counts nothing.

    By section of the kernel, with ``L = nl``:

    - once a day, ``daily_et_context``: 56 and 4;
    - per substep, common to all cells: ``92 L + 119`` and ``2 L + 2``:
      theta and the column sum ``2 L + 2``; saturated fraction 3 (1 exp);
      ``dual_source_et`` ``5 L + 114``; infiltration 7; conductivities and
      potentials ``20 L`` (2 pow a layer); tridiagonal rows
      ``31 (L - 2) + 32``; the refined Thomas solve on ``L + 1`` unknowns
      ``23 L + 5``; the water update ``2 L``; drainage and baseflow heads 5
      (1 exp); bucket cascade ``3 L``; bottom-layer search ``5 L - 2``;
      residual and daily sums ``L + 15``;
    - the impedance operand: ``L + 1`` multiplies per substep;
    - table below the column: aquifer potential, aquifer row, recharge,
      drainage and baseflow, 60 and 3 per substep; table in the column:
      33 and 1;
    - per refresh of the ZD09 and specific-yield profiles (every substep
      at ``zd09_every=1``, else every ``zd09_every`` substeps from the
      first): ``1 + 5 L`` and ``L`` for the yields, and per layer of the
      equilibrium profile 17 and 3 above the table, 21 and 2 around it,
      4 and 1 below it;
    - at ``zd09_every=1`` baseflow takes a fresh bottom yield: 5 and 1 per
      substep.
    """
    below = (jwt == nl) * 1
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


SHARED_BYTES_MAX = 232_448    # dynamic shared memory one block may use
# Raw-forcing field order of the kernel's input list.
_FORCING_KEYS = ("tas", "rhs", "rsds", "rlds", "pr", "huss", "ps")

_residency: Dict[tuple, tuple] = {}


def launch_grid(n: int, block: int) -> int:
    """Blocks of the day kernel's launch for ``n`` cells: a block per
    ``block`` cells, one cell a thread, the last block's tail masked.
    The hardware hands the blocks out as earlier ones finish, which evens
    out cells of unequal cost (frozen columns take half as long again)."""
    if min(n, block) < 1:
        raise ValueError(f"launch_grid: n={n}, block={block} must both be "
                         f">= 1")
    return -(-n // block)


def rounds(n: int, sms: int, blocks_per_sm: int, block: int) -> int:
    """Rounds of resident blocks that ``n`` cells need on a card of
    ``sms`` SMs that each hold ``blocks_per_sm`` blocks of ``block``
    threads: 1 when the card holds the whole grid at once."""
    if min(sms, blocks_per_sm) < 1:
        raise ValueError(f"rounds: sms={sms}, blocks_per_sm={blocks_per_sm} "
                         f"must both be >= 1")
    return -(-launch_grid(n, block) // (sms * blocks_per_sm))


def cell_stride(x: torch.Tensor, name: str, n: int, nl: Optional[int],
                dtype, device) -> int:
    """Elements from one cell of ``x`` to the next, for the kernel.  ``x``
    is ``[n]`` (``nl=None``; any stride) or ``[n, nl]`` with contiguous
    rows that start on 16-byte addresses: a contiguous tensor, or a view
    such as ``y[lo:hi]`` of one.  Raises on anything else; nothing is
    copied."""
    shape = (n,) if nl is None else (n, nl)
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(
            f"day kernel: {name} is {tuple(x.shape)} {x.dtype} on "
            f"{x.device}; expected {shape} {dtype} on {device}")
    stride = x.stride(0) if n > 1 else (nl or 1)
    if not 0 <= stride < 2 ** 31:
        raise ValueError(f"day kernel: {name} has cell stride {stride}")
    if nl is not None:
        if nl > 1 and x.stride(1) != 1:
            raise ValueError(
                f"day kernel: the rows of {name} are not contiguous "
                f"(strides {x.stride()}); pass [n, nl] as the model holds "
                f"it")
        item = x.element_size()
        if x.data_ptr() % 16 or (stride * item) % 16:
            raise ValueError(
                f"day kernel: the rows of {name} do not start on 16-byte "
                f"addresses (offset {x.data_ptr() % 16}, cell stride "
                f"{stride * item} bytes)")
    return stride


def instance_residency(lib, dtype, nl: int, with_imp: bool):
    """``(sms, blocks_per_sm, block, shared bytes a block)`` of a kernel
    instance on the current CUDA device, asked of the library once per
    device and instance.  Raises if the library has no such instance, if
    the device refuses it, or if it wants more shared memory than a block
    may use."""
    key = (id(lib), torch.cuda.current_device(), dtype, nl, with_imp)
    if key not in _residency:
        out = (ctypes.c_int * 4)()
        rc = lib.h9_day_residency(dtype.itemsize, nl, int(with_imp), out)
        if rc != 0:
            raise RuntimeError(
                f"day kernel: no residency for {dtype}, nl={nl}, "
                f"imp={with_imp} on device {key[1]}: error {rc}")
        sms, blocks_per_sm, block, nbytes = out
        if nbytes > SHARED_BYTES_MAX:
            raise RuntimeError(
                f"day kernel: instance {dtype}, nl={nl}, imp={with_imp} "
                f"uses {nbytes} bytes of shared memory a block; limit "
                f"{SHARED_BYTES_MAX}")
        _residency[key] = (sms, blocks_per_sm, block, nbytes)
    return _residency[key]


def hydrology_day_cuda(soil: SoilState, veg: VegState, params: SoilParams,
                       forcing: Forcing, geom: Geometry, dt: float,
                       nisurf: int, imp: Optional[torch.Tensor] = None,
                       zd09_every: int = 1,
                       sw_abs: Optional[torch.Tensor] = None) -> DayResult:
    """The same day as :func:`hydrology_day_plain`, as ONE launch of the
    CUDA day kernel (``csrc/day_kernel.cu``) on the current stream, and
    nothing else on the device: no transpose, no copy, no small kernel.

    The kernel takes the state as the model holds it: layered fields
    ``[n, nl]``, contiguous or slab views ``x[lo:hi]`` (see
    :func:`cell_stride`; anything else raises), and the raw forcing, from
    which it forms ``derive_forcing``'s fields itself, bitwise.  The grid
    is :func:`launch_grid`'s, for the block of the instance
    (:func:`instance_residency`).
    """
    global launches
    h = soil.h2osoi_liq
    n, nl = h.shape
    dtype, device = h.dtype, h.device
    if device.type != "cuda":
        raise ValueError(f"day kernel needs CUDA tensors, got {device}")
    if dtype not in KERNEL_DTYPES or nl not in KERNEL_NLS:
        raise ValueError(f"day kernel has no instance for {dtype}, "
                         f"nl={nl} (has {KERNEL_DTYPES} x {KERNEL_NLS})")
    if n < 1 or nisurf < 1 or zd09_every < 1:
        raise ValueError(f"day kernel: n={n}, nisurf={nisurf}, "
                         f"zd09_every={zd09_every} must all be >= 1")
    if (len(geom.zi), len(geom.dz_soil), len(geom.zc_soil)) != \
            (nl + 2, nl, nl):
        raise ValueError(f"day kernel: geometry does not have nl={nl}")

    # In the order of the kernel's I_* slots; (name, tensor, layered).
    ins = [("h2osoi_liq", h, True), ("smp", soil.smp, True),
           ("zwt", soil.zwt, False), ("wa", soil.wa, False),
           ("rootr", veg.rootr, True), ("lai", veg.lai, False),
           ("lai_litter", veg.lai_litter, False),
           ("theta_s", params.theta_s, True), ("hksat", params.hksat, True),
           ("psi_s", params.psi_s, True), ("bsw", params.bsw, True),
           ("fmax", params.fmax, False), ("imp", imp, True)] + \
          [(k, getattr(forcing, k), False) for k in _FORCING_KEYS] + \
          [("sw_abs", sw_abs, False)]
    strides = [0 if x is None else
               cell_stride(x, name, n, nl if layered else None, dtype,
                           device) for name, x, layered in ins]
    outs = [torch.empty((n, nl), dtype=dtype, device=device)
            for _ in range(2)] + \
           [torch.empty((n,), dtype=dtype, device=device) for _ in range(6)]
    geom_host = np.asarray(geom.zi + geom.dz_soil + geom.zc_soil,
                           dtype=np.float64)
    in_ptrs = (ctypes.c_void_p * len(ins))(
        *[None if x is None else x.data_ptr() for _, x, _ in ins])
    in_strides = (ctypes.c_int * len(ins))(*strides)
    out_ptrs = (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs])

    lib = kernels.day_kernel_lib()
    with torch.cuda.device(device):
        _, _, block, _ = instance_residency(lib, dtype, nl, imp is not None)
        grid = launch_grid(n, block)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.h9_hydrology_day(
            dtype.itemsize, nl, int(imp is not None), in_ptrs, in_strides,
            out_ptrs, n, grid, nisurf, zd09_every, float(dt),
            geom_host.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"day kernel launch failed: CUDA error {rc}")
    launches += 1

    h_new, smp_new, zwt, wa, evap, evap_grnd, rnf, max_res = outs
    new_soil = SoilState(h2osoi_liq=h_new, zwt=zwt, wa=wa, smp=smp_new,
                         h2osoi_liq_ma=soil.h2osoi_liq_ma)
    return new_soil, dict(evap_day=evap, evap_grnd_day=evap_grnd,
                          rnf_day=rnf, max_abs_residual=max_res)


def hydrology_day(soil: SoilState, veg: VegState, params: SoilParams,
                  forcing: Forcing, geom: Geometry, dt: float, nisurf: int,
                  imp: Optional[torch.Tensor] = None, zd09_every: int = 1,
                  use_kernel: Optional[bool] = None,
                  sw_abs: Optional[torch.Tensor] = None) -> DayResult:
    """One hydrology day: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors.  ``use_kernel=True`` demands the kernel and
    raises on CPU tensors; ``use_kernel=False`` takes the twin."""
    day = _day_function(soil, use_kernel)
    return day(soil, veg, params, forcing, geom, dt, nisurf, imp=imp,
               zd09_every=zd09_every, sw_abs=sw_abs)


def _day_function(soil: SoilState, use_kernel: Optional[bool]):
    """The kernel wrapper or the plain twin, by ``use_kernel`` and the
    device of ``soil``."""
    on_cuda = soil.h2osoi_liq.is_cuda
    if use_kernel is None:
        use_kernel = on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the day "
                         "kernel has no CPU form")
    return hydrology_day_cuda if use_kernel else hydrology_day_plain


def slab_bounds(n: int, k: int) -> list:
    """``k`` contiguous ``(lo, hi)`` slabs of a cell axis of length ``n``:
    every slab gets ``n // k`` cells and the last ``n % k`` slabs one
    more."""
    if k < 1 or n < k:
        raise ValueError(f"cannot cut {n} cells into {k} slabs")
    base, extra = divmod(n, k)
    edges = [i * base + max(0, i - (k - extra)) for i in range(k + 1)]
    return list(zip(edges[:-1], edges[1:]))


def hydrology_day_sharded(soil: SoilState, veg: VegState,
                          params: SoilParams, forcing: Forcing,
                          geom: Geometry, dt: float, nisurf: int,
                          devices: Sequence,
                          imp: Optional[torch.Tensor] = None,
                          zd09_every: int = 1,
                          sw_abs: Optional[torch.Tensor] = None,
                          use_kernel: Optional[bool] = None) -> DayResult:
    """One hydrology day with the cell axis cut over a list of devices.

    ``devices`` stands where the JAX package's 1-D mesh stood: the cell
    axis is cut into ``len(devices)`` contiguous slabs
    (:func:`slab_bounds`; the kernel masks a ragged tail, so the cell
    count need not divide), every operand is split on its leading axis,
    and slab ``i``'s day is one launch of the CUDA day kernel on
    ``devices[i]`` (the plain twin with ``use_kernel=False`` or on CPU
    tensors; which of the two is settled once, from the device of the
    inputs, and a device of another type than theirs raises, so no slab
    is moved to the host behind the caller).  The physics is cell-local
    and a thread owns one cell, so the result is bitwise that of the
    unsharded day.  There is no
    collective and no host synchronisation between the slab launches.  A
    device may appear more than once, which lets one card exercise the
    slabbing.  A slab whose device is that of the inputs is a view of
    them; any other slab is copied to its device and its result copied
    back, so the whole result lies on the device of the inputs.  One
    process drives all the devices it is given; the ranks of a
    multi-process run each call this with their local devices on their
    own cells.

    Replaces the TPU path ``pallas_hydrology_day_sharded`` (a
    ``shard_map`` of the Pallas day kernel over a 1-D mesh).  What bounds
    it is what bounds the kernel, a cell's dependent chain, plus what
    slabbing adds: on ONE card the slabs run one after another on one
    stream, and a quarter of the grid (one warp a scheduler) takes two
    thirds of the time of the whole.  Four slabs of 69,632 cells on one
    NVIDIA H100 80GB HBM3 (700 W) take 3.65-3.68 ms against 1.58 ms
    unsharded and 1.61 ms for one slab (``chip_smoke.py``, winter state); slabs on
    different cards can overlap, since nothing here waits for a launch.
    A slab is a view ``x[lo:hi]`` that the kernel reads in place.
    """
    devices = [torch.device(d) for d in devices]
    home = soil.h2osoi_liq.device
    strangers = [str(d) for d in devices if d.type != home.type]
    if strangers:
        raise ValueError(f"sharded day: inputs on {home} cannot be cut over "
                         f"{strangers}; every device must be a {home.type} "
                         f"device")
    day = _day_function(soil, use_kernel)
    n = soil.h2osoi_liq.shape[0]
    results = []
    for dev, (lo, hi) in zip(devices, slab_bounds(n, len(devices))):
        def cut(x):
            return x[lo:hi].to(dev)

        results.append(day(
            soil.map(cut), veg.map(cut), params.map(cut), forcing.map(cut),
            geom, dt, nisurf, imp=None if imp is None else cut(imp),
            zd09_every=zd09_every,
            sw_abs=None if sw_abs is None else cut(sw_abs)))

    def whole(parts):
        return torch.cat([x.to(home) for x in parts])

    soils = [r[0] for r in results]
    new_soil = SoilState(**{
        f: whole([getattr(s, f) for s in soils])
        for f in ("h2osoi_liq", "zwt", "wa", "smp")},
        h2osoi_liq_ma=soil.h2osoi_liq_ma)
    diags = {k: whole([r[1][k] for r in results]) for k in results[0][1]}
    return new_soil, diags
