"""One model day of hydrology: the CUDA day kernel and its plain twin.

Port of ``hybrid9_tpu/physics/pallas_day.py``.  The TPU ran the day's
``nisurf`` substeps as one Pallas kernel over VMEM-resident cell blocks;
here ``csrc/day_kernel.cu`` runs them with one CUDA thread per cell and
the column in registers, and ``hydrology_day_plain`` is the same loop in
plain torch (the port of ``step._xla_day_substeps``).  ``hydrology_day``
dispatches: CUDA tensors go to the kernel, CPU tensors to the twin, with
no fallback between them.

Reference: the NISURF loop at SOURCE/HYBRID9.f90:193-211.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..state import Forcing, SoilParams, SoilState, VegState
from .drainage import compute_specific_yields
from .et import daily_et_context
from .hydrology import Geometry, derive_forcing, substep_values
from .layers import stack, unstack
from .soilwater import compute_equilibrium_zq

# Derived-forcing field order of the kernel's input list.
_FD_KEYS = ("tak", "rh", "rnet", "par", "forc_rain", "lamb", "huss", "ps")
# Layer counts and dtypes the kernel is instantiated for.
KERNEL_NLS = (8, 20)
KERNEL_DTYPES = (torch.float32, torch.float64)

#: Number of CUDA day-kernel launches in this process.
launches = 0

DayResult = Tuple[SoilState, Dict[str, torch.Tensor]]


def hydrology_day_plain(soil: SoilState, veg: VegState, params: SoilParams,
                        forcing: Forcing, geom: Geometry, dt: float,
                        nisurf: int, imp: Optional[torch.Tensor] = None,
                        zd09_every: int = 1) -> DayResult:
    """``nisurf`` hydrology substeps in plain torch.

    With ``zd09_every > 1`` the ZD09 and specific-yield profiles are
    refreshed when ``it % zd09_every == 0`` (from ``it = 0``; the counter
    restarts each day), as in the JAX package.  Returns the new
    SoilState and the daily sums ``evap_day``, ``evap_grnd_day``,
    ``rnf_day`` (mm) and ``max_abs_residual`` (mm).
    """
    fd = derive_forcing(forcing)
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


def _check(x: torch.Tensor, name: str, shape, dtype, device) -> None:
    if x.shape != shape or x.dtype != dtype or x.device != device:
        raise ValueError(
            f"day kernel: {name} is {tuple(x.shape)} {x.dtype} on "
            f"{x.device}; expected {tuple(shape)} {dtype} on {device}")


def hydrology_day_cuda(soil: SoilState, veg: VegState, params: SoilParams,
                       forcing: Forcing, geom: Geometry, dt: float,
                       nisurf: int, imp: Optional[torch.Tensor] = None,
                       zd09_every: int = 1) -> DayResult:
    """The same day as :func:`hydrology_day_plain`, as one launch of the
    CUDA day kernel (``csrc/day_kernel.cu``) on the current stream.

    Layered fields go in and out layer-major (``[nl, n]``), so that
    neighbouring threads touch neighbouring addresses.  Raises on
    anything the kernel does not take.
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
    fd = derive_forcing(forcing)

    layered = dict(h2osoi_liq=h, smp=soil.smp, rootr=veg.rootr,
                   theta_s=params.theta_s, hksat=params.hksat,
                   psi_s=params.psi_s, bsw=params.bsw)
    if imp is not None:
        layered["imp"] = imp
    flat = dict(zwt=soil.zwt, wa=soil.wa, lai=veg.lai,
                lai_litter=veg.lai_litter, fmax=params.fmax,
                **{k: fd[k] for k in _FD_KEYS})
    for name, x in layered.items():
        _check(x, name, (n, nl), dtype, device)
    for name, x in flat.items():
        _check(x, name, (n,), dtype, device)

    lay = {k: x.t().contiguous() for k, x in layered.items()}
    flt = {k: x.contiguous() for k, x in flat.items()}
    ins = [lay["h2osoi_liq"], lay["smp"], flt["zwt"], flt["wa"],
           lay["rootr"], flt["lai"], flt["lai_litter"], lay["theta_s"],
           lay["hksat"], lay["psi_s"], lay["bsw"], flt["fmax"],
           lay.get("imp")] + [flt[k] for k in _FD_KEYS]
    outs = [torch.empty((nl, n), dtype=dtype, device=device)
            for _ in range(2)] + \
           [torch.empty((n,), dtype=dtype, device=device) for _ in range(6)]
    geom_host = np.asarray(geom.zi + geom.dz_soil + geom.zc_soil,
                           dtype=np.float64)
    in_ptrs = (ctypes.c_void_p * len(ins))(
        *[None if x is None else x.data_ptr() for x in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs])

    lib = kernels.day_kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.h9_hydrology_day(
            dtype.itemsize, nl, int(imp is not None), in_ptrs, out_ptrs,
            n, nisurf, zd09_every, float(dt),
            geom_host.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"day kernel launch failed: CUDA error {rc}")
    launches += 1

    h_t, smp_t, zwt, wa, evap, evap_grnd, rnf, max_res = outs
    new_soil = SoilState(h2osoi_liq=h_t.t().contiguous(), zwt=zwt, wa=wa,
                         smp=smp_t.t().contiguous(),
                         h2osoi_liq_ma=soil.h2osoi_liq_ma)
    return new_soil, dict(evap_day=evap, evap_grnd_day=evap_grnd,
                          rnf_day=rnf, max_abs_residual=max_res)


def hydrology_day(soil: SoilState, veg: VegState, params: SoilParams,
                  forcing: Forcing, geom: Geometry, dt: float, nisurf: int,
                  imp: Optional[torch.Tensor] = None, zd09_every: int = 1,
                  use_kernel: Optional[bool] = None) -> DayResult:
    """One hydrology day: the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors.  ``use_kernel=True`` demands the kernel and
    raises on CPU tensors; ``use_kernel=False`` takes the twin."""
    on_cuda = soil.h2osoi_liq.is_cuda
    if use_kernel is None:
        use_kernel = on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the day "
                         "kernel has no CPU form")
    day = hydrology_day_cuda if use_kernel else hydrology_day_plain
    return day(soil, veg, params, forcing, geom, dt, nisurf, imp=imp,
               zd09_every=zd09_every)
