"""One model day of soil heat: the CUDA soil-heat kernel and its plain twin.

The JAX package's ``step._soil_thermal`` is plain jnp, which XLA fuses
into a few loops over the cells.  Here ``csrc/soil_heat.cu`` runs the
whole step, one CUDA thread a cell and one launch a day, and
:func:`soil_heat_plain` is the same step in plain torch: the surface
forcing, ``soiltemp.soil_temperature_step`` and, with the ice store,
``soiltemp.phase_change``.  :func:`soil_heat` dispatches as the hydrology
day does: CUDA tensors go to the kernel, CPU tensors to the twin, with no
fallback between them (``kernels.kernel_wanted``); ``use_kernel=False``
takes the twin on either (the fit differentiates it).

The kernel is bound by bytes (:func:`cell_bytes`).  It reads each input
once and keeps the column on the chip: in registers on the builds by layer
capacity (``CAPACITIES``), in a scratch tensor above the largest
(:func:`capacity`).  What the wrapper decides on the host is plain Python
and tested on the CPU: the build, the geometry it passes
(:func:`geometry`), and what it refuses (``kernels.cell_stride``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils import profiling
from . import bounds
from . import constants as c
from .day_kernel import KERNEL_DTYPES, MIN_NL, layer_cap
from .layers import layer_tensor
from .soiltemp import phase_change, soil_temperature_step

#: Layer capacities of the kernel's register builds; a count above the
#: largest runs on the form with a run-time count (``ANY``).
CAPACITIES = (8, 16, 32)
ANY = 0

#: Number of CUDA soil-heat launches in this process.
launches = 0

HeatResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def volumetric_water(h2osoi: torch.Tensor, dz_soil) -> torch.Tensor:
    """Volumetric water content ``[n, nl]`` of ``h2osoi`` (mm)."""
    dz = layer_tensor(dz_soil, h2osoi.dtype, h2osoi.device)
    return h2osoi / (dz[None, :] * c.RHOW / 1.0e3)


def soil_heat_plain(t_soil, liq, ice, theta_s, lai, forcing, geom,
                    dt: float, soil_ice: bool, latent_ramp: float,
                    sw_abs: Optional[torch.Tensor] = None) -> HeatResult:
    """The daily implicit soil-heat step in plain torch.

    The SW85 ground heat flux G = 0.2 * Rnet * exp(-0.7 * LAI) from the
    day-start ``lai`` (HYDROLOGY.f90:335-339) and an implicit sensible
    exchange through the aerodynamic resistance raa drive
    ``soil_temperature_step`` over ``t_soil`` (``[n, nl]``, K); theta is
    the liquid water ``liq`` (mm), plus the ``ice`` store with
    ``soil_ice``, over the layers of ``geom``.  ``latent_ramp`` > 0 adds
    the apparent-capacity freezing band; with ``soil_ice`` the explicit
    ``phase_change`` then exchanges sensible heat for ice mass.
    ``forcing`` gives ``tas``, ``rsds``, ``rlds`` and ``ps``, ``sw_abs``
    the ``[n]`` shortwave absorptivity (0.92 without it).  Returns
    ``(t_soil, liq, ice)``; without ``soil_ice`` ``liq`` and ``ice`` are
    the inputs."""
    tas = forcing.tas
    a = 0.92 if sw_abs is None else sw_abs
    t2 = tas * tas              # tas ** 4 as JAX's integer_pow forms it
    rnet = a * forcing.rsds + forcing.rlds - c.STBO * (t2 * t2)
    g_flux = 0.2 * rnet * torch.exp(-0.7 * lai)
    raa = torch.where(lai <= 4.0,
                      0.25 * lai * 42.0 + 0.25 * (4.0 - lai) * 34.0, 42.0)
    rho_air = forcing.ps / (c.RGAS * tas)
    h_surf = rho_air * c.CP_AIR / bounds.maximum(raa, 1.0)
    water = liq + ice if soil_ice else liq
    t_new = soil_temperature_step(
        t_soil, volumetric_water(water, geom.dz_soil), theta_s, g_flux,
        geom.dz_soil, geom.zc_soil, dt, t_air=tas, h_surf=h_surf,
        latent_ramp=latent_ramp)
    if not soil_ice:
        return t_new, liq, ice
    return phase_change(t_new, liq, ice, theta_s, geom.dz_soil)


def capacity(dtype, nl: int) -> int:
    """The build that runs ``nl`` layers in ``dtype``: the least of
    ``CAPACITIES`` that holds them, else ``ANY``.  Raises ``ValueError``
    on a dtype or a layer count the day kernel does not take
    (``day_kernel.KERNEL_DTYPES``, ``MIN_NL`` to ``layer_cap``)."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"soil-heat kernel has no instance for {dtype} "
                         f"(has {KERNEL_DTYPES})")
    if not MIN_NL <= nl <= layer_cap(dtype):
        raise ValueError(f"soil-heat kernel: nl={nl}; it takes the day "
                         f"kernel's {MIN_NL} to {layer_cap(dtype)} layers "
                         f"in {dtype}")
    return next((cap for cap in CAPACITIES if nl <= cap), ANY)


def instance_name(cap: int) -> str:
    """The ``instance`` a launch gives the ``day.soil_heat`` span."""
    if cap == ANY:
        return "soil_heat_kernel any"
    return f"soil_heat_kernel capacity {cap}"


@functools.lru_cache(maxsize=None)
def geometry(dz_soil: tuple, zc_soil: tuple) -> tuple:
    """The kernel's geometry, ``3 nl`` Python floats: the layer
    thicknesses in mm, the same in m, and the reciprocal of the distance
    in m from each node to the next (0 below the last), each folded in
    double as ``soil_temperature_step`` folds it.  PyTorch divides a CUDA
    tensor by a Python scalar as a multiply by the scalar's reciprocal,
    taken in double and rounded once, so the kernel takes the
    reciprocal."""
    nl = len(dz_soil)
    zc = [z / 1000.0 for z in zc_soil]
    inv_gaps = [1.0 / (zc[i + 1] - zc[i]) for i in range(nl - 1)] + [0.0]
    return (tuple(float(d) for d in dz_soil)
            + tuple(d / 1000.0 for d in dz_soil) + tuple(inv_gaps))


def cell_bytes(nl: int, itemsize: int, soil_ice: bool,
               with_sw_abs: bool) -> int:
    """Bytes one cell-day of the kernel reads and writes at least: the
    temperature, liquid-water and porosity rows (and the ice row), the
    five surface fields (and ``sw_abs``) in; the temperature row (and the
    water and ice rows) out."""
    rows_in = 3 + int(soil_ice)
    rows_out = 1 + 2 * int(soil_ice)
    fields = 5 + int(with_sw_abs)
    return itemsize * ((rows_in + rows_out) * nl + fields)


def soil_heat_cuda(t_soil, liq, ice, theta_s, lai, forcing, geom,
                   dt: float, soil_ice: bool, latent_ramp: float,
                   sw_abs: Optional[torch.Tensor] = None) -> HeatResult:
    """:func:`soil_heat_plain` as ONE launch of ``csrc/soil_heat.cu`` on
    the current stream, and nothing else on the device but the outputs
    (and, above the largest capacity, the scratch) it allocates.

    Layered inputs are ``[n, nl]`` with contiguous rows, contiguous or
    views such as ``x[lo:hi]``; ``[n]`` inputs take any stride
    (``kernels.cell_stride``; anything else raises, nothing is copied).
    The kernel has no backward: under autograd an input that requires a
    gradient raises (``use_kernel=False`` differentiates the twin).  While
    spans are recorded the launch annotates the open span with its
    ``instance``, ``nl``, ``dtype`` and ``soil_ice``."""
    global launches
    if t_soil.dim() != 2:
        raise ValueError(f"soil-heat kernel: t_soil is "
                         f"{tuple(t_soil.shape)}; expected [n, nl]")
    n, nl = t_soil.shape
    dtype, device = t_soil.dtype, t_soil.device
    if device.type != "cuda":
        raise ValueError(f"soil-heat kernel needs CUDA tensors, got {device}")
    cap = capacity(dtype, nl)
    if n < 1:
        raise ValueError(f"soil-heat kernel: n={n} must be >= 1")
    if (len(geom.dz_soil), len(geom.zc_soil)) != (nl, nl):
        raise ValueError(f"soil-heat kernel: geometry does not have nl={nl}")

    # In the order of the kernel's I_* slots; (name, tensor, layered).
    ins = [("t_soil", t_soil, True), ("h2osoi_liq", liq, True),
           ("h2osoi_ice", ice if soil_ice else None, True),
           ("theta_s", theta_s, True), ("lai", lai, False),
           ("tas", forcing.tas, False), ("rsds", forcing.rsds, False),
           ("rlds", forcing.rlds, False), ("ps", forcing.ps, False),
           ("sw_abs", sw_abs, False)]
    if torch.is_grad_enabled():
        tracked = [name for name, x, _ in ins
                   if x is not None and x.requires_grad]
        if tracked:
            raise RuntimeError(
                f"soil-heat kernel: {', '.join(tracked)} require a "
                f"gradient, and the kernel has no backward; differentiate "
                f"the plain day with use_kernel=False")
    strides = [0 if x is None else
               kernels.cell_stride(x, name, n, nl if layered else None,
                                   dtype, device, aligned=False,
                                   kernel="soil-heat kernel")
               for name, x, layered in ins]
    outs = [torch.empty((n, nl), dtype=dtype, device=device)
            for _ in range(3 if soil_ice else 1)]
    values = geometry(tuple(geom.dz_soil), tuple(geom.zc_soil))
    geom_host = np.asarray(values, dtype=np.float64)
    geom_dev = scratch = None
    if cap == ANY:
        geom_dev = layer_tensor(values, torch.float64, device)
        scratch = torch.empty((2 * nl, n), dtype=dtype, device=device)
    in_ptrs = (ctypes.c_void_p * len(ins))(
        *[None if x is None else x.data_ptr() for _, x, _ in ins])
    in_strides = (ctypes.c_longlong * len(ins))(*strides)
    out_ptrs = (ctypes.c_void_p * 3)(*[x.data_ptr() for x in outs])

    lib = kernels.soil_heat_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if profiling.recording():
            profiling.annotate(instance=instance_name(cap), nl=nl,
                               dtype=str(dtype).removeprefix("torch."),
                               soil_ice=bool(soil_ice))
        rc = lib.h9_soil_heat(
            dtype.itemsize, cap, nl, int(soil_ice), float(latent_ramp),
            float(dt), in_ptrs, in_strides, out_ptrs, n,
            geom_host.ctypes.data,
            None if geom_dev is None else geom_dev.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"soil-heat kernel launch failed: CUDA error {rc}")
    launches += 1
    if not soil_ice:
        return outs[0], liq, ice
    return outs[0], outs[1], outs[2]


def soil_heat(t_soil, liq, ice, theta_s, lai, forcing, geom, dt: float,
              soil_ice: bool, latent_ramp: float,
              sw_abs: Optional[torch.Tensor] = None,
              use_kernel: Optional[bool] = None) -> HeatResult:
    """One soil-heat day: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors.  ``use_kernel=True`` demands the kernel and raises on
    CPU tensors; ``use_kernel=False`` takes the twin, which annotates the
    open span with ``instance="plain"``."""
    args = (t_soil, liq, ice, theta_s, lai, forcing, geom, dt, soil_ice,
            latent_ramp, sw_abs)
    if kernels.kernel_wanted(t_soil, use_kernel, "soil-heat kernel"):
        return soil_heat_cuda(*args)
    if profiling.recording():
        profiling.annotate(instance="plain", nl=t_soil.shape[1],
                           dtype=str(t_soil.dtype).removeprefix("torch."),
                           soil_ice=bool(soil_ice))
    return soil_heat_plain(*args)
