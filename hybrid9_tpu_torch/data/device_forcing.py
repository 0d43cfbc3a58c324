"""Synthetic forcing generated on the device.

Port of ``hybrid9_tpu/data/device_forcing.py``.  Generating the climate
where the model runs removes the host generator and the host-to-device
copy (about 680 MB a year at 0.5 degrees).  The statistics are those of
``data/synthetic.py`` (the same seasonal structure, ranges and clips), the
numbers come from ``torch.Generator``s on the device, six streams keyed
by ``(seed, year)`` as the JAX package folds the year into its key: the
stream is reproducible on one kind of device, but it is neither the JAX
package's stream nor the host generator's.

The key holds neither the block's first day nor the day, as in the JAX
package: within one year, every block of one length draws the same
weather noise, and only the seasonal term differs between them.  The
default of one block a year hides this.  The host generator seeds each
day and does not share it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..physics import constants as c
from ..state import Forcing

_MASK64 = (1 << 64) - 1


def _stream_seed(seed: int, year: int, stream: int) -> int:
    """A 63-bit generator seed from ``(seed, year)`` and the stream index
    (splitmix64 finalisers of each in turn)."""
    x = 0
    for v in (seed, year, stream):
        x = (x + 0x9E3779B97F4A7C15 + (v & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def generate_block(seed: int, year: int, start_doy: int, n_days: int,
                   n: int, lat: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> Forcing:
    """A ``[n_days, n]`` forcing block made on ``lat``'s device."""
    device = lat.device
    lat = lat.to(dtype)
    days = start_doy + torch.arange(n_days, device=device, dtype=dtype)
    phase = 2.0 * math.pi * (days[:, None] - 15) / 365.0
    season = torch.cos(phase) * torch.where(lat >= 0.0, -1.0, 1.0)[None, :]
    shape = (n_days, n)

    def gen(stream):
        g = torch.Generator(device=device)
        g.manual_seed(_stream_seed(seed, year, stream))
        return g

    def noise(stream, scale):
        return scale * torch.randn(shape, generator=gen(stream),
                                   dtype=dtype, device=device)

    def uniform(stream, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen(stream), dtype=dtype,
                       device=device)
        return u * (hi - lo) + lo

    abs_lat = torch.abs(lat)[None, :]
    tas = 288.0 - 0.4 * abs_lat + 10.0 * season + noise(0, 2.0)
    rsds = torch.clamp(220.0 - 2.0 * abs_lat + 120.0 * season
                       + noise(1, 15.0), 5.0, 420.0)
    rlds = torch.clamp(1.2 * (tas - 210.0) + noise(2, 10.0), 120.0, 460.0)
    wet = uniform(3) < 0.35
    pr = torch.where(wet, 6.0e-5 * -torch.log(uniform(4, 1e-7, 1.0)),
                     torch.zeros((), dtype=dtype, device=device))
    rhs = torch.clamp(65.0 + 20.0 * torch.sin(phase + lat[None, :] / 30.0)
                      + noise(5, 8.0), 20.0, 100.0)
    ps = (101325.0 - 40.0 * abs_lat).expand(shape).contiguous()
    esat_pa = 610.8 * torch.exp(17.27 * (tas - c.TF) / (tas - c.TF + 237.3))
    huss = 0.622 * (rhs / 100.0) * esat_pa / ps
    return Forcing(tas=tas, rlds=rlds, rsds=rsds, huss=huss, ps=ps, pr=pr,
                   rhs=rhs)


class DeviceSyntheticForcingProvider:
    """Provider over :func:`generate_block` on ``device`` (None: the
    card; raises where there is none).

    With ``sharding`` (one rank of a multi-process run) the block is the
    rank's slab, on the rank's device.  The generator's streams depend on
    the block's shape, so each rank draws the global ``[days, n]`` block
    and keeps its columns: bitwise the single-process block, for a
    transient of the global block's size on every rank (a 365-day block
    at 69,632 cells is some 0.7 GB in float32)."""

    def __init__(self, n: int, seed: int = 0, lat=None,
                 dtype: torch.dtype = torch.float32, device=None,
                 sharding=None):
        from ..run import resolve_device
        self.n = n
        self.seed = seed
        self.dtype = dtype
        self.sharding = sharding
        self.device = (sharding.device if sharding is not None
                       else resolve_device(device))
        lat = np.linspace(-55.0, 65.0, n) if lat is None else lat
        self.lat = torch.as_tensor(np.asarray(lat), dtype=dtype,
                                   device=self.device)

    def __call__(self, year: int, start_doy: int, n_days: int) -> Forcing:
        block = generate_block(self.seed, year, start_doy, n_days, self.n,
                               self.lat, self.dtype)
        if self.sharding is None:
            return block
        return self.sharding.put_block(block)

    def slab_block(self, slabs, year: int, start_doy: int,
                   n_days: int) -> list:
        """The block cut over device slabs (``parallel.sharding.
        DeviceSlabs``, over the rank's slab under ``sharding``): each
        device the slabs name draws the global block once and keeps its
        slabs' columns, bitwise the global block's, so the columns are
        made where they are used."""
        offset = 0 if self.sharding is None else self.sharding.lo
        blocks = {}
        parts = []
        for device, (lo, hi) in zip(slabs.devices, slabs.bounds):
            if device not in blocks:
                blocks[device] = generate_block(
                    self.seed, year, start_doy, n_days, self.n,
                    self.lat.to(device), self.dtype)
            parts.append(blocks[device].map(
                lambda x: x[:, offset + lo:offset + hi].contiguous()))
        return parts
