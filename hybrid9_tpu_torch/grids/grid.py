"""Global lon/lat grid, land mask, and packed-cell gather/scatter.

A numpy-only copy of ``hybrid9_tpu/grids/grid.py``: land cells of the
dense (lon, lat) grid are gathered once into a packed ``[n]`` axis, so
every lane does useful work; index maps are kept for scattering fields
back to the (lon, lat) grid.
"""

from __future__ import annotations

import dataclasses
import numpy as np


def cell_centres(resolution_deg: float) -> tuple[np.ndarray, np.ndarray]:
    """Lon/lat cell-centre coordinates, matching the PGF convention
    (0.5-degree grid, centres at +/-0.25-style offsets; INIT.f90:141-146).
    """
    nx = int(round(360.0 / resolution_deg))
    ny = int(round(180.0 / resolution_deg))
    half = resolution_deg / 2.0
    lon = -180.0 + half + resolution_deg * np.arange(nx)
    lat = 90.0 - half - resolution_deg * np.arange(ny)
    return lon, lat


@dataclasses.dataclass(frozen=True)
class LandGrid:
    """Packed land-cell view of a global lon/lat grid.

    ``land_idx`` holds flat indices (y * nx + x) of land cells; the packed
    axis is padded to ``n_padded`` (a multiple of the requested block);
    ``valid`` masks real cells vs padding.
    """

    nx: int
    ny: int
    resolution_deg: float
    land_idx: np.ndarray      # [n_land] flat indices into the global grid
    n_padded: int

    @property
    def n_land(self) -> int:
        return int(self.land_idx.shape[0])

    @property
    def valid(self) -> np.ndarray:
        v = np.zeros(self.n_padded, dtype=bool)
        v[:self.n_land] = True
        return v

    @property
    def lon(self) -> np.ndarray:
        lon, _ = cell_centres(self.resolution_deg)
        return lon

    @property
    def lat(self) -> np.ndarray:
        _, lat = cell_centres(self.resolution_deg)
        return lat

    @property
    def cell_lat(self) -> np.ndarray:
        """[n_padded] latitude of each packed cell (padding gets 0)."""
        out = np.zeros(self.n_padded)
        out[:self.n_land] = self.lat[self.land_idx // self.nx]
        return out

    @property
    def cell_lon(self) -> np.ndarray:
        out = np.zeros(self.n_padded)
        out[:self.n_land] = self.lon[self.land_idx % self.nx]
        return out

    def pack(self, field2d: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """Gather a [ny, nx] (or [ny, nx, ...]) field to the packed axis;
        padding lanes get ``fill``."""
        flat = field2d.reshape(self.ny * self.nx, *field2d.shape[2:])
        packed = flat[self.land_idx]
        pad = self.n_padded - self.n_land
        if pad:
            pad_block = np.full((pad, *packed.shape[1:]), fill,
                                dtype=packed.dtype)
            packed = np.concatenate([packed, pad_block], axis=0)
        return packed

    def scatter(self, packed: np.ndarray,
                fill: float = np.nan) -> np.ndarray:
        """Scatter a packed [n_padded, ...] array back to [ny, nx, ...].

        Ocean cells get ``fill`` (the reference writes NaN fill values,
        WRITE_NET_CDF_3DR.f90:186-197).
        """
        out = np.full((self.ny * self.nx, *packed.shape[1:]), fill,
                      dtype=packed.dtype)
        out[self.land_idx] = packed[:self.n_land]
        return out.reshape(self.ny, self.nx, *packed.shape[1:])

    def row_band(self, lo: int, hi: int) -> tuple[int, int, np.ndarray]:
        """Latitude-row band covering packed cells [lo, hi).

        ``land_idx`` is sorted (row-major flatnonzero), so any contiguous
        slab of the packed axis maps to a contiguous band of latitude
        rows.  Returns ``(row_lo, row_hi, local_idx)`` where
        ``local_idx`` are gather indices into the flattened
        ``[row_hi - row_lo, nx]`` band for the real (non-padding) cells of
        the slab.  This is what lets each host hyperslab-read only its own
        spatial footprint of a forcing file — the packed-axis analog of
        each MPI rank's (lon_s, lat_s) x (lon_c, lat_c) tile read
        (READ_NET_CDF_3DR.f90:95-97).
        """
        hi_real = min(hi, self.n_land)
        if hi_real <= lo:  # slab is entirely padding lanes
            return 0, 0, np.zeros(0, np.int64)
        idx = self.land_idx[lo:hi_real]
        row_lo = int(idx[0] // self.nx)
        row_hi = int(idx[-1] // self.nx) + 1
        return row_lo, row_hi, (idx - row_lo * self.nx).astype(np.int64)

    def cell_index_of(self, lon_w: float, lat_w: float) -> int:
        """Packed index of the land cell nearest (lon_w, lat_w).

        The analog of the reference's INTERACTIVE focus-cell lookup
        (INIT.f90:220-236, 462-466).
        """
        ys = self.land_idx // self.nx
        xs = self.land_idx % self.nx
        # Wrap the longitude difference so a dateline focus point finds
        # its true neighbour, and weight it by cos(lat) so nearest-cell
        # selection is not biased at high latitude.
        dlon = (self.lon[xs] - lon_w + 180.0) % 360.0 - 180.0
        dlat = self.lat[ys] - lat_w
        d2 = (dlon * np.cos(np.deg2rad(lat_w))) ** 2 + dlat ** 2
        return int(np.argmin(d2))


def make_land_grid(land_mask: np.ndarray, resolution_deg: float = 0.5,
                   pad_multiple: int = 1024) -> LandGrid:
    """Build a LandGrid from a boolean [ny, nx] land mask."""
    ny, nx = land_mask.shape
    land_idx = np.flatnonzero(land_mask.reshape(-1))
    n = land_idx.shape[0]
    n_padded = max(pad_multiple,
                   ((n + pad_multiple - 1) // pad_multiple) * pad_multiple)
    return LandGrid(nx=nx, ny=ny, resolution_deg=resolution_deg,
                    land_idx=land_idx, n_padded=n_padded)


def synthetic_land_mask(resolution_deg: float = 0.5, seed: int = 0,
                        land_fraction: float = 0.29) -> np.ndarray:
    """Deterministic pseudo-continents with a realistic land fraction.

    Smooth random field thresholded at the requested land fraction; polar
    caps excluded like the HWSD mask effectively does.  A stand-in for the
    soil_tex > 0 & != 13 test (HYBRID9.f90:122-123) when HWSD data is not
    on disk.
    """
    nx = int(round(360.0 / resolution_deg))
    ny = int(round(180.0 / resolution_deg))
    rng = np.random.RandomState(seed)
    # Low-frequency Fourier field -> continent-scale blobs.
    field = np.zeros((ny, nx))
    yy = np.linspace(0.0, 2.0 * np.pi, ny, endpoint=False)
    xx = np.linspace(0.0, 2.0 * np.pi, nx, endpoint=False)
    for ky in range(1, 5):
        for kx in range(1, 5):
            amp = rng.normal() / (kx * kx + ky * ky)
            ph_x, ph_y = rng.uniform(0, 2 * np.pi, 2)
            field += amp * np.outer(np.cos(ky * yy + ph_y),
                                    np.cos(kx * xx + ph_x))
    _, lat = cell_centres(resolution_deg)
    polar = (np.abs(lat) > 83.0)[:, None] & np.ones((1, nx), dtype=bool)
    field[polar] = -np.inf
    thresh = np.quantile(field[~polar], 1.0 - land_fraction)
    return field >= thresh
