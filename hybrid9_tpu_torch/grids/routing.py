"""Flow-direction network for routed flow.

A numpy-only copy of the parts of ``hybrid9_tpu/grids/routing.py`` that
the dense kinematic router needs: a D8 flow-direction network over the
land grid (steepest-descent neighbour on an elevation field) mapped onto
the packed cell axis (for every packed land cell, the packed index of
its downstream cell, or ``n_padded``, a virtual ocean outlet, where the
cell drains off-land), the hop lengths, and the dense direction codes of
the roll stencil (physics/routing.py).  Reading a network file, the
Muskingum reach geometry and flow accumulation are not ported yet
(ROADMAP A6, A5.6).
"""

from __future__ import annotations

import numpy as np

from .grid import LandGrid

# D8 neighbour offsets (dy, dx).
_D8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
       (1, 1)]


def synthetic_elevation(land_mask: np.ndarray, seed: int = 0
                        ) -> np.ndarray:
    """Smooth synthetic elevation (m) over the grid, higher inland.

    Deterministic stand-in for a real DEM: low-frequency random relief
    plus distance-from-ocean swell so networks drain toward coasts.
    """
    ny, nx = land_mask.shape
    rng = np.random.RandomState(seed + 7)
    yy = np.linspace(0.0, 2.0 * np.pi, ny, endpoint=False)
    xx = np.linspace(0.0, 2.0 * np.pi, nx, endpoint=False)
    relief = np.zeros((ny, nx))
    for ky in range(1, 6):
        for kx in range(1, 6):
            amp = rng.normal() / (kx + ky)
            ph_x, ph_y = rng.uniform(0, 2 * np.pi, 2)
            relief += amp * np.outer(np.sin(ky * yy + ph_y),
                                     np.sin(kx * xx + ph_x))
    relief = 500.0 * (relief - relief.min())

    # Distance-from-ocean term: iterative dilation (cheap, approximate).
    dist = np.zeros((ny, nx))
    frontier = ~land_mask
    reached = frontier.copy()
    for step in range(1, 41):
        grown = reached.copy()
        grown[1:, :] |= reached[:-1, :]
        grown[:-1, :] |= reached[1:, :]
        grown[:, 1:] |= reached[:, :-1]
        grown[:, :-1] |= reached[:, 1:]
        newly = grown & ~reached
        dist[newly] = step
        reached = grown
        if reached.all():
            break
    dist[~reached] = 41.0
    return relief + 30.0 * dist


# Metres per degree of great-circle arc (R = 6.371e6 m).
_M_PER_DEG = 6.371e6 * np.pi / 180.0


def flow_length_m(grid: LandGrid, downstream: np.ndarray) -> np.ndarray:
    """Per-cell D8 hop distance to the downstream cell ([n_padded], m).

    The physical length scale for kinematic-wave timing: cardinal hops are
    one cell size, diagonal hops sqrt(2) longer, and the east-west size
    shrinks with cos(latitude).  Outlet-draining cells (downstream ==
    n_padded) get their own cell's diagonal as the run-out length; padding
    cells get 1 m (never used — they hold no water).
    """
    nx, ny = grid.nx, grid.ny
    res = grid.resolution_deg
    n = grid.n_land
    ys = grid.land_idx // nx
    xs = grid.land_idx % nx
    lat = grid.lat[ys]
    dy_m = res * _M_PER_DEG
    dx_m = res * _M_PER_DEG * np.cos(np.deg2rad(lat))

    down = np.asarray(downstream[:n], np.int64)
    internal = down < n
    di = np.where(internal, down, 0)
    yd, xd = grid.land_idx[di] // nx, grid.land_idx[di] % nx
    ddy = np.abs(yd - ys)
    ddx = np.abs(xd - xs)
    ddx = np.minimum(ddx, nx - ddx)          # longitude wrap
    hop = np.sqrt((ddy * dy_m) ** 2 + (ddx * dx_m) ** 2)
    runout = np.sqrt(dy_m ** 2 + dx_m ** 2)  # outlet cells: own diagonal
    length = np.where(internal, hop, runout)

    out = np.ones(grid.n_padded, np.float64)
    out[:n] = np.maximum(length, 1.0)
    return out.astype(np.float32)



def build_downstream_index(grid: LandGrid,
                           elevation: np.ndarray | None = None,
                           seed: int = 0) -> np.ndarray:
    """Packed downstream index per cell ([n_padded] int32).

    For each land cell, the steepest-descent D8 neighbour's packed index;
    cells whose steepest neighbour is ocean, off-grid, or not lower drain
    to the virtual outlet (index ``n_padded``).  Padding cells also point
    at the outlet.  Longitude wraps; latitude clamps at the poles.
    """
    ny, nx = grid.ny, grid.nx
    land = np.zeros(ny * nx, bool)
    land[grid.land_idx] = True
    land = land.reshape(ny, nx)
    if elevation is None:
        elevation = synthetic_elevation(land, seed)

    # Map flat grid index -> packed index.
    packed_of = np.full(ny * nx, -1, np.int64)
    packed_of[grid.land_idx] = np.arange(grid.n_land)

    ys = grid.land_idx // nx
    xs = grid.land_idx % nx
    here = elevation[ys, xs]
    best_drop = np.zeros(grid.n_land)
    best_down = np.full(grid.n_land, grid.n_padded, np.int64)  # outlet
    for dy, dx in _D8:
        yn = ys + dy
        xn = (xs + dx) % nx
        valid = (yn >= 0) & (yn < ny)
        ync = np.clip(yn, 0, ny - 1)
        drop = np.where(valid, here - elevation[ync, xn], -np.inf)
        is_land = valid & land[ync, xn]
        flat_n = ync * nx + xn
        cand = np.where(is_land, packed_of[flat_n], grid.n_padded)
        better = drop > best_drop
        best_down = np.where(better, cand, best_down)
        best_drop = np.where(better, drop, best_drop)

    downstream = np.full(grid.n_padded, grid.n_padded, np.int64)
    downstream[:grid.n_land] = best_down
    # No self-loops (flat cells already go to the outlet via best_drop=0).
    self_loop = downstream[:grid.n_land] == np.arange(grid.n_land)
    downstream[:grid.n_land][self_loop] = grid.n_padded
    return downstream.astype(np.int32)


def _break_cycles(down: np.ndarray, outlet: int) -> int:
    """Redirect members of directed cycles to the outlet, in place.

    User flow-direction products (raw/unconditioned D8) can contain
    2+-cell cycles (e.g. two sink cells pointing at each other), which
    a steepest-descent build cannot.  Cycles would trap routed water
    forever and break the Kahn accumulation pass (everything downstream
    of a cycle is silently dropped from drainage areas).  Standard
    functional-graph colouring: walk each unvisited chain; a node met
    twice on the current walk closes a cycle, and exactly its cycle
    members are redirected to the outlet (their downstream chains keep
    real topology).  Returns the number of redirected cells.
    """
    n = len(down)
    color = np.zeros(n, np.int8)        # 0 new, 1 on current walk, 2 done
    n_broken = 0
    pos = np.full(n, -1, np.int64)      # position on the current walk
    for s in range(n):
        if color[s]:
            continue
        path = []
        v = s
        while True:
            if v >= n or v == outlet or (v < n and color[v] == 2):
                break
            if color[v] == 1:           # closed a cycle at pos[v]
                for u in path[pos[v]:]:
                    down[u] = outlet
                    n_broken += 1
                break
            color[v] = 1
            pos[v] = len(path)
            path.append(v)
            v = down[v]
        for u in path:
            color[u] = 2
            pos[u] = -1
    return n_broken


def load_network(grid: LandGrid, path: str | None, seed: int = 0
                 ) -> tuple[np.ndarray, np.ndarray | None]:
    """``(downstream, elevation)`` of the synthetic network (``path`` is
    None): steepest descent on :func:`synthetic_elevation`.  Reading a
    flow-direction or elevation file is not ported yet."""
    if path is not None:
        raise NotImplementedError(
            f"routing_network_path={path!r}: reading a network file is "
            "not ported yet: ROADMAP A6 (year loop, forcing and I/O)")
    land = np.zeros(grid.ny * grid.nx, bool)
    land[grid.land_idx] = True
    elevation = synthetic_elevation(land.reshape(grid.ny, grid.nx), seed)
    return build_downstream_index(grid, elevation=elevation), elevation


def direction_codes(grid: LandGrid, downstream: np.ndarray) -> np.ndarray:
    """D8 direction code per grid cell for the dense halo formulation.

    Returns ``[ny, nx] int32``: for land cells, the index 0..7 into the
    D8 offset table of the direction the cell drains, or 8 where it
    drains to the ocean outlet; ocean cells get -1.  This is the dense
    dual of the packed ``downstream`` map, used by the roll-stencil
    routing step (physics/routing.py route_kinematic_day_grid).
    """
    nx, ny, n = grid.nx, grid.ny, grid.n_land
    codes = np.full(ny * nx, -1, np.int32)
    ys = grid.land_idx // nx
    xs = grid.land_idx % nx
    down = np.asarray(downstream[:n], np.int64)
    internal = down < n
    di = np.where(internal, down, 0)
    yd, xd = grid.land_idx[di] // nx, grid.land_idx[di] % nx
    ddy = yd - ys
    ddx = xd - xs
    # Longitude wrap: map +-(nx-1) back to -+1.
    ddx = np.where(ddx > nx // 2, ddx - nx, ddx)
    ddx = np.where(ddx < -(nx // 2), ddx + nx, ddx)
    code = np.full(n, 8, np.int32)
    for k, (dy, dx) in enumerate(_D8):
        code = np.where(internal & (ddy == dy) & (ddx == dx), k, code)
    codes[grid.land_idx] = code
    return codes.reshape(ny, nx)
