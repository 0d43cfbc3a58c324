// One model day of soil heat per cell: the CUDA soil-heat kernel.
//
// Replaces no Pallas kernel.  The JAX package runs soil heat as plain jnp
// (hybrid9_tpu/physics/soiltemp.py, driven by step._soil_thermal), and XLA
// fuses it into a few loops over the cells; its only pallas_call is the day
// kernel.  The port's plain form of the same step (the twin,
// hybrid9_tpu_torch/physics/soil_heat.py::soil_heat_plain: the surface
// forcing, soiltemp.soil_temperature_step and soiltemp.phase_change) is a
// Python loop over the layers with two unrolled Thomas solves, some 425
// launches a day at 8 layers and 527 at 10.  This kernel is that fusion
// written by hand: the whole step for one cell per thread, one launch a day.
//
// What bounds it on an H100: bytes.  A cell-day is some 300 operations
// against 148 bytes at 8 layers (29 float32 values read: the temperature,
// water and porosity rows and five surface fields; 8 written) and 180 bytes
// at 10, so the 557,056 cells of a folded 8-member ensemble move 82 MB, 25
// us at 3.35 TB/s.
//
// What the design does about it:
//  - Each input is read once and each output written once.  The column
//    stays on the chip between the passes: the layer properties, the two
//    solves and the phase change.
//  - The state keeps the model's [n, nl] layout (no transpose).  A block of
//    128 cells stages its rows of the temperature, water, porosity (and
//    ice) through shared memory, consecutive threads on consecutive words
//    and every load issued before the first store, in tiles of an odd
//    pitch, so that a warp reading one layer of its rows meets no bank
//    conflict; each thread then walks its own row there, and the outputs
//    leave the same way.  Rows may be views with any row stride (slabs
//    x[lo:hi]); [n] fields take any stride.
//  - Register arrays take compile-time indices only, so the column is built
//    by layer capacity (8, 16, 32) with its layer loops unrolled and guarded
//    by the run-time layer count; the geometry goes in the launch's
//    parameters.  Theta and the heat capacity are formed again in each
//    pass, which keeps four vectors a cell (the day-start temperatures, the
//    conductances, the multipliers and the solution).
//  - Above 32 layers one form takes the count at run time, keeps the
//    conductances and multipliers in a scratch laid out [slot][cell], so a
//    warp's accesses are contiguous, and solves into the output row; its
//    geometry is a float64 tensor on the device.
//  - The arithmetic is the twin's as PyTorch runs it on the card, operation
//    for operation: built with -fmad=false (no multiply-add contraction),
//    constants rounded once to the working type, and a division by a Python
//    scalar formed as PyTorch's CUDA division by a CPU scalar forms it: a
//    multiply by the scalar's reciprocal, taken in double and rounded once.
//    So it is bitwise the twin on CUDA tensors (PyTorch 2.11, H100).
// On an NVIDIA H100 80GB HBM3 at 700 W it takes 64 us at 557,056 cells and
// 8 layers (39 % of the bandwidth bound), 114 us at 10 layers (26 %; the
// capacity-16 build holds 148 registers a thread) and 118 us at 1,114,112
// cells and 8 layers (42 %); the twin's kernels 1.9, 3.2 and 3.1 ms.

// Built by hybrid9_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
// and called through the plain C entry at the bottom.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

// physics/constants.py and physics/soiltemp.py, folded as Python folds them.
constexpr double TF = 273.16;
constexpr double LFUS = 3.337e5;
constexpr double RHOW = 1000.0;
constexpr double STBO = 5.67e-8;
constexpr double RGAS = 1000.0 * 8.314510 / 28.9655;
constexpr double CP_AIR = 1010.0;
constexpr double K_DRY = 0.30;
constexpr double K_SAT = 1.80;
constexpr double C_SOLID = 2.0e6;
constexpr double C_WATER = 4.18e6;
constexpr double C_ICE = 1.9e6;
constexpr double WATMIN = 0.01;

// Inputs and outputs, in the wrapper's order.  I_ICE is null without
// soil_ice; I_SWABS may be null (0.92 everywhere).  O_LIQ and O_ICE are
// written with soil_ice only.
enum { I_T, I_LIQ, I_ICE, I_THETA_S, I_LAI, I_TAS, I_RSDS, I_RLDS, I_PS,
       I_SWABS, N_IN };
enum { O_T, O_LIQ, O_ICE, N_OUT };
constexpr int BLOCK = 128;

template <typename Real>
struct Args {
  const Real* in[N_IN];
  long long stride[N_IN];  // elements from one cell to the next
  Real* out[N_OUT];        // contiguous [n, nl]
  int n, nl, soil_ice;
  double ramp, dt;
};

// torch.maximum / torch.minimum / torch.clamp propagate NaN.
template <typename Real>
__device__ __forceinline__ Real vmax(Real a, Real b) {
  return (a > b || a != a) ? a : b;
}
template <typename Real>
__device__ __forceinline__ Real vmin(Real a, Real b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float ex(float a) { return expf(a); }
__device__ __forceinline__ double ex(double a) { return exp(a); }

// The layer geometry in doubles: thickness in mm, in m, and the reciprocal
// of the distance from a node to the next in 1/m (0 below the last).  By
// value for the capacity builds, from the device for the run-time form.
template <int CAP>
struct GeomVal {
  double v[3][CAP];
  __device__ __forceinline__ double dz_mm(int i) const { return v[0][i]; }
  __device__ __forceinline__ double dz_m(int i) const { return v[1][i]; }
  __device__ __forceinline__ double inv_gap_m(int i) const {
    return v[2][i];
  }
};
struct GeomPtr {
  const double* p;
  int nl;
  __device__ __forceinline__ double dz_mm(int i) const { return p[i]; }
  __device__ __forceinline__ double dz_m(int i) const { return p[nl + i]; }
  __device__ __forceinline__ double inv_gap_m(int i) const {
    return p[2 * nl + i];
  }
};

// A per-layer vector of one cell: registers (compile-time indices only,
// after unrolling), or a strided run in device memory (a row of the output,
// a slot column of the run-time form's scratch).
template <typename Real, int CAP>
struct Regs {
  Real v[CAP];
  __device__ __forceinline__ Real get(int i) const { return v[i]; }
  __device__ __forceinline__ void set(int i, Real x) { v[i] = x; }
};
template <typename Real>
struct Strided {
  Real* p;
  long long stride;
  __device__ __forceinline__ Real get(int i) const { return p[i * stride]; }
  __device__ __forceinline__ void set(int i, Real x) { p[i * stride] = x; }
};

// One cell's surface forcing: the SW85 ground heat flux, the implicit
// sensible exchange through raa and the air temperature.
template <typename Real>
struct Surface {
  Real g_flux, h_surf, tas;
};
template <typename Real>
__device__ __forceinline__ Surface<Real> surface(const Args<Real>& a,
                                                 long long c) {
  const Real lai = a.in[I_LAI][c * a.stride[I_LAI]];
  const Real tas = a.in[I_TAS][c * a.stride[I_TAS]];
  const Real rsds = a.in[I_RSDS][c * a.stride[I_RSDS]];
  const Real rlds = a.in[I_RLDS][c * a.stride[I_RLDS]];
  const Real ps = a.in[I_PS][c * a.stride[I_PS]];
  const Real sw = a.in[I_SWABS] ? a.in[I_SWABS][c * a.stride[I_SWABS]]
                                : Real(0.92);
  const Real t2 = tas * tas;
  const Real rnet = (sw * rsds + rlds) - Real(STBO) * (t2 * t2);
  const Real g_flux = (Real(0.2) * rnet) * ex(Real(-0.7) * lai);
  const Real raa = lai <= Real(4.0)
                       ? (Real(0.25) * lai) * Real(42.0) +
                             (Real(0.25) * (Real(4.0) - lai)) * Real(34.0)
                       : Real(42.0);
  const Real rho_air = ps / (Real(RGAS) * tas);
  const Real h_surf = (rho_air * Real(CP_AIR)) / vmax(raa, Real(1.0));
  return Surface<Real>{g_flux, h_surf, tas};
}

// The whole soil-heat step of one cell (physics/soil_heat.py::
// soil_heat_plain, line for line) over its rows: liq, ice (null without
// soil_ice) and ts in, out_t (out_liq, out_ice) out; an out row may be the
// in row of the same field.  CAP > 0 runs the loops over CAP layers,
// unrolled, each guarded by the run-time count; CAP == 0 runs them over
// nl.  t0 holds the day-start temperatures, dw receives the solution.
// Theta and the heat capacity are formed again in each pass, which keeps
// two vectors fewer.
template <typename Real, int CAP, class G, class T0, class V, class D>
__device__ __forceinline__ void column(
    const Real* liq, const Real* ice, const Real* ts, const Surface<Real>& sf,
    const G& geo, int nl, double ramp, double dt, const T0& t0, V& gc,
    V& gam, D& dw, Real* out_t, Real* out_liq, Real* out_ice) {
  constexpr bool kUnrolled = CAP > 0;
  const int top = kUnrolled ? CAP : nl;
  const auto theta = [&](int i) {
    const Real water = ice ? liq[i] + ice[i] : liq[i];
    return water / ((Real(geo.dz_mm(i)) * Real(RHOW)) * Real(1.0 / 1.0e3));
  };

  // The interface conductances.
  Real k_above = Real(0.0);
#pragma unroll
  for (int i = 0; i < top; ++i) {
    if (i >= nl) continue;
    const Real se = vmin(vmax(theta(i) / ts[i], Real(0.0)), Real(1.0));
    const Real k = Real(K_DRY) + Real(K_SAT - K_DRY) * se;
    if (i > 0)
      gc.set(i - 1, (Real(0.5) * (k_above + k)) * Real(geo.inv_gap_m(i - 1)));
    k_above = k;
  }

  // cv_i dz_i / dt (T'_i - T_i) = g_{i-1}(T'_{i-1} - T'_i)
  //                               - g_i(T'_i - T'_{i+1}) + [G]_top,
  // by the Thomas algorithm.  The corrector (second) re-solves with the
  // fusion enthalpy spread over the freezing band in the layers whose
  // predicted step crosses it; it reads the predictor's T'_i before it
  // overwrites it.
  const Real tf = Real(TF);
  const Real band_lo = Real(TF - ramp);
  const Real inv_ramp = Real(1.0 / ramp);
  const Real inv_dt = Real(1.0 / dt);
  for (int pass = 0; pass < (ramp > 0.0 ? 2 : 1); ++pass) {
    Real bet = Real(1.0), dw_above = Real(0.0);
#pragma unroll
    for (int i = 0; i < top; ++i) {
      if (i >= nl) continue;
      const Real t_old = t0.get(i);
      const Real th = theta(i);
      Real cv = Real(C_SOLID) * (Real(1.0) - ts[i]) + Real(C_WATER) * th;
      if (pass == 1) {
        const Real t_new = dw.get(i);
        const Real lo = vmin(t_old, t_new), hi = vmax(t_old, t_new);
        const Real crosses = (lo < tf && hi > band_lo) ? Real(1.0)
                                                       : Real(0.0);
        cv = cv + crosses * ((Real(RHOW * LFUS) * th) * inv_ramp);
      }
      const Real diag = (cv * Real(geo.dz_m(i))) * inv_dt;
      Real rhs = diag * t_old;
      Real b = diag;
      if (i > 0) b = b + gc.get(i - 1);
      if (i < nl - 1) b = b + gc.get(i);
      Real d;
      if (i == 0) {
        rhs = rhs + sf.g_flux;
        b = b + sf.h_surf;
        rhs = rhs + sf.h_surf * sf.tas;
        bet = b;
        d = rhs / bet;
      } else {
        const Real lower = -gc.get(i - 1);   // a_i, and c_{i-1}
        const Real g = lower / bet;
        bet = b - lower * g;
        d = (rhs - lower * dw_above) / bet;
        gam.set(i, g);
      }
      dw.set(i, d);
      dw_above = d;
    }
#pragma unroll
    for (int i = top - 2; i >= 0; --i) {
      if (i > nl - 2) continue;
      dw.set(i, dw.get(i) - gam.get(i + 1) * dw.get(i + 1));
    }
  }

  // The explicit phase change (soiltemp.phase_change), or the solution.
  if (!ice) {
#pragma unroll
    for (int i = 0; i < top; ++i)
      if (i < nl) out_t[i] = dw.get(i);
    return;
  }
  const Real inv_lfus = Real(1.0 / LFUS);
#pragma unroll
  for (int i = 0; i < top; ++i) {
    if (i >= nl) continue;
    const Real t = dw.get(i), l = liq[i], f = ice[i], s = ts[i];
    const Real dzm = Real(geo.dz_mm(i)) * Real(1.0 / 1000.0);
    const Real d1000 = dzm * Real(1000.0);
    const Real hc = ((Real(C_SOLID) * (Real(1.0) - s) +
                      Real(C_WATER) * (l / d1000)) +
                     Real(C_ICE) * (f / d1000)) * dzm;
    const Real cold = vmax(tf - t, Real(0.0));
    const Real warm = vmax(t - tf, Real(0.0));
    const Real freeze =
        vmin(vmax(l - Real(WATMIN), Real(0.0)), (hc * cold) * inv_lfus);
    const Real melt = vmin(f, (hc * warm) * inv_lfus);
    out_t[i] = t + ((freeze - melt) * Real(LFUS)) / hc;
    out_liq[i] = (l - freeze) + melt;
    out_ice[i] = (f + freeze) - melt;
  }
}

// The tiles a capacity build stages: the layered inputs in, in the order
// the outputs reuse them (the temperature, liquid and ice tiles take the
// outputs of their fields).
constexpr int N_TILES = 4;
__device__ __forceinline__ int tile_field(int k) {
  return k == 0 ? I_T : k == 1 ? I_LIQ : k == 2 ? I_ICE : I_THETA_S;
}

// Shared-memory words of one tile: BLOCK rows of an odd pitch, so that a
// warp reading one layer of its 32 rows hits 32 banks.
__host__ __device__ __forceinline__ int tile_pitch(int nl) { return nl | 1; }

// The elements a thread moves between a block's rows and its tiles:
// element threadIdx.x + j * BLOCK of the rows' nl-element runs, for j below
// CAP (rows <= BLOCK and nl <= CAP), as (row, column).  Consecutive threads
// take consecutive elements of the rows.
template <int CAP>
__device__ __forceinline__ void spread(int nl, int (&rr)[CAP],
                                       int (&cc)[CAP]) {
  const int step_rows = BLOCK / nl, step_cols = BLOCK % nl;
  int row = threadIdx.x / nl, col = threadIdx.x % nl;
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    rr[j] = row;
    cc[j] = col;
    row += step_rows;
    col += step_cols;
    if (col >= nl) {
      col -= nl;
      ++row;
    }
  }
}

// A capacity build: the block's rows staged through shared memory, each
// cell's solve in registers.  Every load of the staging is issued before
// the first store to a tile, so that many bytes are in flight.
template <typename Real, int CAP>
__global__ void __launch_bounds__(BLOCK)
    soil_heat_kernel(const Args<Real> a, const GeomVal<CAP> geo) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Real* shared = reinterpret_cast<Real*>(shared_raw);
  const int nl = a.nl, pitch = tile_pitch(nl);
  const long long c0 = blockIdx.x * static_cast<long long>(BLOCK);
  const int rows = static_cast<int>(
      a.n - c0 < BLOCK ? a.n - c0 : static_cast<long long>(BLOCK));
  const int count = rows * nl;
  Real* tile[N_TILES] = {};
  {
    int rr[CAP], cc[CAP];
    spread<CAP>(nl, rr, cc);
    Real v[N_TILES][CAP];
    int used = 0;
#pragma unroll
    for (int k = 0; k < N_TILES; ++k) {
      const int f = tile_field(k);
      if (a.in[f] == nullptr) continue;   // no ice tile without soil_ice
      tile[k] = shared + used++ * BLOCK * pitch;
      const Real* src = a.in[f] + c0 * a.stride[f];
#pragma unroll
      for (int j = 0; j < CAP; ++j)
        if (threadIdx.x + j * BLOCK < count)
          v[k][j] = src[rr[j] * a.stride[f] + cc[j]];
    }
#pragma unroll
    for (int k = 0; k < N_TILES; ++k) {
      if (tile[k] == nullptr) continue;
#pragma unroll
      for (int j = 0; j < CAP; ++j)
        if (threadIdx.x + j * BLOCK < count)
          tile[k][rr[j] * pitch + cc[j]] = v[k][j];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    const int row = r * pitch;
    Regs<Real, CAP> t0, gc, gam, dw;
#pragma unroll
    for (int i = 0; i < CAP; ++i)
      if (i < nl) t0.set(i, tile[0][row + i]);
    Real* ice = tile[2] ? tile[2] + row : nullptr;
    column<Real, CAP>(tile[1] + row, ice, tile[3] + row, surface(a, c0 + r),
                      geo, nl, a.ramp, a.dt, t0, gc, gam, dw, tile[0] + row,
                      tile[1] + row, ice);
  }
  __syncthreads();
  int rr[CAP], cc[CAP];
  spread<CAP>(nl, rr, cc);
  for (int k = 0; k < (a.soil_ice ? 3 : 1); ++k) {
    Real* dst = a.out[k] + c0 * nl;
#pragma unroll
    for (int j = 0; j < CAP; ++j)
      if (threadIdx.x + j * BLOCK < count)
        dst[rr[j] * nl + cc[j]] = tile[k][rr[j] * pitch + cc[j]];
  }
}

// The run-time form: the conductances and the multipliers in
// scratch[slot][cell] (2 nl slots), the solution in the output row.
template <typename Real>
__global__ void __launch_bounds__(BLOCK)
    soil_heat_kernel_any(const Args<Real> a, const double* geom,
                         Real* scratch) {
  const long long c = blockIdx.x * static_cast<long long>(BLOCK) +
                      threadIdx.x;
  if (c >= a.n) return;
  const long long n = a.n, nl = a.nl;
  const Strided<Real> t0{const_cast<Real*>(a.in[I_T]) + c * a.stride[I_T],
                         1};
  Strided<Real> gc{scratch + c, n}, gam{scratch + nl * n + c, n};
  Real* out_t = a.out[O_T] + c * nl;
  Strided<Real> dw{out_t, 1};
  const Real* ice =
      a.soil_ice ? a.in[I_ICE] + c * a.stride[I_ICE] : nullptr;
  column<Real, 0>(a.in[I_LIQ] + c * a.stride[I_LIQ], ice,
                  a.in[I_THETA_S] + c * a.stride[I_THETA_S], surface(a, c),
                  GeomPtr{geom, a.nl}, a.nl, a.ramp, a.dt, t0, gc, gam, dw,
                  out_t, ice ? a.out[O_LIQ] + c * nl : nullptr,
                  ice ? a.out[O_ICE] + c * nl : nullptr);
}

template <typename Real, int CAP>
int launch_cap(const Args<Real>& a, const double* geom, cudaStream_t s) {
  GeomVal<CAP> geo{};
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < a.nl; ++i) geo.v[k][i] = geom[k * a.nl + i];
  const int tiles = a.soil_ice ? N_TILES : N_TILES - 1;
  const int shared_bytes = static_cast<int>(
      tiles * BLOCK * tile_pitch(a.nl) * sizeof(Real));
  if (shared_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soil_heat_kernel<Real, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = static_cast<int>((a.n + BLOCK - 1) / BLOCK);
  soil_heat_kernel<Real, CAP><<<grid, BLOCK, shared_bytes, s>>>(a, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int launch(int cap, const void* const* ins, const long long* strides,
           void* const* outs, int n, int nl, int soil_ice, double ramp,
           double dt, const double* geom, const void* geom_dev,
           void* scratch, cudaStream_t s) {
  Args<Real> a{};
  for (int k = 0; k < N_IN; ++k) {
    a.in[k] = static_cast<const Real*>(ins[k]);
    a.stride[k] = strides[k];
  }
  if (!soil_ice) a.in[I_ICE] = nullptr;
  for (int k = 0; k < N_OUT; ++k) a.out[k] = static_cast<Real*>(outs[k]);
  a.n = n;
  a.nl = nl;
  a.soil_ice = soil_ice;
  a.ramp = ramp;
  a.dt = dt;
  switch (cap) {
    case 8: return launch_cap<Real, 8>(a, geom, s);
    case 16: return launch_cap<Real, 16>(a, geom, s);
    case 32: return launch_cap<Real, 32>(a, geom, s);
    default: break;
  }
  const int grid = (n + BLOCK - 1) / BLOCK;
  soil_heat_kernel_any<Real><<<grid, BLOCK, 0, s>>>(
      a, static_cast<const double*>(geom_dev), static_cast<Real*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ins holds N_IN device pointers in the order of the I_* slots, strides the
// elements from one cell to the next of each (the rows of layered inputs
// are contiguous), outs N_OUT contiguous [n, nl] outputs (O_LIQ and O_ICE
// with soil_ice only).  cap is the layer capacity of the build (8, 16 or
// 32, at least nl), or 0 for the run-time form, which takes geom_dev (the
// geometry below, as doubles on the device) and scratch (2 nl n values).
// geom holds dz_mm[nl], dz_m[nl] and the reciprocal node gaps
// inv_gap_m[nl] (the last 0) on the host.  latent_ramp > 0 runs the
// corrector solve.  Launches on `stream`, a thread for each cell.
// Allocates nothing, never syncs; returns cudaGetLastError(), or -1 for
// arguments it refuses.
extern "C" int h9_soil_heat(int dtype_bytes, int cap, int nl, int soil_ice,
                            double latent_ramp, double dt,
                            const void* const* ins, const long long* strides,
                            void* const* outs, int n, const double* geom,
                            const void* geom_dev, void* scratch,
                            void* stream) {
  if (n < 1 || nl < 1 || geom == nullptr) return -1;
  if (cap != 0 && cap != 8 && cap != 16 && cap != 32) return -1;
  if (cap != 0 && nl > cap) return -1;
  if (cap == 0 && (geom_dev == nullptr || scratch == nullptr)) return -1;
  for (int k = 0; k < N_IN; ++k) {
    const bool optional = k == I_SWABS || (k == I_ICE && !soil_ice);
    if (ins[k] == nullptr && !optional) return -1;
  }
  if (outs[O_T] == nullptr ||
      (soil_ice && (outs[O_LIQ] == nullptr || outs[O_ICE] == nullptr)))
    return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4)
    return launch<float>(cap, ins, strides, outs, n, nl, soil_ice,
                         latent_ramp, dt, geom, geom_dev, scratch, s);
  if (dtype_bytes == 8)
    return launch<double>(cap, ins, strides, outs, n, nl, soil_ice,
                          latent_ramp, dt, geom, geom_dev, scratch, s);
  return -1;
}
