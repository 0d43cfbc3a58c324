// One model day of HYBRID9 hydrology per cell: the CUDA day kernel.
//
// Replaces the TPU kernel hybrid9_tpu/physics/pallas_day.py::_day_kernel
// (launched by pallas_hydrology_day).  Same physics, line for line, as the
// plain twin hybrid9_tpu_torch/physics/day_kernel.py::hydrology_day_plain,
// whose substep is hydrology.substep_values.
//
// What bounds it on an H100: waiting, then instruction fetch and dispatch;
// not bytes and not the arithmetic units.  A cell reads and writes about 100
// values a day but runs 48 substeps, each one long dependent chain: about 20
// powf/expf (44 when the ZD09 and specific-yield profiles are refreshed
// every substep), some 140 IEEE divisions, and a 9-unknown Thomas solve done
// twice for the refinement step.  A thread cannot overlap its own chain: one
// warp alone on a scheduler needs 0.60 ms for its 32 cell-days, and every
// further warp on that scheduler adds 0.12-0.15 ms (NVIDIA H100 80GB HBM3,
// 700 W; scripts/day_kernel_sweep.py).  So the card must hold many warps,
// and the 0.5-degree grid (69,632 cells, 2,176 warps) should be resident in
// ONE round: 17 warps on each of 132 SMs.  Two things stand in the way:
//  - registers: an SM's 65,536 are four files of 16,384, one per scheduler,
//    so a fifth warp on a scheduler leaves 96 registers a thread (not 120),
//    and the column state, the cached profiles, the tridiagonal bands and
//    the day's constants are about 200 values a cell at nl=8;
//  - code size: with every layer loop unrolled the substep is 12,600
//    instructions (200 KB), more than the instruction caches hold, and each
//    resident warp streams it 48 times a day.
//
// What the design does about it (the main-path instances, float32 nl=8):
//  - One thread per cell, blocks of one warp (residency counts in warps), a
//    block per 32 cells: the hardware hands blocks out as earlier ones
//    finish, which evens out cells of unequal cost (frozen columns take
//    half as long again; a persistent grid whose threads walk cells
//    t, t + threads, ... measured slower wherever cells differ).
//  - The loops over layers stay loops (Build::rolled): the heavy per-layer code
//    (two powf and five divisions a layer in the row loop, three or four
//    powf a layer in the profile refresh) exists once, the substep is 5,200
//    instructions, and 96 registers nearly suffice (some 150 bytes spilt).
//  - A rolled loop indexes its vectors at run time, so they live in dynamic
//    shared memory, laid out [slot][thread] (a warp reads 32 consecutive
//    words: no bank conflict): the cached zq and sy, the lagged smp, theta,
//    the bands a, b, c, r and the soil-parameter rows: 98 words a thread,
//    12,544 bytes a block, 17 blocks an SM (each also reserves 1 KB of the
//    SM's 228 KB).  theta takes the slots of r.  The solve's scratch (pivots,
//    multipliers, dw) stays in registers with the solve unrolled, the imp
//    row is read from global memory (L1), h and the daily sums stay in
//    registers.  The second Thomas sweep reuses the pivots of the first (the
//    same values, bit for bit).
//  - State in and out as the model holds it, [n, nl]: a thread's row is
//    nl consecutive values (a 32-byte sector at float32 nl=8), fetched and
//    stored with 16-byte accesses, so a warp moves exactly its tile's
//    bytes; parameter rows are staged into shared memory once a day.
//  - The raw forcing goes in; rnet, par, rain and lamb are formed here with
//    unfused multiplies and adds, bitwise hydrology.derive_forcing's.
//  - Branches stand where JAX evaluated both sides of a select.  Geometry
//    expressions that JAX folds in double precision are folded in double on
//    the host and rounded once.  No fast math: pow and exp are powf/expf
//    (pow/exp in double).  A cell's arithmetic does not depend on its place
//    in the tensor.
// Off the main path, float32 nl=20 is rolled as well, with the solve's
// scratch and the imp row in shared memory too (324 words a thread, 5 warps
// an SM, 168-191 registers, no spills).  The four float64 instances keep
// every loop unrolled and the state in registers (255, with spills; 8 warps
// an SM) and stage the parameter rows, at nl=8 the imp row too: rolled,
// they need so much shared memory that 2-6 warps an SM remain, which
// measured slower at 33,792 cells.
//
// Built by hybrid9_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C entries at the bottom.  How each instance
// is built stands in Build below; the builds that were measured against
// these and lost, with their times: PERF.md, section 6.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

// physics/constants.py, folded exactly as Python folds them.
constexpr double RHOW = 1000.0;
constexpr double MAIR = 28.9655;
constexpr double MWAT = 18.015;
constexpr double GASC = 8.314510;
constexpr double RGAS = 1000.0 * GASC / MAIR;
constexpr double MRAT = MWAT / MAIR;
constexpr double BYMRAT = 1.0 / MRAT;
constexpr double DELTX = BYMRAT - 1.0;
constexpr double TF = 273.16;
constexpr double STBO = 5.67e-8;
constexpr double SMPMIN = -1.0e8;
constexpr double WATMIN = 0.01;
constexpr double CP_AIR = 1010.0;
constexpr double RSC_MAX = 1.0e8;
constexpr double HKDEPTH = 1.0 / 2.5;
constexpr double FFF = 1.0 / HKDEPTH;
constexpr double RSUB_TOP_MAX = 5.5e-3;

constexpr int N_IN = 21;          // input pointers, in the wrapper's order
constexpr int N_OUT = 8;          // output pointers
constexpr int BLOCK = 32;        // threads per block: one warp
constexpr int MAX_DEVICES = 64;

// How an instance is built.  Every instance stages the soil-parameter and
// root rows in shared memory.  `rolled` keeps the loops over layers as
// loops, which index their vectors at run time: the cached zq and sy, the
// lagged smp, theta and the bands a, b, c, r then live in shared memory
// too (unrolled, they are registers).  `solve_shared` puts the solve's
// scratch (pivots, multipliers, dw) there as well and rolls the solve;
// `imp_shared` stages the imp row, which is otherwise read from global
// memory.  `min_blocks` is the resident blocks an SM that __launch_bounds__
// asks for, which caps the registers.
// The float64 instances: unrolled at the register cap, 8 warps an SM.
template <typename Real, int NL>
struct Build {
  static constexpr bool rolled = false;
  static constexpr bool solve_shared = false;
  static constexpr bool imp_shared = NL <= 8;
  static constexpr int min_blocks = 1;
};
// The main path: 98 words of shared memory and 96 registers a thread, 17
// warps an SM.
template <>
struct Build<float, 8> {
  static constexpr bool rolled = true;
  static constexpr bool solve_shared = false;
  static constexpr bool imp_shared = false;
  static constexpr int min_blocks = 17;
};
// 324 words a thread, 5 warps an SM.
template <>
struct Build<float, 20> {
  static constexpr bool rolled = true;
  static constexpr bool solve_shared = true;
  static constexpr bool imp_shared = true;
  static constexpr int min_blocks = 1;
};

// First slot of each vector in a thread's shared memory.  theta takes the
// slots of r: a row's right-hand side is written after the last read of
// its theta.
template <typename Real, int NL, bool WITH_IMP>
struct Layout {
  using B = Build<Real, NL>;
  static constexpr int on(bool shared, int words) {
    return shared ? words : 0;
  }
  static constexpr int ts = 0;
  static constexpr int bs = ts + NL;
  static constexpr int hk = bs + NL;
  static constexpr int ps = hk + NL;
  static constexpr int rootr = ps + NL;
  static constexpr int imp = rootr + NL;
  static constexpr int zq = imp + on(WITH_IMP && B::imp_shared, NL);
  static constexpr int sy = zq + on(B::rolled, NL);
  static constexpr int smp = sy + on(B::rolled, NL);
  static constexpr int a = smp + on(B::rolled, NL);
  static constexpr int b = a + on(B::rolled, NL);
  static constexpr int c = b + on(B::rolled, NL + 1);
  static constexpr int r = c + on(B::rolled, NL);
  static constexpr int theta = r;
  static constexpr int gam = r + on(B::rolled, NL + 1);
  static constexpr int bet = gam + on(B::solve_shared, NL);
  static constexpr int dw = bet + on(B::solve_shared, NL + 1);
  static constexpr int words = dw + on(B::solve_shared, NL + 1);
};

// Static geometry, each entry rounded once from its double value.
template <typename Real, int NL>
struct Geom {
  Real zi[NL + 2];    // interface depths (mm)
  Real zi_m[NL + 2];  // zi / 1000 (m)
  Real dzi[NL];       // zi[i+1] - zi[i]
  Real dz[NL];        // layer thickness (mm)
  Real thden[NL];     // dz * RHOW / 1e3
  Real dz_dt[NL];     // dz / dt
  Real zc[NL];        // node depths (mm)
  Real dzc[NL];       // zc[i+1] - zc[i], i < NL - 1
  Real dt;
  Real qlim;          // 10 / dt
};

template <typename Real, int NL>
struct Args {
  const Real* in[N_IN];
  Real* out[N_OUT];
  int stride[N_IN];   // elements from one cell to the next, per input
  Geom<Real, NL> g;
  int n;
  int nisurf;
  int zd09_every;
};

// Input slots (see day_kernel.py::hydrology_day_cuda).
enum {
  I_H, I_SMP, I_ZWT, I_WA, I_ROOTR, I_LAI, I_LITTER, I_TS, I_HK, I_PS,
  I_BS, I_FMAX, I_IMP, I_TAS, I_RHS, I_RSDS, I_RLDS, I_PR, I_HUSS, I_PSAIR,
  I_SWABS
};
enum { O_H, O_SMP, O_ZWT, O_WA, O_EVAP, O_EVAP_GRND, O_RNF, O_RES };

// jnp.maximum / jnp.minimum propagate NaN (fmaxf/fminf would drop it).
template <typename Real>
__device__ __forceinline__ Real vmax(Real a, Real b) {
  return (a > b || a != a) ? a : b;
}
template <typename Real>
__device__ __forceinline__ Real vmin(Real a, Real b) {
  return (a < b || a != a) ? a : b;
}
template <typename Real>
__device__ __forceinline__ Real clip(Real x, Real lo, Real hi) {
  return vmin(vmax(x, lo), hi);
}
__device__ __forceinline__ float pw(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pw(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float ex(float a) { return expf(a); }
__device__ __forceinline__ double ex(double a) { return exp(a); }

// Multiply, add and subtract that the compiler may not fuse: the derived
// forcing is formed as separate roundings, as plain tensor code forms it.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// 16 bytes of a row, through the read-only path, and back.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 w = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = w.x; v[1] = w.y;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
template <typename Real, int NL>
__device__ __forceinline__ void load_row(const Real* p, Real (&v)[NL]) {
  constexpr int PER = 16 / sizeof(Real);
  static_assert(NL % PER == 0, "a row is a whole number of 16-byte words");
#pragma unroll
  for (int k = 0; k < NL; k += PER) load16(p + k, v + k);
}
template <typename Real, int NL>
__device__ __forceinline__ void store_row(Real* p, const Real (&v)[NL]) {
  constexpr int PER = 16 / sizeof(Real);
#pragma unroll
  for (int k = 0; k < NL; k += PER) store16(p + k, v + k);
}

// N values of one thread, in registers or in the thread's shared-memory
// slots first, first + BLOCK, ...  A register vector takes compile-time
// indices only (after unrolling); a shared one may be indexed at run time.
template <typename Real, int N, bool SHARED>
struct Vec;
template <typename Real, int N>
struct Vec<Real, N, false> {
  Real v[N];
  __device__ __forceinline__ explicit Vec(Real*) {}
  __device__ __forceinline__ Real get(int i) const { return v[i]; }
  __device__ __forceinline__ void set(int i, Real x) { v[i] = x; }
};
template <typename Real, int N>
struct Vec<Real, N, true> {
  Real* p;
  __device__ __forceinline__ explicit Vec(Real* first) : p(first) {}
  __device__ __forceinline__ Real get(int i) const { return p[i * BLOCK]; }
  __device__ __forceinline__ void set(int i, Real x) { p[i * BLOCK] = x; }
};

// One [n, nl] input row of the thread's cell: staged into shared slots by
// stage(), or (the imp row of some instances) read from global memory at
// each use.  The index may be a run-time value.
template <typename Real, int NL, bool SHARED>
struct Row {
  const Real* g;
  Real* s;
  __device__ __forceinline__ Row(const Real* row, Real* first)
      : g(row), s(first) {}
  __device__ __forceinline__ void stage() const {
    if (SHARED) {
      Real v[NL];
      load_row<Real, NL>(g, v);
#pragma unroll
      for (int i = 0; i < NL; ++i) s[i * BLOCK] = v[i];
    }
  }
  __device__ __forceinline__ Real get(int i) const {
    return SHARED ? s[i * BLOCK] : __ldg(g + i);
  }
};

// soilwater.water_table_index: interfaces zi[1..NL] above the table.
template <typename Real, int NL>
__device__ __forceinline__ int water_table_index(Real zwt,
                                                 const Geom<Real, NL>& g) {
  int jwt = 0;
#pragma unroll
  for (int i = 1; i <= NL; ++i) jwt += (zwt > g.zi_m[i]) ? 1 : 0;
  return jwt;
}

// soilwater._equilibrium_profile, one layer.
template <typename Real, int NL>
__device__ __forceinline__ Real equilibrium_zq(int i, Real zwtmm, Real ts,
                                               Real ps, Real bs,
                                               const Geom<Real, NL>& g) {
  const Real one = Real(1);
  const Real zlo = g.zi[i], zhi = g.zi[i + 1];
  const bool mask_sat = zwtmm <= zlo;
  const bool mask_in = (zwtmm < zhi) && (zwtmm > zlo);
  const Real expo = one - one / bs;
  const Real neg_psi = -ps;
  Real vol_eq;
  if (mask_sat) {
    vol_eq = ts;
  } else {
    const Real temp0_lo = pw((neg_psi + zwtmm - zlo) / neg_psi, expo);
    if (mask_in) {
      const Real voleq1 =
          ps * ts / (one - one / bs) / (zwtmm - zlo) * (one - temp0_lo);
      const Real vol_in =
          (voleq1 * (zwtmm - zlo) + ts * (zhi - zwtmm)) / g.dzi[i];
      vol_eq = vmax(vmin(ts, vol_in), Real(0));
    } else {
      const Real base_hi = (neg_psi + zwtmm - zhi) / neg_psi;
      const Real vol_below = ps * ts / (one - one / bs) / g.dzi[i] *
                             (pw(base_hi, expo) - temp0_lo);
      vol_eq = vmin(ts, vmax(vol_below, Real(0)));
    }
  }
  const Real zq = ps * pw(vmax(vol_eq / ts, Real(0.01)), -bs);
  return vmax(Real(SMPMIN), zq);
}

// soilwater._aquifer_zq: zero unless the table is below the column.
template <typename Real, int NL>
__device__ __forceinline__ Real aquifer_zq(Real zwtmm, int jwt, Real tsl,
                                           Real psl, Real bl,
                                           const Geom<Real, NL>& g) {
  if (jwt != NL) return Real(0);
  const Real one = Real(1);
  const Real temp0_aq = pw((-psl + zwtmm - g.zi[NL]) / (-psl), one - one / bl);
  Real vol_aq =
      psl * tsl / (one - one / bl) / (zwtmm - g.zi[NL]) * (one - temp0_aq);
  vol_aq = vmin(tsl, vmax(vol_aq, Real(0)));
  return vmax(Real(SMPMIN), psl * pw(vmax(vol_aq / tsl, Real(0.01)), -bl));
}

// drainage._specific_yield.
template <typename Real>
__device__ __forceinline__ Real specific_yield(Real ts, Real ps, Real bs,
                                               Real zwtmm) {
  const Real s_y =
      ts * (Real(1) - pw(Real(1) + zwtmm / (-ps), Real(-1) / bs));
  return vmax(s_y, Real(0.02));
}

// What one soil layer contributes to the tridiagonal rows.
template <typename Real>
struct Node {
  Real hk, dhkdw, smp, dsmpdw;
};

// The flux across one interface and its two derivatives
// (soilwater.soil_water_update: qout of the layer above, qin of the one
// below).
template <typename Real>
struct Flux {
  Real q, d1, d2;
};
template <typename Real>
__device__ __forceinline__ Flux<Real> interface_flux(
    const Node<Real>& up, Real smp_dn, Real dsmpdw_dn, Real zq_up, Real zq_dn,
    Real den) {
  const Real num = (smp_dn - up.smp) - (zq_dn - zq_up);
  Flux<Real> f;
  f.q = -up.hk * num / den;
  f.d1 = -(-up.hk * up.dsmpdw + num * up.dhkdw) / den;
  f.d2 = -(up.hk * dsmpdw_dn + num * up.dhkdw) / den;
  return f;
}

template <typename Real, int NL, bool WITH_IMP>
__global__ void __launch_bounds__(BLOCK, Build<Real, NL>::min_blocks)
    day_kernel(const Args<Real, NL> args) {
  using B = Build<Real, NL>;
  using L = Layout<Real, NL, WITH_IMP>;
  constexpr int M = NL + 1;  // unknowns: the layers and the aquifer
  // Rolled, the loops over layers stay loops (unroll factor 1) and index
  // the shared-memory vectors at run time; unrolled, every index is a
  // constant and the vectors live in registers.  The solve's loops roll
  // only where its scratch is in shared memory.
  constexpr bool ROLLED = B::rolled;
  static_assert(ROLLED || !B::solve_shared, "only a rolled build rolls the "
                                            "solve");
  constexpr int UL = ROLLED ? 1 : NL;          // unroll factor, layer loops
  constexpr int UM = B::solve_shared ? 1 : M;  // unroll factor, the solve
  extern __shared__ __align__(16) unsigned char h9_shared[];
  Real* const sm = reinterpret_cast<Real*>(h9_shared) + threadIdx.x;
  auto slot = [&](int first) -> Real* { return sm + first * BLOCK; };

  // One cell a thread; the last block masks its ragged tail.
  const int cell = blockIdx.x * BLOCK + threadIdx.x;
  if (cell >= args.n) return;
  const Geom<Real, NL>& g = args.g;
  const Real dt = g.dt;
  const Real one = Real(1), zero = Real(0);
  const bool cached = args.zd09_every > 1;

  Vec<Real, NL, ROLLED> zq(slot(L::zq)), sy(slot(L::sy));
  // a[i] and gam[i] are stored at i - 1 (a[0] and gam[0] are never read);
  // c[NL] is zero and never read.
  Vec<Real, NL, ROLLED> a(slot(L::a)), c(slot(L::c));
  Vec<Real, M, ROLLED> b(slot(L::b)), r(slot(L::r));
  Vec<Real, NL, B::solve_shared> gam(slot(L::gam));
  Vec<Real, M, B::solve_shared> bet(slot(L::bet)), dw(slot(L::dw));
  Vec<Real, NL, ROLLED> smp(slot(L::smp)), theta(slot(L::theta));

  auto at = [&](int k) -> const Real* {
    return args.in[k] + static_cast<size_t>(cell) * args.stride[k];
  };
  auto vec = [&](int k) -> Real { return __ldg(at(k)); };

  const Row<Real, NL, true> p_ts(at(I_TS), slot(L::ts)),
      p_bs(at(I_BS), slot(L::bs)), p_hk(at(I_HK), slot(L::hk)),
      p_ps(at(I_PS), slot(L::ps)), p_rootr(at(I_ROOTR), slot(L::rootr));
  const Row<Real, NL, WITH_IMP && B::imp_shared> p_imp(
      WITH_IMP ? at(I_IMP) : nullptr, slot(L::imp));
  p_ts.stage();
  p_bs.stage();
  p_hk.stage();
  p_ps.stage();
  p_rootr.stage();
  if (WITH_IMP) p_imp.stage();

  // The carry.
  Real h[NL];
  load_row<Real, NL>(at(I_H), h);
  {
    Real row[NL];
    load_row<Real, NL>(at(I_SMP), row);
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      smp.set(i, row[i]);
      zq.set(i, zero);
      sy.set(i, zero);
    }
  }
  Real zwt = vec(I_ZWT), wa = vec(I_WA);
  Real evap = zero, evap_grnd = zero, rnf = zero, max_res = zero;

  // The day's constants.
  const Real lai = vec(I_LAI), litter = vec(I_LITTER), f_max = vec(I_FMAX);
  Real rain, rnet, par, lamb, rho, desatdT, vdd, gamma, vpd_att, rsc_min,
      rac, raa, ras, rnets, g_soil;
  {
    // hydrology.derive_forcing, each operation rounded on its own.
    const Real tak = vec(I_TAS), rh = vec(I_RHS), rsds = vec(I_RSDS),
               rlds = vec(I_RLDS), pr = vec(I_PR), huss = vec(I_HUSS),
               psair = vec(I_PSAIR);
    const Real sw_abs =
        args.in[I_SWABS] != nullptr ? vec(I_SWABS) : Real(0.92);
    const Real t2 = mul_rn(tak, tak);
    rnet = sub_rn(add_rn(mul_rn(sw_abs, rsds), rlds),
                  mul_rn(Real(STBO), mul_rn(t2, t2)));
    par = mul_rn(mul_rn(sw_abs, rsds), Real(2.3));
    rain = mul_rn(Real(1.0e3), pr) / Real(RHOW);
    lamb = mul_rn(sub_rn(Real(2503.0),
                         mul_rn(Real(2.386), sub_rn(tak, Real(TF)))),
                  Real(1.0e3));

    // et.daily_et_context, once per cell and day.
    const Real tsv = tak * (one + huss * Real(DELTX));
    rho = psair / (Real(RGAS) * tsv);
    const Real tc = tak - Real(TF);
    const Real tc_off = tc + Real(237.3);
    desatdT = (Real(4098.0) * (Real(0.6108) * ex(Real(17.27) * tc / tc_off))) /
              (tc_off * tc_off);
    desatdT = desatdT * Real(18.0) / (Real(GASC) * tak);
    Real esat = Real(0.6108) * ex(Real(17.27) * tc / tc_off);
    esat = esat * Real(18.0) / (Real(GASC) * tak);
    vdd = esat * (one - rh / Real(100.0));
    gamma = (Real(CP_AIR) * psair / (lamb * Real(0.622))) *
            (Real(18.0e-3) / (Real(GASC) * tak));
    const Real lai_safe = lai > zero ? lai : one;
    rnets = rnet * ex(Real(-0.7) * lai);
    g_soil = Real(0.2) * rnets;
    vpd_att = pw(Real(2.8), Real(-80.0) * vmax(zero, vdd) / rho);
    rsc_min = one / ((lai_safe / Real(2.7)) * Real(0.9) /
                     (rho * Real(1.0e3) / Real(18.0)));
    rac = lai > zero ? Real(25.0) / (Real(2.0) * lai_safe) : Real(1.0e6);
    raa = lai <= Real(4.0)
              ? Real(0.25) * lai * Real(42.0) +
                    Real(0.25) * (Real(4.0) - lai) * Real(34.0)
              : Real(42.0);
    ras = lai <= Real(4.0)
              ? Real(0.25) * lai * Real(128.0) +
                    Real(0.25) * (Real(4.0) - lai) * Real(49.0)
              : Real(128.0);
  }

  for (int it = 0; it < args.nisurf; ++it) {
    // ZD09 and specific-yield profiles at the current table: every
    // substep, or every zd09_every substeps from it = 0.
    if (!cached || it % args.zd09_every == 0) {
      const Real zwtmm0 = Real(1000.0) * zwt;
#pragma unroll(UL)
      for (int i = 0; i < NL; ++i) {
        const Real ts = p_ts.get(i), ps = p_ps.get(i), bs = p_bs.get(i);
        zq.set(i, equilibrium_zq<Real, NL>(i, zwtmm0, ts, ps, bs, g));
        sy.set(i, specific_yield(ts, ps, bs, zwtmm0));
      }
    }

    // --- hydrology.substep_values --------------------------------------
    Real sum_h = h[0];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      theta.set(i, h[i] / g.thden[i]);
      if (i > 0) sum_h = sum_h + h[i];
    }
    const Real w0 = rain * dt + wa + sum_h;

    const Real fsat = f_max * ex(Real(-0.5 * FFF) * zwt);
    Real qflx_surf = fsat * rain;

    // et.dual_source_et
    Real beta = zero;
#pragma unroll(UL)
    for (int i = 0; i < NL; ++i) {
      const Real beta_l = one - (smp.get(i) - g.zc[i]) / Real(-150000.0);
      const Real term = p_rootr.get(i) * clip(beta_l, zero, one);
      beta = (i == 0) ? term : beta + term;
    }
    const Real ts0 = p_ts.get(0);
    const Real th0 = theta.get(0);
    const Real rootr0 = p_rootr.get(0);
    Real qtran, qevap;
    {
      const Real lai_safe = lai > zero ? lai : one;
      const bool active = (lai > zero) && (beta > zero) && (par > zero);
      const Real beta_safe = beta > zero ? beta : one;
      const Real par_safe = par > zero ? par : one;
      const Real rsc_a =
          (one / (par_safe / (par_safe + Real(300.0)))) * Real(400.0) /
          (Real(2.0) * lai_safe * vpd_att);
      const Real rsc_raw = rsc_a / vmax(beta_safe, rsc_a / Real(RSC_MAX));
      Real rsc = active ? rsc_raw : Real(1.0e6);
      if (lai > zero) rsc = vmax(rsc, rsc_min);
      rsc = vmin(rsc, Real(RSC_MAX));

      const Real rss =
          th0 <= Real(0.15)
              ? (Real(10.0) + Real(1000.0) * litter) *
                    ex(Real(0.3563 * 100.0) * (Real(0.15) - th0))
              : Real(10.0) + Real(1000.0) * litter * (one - th0 / ts0);

      const Real pmc =
          (desatdT * (rnet - g_soil) +
           (rho * Real(CP_AIR) * vdd - desatdT * rac * (rnets - g_soil)) /
               (raa + rac)) /
          (desatdT + gamma * (one + rsc / (raa + rac)));
      const Real pms =
          (desatdT * (rnet - g_soil) +
           (rho * Real(CP_AIR) * vdd - desatdT * ras * (rnet - rnets)) /
               (raa + ras)) /
          (desatdT + gamma * (one + rss / (raa + ras)));
      const Real r_a = (desatdT + gamma) * raa;
      const Real r_s = (desatdT + gamma) * ras + gamma * rss;
      const Real r_c = (desatdT + gamma) * rac + gamma * rsc;
      const Real ccw = one / (one + r_c * r_a / (r_s * (r_c + r_a)));
      const Real csw = one / (one + r_s * r_a / (r_c * (r_s + r_a)));
      const Real le = ccw * pmc + csw * pms;
      const Real vdd0 = vdd + (desatdT * (rnet - g_soil) -
                               (desatdT + gamma) * le) *
                                  raa / (rho * Real(CP_AIR));
      const Real lec =
          (desatdT * (rnet - rnets) + rho * Real(CP_AIR) * vdd0 / rac) /
          (desatdT + gamma * (one + rsc / rac));
      const Real les =
          (desatdT * (rnets - g_soil) + rho * Real(CP_AIR) * vdd0 / ras) /
          (desatdT + gamma * (one + rss / ras));
      qtran = lec * Real(1.0e3) / (Real(RHOW) * lamb);
      qevap = les * Real(1.0e3) / (Real(RHOW) * lamb);
      Real evap_max1 =
          g.dz[0] * (th0 - Real(WATMIN)) / dt - qtran * rootr0;
      evap_max1 = vmax(zero, evap_max1);
      qevap = vmin(evap_max1, qevap);
    }

    // Infiltration.
    const Real qflx_in_soil = (rain - qflx_surf) - qevap;
    Real qinmax = (one - fsat) * vmin(vmin(p_hk.get(0), p_hk.get(1)),
                                      p_hk.get(2));
    if (WITH_IMP) qinmax = qinmax * p_imp.get(0);
    const Real infl_excess = vmax(zero, qflx_in_soil - qinmax);
    const Real qflx_infl = qflx_in_soil - infl_excess;
    qflx_surf = qflx_surf + infl_excess;

    // --- soilwater.soil_water_update ------------------------------------
    const Real zwtmm = Real(1000.0) * zwt;
    const int jwt = water_table_index<Real, NL>(zwt, g);
    const bool in_col = jwt < NL;
    const bool below = !in_col;
    // theta at the table's layer, for the recharge below: read before
    // the rows are written, which may take theta's slots.
    Real th_j = one;
    if (in_col) {
      if (ROLLED) {
        th_j = theta.get(jwt);
      } else {
#pragma unroll
        for (int i = 0; i < NL; ++i)
          if (jwt == i) th_j = theta.get(i);
      }
    }
    const Real zq_aq = aquifer_zq<Real, NL>(
        zwtmm, jwt, p_ts.get(NL - 1), p_ps.get(NL - 1), p_bs.get(NL - 1),
        g);

    // Conductivity, potential and their derivatives of layer i.
    auto node = [&](int i) -> Node<Real> {
      const int inext = (i + 1 < NL) ? i + 1 : NL - 1;
      const Real ts = p_ts.get(i), tsn = p_ts.get(inext);
      const Real bs = p_bs.get(i);
      const Real th = theta.get(i);
      Real s1 = Real(0.5) * (th + theta.get(inext)) /
                (Real(0.5) * (ts + tsn));
      s1 = vmin(one, s1);
      Real s2 = p_hk.get(i) * pw(s1, Real(2.0) * bs + Real(2.0));
      if (WITH_IMP) s2 = s2 * vmin(p_imp.get(i), p_imp.get(inext));
      Node<Real> nd;
      nd.hk = s1 * s2;
      nd.dhkdw = (Real(2.0) * bs + Real(3.0)) * s2 * (one / (ts + tsn));
      const Real s_node = clip(th / ts, Real(0.01), one);
      nd.smp = vmax(Real(SMPMIN), p_ps.get(i) * pw(s_node, -bs));
      nd.dsmpdw = -bs * nd.smp / (s_node * ts);
      return nd;
    };

    const Real zc_aq = Real(0.5) * (zwtmm + g.zc[NL - 1]);
    const Real dz_aq = in_col ? g.dz[NL - 1] : zwtmm - g.zc[NL - 1];

    // The tridiagonal rows, top to bottom: the flux across the interface
    // under layer i - 1 is qout of row i - 1 and qin of row i.
    Node<Real> cur{zero, zero, zero, zero};
    Flux<Real> in{zero, zero, zero};
#pragma unroll(UL)
    for (int i = 0; i < NL; ++i) {
      const Node<Real> nd = node(i);
      smp.set(i, nd.smp);  // the lagged potential for the next substep
      if (i > 0) {
        const Flux<Real> out = interface_flux(
            cur, nd.smp, nd.dsmpdw, zq.get(i - 1), zq.get(i), g.dzc[i - 1]);
        if (i == 1) {
          r.set(0, qflx_infl - out.q - qtran * rootr0);
          b.set(0, g.dz_dt[0] + out.d1);
        } else {
          r.set(i - 1, in.q - out.q - qtran * p_rootr.get(i - 1));
          a.set(i - 2, -in.d1);
          b.set(i - 1, g.dz_dt[i - 1] - in.d2 + out.d1);
        }
        c.set(i - 1, out.d2);
        in = out;
      }
      cur = nd;
    }
    {
      constexpr int i = NL - 1;
      a.set(i - 1, -in.d1);
      const Real rootr_i = p_rootr.get(i);
      if (below) {
        // Aquifer coupling (table below the column).
        const Real ts = p_ts.get(i), bs = p_bs.get(i);
        const Real s_node_aq =
            clip(Real(0.5) * (one + theta.get(i) / ts), Real(0.01), one);
        const Real smp_aq =
            vmax(Real(SMPMIN), p_ps.get(i) * pw(s_node_aq, -bs));
        const Real dsmpdw_aq = -bs * smp_aq / (s_node_aq * ts);
        const Flux<Real> out = interface_flux(
            cur, smp_aq, dsmpdw_aq, zq.get(i), zq_aq, zc_aq - g.zc[i]);
        r.set(i, in.q - out.q - qtran * rootr_i);
        b.set(i, g.dz_dt[i] - in.d2 + out.d1);
        c.set(i, out.d2);
        r.set(NL, out.q);
        a.set(NL - 1, -out.d1);
        b.set(NL, dz_aq / dt - out.d2);
      } else {
        r.set(i, in.q - zero - qtran * rootr_i);
        b.set(i, g.dz_dt[i] - in.d2);
        c.set(i, zero);
        r.set(NL, zero);
        a.set(NL - 1, zero);
        b.set(NL, dz_aq / dt);
      }
    }

    // soilwater._thomas_solve_refined: solve, then one refinement step
    // on the residual, which overwrites r; the second sweep reuses the
    // first one's pivots bet and multipliers gam.
    {
      Real betv = b.get(0);
      Real x = r.get(0) / betv;
      bet.set(0, betv);
      dw.set(0, x);
#pragma unroll(UM)
      for (int i = 1; i < M; ++i) {
        const Real gi = c.get(i - 1) / betv;
        const Real ai = a.get(i - 1);
        betv = b.get(i) - ai * gi;
        x = (r.get(i) - ai * x) / betv;
        gam.set(i - 1, gi);
        bet.set(i, betv);
        dw.set(i, x);
      }
#pragma unroll(UM)
      for (int i = M - 2; i >= 0; --i) {
        x = dw.get(i) - gam.get(i) * x;
        dw.set(i, x);
      }
#pragma unroll(UM)
      for (int i = 0; i < M; ++i) {
        Real yi = b.get(i) * dw.get(i);
        if (i > 0) yi = yi + a.get(i - 1) * dw.get(i - 1);
        if (i < M - 1) yi = yi + c.get(i) * dw.get(i + 1);
        r.set(i, r.get(i) - yi);
      }
      x = r.get(0) / bet.get(0);
      r.set(0, x);
#pragma unroll(UM)
      for (int i = 1; i < M; ++i) {
        x = (r.get(i) - a.get(i - 1) * x) / bet.get(i);
        r.set(i, x);
      }
#pragma unroll(UM)
      for (int i = M - 2; i >= 0; --i) {
        x = r.get(i) - gam.get(i) * x;
        r.set(i, x);
      }
#pragma unroll(UM)
      for (int i = 0; i < M; ++i) dw.set(i, dw.get(i) + r.get(i));
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) h[i] = h[i] + dw.get(i) * g.dz[i];

    // Aquifer recharge.
    Real qcharge;
    if (in_col) {
      Real zq_jm = zero, smp_jm = zero, zc_jm = zero;
      const int jm = jwt - 1 > 0 ? jwt - 1 : 0;
      if (ROLLED) {
        smp_jm = smp.get(jm);
        zq_jm = zq.get(jm);
        zc_jm = g.zc[jm];
      } else {
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          if (jm == i) {
            smp_jm = smp.get(i);
            zq_jm = zq.get(i);
            zc_jm = g.zc[i];
          }
        }
      }
      const Real ts_j = p_ts.get(jwt), hk_j = p_hk.get(jwt),
                 b_j = p_bs.get(jwt);
      const Real s1q = clip(th_j / ts_j, Real(0.01), one);
      const Real ka = hk_j * pw(s1q, Real(2.0) * b_j + Real(3.0));
      const Real wh = vmax(Real(SMPMIN), smp_jm) - zq_jm;
      const Real den_q =
          jwt == 0 ? zwtmm + one : (zwtmm - zc_jm) * Real(2.0);
      qcharge = clip(-ka * (zero - wh) / den_q, -g.qlim, g.qlim);
    } else {
      qcharge = dw.get(NL) * dz_aq / dt;
    }

    // --- drainage.drainage -----------------------------------------------
    // The walks use the stale zwtmm and jwt of the substep start.
    const Real rous = sy.get(NL - 1);
    const Real qtot = qcharge * dt;
    Real zwt1 = zwt, wa1 = wa;
    int jwt1 = jwt;
    if (below) {
      wa1 = wa + qcharge * dt;
      zwt1 = zwt - (qcharge * dt) / Real(1000.0) / rous;
    } else {
      const bool rising = qtot > zero;
      Real zwt_w = zwt;
      if (rising) {
        Real rem = qtot;
#pragma unroll(UL)
        for (int i = NL - 1; i >= 0; --i) {
          if (i <= jwt && rem > zero) {
            const Real s_y = sy.get(i);
            const Real ql =
                vmax(vmin(rem, s_y * (zwtmm - g.zi[i])), zero);
            zwt_w = zwt_w - ql / s_y / Real(1000.0);
            rem = rem - ql;
          }
        }
      } else {
        Real rem_f = qtot;
#pragma unroll(UL)
        for (int i = 0; i < NL; ++i) {
          if (i >= jwt && rem_f < zero) {
            const Real s_y = sy.get(i);
            const Real ql =
                vmin(vmax(rem_f, -s_y * (g.zi[i + 1] - zwtmm)), zero);
            const Real rem_new = rem_f - ql;
            zwt_w = rem_new >= zero ? zwt_w - ql / s_y / Real(1000.0)
                                    : g.zi_m[i + 1];
            rem_f = rem_new;
          }
        }
        if (rem_f > zero) zwt_w = zwt_w - rem_f / Real(1000.0) / rous;
      }
      zwt1 = zwt_w;
      jwt1 = water_table_index<Real, NL>(zwt1, g);
    }

    // Baseflow.  Without the cache, the yields come fresh at zwtmm1.
    const Real zwtmm1 = Real(1000.0) * zwt1;
    auto sy1 = [&](int i) -> Real {
      return cached ? sy.get(i)
                    : specific_yield(p_ts.get(i), p_ps.get(i),
                                     p_bs.get(i), zwtmm1);
    };
    Real rsub_top =
        Real(RSUB_TOP_MAX) * ex(Real(-FFF) * vmax(zwt1, Real(-1)));
    const Real rous1 = sy1(NL - 1);
    Real zwt2, wa2;
    if (jwt1 == NL) {
      const Real wa_tmp = wa1 - rsub_top * dt;
      zwt2 = zwt1 + (rsub_top * dt) / Real(1000.0) / rous1;
      h[NL - 1] = h[NL - 1] + vmax(zero, wa_tmp - Real(5000.0));
      wa2 = vmin(wa_tmp, Real(5000.0));
    } else {
      Real rem_b = -rsub_top * dt;
      Real zwt_w1 = zwt1;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (i >= jwt1 && rem_b < zero) {
          const Real s_y = (i == NL - 1) ? rous1 : sy1(i);
          const Real ql =
              vmin(vmax(rem_b, -(s_y * (g.zi[i + 1] - zwtmm1))), zero);
          h[i] = h[i] + ql;
          const Real rem_new = rem_b - ql;
          zwt_w1 = rem_new >= zero ? zwt_w1 - ql / s_y / Real(1000.0)
                                   : g.zi_m[i + 1];
          rem_b = rem_new;
        }
      }
      zwt_w1 = zwt_w1 - rem_b / Real(1000.0) / rous1;
      wa2 = wa1 + rem_b;
      zwt2 = zwt_w1;
    }
    const int jwt2 =
        (jwt1 == NL) ? jwt1 : water_table_index<Real, NL>(zwt2, g);
    zwt2 = clip(zwt2, zero, Real(80.0));

    // Saturation-excess bucket cascade, bottom-up.
#pragma unroll
    for (int i = NL - 1; i > 0; --i) {
      const Real cap = vmax(Real(0.01), p_ts.get(i)) * g.dz[i];
      const Real xsi = vmax(h[i] - cap, zero);
      h[i] = vmin(cap, h[i]);
      h[i - 1] = h[i - 1] + xsi;
    }
    const Real cap0 = vmax(zero, ts0 * g.dz[0]);
    const Real xs1 = vmax(vmax(h[0], zero) - cap0, zero);
    h[0] = vmin(cap0, h[0]);
    const Real qflx_rsub_sat = xs1 / dt;

    // watmin floor: borrow from the layer below.
#pragma unroll
    for (int i = 0; i < NL - 1; ++i) {
      if (h[i] < Real(WATMIN)) {
        const Real xs = Real(WATMIN) - h[i];
        if (jwt2 == i + 1)
          zwt2 = zwt2 + xs / vmax(Real(0.01), p_ts.get(i)) / Real(1000.0);
        h[i] = h[i] + xs;
        h[i + 1] = h[i + 1] - xs;
      }
    }
    // Bottom layer: search upward for water.
    Real xs = h[NL - 1] < Real(WATMIN) ? Real(WATMIN) - h[NL - 1] : zero;
#pragma unroll
    for (int j = NL - 2; j >= 0; --j) {
      const Real avail = vmax(h[j] - Real(WATMIN) - xs, zero);
      const Real take = vmin(xs, avail);
      h[NL - 1] = h[NL - 1] + take;
      h[j] = h[j] - take;
      xs = xs - take;
    }
    h[NL - 1] = h[NL - 1] + xs;
    rsub_top = rsub_top - xs / dt;

    // Conservation residual and the daily sums.
    Real sum_h1 = h[0];
#pragma unroll
    for (int i = 1; i < NL; ++i) sum_h1 = sum_h1 + h[i];
    const Real w1 =
        (qflx_surf + qevap + qtran + rsub_top + qflx_rsub_sat) * dt + wa2 +
        sum_h1;
    const Real residual = w1 - w0;

    zwt = zwt2;
    wa = wa2;
    evap = evap + (qevap + qtran) * dt;
    evap_grnd = evap_grnd + qevap * dt;
    rnf = rnf + (qflx_surf + rsub_top) * dt;
    max_res = vmax(max_res, residual < zero ? -residual : residual);
  }

  store_row<Real, NL>(args.out[O_H] + static_cast<size_t>(cell) * NL, h);
  {
    Real row[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) row[i] = smp.get(i);
    store_row<Real, NL>(args.out[O_SMP] + static_cast<size_t>(cell) * NL,
                        row);
  }
  args.out[O_ZWT][cell] = zwt;
  args.out[O_WA][cell] = wa;
  args.out[O_EVAP][cell] = evap;
  args.out[O_EVAP_GRND][cell] = evap_grnd;
  args.out[O_RNF][cell] = rnf;
  args.out[O_RES][cell] = max_res;
}

// What the device holds of one instance, asked once per device.
struct Residency {
  bool known;
  int sms;            // streaming multiprocessors
  int blocks_per_sm;  // resident blocks of this instance an SM holds
};

template <typename Real, int NL, bool WITH_IMP>
struct Instance {
  static constexpr int shared_bytes = Layout<Real, NL, WITH_IMP>::words *
                                      BLOCK * static_cast<int>(sizeof(Real));

  static auto kernel() { return &day_kernel<Real, NL, WITH_IMP>; }

  // out = {SMs, resident blocks an SM, threads a block, shared bytes a
  // block}.  Raises the dynamic shared memory limit of the kernel on this
  // device the first time.
  static int residency(int* out) {
    static Residency cache[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES) return -2;
    Residency& res = cache[dev];
    if (!res.known) {
      e = cudaDeviceGetAttribute(&res.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaFuncSetAttribute(kernel(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shared_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &res.blocks_per_sm, kernel(), BLOCK, shared_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (res.blocks_per_sm < 1)
        return static_cast<int>(cudaErrorLaunchOutOfResources);
      // Shared memory and L1 are one array: ask for the share these
      // blocks need (each also reserves 1 KB), the rest stays L1.
      int sm_bytes = 0;
      e = cudaDeviceGetAttribute(
          &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      const long long need =
          static_cast<long long>(res.blocks_per_sm) * (shared_bytes + 1024);
      int percent = static_cast<int>((need * 100 + sm_bytes - 1) / sm_bytes);
      if (percent > 100) percent = 100;
      e = cudaFuncSetAttribute(kernel(),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               percent);
      if (e != cudaSuccess) return static_cast<int>(e);
      res.known = true;
    }
    out[0] = res.sms;
    out[1] = res.blocks_per_sm;
    out[2] = BLOCK;
    out[3] = shared_bytes;
    return 0;
  }

  static int launch(const void* const* ins, const int* strides,
                    void* const* outs, int n, int grid, int nisurf,
                    int zd09_every, double dt, const double* geom,
                    cudaStream_t stream) {
    int res[4];
    const int rc = residency(res);
    if (rc != 0) return rc;
    Args<Real, NL> args;
    for (int k = 0; k < N_IN; ++k) {
      args.in[k] = static_cast<const Real*>(ins[k]);
      args.stride[k] = strides[k];
    }
    for (int k = 0; k < N_OUT; ++k) args.out[k] = static_cast<Real*>(outs[k]);
    // geom = zi[NL + 2], dz[NL], zc[NL] in mm, as doubles.
    const double* zi = geom;
    const double* dz = geom + NL + 2;
    const double* zc = dz + NL;
    Geom<Real, NL>& g = args.g;
    for (int i = 0; i < NL + 2; ++i) {
      g.zi[i] = static_cast<Real>(zi[i]);
      g.zi_m[i] = static_cast<Real>(zi[i] / 1000.0);
    }
    for (int i = 0; i < NL; ++i) {
      g.dzi[i] = static_cast<Real>(zi[i + 1] - zi[i]);
      g.dz[i] = static_cast<Real>(dz[i]);
      g.thden[i] = static_cast<Real>(dz[i] * RHOW / 1.0e3);
      g.dz_dt[i] = static_cast<Real>(dz[i] / dt);
      g.zc[i] = static_cast<Real>(zc[i]);
      g.dzc[i] = static_cast<Real>(i + 1 < NL ? zc[i + 1] - zc[i] : 0.0);
    }
    g.dt = static_cast<Real>(dt);
    g.qlim = static_cast<Real>(10.0 / dt);
    args.n = n;
    args.nisurf = nisurf;
    args.zd09_every = zd09_every;
    day_kernel<Real, NL, WITH_IMP>
        <<<grid, BLOCK, shared_bytes, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

// Calls Instance<...>::residency or ::launch of the instance named by
// (dtype_bytes, nl, with_imp); -1 where there is none.
template <typename F>
int with_instance(int dtype_bytes, int nl, int with_imp, F f) {
  if (dtype_bytes == 4 && nl == 20)
    return with_imp ? f(Instance<float, 20, true>())
                    : f(Instance<float, 20, false>());
  if (dtype_bytes == 8 && nl == 8)
    return with_imp ? f(Instance<double, 8, true>())
                    : f(Instance<double, 8, false>());
  if (dtype_bytes == 8 && nl == 20)
    return with_imp ? f(Instance<double, 20, true>())
                    : f(Instance<double, 20, false>());
  if (dtype_bytes == 4 && nl == 8)
    return with_imp ? f(Instance<float, 8, true>())
                    : f(Instance<float, 8, false>());
  return -1;
}

}  // namespace

// Plain C entries.  dtype_bytes is 4 (float) or 8 (double).  Both return 0
// on success, a CUDA error code, or -1 for a dtype/layer count with no
// instance or a grid that does not cover the cells; both act on the
// current device.

// out[4] = {SMs of the device, resident blocks of the instance an SM
// holds, threads a block, dynamic shared bytes a block}.  Asks the device
// once and caches.
extern "C" int h9_day_residency(int dtype_bytes, int nl, int with_imp,
                                int* out) {
  return with_instance(dtype_bytes, nl, with_imp,
                       [&](auto inst) { return inst.residency(out); });
}

// ins holds N_IN device pointers in the order of the I_* slots (I_IMP is
// null when with_imp is 0, I_SWABS may be null: 0.92 everywhere), strides
// the elements from one cell to the next of each input (rows of layered
// inputs are contiguous and 16-byte aligned), outs N_OUT contiguous
// outputs; geom holds zi[nl+2], dz[nl], zc[nl] on the host.  Launches
// `grid` blocks of one warp on `stream`, a thread for each cell.
// Allocates nothing, never syncs.
extern "C" int h9_hydrology_day(int dtype_bytes, int nl, int with_imp,
                                const void* const* ins, const int* strides,
                                void* const* outs, int n, int grid,
                                int nisurf, int zd09_every, double dt,
                                const double* geom, void* stream) {
  if (n < 1 || grid < (n + BLOCK - 1) / BLOCK) return -1;
  return with_instance(dtype_bytes, nl, with_imp, [&](auto inst) {
    return inst.launch(ins, strides, outs, n, grid, nisurf, zd09_every, dt,
                       geom, static_cast<cudaStream_t>(stream));
  });
}
