// One model day of HYBRID9 hydrology per cell: the CUDA day kernel.
//
// Replaces the TPU kernel hybrid9_tpu/physics/pallas_day.py::_day_kernel
// (launched by pallas_hydrology_day).  Same physics, line for line, as the
// plain twin hybrid9_tpu_torch/physics/day_kernel.py::hydrology_day_plain,
// whose substep is hydrology.substep_values.
//
// What bounds it on an H100: arithmetic, not bytes.  A cell reads and
// writes about 100 floats per day, but runs 48 substeps of about 44
// pow/exp at zd09_every=1 (about 20 with the ZD09 and specific-yield
// profiles refreshed every 8 substeps), plus a 9-unknown Thomas solve done
// twice for the refinement step and the drainage walks.  The other limit is
// registers: the column state, the cached profiles and the tridiagonal
// bands are about 100 values per cell at nl=8, and spill at nl=20.
//
// What the design does about it: one thread per cell in a 1-D grid; the
// day's carry (h, smp, zwt, wa, the zq/sy cache and the four daily sums)
// stays in registers for all substeps and the outputs are written once;
// every layer loop is unrolled at compile time (NL is a template
// parameter), so per-cell layer picks are selects over constant indices
// and no register array is indexed dynamically; the soil parameters are
// re-read through the read-only cache each substep instead of pinning
// registers; layered fields are layer-major [nl, n], so a warp reads
// neighbouring addresses.  Branches stand where JAX evaluated both sides
// of a select: a lane computes only the side it keeps, with the same
// guards and clamps.  Geometry expressions that JAX folds in double
// precision (zi/1000, dz*RHOW/1e3, dz/dt, ...) are folded in double on the
// host and rounded once to the working type.  No fast math: pow and exp are
// powf/expf (pow/exp in double).
//
// Built by hybrid9_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through the plain C entry h9_hydrology_day at the bottom.

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
constexpr double SMPMIN = -1.0e8;
constexpr double WATMIN = 0.01;
constexpr double CP_AIR = 1010.0;
constexpr double RSC_MAX = 1.0e8;
constexpr double HKDEPTH = 1.0 / 2.5;
constexpr double FFF = 1.0 / HKDEPTH;
constexpr double RSUB_TOP_MAX = 5.5e-3;

constexpr int N_IN = 21;    // input pointers, in the wrapper's order
constexpr int N_OUT = 8;    // output pointers
constexpr int BLOCK = 128;  // threads per block

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
  Geom<Real, NL> g;
  int n;
  int nisurf;
  int zd09_every;
};

// Input slots (see day_kernel.py::hydrology_day_cuda).
enum {
  I_H, I_SMP, I_ZWT, I_WA, I_ROOTR, I_LAI, I_LITTER, I_TS, I_HK, I_PS,
  I_BS, I_FMAX, I_IMP, I_TAK, I_RH, I_RNET, I_PAR, I_RAIN, I_LAMB, I_HUSS,
  I_PSAIR
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

// soilwater._thomas_solve on M equations.
template <typename Real, int M>
__device__ __forceinline__ void thomas(const Real (&a)[M], const Real (&b)[M],
                                       const Real (&cc)[M], const Real (&r)[M],
                                       Real (&dw)[M]) {
  Real gam[M];
  Real bet = b[0];
  dw[0] = r[0] / bet;
  gam[0] = Real(0);
#pragma unroll
  for (int i = 1; i < M; ++i) {
    const Real gi = cc[i - 1] / bet;
    bet = b[i] - a[i] * gi;
    dw[i] = (r[i] - a[i] * dw[i - 1]) / bet;
    gam[i] = gi;
  }
#pragma unroll
  for (int i = M - 2; i >= 0; --i) dw[i] = dw[i] - gam[i + 1] * dw[i + 1];
}

// soilwater._thomas_solve_refined: solve, then one refinement step.
template <typename Real, int M>
__device__ __forceinline__ void thomas_refined(const Real (&a)[M],
                                               const Real (&b)[M],
                                               const Real (&cc)[M],
                                               const Real (&r)[M],
                                               Real (&dw)[M]) {
  thomas(a, b, cc, r, dw);
  Real resid[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    Real yi = b[i] * dw[i];
    if (i > 0) yi = yi + a[i] * dw[i - 1];
    if (i < M - 1) yi = yi + cc[i] * dw[i + 1];
    resid[i] = r[i] - yi;
  }
  Real err[M];
  thomas(a, b, cc, resid, err);
#pragma unroll
  for (int i = 0; i < M; ++i) dw[i] = dw[i] + err[i];
}

template <typename Real, int NL, bool WITH_IMP>
__global__ void __launch_bounds__(BLOCK)
    day_kernel(const Args<Real, NL> args) {
  const int n = args.n;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n) return;
  const Geom<Real, NL>& g = args.g;
  const Real dt = g.dt;
  const Real one = Real(1), zero = Real(0);

  // Layer-major [nl, n] rows and [n] vectors, read-only.
  auto row = [&](int slot, int i) -> Real {
    return __ldg(args.in[slot] + static_cast<size_t>(i) * n + cell);
  };
  auto vec = [&](int slot) -> Real { return __ldg(args.in[slot] + cell); };

  // The carry.
  Real h[NL], smp[NL], zq[NL], sy[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    h[i] = row(I_H, i);
    smp[i] = row(I_SMP, i);
    zq[i] = zero;
    sy[i] = zero;
  }
  Real zwt = vec(I_ZWT), wa = vec(I_WA);
  Real evap = zero, evap_grnd = zero, rnf = zero, max_res = zero;

  const Real lai = vec(I_LAI), litter = vec(I_LITTER), fmax = vec(I_FMAX);
  const Real tak = vec(I_TAK), rh = vec(I_RH), rnet = vec(I_RNET),
             par = vec(I_PAR), rain = vec(I_RAIN), lamb = vec(I_LAMB),
             huss = vec(I_HUSS), psair = vec(I_PSAIR);

  // et.daily_et_context, once per cell and day.
  const Real tsv = tak * (one + huss * Real(DELTX));
  const Real rho = psair / (Real(RGAS) * tsv);
  const Real tc = tak - Real(TF);
  const Real tc_off = tc + Real(237.3);
  Real desatdT = (Real(4098.0) * (Real(0.6108) *
                                  ex(Real(17.27) * tc / tc_off))) /
                 (tc_off * tc_off);
  desatdT = desatdT * Real(18.0) / (Real(GASC) * tak);
  Real esat = Real(0.6108) * ex(Real(17.27) * tc / tc_off);
  esat = esat * Real(18.0) / (Real(GASC) * tak);
  const Real vdd = esat * (one - rh / Real(100.0));
  const Real gamma = (Real(CP_AIR) * psair / (lamb * Real(0.622))) *
                     (Real(18.0e-3) / (Real(GASC) * tak));
  const Real lai_safe = lai > zero ? lai : one;
  const Real vpd_att =
      pw(Real(2.8), Real(-80.0) * vmax(zero, vdd) / rho);
  const Real rsc_min =
      one / ((lai_safe / Real(2.7)) * Real(0.9) /
             (rho * Real(1.0e3) / Real(18.0)));
  const Real rac = lai > zero ? Real(25.0) / (Real(2.0) * lai_safe)
                              : Real(1.0e6);
  const Real raa = lai <= Real(4.0)
                       ? Real(0.25) * lai * Real(42.0) +
                             Real(0.25) * (Real(4.0) - lai) * Real(34.0)
                       : Real(42.0);
  const Real ras = lai <= Real(4.0)
                       ? Real(0.25) * lai * Real(128.0) +
                             Real(0.25) * (Real(4.0) - lai) * Real(49.0)
                       : Real(128.0);
  const Real rnets = rnet * ex(Real(-0.7) * lai);
  const Real g_soil = Real(0.2) * rnets;

  const bool cached = args.zd09_every > 1;
  for (int it = 0; it < args.nisurf; ++it) {
    // ZD09 and specific-yield profiles at the current table: every
    // substep, or every zd09_every substeps from it = 0.
    if (!cached || it % args.zd09_every == 0) {
      const Real zwtmm0 = Real(1000.0) * zwt;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const Real ts = row(I_TS, i), ps = row(I_PS, i), bs = row(I_BS, i);
        zq[i] = equilibrium_zq<Real, NL>(i, zwtmm0, ts, ps, bs, g);
        sy[i] = specific_yield(ts, ps, bs, zwtmm0);
      }
    }

    // --- hydrology.substep_values ----------------------------------------
    Real theta[NL];
    Real sum_h = h[0];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      theta[i] = h[i] / g.thden[i];
      if (i > 0) sum_h = sum_h + h[i];
    }
    const Real w0 = rain * dt + wa + sum_h;

    const Real fsat = fmax * ex(Real(-0.5 * FFF) * zwt);
    Real qflx_surf = fsat * rain;

    // et.dual_source_et
    Real beta = zero;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const Real beta_l = one - (smp[i] - g.zc[i]) / Real(-150000.0);
      const Real term = row(I_ROOTR, i) * clip(beta_l, zero, one);
      beta = (i == 0) ? term : beta + term;
    }
    const bool active = (lai > zero) && (beta > zero) && (par > zero);
    const Real beta_safe = beta > zero ? beta : one;
    const Real par_safe = par > zero ? par : one;
    const Real rsc_a = (one / (par_safe / (par_safe + Real(300.0)))) *
                       Real(400.0) / (Real(2.0) * lai_safe * vpd_att);
    const Real rsc_raw = rsc_a / vmax(beta_safe, rsc_a / Real(RSC_MAX));
    Real rsc = active ? rsc_raw : Real(1.0e6);
    if (lai > zero) rsc = vmax(rsc, rsc_min);
    rsc = vmin(rsc, Real(RSC_MAX));

    const Real ts0 = row(I_TS, 0);
    const Real th0 = theta[0];
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
    const Real qtran = lec * Real(1.0e3) / (Real(RHOW) * lamb);
    Real qevap = les * Real(1.0e3) / (Real(RHOW) * lamb);
    const Real rootr0 = row(I_ROOTR, 0);
    Real evap_max1 =
        g.dz[0] * (th0 - Real(WATMIN)) / dt - qtran * rootr0;
    evap_max1 = vmax(zero, evap_max1);
    qevap = vmin(evap_max1, qevap);

    // Infiltration.
    const Real qflx_in_soil = (rain - qflx_surf) - qevap;
    Real qinmax = (one - fsat) * vmin(vmin(row(I_HK, 0), row(I_HK, 1)),
                                      row(I_HK, 2));
    if (WITH_IMP) qinmax = qinmax * row(I_IMP, 0);
    const Real infl_excess = vmax(zero, qflx_in_soil - qinmax);
    const Real qflx_infl = qflx_in_soil - infl_excess;
    qflx_surf = qflx_surf + infl_excess;

    // --- soilwater.soil_water_update --------------------------------------
    const Real zwtmm = Real(1000.0) * zwt;
    const int jwt = water_table_index<Real, NL>(zwt, g);
    const bool in_col = jwt < NL;
    const bool below = !in_col;
    const Real zq_aq = aquifer_zq<Real, NL>(
        zwtmm, jwt, row(I_TS, NL - 1), row(I_PS, NL - 1), row(I_BS, NL - 1),
        g);

    Real hk[NL], dhkdw[NL], dsmpdw[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int inext = (i + 1 < NL) ? i + 1 : NL - 1;
      const Real ts = row(I_TS, i), tsn = row(I_TS, inext);
      const Real bs = row(I_BS, i);
      Real s1 = Real(0.5) * (theta[i] + theta[inext]) /
                (Real(0.5) * (ts + tsn));
      s1 = vmin(one, s1);
      Real s2 = row(I_HK, i) * pw(s1, Real(2.0) * bs + Real(2.0));
      if (WITH_IMP) s2 = s2 * vmin(row(I_IMP, i), row(I_IMP, inext));
      hk[i] = s1 * s2;
      dhkdw[i] = (Real(2.0) * bs + Real(3.0)) * s2 * (one / (ts + tsn));
      const Real s_node = clip(theta[i] / ts, Real(0.01), one);
      const Real smp_i = vmax(Real(SMPMIN), row(I_PS, i) * pw(s_node, -bs));
      smp[i] = smp_i;  // the lagged potential for the next substep
      dsmpdw[i] = -bs * smp_i / (s_node * ts);
    }

    const Real zc_aq = Real(0.5) * (zwtmm + g.zc[NL - 1]);
    const Real dz_aq = in_col ? g.dz[NL - 1] : zwtmm - g.zc[NL - 1];

    Real a[NL + 1], b[NL + 1], cc[NL + 1], r[NL + 1];
    {
      const Real den = g.dzc[0];
      const Real num = (smp[1] - smp[0]) - (zq[1] - zq[0]);
      const Real qout0 = -hk[0] * num / den;
      const Real dqodw1 = -(-hk[0] * dsmpdw[0] + num * dhkdw[0]) / den;
      const Real dqodw2 = -(hk[0] * dsmpdw[1] + num * dhkdw[0]) / den;
      r[0] = qflx_infl - qout0 - qtran * rootr0;
      a[0] = zero;
      b[0] = g.dz_dt[0] + dqodw1;
      cc[0] = dqodw2;
    }
#pragma unroll
    for (int i = 1; i < NL - 1; ++i) {
      const Real den_in = g.dzc[i - 1];
      const Real num_in = smp[i] - smp[i - 1] - (zq[i] - zq[i - 1]);
      const Real qin_i = -hk[i - 1] * num_in / den_in;
      const Real dqidw0 =
          -(-hk[i - 1] * dsmpdw[i - 1] + num_in * dhkdw[i - 1]) / den_in;
      const Real dqidw1 =
          -(hk[i - 1] * dsmpdw[i] + num_in * dhkdw[i - 1]) / den_in;
      const Real den_out = g.dzc[i];
      const Real num_out = (smp[i + 1] - smp[i]) - (zq[i + 1] - zq[i]);
      const Real qout_i = -hk[i] * num_out / den_out;
      const Real dqodw1 = -(-hk[i] * dsmpdw[i] + num_out * dhkdw[i]) / den_out;
      const Real dqodw2 =
          -(hk[i] * dsmpdw[i + 1] + num_out * dhkdw[i]) / den_out;
      r[i] = qin_i - qout_i - qtran * row(I_ROOTR, i);
      a[i] = -dqidw0;
      b[i] = g.dz_dt[i] - dqidw1 + dqodw1;
      cc[i] = dqodw2;
    }
    {
      constexpr int i = NL - 1;
      const Real den_in = g.dzc[i - 1];
      const Real num_in = smp[i] - smp[i - 1] - (zq[i] - zq[i - 1]);
      const Real qin_bot = -hk[i - 1] * num_in / den_in;
      const Real dqidw0 =
          -(-hk[i - 1] * dsmpdw[i - 1] + num_in * dhkdw[i - 1]) / den_in;
      const Real dqidw1 =
          -(hk[i - 1] * dsmpdw[i] + num_in * dhkdw[i - 1]) / den_in;
      a[i] = -dqidw0;
      const Real rootr_i = row(I_ROOTR, i);
      if (below) {
        // Aquifer coupling (table below the column).
        const Real ts = row(I_TS, i), bs = row(I_BS, i);
        const Real s_node_aq =
            clip(Real(0.5) * (one + theta[i] / ts), Real(0.01), one);
        const Real smp_aq =
            vmax(Real(SMPMIN), row(I_PS, i) * pw(s_node_aq, -bs));
        const Real dsmpdw_aq = -bs * smp_aq / (s_node_aq * ts);
        const Real den_b = zc_aq - g.zc[i];
        const Real num_b = smp_aq - smp[i] - (zq_aq - zq[i]);
        const Real qout_b = -hk[i] * num_b / den_b;
        const Real dqodw1_b = -(-hk[i] * dsmpdw[i] + num_b * dhkdw[i]) / den_b;
        const Real dqodw2_b = -(hk[i] * dsmpdw_aq + num_b * dhkdw[i]) / den_b;
        r[i] = qin_bot - qout_b - qtran * rootr_i;
        b[i] = g.dz_dt[i] - dqidw1 + dqodw1_b;
        cc[i] = dqodw2_b;
        r[NL] = qout_b;
        a[NL] = -dqodw1_b;
        b[NL] = dz_aq / dt - dqodw2_b;
      } else {
        r[i] = qin_bot - zero - qtran * rootr_i;
        b[i] = g.dz_dt[i] - dqidw1;
        cc[i] = zero;
        r[NL] = zero;
        a[NL] = zero;
        b[NL] = dz_aq / dt;
      }
      cc[NL] = zero;
    }

    Real dw[NL + 1];
    thomas_refined<Real, NL + 1>(a, b, cc, r, dw);
#pragma unroll
    for (int i = 0; i < NL; ++i) h[i] = h[i] + dw[i] * g.dz[i];

    // Aquifer recharge.
    Real qcharge;
    if (in_col) {
      Real th_j = one, zq_jm = zero, smp_jm = zero, zc_jm = zero;
      const int jm = jwt - 1 > 0 ? jwt - 1 : 0;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (jwt == i) th_j = theta[i];
        if (jm == i) {
          smp_jm = smp[i];
          zq_jm = zq[i];
          zc_jm = g.zc[i];
        }
      }
      const Real ts_j = row(I_TS, jwt), hk_j = row(I_HK, jwt),
                 b_j = row(I_BS, jwt);
      const Real s1q = clip(th_j / ts_j, Real(0.01), one);
      const Real ka = hk_j * pw(s1q, Real(2.0) * b_j + Real(3.0));
      const Real wh = vmax(Real(SMPMIN), smp_jm) - zq_jm;
      const Real den_q =
          jwt == 0 ? zwtmm + one : (zwtmm - zc_jm) * Real(2.0);
      qcharge = clip(-ka * (zero - wh) / den_q, -g.qlim, g.qlim);
    } else {
      qcharge = dw[NL] * dz_aq / dt;
    }

    // --- drainage.drainage -------------------------------------------------
    // The walks use the stale zwtmm and jwt of the substep start.
    const Real rous = sy[NL - 1];
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
#pragma unroll
        for (int i = NL - 1; i >= 0; --i) {
          if (i <= jwt && rem > zero) {
            const Real s_y = sy[i];
            const Real ql =
                vmax(vmin(rem, s_y * (zwtmm - g.zi[i])), zero);
            zwt_w = zwt_w - ql / s_y / Real(1000.0);
            rem = rem - ql;
          }
        }
      } else {
        Real rem_f = qtot;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          if (i >= jwt && rem_f < zero) {
            const Real s_y = sy[i];
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
      return cached ? sy[i]
                    : specific_yield(row(I_TS, i), row(I_PS, i),
                                     row(I_BS, i), zwtmm1);
    };
    Real rsub_top = Real(RSUB_TOP_MAX) * ex(Real(-FFF) * vmax(zwt1, Real(-1)));
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
    const int jwt2 = (jwt1 == NL) ? jwt1 : water_table_index<Real, NL>(zwt2, g);
    zwt2 = clip(zwt2, zero, Real(80.0));

    // Saturation-excess bucket cascade, bottom-up.
#pragma unroll
    for (int i = NL - 1; i > 0; --i) {
      const Real cap = vmax(Real(0.01), row(I_TS, i)) * g.dz[i];
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
          zwt2 = zwt2 + xs / vmax(Real(0.01), row(I_TS, i)) / Real(1000.0);
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

#pragma unroll
  for (int i = 0; i < NL; ++i) {
    args.out[O_H][static_cast<size_t>(i) * n + cell] = h[i];
    args.out[O_SMP][static_cast<size_t>(i) * n + cell] = smp[i];
  }
  args.out[O_ZWT][cell] = zwt;
  args.out[O_WA][cell] = wa;
  args.out[O_EVAP][cell] = evap;
  args.out[O_EVAP_GRND][cell] = evap_grnd;
  args.out[O_RNF][cell] = rnf;
  args.out[O_RES][cell] = max_res;
}

template <typename Real, int NL, bool WITH_IMP>
int launch(const void* const* ins, void* const* outs, int n, int nisurf,
           int zd09_every, double dt, const double* geom,
           cudaStream_t stream) {
  Args<Real, NL> args;
  for (int k = 0; k < N_IN; ++k) args.in[k] = static_cast<const Real*>(ins[k]);
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
  const int grid = (n + BLOCK - 1) / BLOCK;
  day_kernel<Real, NL, WITH_IMP><<<grid, BLOCK, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real, int NL>
int launch_imp(int with_imp, const void* const* ins, void* const* outs, int n,
               int nisurf, int zd09_every, double dt, const double* geom,
               cudaStream_t stream) {
  return with_imp ? launch<Real, NL, true>(ins, outs, n, nisurf, zd09_every,
                                           dt, geom, stream)
                  : launch<Real, NL, false>(ins, outs, n, nisurf, zd09_every,
                                            dt, geom, stream);
}

template <typename Real>
int launch_nl(int nl, int with_imp, const void* const* ins, void* const* outs,
              int n, int nisurf, int zd09_every, double dt,
              const double* geom, cudaStream_t stream) {
  switch (nl) {
    case 8:
      return launch_imp<Real, 8>(with_imp, ins, outs, n, nisurf, zd09_every,
                                 dt, geom, stream);
    case 20:
      return launch_imp<Real, 20>(with_imp, ins, outs, n, nisurf, zd09_every,
                                  dt, geom, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry.  dtype_bytes is 4 (float) or 8 (double); ins holds
// N_IN device pointers (slot I_IMP may be null when with_imp is 0), outs
// N_OUT; geom holds zi[nl+2], dz[nl], zc[nl] on the host.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or -1 for a
// dtype/layer count with no instance.  Allocates nothing, never syncs.
extern "C" int h9_hydrology_day(int dtype_bytes, int nl, int with_imp,
                                const void* const* ins, void* const* outs,
                                int n, int nisurf, int zd09_every, double dt,
                                const double* geom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 4)
    return launch_nl<float>(nl, with_imp, ins, outs, n, nisurf, zd09_every,
                            dt, geom, s);
  if (dtype_bytes == 8)
    return launch_nl<double>(nl, with_imp, ins, outs, n, nisurf, zd09_every,
                             dt, geom, s);
  return -1;
}
