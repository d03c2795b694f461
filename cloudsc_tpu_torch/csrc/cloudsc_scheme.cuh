// CLOUDSC physics for one column and one level, in CUDA C++ for sm_90a.
//
// A scalar translation of cloudsc_tpu_torch/physics/scheme.py (itself a
// line-for-line port of cloudsc_tpu/physics/scheme.py) on the folded or the
// unfolded input contract, for the version the build names: the
// SchemeConfig switches IWARMRAIN, IEVAPRAIN, IEVAPSNOW, IDEPICE and the
// four aerosol couplings, the pack's form (CLOUDSC_FOLD_INPUTS: the folded
// pack, or the raw state and tendencies summed here; CLOUDSC_FC, _FN, _FD:
// the folded pack's streamed saturation-curve, ZDQS and deposition rows;
// beside the unfolded rows only the ZDQS row, which cloudsc_fused.cu's
// zdqs_kernel writes at working precision),
// the output rows (CLOUDSC_FOLD_OUTPUTS, read by cloudsc_fused.cu), the
// skipped sections (CLOUDSC_SKIP_<tag>, one macro a tag of
// scheme.SKIP_TAGS), CLOUDSC_DYNAMIC_SKIPS and CLOUDSC_S521_ROUND_SKIP
// arrive as macros (kernels/build.py from cuda_cloudsc.KernelVersion), and
// each library holds one version, so no build carries another version's
// branches in its instruction stream. The reference configuration is
// (2, 2, 1, 1) without aerosol couplings, the folded pack with the ZDQS row
// alone, the derivable flux rows folded out, no skipped section, dynamic
// skips on and no per-round skip. `ref:` line numbers point to src/cloudsc_fortran/cloudsc.F90 of the
// reference.
//
// Rounding. Every operation is written in the Python module's order; the
// build passes -fmad=false so no multiply-add is contracted. Literals are
// written T(...) so the float instantiation stays in float; scalar-only
// subexpressions of the Python code arrive precomputed in double in the
// constants vector (kernels/cuda_cloudsc.py CONST_NAMES), cast once to T.
// Powers and square roots go through d_pow / d_sqrt, the libdevice calls
// torch's CUDA `**` and `sqrt` make; `x ** 2` is x * x, as there.
//
// Sparsity. The 5x5 source/implicit matrices are dense arrays initialised to
// zero where the Python code keeps structural zeros as None: adding or
// eliminating an exact zero changes at most the sign of a zero, which no
// consumer distinguishes, so results are the same values.
//
// Dynamic skips are per-thread branches (one column), value-exact like the
// batch-level branches of the Python code; CLOUDSC_DYNAMIC_SKIPS=0 makes
// each take its active side.
#pragma once

#include <cuda_runtime.h>

#if !defined(CLOUDSC_IWARMRAIN) || !defined(CLOUDSC_IEVAPRAIN) || \
    !defined(CLOUDSC_IEVAPSNOW) || !defined(CLOUDSC_IDEPICE) ||   \
    !defined(CLOUDSC_LAERICESED) || !defined(CLOUDSC_LAERICEAUTO) || \
    !defined(CLOUDSC_LAERLIQAUTOLSP) || !defined(CLOUDSC_LAERLIQCOLL) || \
    !defined(CLOUDSC_FC) || !defined(CLOUDSC_FN) || !defined(CLOUDSC_FD) || \
    !defined(CLOUDSC_DYNAMIC_SKIPS) || !defined(CLOUDSC_S521_ROUND_SKIP) || \
    !defined(CLOUDSC_FOLD_INPUTS) || !defined(CLOUDSC_FOLD_OUTPUTS) ||   \
    !defined(CLOUDSC_SKIP_S31) || !defined(CLOUDSC_SKIP_S33) ||   \
    !defined(CLOUDSC_SKIP_S34E) || !defined(CLOUDSC_SKIP_S34C) || \
    !defined(CLOUDSC_SKIP_S37) || !defined(CLOUDSC_SKIP_S43A) ||  \
    !defined(CLOUDSC_SKIP_S43B) || !defined(CLOUDSC_SKIP_S43C) || \
    !defined(CLOUDSC_SKIP_S44A) || !defined(CLOUDSC_SKIP_S44B) || \
    !defined(CLOUDSC_SKIP_S44C) || !defined(CLOUDSC_SKIP_S45R) || \
    !defined(CLOUDSC_SKIP_S45S) || !defined(CLOUDSC_SKIP_S46) ||  \
    !defined(CLOUDSC_SKIP_S521) || !defined(CLOUDSC_SKIP_S522)
#error "the kernel version comes from kernels/build.py (cuda_cloudsc.KernelVersion)"
#endif
#if (CLOUDSC_IWARMRAIN != 1 && CLOUDSC_IWARMRAIN != 2) ||   \
    (CLOUDSC_IEVAPRAIN != 1 && CLOUDSC_IEVAPRAIN != 2) ||   \
    (CLOUDSC_IEVAPSNOW != 1 && CLOUDSC_IEVAPSNOW != 2) ||   \
    (CLOUDSC_IDEPICE != 1 && CLOUDSC_IDEPICE != 2)
#error "each scheme switch is 1 or 2"
#endif
// a folded row has no place beside the unfolded rows; the ZDQS row does:
// the unfolded build with CLOUDSC_FN streams the row that zdqs_kernel
// (cloudsc_fused.cu) writes at working precision
#if !CLOUDSC_FOLD_INPUTS && (CLOUDSC_FC || CLOUDSC_FD)
#error "the unfolded pack (CLOUDSC_FOLD_INPUTS=0) streams no FC/FD rows"
#endif
// the liquid couplings live in the Sundqvist warm-rain branch only
#define CLOUDSC_AER_LIQ \
  ((CLOUDSC_LAERLIQAUTOLSP || CLOUDSC_LAERLIQCOLL) && CLOUDSC_IWARMRAIN == 1)

namespace cloudsc {

// The constants vector, in the order of CONST_NAMES in
// kernels/cuda_cloudsc.py (tests/test_torch_kernel.py checks the two agree).
enum Const {
  C_ptsphy, C_zqtmst, C_RG, C_RD, C_RV, C_RTT, C_RETV, C_RLSTT,
  C_R4LES, C_R4IES, C_R5LES, C_R5IES, C_RALVDCP, C_RALSDCP,
  C_zrldcp, C_zrg_r, C_zepsilon, C_NSSOPT, C_NCLDTOP,
  C_r2es, C_r3les, C_r3ies, C_rtice, C_rtwat, C_rtwat_rtice_r,
  C_rkoop1, C_rkoop2, C_r5alvcp, C_r5alscp,
  C_rlmin, C_ramin, C_rthomo, C_rkooptau, C_ramid, C_rcldtopcf,
  C_rvice, C_rvrain, C_rvsnow, C_riceinit,
  C_rdepliqrefrate, C_rdepliqrefdepth, C_rcovpmin, C_rdensref,
  C_rsnowlin2, C_rlcritsnow, C_rclcrit_land, C_rclcrit_sea,
  C_rcl_kkaau, C_rcl_kkbauq, C_rcl_kkaac, C_rcl_kkbac,
  C_rcl_const1s, C_rcl_const7s, C_rcl_const8s, C_rtaumel,
  C_rcl_fac1, C_rcl_fzrab, C_rcl_const5r, C_rprecrhmax,
  C_rcl_cdenom1, C_rcl_cdenom2, C_rcl_cdenom3, C_rcl_const1r,
  C_rcl_const2r, C_rvrfactor,
  C_rdtgdp_fac, C_zfaci_cold, C_one_m_ramin, C_ldifdt_conv, C_ldifdt,
  C_zrdcp_half, C_one_m_ramid, C_snowlin_fac,
  C_kk_pow_land, C_kk_pow_sea, C_fac2_c6r, C_fac2_c4r, C_fac2_c3r,
  C_one_m_rprecrhmax, C_rv_over_rd, C_rg_rpecons,
  C_rprc1, C_rccn, C_rnice, C_rcl_apb1, C_rcl_apb2, C_rcl_apb3,
  C_rcl_const1i, C_rcl_const2i, C_rcl_const3i, C_rcl_const4i,
  C_rcl_const5i, C_rcl_const2s, C_rcl_const3s, C_rcl_const4s,
  C_rcl_const5s,
  C_rkconv_dt, C_rg_rpecons_half, C_c065_const6i, C_c065_const6s,
  C_RLVTT,
  C_COUNT
};

// Rows of the pack, in the order of pack_rows(fc, fn, fd, aer_rows(c),
// fold_inputs) in kernels/cuda_cloudsc.py: folded, PACK_ROWS and the form's
// curve, ZDQS and deposition rows; unfolded, UNFOLDED_ROWS and the ZDQS
// row (fn); then the aerosol rows the build's couplings read. The rows also
// read at level k+1 come first. The ring follows R_COUNT.
enum Row {
#if CLOUDSC_FOLD_INPUTS
  R_PMF, R_PLU, R_PAPH, R_ZTP1_IN, R_ZQV_IN, R_ZA_IN, R_PAP, R_PVERVEL,
  R_ZHR, R_PLUDE, R_PSNDE, R_PSUPSAT, R_PVFL, R_PVFI,
  R_ZQX0_IN, R_ZQX1_IN, R_ZQX2_IN, R_ZQX3_IN,
#if CLOUDSC_FC
  R_ZQSMIX, R_ZQSLIQ, R_ZQSICE, R_ZFOEEW, R_ZFOEEWMT, R_ZFOEELIQT,
  R_ZFOKOOP, R_ZFOEELIQ, R_ZFOEEICE,
#endif
#if CLOUDSC_FN
  R_ZDQS,
#endif
#if CLOUDSC_FD
  R_ZDEP0, R_ZINFAC,
#endif
#else
  R_PMFU, R_PMFD, R_PLU, R_PAPH, R_PT, R_PQ, R_TENDENCY_TMP_T,
  R_TENDENCY_TMP_Q, R_TENDENCY_TMP_A, R_PA, R_PAP, R_PVERVEL, R_PHRSW,
  R_PHRLW, R_PLUDE, R_PSNDE, R_PSUPSAT, R_PVFL, R_PVFI,
  R_PCLV0, R_PCLV1, R_PCLV2, R_PCLV3, R_TCLD0, R_TCLD1, R_TCLD2, R_TCLD3,
#if CLOUDSC_FN
  R_ZDQS,
#endif
#endif
#if CLOUDSC_LAERICESED
  R_PRE_ICE,
#endif
#if CLOUDSC_LAERICEAUTO
  R_PICRIT_AER, R_PNICE,
#endif
#if CLOUDSC_AER_LIQ
  R_PLCRIT_AER, R_PCCN,
#endif
  R_COUNT
};

constexpr int IL = 0, II = 1, IR = 2, IS = 3, IV = 4, NCLV = 5;
// the saturation-curve rows of the fc form, R_ZQSMIX on
constexpr int NCURVES = 9;
// false: every dynamic skip takes its active side (the oracle of their
// value-exactness, SchemeConfig.dynamic_skips)
constexpr bool DYNAMIC_SKIPS = CLOUDSC_DYNAMIC_SKIPS;
constexpr double ZEPSEC = 1.0e-14;
constexpr double ZTW1 = 1329.31, ZTW2 = 0.0074615, ZTW3 = 0.85e5,
                 ZTW4 = 40.637, ZTW5 = 275.0;

// -- math in the working precision ------------------------------------------
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }

// NaN-propagating max/min, as jnp.maximum / torch.maximum
template <typename T> __device__ __forceinline__ T mx(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T mn(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T sq(T a) { return a * a; }
template <typename T> __device__ __forceinline__ T sgn(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);
}

// -- thermodynamic functions (physics/thermo.py) ----------------------------
template <typename T> __device__ __forceinline__ T foealfa(const T* K, T t) {
  T x = (mx(K[C_rtice], mn(K[C_rtwat], t)) - K[C_rtice]) * K[C_rtwat_rtice_r];
  return mn(T(1), x * x);
}
template <typename T>
__device__ __forceinline__ T foedem_a(const T* K, T t, T alfa) {
  return alfa * K[C_r5alvcp] * (T(1) / sq(t - K[C_R4LES]))
         + (T(1) - alfa) * K[C_r5alscp] * (T(1) / sq(t - K[C_R4IES]));
}
template <typename T> __device__ __forceinline__ T foeldcpm_a(const T* K, T alfa) {
  return alfa * K[C_RALVDCP] + (T(1) - alfa) * K[C_RALSDCP];
}
template <typename T>
__device__ __forceinline__ T foeewm_a(const T* K, T t, T alfa) {
  return K[C_r2es] *
         (alfa * d_exp(K[C_r3les] * (t - K[C_RTT]) / (t - K[C_R4LES])) +
          (T(1) - alfa) * d_exp(K[C_r3ies] * (t - K[C_RTT]) / (t - K[C_R4IES])));
}

// the mixed-phase saturation curve of section 1 (ref: 749-760,
// scheme.sat_mix): its two exponentials, ZFOEEWMT and ZQSMIX at
// temperature t, liquid fraction alfa and pressure pap
template <typename T> struct SatMix {
  T exp_liq, exp_ice, zfoeewmt, zqsmix;
};
template <typename T>
__device__ __forceinline__ SatMix<T> sat_mix(const T* K, T t, T alfa, T pap) {
  SatMix<T> m;
  m.exp_liq = d_exp(K[C_r3les] * (t - K[C_RTT]) / (t - K[C_R4LES]));
  m.exp_ice = d_exp(K[C_r3ies] * (t - K[C_RTT]) / (t - K[C_R4IES]));
  m.zfoeewmt = mn(K[C_r2es] * (alfa * m.exp_liq + (T(1) - alfa) * m.exp_ice)
                  / pap, T(0.5));
  m.zqsmix = m.zfoeewmt / (T(1) - K[C_RETV] * m.zfoeewmt);
  return m;
}

// 3.4b's forcing chain and the in-line CUADJTQ, 2 Newton iterations (ref:
// 1281-1325, scheme.cuadj_zdqs): ZDQS of one level from that level's
// inputs alone (no cross-level carry; pmf_next counts only where
// not_last), so it is elementwise over (level, column). level_step calls
// it in the builds without the streamed ZDQS row, zdqs_kernel
// (cloudsc_fused.cu, through level_zdqs) for every (level, column) below
// the cloud top of the dict's build. The Python scalars zrdcp and 0.5 * RG
// are the constants' zrdcp_half and RG scaled by powers of two, which round
// alike in either precision.
template <typename T>
__device__ __forceinline__ T cuadj_zdqs(const T* K, T ztp1, T pap, T zdp,
                                        T pmf, T pmf_next, bool not_last,
                                        T pvervel, T zhr, T zqsmix) {
  const T O = T(1);
  const T zqtmst = K[C_zqtmst], ptsphy = K[C_ptsphy], RETV = K[C_RETV];
  const T zdtdp = T(2) * K[C_zrdcp_half] * ztp1 / pap;
  const T zdpmxdt = zdp * zqtmst;
  const T zmfdn2 = not_last ? pmf_next : T(0);
  T zwtot = pvervel + (T(0.5) * K[C_RG]) * (pmf + zmfdn2);
  zwtot = mn(zdpmxdt, mx(-zdpmxdt, zwtot));
  const T zdtdiab = mn(zdpmxdt * zdtdp, mx(-zdpmxdt * zdtdp, zhr)) * ptsphy;
  const T zdtforc = zdtdp * zwtot * ptsphy + zdtdiab;
  T tloc = mx(ztp1 + zdtforc, T(160.0));
  T qloc = zqsmix;
  const T zqp = O / pap;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const T alfa_n = foealfa(K, tloc);
    T zqsat = mn(foeewm_a(K, tloc, alfa_n) * zqp, T(0.5));
    const T zcor_n = O / (O - RETV * zqsat);
    zqsat = zqsat * zcor_n;
    const T zcond = (qloc - zqsat) /
                    (O + zqsat * zcor_n * foedem_a(K, tloc, alfa_n));
    tloc = tloc + foeldcpm_a(K, alfa_n) * zcond;
    qloc = qloc - zcond;
  }
  return qloc - zqsmix;
}

// -- section 1: level init (scheme.level_init on the state of state_rows) ---
template <typename T> struct Init {
  T ztp1, za, zaorig, zqx[NCLV], zqx0[NCLV];
  T zqsmix, zqsliq, zqsice, zfoeew, zfoeewmt, zfoeeliqt, zfoealfa;
  T zli, zliqfrac, zicefrac, zfoeeliq, zfoeeice, zfokoop;
  T tend_t_pre, tend_q_pre, zlneg[NCLV];
};

// `curves`: the fc form's nine rows of the level (CURVE_ROWS order), read
// only in a build with CLOUDSC_FC
template <typename T>
__device__ __forceinline__ void level_init(const T* K, T ztp1_in, T zqv_in,
                                           T za_in, const T zqx_in[4], T pap,
                                           const T* curves, Init<T>& o) {
  const T Z = T(0), O = T(1);
  const T zqtmst = K[C_zqtmst], RETV = K[C_RETV], rlmin = K[C_rlmin];
  T zqx[NCLV];
  zqx[IV] = zqv_in;
#pragma unroll
  for (int m = 0; m < 4; ++m) zqx[m] = zqx_in[m];
  T za = za_in;
  o.ztp1 = ztp1_in;
#pragma unroll
  for (int m = 0; m < NCLV; ++m) { o.zqx0[m] = zqx[m]; o.zlneg[m] = Z; }
  o.zaorig = za;
  T tend_t = Z, tend_q = Z;

  // tidy tiny cloud cover / total water (ref: 696-721)
  const bool cond = ((zqx[IL] + zqx[II]) < rlmin) || (za < K[C_ramin]);
#pragma unroll
  for (int m = IL; m <= II; ++m) {
    const T lat = m == IL ? K[C_RALVDCP] : K[C_RALSDCP];
    o.zlneg[m] = o.zlneg[m] + (cond ? zqx[m] : Z);
    const T zqadj = zqx[m] * zqtmst;
    tend_q = tend_q + (cond ? zqadj : Z);
    tend_t = tend_t - (cond ? lat * zqadj : Z);
    zqx[IV] = zqx[IV] + (cond ? zqx[m] : Z);
    zqx[m] = cond ? Z : zqx[m];
  }
  za = cond ? Z : za;

  // tidy small CLV amounts (ref: 727-743)
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool c2 = zqx[m] < rlmin;
    o.zlneg[m] = o.zlneg[m] + (c2 ? zqx[m] : Z);
    const T zqadj = zqx[m] * zqtmst;
    tend_q = tend_q + (c2 ? zqadj : Z);
    const T lat = (m == IL || m == IR) ? K[C_RALVDCP] : K[C_RALSDCP];
    tend_t = tend_t - (c2 ? lat * zqadj : Z);
    zqx[IV] = zqx[IV] + (c2 ? zqx[m] : Z);
    zqx[m] = c2 ? Z : zqx[m];
  }

  // saturation curves (ref: 749-784)
  const T t = ztp1_in;
  o.zfoealfa = foealfa(K, t);
#if CLOUDSC_FC
  // folded at load time in fp64 (physics/satfold.curve_rows)
  o.zqsmix = curves[0];
  o.zqsliq = curves[1];
  o.zqsice = curves[2];
  o.zfoeew = curves[3];
  o.zfoeewmt = curves[4];
  o.zfoeeliqt = curves[5];
  o.zfokoop = curves[6];
  o.zfoeeliq = curves[7];
  o.zfoeeice = curves[8];
#else
  (void)curves;
  const SatMix<T> sm = sat_mix(K, t, o.zfoealfa, pap);
  o.zfoeeliq = K[C_r2es] * sm.exp_liq;
  o.zfoeeice = K[C_r2es] * sm.exp_ice;
  o.zfoeewmt = sm.zfoeewmt;
  o.zqsmix = sm.zqsmix;
  const T zdelta = t >= K[C_RTT] ? O : Z;
  T zfoeew = mn((zdelta * o.zfoeeliq + (O - zdelta) * o.zfoeeice) / pap, T(0.5));
  o.zfoeew = mn(T(0.5), zfoeew);
  o.zqsice = o.zfoeew / (O - RETV * o.zfoeew);
  o.zfoeeliqt = mn(o.zfoeeliq / pap, T(0.5));
  o.zqsliq = o.zfoeeliqt / (O - RETV * o.zfoeeliqt);
  o.zfokoop = mn(K[C_rkoop1] - K[C_rkoop2] * t, o.zfoeeliq / o.zfoeeice);
#endif

  // cloud fraction in [0,1]; liquid/ice split (ref: 786-808)
  o.za = mx(Z, mn(O, za));
  o.zli = zqx[IL] + zqx[II];
  const bool has_li = o.zli > rlmin;
  o.zliqfrac = has_li ? zqx[IL] / o.zli : Z;
  o.zicefrac = has_li ? O - o.zliqfrac : Z;
  o.tend_t_pre = tend_t;
  o.tend_q_pre = tend_q;
#pragma unroll
  for (int m = 0; m < NCLV; ++m) o.zqx[m] = zqx[m];
}

// -- the column carries (scheme.initial_carry) ------------------------------
template <typename T> struct Carry {
  T zanewm1, zqxnm1[NCLV], pfplsx[NCLV], zcovptot, zcovpmax, zcldtopdist;
  T prainfrac;
  bool llrainliq;
};

// the per-level inputs of level_step beyond Init
template <typename T> struct LevelX {
  T ztp1_prev, za_prev, pap, pap_prev, paph, paph_next, paph_surf;
  T pmf, pmf_next, plu_next, pvervel, zhr, plude_in, psnde, psupsat;
  // the form's rows and the aerosol rows; each is set and read only in a
  // build that streams it
  T zdqs, zdep0, zinfac;
  T pre_ice, picrit_aer, pnice, plcrit_aer, pccn;
  bool land, ldcum, not_first, not_last;
  int ktype;
};

template <typename T> struct Ys {
  T zqxn[NCLV], plude, pcovptot, tend_t, tend_q, tend_a;
};

// ZTP1 of level k through `P(lev, row)`: the folded row, or PT + PTSPHY *
// TENDENCY_TMP_T formed here at working precision
template <typename T, typename Rows>
__device__ __forceinline__ T ztp1_row(const Rows& P, int k, const T* K) {
#if CLOUDSC_FOLD_INPUTS
  (void)K;
  return P(k, R_ZTP1_IN);
#else
  return P(k, R_PT) + K[C_ptsphy] * P(k, R_TENDENCY_TMP_T);
#endif
}

// section 1's state inputs of level k through `P(lev, row)`: the folded
// rows, or x + PTSPHY*tend formed here at working precision, in
// scheme.level_init's order
template <typename T, typename Rows>
__device__ __forceinline__ void state_rows(const Rows& P, int k, const T* K,
                                           T& ztp1, T& zqv, T& za,
                                           T (&zqx)[4]) {
  ztp1 = ztp1_row<T>(P, k, K);
#if CLOUDSC_FOLD_INPUTS
  zqv = P(k, R_ZQV_IN);
  za = P(k, R_ZA_IN);
#pragma unroll
  for (int m = 0; m < 4; ++m) zqx[m] = P(k, R_ZQX0_IN + m);
#else
  const T dt = K[C_ptsphy];
  zqv = P(k, R_PQ) + dt * P(k, R_TENDENCY_TMP_Q);
#pragma unroll
  for (int m = 0; m < 4; ++m) zqx[m] = P(k, R_PCLV0 + m) + dt * P(k, R_TCLD0 + m);
  za = P(k, R_PA) + dt * P(k, R_TENDENCY_TMP_A);
#endif
}

// PMFU+PMFD of level `lev`: the folded row, or the sum at working precision
template <typename T, typename Rows>
__device__ __forceinline__ T pmf_row(const Rows& P, int lev) {
#if CLOUDSC_FOLD_INPUTS
  return P(lev, R_PMF);
#else
  return P(lev, R_PMFU) + P(lev, R_PMFD);
#endif
}

// PHRSW+PHRLW of level `lev`: the folded row, or the sum at working
// precision
template <typename T, typename Rows>
__device__ __forceinline__ T zhr_row(const Rows& P, int lev) {
#if CLOUDSC_FOLD_INPUTS
  return P(lev, R_ZHR);
#else
  return P(lev, R_PHRSW) + P(lev, R_PHRLW);
#endif
}

// the streamed rows of level_step's inputs, through `P(lev, row)`: level k's
// and the k+1 rows pmf (or pmfu and pmfd) and plu
template <typename T, typename Rows>
__device__ __forceinline__ void level_rows(const Rows& P, int k,
                                           LevelX<T>& x) {
  x.pmf = pmf_row<T>(P, k);
  x.pmf_next = pmf_row<T>(P, k + 1);
  x.plu_next = P(k + 1, R_PLU);
  x.pvervel = P(k, R_PVERVEL);
  x.zhr = zhr_row<T>(P, k);
  x.psnde = P(k, R_PSNDE);
  x.psupsat = P(k, R_PSUPSAT);
#if CLOUDSC_FN
  x.zdqs = P(k, R_ZDQS);
#endif
#if CLOUDSC_FD
  x.zdep0 = P(k, R_ZDEP0);
  x.zinfac = P(k, R_ZINFAC);
#endif
#if CLOUDSC_LAERICESED
  x.pre_ice = P(k, R_PRE_ICE);
#endif
#if CLOUDSC_LAERICEAUTO
  x.picrit_aer = P(k, R_PICRIT_AER);
  x.pnice = P(k, R_PNICE);
#endif
#if CLOUDSC_AER_LIQ
  x.plcrit_aer = P(k, R_PLCRIT_AER);
  x.pccn = P(k, R_PCCN);
#endif
}

// ZDQS of level k of `nlev` through `P(lev, row)`, from that level's rows
// alone, as K1's level loop forms each input of cuadj_zdqs: ZTP1 and ZQSMIX
// as section 1 forms them (the fc form's ZQSMIX row), PAPH's difference,
// PMF of levels k and k+1 (the k+1 one masked at the last level), PVERVEL
// and ZHR. Above the cloud top (k < NCLDTOP - 1), where K1 reads none, it
// is 0 and nothing is computed.
template <typename T, typename Rows>
__device__ __forceinline__ T level_zdqs(const Rows& P, int k, int nlev,
                                        const T* K) {
  if (k < int(K[C_NCLDTOP]) - 1) return T(0);
  const T ztp1 = ztp1_row<T>(P, k, K);
  const T pap = P(k, R_PAP);
#if CLOUDSC_FC
  const T zqsmix = P(k, R_ZQSMIX);
#else
  const T zqsmix = sat_mix(K, ztp1, foealfa(K, ztp1), pap).zqsmix;
#endif
  return cuadj_zdqs(K, ztp1, pap, P(k + 1, R_PAPH) - P(k, R_PAPH),
                    pmf_row<T>(P, k), pmf_row<T>(P, k + 1), k < nlev - 1,
                    P(k, R_PVERVEL), zhr_row<T>(P, k), zqsmix);
}

// the fc form's nine curve rows of level k, through `P(lev, row)`
template <typename T, typename Rows>
__device__ __forceinline__ void curve_rows(const Rows& P, int k,
                                           T (&curves)[NCURVES]) {
#if CLOUDSC_FC
#pragma unroll
  for (int i = 0; i < NCURVES; ++i) curves[i] = P(k, R_ZQSMIX + i);
#else
  (void)P;
  (void)k;
  (void)curves;
#endif
}

// -- sections 3-6 (scheme.level_step) ----------------------------------------
template <typename T>
__device__ __forceinline__ void level_step(const T* K, int nssopt,
                                           const Init<T>& in, const LevelX<T>& x,
                                           Carry<T>& cr, Ys<T>& ys) {
  const T Z = T(0), O = T(1), EPS = T(ZEPSEC);
  const T ptsphy = K[C_ptsphy], zqtmst = K[C_zqtmst];
  const T RG = K[C_RG], RD = K[C_RD], RETV = K[C_RETV], RTT = K[C_RTT];
  const T RV = K[C_RV], RLSTT = K[C_RLSTT];
  const T RALVDCP = K[C_RALVDCP], RALSDCP = K[C_RALSDCP];
  const T zrldcp = K[C_zrldcp], zrg_r = K[C_zrg_r], zepsilon = K[C_zepsilon];
  const T rlmin = K[C_rlmin];

  const bool not_first = x.not_first, not_last = x.not_last;
  const T ztp1 = in.ztp1, za = in.za, pap = x.pap;
  T zqx[NCLV];
#pragma unroll
  for (int m = 0; m < NCLV; ++m) zqx[m] = in.zqx[m];
  const T zqsmix = in.zqsmix, zqsliq = in.zqsliq, zqsice = in.zqsice;
  const T zfoealfa_k = in.zfoealfa;

  // ---- 3.0 per-level init (ref: 854-983) ----
  T zqxfg[NCLV];
#pragma unroll
  for (int m = 0; m < NCLV; ++m) zqxfg[m] = zqx[m];
  T sqa[NCLV][NCLV], sqb[NCLV][NCLV];
#pragma unroll
  for (int m = 0; m < NCLV; ++m) {
#pragma unroll
    for (int n = 0; n < NCLV; ++n) { sqa[m][n] = Z; sqb[m][n] = Z; }
  }
  T fallsrce[NCLV], fallsink[NCLV], convsrce[NCLV], convsink[NCLV],
      psupsrce[NCLV];
#pragma unroll
  for (int m = 0; m < NCLV; ++m) {
    fallsrce[m] = Z; fallsink[m] = Z; convsrce[m] = Z; convsink[m] = Z;
    psupsrce[m] = Z;
  }
  T solab = Z, solac = Z;

  const T zdp = x.paph_next - x.paph;
  const T zgdp = RG / zdp;
  const T zrho = pap / (RD * ztp1);
  const T zdtgdp = ptsphy * zgdp;
  const T zrdtgdp = zdp * K[C_rdtgdp_fac];

  const T zfacw = K[C_R5LES] / sq(ztp1 - K[C_R4LES]);
  T zcor = O / (O - RETV * in.zfoeeliqt);
  const T zdqsliqdt = zfacw * zcor * zqsliq;
  const T zcorqsliq = O + RALVDCP * zdqsliqdt;
  (void)zcorqsliq;

  T zfaci = K[C_R5IES] / sq(ztp1 - K[C_R4IES]);
  zcor = O / (O - RETV * in.zfoeew);
  const T zdqsicedt = zfaci * zcor * zqsice;
  const T zcorqsice = O + RALSDCP * zdqsicedt;

  const T zalfaw = zfoealfa_k;
  T zfac = zalfaw * zfacw + (O - zalfaw) * zfaci;
  zcor = O / (O - RETV * in.zfoeewmt);
  const T zdqsmixdt = zfac * zcor * zqsmix;
  const T zcorqsmix = O + foeldcpm_a(K, zfoealfa_k) * zdqsmixdt;

  const T zevaplimmix = mx((zqsmix - zqx[IV]) / zcorqsmix, Z);

  T ztmpa = O / mx(za, EPS);
  T zliqcld = zqx[IL] * ztmpa;
  T zicecld = zqx[II] * ztmpa;
  const T zlicld = zliqcld + zicecld;
  const T zicecld30 = zicecld;

  // evaporate very small liquid/ice (ref: 971-983)
#pragma unroll
  for (int m = IL; m <= II; ++m) {
    const T v = zqx[m] < rlmin ? zqx[m] : Z;
    sqa[IV][m] = sqa[IV][m] + v;
    sqa[m][IV] = sqa[m][IV] + -v;
  }

  // ---- 3.1 ice supersaturation adjustment (ref: 985-1088) ----
  const T zfokoop = in.zfokoop;
  const bool warm_or_off = (ztp1 >= RTT) || (nssopt == 0);
  zfac = warm_or_off ? O : za + zfokoop * (O - za);
  zfaci = warm_or_off ? O : K[C_zfaci_cold];
  const bool high_a = za > K[C_one_m_ramin];
  const T zsup_cld = mx((zqx[IV] - zfac * zqsice) / zcorqsice, Z);
  const T zqp1env = (zqx[IV] - za * zqsice) / mx(O - za, zepsilon);
  const T zsup_env = mx((O - za) * (zqp1env - zfac * zqsice) / zcorqsice, Z);
  const T zsupsat = high_a ? zsup_cld : zsup_env;
  const bool has_sup = zsupsat > EPS;
  const bool warm = ztp1 > K[C_rthomo];
#if !CLOUDSC_SKIP_S31
#pragma unroll
  for (int m = IL; m <= II; ++m) {
    const bool w = m == IL ? warm : !warm;
    const T amt = (has_sup && w) ? zsupsat : Z;
    sqa[m][IV] = sqa[m][IV] + amt;
    sqa[IV][m] = sqa[IV][m] + -amt;
    zqxfg[m] = zqxfg[m] + amt;
  }
  solac = has_sup ? (O - za) * zfaci : solac;
  const bool has_ps = x.psupsat > EPS;
#pragma unroll
  for (int m = IL; m <= II; ++m) {
    const bool w = m == IL ? warm : !warm;
    const T amt = (has_ps && w) ? x.psupsat : Z;
    sqa[m][m] = sqa[m][m] + amt;
    psupsrce[m] = amt;
    zqxfg[m] = zqxfg[m] + amt;
  }
  solac = has_ps ? (O - za) * zfaci : solac;
#endif

  // ---- 3.2 detrainment from convection (ref: 1100-1127) ----
  const T plude_scaled = x.plude_in * zdtgdp;
  const bool lcond = not_last && x.ldcum && (plude_scaled > rlmin) &&
                     (x.plu_next > EPS);
  solac = solac + (lcond ? plude_scaled / x.plu_next : Z);
  convsrce[IL] = lcond ? zalfaw * plude_scaled : Z;
  convsrce[II] = lcond ? (O - zalfaw) * plude_scaled : Z;
  sqa[IL][IL] = sqa[IL][IL] + convsrce[IL];
  sqa[II][II] = sqa[II][II] + convsrce[II];
  const T plude_out = not_last ? (lcond ? plude_scaled : Z) : x.plude_in;
  sqa[IS][IS] = sqa[IS][IS] + ((not_last && x.ldcum) ? x.psnde * zdtgdp : Z);

  // ---- 3.3 subsidence source + in-layer evaporation (ref: 1143-1194) ----
  const T zmf = mx(Z, x.pmf * zdtgdp);
  T zacust = zmf * cr.zanewm1;
#if !CLOUDSC_SKIP_S33
  {
    T zlcust[2];
#pragma unroll
    for (int m = IL; m <= II; ++m) {
      zlcust[m] = not_first ? zmf * cr.zqxnm1[m] : Z;
      convsrce[m] = convsrce[m] + zlcust[m];
    }
    const T zdtdp = K[C_zrdcp_half] * (x.ztp1_prev + ztp1) / x.paph;
    const T zdtforc = zdtdp * (pap - x.pap_prev);
    const T zdqs_sub = cr.zanewm1 * zdtforc * zdqsmixdt;
    T zlfinalsum = Z;
#pragma unroll
    for (int m = IL; m <= II; ++m) {
      T zlfinal = mx(Z, zlcust[m] - zdqs_sub);
      const T zevap = mn(zlcust[m] - zlfinal, zevaplimmix);
      zlfinal = zlcust[m] - zevap;
      zlfinalsum = zlfinalsum + (not_first ? zlfinal : Z);
      sqa[m][m] = sqa[m][m] + (not_first ? zlcust[m] : Z);
      sqa[IV][m] = sqa[IV][m] + (not_first ? zevap : Z);
      sqa[m][IV] = sqa[m][IV] + -(not_first ? zevap : Z);
    }
    zacust = zlfinalsum < EPS ? Z : zacust;
    solac = solac + (not_first ? zacust : Z);
  }
#else
  (void)zacust;
#endif
  // subsidence sink to layer below (ref: 1201-1217)
  const T zmfdn = not_last ? mx(Z, x.pmf_next * zdtgdp) : Z;
  solab = solab + zmfdn;
  sqb[IL][IL] = sqb[IL][IL] + zmfdn;
  sqb[II][II] = sqb[II][II] + zmfdn;
  convsink[IL] = zmfdn;
  convsink[II] = zmfdn;

  // ---- 3.4 turbulent erosion (ref: 1230-1261) ----
  {
    const T zldifdt = ((x.ktype > 0) && (plude_out > EPS)) ? K[C_ldifdt_conv]
                                                            : K[C_ldifdt];
    const bool has_cld = in.zli > EPS;
    const T ze = zldifdt * mx(zqsmix - zqx[IV], Z);
    T zleros = za * ze;
    zleros = mn(zleros, zevaplimmix);
    zleros = mn(zleros, in.zli);
    const T zaeros = zleros / (has_cld ? zlicld : O);
#if !CLOUDSC_SKIP_S34E
    solac = solac - (has_cld ? zaeros : Z);
#pragma unroll
    for (int m = IL; m <= II; ++m) {
      const T frac = m == IL ? in.zliqfrac : in.zicefrac;
      const T amt = has_cld ? frac * zleros : Z;
      sqa[IV][m] = sqa[IV][m] + amt;
      sqa[m][IV] = sqa[m][IV] + -amt;
    }
#else
    (void)zaeros;
#endif
  }

  // ---- 3.4b condensation/evaporation from dqsat/dt (ref: 1281-1325) ----
#if CLOUDSC_FN
  // the streamed row: folded at load time in fp64 (physics/satfold.
  // newton_zdqs), or, beside the unfolded rows, zdqs_kernel's cuadj_zdqs
  const T zdqs = x.zdqs;
#else
  const T zdqs = cuadj_zdqs(K, ztp1, pap, zdp, x.pmf, x.pmf_next, not_last,
                            x.pvervel, x.zhr, zqsmix);
#endif

  // 3.4a evaporation of clouds (ref: 1333-1356)
  {
    const bool evap_m = zdqs > Z;
    T zlevap = za * mn(zdqs, zlicld);
    zlevap = mn(zlevap, zevaplimmix);
    zlevap = mn(zlevap, mx(zqsmix - zqx[IV], Z));
#if !CLOUDSC_SKIP_S34C
#pragma unroll
    for (int m = IL; m <= II; ++m) {
      const T frac = m == IL ? in.zliqfrac : in.zicefrac;
      const T amt = evap_m ? frac * zlevap : Z;
      sqa[IV][m] = sqa[IV][m] + amt;
      sqa[m][IV] = sqa[m][IV] + -amt;
    }
#else
    (void)evap_m;
#endif
  }

  // 3.4b(1) increase of cloud water in existing clouds (ref: 1362-1396)
  {
    const bool c1m = (za > EPS) && (zdqs <= -rlmin);
    T zlcond1 = mx(-zdqs, Z);
    const T zcorq = O / (O - RETV * zqsmix);
    const T zcdmax = za > T(0.99)
        ? (zqx[IV] - zqsmix) /
              (O + zcorq * zqsmix * foedem_a(K, ztp1, zfoealfa_k))
        : (zqx[IV] - za * zqsmix) / (c1m ? za : O);
    zlcond1 = mx(mn(zlcond1, zcdmax), Z);
    zlcond1 = za * zlcond1;
    zlcond1 = zlcond1 < rlmin ? Z : zlcond1;
#if !CLOUDSC_SKIP_S34C
#pragma unroll
    for (int m = IL; m <= II; ++m) {
      const bool w = m == IL ? warm : !warm;
      const T amt = (c1m && w) ? zlcond1 : Z;
      sqa[m][IV] = sqa[m][IV] + amt;
      sqa[IV][m] = sqa[IV][m] + -amt;
      zqxfg[m] = zqxfg[m] + amt;
    }
#endif
  }

  // 3.4b(2) generation of new clouds (ref: 1400-1499)
  {
    bool c2m = (zdqs <= -rlmin) && (za < T(1.0 - ZEPSEC));
    const T zsigk = pap / x.paph_surf;
    const T zrhc = zsigk > T(0.8)
        ? K[C_ramid] + K[C_one_m_ramid] * sq((zsigk - T(0.8)) / T(0.2))
        : K[C_ramid];
    T zqe;
    if (nssopt == 0 || nssopt == 1) {
      zqe = (zqx[IV] - za * zqsice) / mx(EPS, O - za);
      zqe = mx(Z, zqe);
    } else if (nssopt == 2) {
      zqe = zqx[IV];
    } else {
      zqe = zqx[IV] + in.zli;
    }
    const T zfac2 = ((ztp1 >= RTT) || (nssopt == 0)) ? O : zfokoop;
    const bool in_range = (zqe >= zrhc * zqsice * zfac2) &&
                          (zqe < zqsice * zfac2);
    c2m = c2m && in_range;
    T zacond = -(O - za) * zfac2 * zdqs /
               mx(T(2.0) * (zfac2 * zqsice - zqe), EPS);
    zacond = mn(zacond, O - za);
    T zlcond2 = -zfac2 * zdqs * T(0.5) * zacond;
    const T zzdl = T(2.0) * (zfac2 * zqsice - zqe) / mx(EPS, O - za);
    const T zlcondlim = (za - O) * zfac2 * zdqs - zfac2 * zqsice + zqx[IV];
    zlcond2 = (zfac2 * zdqs < -zzdl) ? mn(zlcond2, zlcondlim) : zlcond2;
    zlcond2 = mx(zlcond2, Z);
    const bool kill = (zlcond2 < rlmin) || ((O - za) < EPS);
    zlcond2 = kill ? Z : zlcond2;
    zacond = (kill || zlcond2 == Z) ? Z : zacond;
#if !CLOUDSC_SKIP_S34C
    solac = solac + (c2m ? zacond : Z);
#pragma unroll
    for (int m = IL; m <= II; ++m) {
      const bool w = m == IL ? warm : !warm;
      const T amt = (c2m && w) ? zlcond2 : Z;
      sqa[m][IV] = sqa[m][IV] + amt;
      sqa[IV][m] = sqa[IV][m] + -amt;
      zqxfg[m] = zqxfg[m] + amt;
    }
#endif
  }

  // ---- 3.7 cloud-top distance carry (ref: 1529-1533) ----
  const bool reset_top = (x.za_prev < K[C_rcldtopcf]) && (za >= K[C_rcldtopcf]);
  const T zcldtopdist = reset_top ? Z : cr.zcldtopdist + zdp / (zrho * RG);

  // 4.2 sedimentation source/sink (ref: 1714-1746)
#pragma unroll
  for (int m = II; m <= IS; ++m) {
    fallsrce[m] = not_first ? cr.pfplsx[m] * zdtgdp : Z;
    sqa[m][m] = sqa[m][m] + fallsrce[m];
#if CLOUDSC_LAERICESED
    // ice fall speed from the effective radius (ref: 1736-1738)
    const T vice = T(0.002) * x.pre_ice;
#else
    const T vice = K[C_rvice];
#endif
    const T vq = m == II ? vice : (m == IR ? K[C_rvrain] : K[C_rvsnow]);
    fallsink[m] = zdtgdp * (vq * zrho);
  }

  // 4.4b rain-fraction latch (ref: 2044-2056)
  const bool rain_p = zqx[IR] > EPS;
  const bool latch = rain_p && (ztp1 <= RTT) && (x.ztp1_prev > RTT);
  const T zqpretot_f = mx(zqx[IS] + zqx[IR], EPS);
  const T prainfrac = latch ? zqx[IR] / zqpretot_f : cr.prainfrac;
  const bool llrainliq = (latch && (prainfrac > T(0.8))) ||
                         (!latch && cr.llrainliq);

  // ---- 3.7-6: the precipitation region, inert where region_m is false ----
  const bool flux_in = (cr.pfplsx[II] > Z) || (cr.pfplsx[IR] > Z) ||
                       (cr.pfplsx[IS] > Z);
  bool region_m = (zqxfg[IL] > Z) || (zqxfg[II] > Z) || (zqxfg[IR] > Z) ||
                  (zqxfg[IS] > Z) || flux_in;
#pragma unroll
  for (int m = 0; m < NCLV; ++m) {
#pragma unroll
    for (int n = 0; n < NCLV; ++n) region_m = region_m || (sqa[m][n] != Z);
  }

  T zqxn[NCLV], pf_next[NCLV];
  T tend_t = in.tend_t_pre, tend_q = in.tend_q_pre;
  T zcovptot = cr.zcovptot, zcovpmax = Z;
#pragma unroll
  for (int m = 0; m < NCLV; ++m) { zqxn[m] = zqx[m]; pf_next[m] = Z; }

  if (!DYNAMIC_SKIPS || region_m) {
    // 3.7 ice deposition (ref: 1501-1689)
    {
      const bool dep_m = (ztp1 < RTT) && (zqxfg[IL] > rlmin);
#if CLOUDSC_FD
      // folded at load time in fp64 up to the raw amount
      // (physics/satfold.dep_rows); the carry-dependent tail stays
      const T zinfactor = x.zinfac;
      T zdepos = x.zdep0;
#else
      const T zvpice = in.zfoeeice * RV / RD;
      const T zvpliq = zvpice * zfokoop;
      const T zicenuclei = T(1000.0) *
          d_exp(T(12.96) * (zvpliq - zvpice) / zvpliq - T(0.639));
      const T zinfactor = mn(zicenuclei / T(15000.0), O);
#if CLOUDSC_IDEPICE == 1
      // Rotstayn 2001, monodisperse (ref: 1519-1601)
      const T zadd = RLSTT * (RLSTT / (RV * ztp1) - O) / (T(2.4e-2) * ztp1);
      const T zbdd = RV * ztp1 * pap / (T(2.21) * zvpice);
      const T zcvds = T(7.8) * d_pow(zicenuclei / zrho, T(0.666)) *
                      (zvpliq - zvpice) / (T(8.87) * (zadd + zbdd) * zvpice);
      const T zice0 = mx(zicecld30, zicenuclei * K[C_riceinit] / zrho);
      const T zinew_b = T(0.666) * zcvds * ptsphy + d_pow(zice0, T(0.666));
      const T zinew = zinew_b * d_sqrt(zinew_b);
      T zdepos = mx(za * (zinew - zice0), Z);
#else
      // ice-PSD-based deposition (ref: 1608-1689); ZTCG = ZFACX1I = 1
      const T zice0 = mx(zicecld30, zicenuclei * K[C_riceinit] / zrho);
      const T zaplusb = K[C_rcl_apb1] * zvpice - K[C_rcl_apb2] * zvpice * ztp1 +
                        pap * K[C_rcl_apb3] * (ztp1 * ztp1 * ztp1);
      const T zcorrfac = d_sqrt(O / zrho);
      const T ztq = ztp1 / T(273.0);
      const T zcorrfac2 = ztq * d_sqrt(ztq) * (T(393.0) / (ztp1 + T(120.0)));
      const T zpr02 = zrho * zice0 * K[C_rcl_const1i];
      const T zterm1 = (zvpliq - zvpice) * sq(ztp1) * zvpice * zcorrfac2 *
                       K[C_rcl_const2i] / (zrho * zaplusb * zvpice);
      const T zterm2 = K[C_c065_const6i] * d_pow(zpr02, K[C_rcl_const4i]) +
                       K[C_rcl_const3i] * d_sqrt(zcorrfac) * d_sqrt(zrho) *
                           d_pow(zpr02, K[C_rcl_const5i]) / d_sqrt(zcorrfac2);
      T zdepos = mx(za * zterm1 * zterm2 * ptsphy, Z);
#endif
#endif
      const T ztopred = mn(
          zinfactor + (O - zinfactor) * (K[C_rdepliqrefrate] +
                                         zcldtopdist / K[C_rdepliqrefdepth]),
          O);
      zdepos = mn(zdepos, zqxfg[IL]);
      zdepos = zdepos * ztopred;
#if !CLOUDSC_SKIP_S37
      const T amt = dep_m ? zdepos : Z;
      sqa[II][IL] = sqa[II][IL] + amt;
      sqa[IL][II] = sqa[IL][II] + -amt;
      zqxfg[II] = zqxfg[II] + amt;
      zqxfg[IL] = zqxfg[IL] - amt;
#else
      (void)dep_m;
#endif
    }

    // revised in-cloud condensate (ref: 1700-1705)
    ztmpa = O / mx(za, EPS);
    zliqcld = zqxfg[IL] * ztmpa;
    zicecld = zqxfg[II] * ztmpa;

    // 4.2 fall source on the first guess (ref: 1714-1726)
    T zqpretot = Z;
#pragma unroll
    for (int m = II; m <= IS; ++m) {
      zqxfg[m] = zqxfg[m] + fallsrce[m];
      zqpretot = zqpretot + (not_first ? zqxfg[m] : Z);
    }

    // 4.3p precip cover overlap, MAX-RAN (ref: 1767-1784)
    const bool has_pre = zqpretot > EPS;
    const T zcovptot_new = O - ((O - zcovptot) * (O - mx(za, x.za_prev)) /
                                (O - mn(x.za_prev, T(1.0 - 1.0e-6))));
    zcovptot = has_pre ? mx(zcovptot_new, K[C_rcovpmin]) : Z;
    const T zcovpclr = has_pre ? mx(Z, zcovptot - za) : Z;
    const T covp_safe = has_pre ? zcovptot : O;
    const T zraincld = has_pre ? zqxfg[IR] / covp_safe : Z;
    const T zsnowcld = has_pre ? zqxfg[IS] / covp_safe : Z;
    zcovpmax = has_pre ? mx(zcovptot, cr.zcovpmax) : Z;

    const bool snow_m = (ztp1 <= RTT) && (zicecld > EPS);
    const bool liq_m = zliqcld > EPS;
    const bool rime_m = (ztp1 <= RTT) && (zliqcld > EPS);
    const T zfallcorr = d_pow(K[C_rdensref] / zrho, T(0.4));
    const bool rime2 = rime_m && (zsnowcld > EPS) && (zcovptot > T(0.01));
    const T zicetot = zqxfg[II] + zqxfg[IS];
    const bool melt_m = (zicetot > EPS) && (ztp1 > RTT);
    const bool frz_cold = rain_p && (ztp1 < RTT);

    // 4.3a snow autoconversion, Lin et al. 1983 (ref: 1789-1811)
    {
      T zzco = K[C_snowlin_fac] * d_exp(K[C_rsnowlin2] * (ztp1 - RTT));
#if CLOUDSC_LAERICEAUTO
      const T zlcrit = x.picrit_aer;
      zzco = zzco * d_pow(K[C_rnice] / x.pnice, T(0.333));
#else
      const T zlcrit = K[C_rlcritsnow];
#endif
      const T zsnowaut = zzco * (O - d_exp(-sq(zicecld / zlcrit)));
#if !CLOUDSC_SKIP_S43A
      sqb[IS][II] = sqb[IS][II] + (snow_m ? zsnowaut : Z);
#else
      (void)zsnowaut;
      (void)snow_m;
#endif
    }

    // 4.3b warm-rain autoconversion/accretion (ref: 1819-1927)
    {
#if CLOUDSC_IWARMRAIN == 1
      // Sundqvist 1989, implicit (ref: 1826-1874)
      T zzco = K[C_rkconv_dt];
#if CLOUDSC_LAERLIQAUTOLSP
      T zlcrit = x.plcrit_aer;
      zzco = zzco * d_pow(K[C_rccn] / x.pccn, T(0.333));
#else
      T zlcrit = x.land ? K[C_rclcrit_land] : K[C_rclcrit_sea];
#endif
      const T zprecip = (cr.pfplsx[IS] + cr.pfplsx[IR]) / mx(EPS, zcovptot);
      const T pr_sqrt = zprecip > Z ? d_sqrt(zprecip) : Z;
      T zcfpr = O + K[C_rprc1] * pr_sqrt;
#if CLOUDSC_LAERLIQCOLL
      zcfpr = zcfpr * d_pow(K[C_rccn] / x.pccn, T(0.333));
#endif
      zzco = zzco * zcfpr;
      zlcrit = zlcrit / mx(zcfpr, EPS);
      // exp guarded against overflow for large arguments (ref: 1864-1868)
      const T zarg = zliqcld / zlcrit;
      const T zrainaut = zarg < T(20.0) ? zzco * (O - d_exp(-(zarg * zarg)))
                                        : zzco;
      const bool cold = ztp1 <= RTT;
      sqb[IS][IL] = sqb[IS][IL] + ((liq_m && cold) ? zrainaut : Z);
      sqb[IR][IL] = sqb[IR][IL] + ((liq_m && !cold) ? zrainaut : Z);
#else
      // Khairoutdinov and Kogan 2000
      const T zconst_pow = x.land ? K[C_kk_pow_land] : K[C_kk_pow_sea];
      const T zlcrit = x.land ? K[C_rclcrit_land] : K[C_rclcrit_sea];
      const bool above = zliqcld > zlcrit;
      T zrainaut = T(1.5) * za * ptsphy * K[C_rcl_kkaau] *
                   d_pow(mx(zliqcld, Z), K[C_rcl_kkbauq]) * zconst_pow;
      zrainaut = mn(zrainaut, zqxfg[IL]);
      zrainaut = zrainaut < EPS ? Z : zrainaut;
      T zrainacc = T(2.0) * za * ptsphy * K[C_rcl_kkaac] *
                   d_pow(mx(zliqcld * zraincld, Z), K[C_rcl_kkbac]);
      zrainacc = mn(zrainacc, zqxfg[IL]);
      zrainacc = zrainacc < EPS ? Z : zrainacc;
      zrainaut = above ? zrainaut : Z;
      zrainacc = above ? zrainacc : Z;
      const bool cold = ztp1 <= RTT;
#if !CLOUDSC_SKIP_S43B
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int dst = i == 0 ? IS : IR;
        const bool mm = liq_m && (i == 0 ? cold : !cold);
        sqa[dst][IL] = sqa[dst][IL] + (mm ? zrainaut : Z);
        sqa[dst][IL] = sqa[dst][IL] + (mm ? zrainacc : Z);
        sqa[IL][dst] = sqa[IL][dst] + -(mm ? zrainaut : Z);
        sqa[IL][dst] = sqa[IL][dst] + -(mm ? zrainacc : Z);
      }
#else
      (void)cold;
      (void)zrainacc;
#endif
#endif
    }

    // riming: snow collects cloud liquid (ref: 1935-1980)
    {
      const T rime_base = mx(zrho * zsnowcld * K[C_rcl_const1s], Z);
      const T rime_pow = rime_base > Z ? d_pow(rime_base, K[C_rcl_const8s]) : Z;
      T zsnowrime = T(0.3) * zcovptot * ptsphy * K[C_rcl_const7s] *
                    zfallcorr * rime_pow;
      zsnowrime = mn(zsnowrime, O);
#if !CLOUDSC_SKIP_S43C
      sqb[IS][IL] = sqb[IS][IL] + (rime2 ? zsnowrime : Z);
#else
      (void)zsnowrime;
      (void)rime2;
#endif
    }

    // 4.4a melting of snow and ice (ref: 1990-2034)
    {
      const T zsubsat = mx(zqsice - zqx[IV], Z);
      const T ztdmtw0 = ztp1 - RTT - zsubsat * (T(ZTW1) + T(ZTW2) * (pap - T(ZTW3))
                                                - T(ZTW4) * (ztp1 - T(ZTW5)));
      const T zcons1 = d_abs(ptsphy * (O + T(0.5) * ztdmtw0) / K[C_rtaumel]);
      const T zmeltmax = melt_m ? mx(ztdmtw0 * zcons1 * zrldcp, Z) : Z;
#if CLOUDSC_SKIP_S44A
      (void)zmeltmax;
#else
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = i == 0 ? II : IS;
        const int n = IR;  // IMELT[II] = IMELT[IS] = IR
        const bool mm = (zmeltmax > EPS) && (zicetot > EPS);
        const T zalfa_m = zqxfg[m] / (mm ? zicetot : O);
        const T zmelt = mn(zqxfg[m], zalfa_m * zmeltmax);
        const T amt = mm ? zmelt : Z;
        zqxfg[m] = zqxfg[m] - amt;
        zqxfg[n] = zqxfg[n] + amt;
        sqa[n][m] = sqa[n][m] + amt;
        sqa[m][n] = sqa[m][n] + -amt;
      }
#endif
    }

    // 4.4c freezing of liquid (ref: 2099-2112)
    {
      const T zfrzmax = mx((K[C_rthomo] - ztp1) * zrldcp, Z);
      const bool frz_m = (zfrzmax > EPS) && (zqxfg[IL] > EPS);
      const T zfrz = mn(zqxfg[IL], zfrzmax);
#if !CLOUDSC_SKIP_S44C
      const T amt = frz_m ? zfrz : Z;
      sqa[II][IL] = sqa[II][IL] + amt;
      sqa[IL][II] = sqa[IL][II] + -amt;
#else
      (void)zfrz;
      (void)frz_m;
#endif
    }

    // rain sub-branch: 4.4b freezing + 4.5 rain evaporation (Abel-Boutle)
    if (!DYNAMIC_SKIPS || rain_p || (zqxfg[IR] > EPS)) {
      const T lam_den = rain_p ? zrho * zqx[IR] : O;
      const T zlambda_c6 = d_pow(K[C_rcl_fac1] / lam_den, K[C_fac2_c6r]);
      const T ztemp = K[C_rcl_fzrab] * (ztp1 - RTT);
      const T zfrz_het = ptsphy * (K[C_rcl_const5r] / zrho) *
                         (d_exp(ztemp) - O) * zlambda_c6;
      const T zfrzmax_liq = mx(zfrz_het, Z);
      const T zcons1f = d_abs(ptsphy * (O + T(0.5) * (RTT - ztp1)) / K[C_rtaumel]);
      const T zfrzmax_mix = mx((RTT - ztp1) * zcons1f * zrldcp, Z);
      const T zfrzmax = llrainliq ? zfrzmax_liq : zfrzmax_mix;
      const bool frz_m = frz_cold && (zfrzmax > EPS);
      const T zfrz = mn(zqx[IR], zfrzmax);
#if !CLOUDSC_SKIP_S44B
      const T frz = frz_m ? zfrz : Z;
      sqa[IS][IR] = sqa[IS][IR] + frz;
      sqa[IR][IS] = sqa[IR][IS] + -frz;
#else
      (void)zfrz;
      (void)frz_m;
#endif

#if CLOUDSC_IEVAPRAIN == 1
      // 4.5 rain evaporation, Sundqvist (ref: 2121-2184)
      T zzrh = K[C_rprecrhmax] +
               K[C_one_m_rprecrhmax] * zcovpmax / mx(EPS, O - za);
      zzrh = mn(mx(zzrh, K[C_rprecrhmax]), O);
      T zqe = (zqx[IV] - za * zqsliq) / mx(EPS, O - za);
      zqe = mx(Z, mn(zqe, zqsliq));
      const bool llo1 = (zcovpclr > EPS) && (zqxfg[IR] > EPS) &&
                        (zqe < zzrh * zqsliq);
      T denom = zcovptot * zdtgdp;
      denom = sgn(denom) * mx(d_abs(denom), zepsilon);
      denom = denom == Z ? zepsilon : denom;
      const T zpreclr = zqxfg[IR] * zcovpclr / denom;
      const T zbeta1 = d_sqrt(pap / x.paph_surf) / K[C_rvrfactor] * zpreclr /
                       mx(zcovpclr, EPS);
      const T b1_pow = zbeta1 > Z ? d_pow(zbeta1, T(0.5777)) : Z;
      const T zbeta = K[C_rg_rpecons_half] * b1_pow;
      const T zdenom = O + zbeta * ptsphy * zcorqsliq;
      const T zdpr = zcovpclr * zbeta * (zqsliq - zqe) / zdenom * zdp * zrg_r;
      const T zdpevap = zdpr * zdtgdp;
      const T zevap = mn(zdpevap, zqxfg[IR]);
#else
      // 4.5 rain evaporation, Abel and Boutle 2013 (ref: 2190-2279)
      T zzrh = K[C_rprecrhmax] +
               K[C_one_m_rprecrhmax] * zcovpmax / mx(EPS, O - za);
      zzrh = mn(mx(zzrh, K[C_rprecrhmax]), O);
      zzrh = mn(T(0.8), zzrh);
      const T zqe = mx(Z, mn(zqx[IV], zqsliq));
      const bool llo1 = (zcovpclr > EPS) && (zqxfg[IR] > EPS) &&
                        (zqe < zzrh * zqsliq);
      const T zpreclr = zqxfg[IR] / (llo1 ? zcovptot : O);
      const T zesatliq = K[C_rv_over_rd] * in.zfoeeliq;
      const T lam_den2 = llo1 ? zrho * zpreclr : O;
      const T lam_base = K[C_rcl_fac1] / lam_den2;
      const T zevap_denom = K[C_rcl_cdenom1] * zesatliq -
                            K[C_rcl_cdenom2] * ztp1 * zesatliq +
                            K[C_rcl_cdenom3] * (ztp1 * ztp1 * ztp1) * pap;
      const T ztq = ztp1 / T(273.0);
      const T zcorr2 = ztq * d_sqrt(ztq) * T(393.0) / (ztp1 + T(120.0));
      const T zsubsat = mx(zzrh * zqsliq - zqe, Z);
      const T zbeta = (T(0.5) / zqsliq) * sq(ztp1) * zesatliq *
          K[C_rcl_const1r] * (zcorr2 / zevap_denom) *
          (T(0.78) / d_pow(lam_base, K[C_fac2_c4r]) +
           K[C_rcl_const2r] * d_sqrt(zrho * zfallcorr) /
               (d_sqrt(zcorr2) * d_pow(lam_base, K[C_fac2_c3r])));
      const T zdenom = O + zbeta * ptsphy;
      const T zdpevap = zcovpclr * zbeta * ptsphy * zsubsat / zdenom;
      const T zevap = mn(zdpevap, zqxfg[IR]);
#endif
#if !CLOUDSC_SKIP_S45R
      const T amt = llo1 ? zevap : Z;
      sqa[IV][IR] = sqa[IV][IR] + amt;
      sqa[IR][IV] = sqa[IR][IV] + -amt;
      zcovptot = llo1
          ? mx(K[C_rcovpmin],
               zcovptot - mx(Z, (zcovptot - za) * zevap / zqxfg[IR]))
          : zcovptot;
      zqxfg[IR] = zqxfg[IR] - amt;
#else
      (void)zevap;
      (void)llo1;
#endif
    }

#if CLOUDSC_IEVAPSNOW == 1
    // 4.5 snow sublimation, Sundqvist (ref: 2289-2347)
    {
      T zzrh = K[C_rprecrhmax] +
               K[C_one_m_rprecrhmax] * zcovpmax / mx(EPS, O - za);
      zzrh = mn(mx(zzrh, K[C_rprecrhmax]), O);
      T zqe = (zqx[IV] - za * zqsice) / mx(EPS, O - za);
      zqe = mx(Z, mn(zqe, zqsice));
      const bool llo1 = (zcovpclr > EPS) && (zqxfg[IS] > EPS) &&
                        (zqe < zzrh * zqsice);
      T denom = zcovptot * zdtgdp;
      denom = sgn(denom) * mx(d_abs(denom), zepsilon);
      denom = denom == Z ? zepsilon : denom;
      const T zpreclr = zqxfg[IS] * zcovpclr / denom;
      const T zbeta1 = d_sqrt(pap / x.paph_surf) / K[C_rvrfactor] * zpreclr /
                       mx(zcovpclr, EPS);
      const T b1_pow = zbeta1 > Z ? d_pow(zbeta1, T(0.5777)) : Z;
      const T zbeta = K[C_rg_rpecons] * b1_pow;
      const T zdenom = O + zbeta * ptsphy * zcorqsice;
      const T zdpr = zcovpclr * zbeta * (zqsice - zqe) / zdenom * zdp * zrg_r;
      const T zdpevap = zdpr * zdtgdp;
      const T zevap = mn(zdpevap, zqxfg[IS]);
#if !CLOUDSC_SKIP_S45S
      const T amt = llo1 ? zevap : Z;
      sqa[IV][IS] = sqa[IV][IS] + amt;
      sqa[IS][IV] = sqa[IS][IV] + -amt;
      zcovptot = llo1
          ? mx(K[C_rcovpmin],
               zcovptot - mx(Z, (zcovptot - za) * zevap / zqxfg[IS]))
          : zcovptot;
      zqxfg[IS] = zqxfg[IS] - amt;
#else
      (void)zevap;
      (void)llo1;
#endif
    }
#else
    // 4.5 snow sublimation, PSD-based (ref: 2349-2419); ZTCG = ZFACX1S = 1
    {
      T zzrh = K[C_rprecrhmax] +
               K[C_one_m_rprecrhmax] * zcovpmax / mx(EPS, O - za);
      zzrh = mn(mx(zzrh, K[C_rprecrhmax]), O);
      T zqe = (zqx[IV] - za * zqsice) / mx(EPS, O - za);
      zqe = mx(Z, mn(zqe, zqsice));
      const bool llo1 = (zcovpclr > EPS) && (zqx[IS] > EPS) &&
                        (zqe < zzrh * zqsice);
      const T zpreclr = zqx[IS] / (llo1 ? mx(zcovptot, EPS) : O);
      const T zvpice2 = in.zfoeeice * RV / RD;
      const T zaplusb = K[C_rcl_apb1] * zvpice2 -
                        K[C_rcl_apb2] * zvpice2 * ztp1 +
                        pap * K[C_rcl_apb3] * (ztp1 * ztp1 * ztp1);
      const T zcorrfac = d_sqrt(O / zrho);
      const T ztq = ztp1 / T(273.0);
      const T zcorrfac2 = ztq * d_sqrt(ztq) * (T(393.0) / (ztp1 + T(120.0)));
      const T zpr02 = zrho * zpreclr * K[C_rcl_const1s];
      const T zterm1 = (zqsice - zqe) * sq(ztp1) * zvpice2 * zcorrfac2 *
                       K[C_rcl_const2s] / (zrho * zaplusb * zqsice);
      const bool p2_pos = zpr02 > Z;
      const T pow4 = p2_pos ? d_pow(zpr02, K[C_rcl_const4s]) : Z;
      const T pow5 = p2_pos ? d_pow(zpr02, K[C_rcl_const5s]) : Z;
      const T zterm2 = K[C_c065_const6s] * pow4 +
                       K[C_rcl_const3s] * d_sqrt(zcorrfac) * d_sqrt(zrho) *
                           pow5 / d_sqrt(zcorrfac2);
      const T zdpevap = mx(zcovpclr * zterm1 * zterm2 * ptsphy, Z);
      const T zevaplimice = mx((zqsice - zqx[IV]) / zcorqsice, Z);
      T zevap = mn(zdpevap, zevaplimice);
      zevap = mn(zevap, zqx[IS]);
      const T amt = llo1 ? zevap : Z;
      sqa[IV][IS] = sqa[IV][IS] + amt;
      sqa[IS][IV] = sqa[IS][IV] + -amt;
      zcovptot = llo1
          ? mx(K[C_rcovpmin],
               zcovptot - mx(Z, (zcovptot - za) * zevap / zqx[IS]))
          : zcovptot;
      zqxfg[IS] = zqxfg[IS] - amt;
    }
#endif

    // 4.6 evaporate small precipitation amounts (ref: 2426-2435)
#if !CLOUDSC_SKIP_S46
#pragma unroll
    for (int m = IR; m <= IS; ++m) {
      const T v = zqxfg[m] < rlmin ? zqxfg[m] : Z;
      sqa[IV][m] = sqa[IV][m] + v;
      sqa[m][IV] = sqa[m][IV] + -v;
    }
#endif

    // 5.2.1 conservation scaling of explicit sinks (ref: 2467-2580)
#if !CLOUDSC_SKIP_S521
    {
      T zsinksum[NCLV], zmax[NCLV];
      bool ok = true;
#pragma unroll
      for (int m = 0; m < NCLV; ++m) {
        T s = -sqa[m][0];
#pragma unroll
        for (int n = 1; n < NCLV; ++n) s = s + -sqa[m][n];
        zsinksum[m] = s;
        zmax[m] = mx(zqx[m], EPS);
        ok = ok && (zsinksum[m] <= zmax[m]);
      }
      if (!DYNAMIC_SKIPS || !ok) {
        T zratio[NCLV], ratio_fin[NCLV];
        int rank[NCLV];
#pragma unroll
        for (int m = 0; m < NCLV; ++m)
          zratio[m] = zmax[m] / mx(zsinksum[m], zmax[m]);
#pragma unroll
        for (int m = 0; m < NCLV; ++m) {
          int r = 0;
#pragma unroll
          for (int n = 0; n < NCLV; ++n) {
            if (n < m) r += zratio[n] <= zratio[m];
            else if (n > m) r += zratio[n] < zratio[m];
          }
          rank[m] = r;
          ratio_fin[m] = r == 0 ? zratio[m] : O;
        }
        bool neg0[NCLV][NCLV];
#pragma unroll
        for (int m = 0; m < NCLV; ++m) {
#pragma unroll
          for (int n = 0; n < NCLV; ++n) neg0[m][n] = sqa[m][n] < Z;
        }
#if CLOUDSC_S521_ROUND_SKIP
        // the per-round skip (scheme.py's s521_round_skip): species m's
        // negative entries alone within zmax[m] means no earlier round can
        // make it overshoot, and its round is the identity (zmax / zmax)
        bool never_over[NCLV];
#pragma unroll
        for (int m = 0; m < NCLV; ++m) {
          T npart = Z;
#pragma unroll
          for (int n = 0; n < NCLV; ++n)
            npart = npart + (neg0[m][n] ? -sqa[m][n] : Z);
          never_over[m] = npart <= zmax[m];
        }
#endif
#pragma unroll
        for (int round = 1; round < NCLV; ++round) {
#if CLOUDSC_S521_ROUND_SKIP
          bool unsafe = false;
#pragma unroll
          for (int m = 0; m < NCLV; ++m)
            unsafe = unsafe || (rank[m] == round && !never_over[m]);
          if (DYNAMIC_SKIPS && !unsafe) continue;
#endif
          T num = Z, den = O;
#pragma unroll
          for (int m = 0; m < NCLV; ++m) {
            if (rank[m] != round) continue;
            T sink = Z;
#pragma unroll
            for (int n = 0; n < NCLV; ++n) {
              T v = sqa[m][n];
              if (n != m && neg0[n][m] && rank[n] < rank[m]) v = v * ratio_fin[n];
              sink = n == 0 ? -v : sink + -v;
            }
            num = zmax[m];
            den = mx(sink, zmax[m]);
          }
          const T ratio_sel = num / den;
#pragma unroll
          for (int m = 0; m < NCLV; ++m)
            ratio_fin[m] = rank[m] == round ? ratio_sel : ratio_fin[m];
        }
#pragma unroll
        for (int m = 0; m < NCLV; ++m) {
#pragma unroll
          for (int n = 0; n < NCLV; ++n) {
            T v = sqa[m][n];
            if (neg0[m][n]) v = v * ratio_fin[m];
            if (neg0[n][m]) v = v * ratio_fin[n];
            sqa[m][n] = v;
          }
        }
      }
    }
#endif

    // 5.2.2 implicit 5x5 solve: LHS + non-pivoting LU (ref: 2589-2668)
    {
      T qlhs[NCLV][NCLV];
#pragma unroll
      for (int mc = 0; mc < NCLV; ++mc) {
        T diag = O + fallsink[mc];
#pragma unroll
        for (int o = 0; o < NCLV; ++o) diag = diag + sqb[o][mc];
        qlhs[mc][mc] = diag;
      }
#pragma unroll
      for (int nr = 0; nr < NCLV; ++nr) {
#pragma unroll
        for (int mc = 0; mc < NCLV; ++mc)
          if (nr != mc) qlhs[nr][mc] = -sqb[nr][mc];
      }
#pragma unroll
      for (int m = 0; m < NCLV; ++m) {
        T s = sqa[m][0];
#pragma unroll
        for (int n = 1; n < NCLV; ++n) s = s + sqa[m][n];
        zqxn[m] = zqx[m] + s;
      }
#if !CLOUDSC_SKIP_S522
#pragma unroll
      for (int jn = 0; jn < NCLV - 1; ++jn) {
#pragma unroll
        for (int jm = jn + 1; jm < NCLV; ++jm) {
          qlhs[jm][jn] = qlhs[jm][jn] / qlhs[jn][jn];
#pragma unroll
          for (int ik = jn + 1; ik < NCLV; ++ik)
            qlhs[jm][ik] = qlhs[jm][ik] - qlhs[jm][jn] * qlhs[jn][ik];
        }
      }
#pragma unroll
      for (int jn = 1; jn < NCLV; ++jn) {
#pragma unroll
        for (int jm = 0; jm < jn; ++jm)
          zqxn[jn] = zqxn[jn] - qlhs[jn][jm] * zqxn[jm];
      }
      zqxn[NCLV - 1] = zqxn[NCLV - 1] / qlhs[NCLV - 1][NCLV - 1];
#pragma unroll
      for (int jn = NCLV - 2; jn >= 0; --jn) {
#pragma unroll
        for (int jm = jn + 1; jm < NCLV; ++jm)
          zqxn[jn] = zqxn[jn] - qlhs[jn][jm] * zqxn[jm];
        zqxn[jn] = zqxn[jn] / qlhs[jn][jn];
      }
#endif
    }

    // clip small/negative values to vapour (ref: 2673-2680)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const bool neg = zqxn[n] < EPS;
      zqxn[IV] = zqxn[IV] + (neg ? zqxn[n] : Z);
      zqxn[n] = neg ? Z : zqxn[n];
    }

    // 5.3 precipitation flux to the next level (ref: 2698-2712)
#pragma unroll
    for (int m = II; m <= IS; ++m) pf_next[m] = fallsink[m] * zqxn[m] * zrdtgdp;
    const T zqpre2 = pf_next[IS] + pf_next[IR];
    zcovptot = zqpre2 < EPS ? Z : zcovptot;

    // 6. tendencies (ref: 2722-2773)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const T sinks = fallsink[m] + convsink[m];
      const T zfluxq = psupsrce[m] + convsrce[m] + fallsrce[m] +
                       -(sinks * zqxn[m]);
      const T lat = (m == IL || m == IR) ? RALVDCP : RALSDCP;
      tend_t = tend_t + lat * (zqxn[m] - zqx[m] - zfluxq) * zqtmst;
    }
    tend_q = in.tend_q_pre + (zqxn[IV] - zqx[IV]) * zqtmst;
  }

  // 5.1 cloud-fraction solver (ref: 2446-2455)
  T zanew = mn((za + solac) / (O + solab), O);
  zanew = zanew < K[C_ramin] ? Z : zanew;
  const T zda = zanew - in.zaorig;

  cr.zanewm1 = zanew;
#pragma unroll
  for (int m = 0; m < NCLV; ++m) {
    cr.zqxnm1[m] = zqxn[m];
    cr.pfplsx[m] = pf_next[m];
    ys.zqxn[m] = zqxn[m];
  }
  cr.zcovptot = zcovptot;
  cr.zcovpmax = zcovpmax;
  cr.zcldtopdist = zcldtopdist;
  cr.llrainliq = llrainliq;
  cr.prainfrac = prainfrac;
  ys.plude = plude_out;
  ys.pcovptot = zcovptot;
  ys.tend_t = tend_t;
  ys.tend_q = tend_q;
  ys.tend_a = zda * zqtmst;
}

}  // namespace cloudsc
