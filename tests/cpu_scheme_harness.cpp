// csrc/cloudsc_scheme.cuh compiled for the host: fused_kernel's level loop
// (csrc/cloudsc_fused.cu) with direct loads in place of the shared-memory
// ring, one column after another, in double (or HARNESS_T, float), and
// zdqs_kernel's level_zdqs for every (level, column). tests/
// test_torch_kernel.py builds it with g++ -ffp-contract=off, a stub
// cuda_runtime.h and the kernel version's CLOUDSC_* macros (scheme
// version, form, output rows, skips), and holds its outputs to the plain
// version's, so the CUDA header's arithmetic and branches are checked on a
// host without a card.
//
//   harness NLEV NCOL NROWS DIR        reads DIR/{pack,col,consts}.bin
//                                      (float64) and writes DIR/out.bin:
//                                      o_lev, o_half, o_prainfrac
//   harness NLEV NCOL NROWS DIR zdqs   reads DIR/{pack,consts}.bin and
//                                      writes DIR/zdqs.bin: the (nlev,
//                                      ncol) ZDQS row (0 above the cloud
//                                      top, as level_zdqs gives it)
// Every value is read and written as float64 and cast to T and back.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cloudsc_scheme.cuh"

using namespace cloudsc;
#ifdef HARNESS_T
using T = HARNESS_T;
#else
using T = double;
#endif

enum { OL_PLUDE, OL_PCOVPTOT, OL_TEND_T, OL_TEND_Q, OL_TEND_A, OL_TCLD0,
       OL_COUNT = OL_TCLD0 + 5 };
enum { OH_PFSQLF, OH_PFSQIF, OH_PFCQLNG, OH_PFCQNNG, OH_PFSQRF, OH_PFSQSF,
       OH_PFCQRNG, OH_PFCQSNG, OH_PFPLSL, OH_PFPLSN,
#if !CLOUDSC_FOLD_OUTPUTS
       OH_PFSQLTUR, OH_PFSQITUR, OH_PFHPSL, OH_PFHPSN,
#endif
       OH_COUNT };

static void column(const T* pack, const T* col, const T* K, T* o_lev,
                   T* o_half, T* o_pr, int nlev, int ncol, int nrows, int j) {
  const T Z = T(0);
  const int ktop = int(K[C_NCLDTOP]) - 1;
  const int nssopt = int(K[C_NSSOPT]);
  const T zqtmst = K[C_zqtmst], ptsphy = K[C_ptsphy];
  const size_t n = size_t(ncol);
  auto P = [&](int lev, int r) { return pack[(size_t(lev) * nrows + r) * n + j]; };
  const T plsm = col[0 * n + j];
  const bool ldcum = col[1 * n + j] > T(0.5);
  const int ktype = int(col[2 * n + j]);
  const T paph_surf = col[3 * n + j];
  Carry<T> cr;
  cr.zanewm1 = Z;
  for (int m = 0; m < NCLV; ++m) { cr.zqxnm1[m] = Z; cr.pfplsx[m] = Z; }
  cr.zcovptot = Z;
  cr.zcovpmax = Z;
  cr.zcldtopdist = Z;
  cr.prainfrac = Z;
  cr.llrainliq = true;
  T ztp1_prev = Z, za_prev = Z, pap_prev = Z;
  T a_lf = Z, a_if = Z, a_lng = Z, a_nng = Z;
  T alf_prev = Z, aif_prev = Z, alng_prev = Z, anng_prev = Z;
  T rain_prev = Z, snow_prev = Z, lnegr_prev = Z, lnegs_prev = Z;
#if !CLOUDSC_FOLD_OUTPUTS
  T a_ltur = Z, a_itur = Z;
#endif
  for (int k = 0; k <= nlev; ++k) {
    T* oh = o_half + size_t(k) * OH_COUNT * n + j;
    oh[OH_PFSQLF * n] = a_lf;
    oh[OH_PFSQIF * n] = a_if;
    oh[OH_PFCQLNG * n] = a_lng;
    oh[OH_PFCQNNG * n] = a_nng;
    oh[OH_PFSQRF * n] = alf_prev + rain_prev;
    oh[OH_PFSQSF * n] = aif_prev + snow_prev;
    oh[OH_PFCQRNG * n] = alng_prev + lnegr_prev;
    oh[OH_PFCQSNG * n] = anng_prev + lnegs_prev;
    oh[OH_PFPLSL * n] = cr.pfplsx[IR] + cr.pfplsx[IL];
    oh[OH_PFPLSN * n] = cr.pfplsx[IS] + cr.pfplsx[II];
#if !CLOUDSC_FOLD_OUTPUTS
    oh[OH_PFSQLTUR * n] = a_ltur;
    oh[OH_PFSQITUR * n] = a_itur;
    oh[OH_PFHPSL * n] = -K[C_RLVTT] * (cr.pfplsx[IR] + cr.pfplsx[IL]);
    oh[OH_PFHPSN * n] = -K[C_RLSTT] * (cr.pfplsx[IS] + cr.pfplsx[II]);
#endif
    if (k == nlev) break;
    T ztp1_in, zqv_in, za_in, zqx_in[4];
    state_rows(P, k, K, ztp1_in, zqv_in, za_in, zqx_in);
    const T pap = P(k, R_PAP), plude_in = P(k, R_PLUDE);
    const T paph_k = P(k, R_PAPH), paph_k1 = P(k + 1, R_PAPH);
    T curves[NCURVES];
    curve_rows(P, k, curves);
    Init<T> in;
    level_init(K, ztp1_in, zqv_in, za_in, zqx_in, pap, curves, in);
    T plude_row = plude_in, pcovptot_row = Z, tend_t_row = in.tend_t_pre,
      tend_q_row = in.tend_q_pre, tend_a_row = Z;
    T zqxn_eff[NCLV];
    for (int m = 0; m < NCLV; ++m) zqxn_eff[m] = Z;
    if (k >= ktop) {
      LevelX<T> x;
      x.ztp1_prev = ztp1_prev;
      x.za_prev = za_prev;
      x.pap = pap;
      x.pap_prev = pap_prev;
      x.paph = paph_k;
      x.paph_next = paph_k1;
      x.paph_surf = paph_surf;
      x.plude_in = plude_in;
      level_rows(P, k, x);
      x.land = plsm > T(0.5);
      x.ldcum = ldcum;
      x.ktype = ktype;
      x.not_first = k > ktop;
      x.not_last = k < nlev - 1;
      Ys<T> ys;
      level_step(K, nssopt, in, x, cr, ys);
      plude_row = ys.plude;
      pcovptot_row = ys.pcovptot;
      tend_t_row = ys.tend_t;
      tend_q_row = ys.tend_q;
      tend_a_row = ys.tend_a;
      for (int m = 0; m < NCLV; ++m) zqxn_eff[m] = ys.zqxn[m];
    }
    T* ol = o_lev + size_t(k) * OL_COUNT * n + j;
    ol[OL_PLUDE * n] = plude_row;
    ol[OL_PCOVPTOT * n] = pcovptot_row;
    ol[OL_TEND_T * n] = tend_t_row;
    ol[OL_TEND_Q * n] = tend_q_row;
    ol[OL_TEND_A * n] = tend_a_row;
    for (int m = 0; m < 4; ++m)
      ol[(OL_TCLD0 + m) * n] = (zqxn_eff[m] - in.zqx0[m]) * zqtmst;
    ol[(OL_TCLD0 + IV) * n] = T(0);
    ztp1_prev = in.ztp1;
    za_prev = in.za;
    pap_prev = pap;
    const T zgdph_r = -K[C_zrg_r] * (paph_k1 - paph_k) * zqtmst;
    const T liq_inc = (zqxn_eff[IL] - in.zqx0[IL] + P(k, R_PVFL) * ptsphy -
                       in.zfoealfa * plude_row) * zgdph_r;
    const T ice_inc = (zqxn_eff[II] - in.zqx0[II] + P(k, R_PVFI) * ptsphy -
                       (T(1) - in.zfoealfa) * plude_row) * zgdph_r;
    alf_prev = a_lf;
    aif_prev = a_if;
    alng_prev = a_lng;
    anng_prev = a_nng;
    rain_prev = (zqxn_eff[IR] - in.zqx0[IR]) * zgdph_r;
    snow_prev = (zqxn_eff[IS] - in.zqx0[IS]) * zgdph_r;
    lnegr_prev = in.zlneg[IR] * zgdph_r;
    lnegs_prev = in.zlneg[IS] * zgdph_r;
    a_lf = a_lf + liq_inc;
    a_if = a_if + ice_inc;
    a_lng = a_lng + in.zlneg[IL] * zgdph_r;
    a_nng = a_nng + in.zlneg[II] * zgdph_r;
#if !CLOUDSC_FOLD_OUTPUTS
    a_ltur = a_ltur + P(k, R_PVFL) * ptsphy * zgdph_r;
    a_itur = a_itur + P(k, R_PVFI) * ptsphy * zgdph_r;
#endif
  }
  o_pr[j] = cr.prainfrac;
}

static std::vector<T> read(const char* dir, const char* name, size_t count) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  std::vector<double> v(count);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(double), count, f) != count) {
    fprintf(stderr, "cannot read %zu values from %s\n", count, path);
    exit(2);
  }
  fclose(f);
  return std::vector<T>(v.begin(), v.end());
}

static void write(FILE* f, const std::vector<T>& v) {
  const std::vector<double> d(v.begin(), v.end());
  fwrite(d.data(), sizeof(double), d.size(), f);
}

int main(int argc, char** argv) {
  if (argc != 5 && !(argc == 6 && !strcmp(argv[5], "zdqs"))) return 2;
  const int nlev = atoi(argv[1]), ncol = atoi(argv[2]), nrows = atoi(argv[3]);
  const char* dir = argv[4];
  if (nrows != R_COUNT) {
    fprintf(stderr, "a pack of %d rows, the build's R_COUNT is %d\n", nrows,
            R_COUNT);
    return 3;
  }
  const auto pack = read(dir, "pack.bin", size_t(nlev + 1) * nrows * ncol);
  const auto K = read(dir, "consts.bin", C_COUNT);
  char path[4096];
  if (argc == 6) {
    // zdqs_kernel's element (k, j), the pack's edge row standing for the
    // Rows policy's clamp
    std::vector<T> zdqs(size_t(nlev) * ncol);
    for (int k = 0; k < nlev; ++k)
      for (int j = 0; j < ncol; ++j) {
        auto P = [&](int lev, int r) {
          return pack[(size_t(lev) * nrows + r) * ncol + j];
        };
        zdqs[size_t(k) * ncol + j] = level_zdqs<T>(P, k, nlev, K.data());
      }
    snprintf(path, sizeof path, "%s/zdqs.bin", dir);
    FILE* f = fopen(path, "wb");
    if (!f) return 4;
    write(f, zdqs);
    fclose(f);
    return 0;
  }
  const auto col = read(dir, "col.bin", size_t(4) * ncol);
  std::vector<T> o_lev(size_t(nlev) * OL_COUNT * ncol),
      o_half(size_t(nlev + 1) * OH_COUNT * ncol), o_pr(ncol);
  for (int j = 0; j < ncol; ++j)
    column(pack.data(), col.data(), K.data(), o_lev.data(), o_half.data(),
           o_pr.data(), nlev, ncol, nrows, j);
  snprintf(path, sizeof path, "%s/out.bin", dir);
  FILE* f = fopen(path, "wb");
  if (!f) return 4;
  write(f, o_lev);
  write(f, o_half);
  write(f, o_pr);
  fclose(f);
  return 0;
}
