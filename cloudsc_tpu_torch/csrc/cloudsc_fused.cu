// The fused CLOUDSC step as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel cloudsc_tpu/kernels/pallas_cloudsc.py::_build ->
// pl.pallas_call(_kernel) (body: _kernel, _sub_level, _write_level_rows and
// scheme.level_init / scheme.level_step), in every contract the TPU kernel
// takes: the folded input pack, with the streamed ZDQS row or the in-line
// CUADJTQ, with or without the streamed saturation-curve and deposition
// rows, or the unfolded pack (CLOUDSC_FOLD_INPUTS=0: the raw state and
// tendencies, whose x + PTSPHY*tend, PMFU+PMFD and PHRSW+PHRLW the kernel
// forms at working precision, with the in-line CUADJTQ); the four
// derivable flux rows folded out of the outputs, or written here
// (CLOUDSC_FOLD_OUTPUTS=0: PFSQLTUR/ITUR as running sums in registers,
// PFHPSL/N = -RLVTT/RLSTT x PFPLSL/N). One library holds one version,
// named by the CLOUDSC_* macros of cloudsc_scheme.cuh (SchemeConfig's four
// switches, skips and aerosol couplings, the pack's form and the output
// rows); the ring streams the form's rows: 19 in the main path's form, 18
// to 30 in the other folded forms, 27 unfolded, 28 unfolded with the ZDQS
// row that zdqs_kernel (below) writes for a field dict, 5 more with every
// aerosol coupling.
//
// Schedule: the reference's own k-caching schedule. One thread owns one
// column and integrates it top-down through all levels; the 33 cross-level
// carries and the section-8 running sums are locals (registers). Element
// (k, r, j) of the pack sits at
// (k*nrows + r)*ncol + j, so every copy and store of a warp is one coalesced
// run. The dynamic skips of the TPU kernel (above-cloud-top levels, the
// precipitation region, the rain sub-branch, the 5.2.1 no-overshoot case)
// are per-thread branches. Built with -fmad=false, in the plain version's
// operation order: bitwise equal to it (kernels/cuda_cloudsc.py).
//
// What bounds it on this card: per column and step it streams 138 x 19
// values in and 137 x 9 + 138 x 10 values out (~5,240 values: 21 kB in
// fp32, 42 kB in fp64; unfolded, 138 x 27 in: ~6,344 values) against
// ~124,823 flops in the reference's flop model (timer_mod.F90: 12,482,329
// per 100 columns), about 6 flop a byte in fp32: by the roofline the bytes
// bound it (PERF.md: 1.025 / 2.050 ms a step at 163,840 columns, 1.240 /
// 2.480 ms unfolded). But one column a thread takes many registers, so few
// warps are resident, and each level's work is a long dependent scalar
// chain. A kernel that loads level k's rows at level k waits out the memory
// latency once a level: the first version did, streamed at ~60 % of the
// copy roof, and did not hide its compute under the stream.
//
// What the TPU kernel did about the same problem: its Pallas pipeline
// double-buffers each grid step's block of lps levels, plus a lookahead
// block for the k+1 rows, so the next levels arrive in VMEM while the
// current ones compute (pallas_cloudsc.py:847-876). Here each thread runs
// its own pipeline: a ring of S stages of the R_COUNT input rows in dynamic
// shared memory, laid out [S][R_COUNT][BLOCK] so a warp's copies land on
// consecutive words. The thread copies level k+S-1 of its own column with
// cp.async (4 or 8 bytes, no registers held while in flight) and commits one
// group a level; before level k computes, cp.async.wait_group(S-2) makes
// levels k and k+1 complete (the k+1 rows pmf, plu, paph included). A thread
// reads only what it copied itself, so no block barrier is needed, and
// divergence between columns or a ragged last block costs nothing.
// `kernels/cuda_cloudsc.py::ring_schedule` models the slots and groups, and
// the CPU tests check it; `cuda_cloudsc.RING` holds the geometry of both
// precisions (S, BLOCK and the launch bound's blocks an SM), chosen by
// bench/ring_sweep.py, and kernels/build.py passes it here as the
// CLOUDSC_RING_* macros. Holding no loads in registers, the kernel needs
// 128 (fp32) / 236 (fp64) registers in the reference configuration's build
// (125-134 / 234-244 in the others, PERF.md) and spills nothing, 16 / 8
// warps an SM on an H100; the stream then hides under the compute, and the
// body's own instruction stream sets the pace.
//
// Two addressing policies feed the ring, one body for both (a template
// parameter of fused_kernel; only the ring's source addresses and the four
// per-column reads differ, so the arithmetic, the schedule and the register
// budget are the same):
//   Pack  the pack above and `col` (PLSM, LDCUM, KTYPE as the pack's type,
//         then the surface pressure): row r of level lev at
//         pack + (lev*nrows + r)*ncol + j. Every entry point but the rows'
//         reads it, and the floor and init bodies read nothing else.
//   Rows  a plain field dict read where it lies, with no pack: a table of
//         R_COUNT row base pointers and each row's height h_r (nlev, or
//         nlev+1 for PAPH), passed by value in the kernel's parameter space
//         (the constant bank: no device array, no copy, no extra operation
//         a step). Row r of level lev is at p[r] + min(lev, h_r - 1)*ncol + j:
//         clamping the level reads, at level nlev, the same values the pack's
//         edge-replicated row nlev holds. PLSM is read in the working type,
//         LDCUM as a byte (!= 0), KTYPE as int32, the surface pressure at
//         PAPH's level nlev. Only the unfolded builds have it (the unfolded
//         pack's rows are fields; a folded row is not), as the C entries
//         cloudsc_fused_rows_{f32,f64}; kernels/cuda_cloudsc.py launches it
//         for a field dict on the card whose rows are contiguous (h_r, ncol)
//         tensors of the working type (`rows_in_place`), in the build with
//         CLOUDSC_FN, after zdqs_kernel has written the table's ZDQS row.
// A warp's copies coalesce alike from either source: every row of both is
// a run of ncol columns.
//
// Beside it, the TPU kernel's two diagnostic bodies (floor_kernel,
// init_kernel; see below), which split the step's time into stream and
// compute. They keep their direct loads and 128-thread blocks.
#include <cuda_runtime.h>

#include <mutex>

#include "cloudsc_scheme.cuh"

#if !defined(CLOUDSC_RING_STAGES) || !defined(CLOUDSC_RING_BLOCK) || \
    !defined(CLOUDSC_RING_MIN_BLOCKS)
#error "the ring geometry comes from kernels/build.py (cuda_cloudsc.RING)"
#endif

namespace cloudsc {

// output rows: per level (OLEV_ROWS) and per half level (OHALF_ROWS) in
// kernels/cuda_cloudsc.py; the five cloud tendencies OL_TCLD0..+4 (NCLV
// order, the vapour's last and 0) are TENDENCY_LOC_CLD as `assemble`
// returns it, a view of o_lev
enum { OL_PLUDE, OL_PCOVPTOT, OL_TEND_T, OL_TEND_Q, OL_TEND_A, OL_TCLD0,
       OL_COUNT = OL_TCLD0 + 5 };
enum { OH_PFSQLF, OH_PFSQIF, OH_PFCQLNG, OH_PFCQNNG, OH_PFSQRF, OH_PFSQSF,
       OH_PFCQRNG, OH_PFCQSNG, OH_PFPLSL, OH_PFPLSN,
#if !CLOUDSC_FOLD_OUTPUTS
       OH_PFSQLTUR, OH_PFSQITUR, OH_PFHPSL, OH_PFHPSN,
#endif
       OH_COUNT };

// K1's ring geometry: S stages, BLOCK threads a block, the launch bound's
// MIN_BLOCKS an SM
constexpr int RING_S = CLOUDSC_RING_STAGES;
constexpr int RING_BLOCK = CLOUDSC_RING_BLOCK;
constexpr int RING_MIN_BLOCKS = CLOUDSC_RING_MIN_BLOCKS;
static_assert(RING_S >= 3,
              "levels k and k+1 are read while level k+S-1 is in flight");

// dynamic shared memory of one block of fused_kernel<T, *>: the ring
template <typename T> constexpr int ring_bytes() {
  return RING_S * R_COUNT * RING_BLOCK * int(sizeof(T));
}

// one element from device memory into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group but the N most recent is complete
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K1's addressing policies (see the top of the file), a template parameter
// of fused_kernel: the ring's copy of row r of level `lev` of column j and
// the four per-column values come from the `pack` and `col` parameters
// (Pack, a tag), or from the table `rows` (Rows). `KIND` indexes the
// once-flags of configure_fused. The pack's pointers stay plain
// __restrict__ parameters, so the Pack policy builds as the kernel did
// before it had a policy.
struct Pack {
  static constexpr int KIND = 0;
};

template <typename T> struct Rows {
  static constexpr int KIND = 1;
  const T* p[R_COUNT];  // row r's (h[r], ncol) field, columns innermost
  int h[R_COUNT];       // its height: nlev, or nlev+1 (PAPH)
  const T* plsm;
  const unsigned char* ldcum;  // a bool a column
  const int* ktype;
};

template <typename T, typename Src>
__global__ void __launch_bounds__(RING_BLOCK, RING_MIN_BLOCKS)
fused_kernel(const T* __restrict__ pack, const T* __restrict__ col,
             const double* __restrict__ kd, T* __restrict__ o_lev,
             T* __restrict__ o_half, T* __restrict__ o_prainfrac, int nlev,
             int ncol, int nrows, const Src rows) {
  constexpr int S = RING_S, BLOCK = RING_BLOCK, D = S - 1;
  constexpr bool PACKED = Src::KIND == Pack::KIND;
  // the constants, cast to the working precision once per block
  __shared__ T K[C_COUNT];
  extern __shared__ __align__(16) unsigned char ring_smem[];
  for (int i = threadIdx.x; i < C_COUNT; i += blockDim.x) K[i] = T(kd[i]);
  __syncthreads();
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= ncol) return;

  const T Z = T(0);
  const int ktop = int(kd[C_NCLDTOP]) - 1;
  const int nssopt = int(kd[C_NSSOPT]);
  const T zqtmst = K[C_zqtmst], ptsphy = K[C_ptsphy];
  const size_t n = size_t(ncol);

  // this thread's slots: row r of stage s at mine[(s*R_COUNT + r)*BLOCK]
  T* const mine = reinterpret_cast<T*>(ring_smem) + threadIdx.x;
  // copy level `lev`'s rows into stage lev % S; one group a level, empty
  // past the last level, so group g always holds level g. Rows: a row's
  // level clamped to its height, so level nlev of a per-level row reads
  // its level nlev-1, as the pack's edge-replicated row holds it. Every
  // row is nlev or nlev+1 levels high (launch_rows), so the clamp acts at
  // level nlev alone: below it a row's address is its base plus one
  // offset a level, as cheap as the pack's (the branch is the same for
  // every thread)
  auto fetch = [&](int lev) {
    if (lev <= nlev) {
      T* dst = mine + (lev % S) * R_COUNT * BLOCK;
      if constexpr (PACKED) {
        const T* src = pack + size_t(lev) * nrows * n + j;
#pragma unroll
        for (int r = 0; r < R_COUNT; ++r)
          cp_async(dst + r * BLOCK, src + r * n);
      } else if (lev < nlev) {
        const size_t off = size_t(lev) * n + j;
#pragma unroll
        for (int r = 0; r < R_COUNT; ++r)
          cp_async(dst + r * BLOCK, rows.p[r] + off);
      } else {
#pragma unroll
        for (int r = 0; r < R_COUNT; ++r)
          cp_async(dst + r * BLOCK,
                   rows.p[r] + size_t(min(lev, rows.h[r] - 1)) * n + j);
      }
    }
    cp_async_commit();
  };
  // row r of level `lev`, once its group is complete
  auto P = [&](int lev, int r) -> T {
    return mine[((lev % S) * R_COUNT + r) * BLOCK];
  };
  for (int lev = 0; lev < D; ++lev) fetch(lev);

  T plsm, paph_surf;
  bool ldcum;
  int ktype;
  if constexpr (PACKED) {
    plsm = col[0 * n + j];
    ldcum = col[1 * n + j] > T(0.5);
    ktype = int(col[2 * n + j]);
    paph_surf = col[3 * n + j];
  } else {
    // through the read-only path, as the pack's const __restrict__ col is
    // read: the compiler may then load a value again where it is used
    // rather than hold it in a register through the level loop
    plsm = __ldg(rows.plsm + j);
    ldcum = __ldg(rows.ldcum + j) != 0;
    ktype = __ldg(rows.ktype + j);
    paph_surf = __ldg(rows.p[R_PAPH] + size_t(nlev) * n + j);
  }

  Carry<T> cr;
  cr.zanewm1 = Z;
#pragma unroll
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
    // section 8 flux rows for half-level k, the state before level k
    // (ref: 2788-2867; rain/snow alias onto the liquid/ice flux of the
    // level above, ref: 2818-2819)
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

    // level k+S-1 goes into the stage level k-1 left; levels k and k+1
    // are then complete
    fetch(k + D);
    cp_async_wait<S - 2>();

    T ztp1_in, zqv_in, za_in, zqx_in[4];
    state_rows(P, k, K, ztp1_in, zqv_in, za_in, zqx_in);
    const T pap = P(k, R_PAP);
    const T plude_in = P(k, R_PLUDE);
    const T paph_k = P(k, R_PAPH);
    const T paph_k1 = P(k + 1, R_PAPH);
    T curves[NCURVES];
    curve_rows(P, k, curves);
    Init<T> in;
    level_init(K, ztp1_in, zqv_in, za_in, zqx_in, pap, curves, in);

    T plude_row = plude_in, pcovptot_row = Z, tend_t_row = in.tend_t_pre,
      tend_q_row = in.tend_q_pre, tend_a_row = Z;
    T zqxn_eff[NCLV];
#pragma unroll
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
#pragma unroll
      for (int m = 0; m < NCLV; ++m) zqxn_eff[m] = ys.zqxn[m];
    }

    T* ol = o_lev + size_t(k) * OL_COUNT * n + j;
    ol[OL_PLUDE * n] = plude_row;
    ol[OL_PCOVPTOT * n] = pcovptot_row;
    ol[OL_TEND_T * n] = tend_t_row;
    ol[OL_TEND_Q * n] = tend_q_row;
    ol[OL_TEND_A * n] = tend_a_row;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ol[(OL_TCLD0 + m) * n] = (zqxn_eff[m] - in.zqx0[m]) * zqtmst;
    ol[(OL_TCLD0 + IV) * n] = T(0);
    ztp1_prev = in.ztp1;
    za_prev = in.za;
    pap_prev = pap;

    // section-8 increments for this level (ref: 2798-2857)
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
    // the input-only running sums (cuda_cloudsc.foldo_synthesize's
    // recurrence)
    a_ltur = a_ltur + P(k, R_PVFL) * ptsphy * zgdph_r;
    a_itur = a_itur + P(k, R_PVFI) * ptsphy * zgdph_r;
#endif
  }
  cp_async_wait<0>();  // only empty groups are left
  o_prainfrac[j] = cr.prainfrac;
}

// -- the two diagnostic bodies of the TPU kernel (pallas_cloudsc.py:489-509,
// `_mode` "floor" and "init"), for the measurement lab
// (cloudsc_tpu_torch/bench/kernel_lab.py). They take the same pack and write
// the same three buffers as fused_kernel, so they stream the step's exact
// I/O, folded or unfolded: `floor` with degenerate compute (one add a level:
// ztp1_in + zqv_in, or pt + pq), `init` with the section-1 compute only. On the TPU the BlockSpecs stream every row
// whatever the body reads; here a load whose value goes unused would be
// dropped, so each level's rows (and col) are read through a volatile
// pointer: every input byte the step's model counts is loaded once. Every
// output row of level k gets the level's value v (o_lev only for k < nlev)
// but the vapour's cloud tendency, 0 as the full body writes it;
// o_prainfrac gets the value of the last level the loop visits, the
// edge-replicated row nlev, as the TPU body leaves it.
constexpr int DIAG_BLOCK = 128;

template <typename T>
__device__ __forceinline__ void load_level(const T* pack, int k, size_t n,
                                           int j, T (&row)[R_COUNT]) {
  const volatile T* pk = pack + size_t(k) * R_COUNT * n + j;
#pragma unroll
  for (int r = 0; r < R_COUNT; ++r) row[r] = pk[r * n];
}

template <typename T>
__device__ __forceinline__ void load_col(const T* col, size_t n, int j) {
  const volatile T* c = col + j;
#pragma unroll
  for (int r = 0; r < 4; ++r) (void)c[r * n];
}

template <typename T>
__device__ __forceinline__ void write_level(T* o_lev, T* o_half, int k,
                                            int nlev, size_t n, int j, T v) {
  T* oh = o_half + size_t(k) * OH_COUNT * n + j;
#pragma unroll
  for (int r = 0; r < OH_COUNT; ++r) oh[r * n] = v;
  if (k == nlev) return;
  T* ol = o_lev + size_t(k) * OL_COUNT * n + j;
#pragma unroll
  for (int r = 0; r < OL_COUNT; ++r)
    ol[r * n] = r == OL_TCLD0 + IV ? T(0) : v;
}

template <typename T>
__global__ void __launch_bounds__(DIAG_BLOCK)
floor_kernel(const T* __restrict__ pack, const T* __restrict__ col,
             const double* __restrict__ kd, T* __restrict__ o_lev,
             T* __restrict__ o_half, T* __restrict__ o_prainfrac, int nlev,
             int ncol, int nrows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncol) return;
  const size_t n = size_t(ncol);
  load_col(col, n, j);
  T v = T(0);
  for (int k = 0; k <= nlev; ++k) {
    T row[R_COUNT];
    load_level(pack, k, n, j, row);
#if CLOUDSC_FOLD_INPUTS
    v = row[R_ZTP1_IN] + row[R_ZQV_IN];
#else
    v = row[R_PT] + row[R_PQ];
#endif
    write_level(o_lev, o_half, k, nlev, n, j, v);
  }
  o_prainfrac[j] = v;
}

template <typename T>
__global__ void __launch_bounds__(DIAG_BLOCK)
init_kernel(const T* __restrict__ pack, const T* __restrict__ col,
            const double* __restrict__ kd, T* __restrict__ o_lev,
            T* __restrict__ o_half, T* __restrict__ o_prainfrac, int nlev,
            int ncol, int nrows) {
  __shared__ T K[C_COUNT];
  for (int i = threadIdx.x; i < C_COUNT; i += blockDim.x) K[i] = T(kd[i]);
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncol) return;
  const size_t n = size_t(ncol);
  load_col(col, n, j);
  T v = T(0);
  for (int k = 0; k <= nlev; ++k) {
    T row[R_COUNT];
    load_level(pack, k, n, j, row);
    const auto R = [&](int, int r) { return row[r]; };
    T ztp1_in, zqv_in, za_in, zqx_in[4];
    state_rows(R, k, K, ztp1_in, zqv_in, za_in, zqx_in);
    T curves[NCURVES];
    curve_rows(R, k, curves);
    Init<T> in;
    level_init(K, ztp1_in, zqv_in, za_in, zqx_in, row[R_PAP], curves, in);
    v = in.ztp1 + in.zqsmix + in.zfokoop + in.zli;
    write_level(o_lev, o_half, k, nlev, n, j, v);
  }
  o_prainfrac[j] = v;
}

// fused_kernel may take more than the default 48 KB of dynamic shared
// memory. The attribute belongs to the function on each device: it is set
// once a device, precision and addressing policy, and later calls return
// that first call's result. The flags have internal linkage: a template's
// static locals would be one object across every library of the process
// (GNU unique symbols), and each scheme version's library has a
// fused_kernel of its own to set.
constexpr int MAX_DEVICES = 64;

namespace {
std::once_flag configured[2][2][MAX_DEVICES];
cudaError_t configure_result[2][2][MAX_DEVICES];
}  // namespace

template <typename T, typename Src> cudaError_t configure_fused() {
  constexpr int a = Src::KIND, t = sizeof(T) == sizeof(double);
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(configured[a][t][dev], [dev] {
    configure_result[a][t][dev] = cudaFuncSetAttribute(
        fused_kernel<T, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ring_bytes<T>());
  });
  return configure_result[a][t][dev];
}

template <typename T, typename Src>
int launch_fused(const T* pack, const T* col, const Src& rows,
                 const double* consts, T* o_lev, T* o_half, T* o_prainfrac,
                 int nlev, int ncol, int nrows, cudaStream_t s) {
  const cudaError_t e = configure_fused<T, Src>();
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_kernel<T, Src><<<(ncol + RING_BLOCK - 1) / RING_BLOCK, RING_BLOCK,
                         ring_bytes<T>(), s>>>(pack, col, consts, o_lev,
                                               o_half, o_prainfrac, nlev,
                                               ncol, nrows, rows);
  return static_cast<int>(cudaGetLastError());
}

enum Body { FULL, FLOOR, INIT };

template <typename T, Body B>
int launch(const T* pack, const T* col, const double* consts, T* o_lev,
           T* o_half, T* o_prainfrac, int nlev, int ncol, int nrows,
           void* stream) {
  // a pack with another row set belongs to another scheme version's build
  if (nrows != R_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  if (ncol <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (B == FULL) {
    return launch_fused<T>(pack, col, Pack{}, consts, o_lev, o_half,
                           o_prainfrac, nlev, ncol, nrows, s);
  } else {
    const int grid = (ncol + DIAG_BLOCK - 1) / DIAG_BLOCK;
    if constexpr (B == FLOOR)
      floor_kernel<T><<<grid, DIAG_BLOCK, 0, s>>>(
          pack, col, consts, o_lev, o_half, o_prainfrac, nlev, ncol, nrows);
    else
      init_kernel<T><<<grid, DIAG_BLOCK, 0, s>>>(
          pack, col, consts, o_lev, o_half, o_prainfrac, nlev, ncol, nrows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Rows policy's table from host arrays of nrows row pointers and
// heights, copied into a kernel's parameters; false for another row set, a
// height other than nlev or nlev+1, a PAPH without its surface level nlev,
// or a null row.
template <typename T>
bool make_rows(const void* const* rows, const int* heights, int nlev,
               int nrows, Rows<T>& table) {
  if (nrows != R_COUNT || heights[R_PAPH] != nlev + 1) return false;
  for (int r = 0; r < R_COUNT; ++r) {
    if (!rows[r] || heights[r] < nlev || heights[r] > nlev + 1) return false;
    table.p[r] = static_cast<const T*>(rows[r]);
    table.h[r] = heights[r];
  }
  table.plsm = nullptr;
  table.ldcum = nullptr;
  table.ktype = nullptr;
  return true;
}

// The Rows policy's launch: `rows` and `heights` as make_rows takes them.
// Refuses what make_rows refuses and a null per-column row.
template <typename T>
int launch_rows(const void* const* rows, const int* heights, const T* plsm,
                const unsigned char* ldcum, const int* ktype,
                const double* consts, T* o_lev, T* o_half, T* o_prainfrac,
                int nlev, int ncol, int nrows, void* stream) {
  Rows<T> table;
  if (!make_rows(rows, heights, nlev, nrows, table) || !plsm || !ldcum ||
      !ktype)
    return static_cast<int>(cudaErrorInvalidValue);
  table.plsm = plsm;
  table.ldcum = ldcum;
  table.ktype = ktype;
  if (ncol <= 0) return 0;
  return launch_fused<T>(nullptr, nullptr, table, consts, o_lev, o_half,
                         o_prainfrac, nlev, ncol, nrows,
                         static_cast<cudaStream_t>(stream));
}

// -- the ZDQS row of a field dict (no TPU kernel: the TPU kernel reads the
// row folded on the host in fp64, or runs the in-line CUADJTQ in its
// sweep). zdqs_kernel hoists K1's section 3.4b forcing chain and in-line
// CUADJTQ out of the column sweep, where one thread a column runs it as a
// long dependent chain at 8 (fp64) or 12 (fp32) warps an SM: it reads only
// level k's inputs (level_zdqs), so here one thread takes one (level,
// column), columns innermost, at full occupancy, and writes the (nlev,
// ncol) row that K1's unfolded build with CLOUDSC_FN streams in its ring.
// The same device functions, operation order and -fmad=false as the
// in-line chain: the row is the in-line chain's value bit for bit on every
// level K1 reads (k >= NCLDTOP - 1), and 0 above, where its blocks compute
// nothing. It reads the dict in place through the Rows table and clamp of
// K1 (the table's ZDQS entry, its own output, is not read). The constants
// are a parameter in the working type (ZdqsConsts), read from the
// parameter bank: no per-block copy to shared memory and no barrier.
// Bound, at 163,840 columns and NCLDTOP 15: 9 rows read on the 123 levels
// it computes (PT, TENDENCY_TMP_T, PAP, PAPH, PMFU, PMFD, PVERVEL, PHRSW,
// PHRLW) and ZDQS written on all 137, 1.63 GB fp64 / 0.82 GB fp32, 0.487 /
// 0.244 ms at 3.35 TB/s.
constexpr int ZDQS_BLOCK = 256;

template <typename T> struct ZdqsConsts {
  T v[C_COUNT];  // the constants vector, rounded to T on the host
};

template <typename T>
__global__ void __launch_bounds__(ZDQS_BLOCK)
zdqs_kernel(const __grid_constant__ ZdqsConsts<T> K, T* __restrict__ o_zdqs,
            int nlev, int ncol, const __grid_constant__ Rows<T> rows) {
  const int j = blockIdx.x * ZDQS_BLOCK + threadIdx.x, k = blockIdx.y;
  if (j >= ncol) return;
  const size_t n = size_t(ncol);
  auto P = [&](int lev, int r) -> T {
    return __ldg(rows.p[r] + size_t(min(lev, rows.h[r] - 1)) * n + j);
  };
  o_zdqs[size_t(k) * n + j] = level_zdqs<T>(P, k, nlev, K.v);
}

// zdqs_kernel's launch: `rows` and `heights` as make_rows takes them (the
// ZDQS entry may be o_zdqs itself), `consts` the constants vector in host
// memory; refuses what make_rows refuses.
template <typename T>
int launch_zdqs(const void* const* rows, const int* heights,
                const double* consts, T* o_zdqs, int nlev, int ncol,
                int nrows, void* stream) {
  Rows<T> table;
  if (!make_rows(rows, heights, nlev, nrows, table) || !o_zdqs || !consts)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncol <= 0 || nlev <= 0) return 0;
  ZdqsConsts<T> K;
  for (int i = 0; i < C_COUNT; ++i) K.v[i] = T(consts[i]);
  const dim3 grid((ncol + ZDQS_BLOCK - 1) / ZDQS_BLOCK, nlev);
  zdqs_kernel<T><<<grid, ZDQS_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      K, o_zdqs, nlev, ncol, table);
  return static_cast<int>(cudaGetLastError());
}

// What fused_kernel<T, Src> runs with on the current device: out[0] blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] dynamic
// shared memory bytes a block, out[2..4] S, BLOCK and MIN_BLOCKS, out[5]
// registers a thread, out[6] local memory bytes a thread (stack and
// spills), the last two from cudaFuncGetAttributes.
template <typename T, typename Src> int occupancy(int* out) {
  cudaError_t e = configure_fused<T, Src>();
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_kernel<T, Src>, RING_BLOCK, ring_bytes<T>());
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fused_kernel<T, Src>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = blocks;
  out[1] = ring_bytes<T>();
  out[2] = RING_S;
  out[3] = RING_BLOCK;
  out[4] = RING_MIN_BLOCKS;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace cloudsc

// The C entry points, one per body and precision: cloudsc_{fused,floor,
// init}_{f32,f64}(pack, col, consts, o_lev, o_half, o_prainfrac, nlev, ncol,
// nrows, stream) -> cudaError_t of the launch.
#define CLOUDSC_ENTRY(NAME, T, B)                                          \
  extern "C" int NAME(const T* pack, const T* col, const double* consts,  \
                      T* o_lev, T* o_half, T* o_prainfrac, int nlev,       \
                      int ncol, int nrows, void* stream) {                 \
    return cloudsc::launch<T, cloudsc::B>(pack, col, consts, o_lev,        \
                                          o_half, o_prainfrac, nlev, ncol, \
                                          nrows, stream);                  \
  }

CLOUDSC_ENTRY(cloudsc_fused_f32, float, FULL)
CLOUDSC_ENTRY(cloudsc_fused_f64, double, FULL)
CLOUDSC_ENTRY(cloudsc_floor_f32, float, FLOOR)
CLOUDSC_ENTRY(cloudsc_floor_f64, double, FLOOR)
CLOUDSC_ENTRY(cloudsc_init_f32, float, INIT)
CLOUDSC_ENTRY(cloudsc_init_f64, double, INIT)

// cloudsc_fused_occupancy_{f32,f64}(int out[7]) -> cudaError_t; see
// cloudsc::occupancy
extern "C" int cloudsc_fused_occupancy_f32(int* out) {
  return cloudsc::occupancy<float, cloudsc::Pack>(out);
}
extern "C" int cloudsc_fused_occupancy_f64(int* out) {
  return cloudsc::occupancy<double, cloudsc::Pack>(out);
}

#if !CLOUDSC_FOLD_INPUTS
// The full body reading a field dict in place (the Rows policy), in the
// unfolded builds only (with CLOUDSC_FN the table holds the ZDQS row that
// cloudsc_zdqs_rows_* wrote): cloudsc_fused_rows_{f32,f64}(rows, heights,
// plsm, ldcum, ktype, consts, o_lev, o_half, o_prainfrac, nlev, ncol,
// nrows, stream) -> cudaError_t of the launch, `rows` (void*[nrows]) and
// `heights` (int[nrows]) host arrays in the pack's row order; and
// cloudsc_fused_rows_occupancy_{f32,f64}(int out[7]).
extern "C" int cloudsc_fused_rows_f32(const void* const* rows,
                                      const int* heights, const float* plsm,
                                      const unsigned char* ldcum,
                                      const int* ktype, const double* consts,
                                      float* o_lev, float* o_half,
                                      float* o_prainfrac, int nlev, int ncol,
                                      int nrows, void* stream) {
  return cloudsc::launch_rows<float>(rows, heights, plsm, ldcum, ktype,
                                     consts, o_lev, o_half, o_prainfrac, nlev,
                                     ncol, nrows, stream);
}
extern "C" int cloudsc_fused_rows_f64(const void* const* rows,
                                      const int* heights, const double* plsm,
                                      const unsigned char* ldcum,
                                      const int* ktype, const double* consts,
                                      double* o_lev, double* o_half,
                                      double* o_prainfrac, int nlev, int ncol,
                                      int nrows, void* stream) {
  return cloudsc::launch_rows<double>(rows, heights, plsm, ldcum, ktype,
                                      consts, o_lev, o_half, o_prainfrac,
                                      nlev, ncol, nrows, stream);
}

// zdqs_kernel: cloudsc_zdqs_rows_{f32,f64}(rows, heights, consts, o_zdqs,
// nlev, ncol, nrows, stream) -> cudaError_t of the launch, `rows` and
// `heights` as for cloudsc_fused_rows_*, `consts` (double[C_COUNT]) in host
// memory.
extern "C" int cloudsc_zdqs_rows_f32(const void* const* rows,
                                     const int* heights, const double* consts,
                                     float* o_zdqs, int nlev, int ncol,
                                     int nrows, void* stream) {
  return cloudsc::launch_zdqs<float>(rows, heights, consts, o_zdqs, nlev,
                                     ncol, nrows, stream);
}
extern "C" int cloudsc_zdqs_rows_f64(const void* const* rows,
                                     const int* heights, const double* consts,
                                     double* o_zdqs, int nlev, int ncol,
                                     int nrows, void* stream) {
  return cloudsc::launch_zdqs<double>(rows, heights, consts, o_zdqs, nlev,
                                      ncol, nrows, stream);
}

extern "C" int cloudsc_fused_rows_occupancy_f32(int* out) {
  return cloudsc::occupancy<float, cloudsc::Rows<float>>(out);
}
extern "C" int cloudsc_fused_rows_occupancy_f64(int* out) {
  return cloudsc::occupancy<double, cloudsc::Rows<double>>(out);
}
#endif
