// The four derivable flux rows of section 8 in one launch: PFHPSL/N =
// -RLVTT/RLSTT x PFPLSL/N (ref: cloudsc.F90: 2864-2865) and PFSQLTUR/ITUR,
// the running sums of PVFL/PVFI*PTSPHY*ZGDPH_R over the levels (ref:
// 2812-2857), from the step's input rows and K1's PFPLSL/N.
//
// Replaces no TPU kernel. The JAX package rebuilds these rows outside any
// pl.pallas_call, in cloudsc_tpu/kernels/pallas_cloudsc.py::
// _foldo_synthesize (l.1525): a lax.scan over the levels that XLA compiles
// into one loop. The port's plain version (kernels/cuda_cloudsc.py::
// foldo_synthesize_plain) adds and copies one row a level for each sum,
// 559 operations a step at 137 levels, each a launch on the card; this
// kernel does all of it in one.
//
// What bounds it on this card: bytes. A column reads PAPH (nlev+1 rows),
// PVFL and PVFI (nlev), PFPLSL and PFPLSN (nlev+1) and writes the four rows
// (nlev+1 each): 688 rows read and 552 written at 137 levels, against ~8
// flops a level. At 163,840 columns that is 1.625 GB in fp64 / 0.81 GB in
// fp32, 0.485 / 0.243 ms at 3.35 TB/s.
//
// Design. One thread a column, consecutive threads on consecutive columns,
// so every load and store of a warp is one coalesced run; the ragged last
// block masks its column. The thread walks the levels in order and keeps
// the two running sums and PAPH of the level above in registers, so PAPH is
// read once. The sums are a recurrence along the levels, so a thread's
// adds are one dependent chain; the loads do not depend on it, and the
// whole grid (640 blocks of 256 at 163,840 columns, 44 registers a thread:
// every block resident at once) keeps enough of them in flight to stream
// at 82 % (fp32) / 85 % (fp64) of the memory's rate (PERF.md §6). Issuing
// 2, 4 or 8 levels' loads before their arithmetic, or a level's five loads
// before its stores, measured no faster.
//
// Bit for bit with the plain version in both precisions: the same
// operations in the same order, each rounded once (the _rn intrinsics are
// never contracted into a multiply-add, whatever the build's -fmad), with
// the constants rounded to the working type on the host, as PyTorch rounds
// a Python scalar:
//   zgdph_r = ((-zrg_r) * (paph[k+1] - paph[k])) * zqtmst
//   acc     = acc + (pvfl[k] * ptsphy) * zgdph_r,  acc(0) = 0
// No scan: a parallel prefix sum would reorder the additions.
//
// Each input row comes as a pointer and a level stride in elements (the
// pack's rows, a field dict's fields and the strided views of K1's output
// buffer); columns are contiguous. Offsets are 64-bit: a pack at 409,600
// columns nears 2**31 elements. The four outputs are the planes of one
// (4, nlev+1, ncol) buffer in the order PFHPSL, PFHPSN, PFSQLTUR, PFSQITUR.
#include <cuda_runtime.h>

namespace foldo {

// a block's threads: 256 streams fp32 at 82 % of the bound, 128 at 72-77 %
// (fp64 85 % with either)
constexpr int BLOCK = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T> struct Consts {
  T neg_zrg_r, zqtmst, ptsphy, neg_rlvtt, neg_rlstt;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
foldo_kernel(const T* __restrict__ paph, const T* __restrict__ pvfl,
             const T* __restrict__ pvfi, const T* __restrict__ pfplsl,
             const T* __restrict__ pfplsn, long long s_paph, long long s_pvfl,
             long long s_pvfi, long long s_pfplsl, long long s_pfplsn,
             T* __restrict__ out, int nlev, int ncol, Consts<T> c) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= ncol) return;
  const long long n = ncol, plane = static_cast<long long>(nlev + 1) * n;
  paph += j;
  pvfl += j;
  pvfi += j;
  pfplsl += j;
  pfplsn += j;
  T* hpsl = out + j;
  T* hpsn = hpsl + plane;
  T* ltur = hpsn + plane;
  T* itur = ltur + plane;

  T paph_k = paph[0];
  T acc_l = T(0), acc_i = T(0);
  ltur[0] = acc_l;
  itur[0] = acc_i;
  for (long long k = 0; k < nlev; ++k) {
    const T paph_k1 = paph[(k + 1) * s_paph];
    const T zgdph_r = mul(mul(c.neg_zrg_r, sub(paph_k1, paph_k)), c.zqtmst);
    acc_l = add(acc_l, mul(mul(pvfl[k * s_pvfl], c.ptsphy), zgdph_r));
    acc_i = add(acc_i, mul(mul(pvfi[k * s_pvfi], c.ptsphy), zgdph_r));
    ltur[(k + 1) * n] = acc_l;
    itur[(k + 1) * n] = acc_i;
    hpsl[k * n] = mul(c.neg_rlvtt, pfplsl[k * s_pfplsl]);
    hpsn[k * n] = mul(c.neg_rlstt, pfplsn[k * s_pfplsn]);
    paph_k = paph_k1;
  }
  const long long last = nlev;
  hpsl[last * n] = mul(c.neg_rlvtt, pfplsl[last * s_pfplsl]);
  hpsn[last * n] = mul(c.neg_rlstt, pfplsn[last * s_pfplsn]);
}

template <typename T>
int launch(const T* paph, const T* pvfl, const T* pvfi, const T* pfplsl,
           const T* pfplsn, long long s_paph, long long s_pvfl,
           long long s_pvfi, long long s_pfplsl, long long s_pfplsn, T* out,
           int nlev, int ncol, double neg_zrg_r, double zqtmst, double ptsphy,
           double neg_rlvtt, double neg_rlstt, void* stream) {
  if (nlev < 1 || ncol < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ncol == 0) return 0;
  // rounded to T here, on the host, as PyTorch rounds a Python scalar
  const Consts<T> c{static_cast<T>(neg_zrg_r), static_cast<T>(zqtmst),
                    static_cast<T>(ptsphy), static_cast<T>(neg_rlvtt),
                    static_cast<T>(neg_rlstt)};
  foldo_kernel<T><<<(ncol + BLOCK - 1) / BLOCK, BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      paph, pvfl, pvfi, pfplsl, pfplsn, s_paph, s_pvfl, s_pvfi, s_pfplsl,
      s_pfplsn, out, nlev, ncol, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace foldo

// cloudsc_foldo_{f32,f64}(paph, pvfl, pvfi, pfplsl, pfplsn, and their level
// strides in elements, out, nlev, ncol, -zrg_r, zqtmst, ptsphy, -RLVTT,
// -RLSTT, stream) -> cudaError_t of the launch
extern "C" int cloudsc_foldo_f32(const float* paph, const float* pvfl,
                                 const float* pvfi, const float* pfplsl,
                                 const float* pfplsn, long long s_paph,
                                 long long s_pvfl, long long s_pvfi,
                                 long long s_pfplsl, long long s_pfplsn,
                                 float* out, int nlev, int ncol,
                                 double neg_zrg_r, double zqtmst,
                                 double ptsphy, double neg_rlvtt,
                                 double neg_rlstt, void* stream) {
  return foldo::launch<float>(paph, pvfl, pvfi, pfplsl, pfplsn, s_paph,
                              s_pvfl, s_pvfi, s_pfplsl, s_pfplsn, out, nlev,
                              ncol, neg_zrg_r, zqtmst, ptsphy, neg_rlvtt,
                              neg_rlstt, stream);
}

extern "C" int cloudsc_foldo_f64(const double* paph, const double* pvfl,
                                 const double* pvfi, const double* pfplsl,
                                 const double* pfplsn, long long s_paph,
                                 long long s_pvfl, long long s_pvfi,
                                 long long s_pfplsl, long long s_pfplsn,
                                 double* out, int nlev, int ncol,
                                 double neg_zrg_r, double zqtmst,
                                 double ptsphy, double neg_rlvtt,
                                 double neg_rlstt, void* stream) {
  return foldo::launch<double>(paph, pvfl, pvfi, pfplsl, pfplsn, s_paph,
                               s_pvfl, s_pvfi, s_pfplsl, s_pfplsn, out, nlev,
                               ncol, neg_zrg_r, zqtmst, ptsphy, neg_rlvtt,
                               neg_rlstt, stream);
}
