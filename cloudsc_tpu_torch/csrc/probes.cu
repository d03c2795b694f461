// The measurement lab's two synthetic probes as CUDA kernels for Hopper
// (sm_90a), fp32. Wrappers and plain versions: kernels/cuda_probes.py.
//
// K2, overlap_kernel. Replaces bench/overlap_probe.py::make_fn ->
// pl.pallas_call: a stream of (nk2, rr) rows a column with a chain of w
// dependent multiply-adds on every value, in five variants (plain, alias,
// scratch, prod, branchy) and two modes (full: streaming; resident: level 0
// reread at every step, the cache-resident compute time). It runs K1's
// schedule, not the TPU's: one thread owns one column and runs the level
// loop itself, row by row (load, w steps of fmaf, store), so the probe sees
// the stream K1 sees. Beyond the head rows the rows go in batches of
// BATCH, loaded together: the same loads in flight for every w, where the
// compiler would otherwise issue load-store pairs at w=0 and hoist loads at
// w>0, and the stream time S would not be the stream of T. Layout (nk2, rr, ncol), columns contiguous, every warp
// access one coalesced run; JAX element [k, i, r, s, l] of the
// (nk2, ni, rr, sb, 128) probe array is element [k, r, (i*sb + s)*128 + l].
// A thread block spans one JAX block of sb*128 columns, so the branchy
// predicate (the block's row-0 max at level k > 0.5) is one
// __syncthreads_or. The scratch variant's 33 carried rows are registers; its
// rows < 33 are an unrolled loop so they index them statically. Every
// multiply-add is an explicit fmaf, which is what XLA's contraction of the
// JAX body computes, whatever -fmad says. w is a template parameter over
// OVERLAP_WS (fully unrolled chain; no loop counter between the FMAs).
// Blocks are of up to 256 threads (sb <= 2): no cap on registers below 255,
// so the scratch rows stay in registers.
// Bound: memory at small w (one load and one store of 4 B per w FMAs), the
// dependent FMA latency at large w with ~10 warps an SM at the lab's size.
//
// K3, copy_kernel. Replaces bench/dma_probe.py::make_copy -> pl.pallas_call:
// out = in * 1.0000001f. One thread block does the work of one TPU grid
// step and states its access shape explicitly: nruns runs of run_len floats,
// run q at base + q*run_stride, base = i*base_i + k*base_k for block
// (i, k) = (blockIdx.x % ni, blockIdx.x / ni). contig<N>: one run of N*128;
// strided: lps*R runs of SB*128 at the offsets of block (k, 0, i, 0) of
// (nk2*lps, R, nblk, 128); tilemajor: one run of lps*R*SB*128. Bound: HBM
// bandwidth; 16-byte loads and stores, consecutive threads on consecutive
// addresses within a run.
#include <cuda_runtime.h>

namespace probes {

constexpr float MUL = 1.0000001f;  // the chain's factor and K3's multiplier
constexpr float ADD = 1e-7f;       // the chain's addend
constexpr int SCR_ROWS = 33;       // rows carried across levels (scratch)
constexpr int LOOK_ROWS = 3;       // k+1 lookahead rows (alias)
constexpr int COL_N = 8 * 128;     // the (8, 128) dependency operand
constexpr int BATCH = 4;           // rows loaded together, every w

enum Variant { PLAIN, ALIAS, SCRATCH, PROD, BRANCHY };

// the w values overlap_kernel is instantiated for (cuda_probes.OVERLAP_W)
#define OVERLAP_WS 0, 1, 2, 3, 4, 8, 16, 32

template <int W>
__device__ __forceinline__ float chain(float v) {
#pragma unroll
  for (int s = 0; s < W; ++s) v = fmaf(v, MUL, ADD);
  return v;
}

__device__ __forceinline__ void thread_col(const float* __restrict__ col_in,
                                           float* __restrict__ col_out) {
  if (blockIdx.x != 0) return;
  for (int t = threadIdx.x; t < COL_N; t += blockDim.x)
    col_out[t] = col_in[t] * MUL;
}

constexpr int OVERLAP_MAX_THREADS = 256;  // sb <= cuda_probes.SB_MAX = 2

template <int V, int W>
__global__ void __launch_bounds__(OVERLAP_MAX_THREADS)
overlap_kernel(const float* __restrict__ in, float* __restrict__ out,
               float* __restrict__ colo, const float* __restrict__ col_in,
               float* __restrict__ col_out, int nk2, int rr, int ncol,
               int resident) {
  constexpr bool kAlias = V == ALIAS || V == PROD;
  constexpr bool kScratch = V == SCRATCH || V == PROD;
  constexpr int kHead = kScratch ? SCR_ROWS : (kAlias ? LOOK_ROWS : 0);
  thread_col(col_in, col_out);
  // the grid covers ncol exactly (ncol is a multiple of the block), so every
  // thread reaches the branchy barrier
  const size_t n = size_t(ncol);
  const size_t j = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t plane = size_t(rr) * n;
  float acc[kScratch ? SCR_ROWS : 1];
#pragma unroll
  for (int r = 0; r < (kScratch ? SCR_ROWS : 1); ++r) acc[r] = 0.f;
  float row0 = 0.f;
  for (int k = 0; k < nk2; ++k) {
    const float* src = in + (resident ? 0 : k) * plane + j;
    const float* look = in + (resident ? 0 : min(k + 1, nk2 - 1)) * plane + j;
    float* dst = out + (resident ? 0 : k) * plane + j;
    bool pred = true;
    if constexpr (V == BRANCHY) pred = __syncthreads_or(src[0] > 0.5f);
#pragma unroll
    for (int r = 0; r < kHead; ++r) {
      float v = chain<W>(src[r * n]);
      if constexpr (kScratch) {
        acc[r] = fmaf(v, 1e-8f, acc[r]);
        v = fmaf(acc[r], 1e-9f, v);
      }
      if (kAlias && r < LOOK_ROWS) v = fmaf(look[r * n], 1e-9f, v);
      dst[r * n] = v;
      if (r == 0) row0 = v;
    }
    int r = kHead;
#pragma unroll 1
    for (; r + BATCH <= rr; r += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int g = 0; g < BATCH; ++g) v[g] = src[(r + g) * n];
#pragma unroll
      for (int g = 0; g < BATCH; ++g) {
        if (pred) v[g] = chain<W>(v[g]);
        dst[(r + g) * n] = v[g];
      }
    }
#pragma unroll 1
    for (; r < rr; ++r) {
      float v = src[r * n];
      if (pred) v = chain<W>(v);
      dst[r * n] = v;
    }
  }
  if constexpr (V == PROD) colo[j] = row0 * MUL;
}

struct OverlapArgs {
  const float* in;
  float* out;
  float* colo;
  const float* col_in;
  float* col_out;
  int nk2, rr, ncol, sb, resident;
  cudaStream_t stream;
};

template <int V, int W>
int overlap_launch(const OverlapArgs& a) {
  const int threads = a.sb * 128;
  if (threads > OVERLAP_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  overlap_kernel<V, W><<<a.ncol / threads, threads, 0, a.stream>>>(
      a.in, a.out, a.colo, a.col_in, a.col_out, a.nk2, a.rr, a.ncol,
      a.resident);
  return static_cast<int>(cudaGetLastError());
}

// w -> overlap_launch<V, w> over the instantiated set
template <int V, int... Ws>
struct WDispatch {
  static int run(int, const OverlapArgs&) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
};
template <int V, int W0, int... Ws>
struct WDispatch<V, W0, Ws...> {
  static int run(int w, const OverlapArgs& a) {
    return w == W0 ? overlap_launch<V, W0>(a) : WDispatch<V, Ws...>::run(w, a);
  }
};

constexpr int COPY_THREADS = 256;

__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const float* __restrict__ in, float* __restrict__ out,
            const float* __restrict__ col_in, float* __restrict__ col_out,
            int run_len, int nruns, long long run_stride, int ni,
            long long base_i, long long base_k) {
  thread_col(col_in, col_out);
  const long long i = blockIdx.x % ni, k = blockIdx.x / ni;
  const size_t base = size_t(i * base_i + k * base_k);
  // float4 units; the position (run q, offset o) advances by the block size
  // without a division in the loop
  const int r4 = run_len / 4, n4 = nruns * r4;
  const int dq = blockDim.x / r4, dor = blockDim.x % r4;
  int q = threadIdx.x / r4, o = threadIdx.x % r4;
#pragma unroll 4
  for (int e = threadIdx.x; e < n4; e += blockDim.x) {
    const size_t off = base + size_t(q) * size_t(run_stride) + size_t(o) * 4;
    float4 v = *reinterpret_cast<const float4*>(in + off);
    v.x *= MUL;
    v.y *= MUL;
    v.z *= MUL;
    v.w *= MUL;
    *reinterpret_cast<float4*>(out + off) = v;
    o += dor;
    q += dq;
    if (o >= r4) {
      o -= r4;
      ++q;
    }
  }
}

}  // namespace probes

// overlap_probe(in, col_in, out, colo, col_out, variant, w, resident, nk2,
// rr, ncol, sb, stream) -> cudaError_t of the launch (cudaErrorInvalidValue
// for a variant or w that is not instantiated). colo is written for the prod
// variant only.
extern "C" int overlap_probe(const float* in, const float* col_in, float* out,
                             float* colo, float* col_out, int variant, int w,
                             int resident, int nk2, int rr, int ncol, int sb,
                             void* stream) {
  using namespace probes;
  if (ncol <= 0) return 0;
  const OverlapArgs a{in, out, colo, col_in, col_out, nk2, rr, ncol, sb,
                      resident, static_cast<cudaStream_t>(stream)};
  switch (variant) {
    case PLAIN: return WDispatch<PLAIN, OVERLAP_WS>::run(w, a);
    case ALIAS: return WDispatch<ALIAS, OVERLAP_WS>::run(w, a);
    case SCRATCH: return WDispatch<SCRATCH, OVERLAP_WS>::run(w, a);
    case PROD: return WDispatch<PROD, OVERLAP_WS>::run(w, a);
    case BRANCHY: return WDispatch<BRANCHY, OVERLAP_WS>::run(w, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// copy_probe(in, col_in, out, col_out, run_len, nruns, run_stride, ni,
// base_i, base_k, nblocks, stream) -> cudaError_t of the launch.
extern "C" int copy_probe(const float* in, const float* col_in, float* out,
                          float* col_out, int run_len, int nruns,
                          long long run_stride, int ni, long long base_i,
                          long long base_k, int nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  probes::copy_kernel<<<nblocks, probes::COPY_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, out, col_in, col_out, run_len, nruns, run_stride, ni, base_i,
      base_k);
  return static_cast<int>(cudaGetLastError());
}
