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
// out = in * 1.0000001f over a probe array, in the access shape of one TPU
// grid step: step (i, k) = (b % ni, b / ni) copies nruns runs of run_len
// floats, run q at i*base_i + k*base_k + q*run_stride. contig<N>: one run of
// N*128; strided: lps*R runs of SB*128 at the offsets of block (k, 0, i, 0)
// of (nk2*lps, R, nblk, 128); tilemajor: one run of lps*R*SB*128.
// Bound: HBM bytes, the array read once and written once (3.256 GB at the
// lab's default size, 0.972 ms at 3.35 TB/s); one multiply a value.
//
// On the TPU the probe measures the DMA engine against the contiguity of a
// BlockSpec; here the counterpart is the Tensor Memory Accelerator's bulk
// copy. The first version carried the TPU grid over one thread block a
// step: 1.74 waves of 1,840 blocks on strided and tilemajor (the last wave
// on 74 % of the card), 0.73 of a wave on contig4096, 16 kB blocks on
// contig32, and one 16-byte load a thread in flight. This one is a
// persistent grid of COPY_RING_CTAS CTAs an SM. The probe's runs are cut
// into stages of at most COPY_RING_CHUNK bytes that never cross a step: a
// longer run into equal 16-byte-aligned pieces, shorter runs gathered whole,
// as many consecutive runs of a step as fit, spread evenly over the step's
// stages (cuda_probes.CopyProbe.stage_copies is the same mapping). Stage t
// goes to CTA t % grid, so no CTA moves more than one stage more than
// another; a CTA walks its stages by adding the grid with carries: 64-bit
// divisions a stage on the elected thread's path slowed the small stages.
// Each CTA keeps a ring of COPY_RING_STAGES stages in dynamic
// shared memory, a full mbarrier a slot. One elected thread keeps S-1
// stages of bulk loads in flight (mbarrier.arrive.expect_tx with the
// stage's bytes, then one cp.async.bulk a run piece); when a stage's
// barrier completes, every warp multiplies it in place with float4 from
// shared memory, fences the generic-proxy writes against the async proxy
// (fence.proxy.async.shared::cta) and meets at a CTA barrier; the elected
// thread then issues the stage's bulk stores as one bulk group. A slot is
// refilled only after cp.async.bulk.wait_group.read shows its store has
// read it, and the CTA barrier of each stage keeps every warp off a slot
// before it is refilled: the two take the place of an empty barrier. No
// thread spends registers on the stream's addresses. Every ring swept
// (16-64 kB stages, 1-4 CTAs an SM) lands within a few percent of the same
// rate, a few percent under torch's x * 1.0000001 (PERF.md): with L2
// evict-first hints or with the stores from registers instead of bulk
// stores it was no faster, and a persistent register body over the same
// stages (no shared memory) was 2-3 % slower.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#if !defined(COPY_RING_STAGES) || !defined(COPY_RING_CHUNK) || \
    !defined(COPY_RING_CTAS)
#error "K3's ring geometry comes from kernels/build.py (cuda_probes.COPY_RING)"
#endif

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

// K3's ring: S stages of at most CHUNK bytes a CTA, CTAS CTAs an SM
constexpr int COPY_S = COPY_RING_STAGES;
constexpr int COPY_CHUNK = COPY_RING_CHUNK;
constexpr int COPY_CTAS = COPY_RING_CTAS;
constexpr int COPY_THREADS = 256;
constexpr int COPY_SMEM = COPY_S * COPY_CHUNK;
static_assert(COPY_S >= 2, "the ring needs a stage in flight");
// an mbarrier's transaction count holds less than 2^20 bytes
static_assert(COPY_CHUNK % 16 == 0 && COPY_CHUNK > 0 && COPY_CHUNK < (1 << 20),
              "a stage is a positive multiple of 16 bytes under 1 MB");
static_assert(COPY_CTAS >= 1, "at least one CTA an SM");

// The probe's runs and their cut into stages: sps stages a step; ppr > 1
// cuts every run into ppr pieces of piece_units 16-byte units (the first
// piece_rem pieces one unit more), ppr == 1 gathers whole runs, run_per a
// stage (the first run_rem stages of a step one run more).
struct CopyShape {
  long long run_stride, base_i, base_k;  // floats
  int ni, nk2, run_bytes, sps, ppr, piece_units, piece_rem, run_per, run_rem;
};

// One stage: nq bulk copies of `bytes` each, copy m at float offset
// g + m*run_stride, packed back to back in the slot.
struct Stage {
  long long g;
  int nq, bytes;
};

// A CTA's walk over its stages t = c, c + grid, ...: stage t is stage r of
// TPU step (i, k), b = t / sps = i + k*ni. Advancing by the grid adds
// (dr, di, dk) with carries, so no stage costs a division.
struct StageWalk {
  int r, i, k, dr, di, dk;

  __device__ StageWalk(const CopyShape& s, long long c, long long grid) {
    const long long b = c / s.sps, db = grid / s.sps;
    r = static_cast<int>(c % s.sps);
    i = static_cast<int>(b % s.ni);
    k = static_cast<int>(b / s.ni);
    dr = static_cast<int>(grid % s.sps);
    di = static_cast<int>(db % s.ni);
    dk = static_cast<int>(db / s.ni);
  }

  __device__ __forceinline__ Stage stage(const CopyShape& s) const {
    const long long base = i * s.base_i + k * s.base_k;
    Stage st;
    if (s.ppr > 1) {
      const int q = r / s.ppr, p = r % s.ppr;
      const int u0 = p * s.piece_units + min(p, s.piece_rem);
      st.g = base + q * s.run_stride + 4LL * u0;
      st.nq = 1;
      st.bytes = 16 * (s.piece_units + (p < s.piece_rem));
    } else {
      const int q0 = r * s.run_per + min(r, s.run_rem);
      st.g = base + q0 * s.run_stride;
      st.nq = s.run_per + (r < s.run_rem);
      st.bytes = s.run_bytes;
    }
    return st;
  }

  __device__ __forceinline__ void next(const CopyShape& s) {
    r += dr;
    const int carry = r >= s.sps;
    r -= carry ? s.sps : 0;
    i += di + carry;
    k += dk;
    if (i >= s.ni) {
      i -= s.ni;
      ++k;
    }
  }
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const float* __restrict__ in, float* __restrict__ out,
            const float* __restrict__ col_in, float* __restrict__ col_out,
            const CopyShape s) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[COPY_S];
  __shared__ Stage slot_stage[COPY_S];  // the stage each slot holds
  thread_col(col_in, col_out);
  // this CTA's stages: c, c + grid, ... while the step is in the probe (the
  // count is the same for every thread of the CTA, so every thread meets
  // every barrier)
  const long long grid = gridDim.x, c = blockIdx.x;
  const long long nstages = static_cast<long long>(s.ni) * s.nk2 * s.sps;
  const long long n = c < nstages ? (nstages - c + grid - 1) / grid : 0;
  if (n == 0) return;
  const bool lead = threadIdx.x == 0;
  const uint32_t ring0 = smem(ring);
  StageWalk walk(s, c, grid);  // the lead thread's next stage to load
  if (lead) {
    for (int j = 0; j < COPY_S; ++j) mbar_init(smem(&full[j]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the lead thread: the walk's stage j into slot j % S; its copies land on
  // the slot's full barrier, which the thread arms with their byte sum
  auto load = [&](long long j) {
    const Stage st = walk.stage(s);
    walk.next(s);
    const int slot = static_cast<int>(j % COPY_S);
    slot_stage[slot] = st;
    const uint32_t bar = smem(&full[slot]);
    mbar_expect_tx(bar, static_cast<uint32_t>(st.nq * st.bytes));
    uint32_t dst = ring0 + slot * COPY_CHUNK;
    const float* src = in + st.g;
    for (int m = 0; m < st.nq; ++m) {
      bulk_load(dst, src, st.bytes, bar);
      dst += st.bytes;
      src += s.run_stride;
    }
  };
  if (lead)
    for (long long j = 0; j < COPY_S - 1 && j < n; ++j) load(j);
  for (long long j = 0; j < n; ++j) {
    const int slot = static_cast<int>(j % COPY_S);
    // the slot's (j / S)-th phase completes when stage j has landed; the
    // lead's write of slot_stage comes before its arrive, so it is seen
    mbar_wait(smem(&full[slot]), static_cast<uint32_t>((j / COPY_S) & 1));
    const Stage st = slot_stage[slot];
    float4* v = reinterpret_cast<float4*>(ring + slot * COPY_CHUNK);
    const int n4 = st.nq * st.bytes / 16;
    for (int e = threadIdx.x; e < n4; e += COPY_THREADS) {
      float4 a = v[e];
      a.x *= MUL;
      a.y *= MUL;
      a.z *= MUL;
      a.w *= MUL;
      v[e] = a;
    }
    // the multiply's writes before the bulk stores read the slot
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (lead) {
      uint32_t src = ring0 + slot * COPY_CHUNK;
      float* dst = out + st.g;
      for (int m = 0; m < st.nq; ++m) {
        bulk_store(dst, src, st.bytes);
        src += st.bytes;
        dst += s.run_stride;
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (j + COPY_S - 1 < n) {
        // stage j+S-1 refills stage j-1's slot once its store has read it
        // (every group but stage j's)
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(j + COPY_S - 1);
      }
    }
  }
  if (lead) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// copy_kernel takes COPY_SMEM bytes of dynamic shared memory, more than the
// default 48 KB for most geometries: the attribute is set once a device,
// and the blocks an SM read then. The flags have internal linkage (a
// template's static locals would be one object across every library of the
// process; see cloudsc_fused.cu::configure_fused).
constexpr int MAX_DEVICES = 64;

struct CopyConfig {
  cudaError_t err;
  int sms, blocks_per_sm;
};

namespace {
std::once_flag copy_configured[MAX_DEVICES];
CopyConfig copy_config[MAX_DEVICES];

CopyConfig configure_copy() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return {e, 0, 0};
  if (dev < 0 || dev >= MAX_DEVICES) return {cudaErrorInvalidDevice, 0, 0};
  std::call_once(copy_configured[dev], [dev] {
    CopyConfig& c = copy_config[dev];
    c = {cudaSuccess, 0, 0};
    c.err = cudaFuncSetAttribute(
        copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, COPY_SMEM);
    if (c.err == cudaSuccess)
      c.err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (c.err == cudaSuccess)
      c.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.blocks_per_sm, copy_kernel, COPY_THREADS, COPY_SMEM);
  });
  return copy_config[dev];
}
}  // namespace

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
// base_i, base_k, nsteps, stream) -> cudaError_t of the launch
// (cudaErrorInvalidValue for runs or offsets that are not whole 16-byte
// units, cudaErrorInvalidConfiguration where COPY_RING_CTAS CTAs do not fit
// on an SM). Pointers must be 16-byte aligned (cuda_probes.dma_copy checks).
extern "C" int copy_probe(const float* in, const float* col_in, float* out,
                          float* col_out, int run_len, int nruns,
                          long long run_stride, int ni, long long base_i,
                          long long base_k, int nsteps, void* stream) {
  using namespace probes;
  if (nsteps <= 0) return 0;
  if (run_len <= 0 || run_len % 4 || nruns <= 0 || ni <= 0 || nsteps % ni ||
      run_len > (1 << 28) || run_stride % 4 || base_i % 4 || base_k % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const CopyConfig cfg = configure_copy();
  if (cfg.err != cudaSuccess) return static_cast<int>(cfg.err);
  if (cfg.blocks_per_sm < COPY_CTAS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CopyShape s;
  s.run_stride = run_stride;
  s.base_i = base_i;
  s.base_k = base_k;
  s.ni = ni;
  s.nk2 = (nsteps + ni - 1) / ni;
  s.run_bytes = 4 * run_len;
  if (s.run_bytes > COPY_CHUNK) {
    const int units = s.run_bytes / 16;
    s.ppr = (s.run_bytes + COPY_CHUNK - 1) / COPY_CHUNK;
    s.sps = nruns * s.ppr;
    s.piece_units = units / s.ppr;
    s.piece_rem = units % s.ppr;
    s.run_per = 1;
    s.run_rem = 0;
  } else {
    const int per = COPY_CHUNK / s.run_bytes;
    s.ppr = 1;
    s.sps = (nruns + per - 1) / per;
    s.piece_units = s.run_bytes / 16;
    s.piece_rem = 0;
    s.run_per = nruns / s.sps;
    s.run_rem = nruns % s.sps;
  }
  copy_kernel<<<cfg.sms * COPY_CTAS, COPY_THREADS, COPY_SMEM,
                static_cast<cudaStream_t>(stream)>>>(in, out, col_in, col_out,
                                                     s);
  return static_cast<int>(cudaGetLastError());
}

// copy_probe_geometry(int out[9]) -> cudaError_t: what copy_kernel runs
// with on the current device: out[0] CTAs an SM that fit
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] dynamic shared
// memory bytes a CTA, out[2..4] S, CHUNK and CTAS, out[5] SMs, out[6]
// threads a CTA, out[7] registers a thread and out[8] local memory bytes a
// thread (cudaFuncGetAttributes).
extern "C" int copy_probe_geometry(int* out) {
  using namespace probes;
  const CopyConfig cfg = configure_copy();
  if (cfg.err != cudaSuccess) return static_cast<int>(cfg.err);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, copy_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[9] = {cfg.blocks_per_sm, COPY_SMEM, COPY_S, COPY_CHUNK,
                       COPY_CTAS, cfg.sms, COPY_THREADS, attr.numRegs,
                       static_cast<int>(attr.localSizeBytes)};
  for (int k = 0; k < 9; ++k) out[k] = vals[k];
  return 0;
}
