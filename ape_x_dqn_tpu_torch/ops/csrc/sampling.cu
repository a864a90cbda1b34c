// Stratified inverse-CDF sampling over replay priorities, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_sample` in
// ape_x_dqn_tpu/ops/pallas/sampling.py (pallas_call at :118) and its XLA
// spellings `_two_level_sample` / `_xla_sample` in the same file: for each
// target t_b, the first index i with  sum_{j<=i} p_j > t_b  (searchsorted
// side="right"), clamped to C-1.  A target at or past the total resolves to
// C-1, a negative one to 0.  Targets need not be sorted.
//
// Bound: bytes.  The function must read p once and the B targets, and write
// B indices: 4*C + 8*B bytes, against next to no arithmetic.  The TPU kernel
// streams p once through VMEM with the running mass carried in SMEM across a
// sequential grid.  Here that is one cooperative launch, every block
// resident (grid <= one block per SM):
//   1. stage:   block g owns the contiguous slice [g*slice, g*slice+len) and
//               copies it into dynamic shared memory with one-dimensional
//               bulk copies (cp.async.bulk, completion on an mbarrier); the
//               unaligned head and the ragged tail (< 16 bytes each) use
//               plain loads.  p is read from device memory once.
//   2. scan:    each thread sums an odd-length contiguous run (odd, so a
//               warp's 32 runs start in 32 banks) in one read, and a
//               warp-shuffle block scan over the run sums gives each run's
//               offset.  The local prefix of an element is its run's offset
//               plus the run's sequential sum up to it; the last element's
//               prefix is the block mass m_g, the same float everywhere.
//   3. barrier: m_g goes to global scratch; cooperative_groups grid sync.
//               Every block then computes the same offsets E[0..G-1] (one
//               warp: a sequential run per lane, a shuffle scan over the
//               runs, then an exact running max so that E ascends) in one
//               fixed order, so the kernel is deterministic run to run.
//   4. resolve: the block's threads stride over all B targets (the first
//               4 per thread are loaded before the barrier); block g owns
//               E[g] <= t < E[g+1], block 0 also t < 0, the last block also
//               t >= total, so each index is written by exactly one block
//               and a zero-mass block owns nothing (side="right").  The
//               owner counts the local prefixes <= t - E[g] (the TPU
//               kernel's rel / pos): a binary search over the run offsets,
//               then a walk along one run.  min(pos, len-1) plus the slice
//               base is the index.
// A slice larger than the tile (C above ~7 M floats on 132 SMs) is walked in
// tiles twice, once for the mass and once to resolve; per-target counts
// accumulate in `out`.  The main path's sizes never take that branch.
//
// Grid and slice come from the wrapper (ops/sampling.py `plan`): grid =
// min(SMs, ceil(C / 1024)), slice = ceil(C / grid) rounded up to 4 floats;
// C = 100 000 -> 98 blocks of 1 024; C = 2 000 000 -> 132 blocks of 15 152
// (60.6 KB of shared memory each) on an H100 SXM.
//
// nvcc 12.9 -O3 for sm_90a, ptxas -v: 56 registers, no spills, 5 376 bytes
// of static shared memory (run offsets, block offsets, mbarrier), and
// (tile + 4) floats dynamic: 60 624 bytes at C = 2 000 000, at most 213 008.
//
// Interface: plain C.  apex_sample_setup once per device (raises the kernel's
// dynamic shared memory limit, checks that one block fits on every SM);
// apex_sample_indices launches on the caller's stream, allocates nothing,
// does not synchronise, carries no state between calls (graph-capture safe),
// and returns the cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 256;         // blocks; Hopper parts have <= 144 SMs
constexpr int kMaxTile = 53248;       // floats of slice in shared memory (208 KiB)
constexpr int kPieceBytes = 32768;    // bytes per bulk copy
constexpr int kPrefetch = 4;          // targets a thread loads before the barrier
constexpr unsigned kFull = 0xffffffffu;

// Built with -DAPEX_SAMPLER_PHASES (bench_sampler --phases), every block's
// thread 0 stamps the global timer at the end of each phase; otherwise the
// stamps compile to nothing.
#ifdef APEX_SAMPLER_PHASES
constexpr int kPhases = 6;
__device__ unsigned long long phase_ns[kMaxGrid * kPhases];
__device__ __forceinline__ void stamp(int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    phase_ns[blockIdx.x * kPhases + k] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// A load the compiler may not sink past the barriers that follow it, so its
// latency overlaps the staging instead of the resolve.
__device__ __forceinline__ float load_early(const float* ptr) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(ptr));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the phase `parity` of the barrier to complete.  A copy that never
// lands traps (a launch error) after ~2^32 cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// Copies p[base, base+n) into s[shift + j] for j in [0, n), where shift is
// the 4-byte position of p within its 16 bytes: the 16-byte aligned body by
// bulk copy, the head and tail by plain loads.  Ends with every element in
// place and visible to the block.
__device__ void stage(const float* __restrict__ p, long long base, int n,
                      int shift, float* s, uint32_t bar, uint32_t& phase) {
  const int head = min((4 - shift) & 3, n);
  const int body = (n - head) & ~3;
  // Every thread is done with s, and its writes are ordered before the
  // copy's (generic proxy before async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (body > 0 && threadIdx.x == 0) {
    const uint32_t bytes = 4u * body;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
    const char* src = reinterpret_cast<const char*>(p + base + head);
    const uint32_t dst = smem_addr(s + shift + head);
    for (uint32_t off = 0; off < bytes; off += kPieceBytes) {
      const uint32_t piece = min(bytes - off, (uint32_t)kPieceBytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          ::"r"(dst + off), "l"(src + off), "r"(piece), "r"(bar)
          : "memory");
    }
  }
  for (int j = threadIdx.x; j < head; j += kThreads) s[shift + j] = p[base + j];
  for (int j = head + body + threadIdx.x; j < n; j += kThreads)
    s[shift + j] = p[base + j];
  if (body > 0) {
    mbar_wait(bar, phase);
    phase ^= 1u;
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_inclusive_max(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = fmaxf(v, n);
  }
  return v;
}

// Thread k owns the run [k*run, k*run + run) of a tile of n priorities; odd,
// so that a warp's 32 runs start in 32 banks.
__device__ __forceinline__ int run_length(int n) {
  return ((n + kThreads - 1) / kThreads) | 1;
}

// One read of s[0, n): each thread sums its run, and a warp-shuffle block
// scan over the run sums gives off[k] = carry + the runs before run k.  The
// prefix of element j of run k is off[k] plus the run's sequential sum up to
// j.  Returns the prefix of the tile's last element (its end mass) to every
// thread.  The order of every sum depends on n and carry alone.
__device__ float scan_tile(const float* s, int n, float carry, float* off,
                           float* warp_tot, float* end) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int run = run_length(n);
  const int lo = min(tid * run, n);
  const int hi = min(lo + run, n);
  float acc = 0.f;
  for (int j = lo; j < hi; ++j) acc += s[j];
  const float incl = warp_inclusive_scan(acc, lane);
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = warp_inclusive_scan(lane < kWarps ? warp_tot[lane] : 0.f, lane);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const float o = (carry + (warp > 0 ? warp_tot[warp - 1] : 0.f)) + excl;
  off[tid] = o;
  if (lo < n && hi == n) *end = o + acc;
  __syncthreads();
  return *end;
}

// Number of entries of a[0, n) that are <= x (a is ascending).
__device__ __forceinline__ int upper_bound(const float* a, int n, float x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] <= x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Number of the tile's prefixes (as scan_tile defines them) that are <= rel:
// the run by binary search over the run offsets, then a walk along the run.
__device__ __forceinline__ int count_le(const float* s, const float* off, int n,
                                       float rel) {
  const int run = run_length(n);
  const int runs = (n + run - 1) / run;
  const int k = upper_bound(off + 1, runs - 1, rel);
  const float o = off[k];
  const int hi = min(k * run + run, n);
  float acc = 0.f;
  int j = k * run;
  for (; j < hi; ++j) {
    acc += s[j];
    if (o + acc > rel) break;
  }
  return j;
}

__global__ void __launch_bounds__(kThreads, 1)
sample_kernel(const float* __restrict__ p, int C,
              const float* __restrict__ targets, int B, int slice, int tile,
              int shift, float* __restrict__ mass, int* __restrict__ out) {
  extern __shared__ __align__(128) float s_buf[];  // tile + 4 floats
  __shared__ float s_off[kThreads];
  __shared__ float s_E[kMaxGrid];
  __shared__ float s_warp[kWarps];
  __shared__ float s_end;
  __shared__ __align__(8) unsigned long long s_bar;

  const int g = blockIdx.x;
  const int G = gridDim.x;
  const long long start = (long long)g * slice;
  const int len = (int)min((long long)slice, (long long)C - start);
  const float* s = s_buf + shift;
  const uint32_t bar = smem_addr(&s_bar);
  uint32_t phase = 0;
  stamp(0);
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();

  // Targets of the first kPrefetch strides, loaded while p streams in.
  float tq[kPrefetch];
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int b = threadIdx.x + q * kThreads;
    tq[q] = b < B ? load_early(targets + b) : 0.f;
  }

  // 1-2. Stage and scan the slice (one tile when it fits); m = its mass.
  float m = 0.f;
  for (int k = 0; k < len; k += tile) {
    const int n = min(tile, len - k);
    stage(p, start + k, n, shift, s_buf, bar, phase);
    stamp(1);
    m = scan_tile(s, n, m, s_off, s_warp, &s_end);
  }
  stamp(2);

  // 3. Publish m_g, wait for every block, and build E[0..G-1] in one fixed
  // order: a sequential run per lane, a shuffle scan over the runs.
  // Rounding may leave E lower where two lanes' runs meet; a running max
  // (exact) makes it ascending, so the blocks' ranges [E[g], E[g+1]) tile
  // the line.
  if (threadIdx.x == 0) mass[g] = m;
  cg::this_grid().sync();
  stamp(3);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    constexpr int kPer = kMaxGrid / 32;
    const int per = (G + 31) / 32;
    const int lo = lane * per;
    float mk[kPer];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      mk[i] = (i < per && lo + i < G) ? __ldcg(mass + lo + i) : 0.f;
      run += mk[i];
    }
    const float incl = warp_inclusive_scan(run, lane);
    float acc = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) acc = 0.f;
    float ek[kPer];
    float top = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      ek[i] = acc;
      if (i < per && lo + i < G) top = acc;
      acc += mk[i];
    }
    float below = __shfl_up_sync(kFull, warp_inclusive_max(top, lane), 1);
    if (lane == 0) below = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (i < per && lo + i < G) s_E[lo + i] = fmaxf(ek[i], below);
  }
  __syncthreads();
  stamp(4);

  // 4. Resolve the targets this block owns: E[g] <= t < E[g+1], with block 0
  // taking t < 0 and the last block everything from E[G-1] up.
  const float lo_t = s_E[g];
  const float hi_t = g + 1 < G ? s_E[g + 1] : 0.f;
  auto owns = [&](float t) {
    return (g == 0 || !(t < lo_t)) && (g + 1 == G || t < hi_t);
  };
  if (tile >= slice) {  // the slice and its run offsets are still staged
    auto resolve = [&](int b, float t) {
      if (!owns(t)) return;
      const int pos = min(count_le(s, s_off, len, t - lo_t), len - 1);
      out[b] = (int)min(start + pos, (long long)C - 1);
    };
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int b = threadIdx.x + q * kThreads;
      if (b < B) resolve(b, tq[q]);
    }
    for (int b = threadIdx.x + kPrefetch * kThreads; b < B; b += kThreads)
      resolve(b, targets[b]);
    stamp(5);
    return;
  }
  // Tiled: re-stage and re-scan each tile (the same sums as above) and add
  // each owned target's count of prefixes <= rel into out[b].  The same
  // thread handles b in every tile, so out[b] needs no synchronisation.
  float carry = 0.f;
  for (int k = 0; k < len; k += tile) {
    const int n = min(tile, len - k);
    stage(p, start + k, n, shift, s_buf, bar, phase);
    carry = scan_tile(s, n, carry, s_off, s_warp, &s_end);
    for (int b = threadIdx.x; b < B; b += kThreads) {
      const float t = targets[b];
      if (!owns(t)) continue;
      const int c = count_le(s, s_off, n, t - lo_t);
      out[b] = (k == 0 ? 0 : out[b]) + c;
    }
  }
  for (int b = threadIdx.x; b < B; b += kThreads) {
    if (!owns(targets[b])) continue;
    const int pos = min(out[b], len - 1);
    out[b] = (int)min(start + pos, (long long)C - 1);
  }
}

size_t smem_bytes(int tile) { return sizeof(float) * ((size_t)tile + 4); }

}  // namespace

// Once per device (current device): lets the kernel take a full tile of
// dynamic shared memory and checks that one block fits on every SM, which a
// cooperative launch of up to one block per SM needs.  Writes the SM count.
extern "C" int apex_sample_setup(int* num_sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sample_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxTile));
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sample_kernel, kThreads, smem_bytes(kMaxTile));
  if (err != cudaSuccess) return (int)err;
  return per_sm >= 1 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// p: float32 [C]; targets: float32 [B]; mass: float32 scratch [grid];
// out: int32 [B].  grid blocks of `slice` floats cover C, the last one
// non-empty; `tile` (a multiple of 4, <= slice) is the shared-memory tile.
// Returns a cudaError_t (0 = success).
extern "C" int apex_sample_indices(const float* p, int C, const float* targets,
                                   int B, int grid, int slice, int tile,
                                   float* mass, int* out, void* stream) {
  if (C <= 0 || B < 0 || grid < 1 || grid > kMaxGrid || slice <= 0 ||
      slice % 4 != 0 || tile <= 0 || tile % 4 != 0 || tile > kMaxTile ||
      tile > slice || (long long)(grid - 1) * slice >= C ||
      (long long)grid * slice < C)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int shift = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(tile);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sample_kernel, p, C, targets, B, slice,
                                 tile, shift, mass, out);
}

#ifdef APEX_SAMPLER_PHASES
// Copies the phase stamps of the last launch, [kMaxGrid][kPhases] ns.
extern "C" int apex_sample_phases(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_ns, sizeof(phase_ns));
}
#endif
