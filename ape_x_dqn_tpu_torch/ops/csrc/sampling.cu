// Stratified inverse-CDF sampling over replay priorities, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_sample` in
// ape_x_dqn_tpu/ops/pallas/sampling.py (pallas_call at :118) and its XLA
// spellings `_two_level_sample` / `_xla_sample` in the same file: for each
// target t_b, the first index i with  sum_{j<=i} p_j > t_b  (searchsorted
// side="right"), clamped to C-1.  A target past the total resolves to the
// last leaf.
//
// The TPU kernel streams p once with a running sum carried in SMEM across a
// sequential grid.  CUDA blocks run in no fixed order, so nothing may be
// carried between blocks; the work is split into three launches instead:
//   1. chunk_mass:  one block per 1024-element chunk reduces its mass
//                   (lanes past C count as zero);
//   2. chunk_scan:  one block scans the R = ceil(C/1024) chunk masses into
//                   an inclusive chunk CDF, looping over tiles of 1024;
//   3. resolve:     one warp per target binary-searches the chunk CDF
//                   (side="right"), takes rel = t - (cdf[r] - mass[r]), runs
//                   a warp-shuffle scan over the chunk's 1024 priorities
//                   (32 per lane, carried across), counts prefix <= rel,
//                   then applies min(pos, 1023) and the clamp to C-1.
// This is the radix-1024 two-level tree of `_two_level_sample`.
//
// Bound: bytes.  The function must read p once (4*C bytes) and the B
// targets, and write B indices: 4*C + 8*B bytes.  Pass 1 reads p once,
// coalesced; pass 3 re-reads only the B chunks it lands in (4 KB each,
// mostly from L2).  Speed work (vector loads, fusing passes 1-2 with a
// decoupled look-back) is left for later; wgmma and TMA have no place here.
//
// Interface: plain C, launched on the caller's stream, no allocation and no
// synchronisation.  The caller provides scratch for the R chunk masses and
// the R chunk CDF entries and checks the returned cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kMassThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kResolveWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

// Pass 1: mass[r] = sum of p[r*1024 .. r*1024+1023], zero past C.
__global__ void chunk_mass_kernel(const float* __restrict__ p, int C,
                                  float* __restrict__ mass) {
  __shared__ float warp_tot[kMassThreads / 32];
  const long long base = (long long)blockIdx.x * kChunk;
  float v = 0.f;
  for (int k = threadIdx.x; k < kChunk; k += kMassThreads) {
    const long long i = base + k;
    if (i < C) v += p[i];
  }
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kMassThreads / 32 ? warp_tot[lane] : 0.f;
    w = warp_sum(w);
    if (lane == 0) mass[blockIdx.x] = w;
  }
}

// Pass 2: cdf[r] = mass[0] + ... + mass[r], one block, tiles of 1024 with
// the running total carried in shared memory between tiles.
__global__ void chunk_scan_kernel(const float* __restrict__ mass,
                                  float* __restrict__ cdf, int R) {
  __shared__ float warp_tot[kScanThreads / 32];
  __shared__ float carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0.f;
  __syncthreads();
  for (int tile = 0; tile < R; tile += kScanThreads) {
    const int i = tile + threadIdx.x;
    float v = i < R ? mass[i] : 0.f;
    v = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      warp_tot[lane] = warp_inclusive_scan(warp_tot[lane], lane);
    }
    __syncthreads();
    const float off = carry + (warp > 0 ? warp_tot[warp - 1] : 0.f);
    if (i < R) cdf[i] = v + off;
    __syncthreads();  // every thread has read `carry` for this tile
    if (threadIdx.x == kScanThreads - 1) carry = v + off;
    __syncthreads();
  }
}

// Pass 3: one warp per target.
__global__ void resolve_kernel(const float* __restrict__ p, int C,
                               const float* __restrict__ mass,
                               const float* __restrict__ cdf, int R,
                               const float* __restrict__ targets, int B,
                               int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kResolveWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together
  const float t = targets[b];
  // First chunk whose inclusive CDF exceeds t (side="right"); every lane
  // runs the same search, so its loads are broadcasts.
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] > t) hi = mid; else lo = mid + 1;
  }
  const int r = lo < R ? lo : R - 1;
  const float rel = t - (cdf[r] - mass[r]);
  const long long base = (long long)r * kChunk;
  float carry = 0.f;
  int count = 0;
  for (int k = 0; k < kChunk; k += 32) {
    const long long i = base + k + lane;
    const float v = i < C ? p[i] : 0.f;
    const float prefix = warp_inclusive_scan(v, lane) + carry;
    count += prefix <= rel ? 1 : 0;
    carry = __shfl_sync(kFull, prefix, 31);
  }
  count = warp_sum_int(count);
  if (lane == 0) {
    const int pos = count < kChunk - 1 ? count : kChunk - 1;
    const long long idx = base + pos;
    out[b] = (int)(idx < C - 1 ? idx : (long long)C - 1);
  }
}

}  // namespace

// p: float32 [C]; targets: float32 [B]; scratch_mass, scratch_cdf: float32
// [ceil(C/1024)] each; out: int32 [B].  Returns a cudaError_t (0 = success).
extern "C" int apex_sample_indices(const float* p, int C, const float* targets,
                                   int B, float* scratch_mass,
                                   float* scratch_cdf, int* out,
                                   void* stream) {
  if (C <= 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = (C + kChunk - 1) / kChunk;
  chunk_mass_kernel<<<R, kMassThreads, 0, s>>>(p, C, scratch_mass);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_scan_kernel<<<1, kScanThreads, 0, s>>>(scratch_mass, scratch_cdf, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kResolveWarps - 1) / kResolveWarps;
  resolve_kernel<<<blocks, kResolveWarps * 32, 0, s>>>(
      p, C, scratch_mass, scratch_cdf, R, targets, B, out);
  return (int)cudaGetLastError();
}
