// Global-norm clip and RMSProp update over every leaf of the params, for
// Hopper (sm_90a): the learner's optimizer step as two launches.
//
// Replaces no TPU kernel.  The JAX package's optimizer (optax's
// clip_by_global_norm and rmsprop, ape_x_dqn_tpu/learner/train_step.py) is
// plain jnp that XLA fuses into the step's program.  Eager PyTorch ran it op
// by op inside the captured step: 86 launches for the clip and 11 per leaf
// for the bfloat16-nu update, 240 a step for the conv dueling net's 14 leaves.
//
// The arithmetic is the plain version's (learner/train_step.Optimizer.clip
// and _update), op by op, each op rounded once (__f*_rn: no FMA
// contraction), with the float constants PyTorch gives its scalars:
//   norm = sqrt(sum g^2)                       (no epsilon)
//   g'   = norm < max ? g : (g / norm) * max
//   nu32 = rho * nu + (1 - rho) * (g' * g')    (nu upcast from its storage)
//   s    = g' * rsqrt(nu32 + eps)              (eps inside the rsqrt)
//   nu   = nu32, rounded to nearest even when stored as bfloat16
//   p    = p + (-lr) * s
// Only the norm's summation order differs from the plain version's, so
// while the clip does not engage the result is the same bit for bit.
//
// Bound: bytes.  Per parameter the step must read g (4 B), read and write p
// (8 B) and read and write nu (4 B in bfloat16, 8 B in float32): 16 B, for
// config3's network (3 321 541 params) 53.1 MB, 15.9 us at 3.35 TB/s, against
// ~10 flops.  The design:
//   1. norm_partials: every block strides over every leaf as one flat index
//      space (16-byte loads where the leaf is aligned, plain loads for the
//      ragged tail) and writes its float32 sum of g^2 to partials[block]:
//      no atomics, so the norm is the same from run to run.
//   2. rmsprop_apply: each block first sums the partials in one fixed order,
//      so every block holds the same norm, then makes the one pass over
//      g, p and nu above, 16-byte loads and stores where aligned.
// g is read twice; its 13.3 MB (config3) stays in the 50 MB L2 between the
// two launches, so the second read comes mostly from L2 and device memory
// sees close to the 16 B.  The grid covers every SM several times over, and
// both launches use the same grid, so the partials are read as written.  On
// an NVIDIA H100 80GB HBM3 at 700 W the pair takes 21.2-22.9 us replayed from
// a graph (69-75 % of the bound) at config3's leaf sizes with bfloat16 nu and
// contiguous gradients; chip_smoke.py's phase 3b times it on the network's
// own gradients, whose conv weights come channels-last.
//
// nvcc 12.8 -O3 for sm_90a, ptxas -v: 28-32 registers, no stack frame, no
// spills, 32-36 bytes of static shared memory.
//
// Leaves are passed by value in the kernel's parameter block (as PyTorch's
// multi_tensor_apply does), up to kMaxLeaves: a CUDA graph that captures the
// launch keeps them with the other addresses.  Every network the port runs
// has 14 leaves or fewer; a call with more is refused.  p and nu are
// contiguous; a gradient may come in another layout (cuDNN hands the conv
// weights' gradients back channels-last): such a leaf carries g's sizes and
// strides, and g is read through them, element by element.
//
// Interface: plain C.  apex_rmsprop_setup once per device (the SM count);
// apex_rmsprop_step launches on the caller's stream, allocates nothing, does
// not synchronise, and returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 4;         // dims of a gradient read through its strides
constexpr int kMaxLeaves = 48;      // 48 x 72 B: inside the 4 KB parameter block
constexpr int kMaxGrid = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Leaf {
  const float* g;
  float* p;
  void* nu;
  long long n;
  int ndim;                 // 0: g laid out as p; else g's sizes and strides (elements)
  int size[kMaxDims];
  int stride[kMaxDims];
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
};

struct Hyper {
  float rho;        // (float)rho
  float one_minus;  // (float)(1 - rho), the difference taken in double
  float eps;        // (float)eps
  float neg_lr;     // (float)(-lr)
  float max_norm;   // (float)max_grad_norm
};

__host__ __device__ __forceinline__ bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

// Where element i of the leaf (p's row-major index) lies in g.
__device__ __forceinline__ long long g_offset(const Leaf& leaf, long long i) {
  if (leaf.ndim == 0) return i;
  int rest = static_cast<int>(i), off = 0;   // such a leaf's offsets fit an int
  for (int d = leaf.ndim - 1; d >= 0; --d) {
    const int q = rest / leaf.size[d];
    off += (rest - q * leaf.size[d]) * leaf.stride[d];
    rest = q;
  }
  return off;
}

// The block's sum of v, in one fixed order; valid in thread 0.
__device__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  }
  return v;
}

__device__ __forceinline__ float square_sum4(float acc, float4 v) {
  acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
  acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
  acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
  return __fadd_rn(acc, __fmul_rn(v.w, v.w));
}

__global__ void __launch_bounds__(kThreads)
norm_partials(const __grid_constant__ Leaves leaves, float* partials) {
  __shared__ float warp_sums[kWarps];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
#pragma unroll 1
  for (int l = 0; l < leaves.count; ++l) {
    const Leaf& leaf = leaves.leaf[l];
    const float* g = leaf.g;
    const long long n = leaf.n;
    long long head = 0;
    if (leaf.ndim == 0 && aligned(g, 16)) {
      const long long nv = n >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (long long i = tid; i < nv; i += stride) acc = square_sum4(acc, __ldg(g4 + i));
      head = nv << 2;
    }
    for (long long i = head + tid; i < n; i += stride) {
      const float v = __ldg(g + g_offset(leaf, i));
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
  }
  const float s = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

template <typename Nu> struct NuIO;

template <> struct NuIO<float> {
  static constexpr uintptr_t kVecBytes = 16;
  __device__ static float load(const void* nu, long long i) {
    return static_cast<const float*>(nu)[i];
  }
  __device__ static void store(void* nu, long long i, float v) {
    static_cast<float*>(nu)[i] = v;
  }
  __device__ static float4 load4(const void* nu, long long i) {
    return static_cast<const float4*>(nu)[i];
  }
  __device__ static void store4(void* nu, long long i, float4 v) {
    static_cast<float4*>(nu)[i] = v;
  }
};

template <> struct NuIO<__nv_bfloat16> {
  static constexpr uintptr_t kVecBytes = 8;
  __device__ static float load(const void* nu, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(nu)[i]);
  }
  __device__ static void store(void* nu, long long i, float v) {
    static_cast<__nv_bfloat16*>(nu)[i] = __float2bfloat16_rn(v);
  }
  __device__ static float4 load4(const void* nu, long long i) {
    const uint2 raw = static_cast<const uint2*>(nu)[i];
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
  }
  __device__ static void store4(void* nu, long long i, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    static_cast<uint2*>(nu)[i] = raw;
  }
};

// One element of the step (see the top of the file); nu in and out as float32.
template <bool kClip>
__device__ __forceinline__ void step(float g, float& p, float& nu, const Hyper& h,
                                     bool keep, float norm) {
  if (kClip && !keep) g = __fmul_rn(__fdiv_rn(g, norm), h.max_norm);
  const float nu32 = __fadd_rn(__fmul_rn(h.rho, nu), __fmul_rn(h.one_minus, __fmul_rn(g, g)));
  const float s = __fmul_rn(g, rsqrtf(__fadd_rn(nu32, h.eps)));
  nu = nu32;
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, s));
}

template <typename Nu, bool kClip>
__global__ void __launch_bounds__(kThreads)
rmsprop_apply(const __grid_constant__ Leaves leaves, const float* partials, int num_partials,
              Hyper h) {
  __shared__ float warp_sums[kWarps + 1];
  bool keep = true;
  float norm = 0.0f;
  if (kClip) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < num_partials; i += kThreads)
      acc = __fadd_rn(acc, partials[i]);
    const float total = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) warp_sums[kWarps] = __fsqrt_rn(total);
    __syncthreads();
    norm = warp_sums[kWarps];
    keep = norm < h.max_norm;   // false for a NaN norm, as torch.where's condition
  }
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
#pragma unroll 1
  for (int l = 0; l < leaves.count; ++l) {
    const Leaf& leaf = leaves.leaf[l];
    const float* g = leaf.g;
    float* p = leaf.p;
    void* nu = leaf.nu;
    const long long n = leaf.n;
    long long head = 0;
    if (leaf.ndim == 0 && aligned(g, 16) && aligned(p, 16) &&
        aligned(nu, NuIO<Nu>::kVecBytes)) {
      const long long nv = n >> 2;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      for (long long i = tid; i < nv; i += stride) {
        const float4 gv = __ldg(g4 + i);
        float4 pv = p4[i];
        float4 nv4 = NuIO<Nu>::load4(nu, i);
        step<kClip>(gv.x, pv.x, nv4.x, h, keep, norm);
        step<kClip>(gv.y, pv.y, nv4.y, h, keep, norm);
        step<kClip>(gv.z, pv.z, nv4.z, h, keep, norm);
        step<kClip>(gv.w, pv.w, nv4.w, h, keep, norm);
        NuIO<Nu>::store4(nu, i, nv4);
        p4[i] = pv;
      }
      head = nv << 2;
    }
    for (long long i = head + tid; i < n; i += stride) {
      float pv = p[i];
      float nv1 = NuIO<Nu>::load(nu, i);
      step<kClip>(__ldg(g + g_offset(leaf, i)), pv, nv1, h, keep, norm);
      NuIO<Nu>::store(nu, i, nv1);
      p[i] = pv;
    }
  }
}

template <typename Nu>
cudaError_t launch_apply(bool clip, const Leaves& leaves, const float* partials, int grid,
                         const Hyper& h, cudaStream_t stream) {
  if (clip)
    rmsprop_apply<Nu, true><<<grid, kThreads, 0, stream>>>(leaves, partials, grid, h);
  else
    rmsprop_apply<Nu, false><<<grid, kThreads, 0, stream>>>(leaves, partials, grid, h);
  return cudaGetLastError();
}

}  // namespace

// The SM count of the current device.
extern "C" int apex_rmsprop_setup(int* num_sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
}

// One optimizer step over `count` leaves (1 to kMaxLeaves): g[i], p[i]
// float32 and nu[i] (bfloat16 when nu_bf16, else float32) of n[i] elements
// each, p and nu contiguous; g[i] laid out as p when ndim[i] is 0, else of
// sizes sizes[i*kMaxDims ...] and element strides strides[i*kMaxDims ...].
// With `clip` the norm launch runs first over `grid` blocks into `partials`
// (grid floats).  Both launches go to `stream`.
extern "C" int apex_rmsprop_step(const void* const* g, void* const* p, void* const* nu,
                                 const long long* n, const int* ndim, const int* sizes,
                                 const int* strides, int count, int nu_bf16, int clip,
                                 float rho, float one_minus, float eps, float neg_lr,
                                 float max_norm, float* partials, int grid, void* stream) {
  if (count < 1 || count > kMaxLeaves || grid < 1 || grid > kMaxGrid ||
      (clip && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  Leaves t{};
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0 || g[i] == nullptr || p[i] == nullptr || nu[i] == nullptr ||
        !aligned(g[i], 4) || !aligned(p[i], 4) || !aligned(nu[i], nu_bf16 ? 2 : 4) ||
        ndim[i] < 0 || ndim[i] > kMaxDims || (ndim[i] > 0 && n[i] > 0x7fffffffLL))
      return (int)cudaErrorInvalidValue;
    Leaf& leaf = t.leaf[t.count++];
    leaf.g = static_cast<const float*>(g[i]);
    leaf.p = static_cast<float*>(p[i]);
    leaf.nu = nu[i];
    leaf.n = n[i];
    leaf.ndim = ndim[i];
    for (int d = 0; d < kMaxDims; ++d) {
      leaf.size[d] = sizes[i * kMaxDims + d];
      leaf.stride[d] = strides[i * kMaxDims + d];
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clip) {
    norm_partials<<<grid, kThreads, 0, s>>>(t, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const Hyper h{rho, one_minus, eps, neg_lr, max_norm};
  return (int)(nu_bf16 ? launch_apply<__nv_bfloat16>(clip, t, partials, grid, h, s)
                       : launch_apply<float>(clip, t, partials, grid, h, s));
}
