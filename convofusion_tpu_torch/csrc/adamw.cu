// AdamW over a training step's whole trainable set in one pass:
// optax.chain(clip_by_global_norm(c), adamw(lr, b1, b2, eps, wd)) on fp32
// masters and moments, from gradients in their own dtype, with the rounded
// master written into the low-precision weight.
//
// Replaces no TPU kernel: the JAX package leaves optax's update to XLA.  It
// replaces the port's torch._foreach chain (ops/adamw.py::adamw_reference):
// a per-tensor fp32 cast of every gradient, 13 foreach passes and the
// per-tensor bf16 copy, ~1,000 small kernels a step that read and write
// each parameter ~128 bytes.  For each element, in the chain's op order
// and rounding:
//   g   = float(grad), 0 where the tensor has none
//   g   = g / norm * c                    when c != 0 and not norm < c
//   mu  = fma(1 - b1, g, mu * b1)         (_foreach_add_ with alpha)
//   nu  = fma(1 - b2, g * g, nu * b2)     (_foreach_addcmul_ with value)
//   u   = (mu / bc1) / (sqrt(nu / bc2) + eps)
//   u   = fma(wd, master, u)              (_foreach_add_ with alpha; wd > 0)
//   master = master + u * (-lr);  weight = bf16(master) where there is one
// Every operation is an explicit round-to-nearest intrinsic and the file
// builds with -fmad=false, so nothing else is contracted.  -lr and the two
// bias corrections are read from the trainer's 0-dim device tensors, so
// one captured launch serves every step.
//
// Bound: bytes.  ~20 flops an element against 28 bytes (bf16 gradient and
// weight; 30 with an fp32 gradient and no weight): the 93.75 M parameters
// of stage 2 are 2.63 GB, 0.78 ms at 3.35 TB/s.  The design:
//   * A work list, not a launch per tensor.  ops/adamw.py builds a device
//     table of tensor descriptors (the five pointers, the size, flags) and
//     of chunks (tensor, index) of `chunk` elements; block b takes chunk b.
//     That balances 544 tensors whose median is 512 elements against the
//     512 x 1024 matrices, and the table is made once, outside any CUDA
//     graph capture, so a captured step is this launch and nothing else.
//   * Each element is read once and written once.  Where every pointer of
//     a tensor is 16-byte aligned a thread moves 8 elements at a time in
//     16-byte loads and stores (fp32 as two float4, bf16 as one uint4),
//     with a scalar tail; other tensors take the scalar loop.  A thread
//     keeps ~112 bytes of loads in flight an iteration, 2,048 threads an
//     SM: far over the ~20 KB an SM needs to cover DRAM's latency.
//   * The clip's global norm, where the caller has none, is a pre-pass of
//     kNormBlocks blocks, each summing the squares of a fixed set of
//     chunks in a fixed order into its own partial; each update block
//     sums the partials in a fixed order.  No atomics: the norm repeats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// The same fields, in the same order, as ops/adamw.py::_CHyper; passed by
// value.
struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, grad_clip;
};

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // elements a thread moves at a time
constexpr int kNormBlocks = 264; // ops/adamw.py NORM_BLOCKS

// ops/adamw.py FLAG_*
constexpr long long kHasGrad = 1, kGradBf16 = 2, kHasWeight = 4,
                    kAligned = 8;

// A tensor's row of the table (ops/adamw.py DESC_FIELDS): 8 int64.
struct Desc {
  long long grad, master, mu, nu, weight, numel, flags, unused;
};
// A chunk's row: elements [index * chunk, min((index + 1) * chunk, numel))
// of tensor `tensor`.
struct Chunk {
  int tensor, index;
};

__device__ __forceinline__ float load_grad(const Desc& d, long long i) {
  if (!(d.flags & kHasGrad)) return 0.0f;
  if (d.flags & kGradBf16) {
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(d.grad)[i]);
  }
  return reinterpret_cast<const float*>(d.grad)[i];
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8_grad(const Desc& d, long long i,
                                           float (&v)[kVec]) {
  if (!(d.flags & kHasGrad)) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = 0.0f;
  } else if (d.flags & kGradBf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(d.grad) + i);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    load8(reinterpret_cast<const float*>(d.grad) + i, v);
  }
}

__device__ __forceinline__ void store8_bf16(__nv_bfloat16* p,
                                            const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The chain's op order for one element (file comment).
__device__ __forceinline__ void adamw_one(float g, float& master, float& mu,
                                          float& nu, const Hyper& h,
                                          bool clip, float norm, float neg_lr,
                                          float bc1, float bc2) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.grad_clip);
  mu = __fmaf_rn(h.one_minus_b1, g, __fmul_rn(mu, h.b1));
  nu = __fmaf_rn(h.one_minus_b2, __fmul_rn(g, g), __fmul_rn(nu, h.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(mu, bc1), denom);
  if (h.weight_decay != 0.0f) u = __fmaf_rn(h.weight_decay, master, u);
  master = __fadd_rn(master, __fmul_rn(u, neg_lr));
}

// The sum of v over the block, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[kThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warps[w]);
    total = s;
  }
  __syncthreads();
  return total;
}

// Pre-pass: block b sums g * g over chunks b, b + kNormBlocks, ... into
// partials[b].
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const Desc* __restrict__ descs,
                 const Chunk* __restrict__ chunks, int n_chunks, int chunk,
                 float* __restrict__ partials) {
  float acc = 0.0f;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunks[c];
    const Desc d = descs[ch.tensor];
    if (!(d.flags & kHasGrad)) continue;
    const long long start = static_cast<long long>(ch.index) * chunk;
    const int len = static_cast<int>(
        min(static_cast<long long>(chunk), d.numel - start));
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float g = load_grad(d, start + i);
      acc = __fmaf_rn(g, g, acc);
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Desc* __restrict__ descs,
                 const Chunk* __restrict__ chunks, int chunk, const Hyper h,
                 const float* __restrict__ neg_lr_p,
                 const float* __restrict__ bc1_p,
                 const float* __restrict__ bc2_p,
                 const float* __restrict__ norm_p,
                 const float* __restrict__ partials) {
  const Chunk ch = chunks[blockIdx.x];
  const Desc d = descs[ch.tensor];
  const float neg_lr = *neg_lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  bool clip = false;
  float norm = 0.0f;
  if (h.grad_clip != 0.0f) {
    if (norm_p != nullptr) {
      norm = *norm_p;
    } else {
      float s = 0.0f;
      for (int b = threadIdx.x; b < kNormBlocks; b += kThreads) {
        s = __fadd_rn(s, partials[b]);
      }
      norm = __fsqrt_rn(block_sum(s));
    }
    clip = !(norm < h.grad_clip);
  }
  const long long start = static_cast<long long>(ch.index) * chunk;
  const int len = static_cast<int>(
      min(static_cast<long long>(chunk), d.numel - start));
  float* master = reinterpret_cast<float*>(d.master) + start;
  float* mu = reinterpret_cast<float*>(d.mu) + start;
  float* nu = reinterpret_cast<float*>(d.nu) + start;
  __nv_bfloat16* weight = reinterpret_cast<__nv_bfloat16*>(d.weight) + start;
  const bool has_weight = d.flags & kHasWeight;

  int vec_end = 0;
  if (d.flags & kAligned) {
    vec_end = len / kVec * kVec;
    for (int i = threadIdx.x * kVec; i < vec_end; i += kThreads * kVec) {
      float g[kVec], m[kVec], a[kVec], v[kVec];
      load8_grad(d, start + i, g);
      load8(master + i, m);
      load8(mu + i, a);
      load8(nu + i, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        adamw_one(g[j], m[j], a[j], v[j], h, clip, norm, neg_lr, bc1, bc2);
      }
      store8(master + i, m);
      store8(mu + i, a);
      store8(nu + i, v);
      if (has_weight) store8_bf16(weight + i, m);
    }
  }
  for (int i = vec_end + threadIdx.x; i < len; i += kThreads) {
    float m = master[i], a = mu[i], v = nu[i];
    adamw_one(load_grad(d, start + i), m, a, v, h, clip, norm, neg_lr, bc1,
              bc2);
    master[i] = m;
    mu[i] = a;
    nu[i] = v;
    if (has_weight) weight[i] = __float2bfloat16_rn(m);
  }
}

}  // namespace

// Plain C interface for ctypes.  `table` holds n_tensors Desc rows, then
// n_chunks Chunk rows (ops/adamw.py::work_list); neg_lr, bc1 and bc2 are
// 0-dim fp32 device tensors; `norm` the clip's global norm or null, and
// then, with h.grad_clip != 0, the pre-pass computes it into `partials`
// (kNormBlocks floats).  Launches on `stream` and returns
// cudaGetLastError() after the last launch, or the first error.
extern "C" int adamw_step(const void* table, int n_tensors, int n_chunks,
                          int chunk, Hyper h, const float* neg_lr,
                          const float* bc1, const float* bc2,
                          const float* norm, float* partials,
                          void* stream) {
  const auto* descs = static_cast<const Desc*>(table);
  const auto* chunks = reinterpret_cast<const Chunk*>(descs + n_tensors);
  auto s = static_cast<cudaStream_t>(stream);
  if (h.grad_clip != 0.0f && norm == nullptr) {
    sumsq_kernel<<<kNormBlocks, kThreads, 0, s>>>(descs, chunks, n_chunks,
                                                  chunk, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  adamw_kernel<<<n_chunks, kThreads, 0, s>>>(descs, chunks, chunk, h, neg_lr,
                                             bc1, bc2, norm, partials);
  return static_cast<int>(cudaGetLastError());
}
