// Fused modality-guidance combine + DDPM / DDIM scheduler step.
//
// Replaces convofusion_tpu/ops/pallas_step.py::_kernel (launched by
// fused_guided_step).  One elementwise pass over the n = B*16*128 latent
// elements computes, in fp32:
//   eps  = u + gs * (b1 + b2 + b3 + b4 + b5 - 5u)      (branch 6 weight 0)
//   x0   = (x - sqrt(1 - a_t) * eps) * (1 / sqrt(a_t)), clipped to +-1 if clip
//   eps2 = (x - sqrt(a_t) * x0) * (1 / sqrt(1 - a_t))
//   DDPM fixed_small posterior mean + add_noise * sqrt(max(var, 1e-20)) * z
//   or the eta-0 DDIM update sqrt(a_prev) * x0 + sqrt(1 - a_prev) * eps2.
//
// Bound: bytes.  About 20 flops per element against 20-24 bytes (bf16
// branch planes) or 32-36 (fp32).  The output does not depend on branch 6
// (weight 0) nor, outside DDPM steps with t > 0, on the noise, so neither
// is read: at B = 96 an eta-0 DDIM step with bf16 planes moves
// 6 x 0.39 + 0.79 + 0.79 = 3.9 MB, 1.17 us at 3.35 TB/s.  At that size the
// kernel is a few microseconds of latency, not of bandwidth, and the
// design is for latency:
//   * Every byte of a block's tile is in flight at once.  One thread arms
//     an mbarrier with the tile's byte count and issues one bulk copy
//     (cp.async.bulk, the copy engine behind TMA) per input slice: branch
//     planes 0-5 at their own dtype, the latents, and the noise only when
//     it enters.  No thread holds a load in a register while DRAM answers.
//   * One wave: the wrapper (ops/guided_step.py::_launch_geometry) sizes
//     the tile so that the grid fits the 132 SMs at the main path's shape
//     (TILE 1,536 -> 128 blocks at B = 96), and the last tile may be short.
//   * No per-thread scalar work: the twelve step coefficients are computed
//     once a step on the host (ops/guided_step.py::step_coefs) and arrive
//     as one struct; the card runs no scalar sqrt or division, and the two
//     per-element divisions are multiplications by host-made reciprocals,
//     as in the plain version.
// What is left at B = 96 is the fixed cost of a launch and of one copy
// round trip, which the kernel cannot remove: its time hardly changes
// from B = 1 to B = 96, while at sizes beyond L2 it streams near the
// memory rate (PERF.md, the step kernel's findings, and
// scripts/guided_step_compare.py, which measures it).
// Shared memory per block is 6 x TILE x sizeof(plane) + 2 x TILE x 4 bytes:
// 30 KB at TILE 1,536 with bf16 planes, 32 KB at TILE 1,024 with fp32
// planes.  The wrapper keeps it under the 48 KB a launch may take without
// cudaFuncSetAttribute, so none is called.
//
// Built without --use_fast_math and with -fmad=false: no multiply-add is
// contracted, so the kernel rounds as the plain PyTorch version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// The same fields, in the same order, as ops/guided_step.py::StepCoefs;
// passed by value to the C interface and on to the kernel.
struct StepCoefs {
  float gs, sqrt_at, sqrt_bt, inv_sqrt_at, inv_sqrt_bt, clip, is_ddpm;
  float coef_x0, coef_xt, noise_std, sqrt_aprev, sqrt_bprev;
};

namespace {

constexpr int kPlanes = 6;  // branches 0-5; branch 6 has weight 0
constexpr int kVec = 8;     // elements a thread takes per iteration
// try_wait polls before a block gives up on its copies (seconds of
// waiting): a byte count that never completes traps, and the launch then
// fails with a CUDA error instead of hanging the card
constexpr uint32_t kMaxPolls = 1u << 24;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global -> shared bulk copy that reports its bytes to the mbarrier.  Both
// addresses and the size must be multiples of 16 bytes.  A block launched
// without clusters is its own cluster, so shared::cluster names this
// block's shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// Eight consecutive elements from shared memory as fp32, 16-byte reads.
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// The plain version's op order (ops/guided_step.py::guided_step_reference).
__device__ __forceinline__ float step_one(const float (&b)[kPlanes], float x,
                                          float z, const StepCoefs& c) {
  const float single = b[1] + b[2] + b[3] + b[4] + b[5];
  const float eps = b[0] + c.gs * (single - 5.0f * b[0]);
  float x0 = (x - c.sqrt_bt * eps) * c.inv_sqrt_at;
  if (c.clip > 0.0f) x0 = fminf(fmaxf(x0, -1.0f), 1.0f);
  if (c.is_ddpm > 0.0f) {
    return c.coef_x0 * x0 + c.coef_xt * x + c.noise_std * z;
  }
  const float eps2 = (x - c.sqrt_at * x0) * c.inv_sqrt_bt;
  return c.sqrt_aprev * x0 + c.sqrt_bprev * eps2;
}

// Block b owns elements [b * tile, min((b + 1) * tile, n)).  Its shared
// buffer holds, in order: planes 0-5 (tile elements each, at the planes'
// dtype), the latents and the noise (tile fp32 each).
template <typename T>
__global__ void __launch_bounds__(256)
    guided_step_kernel(const T* __restrict__ np7,
                       const float* __restrict__ lat,
                       const float* __restrict__ noise,
                       float* __restrict__ out, long long n, int tile,
                       int read_noise, const StepCoefs c) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;

  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const int len = static_cast<int>(min(static_cast<long long>(tile),
                                       n - start));
  T* planes = reinterpret_cast<T*>(smem);
  float* xs = reinterpret_cast<float*>(smem + kPlanes * tile * sizeof(T));
  float* zs = xs + tile;
  const uint32_t bar_s = smem_addr(&bar);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t plane_bytes = len * sizeof(T);
    const uint32_t f32_bytes = len * sizeof(float);
    // the armed count and the copies below follow the same read_noise
    const uint32_t total =
        kPlanes * plane_bytes + f32_bytes * (read_noise ? 2 : 1);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_s),
        "r"(total)
        : "memory");
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      bulk_load(planes + k * tile, np7 + k * n + start, plane_bytes, bar_s);
    }
    bulk_load(xs, lat + start, f32_bytes, bar_s);
    if (read_noise) bulk_load(zs, noise + start, f32_bytes, bar_s);
  }
  wait_phase0(bar_s);

  for (int i = threadIdx.x * kVec; i < len; i += blockDim.x * kVec) {
    float p[kPlanes][kVec], x[kVec], z[kVec];
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) load8(planes + k * tile + i, p[k]);
    load8(xs + i, x);
    if (read_noise) {
      load8(zs + i, z);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) z[j] = 0.0f;
    }
    float r[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float b[kPlanes] = {p[0][j], p[1][j], p[2][j],
                                p[3][j], p[4][j], p[5][j]};
      r[j] = step_one(b, x[j], z[j], c);
    }
    float4* o = reinterpret_cast<float4*>(out + start + i);
    o[0] = make_float4(r[0], r[1], r[2], r[3]);
    o[1] = make_float4(r[4], r[5], r[6], r[7]);
  }
}

template <typename T>
int launch(const void* np7, const void* lat, const void* noise, void* out,
           long long n, StepCoefs c, int read_noise, int tile, int blocks,
           int threads, int smem_bytes, void* stream) {
  guided_step_kernel<T><<<blocks, threads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(np7), static_cast<const float*>(lat),
      static_cast<const float*>(noise), static_cast<float*>(out), n, tile,
      read_noise, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  np7 is (7, n) contiguous; lat, noise and
// out are (n,) fp32 contiguous; n a multiple of 8 and every pointer 16-byte
// aligned, so each bulk copy's addresses and size are multiples of 16
// bytes.  The geometry (tile, blocks, threads, shared bytes) comes from
// ops/guided_step.py::_launch_geometry, which checks it.  Returns
// cudaGetLastError() after the launch.
extern "C" int guided_step_f32(const void* np7, const void* lat,
                               const void* noise, void* out, long long n,
                               StepCoefs c, int read_noise, int tile,
                               int blocks, int threads, int smem_bytes,
                               void* stream) {
  return launch<float>(np7, lat, noise, out, n, c, read_noise, tile, blocks,
                       threads, smem_bytes, stream);
}

extern "C" int guided_step_bf16(const void* np7, const void* lat,
                                const void* noise, void* out, long long n,
                                StepCoefs c, int read_noise, int tile,
                                int blocks, int threads, int smem_bytes,
                                void* stream) {
  return launch<__nv_bfloat16>(np7, lat, noise, out, n, c, read_noise, tile,
                               blocks, threads, smem_bytes, stream);
}
