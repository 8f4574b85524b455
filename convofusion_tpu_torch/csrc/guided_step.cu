// Fused modality-guidance combine + DDPM / DDIM scheduler step.
//
// Replaces convofusion_tpu/ops/pallas_step.py::_kernel (launched by
// fused_guided_step).  One elementwise pass over the R*D = B*16*128 latent
// elements computes, in fp32:
//   eps  = u + gs * (b1 + b2 + b3 + b4 + b5 - 5u)      (branch 6 weight 0)
//   x0   = (x - sqrt(1 - a_t) * eps) / sqrt(a_t), clipped to +-1 if clip
//   eps2 = (x - sqrt(a_t) * x0) / sqrt(1 - a_t)
//   DDPM fixed_small posterior mean + add_noise * sqrt(max(var, 1e-20)) * z
//   or the eta-0 DDIM update sqrt(a_prev) * x0 + sqrt(1 - a_prev) * eps2.
//
// Bound: bytes.  About 20 flops per element against 36-40 bytes (fp32
// branch planes) or 20-24 bytes (bf16).  Counting all seven planes, at
// B = 96 a DDPM step moves 7 x 0.79 MB of noise_pred + 2 x 0.79 MB in +
// 0.79 MB out = 7.9 MB, ~2.35 us at 3.35 TB/s; with bf16 planes 5.1 MB,
// ~1.5 us.  The output does not depend on branch 6 (weight 0) nor, outside
// DDPM steps with t > 0, on the noise, so the kernel reads neither: an
// eta-0 DDIM step with bf16 planes moves 6 x 0.39 + 0.79 + 0.79 = 3.9 MB,
// ~1.2 us.  The design moves each byte once: each thread handles 4
// consecutive elements with 16-byte loads of latents, noise and output
// (8-byte loads of bf16 planes), reads the branch planes at their own
// dtype and upcasts in registers (no fp32 copy of noise_pred, as
// pallas_step.py:97 makes), and takes the six per-step scalars as kernel
// arguments.  At this size one launch costs
// about as much as the work, so launch latency will likely dominate;
// closing that (a CUDA graph over the step loop, or folding the step into
// the epilogue of the denoiser's last GEMM) is later work.
//
// Built without --use_fast_math and with -fmad=false: divisions and square
// roots stay IEEE and no multiply-add is contracted, so the kernel rounds
// as the plain PyTorch version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

struct StepCoefs {
  float gs, sqrt_at, sqrt_bt, clip, is_ddpm;
  float coef_x0, coef_xt, noise_std, sqrt_aprev, sqrt_bprev;
};

__device__ __forceinline__ float step_one(float u, float b1, float b2,
                                          float b3, float b4, float b5,
                                          float x, float z,
                                          const StepCoefs& c) {
  const float single = b1 + b2 + b3 + b4 + b5;
  const float eps = u + c.gs * (single - 5.0f * u);
  float x0 = (x - c.sqrt_bt * eps) / c.sqrt_at;
  if (c.clip > 0.0f) x0 = fminf(fmaxf(x0, -1.0f), 1.0f);
  if (c.is_ddpm > 0.0f) {
    return c.coef_x0 * x0 + c.coef_xt * x + c.noise_std * z;
  }
  const float eps2 = (x - c.sqrt_at * x0) / c.sqrt_bt;
  return c.sqrt_aprev * x0 + c.sqrt_bprev * eps2;
}

template <typename T>
__global__ void guided_step_kernel(const T* __restrict__ np7,
                                   const float* __restrict__ lat,
                                   const float* __restrict__ noise,
                                   float* __restrict__ out, long long n,
                                   float alpha_t, float alpha_prev, float gs,
                                   float is_ddpm, float add_noise,
                                   float clip) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (e >= n) return;

  // per-step coefficients, in the order and precision of the plain version
  StepCoefs c;
  const float beta_t = 1.0f - alpha_t;
  const float beta_prev = 1.0f - alpha_prev;
  c.gs = gs;
  c.clip = clip;
  c.is_ddpm = is_ddpm;
  c.sqrt_at = sqrtf(alpha_t);
  c.sqrt_bt = sqrtf(beta_t);
  const float current_alpha = alpha_t / alpha_prev;
  const float current_beta = 1.0f - current_alpha;
  c.coef_x0 = sqrtf(alpha_prev) * current_beta / beta_t;
  c.coef_xt = sqrtf(current_alpha) * beta_prev / beta_t;
  const float variance = fmaxf(beta_prev / beta_t * current_beta, 1e-20f);
  c.noise_std = add_noise * sqrtf(variance);
  c.sqrt_aprev = sqrtf(alpha_prev);
  c.sqrt_bprev = sqrtf(fmaxf(beta_prev, 0.0f));

  const float4 u = load4(np7 + e);
  const float4 b1 = load4(np7 + n + e);
  const float4 b2 = load4(np7 + 2 * n + e);
  const float4 b3 = load4(np7 + 3 * n + e);
  const float4 b4 = load4(np7 + 4 * n + e);
  const float4 b5 = load4(np7 + 5 * n + e);  // branch 6 (full) unread
  const float4 x = load4(lat + e);
  // the noise is read only where it enters: DDPM steps with t > 0
  const float4 z = (is_ddpm > 0.0f && add_noise != 0.0f)
                       ? load4(noise + e)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float4 r;
  r.x = step_one(u.x, b1.x, b2.x, b3.x, b4.x, b5.x, x.x, z.x, c);
  r.y = step_one(u.y, b1.y, b2.y, b3.y, b4.y, b5.y, x.y, z.y, c);
  r.z = step_one(u.z, b1.z, b2.z, b3.z, b4.z, b5.z, x.z, z.z, c);
  r.w = step_one(u.w, b1.w, b2.w, b3.w, b4.w, b5.w, x.w, z.w, c);
  *reinterpret_cast<float4*>(out + e) = r;
}

template <typename T>
int launch(const void* np7, const void* lat, const void* noise, void* out,
           long long n, float alpha_t, float alpha_prev, float gs,
           float is_ddpm, float add_noise, float clip, void* stream) {
  const int threads = 256;
  const long long groups = n / 4;
  const unsigned blocks =
      static_cast<unsigned>((groups + threads - 1) / threads);
  guided_step_kernel<T><<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(np7), static_cast<const float*>(lat),
      static_cast<const float*>(noise), static_cast<float*>(out), n, alpha_t,
      alpha_prev, gs, is_ddpm, add_noise, clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  np7 is (7, n) contiguous; lat, noise and
// out are (n,) fp32 contiguous, n a multiple of 4, all 16-byte aligned (the
// Python wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int guided_step_f32(const void* np7, const void* lat,
                               const void* noise, void* out, long long n,
                               float alpha_t, float alpha_prev, float gs,
                               float is_ddpm, float add_noise, float clip,
                               void* stream) {
  return launch<float>(np7, lat, noise, out, n, alpha_t, alpha_prev, gs,
                       is_ddpm, add_noise, clip, stream);
}

extern "C" int guided_step_bf16(const void* np7, const void* lat,
                                const void* noise, void* out, long long n,
                                float alpha_t, float alpha_prev, float gs,
                                float is_ddpm, float add_noise, float clip,
                                void* stream) {
  return launch<__nv_bfloat16>(np7, lat, noise, out, n, alpha_t, alpha_prev,
                               gs, is_ddpm, add_noise, clip, stream);
}
