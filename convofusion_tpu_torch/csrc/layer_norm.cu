// The guided denoiser's LayerNorm over rows of D (a multiple of 4, up to
// 1024), written in bf16 for the Linear that reads it, with TimeBlock's
// modulation and SiLU as an optional epilogue.
//
// Replaces no TPU kernel: the JAX package computes nn.LayerNorm in fp32 and
// lets nn.Dense(dtype=bf16) round the result at its input, and XLA fuses
// the two (convofusion_tpu/ops/transformer.py:291-302).  It replaces the
// port's plain sequence (ops/layer_norm.py::layer_norm_reference): the
// upcast of a bf16 input, PyTorch's fp32 LayerNorm, the fp32 mul and add of
// TimeBlock's modulation and its SiLU, and the cast to bf16 inside each
// Linear that reads the result.  Per row, in the plain path's rounding:
//   mean, var      fp32, in the order of PyTorch's vectorized_layer_norm
//                  kernel at N = D: a block of 128 threads, thread t taking
//                  the 4-element vectors t, t + 128, ... of the row in
//                  turn, Welford online per thread, a shuffle-down tree
//                  over each warp, a tree over the 4 warps; the
//                  multiply-adds that PyTorch's build contracts are
//                  __fmaf_rn here
//   y = fma(w, rstd * (x - mean), b)      rstd = rsqrtf(var + eps)
//   with the epilogue, per batch row of scale and shift (bf16):
//   y = silu(y * bf16(1 + scale) + shift)  fp32, x / (1 + expf(-x))
//   out = bf16(y)
// The module builds with -fmad=false and no fast math (ops/nvcc.FLAGS).
//
// Bound: bytes.  A row reads D inputs in their stored dtype (fp32 or bf16)
// and writes D bf16 values; weight, bias and the scale and shift rows stay
// in L1 and L2.  The design: one warp a row, each lane standing in for 4 of
// PyTorch's 128 threads (lanes l of the 4 virtual warps: threads l, l + 32,
// l + 64, l + 96), so that the four warp trees run side by side in one
// lane's registers and the row needs no shared memory and no barrier; a
// thread's kSteps = ceil(D / 512) vectors are template-unrolled, those past
// the row's end skipped as PyTorch's loop skips them; at D 512 and 1024 the
// width is a template constant and nothing is skipped (a width read at run
// time made the D 512 rows 20-50% slower); all of a lane's loads are issued
// before its first use; 8 rows a block.
//
// memory_norms, the second entry: every memory LayerNorm of a guided call
// (each layer's {stream}_norm over the stream's real and uncond memory
// rows) in one launch.  The rows are the same for every layer and only
// the affine differs, so a row is read and its mean and rstd computed once,
// by the reduction above (so each output is bit-equal to layer_norm's),
// and its rstd * (x - mean) is written once a layer, with that layer's
// fp32 weight and bias, in bf16.  Out: (layers, rows, d), a layer's rows
// stream by stream, each stream's real rows then its uncond rows, so that
// one GEMM a (layer, stream) projects both variants.  The weights are read
// where they live, through the addresses in the parameters.  Bound: bytes,
// and mostly the writes: at the published geometry (batch 32, Tk 64, 161,
// 64, 8, 1, fp32 rows) 20.1 MB read and 90.6 MB written, 33 us at
// 3.35 TB/s.  The design: a warp takes 4 rows of a stream (2 at D > 512);
// for each row it runs the reduction, then reads the row again (from L1)
// in chunks of 8 columns a lane (4 where D is not a multiple of 8) and
// keeps rstd * (x - mean); then per layer it loads the chunks' weight and
// bias once and writes each row's chunks with 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // one warp a row
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kVec = 4;          // PyTorch's vec_size: a thread's vector
constexpr int kTorchThreads = 128;            // PyTorch's block
constexpr int kParts = kTorchThreads / 32;    // its warps a lane stands in
constexpr int kMaxD = 1024;      // ops/layer_norm.py MAX_D
constexpr int kMaxSteps = kMaxD / (kTorchThreads * kVec);
constexpr int kMaxStreams = 8;   // memory_norms: streams a launch
constexpr int kMaxNorms = 128;   // (layer, stream) affines a launch
constexpr int kTaskRows = 4;     // rows a warp at D <= 512

struct Welford {
  float mean, m2, count;
};

// PyTorch's cuWelfordOnlineSum.
__device__ __forceinline__ Welford online(Welford w, float v) {
  const float delta = v - w.mean;
  const float n = w.count + 1.f;
  const float mean = __fmaf_rn(delta, 1.f / n, w.mean);
  return {mean, __fmaf_rn(delta, v - mean, w.m2), n};
}

// PyTorch's cuWelfordCombine(dataB = own, dataA = other).
__device__ __forceinline__ Welford combine(Welford own, Welford other) {
  const float delta = own.mean - other.mean;
  const float count = other.count + own.count;
  if (!(count > 0.f)) return {0.f, 0.f, count};
  const float coef = 1.f / count;
  const float n_other = other.count * coef;
  const float n_own = own.count * coef;
  return {__fmaf_rn(n_other, other.mean, n_own * own.mean),
          __fmaf_rn(delta * delta * other.count, n_own, other.m2 + own.m2),
          count};
}

__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float v[kVec]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

}  // namespace

// The same fields, in the same order, as ops/layer_norm.py::_CParams;
// passed by value.
struct Params {
  const void* x;                  // fp32 or bf16 rows of d: row r at
                                  //   (r / x_inner) * x_outer + r % x_inner
                                  //   rows of d (x_outer 0: a broadcast)
  void* y;                        // (rows, d) bf16
  const float* weight;            // (d,)
  const float* bias;              // (d,)
  const __nv_bfloat16* scale;     // the epilogue's rows, or null: none
  const __nv_bfloat16* shift;
  long long rows;
  long long x_inner;
  long long x_outer;              // elements
  long long mod_stride;           // elements between scale (shift) rows
  int rows_per_batch;             // row r takes scale row
  int batches;                    //   (r / rows_per_batch) % batches
  int x_bf16;
  int d;                          // a multiple of kVec, up to kMaxD
  float eps;
};

// One variant (real or uncond) of one stream's memory rows.
struct MemSegment {
  const void* x;                  // fp32 or bf16 rows of d, row r at
                                  //   (r / x_inner) * x_outer + r % x_inner
                                  //   rows of d
  long long rows;
  long long x_inner;
  long long x_outer;              // elements
  int x_bf16;
};

// memory_norms' parameters: the same fields, in the same order, as
// ops/layer_norm.py::_CMemParams; passed by value.
struct MemParams {
  MemSegment seg[kMaxStreams][2];         // stream s: real, then uncond
  long long out_row[kMaxStreams];         // a layer's rows before stream s
  long long task_start[kMaxStreams + 1];  // set by memory_norms
  const float* weight[kMaxNorms];         // (d,) of (layer, stream) at
  const float* bias[kMaxNorms];           //   layer * streams + stream
  void* y;                                // (layers, layer_rows, d) bf16
  long long layer_rows;
  int streams;
  int layers;
  int d;                                  // as Params::d
  float eps;
};

namespace {

// The row's vectors in PyTorch's order: vector (step, part) of this lane is
// PyTorch's thread part * 32 + lane reading vector step * 128 + part * 32 +
// lane; all loads are issued before the first use.
template <typename T, int kSteps, bool kFull>
__device__ __forceinline__ void load_row(const T* x, int lane, int vecs,
                                         float v[kSteps][kParts][kVec]) {
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int i = (step * kParts + part) * 32 + lane;
      if (kFull || i < vecs) load4(x + i * kVec, v[step][part]);
    }
  }
}

// The row's mean and rstd from load_row's vectors, in PyTorch's order,
// the same in every lane.
template <int kSteps, bool kFull>
__device__ __forceinline__ void row_stats(const float v[kSteps][kParts][kVec],
                                          int lane, int vecs, int d,
                                          float eps, float& mean,
                                          float& rstd) {
  // lane l holds thread l of each of PyTorch's 4 warps
  Welford w[kParts];
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    w[part] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      if (kFull || (step * kParts + part) * 32 + lane < vecs) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          w[part] = online(w[part], v[step][part][i]);
        }
      }
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const Welford other{
          __shfl_down_sync(0xffffffffu, w[part].mean, offset),
          __shfl_down_sync(0xffffffffu, w[part].m2, offset),
          __shfl_down_sync(0xffffffffu, w[part].count, offset)};
      w[part] = combine(w[part], other);
    }
  }
  // PyTorch's tree over its warps: 0 with 2 and 1 with 3, then 0 with 1
  const Welford s = combine(combine(w[0], w[2]), combine(w[1], w[3]));
  mean = __shfl_sync(0xffffffffu, s.mean, 0);
  const float var =
      __shfl_sync(0xffffffffu, s.m2, 0) / static_cast<float>(d);
  rstd = rsqrtf(var + eps);
}

// kFull: d is kSteps * 512, so that every vector of a lane lies in the row
// and the width is a constant
template <typename T, bool kMod, int kSteps, bool kFull>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  const int d = kFull ? kSteps * kTorchThreads * kVec : p.d;
  const int vecs = d / kVec;
  const T* x = static_cast<const T*>(p.x) + (row / p.x_inner) * p.x_outer +
               (row % p.x_inner) * d;
  float v[kSteps][kParts][kVec];
  load_row<T, kSteps, kFull>(x, lane, vecs, v);
  float mean, rstd;
  row_stats<kSteps, kFull>(v, lane, vecs, d, p.eps, mean, rstd);

  const __nv_bfloat16* sc = nullptr;
  const __nv_bfloat16* sh = nullptr;
  if (kMod) {
    const long long b = (row / p.rows_per_batch) % p.batches;
    sc = p.scale + b * p.mod_stride;
    sh = p.shift + b * p.mod_stride;
  }
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + row * d;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int c = ((step * kParts + part) * 32 + lane) * kVec;
      if (!kFull && c >= d) continue;
      float g[kVec], bias[kVec], o[kVec];
      load4(p.weight + c, g);
      load4(p.bias + c, bias);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        o[i] = __fmaf_rn(g[i], rstd * (v[step][part][i] - mean), bias[i]);
      }
      if (kMod) {
        float s4[kVec], t4[kVec];
        load4(sc + c, s4);
        load4(sh + c, t4);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          // 1 + scale rounds to bf16, as the bf16 tensor sum does
          const float one_plus =
              __bfloat162float(__float2bfloat16_rn(s4[i] + 1.f));
          const float u = o[i] * one_plus + t4[i];
          o[i] = u / (1.f + expf(-u));
        }
      }
      uint2 out;
      *reinterpret_cast<__nv_bfloat162*>(&out.x) =
          __floats2bfloat162_rn(o[0], o[1]);
      *reinterpret_cast<__nv_bfloat162*>(&out.y) =
          __floats2bfloat162_rn(o[2], o[3]);
      *reinterpret_cast<uint2*>(y + c) = out;
    }
  }
}

template <typename T, int kSteps, bool kFull>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      (p.rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (p.scale != nullptr) {
    layer_norm_kernel<T, true, kSteps, kFull>
        <<<blocks, kThreads, 0, stream>>>(p);
  } else {
    layer_norm_kernel<T, false, kSteps, kFull>
        <<<blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// kSteps = ceil(d / 512): a thread's vectors
template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static_assert(kMaxSteps == 2, "one instance a step count");
  constexpr int kStep = kTorchThreads * kVec;
  if (p.d == kStep) return launch<T, 1, true>(p, stream);
  if (p.d == 2 * kStep) return launch<T, 2, true>(p, stream);
  return p.d < kStep ? launch<T, 1, false>(p, stream)
                     : launch<T, 2, false>(p, stream);
}

// ------------------------------------------------------- memory_norms

// This lane's rstd * (x - mean) of a row in chunks of kChunk columns,
// chunk c at columns (c * 32 + lane) * kChunk; chunks past d are left
// unset.
template <typename T, int kSteps, bool kFull, int kChunk>
__device__ __forceinline__ void normalized_row(const T* x, int lane, int d,
                                               float eps, float* xh) {
  const int vecs = d / kVec;
  float v[kSteps][kParts][kVec];
  load_row<T, kSteps, kFull>(x, lane, vecs, v);
  float mean, rstd;
  row_stats<kSteps, kFull>(v, lane, vecs, d, eps, mean, rstd);
  constexpr int kChunks = kSteps * kTorchThreads * kVec / 32 / kChunk;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * 32 + lane) * kChunk;
    if (!kFull && col >= d) continue;
#pragma unroll
    for (int i = 0; i < kChunk; i += kVec) {
      float t[kVec];
      load4(x + col + i, t);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        xh[c * kChunk + i + j] = rstd * (t[j] - mean);
      }
    }
  }
}

__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&t);
}

// kChunk bf16 of fma(w, xh, b) at y: one 16-byte store (8-byte for 4)
template <int kChunk>
__device__ __forceinline__ void store_affine(__nv_bfloat16* y,
                                             const float* w,
                                             const float* xh,
                                             const float* b) {
  float o[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) o[i] = __fmaf_rn(w[i], xh[i], b[i]);
  if constexpr (kChunk == 8) {
    *reinterpret_cast<uint4*>(y) =
        make_uint4(bf16x2(o[0], o[1]), bf16x2(o[2], o[3]),
                   bf16x2(o[4], o[5]), bf16x2(o[6], o[7]));
  } else {
    *reinterpret_cast<uint2*>(y) =
        make_uint2(bf16x2(o[0], o[1]), bf16x2(o[2], o[3]));
  }
}

// One warp a task: kTaskRows / kSteps rows of one stream; kFull as in
// layer_norm_kernel, kChunk 8 (4 where d is not a multiple of 8).
// Two blocks an SM at D <= 512 (at most 128 registers a thread).
template <int kSteps, bool kFull, int kChunk>
__global__ void __launch_bounds__(kThreads, 3 - kSteps)
    memory_norms_kernel(const __grid_constant__ MemParams p) {
  constexpr int kElems = kSteps * kTorchThreads * kVec / 32;
  constexpr int kChunks = kElems / kChunk;
  constexpr int kRows = kTaskRows / kSteps;
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (task >= p.task_start[p.streams]) return;
  int s = 0;
  while (task >= p.task_start[s + 1]) ++s;
  const int d = kFull ? kSteps * kTorchThreads * kVec : p.d;
  const long long real_rows = p.seg[s][0].rows;
  const long long r0 = (task - p.task_start[s]) * kRows;
  const long long left = real_rows + p.seg[s][1].rows - r0;
  const int n = left < kRows ? static_cast<int>(left) : kRows;
  float xh[kRows][kElems];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k >= n) continue;
    const long long r = r0 + k;
    const int unc = r >= real_rows;
    const MemSegment& g = p.seg[s][unc];
    const long long i = unc ? r - real_rows : r;
    const long long off = (i / g.x_inner) * g.x_outer + (i % g.x_inner) * d;
    if (g.x_bf16) {
      normalized_row<__nv_bfloat16, kSteps, kFull, kChunk>(
          static_cast<const __nv_bfloat16*>(g.x) + off, lane, d, p.eps,
          xh[k]);
    } else {
      normalized_row<float, kSteps, kFull, kChunk>(
          static_cast<const float*>(g.x) + off, lane, d, p.eps, xh[k]);
    }
  }
  __nv_bfloat16* y =
      static_cast<__nv_bfloat16*>(p.y) + (p.out_row[s] + r0) * d;
  for (int layer = 0; layer < p.layers; ++layer) {
    const float* wp = p.weight[layer * p.streams + s];
    const float* bp = p.bias[layer * p.streams + s];
    float w[kElems], b[kElems];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * 32 + lane) * kChunk;
      if (!kFull && col >= d) continue;
#pragma unroll
      for (int i = 0; i < kChunk; i += kVec) {
        load4(wp + col + i, w + c * kChunk + i);
        load4(bp + col + i, b + c * kChunk + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k >= n) continue;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = (c * 32 + lane) * kChunk;
        if (!kFull && col >= d) continue;
        store_affine<kChunk>(y + k * d + col, w + c * kChunk,
                             xh[k] + c * kChunk, b + c * kChunk);
      }
    }
    y += p.layer_rows * d;
  }
}

template <int kSteps, bool kFull, int kChunk>
cudaError_t launch_memory(const MemParams& p, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      (p.task_start[p.streams] + kRowsPerBlock - 1) / kRowsPerBlock);
  memory_norms_kernel<kSteps, kFull, kChunk>
      <<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.
extern "C" int layer_norm_params_bytes() {
  return static_cast<int>(sizeof(Params));
}

// Launches ceil(rows / 8) blocks of kThreads on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for no rows, a d that is
// not a positive multiple of kVec up to kMaxD, a non-positive x_inner or,
// with the epilogue, a non-positive rows_per_batch or batches.
extern "C" int layer_norm(Params p, void* stream) {
  if (p.rows <= 0 || p.d <= 0 || p.d % kVec != 0 || p.d > kMaxD ||
      p.x_inner <= 0 ||
      (p.scale != nullptr && (p.rows_per_batch <= 0 || p.batches <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.x_bf16 ? launch<__nv_bfloat16>(p, s)
                                   : launch<float>(p, s));
}

// Fills p.task_start (a stream's rows in tasks of kTaskRows / steps rows,
// steps = ceil(d / 512)) and launches ceil(tasks / 8) blocks of kThreads
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for
// streams not in 1..kMaxStreams, no layers or more than kMaxNorms affines,
// a d that layer_norm does not take, a negative row count, a segment with
// rows and a non-positive x_inner, or no rows.
extern "C" int memory_norms(MemParams p, void* stream) {
  if (p.streams < 1 || p.streams > kMaxStreams || p.layers < 1 ||
      p.layers * p.streams > kMaxNorms || p.d <= 0 || p.d % kVec != 0 ||
      p.d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kStep = kTorchThreads * kVec;
  const int rows = kTaskRows / (p.d > kStep ? 2 : 1);
  p.task_start[0] = 0;
  for (int s = 0; s < p.streams; ++s) {
    long long n = 0;
    for (const MemSegment& g : p.seg[s]) {
      if (g.rows < 0 || (g.rows > 0 && g.x_inner <= 0)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      n += g.rows;
    }
    p.task_start[s + 1] = p.task_start[s] + (n + rows - 1) / rows;
  }
  if (p.task_start[p.streams] == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.d == kStep) {
    err = launch_memory<1, true, 8>(p, st);
  } else if (p.d == 2 * kStep) {
    err = launch_memory<2, true, 8>(p, st);
  } else if (p.d % 8 == 0) {
    err = p.d < kStep ? launch_memory<1, false, 8>(p, st)
                      : launch_memory<2, false, 8>(p, st);
  } else {
    err = p.d < kStep ? launch_memory<1, false, 4>(p, st)
                      : launch_memory<2, false, 4>(p, st);
  }
  return static_cast<int>(err);
}

extern "C" int memory_norms_params_bytes() {
  return static_cast<int>(sizeof(MemParams));
}
