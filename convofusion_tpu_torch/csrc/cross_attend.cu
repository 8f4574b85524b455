// The guided denoiser's grouped single-head cross-attention core for one
// condition stream of one layer, both guidance variants in one launch.
//
// Replaces no TPU kernel: the JAX package leaves TransformerDecoderLayer2Att
// .guided's attention to XLA.  It replaces the port's plain sequence
// (ops/cross_attend.py::cross_attend_reference): index_select of the real
// and of the uncond branch rows out of q_all, per variant q k^T, the scale,
// the padding fill, the fp32 softmax, the bf16 cast and P v, and two
// index_copy_ back, ~17 kernels a (layer, stream) and 765 a guided step at
// the published geometry.  Per query row, in the plain path's rounding:
//   s = bf16(q . k)                         fp32 sums (the bf16 GEMM)
//   s = bf16(float(s) * (1 / bf16(sqrt D)))  (CUDA's division by a scalar)
//   s = bf16(-1e9) at padded keys           not -inf: a fully padded row is
//                                           uniform, as in the plain path
//   p = bf16(softmax(float(s)))             fp32 over the whole row, in the
//                                           order of PyTorch's warp softmax
//   o = bf16(p . v)                         fp32 sums
// The module builds with -fmad=false and no fast math: expf, and x / sum
// as div_softmax computes it.
//
// Bound: bytes.  Per stream and layer the core reads q_all (G, B, Tq, D) and
// the real K/V (B, Tk, D) x 2 and writes out (G, B, Tq, D); the batch-1
// uncond K/V is read once from DRAM.  At (7, 32, 16, 512) and the five
// streams' Tk 64, 161, 64, 8, 1 that is ~56 MB a layer, 17 us at 3.35 TB/s;
// the products are ~2.2 GFLOP a layer.  The design:
//   * No gather, no scatter.  A block takes up to kRows query rows that
//     share one K/V: rows of one K/V batch row b of a variant (the real
//     variant, or an uncond K/V of batch B), or a tile of the rows of all
//     uncond branches against a batch-1 K/V, which stays in L2 for its
//     tiles.  It reads each row straight from q_all by the variant's branch
//     list and writes it straight to the same row of out.
//   * The whole logits row in shared memory (Tk is a few hundred at most),
//     so the softmax is two passes over it, not an online softmax whose
//     rescaling rounds differently.  The full-condition branch's weights
//     are written by the block that computes them.
//   * kRows = 32 rows a block: 112 blocks at the published geometry, one
//     wave on the 132 SMs, and every warp busy in every phase.
//   * Products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//     sums): q k^T over K chunks of kKeyChunk keys, the warp's q fragments
//     held in registers across the chunks (the kernel is built for the
//     published width, D = 512) and each tile's sum split into kChains
//     independent chains so that the products' latency overlaps; P v over
//     column passes of kCols.  q, K and V stream into shared memory with
//     cp.async, kStages - 1 K chunks or the next V pass in flight while
//     the current one is used.
//   * The softmax takes all of a warp's rows side by side with no branch on
//     a row, so that their reductions' shuffles and exponentials overlap;
//     the padding mask is copied into shared memory once, and each output
//     tile leaves through shared memory as whole 16-byte row pieces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // ops/cross_attend.py THREADS
constexpr int kD = 512;          // the model width (D_MODEL): q's fragments
                                 // live in registers, a width's worth
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;        // query rows a block (ROWS)
constexpr int kMTiles = kRows / 16;            // 16-row mma tiles
constexpr int kSplit = kWarps / kMTiles;       // warps sharing an m-tile
constexpr int kKeyChunk = 32;    // keys a K chunk, and the key padding
constexpr int kStages = 3;       // K chunks in shared memory (STAGES)
constexpr int kChains = 4;       // q k^T partial sums a tile, k-steps mod 4
constexpr int kRowsPerWarp = kRows / kWarps;   // softmax rows, at once
constexpr int kCols = 128;       // output columns a pass of P v (COLS)
constexpr int kWarpCols = kCols / kSplit;      // a warp's columns a pass
static_assert(kChains == 4, "the q k^T epilogue adds four partial sums");
static_assert(kKeyChunk / kSplit == 8, "a warp takes one n-tile of a chunk");
static_assert(kWarpCols % 16 == 0, "P v takes n-tiles in pairs");
constexpr int kPad = 8;          // bf16 of row padding in shared memory
constexpr int kMaxBranches = 8;

}  // namespace

// The same fields, in the same order, as ops/cross_attend.py::_CVariant
// and _CParams; passed by value.
struct Variant {
  const __nv_bfloat16* k;      // (kv_batch, tk, d) rows, k_rstride apart
  const __nv_bfloat16* v;
  const unsigned char* mask;   // (mask_batch, tk) bool, true = pad; or null
  long long k_bstride, k_rstride, v_bstride, v_rstride, m_bstride;
  int kv_batch, mask_batch, tk, n_branches;
  int att_branch;              // whose weights go to att, or -1
  int tiles;                   // row tiles a K/V batch row
  int blocks;                  // kv_batch * tiles
  int branches[kMaxBranches];  // the variant's branches, ascending
};

struct Params {
  const __nv_bfloat16* q;      // (g, b, tq, d) contiguous
  __nv_bfloat16* out;          // (g, b, tq, d) contiguous
  __nv_bfloat16* att;          // (b, tq, var[0].tk) contiguous
  int b, tq, d;
  float inv_scale;             // fp32 1 / bf16(sqrt d)
  Variant var[2];              // real, uncond
};

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes (all of them at 0)
// are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one 16 x 8 tile, k 16: bf16 in, fp32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e / s for e in [0, 1] and s >= 1 (a softmax's exponential and sum): the
// quotient through the rounded reciprocal, corrected by one exact residual,
// which is IEEE division's result in all but rare cases, with no slow path
// and no branch.
__device__ __forceinline__ float div_softmax(float e, float s, float inv) {
  const float q = __fmul_rn(e, inv);
  return __fmaf_rn(__fmaf_rn(-q, s, e), inv, q);
}

__global__ void __launch_bounds__(kThreads)
    cross_attend_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int q_rows[kRows];          // row of q_all / out, or -1
  __shared__ int att_rows[kRows];        // row of att, or -1
  __shared__ long long mask_rows[kRows]; // offset of the row's mask, or -1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool real = static_cast<int>(blockIdx.x) < p.var[0].blocks;
  // a copy, each field a select of two parameter loads
  const Variant vr = real ? p.var[0] : p.var[1];
  const int blk = real ? blockIdx.x : blockIdx.x - p.var[0].blocks;
  const int kb = blk / vr.tiles, tile = blk - kb * vr.tiles;
  const int per = p.b / vr.kv_batch;   // query batch rows a K/V row serves
  const int span = per * p.tq;         // rows of one branch here
  const int row0 = tile * kRows;
  const int n_active = min(kRows, vr.n_branches * span - row0);
  const int tk = vr.tk;
  constexpr int d = kD;
  const int tkp = (tk + kKeyChunk - 1) / kKeyChunk * kKeyChunk;

  // shared memory: the logits, then the weights, kRows x ldS bf16; the
  // padding mask, kRows x tkp bytes; then the stage area, which holds q
  // and kStages K chunks, later two V passes and an output tile
  const int ldS = tkp + kPad, ldV = kCols + kPad;
  constexpr int ldQ = kD + kPad;
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* sM = reinterpret_cast<unsigned char*>(sS + kRows * ldS);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sM + kRows * tkp);
  __nv_bfloat16* sQ = stage;
  __nv_bfloat16* sK = sQ + kRows * ldQ;
  __nv_bfloat16* sV = stage;
  __nv_bfloat16* sO = sV + 2 * tkp * ldV;
  const __nv_bfloat16* kbase = vr.k + kb * vr.k_bstride;
  const __nv_bfloat16* vbase = vr.v + kb * vr.v_bstride;

  // a warp copies rows, a lane 16 bytes at a time; keys past tk are zeros
  auto load_k = [&](int chunk, int buf) {
    __nv_bfloat16* dst = sK + buf * kKeyChunk * ldQ;
    for (int r = warp; r < kKeyChunk; r += kWarps) {
      const int key = chunk * kKeyChunk + r;
      const bool ok = key < tk;
      const __nv_bfloat16* src = kbase + (ok ? key * vr.k_rstride : 0);
      for (int c = lane * 8; c < d; c += 32 * 8) {
        cp_async16(dst + r * ldQ + c, src + c, ok ? 16 : 0);
      }
    }
  };
  auto load_v = [&](int pass, int buf) {
    __nv_bfloat16* dst = sV + buf * tkp * ldV;
    const int c = (lane & 15) * 8;
    for (int r = warp * 2 + (lane >> 4); r < tkp; r += kWarps * 2) {
      const bool ok = r < tk;
      cp_async16(dst + r * ldV + c,
                 vbase + (ok ? r * vr.v_rstride + pass * kCols + c : 0),
                 ok ? 16 : 0);
    }
  };
  load_k(0, 0);                          // needs no row table

  if (tid < kRows) {
    int q_row = -1, att_row = -1;
    long long m_row = -1;
    if (tid < n_active) {
      const int r = row0 + tid;
      const int gi = r / span, rem = r - gi * span;
      const int bb = kb * per + rem / p.tq, t = rem % p.tq;
      int g = 0;
#pragma unroll
      for (int i = 0; i < kMaxBranches; ++i) {
        if (i == gi) g = vr.branches[i];   // no indexed parameter array
      }
      q_row = (g * p.b + bb) * p.tq + t;
      if (g == vr.att_branch) att_row = bb * p.tq + t;
      if (vr.mask != nullptr) {
        m_row = (vr.mask_batch == 1 ? 0 : bb) * vr.m_bstride;
      }
    }
    q_rows[tid] = q_row;
    att_rows[tid] = att_row;
    mask_rows[tid] = m_row;
  }
  __syncthreads();

  // ---- 1. s = q k^T, scaled and filled, into sS as bf16
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = q_rows[r];
    const __nv_bfloat16* src =
        p.q + (row < 0 ? 0 : static_cast<long long>(row) * d);
    for (int c = lane * 8; c < d; c += 32 * 8) {
      cp_async16(sQ + r * ldQ + c, src + c, row < 0 ? 0 : 16);
    }
  }
  cp_async_commit();                     // group 0: K chunk 0 and q
  const int n_chunks = tkp / kKeyChunk;
  for (int c = 1; c < kStages - 1; ++c) {
    if (c < n_chunks) load_k(c, c);
    cp_async_commit();
  }
  if (vr.mask != nullptr) {              // the rows' masks, while q lands
    // a warp's rows and four keys a lane loaded before any is stored, so
    // that the loads' latencies overlap
    for (int base = lane; base < tk; base += 32 * 4) {
      unsigned char m[kRowsPerWarp][4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const long long m_row = mask_rows[warp + i * kWarps];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = base + 32 * u;
          m[i][u] = m_row >= 0 && key < tk ? vr.mask[m_row + key] : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = base + 32 * u;
          if (key < tk) sM[(warp + i * kWarps) * tkp + key] = m[i][u];
        }
      }
    }
  }
  // each iteration issues chunk c + kStages - 1 (an empty group past the
  // last) and waits for chunk c
  const int mi = warp % kMTiles;         // the warp's 16-row m-tile
  const int nq = warp / kMTiles;         // and its 8 keys of a chunk
  const bool m_active = mi * 16 < n_active;
  const __nv_bfloat16 big_neg = __float2bfloat16_rn(-1e9f);
  unsigned qf[kD / 16][4];
  for (int c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) {
      load_k(c + kStages - 1, (c + kStages - 1) % kStages);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (c == 0 && m_active) {
      // the m-tile's q, all of D, as mma A fragments: read from shared
      // memory once, not once a chunk
      const __nv_bfloat16* a_ptr =
          sQ + (mi * 16 + (lane & 15)) * ldQ + (lane >> 4) * 8;
#pragma unroll
      for (int k = 0; k < kD / 16; ++k) ldmatrix_x4(qf[k], a_ptr + 16 * k);
    }
    if (m_active) {
      // kChains independent sums (k-steps mod kChains), added in fp32 at
      // the end: the tensor cores' latency is not one chain of d / 16
      // products.  One ldmatrix gives the warp's 8 keys for two k-steps.
      float acc[kChains][4] = {};
      const __nv_bfloat16* b_ptr = sK + (c % kStages) * kKeyChunk * ldQ +
                                   (nq * 8 + (lane & 7)) * ldQ +
                                   (lane >> 3) * 8;
#pragma unroll
      for (int k = 0; k < kD / 16; k += 2) {
        unsigned b[4];
        ldmatrix_x4(b, b_ptr + 16 * k);
        mma(acc[k % kChains], qf[k], b[0], b[1]);
        mma(acc[(k + 1) % kChains], qf[k + 1], b[2], b[3]);
      }
      // rows past n_active and keys past tk are written too, and never
      // read as weights: no branch here; every load before any store
      __nv_bfloat16 val[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = mi * 16 + (lane >> 2) + (i >> 1) * 8;
        const int key = c * kKeyChunk + nq * 8 + (lane & 3) * 2 + (i & 1);
        const float dot = __fadd_rn(__fadd_rn(acc[0][i], acc[1][i]),
                                    __fadd_rn(acc[2][i], acc[3][i]));
        const __nv_bfloat16 l = __float2bfloat16_rn(dot);
        val[i] = __float2bfloat16_rn(
            __fmul_rn(__bfloat162float(l), p.inv_scale));
        if (vr.mask != nullptr && sM[row * tkp + key]) val[i] = big_neg;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mi * 16 + (lane >> 2) + h * 8;
        const int key = c * kKeyChunk + nq * 8 + (lane & 3) * 2;
        __nv_bfloat162 pair;
        pair.x = val[h * 2];
        pair.y = val[h * 2 + 1];
        *reinterpret_cast<__nv_bfloat162*>(sS + row * ldS + key) = pair;
      }
    }
    __syncthreads();
  }

  // the first V pass streams in while the softmax runs
  load_v(0, 0);
  cp_async_commit();

  // ---- 2. p = softmax(s) in fp32, kRowsPerWarp rows a warp side by side,
  // so that their loads, exponentials and shuffles overlap; no branch on a
  // row (rows past n_active compute what is never stored).  PyTorch's warp
  // softmax for rows of up to 1,024: `width` lanes (the row's length rounded
  // up to a power of two, at most 32; the lanes past tk have nothing) each
  // take elements lane + it * width in order; max; a lane's sum of
  // exp(x - max) from 0 in that order, then the xor butterfly (lanes past
  // `width` add zeros, which changes no bit); x / sum.
  int width = 1;
  while (width < tk && width < 32) width <<= 1;
  float mx[kRowsPerWarp], sum[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    mx[r] = -INFINITY;
    sum[r] = 0.0f;
  }
  for (int idx = lane; idx < tk; idx += width) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      mx[r] = fmaxf(mx[r], __bfloat162float(
                               sS[(warp + r * kWarps) * ldS + idx]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    }
  }
  for (int idx = lane; idx < tk; idx += width) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      sum[r] = __fadd_rn(sum[r], expf(__fsub_rn(__bfloat162float(
                   sS[(warp + r * kWarps) * ldS + idx]), mx[r])));
    }
  }
  float inv[kRowsPerWarp];
  int att_row[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], off));
    }
    inv[r] = __frcp_rn(sum[r]);
    att_row[r] = att_rows[warp + r * kWarps];
  }
  for (int idx = lane; idx < tkp; idx += 32) {
    const bool in_row = idx < tk;
    __nv_bfloat16 w[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float e = expf(__fsub_rn(
          __bfloat162float(sS[(warp + r * kWarps) * ldS + idx]), mx[r]));
      w[r] = __float2bfloat16_rn(in_row ? div_softmax(e, sum[r], inv[r])
                                        : 0.0f);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      sS[(warp + r * kWarps) * ldS + idx] = w[r];
    }
    if (in_row) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (att_row[r] >= 0) {
          p.att[static_cast<long long>(att_row[r]) * tk + idx] = w[r];
        }
      }
    }
  }

  // ---- 3. o = p v, kCols output columns a pass; warp (mi, cq) takes rows
  // mi * 16.. and kWarpCols columns of the pass, through sO to whole-row
  // stores
  const int n_pass = d / kCols;
  const int cq = warp / kMTiles;
  const int ldO = kCols + kPad;
  for (int pass = 0; pass < n_pass; ++pass) {
    if (pass + 1 < n_pass) {
      load_v(pass + 1, (pass + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (m_active) {
      float acc[kWarpCols / 8][4] = {};
      const __nv_bfloat16* a_ptr =
          sS + (mi * 16 + (lane & 15)) * ldS + (lane >> 4) * 8;
      const __nv_bfloat16* b_ptr = sV + (pass & 1) * tkp * ldV +
                                   (lane & 15) * ldV + cq * kWarpCols +
                                   (lane >> 4) * 8;
      for (int ks = 0; ks < tkp; ks += 16) {
        unsigned a[4];
        ldmatrix_x4(a, a_ptr + ks);
#pragma unroll
        for (int j = 0; j < kWarpCols / 16; ++j) {
          unsigned b[4];
          ldmatrix_x4_trans(b, b_ptr + ks * ldV + j * 16);
          mma(acc[2 * j], a, b[0], b[1]);
          mma(acc[2 * j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* dst = sO + (mi * 16 + (lane >> 2) + h * 8) * ldO +
                             cq * kWarpCols + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < kWarpCols / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(acc[j][h * 2], acc[j][h * 2 + 1]);
        }
      }
    }
    __syncthreads();
    // a warp stores two rows of the pass at a time, 16 bytes a lane
    for (int r = warp * 2 + (lane >> 4); r < n_active; r += kWarps * 2) {
      const int c = (lane & 15) * 8;
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(q_rows[r]) * d +
                                pass * kCols + c) =
          *reinterpret_cast<const uint4*>(sO + r * ldO + c);
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface for ctypes.
extern "C" int cross_attend_params_bytes() {
  return static_cast<int>(sizeof(Params));
}

// Lets the kernel take up to `bytes` of dynamic shared memory; once, before
// any launch (and outside any stream capture).
extern "C" int cross_attend_init(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      cross_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes));
}

// Launches p.var[0].blocks + p.var[1].blocks blocks with `shared_bytes` of
// dynamic shared memory (ops/cross_attend.py::shared_bytes) on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue where p.d is not
// kD.
extern "C" int cross_attend(Params p, int shared_bytes, void* stream) {
  if (p.d != kD) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = p.var[0].blocks + p.var[1].blocks;
  cross_attend_kernel<<<blocks, kThreads, shared_bytes,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
