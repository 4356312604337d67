// Whole Swin transformer block, float32, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/swin_block.py::fused_swin_block (Pallas,
// `_fused_swin_block_jit` -> `_block_kernel` -> the precise f32 branch of
// `_body`). Per window of N tokens it computes
//
//   LN1 -> qkv -> per-head W-MSA with rel-pos bias (+ shift mask),
//   max-subtracted softmax with exact division -> proj -> +residual
//   -> LN2 -> fc1 -> erf GELU -> fc2 -> +residual
//
// on window-layout tokens (B*nW, N, C); the caller does the roll, window
// partition and reverse. LayerNorm is two-pass (mean subtracted before the
// variance), eps 1e-5, as in the JAX precise path.
//
// What bounds it on an H100: operations. A block does 16C^2 + 4NC flops a
// token (C = 60/90/120 on the main path) and moves its (N, C) input and
// output. On the CUDA cores (67 TFLOP/s f32 FMA) that is ~0.2 ms a launch
// at bucket 64; one TF32 product alone keeps ~11 mantissa bits and breaks
// the 1e-4 agreement.
//
// What the design does about it:
//  * The four projections run on the tensor cores as 3xTF32: each operand
//    x is split as big = tf32_rna(x), small = tf32_rna(x - big) (about 22
//    of f32's 24 mantissa bits together), and a product accumulates
//    small*big' + big*small' + big*big' in f32 (`mma.sync m16n8k8 tf32`),
//    dropping only small*small'. The weights are split once, when the plan
//    is made (kernels.swin_block.f32_kernel_layout); the activations as a
//    warp reads its fragments.
//  * The products are token-parallel: 64- or 128-token x BN tiles over
//    all T = windows x N tokens, a 3-stage cp.async ring for A and both
//    weight parts (one weight tile serves the tile's tokens), the
//    accumulator tile parked in shared memory for a fused epilogue: bias
//    and q scale; the residual and LN2 where one tile spans the row; the
//    erf GELU; the final residual.
//  * Attention per (window, head) on the CUDA cores in f32, with the sums
//    in the order of the per-window kernel this replaces: register tiles
//    of 4 x 8 scores and 4 x 4 outputs a thread, read as float4 from
//    transposed q, k and P, so a shared-memory load feeds 4-8 FMAs.
//  * The state between the six phases is token-major f32 rows in device
//    memory: LN1's rows (later LN2's), q/k/v (later the MLP hidden rows),
//    the attention output and the residual x1 (`carve`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 32;
constexpr int kMaxC = 192;       // the row kernels keep 6 values a lane
constexpr float kEps = 1e-5f;    // torch-default LayerNorm epsilon
// Softmax terms below exp(-80) (1.8e-35 of the row max) are set to 0: at
// exp(-87) and beyond, the term and its quotient by the row sum would be
// denormal and send expf and the IEEE division to their slow paths (the
// shift mask's -100 entries land there). The change to an output is
// below 1e-34 of its scale.
constexpr float kExpFloor = -80.0f;
constexpr int kKernels = 6;  // launches of one call

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One launch's geometry: row widths of the token-major buffers (multiples
// of 8 floats, zero past the data).
struct Dims {
  int windows, n, c, nh, hd, hidden, tokens, bw;
  int kp;  // C rows
  int n3;  // q/k/v rows: [q | k | v], C each
  int hp;  // hidden rows
  float scale;
};

inline Dims make_dims(const int* dims) {
  Dims d;
  d.windows = dims[0];
  d.n = dims[1];
  d.c = dims[2];
  d.nh = dims[3];
  d.hidden = dims[4];
  d.bw = dims[5];
  d.hd = d.nh > 0 ? d.c / d.nh : 0;
  d.tokens = d.windows * d.n;
  d.kp = round_up(d.c, 8);
  d.n3 = round_up(3 * d.c, 8);
  d.hp = round_up(d.hidden, 8);
  d.scale = d.hd > 0 ? static_cast<float>(1.0 / sqrt(static_cast<double>(d.hd)))
                     : 0.f;
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ 3xTF32 GEMM

constexpr int kBK = 16, kStages = 3, kGemmThreads = 256;

// Shared memory of one BM x BN tile: the ring of A (BM x kBK) and both
// weight parts (kBK x BN); strides chosen so that a warp's fragment loads
// hit 32 distinct banks. The accumulator tile (BM x BN f32, row stride BN
// + 4) reuses it.
template <int BM, int BN>
struct Tile {
  static constexpr int kLdA = kBK + 4;
  static constexpr int kA = BM * kLdA;
  static constexpr int kLdB = BN + 8;
  static constexpr int kB = kBK * kLdB;
  static constexpr int kStage = kA + 2 * kB;
  static constexpr int kLdC = BN + 4;
  static constexpr int kPipe = kStages * kStage * 4;
  static constexpr int kSmem =
      kPipe > BM * kLdC * 4 ? kPipe : BM * kLdC * 4;
};

// C (M, N) = A (M, K) B (K, N): A f32 at row stride lda, B as its tf32
// big and small parts ([K][N] at row stride ldb); strides multiples of 4.
struct Gemm {
  const float* a;
  const float* bh;
  const float* bl;
  int lda, ldb, M, N, K;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits cleared so the bits are the value's f32 pattern.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b: m16n8k8 tf32, f32 accumulation. a0: (row g, k t), a1: (row
// g+8, k t), a2: (row g, k t+4), a3: (row g+8, k t+4); b0: (k t, col g),
// b1: (k t+4, col g); d as the bf16 m16n8k16 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One BM x BN tile of C, then epi.run<BM, BN>(tile in shared memory, m0,
// n0). blockIdx.x walks the N tiles, so the blocks that read one A tile
// run together. Warps BM/32 (m) x 256/BM (n), each 32 rows x BN/(8 WN).
template <int BM, int BN, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
    gemm_kernel(const Gemm g, const Epi epi) {
  using L = Tile<BM, BN>;
  constexpr int WM = BM / 32, WN = 8 / WM;
  constexpr int NT = BN / (8 * WN);  // n-tiles of 8 a warp
  extern __shared__ __align__(16) float sm[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3, wm = warp / WN, wn = warp % WN;
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int steps = (g.K + kBK - 1) / kBK;

  auto load = [&](int step, int stage) {
    float* As = sm + stage * L::kStage;
    float* Bh = As + L::kA;
    float* Bl = Bh + L::kB;
    const int k0 = step * kBK;
    for (int i = tid; i < BM * (kBK / 4); i += kGemmThreads) {
      const int r = i >> 2, c4 = (i & 3) * 4;
      const bool ok = m0 + r < g.M && k0 + c4 < g.K;
      cp_async16(As + r * L::kLdA + c4,
                 ok ? g.a + static_cast<size_t>(m0 + r) * g.lda + k0 + c4
                    : g.a,
                 ok);
    }
    for (int i = tid; i < kBK * (BN / 4); i += kGemmThreads) {
      const int r = i / (BN / 4), c4 = (i - r * (BN / 4)) * 4;
      const bool ok = k0 + r < g.K && n0 + c4 < g.N;
      const size_t at = static_cast<size_t>(k0 + r) * g.ldb + n0 + c4;
      cp_async16(Bh + r * L::kLdB + c4, ok ? g.bh + at : g.bh, ok);
      cp_async16(Bl + r * L::kLdB + c4, ok ? g.bl + at : g.bl, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < steps) load(nxt, nxt % kStages);
    cp_async_commit();
    const float* As = sm + (s % kStages) * L::kStage;
    const float* Bh = As + L::kA;
    const float* Bl = Bh + L::kB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = As + (wm * 32 + mt * 16 + gr) * L::kLdA + kk + t4;
        split_tf32(p[0], ab[mt][0], as[mt][0]);
        split_tf32(p[8 * L::kLdA], ab[mt][1], as[mt][1]);
        split_tf32(p[4], ab[mt][2], as[mt][2]);
        split_tf32(p[8 * L::kLdA + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wn * (BN / WN) + nt * 8 + gr;
        const int r0 = (kk + t4) * L::kLdB + col, r1 = r0 + 4 * L::kLdB;
        const uint32_t h0 = __float_as_uint(Bh[r0]), h1 = __float_as_uint(Bh[r1]);
        const uint32_t l0 = __float_as_uint(Bl[r0]), l1 = __float_as_uint(Bl[r1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], as[mt], h0, h1);  // the small terms first
          mma_tf32(acc[mt][nt], ab[mt], l0, l1);
          mma_tf32(acc[mt][nt], ab[mt], h0, h1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * 32 + mt * 16 + gr;
      const int col = wn * (BN / WN) + nt * 8 + 2 * t4;
      sm[r * L::kLdC + col] = acc[mt][nt][0];
      sm[r * L::kLdC + col + 1] = acc[mt][nt][1];
      sm[(r + 8) * L::kLdC + col] = acc[mt][nt][2];
      sm[(r + 8) * L::kLdC + col + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  epi.template run<BM, BN>(sm, m0, n0);
}

// ------------------------------------------------------------ epilogues

// f(m, j, v) for the tile's runs of V columns j..j+V-1 (V values at v,
// 4V-byte aligned) with m < M, j < N (N a multiple of V)
template <int BM, int BN, int V, class F>
__device__ __forceinline__ void each(const float* ct, int m0, int n0, int M,
                                     int N, F f) {
  constexpr int ldc = BN + 4, per = BN / V;
  for (int i = threadIdx.x; i < BM * per; i += blockDim.x) {
    const int r = i / per, cc = (i - r * per) * V;
    const int m = m0 + r, j = n0 + cc;
    if (m < M && j < N) f(m, j, ct + r * ldc + cc);
  }
}

// q, k, v = xn Wqkv + bqkv, q times the head scale
struct EpiQkv {
  float* qkv;
  const float* bqkv;  // (n3), zeros past 3C
  int tokens, n3, c;
  float scale;
  template <int BM, int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    each<BM, BN, 4>(ct, m0, n0, tokens, n3, [&](int m, int j, const float* v) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = v[e] + bqkv[j + e];
        if (j + e < c) o[e] *= scale;
      }
      *reinterpret_cast<float4*>(qkv + static_cast<size_t>(m) * n3 + j) =
          make_float4(o[0], o[1], o[2], o[3]);
    });
  }
};

// x1 = x + (ao Wproj + bproj); x1n = LN2(x1) (a warp per row: one tile
// spans the row)
struct EpiProjLn {
  const float* x;
  const float* bproj;
  const float* g2;
  const float* b2;
  float* x1;   // (tokens, c)
  float* x1n;  // (tokens, kp)
  int tokens, c, kp;
  template <int BM, int BN>
  __device__ void run(const float* ct, int m0, int) const {
    constexpr int ldc = BN + 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += blockDim.x >> 5) {
      const int m = m0 + r;
      if (m >= tokens) break;
      const float* xr = x + static_cast<size_t>(m) * c;
      float v[6], s = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        v[i] = 0.f;
        if (o < c) {
          v[i] = xr[o] + (ct[r * ldc + o] + bproj[o]);  // residual 1
          s += v[i];
        }
      }
      const float mu = warp_sum(s) / c;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float dv = v[i] - mu;
        if (lane + 32 * i < c) q += dv * dv;
      }
      const float rstd = 1.0f / sqrtf(warp_sum(q) / c + kEps);
      float* x1r = x1 + static_cast<size_t>(m) * c;
      float* nr = x1n + static_cast<size_t>(m) * kp;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        if (o < c) {
          x1r[o] = v[i];
          nr[o] = (v[i] - mu) * rstd * g2[o] + b2[o];
        } else if (o < kp) {
          nr[o] = 0.f;
        }
      }
    }
  }
};

// h = erf GELU(x1n W1 + bf1), zeros past hidden
struct EpiFc1 {
  float* h;
  const float* bf1;
  int tokens, hidden, hp;
  template <int BM, int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    each<BM, BN, 4>(ct, m0, n0, tokens, hp, [&](int m, int j, const float* v) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = 0.f;
        if (j + e < hidden) {
          const float u = v[e] + bf1[j + e];
          o[e] = 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
        }
      }
      *reinterpret_cast<float4*>(h + static_cast<size_t>(m) * hp + j) =
          make_float4(o[0], o[1], o[2], o[3]);
    });
  }
};

// out = x1 + (h W2 + bf2)
struct EpiOut {
  const float* x1;
  const float* bf2;
  float* out;
  int tokens, c;
  template <int BM, int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    each<BM, BN, 2>(ct, m0, n0, tokens, c, [&](int m, int j, const float* v) {
      const size_t at = static_cast<size_t>(m) * c + j;  // c is even
      const float2 r = *reinterpret_cast<const float2*>(x1 + at);
      *reinterpret_cast<float2*>(out + at) =  // residual 2
          make_float2(r.x + (v[0] + bf2[j]), r.y + (v[1] + bf2[j + 1]));
    });
  }
};

template <int BM, int BN, class Epi>
inline cudaError_t run_gemm(const Gemm& g, const Epi& epi, cudaStream_t s) {
  constexpr int smem = Tile<BM, BN>::kSmem;
  auto kernel = gemm_kernel<BM, BN, Epi>;
  // set where it launches: the attribute belongs to this library's kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  kernel<<<grid, kGemmThreads, smem, s>>>(g, epi);
  return cudaGetLastError();
}

// The tile of least padding for g.N columns (the wider on a tie), of 128
// tokens where `tall` (a weight tile read from L2 then serves twice the
// tokens; faster for the qkv and fc1 products at C = 60-120 on an H100,
// slower for the narrower proj and fc2 below C = 120), else of 64; or,
// with `span`, the narrowest 64-token tile that spans the row.
template <class Epi>
inline cudaError_t run_fit(const Gemm& g, const Epi& epi, cudaStream_t s,
                           bool tall, bool span = false) {
  static const int widths[] = {192, 128, 96, 64};
  int best = tall ? 128 : 192;
  for (int w : widths) {
    if (tall && w > 128) continue;
    if (span ? w >= g.N
             : (g.N + w - 1) / w * w < (g.N + best - 1) / best * best)
      best = w;
  }
  if (tall) {
    switch (best) {
      case 128: return run_gemm<128, 128>(g, epi, s);
      case 96: return run_gemm<128, 96>(g, epi, s);
      default: return run_gemm<128, 64>(g, epi, s);
    }
  }
  switch (best) {
    case 192: return run_gemm<64, 192>(g, epi, s);
    case 128: return run_gemm<64, 128>(g, epi, s);
    case 96: return run_gemm<64, 96>(g, epi, s);
    default: return run_gemm<64, 64>(g, epi, s);
  }
}

// ------------------------------------------------------------ row kernels

// LN1 of every token, a warp per token: xn = (x - mu) rstd g1 + b1, kp
// wide, zeros past c.
__global__ void __launch_bounds__(256)
    ln1_kernel(const float* x, const float* g1, const float* b1, float* xn,
               int tokens, int c, int kp) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= tokens) return;
  const float* xr = x + static_cast<size_t>(m) * c;
  float v[6], s = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = lane + 32 * i;
    v[i] = o < c ? xr[o] : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float dv = v[i] - mu;
    if (lane + 32 * i < c) q += dv * dv;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(q) / c + kEps);
  float* nr = xn + static_cast<size_t>(m) * kp;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = lane + 32 * i;
    if (o < c)
      nr[o] = (v[i] - mu) * rstd * __ldg(g1 + o) + __ldg(b1 + o);
    else if (o < kp)
      nr[o] = 0.f;
  }
}

// ------------------------------------------------------------ attention

constexpr int kAttnThreads = 128;

struct AttnArgs {
  const float* qkv;   // (tokens, n3)
  const float* bias;  // (nh * bw, n, n), head-major
  float* ao;          // (tokens, kp)
  int n, c, nh, hd, n3, kp, bw;
};

// Shared memory of one (window, head), floats: q^T and k^T (hd rows of n
// + 4), v (n rows of hd rounded up to 4, zeros past hd), P^T (n rows of
// n + 4).
__host__ __device__ inline int attn_smem_bytes(int n, int hd) {
  return 4 * (2 * hd * (n + 4) + n * round_up(hd, 4) + n * (n + 4));
}

// One (window, head) of n tokens: s = q k^T + bias, max-subtracted
// softmax with exact division (terms below exp(kExpFloor) set to 0),
// o = p v; every sum in the order of the per-window kernel this replaces
// (over the head's channels, then the keys, ascending). A thread owns a
// 4 x 8 tile of the scores (row group t / (n/8), key group t % (n/8): a
// softmax row lies in n/8 neighbouring lanes), read as float4 from q^T
// and k^T; then a 4-row x 4-channel tile of o, read as float4 from P^T
// and v. Threads past the last row group (n < 64) work on row group 0
// and write nothing, so every lane takes part in the shuffles. Head 0
// also zeroes the rows' pad columns.
__global__ void __launch_bounds__(kAttnThreads)
    attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, ldn = n + 4, kgs = n / 8;
  const int hd = a.hd, hv = round_up(hd, 4);
  const int win = blockIdx.x / a.nh, h = blockIdx.x - win * a.nh;
  float* qt = sm;              // [hd][ldn]
  float* kt = qt + hd * ldn;   // [hd][ldn]
  float* v = kt + hd * ldn;    // [n][hv]
  float* pt = v + n * hv;      // [n][ldn]: P^T
  const size_t t0 = static_cast<size_t>(win) * n;
  for (int i = threadIdx.x; i < n * hv; i += blockDim.x) {
    const int r = i / hv, dd = i - r * hv;
    const float* src = a.qkv + (t0 + r) * a.n3 + h * hd + dd;
    if (dd < hd) {
      qt[dd * ldn + r] = src[0];
      kt[dd * ldn + r] = src[a.c];
    }
    v[r * hv + dd] = dd < hd ? src[2 * a.c] : 0.f;
  }
  if (h == 0) {
    const int pad = a.kp - a.c;
    for (int i = threadIdx.x; i < n * pad; i += blockDim.x)
      a.ao[(t0 + i / pad) * a.kp + a.c + i % pad] = 0.f;
  }
  __syncthreads();
  const int rg = threadIdx.x / kgs;
  const bool own = rg < n / 4;
  const int i0 = own ? 4 * rg : 0;         // 4 rows
  const int j0 = 8 * (threadIdx.x % kgs);  // 8 keys
  float s[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 8; ++u) s[r][u] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float4 q4 = *reinterpret_cast<const float4*>(qt + d * ldn + i0);
    const float4 k0 = *reinterpret_cast<const float4*>(kt + d * ldn + j0);
    const float4 k1 = *reinterpret_cast<const float4*>(kt + d * ldn + j0 + 4);
    const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
    const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 8; ++u) s[r][u] = fmaf(qv[r], kv[u], s[r][u]);
  }
  const float* bh = a.bias +
                    (static_cast<size_t>(h) * a.bw + win % a.bw) * n * n +
                    i0 * n + j0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bh + r * n));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bh + r * n + 4));
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float mx = -3.0e38f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s[r][u] += bv[u];
      mx = fmaxf(mx, s[r][u]);
    }
    for (int o = kgs / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float dv = s[r][u] - mx;
      s[r][u] = dv < kExpFloor ? 0.f : expf(dv);
      sum += s[r][u];
    }
    for (int o = kgs / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int u = 0; u < 8; ++u) s[r][u] = s[r][u] / sum;
  }
  if (own) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      *reinterpret_cast<float4*>(pt + (j0 + u) * ldn + i0) =
          make_float4(s[0][u], s[1][u], s[2][u], s[3][u]);
  }
  __syncthreads();
  // o: n/4 row groups x hv/4 channel groups
  const int rgs = n / 4;
  for (int item = threadIdx.x; item < rgs * (hv / 4); item += blockDim.x) {
    const int r0 = 4 * (item % rgs), d0 = 4 * (item / rgs);
    float o[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r][0] = o[r][1] = o[r][2] = o[r][3] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + j * ldn + r0);
      const float4 v4 = *reinterpret_cast<const float4*>(v + j * hv + d0);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][e] = fmaf(pv[r], vv[e], o[r][e]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* dst = a.ao + (t0 + r0 + r) * a.kp + h * hd + d0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < hd) dst[e] = o[r][e];
    }
  }
}

// ------------------------------------------------------------------ host

// The buffers of one call, carved from one workspace (each 256-byte
// aligned): LN1's rows (later LN2's), q/k/v (later the MLP hidden rows),
// the attention output, x1.
struct Bufs {
  float *xn, *qkv, *ao, *x1;
};

inline long long carve(const Dims& d, char* base, Bufs* b) {
  const long long T = d.tokens;
  long long off = 0;
  auto take = [&](long long floats) {
    float* p = base ? reinterpret_cast<float*>(base + off) : nullptr;
    off += (floats * 4 + 255) / 256 * 256;
    return p;
  };
  Bufs z;
  z.xn = take(T * d.kp);
  z.qkv = take(T * (d.n3 > d.hp ? d.n3 : d.hp));
  z.ao = take(T * d.kp);
  z.x1 = take(T * d.c);
  if (b) *b = z;
  return off;
}

// The geometry the kernels take: windows of n | 64 tokens with n % 8 ==
// 0, even C <= kMaxC, head dim <= kMaxHeadDim.
inline bool dims_ok(const Dims& d) {
  return d.n > 0 && 64 % d.n == 0 && d.n % 8 == 0 && d.c > 0 &&
         d.c % 2 == 0 && d.c <= kMaxC && d.nh > 0 && d.c % d.nh == 0 &&
         d.hd <= kMaxHeadDim && d.hidden > 0 && d.bw > 0 && d.windows >= 0 &&
         d.windows % d.bw == 0;
}

}  // namespace

extern "C" {

const char* swin_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Workspace bytes of one call (dims as swin_block_f32's).
long long swin_block_f32_work_bytes(const int* dims) {
  return carve(make_dims(dims), nullptr, nullptr);
}

// Kernels launched by one call.
int swin_block_f32_kernels() { return kKernels; }

// One block over `windows` windows: kKernels launches on `stream`, each
// checked; returns a cudaError_t (0 on success). ptrs: x, out, then the
// kernels.swin_block.f32_kernel_layout order -- wqkv big, small (kp, n3),
// bqkv (n3), wproj big, small (kp, kp), bproj (c), g1, b1, g2, b2 (c), w1
// big, small (kp, hp), bf1 (hidden), w2 big, small (hp, kp), bf2 (c) --
// the head-major bias (nh * bias_windows, n, n), the workspace. dims:
// windows, n, c, nh, hidden, bias_windows.
int swin_block_f32(const void* const* ptrs, const int* dims, int device,
                   void* stream) {
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || d.windows == 0) return static_cast<int>(err);
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  const float* x = f(0);
  float* out = const_cast<float*>(f(1));
  Bufs b;
  carve(d, static_cast<char*>(const_cast<void*>(ptrs[19])), &b);
  const int T = d.tokens;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RDST_CHECK(expr)                                  \
  do {                                                    \
    err = (expr);                                         \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
  ln1_kernel<<<(T + 7) / 8, 256, 0, s>>>(x, f(8), f(9), b.xn, T, d.c, d.kp);
  RDST_CHECK(cudaGetLastError());
  RDST_CHECK(run_fit(Gemm{b.xn, f(2), f(3), d.kp, d.n3, T, d.n3, d.kp},
                     EpiQkv{b.qkv, f(4), T, d.n3, d.c, d.scale}, s, true));
  const int asmem = attn_smem_bytes(d.n, d.hd);
  RDST_CHECK(cudaFuncSetAttribute(
      attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, asmem));
  attn_kernel<<<d.windows * d.nh, kAttnThreads, asmem, s>>>(
      AttnArgs{b.qkv, f(18), b.ao, d.n, d.c, d.nh, d.hd, d.n3, d.kp, d.bw});
  RDST_CHECK(cudaGetLastError());
  // LN2's rows take LN1's place, the hidden rows q/k/v's
  RDST_CHECK(run_fit(Gemm{b.ao, f(5), f(6), d.kp, d.kp, T, d.kp, d.kp},
                     EpiProjLn{x, f(7), f(10), f(11), b.x1, b.xn, T, d.c,
                               d.kp},
                     s, false, true));
  RDST_CHECK(run_fit(Gemm{b.xn, f(12), f(13), d.kp, d.hp, T, d.hp, d.kp},
                     EpiFc1{b.qkv, f(14), T, d.hidden, d.hp}, s, true));
  RDST_CHECK(run_fit(Gemm{b.qkv, f(15), f(16), d.hp, d.kp, T, d.kp, d.hp},
                     EpiOut{b.x1, f(17), out, T, d.c}, s, false));
#undef RDST_CHECK
  return 0;
}

}  // extern "C"
