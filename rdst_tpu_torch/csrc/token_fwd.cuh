// The token-parallel bf16 Swin-block forward for Hopper (sm_90a), shared by
// the fast block above the window body's widths (csrc/swin_block_fast.cu)
// and the pair and RDSTB stage kernels that the window body does not take
// (csrc/swin_pair.cu, csrc/rdstb_block.cu: C above 120, or int8 qkv).
//
// Six kernels over all T = windows x n tokens, built from the pieces of
// csrc/token_gemm.cuh: LN1 rows (bf16, or int8 for the int8 qkv product),
// the qkv GEMM (bf16 mma.sync m16n8k16, or int8 m16n8k32 with an int32
// accumulator), attention per (window, head) with the approximate
// reciprocal, the projection with its residual and LN2 in one row-spanning
// tile, fc1 with the tanh GELU, fc2 with the residual and the bf16 output.
// The block's input rows and its output rows go through the caller's row
// maps (`tokpar::Rows`) at the caller's row strides, so a stage reads the
// dense rows x0 | feats or the rolled windows of an image-layout scratch,
// and writes its rows at their image positions, without a relayout pass.
// `adapter` is the RDSTB's tail adapter on a stage's output: a GEMM C ->
// growth with the post-norm LN in a row-spanning epilogue (or, pre-norm,
// the LN(C) rows first), its rows scattered into the dense rows.
//
// What bounds it on an H100: operations for the GEMMs (16C^2 + 4NC flops a
// token), the bytes of the token-major buffers between phases for the rest.

#pragma once

#include "token_gemm.cuh"

namespace tokfwd {

namespace tp = tokpar;
using fastblk::bf16;

// The serving GEMMs run three blocks an SM (tiles at most 128 wide, so
// fewer registers than the backward's two) and launch the N tiles of one
// A tile together (blockIdx.x walks them), so A is read from device
// memory once.
constexpr int kMinB = 3;
constexpr int kFwdKernels = 6;  // kernels of one forward

// A block's input rows: token m at row xr(m, n) of x, ldx elements a row
// (its first c are the token). Where copy is set, LN1's pass also copies
// each token's c values to the same row of copy (ldcopy a row) and zeros
// that row's columns [zero_from, ldcopy).
struct RowsIn {
  const bf16* x;
  tp::Rows xr;
  int ldx;
  bf16* copy;
  int ldcopy, zero_from;
};

inline RowsIn rows_in(const bf16* x, tp::Rows xr, int ldx) {
  return RowsIn{x, xr, ldx, nullptr, 0, 0};
}

constexpr tp::Rows kSameRows{0, 0, 0, 0, 0};  // token m at row m

// LN1 of every token, a warp per token (one-pass moments, eps 1e-5):
// bf16(normalize(x)) rows, or with int8 qkv the rows quantized as
// fastblk::quantize_rows does (each product and the difference rounded on
// its own, round half to even); ld elements a row, zeros past c.
template <bool kInt8>
__global__ void __launch_bounds__(256)
    ln1_rows_kernel(const RowsIn in, void* dst, const tp::Dims d, int ld) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= d.tokens) return;
  const size_t row = in.xr(m, d.n);
  const bf16* xr = in.x + row * in.ldx;
  float v[6], s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = lane + 32 * i;
    v[i] = o < d.c ? tp::ldb(xr + o) : 0.f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  if (in.copy) {
    bf16* cr = in.copy + row * in.ldcopy;
    for (int o = lane; o < d.c; o += 32) cr[o] = xr[o];
    for (int o = in.zero_from + lane; o < in.ldcopy; o += 32)
      cr[o] = __float2bfloat16_rn(0.f);
  }
  s = fastblk::warp_sum(s);
  s2 = fastblk::warp_sum(s2);
  const float mu = s / d.c;
  const float a = rsqrtf(fmaxf(s2 / d.c - mu * mu, 0.f) + fastblk::kEps);
  if (kInt8) {
    int8_t* out = static_cast<int8_t*>(dst) + static_cast<size_t>(m) * ld;
    const float ma = __fmul_rn(mu, a);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int o = lane + 32 * i;
      if (o < d.c) {
        const float xn = __fsub_rn(__fmul_rn(v[i], a), ma);
        const float q =
            fminf(fmaxf(rintf(__fmul_rn(xn, fastblk::kQX)), -127.f), 127.f);
        out[o] = static_cast<int8_t>(static_cast<int>(q));
      }
    }
    for (int o = d.c + lane; o < ld; o += 32) out[o] = 0;
  } else {
    bf16* out = static_cast<bf16*>(dst) + static_cast<size_t>(m) * ld;
    const float ma = mu * a;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int o = lane + 32 * i;
      if (o < d.c) out[o] = __float2bfloat16_rn(v[i] * a - ma);
    }
    for (int o = d.c + lane; o < ld; o += 32)
      out[o] = __float2bfloat16_rn(0.f);
  }
}

// C (M, N) = A (M, K) B^T with int8 operands and int32 sums (exact): A
// stored [M][K], B [N][K], rows of lda / ldb bytes (multiples of 16). 64 x
// BN tiles, 64 bytes of depth a stage in the cp.async ring of gemm_tile,
// mma.sync m16n8k32.s8; the sums are parked in shared memory as floats
// (exact: |sum| <= 127^2 K < 2^24 for K <= 1040) for the epilogue.
constexpr int kS8BK = 64;

template <int BN>
struct S8Tile {
  static constexpr int kLd = kS8BK + 16;  // bytes: conflict-free fragments
  static constexpr int kA = tp::kBM * kLd;
  static constexpr int kStage = kA + BN * kLd;
  static constexpr int kLdC = BN + 4;
  static constexpr int kPipe = tp::kStages * kStage;
  static constexpr int kSmem =
      kPipe > tp::kBM * kLdC * 4 ? kPipe : tp::kBM * kLdC * 4;
};

struct S8Args {
  const int8_t* a;
  const int8_t* b;
  int lda, ldb, M, N, K;
};

template <int BN, class Epi>
__global__ void __launch_bounds__(tp::kGemmThreads, kMinB)
    gemm_s8_kernel(const S8Args g, const Epi epi) {
  using L = S8Tile<BN>;
  constexpr int NT = BN / 32;  // n-tiles of 8 a warp
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.y * tp::kBM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3, wm = warp >> 2, wn = warp & 3;
  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  const int steps = (g.K + kS8BK - 1) / kS8BK;
  auto load = [&](int step, int stage) {
    char* As = smem + stage * L::kStage;
    char* Bs = As + L::kA;
    const int k0 = step * kS8BK;
    {
      const int r = tid >> 2, c16 = (tid & 3) * 16;  // 64 x 64 bytes
      const bool ok = m0 + r < g.M && k0 + c16 < g.K;
      tp::cp_async16(As + r * L::kLd + c16,
                     ok ? g.a + static_cast<size_t>(m0 + r) * g.lda + k0 + c16
                        : g.a,
                     ok);
    }
    for (int i = tid; i < BN * 4; i += tp::kGemmThreads) {
      const int r = i >> 2, c16 = (i & 3) * 16;
      const bool ok = n0 + r < g.N && k0 + c16 < g.K;
      tp::cp_async16(Bs + r * L::kLd + c16,
                     ok ? g.b + static_cast<size_t>(n0 + r) * g.ldb + k0 + c16
                        : g.b,
                     ok);
    }
  };
#pragma unroll
  for (int s = 0; s < tp::kStages - 1; ++s) {
    if (s < steps) load(s, s);
    tp::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tp::cp_async_wait<tp::kStages - 2>();
    __syncthreads();
    const int nxt = s + tp::kStages - 1;
    if (nxt < steps) load(nxt, nxt % tp::kStages);
    tp::cp_async_commit();
    const char* As = smem + (s % tp::kStages) * L::kStage;
    const char* Bs = As + L::kA;
#pragma unroll
    for (int kk = 0; kk < kS8BK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const char* p = As + (wm * 32 + mt * 16 + gr) * L::kLd + kk + 4 * t4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * L::kLd);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * L::kLd + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const char* q = Bs + (wn * (BN / 4) + nt * 8 + gr) * L::kLd + kk + 4 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          fastblk::mma16832s8(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2],
                              af[mt][3], b0, b1);
      }
    }
  }
  tp::cp_async_wait<0>();
  __syncthreads();
  float* ct = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * 32 + mt * 16 + gr;
      const int col = wn * (BN / 4) + nt * 8 + 2 * t4;
      ct[r * L::kLdC + col] = static_cast<float>(acc[mt][nt][0]);
      ct[r * L::kLdC + col + 1] = static_cast<float>(acc[mt][nt][1]);
      ct[(r + 8) * L::kLdC + col] = static_cast<float>(acc[mt][nt][2]);
      ct[(r + 8) * L::kLdC + col + 1] = static_cast<float>(acc[mt][nt][3]);
    }
  __syncthreads();
  epi.template run<BN>(ct, m0, n0);
}

// q, k, v = bf16(int32(xq Wq) * ws + bqkv) by head, each product and sum
// rounded on its own (as the window body's int8 epilogue)
struct EpiQkvS8 {
  bf16* qkv;          // (tokens, n3)
  const float* ws;    // (n3) by head
  const float* bqkv;  // (n3) by head
  int tokens, n3;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    tp::each_pair<BN>(ct, m0, n0, tokens, n3,
                      [&](int m, int j, float v0, float v1) {
                        tp::st_bf2(qkv + static_cast<size_t>(m) * n3 + j,
                                   __fadd_rn(__fmul_rn(v0, ws[j]), bqkv[j]),
                                   __fadd_rn(__fmul_rn(v1, ws[j + 1]),
                                             bqkv[j + 1]));
                      });
  }
};

// h = bf16(gelu_tanh(x1n W1 + bf1)), zeros past hidden
struct EpiFc1Serve {
  bf16* h;           // (tokens, hp)
  const float* bf1;  // (hidden)
  int tokens, hidden, hp;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    tp::each_pair<BN>(
        ct, m0, n0, tokens, hp, [&](int m, int j, float v0, float v1) {
          tp::st_bf2(h + static_cast<size_t>(m) * hp + j,
                     j < hidden ? fastblk::gelu_tanh(v0 + bf1[j]) : 0.f,
                     j + 1 < hidden ? fastblk::gelu_tanh(v1 + bf1[j + 1])
                                    : 0.f);
        });
  }
};

// out = bf16(x1 + (h W2 + bf2)) at row orow(m, n) of out (ldo a row,
// zeros in its columns [c, ldo))
struct EpiOut {
  const float* x1;  // (tokens, c)
  const bf16* bf2;  // (c)
  bf16* out;
  tp::Rows orow;
  int ldo, n, tokens, c, kp;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    tp::each_pair<BN>(ct, m0, n0, tokens, kp,
                      [&](int m, int j, float v0, float v1) {
                        const size_t at = static_cast<size_t>(m) * c + j;
                        bf16* o = out + orow(m, n) * ldo + j;
                        const float v[2] = {v0, v1};
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                          if (j + e < c)
                            o[e] = __float2bfloat16_rn(
                                x1[at + e] + (v[e] + tp::ldb(bf2 + j + e)));
                          else if (j + e < ldo)
                            o[e] = __float2bfloat16_rn(0.f);
                        }
                      });
  }
};

// The tile width of least padding for N columns, the wider on a tie.
inline int fit_bn(int n, const int* widths, int count) {
  int best = widths[0];
  for (int i = 1; i < count; ++i) {
    const int w = widths[i];
    if ((n + w - 1) / w * w < (n + best - 1) / best * best) best = w;
  }
  return best;
}

template <bool TA, bool TB, class Epi>
inline cudaError_t run_fit(const tp::GemmArgs& g, const Epi& epi,
                           cudaStream_t s) {
  static const int widths[] = {128, 64};
  if (fit_bn(g.N, widths, 2) == 128)
    return tp::run_gemm<128, TA, TB, Epi, kMinB, true>(g, epi, s);
  return tp::run_gemm<64, TA, TB, Epi, kMinB, true>(g, epi, s);
}

template <int BN, class Epi>
inline cudaError_t run_s8(const S8Args& g, const Epi& epi, cudaStream_t s) {
  constexpr int smem = S8Tile<BN>::kSmem;
  auto kernel = gemm_s8_kernel<BN, Epi>;
  // set where it launches: the attribute belongs to this library's kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + tp::kBM - 1) / tp::kBM);
  kernel<<<grid, tp::kGemmThreads, smem, s>>>(g, epi);
  return cudaGetLastError();
}

template <class Epi>
inline cudaError_t run_s8_fit(const S8Args& g, const Epi& epi,
                              cudaStream_t s) {
  static const int widths[] = {128, 96, 64};
  switch (fit_bn(g.N, widths, 3)) {
    case 128: return run_s8<128>(g, epi, s);
    case 96: return run_s8<96>(g, epi, s);
    default: return run_s8<64>(g, epi, s);
  }
}

// The forward's buffers, carved from one workspace (256-byte aligned):
// LN1 rows (bf16 kp wide, or int8 kq wide), later LN2's rows; q/k/v by
// head, later the MLP hidden rows; the attention output rows; x1 (f32).
struct FwdBufs {
  void* xin;
  bf16* qkv;
  bf16* ao;
  float* x1;
};

inline long long carve_fwd(const tp::Dims& d, char* base, FwdBufs* b) {
  const long long T = d.tokens;
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  FwdBufs z;
  z.xin = take(T * d.kp * 2);  // holds the int8 rows too: kq <= 2 kp
  z.qkv = reinterpret_cast<bf16*>(take(T * (d.n3 > d.hp ? d.n3 : d.hp) * 2));
  z.ao = reinterpret_cast<bf16*>(take(T * d.kp * 2));
  z.x1 = reinterpret_cast<float*>(take(T * d.c * 4));
  if (b) *b = z;
  return off;
}

// One block's operands: the kernels.swin_block.token_layout order --
// wqkv (kp, n3) bf16 [k][n] by head, bqkv (n3) f32, wproj (kp, kp), bproj
// (c) bf16, w1 (kp, hp), bf1 (hidden) f32, w2 (hp, kp), bf2 (c) bf16 --
// the packed bias (bw, n, nh n), then the int8 qkv weights (n3, kq) [n][k]
// and their steps (n3), both null for bf16 qkv.
struct BlockW {
  const bf16* wqkv;
  const float* bqkv;
  const bf16* wproj;
  const bf16* bproj;
  const bf16* w1;
  const float* bf1;
  const bf16* w2;
  const bf16* bf2;
  const bf16* bias;
  const int8_t* wq;
  const float* ws;
};

constexpr int kBlockPtrs = 11;  // pointers of one BlockW

inline BlockW block_w(const void* const* p) {
  return BlockW{static_cast<const bf16*>(p[0]),
                static_cast<const float*>(p[1]),
                static_cast<const bf16*>(p[2]),
                static_cast<const bf16*>(p[3]),
                static_cast<const bf16*>(p[4]),
                static_cast<const float*>(p[5]),
                static_cast<const bf16*>(p[6]),
                static_cast<const bf16*>(p[7]),
                static_cast<const bf16*>(p[8]),
                static_cast<const int8_t*>(p[9]),
                static_cast<const float*>(p[10])};
}

#define TOKFWD_CHECK(expr)                  \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

// One block over d.tokens tokens: kFwdKernels launches on s, each checked.
// Token m reads in's row in.xr(m, n) and writes bf16 row orow(m, n) of out
// (ldo a row; zeros in its columns [c, ldo)). bw: bias windows (1, or the
// windows of an image); softmax: the kernels' code.
inline cudaError_t forward(const tp::Dims& d, const RowsIn& in, bf16* out,
                           tp::Rows orow, int ldo, const BlockW& w, int bw,
                           int softmax, const FwdBufs& b, cudaStream_t s) {
  const int T = d.tokens, kp = d.kp, hp = d.hp, n3 = d.n3;
  const int kq = fastblk::round_up(d.c, 32);
  bf16* xn = static_cast<bf16*>(b.xin);
  if (w.wq) {
    ln1_rows_kernel<true><<<(T + 7) / 8, 256, 0, s>>>(in, b.xin, d, kq);
    TOKFWD_CHECK(cudaGetLastError());
    TOKFWD_CHECK(run_s8_fit(
        S8Args{static_cast<const int8_t*>(b.xin), w.wq, kq, kq, T, n3, kq},
        EpiQkvS8{b.qkv, w.ws, w.bqkv, T, n3}, s));
  } else {
    ln1_rows_kernel<false><<<(T + 7) / 8, 256, 0, s>>>(in, b.xin, d, kp);
    TOKFWD_CHECK(cudaGetLastError());
    TOKFWD_CHECK((run_fit<false, true>(
        tp::gemm_args(xn, nullptr, kp, w.wqkv, nullptr, n3, T, n3, kp),
        tp::EpiQkv{b.qkv, w.bqkv, T, n3}, s)));
  }
  const tp::AttnSmem al = tp::attn_smem(d, false);
  TOKFWD_CHECK(cudaFuncSetAttribute(
      tp::attn_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      al.bytes));
  tp::attn_fwd_kernel<true><<<d.windows * d.nh, tp::kAttnThreads, al.bytes,
                              s>>>(
      tp::Attn{d, b.qkv, w.bias, bw, softmax, b.ao});
  TOKFWD_CHECK(cudaGetLastError());
  // LN2's rows take the LN1 rows' place, the hidden rows q/k/v's
  TOKFWD_CHECK((tp::run_rows<false, true, tp::EpiProjLn, kMinB>(
      tp::gemm_args(b.ao, nullptr, kp, w.wproj, nullptr, kp, T, kp, kp),
      tp::EpiProjLn{d, in.x, in.xr, w.bproj, nullptr, 0, 0, b.x1, xn, nullptr,
                    in.ldx},
      s)));
  TOKFWD_CHECK((run_fit<false, true>(
      tp::gemm_args(xn, nullptr, kp, w.w1, nullptr, hp, T, hp, kp),
      EpiFc1Serve{b.qkv, w.bf1, T, d.hidden, hp}, s)));
  return run_fit<false, true>(
      tp::gemm_args(b.qkv, nullptr, hp, w.w2, nullptr, kp, T, kp, hp),
      EpiOut{b.x1, w.bf2, out, orow, ldo, d.n, T, d.c, kp}, s);
}

// The RDSTB's tail adapter on T rows (a row-spanning tile, a warp per row):
// a = acc + bad over the growth channels; post-norm: bf16(LN(a) * gad +
// bbad) (two-pass moments, eps 1e-5), pre-norm: bf16(a); into row
// orow(m, n) of dense (ld a row) at columns [col, col + growth).
struct EpiAdapter {
  const float* bad;   // (ng)
  const float* gad;   // (growth)
  const float* bbad;  // (growth)
  bf16* dense;
  tp::Rows orow;
  int n, ld, col, growth, tokens, prenorm;
  template <int BN>
  __device__ void run(const float* ct, int m0, int) const {
    constexpr int ldc = BN + 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < tp::kBM; r += blockDim.x >> 5) {
      const int m = m0 + r;
      if (m >= tokens) break;
      const float* row = ct + r * ldc;
      bf16* dst = dense + orow(m, n) * ld + col;
      if (prenorm) {
        for (int i = lane; i < growth; i += 32)
          dst[i] = __float2bfloat16_rn(row[i] + bad[i]);
        continue;
      }
      float s = 0.f;
      for (int i = lane; i < growth; i += 32) s += row[i] + bad[i];
      const float mu = fastblk::warp_sum(s) / growth;
      float v = 0.f;
      for (int i = lane; i < growth; i += 32) {
        const float q = (row[i] + bad[i]) - mu;
        v += q * q;
      }
      const float rs = rsqrtf(fastblk::warp_sum(v) / growth + fastblk::kEps);
      for (int i = lane; i < growth; i += 32)
        dst[i] = __float2bfloat16_rn(((row[i] + bad[i]) - mu) * rs * gad[i] +
                                     bbad[i]);
    }
  }
};

// The adapter's operands: its weight (growth, kz) bf16 [n][k] (the Dense
// transposed, zero past c; pre-norm: the LN(C) affine folded in), its bias
// (ng) f32, the post-norm LN scale and bias (growth) f32.
struct AdapterW {
  const bf16* w;
  const float* b;
  const float* gamma;
  const float* beta;
};

constexpr int kAdapterPtrs = 4;

inline AdapterW adapter_w(const void* const* p) {
  return AdapterW{static_cast<const bf16*>(p[0]),
                  static_cast<const float*>(p[1]),
                  static_cast<const float*>(p[2]),
                  static_cast<const float*>(p[3])};
}

// The adapter on the block output z (d.tokens rows of kz bf16, zeros past
// c): pre-norm first normalizes z into zn (same shape), then one GEMM with
// the row epilogue. 1 or 2 launches, each checked.
inline cudaError_t adapter(const tp::Dims& d, const bf16* z, int kz,
                           bf16* zn, bool prenorm, const AdapterW& w,
                           int growth, bf16* dense, tp::Rows orow, int ld,
                           int col, cudaStream_t s) {
  const int T = d.tokens;
  const bf16* a = z;
  if (prenorm) {
    ln1_rows_kernel<false><<<(T + 7) / 8, 256, 0, s>>>(
        rows_in(z, kSameRows, kz), zn, d, kz);
    TOKFWD_CHECK(cudaGetLastError());
    a = zn;
  }
  return tp::run_rows<false, false, EpiAdapter, kMinB>(
      tp::gemm_args(a, nullptr, kz, w.w, nullptr, kz, T, growth, kz),
      EpiAdapter{w.b, w.gamma, w.beta, dense, orow, d.n, ld, col, growth, T,
                 prenorm ? 1 : 0},
      s);
}

#undef TOKFWD_CHECK

}  // namespace tokfwd
