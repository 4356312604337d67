// The token-parallel bf16 Swin-block forward for Hopper (sm_90a), shared by
// the fast block that the window kernel does not take (csrc/swin_block_fast
// .cu: C above 120, or int8 qkv), the pair and RDSTB stage kernels that the
// window body does not take (csrc/swin_pair.cu, csrc/rdstb_block.cu: the
// same rule), and the forward of the training step's single block
// (csrc/block_train.cu, with its exact division and factor columns).
//
// Five kernels over all T = windows x n tokens: LN1 rows (bf16, or int8
// for the int8 qkv product), the qkv GEMM, attention per (window, head)
// with the approximate reciprocal (csrc/token_gemm.cuh), the projection
// with its residual and LN2, and fc1 + tanh GELU + fc2 + residual in one
// kernel with the bf16 output. The GEMMs are the persistent wgmma kernels
// of csrc/token_wgmma.cuh (TMA-fed, int8 qkv on wgmma .s8, epilogues on
// the accumulator registers, the hidden rows kept in shared memory).
// The block's input rows and its output rows go through the caller's row
// maps (`tokpar::Rows`) at the caller's row strides, so a stage reads the
// dense rows x0 | feats or the rolled windows of an image-layout scratch,
// and writes its rows at their image positions, without a relayout pass.
// `adapter` is the RDSTB's tail adapter on a stage's output: a GEMM C ->
// growth with the post-norm LN in a row-spanning epilogue (or, pre-norm,
// the LN(C) rows first), its rows scattered into the dense rows.
//
// What bounds it on an H100: the bytes of the token-major buffers between
// phases (the GEMMs' operations, 16C^2 + 4NC flops a token, take a third
// of that time or less).

#pragma once

#include "token_gemm.cuh"
#include "token_wgmma.cuh"

namespace tokfwd {

namespace tp = tokpar;
using fastblk::bf16;

constexpr int kFwdKernels = 5;  // kernels of one forward

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
// bf16(normalize(x)) rows, or with int8 qkv the rows quantized,
// clip(round(normalize(x) * kQX), +-127) (each product and the difference
// rounded on its own, round half to even, as kernels.quant.quant_rows);
// ld elements a row, zeros past c.
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

// The forward's buffers, carved from one workspace (256-byte aligned):
// LN1 rows (bf16 kp wide, or int8 kq wide), later LN2's rows; q/k/v by
// head; the attention output rows; x1 (f32, in the GEMM epilogues' own
// order, tokwg::x1_at). (The MLP's hidden rows stay in shared memory.)
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
  z.qkv = reinterpret_cast<bf16*>(take(T * d.n3 * 2));
  z.ao = reinterpret_cast<bf16*>(take(T * d.kp * 2));
  z.x1 = reinterpret_cast<float*>(take(tokwg::x1_floats(d.tokens, d.c) * 4));
  if (b) *b = z;
  return off;
}

// One block's operands: the kernels.swin_block.token_wgmma_layout order,
// every weight K-major [n][k] -- wqkv (n3, kp) bf16 by head, bqkv (n3)
// f32, wproj (kp, kp), bproj (c) bf16, w1 (hp, kp), bf1 (hidden) f32, w2
// (kp, hp), bf2 (c) bf16 -- the packed bias (bw, n, nh n), then the int8
// qkv weights (n3, kq) [n][k] and their steps (n3), both null for bf16
// qkv.
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
// windows of an image); softmax: the kernels' code. The training step's
// block (csrc/block_train.cu) adds its two differences: dpf, the (tokens,
// 2) stochastic-depth factor columns [attn, mlp] on the residual
// branches, and `exact`, the exact division of the softmax normalizer
// (the backward's recompute divides so too).
inline cudaError_t forward(const tp::Dims& d, const RowsIn& in, bf16* out,
                           tp::Rows orow, int ldo, const BlockW& w, int bw,
                           int softmax, const FwdBufs& b, cudaStream_t s,
                           const float* dpf = nullptr, bool exact = false) {
  const int T = d.tokens, kp = d.kp;
  const int kq = fastblk::round_up(d.c, 32);
  bf16* xn = static_cast<bf16*>(b.xin);
  if (w.wq) {
    ln1_rows_kernel<true><<<(T + 7) / 8, 256, 0, s>>>(in, b.xin, d, kq);
    TOKFWD_CHECK(cudaGetLastError());
    TOKFWD_CHECK(tokwg::qkv(b.xin, w.wq, kq, d.c,
                            tokwg::EpiQkv{b.qkv, w.ws, w.bqkv, T, d.n3}, s));
  } else {
    ln1_rows_kernel<false><<<(T + 7) / 8, 256, 0, s>>>(in, b.xin, d, kp);
    TOKFWD_CHECK(cudaGetLastError());
    TOKFWD_CHECK(tokwg::qkv(xn, w.wqkv, kp, d.c,
                            tokwg::EpiQkv{b.qkv, nullptr, w.bqkv, T, d.n3},
                            s));
  }
  const tp::AttnSmem al = tp::attn_smem(d, false);
  auto attn =
      exact ? &tp::attn_fwd_kernel<false> : &tp::attn_fwd_kernel<true>;
  TOKFWD_CHECK(cudaFuncSetAttribute(
      attn, cudaFuncAttributeMaxDynamicSharedMemorySize, al.bytes));
  attn<<<d.windows * d.nh, tp::kAttnThreads, al.bytes, s>>>(
      tp::Attn{d, b.qkv, w.bias, bw, softmax, b.ao});
  TOKFWD_CHECK(cudaGetLastError());
  // LN2's rows take the LN1 rows' place
  TOKFWD_CHECK(tokwg::proj_ln(
      b.ao, w.wproj,
      tokwg::EpiProjLn{in.x, in.xr, in.ldx, d.n, w.bproj, b.x1, xn, T, d.c,
                       kp, dpf},
      s));
  return tokwg::mlp(xn, kp, w.w1, w.w2, d.hp,
                    tokwg::MlpEpi{w.bf1, b.x1, w.bf2, out, orow, ldo, d.n, T,
                                  d.c, d.hidden, dpf},
                    s);
}

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

// The adapter on the block output z (d.tokens rows of kz bf16): pre-norm
// first normalizes z into zn (same shape), then one GEMM with the row
// epilogue. 1 or 2 launches, each checked.
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
  return tokwg::adapter(
      a, kz, w.w, d.c,
      tokwg::EpiAdapter{w.b, w.gamma, w.beta, dense, orow, d.n, ld, col,
                        growth, T, prenorm ? 1 : 0},
      s);
}

#undef TOKFWD_CHECK

}  // namespace tokfwd
