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
// kernel with the bf16 output. The int8 'proj' and 'mlp' groups
// (kernels.quant) add phases: their inputs take a dynamic scale, the amax
// of a whole scale group of tokens (the windows one program of the JAX
// kernel holds), which must be known before the first token is quantized:
// * 'proj': the attention writes float32 rows and its groups' amax (an
//   atomicMax on the float bits, one slot a group), a pass quantizes them
//   to int8 rows, the projection runs on wgmma .s8 (6 kernels);
// * 'mlp': LN2's rows leave the projection's epilogue as int8 at the
//   static step; fc1 on wgmma .s8 writes float32 h1 = gelu(...) and its
//   groups' amax, a pass quantizes h1, fc2 on wgmma .s8 adds bias and
//   residual (the fused MLP's one kernel becomes three). The hidden rows
//   go through device memory here (about 120 MB at bucket 64 for C = 180
//   to 192), where the bf16 MLP keeps them in shared memory: a tile's fc2
//   needs its group's amax, which only the whole group's fc1 gives. The
//   other way, fc1 run twice (once for the amax, again fused with fc2),
//   saves those bytes and is left to a later design.
// The GEMMs are the persistent wgmma kernels of csrc/token_wgmma.cuh
// (TMA-fed, int8 products on wgmma .s8, epilogues on the accumulator
// registers, the bf16 MLP's hidden rows kept in shared memory).
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
// The int8 groups of a forward that take a dynamic scale
// (kernels.swin_block.int8_mask).
constexpr int kInt8Proj = 1, kInt8Mlp = 2;

// kernels of one forward with the int8 groups of `mask`
__host__ __device__ inline int fwd_kernels(int mask) {
  return kFwdKernels + ((mask & kInt8Proj) ? 1 : 0) +
         ((mask & kInt8Mlp) ? 2 : 0);
}

struct FwdBufs {
  void* xin;
  bf16* qkv;
  bf16* ao;
  float* x1;
  // the int8 'proj' / 'mlp' phases (mask): float32 rows of the attention
  // output or of h1 (the wider), h1's int8 rows, the amax bits of each
  // scale group (gw windows) of the attention output, then of h1
  float* f32 = nullptr;
  int8_t* h1q = nullptr;
  unsigned* amax = nullptr;
  int gw = 0, groups = 0, mask = 0;
};

// The forward's workspace; with int8 groups `mask` (and gw windows a scale
// group) their buffers after the others.
inline long long carve_fwd(const tp::Dims& d, char* base, FwdBufs* b,
                           int gw = 0, int mask = 0) {
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
  z.ao = reinterpret_cast<bf16*>(take(T * d.kp * 2));  // and its int8 rows
  z.x1 = reinterpret_cast<float*>(take(tokwg::x1_floats(d.tokens, d.c) * 4));
  if (mask && gw > 0) {
    const int wide = (mask & kInt8Mlp) && d.hidden > d.c ? d.hidden : d.c;
    z.f32 = reinterpret_cast<float*>(take(T * wide * 4));
    if (mask & kInt8Mlp)
      z.h1q = reinterpret_cast<int8_t*>(
          take(T * fastblk::round_up(d.hidden, 32)));
    z.gw = gw;
    z.groups = (d.windows + gw - 1) / gw;
    z.mask = mask;
    z.amax = reinterpret_cast<unsigned*>(take(2LL * z.groups * 4));
  }
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
  // int8 'mlp' (kernels.swin_block.int8_token_layout): w1q (hidden, kq)
  // [n][k] and its steps w1s (hidden), w2q (c, kh) [n][k] and w2s (c);
  // int8 'proj': wpq (c, kq) [n][k] and wps (c); kq = c, kh = hidden, each
  // rounded up to 32; null where the group is off
  const int8_t* w1q = nullptr;
  const float* w1s = nullptr;
  const int8_t* w2q = nullptr;
  const float* w2s = nullptr;
  const int8_t* wpq = nullptr;
  const float* wps = nullptr;
  // the groups the block's operands hold (kInt8Proj | kInt8Mlp)
  int mask() const {
    return (wpq ? kInt8Proj : 0) | (w1q ? kInt8Mlp : 0);
  }
};

constexpr int kBlockPtrs = 17;  // pointers of one BlockW

inline BlockW block_w(const void* const* p) {
  BlockW w{static_cast<const bf16*>(p[0]),
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
  w.w1q = static_cast<const int8_t*>(p[11]);
  w.w1s = static_cast<const float*>(p[12]);
  w.w2q = static_cast<const int8_t*>(p[13]);
  w.w2s = static_cast<const float*>(p[14]);
  w.wpq = static_cast<const int8_t*>(p[15]);
  w.wps = static_cast<const float*>(p[16]);
  return w;
}

// Whether a block's pointers are whole: each int8 group's weight and steps
// both there or both null.
inline bool block_w_ok(const void* const* p) {
  return !p[9] == !p[10] && !p[11] == !p[12] && !p[11] == !p[13] &&
         !p[11] == !p[14] && !p[15] == !p[16];
}

// The attention with int8 'proj': o = (e v) rcp(den) (float32, the JAX
// kernel's `acc`) into (tokens, c) rows, and the amax of each scale group
// (gw windows) into amax[window / gw], one atomicMax a warp.
__global__ void __launch_bounds__(tp::kAttnThreads)
    attn_f32_kernel(const tp::Attn a, float* out, unsigned* amax, int gw) {
  extern __shared__ __align__(16) char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const tp::Dims& d = a.d;
  const tp::AttnSmem L = tp::attn_smem(d, false);
  const int win = blockIdx.x / d.nh, h = blockIdx.x - win * d.nh;
  const size_t t0 = static_cast<size_t>(win) * d.n;
  tp::load_qkv(a, sm, L, win, h);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  if (r0 >= d.n) return;
  tp::AttnRows R;
  tp::attn_rows<true>(a, sm, L, win, h, r0, R);
  const int gr = lane >> 2, t4 = lane & 3;
  float* o0 = out + (t0 + r0 + gr) * d.c + h * d.hd;
  float* o1 = o0 + static_cast<size_t>(8) * d.c;
  float mx = 0.f;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dd = dt * 8 + 2 * t4 + e;
      if (dd < d.hd) {
        o0[dd] = R.o[dt][e];
        o1[dd] = R.o[dt][2 + e];
        mx = fmaxf(mx, fmaxf(fabsf(R.o[dt][e]), fabsf(R.o[dt][2 + e])));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) atomicMax(amax + win / gw, __float_as_uint(mx));
}

// float32 rows (tokens, cols; lds a row) -> int8 rows (ldd a row, zeros
// past cols) at each row's group scale 127 / amax (gtok rows a group;
// _quant_dyn: round half to even, clip at +-127), a warp a row.
__global__ void __launch_bounds__(256)
    quant_rows_kernel(const float* src, int lds, int cols, int8_t* dst,
                      int ldd, const unsigned* amax, int gtok, int tokens) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= tokens) return;
  const float s =
      __fdiv_rn(127.f, fmaxf(__uint_as_float(amax[m / gtok]), 1e-30f));
  const float* row = src + static_cast<size_t>(m) * lds;
  int8_t* out = dst + static_cast<size_t>(m) * ldd;
  for (int o = lane; o < ldd; o += 32)
    out[o] = o < cols ? tokwg::quant8(row[o], s) : 0;
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
//
// The block's int8 'proj' / 'mlp' operands (w.mask()) must be the groups
// the buffers were carved for (b.mask), their dynamic scales taken over
// each b.gw windows; the training step's block has neither.
inline cudaError_t forward(const tp::Dims& d, const RowsIn& in, bf16* out,
                           tp::Rows orow, int ldo, const BlockW& w, int bw,
                           int softmax, const FwdBufs& b, cudaStream_t s,
                           const float* dpf = nullptr, bool exact = false) {
  const int T = d.tokens, kp = d.kp;
  const int kq = fastblk::round_up(d.c, 32);
  bf16* xn = static_cast<bf16*>(b.xin);
  const int mask = w.mask();
  if (mask != b.mask || (mask && (dpf || exact || b.gw <= 0 ||
                                  d.windows % b.gw)))
    return cudaErrorInvalidValue;
  if (mask)
    TOKFWD_CHECK(cudaMemsetAsync(b.amax, 0, 2ull * b.groups * 4, s));
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
  if (mask & kInt8Proj) {
    // o in float32 with its groups' amax, then int8 rows in the place of
    // the bf16 attention output
    TOKFWD_CHECK(cudaFuncSetAttribute(
        attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        al.bytes));
    attn_f32_kernel<<<d.windows * d.nh, tp::kAttnThreads, al.bytes, s>>>(
        tp::Attn{d, b.qkv, w.bias, bw, softmax, nullptr}, b.f32, b.amax,
        b.gw);
    TOKFWD_CHECK(cudaGetLastError());
    quant_rows_kernel<<<(T + 7) / 8, 256, 0, s>>>(
        b.f32, d.c, d.c, reinterpret_cast<int8_t*>(b.ao), kq, b.amax,
        b.gw * d.n, T);
    TOKFWD_CHECK(cudaGetLastError());
  } else {
    auto attn =
        exact ? &tp::attn_fwd_kernel<false> : &tp::attn_fwd_kernel<true>;
    TOKFWD_CHECK(cudaFuncSetAttribute(
        attn, cudaFuncAttributeMaxDynamicSharedMemorySize, al.bytes));
    attn<<<d.windows * d.nh, tp::kAttnThreads, al.bytes, s>>>(
        tp::Attn{d, b.qkv, w.bias, bw, softmax, b.ao});
    TOKFWD_CHECK(cudaGetLastError());
  }
  if (!mask) {
    // LN2's rows take the LN1 rows' place
    TOKFWD_CHECK(tokwg::proj_ln(
        b.ao, w.wproj,
        tokwg::EpiProjLn{in.x, in.xr, in.ldx, d.n, w.bproj, b.x1, xn, T, d.c,
                         kp, dpf},
        s));
    return tokwg::mlp(xn, kp, w.w1, w.w2, d.hp,
                      tokwg::MlpEpi{w.bf1, b.x1, w.bf2, out, orow, ldo, d.n,
                                    T, d.c, d.hidden, dpf},
                      s);
  }
  // LN2's rows (bf16, or int8 for int8 'mlp') take the LN1 rows' place
  const bool qp = mask & kInt8Proj, qm = mask & kInt8Mlp;
  int8_t* x1q = static_cast<int8_t*>(b.xin);
  TOKFWD_CHECK(tokwg::proj_ln_q(
      qp ? static_cast<const void*>(b.ao) : b.ao, qp ? kq : kp,
      qp ? static_cast<const void*>(w.wpq) : w.wproj,
      tokwg::EpiProjLnQ{in.x, in.xr, in.ldx, d.n, w.bproj, qp ? w.wps : nullptr,
                        b.amax, b.gw * d.n, b.x1, qm ? nullptr : xn, kp,
                        qm ? x1q : nullptr, kq, T, d.c},
      s));
  if (!qm)
    return tokwg::mlp(xn, kp, w.w1, w.w2, d.hp,
                      tokwg::MlpEpi{w.bf1, b.x1, w.bf2, out, orow, ldo, d.n,
                                    T, d.c, d.hidden, nullptr},
                      s);
  unsigned* hmax = b.amax + b.groups;
  const int kh = fastblk::round_up(d.hidden, 32);
  TOKFWD_CHECK(tokwg::fc1_s8(
      x1q, kq, w.w1q, d.c,
      tokwg::EpiFc1{w.bf1, w.w1s, b.f32, hmax, b.gw * d.n, T, d.hidden}, s));
  quant_rows_kernel<<<(T + 7) / 8, 256, 0, s>>>(
      b.f32, d.hidden, d.hidden, b.h1q, kh, hmax, b.gw * d.n, T);
  TOKFWD_CHECK(cudaGetLastError());
  return tokwg::fc2_s8(
      b.h1q, kh, w.w2q, d.hidden,
      tokwg::EpiFc2{w.bf2, w.w2s, b.x1, hmax, b.gw * d.n, out, orow, ldo,
                    d.n, T, d.c},
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
