// Token-parallel pieces of the bf16 Swin block for Hopper (sm_90a), shared
// by the serving forward (csrc/swin_block_fast.cu) and the training
// backward (csrc/block_bwd.cuh, which recomputes the same forward):
//
//  * the token-major geometry (`Dims`) and the caller's row maps (`Rows`);
//  * a tensor-core GEMM over all T = windows x n tokens (`gemm_tile`: 64 x
//    BN tiles, BK = 32, a 3-stage cp.async ring, ldmatrix + mma.sync
//    m16n8k16 bf16, f32 accumulation), whose accumulator tile is parked in
//    shared memory for a fused epilogue (`gemm_kernel`, `run_gemm`,
//    `run_rows` where one tile spans a whole row);
//  * the forward epilogues both use: q/k/v by head (`EpiQkv`), and the
//    projection with its residual and LN2's statistics (`EpiProjLn`);
//  * attention per (window, head), 4 warps of 16 query rows, q/k/v in
//    shared memory padded to 16 channels (`attn_rows`, `attn_fwd_kernel`):
//    the scores, the softmax variant and P V in registers; the serving
//    forward takes the approximate reciprocal of the normalizer
//    (`kApprox`), the backward's recompute divides exactly.
//
// What bounds these on an H100: operations for the GEMMs, the bytes of the
// token-major buffers between phases for the rest. A window's own products
// are too small for the tensor cores (64 tokens, heads of 10-30 channels),
// so every product here runs over the whole launch's tokens.

#pragma once

#include "fast_block.cuh"

namespace tokpar {

using fastblk::bf16;
using fastblk::round_up;

constexpr int kChunkTokens = 1024;  // tokens of one weight-gradient partial

// Widths of the token-major buffers. A C-wide buffer has rows of kp =
// round_up(c + 1, 16) elements: column c holds ones in the activations
// (the bias-gradient column), the rest of the padding zeros; likewise hp
// for the hidden width. q/k/v rows hold each head in hdg = round_up(hd,
// 8) channels (16-byte rows per head).
struct Dims {
  int windows, n, c, nh, hidden, tokens;
  int hd, hdg, hds;  // head width; in the q/k/v rows; in shared memory
  int kp, hp, n3;
  int chunks;        // token chunks of the weight-gradient products
};

__host__ __device__ inline Dims make_dims(int windows, int n, int c, int nh,
                                          int hidden) {
  Dims d;
  d.windows = windows;
  d.n = n;
  d.c = c;
  d.nh = nh;
  d.hidden = hidden;
  d.tokens = windows * n;
  d.hd = c / nh;
  d.hdg = round_up(d.hd, 8);
  d.hds = round_up(d.hd, 16);
  d.kp = round_up(c + 1, 16);
  d.hp = round_up(hidden + 1, 16);
  d.n3 = 3 * nh * d.hdg;
  d.chunks = (d.tokens + kChunkTokens - 1) / kChunkTokens;
  return d;
}

// Where token t (window t / n, row t % n) of a block's window order lives
// in a caller's tensor: the same row (window layout), or the rolled image
// position of the pair's relayout (image layout (images, ih, iw, c)).
struct Rows {
  int img, ih, iw, ws, shift;
  __device__ __forceinline__ size_t operator()(int t, int n) const {
    if (!img) return static_cast<size_t>(t);
    const int win = t / n, r = t - win * n;
    const int nww = iw / ws, nw = (ih / ws) * nww;
    const int im = win / nw, wi = win - im * nw;
    const int yy = ((wi / nww) * ws + shift + r / ws) % ih;
    const int xx = ((wi % nww) * ws + shift + r % ws) % iw;
    return (static_cast<size_t>(im) * ih + yy) * iw + xx;
  }
};

__device__ __forceinline__ float ldb(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float rb(float v) {
  return fastblk::round_bf16(v);
}

// ------------------------------------------------ fragments (ldmatrix)

__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A operand (16 x 16 at rows m0, depth k0) of mma16816 from a matrix
// stored [m][k] (frag_a) or [k][m] (frag_at) at row stride ld.
__device__ __forceinline__ void frag_a(uint32_t* r, const bf16* s, int ld,
                                       int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(r, s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}

__device__ __forceinline__ void frag_at(uint32_t* r, const bf16* s, int ld,
                                        int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4t(r, s + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + m0 +
                ((l >> 3) & 1) * 8);
}

// Two B operands (n-tiles n0 and n0 + 8, depth 16 at k0): r[0..1] and
// r[2..3], from a matrix stored [n][k] (frag_b) or [k][n] (frag_bt).
__device__ __forceinline__ void frag_b(uint32_t* r, const bf16* s, int ld,
                                       int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4(r, s + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 +
               ((l >> 3) & 1) * 8);
}

__device__ __forceinline__ void frag_bt(uint32_t* r, const bf16* s, int ld,
                                        int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm4t(r, s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  fastblk::mma16816(d, a[0], a[1], a[2], a[3], b0, b1);
}

// A operand (16 x 16, depth k = 16 kk..) from accumulator tiles 2kk, 2kk+1
// (rows g, g + 8; columns 2t, 2t + 1 of each 8-wide tile), as bf16.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* t0,
                                         const float* t1) {
  a[0] = fastblk::pack2(t0[0], t0[1]);
  a[1] = fastblk::pack2(t0[2], t0[3]);
  a[2] = fastblk::pack2(t1[0], t1[1]);
  a[3] = fastblk::pack2(t1[2], t1[3]);
}

__device__ __forceinline__ void st_bf2(bf16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = fastblk::pack2(v0, v1);
}

// ---------------------------------------------------------------- GEMM

constexpr int kBM = 64, kBK = 32, kStages = 3, kGemmThreads = 256;

// C (M, N) = sum over segments s of A_s (M, K) B_s (K, N): A stored
// [M][K] (TA false) or [K][M] (TA true) at row stride lda, B stored
// [N][K] (TB false) or [K][N] (TB true) at row stride ldb. Every stored
// row is a multiple of 8 elements (16-byte chunks).
struct GemmArgs {
  const bf16* a[2];
  const bf16* b[2];
  int lda, ldb, M, N, K, nseg;
};

template <int BN, bool TA, bool TB>
struct Tile {
  static constexpr int kLdA = TA ? kBM + 8 : kBK + 8;
  static constexpr int kAElems = TA ? kBK * (kBM + 8) : kBM * (kBK + 8);
  static constexpr int kLdB = TB ? BN + 8 : kBK + 8;
  static constexpr int kBElems = TB ? kBK * (BN + 8) : BN * (kBK + 8);
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr int kLdC = BN + 4;
  static constexpr int kPipe = kStages * kStageElems * 2;
  static constexpr int kSmem =
      kPipe > kBM * kLdC * 4 ? kPipe : kBM * kLdC * 4;
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

// One 64 x BN tile of C at (m0, n0) over depth [kb, ke), left in shared
// memory as f32 (row stride Tile::kLdC) after a __syncthreads(). Warps
// 2 (m) x 4 (n), each 32 x BN/4.
template <int BN, bool TA, bool TB>
__device__ void gemm_tile(const GemmArgs& g, int m0, int n0, int kb, int ke,
                          char* smem) {
  using L = Tile<BN, TA, TB>;
  constexpr int NT = BN / 32;
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int nk = (ke - kb + kBK - 1) / kBK;
  const int steps = nk * g.nseg;

  auto load = [&](int step, int stage) {
    const int seg = step >= nk ? 1 : 0;
    const int k0 = kb + (step - seg * nk) * kBK;
    const bf16* A = g.a[seg];
    const bf16* B = g.b[seg];
    bf16* As = sm + stage * L::kStageElems;
    bf16* Bs = As + L::kAElems;
    {
      const int i = tid;  // kBM x kBK = 256 chunks of 8
      int r, c8;
      bool ok;
      const bf16* src;
      if (!TA) {
        r = i >> 2;
        c8 = (i & 3) * 8;
        ok = m0 + r < g.M && k0 + c8 < ke;
        src = A + static_cast<size_t>(m0 + r) * g.lda + k0 + c8;
      } else {
        r = i >> 3;
        c8 = (i & 7) * 8;
        ok = k0 + r < ke && m0 + c8 < g.M;
        src = A + static_cast<size_t>(k0 + r) * g.lda + m0 + c8;
      }
      cp_async16(As + r * L::kLdA + c8, ok ? src : A, ok);
    }
    for (int i = tid; i < BN * 4; i += kGemmThreads) {
      int r, c8;
      bool ok;
      const bf16* src;
      if (!TB) {
        r = i >> 2;
        c8 = (i & 3) * 8;
        ok = n0 + r < g.N && k0 + c8 < ke;
        src = B + static_cast<size_t>(n0 + r) * g.ldb + k0 + c8;
      } else {
        r = i / (BN / 8);
        c8 = (i % (BN / 8)) * 8;
        ok = k0 + r < ke && n0 + c8 < g.N;
        src = B + static_cast<size_t>(k0 + r) * g.ldb + n0 + c8;
      }
      cp_async16(Bs + r * L::kLdB + c8, ok ? src : B, ok);
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
    const bf16* As = sm + (s % kStages) * L::kStageElems;
    const bf16* Bs = As + L::kAElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (TA)
          frag_at(af[mt], As, L::kLdA, wm * 32 + mt * 16, kk);
        else
          frag_a(af[mt], As, L::kLdA, wm * 32 + mt * 16, kk);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4];
        const int nb = wn * (BN / 4) + np * 16;
        if (TB)
          frag_bt(bq, Bs, L::kLdB, nb, kk);
        else
          frag_b(bq, Bs, L::kLdB, nb, kk);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][2 * np], af[mt], bq[0], bq[1]);
          mma(acc[mt][2 * np + 1], af[mt], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* ct = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * 32 + mt * 16 + gr;
      const int col = wn * (BN / 4) + nt * 8 + 2 * t4;
      ct[r * L::kLdC + col] = acc[mt][nt][0];
      ct[r * L::kLdC + col + 1] = acc[mt][nt][1];
      ct[(r + 8) * L::kLdC + col] = acc[mt][nt][2];
      ct[(r + 8) * L::kLdC + col + 1] = acc[mt][nt][3];
    }
  __syncthreads();
}

// A GEMM over the T token rows with epilogue epi(tile, ldc, m0, n0, BN),
// kMinBlocks blocks an SM; with kNFirst blockIdx.x walks the N tiles, so
// the blocks that read one A tile run together.
template <int BN, bool TA, bool TB, class Epi, int kMinBlocks = 2,
          bool kNFirst = false>
__global__ void __launch_bounds__(kGemmThreads, kMinBlocks)
    gemm_kernel(const GemmArgs g, const Epi epi) {
  extern __shared__ __align__(16) char smem[];
  const int m0 = (kNFirst ? blockIdx.y : blockIdx.x) * kBM;
  const int n0 = (kNFirst ? blockIdx.x : blockIdx.y) * BN;
  gemm_tile<BN, TA, TB>(g, m0, n0, 0, g.K, smem);
  epi.template run<BN>(reinterpret_cast<const float*>(smem), m0, n0);
}

// ------------------------------------------------------------ epilogues
//
// Each reads the 64 x BN f32 tile that gemm_tile left in shared memory
// (row stride BN + 4): element-wise ones a column pair per thread, the
// row-wise ones (where one tile spans the row) a warp per row.

// f(m, j, v0, v1) for the tile's column pairs (j, j + 1), j < N, m < M
template <int BN, class F>
__device__ __forceinline__ void each_pair(const float* ct, int m0, int n0,
                                          int M, int N, F f) {
  constexpr int ldc = BN + 4, half = BN / 2;
  for (int i = threadIdx.x; i < kBM * half; i += blockDim.x) {
    const int r = i / half, cc = 2 * (i - r * half);
    const int m = m0 + r, j = n0 + cc;
    if (m < M && j < N) f(m, j, ct[r * ldc + cc], ct[r * ldc + cc + 1]);
  }
}

// q, k, v = bf16(xn Wqkv + bqkv), by head (pad channels 0: zero weights
// and bias there)
struct EpiQkv {
  bf16* qkv;          // (tokens, n3)
  const float* bqkv;  // (n3) by head
  int tokens, n3;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    each_pair<BN>(ct, m0, n0, tokens, n3,
                  [&](int m, int j, float v0, float v1) {
                    st_bf2(qkv + static_cast<size_t>(m) * n3 + j,
                           v0 + bqkv[j], v1 + bqkv[j + 1]);
                  });
  }
};

// x1 = x + (ao Wproj + bproj) fa; LN2's statistics; x1n (a warp per row).
// fa is column dp_col of the factor rows dpf (stride dp_stride), or 1
// without them; st2 (mean, rsqrt) is written where it is not null.
struct EpiProjLn {
  Dims d;
  const bf16* x;  // the block's input tokens (the first c of ldx a row) ...
  Rows xr;        // ... at these rows
  const bf16* bproj;
  const float* dpf;
  int dp_col, dp_stride;
  float* x1;    // (tokens, c)
  bf16* x1n;    // (tokens, kp), ones at c
  float2* st2;  // (tokens) or null
  int ldx;
  template <int BN>
  __device__ void run(const float* ct, int m0, int) const {
    constexpr int ldc = BN + 4;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kBM; r += blockDim.x >> 5) {
      const int m = m0 + r;
      if (m >= d.tokens) break;
      const bf16* xrow = x + xr(m, d.n) * ldx;
      const float f =
          dpf ? dpf[static_cast<size_t>(m) * dp_stride + dp_col] : 1.0f;
      float v[6], s = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        v[i] = 0.f;
        if (o < d.c) {
          v[i] = ldb(xrow + o) + (ct[r * ldc + o] + ldb(bproj + o)) * f;
          s += v[i];
          s2 += v[i] * v[i];
        }
      }
      s = fastblk::warp_sum(s);
      s2 = fastblk::warp_sum(s2);
      const float mu = s / d.c;
      const float q = rsqrtf(fmaxf(s2 / d.c - mu * mu, 0.f) + fastblk::kEps);
      const float mq = mu * q;
      float* x1r = x1 + static_cast<size_t>(m) * d.c;
      bf16* x1nr = x1n + static_cast<size_t>(m) * d.kp;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        if (o < d.c) {
          x1r[o] = v[i];
          x1nr[o] = __float2bfloat16_rn(v[i] * q - mq);
        }
      }
      for (int o = d.c + lane; o < d.kp; o += 32)
        x1nr[o] = __float2bfloat16_rn(o == d.c ? 1.f : 0.f);
      if (lane == 0 && st2) st2[m] = make_float2(mu, q);
    }
  }
};

// ------------------------------------------------------------ attention

constexpr int kAttnThreads = 128;  // 4 warps, 16 query rows each

struct AttnSmem {
  int q, k, v, dout, p, dsh, dsl, dah, dal, bytes;
};

__host__ __device__ inline AttnSmem attn_smem(const Dims& d, bool vjp) {
  const int ldh = d.hds + 8, ldn = d.n + 8;
  AttnSmem s;
  int off = 0;
  s.q = off, off += d.n * ldh;
  s.k = off, off += d.n * ldh;
  s.v = off, off += d.n * ldh;
  s.dout = s.p = s.dsh = s.dsl = s.dah = s.dal = off;
  if (vjp) {
    s.dout = off, off += d.n * ldh;
    s.p = off, off += d.n * ldn;
    s.dsh = off, off += d.n * ldn;
    s.dsl = off, off += d.n * ldn;
    s.dah = off, off += d.n * ldh;
    s.dal = off, off += d.n * ldh;
  }
  s.bytes = 2 * off;
  return s;
}

// One launch's attention operands: q/k/v by head (tokens, n3), the packed
// bias (bw, n, nh n) bf16, the softmax variant, and the forward's output
// rows (tokens, kp): bf16(o), ones at column c, zeros past it.
struct Attn {
  Dims d;
  const bf16* qkv;
  const bf16* bias;
  int bw, softmax;
  bf16* ao;
};

// q, k, v of (window, head) into shared memory, each head padded to hds
// channels with zeros.
__device__ inline void load_qkv(const Attn& a, bf16* sm,
                                const AttnSmem& L, int win, int h) {
  const Dims& d = a.d;
  const int ldh = d.hds + 8, cpr = d.hds / 8;
  const int base[3] = {L.q, L.k, L.v};
  for (int i = threadIdx.x; i < 3 * d.n * cpr; i += blockDim.x) {
    const int part = i / (d.n * cpr), rem = i - part * d.n * cpr;
    const int r = rem / cpr, ch = rem - r * cpr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ch * 8 < d.hdg)
      v = *reinterpret_cast<const uint4*>(
          a.qkv + (static_cast<size_t>(win) * d.n + r) * d.n3 +
          part * d.nh * d.hdg + h * d.hdg + ch * 8);
    *reinterpret_cast<uint4*>(sm + base[part] + r * ldh + ch * 8) = v;
  }
}

// The forward of one warp's 16 query rows r0.. of (window, head): s = q
// k^T + bias (f32), e by the softmax variant (f32), den = bf16(sum_j
// bf16(e)), o = (bf16(e) v) / den, or (bf16(e) v) rcp(den) with the
// approximate reciprocal (kApprox, the serving forward's). Returns s, e (8
// n-tiles of 8 over the keys), the P = bf16(e) A operands of the P V
// product, den and o (the unrounded quotient, 4 d-tiles).
struct AttnRows {
  float s[8][4], e[8][4], o[4][4];
  uint32_t pa[4][4];
  float den0, den1;
};

template <bool kApprox>
__device__ inline void attn_rows(const Attn& a, const bf16* sm,
                                 const AttnSmem& L, int win, int h, int r0,
                                 AttnRows& R) {
  const Dims& d = a.d;
  const int ldh = d.hds + 8, n = d.n, nkt = n / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  // the bias first, so its latency overlaps the score products
  const int bwin = win % a.bw;
  const bf16* b0 = a.bias +
                   (static_cast<size_t>(bwin) * n + r0 + gr) * d.nh * n +
                   h * n + 2 * t4;
  const bf16* b1 = b0 + static_cast<size_t>(8) * d.nh * n;
  uint32_t bb[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nkt) {
      bb[j][0] = fastblk::ldg32(b0 + j * 8);
      bb[j][1] = fastblk::ldg32(b1 + j * 8);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) R.s[j][0] = R.s[j][1] = R.s[j][2] = R.s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 32; kk += 16) {
    if (kk < d.hds) {
      uint32_t qa[4];
      frag_a(qa, sm + L.q, ldh, r0, kk);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp < nkt) {
          uint32_t kb[4];
          frag_b(kb, sm + L.k, ldh, jp * 16, kk);
          mma(R.s[2 * jp], qa, kb[0], kb[1]);
          mma(R.s[2 * jp + 1], qa, kb[2], kb[3]);
        }
      }
    }
  }
  float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nkt) {
      const uint32_t u0 = bb[j][0], u1 = bb[j][1];
      R.s[j][0] += fastblk::lo_f(u0);
      R.s[j][1] += fastblk::hi_f(u0);
      R.s[j][2] += fastblk::lo_f(u1);
      R.s[j][3] += fastblk::hi_f(u1);
      m0 = fmaxf(m0, fmaxf(R.s[j][0], R.s[j][1]));
      m1 = fmaxf(m1, fmaxf(R.s[j][2], R.s[j][3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if (a.softmax == fastblk::kStableMM) {
    m0 = rb(m0);
    m1 = rb(m1);
  }
  const bool clamp = a.softmax == fastblk::kClampOnly;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nkt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float s = R.s[j][u];
        R.e[j][u] = clamp ? expf(fminf(s, fastblk::kClamp))
                          : expf(s - (u < 2 ? m0 : m1));
      }
      d0 += rb(R.e[j][0]) + rb(R.e[j][1]);
      d1 += rb(R.e[j][2]) + rb(R.e[j][3]);
    } else {
      R.e[j][0] = R.e[j][1] = R.e[j][2] = R.e[j][3] = 0.f;
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  R.den0 = rb(d0);
  R.den1 = rb(d1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(R.pa[kk], R.e[2 * kk], R.e[2 * kk + 1]);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) R.o[dt][0] = R.o[dt][1] = R.o[dt][2] = R.o[dt][3] = 0.f;
#pragma unroll
  for (int dp = 0; dp < 2; ++dp) {
    if (dp * 16 < d.hds) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 < n) {
          uint32_t vb[4];
          frag_bt(vb, sm + L.v, ldh, dp * 16, kk * 16);
          mma(R.o[2 * dp], R.pa[kk], vb[0], vb[1]);
          mma(R.o[2 * dp + 1], R.pa[kk], vb[2], vb[3]);
        }
      }
    }
  }
  if (kApprox) {
    const float rd0 = fastblk::rcp_approx(R.den0);
    const float rd1 = fastblk::rcp_approx(R.den1);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      R.o[dt][0] *= rd0;
      R.o[dt][1] *= rd0;
      R.o[dt][2] *= rd1;
      R.o[dt][3] *= rd1;
    }
  } else {
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      R.o[dt][0] /= R.den0;
      R.o[dt][1] /= R.den0;
      R.o[dt][2] /= R.den1;
      R.o[dt][3] /= R.den1;
    }
  }
}

// The attention output bf16(o) of (window, head) in the C-wide layout
// (head 0 also writes the pad columns: ones at c).
template <bool kApprox>
__global__ void __launch_bounds__(kAttnThreads)
    attn_fwd_kernel(const Attn a) {
  extern __shared__ __align__(16) char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const Dims& d = a.d;
  const AttnSmem L = attn_smem(d, false);
  const int win = blockIdx.x / d.nh, h = blockIdx.x - win * d.nh;
  const size_t t0 = static_cast<size_t>(win) * d.n;
  load_qkv(a, sm, L, win, h);
  if (h == 0) {
    const int pad = d.kp - d.c;
    for (int i = threadIdx.x; i < d.n * pad; i += blockDim.x) {
      const int r = i / pad, o = d.c + i % pad;
      a.ao[(t0 + r) * d.kp + o] = __float2bfloat16_rn(o == d.c ? 1.f : 0.f);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  if (r0 >= d.n) return;
  AttnRows R;
  attn_rows<kApprox>(a, sm, L, win, h, r0, R);
  const int gr = lane >> 2, t4 = lane & 3;
  bf16* o0 = a.ao + (t0 + r0 + gr) * d.kp + h * d.hd;
  bf16* o1 = o0 + static_cast<size_t>(8) * d.kp;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int dd = dt * 8 + 2 * t4;
    if (dd < d.hd) {
      o0[dd] = __float2bfloat16_rn(R.o[dt][0]);
      o1[dd] = __float2bfloat16_rn(R.o[dt][2]);
    }
    if (dd + 1 < d.hd) {
      o0[dd + 1] = __float2bfloat16_rn(R.o[dt][1]);
      o1[dd + 1] = __float2bfloat16_rn(R.o[dt][3]);
    }
  }
}

// ------------------------------------------------------------------ host

inline GemmArgs gemm_args(const bf16* a0, const bf16* a1, int lda,
                          const bf16* b0, const bf16* b1, int ldb, int M,
                          int N, int K) {
  GemmArgs g;
  g.a[0] = a0;
  g.a[1] = a1 ? a1 : a0;
  g.b[0] = b0;
  g.b[1] = b1 ? b1 : b0;
  g.nseg = (a1 || b1) ? 2 : 1;
  g.lda = lda;
  g.ldb = ldb;
  g.M = M;
  g.N = N;
  g.K = K;
  return g;
}

template <int BN, bool TA, bool TB, class Epi, int kMinBlocks = 2,
          bool kNFirst = false>
inline cudaError_t run_gemm(const GemmArgs& g, const Epi& epi,
                            cudaStream_t s) {
  constexpr int smem = Tile<BN, TA, TB>::kSmem;
  auto kernel = gemm_kernel<BN, TA, TB, Epi, kMinBlocks, kNFirst>;
  // set where it launches: the attribute belongs to this library's kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int mt = (g.M + kBM - 1) / kBM, nt = (g.N + BN - 1) / BN;
  const dim3 grid(kNFirst ? nt : mt, kNFirst ? mt : nt);
  kernel<<<grid, kGemmThreads, smem, s>>>(g, epi);
  return cudaGetLastError();
}

// A GEMM whose epilogue works a row at a time: one tile spans the row.
template <bool TA, bool TB, class Epi, int kMinBlocks = 2>
inline cudaError_t run_rows(const GemmArgs& g, const Epi& epi,
                            cudaStream_t s) {
  if (g.N <= 64) return run_gemm<64, TA, TB, Epi, kMinBlocks>(g, epi, s);
  if (g.N <= 128) return run_gemm<128, TA, TB, Epi, kMinBlocks>(g, epi, s);
  if (g.N <= 192) return run_gemm<192, TA, TB, Epi>(g, epi, s);
  return run_gemm<256, TA, TB, Epi>(g, epi, s);
}

}  // namespace tokpar
