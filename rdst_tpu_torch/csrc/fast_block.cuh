// The bfloat16 fast Swin block body for Hopper (sm_90a), one window per
// thread block, of the train-pair forward (pair_train.cu), and the
// primitives (bf16 pairs, the mma.sync products and softmax variants of
// the attention, the launch checks) that csrc/window_body.cuh and the
// token-parallel kernels share. The fast block, the block-train forward
// and the pair and RDSTB stages run other designs (csrc/swin_block_fast
// .cu, csrc/block_train.cu, csrc/window_body.cuh, csrc/token_fwd.cuh).
//
// Replaces: the fast branch of `_body` in rdst_tpu/kernels/swin_block.py
// (`fast=True`, :261-473). Per window of N tokens (C channels, nH heads):
//
//   xn = bf16(normalize(x))                    one-pass moments, eps 1e-5
//   q, k, v = bf16(xn @ Wqkv' + bqkv')         LN1 affine, q scale folded
//   s_h = q_h k_h^T + bias_h                   bias bf16, s f32
//   e = bf16(exp(...))                         by softmax variant
//   o = (e v) * rcp(bf16(sum_j e))             approximate reciprocal
//   x1 = x + (bf16(o) @ Wproj + bproj)
//   h = bf16(gelu_tanh(bf16(normalize(x1)) @ W1' + b1'))
//   out = x1 + (h @ W2 + b2)                   f32; the caller rounds
//
// What bounds it on an H100: operations (about 16C^2 + 4NC flops per
// token against 4C bytes of tokens in and out). The design runs every
// product on the tensor cores: `mma.sync.m16n8k16` with bf16 operands
// and f32 accumulation, written by hand (inline PTX).
// * The TPU kernel packs all heads into one (N, nH*N) product because
//   per-head products with head dim 10-20 underfill its matrix unit.
//   Here the products are per head instead, each head zero-padded to a
//   k-depth of 8 (q, k: one m16n8k16 step per 16 channels, an m16n8k8
//   step for a last 8) and an n-width of 8 (v), which wastes less
//   than the packed form's nH-fold masked work: a warp owns one head and
//   16 query rows, keeps its 16 x N scores in registers, does the
//   softmax there, and feeds the rounded probabilities back into the
//   P*V product as the A operand without a trip through shared memory.
// * Projections: A (tokens) in shared memory, B (weights, (out, in)
//   bf16, padded to multiples of 16 by the wrapper) read from global
//   memory/L2; a warp owns 8 output channels of all N rows.
// * Shared memory rows use strides of 8 (mod 64) bf16 elements past a
//   multiple of 64, so the fragment loads of a warp hit distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fastblk {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // threads per block of every fast kernel
constexpr float kEps = 1e-5f;
constexpr float kClamp = 60.0f;
constexpr int kMaxN = 64;
// Widest C of the fast block's and the single-block train kernels'
// token-parallel designs (SwinIR-std, C = 180). The train-pair kernels keep
// the C <= 128 they were verified at.
constexpr int kMaxC = 192;
constexpr int kMaxCShared = 128;
constexpr float kQX = 31.75f;  // int8 activation step: 127 / 4 sigma
                               // (csrc/token_fwd.cuh's int8 LN1 rows)

enum Softmax { kStable = 0, kClampOnly = 1, kStableMM = 2 };

// One block's weights in the kernels' layout (kernels.swin_block
// .kernel_layout): (out, in) bf16 padded to multiples of 16, qkv as three
// (cp, cp) parts; folded biases bqkv and bf1 f32, bproj and bf2 bf16.
struct Weights {
  const bf16* wqkv;   // (3 cp, cp)
  const float* bqkv;  // (3 cp)
  const bf16* wproj;  // (cp, cp)
  const bf16* bproj;  // (cp)
  const bf16* w1;     // (hp, cp)
  const float* bf1;   // (hp)
  const bf16* w2;     // (cp, hp)
  const bf16* bf2;    // (cp)
  const bf16* bias;   // (bias_windows, n, nh * n), bf16
  int bias_windows;
};

struct Geom {
  int n, c, nh, hidden;
  int cp, hp, hd, hdq, hdv;  // padded widths
  int lda, ldq, ldv, ldh;    // shared-memory row strides (elements)
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline Geom make_geom(int n, int c, int nh,
                                          int hidden) {
  Geom g;
  g.n = n;
  g.c = c;
  g.nh = nh;
  g.hidden = hidden;
  g.cp = round_up(c, 16);
  g.hp = round_up(hidden, 16);
  g.hd = c / nh;
  g.hdq = round_up(g.hd, 8);
  g.hdv = round_up(g.hd, 8);
  g.lda = g.cp + 8;
  g.ldq = nh * g.hdq + 8;
  g.ldv = n + 8;
  g.ldh = g.hp + 8;
  return g;
}

// Byte offsets of one window's buffers; kernels.swin_block
// .fast_smem_bytes mirrors this.
struct Smem {
  int xs, xn, region, total, region_bytes;
};

__host__ __device__ inline Smem smem_layout(const Geom& g) {
  Smem s;
  s.xs = 0;
  s.xn = round_up(4 * g.n * g.c, 16);
  s.region = s.xn + round_up(2 * g.n * g.lda, 16);
  const int attn = 2 * (2 * g.n * g.ldq + g.nh * g.hdv * g.ldv);
  const int mlp = 2 * g.n * g.ldh;
  s.region_bytes = round_up(attn > mlp ? attn : mlp, 16);
  s.total = s.region + s.region_bytes;
  return s;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// d += a * b: m16n8k16, A row-major (16 x 16) bf16, B "col" (16 x 8) bf16,
// D f32. a0: (row g, k 2t..2t+1), a1: (row g+8, same k), a2: (row g,
// k 2t+8..), a3: (row g+8, k 2t+8..); b0: (k 2t..2t+1, col g), b1: k + 8;
// d: (row g, cols 2t, 2t+1), (row g+8, same cols); g = lane / 4,
// t = lane % 4.
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a * b: m16n8k8, A (16 x 8): a0 (row g, k 2t..2t+1), a1 (row g+8);
// B (8 x 8): b0 (k 2t..2t+1, col g); d as mma16816.
__device__ __forceinline__ void mma1688(float* d, uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// epi(row, col, v0, v1) for rows m < M (M a multiple of 16, <= 64) and
// column pairs (col, col + 1) < ntiles * 8 of
// sum_k A[m * lda + k] * W[o * ldw + k], k < ksteps * 16. A bf16 in shared
// memory, W bf16 (out, in) in global memory. A warp owns 8 output columns
// of every row: the B fragment is loaded once per k-step for all M/16
// row tiles.
template <class Epi>
__device__ void gemm(const bf16* A, int lda, int M, int ksteps,
                     const bf16* __restrict__ W, int ldw, int ntiles,
                     Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int mts = M >> 4;
  for (int nt = warp; nt < ntiles; nt += nwarps) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const bf16* wr = W + static_cast<size_t>(nt * 8 + g) * ldw + 2 * t;
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t b0 = ldg32(wr + ks * 16), b1 = ldg32(wr + ks * 16 + 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mts) {
          const bf16* ar = A + (mt * 16 + g) * lda + ks * 16 + 2 * t;
          mma16816(acc[mt], ld32(ar), ld32(ar + 8 * lda), ld32(ar + 8),
                   ld32(ar + 8 * lda + 8), b0, b1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < mts) {
        epi(mt * 16 + g, nt * 8 + 2 * t, acc[mt][0], acc[mt][1]);
        epi(mt * 16 + g + 8, nt * 8 + 2 * t, acc[mt][2], acc[mt][3]);
      }
    }
  }
}

// Affine-free one-pass LayerNorm of n rows of c f32 (stride c) into bf16
// rows at stride ldd, columns c..cpad-1 set to 0. Every row at once:
// blockDim.x / n neighbouring threads per row (a power of two <= 32, as
// n | 256 makes it), reduced by shuffles within their group.
__device__ inline void normalize_rows(const float* src, bf16* dst, int ldd,
                                      int n, int c, int cpad) {
  const int tpr = blockDim.x / n;
  const int r = threadIdx.x / tpr, j = threadIdx.x - r * tpr;
  const float* row = src + r * c;
  float s = 0.f, s2 = 0.f;
  for (int i = j; i < c; i += tpr) {
    const float v = row[i];
    s += v;
    s2 += v * v;
  }
  for (int o = tpr >> 1; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mu = s / c, ex2 = s2 / c;
  const float a = rsqrtf(fmaxf(ex2 - mu * mu, 0.f) + kEps);
  const float ma = mu * a;
  for (int i = j; i < cpad; i += tpr)
    dst[r * ldd + i] = __float2bfloat16_rn(i < c ? row[i] * a - ma : 0.f);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.0f + tanhf(u)));
}

// The whole fast block on one window: xs (n, c) f32 in shared memory is
// replaced by the block's f32 output. `smem` is the block's dynamic
// shared memory laid out by smem_layout(g); bias_win selects the window's
// bias slice. The training kernel (pair_train.cu) asks for an exact
// division of the softmax normalizer (`exact`) and scales the residual
// branches of row m by dp_attn[dp_stride m] and dp_mlp[dp_stride m]
// (stochastic-depth factor columns; null means 1). Starts and ends with
// __syncthreads().
__device__ inline void fast_block(const Weights& w, const Geom& g, char* smem,
                           int bias_win, int softmax, bool exact = false,
                           const float* dp_attn = nullptr,
                           const float* dp_mlp = nullptr,
                           int dp_stride = 4) {
  const Smem L = smem_layout(g);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  bf16* xn = reinterpret_cast<bf16*>(smem + L.xn);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.region);
  bf16* ks = qs + g.n * g.ldq;
  bf16* vt = ks + g.n * g.ldq;  // (nh * hdv, n) transposed v
  bf16* hb = qs;                // (n, hp) MLP hidden rows
  const int n = g.n, c = g.c;
  __syncthreads();

  // LN1; q/k/v pads must read as zero
  normalize_rows(xs, xn, g.lda, n, c, g.cp);
  {
    uint4* z = reinterpret_cast<uint4*>(smem + L.region);
    for (int i = threadIdx.x; i < L.region_bytes / 16; i += blockDim.x)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // head of a channel without an integer division: (ch + 0.5) / hd is at
  // least 0.5 / hd from an integer, far beyond the float error
  const float inv_hd = 1.0f / g.hd;
  // the q/k/v scatter of output columns o, o + 1
  auto qkv_epi = [&](int m, int o, float v0, float v1) {
    const int part = o < g.cp ? 0 : (o < 2 * g.cp ? 1 : 2);
    const float vv[2] = {v0, v1};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ch = o + u - part * g.cp;
      if (ch >= c) continue;
      const bf16 val =
          __float2bfloat16_rn(__fadd_rn(vv[u], __ldg(w.bqkv + o + u)));
      const int h = static_cast<int>((ch + 0.5f) * inv_hd);
      const int d = ch - h * g.hd;
      if (part == 0)
        qs[m * g.ldq + h * g.hdq + d] = val;
      else if (part == 1)
        ks[m * g.ldq + h * g.hdq + d] = val;
      else
        vt[(h * g.hdv + d) * g.ldv + m] = val;
    }
  };
  gemm(xn, g.lda, n, g.cp / 16, w.wqkv, g.cp, 3 * g.cp / 8, qkv_epi);
  __syncthreads();

  // attention: a warp owns (head h, 16 query rows); ao overwrites xn.
  // The projection reads columns c..cp-1 of ao as zeros: normalize_rows
  // left them so.
  {
    bf16* ao = xn;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gr = lane >> 2, t = lane & 3;
    const int nwarps = blockDim.x >> 5;
    const int mts = n >> 4, nkt = n >> 3;
    const int items = g.nh * mts;
    for (int item = warp; item < items; item += nwarps) {
      const int h = item / mts, mt = item - h * mts;
      const int r0 = mt * 16 + gr, r1 = r0 + 8;
      // the bias (bf16, packed (bw, n, nh * n)) is loaded first, so its
      // latency overlaps the score products
      const bf16* b0 = w.bias +
                       (static_cast<size_t>(bias_win) * n + r0) * g.nh * n +
                       h * n + 2 * t;
      const bf16* b1 = b0 + static_cast<size_t>(8) * g.nh * n;
      uint32_t bb[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nkt) {
          bb[j][0] = ldg32(b0 + j * 8);
          bb[j][1] = ldg32(b1 + j * 8);
        }
      }
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      for (int kk = 0; kk < g.hdq; kk += 16) {
        const bf16* qa = qs + r0 * g.ldq + h * g.hdq + kk + 2 * t;
        const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * g.ldq);
        if (kk + 16 <= g.hdq) {
          const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * g.ldq + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < nkt) {
              const bf16* kb =
                  ks + (j * 8 + gr) * g.ldq + h * g.hdq + kk + 2 * t;
              mma16816(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
            }
          }
        } else {  // the last 8 channels of the head
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j < nkt)
              mma1688(s[j], a0, a1,
                      ld32(ks + (j * 8 + gr) * g.ldq + h * g.hdq + kk + 2 * t));
          }
        }
      }
      float m0 = -3.0e38f, m1 = -3.0e38f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nkt) {
          const uint32_t u0 = bb[j][0], u1 = bb[j][1];
          s[j][0] += lo_f(u0);
          s[j][1] += hi_f(u0);
          s[j][2] += lo_f(u1);
          s[j][3] += hi_f(u1);
          m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
          m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
        }
      }
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
      if (softmax == kStableMM) {
        m0 = round_bf16(m0);
        m1 = round_bf16(m1);
      }
      uint32_t p[8][2];
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nkt) {
          float e[4];
          if (softmax == kClampOnly) {
#pragma unroll
            for (int u = 0; u < 4; ++u) e[u] = __expf(fminf(s[j][u], kClamp));
          } else {
            e[0] = __expf(s[j][0] - m0);
            e[1] = __expf(s[j][1] - m0);
            e[2] = __expf(s[j][2] - m1);
            e[3] = __expf(s[j][3] - m1);
          }
          p[j][0] = pack2(e[0], e[1]);
          p[j][1] = pack2(e[2], e[3]);
          d0 += lo_f(p[j][0]) + hi_f(p[j][0]);
          d1 += lo_f(p[j][1]) + hi_f(p[j][1]);
        } else {
          p[j][0] = p[j][1] = 0u;
        }
      }
      d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
      d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
      const float dn0 = round_bf16(d0), dn1 = round_bf16(d1);
      const float rd0 = rcp_approx(dn0), rd1 = rcp_approx(dn1);
      for (int dt = 0; dt < g.hdv; dt += 8) {
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* vb = vt + (h * g.hdv + dt + gr) * g.ldv + 2 * t;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (2 * kk < nkt)
            mma16816(o, p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                     p[2 * kk + 1][1], ld32(vb + kk * 16),
                     ld32(vb + kk * 16 + 8));
        }
        const int d = dt + 2 * t;
        bf16* a0p = ao + r0 * g.lda + h * g.hd;
        bf16* a1p = ao + r1 * g.lda + h * g.hd;
        if (exact) {
          o[0] /= dn0;
          o[1] /= dn0;
          o[2] /= dn1;
          o[3] /= dn1;
        } else {
          o[0] *= rd0;
          o[1] *= rd0;
          o[2] *= rd1;
          o[3] *= rd1;
        }
        if (d < g.hd) {
          a0p[d] = __float2bfloat16_rn(o[0]);
          a1p[d] = __float2bfloat16_rn(o[2]);
        }
        if (d + 1 < g.hd) {
          a0p[d + 1] = __float2bfloat16_rn(o[1]);
          a1p[d + 1] = __float2bfloat16_rn(o[3]);
        }
      }
    }
  }
  __syncthreads();

  // proj + residual 1 (x1 = x + (o Wproj + bproj))
  gemm(xn, g.lda, n, g.cp / 16, w.wproj, g.cp, g.cp / 8,
       [&](int m, int o, float v0, float v1) {
         const float f = dp_attn ? dp_attn[dp_stride * m] : 1.0f;
         if (o < c)
           xs[m * c + o] += (v0 + __bfloat162float(w.bproj[o])) * f;
         if (o + 1 < c)
           xs[m * c + o + 1] += (v1 + __bfloat162float(w.bproj[o + 1])) * f;
       });
  __syncthreads();

  normalize_rows(xs, xn, g.lda, n, c, g.cp);
  __syncthreads();

  gemm(xn, g.lda, n, g.cp / 16, w.w1, g.cp, g.hp / 8,
       [&](int m, int o, float v0, float v1) {
         *reinterpret_cast<uint32_t*>(hb + m * g.ldh + o) =
             pack2(gelu_tanh(v0 + __ldg(w.bf1 + o)),
                   gelu_tanh(v1 + __ldg(w.bf1 + o + 1)));
       });
  __syncthreads();

  // fc2 + residual 2
  gemm(hb, g.ldh, n, g.hp / 16, w.w2, g.hp, g.cp / 8,
       [&](int m, int o, float v0, float v1) {
         const float f = dp_mlp ? dp_mlp[dp_stride * m] : 1.0f;
         if (o < c) xs[m * c + o] += (v0 + __bfloat162float(w.bf2[o])) * f;
         if (o + 1 < c)
           xs[m * c + o + 1] += (v1 + __bfloat162float(w.bf2[o + 1])) * f;
       });
  __syncthreads();
}

// A barrier across every block of a cooperative launch. `counter` is zero
// at the launch; each block passes its `epoch` (barriers so far), so the
// counter only grows. Writes before the barrier are visible after it to
// loads that bypass L1 (__ldcg).
__device__ inline void grid_barrier(unsigned int* counter,
                                    unsigned int& epoch) {
  __syncthreads();
  epoch += 1;
  if (threadIdx.x == 0) {
    const unsigned int target = epoch * gridDim.x;
    __threadfence();
    atomicAdd(counter, 1u);
    while (atomicAdd(counter, 0u) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// Shared launch checks: the device's opt-in shared-memory limit and the
// function attribute above the 48 KB default. Returns a cudaError_t.
template <class Kernel>
inline cudaError_t prepare(Kernel kernel, int smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// Blocks of a cooperative launch: all co-resident, at most `work`.
template <class Kernel>
inline cudaError_t cooperative_grid(Kernel kernel, int smem, int device,
                                    int work, int* grid) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = per_sm * sms < work ? per_sm * sms : work;
  return cudaSuccess;
}

// The geometry the window body takes, up to width max_c (kMaxC for the
// fast block and the single-block train kernels, kMaxCShared for the
// train-pair kernels).
inline bool geom_ok(const Geom& g, int max_c = kMaxCShared) {
  return g.n > 0 && g.n <= kMaxN && g.n % 16 == 0 && g.c > 0 &&
         g.c <= max_c && g.nh > 0 && g.c % g.nh == 0 && g.hd <= 32 &&
         g.hidden > 0 && g.hidden <= 512;
}

}  // namespace fastblk

// Each kernel library is built from one source that includes this header
// once, so the definition below exists once per library.
extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
