// One Swin block's backward for the bf16 training kernels (sm_90a):
// shared by csrc/pair_train.cu (the two blocks of a DSTL pair) and
// csrc/block_train.cu (one block).
//
// Replaces the backward pallas_calls of rdst_tpu/kernels/pair_train.py
// (:232) and rdst_tpu/kernels/block_train.py (:220): `jax.vjp` of the
// fast block body inside the kernel, which recomputes each window's
// forward and runs its VJP in VMEM, one grid step per window chunk.
//
// The math is the hand-derived VJP of the fast body with an exact
// division of the softmax normalizer: the MLP (tanh-GELU derivative),
// the affine-free normalize, the projection, the per-head softmax
// (clamp: no gradient where s > 60; stable: the gradient through the row
// max, split among its ties; stable_mm: that gradient rounded to bf16),
// q/k/v and the packed bias. Cotangents are rounded to bf16 wherever the
// forward holds a bf16 value, as autodiff of the bf16 body does.
// kernels/block_train.py::block_bwd_reference is the same computation in
// plain PyTorch, phase by phase, at the same rounding points.
//
// What bounds it on an H100: operations, about 4x the forward's products
// (the recompute, twice the forward's products for the VJP, and the f32
// cotangents taken as bf16 hi + lo pairs), but only if every product runs
// on the tensor cores at a good share of their rate and the state between
// products stays small. A window's own products are tiny (64 tokens,
// head widths 10-30), so the design works over all T = windows x 64
// tokens at once, in phases, each laid out for where its data lives (the
// GEMM, the two forward epilogues and the attention forward are in
// csrc/token_gemm.cuh, shared with the serving forward of
// csrc/swin_block_fast.cu):
//
//  * Dense products as token-parallel tensor-core GEMMs (`gemm_tile`:
//    64 x BN tiles, BK = 32, a 3-stage cp.async ring, ldmatrix +
//    mma.sync m16n8k16 bf16, f32 accumulation). The accumulator tile is
//    parked in shared memory, and each use's epilogue reads it there:
//    bias, GELU and its derivative, the bf16 roundings, and -- where one
//    tile spans a whole row (BN >= C + 1) -- the row passes of the
//    normalize (LN2's statistics after the projection; both normalize
//    VJPs) and the residual adds, a warp per row.
//  * f32 cotangent operands are written by the producing epilogue as two
//    bf16 tensors (hi, lo = bf16(v - hi)); the consuming GEMM runs both
//    against the same other operand into one accumulator: K doubled,
//    about 16 bits of the f32 product.
//  * Weight gradients are the same GEMM transposed, X^T dY with K = T,
//    cut into fixed token chunks (`wgrad_kernel`, all four weights in one
//    launch), the partials summed in chunk order (`reduce_kernel`): no
//    float atomics, so a step is deterministic. Bias gradients come out
//    of the same products: every activation buffer carries a column of
//    ones in its padding, so row C (or hidden) of X^T dY is the column
//    sum of dY.
//  * Attention per (window, head), 4 warps of 16 query rows, q/k/v/dO in
//    shared memory padded to 16 channels: the recomputed scores, softmax
//    and P V in registers (`attn_fwd_kernel`), then the VJP
//    (`attn_vjp_kernel`): dP, the normalizer's cotangent, the score
//    cotangent with the clamp mask and the tie split of the row max, dq
//    from registers, dk and dv through shared memory. The score
//    cotangents are written per window and summed per bias window.
//  * The pair's relayouts (block b's input gathered from block a's
//    output at rolled positions, its input cotangent scattered back) are
//    row maps (`Rows`) in the row kernel and the row-wise epilogues.
//
// 13 kernels per block (`kBwdKernels`); the state between them is
// token-major bf16/f32 buffers in device memory (`work_floats`).

#pragma once

#include "token_gemm.cuh"

namespace trainblk {

// the token-parallel geometry, GEMM, forward epilogues and attention
// forward (csrc/token_gemm.cuh), shared with the serving forward
using namespace tokpar;

using fastblk::bf16;
using fastblk::round_up;

// One block's folded weights in the plain (in, out) layout of
// kernels.swin_block.FastParams, and its packed bias.
struct BlockW {
  const bf16* wqkv;   // (c, 3c)
  const float* bqkv;  // (3c)
  const bf16* wproj;  // (c, c)
  const bf16* bproj;  // (c)
  const bf16* w1;     // (c, hidden)
  const float* bf1;   // (hidden)
  const bf16* w2;     // (hidden, c)
  const bf16* bf2;    // (c)
  const bf16* bias;   // (bw, n, nh * n)
  int bw;
};

// Offsets (floats) of one block's weight gradients: FastParams order.
struct Grads {
  int wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2, total;
};

__host__ __device__ inline Grads grad_layout(int c, int hid) {
  Grads G;
  G.wqkv = 0;
  G.bqkv = G.wqkv + 3 * c * c;
  G.wproj = G.bqkv + 3 * c;
  G.bproj = G.wproj + c * c;
  G.w1 = G.bproj + c;
  G.bf1 = G.w1 + c * hid;
  G.w2 = G.bf1 + hid;
  G.bf2 = G.w2 + hid * c;
  G.total = G.bf2 + c;
  return G;
}

constexpr int kBwdKernels = 13;     // kernels of one block's backward

// Elements of one chunk's weight-gradient partials: dWqkv (kp, n3),
// dWproj (kp, kp), dW1 (kp, hp), dW2 (hp, kp), in that order.
inline long long part_size(const Dims& d) {
  return static_cast<long long>(d.kp) * d.n3 +
         static_cast<long long>(d.kp) * d.kp +
         2ll * static_cast<long long>(d.kp) * d.hp;
}

// The workspace's buffers (token-major; T = tokens).
struct Bufs {
  bf16 *wqkv, *wproj, *w1, *w2;  // weights padded: (kp, n3) (kp, kp)
                                 // (kp, hp) (hp, kp)
  float* bqkv;                   // (n3) the qkv bias by head, padded
  float2 *st1, *st2;             // (T) mean and rsqrt of LN1 / LN2
  bf16* xn;                      // (T, kp) bf16(normalize(x)), ones at c
  bf16 *dh2h, *dh2l;             // (T, kp) fm dz as hi + lo
  bf16* qkv;                     // (T, n3) q, k, v by head
  bf16* ao;                      // (T, kp) bf16 attention output, ones at c
  float* x1;                     // (T, c) the residual after attention
  bf16* x1n;                     // (T, kp) bf16(normalize(x1)), ones at c
  float* gd;                     // (T, hp) gelu'(u)
  bf16* h1;                      // (T, hp) bf16(gelu(u)), ones at hidden
  bf16 *duh, *dul;               // (T, hp) du as hi + lo
  float* g2;                     // (T, c) the residual's cotangent after LN2
  bf16 *dyh, *dyl;               // (T, kp) fa g2 as hi + lo
  bf16* dout;                    // (T, kp) the attention output's cotangent
  bf16* dqkv;                    // (T, n3)
  float* dsw;                    // (windows, n, nh n) score cotangents
  float* part;                   // (chunks, part_size) weight partials
};

// Floats of the workspace, and its buffers carved from `base` (each
// 128-byte aligned).
inline long long carve(const Dims& d, float* base, Bufs* b) {
  long long off = 0;
  const long long T = d.tokens;
  auto take = [&](long long floats) {
    float* p = base ? base + off : nullptr;
    off += (floats + 31) / 32 * 32;
    return p;
  };
  auto bf = [&](long long elems) {
    return reinterpret_cast<bf16*>(take((elems + 1) / 2));
  };
  Bufs z;
  z.wqkv = bf(static_cast<long long>(d.kp) * d.n3);
  z.wproj = bf(static_cast<long long>(d.kp) * d.kp);
  z.w1 = bf(static_cast<long long>(d.kp) * d.hp);
  z.w2 = bf(static_cast<long long>(d.hp) * d.kp);
  z.bqkv = take(d.n3);
  z.st1 = reinterpret_cast<float2*>(take(2 * T));
  z.st2 = reinterpret_cast<float2*>(take(2 * T));
  z.xn = bf(T * d.kp);
  z.dh2h = bf(T * d.kp);
  z.dh2l = bf(T * d.kp);
  z.qkv = bf(T * d.n3);
  z.ao = bf(T * d.kp);
  z.x1 = take(T * d.c);
  z.x1n = bf(T * d.kp);
  z.gd = take(T * d.hp);
  z.h1 = bf(T * d.hp);
  z.duh = bf(T * d.hp);
  z.dul = bf(T * d.hp);
  z.g2 = take(T * d.c);
  z.dyh = bf(T * d.kp);
  z.dyl = bf(T * d.kp);
  z.dout = bf(T * d.kp);
  z.dqkv = bf(T * d.n3);
  z.dsw = take(T * d.nh * d.n);
  z.part = take(d.chunks * part_size(d));
  if (b) *b = z;
  return off;
}

inline long long work_floats(const Dims& d) { return carve(d, nullptr, nullptr); }

struct BwdArgs {
  BlockW w;
  Dims d;
  Bufs b;
  const bf16* x;   // the block's input tokens (c per row) ...
  Rows xr;         // ... at these rows
  const bf16* dz;  // the output's cotangent
  Rows dzr;
  bf16* dx;        // the input's cotangent (out)
  Rows dxr;
  const float* dpf;  // (tokens, dp_stride) factor columns or null
  int dp_col;        // the attn column; the mlp column follows
  int dp_stride;
  int softmax;
  float* grads;  // grad_layout floats (out)
  float* dbias;  // (bw, n, nh n) (out)
};

// The attention operands of a block's forward recompute.
__host__ __device__ inline Attn attn_of(const BwdArgs& a) {
  return Attn{a.d, a.b.qkv, a.w.bias, a.w.bw, a.softmax, a.b.ao};
}

__device__ __forceinline__ float fa_of(const BwdArgs& a, int t) {
  return a.dpf ? a.dpf[static_cast<size_t>(t) * a.dp_stride + a.dp_col]
               : 1.0f;
}

__device__ __forceinline__ float fm_of(const BwdArgs& a, int t) {
  return a.dpf ? a.dpf[static_cast<size_t>(t) * a.dp_stride + a.dp_col + 1]
               : 1.0f;
}

// v as bf16 hi and lo = bf16(v - hi)
__device__ __forceinline__ void split(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

__device__ __forceinline__ float gelu_grad(float u) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  const float t = tanhf(k0 * (u + k1 * u * u * u));
  return 0.5f * (1.0f + t) +
         0.5f * u * (1.0f - t * t) * k0 * (1.0f + 3.0f * k1 * u * u);
}

// the same as hi and lo parts
__device__ __forceinline__ void acc_to_a2(uint32_t* hi, uint32_t* lo,
                                          const float* t0, const float* t1) {
  float l0[4], l1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    l0[u] = t0[u] - rb(t0[u]);
    l1[u] = t1[u] - rb(t1[u]);
  }
  acc_to_a(hi, t0, t1);
  acc_to_a(lo, l0, l1);
}

// q, k, v = bf16(xn Wqkv + bqkv), by head (pad channels 0: zero weights
// and bias there)

// u = x1n W1 + bf1: h1 = bf16(gelu(u)) (ones at hidden), gd = gelu'(u)
struct EpiFc1 {
  BwdArgs a;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    const Dims& d = a.d;
    each_pair<BN>(ct, m0, n0, d.tokens, d.hp,
                  [&](int m, int j, float v0, float v1) {
                    const float v[2] = {v0, v1};
                    float h[2], gg[2];
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                      h[u] = j + u == d.hidden ? 1.f : 0.f;
                      gg[u] = 0.f;
                      if (j + u < d.hidden) {
                        const float uu = v[u] + a.w.bf1[j + u];
                        h[u] = fastblk::gelu_tanh(uu);
                        gg[u] = gelu_grad(uu);
                      }
                    }
                    const size_t at = static_cast<size_t>(m) * d.hp + j;
                    st_bf2(a.b.h1 + at, h[0], h[1]);
                    *reinterpret_cast<float2*>(a.b.gd + at) =
                        make_float2(gg[0], gg[1]);
                  });
  }
};

// du = bf16(dh2 W2^T) gelu'(u), as hi + lo
struct EpiDu {
  BwdArgs a;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    const Dims& d = a.d;
    each_pair<BN>(ct, m0, n0, d.tokens, d.hp,
                  [&](int m, int j, float v0, float v1) {
                    const size_t at = static_cast<size_t>(m) * d.hp + j;
                    const float2 gg =
                        *reinterpret_cast<const float2*>(a.b.gd + at);
                    const float u0 = rb(v0) * gg.x, u1 = rb(v1) * gg.y;
                    st_bf2(a.b.duh + at, u0, u1);
                    st_bf2(a.b.dul + at, u0 - rb(u0), u1 - rb(u1));
                  });
  }
};

// g2 = dz + normalize VJP of LN2 at x1 for bf16(du W1^T); dy = fa g2 as
// hi + lo (a warp per row)
struct EpiLn2Bwd {
  BwdArgs a;
  template <int BN>
  __device__ void run(const float* ct, int m0, int) const {
    constexpr int ldc = BN + 4;
    const Dims& d = a.d;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kBM; r += blockDim.x >> 5) {
      const int m = m0 + r;
      if (m >= d.tokens) break;
      const float2 st = a.b.st2[m];
      const float mq = st.x * st.y;
      const float* x1 = a.b.x1 + static_cast<size_t>(m) * d.c;
      float dn[6], xh[6], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        dn[i] = xh[i] = 0.f;
        if (o < d.c) {
          dn[i] = rb(ct[r * ldc + o]);
          xh[i] = x1[o] * st.y - mq;
          s1 += dn[i];
          s2 += dn[i] * xh[i];
        }
      }
      const float m1 = fastblk::warp_sum(s1) / d.c;
      const float m2 = fastblk::warp_sum(s2) / d.c;
      const bf16* dz = a.dz + a.dzr(m, d.n) * d.c;
      const float f = fa_of(a, m);
      float* g2 = a.b.g2 + static_cast<size_t>(m) * d.c;
      const size_t at = static_cast<size_t>(m) * d.kp;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        if (o < d.c) {
          const float g = ldb(dz + o) + st.y * (dn[i] - m1 - xh[i] * m2);
          g2[o] = g;
          split(f * g, a.b.dyh + at + o, a.b.dyl + at + o);
        }
      }
      for (int o = d.c + lane; o < d.kp; o += 32)
        split(0.f, a.b.dyh + at + o, a.b.dyl + at + o);
    }
  }
};

// the attention output's cotangent bf16(dy Wproj^T) (pads 0)
struct EpiDout {
  BwdArgs a;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    const Dims& d = a.d;
    each_pair<BN>(ct, m0, n0, d.tokens, d.kp,
                  [&](int m, int j, float v0, float v1) {
                    st_bf2(a.b.dout + static_cast<size_t>(m) * d.kp + j,
                           j < d.c ? v0 : 0.f, j + 1 < d.c ? v1 : 0.f);
                  });
  }
};

// dx = bf16(g2 + normalize VJP of LN1 at x for bf16(dqkv Wqkv^T)), stored
// at the caller's rows (a warp per row)
struct EpiLn1Bwd {
  BwdArgs a;
  template <int BN>
  __device__ void run(const float* ct, int m0, int) const {
    constexpr int ldc = BN + 4;
    const Dims& d = a.d;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kBM; r += blockDim.x >> 5) {
      const int m = m0 + r;
      if (m >= d.tokens) break;
      const float2 st = a.b.st1[m];
      const float mq = st.x * st.y;
      const bf16* xr = a.x + a.xr(m, d.n) * d.c;
      float dn[6], xh[6], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        dn[i] = xh[i] = 0.f;
        if (o < d.c) {
          dn[i] = rb(ct[r * ldc + o]);
          xh[i] = ldb(xr + o) * st.y - mq;
          s1 += dn[i];
          s2 += dn[i] * xh[i];
        }
      }
      const float m1 = fastblk::warp_sum(s1) / d.c;
      const float m2 = fastblk::warp_sum(s2) / d.c;
      const float* g2 = a.b.g2 + static_cast<size_t>(m) * d.c;
      bf16* dx = a.dx + a.dxr(m, d.n) * d.c;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int o = lane + 32 * i;
        if (o < d.c)
          dx[o] = __float2bfloat16_rn(g2[o] +
                                      st.y * (dn[i] - m1 - xh[i] * m2));
      }
    }
  }
};

// ------------------------------------------------------ weight gradients

// The four X^T dY products in one launch: blockIdx.x walks the output
// tiles of every weight (64 x 128), blockIdx.z the token chunks; each
// block writes its chunk's partial tile.
struct WgradArgs {
  GemmArgs p[4];
  int first[5];  // first tile of each product; first[4] = all tiles
  int tiles_n[4];
  long long poff[4];
  long long psize;
  float* part;
};

constexpr int kWgradBN = 128;

__global__ void __launch_bounds__(kGemmThreads, 2)
    wgrad_kernel(const WgradArgs w) {
  extern __shared__ __align__(16) char smem[];
  int p = 0;
  while (p < 3 && static_cast<int>(blockIdx.x) >= w.first[p + 1]) ++p;
  const GemmArgs& g = w.p[p];
  const int tile = blockIdx.x - w.first[p];
  const int m0 = (tile / w.tiles_n[p]) * kBM;
  const int n0 = (tile % w.tiles_n[p]) * kWgradBN;
  const int kb = blockIdx.z * kChunkTokens;
  const int ke = min(kb + kChunkTokens, g.K);
  gemm_tile<kWgradBN, true, true>(g, m0, n0, kb, ke, smem);
  const float* ct = reinterpret_cast<const float*>(smem);
  constexpr int ldc = Tile<kWgradBN, true, true>::kLdC;
  float* out = w.part + blockIdx.z * w.psize + w.poff[p];
  for (int i = threadIdx.x; i < kBM * kWgradBN; i += blockDim.x) {
    const int r = i / kWgradBN, cc = i - r * kWgradBN;
    const int m = m0 + r, nn = n0 + cc;
    if (m < g.M && nn < g.N)
      out[static_cast<size_t>(m) * g.N + nn] = ct[r * ldc + cc];
  }
}

// The gradients in FastParams order: each the chunk partials summed,
// unpadded (a bias is its weight's ones row); then the bias cotangents,
// each the score cotangents of its bias window's windows summed. A block
// takes 32 outputs (a lane each); warp w sums the parts w, w + 8, ... in
// order, then warp 0 adds the 8 warp sums in order: a fixed order.
constexpr int kReduceOuts = 32;

__global__ void __launch_bounds__(256)
    reduce_kernel(const BwdArgs a, const WgradArgs w) {
  __shared__ float sums[8][kReduceOuts];
  const Dims& d = a.d;
  const Grads G = grad_layout(d.c, d.hidden);
  const int nb = d.n * d.nh * d.n;
  const long long total = G.total + static_cast<long long>(a.w.bw) * nb;
  const int c = d.c, hid = d.hidden;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kReduceOuts + lane;
  float acc = 0.f;
  if (i >= G.total && i < total) {
    const long long e = i - G.total;
    const int b = static_cast<int>(e / nb), rest = static_cast<int>(e % nb);
    for (int win = b + warp * a.w.bw; win < d.windows; win += 8 * a.w.bw)
      acc += a.b.dsw[static_cast<size_t>(win) * nb + rest];
  } else if (i < G.total) {
    const int k = static_cast<int>(i);
    auto qcol = [&](int j) {
      const int part = j / c, ch = j - part * c, h = ch / d.hd;
      return part * d.nh * d.hdg + h * d.hdg + ch - h * d.hd;
    };
    int p, row, col;
    if (k < G.bqkv) {
      p = 0, row = k / (3 * c), col = qcol(k % (3 * c));
    } else if (k < G.wproj) {
      p = 0, row = c, col = qcol(k - G.bqkv);
    } else if (k < G.bproj) {
      p = 1, row = (k - G.wproj) / c, col = (k - G.wproj) % c;
    } else if (k < G.w1) {
      p = 1, row = c, col = k - G.bproj;
    } else if (k < G.bf1) {
      p = 2, row = (k - G.w1) / hid, col = (k - G.w1) % hid;
    } else if (k < G.w2) {
      p = 2, row = c, col = k - G.bf1;
    } else if (k < G.bf2) {
      p = 3, row = (k - G.w2) / c, col = (k - G.w2) % c;
    } else {
      p = 3, row = hid, col = k - G.bf2;
    }
    const float* src = w.part + w.poff[p] +
                       static_cast<size_t>(row) * w.p[p].N + col;
    for (int z = warp; z < d.chunks; z += 8) acc += src[z * w.psize];
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < total) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += sums[q][lane];
    if (i < G.total)
      a.grads[i] = v;
    else
      a.dbias[i - G.total] = v;
  }
}

// ------------------------------------------------------- row kernels

// The weights padded: Wqkv (kp, n3) by head, Wproj (kp, kp), W1 (kp, hp),
// W2 (hp, kp), and the qkv bias (n3) by head; zeros in every pad.
__global__ void prep_weights_kernel(const BwdArgs a) {
  const Dims& d = a.d;
  const long long s0 = static_cast<long long>(d.kp) * d.n3;
  const long long s1 = s0 + static_cast<long long>(d.kp) * d.kp;
  const long long s2 = s1 + static_cast<long long>(d.kp) * d.hp;
  const long long s3 = s2 + static_cast<long long>(d.hp) * d.kp;
  const long long s4 = s3 + d.n3;
  const int c = d.c, hid = d.hidden, hw = d.nh * d.hdg;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < s4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    if (i < s0) {
      const int row = static_cast<int>(i / d.n3), col = static_cast<int>(i % d.n3);
      const int part = col / hw, h = (col - part * hw) / d.hdg;
      const int dd = col - part * hw - h * d.hdg;
      if (row < c && dd < d.hd)
        v = ldb(a.w.wqkv + static_cast<size_t>(row) * 3 * c + part * c +
                h * d.hd + dd);
      a.b.wqkv[i] = __float2bfloat16_rn(v);
    } else if (i < s1) {
      const long long e = i - s0;
      const int row = static_cast<int>(e / d.kp), col = static_cast<int>(e % d.kp);
      if (row < c && col < c) v = ldb(a.w.wproj + row * c + col);
      a.b.wproj[e] = __float2bfloat16_rn(v);
    } else if (i < s2) {
      const long long e = i - s1;
      const int row = static_cast<int>(e / d.hp), col = static_cast<int>(e % d.hp);
      if (row < c && col < hid) v = ldb(a.w.w1 + row * hid + col);
      a.b.w1[e] = __float2bfloat16_rn(v);
    } else if (i < s3) {
      const long long e = i - s2;
      const int row = static_cast<int>(e / d.kp), col = static_cast<int>(e % d.kp);
      if (row < hid && col < c) v = ldb(a.w.w2 + row * c + col);
      a.b.w2[e] = __float2bfloat16_rn(v);
    } else {
      const int col = static_cast<int>(i - s3);
      const int part = col / hw, h = (col - part * hw) / d.hdg;
      const int dd = col - part * hw - h * d.hdg;
      a.b.bqkv[col] = dd < d.hd ? a.w.bqkv[part * c + h * d.hd + dd] : 0.f;
    }
  }
}

// LN1 (statistics and xn, ones at c) and dh2 = fm dz as hi + lo: a warp
// per token, gathered at the caller's rows.
__global__ void __launch_bounds__(256) rows_kernel(const BwdArgs a) {
  const Dims& d = a.d;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= d.tokens) return;
  const bf16* xr = a.x + a.xr(m, d.n) * d.c;
  float v[6], s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = lane + 32 * i;
    v[i] = o < d.c ? ldb(xr + o) : 0.f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = fastblk::warp_sum(s);
  s2 = fastblk::warp_sum(s2);
  const float mu = s / d.c;
  const float q = rsqrtf(fmaxf(s2 / d.c - mu * mu, 0.f) + fastblk::kEps);
  const float mq = mu * q;
  const size_t at = static_cast<size_t>(m) * d.kp;
  const bf16* dz = a.dz + a.dzr(m, d.n) * d.c;
  const float f = fm_of(a, m);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = lane + 32 * i;
    if (o < d.c) {
      a.b.xn[at + o] = __float2bfloat16_rn(v[i] * q - mq);
      split(f * ldb(dz + o), a.b.dh2h + at + o, a.b.dh2l + at + o);
    }
  }
  for (int o = d.c + lane; o < d.kp; o += 32) {
    a.b.xn[at + o] = __float2bfloat16_rn(o == d.c ? 1.f : 0.f);
    split(0.f, a.b.dh2h + at + o, a.b.dh2l + at + o);
  }
  if (lane == 0) a.b.st1[m] = make_float2(mu, q);
}

// ------------------------------------------------------------ attention

// The VJP of (window, head): from the output cotangent dO, the
// normalizer's cotangent dden = bf16(-sum_d dO o / den), dA = dO / den,
// dP = dA V^T, the score cotangent ds = bf16(bf16(dP) + dden) e (clamp: 0
// where s > 60; stable: minus its row sum added to the row max's ties,
// split evenly; stable_mm: that sum rounded first), then dq = bf16(ds k),
// dk = bf16(ds^T q), dv = bf16(bf16(e)^T dA). Products with an f32
// operand (dA, ds) take it as bf16 hi + lo. The score cotangents go to
// dsw per window, in the packed bias layout. Four blocks an SM where the
// shared memory allows it (heads of up to 16 channels).
__global__ void __launch_bounds__(kAttnThreads, 4)
    attn_vjp_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const Dims& d = a.d;
  const AttnSmem L = attn_smem(d, true);
  const int n = d.n, nkt = n / 8, ldh = d.hds + 8, ldn = n + 8;
  const int win = blockIdx.x / d.nh, h = blockIdx.x - win * d.nh;
  const size_t t0 = static_cast<size_t>(win) * n;
  load_qkv(attn_of(a), sm, L, win, h);
  for (int i = threadIdx.x; i < n * d.hds; i += blockDim.x) {
    const int r = i / d.hds, dd = i - r * d.hds;
    sm[L.dout + r * ldh + dd] =
        dd < d.hd ? a.b.dout[(t0 + r) * d.kp + h * d.hd + dd]
                  : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const size_t hw = static_cast<size_t>(d.nh) * d.hdg;
  if (r0 < n) {
    AttnRows R;
    attn_rows<false>(attn_of(a), sm, L, win, h, r0, R);
    // the masks: s past the clamp, s equal to its row's (raw) max
    const bool clamp = a.softmax == fastblk::kClampOnly;
    float mx0 = -3.0e38f, mx1 = -3.0e38f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nkt) {
        mx0 = fmaxf(mx0, fmaxf(R.s[j][0], R.s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(R.s[j][2], R.s[j][3]));
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    uint32_t over = 0u, tie = 0u;  // bit 4 j + u
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nkt) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (R.s[j][u] > fastblk::kClamp) over |= 1u << (4 * j + u);
          if (R.s[j][u] == (u < 2 ? mx0 : mx1)) tie |= 1u << (4 * j + u);
        }
      }
    }
    // P = bf16(e) for dv, kept in shared memory
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nkt) {
        const int col = j * 8 + 2 * t4;
        st_bf2(sm + L.p + (r0 + gr) * ldn + col, R.e[j][0], R.e[j][1]);
        st_bf2(sm + L.p + (r0 + gr + 8) * ldn + col, R.e[j][2], R.e[j][3]);
      }
    }
    // dO in the accumulator layout; dden; dA = dO / den
    float da[4][4], q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int dd = dt * 8 + 2 * t4;
      if (dd < d.hds) {
        const bf16* p0 = sm + L.dout + (r0 + gr) * ldh + dd;
        const bf16* p1 = p0 + 8 * ldh;
        const float g0 = ldb(p0), g1 = ldb(p0 + 1);
        const float g2 = ldb(p1), g3 = ldb(p1 + 1);
        q0 += g0 * R.o[dt][0] + g1 * R.o[dt][1];
        q1 += g2 * R.o[dt][2] + g3 * R.o[dt][3];
        da[dt][0] = g0 / R.den0;
        da[dt][1] = g1 / R.den0;
        da[dt][2] = g2 / R.den1;
        da[dt][3] = g3 / R.den1;
      } else {
        da[dt][0] = da[dt][1] = da[dt][2] = da[dt][3] = 0.f;
      }
    }
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    const float dden0 = rb(-q0 / R.den0), dden1 = rb(-q1 / R.den1);
    // dA as hi + lo: the A operands of dP = dA V^T, and stored for dv
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      acc_to_a2(ah[ks], al[ks], da[2 * ks], da[2 * ks + 1]);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int dd = dt * 8 + 2 * t4;
      if (dd < d.hds) {
        const int i0 = (r0 + gr) * ldh + dd, i1 = i0 + 8 * ldh;
        st_bf2(sm + L.dah + i0, da[dt][0], da[dt][1]);
        st_bf2(sm + L.dah + i1, da[dt][2], da[dt][3]);
        st_bf2(sm + L.dal + i0, da[dt][0] - rb(da[dt][0]),
               da[dt][1] - rb(da[dt][1]));
        st_bf2(sm + L.dal + i1, da[dt][2] - rb(da[dt][2]),
               da[dt][3] - rb(da[dt][3]));
      }
    }
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks * 16 < d.hds) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (2 * jp < nkt) {
            uint32_t vb[4];
            frag_b(vb, sm + L.v, ldh, jp * 16, ks * 16);
            mma(ds[2 * jp], ah[ks], vb[0], vb[1]);
            mma(ds[2 * jp], al[ks], vb[0], vb[1]);
            mma(ds[2 * jp + 1], ah[ks], vb[2], vb[3]);
            mma(ds[2 * jp + 1], al[ks], vb[2], vb[3]);
          }
        }
      }
    }
    // ds from dP, with the clamp mask or the tie split of the row max
    float tot0 = 0.f, tot1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nkt) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v = rb(rb(ds[j][u]) + (u < 2 ? dden0 : dden1)) * R.e[j][u];
          if (clamp && (over >> (4 * j + u) & 1u)) v = 0.f;
          ds[j][u] = v;
          if (u < 2)
            tot0 += v;
          else
            tot1 += v;
        }
      }
    }
    if (!clamp) {
      int n0 = 0, n1 = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        n0 += (tie >> (4 * j) & 1u) + (tie >> (4 * j + 1) & 1u);
        n1 += (tie >> (4 * j + 2) & 1u) + (tie >> (4 * j + 3) & 1u);
      }
      tot0 += __shfl_xor_sync(0xffffffffu, tot0, 1);
      tot0 += __shfl_xor_sync(0xffffffffu, tot0, 2);
      tot1 += __shfl_xor_sync(0xffffffffu, tot1, 1);
      tot1 += __shfl_xor_sync(0xffffffffu, tot1, 2);
      n0 += __shfl_xor_sync(0xffffffffu, n0, 1);
      n0 += __shfl_xor_sync(0xffffffffu, n0, 2);
      n1 += __shfl_xor_sync(0xffffffffu, n1, 1);
      n1 += __shfl_xor_sync(0xffffffffu, n1, 2);
      float dm0 = -tot0, dm1 = -tot1;
      if (a.softmax == fastblk::kStableMM) {
        dm0 = rb(dm0);
        dm1 = rb(dm1);
      }
      dm0 /= n0;
      dm1 /= n1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (tie >> (4 * j + u) & 1u) ds[j][u] += u < 2 ? dm0 : dm1;
      }
    }
    // ds: to dsw, to shared memory as hi + lo (for dk), as A operands
    // (for dq)
    float* w0 = a.b.dsw + ((t0 + r0 + gr) * d.nh + h) * n;
    float* w1 = w0 + static_cast<size_t>(8) * d.nh * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nkt) {
        const int col = j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(w0 + col) = make_float2(ds[j][0], ds[j][1]);
        *reinterpret_cast<float2*>(w1 + col) = make_float2(ds[j][2], ds[j][3]);
        const int i0 = (r0 + gr) * ldn + col, i1 = i0 + 8 * ldn;
        st_bf2(sm + L.dsh + i0, ds[j][0], ds[j][1]);
        st_bf2(sm + L.dsh + i1, ds[j][2], ds[j][3]);
        st_bf2(sm + L.dsl + i0, ds[j][0] - rb(ds[j][0]),
               ds[j][1] - rb(ds[j][1]));
        st_bf2(sm + L.dsl + i1, ds[j][2] - rb(ds[j][2]),
               ds[j][3] - rb(ds[j][3]));
      }
    }
    float dq[4][4];
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 < n) {
        uint32_t sh[4], sl[4];
        acc_to_a2(sh, sl, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          if (dp * 16 < d.hds) {
            uint32_t kb[4];
            frag_bt(kb, sm + L.k, ldh, dp * 16, kk * 16);
            mma(dq[2 * dp], sh, kb[0], kb[1]);
            mma(dq[2 * dp], sl, kb[0], kb[1]);
            mma(dq[2 * dp + 1], sh, kb[2], kb[3]);
            mma(dq[2 * dp + 1], sl, kb[2], kb[3]);
          }
        }
      }
    }
    bf16* q0p = a.b.dqkv + (t0 + r0 + gr) * d.n3 + h * d.hdg;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int dd = dt * 8 + 2 * t4;
      if (dd < d.hdg) {
        st_bf2(q0p + dd, dq[dt][0], dq[dt][1]);
        st_bf2(q0p + 8 * d.n3 + dd, dq[dt][2], dq[dt][3]);
      }
    }
  }
  __syncthreads();
  // dk and dv: warp w owns key rows j0 = 16 w
  const int j0 = warp * 16;
  if (j0 >= n) return;
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk * 16 < n) {
      uint32_t sh[4], sl[4], pa[4];
      frag_at(sh, sm + L.dsh, ldn, j0, kk * 16);
      frag_at(sl, sm + L.dsl, ldn, j0, kk * 16);
      frag_at(pa, sm + L.p, ldn, j0, kk * 16);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        if (dp * 16 < d.hds) {
          uint32_t qb[4], ab[4], lb[4];
          frag_bt(qb, sm + L.q, ldh, dp * 16, kk * 16);
          frag_bt(ab, sm + L.dah, ldh, dp * 16, kk * 16);
          frag_bt(lb, sm + L.dal, ldh, dp * 16, kk * 16);
          mma(dk[2 * dp], sh, qb[0], qb[1]);
          mma(dk[2 * dp], sl, qb[0], qb[1]);
          mma(dk[2 * dp + 1], sh, qb[2], qb[3]);
          mma(dk[2 * dp + 1], sl, qb[2], qb[3]);
          mma(dv[2 * dp], pa, ab[0], ab[1]);
          mma(dv[2 * dp], pa, lb[0], lb[1]);
          mma(dv[2 * dp + 1], pa, ab[2], ab[3]);
          mma(dv[2 * dp + 1], pa, lb[2], lb[3]);
        }
      }
    }
  }
  bf16* k0p = a.b.dqkv + (t0 + j0 + gr) * d.n3 + hw + h * d.hdg;
  bf16* v0p = k0p + hw;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int dd = dt * 8 + 2 * t4;
    if (dd < d.hdg) {
      st_bf2(k0p + dd, dk[dt][0], dk[dt][1]);
      st_bf2(k0p + 8 * d.n3 + dd, dk[dt][2], dk[dt][3]);
      st_bf2(v0p + dd, dv[dt][0], dv[dt][1]);
      st_bf2(v0p + 8 * d.n3 + dd, dv[dt][2], dv[dt][3]);
    }
  }
}

// ------------------------------------------------------------------ host

inline WgradArgs wgrad_args(const BwdArgs& a) {
  const Dims& d = a.d;
  const Bufs& b = a.b;
  const int T = d.tokens;
  WgradArgs w;
  w.p[0] = gemm_args(b.xn, nullptr, d.kp, b.dqkv, nullptr, d.n3, d.kp,
                     d.n3, T);
  w.p[1] = gemm_args(b.ao, nullptr, d.kp, b.dyh, b.dyl, d.kp, d.kp, d.kp, T);
  w.p[2] = gemm_args(b.x1n, nullptr, d.kp, b.duh, b.dul, d.hp, d.kp, d.hp,
                     T);
  w.p[3] = gemm_args(b.h1, nullptr, d.hp, b.dh2h, b.dh2l, d.kp, d.hp, d.kp,
                     T);
  w.first[0] = 0;
  long long off = 0;
  for (int p = 0; p < 4; ++p) {
    w.tiles_n[p] = (w.p[p].N + kWgradBN - 1) / kWgradBN;
    w.first[p + 1] = w.first[p] + w.tiles_n[p] * ((w.p[p].M + kBM - 1) / kBM);
    w.poff[p] = off;
    off += static_cast<long long>(w.p[p].M) * w.p[p].N;
  }
  w.psize = off;
  w.part = b.part;
  return w;
}

// One block's backward: kBwdKernels launches on stream s, each checked.
// Returns a cudaError_t.
inline cudaError_t block_backward(const BwdArgs& a, cudaStream_t s) {
  const Dims& d = a.d;
  const Bufs& b = a.b;
  const int T = d.tokens, kp = d.kp, hp = d.hp, n3 = d.n3;
  cudaError_t err;
#define RDST_CHECK(expr)                     \
  do {                                       \
    err = (expr);                            \
    if (err != cudaSuccess) return err;      \
  } while (0)
  prep_weights_kernel<<<264, 256, 0, s>>>(a);
  RDST_CHECK(cudaGetLastError());
  rows_kernel<<<(T + 7) / 8, 256, 0, s>>>(a);
  RDST_CHECK(cudaGetLastError());
  RDST_CHECK((run_gemm<128, false, true>(
      gemm_args(b.xn, nullptr, kp, b.wqkv, nullptr, n3, T, n3, kp),
      EpiQkv{b.qkv, b.bqkv, T, n3}, s)));
  const AttnSmem fw = attn_smem(d, false), bw = attn_smem(d, true);
  RDST_CHECK(cudaFuncSetAttribute(
      attn_fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fw.bytes));
  attn_fwd_kernel<false><<<d.windows * d.nh, kAttnThreads, fw.bytes, s>>>(
      attn_of(a));
  RDST_CHECK(cudaGetLastError());
  RDST_CHECK((run_rows<false, true>(
      gemm_args(b.ao, nullptr, kp, b.wproj, nullptr, kp, T, kp, kp),
      EpiProjLn{d, a.x, a.xr, a.w.bproj, a.dpf, a.dp_col, a.dp_stride, b.x1,
                b.x1n, b.st2, d.c},
      s)));
  RDST_CHECK((run_gemm<128, false, true>(
      gemm_args(b.x1n, nullptr, kp, b.w1, nullptr, hp, T, hp, kp),
      EpiFc1{a}, s)));
  RDST_CHECK((run_gemm<128, false, false>(
      gemm_args(b.dh2h, b.dh2l, kp, b.w2, nullptr, kp, T, hp, kp),
      EpiDu{a}, s)));
  RDST_CHECK((run_rows<false, false>(
      gemm_args(b.duh, b.dul, hp, b.w1, nullptr, hp, T, kp, hp),
      EpiLn2Bwd{a}, s)));
  RDST_CHECK((run_gemm<128, false, false>(
      gemm_args(b.dyh, b.dyl, kp, b.wproj, nullptr, kp, T, kp, kp),
      EpiDout{a}, s)));
  RDST_CHECK(cudaFuncSetAttribute(
      attn_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bw.bytes));
  attn_vjp_kernel<<<d.windows * d.nh, kAttnThreads, bw.bytes, s>>>(a);
  RDST_CHECK(cudaGetLastError());
  RDST_CHECK((run_rows<false, false>(
      gemm_args(b.dqkv, nullptr, n3, b.wqkv, nullptr, n3, T, kp, n3),
      EpiLn1Bwd{a}, s)));
  const WgradArgs w = wgrad_args(a);
  constexpr int wsmem = Tile<kWgradBN, true, true>::kSmem;
  RDST_CHECK(cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wsmem));
  wgrad_kernel<<<dim3(w.first[4], 1, d.chunks), kGemmThreads, wsmem, s>>>(w);
  RDST_CHECK(cudaGetLastError());
  const long long total = grad_layout(d.c, d.hidden).total +
                          static_cast<long long>(a.w.bw) * d.n * d.nh * d.n;
  reduce_kernel<<<static_cast<int>((total + kReduceOuts - 1) / kReduceOuts),
                  256, 0, s>>>(a, w);
  RDST_CHECK(cudaGetLastError());
#undef RDST_CHECK
  return cudaSuccess;
}

// Fills the parts of a block's BwdArgs that both train kernels share.
inline void set_block(BwdArgs* a, const void* const* wp, int bw,
                      const Dims& d, float* work, int softmax) {
  a->w.wqkv = static_cast<const bf16*>(wp[0]);
  a->w.bqkv = static_cast<const float*>(wp[1]);
  a->w.wproj = static_cast<const bf16*>(wp[2]);
  a->w.bproj = static_cast<const bf16*>(wp[3]);
  a->w.w1 = static_cast<const bf16*>(wp[4]);
  a->w.bf1 = static_cast<const float*>(wp[5]);
  a->w.w2 = static_cast<const bf16*>(wp[6]);
  a->w.bf2 = static_cast<const bf16*>(wp[7]);
  a->w.bias = static_cast<const bf16*>(wp[8]);
  a->w.bw = bw;
  a->d = d;
  carve(d, work, &a->b);
  a->softmax = softmax;
}

}  // namespace trainblk
