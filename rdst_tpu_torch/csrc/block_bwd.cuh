// One Swin block's backward for the bf16 training kernels (sm_90a):
// shared by csrc/pair_train.cu (the two blocks of a DSTL pair) and
// csrc/block_train.cu (one block).
//
// `block_bwd_kernel` runs one window per thread block (a grid-stride loop
// over windows). Like the TPU kernels (`jax.vjp` of the body inside the
// backward pallas_call), each window's forward is recomputed, then the
// VJP of the same math runs in the window: the MLP (tanh-GELU
// derivative), the affine-free normalize, the projection, the per-head
// softmax (exact division; clamp: no gradient where s > 60; stable: the
// gradient through the row max, split among its ties), q/k/v and the
// packed bias. Cotangents are rounded to bf16 wherever the forward holds
// a bf16 value, as autodiff of the bf16 body does. The block's input and
// output cotangent are read and written in window layout, or gathered
// from / scattered into an image-layout tensor at rolled positions (the
// pair's relayout, a permutation). Weight and bias gradients are
// accumulated in f32 per thread block and summed over thread blocks in a
// fixed order by `sum_parts_kernel`, so a step is deterministic (no float
// atomics); the per-window score cotangents are summed per bias window
// the same way.
//
// What bounds it on an H100: operations (about twice the forward's
// products, plus the recompute). The products run on the tensor cores
// (block_gemm: mma.sync, f32 operands split into bf16 hi + lo), but the
// window's intermediates live in an L2-backed global workspace of the
// thread block and its row passes take a thread per row, so staging and
// latency, not the products, bound this first version.

#pragma once

#include "fast_block.cuh"

namespace trainblk {

using fastblk::bf16;

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

// Offsets (floats) of one thread block's workspace.
struct Work {
  int x, xn, qkv, s, e, den, o, x1, x1n, u, h1, st, g, du, dt, dqkv, dden,
      da;
  int total;
};

__host__ __device__ inline Work work_layout(int n, int c, int nh, int hid) {
  Work L;
  int off = 0;
  int* const fields[] = {&L.x, &L.xn, &L.qkv, &L.s, &L.e, &L.den, &L.o,
                         &L.x1, &L.x1n, &L.u, &L.h1, &L.st, &L.g, &L.du,
                         &L.dt, &L.dqkv, &L.dden, &L.da};
  const int sizes[] = {n * c, n * c, 3 * n * c, nh * n * n, nh * n * n,
                       nh * n, n * c, n * c, n * c, n * hid, n * hid, 4 * n,
                       n * c, n * hid, n * c, 3 * n * c, nh * n,
                       nh * n * n};
  for (int i = 0; i < 18; ++i) {
    *fields[i] = off;
    off += (sizes[i] + 31) / 32 * 32;  // 128-byte aligned buffers
  }
  L.total = off;
  return L;
}

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

struct BwdArgs {
  BlockW w;
  // the block's input tokens: window layout (x_win) or gathered from an
  // image-layout tensor (x_img) at the rolled positions of img_shift
  const bf16* x_win;
  const bf16* x_img;
  const bf16* dz_win;  // cotangent of the output, window layout, or
  const bf16* dz_img;  // gathered from an image-layout tensor
  bf16* dx_win;        // cotangent of the input, window layout, or
  bf16* dx_img;        // scattered into an image-layout tensor
  const float* dpf;    // (windows * n, dp_stride) or null
  int dp_col;          // the attn column; the mlp column follows
  int dp_stride;       // columns of dpf: 4 (a pair's), 2 (one block's)
  float* work;         // gridDim.x * work_layout(...).total
  float* slab;         // gridDim.x * grad_layout(...).total, zeroed
  float* dsw;          // (windows, n, nh * n) score cotangents
  int windows, n, c, nh, hidden, ih, iw, ws, img_shift, softmax;
};

__device__ __forceinline__ float ldb(const bf16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float rb(float v) {
  return fastblk::round_bf16(v);
}

template <class F>
__device__ __forceinline__ void each(int total, F f) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) f(i);
}

// The thread block's product: epi(m, n, sum_k a(m, k) b(k, n)) for
// m < M, n < N, on the tensor cores. C tiles of 64 x 64: warp w owns rows
// 16 (w / 2).. and columns 32 (w % 2).., four m16n8k16 tiles, f32
// accumulators. Per 16-deep slice the operands are staged in shared
// memory as bf16 (`tile`: kTileBytes) through the accessors a and b,
// which read the workspace and the weights in whatever layout they have.
// An operand that is not a bf16 value (SA, SB: the f32 cotangents) is
// split into hi + lo bf16 parts and the product takes hi*hi + hi*lo +
// lo*hi, about 16 bits of mantissa: f32 products to the rounding the
// gradients need. Starts and ends with __syncthreads().
constexpr int kTM = 64, kTK = 16, kLd = kTK + 8;  // 48-byte smem rows
constexpr int kTileBytes = 4 * kTM * kLd * 2;

template <bool SA, bool SB, class FA, class FB, class Epi>
__device__ void block_gemm(int M, int N, int K, FA a, FB b, Epi epi,
                           bf16* tile) {
  bf16* Ah = tile;  // [64 m][kLd]
  bf16* Al = Ah + kTM * kLd;
  bf16* Bh = Al + kTM * kLd;  // [64 n][kLd]
  bf16* Bl = Bh + kTM * kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  for (int m0 = 0; m0 < M; m0 += kTM) {
    for (int n0 = 0; n0 < N; n0 += kTM) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kTK) {
        __syncthreads();
        for (int i = tid; i < kTK * kTM; i += blockDim.x) {
          const int mm = i >> 4, kk = i & 15;  // A: neighbours along k
          const int k = k0 + kk;
          const float va = (m0 + mm < M && k < K) ? a(m0 + mm, k) : 0.f;
          const bf16 ha = __float2bfloat16_rn(va);
          Ah[mm * kLd + kk] = ha;
          if (SA) Al[mm * kLd + kk] =
              __float2bfloat16_rn(va - __bfloat162float(ha));
          const int kb = i >> 6, nn = i & 63;  // B: neighbours along n
          const float vb =
              (n0 + nn < N && k0 + kb < K) ? b(k0 + kb, n0 + nn) : 0.f;
          const bf16 hb = __float2bfloat16_rn(vb);
          Bh[nn * kLd + kb] = hb;
          if (SB) Bl[nn * kLd + kb] =
              __float2bfloat16_rn(vb - __bfloat162float(hb));
        }
        __syncthreads();
        const bf16* ar = Ah + (wr + g) * kLd + 2 * t;
        const uint32_t a0 = fastblk::ld32(ar), a1 = fastblk::ld32(ar + 8 * kLd),
                       a2 = fastblk::ld32(ar + 8),
                       a3 = fastblk::ld32(ar + 8 * kLd + 8);
        uint32_t l0 = 0, l1 = 0, l2 = 0, l3 = 0;
        if (SA) {
          const bf16* lr = Al + (wr + g) * kLd + 2 * t;
          l0 = fastblk::ld32(lr);
          l1 = fastblk::ld32(lr + 8 * kLd);
          l2 = fastblk::ld32(lr + 8);
          l3 = fastblk::ld32(lr + 8 * kLd + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* br = Bh + (wc + nt * 8 + g) * kLd + 2 * t;
          const uint32_t b0 = fastblk::ld32(br), b1 = fastblk::ld32(br + 8);
          fastblk::mma16816(acc[nt], a0, a1, a2, a3, b0, b1);
          if (SA) fastblk::mma16816(acc[nt], l0, l1, l2, l3, b0, b1);
          if (SB) {
            const bf16* bl = Bl + (wc + nt * 8 + g) * kLd + 2 * t;
            fastblk::mma16816(acc[nt], a0, a1, a2, a3, fastblk::ld32(bl),
                              fastblk::ld32(bl + 8));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r0 = m0 + wr + g, col = n0 + wc + nt * 8 + 2 * t;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = r0 + (u >> 1) * 8, nn = col + (u & 1);
          if (m < M && nn < N) epi(m, nn, acc[nt][u]);
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float gelu_grad(float u) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  const float t = tanhf(k0 * (u + k1 * u * u * u));
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * k0 *
                                 (1.0f + 3.0f * k1 * u * u);
}

// Per-row moments of the affine-free normalize (one thread per row):
// st[r] = mean, st[n + r] = rsqrt(max(E[x^2] - mean^2, 0) + eps).
__device__ inline void row_stats(const float* x, float* st, int n, int c) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float s = 0.f, s2 = 0.f;
    for (int k = 0; k < c; ++k) {
      const float v = x[r * c + k];
      s += v;
      s2 += v * v;
    }
    const float mu = s / c;
    st[r] = mu;
    st[n + r] = rsqrtf(fmaxf(s2 / c - mu * mu, 0.f) + fastblk::kEps);
  }
}

// dx += VJP of the normalize at x (stats st) for the cotangent dn of its
// output: a (dn - mean(dn) - xhat mean(dn xhat)). One thread per row.
__device__ inline void normalize_bwd(const float* x, const float* st,
                                     const float* dn, float* dx, int n,
                                     int c) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float mu = st[r], a = st[n + r];
    float m1 = 0.f, m2 = 0.f;
    for (int k = 0; k < c; ++k) {
      const float xh = x[r * c + k] * a - mu * a;
      m1 += dn[r * c + k];
      m2 += dn[r * c + k] * xh;
    }
    m1 /= c;
    m2 /= c;
    for (int k = 0; k < c; ++k) {
      const float xh = x[r * c + k] * a - mu * a;
      dx[r * c + k] += a * (dn[r * c + k] - m1 - xh * m2);
    }
  }
}

// Column sums of an (n, cols) workspace matrix, scaled per row by f(r),
// added to out.
template <class F>
__device__ inline void col_sums(const float* x, int n, int cols, F f,
                                float* out) {
  each(cols, [&](int j) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r) acc += f(r) * x[r * cols + j];
    out[j] += acc;
  });
}

__global__ void __launch_bounds__(256, 3)
    block_bwd_kernel(const BwdArgs a) {
  __shared__ __align__(16) bf16 tile[kTileBytes / 2];
  const int n = a.n, c = a.c, nh = a.nh, hid = a.hidden;
  const int hd = c / nh, c3 = 3 * c, nn = n * n;
  const Work L = work_layout(n, c, nh, hid);
  const Grads GL = grad_layout(c, hid);
  float* wk = a.work + static_cast<size_t>(blockIdx.x) * L.total;
  float* slab = a.slab + static_cast<size_t>(blockIdx.x) * GL.total;
  float *X = wk + L.x, *XN = wk + L.xn, *QKV = wk + L.qkv, *S = wk + L.s;
  float *E = wk + L.e, *DEN = wk + L.den, *O = wk + L.o, *X1 = wk + L.x1;
  float *X1N = wk + L.x1n, *U = wk + L.u, *H1 = wk + L.h1, *ST = wk + L.st;
  float *G = wk + L.g, *DU = wk + L.du, *DT = wk + L.dt;
  float *DQKV = wk + L.dqkv, *DDEN = wk + L.dden, *DA = wk + L.da;
  const BlockW& W = a.w;
  const int nww = a.iw / a.ws, nw = (a.ih / a.ws) * nww;
  auto one = [](int) { return 1.0f; };

  for (int win = blockIdx.x; win < a.windows; win += gridDim.x) {
    const int img = win / nw, wi = win - img * nw;
    const int oy = (wi / nww) * a.ws + a.img_shift;
    const int ox = (wi % nww) * a.ws + a.img_shift;
    // the image-layout element of (row r, channel ch) of this window
    auto img_at = [&](int r, int ch) {
      const int yy = (oy + r / a.ws) % a.ih, xx = (ox + r % a.ws) % a.iw;
      return ((static_cast<size_t>(img) * a.ih + yy) * a.iw + xx) * c + ch;
    };
    const size_t wbase = static_cast<size_t>(win) * n * c;
    const float* dp = a.dpf ? a.dpf + static_cast<size_t>(win) * n *
                                      a.dp_stride + a.dp_col
                            : nullptr;
    auto fa = [&](int r) { return dp ? dp[a.dp_stride * r] : 1.0f; };
    auto fm = [&](int r) { return dp ? dp[a.dp_stride * r + 1] : 1.0f; };
    const int bwin = W.bw == 1 ? 0 : wi % W.bw;
    const bf16* bias = W.bias + static_cast<size_t>(bwin) * n * nh * n;

    // ---- the forward, recomputed
    __syncthreads();
    each(n * c, [&](int i) {
      const int r = i / c, ch = i - r * c;
      X[i] = a.x_win ? ldb(a.x_win + wbase + i) : ldb(a.x_img + img_at(r, ch));
    });
    __syncthreads();
    row_stats(X, ST, n, c);
    __syncthreads();
    each(n * c, [&](int i) {
      const int r = i / c;
      const float mu = ST[r], s = ST[n + r];
      XN[i] = rb(X[i] * s - mu * s);
    });
    block_gemm<false, false>(
        n, c3, c, [&](int m, int k) { return XN[m * c + k]; },
        [&](int k, int j) { return ldb(W.wqkv + k * c3 + j); },
        [&](int m, int j, float v) { QKV[m * c3 + j] = rb(v + W.bqkv[j]); },
        tile);
    for (int hh = 0; hh < nh; ++hh)
      block_gemm<false, false>(
          n, n, hd,
          [&](int r, int d) { return QKV[r * c3 + hh * hd + d]; },
          [&](int d, int j) { return QKV[j * c3 + c + hh * hd + d]; },
          [&](int r, int j, float v) {
            S[(hh * n + r) * n + j] = v + ldb(bias + (r * nh + hh) * n + j);
          },
          tile);
    each(nh * n, [&](int i) {
      const float* s = S + i * n;
      float m = -3.0e38f;
      for (int j = 0; j < n; ++j) m = fmaxf(m, s[j]);
      if (a.softmax == fastblk::kStableMM) m = rb(m);
      float den = 0.f;
      for (int j = 0; j < n; ++j) {
        const float e = a.softmax == fastblk::kClampOnly
                            ? expf(fminf(s[j], fastblk::kClamp))
                            : expf(s[j] - m);
        E[i * n + j] = e;
        den += rb(e);
      }
      DEN[i] = rb(den);
    });
    for (int hh = 0; hh < nh; ++hh)
      block_gemm<false, false>(
          n, hd, n, [&](int r, int j) { return rb(E[(hh * n + r) * n + j]); },
          [&](int j, int d) { return QKV[j * c3 + 2 * c + hh * hd + d]; },
          [&](int r, int d, float v) {
            O[r * c + hh * hd + d] = v / DEN[hh * n + r];
          },
          tile);
    block_gemm<false, false>(
        n, c, c, [&](int r, int k) { return rb(O[r * c + k]); },
        [&](int k, int o) { return ldb(W.wproj + k * c + o); },
        [&](int r, int o, float v) {
          X1[r * c + o] = X[r * c + o] + (v + ldb(W.bproj + o)) * fa(r);
        },
        tile);
    row_stats(X1, ST + 2 * n, n, c);
    __syncthreads();
    each(n * c, [&](int i) {
      const int r = i / c;
      const float mu = ST[2 * n + r], s = ST[3 * n + r];
      X1N[i] = rb(X1[i] * s - mu * s);
    });
    block_gemm<false, false>(
        n, hid, c, [&](int r, int k) { return X1N[r * c + k]; },
        [&](int k, int o) { return ldb(W.w1 + k * hid + o); },
        [&](int r, int o, float v) {
          const float u = v + W.bf1[o];
          U[r * hid + o] = u;
          H1[r * hid + o] = rb(fastblk::gelu_tanh(u));
        },
        tile);

    // ---- the VJP. G holds the cotangent of the residual stream.
    each(n * c, [&](int i) {
      const int r = i / c, ch = i - r * c;
      G[i] = a.dz_win ? ldb(a.dz_win + wbase + i)
                      : ldb(a.dz_img + img_at(r, ch));
    });
    __syncthreads();
    // fc2: dh2 = fm * G
    col_sums(G, n, c, fm, slab + GL.bf2);
    block_gemm<false, true>(
        hid, c, n, [&](int k, int r) { return H1[r * hid + k]; },
        [&](int r, int j) { return fm(r) * G[r * c + j]; },
        [&](int k, int j, float v) { slab[GL.w2 + k * c + j] += v; }, tile);
    block_gemm<true, false>(
        n, hid, c, [&](int r, int j) { return G[r * c + j]; },
        [&](int j, int k) { return ldb(W.w2 + k * c + j); },
        [&](int r, int k, float v) {
          DU[r * hid + k] = rb(v * fm(r)) * gelu_grad(U[r * hid + k]);
        },
        tile);
    // fc1
    col_sums(DU, n, hid, one, slab + GL.bf1);
    block_gemm<false, true>(
        c, hid, n, [&](int k, int r) { return X1N[r * c + k]; },
        [&](int r, int j) { return DU[r * hid + j]; },
        [&](int k, int j, float v) { slab[GL.w1 + k * hid + j] += v; },
        tile);
    block_gemm<true, false>(
        n, c, hid, [&](int r, int j) { return DU[r * hid + j]; },
        [&](int j, int k) { return ldb(W.w1 + k * hid + j); },
        [&](int r, int k, float v) { DT[r * c + k] = rb(v); }, tile);
    normalize_bwd(X1, ST + 2 * n, DT, G, n, c);
    __syncthreads();
    // proj: dy = fa * G
    col_sums(G, n, c, fa, slab + GL.bproj);
    block_gemm<false, true>(
        c, c, n, [&](int k, int r) { return rb(O[r * c + k]); },
        [&](int r, int j) { return fa(r) * G[r * c + j]; },
        [&](int k, int j, float v) { slab[GL.wproj + k * c + j] += v; },
        tile);
    // the cotangent of the bf16 attention output
    block_gemm<true, false>(
        n, c, c, [&](int r, int j) { return G[r * c + j]; },
        [&](int j, int k) { return ldb(W.wproj + k * c + j); },
        [&](int r, int k, float v) { DT[r * c + k] = rb(v * fa(r)); }, tile);
    // o = A / den: the normalizer's cotangent
    each(nh * n, [&](int i) {
      const int hh = i / n, r = i - hh * n;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d)
        acc += DT[r * c + hh * hd + d] * O[r * c + hh * hd + d];
      DDEN[i] = rb(-acc / DEN[i]);
    });
    // dv, and dA V^T (the cotangent of e through P V)
    for (int hh = 0; hh < nh; ++hh) {
      block_gemm<false, true>(
          n, hd, n, [&](int j, int r) { return rb(E[(hh * n + r) * n + j]); },
          [&](int r, int d) {
            return DT[r * c + hh * hd + d] / DEN[hh * n + r];
          },
          [&](int j, int d, float v) {
            DQKV[j * c3 + 2 * c + hh * hd + d] = rb(v);
          },
          tile);
      block_gemm<true, false>(
          n, n, hd,
          [&](int r, int d) {
            return DT[r * c + hh * hd + d] / DEN[hh * n + r];
          },
          [&](int d, int j) { return QKV[j * c3 + 2 * c + hh * hd + d]; },
          [&](int r, int j, float v) { DA[(hh * n + r) * n + j] = v; },
          tile);
    }
    // the scores' cotangent, one thread per (head, query row), kept in S
    // and per window in dsw; the stable variants also carry the gradient
    // through the row max, split evenly among its ties
    each(nh * n, [&](int i) {
      const int hh = i / n, r = i - hh * n;
      float* srow = S + i * n;
      const float* erow = E + i * n;
      const float* darow = DA + i * n;
      const bool clamp = a.softmax == fastblk::kClampOnly;
      float m = -3.0e38f;
      for (int j = 0; j < n; ++j) m = fmaxf(m, srow[j]);
      unsigned long long ties = 0ull;
      float tot = 0.f;
      for (int j = 0; j < n; ++j) {
        // e's two bf16 cotangents (through P V and the normalizer),
        // added in bf16
        float ds = rb(rb(darow[j]) + DDEN[i]) * erow[j];
        if (clamp && srow[j] > fastblk::kClamp) ds = 0.f;
        if (srow[j] == m) ties |= 1ull << j;
        tot += ds;
        srow[j] = ds;
      }
      if (!clamp) {
        float dm = -tot;
        if (a.softmax == fastblk::kStableMM) dm = rb(dm);
        dm /= __popcll(ties);
        for (int j = 0; j < n; ++j)
          if (ties >> j & 1ull) srow[j] += dm;
      }
      float* dst = a.dsw + (static_cast<size_t>(win) * n + r) * nh * n +
                   hh * n;
      for (int j = 0; j < n; ++j) dst[j] = srow[j];
    });
    for (int hh = 0; hh < nh; ++hh) {
      block_gemm<true, false>(
          n, hd, n, [&](int r, int j) { return S[(hh * n + r) * n + j]; },
          [&](int j, int d) { return QKV[j * c3 + c + hh * hd + d]; },
          [&](int r, int d, float v) { DQKV[r * c3 + hh * hd + d] = rb(v); },
          tile);
      block_gemm<true, false>(
          n, hd, n, [&](int j, int r) { return S[(hh * n + r) * n + j]; },
          [&](int r, int d) { return QKV[r * c3 + hh * hd + d]; },
          [&](int j, int d, float v) {
            DQKV[j * c3 + c + hh * hd + d] = rb(v);
          },
          tile);
    }
    // qkv
    col_sums(DQKV, n, c3, one, slab + GL.bqkv);
    block_gemm<false, false>(
        c, c3, n, [&](int k, int r) { return XN[r * c + k]; },
        [&](int r, int j) { return DQKV[r * c3 + j]; },
        [&](int k, int j, float v) { slab[GL.wqkv + k * c3 + j] += v; },
        tile);
    block_gemm<false, false>(
        n, c, c3, [&](int r, int j) { return DQKV[r * c3 + j]; },
        [&](int j, int k) { return ldb(W.wqkv + k * c3 + j); },
        [&](int r, int k, float v) { DT[r * c + k] = rb(v); }, tile);
    normalize_bwd(X, ST, DT, G, n, c);
    __syncthreads();
    each(n * c, [&](int i) {
      const int r = i / c, ch = i - r * c;
      const bf16 v = __float2bfloat16_rn(G[i]);
      if (a.dx_win)
        a.dx_win[wbase + i] = v;
      else
        a.dx_img[img_at(r, ch)] = v;
    });
  }
}

// out[p] = sum over g < parts of in[g * size + p], in order of g.
__global__ void sum_parts_kernel(const float* in, int parts, int size,
                                 int stride, int period, float* out) {
  // parts are strided by `stride` floats; with period > 1, out has
  // `period` rows of `size` and part g adds to row g % period
  const int total = period * size;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int row = i / size, p = i - row * size;
    float acc = 0.f;
    for (int g = row; g < parts; g += period)
      acc += in[static_cast<size_t>(g) * stride + p];
    out[i] = acc;
  }
}


void set_block_weights(BlockW* w, const void* const* p, int bw) {
  w->wqkv = static_cast<const bf16*>(p[0]);
  w->bqkv = static_cast<const float*>(p[1]);
  w->wproj = static_cast<const bf16*>(p[2]);
  w->bproj = static_cast<const bf16*>(p[3]);
  w->w1 = static_cast<const bf16*>(p[4]);
  w->bf1 = static_cast<const float*>(p[5]);
  w->w2 = static_cast<const bf16*>(p[6]);
  w->bf2 = static_cast<const bf16*>(p[7]);
  w->bias = static_cast<const bf16*>(p[8]);
  w->bw = bw;
}

}  // namespace trainblk
