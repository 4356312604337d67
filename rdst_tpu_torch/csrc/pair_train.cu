// The differentiable DSTL pair of the bf16 training step, forward and
// backward, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/pair_train.py::fused_swin_pair_train (:293
// -> `_fused_swin_pair_train_impl` :323; forward pallas_call :201,
// backward pallas_call :232, joined by jax.custom_vjp :254-278). The
// function is the pair of csrc/swin_pair.cu -- block a (shift 0, shared
// bias), its output rounded to bf16, the roll by -shift and
// re-partition, block b (shift, per-window bias) -- with the two
// training differences of `_pair_ops` (:84-104): an exact division of
// the softmax normalizer, and stochastic-depth factor columns `dpf`
// (rows x [attn_a, mlp_a, attn_b, mlp_b]) on the residual branches.
//
// Forward (`pair_train_fwd_bf16`): the cooperative grid of swin_pair.cu
// with fastblk::fast_block in its exact-division form; block a's bf16
// output stays in the image-layout scratch, which the caller keeps for
// the backward.
//
// Backward (`pair_train_bwd_bf16`): block b's backward, then block a's,
// then deterministic reductions. Like the TPU kernel, each window's
// forward is recomputed (flash-attention style: only tokens, cotangents
// and block a's output cross device memory between the launches), then
// the VJP of the same math runs in the window: the MLP (tanh-GELU
// derivative), the affine-free normalize, the projection, the per-head
// softmax (exact division; clamp: no gradient where s > 60), q/k/v and
// the packed bias. Cotangents are rounded to bf16 wherever the forward
// holds a bf16 value, as autodiff of the bf16 body does. Block b's input
// cotangent is scattered back through the relayout (a permutation, so
// the scatter is conflict-free) into an image-layout buffer, from which
// block a gathers its output cotangent. Weight and bias gradients are
// accumulated in f32 per thread block (one window each) and summed over
// thread blocks in a fixed order by a second pass, so a step is
// deterministic; the per-window score cotangents are summed per bias
// window the same way.
//
// What bounds it on an H100: operations (the backward does about twice
// the forward's products, plus the recompute). The backward's products
// run on the tensor cores (block_gemm: mma.sync, f32 operands split into
// bf16 hi + lo), but the window's intermediates live in an L2-backed
// global workspace of the thread block and its row passes (softmax, the
// normalize VJP, column sums) take a thread per row, so staging and
// latency, not the products, bound this first version: simple and right
// first; the window state in shared memory is later work.

#include "fast_block.cuh"

namespace {

using fastblk::bf16;

// ---------------------------------------------------------------- forward

struct FwdArgs {
  const bf16* x;           // (images * nW, n, c), unshifted window layout
  bf16* out;               // (images * nW, n, c), shifted window layout
  bf16* y;                 // block a's output, (images, H, W, c)
  unsigned int* counter;   // grid barrier, zero at launch
  const float* dpf;        // (images * nW * n, 4) or null
  fastblk::Weights wa, wb;
  fastblk::Geom g;
  int images, h, w, ws, shift, softmax;
};

__device__ __forceinline__ float ldcg_bf16(const bf16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

__global__ void __launch_bounds__(fastblk::kThreads, 2)
    pair_train_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) char smem[];
  const fastblk::Geom& g = a.g;
  float* xs = reinterpret_cast<float*>(smem);
  const int n = g.n, c = g.c, ws = a.ws;
  const int nww = a.w / ws, nw = (a.h / ws) * nww;
  const int windows = a.images * nw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  unsigned int epoch = 0;

  for (int win = blockIdx.x; win < windows; win += gridDim.x) {
    const bf16* xg = a.x + static_cast<size_t>(win) * n * c;
    const float* dp = a.dpf ? a.dpf + static_cast<size_t>(win) * n * 4
                            : nullptr;
    __syncthreads();
    for (int i = threadIdx.x; i < n * c; i += blockDim.x)
      xs[i] = __bfloat162float(xg[i]);
    fastblk::fast_block(a.wa, g, smem, 0, a.softmax, true,
                        dp ? dp : nullptr, dp ? dp + 1 : nullptr);
    const int img = win / nw, wi = win - img * nw;
    const int oy = (wi / nww) * ws, ox = (wi % nww) * ws;
    for (int r = warp; r < n; r += nwarps) {
      bf16* dst = a.y + ((static_cast<size_t>(img) * a.h + oy + r / ws) *
                             a.w + ox + r % ws) * c;
      for (int ch = lane; ch < c; ch += 32)
        dst[ch] = __float2bfloat16_rn(xs[r * c + ch]);
    }
  }
  fastblk::grid_barrier(a.counter, epoch);

  for (int win = blockIdx.x; win < windows; win += gridDim.x) {
    const int img = win / nw, wi = win - img * nw;
    const int oy = (wi / nww) * ws + a.shift, ox = (wi % nww) * ws + a.shift;
    const float* dp = a.dpf ? a.dpf + static_cast<size_t>(win) * n * 4
                            : nullptr;
    __syncthreads();
    for (int r = warp; r < n; r += nwarps) {
      const int yy = (oy + r / ws) % a.h, xx = (ox + r % ws) % a.w;
      const bf16* src =
          a.y + ((static_cast<size_t>(img) * a.h + yy) * a.w + xx) * c;
      for (int ch = lane; ch < c; ch += 32) xs[r * c + ch] = ldcg_bf16(src + ch);
    }
    fastblk::fast_block(a.wb, g, smem, wi % a.wb.bias_windows, a.softmax,
                        true, dp ? dp + 2 : nullptr, dp ? dp + 3 : nullptr);
    bf16* og = a.out + static_cast<size_t>(win) * n * c;
    for (int i = threadIdx.x; i < n * c; i += blockDim.x)
      og[i] = __float2bfloat16_rn(xs[i]);
  }
}

// --------------------------------------------------------------- backward

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
  const float* dpf;    // (windows * n, 4) or null
  int dp_col;          // the attn column; the mlp column follows
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
    pair_block_bwd_kernel(const BwdArgs a) {
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
    const float* dp = a.dpf ? a.dpf + static_cast<size_t>(win) * n * 4 +
                                  a.dp_col
                            : nullptr;
    auto fa = [&](int r) { return dp ? dp[4 * r] : 1.0f; };
    auto fm = [&](int r) { return dp ? dp[4 * r + 1] : 1.0f; };
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

void set_fast_weights(fastblk::Weights* w, const void* const* p) {
  w->wqkv = static_cast<const bf16*>(p[0]);
  w->bqkv = static_cast<const float*>(p[1]);
  w->wproj = static_cast<const bf16*>(p[2]);
  w->bproj = static_cast<const bf16*>(p[3]);
  w->w1 = static_cast<const bf16*>(p[4]);
  w->bf1 = static_cast<const float*>(p[5]);
  w->w2 = static_cast<const bf16*>(p[6]);
  w->bf2 = static_cast<const bf16*>(p[7]);
  w->bias = static_cast<const bf16*>(p[8]);
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

template <class T>
T* mut(const void* p) {
  return static_cast<T*>(const_cast<void*>(p));
}

bool dims_ok(const fastblk::Geom& g, int images, int h, int w, int ws,
             int shift, int softmax) {
  return fastblk::geom_ok(g) && ws > 0 && h % ws == 0 && w % ws == 0 &&
         shift >= 0 && shift < ws && images >= 0 && softmax >= 0 &&
         softmax <= 2;
}

}  // namespace

extern "C" {

// Floats of the backward's per-thread-block workspace and weight-gradient
// partials; the wrapper allocates grid times each.
int pair_train_work_floats(int n, int c, int nh, int hidden) {
  return work_layout(n, c, nh, hidden).total;
}

int pair_train_grad_floats(int c, int hidden) {
  return grad_layout(c, hidden).total;
}

// ptrs: x, out, y scratch, counter, dpf (0 = none), then block a's and
// block b's kernel_layout weights and packed bias (9 each). dims: images,
// h, w, ws, shift, c, nh, hidden, softmax.
int pair_train_fwd_bf16(const void* const* ptrs, const int* dims, int device,
                        void* stream) {
  FwdArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = mut<bf16>(ptrs[1]);
  a.y = mut<bf16>(ptrs[2]);
  a.counter = mut<unsigned int>(ptrs[3]);
  a.dpf = static_cast<const float*>(ptrs[4]);
  set_fast_weights(&a.wa, ptrs + 5);
  set_fast_weights(&a.wb, ptrs + 14);
  a.images = dims[0];
  a.h = dims[1];
  a.w = dims[2];
  a.ws = dims[3];
  a.shift = dims[4];
  a.g = fastblk::make_geom(dims[3] * dims[3], dims[5], dims[6], dims[7]);
  a.softmax = dims[8];
  if (!dims_ok(a.g, a.images, a.h, a.w, a.ws, a.shift, a.softmax))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (a.h / a.ws) * (a.w / a.ws);
  a.wa.bias_windows = 1;
  a.wb.bias_windows = a.shift > 0 ? nw : 1;
  const int smem = fastblk::smem_layout(a.g).total;
  cudaError_t err = fastblk::prepare(pair_train_fwd_kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.images == 0) return 0;
  int grid = 0;
  err = fastblk::cooperative_grid(pair_train_fwd_kernel, smem, device,
                                  a.images * nw, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pair_train_fwd_kernel), dim3(grid),
      dim3(fastblk::kThreads), params, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x (unshifted windows), dz (shifted windows), y (block a's output,
// image layout, from the forward), dx (out, windows), dy (scratch, image
// layout), dpf (0 = none), work, slab_a, slab_b (zeroed), dsw_a, dsw_b,
// grad_a, grad_b (grad_layout floats each), dbias_a (1, n, nh n), dbias_b
// (bw_b, n, nh n), then block a's and block b's FastParams weights and
// packed bias (9 each). dims: images, h, w, ws, shift, c, nh, hidden,
// softmax, grid.
int pair_train_bwd_bf16(const void* const* ptrs, const int* dims, int device,
                        void* stream) {
  const int images = dims[0], h = dims[1], w = dims[2], ws = dims[3];
  const int shift = dims[4], c = dims[5], nh = dims[6], hid = dims[7];
  const int softmax = dims[8], grid = dims[9];
  const fastblk::Geom g = fastblk::make_geom(ws * ws, c, nh, hid);
  if (!dims_ok(g, images, h, w, ws, shift, softmax) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = ws * ws, nw = (h / ws) * (w / ws), windows = images * nw;
  if (windows == 0) return 0;
  const int bw_b = shift > 0 ? nw : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  BwdArgs b{};
  b.dpf = static_cast<const float*>(ptrs[5]);
  b.work = mut<float>(ptrs[6]);
  b.windows = windows;
  b.n = n;
  b.c = c;
  b.nh = nh;
  b.hidden = hid;
  b.ih = h;
  b.iw = w;
  b.ws = ws;
  b.softmax = softmax;
  BwdArgs a = b;

  // block b: input gathered from y at the rolled positions, cotangent in
  // the shifted window layout, input cotangent scattered back into dy
  set_block_weights(&b.w, ptrs + 24, bw_b);
  b.x_img = static_cast<const bf16*>(ptrs[2]);
  b.dz_win = static_cast<const bf16*>(ptrs[1]);
  b.dx_img = mut<bf16>(ptrs[4]);
  b.img_shift = shift;
  b.dp_col = 2;
  b.slab = mut<float>(ptrs[8]);
  b.dsw = mut<float>(ptrs[10]);
  // block a: input in windows, cotangent gathered from dy unshifted
  set_block_weights(&a.w, ptrs + 15, 1);
  a.x_win = static_cast<const bf16*>(ptrs[0]);
  a.dz_img = static_cast<const bf16*>(ptrs[4]);
  a.dx_win = mut<bf16>(ptrs[3]);
  a.img_shift = 0;
  a.dp_col = 0;
  a.slab = mut<float>(ptrs[7]);
  a.dsw = mut<float>(ptrs[9]);

  pair_block_bwd_kernel<<<grid, 256, 0, s>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_block_bwd_kernel<<<grid, 256, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int gsize = grad_layout(c, hid).total, bsize = n * nh * n;
  sum_parts_kernel<<<(gsize + 255) / 256, 256, 0, s>>>(
      a.slab, grid, gsize, gsize, 1, mut<float>(ptrs[11]));
  sum_parts_kernel<<<(gsize + 255) / 256, 256, 0, s>>>(
      b.slab, grid, gsize, gsize, 1, mut<float>(ptrs[12]));
  sum_parts_kernel<<<(bsize + 255) / 256, 256, 0, s>>>(
      a.dsw, windows, bsize, bsize, 1, mut<float>(ptrs[13]));
  sum_parts_kernel<<<(bw_b * bsize + 255) / 256, 256, 0, s>>>(
      b.dsw, windows, bsize, bsize, bw_b, mut<float>(ptrs[14]));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
