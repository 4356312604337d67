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
// What bounds it on an H100: operations. At the flagship geometry
// (N = 64, C = 60/90/120, 6 heads, MLP 2C) a block does 16C^2 + 4NC flops
// per token but moves only its (N, C) input and output plus the weights
// and the bias, about 1/100 of a byte per flop. The precise path is
// float32, so it runs on the CUDA cores (67 TFLOP/s f32 on an H100 SXM);
// the tensor cores would compute in TF32 and break f32 agreement.
//
// What the design does about it: one thread block per window keeps every
// intermediate (LN outputs, q/k/v, one head's N x N scores, the MLP
// hidden state) in shared memory, so HBM sees only the block's input,
// output, weights and bias. The four projections are register-tiled: a
// warp owns 8 or 16 tokens x 64 output channels (two per lane); a lane
// loads eight weight rows at once (their L2 latency paid once) and reads
// A as float4, so one shared-memory load feeds eight FMAs and a weight
// read from L2 serves 8-16 tokens. Softmax spreads a row over n/8 lanes;
// P*V reads P four columns at a time for four rows per thread. q/k/v rows
// use an odd stride (C + 1) so a warp's column reads hit distinct banks.
// Up to ~171 KB of dynamic shared memory (C = 120), above the 48 KB
// default, so the launcher raises the function's limit first, and it
// picks 2 x 256 or 1 x 512 threads per SM to keep 16 warps resident.
// Tensor cores, wgmma and TMA are left for the bf16 path.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsMin = 256;  // the smaller of the two block sizes
constexpr int kMaxHeadDim = 32;  // bound of the register row in the score loop
constexpr float kEps = 1e-5f;    // torch-default LayerNorm epsilon
// Softmax terms below exp(-80) (1.8e-35 of the row max) are set to 0: at
// exp(-87) and beyond, the term and its quotient by the row sum would be
// denormal and send expf and the IEEE division to their slow paths (the
// shift mask's -100 entries land there). The change to an output is
// below 1e-34 of its scale.
constexpr float kExpFloor = -80.0f;

struct BlockArgs {
  const float* x;
  float* out;
  const float* wqkv;   // (C, 3C)  (in, out)
  const float* bqkv;   // (3C)
  const float* wproj;  // (C, C)
  const float* bproj;  // (C)
  const float* g1;
  const float* b1;
  const float* g2;
  const float* b2;
  const float* w1;     // (C, H)
  const float* bf1;    // (H)
  const float* w2;     // (H, C)
  const float* bf2;    // (C)
  const float* bias;   // (nH * bias_windows, N, N), head-major
  int n, c, nh, hidden, bias_windows;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row-wise LayerNorm with affine over c channels, one warp per row; src
// rows at stride c, dst rows at stride ldd.
__device__ void layer_norm_rows(const float* src, float* dst, int ldd, int n,
                                int c, const float* __restrict__ g,
                                const float* __restrict__ b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    const float* row = src + r * c;
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += row[i];
    const float mu = warp_sum(s) / c;
    float v = 0.f;
    for (int i = lane; i < c; i += 32) {
      const float d = row[i] - mu;
      v += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) / c + kEps);
    for (int i = lane; i < c; i += 32)
      dst[r * ldd + i] = (row[i] - mu) * rstd * __ldg(g + i) + __ldg(b + i);
  }
}

// epi(m, o, sum_k A[m * lda + k] * W[k * nout + o]) for m < M, o < nout.
// A lives in shared memory (16-byte aligned rows, lda % 4 == 0, K even),
// W in global memory. A warp owns RT rows x 64 columns (lanes take o and
// o + 32). Per eight k, a lane loads 16 weights at once (their L2 latency
// paid once) and reads each A row as two float4 (one shared-memory load
// feeds eight FMAs).
template <int RT, class Epi>
__device__ void project_tiles(const float* A, int lda, int M, int K,
                              const float* __restrict__ W, int nout, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int tiles_n = (nout + 63) / 64;
  const int tiles = (M / RT) * tiles_n;
  for (int tile = warp; tile < tiles; tile += nwarps) {
    const int m0 = (tile / tiles_n) * RT;
    const int c0 = (tile % tiles_n) * 64 + lane;
    const int c1 = c0 + 32;
    const bool ok0 = c0 < nout, ok1 = c1 < nout;
    float acc0[RT], acc1[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc0[r] = acc1[r] = 0.f;
    int k = 0;
    for (; k + 8 <= K; k += 8) {
      float w0[8], w1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* wk = W + static_cast<size_t>(k + u) * nout;
        w0[u] = ok0 ? __ldg(wk + c0) : 0.f;
        w1[u] = ok1 ? __ldg(wk + c1) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4* ar =
            reinterpret_cast<const float4*>(A + (m0 + r) * lda + k);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 a = ar[h];
          const float* u0 = w0 + 4 * h;
          const float* u1 = w1 + 4 * h;
          acc0[r] = fmaf(a.x, u0[0], acc0[r]);
          acc0[r] = fmaf(a.y, u0[1], acc0[r]);
          acc0[r] = fmaf(a.z, u0[2], acc0[r]);
          acc0[r] = fmaf(a.w, u0[3], acc0[r]);
          acc1[r] = fmaf(a.x, u1[0], acc1[r]);
          acc1[r] = fmaf(a.y, u1[1], acc1[r]);
          acc1[r] = fmaf(a.z, u1[2], acc1[r]);
          acc1[r] = fmaf(a.w, u1[3], acc1[r]);
        }
      }
    }
    for (; k < K; k += 2) {
      const float* wk = W + static_cast<size_t>(k) * nout;
      const float w00 = ok0 ? __ldg(wk + c0) : 0.f;
      const float w01 = ok1 ? __ldg(wk + c1) : 0.f;
      const float w10 = ok0 ? __ldg(wk + nout + c0) : 0.f;
      const float w11 = ok1 ? __ldg(wk + nout + c1) : 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float2 a =
            *reinterpret_cast<const float2*>(A + (m0 + r) * lda + k);
        acc0[r] = fmaf(a.x, w00, acc0[r]);
        acc0[r] = fmaf(a.y, w10, acc0[r]);
        acc1[r] = fmaf(a.x, w01, acc1[r]);
        acc1[r] = fmaf(a.y, w11, acc1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (ok0) epi(m0 + r, c0, acc0[r]);
      if (ok1) epi(m0 + r, c1, acc1[r]);
    }
  }
}

// Taller tiles (16 rows) halve the weight traffic where they still give
// every warp work; otherwise 8 rows.
template <class Epi>
__device__ void project(const float* A, int lda, int M, int K,
                        const float* __restrict__ W, int nout, Epi epi) {
  const int tiles_n = (nout + 63) / 64;
  if (M % 16 == 0 && (M / 16) * tiles_n >= static_cast<int>(blockDim.x >> 5))
    project_tiles<16>(A, lda, M, K, W, nout, epi);
  else
    project_tiles<8>(A, lda, M, K, W, nout, epi);
}

// 16 warps per SM either way: 2 blocks of 256 threads where two fit in
// shared memory (C = 60), else 1 block of 512 (C = 90, 120); 128
// registers per thread in both.
template <int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
swin_block_kernel(const BlockArgs p) {
  extern __shared__ float smem[];
  const int n = p.n, c = p.c, hidden = p.hidden;
  const int cp = c + 1;  // odd q/k/v row stride: conflict-free column reads
  const int hd = c / p.nh;
  const int win = blockIdx.x;

  const int cs = (c + 3) & ~3;            // row strides of projection inputs:
  const int hs = (hidden + 3) & ~3;       // multiples of 4 for float4 reads

  float* xs = smem;                       // (n, c) input, then x1
  float* xn = xs + n * c;                 // (n, cs) LN out, attention out
  float* region = xn + n * cs;            // q/k/v (3, n, cp), then MLP hidden
  const int region_len = max(3 * n * cp, n * hs);
  float* sc = region + region_len;        // (n, n) one head's scores
  float* q = region;
  float* k = region + n * cp;
  float* v = region + 2 * n * cp;
  float* hb = region;                     // (n, hs)

  const float* xg = p.x + static_cast<size_t>(win) * n * c;
  for (int i = threadIdx.x; i < n * c; i += blockDim.x) xs[i] = xg[i];
  __syncthreads();

  layer_norm_rows(xs, xn, cs, n, c, p.g1, p.b1);
  __syncthreads();

  project(xn, cs, n, c, p.wqkv, 3 * c, [&](int m, int o, float acc) {
    const int part = o / c, ch = o - part * c;
    float val = acc + __ldg(p.bqkv + o);
    if (part == 0) val *= p.scale;
    region[part * n * cp + m * cp + ch] = val;
  });
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* ao = xn;  // LN1 output is dead once q/k/v exist
  const int bwin = p.bias_windows > 1 ? win % p.bias_windows : 0;
  for (int h = 0; h < p.nh; ++h) {
    const int off = h * hd;
    const float* bh =
        p.bias + (static_cast<size_t>(h) * p.bias_windows + bwin) * n * n;
    {  // scores: a thread owns key column j, with k_j held in registers
      const int j = threadIdx.x % n;
      const int rows_per_pass = blockDim.x / n;
      float kr[kMaxHeadDim];
#pragma unroll
      for (int d = 0; d < kMaxHeadDim; ++d)
        kr[d] = d < hd ? k[j * cp + off + d] : 0.f;
      for (int i = threadIdx.x / n; i < n; i += rows_per_pass) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxHeadDim; ++d)
          if (d < hd) s = fmaf(q[i * cp + off + d], kr[d], s);
        sc[i * n + j] = s + __ldg(bh + i * n + j);
      }
    }
    __syncthreads();
    {  // softmax: n/8 lanes per row (a power of two), eight terms each
      const int lanes = n / 8;
      float* seg = sc + (threadIdx.x % lanes) * 8;
      for (int i = threadIdx.x / lanes; i < n; i += blockDim.x / lanes) {
        float4* r4 = reinterpret_cast<float4*>(seg + i * n);
        const float4 lo = r4[0], hi = r4[1];
        float e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        float mx = e[0];
#pragma unroll
        for (int u = 1; u < 8; ++u) mx = fmaxf(mx, e[u]);
        for (int o = lanes / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float d = e[u] - mx;
          e[u] = d < kExpFloor ? 0.f : expf(d);
          sum += e[u];
        }
        for (int o = lanes / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = e[u] / sum;
        r4[0] = make_float4(e[0], e[1], e[2], e[3]);
        r4[1] = make_float4(e[4], e[5], e[6], e[7]);
      }
    }
    __syncthreads();
    // p v_h: a thread owns head channel d of rows i + g*n/4, g < 4, so a
    // v element read serves four rows and P is read four columns at once
    const int q4 = n / 4;
    for (int idx = threadIdx.x; idx < q4 * hd; idx += blockDim.x) {
      const int i = idx / hd, d = idx - (idx / hd) * hd;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < n; j += 4) {
        const float v0 = v[j * cp + off + d], v1 = v[(j + 1) * cp + off + d];
        const float v2 = v[(j + 2) * cp + off + d];
        const float v3 = v[(j + 3) * cp + off + d];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 pr =
              *reinterpret_cast<const float4*>(sc + (i + g * q4) * n + j);
          acc[g] = fmaf(pr.x, v0, acc[g]);
          acc[g] = fmaf(pr.y, v1, acc[g]);
          acc[g] = fmaf(pr.z, v2, acc[g]);
          acc[g] = fmaf(pr.w, v3, acc[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) ao[(i + g * q4) * cs + off + d] = acc[g];
    }
    __syncthreads();
  }

  project(ao, cs, n, c, p.wproj, c, [&](int m, int o, float acc) {
    xs[m * c + o] += acc + __ldg(p.bproj + o);  // residual 1
  });
  __syncthreads();

  layer_norm_rows(xs, xn, cs, n, c, p.g2, p.b2);
  __syncthreads();

  project(xn, cs, n, c, p.w1, hidden, [&](int m, int o, float acc) {
    const float u = acc + __ldg(p.bf1 + o);
    hb[m * hs + o] = 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
  });
  __syncthreads();

  float* og = p.out + static_cast<size_t>(win) * n * c;
  project(hb, hs, n, hidden, p.w2, c, [&](int m, int o, float acc) {
    og[m * c + o] = xs[m * c + o] + (acc + __ldg(p.bf2 + o));  // residual 2
  });
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch, in bytes (layout in the kernel).
int swin_block_smem_bytes(int n, int c, int hidden) {
  const int cs = (c + 3) & ~3, hs = (hidden + 3) & ~3;
  const int region = 3 * n * (c + 1) > n * hs ? 3 * n * (c + 1) : n * hs;
  return static_cast<int>(sizeof(float)) * (n * c + n * cs + region + n * n);
}

const char* swin_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch one block over `windows` windows on `stream`; returns the
// cudaError_t of the set-up and launch (0 on success). The kernel takes
// n | 256 with n % 8 == 0 and n <= 64, even c and hidden, c % nh == 0 and
// c / nh <= 32; bias_windows is nW (per-window bias) or 1 (shared).
int swin_block_f32(const float* x, float* out, const float* wqkv,
                   const float* bqkv, const float* wproj, const float* bproj,
                   const float* g1, const float* b1, const float* g2,
                   const float* b2, const float* w1, const float* bf1,
                   const float* w2, const float* bf2, const float* bias,
                   int windows, int n, int c, int nh, int hidden,
                   int bias_windows, int device, void* stream) {
  if (n <= 0 || n > 64 || kThreadsMin % n != 0 || n % 8 != 0 || c <= 0 ||
      c % 2 != 0 || nh <= 0 || c % nh != 0 || c / nh > kMaxHeadDim ||
      hidden <= 0 || hidden % 2 != 0 || bias_windows <= 0 ||
      windows % bias_windows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = swin_block_smem_bytes(n, c, hidden);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  err = cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two 256-thread blocks per SM where their shared memory (plus the 1 KB
  // the runtime reserves per block) fits, else one block of 512
  const bool two_per_sm = 2 * (smem + 1024) <= per_sm;
  auto kernel = two_per_sm ? swin_block_kernel<256> : swin_block_kernel<512>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (windows == 0) return 0;
  BlockArgs p{x,  out, wqkv, bqkv, wproj, bproj, g1,   b1,
              g2, b2,  w1,   bf1,  w2,    bf2,   bias, n,
              c,  nh,  hidden, bias_windows,
              static_cast<float>(1.0 / sqrt(static_cast<double>(c / nh)))};
  kernel<<<windows, two_per_sm ? 256 : 512, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
