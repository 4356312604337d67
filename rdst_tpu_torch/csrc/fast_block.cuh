// The primitives of the bf16 Swin-block kernels for Hopper (sm_90a) that
// csrc/window_body.cuh, csrc/token_gemm.cuh, csrc/token_wgmma.cuh and the
// training backward share: bf16 pairs and rounding, the mma.sync products
// and softmax variants of the attention, the block geometry and its
// launch check, and the tanh GELU. (The one-window fast block that was
// built on them, one window a thread block with a grid barrier between a
// pair's blocks, is gone: the fast block, the pair, the RDSTB and both
// training forwards run csrc/window_body.cuh or csrc/token_fwd.cuh.)
//
// Replaces: nothing by itself; the pieces of the fast branch of `_body`
// in rdst_tpu/kernels/swin_block.py (`fast=True`, :261-473) that the
// kernels above share:
//
//   xn = bf16(normalize(x))                    one-pass moments, eps 1e-5
//   e = bf16(exp(...))                         by softmax variant
//   h = bf16(gelu_tanh(...))
//
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fastblk {

typedef __nv_bfloat16 bf16;

constexpr float kEps = 1e-5f;
constexpr float kClamp = 60.0f;
constexpr int kMaxN = 64;
// Widest C of the fast block's and the single-block train kernels'
// token-parallel designs (SwinIR-std, C = 180); the train-pair backward
// takes the window body's widest, 128.
constexpr int kMaxC = 192;
constexpr int kMaxCShared = 128;
constexpr float kQX = 31.75f;  // int8 activation step: 127 / 4 sigma
                               // (csrc/token_fwd.cuh's int8 LN1 rows)

enum Softmax { kStable = 0, kClampOnly = 1, kStableMM = 2 };

struct Geom {
  int n, c, nh, hidden;
  int cp, hp, hd, hdq;  // padded widths
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
  return g;
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.0f + tanhf(u)));
}

// The block geometry the kernels take, up to width max_c (kMaxC for the
// token-parallel designs, kMaxCShared for the train-pair backward).
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
