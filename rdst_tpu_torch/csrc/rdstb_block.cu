// A whole RDSTB, bfloat16 fast branch, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/rdstb_block.py::fused_rdstb (:334 ->
// `_fused_rdstb_impl` :363 -> pallas_call :496; `_rdstb_kernel` :118,
// `_conv3x3` :80). Per image of image-major tokens (H*W, C0):
//
//   for each of nb DSTLs (input width c = C0 + d*g):
//     y = bf16(block_a(concat(x0, feats)))          shift 0, shared bias
//     z = bf16(block_b(roll(y, -s)))                per-window bias
//     z = roll(z, +s)
//     feats += bf16(LN(z @ Wad + bad))               post-norm adapter, or
//              bf16(normalize(z) @ Wad' + bad')      pre-norm (LN folded)
//   out = bf16(conv3x3(concat(x0, feats)) + bconv + x0)
//
// The TPU kernel keeps one image's whole state in VMEM. Here an image's
// dense features (H*W x 150 bf16 = 384 KB at the flagship) do not fit in
// a thread block's shared memory, so one call is 2*nb + 1 ordinary
// kernels on the caller's stream, each with the shared memory and
// occupancy of its own width; the state between them lives in two global
// scratch buffers that stay in the 50 MB L2 (25 MB at bucket 64): the
// dense rows (H*W, ccatp) = x0 | feats | zero pad, ccatp = C_cat to 16,
// and the block-a output y (H*W, c8), c8 = c to 8:
// * stage A of DSTL d: block a (csrc/window_body.cuh) on the unshifted
//   windows of the dense rows (of x for the first DSTL, which also copies
//   x0 into the dense rows); the bf16 rows into y at their image
//   positions;
// * stage B: per shifted window, y gathered at (y + s mod H, x + s mod W)
//   (the roll and re-partition), block b, round to bf16, the adapter as
//   one more warpgroup product, and the growth channels into the dense
//   rows at the windows' unrolled positions (the un-shift relayout);
// * the conv: a tiled implicit GEMM, 8 x 16 output pixels a thread block
//   (a warpgroup's 64 = wgmma's M), the zero-bordered halo of the dense
//   rows read once with 16-byte copies into shared memory in wgmma's
//   core-matrix order, so that each of the 9 taps is a shifted
//   descriptor over it; the weights tap-major as `_conv3x3`'s (9*C_cat,
//   C0), staged one tap (64 x 160 bf16 = 20 KB) at a time; then bias,
//   residual, bf16.
// Bound by operations (the conv adds 2 * 1350 * 60 flops per pixel to the
// blocks' work at the flagship).
//
// A DSTL whose blocks the window body does not take (C above 120, or int8
// qkv: RDST-W96's C = 96 / 144 / 192 with `pallas_quant = 'qkv'`) runs its
// two stages on the token-parallel forward of csrc/token_fwd.cuh instead,
// five kernels a stage over all the call's tokens, with the same buffers:
// stage A reads the dense rows (x for the first DSTL, whose LN1 pass also
// copies x0 in) through a row map and writes its rows into y at their
// image positions; stage B reads the rolled windows of y, writes its bf16
// rows token-major, and the adapter (pre-norm: LN rows, then) one GEMM C
// -> growth with the post-norm LN in a row-spanning epilogue puts the
// growth channels into the dense rows at the un-shifted pixels. The route
// of each DSTL comes with the call (kernels.swin_block.stage_route: the
// window body up to C = 120 without int8, the token-parallel stages
// otherwise). The conv is the same for both.
//
// int8 groups (kernels.quant; `pallas_quant`): 'qkv', 'mlp' and 'proj'
// send every DSTL to the token-parallel stages, which run those products
// on wgmma .s8 (csrc/token_fwd.cuh), each dynamic scale over the windows
// of `gimg` images (one program of the JAX kernel). 'conv' alone moves no
// DSTL: after the last one, a pass takes the amax of each group's dense
// rows x0 | feats (an atomicMax on the float bits a thread block), then
// the conv kernel reads the halo quantized to int8 at its image's group
// scale into shared memory, in wgmma's core-matrix order for 8-bit
// operands (8 pixels x 16 channels contiguous, kq = C_cat to 32 channels
// a pixel), runs the nine taps as m64n32k32 .s8 products into int32
// accumulators, the weights staged one int8 tap (64 x kq bytes) at a
// time, and dequantizes once in the epilogue, int32 (wcs dq) + bconv,
// before the residual.

#include "token_fwd.cuh"
#include "window_body.cuh"

namespace {

using wbody::bf16;

constexpr int kMaxDstl = 4;
constexpr int kConvRows = 8, kConvCols = 16;  // output pixels a block
constexpr int kHaloRows = kConvRows + 2, kHaloCols = kConvCols + 2;
constexpr int kConvSlots = 2;

struct StageArgs {
  const bf16* x;   // (images, H*W, c0) image-major tokens
  bf16* dense;     // (images, H*W, ccatp) x0 | feats | zero pad
  bf16* y;         // (images, H*W, c8)
  wbody::BlockW w;
  wbody::Geom g;
  const float* bad;   // (ng) adapter bias
  const float* gad;   // (growth) post-norm LN scale
  const float* bbad;  // (growth) post-norm LN bias
  int windows, nw, h, w_img, ws, shift, softmax;
  int c0, ccat, ccatp, dcol, growth, ng, prenorm, first;
  int nslots, slot_bytes, wg_bytes;
};

__device__ __forceinline__ int pixel(const StageArgs& a, int wi, int r,
                                     int s) {
  const int nww = a.w_img / a.ws;
  const int yy = ((wi / nww) * a.ws + r / a.ws + s) % a.h;
  const int xx = ((wi % nww) * a.ws + r % a.ws + s) % a.w_img;
  return yy * a.w_img + xx;
}

// the flat pixel index (over the batch) of row r of the tile
__device__ __forceinline__ size_t tile_pixel(const StageArgs& a, int gw0,
                                             int r, int s) {
  const int gw = gw0 + r / a.g.n;
  const int img = gw / a.nw, wi = gw - img * a.nw;
  return static_cast<size_t>(img) * a.h * a.w_img +
         pixel(a, wi, r % a.g.n, s);
}

// x rounded to bf16 into A rows, core-matrix order
template <int NT>
__device__ __forceinline__ void bf16_into(const float (&x)[NT][16], int cp,
                                          char* a) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 32 * j + 8 * q + 2 * t;
      if (col >= cp) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            a + wbody::aoff(16 * wq + g + 8 * h, col, 16 * cp)) =
            wbody::pack2(x[j][4 * q + 2 * h], x[j][4 * q + 2 * h + 1]);
    }
}

template <int NT, bool kB>
__global__ void __launch_bounds__(wbody::kWgs * 128 + 32, 1)
    rdstb_stage_kernel(const StageArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int nwg = (blockDim.x - 32) / 128;
  const int wg = wbody::warpgroup();
  const wbody::Geom& g = a.g;
  char* ring_base = smem + nwg * a.wg_bytes;
  char* ctrl = ring_base + a.nslots * a.slot_bytes;
  wbody::Ring ring = wbody::make_ring(ring_base, a.nslots, a.slot_bytes,
                                      ctrl);
  int active = (a.windows * g.n + wbody::kRows - 1) / wbody::kRows -
               blockIdx.x * nwg;
  if (active > nwg) active = nwg;
  if (threadIdx.x == 0) wbody::ring_init(ring, 4 * active);
  __syncthreads();
  if (wg == nwg) {  // the producer warp
    if ((threadIdx.x & 31) == 0)
      wbody::produce_block(ring, g, kB ? a.ng : 0, a.w.panels);
    return;
  }
  const wbody::TileInfo ti =
      wbody::tile_info(blockIdx.x, nwg, wg, g.n, a.windows);
  if (ti.rows == 0) return;
  char* wsm = smem + wg * a.wg_bytes;
  bf16* stage = reinterpret_cast<bf16*>(wsm);
  const int c = g.c, yb = 2 * g.c8, db = 2 * a.ccatp;
  const int tid = threadIdx.x & 127;

  float x[NT][16];
  if (!kB && a.first) {  // x0 rows of the tokens, copied to the dense rows
    const int xb = 2 * a.c0;
    wbody::rows_in(
        [&](int r) {
          return reinterpret_cast<const char*>(
              a.x + tile_pixel(a, ti.gw0, r, 0) * a.c0);
        },
        ti.rows, xb, reinterpret_cast<uintptr_t>(a.x) | xb, wsm, yb);
    wbody::wg_sync(wg);
    auto drow = [&](int r) {
      return reinterpret_cast<char*>(a.dense +
                                     tile_pixel(a, ti.gw0, r, 0) * a.ccatp);
    };
    wbody::rows_out(drow, ti.rows, xb,
                    reinterpret_cast<uintptr_t>(a.dense) | db | xb, wsm, yb);
    const int pad = a.ccatp - a.ccat;
    for (int i = tid; i < ti.rows * pad; i += 128) {
      const int r = i / pad;
      reinterpret_cast<bf16*>(drow(r))[a.ccat + i - r * pad] =
          __float2bfloat16_rn(0.f);
    }
  } else if (!kB) {  // x0 | feats so far, from the dense rows
    wbody::rows_in(
        [&](int r) {
          return reinterpret_cast<const char*>(
              a.dense + tile_pixel(a, ti.gw0, r, 0) * a.ccatp);
        },
        ti.rows, yb, reinterpret_cast<uintptr_t>(a.dense) | db | yb, wsm, yb);
  } else {  // the rolled windows of y
    wbody::rows_in(
        [&](int r) {
          return reinterpret_cast<const char*>(
              a.y + tile_pixel(a, ti.gw0, r, a.shift) * g.c8);
        },
        ti.rows, yb, reinterpret_cast<uintptr_t>(a.y) | yb, wsm, yb);
  }
  wbody::wg_sync(wg);
  wbody::regs_from_rows(x, stage, g.c8, c, ti.rows);
  wbody::wg_sync(wg);

  wbody::block(x, a.w, g, wsm, ring, a.softmax, ti.gw0, a.nw, wg);

  if (!kB) {  // bf16 rows into y at their image positions
    wbody::rows_from_regs(x, stage, g.c8, g.c8);
    wbody::wg_sync(wg);
    wbody::rows_out(
        [&](int r) {
          return reinterpret_cast<char*>(
              a.y + tile_pixel(a, ti.gw0, r, 0) * g.c8);
        },
        ti.rows, yb, reinterpret_cast<uintptr_t>(a.y) | yb, wsm, yb);
    return;
  }

  // the adapter on the bf16-rounded block output (the un-shift relayout
  // rounds), normalized first when the LN precedes the Dense
  if (a.prenorm)
    wbody::normalize_into<true>(x, c, g.cp, wsm);
  else
    bf16_into(x, g.cp, wsm);
  wbody::fence_async_smem();
  wbody::wg_sync(wg);
  float* ab = reinterpret_cast<float*>(wsm + wbody::wg_layout(g, a.ng).region);
  {
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int gr = lane >> 2, t = lane & 3;
    wbody::gemm_pieces(
        ring, wbody::smem_u32(wsm), 16 * g.cp, a.ng, g.cp,
        [&](int n0, int tiles, float (&acc)[2][16]) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= tiles) continue;
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int o = n0 + 32 * j + 8 * q + 2 * t + e;
                  ab[(16 * wq + gr + 8 * h) * a.ng + o] =
                      acc[j][4 * q + 2 * h + e] + __ldg(a.bad + o);
                }
          }
        });
  }
  wbody::wg_sync(wg);
  {  // one warp per row: LN over the growth channels, into the dense rows
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int gr = a.growth;
    for (int r = wq; r < ti.rows; r += 4) {
      const float* row = ab + r * a.ng;
      bf16* dst = a.dense + tile_pixel(a, ti.gw0, r, a.shift) * a.ccatp +
                  a.dcol;
      if (a.prenorm) {
        for (int i = lane; i < gr; i += 32)
          dst[i] = __float2bfloat16_rn(row[i]);
        continue;
      }
      float s = 0.f;
      for (int i = lane; i < gr; i += 32) s += row[i];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / gr;
      float v = 0.f;
      for (int i = lane; i < gr; i += 32) {
        const float q = row[i] - mu;
        v += q * q;
      }
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const float rs = rsqrtf(v / gr + wbody::kEps);
      for (int i = lane; i < gr; i += 32)
        dst[i] = __float2bfloat16_rn((row[i] - mu) * rs * __ldg(a.gad + i) +
                                     __ldg(a.bbad + i));
    }
  }
}

struct ConvArgs {
  const bf16* dense;   // (images, H*W, ccatp)
  bf16* out;           // (images, H*W, c0)
  const char* panels;  // per 64 outputs, per tap, per 256 inputs
  const float* bias;   // (c0)
  int images, h, w, c0, no, ccatp, slot_bytes, patch_bytes;
  // int8 'conv': the weights' steps (c0), each group's amax bits of the
  // dense rows, images a group, the halo's channels a pixel (C_cat to 32)
  const float* scales;
  const unsigned* amax;
  int gimg, kq;
};

// d (64 x 32 int32, accumulator order) = A (64 x 32 int8) B^T (32 x 32
// int8) (+ d when acc), exact sums
__device__ __forceinline__ void wgmma32s8(int (&d)[16], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void fence_acc(int (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The amax of each group's dense rows (per_group elements, a multiple of
// 8): grid (chunks, groups), one atomicMax a thread block.
__global__ void __launch_bounds__(256)
    dense_amax_kernel(const bf16* dense, long long per_group,
                      unsigned* amax) {
  __shared__ float part[8];
  const bf16* base = dense + blockIdx.y * per_group;
  float mx = 0.f;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) * 8;
       i < per_group; i += static_cast<long long>(gridDim.x) * blockDim.x * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(base + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mx = fmaxf(mx, fmaxf(fabsf(fastblk::lo_f(w[k])),
                           fabsf(fastblk::hi_f(w[k]))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < 8; ++k) mx = fmaxf(mx, part[k]);
    atomicMax(amax + blockIdx.y, __float_as_uint(mx));
  }
}

// The conv with int8 'conv' (see the head of this file): the conv
// kernel's tiling, its halo quantized to int8 at the image's group scale.
__global__ void __launch_bounds__(2 * 128 + 32, 1)
    rdstb_conv_s8_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int wg = wbody::warpgroup();
  const int tiles_x = (a.w + kConvCols - 1) / kConvCols;
  const int tiles_y = (a.h + kConvRows - 1) / kConvRows;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int rest = blockIdx.x - img * tiles_x * tiles_y;
  const int y0 = (rest / tiles_x) * kConvRows;
  const int x0 = (rest % tiles_x) * kConvCols;
  char* patch = smem;
  wbody::Ring ring = wbody::make_ring(smem + a.patch_bytes, kConvSlots,
                                      a.slot_bytes,
                                      smem + a.patch_bytes +
                                          kConvSlots * a.slot_bytes);
  if (threadIdx.x == 0) wbody::ring_init(ring, 8);
  __syncthreads();
  if (wg == 2) {  // the producer warp: the int8 panels in order
    if ((threadIdx.x & 31) == 0) {
      size_t off = 0;
      int idx = 0;
      for (int n0 = 0; n0 < a.no; n0 += wbody::kPanelN)
        for (int tap = 0; tap < 9; ++tap)
          for (int k0 = 0; k0 < a.kq; k0 += wbody::kPanelK) {
            const int b = wbody::panel_bytes(a.no - n0, a.kq - k0) / 2;
            wbody::ring_put(ring, idx++, a.panels + off, b);
            off += b;
          }
    }
    return;
  }
  // the halo: (kHaloRows x kHaloCols) pixels x kq int8 channels, stored
  // [row][16-channel chunk][col][16], zero outside the image and past
  // C_cat (the dense rows' pad is zero)
  const unsigned bits = a.amax[img / a.gimg];
  const float sc = __fdiv_rn(127.f, fmaxf(__uint_as_float(bits), 1e-30f));
  const int kc = a.kq / 16;
  const int hw = a.h * a.w;
  for (int i = threadIdx.x; i < kHaloRows * kHaloCols * kc; i += 256) {
    const int p = i / kc, ch = i - p * kc;
    const int pr = p / kHaloCols, pc = p - pr * kHaloCols;
    const int yy = y0 + pr - 1, xx = x0 + pc - 1;
    uint32_t q[4] = {0u, 0u, 0u, 0u};
    if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w && 16 * ch < a.ccatp) {
      const uint4* src = reinterpret_cast<const uint4*>(
          a.dense + (static_cast<size_t>(img) * hw + yy * a.w + xx) *
                        a.ccatp + ch * 16);
      const uint4 v0 = src[0], v1 = src[1];
      const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t lo = static_cast<uint8_t>(
            tokwg::quant8(fastblk::lo_f(w[k]), sc));
        const uint32_t hi = static_cast<uint8_t>(
            tokwg::quant8(fastblk::hi_f(w[k]), sc));
        q[k >> 1] |= (lo | (hi << 8)) << (16 * (k & 1));
      }
    }
    *reinterpret_cast<uint4*>(patch + ((pr * kc + ch) * kHaloCols + pc) * 16) =
        make_uint4(q[0], q[1], q[2], q[3]);
  }
  wbody::fence_async_smem();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const uint32_t patch_s = wbody::smem_u32(patch);
  const uint32_t lbo = kHaloCols * 16, sbo = kc * kHaloCols * 16;
  const float dq = tokwg::dequant_step(bits);
  for (int n0 = 0; n0 < a.no; n0 += wbody::kPanelN) {
    const bool two = a.no - n0 >= 64;
    int acc[2][16];  // written by the products only
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
      for (int k0 = 0; k0 < a.kq; k0 += wbody::kPanelK) {
        const int kw = a.kq - k0 < wbody::kPanelK ? a.kq - k0
                                                  : wbody::kPanelK;
        const uint32_t b = wbody::ring_get(ring);
        wbody::wgmma_fence();
        for (int ks = 0; ks < kw / 32; ++ks) {
          // rows: output pixels (r, 8 wg + col) <- halo (r + dy, 8 wg +
          // col + dx); K: channels k0 + 32 ks ..
          const uint64_t da = wbody::desc(
              patch_s + ((dy * kc + (k0 + 32 * ks) / 16) * kHaloCols +
                         8 * wg + dx) * 16,
              lbo, sbo);
          const int add = tap > 0 || k0 > 0 || ks > 0;
          wgmma32s8(acc[0], da, wbody::desc(b + ks * 256, 128, kw * 8), add);
          if (two)
            wgmma32s8(acc[1], da,
                      wbody::desc(b + 32 * kw + ks * 256, 128, kw * 8), add);
        }
        wbody::wgmma_commit();
        wbody::wgmma_wait0();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wbody::ring_done(ring);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * wq + gr + 8 * h;
          const int oy = y0 + m / 8, ox = x0 + 8 * wg + m % 8;
          if (oy >= a.h || ox >= a.w) continue;
          const size_t pix = static_cast<size_t>(img) * hw + oy * a.w + ox;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = n0 + 32 * j + 8 * q + 2 * t + e;
            if (o < a.c0 && (j == 0 || two)) {
              const float y = __fadd_rn(
                  __fmul_rn(static_cast<float>(acc[j][4 * q + 2 * h + e]),
                            __fmul_rn(__ldg(a.scales + o), dq)),
                  __ldg(a.bias + o));
              a.out[pix * a.c0 + o] = __float2bfloat16_rn(
                  y + __bfloat162float(a.dense[pix * a.ccatp + o]));
            }
          }
        }
  }
}

__global__ void __launch_bounds__(2 * 128 + 32, 1)
    rdstb_conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) char smem[];
  const int wg = wbody::warpgroup();
  const int tiles_x = (a.w + kConvCols - 1) / kConvCols;
  const int tiles_y = (a.h + kConvRows - 1) / kConvRows;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int rest = blockIdx.x - img * tiles_x * tiles_y;
  const int y0 = (rest / tiles_x) * kConvRows;
  const int x0 = (rest % tiles_x) * kConvCols;
  char* patch = smem;
  wbody::Ring ring = wbody::make_ring(smem + a.patch_bytes, kConvSlots,
                                      a.slot_bytes,
                                      smem + a.patch_bytes +
                                          kConvSlots * a.slot_bytes);
  if (threadIdx.x == 0) wbody::ring_init(ring, 8);
  __syncthreads();
  if (wg == 2) {  // the producer warp: the panels in order
    if ((threadIdx.x & 31) == 0) {
      size_t off = 0;
      int idx = 0;
      for (int n0 = 0; n0 < a.no; n0 += wbody::kPanelN)
        for (int tap = 0; tap < 9; ++tap)
          for (int k0 = 0; k0 < a.ccatp; k0 += wbody::kPanelK) {
            const int b = wbody::panel_bytes(a.no - n0, a.ccatp - k0);
            wbody::ring_put(ring, idx++, a.panels + off, b);
            off += b;
          }
    }
    return;
  }
  // the halo: (kHaloRows x kHaloCols) pixels x ccatp channels, stored
  // [row][8-channel chunk][col][8], zero outside the image
  const int kc = a.ccatp / 8;
  const int hw = a.h * a.w;
  for (int i = threadIdx.x; i < kHaloRows * kHaloCols * kc; i += 256) {
    const int p = i / kc, ch = i - p * kc;
    const int pr = p / kHaloCols, pc = p - pr * kHaloCols;
    const int yy = y0 + pr - 1, xx = x0 + pc - 1;
    const bool in = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
    const bf16* src =
        in ? a.dense + (static_cast<size_t>(img) * hw + yy * a.w + xx) *
                           a.ccatp + ch * 8
           : a.dense;
    const uint32_t dst =
        wbody::smem_u32(patch + ((pr * kc + ch) * kHaloCols + pc) * 16);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  wbody::fence_async_smem();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const uint32_t patch_s = wbody::smem_u32(patch);
  const uint32_t lbo = kHaloCols * 16, sbo = kc * kHaloCols * 16;
  for (int n0 = 0; n0 < a.no; n0 += wbody::kPanelN) {
    const bool two = a.no - n0 >= 64;
    float acc[2][16];  // written by the products only
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
      for (int k0 = 0; k0 < a.ccatp; k0 += wbody::kPanelK) {
        const int kw = a.ccatp - k0 < wbody::kPanelK ? a.ccatp - k0
                                                     : wbody::kPanelK;
        const uint32_t b = wbody::ring_get(ring);
        wbody::wgmma_fence();
        for (int ks = 0; ks < kw / 16; ++ks) {
          // rows: output pixels (r, 8 wg + col) <- halo (r + dy, 8 wg +
          // col + dx); K: channels k0 + 16 ks ..
          const uint64_t da = wbody::desc(
              patch_s + ((dy * kc + (k0 + 16 * ks) / 8) * kHaloCols +
                         8 * wg + dx) * 16,
              lbo, sbo);
          const int add = tap > 0 || k0 > 0 || ks > 0;
          wbody::wgmma32(acc[0], da,
                         wbody::desc(b + ks * 256, 128, kw * 16), add);
          if (two)
            wbody::wgmma32(acc[1], da,
                           wbody::desc(b + 64 * kw + ks * 256, 128, kw * 16),
                           add);
        }
        wbody::wgmma_commit();
        wbody::wgmma_wait0();
        wbody::fence_acc(acc[0]);
        wbody::fence_acc(acc[1]);
        wbody::ring_done(ring);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * wq + gr + 8 * h;
          const int oy = y0 + m / 8, ox = x0 + 8 * wg + m % 8;
          if (oy >= a.h || ox >= a.w) continue;
          const size_t pix = static_cast<size_t>(img) * hw + oy * a.w + ox;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = n0 + 32 * j + 8 * q + 2 * t + e;
            if (o < a.c0)
              a.out[pix * a.c0 + o] = __float2bfloat16_rn(
                  acc[j][4 * q + 2 * h + e] + __ldg(a.bias + o) +
                  __bfloat162float(a.dense[pix * a.ccatp + o]));
          }
        }
  }
}

void set_weights(wbody::BlockW* w, const void* const* p) {
  w->panels = static_cast<const char*>(p[0]);
  w->bqkv = static_cast<const float*>(p[1]);
  w->bproj = static_cast<const bf16*>(p[2]);
  w->bf1 = static_cast<const float*>(p[3]);
  w->bf2 = static_cast<const bf16*>(p[4]);
  w->bias = static_cast<const bf16*>(p[5]);
}

template <int NT, bool kB>
cudaError_t launch(const StageArgs& base, const wbody::Fit& f,
                   cudaStream_t s) {
  auto kernel = rdstb_stage_kernel<NT, kB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (err != cudaSuccess) return err;
  StageArgs a = base;
  a.nslots = f.nslots;
  a.slot_bytes = f.slot_bytes;
  a.wg_bytes = f.wg_bytes;
  const int tiles = (a.windows * a.g.n + wbody::kRows - 1) / wbody::kRows;
  kernel<<<(tiles + f.nwg - 1) / f.nwg, wbody::stage_threads(f.nwg), f.smem,
           s>>>(a);
  return cudaGetLastError();
}

template <bool kB>
cudaError_t launch_nt(const StageArgs& a, const wbody::Fit& f,
                      cudaStream_t s) {
  switch (a.g.no / 32) {
    case 1: return launch<1, kB>(a, f, s);
    case 2: return launch<2, kB>(a, f, s);
    case 3: return launch<3, kB>(a, f, s);
    case 4: return launch<4, kB>(a, f, s);
  }
  return cudaErrorInvalidValue;
}

int conv_slot_bytes(int c0, int ccatp) {
  return wbody::round_up(wbody::panel_bytes(wbody::round_up(c0, 32), ccatp),
                         128);
}

int conv_patch_bytes(int ccatp) {
  return wbody::round_up(kHaloRows * kHaloCols * ccatp * 2, 128);
}

// the int8 conv's: a tap's int8 panel, and the int8 halo of kq channels
int conv_s8_slot_bytes(int c0, int kq) {
  return wbody::round_up(wbody::panel_bytes(wbody::round_up(c0, 32), kq) / 2,
                         128);
}

int conv_s8_patch_bytes(int kq) {
  return wbody::round_up(kHaloRows * kHaloCols * kq, 128);
}

// dims past route[nb] (as rdstb_bf16's): images of an int8 scale group,
// the blocks' int8 groups (tokfwd::kInt8Proj | kInt8Mlp), int8 'conv'
struct Int8Dims {
  int gimg, mask, conv;
};

Int8Dims int8_dims(const int* dims) {
  const int nb = dims[7];
  return Int8Dims{dims[11 + 2 * nb], dims[12 + 2 * nb], dims[13 + 2 * nb]};
}

// the conv's amax slots (one an image group) at the head of the workspace
long long conv_amax_bytes(const int* dims) {
  const Int8Dims q = int8_dims(dims);
  if (!q.conv || q.gimg <= 0) return 0;
  return (4LL * ((dims[0] + q.gimg - 1) / q.gimg) + 255) / 256 * 256;
}

// The token-parallel stages' geometry of DSTL d (dims as rdstb_bf16's).
tokpar::Dims token_dims(const int* dims, int d) {
  const int nw = (dims[1] / dims[3]) * (dims[2] / dims[3]);
  return tokpar::make_dims(dims[0] * nw, dims[3] * dims[3],
                           dims[5] + d * dims[6], dims[8], dims[11 + d]);
}

}  // namespace

extern "C" {

// The workspace in bytes (dims as rdstb_bf16's): the int8 conv's amax
// slots, then the token-parallel stages' (the widest of the DSTLs that run
// them); 0 if neither is needed.
long long rdstb_work_bytes(const int* dims) {
  const int nb = dims[7];
  const int nw = (dims[1] / dims[3]) * (dims[2] / dims[3]);
  const Int8Dims q = int8_dims(dims);
  long long most = 0;
  for (int d = 0; d < nb; ++d) {
    if (!dims[11 + nb + d]) continue;
    const long long b = tokfwd::carve_fwd(token_dims(dims, d), nullptr,
                                          nullptr, q.gimg * nw, q.mask);
    if (b > most) most = b;
  }
  return conv_amax_bytes(dims) + most;
}

// Dynamic shared memory of stage `k` of a call: 2 d for DSTL d's stage A,
// 2 d + 1 for its stage B, 2 nb for the conv; 0 if it does not fit.
int rdstb_stage_smem_bytes(int n, int c0, int growth, int nb, int nh,
                           const int* hidden, int k) {
  if (k == 2 * nb) {
    const int ccatp = wbody::round_up(c0 + nb * growth, 16);
    return conv_patch_bytes(ccatp) +
           kConvSlots * conv_slot_bytes(c0, ccatp) + wbody::kCtrlBytes;
  }
  const int d = k / 2;
  const wbody::Geom g = wbody::make_geom(n, c0 + d * growth, nh, hidden[d]);
  return wbody::stage_fit(g, (k & 1) ? wbody::round_up(growth, 32) : 0)
      .smem;
}

// ptrs: x, out, y scratch, dense scratch, the workspace (rdstb_work_bytes;
// 0 when it is 0 bytes), conv panels (bf16, or int8 for int8 'conv'), conv
// bias, the int8 conv's steps (c0; 0 for the bf16 conv), then per DSTL, on
// the window body (route 0): block a (6: panels, bqkv, bproj, bf1, bf2,
// packed bias), block b (6, its panels followed by the adapter's), the
// adapter bias (ng) and post-norm LN scale and bias; on the token-parallel
// stages (route 1): block a and block b (tokfwd::kBlockPtrs each), the
// adapter (tokfwd::kAdapterPtrs). dims: images, h, w, ws, shift, c0,
// growth, nb, nh, prenorm, softmax, hidden[nb], route[nb], then the images
// of an int8 scale group, the blocks' int8 groups (tokfwd::kInt8Proj |
// kInt8Mlp), int8 'conv' (0 / 1).
int rdstb_bf16(const void* const* ptrs, const int* dims, int device,
               void* stream) {
  StageArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  bf16* out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  a.y = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  a.dense = static_cast<bf16*>(const_cast<void*>(ptrs[3]));
  char* work = static_cast<char*>(const_cast<void*>(ptrs[4]));
  const int images = dims[0];
  a.h = dims[1];
  a.w_img = dims[2];
  a.ws = dims[3];
  a.shift = dims[4];
  a.c0 = dims[5];
  a.growth = dims[6];
  const int nb = dims[7];
  const int nh = dims[8];
  a.prenorm = dims[9];
  a.softmax = dims[10];
  if (nb < 1 || nb > kMaxDstl || a.ws <= 0 || a.h % a.ws || a.w_img % a.ws ||
      a.shift < 0 || a.shift >= a.ws || images < 0 || a.softmax < 0 ||
      a.softmax > 2 || a.growth <= 0 || a.c0 <= 0 || a.c0 > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nw = (a.h / a.ws) * (a.w_img / a.ws);
  a.windows = images * a.nw;
  const Int8Dims q = int8_dims(dims);
  if (q.gimg <= 0 || images % q.gimg || q.mask < 0 || q.mask > 3 ||
      (q.conv && !ptrs[7]) || (!q.conv && ptrs[7]) || (q.conv && !ptrs[4]))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ccat = a.c0 + nb * a.growth;
  a.ccatp = wbody::round_up(a.ccat, 16);
  a.ng = wbody::round_up(a.growth, 32);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* route = dims + 11 + nb;
  wbody::Fit fits[2 * kMaxDstl];
  for (int d = 0; d < nb; ++d) {
    const int c = a.c0 + d * a.growth;
    if (route[d]) {
      if (!fastblk::geom_ok(fastblk::make_geom(a.ws * a.ws, c, nh,
                                               dims[11 + d]),
                            fastblk::kMaxC) ||
          !work)
        return static_cast<int>(cudaErrorInvalidValue);
      continue;
    }
    if (q.mask) return static_cast<int>(cudaErrorInvalidValue);
    const wbody::Geom g = wbody::make_geom(a.ws * a.ws, c, nh, dims[11 + d]);
    if (!wbody::geom_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
    fits[2 * d] = wbody::stage_fit(g, 0);
    fits[2 * d + 1] = wbody::stage_fit(g, a.ng);
    if (fits[2 * d].nwg == 0 || fits[2 * d + 1].nwg == 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvArgs cv;
  cv.dense = a.dense;
  cv.out = out;
  cv.panels = static_cast<const char*>(ptrs[5]);
  cv.bias = static_cast<const float*>(ptrs[6]);
  cv.images = images;
  cv.h = a.h;
  cv.w = a.w_img;
  cv.c0 = a.c0;
  cv.no = wbody::round_up(a.c0, 32);
  cv.ccatp = a.ccatp;
  cv.kq = wbody::round_up(a.ccat, 32);
  cv.scales = static_cast<const float*>(ptrs[7]);
  cv.gimg = q.gimg;
  cv.amax = reinterpret_cast<const unsigned*>(work);
  cv.slot_bytes = q.conv ? conv_s8_slot_bytes(a.c0, cv.kq)
                         : conv_slot_bytes(a.c0, a.ccatp);
  cv.patch_bytes = q.conv ? conv_s8_patch_bytes(cv.kq)
                          : conv_patch_bytes(a.ccatp);
  const int conv_smem =
      cv.patch_bytes + kConvSlots * cv.slot_bytes + wbody::kCtrlBytes;
  if (conv_smem > wbody::kSmemOptin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (images == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const* p = ptrs + 8;
  char* token_work = work ? work + conv_amax_bytes(dims) : nullptr;
  for (int d = 0; d < nb; ++d) {
    a.first = d == 0;
    a.dcol = a.c0 + d * a.growth;
    if (route[d]) {  // the token-parallel stages
      const tokpar::Dims td = token_dims(dims, d);
      const int c = td.c, c8 = wbody::round_up(c, 8);
      const tokpar::Rows img{1, a.h, a.w_img, a.ws, 0};
      const tokpar::Rows rolled{1, a.h, a.w_img, a.ws, a.shift};
      tokfwd::FwdBufs b;
      tokfwd::carve_fwd(td, token_work, &b, q.gimg * a.nw, q.mask);
      // stage A: block a on the dense rows (on x for the first DSTL, with
      // x0 copied into the dense rows and their pad zeroed)
      tokfwd::RowsIn in = tokfwd::rows_in(a.dense, img, a.ccatp);
      if (a.first)
        in = tokfwd::RowsIn{a.x, img, a.c0, a.dense, a.ccatp, a.ccat};
      err = tokfwd::forward(td, in, a.y, img, c8, tokfwd::block_w(p), 1,
                            a.softmax, b, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      // stage B: block b on the rolled windows of y, its bf16 rows
      // token-major into the attention-output rows (free by then), the
      // adapter into the dense rows at the windows' un-shifted pixels
      const void* const* pb = p + tokfwd::kBlockPtrs;
      err = tokfwd::forward(td, tokfwd::rows_in(a.y, rolled, c8), b.ao,
                            tokfwd::kSameRows, c8, tokfwd::block_w(pb),
                            a.shift > 0 ? a.nw : 1, a.softmax, b, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = tokfwd::adapter(
          td, b.ao, c8, static_cast<bf16*>(b.xin), a.prenorm != 0,
          tokfwd::adapter_w(pb + tokfwd::kBlockPtrs), a.growth, a.dense,
          rolled, a.ccatp, a.dcol, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      p += 2 * tokfwd::kBlockPtrs + tokfwd::kAdapterPtrs;
      continue;
    }
    a.g = wbody::make_geom(a.ws * a.ws, a.c0 + d * a.growth, nh,
                           dims[11 + d]);
    StageArgs sa = a;  // stage A: block a, shift 0, shared bias
    set_weights(&sa.w, p);
    sa.w.bias_windows = 1;
    err = launch_nt<false>(sa, fits[2 * d], s);
    if (err != cudaSuccess) return static_cast<int>(err);
    StageArgs sb = a;  // stage B: block b, the adapter
    set_weights(&sb.w, p + 6);
    sb.w.bias_windows = a.shift > 0 ? a.nw : 1;
    sb.bad = static_cast<const float*>(p[12]);
    sb.gad = static_cast<const float*>(p[13]);
    sb.bbad = static_cast<const float*>(p[14]);
    err = launch_nt<true>(sb, fits[2 * d + 1], s);
    if (err != cudaSuccess) return static_cast<int>(err);
    p += 15;
  }
  const int tiles = images * ((a.h + kConvRows - 1) / kConvRows) *
                    ((a.w_img + kConvCols - 1) / kConvCols);
  if (q.conv) {  // each image group's amax, then the int8 conv
    unsigned* amax = reinterpret_cast<unsigned*>(work);
    const int groups = images / q.gimg;
    err = cudaMemsetAsync(amax, 0, 4ull * groups, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long per = static_cast<long long>(q.gimg) * a.h * a.w_img *
                          a.ccatp;
    long long chunks = (per + 256 * 8 * 8 - 1) / (256 * 8 * 8);
    if (chunks > 256) chunks = 256;
    dense_amax_kernel<<<dim3(static_cast<unsigned>(chunks), groups), 256, 0,
                        s>>>(a.dense, per, amax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(rdstb_conv_s8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               conv_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rdstb_conv_s8_kernel<<<tiles, 2 * 128 + 32, conv_smem, s>>>(cv);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaFuncSetAttribute(rdstb_conv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             conv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rdstb_conv_kernel<<<tiles, 2 * 128 + 32, conv_smem, s>>>(cv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
