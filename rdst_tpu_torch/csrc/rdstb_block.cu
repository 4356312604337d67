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
// a thread block's shared memory, so the kernel is one cooperative grid of
// co-resident thread blocks that walks the RDSTB in 2*nb + 1 stages with
// a grid-wide barrier between them; the state between stages lives in
// two global scratch buffers (the block-a output y at width <= C0 +
// (nb-1)*g, and the grown features at nb*g), 25 MB at bucket 64, so it
// stays in the 50 MB L2:
// * stage A of DSTL d: per window, gather rows of x0 | feats, block a,
//   scatter the bf16 rows into y at their image positions;
// * stage B: per shifted window, gather y at (y + s mod H, x + s mod W)
//   (the roll and re-partition), block b, round to bf16, the adapter as
//   one more tensor-core product, and scatter the growth channels into
//   feats at the rows' unrolled positions (the un-shift relayout);
// * conv: per 8 x 8 output tile, load a zero-padded (ws+2)^2 halo of
//   x0 | feats into shared memory and run the 3x3 conv as an implicit
//   GEMM over K = 9 * C_cat (tap-major, as `_conv3x3`'s (9*C_cat, C0)
//   weight) on the tensor cores, then bias, residual, bf16.
// Every SM takes windows of any image in every stage. Bound by operations
// (the conv adds 2 * 1350 * 60 flops per pixel to the blocks' work).

#include "fast_block.cuh"

namespace {

using fastblk::bf16;

constexpr int kMaxDstl = 4;

struct Dstl {
  fastblk::Weights wa, wb;
  fastblk::Geom g;
  const bf16* wad;   // (gp, cp) adapter weight, (out, in), padded
  const float* bad;  // (gp)
  const float* gad;  // (g) post-norm LN scale (unused when pre-norm)
  const float* bbad; // (g) post-norm LN bias
};

struct Args {
  const bf16* x;          // (images, H*W, c0) image-major tokens
  bf16* out;              // (images, H*W, c0)
  bf16* y;                // scratch (images, H*W, cmax)
  bf16* f;                // scratch (images, H*W, nb * growth)
  unsigned int* counter;  // grid barrier, zero at launch
  const bf16* wc;         // (c0p, 9 * ccp) conv weight, (out, tap, in)
  const float* bc;        // (c0)
  Dstl d[kMaxDstl];
  int images, h, w, ws, shift, c0, growth, nb, prenorm, softmax;
  int cmax, ccat, ccp, c0p, gp;
};

__device__ __forceinline__ bf16 ldcg_bf16(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// channel ch of pixel p (image-major over the batch) of x0 | feats
__device__ __forceinline__ bf16 dense_at(const Args& a, size_t p, int ch) {
  if (ch < a.c0) return a.x[p * a.c0 + ch];
  return ldcg_bf16(a.f + p * (a.nb * a.growth) + (ch - a.c0));
}

__global__ void __launch_bounds__(fastblk::kThreads, 2)
    rdstb_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int ws = a.ws, nww = a.w / ws, nw = (a.h / ws) * nww;
  const int windows = a.images * nw;
  const int hw = a.h * a.w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  unsigned int epoch = 0;

  for (int d = 0; d < a.nb; ++d) {
    const Dstl& L = a.d[d];
    const fastblk::Geom& g = L.g;
    const int n = g.n, c = g.c;
    const fastblk::Smem lay = fastblk::smem_layout(g);

    // stage A: block a on unshifted windows of x0 | feats -> y
    for (int win = blockIdx.x; win < windows; win += gridDim.x) {
      const int img = win / nw, wi = win - img * nw;
      const int oy = (wi / nww) * ws, ox = (wi % nww) * ws;
      __syncthreads();
      for (int r = warp; r < n; r += nwarps) {  // a warp per row
        const size_t p = static_cast<size_t>(img) * hw +
                         (oy + r / ws) * a.w + ox + r % ws;
        for (int ch = lane; ch < c; ch += 32)
          xs[r * c + ch] = __bfloat162float(dense_at(a, p, ch));
      }
      fastblk::fast_block(L.wa, g, smem, 0, a.softmax);
      for (int r = warp; r < n; r += nwarps) {
        bf16* dst = a.y + (static_cast<size_t>(img) * hw +
                           (oy + r / ws) * a.w + ox + r % ws) * a.cmax;
        for (int ch = lane; ch < c; ch += 32)
          dst[ch] = __float2bfloat16_rn(xs[r * c + ch]);
      }
    }
    fastblk::grid_barrier(a.counter, epoch);

    // stage B: block b on the rolled windows of y, adapter -> feats
    for (int win = blockIdx.x; win < windows; win += gridDim.x) {
      const int img = win / nw, wi = win - img * nw;
      const int oy = (wi / nww) * ws + a.shift;
      const int ox = (wi % nww) * ws + a.shift;
      __syncthreads();
      for (int r = warp; r < n; r += nwarps) {
        const int pix = ((oy + r / ws) % a.h) * a.w + (ox + r % ws) % a.w;
        const bf16* src =
            a.y + (static_cast<size_t>(img) * hw + pix) * a.cmax;
        for (int ch = lane; ch < c; ch += 32)
          xs[r * c + ch] = __bfloat162float(ldcg_bf16(src + ch));
      }
      fastblk::fast_block(L.wb, g, smem, wi % L.wb.bias_windows, a.softmax);
      // adapter input: the bf16-rounded block output (the un-shift
      // relayout rounds), normalized first when the LN precedes the Dense
      bf16* xn = reinterpret_cast<bf16*>(smem + lay.xn);
      for (int i = threadIdx.x; i < n * c; i += blockDim.x)
        xs[i] = fastblk::round_bf16(xs[i]);
      __syncthreads();
      if (a.prenorm) {
        fastblk::normalize_rows(xs, xn, g.lda, n, c, g.cp);
      } else {
        for (int i = threadIdx.x; i < n * g.cp; i += blockDim.x) {
          const int r = i / g.cp, ch = i - r * g.cp;
          xn[r * g.lda + ch] = __float2bfloat16_rn(ch < c ? xs[r * c + ch]
                                                          : 0.f);
        }
      }
      __syncthreads();
      float* ab = reinterpret_cast<float*>(smem + lay.region);  // (n, gp)
      fastblk::gemm(xn, g.lda, n, g.cp / 16, L.wad, g.cp, a.gp / 8,
                    [&](int m, int o, float v0, float v1) {
                      ab[m * a.gp + o] = v0 + __ldg(L.bad + o);
                      ab[m * a.gp + o + 1] = v1 + __ldg(L.bad + o + 1);
                    });
      __syncthreads();
      {  // one warp per row: LN over the growth channels, store to feats
        const int gr = a.growth;
        for (int r = warp; r < n; r += nwarps) {
          const float* row = ab + r * a.gp;
          const int pix =
              ((oy + r / ws) % a.h) * a.w + (ox + r % ws) % a.w;
          bf16* dst = a.f + (static_cast<size_t>(img) * hw + pix) *
                                (a.nb * gr) + d * gr;
          if (a.prenorm) {
            for (int i = lane; i < gr; i += 32)
              dst[i] = __float2bfloat16_rn(row[i]);
            continue;
          }
          float s = 0.f;
          for (int i = lane; i < gr; i += 32) s += row[i];
          const float mu = fastblk::warp_sum(s) / gr;
          float v = 0.f;
          for (int i = lane; i < gr; i += 32) {
            const float q = row[i] - mu;
            v += q * q;
          }
          const float rs = rsqrtf(fastblk::warp_sum(v) / gr + fastblk::kEps);
          for (int i = lane; i < gr; i += 32)
            dst[i] = __float2bfloat16_rn((row[i] - mu) * rs * __ldg(L.gad + i)
                                         + __ldg(L.bbad + i));
        }
      }
    }
    fastblk::grid_barrier(a.counter, epoch);
  }

  // conv 3x3 (zero padding) over x0 | feats, + bias + x0, one ws x ws tile
  // of output pixels per step
  const int pw = ws + 2, ldp = a.ccp + 8;
  bf16* patch = reinterpret_cast<bf16*>(smem);  // (pw * pw, ldp)
  const int n = ws * ws;
  const int gr = lane >> 2, t = lane & 3;
  for (int win = blockIdx.x; win < windows; win += gridDim.x) {
    const int img = win / nw, wi = win - img * nw;
    const int oy = (wi / nww) * ws, ox = (wi % nww) * ws;
    __syncthreads();
    for (int p = warp; p < pw * pw; p += nwarps) {  // a warp per halo pixel
      const int yy = oy + p / pw - 1, xx = ox + p % pw - 1;
      const bool in = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
      const size_t q = static_cast<size_t>(img) * hw + yy * a.w + xx;
      for (int ch = lane; ch < a.ccp; ch += 32)
        patch[p * ldp + ch] = in && ch < a.ccat ? dense_at(a, q, ch)
                                                : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    for (int nt = warp; nt < a.c0p / 8; nt += nwarps) {
      float acc[4][4];
      int row[4][2];  // halo row of this lane's output pixels, tap (0, 0)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
        const int m0 = mt * 16 + gr, m1 = m0 + 8;
        row[mt][0] = (m0 / ws) * pw + m0 % ws;
        row[mt][1] = (m1 / ws) * pw + m1 % ws;
      }
      const bf16* wr = a.wc + static_cast<size_t>(nt * 8 + gr) * (9 * a.ccp) +
                       2 * t;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx, wr += a.ccp) {
          const bf16* tap = patch + (dy * pw + dx) * ldp + 2 * t;
          for (int ch0 = 0; ch0 < a.ccp; ch0 += 16) {
            const uint32_t b0 = fastblk::ldg32(wr + ch0);
            const uint32_t b1 = fastblk::ldg32(wr + ch0 + 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              if (mt * 16 < n) {
                const bf16* p0 = tap + row[mt][0] * ldp + ch0;
                const bf16* p1 = tap + row[mt][1] * ldp + ch0;
                fastblk::mma16816(acc[mt], fastblk::ld32(p0),
                                  fastblk::ld32(p1), fastblk::ld32(p0 + 8),
                                  fastblk::ld32(p1 + 8), b0, b1);
              }
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt * 16 < n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = mt * 16 + gr + 8 * half;
            const size_t pix = static_cast<size_t>(img) * hw +
                               (oy + m / ws) * a.w + ox + m % ws;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int o = nt * 8 + 2 * t + u;
              if (o < a.c0)
                a.out[pix * a.c0 + o] = __float2bfloat16_rn(
                    acc[mt][2 * half + u] + __ldg(a.bc + o) +
                    __bfloat162float(a.x[pix * a.c0 + o]));
            }
          }
        }
      }
    }
  }
}

void set_weights(fastblk::Weights* w, const void* const* p) {
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

}  // namespace

extern "C" {

// Dynamic shared memory of a launch: the widest DSTL's window body, the
// adapter rows inside its region, and the conv halo.
int rdstb_smem_bytes(int ws, int c0, int growth, int nb, int nh,
                     const int* hidden) {
  int smem = 0;
  for (int d = 0; d < nb; ++d) {
    const fastblk::Geom g =
        fastblk::make_geom(ws * ws, c0 + d * growth, nh, hidden[d]);
    const fastblk::Smem s = fastblk::smem_layout(g);
    int need = s.total;
    const int ad = s.region + 4 * g.n * fastblk::round_up(growth, 8);
    if (ad > need) need = ad;
    if (need > smem) smem = need;
  }
  const int ccp = fastblk::round_up(c0 + nb * growth, 16);
  const int patch = 2 * (ws + 2) * (ws + 2) * (ccp + 8);
  return patch > smem ? patch : smem;
}

// ptrs: x, out, y scratch, feats scratch, counter, conv weight, conv bias,
// then per DSTL: block a (9: kernel_layout weights + packed bias), block b
// (9), adapter weight, bias, LN scale, LN bias. dims: images, h, w, ws,
// shift, c0, growth, nb, nh, prenorm, softmax, hidden[nb].
int rdstb_bf16(const void* const* ptrs, const int* dims, int device,
               void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  a.y = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  a.f = static_cast<bf16*>(const_cast<void*>(ptrs[3]));
  a.counter = static_cast<unsigned int*>(const_cast<void*>(ptrs[4]));
  a.wc = static_cast<const bf16*>(ptrs[5]);
  a.bc = static_cast<const float*>(ptrs[6]);
  a.images = dims[0];
  a.h = dims[1];
  a.w = dims[2];
  a.ws = dims[3];
  a.shift = dims[4];
  a.c0 = dims[5];
  a.growth = dims[6];
  a.nb = dims[7];
  const int nh = dims[8];
  a.prenorm = dims[9];
  a.softmax = dims[10];
  if (a.nb < 1 || a.nb > kMaxDstl || a.ws <= 0 || a.h % a.ws || a.w % a.ws ||
      a.shift < 0 || a.shift >= a.ws || a.images < 0 || a.softmax < 0 ||
      a.softmax > 2 || a.growth <= 0 || a.c0 <= 0 || a.c0 > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (a.h / a.ws) * (a.w / a.ws);
  a.cmax = a.c0 + (a.nb - 1) * a.growth;
  a.ccat = a.c0 + a.nb * a.growth;
  a.ccp = fastblk::round_up(a.ccat, 16);
  a.c0p = fastblk::round_up(a.c0, 16);
  a.gp = fastblk::round_up(a.growth, 8);
  for (int d = 0; d < a.nb; ++d) {
    const void* const* p = ptrs + 7 + 22 * d;
    Dstl& L = a.d[d];
    set_weights(&L.wa, p);
    set_weights(&L.wb, p + 9);
    L.wad = static_cast<const bf16*>(p[18]);
    L.bad = static_cast<const float*>(p[19]);
    L.gad = static_cast<const float*>(p[20]);
    L.bbad = static_cast<const float*>(p[21]);
    L.wa.bias_windows = 1;
    L.wb.bias_windows = a.shift > 0 ? nw : 1;
    L.g = fastblk::make_geom(a.ws * a.ws, a.c0 + d * a.growth, nh,
                             dims[11 + d]);
    if (!fastblk::geom_ok(L.g))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem =
      rdstb_smem_bytes(a.ws, a.c0, a.growth, a.nb, nh, dims + 11);
  cudaError_t err = fastblk::prepare(rdstb_kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.images == 0) return 0;
  int grid = 0;
  err = fastblk::cooperative_grid(rdstb_kernel, smem, device, a.images * nw,
                                  &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rdstb_kernel), dim3(grid),
      dim3(fastblk::kThreads), params, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
