// One DSTL's Swin block pair, bfloat16 fast branch, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/swin_block.py::fused_swin_pair (:1001 ->
// pallas_call :1094; `_pair_kernel` :531, `_shift_relayout` :507): block
// a (shift 0, shared bias) on window-layout tokens, its output rounded to
// bf16, the roll by -shift and re-partition, block b (shift, per-window
// bias); the output stays in the shifted window layout.
//
// The TPU kernel keeps a whole image's 20 windows in VMEM and does the
// relayout there. An image does not fit in one thread block's shared
// memory (20 x 64 x 120 bf16 = 307 KB at C = 120), so this kernel is one
// cooperative grid of co-resident thread blocks, one window at a time per
// block: stage A writes block a's bf16 output into an image-layout
// scratch (B, H, W, C) in global memory (it stays in the 50 MB L2), a
// grid-wide barrier follows, and stage B gathers each shifted window's
// rows from the scratch at (y + s mod H, x + s mod W), which is the
// roll -> partition of `_shift_relayout`. Every SM takes windows of any
// image, so the card fills at bucket 64 (1280 windows). The window body
// is fastblk::fast_block (csrc/fast_block.cuh): bound by operations, all
// products on the tensor cores.

#include "fast_block.cuh"

namespace {

using fastblk::bf16;

struct Args {
  const bf16* x;           // (images * nW, n, c), unshifted window layout
  bf16* out;               // (images * nW, n, c), shifted window layout
  bf16* y;                 // scratch (images, H, W, c)
  unsigned int* counter;   // grid barrier, zero at launch
  fastblk::Weights wa, wb;
  fastblk::Geom g;
  int images, h, w, ws, shift, softmax;
};

__device__ __forceinline__ float ldcg_bf16(const bf16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

__global__ void __launch_bounds__(fastblk::kThreads, 2)
    swin_pair_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const fastblk::Geom& g = a.g;
  float* xs = reinterpret_cast<float*>(smem);
  const int n = g.n, c = g.c, ws = a.ws;
  const int nww = a.w / ws, nw = (a.h / ws) * nww;
  const int windows = a.images * nw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  unsigned int epoch = 0;

  // stage A: block a, output scattered into image layout
  for (int win = blockIdx.x; win < windows; win += gridDim.x) {
    const bf16* xg = a.x + static_cast<size_t>(win) * n * c;
    __syncthreads();
    for (int i = threadIdx.x; i < n * c; i += blockDim.x)
      xs[i] = __bfloat162float(xg[i]);
    fastblk::fast_block(a.wa, g, smem, 0, a.softmax);
    const int img = win / nw, wi = win - img * nw;
    const int oy = (wi / nww) * ws, ox = (wi % nww) * ws;
    for (int r = warp; r < n; r += nwarps) {  // a warp per row
      bf16* dst = a.y + ((static_cast<size_t>(img) * a.h + oy + r / ws) *
                             a.w + ox + r % ws) * c;
      for (int ch = lane; ch < c; ch += 32)
        dst[ch] = __float2bfloat16_rn(xs[r * c + ch]);
    }
  }
  fastblk::grid_barrier(a.counter, epoch);

  // stage B: gather the rolled windows, block b, shifted window layout out
  for (int win = blockIdx.x; win < windows; win += gridDim.x) {
    const int img = win / nw, wi = win - img * nw;
    const int oy = (wi / nww) * ws + a.shift, ox = (wi % nww) * ws + a.shift;
    __syncthreads();
    for (int r = warp; r < n; r += nwarps) {
      const int yy = (oy + r / ws) % a.h, xx = (ox + r % ws) % a.w;
      const bf16* src =
          a.y + ((static_cast<size_t>(img) * a.h + yy) * a.w + xx) * c;
      for (int ch = lane; ch < c; ch += 32) xs[r * c + ch] = ldcg_bf16(src + ch);
    }
    fastblk::fast_block(a.wb, g, smem, wi % a.wb.bias_windows, a.softmax);
    bf16* og = a.out + static_cast<size_t>(win) * n * c;
    for (int i = threadIdx.x; i < n * c; i += blockDim.x)
      og[i] = __float2bfloat16_rn(xs[i]);
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

// ptrs: x, out, scratch, counter, then block a's and block b's
// kernel_layout weights and packed bias (9 each). dims: images, h, w, ws,
// shift, c, nh, hidden, softmax.
int swin_pair_bf16(const void* const* ptrs, const int* dims, int device,
                   void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  a.y = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  a.counter = static_cast<unsigned int*>(const_cast<void*>(ptrs[3]));
  set_weights(&a.wa, ptrs + 4);
  set_weights(&a.wb, ptrs + 13);
  a.images = dims[0];
  a.h = dims[1];
  a.w = dims[2];
  a.ws = dims[3];
  a.shift = dims[4];
  a.g = fastblk::make_geom(dims[3] * dims[3], dims[5], dims[6], dims[7]);
  a.softmax = dims[8];
  a.wa.bias_windows = 1;
  const int nw = a.ws > 0 ? (a.h / a.ws) * (a.w / a.ws) : 0;
  a.wb.bias_windows = a.shift > 0 ? nw : 1;
  if (!fastblk::geom_ok(a.g) || a.ws <= 0 || a.h % a.ws || a.w % a.ws ||
      a.shift < 0 || a.shift >= a.ws || a.images < 0 || a.softmax < 0 ||
      a.softmax > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fastblk::smem_layout(a.g).total;
  cudaError_t err = fastblk::prepare(swin_pair_kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.images == 0) return 0;
  int grid = 0;
  err = fastblk::cooperative_grid(swin_pair_kernel, smem, device,
                                  a.images * nw, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.counter, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(swin_pair_kernel), dim3(grid),
      dim3(fastblk::kThreads), params, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
