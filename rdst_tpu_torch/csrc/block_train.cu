// One differentiable Swin block of the bf16 training step, forward and
// backward, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/block_train.py::fused_swin_block_train (:307
// -> `_fused_swin_block_train_impl` :333; forward pallas_call :187,
// backward pallas_call :220, joined by jax.custom_vjp :254-278). It is
// the training twin of the fast block (csrc/swin_block_fast.cu) for the
// widths a DSTL pair cannot hold on the TPU (SwinIR-std, C = 180): the
// fast body with an exact division of the softmax normalizer and the
// stochastic-depth factor columns `dpf` (rows x [attn, mlp]) on the
// residual branches. The TPU kernel's bias adds through a ones-column
// matmul (`mm_bias`) are a Mosaic lowering device: a plain f32 add here.
//
// Forward (`block_train_fwd_bf16`): one thread block per window running
// fastblk::fast_block (csrc/fast_block.cuh) in its exact-division form;
// tokens in and out in window layout, the bias shared (1 window) or per
// window (the block's nW, a shifted block).
//
// Backward (`block_train_bwd_bf16`): trainblk::block_bwd_kernel
// (csrc/block_bwd.cuh: each window's forward recomputed, then its
// hand-written VJP, gradients in f32 per thread block), then two fixed-
// order reductions: the weight-gradient slabs, and the score cotangents
// per bias window (1 window for an unshifted block, nW for a shifted one).
// The TPU kernel's grid of window chunks (3 of 3 windows at C = 180) is a
// VMEM device; the sums are the same.
//
// What bounds it on an H100: operations (16C^2 + 4NC flops per token
// forward, about twice that backward, plus the recompute). The forward
// runs every product on the tensor cores out of shared memory; the
// backward stages its window state through device memory (about 1.25 MB
// per thread block at C = 180), which bounds this first version.

#include "fast_block.cuh"
#include "block_bwd.cuh"

namespace {

using fastblk::bf16;

struct FwdArgs {
  const bf16* x;      // (windows, n, c), window layout
  bf16* out;          // (windows, n, c)
  const float* dpf;   // (windows * n, 2) or null
  fastblk::Weights w;
  fastblk::Geom g;
  int windows, softmax;
};

__global__ void __launch_bounds__(fastblk::kThreads)
    block_train_fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) char smem[];
  const fastblk::Geom& g = a.g;
  float* xs = reinterpret_cast<float*>(smem);
  const int rows = g.n * g.c;
  for (int win = blockIdx.x; win < a.windows; win += gridDim.x) {
    const bf16* xg = a.x + static_cast<size_t>(win) * rows;
    const float* dp =
        a.dpf ? a.dpf + static_cast<size_t>(win) * g.n * 2 : nullptr;
    __syncthreads();  // the previous window's output is stored
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      xs[i] = __bfloat162float(xg[i]);
    fastblk::fast_block(a.w, g, smem, win % a.w.bias_windows, a.softmax,
                        true, dp, dp ? dp + 1 : nullptr, 2);
    bf16* og = a.out + static_cast<size_t>(win) * rows;
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      og[i] = __float2bfloat16_rn(xs[i]);
  }
}

template <class T>
T* mut(const void* p) {
  return static_cast<T*>(const_cast<void*>(p));
}

bool dims_ok(const fastblk::Geom& g, int windows, int bias_windows,
             int softmax) {
  return fastblk::geom_ok(g, fastblk::kMaxC) && windows >= 0 &&
         bias_windows > 0 && windows % bias_windows == 0 && softmax >= 0 &&
         softmax <= 2;
}

}  // namespace

extern "C" {

// Floats of the backward's per-thread-block workspace and weight-gradient
// partials; the wrapper allocates grid times each.
int block_train_work_floats(int n, int c, int nh, int hidden) {
  return trainblk::work_layout(n, c, nh, hidden).total;
}

int block_train_grad_floats(int c, int hidden) {
  return trainblk::grad_layout(c, hidden).total;
}

// ptrs: x, out, dpf (0 = none), then the block's kernel_layout weights and
// packed bias (9). dims: windows, n, c, nh, hidden, bias_windows, softmax.
int block_train_fwd_bf16(const void* const* ptrs, const int* dims,
                         int device, void* stream) {
  FwdArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = mut<bf16>(ptrs[1]);
  a.dpf = static_cast<const float*>(ptrs[2]);
  a.w.wqkv = static_cast<const bf16*>(ptrs[3]);
  a.w.bqkv = static_cast<const float*>(ptrs[4]);
  a.w.wproj = static_cast<const bf16*>(ptrs[5]);
  a.w.bproj = static_cast<const bf16*>(ptrs[6]);
  a.w.w1 = static_cast<const bf16*>(ptrs[7]);
  a.w.bf1 = static_cast<const float*>(ptrs[8]);
  a.w.w2 = static_cast<const bf16*>(ptrs[9]);
  a.w.bf2 = static_cast<const bf16*>(ptrs[10]);
  a.w.bias = static_cast<const bf16*>(ptrs[11]);
  a.windows = dims[0];
  a.g = fastblk::make_geom(dims[1], dims[2], dims[3], dims[4]);
  a.w.bias_windows = dims[5];
  a.softmax = dims[6];
  if (!dims_ok(a.g, a.windows, a.w.bias_windows, a.softmax))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fastblk::smem_layout(a.g).total;
  cudaError_t err = fastblk::prepare(block_train_fwd_kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.windows == 0) return 0;
  block_train_fwd_kernel<<<a.windows, fastblk::kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x, dz, dx (out), dpf (0 = none), work, slab (zeroed), dsw
// (windows, n, nh n) score cotangents, grad (grad_layout floats), dbias
// (bias_windows, n, nh n), then the block's FastParams weights and packed
// bias (9). dims: windows, n, c, nh, hidden, bias_windows, softmax, grid.
int block_train_bwd_bf16(const void* const* ptrs, const int* dims,
                         int device, void* stream) {
  const int windows = dims[0], n = dims[1], c = dims[2], nh = dims[3];
  const int hid = dims[4], bw = dims[5], softmax = dims[6], grid = dims[7];
  const fastblk::Geom g = fastblk::make_geom(n, c, nh, hid);
  if (!dims_ok(g, windows, bw, softmax) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (windows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  trainblk::BwdArgs b{};
  trainblk::set_block_weights(&b.w, ptrs + 9, bw);
  b.x_win = static_cast<const bf16*>(ptrs[0]);
  b.dz_win = static_cast<const bf16*>(ptrs[1]);
  b.dx_win = mut<bf16>(ptrs[2]);
  b.dpf = static_cast<const float*>(ptrs[3]);
  b.dp_col = 0;
  b.dp_stride = 2;
  b.work = mut<float>(ptrs[4]);
  b.slab = mut<float>(ptrs[5]);
  b.dsw = mut<float>(ptrs[6]);
  b.windows = windows;
  b.n = n;
  b.c = c;
  b.nh = nh;
  b.hidden = hid;
  b.softmax = softmax;
  // window layout throughout: one row of windows per bias period, so the
  // kernel's window-in-image index is win % bw (no relayout, no shift)
  int ws = 1;
  while (ws * ws < n) ++ws;
  b.ws = ws;
  b.ih = ws;
  b.iw = ws * bw;
  b.img_shift = 0;

  trainblk::block_bwd_kernel<<<grid, 256, 0, s>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gsize = trainblk::grad_layout(c, hid).total, bsize = n * nh * n;
  trainblk::sum_parts_kernel<<<(gsize + 255) / 256, 256, 0, s>>>(
      b.slab, grid, gsize, gsize, 1, mut<float>(ptrs[7]));
  trainblk::sum_parts_kernel<<<(bw * bsize + 255) / 256, 256, 0, s>>>(
      b.dsw, windows, bsize, bsize, bw, mut<float>(ptrs[8]));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
