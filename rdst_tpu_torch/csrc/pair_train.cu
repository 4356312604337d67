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
// each trainblk::block_backward (csrc/block_bwd.cuh: 13 kernels over all
// the launch's tokens -- the forward recomputed and the VJP as
// token-parallel tensor-core GEMMs with fused epilogues, attention per
// (window, head), deterministic split-K weight gradients). The two blocks
// share one workspace. The relayout is a row map: block b reads its input
// from block a's output y (image layout) at the rolled positions and
// scatters its input cotangent back there into an image-layout buffer
// (a permutation, so the scatter is conflict-free), from which block a
// reads its output cotangent.
//
// What bounds it on an H100: operations (the backward does about twice
// the forward's products, plus the recompute); see csrc/block_bwd.cuh
// for what each phase of the backward does about it.

#include "fast_block.cuh"
#include "block_bwd.cuh"

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

// Floats of the backward's workspace for `windows` windows (shared by
// the two blocks).
long long pair_train_work_floats(int windows, int n, int c, int nh,
                                 int hidden) {
  return trainblk::work_floats(trainblk::make_dims(windows, n, c, nh, hidden));
}

// Kernels one backward call launches (two of them attention VJPs).
int pair_train_bwd_kernels() { return 2 * trainblk::kBwdKernels; }

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
// layout), dpf (0 = none), work (pair_train_work_floats), grad_a, grad_b
// (grad_layout floats each, out), dbias_a (1, n, nh n), dbias_b (bw_b, n,
// nh n), then block a's and block b's FastParams weights and packed bias
// (9 each). dims: images, h, w, ws, shift, c, nh, hidden, softmax.
int pair_train_bwd_bf16(const void* const* ptrs, const int* dims, int device,
                        void* stream) {
  const int images = dims[0], h = dims[1], w = dims[2], ws = dims[3];
  const int shift = dims[4], c = dims[5], nh = dims[6], hid = dims[7];
  const int softmax = dims[8];
  const fastblk::Geom g = fastblk::make_geom(ws * ws, c, nh, hid);
  if (!dims_ok(g, images, h, w, ws, shift, softmax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = ws * ws, nw = (h / ws) * (w / ws), windows = images * nw;
  if (windows == 0) return 0;
  const int bw_b = shift > 0 ? nw : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const trainblk::Dims d = trainblk::make_dims(windows, n, c, nh, hid);
  float* work = mut<float>(ptrs[6]);

  // block b: input gathered from y at the rolled positions, cotangent in
  // the shifted window layout, input cotangent scattered back into dy
  trainblk::BwdArgs b{};
  trainblk::set_block(&b, ptrs + 20, bw_b, d, work, softmax);
  const trainblk::Rows rolled{1, h, w, ws, shift};
  b.x = static_cast<const bf16*>(ptrs[2]);
  b.xr = rolled;
  b.dz = static_cast<const bf16*>(ptrs[1]);
  b.dx = mut<bf16>(ptrs[4]);
  b.dxr = rolled;
  b.dpf = static_cast<const float*>(ptrs[5]);
  b.dp_col = 2;
  b.dp_stride = 4;
  b.grads = mut<float>(ptrs[8]);
  b.dbias = mut<float>(ptrs[10]);
  err = trainblk::block_backward(b, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // block a: input in windows, cotangent gathered from dy unshifted
  trainblk::BwdArgs a{};
  trainblk::set_block(&a, ptrs + 11, 1, d, work, softmax);
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.dz = static_cast<const bf16*>(ptrs[4]);
  a.dzr = trainblk::Rows{1, h, w, ws, 0};
  a.dx = mut<bf16>(ptrs[3]);
  a.dpf = b.dpf;
  a.dp_col = 0;
  a.dp_stride = 4;
  a.grads = mut<float>(ptrs[7]);
  a.dbias = mut<float>(ptrs[9]);
  return static_cast<int>(trainblk::block_backward(a, s));
}

}  // extern "C"
