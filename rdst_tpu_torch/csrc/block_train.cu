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
// Backward (`block_train_bwd_bf16`): trainblk::block_backward
// (csrc/block_bwd.cuh), 13 kernels over all the launch's tokens: the
// forward recomputed and the VJP as token-parallel tensor-core GEMMs with
// fused epilogues, attention per (window, head), the weight gradients as
// split-K products summed in a fixed order, the score cotangents summed
// per bias window (1 window for an unshifted block, nW for a shifted
// one). The TPU kernel's grid of window chunks (3 of 3 windows at C =
// 180) is a VMEM device; the sums are the same.
//
// What bounds it on an H100: operations (16C^2 + 4NC flops per token
// forward, about twice that backward, plus the recompute). The forward
// runs every product on the tensor cores out of shared memory; the
// backward's products run as GEMMs over 18,432 tokens at the training
// geometry (see csrc/block_bwd.cuh for what each phase does about it).

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

// Floats of the backward's workspace for `windows` windows.
long long block_train_work_floats(int windows, int n, int c, int nh,
                                  int hidden) {
  return trainblk::work_floats(trainblk::make_dims(windows, n, c, nh, hidden));
}

// Kernels one backward call launches (one of them the attention VJP).
int block_train_bwd_kernels() { return trainblk::kBwdKernels; }

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

// ptrs: x, dz, dx (out), dpf (0 = none), work (block_train_work_floats),
// grad (grad_layout floats, out), dbias (bias_windows, n, nh n; out), then
// the block's FastParams weights and packed bias (9). dims: windows, n, c,
// nh, hidden, bias_windows, softmax.
int block_train_bwd_bf16(const void* const* ptrs, const int* dims,
                         int device, void* stream) {
  const int windows = dims[0], n = dims[1], c = dims[2], nh = dims[3];
  const int hid = dims[4], bw = dims[5], softmax = dims[6];
  const fastblk::Geom g = fastblk::make_geom(n, c, nh, hid);
  if (!dims_ok(g, windows, bw, softmax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (windows == 0) return 0;

  trainblk::BwdArgs b{};
  trainblk::set_block(&b, ptrs + 7, bw,
                      trainblk::make_dims(windows, n, c, nh, hid),
                      mut<float>(ptrs[4]), softmax);
  // window layout throughout: token t is row t of x, dz and dx
  b.x = static_cast<const bf16*>(ptrs[0]);
  b.dz = static_cast<const bf16*>(ptrs[1]);
  b.dx = mut<bf16>(ptrs[2]);
  b.dpf = static_cast<const float*>(ptrs[3]);
  b.dp_col = 0;
  b.dp_stride = 2;
  b.grads = mut<float>(ptrs[5]);
  b.dbias = mut<float>(ptrs[6]);
  return static_cast<int>(
      trainblk::block_backward(b, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
