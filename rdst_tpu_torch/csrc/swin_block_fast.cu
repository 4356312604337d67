// Whole Swin block, bfloat16 fast branch, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/swin_block.py::fused_swin_block (:757 ->
// pallas_call :931) with bf16 tokens, i.e. the fast branch of `_body`
// (:261), including its `pack=2` layout (:822-860, two windows per lane
// row: a TPU lane-fill device with the same arithmetic, so it has no
// counterpart here), its window-chunked grid (:867-886, a VMEM device:
// here every window is its own thread block) and its int8 qkv operands
// (`quant={'qkv'}`, :888-897). Takes C up to fastblk::kMaxC (SwinIR-std's
// 180: 150,528 bytes of shared memory per window).
//
// One thread block per window: load the window's bf16 rows widened to
// f32, run fastblk::fast_block (csrc/fast_block.cuh: every product on the
// tensor cores, all intermediates in shared memory), store bf16. Bound on
// an H100 by operations; see the header for the design.

#include "fast_block.cuh"

namespace {

using fastblk::bf16;

struct Args {
  const bf16* x;  // (windows, n, c)
  bf16* out;
  fastblk::Weights w;
  fastblk::Geom g;
  int windows, softmax;
};

template <bool kInt8>
__global__ void __launch_bounds__(fastblk::kThreads)
    swin_block_fast_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const fastblk::Geom& g = a.g;
  float* xs = reinterpret_cast<float*>(smem);
  const int rows = g.n * g.c;
  for (int win = blockIdx.x; win < a.windows; win += gridDim.x) {
    const bf16* xg = a.x + static_cast<size_t>(win) * rows;
    __syncthreads();  // the previous window's output is stored
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      xs[i] = __bfloat162float(xg[i]);
    fastblk::fast_block<kInt8>(a.w, g, smem, win % a.w.bias_windows,
                               a.softmax);
    bf16* og = a.out + static_cast<size_t>(win) * rows;
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      og[i] = __float2bfloat16_rn(xs[i]);
  }
}

}  // namespace

extern "C" {

// ptrs: x, out, wqkv, bqkv, wproj, bproj, w1, bf1, w2, bf2, bias (the
// kernels.swin_block.kernel_layout order, then the packed bias), then the
// int8 qkv weights (3 cp, kq) and their steps (3 cp), both 0 for bf16 qkv.
// dims: windows, n, c, nh, hidden, bias_windows, softmax.
int swin_block_fast_bf16(const void* const* ptrs, const int* dims,
                         int device, void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  a.w.wqkv = static_cast<const bf16*>(ptrs[2]);
  a.w.bqkv = static_cast<const float*>(ptrs[3]);
  a.w.wproj = static_cast<const bf16*>(ptrs[4]);
  a.w.bproj = static_cast<const bf16*>(ptrs[5]);
  a.w.w1 = static_cast<const bf16*>(ptrs[6]);
  a.w.bf1 = static_cast<const float*>(ptrs[7]);
  a.w.w2 = static_cast<const bf16*>(ptrs[8]);
  a.w.bf2 = static_cast<const bf16*>(ptrs[9]);
  a.w.bias = static_cast<const bf16*>(ptrs[10]);
  a.w.wq = static_cast<const int8_t*>(ptrs[11]);
  a.w.wqs = static_cast<const float*>(ptrs[12]);
  a.windows = dims[0];
  a.g = fastblk::make_geom(dims[1], dims[2], dims[3], dims[4]);
  a.w.bias_windows = dims[5];
  a.softmax = dims[6];
  if (!fastblk::geom_ok(a.g, fastblk::kMaxC) || !a.w.wq != !a.w.wqs ||
      a.w.bias_windows <= 0 || a.windows < 0 ||
      a.windows % a.w.bias_windows != 0 || a.softmax < 0 || a.softmax > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fastblk::smem_layout(a.g).total;
  const bool int8 = a.w.wq != nullptr;
  cudaError_t err =
      int8 ? fastblk::prepare(swin_block_fast_kernel<true>, smem, device)
           : fastblk::prepare(swin_block_fast_kernel<false>, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.windows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8)
    swin_block_fast_kernel<true><<<a.windows, fastblk::kThreads, smem, s>>>(a);
  else
    swin_block_fast_kernel<false><<<a.windows, fastblk::kThreads, smem, s>>>(
        a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
