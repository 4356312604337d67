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
// Forward (`block_train_fwd_bf16`): the token-parallel forward of
// csrc/token_fwd.cuh (five kernels over all the launch's tokens: LN1 rows,
// the qkv GEMM, attention per (window, head), proj + residual + LN2, fc1 +
// GELU + fc2 + residual), its GEMMs the persistent TMA-fed wgmma kernels of
// csrc/token_wgmma.cuh, with the two training differences: the attention
// divides exactly (`attn_fwd_kernel<false>`, the kernel the backward's
// recompute runs) and the factor columns scale the two residual branches
// in the proj and fc2 epilogues. Tokens in and out in window layout, the
// bias shared (1 window) or per window (the block's nW, a shifted block);
// the weights as kernels.swin_block.token_wgmma_layout lays them out; the
// scratch between the phases carved by tokfwd::carve_fwd from one buffer
// the caller keeps. Nothing is saved for the backward: it recomputes from
// x.
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
// forward, about twice that backward, plus the recompute). Both run their
// products as GEMMs over all 18,432 tokens of the training geometry (see
// csrc/token_wgmma.cuh and csrc/block_bwd.cuh for what each phase does
// about it).

#include "block_bwd.cuh"
#include "token_fwd.cuh"

namespace {

using fastblk::bf16;

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

// The forward's scratch in bytes (dims as block_train_fwd_bf16's).
long long block_train_fwd_work_bytes(const int* dims) {
  return tokfwd::carve_fwd(
      tokpar::make_dims(dims[0], dims[1], dims[2], dims[3], dims[4]),
      nullptr, nullptr);
}

// Kernels one forward call launches.
int block_train_fwd_kernels() { return tokfwd::kFwdKernels; }

// ptrs: x, out, dpf (0 = none), the block's weights in the
// kernels.swin_block.token_wgmma_layout order (wqkv, bqkv, wproj, bproj,
// w1, bf1, w2, bf2), the packed bias, the scratch
// (block_train_fwd_work_bytes). dims: windows, n, c, nh, hidden,
// bias_windows, softmax.
int block_train_fwd_bf16(const void* const* ptrs, const int* dims,
                         int device, void* stream) {
  const int windows = dims[0], n = dims[1], c = dims[2], nh = dims[3];
  const int hid = dims[4], bw = dims[5], softmax = dims[6];
  if (!dims_ok(fastblk::make_geom(n, c, nh, hid), windows, bw, softmax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || windows == 0) return static_cast<int>(err);
  const tokpar::Dims d = tokpar::make_dims(windows, n, c, nh, hid);
  tokfwd::FwdBufs b;
  tokfwd::carve_fwd(d, mut<char>(ptrs[12]), &b);
  const void* const* w = ptrs + 3;
  const tokfwd::BlockW wts{static_cast<const bf16*>(w[0]),
                           static_cast<const float*>(w[1]),
                           static_cast<const bf16*>(w[2]),
                           static_cast<const bf16*>(w[3]),
                           static_cast<const bf16*>(w[4]),
                           static_cast<const float*>(w[5]),
                           static_cast<const bf16*>(w[6]),
                           static_cast<const bf16*>(w[7]),
                           static_cast<const bf16*>(w[8]),
                           nullptr,
                           nullptr};
  return static_cast<int>(tokfwd::forward(
      d,
      tokfwd::rows_in(static_cast<const bf16*>(ptrs[0]), tokfwd::kSameRows,
                      c),
      mut<bf16>(ptrs[1]), tokfwd::kSameRows, c, wts, bw, softmax, b,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(ptrs[2]),
      true));
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
