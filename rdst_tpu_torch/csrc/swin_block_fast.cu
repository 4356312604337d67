// Whole Swin block, bfloat16 fast branch, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/swin_block.py::fused_swin_block (:757 ->
// pallas_call :931) with bf16 tokens, i.e. the fast branch of `_body`
// (:261), including its `pack=2` layout (:822-860, two windows per lane
// row: a TPU lane-fill device with the same arithmetic, so it has no
// counterpart here), its window-chunked grid (:867-886, a VMEM device)
// and its int8 qkv operands (`quant={'qkv'}`, :888-897). Takes C up to
// fastblk::kMaxC (SwinIR-std's 180).
//
// What bounds it on an H100: operations (16C^2 + 4NC flops per token
// against 4C bytes of tokens in and out), on the tensor cores. Two
// designs compute the same numbers, and the plan picks one by C
// (kernels.swin_block.fast_route):
//
//  * the token-parallel forward (`swin_block_fast_tokens`, the wide
//    blocks; csrc/token_fwd.cuh, which the pair and RDSTB stages the
//    window body does not take run too): five phases over all T =
//    windows x n tokens: LN1 rows (bf16, or int8 for the int8 qkv
//    product), the qkv GEMM (bf16, or int8 on wgmma .s8), attention per
//    (window, head) with the approximate reciprocal (csrc/token_gemm.cuh,
//    shared with the training backward), the projection with its
//    residual and LN2, and fc1 + tanh GELU + fc2 + residual with the bf16
//    output in one kernel. The GEMMs (csrc/token_wgmma.cuh) are
//    persistent wgmma kernels fed by TMA, one thread block an SM walking
//    128-row tiles, so a tile's epilogue overlaps the next tile's loads;
//    the state between phases is token-major bf16/f32 rows in device
//    memory, except the MLP's hidden rows, which stay in shared memory.
//  * the window body (`swin_block_fast_bf16`): one thread block per
//    window, every intermediate in shared memory (csrc/fast_block.cuh,
//    shared with the pair, RDSTB and train kernels); one launch.
//
// Both round where the plain version (swin_block_fast_reference) rounds.

#include "fast_block.cuh"
#include "token_fwd.cuh"

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

// The token-parallel forward's workspace in bytes (dims as below).
long long swin_block_fast_work_bytes(const int* dims) {
  return tokfwd::carve_fwd(
      tokpar::make_dims(dims[0], dims[1], dims[2], dims[3], dims[4]),
      nullptr, nullptr);
}

// The token-parallel forward (csrc/token_fwd.cuh): tokfwd::kFwdKernels
// launches on `stream`, each checked. ptrs: x, out, then the
// kernels.swin_block.token_wgmma_layout order -- wqkv (n3, kp) bf16 [n][k]
// by head, bqkv (n3) f32, wproj (kp, kp) [n][k], bproj (c) bf16, w1 (hp,
// kp) [n][k], bf1 (hidden) f32, w2 (kp, hp) [n][k], bf2 (c) bf16 -- the
// packed bias (bw, n, nh
// n), the int8 qkv weights (n3, kq) [n][k] and their steps (n3) (both 0
// for bf16 qkv), and the workspace. dims: windows, n, c, nh, hidden,
// bias_windows, softmax.
int swin_block_fast_tokens(const void* const* ptrs, const int* dims,
                           int device, void* stream) {
  const int windows = dims[0], bw = dims[5], softmax = dims[6];
  const fastblk::Geom geom = fastblk::make_geom(dims[1], dims[2], dims[3],
                                                dims[4]);
  if (!fastblk::geom_ok(geom, fastblk::kMaxC) || !ptrs[11] != !ptrs[12] ||
      bw <= 0 || windows < 0 || windows % bw != 0 || softmax < 0 ||
      softmax > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || windows == 0) return static_cast<int>(err);
  const tokpar::Dims d = tokpar::make_dims(windows, dims[1], dims[2],
                                           dims[3], dims[4]);
  tokfwd::FwdBufs b;
  tokfwd::carve_fwd(d, static_cast<char*>(const_cast<void*>(ptrs[13])), &b);
  return static_cast<int>(tokfwd::forward(
      d,
      tokfwd::rows_in(static_cast<const bf16*>(ptrs[0]), tokfwd::kSameRows,
                      d.c),
      static_cast<bf16*>(const_cast<void*>(ptrs[1])), tokfwd::kSameRows, d.c,
      tokfwd::block_w(ptrs + 2), bw, softmax, b,
      static_cast<cudaStream_t>(stream)));
}

// Kernels of one token-parallel call.
int swin_block_fast_tokens_kernels() { return tokfwd::kFwdKernels; }

// The token-parallel forward's GEMMs one at a time (csrc/token_wgmma.cuh),
// for their checks and device times (kernels.token_wgmma): one launch
// each on `stream`, checked; K = c. The qkv product: ptrs a (tokens, ld)
// int8 or bf16 rows, w (n3, ld), ws (n3; 0 for bf16), bqkv (n3), out
// (tokens, n3); dims tokens, c, n3, ld.
int tokwg_qkv(const void* const* ptrs, const int* dims, int device,
              void* stream) {
  const int tokens = dims[0], c = dims[1], n3 = dims[2], ld = dims[3];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || n3 <= 0 || n3 % 8 ||
      ld < c)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tokwg::qkv(
      ptrs[0], ptrs[1], ld, c,
      tokwg::EpiQkv{static_cast<bf16*>(const_cast<void*>(ptrs[4])),
                    static_cast<const float*>(ptrs[2]),
                    static_cast<const float*>(ptrs[3]), tokens, n3},
      static_cast<cudaStream_t>(stream)));
}

// The projection + residual + LN2: ptrs ao (tokens, kp), wproj (kp, kp)
// [n][k], x (tokens, c), bproj (c), x1 (tokwg::x1_floats f32, in
// tokwg::x1_at's order), x1n (tokens, kp); dims tokens, c, kp.
int tokwg_proj_ln(const void* const* ptrs, const int* dims, int device,
                  void* stream) {
  const int tokens = dims[0], c = dims[1], kp = dims[2];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || kp <= c || kp % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tokwg::proj_ln(
      static_cast<const bf16*>(ptrs[0]), static_cast<const bf16*>(ptrs[1]),
      tokwg::EpiProjLn{static_cast<const bf16*>(ptrs[2]), tokfwd::kSameRows,
                       c, 1, static_cast<const bf16*>(ptrs[3]),
                       static_cast<float*>(const_cast<void*>(ptrs[4])),
                       static_cast<bf16*>(const_cast<void*>(ptrs[5])),
                       tokens, c, kp},
      static_cast<cudaStream_t>(stream)));
}

// fc1 + GELU + fc2 + residual: ptrs x1n (tokens, kp), w1 (hp, kp), w2
// (kp, hp) [n][k], bf1 (hidden) f32, x1 (as tokwg_proj_ln's), bf2 (c),
// out (tokens, c); dims tokens, c, hidden, kp, hp.
int tokwg_mlp(const void* const* ptrs, const int* dims, int device,
              void* stream) {
  const int tokens = dims[0], c = dims[1], hidden = dims[2], kp = dims[3];
  const int hp = dims[4];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || hidden <= 0 ||
      hidden > 512 || kp < c || kp % 8 || hp < hidden || hp % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tokwg::mlp(
      static_cast<const bf16*>(ptrs[0]), kp,
      static_cast<const bf16*>(ptrs[1]), static_cast<const bf16*>(ptrs[2]),
      hp,
      tokwg::MlpEpi{static_cast<const float*>(ptrs[3]),
                    static_cast<const float*>(ptrs[4]),
                    static_cast<const bf16*>(ptrs[5]),
                    static_cast<bf16*>(const_cast<void*>(ptrs[6])),
                    tokfwd::kSameRows, c, 1, tokens, c, hidden},
      static_cast<cudaStream_t>(stream)));
}

// The RDSTB adapter: ptrs z (tokens, ldz), w (growth, ldz) [n][k], bad,
// gad, bbad (growth) f32, out (tokens, growth); dims tokens, c, ldz,
// growth, prenorm.
int tokwg_adapter(const void* const* ptrs, const int* dims, int device,
                  void* stream) {
  const int tokens = dims[0], c = dims[1], ldz = dims[2], growth = dims[3];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || ldz < c || ldz % 8 ||
      growth <= 0 || growth > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tokwg::adapter(
      static_cast<const bf16*>(ptrs[0]), ldz,
      static_cast<const bf16*>(ptrs[1]), c,
      tokwg::EpiAdapter{static_cast<const float*>(ptrs[2]),
                        static_cast<const float*>(ptrs[3]),
                        static_cast<const float*>(ptrs[4]),
                        static_cast<bf16*>(const_cast<void*>(ptrs[5])),
                        tokfwd::kSameRows, 1, growth, 0, growth, tokens,
                        dims[4] ? 1 : 0},
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
