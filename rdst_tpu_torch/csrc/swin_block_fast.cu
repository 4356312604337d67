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
//    blocks): six phases over all T = windows x n tokens, built from the
//    pieces it shares with the training backward (csrc/token_gemm.cuh):
//    LN1 rows (bf16, or int8 for the int8 qkv product), the qkv GEMM
//    (bf16 mma.sync m16n8k16, or int8 m16n8k32 with an int32
//    accumulator), attention per (window, head) with the approximate
//    reciprocal, the projection with its residual and LN2 in one
//    row-spanning tile, fc1 with the tanh GELU, fc2 with the residual and
//    the bf16 output. Every GEMM tile of 64 tokens reads a weight tile
//    once through a cp.async ring, where the window body reads all of a
//    block's weights from L2 for every window of 64 tokens; the state
//    between phases is token-major bf16/f32 rows in device memory.
//  * the window body (`swin_block_fast_bf16`): one thread block per
//    window, every intermediate in shared memory (csrc/fast_block.cuh,
//    shared with the pair, RDSTB and train kernels); one launch.
//
// Both round where the plain version (swin_block_fast_reference) rounds.

#include "fast_block.cuh"
#include "token_gemm.cuh"

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

// ------------------------------------------------ the token-parallel forward

namespace tp = tokpar;

// The serving GEMMs run three blocks an SM (tiles at most 128 wide, so
// fewer registers than the backward's two) and launch the N tiles of one
// A tile together (blockIdx.x walks them), so A is read from device
// memory once.
constexpr int kMinB = 3;

// LN1 of every token, a warp per token (one-pass moments, eps 1e-5):
// bf16(normalize(x)) rows, or with int8 qkv the rows quantized as
// fastblk::quantize_rows does (each product and the difference rounded on
// its own, round half to even); ld elements a row, zeros past c.
template <bool kInt8>
__global__ void __launch_bounds__(256)
    ln1_rows_kernel(const bf16* x, void* dst, const tp::Dims d, int ld) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= d.tokens) return;
  const bf16* xr = x + static_cast<size_t>(m) * d.c;
  float v[6], s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int o = lane + 32 * i;
    v[i] = o < d.c ? tp::ldb(xr + o) : 0.f;
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = fastblk::warp_sum(s);
  s2 = fastblk::warp_sum(s2);
  const float mu = s / d.c;
  const float a = rsqrtf(fmaxf(s2 / d.c - mu * mu, 0.f) + fastblk::kEps);
  if (kInt8) {
    int8_t* row = static_cast<int8_t*>(dst) + static_cast<size_t>(m) * ld;
    const float ma = __fmul_rn(mu, a);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int o = lane + 32 * i;
      if (o < d.c) {
        const float xn = __fsub_rn(__fmul_rn(v[i], a), ma);
        const float q =
            fminf(fmaxf(rintf(__fmul_rn(xn, fastblk::kQX)), -127.f), 127.f);
        row[o] = static_cast<int8_t>(static_cast<int>(q));
      }
    }
    for (int o = d.c + lane; o < ld; o += 32) row[o] = 0;
  } else {
    bf16* row = static_cast<bf16*>(dst) + static_cast<size_t>(m) * ld;
    const float ma = mu * a;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int o = lane + 32 * i;
      if (o < d.c) row[o] = __float2bfloat16_rn(v[i] * a - ma);
    }
    for (int o = d.c + lane; o < ld; o += 32)
      row[o] = __float2bfloat16_rn(0.f);
  }
}

// C (M, N) = A (M, K) B^T with int8 operands and int32 sums (exact): A
// stored [M][K], B [N][K], rows of lda / ldb bytes (multiples of 16). 64 x
// BN tiles, 64 bytes of depth a stage in the cp.async ring of gemm_tile,
// mma.sync m16n8k32.s8; the sums are parked in shared memory as floats
// (exact: |sum| <= 127^2 K < 2^24 for K <= 1040) for the epilogue.
constexpr int kS8BK = 64;

template <int BN>
struct S8Tile {
  static constexpr int kLd = kS8BK + 16;  // bytes: conflict-free fragments
  static constexpr int kA = tp::kBM * kLd;
  static constexpr int kStage = kA + BN * kLd;
  static constexpr int kLdC = BN + 4;
  static constexpr int kPipe = tp::kStages * kStage;
  static constexpr int kSmem =
      kPipe > tp::kBM * kLdC * 4 ? kPipe : tp::kBM * kLdC * 4;
};

struct S8Args {
  const int8_t* a;
  const int8_t* b;
  int lda, ldb, M, N, K;
};

template <int BN, class Epi>
__global__ void __launch_bounds__(tp::kGemmThreads, kMinB)
    gemm_s8_kernel(const S8Args g, const Epi epi) {
  using L = S8Tile<BN>;
  constexpr int NT = BN / 32;  // n-tiles of 8 a warp
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.y * tp::kBM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3, wm = warp >> 2, wn = warp & 3;
  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  const int steps = (g.K + kS8BK - 1) / kS8BK;
  auto load = [&](int step, int stage) {
    char* As = smem + stage * L::kStage;
    char* Bs = As + L::kA;
    const int k0 = step * kS8BK;
    {
      const int r = tid >> 2, c16 = (tid & 3) * 16;  // 64 x 64 bytes
      const bool ok = m0 + r < g.M && k0 + c16 < g.K;
      tp::cp_async16(As + r * L::kLd + c16,
                     ok ? g.a + static_cast<size_t>(m0 + r) * g.lda + k0 + c16
                        : g.a,
                     ok);
    }
    for (int i = tid; i < BN * 4; i += tp::kGemmThreads) {
      const int r = i >> 2, c16 = (i & 3) * 16;
      const bool ok = n0 + r < g.N && k0 + c16 < g.K;
      tp::cp_async16(Bs + r * L::kLd + c16,
                     ok ? g.b + static_cast<size_t>(n0 + r) * g.ldb + k0 + c16
                        : g.b,
                     ok);
    }
  };
#pragma unroll
  for (int s = 0; s < tp::kStages - 1; ++s) {
    if (s < steps) load(s, s);
    tp::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tp::cp_async_wait<tp::kStages - 2>();
    __syncthreads();
    const int nxt = s + tp::kStages - 1;
    if (nxt < steps) load(nxt, nxt % tp::kStages);
    tp::cp_async_commit();
    const char* As = smem + (s % tp::kStages) * L::kStage;
    const char* Bs = As + L::kA;
#pragma unroll
    for (int kk = 0; kk < kS8BK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const char* p = As + (wm * 32 + mt * 16 + gr) * L::kLd + kk + 4 * t4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * L::kLd);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * L::kLd + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const char* q = Bs + (wn * (BN / 4) + nt * 8 + gr) * L::kLd + kk + 4 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          fastblk::mma16832s8(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2],
                              af[mt][3], b0, b1);
      }
    }
  }
  tp::cp_async_wait<0>();
  __syncthreads();
  float* ct = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * 32 + mt * 16 + gr;
      const int col = wn * (BN / 4) + nt * 8 + 2 * t4;
      ct[r * L::kLdC + col] = static_cast<float>(acc[mt][nt][0]);
      ct[r * L::kLdC + col + 1] = static_cast<float>(acc[mt][nt][1]);
      ct[(r + 8) * L::kLdC + col] = static_cast<float>(acc[mt][nt][2]);
      ct[(r + 8) * L::kLdC + col + 1] = static_cast<float>(acc[mt][nt][3]);
    }
  __syncthreads();
  epi.template run<BN>(ct, m0, n0);
}

// q, k, v = bf16(int32(xq Wq) * ws + bqkv) by head, each product and sum
// rounded on its own (as the window body's int8 epilogue)
struct EpiQkvS8 {
  bf16* qkv;          // (tokens, n3)
  const float* ws;    // (n3) by head
  const float* bqkv;  // (n3) by head
  int tokens, n3;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    tp::each_pair<BN>(ct, m0, n0, tokens, n3,
                      [&](int m, int j, float v0, float v1) {
                        tp::st_bf2(qkv + static_cast<size_t>(m) * n3 + j,
                                   __fadd_rn(__fmul_rn(v0, ws[j]), bqkv[j]),
                                   __fadd_rn(__fmul_rn(v1, ws[j + 1]),
                                             bqkv[j + 1]));
                      });
  }
};

// h = bf16(gelu_tanh(x1n W1 + bf1)), zeros past hidden
struct EpiFc1Serve {
  bf16* h;           // (tokens, hp)
  const float* bf1;  // (hidden)
  int tokens, hidden, hp;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    tp::each_pair<BN>(
        ct, m0, n0, tokens, hp, [&](int m, int j, float v0, float v1) {
          tp::st_bf2(h + static_cast<size_t>(m) * hp + j,
                     j < hidden ? fastblk::gelu_tanh(v0 + bf1[j]) : 0.f,
                     j + 1 < hidden ? fastblk::gelu_tanh(v1 + bf1[j + 1])
                                    : 0.f);
        });
  }
};

// out = bf16(x1 + (h W2 + bf2))
struct EpiOut {
  const float* x1;  // (tokens, c)
  const bf16* bf2;  // (c)
  bf16* out;        // (tokens, c)
  int tokens, c, kp;
  template <int BN>
  __device__ void run(const float* ct, int m0, int n0) const {
    tp::each_pair<BN>(ct, m0, n0, tokens, kp,
                      [&](int m, int j, float v0, float v1) {
                        const size_t at = static_cast<size_t>(m) * c + j;
                        if (j < c)
                          out[at] = __float2bfloat16_rn(
                              x1[at] + (v0 + tp::ldb(bf2 + j)));
                        if (j + 1 < c)
                          out[at + 1] = __float2bfloat16_rn(
                              x1[at + 1] + (v1 + tp::ldb(bf2 + j + 1)));
                      });
  }
};

// The tile width of least padding for N columns, the wider on a tie.
inline int fit_bn(int n, const int* widths, int count) {
  int best = widths[0];
  for (int i = 1; i < count; ++i) {
    const int w = widths[i];
    if ((n + w - 1) / w * w < (n + best - 1) / best * best) best = w;
  }
  return best;
}

template <bool TA, bool TB, class Epi>
inline cudaError_t run_fit(const tp::GemmArgs& g, const Epi& epi,
                           cudaStream_t s) {
  static const int widths[] = {128, 64};
  if (fit_bn(g.N, widths, 2) == 128)
    return tp::run_gemm<128, TA, TB, Epi, kMinB, true>(g, epi, s);
  return tp::run_gemm<64, TA, TB, Epi, kMinB, true>(g, epi, s);
}

template <int BN, class Epi>
inline cudaError_t run_s8(const S8Args& g, const Epi& epi, cudaStream_t s) {
  constexpr int smem = S8Tile<BN>::kSmem;
  auto kernel = gemm_s8_kernel<BN, Epi>;
  // set where it launches: the attribute belongs to this library's kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + tp::kBM - 1) / tp::kBM);
  kernel<<<grid, tp::kGemmThreads, smem, s>>>(g, epi);
  return cudaGetLastError();
}

template <class Epi>
inline cudaError_t run_s8_fit(const S8Args& g, const Epi& epi,
                              cudaStream_t s) {
  static const int widths[] = {128, 96, 64};
  switch (fit_bn(g.N, widths, 3)) {
    case 128: return run_s8<128>(g, epi, s);
    case 96: return run_s8<96>(g, epi, s);
    default: return run_s8<64>(g, epi, s);
  }
}

// The forward's buffers, carved from one workspace (256-byte aligned):
// LN1 rows (bf16 kp wide, or int8 kq wide), later LN2's rows; q/k/v by
// head, later the MLP hidden rows; the attention output rows; x1 (f32).
struct FwdBufs {
  void* xin;
  bf16* qkv;
  bf16* ao;
  float* x1;
};

inline long long carve_fwd(const tp::Dims& d, char* base, FwdBufs* b) {
  const long long T = d.tokens;
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  FwdBufs z;
  z.xin = take(T * d.kp * 2);  // holds the int8 rows too: kq <= 2 kp
  z.qkv = reinterpret_cast<bf16*>(take(T * (d.n3 > d.hp ? d.n3 : d.hp) * 2));
  z.ao = reinterpret_cast<bf16*>(take(T * d.kp * 2));
  z.x1 = reinterpret_cast<float*>(take(T * d.c * 4));
  if (b) *b = z;
  return off;
}

constexpr int kFwdKernels = 6;  // kernels of one token-parallel call

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
  return carve_fwd(tp::make_dims(dims[0], dims[1], dims[2], dims[3], dims[4]),
                   nullptr, nullptr);
}

// The token-parallel forward: kFwdKernels launches on `stream`, each
// checked. ptrs: x, out, then the kernels.swin_block.token_layout order --
// wqkv (kp, n3) bf16 [k][n] by head, bqkv (n3) f32, wproj (kp, kp), bproj
// (c) bf16, w1 (kp, hp), bf1 (hidden) f32, w2 (hp, kp), bf2 (c) bf16 --
// the packed bias (bw, n, nh n), the int8 qkv weights (n3, kq) [n][k] and
// their steps (n3) (both 0 for bf16 qkv), and the workspace. dims:
// windows, n, c, nh, hidden, bias_windows, softmax.
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
  const tp::Dims d = tp::make_dims(windows, dims[1], dims[2], dims[3],
                                   dims[4]);
  const int T = d.tokens, kp = d.kp, hp = d.hp, n3 = d.n3;
  const bf16* x = static_cast<const bf16*>(ptrs[0]);
  bf16* out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  const bf16* wqkv = static_cast<const bf16*>(ptrs[2]);
  const float* bqkv = static_cast<const float*>(ptrs[3]);
  const bf16* wproj = static_cast<const bf16*>(ptrs[4]);
  const bf16* bproj = static_cast<const bf16*>(ptrs[5]);
  const bf16* w1 = static_cast<const bf16*>(ptrs[6]);
  const float* bf1 = static_cast<const float*>(ptrs[7]);
  const bf16* w2 = static_cast<const bf16*>(ptrs[8]);
  const bf16* bf2 = static_cast<const bf16*>(ptrs[9]);
  const bf16* bias = static_cast<const bf16*>(ptrs[10]);
  const int8_t* wq = static_cast<const int8_t*>(ptrs[11]);
  const float* ws = static_cast<const float*>(ptrs[12]);
  FwdBufs b;
  carve_fwd(d, static_cast<char*>(const_cast<void*>(ptrs[13])), &b);
  bf16* xn = static_cast<bf16*>(b.xin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RDST_CHECK(expr)                              \
  do {                                                \
    err = (expr);                                     \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
  if (wq) {
    ln1_rows_kernel<true><<<(T + 7) / 8, 256, 0, s>>>(x, b.xin, d, geom.kq);
    RDST_CHECK(cudaGetLastError());
    RDST_CHECK(run_s8_fit(
        S8Args{static_cast<const int8_t*>(b.xin), wq, geom.kq, geom.kq, T, n3,
               geom.kq},
        EpiQkvS8{b.qkv, ws, bqkv, T, n3}, s));
  } else {
    ln1_rows_kernel<false><<<(T + 7) / 8, 256, 0, s>>>(x, b.xin, d, kp);
    RDST_CHECK(cudaGetLastError());
    RDST_CHECK((run_fit<false, true>(
        tp::gemm_args(xn, nullptr, kp, wqkv, nullptr, n3, T, n3, kp),
        tp::EpiQkv{b.qkv, bqkv, T, n3}, s)));
  }
  const tp::AttnSmem al = tp::attn_smem(d, false);
  RDST_CHECK(cudaFuncSetAttribute(tp::attn_fwd_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  al.bytes));
  tp::attn_fwd_kernel<true><<<windows * d.nh, tp::kAttnThreads, al.bytes, s>>>(
      tp::Attn{d, b.qkv, bias, bw, softmax, b.ao});
  RDST_CHECK(cudaGetLastError());
  // LN2's rows take the LN1 rows' place, the hidden rows q/k/v's
  RDST_CHECK((tp::run_rows<false, true, tp::EpiProjLn, kMinB>(
      tp::gemm_args(b.ao, nullptr, kp, wproj, nullptr, kp, T, kp, kp),
      tp::EpiProjLn{d, x, tp::Rows{0, 0, 0, 0, 0}, bproj, nullptr, 0, 0,
                    b.x1, xn, nullptr},
      s)));
  RDST_CHECK((run_fit<false, true>(
      tp::gemm_args(xn, nullptr, kp, w1, nullptr, hp, T, hp, kp),
      EpiFc1Serve{b.qkv, bf1, T, d.hidden, hp}, s)));
  RDST_CHECK((run_fit<false, true>(
      tp::gemm_args(b.qkv, nullptr, hp, w2, nullptr, kp, T, kp, hp),
      EpiOut{b.x1, bf2, out, T, d.c, kp}, s)));
#undef RDST_CHECK
  return 0;
}

// Kernels of one token-parallel call.
int swin_block_fast_tokens_kernels() { return kFwdKernels; }

}  // extern "C"
