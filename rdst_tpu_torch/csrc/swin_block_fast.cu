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
// designs compute the same numbers, and the plan picks one by C and the
// qkv operands (kernels.swin_block.fast_route):
//
//  * the persistent window kernel (`swin_block_fast_window`, C <= 120
//    with bf16 qkv: E1's blocks in mode swin): one thread block an SM
//    walks the launch's tile pairs -- a tile is 64 tokens, one 64-token
//    window or four 16-token windows, wgmma's M -- with two consumer
//    warpgroups, one tile each, and a producer warpgroup that hands them
//    its registers (232 a consumer thread). Each warpgroup runs
//    the window body of csrc/window_body.cuh on its tile (the f32
//    residual in its accumulator registers, wgmma.m64n32k16 products on
//    weight panels in shared memory, the attention per (window, head) on
//    mma.sync). What the one-window design lost time to, and what this
//    one does about it:
//    - tensor cores idle through every LayerNorm, softmax, GELU and
//      epilogue: the two warpgroups take the tensor cores in turns,
//      section by section (wbody::Turned: qkv, proj, fc1 + fc2), so one
//      warpgroup's CUDA-core work runs under the other's products;
//    - the weights read again from L2 for every window: the plan
//      (wbody::persist_fit) keeps the first GEMMs' panels resident in
//      shared memory for the block's whole walk (all of them at C = 60,
//      qkv and proj at C = 90), loaded once; the rest stream through a
//      ring, each warpgroup's copy in turn order;
//    - a prologue per window: the block persists, and each warpgroup's
//      next tile is on its way by a bulk copy while this one computes
//      (into a buffer of its own at the tile's start, or, where shared
//      memory is short, into its A rows once fc1 has read them);
//    - a global load behind each epilogue (the folded biases): the block
//      keeps bqkv, bproj, bf1 and bf2 in shared memory;
//    - two MUFU operations a GELU: the fc1 epilogue's takes the hardware
//      tanh (wbody::gelu for Turned), within a few 2^-11 of tanh, far
//      below h's bf16 rounding.
//  * the token-parallel forward (`swin_block_fast_tokens`, the wide
//    blocks and int8 qkv; csrc/token_fwd.cuh, which the pair and RDSTB
//    stages the window body does not take run too): five phases over all
//    T = windows x n tokens: LN1 rows (bf16, or int8 for the int8 qkv
//    product), the qkv GEMM (bf16, or int8 on wgmma .s8), attention per
//    (window, head) with the approximate reciprocal (csrc/token_gemm.cuh,
//    shared with the training backward), the projection with its
//    residual and LN2, and fc1 + tanh GELU + fc2 + residual with the bf16
//    output in one kernel. The GEMMs (csrc/token_wgmma.cuh) are
//    persistent wgmma kernels fed by TMA, one thread block an SM walking
//    128-row tiles, so a tile's epilogue overlaps the next tile's loads;
//    the state between phases is token-major bf16/f32 rows in device
//    memory, except the MLP's hidden rows, which stay in shared memory.
//
// Both round where the plain version (swin_block_fast_reference) rounds.

#include "token_fwd.cuh"
#include "window_body.cuh"

namespace {

using wbody::bf16;

struct WinArgs {
  const bf16* x;  // (windows, n, c), window layout
  bf16* out;
  wbody::BlockW w;
  wbody::Geom g;
  wbody::PFit f;
  int windows, pairs, softmax;
  bool turns;
};

// The consumer warpgroups and a producer warpgroup, which gives its
// registers to them (setmaxnreg, as csrc/token_wgmma.cuh's kernels): a
// producer warp alone would leave each thread 168 registers (the SM
// allocates warps four at a time), and the window body spills at C > 60.
constexpr int kWinThreads = (wbody::kPersistWgs + 1) * 128;

template <int NT>
__global__ void __launch_bounds__(kWinThreads, 1)
    fast_window_kernel(const WinArgs a) {
  extern __shared__ __align__(128) char smem[];
  const wbody::Geom& g = a.g;
  const wbody::PFit& f = a.f;
  const int wg = wbody::warpgroup();
  char* res = smem + wbody::kPersistWgs * f.wg_bytes;
  char* inb = res + f.res_bytes;
  char* ring_base = inb + f.nin * f.in_bytes;
  char* ctrl = ring_base + f.nslots * f.slot_bytes;
  const wbody::Ring ring =
      wbody::make_ring(ring_base, f.nslots, f.slot_bytes, ctrl);
  // after the ring's: the resident panels' barrier, one a warpgroup for
  // its input tiles; then the epilogues' constants
  const uint32_t res_bar = wbody::smem_u32(ctrl + wbody::kCtrlBytes);
  float* cq = reinterpret_cast<float*>(ctrl + wbody::kPersistCtrl);
  float* cf1 = cq + g.nq;
  bf16* cbp = reinterpret_cast<bf16*>(cf1 + g.hp);
  bf16* cf2 = cbp + g.cp;
  for (int i = threadIdx.x; i < g.nq; i += blockDim.x) cq[i] = a.w.bqkv[i];
  for (int i = threadIdx.x; i < g.hp; i += blockDim.x) cf1[i] = a.w.bf1[i];
  for (int i = threadIdx.x; i < g.cp; i += blockDim.x) {
    cbp[i] = a.w.bproj[i];
    cf2[i] = a.w.bf2[i];
  }
  if (threadIdx.x == 0) {
    wbody::ring_init(ring, 4);  // a panel copy is one warpgroup's
    for (int b = 0; b < 1 + wbody::kPersistWgs; ++b)
      wbody::mbar_init(res_bar + 8 * b, 1);
    wbody::mbar_init_fence();
  }
  __syncthreads();
  if (wg == wbody::kPersistWgs) {  // the producer warpgroup: one thread
    tokwg::regs_dec<tokwg::kProducerRegs>();
    if (threadIdx.x == wbody::kPersistWgs * 128) {
      if (f.res_bytes)
        wbody::bulk_load(wbody::smem_u32(res), a.w.panels, f.res_bytes,
                         res_bar);
      if (f.nslots)
        wbody::produce_turns(ring, g, f.res, a.w.panels, blockIdx.x,
                             gridDim.x, a.pairs);
    }
    return;
  }
  tokwg::regs_inc<tokwg::kConsumerRegs>();
  const int n = g.n, c = g.c, per = wbody::kRows / n;  // windows a tile
  const int row_bytes = 2 * c;
  char* wsm = smem + wg * f.wg_bytes;
  char* region = wsm + wbody::wg_layout(g, 0).region;
  char* inbuf = f.nin ? inb + wg * f.in_bytes : wsm;
  const uint32_t inbuf_s = wbody::smem_u32(inbuf);
  const uint32_t in_bar = res_bar + 8 * (1 + wg);
  const bool lead = (threadIdx.x & 127) == 0;
  // valid rows of tile `tile` (whole windows; 0 past the last)
  auto rows_of = [&](int tile) {
    const int left = a.windows - tile * per;
    return left <= 0 ? 0 : (left < per ? left : per) * n;
  };
  auto src_of = [&](int tile) {
    return reinterpret_cast<const char*>(a.x) +
           static_cast<size_t>(tile) * wbody::kRows * row_bytes;
  };
  wbody::BlockW w = a.w;  // its constants from shared memory
  w.bqkv = cq;
  w.bf1 = cf1;
  w.bproj = cbp;
  w.bf2 = cf2;
  wbody::Turned t;
  t.ring = ring;
  t.st = wbody::streamed(g, f.res);
  t.res = wbody::smem_u32(res);
  t.res_panels = f.res_panels;
  t.wg = wg;
  t.turns = 0;
  t.take_turns = a.turns;
  t.next_dst = inbuf_s;
  t.in_bar = in_bar;

  int pair = blockIdx.x;
  {
    const int rows = rows_of(2 * pair + wg);
    if (lead && rows)
      wbody::bulk_load(inbuf_s, src_of(2 * pair + wg), rows * row_bytes,
                       in_bar);
  }
  if (f.res_bytes) wbody::mbar_wait(res_bar, 0);
  int loads = 0;
  for (int it = 0; pair < a.pairs; pair += gridDim.x, ++it) {
    const int tile = 2 * pair + wg, rows = rows_of(tile);
    if (rows) wbody::mbar_wait(in_bar, loads++ & 1);
    float x[NT][16];
    wbody::regs_from_rows(x, reinterpret_cast<const bf16*>(inbuf), c, c,
                          rows);
    wbody::wg_sync(wg);
    // the next tile: into the input buffer now, or into the A rows once
    // fc1 has read them (after_fc1)
    const int next = 2 * (pair + gridDim.x) + wg;
    const int next_rows = pair + gridDim.x < a.pairs ? rows_of(next) : 0;
    t.start(it);
    t.next_bytes = 0;
    if (next_rows && f.nin) {
      if (lead) {
        wbody::fence_async_smem();
        wbody::bulk_load(inbuf_s, src_of(next), next_rows * row_bytes,
                         in_bar);
      }
    } else if (next_rows) {
      t.next_src = src_of(next);
      t.next_bytes = next_rows * row_bytes;
    }
    // a warpgroup without a tile (the last pair's second) runs the block
    // on zeros, so that its turns and ring copies stay in step
    wbody::block(x, w, g, wsm, t, a.softmax, tile * per, w.bias_windows,
                 wg);
    if (rows) {  // bf16 rows out through the q | k | v region
      wbody::rows_from_regs(x, reinterpret_cast<bf16*>(region), c, c);
      wbody::wg_sync(wg);
      char* dst = reinterpret_cast<char*>(a.out) +
                  static_cast<size_t>(tile) * wbody::kRows * row_bytes;
      const int bytes = rows * row_bytes;
      wbody::rows_out([&](int) { return dst; }, 1, bytes,
                      reinterpret_cast<uintptr_t>(dst) | bytes, region, 0);
    }
  }
  wbody::turn_close(t);
}

// a GEMM launch's tile rows as the caller names them (0: the schedule's)
bool rows_ok(int bm) { return bm == 0 || bm == 64 || bm == 128; }

template <int NT>
cudaError_t launch_window(const WinArgs& a, cudaStream_t s) {
  auto kernel = fast_window_kernel<NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.f.smem);
  if (err != cudaSuccess) return err;
  const int sms = tokwg::sm_count();
  kernel<<<a.pairs < sms ? a.pairs : sms, kWinThreads, a.f.smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The persistent window kernel: ptrs x, out, then the block's
// kernels.window_body.stage_layout operands (panels, bqkv, bproj, bf1,
// bf2) and its bias in fragment order (stage_bias). dims: windows, n, c,
// nh, hidden, bias_windows, softmax, turns (1; 0 runs the warpgroups
// without turns, a measurement of what the turns overlap, taken only
// where every weight is resident). x and out 16-byte aligned.
int swin_block_fast_window(const void* const* ptrs, const int* dims,
                           int device, void* stream) {
  WinArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  a.w.panels = static_cast<const char*>(ptrs[2]);
  a.w.bqkv = static_cast<const float*>(ptrs[3]);
  a.w.bproj = static_cast<const bf16*>(ptrs[4]);
  a.w.bf1 = static_cast<const float*>(ptrs[5]);
  a.w.bf2 = static_cast<const bf16*>(ptrs[6]);
  a.w.bias = static_cast<const bf16*>(ptrs[7]);
  a.windows = dims[0];
  a.g = wbody::make_geom(dims[1], dims[2], dims[3], dims[4]);
  a.w.bias_windows = dims[5];
  a.softmax = dims[6];
  a.turns = dims[7] != 0;
  a.f = wbody::persist_fit(a.g);
  if (!wbody::geom_ok(a.g) || a.f.smem == 0 || a.w.bias_windows <= 0 ||
      a.windows < 0 || a.windows % a.w.bias_windows != 0 ||
      a.softmax < 0 || a.softmax > 2 || (!a.turns && a.f.nslots))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a.x) |
       reinterpret_cast<uintptr_t>(a.out)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || a.windows == 0) return static_cast<int>(err);
  const int tiles = (a.windows * a.g.n + wbody::kRows - 1) / wbody::kRows;
  a.pairs = (tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // no / 32 = 1 (C <= 32) is not built: ptxas serializes its wgmma, and
  // kernels.swin_block.window_kernel_supports routes those widths to the
  // token-parallel forward
  switch (a.g.no / 32) {
    case 2: return static_cast<int>(launch_window<2>(a, s));
    case 3: return static_cast<int>(launch_window<3>(a, s));
    case 4: return static_cast<int>(launch_window<4>(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The token-parallel forward's workspace in bytes (dims as below).
long long swin_block_fast_work_bytes(const int* dims) {
  return tokfwd::carve_fwd(
      tokpar::make_dims(dims[0], dims[1], dims[2], dims[3], dims[4]),
      nullptr, nullptr, dims[7], dims[8]);
}

// The token-parallel forward (csrc/token_fwd.cuh): tokfwd::fwd_kernels
// launches on `stream`, each checked. ptrs: x, out, then the
// kernels.swin_block.token_wgmma_layout order -- wqkv (n3, kp) bf16 [n][k]
// by head, bqkv (n3) f32, wproj (kp, kp) [n][k], bproj (c) bf16, w1 (hp,
// kp) [n][k], bf1 (hidden) f32, w2 (kp, hp) [n][k], bf2 (c) bf16 -- the
// packed bias (bw, n, nh n), the int8 qkv weights (n3, kq) [n][k] and
// their steps (n3) (both 0 for bf16 qkv), the int8 fc1 / fc2 / projection
// operands (kernels.swin_block.int8_token_layout: 6, 0 where a group is
// off), and the workspace. dims: windows, n, c, nh, hidden, bias_windows,
// softmax, the windows of an int8 scale group, the int8 groups
// (tokfwd::kInt8Proj | kInt8Mlp).
int swin_block_fast_tokens(const void* const* ptrs, const int* dims,
                           int device, void* stream) {
  const int windows = dims[0], bw = dims[5], softmax = dims[6];
  const fastblk::Geom geom = fastblk::make_geom(dims[1], dims[2], dims[3],
                                                dims[4]);
  if (!fastblk::geom_ok(geom, fastblk::kMaxC) ||
      !tokfwd::block_w_ok(ptrs + 2) || bw <= 0 || windows < 0 ||
      windows % bw != 0 || softmax < 0 || softmax > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || windows == 0) return static_cast<int>(err);
  const tokpar::Dims d = tokpar::make_dims(windows, dims[1], dims[2],
                                           dims[3], dims[4]);
  tokfwd::FwdBufs b;
  tokfwd::carve_fwd(
      d,
      static_cast<char*>(const_cast<void*>(ptrs[2 + tokfwd::kBlockPtrs])),
      &b, dims[7], dims[8]);
  return static_cast<int>(tokfwd::forward(
      d,
      tokfwd::rows_in(static_cast<const bf16*>(ptrs[0]), tokfwd::kSameRows,
                      d.c),
      static_cast<bf16*>(const_cast<void*>(ptrs[1])), tokfwd::kSameRows, d.c,
      tokfwd::block_w(ptrs + 2), bw, softmax, b,
      static_cast<cudaStream_t>(stream)));
}

// Kernels of one token-parallel call without int8 'mlp' / 'proj'.
int swin_block_fast_tokens_kernels() { return tokfwd::kFwdKernels; }

// Kernels of one token-parallel call with the int8 groups of `mask`.
int swin_block_fast_tokens_kernels_int8(int mask) {
  return tokfwd::fwd_kernels(mask);
}

// The token-parallel forward's GEMMs one at a time (csrc/token_wgmma.cuh),
// for their checks and device times (kernels.token_wgmma): one launch
// each on `stream`, checked; K = c. The qkv product: ptrs a (tokens, ld)
// int8 or bf16 rows, w (n3, ld), ws (n3; 0 for bf16), bqkv (n3), out
// (tokens, n3); dims tokens, c, n3, ld, bm (tile rows: 64, 128, or 0 for
// the schedule's own; the same in the two below).
int tokwg_qkv(const void* const* ptrs, const int* dims, int device,
              void* stream) {
  const int tokens = dims[0], c = dims[1], n3 = dims[2], ld = dims[3];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || n3 <= 0 || n3 % 8 ||
      ld < c || !rows_ok(dims[4]))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tokwg::qkv(
      ptrs[0], ptrs[1], ld, c,
      tokwg::EpiQkv{static_cast<bf16*>(const_cast<void*>(ptrs[4])),
                    static_cast<const float*>(ptrs[2]),
                    static_cast<const float*>(ptrs[3]), tokens, n3},
      static_cast<cudaStream_t>(stream), dims[4]));
}

// The projection + residual + LN2: ptrs ao (tokens, kp), wproj (kp, kp)
// [n][k], x (tokens, c), bproj (c), x1 (tokwg::x1_floats f32, in
// tokwg::x1_at's order), x1n (tokens, kp); dims tokens, c, kp, bm.
int tokwg_proj_ln(const void* const* ptrs, const int* dims, int device,
                  void* stream) {
  const int tokens = dims[0], c = dims[1], kp = dims[2];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || kp <= c || kp % 8 ||
      !rows_ok(dims[3]))
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
      static_cast<cudaStream_t>(stream), dims[3]));
}

// fc1 + GELU + fc2 + residual: ptrs x1n (tokens, kp), w1 (hp, kp), w2
// (kp, hp) [n][k], bf1 (hidden) f32, x1 (as tokwg_proj_ln's), bf2 (c),
// out (tokens, c); dims tokens, c, hidden, kp, hp, bm.
int tokwg_mlp(const void* const* ptrs, const int* dims, int device,
              void* stream) {
  const int tokens = dims[0], c = dims[1], hidden = dims[2], kp = dims[3];
  const int hp = dims[4];
  if (tokens < 0 || c <= 0 || c > fastblk::kMaxC || hidden <= 0 ||
      hidden > 512 || kp < c || kp % 8 || hp < hidden || hp % 8 ||
      !rows_ok(dims[5]))
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
      static_cast<cudaStream_t>(stream), dims[5]));
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
