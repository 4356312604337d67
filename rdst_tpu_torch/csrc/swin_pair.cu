// One DSTL's Swin block pair, bfloat16 fast branch, for Hopper (sm_90a).
//
// Replaces: rdst_tpu/kernels/swin_block.py::fused_swin_pair (:1001 ->
// pallas_call :1094; `_pair_kernel` :531, `_shift_relayout` :507): block
// a (shift 0, shared bias) on window-layout tokens, its output rounded to
// bf16, the roll by -shift and re-partition, block b (shift, per-window
// bias); the output stays in the shifted window layout.
//
// The TPU kernel keeps a whole image's 20 windows in VMEM and does the
// relayout there. An image does not fit in a thread block's shared memory
// (20 x 64 x 120 bf16 = 307 KB at C = 120), so the pair is two ordinary
// kernels on the caller's stream, each on the window body of
// csrc/window_body.cuh (bound by operations; warpgroup products on
// weight panels staged in shared memory and shared by the thread block's
// two windows):
// * stage A: block a on the unshifted windows; its bf16 rows go into an
//   image-layout scratch (B, H, W, c8) in global memory (it stays in the
//   50 MB L2);
// * stage B: each shifted window's rows gathered from the scratch at
//   (y + s mod H, x + s mod W), which is the roll -> partition of
//   `_shift_relayout`; block b; the bf16 rows to the output.
// Each stage takes the shared memory and occupancy of its own width, and
// the kernel boundary is the only barrier between them.
//
// Where the window body does not take the block (C above 120, where its
// f32 residual of a 64-token tile outgrows the registers that two
// consumer warpgroups and a producer warp leave, or int8 qkv, which it
// has no product for), `swin_pair_tokens` runs the same two stages on the
// token-parallel forward of csrc/token_fwd.cuh (five kernels a stage over
// all the call's tokens, the int8 qkv product included): stage A reads
// the windows and writes its rows into the image-layout scratch through a
// row map, stage B reads the rolled windows through another; the kernels
// pick the design by (C, int8) as kernels.swin_block.stage_route does.

#include "token_fwd.cuh"
#include "window_body.cuh"

namespace {

using wbody::bf16;

struct Args {
  const bf16* x;  // (windows, n, c), unshifted window layout
  bf16* out;      // (windows, n, c), shifted window layout
  bf16* y;        // scratch (images, H, W, c8)
  wbody::BlockW w;
  wbody::Geom g;
  int windows, nw, h, w_img, ws, shift, softmax;
  int nslots, slot_bytes, wg_bytes;
};

// The pixel (row of image `img`, flattened) of row r of window wi,
// rolled by s.
__device__ __forceinline__ int pixel(const Args& a, int wi, int r, int s) {
  const int nww = a.w_img / a.ws;
  const int yy = ((wi / nww) * a.ws + r / a.ws + s) % a.h;
  const int xx = ((wi % nww) * a.ws + r % a.ws + s) % a.w_img;
  return yy * a.w_img + xx;
}

template <int NT, bool kB>
__global__ void __launch_bounds__(wbody::kWgs * 128 + 32, 1)
    pair_stage_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  const int nwg = (blockDim.x - 32) / 128;
  const int wg = wbody::warpgroup();
  const wbody::Geom& g = a.g;
  char* ring_base = smem + nwg * a.wg_bytes;
  char* ctrl = ring_base + a.nslots * a.slot_bytes;
  wbody::Ring ring = wbody::make_ring(ring_base, a.nslots, a.slot_bytes,
                                      ctrl);
  int active = (a.windows * g.n + wbody::kRows - 1) / wbody::kRows -
               blockIdx.x * nwg;
  if (active > nwg) active = nwg;
  if (threadIdx.x == 0) wbody::ring_init(ring, 4 * active);
  __syncthreads();
  if (wg == nwg) {  // the producer warp
    if ((threadIdx.x & 31) == 0)
      wbody::produce_block(ring, g, 0, a.w.panels);
    return;
  }
  const wbody::TileInfo ti =
      wbody::tile_info(blockIdx.x, nwg, wg, g.n, a.windows);
  if (ti.rows == 0) return;
  char* wsm = smem + wg * a.wg_bytes;
  bf16* stage = reinterpret_cast<bf16*>(wsm);
  const int n = g.n, c = g.c;
  const int rowb = 2 * c, yb = 2 * g.c8;

  float x[NT][16];
  if (!kB) {  // the tile's windows are contiguous rows of x
    const char* src = reinterpret_cast<const char*>(
        a.x + static_cast<size_t>(ti.gw0) * n * c);
    const int bytes = ti.rows * rowb;
    wbody::rows_in([&](int) { return src; }, 1, bytes,
                   reinterpret_cast<uintptr_t>(src) | bytes, wsm, 0);
    wbody::wg_sync(wg);
    wbody::regs_from_rows(x, stage, c, c, ti.rows);
  } else {  // the rolled windows, gathered from the image-layout scratch
    auto src = [&](int r) {
      const int gw = ti.gw0 + r / n;
      const int img = gw / a.nw, wi = gw - img * a.nw;
      return reinterpret_cast<const char*>(
          a.y + (static_cast<size_t>(img) * a.h * a.w_img +
                 pixel(a, wi, r % n, a.shift)) * g.c8);
    };
    wbody::rows_in(src, ti.rows, yb,
                   reinterpret_cast<uintptr_t>(a.y) | yb, wsm, yb);
    wbody::wg_sync(wg);
    wbody::regs_from_rows(x, stage, g.c8, c, ti.rows);
  }
  wbody::wg_sync(wg);

  wbody::block(x, a.w, g, wsm, ring, a.softmax, ti.gw0, a.nw, wg);

  if (!kB) {  // bf16 rows into the scratch at their image positions
    wbody::rows_from_regs(x, stage, g.c8, g.c8);
    wbody::wg_sync(wg);
    auto dst = [&](int r) {
      const int gw = ti.gw0 + r / n;
      const int img = gw / a.nw, wi = gw - img * a.nw;
      return reinterpret_cast<char*>(
          a.y + (static_cast<size_t>(img) * a.h * a.w_img +
                 pixel(a, wi, r % n, 0)) * g.c8);
    };
    wbody::rows_out(dst, ti.rows, yb, reinterpret_cast<uintptr_t>(a.y) | yb,
                    wsm, yb);
  } else {  // bf16 rows, shifted window layout
    wbody::rows_from_regs(x, stage, c, c);
    wbody::wg_sync(wg);
    char* dst = reinterpret_cast<char*>(
        a.out + static_cast<size_t>(ti.gw0) * n * c);
    const int bytes = ti.rows * rowb;
    wbody::rows_out([&](int) { return dst; }, 1, bytes,
                    reinterpret_cast<uintptr_t>(dst) | bytes, wsm, 0);
  }
}

void set_weights(wbody::BlockW* w, const void* const* p) {
  w->panels = static_cast<const char*>(p[0]);
  w->bqkv = static_cast<const float*>(p[1]);
  w->bproj = static_cast<const bf16*>(p[2]);
  w->bf1 = static_cast<const float*>(p[3]);
  w->bf2 = static_cast<const bf16*>(p[4]);
  w->bias = static_cast<const bf16*>(p[5]);
}

template <int NT, bool kB>
cudaError_t launch(const Args& base, const wbody::Fit& f, cudaStream_t s) {
  auto kernel = pair_stage_kernel<NT, kB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (err != cudaSuccess) return err;
  Args a = base;
  a.nslots = f.nslots;
  a.slot_bytes = f.slot_bytes;
  a.wg_bytes = f.wg_bytes;
  const int tiles = (a.windows * a.g.n + wbody::kRows - 1) / wbody::kRows;
  kernel<<<(tiles + f.nwg - 1) / f.nwg, wbody::stage_threads(f.nwg), f.smem,
           s>>>(a);
  return cudaGetLastError();
}

template <bool kB>
cudaError_t launch_nt(const Args& a, const wbody::Fit& f, cudaStream_t s) {
  switch (a.g.no / 32) {
    case 1: return launch<1, kB>(a, f, s);
    case 2: return launch<2, kB>(a, f, s);
    case 3: return launch<3, kB>(a, f, s);
    case 4: return launch<4, kB>(a, f, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernels one call launches on the window body.
int swin_pair_kernels() { return 2; }

// Dynamic shared memory of the stage kernels (both take the same).
int swin_pair_smem_bytes(int n, int c, int nh, int hidden) {
  const wbody::Geom g = wbody::make_geom(n, c, nh, hidden);
  return wbody::stage_fit(g, 0).smem;
}

// ptrs: x, out, scratch, then block a's and block b's weights (6 each:
// panels, bqkv, bproj, bf1, bf2, packed bias; kernels.window_body
// .stage_layout). dims: images, h, w, ws, shift, c, nh, hidden, softmax.
int swin_pair_bf16(const void* const* ptrs, const int* dims, int device,
                   void* stream) {
  Args a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(ptrs[1]));
  a.y = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  const int images = dims[0];
  a.h = dims[1];
  a.w_img = dims[2];
  a.ws = dims[3];
  a.shift = dims[4];
  a.g = wbody::make_geom(dims[3] * dims[3], dims[5], dims[6], dims[7]);
  a.softmax = dims[8];
  if (!wbody::geom_ok(a.g) || a.ws <= 0 || a.h % a.ws || a.w_img % a.ws ||
      a.shift < 0 || a.shift >= a.ws || images < 0 || a.softmax < 0 ||
      a.softmax > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nw = (a.h / a.ws) * (a.w_img / a.ws);
  a.windows = images * a.nw;
  const wbody::Fit f = wbody::stage_fit(a.g, 0);
  if (f.nwg == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (images == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args sa = a;  // stage A: block a, shift 0, shared bias
  set_weights(&sa.w, ptrs + 3);
  sa.w.bias_windows = 1;
  err = launch_nt<false>(sa, f, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args sb = a;  // stage B: block b on the rolled windows
  set_weights(&sb.w, ptrs + 9);
  sb.w.bias_windows = a.shift > 0 ? a.nw : 1;
  err = launch_nt<true>(sb, f, s);
  return static_cast<int>(err);
}

// The token-parallel stages' workspace in bytes (dims as
// swin_pair_tokens').
long long swin_pair_tokens_work_bytes(const int* dims) {
  const int nw = (dims[1] / dims[3]) * (dims[2] / dims[3]);
  return tokfwd::carve_fwd(tokpar::make_dims(dims[0] * nw, dims[3] * dims[3],
                                             dims[5], dims[6], dims[7]),
                           nullptr, nullptr, dims[9], dims[10]);
}

// The pair on the token-parallel stages: 2 tokfwd::fwd_kernels launches,
// each checked. ptrs: x, out, scratch (images, H*W, c8), block a's and
// block b's operands (tokfwd::kBlockPtrs each, tokfwd::BlockW: the
// kernels.swin_block.token_wgmma_layout order, the packed bias, the int8 qkv
// weights and steps or 0, 0, the int8 fc1 / fc2 / projection operands or
// 0s), the workspace. dims as swin_pair_bf16's, then the windows of an
// int8 scale group and the int8 groups (tokfwd::kInt8Proj | kInt8Mlp).
int swin_pair_tokens(const void* const* ptrs, const int* dims, int device,
                     void* stream) {
  const int images = dims[0], h = dims[1], w = dims[2], ws = dims[3];
  const int shift = dims[4], c = dims[5], nh = dims[6], hidden = dims[7];
  const int softmax = dims[8];
  const fastblk::Geom geom = fastblk::make_geom(ws * ws, c, nh, hidden);
  const void* const* pa = ptrs + 3;
  const void* const* pb = pa + tokfwd::kBlockPtrs;
  if (!fastblk::geom_ok(geom, fastblk::kMaxC) || ws <= 0 || h % ws ||
      w % ws || shift < 0 || shift >= ws || images < 0 || softmax < 0 ||
      softmax > 2 || !tokfwd::block_w_ok(pa) || !tokfwd::block_w_ok(pb))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (h / ws) * (w / ws);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || images == 0) return static_cast<int>(err);
  const tokpar::Dims d =
      tokpar::make_dims(images * nw, ws * ws, c, nh, hidden);
  tokfwd::FwdBufs b;
  tokfwd::carve_fwd(
      d, static_cast<char*>(const_cast<void*>(pb[tokfwd::kBlockPtrs])), &b,
      dims[9], dims[10]);
  bf16* y = static_cast<bf16*>(const_cast<void*>(ptrs[2]));
  const int c8 = wbody::round_up(c, 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // stage A: block a, shift 0, shared bias; rows into the scratch at
  // their image positions
  err = tokfwd::forward(
      d, tokfwd::rows_in(static_cast<const bf16*>(ptrs[0]), tokfwd::kSameRows,
                         c),
      y, tokpar::Rows{1, h, w, ws, 0}, c8, tokfwd::block_w(pa), 1, softmax,
      b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // stage B: block b on the rolled windows, shifted window layout out
  return static_cast<int>(tokfwd::forward(
      d, tokfwd::rows_in(y, tokpar::Rows{1, h, w, ws, shift}, c8),
      static_cast<bf16*>(const_cast<void*>(ptrs[1])), tokfwd::kSameRows, c,
      tokfwd::block_w(pb), shift > 0 ? nw : 1, softmax, b, s));
}

}  // extern "C"
