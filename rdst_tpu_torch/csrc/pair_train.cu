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
// Forward (`pair_train_fwd_bf16`): one persistent, cooperative launch
// on the window body of csrc/window_body.cuh in its training form
// (wbody::TrainForm), on the schedule of swin_block_fast.cu's window
// kernel: one thread block an SM, two consumer warpgroups (a 64-token
// tile each, wgmma products on weight panels in shared memory) and a
// producer warpgroup. What bounds it on an H100 is operations, but at the
// training geometry (288 windows a block) the rounds of tiles over the
// 132 SMs set the time, so the design chains the two blocks:
// * One walk over both blocks' tile pairs, block a's first, then block
//   b's: 2 x 144 pairs take 3 rounds of 132, where a launch a block would
//   take 2 rounds each (the second of 12 pairs).
// * Block a's tile rows go out to y (images, H, W, c) at the windows'
//   pixels; the backward reads the same y. Block b's rows are gathered
//   from y at the rolled pixels ((y + s) mod H, (x + s) mod W) by
//   cp.async, and its output is the shifted window layout. Both move a
//   window row of ws pixels at a time, contiguous in y but where it wraps
//   at the image's edge, in 16-byte vectors (a pixel's row of c bf16 is
//   not a multiple of 16 bytes at C = 60 / 90, a window row is).
// * A block-b tile of image i needs image i's block-a windows in y: a
//   counter an image (zeroed before the launch) takes a release add from
//   each block-a tile once its rows are out, and each thread of a block-b
//   tile takes an acquire read of it before its share of the gather. A
//   tile only waits on tiles placed earlier in every thread block's walk,
//   and the cooperative launch keeps every thread block resident, so the
//   walk cannot deadlock (kernels.pair_train.chained_walk models it).
// * The plan is persist_fit's with both blocks' epilogue constants and the
//   tiles' factor rows in shared memory (blocks 2; a register for a
//   factor across the products spills at C = 120): every panel resident
//   at C = 60, qkv + proj at C = 90 / 96, none at C = 120. The resident
//   region holds one block's panels: the producer reloads it once, when
//   both warpgroups are past their last block-a tile (the swap barrier).
//   The warpgroups take the tensor cores in turns only where panels
//   stream (the caller decides; kernels.pair_train.forward_turns).
// * The next tile's rows are on their way while this one computes: a
//   block-a tile's by a bulk copy, a block-b tile's by cp.async where the
//   plan has input buffers (C = 60) and its images are ready at this
//   tile's start; otherwise each thread copies its share at the next
//   tile's start.
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

#include "block_bwd.cuh"
#include "token_wgmma.cuh"  // window_body.cuh; tokwg's register moves

namespace {

// ---------------------------------------------------------------- forward

using wbody::bf16;

struct FwdArgs {
  const bf16* x;          // (windows, n, c), unshifted window layout
  bf16* out;              // (windows, n, c), shifted window layout
  bf16* y;                // block a's output, (images, ih, iw, c)
  unsigned int* ready;    // block-a windows in y, one counter an image
  const float* dpf;       // (windows * n, 4) or null
  wbody::BlockW wa, wb;   // stage_layout panels and constants, stage_bias
  wbody::Geom g;
  wbody::PFit f;          // persist_fit(g, 2)
  int ih, iw, ws, shift, softmax;
  int nw, windows, pairs_a;  // windows an image and in all; tile pairs a
                             // block
  bool turns;
};

// threads of a thread block: two consumer warpgroups and the producer's
constexpr int kFwdThreads = (wbody::kPersistWgs + 1) * 128;

// A tile's rows at their pixels in y, rolled by `shift`, as runs of ws
// pixels (run q: row q % ws of window gw0 + q / ws; tile rows q ws ..
// q ws + ws - 1), each contiguous in y but where it wraps at the image's
// right edge: f(global address, byte offset in the tile's rows, bytes) for
// each of this thread's vectors of rows [0, rows). The vectors are 16
// bytes where every run, image row, shift and y allow it (C = 60, 90, 96,
// 120 at window 8 and shift 4), else 8, 4 or 2, so that none crosses a
// wrap.
template <class F>
__device__ __forceinline__ void for_run_vectors(const FwdArgs& a, int gw0,
                                                int rows, int shift, F f) {
  const int ws = a.ws, rb = 2 * a.g.c, run = ws * rb, nww = a.iw / ws;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.y) | run |
                          rb * a.iw | rb * shift;
  const int v = (align & 15) == 0 ? 16 : (align & 7) == 0 ? 8
                : (align & 3) == 0 ? 4 : 2;
  const int per = run / v, total = (rows / ws) * per;
  for (int i = threadIdx.x & 127; i < total; i += 128) {
    const int q = i / per, off = (i - q * per) * v;
    const int gw = gw0 + q / ws, wr = q % ws;
    const int img = gw / a.nw, wi = gw - img * a.nw;
    const int yy = ((wi / nww) * ws + wr + shift) % a.ih;
    const int px = off / rb;
    int xx = (wi % nww) * ws + shift + px;
    if (xx >= a.iw) xx -= a.iw;
    char* at = reinterpret_cast<char*>(
        a.y + ((static_cast<size_t>(img) * a.ih + yy) * a.iw + xx) * a.g.c);
    f(at + off - px * rb, q * run + off, v);
  }
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned int* p, unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p),
               "r"(v)
               : "memory");
}

// Whether every image of windows gw0 .. gw0 + k - 1 has its block-a
// windows in y (an acquire read of each counter); with `wait`, spins
// until they have. A wait of billions of cycles means a lost tile: it
// traps, so the launch fails and the caller raises, rather than hanging
// the card.
__device__ bool images_ready(const FwdArgs& a, int gw0, int k, bool wait) {
  for (int i = gw0 / a.nw; i <= (gw0 + k - 1) / a.nw; ++i) {
    long long t0 = -1;
    while (ld_acquire(a.ready + i) < static_cast<unsigned int>(a.nw)) {
      if (!wait) return false;
      if (t0 < 0)
        t0 = clock64();
      else if (clock64() - t0 > (1ll << 34))
        __trap();
      __nanosleep(64);
    }
  }
  return true;
}

// This thread's share of block-b rows [0, rows) of the tile whose first
// window is gw0, gathered from y at the rolled pixels into dst (rows of 2c
// bytes) by cp.async, once the images are ready; without `wait`, copies
// nothing and returns false when they are not. The copies stay in flight
// (the caller waits for them with cp.async.wait_all, then the warpgroup's
// barrier); y is written during the launch, so nothing reads it through
// the read-only path.
__device__ bool gather_rolled(const FwdArgs& a, int gw0, int rows, char* dst,
                              bool wait) {
  if (!images_ready(a, gw0, rows / a.g.n, wait)) return false;
  for_run_vectors(a, gw0, rows, a.shift, [&](const char* s, int o, int v) {
    const uint32_t d = wbody::smem_u32(dst + o);
    if (v == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(s) : "memory");
    else if (v == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(s) : "memory");
    else if (v == 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(s) : "memory");
    else
      *reinterpret_cast<unsigned short*>(dst + o) =
          __ldcg(reinterpret_cast<const unsigned short*>(s));
  });
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return true;
}

// Block a's or block b's weights, field by field (a choice of the whole
// struct would keep both in local memory)
__device__ __forceinline__ wbody::BlockW pick(int b, const wbody::BlockW& wa,
                                             const wbody::BlockW& wb) {
  wbody::BlockW w;
  w.panels = b ? wb.panels : wa.panels;
  w.bqkv = b ? wb.bqkv : wa.bqkv;
  w.bproj = b ? wb.bproj : wa.bproj;
  w.bf1 = b ? wb.bf1 : wa.bf1;
  w.bf2 = b ? wb.bf2 : wa.bf2;
  w.bias = b ? wb.bias : wa.bias;
  w.bias_windows = b ? wb.bias_windows : wa.bias_windows;
  return w;
}

// A warpgroup's weights, turns and training form: the persistent
// kernel's source (resident panels, the ring in turn order) with the
// tile's factor rows.
struct Trained : wbody::Turned {
  const float* frows;  // the tile's factor rows in shared memory, 64 x
                       // [attn, mlp]
};

__device__ __forceinline__ float2 row_factors(const Trained& t, int which) {
  const int r = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  return make_float2(t.frows[2 * r + which], t.frows[2 * (r + 8) + which]);
}

// the GELU of the backward's recompute (csrc/block_bwd.cuh)
__device__ __forceinline__ float gelu(const Trained&, float x) {
  return fastblk::gelu_tanh(x);
}

}  // namespace

namespace wbody {
template <>
struct TrainForm<Trained> {
  static constexpr bool value = true;
};
}  // namespace wbody

namespace {

template <int NT>
__global__ void __launch_bounds__(kFwdThreads, 1)
    pair_train_fwd_kernel(const __grid_constant__ FwdArgs a) {
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
  // after the ring's barriers: the resident panels', one a warpgroup for
  // its input tiles, the swap's; then both blocks' epilogue constants
  const uint32_t res_bar = wbody::smem_u32(ctrl + wbody::kCtrlBytes);
  const uint32_t swap_bar = res_bar + 8 * (1 + wbody::kPersistWgs);
  // the blocks' epilogue constants in shared memory
  auto staged = [&](const wbody::BlockW& src, char* at) {
    float* cq = reinterpret_cast<float*>(at);
    float* cf1 = cq + g.nq;
    bf16* cbp = reinterpret_cast<bf16*>(cf1 + g.hp);
    bf16* cf2 = cbp + g.cp;
    for (int i = threadIdx.x; i < g.nq; i += blockDim.x) cq[i] = src.bqkv[i];
    for (int i = threadIdx.x; i < g.hp; i += blockDim.x) cf1[i] = src.bf1[i];
    for (int i = threadIdx.x; i < g.cp; i += blockDim.x) {
      cbp[i] = src.bproj[i];
      cf2[i] = src.bf2[i];
    }
    wbody::BlockW w = src;
    w.bqkv = cq;
    w.bf1 = cf1;
    w.bproj = cbp;
    w.bf2 = cf2;
    return w;
  };
  char* consts = ctrl + wbody::kPersistCtrl;
  const int stride = wbody::const_stride(g);
  const wbody::BlockW wa = staged(a.wa, consts);
  const wbody::BlockW wb = staged(a.wb, consts + stride);
  if (threadIdx.x == 0) {
    wbody::ring_init(ring, 4);  // a panel copy is one warpgroup's
    for (int b = 0; b < 1 + wbody::kPersistWgs; ++b)
      wbody::mbar_init(res_bar + 8 * b, 1);
    wbody::mbar_init(swap_bar, wbody::kPersistWgs);
    wbody::mbar_init_fence();
  }
  __syncthreads();
  const int pairs = 2 * a.pairs_a;
  if (wg == wbody::kPersistWgs) {  // the producer warpgroup: one thread
    tokwg::regs_dec<tokwg::kProducerRegs>();
    if (threadIdx.x == wbody::kPersistWgs * 128) {
      int held = -1, seq = 0;  // the block whose panels are resident
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
        const int blk = pair < a.pairs_a ? 0 : 1;
        const char* panels = blk ? a.wb.panels : a.wa.panels;
        if (f.res_bytes && blk != held) {
          if (held >= 0) wbody::mbar_wait(swap_bar, 0);
          wbody::bulk_load(wbody::smem_u32(res), panels, f.res_bytes,
                           res_bar);
          held = blk;
        }
        // per section, warpgroup 0's copy of its streamed panels, then
        // warpgroup 1's (wbody::produce_turns' order)
        for (int s = 0; s < 3 && f.nslots; ++s)
          for (int w = 0; w < wbody::kPersistWgs; ++w)
            wbody::for_panels(g, 0, [&](int i, int off, int b) {
              if (i >= f.res && wbody::section_of(i) == s)
                wbody::ring_put(ring, seq++, panels + off, b);
            });
      }
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
  // valid rows of tile `tile` of a block (whole windows; 0 past the last)
  auto rows_of = [&](int tile) {
    const int left = a.windows - tile * per;
    return left <= 0 ? 0 : (left < per ? left : per) * n;
  };
  auto src_of = [&](int tile) {
    return reinterpret_cast<const char*>(a.x) +
           static_cast<size_t>(tile) * wbody::kRows * row_bytes;
  };
  Trained t;
  t.ring = ring;
  t.st = wbody::streamed(g, f.res);
  t.res = wbody::smem_u32(res);
  t.res_panels = f.res_panels;
  t.wg = wg;
  t.turns = 0;
  t.take_turns = a.turns;
  t.next_dst = inbuf_s;
  t.in_bar = in_bar;
  float* frows = reinterpret_cast<float*>(consts + 2 * stride +
                                          wg * wbody::kFactorBytes);
  t.frows = frows;
  bool gathered = false;  // this thread's share of its next tile's rows

  int pair = blockIdx.x;
  if (pair < a.pairs_a) {  // the first tile's rows, when block a's
    const int rows = rows_of(2 * pair + wg);
    if (lead && rows)
      wbody::bulk_load(inbuf_s, src_of(2 * pair + wg), rows * row_bytes,
                       in_bar);
  }
  int loads = 0, swaps = 0, held = -1;
  for (int it = 0; pair < pairs; pair += gridDim.x, ++it) {
    const int blk = pair < a.pairs_a ? 0 : 1;
    const int tile = 2 * (pair - blk * a.pairs_a) + wg, rows = rows_of(tile);
    const int gw0 = tile * per;
    if (rows && blk == 0) {
      wbody::mbar_wait(in_bar, loads++ & 1);
    } else if (rows) {  // the rolled rows of a block-b tile
      if (!gathered) gather_rolled(a, gw0, rows, inbuf, true);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      wbody::wg_sync(wg);
    }
    float x[NT][16];
    wbody::regs_from_rows(x, reinterpret_cast<const bf16*>(inbuf), c, c,
                          rows);
    {  // the tile's factor rows of its block: [attn, mlp], 1 without dpf
      const int i = threadIdx.x & 127, r = i >> 1;
      frows[i] = a.dpf && r < rows
                     ? __ldg(a.dpf + (static_cast<size_t>(tile) *
                                          wbody::kRows + r) * 4 +
                             2 * blk + (i & 1))
                     : 1.f;
    }
    wbody::wg_sync(wg);
    if (f.res_bytes && blk != held) {  // this block's resident panels
      wbody::mbar_wait(res_bar, swaps++ & 1);
      held = blk;
    }
    // the next tile: a block-a tile by a bulk copy into the input buffer
    // now, or into the A rows once fc1 has read them (after_fc1); a
    // block-b tile by cp.async into the input buffer now, if its images
    // are ready (a gather from within the block, into the A rows, would
    // serialize its wgmma: ptxas C7520)
    const int npair = pair + gridDim.x;
    const int nblk = npair < a.pairs_a ? 0 : 1;
    const int ntile = 2 * (npair - nblk * a.pairs_a) + wg;
    const int nrows = npair < pairs ? rows_of(ntile) : 0;
    t.start(it);
    t.next_bytes = 0;
    gathered = false;
    if (nrows && nblk == 0) {
      if (f.nin) {
        if (lead) {
          wbody::fence_async_smem();
          wbody::bulk_load(inbuf_s, src_of(ntile), nrows * row_bytes,
                           in_bar);
        }
      } else {
        t.next_src = src_of(ntile);
        t.next_bytes = nrows * row_bytes;
      }
    } else if (nrows && f.nin) {
      gathered = gather_rolled(a, ntile * per, nrows, inbuf, false);
    }
    // a warpgroup without a tile (a block's last pair's second) runs the
    // block on zeros, so that its turns and ring copies stay in step
    const wbody::BlockW w = pick(blk, wa, wb);
    wbody::block(x, w, g, wsm, t, a.softmax, gw0, a.nw, wg);
    // past its last block-a tile: the resident panels may be swapped
    if (f.res_bytes && npair < pairs && nblk != blk && lead)
      wbody::mbar_arrive(swap_bar);
    if (!rows) continue;
    // bf16 rows out through the q | k | v region
    wbody::rows_from_regs(x, reinterpret_cast<bf16*>(region), c, c);
    wbody::wg_sync(wg);
    if (blk == 0) {  // into y at the windows' pixels, then the release
      for_run_vectors(a, gw0, rows, 0, [&](char* d, int o, int v) {
        const char* src = region + o;
        if (v == 16)
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
        else if (v == 8)
          *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(src);
        else if (v == 4)
          *reinterpret_cast<uint32_t*>(d) =
              *reinterpret_cast<const uint32_t*>(src);
        else
          *reinterpret_cast<unsigned short*>(d) =
              *reinterpret_cast<const unsigned short*>(src);
      });
      __threadfence();
      wbody::wg_sync(wg);
      if (lead) {
        const int k = rows / n;
        for (int i = gw0 / a.nw; i <= (gw0 + k - 1) / a.nw; ++i) {
          const int lo = gw0 > i * a.nw ? gw0 : i * a.nw;
          const int hi = gw0 + k < (i + 1) * a.nw ? gw0 + k : (i + 1) * a.nw;
          add_release(a.ready + i, hi - lo);
        }
      }
    } else {  // the shifted window layout, as the tile is
      char* dst = reinterpret_cast<char*>(a.out) +
                  static_cast<size_t>(tile) * wbody::kRows * row_bytes;
      const int bytes = rows * row_bytes;
      wbody::rows_out([&](int) { return dst; }, 1, bytes,
                      reinterpret_cast<uintptr_t>(dst) | bytes, region, 0);
    }
  }
  wbody::turn_close(t);
}

// One thread block an SM at most: the plan's shared memory and 384
// threads of 168 registers fit one on an SM, and the cooperative launch
// refuses a grid whose blocks are not all resident.
template <int NT>
cudaError_t launch_fwd(FwdArgs& a, cudaStream_t s) {
  auto kernel = pair_train_fwd_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.f.smem);
  if (err != cudaSuccess) return err;
  const int sms = tokwg::sm_count(), pairs = 2 * a.pairs_a;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(pairs < sms ? pairs : sms),
                                    dim3(kFwdThreads), params, a.f.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// one block's stage_layout operands and stage_bias
void set_stage_weights(wbody::BlockW* w, const void* const* p) {
  w->panels = static_cast<const char*>(p[0]);
  w->bqkv = static_cast<const float*>(p[1]);
  w->bproj = static_cast<const bf16*>(p[2]);
  w->bf1 = static_cast<const float*>(p[3]);
  w->bf2 = static_cast<const bf16*>(p[4]);
  w->bias = static_cast<const bf16*>(p[5]);
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

// ptrs: x, out, y (block a's output, image layout), ready (images
// unsigned ints, zeroed here), dpf (0 = none), then block a's
// kernels.window_body.stage_layout operands (panels, bqkv, bproj, bf1,
// bf2) and its stage_bias, then block b's (6 each). dims: images, h, w,
// ws, shift, c, nh, hidden, softmax, turns (1; 0 runs the warpgroups
// without turns, taken only where every panel is resident). x and the
// panels 16-byte aligned.
int pair_train_fwd_bf16(const void* const* ptrs, const int* dims, int device,
                        void* stream) {
  FwdArgs a;
  a.x = static_cast<const bf16*>(ptrs[0]);
  a.out = mut<bf16>(ptrs[1]);
  a.y = mut<bf16>(ptrs[2]);
  a.ready = mut<unsigned int>(ptrs[3]);
  a.dpf = static_cast<const float*>(ptrs[4]);
  set_stage_weights(&a.wa, ptrs + 5);
  set_stage_weights(&a.wb, ptrs + 11);
  const int images = dims[0];
  a.ih = dims[1];
  a.iw = dims[2];
  a.ws = dims[3];
  a.shift = dims[4];
  a.softmax = dims[8];
  a.turns = dims[9] != 0;
  if (a.ws <= 0 || images < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.g = wbody::make_geom(a.ws * a.ws, dims[5], dims[6], dims[7]);
  a.f = wbody::persist_fit(a.g, 2);
  if (!wbody::geom_ok(a.g) || a.f.smem == 0 || a.ih % a.ws ||
      a.iw % a.ws || a.shift < 0 || a.shift >= a.ws || a.softmax < 0 ||
      a.softmax > 2 || (!a.turns && a.f.nslots))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a.x) |
       reinterpret_cast<uintptr_t>(a.wa.panels) |
       reinterpret_cast<uintptr_t>(a.wb.panels)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  a.nw = (a.ih / a.ws) * (a.iw / a.ws);
  a.windows = images * a.nw;
  a.wa.bias_windows = 1;
  a.wb.bias_windows = a.shift > 0 ? a.nw : 1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || a.windows == 0) return static_cast<int>(err);
  const int tiles = (a.windows * a.g.n + wbody::kRows - 1) / wbody::kRows;
  a.pairs_a = (tiles + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.ready, 0, sizeof(unsigned int) * images, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (a.g.no / 32) {
    case 1: return static_cast<int>(launch_fwd<1>(a, s));
    case 2: return static_cast<int>(launch_fwd<2>(a, s));
    case 3: return static_cast<int>(launch_fwd<3>(a, s));
    case 4: return static_cast<int>(launch_fwd<4>(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
