// The GEMMs of the token-parallel serving forward (csrc/token_fwd.cuh) for
// Hopper (sm_90a): persistent, warp-specialized, wgmma on operands that
// TMA brings into shared memory.
//
// Replaces, for the serving forward only, the mma.sync tiles of
// csrc/token_gemm.cuh (`gemm_tile`, and the int8 tile that token_fwd.cuh
// had): the qkv product (bf16, or int8 on wgmma .s8), the projection with
// its residual and LN2, fc1 + tanh GELU + fc2 + residual fused in one
// kernel, and the RDSTB adapter's product with its LN. The training
// backward (csrc/block_bwd.cuh) keeps gemm_tile.
//
// What bounds these on an H100: the bytes of the token-major buffers they
// read and write (a call's operations take a third of its bytes' time or
// less); before this design, the latency of 64-row tiles with 3-13
// K-steps each, none overlapping another tile's loads. The design:
// * One thread block an SM (the grid is the tiles or the SMs, whichever is
//   fewer) walks tiles of 128 token rows (64 where the call has fewer
//   128-row tiles than the card has SMs, or where the MLP's hidden rows of
//   128 do not fit): two consumer warpgroups of wgmma's M = 64 each, or
//   one, and a producer warpgroup that hands its registers to them
//   (setmaxnreg) and keeps TMA loads in flight from one thread.
// * The producer loads a tile's A rows (all of K, in 128-byte slices with
//   the 128-byte swizzle) into one of two A buffers, so the next tile's
//   rows land while this tile's products and epilogue run, and the
//   weights, slice by slice, through a ring of slots with an mbarrier pair
//   each. The weights are re-read from L2 for each tile.
// * Operands are 2-D tensor maps (`cuTensorMapEncodeTiled`, through the
//   runtime's driver entry point, so nothing links libcuda) over the plain
//   token-major buffers and the K-major [n][k] weights. K and N stop at
//   the real widths (C, hidden, growth): the map fills rows and columns
//   past them with zeros, so no pad column is read from memory.
// * Products: wgmma m64n64k16 bf16 -> f32 and m64n64k32 s8 -> s32 (exact
//   sums), both operands from shared memory by descriptor.
// * Epilogues run on the accumulator registers (a warp holds 16 whole
//   rows: LN2 and the adapter's LN reduce a row with quad shuffles), with
//   the per-column constants in shared memory. Their bf16 rows leave (and
//   the projection's residual rows arrive) through 2 KB of staging rows a
//   warp, as whole 16- or 8-byte vectors of each row; the f32 x1 between
//   the projection and the MLP stays in the accumulator's own order.
// * The MLP keeps a tile's hidden rows in shared memory: fc1 + GELU slice
//   by slice (the next slice's products run while the warps apply the
//   GELU), the A tile goes back to the producer, then fc2 from the hidden
//   rows; the hidden rows never reach device memory.
// Rounding points are token_gemm.cuh's epilogues': only the order of the
// sums changes; the int8 sums are exact, so q/k/v are bitwise the same.

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "token_gemm.cuh"
#include "window_body.cuh"

namespace tokwg {

using fastblk::bf16;
namespace tp = tokpar;

constexpr int kSlice = 128;        // bytes of K a slice (the swizzle span)
constexpr int kPiece = 64;         // output columns of one wgmma
constexpr int kPieceBytes = kPiece * kSlice;  // a 64-row slice: 8 KB
constexpr int kMaxWgs = 2;         // consumer warpgroups a block
// the consumers and a producer warpgroup (one thread of it issues the
// copies), which gives its registers to the consumers
constexpr int kThreads = (kMaxWgs + 1) * 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kMaxSlots = 6;       // weight ring slots
constexpr int kAlign = 1024;       // the 128-byte swizzle's period
constexpr int kSmemOptin = 232448;
constexpr int kQkvPieces = 3;      // qkv output columns a pass: 192

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A launch's schedule (host-computed; kernels.swin_block.token_gemm_sched
// mirrors it): tiles of bm rows, A in nks slices, ksteps 32-byte K-steps of
// products, the ring, the bytes of an A buffer, of the staging rows (the
// MLP's hidden slice; the other kernels' output rows) and of the
// epilogue's per-column constants.
struct Sched {
  int tiles, bm, nks, ksteps;
  int nslots, slot_bytes, na, a_bytes, h_bytes, c_bytes;
};

// Rows a tile: 128 (two consumer warpgroups) once the call has at least
// as many 128-row tiles as the card has SMs, else 64 (one).
inline int tile_rows(int m, int sms) { return cdiv(m, 128) >= sms ? 128 : 64; }

// A GEMM over m rows in tiles of bm, K of kbytes bytes, weight stages of
// slot_bytes, `consts` f32 epilogue constants, h_slices 128-byte columns of
// staging rows (the MLP's hidden rows; one elsewhere) and na A buffers.
inline Sched sched(int m, int bm, int kbytes, int slot_bytes, int consts,
                   int h_slices = 1, int na = 2) {
  Sched s;
  s.bm = bm;
  s.tiles = cdiv(m, bm);
  s.nks = cdiv(kbytes, kSlice);
  s.ksteps = cdiv(kbytes, 32);
  s.na = na;
  s.a_bytes = bm * s.nks * kSlice;
  s.h_bytes = h_slices * bm * kSlice;
  s.c_bytes = cdiv(4 * consts, 16) * 16;
  s.slot_bytes = slot_bytes;
  const int n = (kSmemOptin - kAlign - na * s.a_bytes - s.h_bytes -
                 s.c_bytes - 32) /
                (slot_bytes + 16);
  s.nslots = n > kMaxSlots ? kMaxSlots : n;
  return s;
}

inline int smem_bytes(const Sched& s) {
  return kAlign + s.na * s.a_bytes + s.nslots * s.slot_bytes + s.h_bytes +
         s.c_bytes + 32 + 16 * s.nslots;
}

// ------------------------------------------------------------ device side

using wbody::fence_async_smem;
using wbody::mbar_arrive;
using wbody::mbar_wait;
using wbody::smem_u32;
using wbody::wgmma_commit;
using wbody::wgmma_fence;
using wbody::wgmma_wait0;

// wgmma descriptor of a K-major operand in the 128-byte swizzle: 8-row
// groups 1024 bytes apart (the leading offset is unused in this mode);
// the start advances 32 bytes a K-step inside the 128-byte row.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x 64, accumulator order) = A (64 x 16) B^T (64 x 16) (+ d when
// acc), bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                    int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// the same with int8 operands (64 x 32 bytes of depth) and exact int32 sums
__device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db,
                                    int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// the warpgroup's registers a thread, raised or lowered (all of its
// threads take part)
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// keep the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// box (c0, c1) of a 2-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The block's shared memory, from a 1024-byte aligned base: two A
// buffers, the ring's slots, the staging rows (64 rows x 128 bytes a
// consumer warpgroup: the MLP's hidden slice, and 2 KB a consumer warp for
// its output rows), the epilogue's per-column constants (f32), then the
// barriers: A full x2, A empty x2, slot full x nslots, slot empty x nslots.
struct Lay {
  uint32_t a0, slot0, h, bar;
  char* hp;   // the staging rows, generic
  float* cs;  // the constants
  int nslots, slot_bytes, a_bytes;
  __device__ uint32_t a(int b) const { return a0 + b * a_bytes; }
  __device__ uint32_t afull(int b) const { return bar + 8 * b; }
  __device__ uint32_t aempty(int b) const { return bar + 16 + 8 * b; }
  __device__ uint32_t full(int s) const { return bar + 32 + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return bar + 32 + 8 * (nslots + s);
  }
  __device__ uint32_t slot(int s) const { return slot0 + s * slot_bytes; }
};

__device__ inline Lay lay(char* raw, const Sched& s) {
  Lay L;
  const uint32_t r = smem_u32(raw);
  const uint32_t base = (r + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  L.a0 = base;
  L.a_bytes = s.a_bytes;
  L.slot0 = base + s.na * s.a_bytes;
  L.nslots = s.nslots;
  L.slot_bytes = s.slot_bytes;
  L.h = L.slot0 + s.nslots * s.slot_bytes;
  L.hp = raw + (L.h - r);
  L.cs = reinterpret_cast<float*>(L.hp + s.h_bytes);
  L.bar = L.h + s.h_bytes + s.c_bytes;
  return L;
}

// thread 0: every barrier; arrivals: the producer's one (with the bytes)
// on a full barrier, one a consumer warp on an empty one
__device__ inline void init_bars(const Lay& L, int consumer_warps) {
  for (int b = 0; b < 2; ++b) {
    wbody::mbar_init(L.afull(b), 1);
    wbody::mbar_init(L.aempty(b), consumer_warps);
  }
  for (int s = 0; s < L.nslots; ++s) {
    wbody::mbar_init(L.full(s), 1);
    wbody::mbar_init(L.empty(s), consumer_warps);
  }
  wbody::mbar_init_fence();
}

// the producer: ring stage `seq` of `bytes`, once its slot is free
__device__ __forceinline__ int put(const Lay& L, int seq, int bytes) {
  const int slot = seq % L.nslots;
  if (seq >= L.nslots) mbar_wait(L.empty(slot), ((seq / L.nslots) - 1) & 1);
  expect_tx(L.full(slot), bytes);
  return slot;
}

// the producer: tile `tile` of A (every K slice) into buffer it % na, once
// the tile na before it has given the buffer back
__device__ __forceinline__ void put_a(const Lay& L, const Sched& s,
                                      const CUtensorMap* map, int kel,
                                      int tile, int it) {
  const int b = it % s.na;
  if (it >= s.na) mbar_wait(L.aempty(b), ((it / s.na) - 1) & 1);
  expect_tx(L.afull(b), s.a_bytes);
  for (int k = 0; k < s.nks; ++k)
    tma_load(L.a(b) + k * s.bm * kSlice, map, k * kel, tile * s.bm,
             L.afull(b));
}

// a consumer: stage `seq`'s slot, once it has landed
__device__ __forceinline__ uint32_t take(const Lay& L, int seq) {
  const int slot = seq % L.nslots;
  mbar_wait(L.full(slot), (seq / L.nslots) & 1);
  return L.slot(slot);
}

// a consumer warp gives stage `seq`'s slot back (its products are done)
__device__ __forceinline__ void give(const Lay& L, int seq) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(L.empty(seq % L.nslots));
}

// ------------------------------------------------------------ epilogues
//
// run(acc, np, m0, n0): the accumulator of the warpgroup's 64 rows from m0
// and np pieces of 64 columns from n0. Thread (warp w of the warpgroup,
// lane 4 g + t) holds rows m0 + 16 w + g + 8 h (h = 0, 1), columns n0 +
// 64 q + 8 j + 2 t + e at acc[q][4 j + 2 h + e].

struct Frag {
  int lane, g, t, r0;  // lane, quad row, quad lane, the warp's first row
};

__device__ __forceinline__ Frag frag() {
  const int lane = threadIdx.x & 31;
  return Frag{lane, lane >> 2, lane & 3,
              16 * static_cast<int>((threadIdx.x >> 5) & 3)};
}

// x1, the f32 residual between the projection's epilogue and the MLP's,
// in the accumulator's own order, so that both move it as whole 256-byte
// runs a warp: the float pair (row m, columns 64 q + 8 j + 2 t, +1), m = 16
// blk + 8 h + g, at float (((blk pc + q) 8 + j) 2 + h) 64 + 2 (4 g + t),
// pc = ceil(c / 64) pieces a row (kernels.token_wgmma.x1_pack mirrors it).
__host__ __device__ inline size_t x1_at(int blk, int pc, int q, int j,
                                        int h, int lane) {
  return ((((static_cast<size_t>(blk) * pc + q) * 8 + j) * 2 + h) * 32 +
          lane) *
         2;
}

__host__ __device__ inline size_t x1_floats(int tokens, int c) {
  return static_cast<size_t>(cdiv(tokens, 16)) * 16 * kPiece *
         cdiv(c, kPiece);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp's staging rows: 16 rows x 128 bytes (64 bf16 columns) in shared
// memory, row r's 16-byte chunk k at r * 128 + ((k ^ (r & 7)) << 4), so
// that the accumulator order's pairs go in, and whole 16-byte chunks of
// rows come out, without bank conflicts. Through it a warp's stores (and
// the projection's residual loads) move 128 whole bytes of each row, where
// the accumulator order moves 16 bytes of a 32-byte sector.
constexpr int kStageBytes = 16 * kSlice;

__device__ __forceinline__ char* warp_stage(const Lay& L) {
  return L.hp + (threadIdx.x >> 5) * kStageBytes;
}

__device__ __forceinline__ uint32_t* stage_pair(char* st, int row, int col) {
  return reinterpret_cast<uint32_t*>(st + row * kSlice +
                                     ((((col >> 3) ^ row) & 7) << 4) +
                                     (col & 7) * 2);
}

// The V-byte vector k (V = 16 or 8: V / 2 columns from column k V / 2)
// of staged row `row`.
template <int V>
__device__ __forceinline__ char* stage_at(char* st, int row, int k) {
  const int c16 = V == 16 ? k : k >> 1;
  return st + row * kSlice + (((c16 ^ row) & 7) << 4) +
         (V == 16 ? 0 : (k & 1) * 8);
}

template <int V>
using VecT = typename std::conditional<V == 16, uint4, uint2>::type;

// The staged rows a lane moves in V-byte vectors: the i-th is row
// lane / (128 / V) + i 32 / (128 / V) of the warp's 16, vector lane % (128
// / V) of it (i < 16 (128 / V) / 32).
template <int V>
__device__ __forceinline__ int vec_row(int lane, int i) {
  constexpr int per = kSlice / V;
  return (lane + 32 * i) / per;
}

// The staged 16 x 64 piece out in V-byte vectors: vector k of row rr (the
// lane's i-th, vec_row) to dst(i, rr) + k V / 2, where dst is not null
// and k V / 2 < limit (columns relative to the piece).
template <int V, class Dst>
__device__ __forceinline__ void stage_out(char* st, int lane, Dst dst,
                                          int limit) {
  constexpr int per = kSlice / V, el = V / 2;  // vectors a row; columns
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * per / 32; ++i) {
    const int idx = lane + 32 * i, rr = idx / per, k = idx % per;
    bf16* d = dst(i, rr);
    if (d && el * k < limit)
      *reinterpret_cast<VecT<V>*>(d + el * k) =
          *reinterpret_cast<const VecT<V>*>(stage_at<V>(st, rr, k));
  }
  __syncwarp();
}

// The widest vector (16 or 8 bytes; 0: neither) that rows of ld bf16 at
// base take.
__device__ __forceinline__ int vec_bytes(const void* base, int ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) | (2u * ld);
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : 0;
}

// every thread of the block: n per-column constants into shared memory
template <class F>
__device__ __forceinline__ void fill(float* cs, int n, F f) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cs[i] = f(i);
}

// q, k, v by head: bf16(acc + bqkv), or with int8 qkv bf16(int32(acc) ws +
// bqkv), each product and sum rounded on its own (token_fwd.cuh's
// epilogues before this design); rows of n3 (a multiple of 8) out through
// the staging rows. Constants: bqkv, then ws.
struct EpiQkv {
  bf16* qkv;          // (tokens, n3)
  const float* ws;    // (n3) by head, or null for bf16 qkv
  const float* bqkv;  // (n3) by head
  int tokens, n3;
  __host__ __device__ int consts() const { return ws ? 2 * n3 : n3; }
  __device__ void fill_consts(float* cs) const {
    const int n = n3;
    const float* b = bqkv;
    const float* w = ws;
    fill(cs, consts(), [&](int i) { return i < n ? b[i] : w[i - n]; });
  }
  template <int NT, class Acc>
  __device__ void run(const Acc (&acc)[NT][32], int np, int m0, int n0,
                      const float* cs, char* st) const {
    const Frag f = frag();
    const int r0 = m0 + f.r0;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if (q >= np) continue;
      const int c0 = n0 + kPiece * q;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + 8 * j + 2 * f.t;
        const bool in = col < n3;
        const float2 b = in ? *reinterpret_cast<const float2*>(cs + col)
                            : make_float2(0.f, 0.f);
        const float2 w = in && ws
                             ? *reinterpret_cast<const float2*>(cs + n3 + col)
                             : make_float2(1.f, 1.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = static_cast<float>(acc[q][4 * j + 2 * h]);
          float v1 = static_cast<float>(acc[q][4 * j + 2 * h + 1]);
          if (ws) {
            v0 = __fadd_rn(__fmul_rn(v0, w.x), b.x);
            v1 = __fadd_rn(__fmul_rn(v1, w.y), b.y);
          } else {
            v0 = v0 + b.x;
            v1 = v1 + b.y;
          }
          *stage_pair(st, f.g + 8 * h, 8 * j + 2 * f.t) =
              fastblk::pack2(v0, v1);
        }
      }
      stage_out<16>(
          st, f.lane,
          [&](int, int rr) -> bf16* {
            const int m = r0 + rr;
            return m < tokens ? qkv + static_cast<size_t>(m) * n3 + c0
                              : nullptr;
          },
          n3 - c0);
    }
  }
};

// x1 = x + (ao Wproj + bproj) f (f32, the input token at row xr(m, n) of
// x, ldx a row; f = dpf[2 m], the training step's stochastic-depth factor
// of the attention branch, or 1 without dpf, which changes no bit); LN2
// with one-pass moments (eps 1e-5) over the c columns; x1n =
// bf16(normalize(x1)), ones at column c, zeros to kp. A warp's rows are
// whole in its accumulator, so the moments are quad sums. The residual
// comes in and x1n goes out through the staging rows where the strides
// allow (x1's f32 pairs already fill a quad's 32-byte sector). Constants:
// bproj (f32).
struct EpiProjLn {
  const bf16* x;
  tp::Rows xr;
  int ldx, n;
  const bf16* bproj;
  float* x1;  // x1_floats(tokens, c), in x1_at's order
  bf16* x1n;  // (tokens, kp)
  int tokens, c, kp;
  const float* dpf = nullptr;  // (tokens, 2) factor columns [attn, mlp]
  __host__ __device__ int consts() const { return c; }
  __device__ void fill_consts(float* cs) const {
    const bf16* b = bproj;
    fill(cs, c, [&](int i) { return __bfloat162float(b[i]); });
  }
  template <int NT>
  __device__ void run(const float (&acc)[NT][32], int, int m0, int,
                      const float* cs, char* st) const {
    const Frag f = frag();
    const int r0 = m0 + f.r0;
    const int vb = vec_bytes(x, ldx);
    // the rows this lane loads through the staging rows, found once (a
    // row map costs integer divisions): element offsets, or -1 past T
    long long xoff[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = r0 + (vb == 16 ? vec_row<16>(f.lane, i & 3)
                                   : vec_row<8>(f.lane, i));
      xoff[i] = vb && i < 16 * 128 / vb / 32 && m < tokens
                    ? static_cast<long long>(xr(m, n)) * ldx
                    : -1;
    }
    // the residual's pairs at this lane's columns, rows g and g + 8
    uint32_t xp[2][NT][8];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if (vb) {
        // its rows in V-byte vectors into the staging rows (a vector that
        // starts before c may read columns past it, inside the row: the
        // stride is a multiple of V / 2; they are not used)
        auto in = [&](auto vtag) {
          constexpr int V = decltype(vtag)::value;
          constexpr int per = kSlice / V, el = V / 2;
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 16 * per / 32; ++i) {
            const int idx = f.lane + 32 * i, rr = idx / per, k = idx % per;
            const int col = kPiece * q + el * k;
            VecT<V> v{};
            if (xoff[i] >= 0 && col < c)
              v = __ldg(reinterpret_cast<const VecT<V>*>(x + xoff[i] + col));
            *reinterpret_cast<VecT<V>*>(stage_at<V>(st, rr, k)) = v;
          }
          __syncwarp();
        };
        if (vb == 16)
          in(std::integral_constant<int, 16>());
        else
          in(std::integral_constant<int, 8>());
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xp[h][q][j] = *stage_pair(st, f.g + 8 * h, 8 * j + 2 * f.t);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r0 + f.g + 8 * h;
          const bf16* xrow = x + (m < tokens ? xr(m, n) * ldx : 0);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = kPiece * q + 8 * j + 2 * f.t;
            xp[h][q][j] = fastblk::pack2(
                m < tokens && col < c ? tp::ldb(xrow + col) : 0.f,
                m < tokens && col + 1 < c ? tp::ldb(xrow + col + 1) : 0.f);
          }
        }
      }
    }
    float mu[2], rs[2], fa[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      fa[h] = dpf && m < tokens ? __ldg(dpf + 2 * static_cast<size_t>(m))
                                : 1.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kPiece * q + 8 * j + 2 * f.t + e;
            if (col < c) {
              const float xv = e ? fastblk::hi_f(xp[h][q][j])
                                 : fastblk::lo_f(xp[h][q][j]);
              const float v =
                  xv + (acc[q][4 * j + 2 * h + e] + cs[col]) * fa[h];
              s1 += v;
              s2 += v * v;
            }
          }
      s1 = quad_sum(s1);
      s2 = quad_sum(s2);
      mu[h] = s1 / c;
      rs[h] = rsqrtf(fmaxf(s2 / c - mu[h] * mu[h], 0.f) + fastblk::kEps);
    }
    const int blk = r0 >> 4, pc = cdiv(c, kPiece);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + f.g + 8 * h;
        const float mr = mu[h] * rs[h];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = kPiece * q + 8 * j + 2 * f.t;
          float v[2], nv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xv = e ? fastblk::hi_f(xp[h][q][j])
                               : fastblk::lo_f(xp[h][q][j]);
            v[e] = col + e < c
                       ? xv + (acc[q][4 * j + 2 * h + e] + cs[col + e]) *
                                  fa[h]
                       : 0.f;
            nv[e] = col + e < c ? v[e] * rs[h] - mr
                                : (col + e == c ? 1.f : 0.f);
          }
          if (m < tokens && kPiece * q + 8 * j < c)
            *reinterpret_cast<float2*>(x1 + x1_at(blk, pc, q, j, h, f.lane)) =
                make_float2(v[0], v[1]);
          *stage_pair(st, f.g + 8 * h, 8 * j + 2 * f.t) =
              fastblk::pack2(nv[0], nv[1]);
        }
      }
      stage_out<16>(
          st, f.lane,
          [&](int, int rr) -> bf16* {
            const int m = r0 + rr;
            return m < tokens
                       ? x1n + static_cast<size_t>(m) * kp + kPiece * q
                       : nullptr;
          },
          kp - kPiece * q);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      if (m < tokens)
        for (int o = kPiece * NT + f.t; o < kp; o += 4)
          x1n[static_cast<size_t>(m) * kp + o] =
              __float2bfloat16_rn(o == c ? 1.f : 0.f);
    }
  }
};

// The RDSTB's tail adapter: a = acc + bad over the growth columns;
// post-norm bf16(LN(a) gad + bbad) (two-pass moments, eps 1e-5), pre-norm
// bf16(a); into row orow(m, n) of dense (ld a row) at columns [col, col +
// growth), through the staging rows where the strides allow. Constants:
// bad, gad, bbad.
struct EpiAdapter {
  const float* bad;   // (growth)
  const float* gad;   // (growth)
  const float* bbad;  // (growth)
  bf16* dense;
  tp::Rows orow;
  int n, ld, col, growth, tokens, prenorm;
  __host__ __device__ int consts() const { return 3 * growth; }
  __device__ void fill_consts(float* cs) const {
    const int g = growth;
    const float *b = bad, *ga = gad, *bb = bbad;
    fill(cs, 3 * g, [&](int i) {
      return i < g ? b[i] : i < 2 * g ? ga[i - g] : bb[i - 2 * g];
    });
  }
  template <int NT>
  __device__ void run(const float (&acc)[NT][32], int, int m0, int,
                      const float* cs, char* st) const {
    const Frag f = frag();
    const int r0 = m0 + f.r0;
    const float *cb = cs, *cg = cs + growth, *cbb = cs + 2 * growth;
    float mu[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = kPiece * q + 8 * j + 2 * f.t + e;
            if (i < growth) s += acc[q][4 * j + 2 * h + e] + cb[i];
          }
      mu[h] = quad_sum(s) / growth;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = kPiece * q + 8 * j + 2 * f.t + e;
            if (i < growth) {
              const float d = (acc[q][4 * j + 2 * h + e] + cb[i]) - mu[h];
              v += d * d;
            }
          }
      rs[h] = rsqrtf(quad_sum(v) / growth + fastblk::kEps);
    }
    auto value = [&](int q, int j, int h, int e) {
      const int i = kPiece * q + 8 * j + 2 * f.t + e;
      if (i >= growth) return 0.f;
      const float a = acc[q][4 * j + 2 * h + e] + cb[i];
      return prenorm ? a : (a - mu[h]) * rs[h] * cg[i] + cbb[i];
    };
    if (((ld | col | growth) & 7) == 0 && vec_bytes(dense, ld) == 16) {
#pragma unroll
      for (int q = 0; q < NT; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *stage_pair(st, f.g + 8 * h, 8 * j + 2 * f.t) =
                fastblk::pack2(value(q, j, h, 0), value(q, j, h, 1));
        stage_out<16>(
            st, f.lane,
            [&](int, int rr) -> bf16* {
              const int m = r0 + rr;
              return m < tokens ? dense + orow(m, n) * ld + col + kPiece * q
                                : nullptr;
            },
            growth - kPiece * q);
      }
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      if (m >= tokens) continue;
      bf16* dst = dense + orow(m, n) * ld + col;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = kPiece * q + 8 * j + 2 * f.t + e;
            if (i < growth) dst[i] = __float2bfloat16_rn(value(q, j, h, e));
          }
    }
  }
};

// ------------------------------------------------------ int8 epilogues
//
// The int8 'proj' and 'mlp' groups (kernels.quant): their products run on
// wgmma .s8 with exact int32 sums; a dynamic scale is the amax of one scale
// group of tokens (gtok of them: the windows one program of the JAX kernel
// holds), kept as the bits of a non-negative float (atomicMax orders them
// as the floats), its dequant step amax * (1 / 127) meeting the weight
// step before the int32 sum, each product and sum rounded on its own (the
// JAX epilogue's order). These are the epilogues' own code: the bf16 ones
// above, which the training step's forward runs too, stay as they are.

constexpr float kInv127 = 1.0f / 127.0f;

// the dequant step of a group's amax bits (the floor 1e-30 of _quant_dyn)
__device__ __forceinline__ float dequant_step(unsigned bits) {
  return __fmul_rn(fmaxf(__uint_as_float(bits), 1e-30f), kInv127);
}

// a warp's max, then one atomicMax into the group of the warp's rows (a
// warp's 16 rows lie in one window of n = 16 or 64 tokens, so in one
// group)
__device__ __forceinline__ void group_amax(float mx, unsigned* amax,
                                           int row, int tokens, int gtok) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0 && row < tokens)
    atomicMax(amax + row / gtok, __float_as_uint(mx));
}

__device__ __forceinline__ int8_t quant8(float v, float s) {
  return static_cast<int8_t>(
      static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, s)), -127.f), 127.f)));
}

// The projection's epilogue with int8 operands in either place: y = acc +
// bproj (bf16 product) or int32(acc) (wps dq) + bproj (int8 'proj', dq the
// token's group step); x1 = x + y (f32, in x1_at's order, as EpiProjLn);
// LN2 (one-pass moments, eps 1e-5) into bf16 rows x1n (ones at c, zeros
// to kp) or, for int8 'mlp', int8 rows x1q = clip(round(normalize(x1)
// kQX)) (zeros to kq). Constants: bproj (f32), then wps.
struct EpiProjLnQ {
  const bf16* x;
  tp::Rows xr;
  int ldx, n;
  const bf16* bproj;
  const float* ws;        // (c) wps, or null for the bf16 product
  const unsigned* amax;   // the groups' amax bits of the attention output
  int gtok;
  float* x1;
  bf16* x1n;              // (tokens, kp), or null
  int kp;
  int8_t* x1q;            // (tokens, kq), or null
  int kq, tokens, c;
  __host__ __device__ int consts() const { return ws ? 2 * c : c; }
  __device__ void fill_consts(float* cs) const {
    const bf16* b = bproj;
    const float* w = ws;
    const int cc = c;
    fill(cs, consts(), [&](int i) {
      return i < cc ? __bfloat162float(b[i]) : w[i - cc];
    });
  }
  template <int NT, class Acc>
  __device__ void run(const Acc (&acc)[NT][32], int, int m0, int,
                      const float* cs, char*) const {
    const Frag f = frag();
    const int r0 = m0 + f.r0;
    // the residual is read twice (moments, then the rows) from memory
    // rather than held: the accumulator takes the registers
    float dq[2];
    const bf16* xrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      dq[h] = ws && m < tokens ? dequant_step(amax[m / gtok]) : 0.f;
      xrow[h] = m < tokens ? x + xr(m, n) * ldx : nullptr;
    }
    auto value = [&](int q, int j, int h, int e) {
      const int col = kPiece * q + 8 * j + 2 * f.t + e;
      if (col >= c || !xrow[h]) return 0.f;
      const float a = static_cast<float>(acc[q][4 * j + 2 * h + e]);
      const float y =
          ws ? __fadd_rn(__fmul_rn(a, __fmul_rn(cs[c + col], dq[h])), cs[col])
             : a + cs[col];
      return tp::ldb(xrow[h] + col) + y;
    };
    float mu[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = value(q, j, h, e);
            s1 += v;
            s2 += v * v;
          }
      s1 = quad_sum(s1);
      s2 = quad_sum(s2);
      mu[h] = s1 / c;
      rs[h] = rsqrtf(fmaxf(s2 / c - mu[h] * mu[h], 0.f) + fastblk::kEps);
    }
    const int blk = r0 >> 4, pc = cdiv(c, kPiece);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      if (m >= tokens) continue;
      const float mr = __fmul_rn(mu[h], rs[h]);
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = kPiece * q + 8 * j + 2 * f.t;
          float v[2], nv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = value(q, j, h, e);
            nv[e] = col + e < c
                        ? __fsub_rn(__fmul_rn(v[e], rs[h]), mr)
                        : (col + e == c ? 1.f : 0.f);
          }
          if (kPiece * q + 8 * j < c)
            *reinterpret_cast<float2*>(x1 + x1_at(blk, pc, q, j, h, f.lane)) =
                make_float2(v[0], v[1]);
          if (x1n && col < kp)
            *reinterpret_cast<uint32_t*>(x1n + static_cast<size_t>(m) * kp +
                                         col) = fastblk::pack2(nv[0], nv[1]);
          if (x1q && col < kq) {
            const int8_t q0 = col < c ? quant8(nv[0], fastblk::kQX) : 0;
            const int8_t q1 = col + 1 < c ? quant8(nv[1], fastblk::kQX) : 0;
            *reinterpret_cast<uint16_t*>(x1q + static_cast<size_t>(m) * kq +
                                         col) =
                static_cast<uint16_t>(static_cast<uint8_t>(q0) |
                                      (static_cast<uint8_t>(q1) << 8));
          }
        }
      if (x1n)
        for (int o = kPiece * NT + f.t; o < kp; o += 4)
          x1n[static_cast<size_t>(m) * kp + o] =
              __float2bfloat16_rn(o == c ? 1.f : 0.f);
    }
  }
};

// fc1 of int8 'mlp': h1 = gelu_tanh(int32(acc) w1s + bf1) (f32) into
// (tokens, hidden) rows, and the amax of each scale group's h1 (its fc2
// input's dynamic scale). Constants: bf1, then w1s.
struct EpiFc1 {
  const float* bf1;  // (hidden)
  const float* w1s;  // (hidden)
  float* h1;         // (tokens, hidden)
  unsigned* amax;
  int gtok, tokens, hidden;
  __host__ __device__ int consts() const { return 2 * hidden; }
  __device__ void fill_consts(float* cs) const {
    const float *b = bf1, *w = w1s;
    const int hd = hidden;
    fill(cs, 2 * hd, [&](int i) { return i < hd ? b[i] : w[i - hd]; });
  }
  template <int NT, class Acc>
  __device__ void run(const Acc (&acc)[NT][32], int np, int m0, int n0,
                      const float* cs, char*) const {
    const Frag f = frag();
    const int r0 = m0 + f.r0;
    float mx = 0.f;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if (q >= np) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + kPiece * q + 8 * j + 2 * f.t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r0 + f.g + 8 * h;
          if (m >= tokens) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + e;
            v[e] = cc < hidden
                       ? fastblk::gelu_tanh(__fadd_rn(
                             __fmul_rn(static_cast<float>(
                                           acc[q][4 * j + 2 * h + e]),
                                       cs[hidden + cc]),
                             cs[cc]))
                       : 0.f;
            mx = fmaxf(mx, fabsf(v[e]));
          }
          float* dst = h1 + static_cast<size_t>(m) * hidden + col;
          if (col + 1 < hidden && (hidden & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            if (col < hidden) dst[0] = v[0];
            if (col + 1 < hidden) dst[1] = v[1];
          }
        }
      }
    }
    group_amax(mx, amax, r0, tokens, gtok);
  }
};

// fc2 of int8 'mlp': out = bf16(x1 + (int32(acc) (w2s dq) + bf2)) at row
// orow(m, n) of out (ldo a row, zeros in its columns [c, ldo)), dq the
// token's group step of h1. Constants: bf2 (f32), then w2s.
struct EpiFc2 {
  const bf16* bf2;    // (c)
  const float* w2s;   // (c)
  const float* x1;    // x1_floats(tokens, c), in x1_at's order
  const unsigned* amax;
  int gtok;
  bf16* out;
  tp::Rows orow;
  int ldo, n, tokens, c;
  __host__ __device__ int consts() const { return 2 * c; }
  __device__ void fill_consts(float* cs) const {
    const bf16* b = bf2;
    const float* w = w2s;
    const int cc = c;
    fill(cs, 2 * cc, [&](int i) {
      return i < cc ? __bfloat162float(b[i]) : w[i - cc];
    });
  }
  template <int NT, class Acc>
  __device__ void run(const Acc (&acc)[NT][32], int, int m0, int,
                      const float* cs, char*) const {
    const Frag f = frag();
    const int r0 = m0 + f.r0, blk = r0 >> 4, pc = cdiv(c, kPiece);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      if (m >= tokens) continue;
      const float dq = dequant_step(amax[m / gtok]);
      bf16* o = out + orow(m, n) * ldo;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = kPiece * q + 8 * j + 2 * f.t;
          if (col >= c) continue;
          const float2 xv = *reinterpret_cast<const float2*>(
              x1 + x1_at(blk, pc, q, j, h, f.lane));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= c) continue;
            const float a = static_cast<float>(acc[q][4 * j + 2 * h + e]);
            const float y = __fadd_rn(
                __fmul_rn(a, __fmul_rn(cs[c + col + e], dq)), cs[col + e]);
            o[col + e] = __float2bfloat16_rn((e ? xv.y : xv.x) + y);
          }
        }
      for (int col = c + f.t; col < ldo; col += 4)
        o[col] = __float2bfloat16_rn(0.f);
    }
  }
};

// ------------------------------------------------------------ kernels

// C (M, N) = A (M, K) B (N, K)^T: the A tile from map a, the weights from
// map b in passes of 64 NT columns, each epilogued from the registers.
template <class Epi>
struct alignas(64) GemmP {
  CUtensorMap a, b;
  Sched s;
  int n;    // output columns
  int kel;  // elements of a K slice (64 bf16, 128 int8)
  Epi epi;
};

template <int NT, bool kS8, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ GemmP<Epi> p) {
  using Acc = typename std::conditional<kS8, int, float>::type;
  extern __shared__ __align__(1024) char smem[];
  const Lay L = lay(smem, p.s);
  const int nwg = (blockDim.x >> 7) - 1;
  const int wg = wbody::warpgroup();
  if (threadIdx.x == 0) init_bars(L, 4 * nwg);
  p.epi.fill_consts(L.cs);
  __syncthreads();
  constexpr int chunk = kPiece * NT;
  if (wg == nwg) {  // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x == nwg * 128) {
      int it = 0, seq = 0;
      for (int tile = blockIdx.x; tile < p.s.tiles;
           tile += gridDim.x, ++it) {
        put_a(L, p.s, &p.a, p.kel, tile, it);
        for (int n0 = 0; n0 < p.n; n0 += chunk)
          for (int k = 0; k < p.s.nks; ++k) {
            const int slot = put(L, seq++, NT * kPieceBytes);
            tma_load(L.slot(slot), &p.b, k * p.kel, n0, L.full(slot));
          }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  int it = 0, seq = 0;
  for (int tile = blockIdx.x; tile < p.s.tiles; tile += gridDim.x, ++it) {
    const int b = it % p.s.na;
    mbar_wait(L.afull(b), (it / p.s.na) & 1);
    const uint32_t a0 = L.a(b) + wg * kPieceBytes;
    for (int n0 = 0; n0 < p.n; n0 += chunk) {
      const int np = cdiv(p.n - n0, kPiece);
      Acc acc[NT][32];
      for (int k = 0; k < p.s.nks; ++k) {
        const uint32_t bs = take(L, seq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * k + kk < p.s.ksteps) {
            const uint64_t da = desc(a0 + k * p.s.bm * kSlice + 32 * kk);
#pragma unroll
            for (int q = 0; q < NT; ++q)
              if (q < np)
                mma(acc[q], da, desc(bs + q * kPieceBytes + 32 * kk),
                    k + kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int q = 0; q < NT; ++q) fence_acc(acc[q]);
        give(L, seq++);
      }
      if (n0 + chunk >= p.n && (threadIdx.x & 31) == 0)
        mbar_arrive(L.aempty(b));
      p.epi.template run<NT>(acc, np, tile * p.s.bm + 64 * wg, n0, L.cs,
                             warp_stage(L));
    }
  }
}

// fc1 + tanh GELU + fc2 + residual: per tile, for each 64 hidden columns
// j, h_j = bf16(gelu_tanh(x1n W1_j^T + bf1)) (zeros past hidden) into the
// hidden slice, then acc += h_j W2[:, j]^T; out = bf16(x1 + (acc + bf2) f)
// at row orow(m, n) of out (ldo a row, zeros in its columns [c, ldo)); f =
// dpf[2 m + 1], the MLP branch's stochastic-depth factor, or 1.
struct MlpEpi {
  const float* bf1;  // (hidden)
  const float* x1;   // x1_floats(tokens, c), in x1_at's order
  const bf16* bf2;   // (c)
  bf16* out;
  tp::Rows orow;
  int ldo, n, tokens, c, hidden;
  const float* dpf = nullptr;  // (tokens, 2) factor columns [attn, mlp]
  // constants: bf1, then bf2 (f32)
  __host__ __device__ int consts() const { return hidden + c; }
  __device__ void fill_consts(float* cs) const {
    const int hd = hidden;
    const float* b1 = bf1;
    const bf16* b2 = bf2;
    fill(cs, hidden + c, [&](int i) {
      return i < hd ? b1[i] : __bfloat162float(b2[i - hd]);
    });
  }
};

struct alignas(64) MlpP {
  CUtensorMap a, w1, w2;
  Sched s;
  int chunks;  // 64-column slices of the hidden width
  MlpEpi e;
};

// One 64-column slice of fc1: hacc = x1n W1_j^T over the A tile's K.
__device__ __forceinline__ void fc1_slice(float (&hacc)[32], uint32_t a0,
                                          uint32_t w1, const Sched& s) {
  wgmma_fence();
  for (int k = 0; k < s.nks; ++k) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (4 * k + kk < s.ksteps)
        mma(hacc, desc(a0 + k * s.bm * kSlice + 32 * kk),
            desc(w1 + k * kPieceBytes + 32 * kk), k + kk > 0);
  }
  wgmma_commit();
}

// bf16(gelu_tanh(hacc + bf1)) of hidden columns 64 j.. (zeros past
// hidden) into the warpgroup's hidden rows, slice j, in the swizzled
// order wgmma reads: 16-byte chunk jj of row r at chunk jj ^ (r & 7)
__device__ __forceinline__ void gelu_slice(const float (&hacc)[32], int j,
                                           char* hj, const float* bf1,
                                           int hidden, const Frag& f) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 64 * j + 8 * jj + 2 * f.t;
    const float b0 = col < hidden ? bf1[col] : 0.f;
    const float b1 = col + 1 < hidden ? bf1[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.r0 + f.g + 8 * h;
      const float v0 =
          col < hidden ? fastblk::gelu_tanh(hacc[4 * jj + 2 * h] + b0) : 0.f;
      const float v1 = col + 1 < hidden
                           ? fastblk::gelu_tanh(hacc[4 * jj + 2 * h + 1] + b1)
                           : 0.f;
      *reinterpret_cast<uint32_t*>(hj + (r >> 3) * 1024 + f.g * 128 +
                                   ((jj ^ f.g) << 4) + 4 * f.t) =
          fastblk::pack2(v0, v1);
    }
  }
}

// The tile in two phases. fc1: each 64-column slice of the hidden rows
// goes through the GELU into shared memory while the tensor cores run the
// next slice's products (two fc1 accumulators take turns; the caller
// unrolls by two so that each has fixed registers); then the A tile goes
// back to the producer, which loads the next tile's rows during fc2. fc2:
// acc = h W2^T over K = hidden from the hidden rows in shared memory, as
// the GEMM kernel's main loop. The ring carries W1's slices, then W2's.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_kernel(const __grid_constant__ MlpP p) {
  extern __shared__ __align__(1024) char smem[];
  const Lay L = lay(smem, p.s);
  const int nwg = (blockDim.x >> 7) - 1;
  const int wg = wbody::warpgroup();
  if (threadIdx.x == 0) init_bars(L, 4 * nwg);
  p.e.fill_consts(L.cs);
  __syncthreads();
  if (wg == nwg) {  // the producer: A, W1's slices, W2's slices
    regs_dec<kProducerRegs>();
    if (threadIdx.x == nwg * 128) {
      int it = 0, seq = 0;
      for (int tile = blockIdx.x; tile < p.s.tiles;
           tile += gridDim.x, ++it) {
        put_a(L, p.s, &p.a, 64, tile, it);
        for (int j = 0; j < p.chunks; ++j) {
          const int slot = put(L, seq++, p.s.nks * kPieceBytes);
          for (int k = 0; k < p.s.nks; ++k)
            tma_load(L.slot(slot) + k * kPieceBytes, &p.w1, 64 * k, 64 * j,
                     L.full(slot));
        }
        for (int j = 0; j < p.chunks; ++j) {
          const int slot = put(L, seq++, NT * kPieceBytes);
          tma_load(L.slot(slot), &p.w2, 64 * j, 0, L.full(slot));
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  const MlpEpi& e = p.e;
  const Frag f = frag();
  const int n = p.chunks;
  // slice j of this warpgroup's hidden rows
  auto hrows = [&](int j) { return (j * nwg + wg) * kPieceBytes; };
  int it = 0, seq = 0;
  for (int tile = blockIdx.x; tile < p.s.tiles; tile += gridDim.x, ++it) {
    const int b = it % p.s.na;
    mbar_wait(L.afull(b), (it / p.s.na) & 1);
    const uint32_t a0 = L.a(b) + wg * kPieceBytes;
    const int m0 = tile * p.s.bm + 64 * wg;
    {  // fc1 + GELU, slice by slice
      float ha[32], hb[32];
      fc1_slice(ha, a0, take(L, seq), p.s);
      auto step = [&](int j, float (&cur)[32], float (&nxt)[32]) {
        if (j + 1 < n) {
          fc1_slice(nxt, a0, take(L, seq + j + 1), p.s);
          wbody::wgmma_wait1();  // all but slice j + 1's products
        } else {
          wgmma_wait0();
        }
        fence_acc(cur);
        give(L, seq + j);
        gelu_slice(cur, j, L.hp + hrows(j), L.cs, e.hidden, f);
      };
      for (int j = 0; j < n; j += 2) {
        step(j, ha, hb);
        if (j + 1 < n) step(j + 1, hb, ha);
      }
      seq += n;
    }
    if ((threadIdx.x & 31) == 0) mbar_arrive(L.aempty(b));
    fence_async_smem();
    wbody::wg_sync(wg);
    // fc2 over the hidden rows
    float acc[NT][32];
    for (int j = 0; j < n; ++j) {
      const uint32_t w2 = take(L, seq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (64 * j + 16 * kk < e.hidden) {
          const uint64_t da = desc(L.h + hrows(j) + 32 * kk);
#pragma unroll
          for (int q = 0; q < NT; ++q)
            mma(acc[q], da, desc(w2 + q * kPieceBytes + 32 * kk), j + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int q = 0; q < NT; ++q) fence_acc(acc[q]);
      give(L, seq++);
    }
    // out = bf16(x1 + (acc + bf2)), zeros in the row's pad, through this
    // warp's rows of the hidden slice (every fc2 product has read them)
    // where the stride allows
    const float* bf2 = L.cs + e.hidden;
    const int r0 = m0 + f.r0, blk = r0 >> 4, pc = cdiv(e.c, kPiece);
    float fm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + f.g + 8 * h;
      fm[h] = e.dpf && m < e.tokens
                  ? __ldg(e.dpf + 2 * static_cast<size_t>(m) + 1)
                  : 1.f;
    }
    auto value = [&](int q, int j, int h) {
      const int m = r0 + f.g + 8 * h, col = kPiece * q + 8 * j + 2 * f.t;
      float2 x = make_float2(0.f, 0.f);
      if (m < e.tokens && kPiece * q + 8 * j < e.c)
        x = __ldg(reinterpret_cast<const float2*>(
            e.x1 + x1_at(blk, pc, q, j, h, f.lane)));
      return make_float2(
          col < e.c ? x.x + (acc[q][4 * j + 2 * h] + bf2[col]) * fm[h] : 0.f,
          col + 1 < e.c
              ? x.y + (acc[q][4 * j + 2 * h + 1] + bf2[col + 1]) * fm[h]
              : 0.f);
    };
    const int vb = vec_bytes(e.out, e.ldo);
    if (vb) {
      char* st = warp_stage(L);
      // the rows this lane stores, found once: element offsets or -1
      long long ooff[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = r0 + (vb == 16 ? vec_row<16>(f.lane, i & 3)
                                     : vec_row<8>(f.lane, i));
        ooff[i] = i < 16 * 128 / vb / 32 && m < e.tokens
                      ? static_cast<long long>(e.orow(m, e.n)) * e.ldo
                      : -1;
      }
#pragma unroll
      for (int q = 0; q < NT; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 v = value(q, j, h);
            *stage_pair(st, f.g + 8 * h, 8 * j + 2 * f.t) =
                fastblk::pack2(v.x, v.y);
          }
        auto dst = [&](int i, int) -> bf16* {
          return ooff[i] >= 0 ? e.out + ooff[i] + kPiece * q : nullptr;
        };
        if (vb == 16)
          stage_out<16>(st, f.lane, dst, e.ldo - kPiece * q);
        else
          stage_out<8>(st, f.lane, dst, e.ldo - kPiece * q);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + f.g + 8 * h;
        if (m < e.tokens)
          for (int col = kPiece * NT + f.t; col < e.ldo; col += 4)
            e.out[e.orow(m, e.n) * e.ldo + col] = __float2bfloat16_rn(0.f);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + f.g + 8 * h;
        if (m >= e.tokens) continue;
        bf16* o = e.out + e.orow(m, e.n) * e.ldo;
#pragma unroll
        for (int q = 0; q < NT; ++q)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = kPiece * q + 8 * j + 2 * f.t;
            if (col >= e.c) continue;
            const float2 v = value(q, j, h);
            o[col] = __float2bfloat16_rn(v.x);
            if (col + 1 < e.c) o[col + 1] = __float2bfloat16_rn(v.y);
          }
        for (int col = e.c + f.t; col < e.ldo; col += 4)
          o[col] = __float2bfloat16_rn(0.f);
      }
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's encoder, found once through the runtime
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A K-major operand as a tensor map: `rows` rows of k elements (esize
// bytes: 1 int8, 2 bf16) at a stride of ld elements; boxes of one 128-byte
// slice by box_rows rows, 128-byte swizzle, zeros outside the k x rows.
inline cudaError_t make_map(CUtensorMap* m, const void* base, int esize,
                            int k, int ld, int rows, int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlice / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(
      m,
      esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev])
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

#define TOKWG_CHECK(expr)             \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// one persistent launch: min(tiles, SMs) blocks of bm / 64 consumer
// warpgroups and the producer warp
template <class Kernel, class P>
inline cudaError_t launch(Kernel kernel, const P& p, cudaStream_t s) {
  if (p.s.nslots < 2) return cudaErrorInvalidValue;
  const int smem = smem_bytes(p.s);
  TOKWG_CHECK(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (p.s.tiles == 0) return cudaSuccess;
  const int sms = sm_count();
  const int grid = p.s.tiles < sms ? p.s.tiles : sms;
  kernel<<<grid, (p.s.bm / 64 + 1) * 128, smem, s>>>(p);
  return cudaGetLastError();
}

// the int8 product's epilogue, a type of its own so that its kernel has a
// name of its own
struct EpiQkvS8 : EpiQkv {};

// A launch's tile rows: bm where the caller names it (64 or 128: the
// measurements of each height), else tile_rows's.
inline int pick_rows(int m, int bm) {
  return bm ? bm : tile_rows(m, sm_count());
}

template <bool kS8, class Epi>
inline cudaError_t qkv_es(const void* a, const void* w, int ld, int c,
                          const Epi& epi, int bm, cudaStream_t s) {
  constexpr int es = kS8 ? 1 : 2;
  GemmP<Epi> p;
  p.s = sched(epi.tokens, pick_rows(epi.tokens, bm), c * es,
              kQkvPieces * kPieceBytes, epi.consts());
  p.n = epi.n3;
  p.kel = kSlice / es;
  p.epi = epi;
  TOKWG_CHECK(make_map(&p.a, a, es, c, ld, epi.tokens, p.s.bm));
  TOKWG_CHECK(make_map(&p.b, w, es, c, ld, epi.n3, kPiece * kQkvPieces));
  return launch(gemm_kernel<kQkvPieces, kS8, Epi>, p, s);
}

// The qkv product: int8 rows (tokens, ld) [m][k] and weights wq (n3, ld)
// when epi.ws is set (the steps), else bf16 rows and weights (n3, ld);
// K = c; q/k/v by head into qkv (tokens, n3). bm: pick_rows's.
inline cudaError_t qkv(const void* a, const void* w, int ld, int c,
                       const EpiQkv& epi, cudaStream_t s, int bm = 0) {
  if (epi.ws) return qkv_es<true>(a, w, ld, c, EpiQkvS8{epi}, bm, s);
  return qkv_es<false>(a, w, ld, c, epi, bm, s);
}

// A GEMM whose epilogue spans a row: N <= 256 in one pass of NT pieces;
// bf16 operands (kEs 2) or int8 (kEs 1, wgmma .s8).
template <class Epi, int NT, int kEs = 2>
inline cudaError_t rows_nt(GemmP<Epi>& p, const void* w, int ldw, int k,
                           cudaStream_t s) {
  TOKWG_CHECK(make_map(&p.b, w, kEs, k, ldw, p.n, kPiece * NT));
  return launch(gemm_kernel<NT, kEs == 1, Epi>, p, s);
}

template <class Epi, int kMaxNt, int kEs = 2>
inline cudaError_t rows(const void* a, int lda, const void* w, int ldw,
                        int tokens, int n, int k, const Epi& epi,
                        cudaStream_t s, int bm = 0) {
  const int nt = cdiv(n, kPiece);
  if (nt > kMaxNt) return cudaErrorInvalidValue;
  GemmP<Epi> p;
  p.s = sched(tokens, pick_rows(tokens, bm), kEs * k, nt * kPieceBytes,
              epi.consts());
  p.n = n;
  p.kel = kSlice / kEs;
  p.epi = epi;
  TOKWG_CHECK(make_map(&p.a, a, kEs, k, lda, tokens, p.s.bm));
  switch (nt) {
    case 1: return rows_nt<Epi, 1, kEs>(p, w, ldw, k, s);
    case 2: return rows_nt<Epi, 2, kEs>(p, w, ldw, k, s);
    case 3: return rows_nt<Epi, 3, kEs>(p, w, ldw, k, s);
    case 4: return rows_nt<Epi, kMaxNt < 4 ? 3 : 4, kEs>(p, w, ldw, k, s);
  }
  return cudaErrorInvalidValue;
}

// The projection + residual + LN2: ao (tokens, kp) bf16, wproj (kp, kp)
// [n][k]; K = N = c. bm: pick_rows's.
inline cudaError_t proj_ln(const bf16* ao, const bf16* wproj,
                           const EpiProjLn& epi, cudaStream_t s,
                           int bm = 0) {
  return rows<EpiProjLn, 3>(ao, epi.kp, wproj, epi.kp, epi.tokens, epi.c,
                            epi.c, epi, s, bm);
}

// The adapter: z (tokens, ldz) bf16, w (growth, ldz) [n][k]; K = c.
inline cudaError_t adapter(const bf16* z, int ldz, const bf16* w, int c,
                           const EpiAdapter& epi, cudaStream_t s) {
  return rows<EpiAdapter, 4>(z, ldz, w, ldz, epi.tokens, epi.growth, c, epi,
                             s);
}

template <int NT>
inline cudaError_t mlp_nt(MlpP& p, const bf16* w2, int hp, cudaStream_t s) {
  TOKWG_CHECK(make_map(&p.w2, w2, 2, p.e.hidden, hp, p.e.c, kPiece * NT));
  return launch(mlp_kernel<NT>, p, s);
}

// fc1 + GELU + fc2 + residual: x1n (tokens, kp) bf16, w1 (hp, kp) and w2
// (kp, hp) [n][k]; K = c for fc1, hidden for fc2. bm: pick_rows's.
inline cudaError_t mlp(const bf16* x1n, int kp, const bf16* w1,
                       const bf16* w2, int hp, const MlpEpi& e,
                       cudaStream_t s, int bm = 0) {
  const int nt = cdiv(e.c, kPiece), nks = cdiv(2 * e.c, kSlice);
  if (nt > 3) return cudaErrorInvalidValue;
  MlpP p;
  p.chunks = cdiv(e.hidden, kPiece);
  const int slot = (nks > nt ? nks : nt) * kPieceBytes;
  p.s = sched(e.tokens, pick_rows(e.tokens, bm), 2 * e.c, slot, e.consts(),
              p.chunks, 1);
  if (p.s.nslots < 2)  // the hidden rows of 128 do not fit: 64 a tile
    p.s = sched(e.tokens, 64, 2 * e.c, slot, e.consts(), p.chunks, 1);
  p.e = e;
  TOKWG_CHECK(make_map(&p.a, x1n, 2, e.c, kp, e.tokens, p.s.bm));
  TOKWG_CHECK(make_map(&p.w1, w1, 2, e.c, kp, e.hidden, kPiece));
  switch (nt) {
    case 1: return mlp_nt<1>(p, w2, hp, s);
    case 2: return mlp_nt<2>(p, w2, hp, s);
    case 3: return mlp_nt<3>(p, w2, hp, s);
  }
  return cudaErrorInvalidValue;
}

// The projection with int8 operands in either place (EpiProjLnQ): int8
// 'proj', the int8 rows of the attention output a (tokens, lda) and wpq
// (c, lda) [n][k]; else bf16 rows and wproj (kp, kp). K = N = c.
inline cudaError_t proj_ln_q(const void* a, int lda, const void* w,
                             const EpiProjLnQ& epi, cudaStream_t s,
                             int bm = 0) {
  if (epi.ws)
    return rows<EpiProjLnQ, 3, 1>(a, lda, w, lda, epi.tokens, epi.c, epi.c,
                                  epi, s, bm);
  return rows<EpiProjLnQ, 3, 2>(a, lda, w, lda, epi.tokens, epi.c, epi.c,
                                epi, s, bm);
}

// fc1 of int8 'mlp': x1q (tokens, kq) and w1q (hidden, kq) [n][k] int8; K
// = c; the hidden columns in passes of kQkvPieces pieces.
inline cudaError_t fc1_s8(const int8_t* x1q, int kq, const int8_t* w1q,
                          int c, const EpiFc1& epi, cudaStream_t s,
                          int bm = 0) {
  GemmP<EpiFc1> p;
  p.s = sched(epi.tokens, pick_rows(epi.tokens, bm), c,
              kQkvPieces * kPieceBytes, epi.consts());
  p.n = epi.hidden;
  p.kel = kSlice;
  p.epi = epi;
  TOKWG_CHECK(make_map(&p.a, x1q, 1, c, kq, epi.tokens, p.s.bm));
  TOKWG_CHECK(make_map(&p.b, w1q, 1, c, kq, epi.hidden, kPiece * kQkvPieces));
  return launch(gemm_kernel<kQkvPieces, true, EpiFc1>, p, s);
}

// fc2 of int8 'mlp': h1q (tokens, kh) and w2q (c, kh) [n][k] int8; K =
// hidden, N = c.
inline cudaError_t fc2_s8(const int8_t* h1q, int kh, const int8_t* w2q,
                          int hidden, const EpiFc2& epi, cudaStream_t s,
                          int bm = 0) {
  return rows<EpiFc2, 3, 1>(h1q, kh, w2q, kh, epi.tokens, epi.c, hidden, epi,
                            s, bm);
}

#undef TOKWG_CHECK

}  // namespace tokwg
