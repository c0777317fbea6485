// Kernels B5 and B6: the block-sparse LIF reservoir with streaming spike
// statistics on Hopper (sm_90a), one stream-tiled tensor-core body.
//
// B5 (chunk = false) replaces lsm_tpu/ops/pallas/sparse_lif_kernel.py:54
// _sparse_lif_kernel: T steps from a zero state, windowed-rate moments and
// all_counts. B6 (chunk = true) replaces
// lsm_tpu/ops/pallas/sparse_lif_chunk_kernel.py:36 _sparse_chunk_kernel: one
// continuous-mode chunk with v, refrac and the spike vector carried in and
// out, a segment summary with segment-relative times and per-window counts.
// Per step t, for destination block j (neurons 128 j .. 128 j + 127):
//
//     drive_j = sum_s s_prev[block src_idx[j, s]] . bf16(W[j, s])
//               + x_t . bf16(W_in[:, block j])               (f32 accumulate)
//
// then the dense kernel's update (lif.cu): v = refrac == 0 ? v (1 - leak) +
// drive : 0, spike = refrac == 0 && v >= threshold, reset and refractory.
// Slots that name the same source block are summed, not merged: a partner
// permutation can coincide with a band block (lsm_tpu/models/sparse.py).
// The same body runs the dense reservoir above 1024 padded neurons (B2, B4
// in lif.cu) with the (N, N) matrix seen as nb x nb blocks.
//
// What bounds it on an H100. The TPU kernel took a tile of streams and did
// each step as MXU products of the tile's spike plane with each 128 x 128
// weight block, so a block was read once per tile, not once per stream. Here
// the same products run on the tensor cores: per (tile of M streams, block
// j, step) 2 M 128 128 K bf16 operations, K = S + ceil(C / 128) slots (at
// B = 2400 and 10240 neurons 88 GFLOP a step, 89 us at the 989 TFLOP/s
// dense peak). Each tile reads each slot's 32 KB block (680 MB a step at
// B = 2400, from L2: ~100 us a step with nothing else running,
// tools/block_split.py), and the carried state, 5 bytes a (stream, neuron),
// is read and written each step (246 MB at B = 2400: 73 us at 3.35 TB/s).
// The three can overlap; a step that runs them one after the other takes
// their sum. Every destination block reads R random partner blocks, so step
// t + 1 waits for all of step t.
//
// Design. One kernel launch per step, enqueued by the C entry point (T
// launches a call, none from Python); v (f32), refrac (8 bits up to
// refractory 255, else 16: picked at launch) and two bit-packed spike
// planes (B, N / 32) live in global scratch between steps, which the
// wrapper allocates. Each call first copies every slot's weight block into
// that scratch, the input projection's 128-channel slices as more slots
// (x_t . W_in[:, block j] is one more K-slice, as on the TPU), K-major and
// already in the byte order of wgmma's 128-byte swizzle, so a block lands in
// shared memory by one TMA bulk copy; any stride or alignment of the
// caller's weights will do. The work of a step is its items (tile of M = 64
// or 128 streams, destination block j); one persistent CTA an SM walks them,
// and its warps specialize:
//   - a producer warp streams each item's K weight blocks and the tile's
//     spike bits of each slot's source block through a four-stage ring in
//     shared memory (the blocks by TMA bulk copy, the bits by cp.async), each
//     stage counted by a full and an empty mbarrier, running ahead of the
//     consumers over item boundaries;
//   - M / 64 consumer warpgroups: for each slot, the A operand built in
//     registers from the tile's bits (two bits to a pair of bf16 0/1, in the
//     m16n8k16 register layout), eight wgmma.m64n128k16 (bf16 in, f32 out, a
//     64 x 128 f32 accumulator of 64 registers a thread) on the stage, one
//     commit group, and the stage released through its empty barrier; no
//     CTA-wide barrier in the loop. An item's accumulators then go to a stash
//     in shared memory;
//   - two update warpgroups apply the stashed item's membrane update while
//     the consumers run the next item's products, so the state's traffic
//     overlaps the tensor cores instead of following them: per (stream,
//     neuron) in the accumulator's layout, the product and the sum rounded
//     separately (__fmul_rn, __fadd_rn) as the plain twin rounds them; v,
//     refrac, the step's spike words (one per row, OR-reduced over a quad)
//     and, for output blocks, the output raster are written; B5's all_counts
//     takes its whole counts by reductions that return nothing.
// The host's plan (ops/kernels/sparse_lif.py `block_plan`) picks M: 128 when
// a step still has two tiles for every SM, else 64. Rows past B read nothing
// and write nothing. After the last step one thread per (stream, output
// neuron) replays the raster through OutputStats (B5's window fold, B6's
// per-window counts). Each (stream, neuron) has one owner and the slot and
// k16 order is fixed, so results are deterministic; on dyadic weights every
// partial sum is exact in f32 and the bits are the twin's.
//
// Limits: N a multiple of 128, T > 0 and refractory <= 65535 (the 16-bit
// counter); no limit on N, C or the outputs from shared memory, which holds
// the ring, the bits and one stash (201 KB at M = 128: one CTA an SM). At 96
// registers a thread (544 threads) ptxas serializes the eight wgmma of a
// slot; the two consumer warpgroups interleave theirs.

#include <type_traits>

#include "lif_common.cuh"

// A step's split (ROADMAP E11; tools/block_split.py builds these): 0 is the
// kernel; 1 runs no products, 2 moves no state (the update neither reads nor
// writes v and refrac), 3 loads no weight blocks (the ring stays zero), 4 is
// 1 and 2 together, 5 loads neither blocks nor bits and waits for no stage;
// 6 is the kernel with clock64 stamps (lsm_block_stamps). Only 0 and 6 are
// right.
#ifndef LSM_BLOCK_SPLIT
#define LSM_BLOCK_SPLIT 0
#endif

namespace lsm {
namespace {

constexpr int kSplit = LSM_BLOCK_SPLIT;
constexpr bool kStamps = kSplit == 6;
constexpr bool kProducts = kSplit != 1 && kSplit != 4;
constexpr bool kMove = kSplit != 2 && kSplit != 4;      // the state is read and written
#if LSM_BLOCK_SPLIT == 6
// Per CTA of the last launch: a consumer's cycles waiting for stages, in
// products and in all, the update warpgroups' cycles waiting for a stash,
// the producer's cycles waiting for free stages and in all, items, and a
// consumer's cycles waiting for the stash to be free.
__device__ long long g_stamps[4096][8];
#endif

constexpr int kBlock = 128;                     // neurons a block
constexpr int kTileBytes = kBlock * kBlock * 2; // one 128 x 128 bf16 block
constexpr int kStages = 4;                      // weight blocks in the ring
constexpr int kUpdaters = 256;                  // threads of the two update warpgroups

size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// Input slices per step: ceil(C / 128) blocks of 128 channels.
int in_slices(int C) { return (C + kBlock - 1) / kBlock; }

// A CTA's shared memory past its 1024-byte alignment: the ring of weight
// blocks, the ring of the tile's spike bits (16 bytes a row), the stash of
// a tile's accumulators (value i of consumer thread t at [i][t]), then the
// barriers full[stage], empty[stage], stash_full and stash_free. 201 KB at
// M = 128: one CTA an SM.
template <int M>
struct Smem {
  static constexpr size_t kBitsAt = (size_t)kStages * kTileBytes;
  static constexpr size_t kStash = kBitsAt + (size_t)kStages * M * 16;
  static constexpr size_t kBars = kStash + (size_t)64 * 2 * M * 4;
  static constexpr size_t kBytes = kBars + (2 * kStages + 2) * 8 + 1024;
};

// Global scratch, in order: the weight blocks (nb, S + n_in, 32 KB) of every
// slot, pre-swizzled (the input projection's blocks after the recurrent
// ones), two spike planes (B, N/32), the input bits (T, B, 4 n_in), the
// output raster (T, B, ceil(no/32)), refrac (B, N) of rbytes each and, for
// B5, v (B, N) f32 (B6 keeps v in v_out).
struct Layout {
  size_t wt, plane, xbits, raster, refrac, v, total;
};

Layout layout(int B, int C, int T, int N, int S, int no, bool chunk, int rbytes) {
  Layout l{};
  const size_t b = B, nb = N / kBlock, wn = N / 32, n_in = in_slices(C), now = (no + 31) / 32;
  l.wt = 0;
  l.plane = l.wt + align256(nb * (S + n_in) * kTileBytes);
  l.xbits = l.plane + align256(2 * b * wn * 4);
  l.raster = l.xbits + align256((size_t)T * b * 4 * n_in * 4);
  l.refrac = l.raster + align256((size_t)T * b * now * 4);
  l.v = l.refrac + align256(b * N * rbytes);
  l.total = l.v + (chunk ? 0 : align256(b * N * 4));
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (lanes 8 c .. 8 c + 7 along K) of row r in
// a K-major tile of `rows` rows and 128 K lanes, as wgmma's 128-byte swizzle
// lays it out: two 64-lane halves of `rows` x 128 bytes, 8-row atoms of
// 1024 bytes, the chunk XOR-ed with the row within the atom.
__device__ __forceinline__ int sw128(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + (r >> 3) * 1024 + (r & 7) * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major 128-byte-swizzled tile:
// start address, leading offset 1 (unused with this swizzle), stride 1024
// bytes between 8-row atoms, swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// ---- barriers and bulk copies -----------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// The one arrival of the barrier's phase, which then waits for `bytes`.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// past ~10 s of SM clock traps: a lost arrival or copy becomes a launch
// error, not a card that never finishes the step.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// One arrival on the barrier.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// 16 bytes from global `src` into shared memory at `dst`, or 16 zero bytes
// where `valid` is false (then nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// `bytes` from global `src` into this CTA's shared memory at `dst`, counted
// by the barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- the tensor cores ----------------------------------------------------------

// d (64 f32 a thread) += A (64 x 16, four bf16 pairs a thread in mma.sync's
// m16n8k16 A layout, 16 rows a warp) . B (16 x 128, K-major in shared memory,
// read through its descriptor). Asynchronous: a and d stay untouched until
// wgmma.wait_group (see fence_operand).
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Keep the compiler from moving or reusing registers that an in-flight
// wgmma reads or writes (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Two spikes (bits 0 and 1 of y) as a pair of bf16 0/1 (1.0 = 0x3F80).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t y) {
  return (y & 1u) * 0x3F80u | (y & 2u) * 0x1FC00000u;
}

struct StepArgs {
  const uint32_t* rd;        // (B, N/32) spike bits of step t - 1
  uint32_t* wr;              // (B, N/32) spike bits of step t
  const uint32_t* xb;        // (B, 4 n_in) input bits of step t
  uint32_t* raster;          // (B, no_w) output-neuron bits of step t
  float* v;                  // (B, N)
  void* refrac;              // (B, N) of R
  float* all_counts;         // B5: (B, N); B6: nullptr
  const uint16_t* wt;        // (nb, S + n_in) pre-swizzled 32 KB blocks
  const int* src_idx;        // (nb, S) or nullptr (slot s reads block s)
  const float* leak_keep;
  int B, N, S, n_in, no_w, refractory;
  int tiles;                 // stream tiles: ceil(B / M)
  float thr;
};

// Word wj (lanes 32 wj .. + 32) of the membrane update of the tile at row0
// and block j, for consumer thread ct, from the tile's accumulators in the
// stash: acc[4 c + 2 h + e] is row r0 + 8 h, lane 8 c + 2 q + e of block j.
// The state of both rows (four chunks each) is loaded in one batch, then
// updated and stored; each row's spike bits are OR-ed over the quad and
// written by its first lane. Run by a warp whose lanes are ct's.
template <int M, typename R>
__device__ __forceinline__ void update_word(const StepArgs& a, const float* stash, int j,
                                            int row0, int wj, int ct) {
  // Two neighbours' counters in one load and store.
  using Pair = typename std::conditional<sizeof(R) == 1, uint16_t, uint32_t>::type;
  constexpr int kBits = 8 * sizeof(R);
  constexpr unsigned kMask = (1u << kBits) - 1u;
  R* const refrac_s = static_cast<R*>(a.refrac);
  const int lane = ct & 31, warp = ct >> 5, g = lane >> 2, q = lane & 3;
  const int wpr = a.N >> 5;
  const int r0 = row0 + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const size_t rows[2] = {(size_t)r0 * a.N, (size_t)(r0 + 8) * a.N};
  const bool oks[2] = {r0 < a.B, r0 + 8 < a.B};
  const int n0 = j * kBlock + wj * 32 + 2 * q;
  float2 vv[2][4], lk[4];
  unsigned rr[2][4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    lk[t] = *reinterpret_cast<const float2*>(a.leak_keep + n0 + 8 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = rows[h] + n0 + 8 * t;
      const bool rd = oks[h] && kMove;
      vv[h][t] = rd ? *reinterpret_cast<const float2*>(a.v + at) : make_float2(0.f, 0.f);
      rr[h][t] = rd ? *reinterpret_cast<const Pair*>(refrac_s + at) : 0u;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const size_t at = rows[h] + n0 + 8 * t;
      float vo[2];
      unsigned ro = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float drive = stash[(4 * (4 * wj + t) + 2 * h + e) * (2 * M) + ct];
        const int refrac = (rr[h][t] >> (kBits * e)) & kMask;
        const bool active = refrac == 0;
        // No FMA contraction: the plain twin rounds the product and the sum.
        const float v_new =
            active ? __fadd_rn(__fmul_rn(e ? vv[h][t].y : vv[h][t].x, e ? lk[t].y : lk[t].x), drive)
                   : 0.f;
        const bool spike = active && v_new >= a.thr;
        vo[e] = spike ? 0.f : v_new;
        ro |= static_cast<unsigned>(spike ? a.refractory : max(refrac - 1, 0)) << (kBits * e);
        if (spike) {
          word |= 1u << (t * 8 + 2 * q + e);
          // One owner per (stream, neuron) a step and whole counts: the sum
          // is exact, so a reduction that returns nothing will do.
          if (oks[h] && a.all_counts) atomicAdd(a.all_counts + at + e, 1.f);
        }
      }
      if (oks[h] && kMove) {
        *reinterpret_cast<float2*>(a.v + at) = make_float2(vo[0], vo[1]);
        *reinterpret_cast<Pair*>(refrac_s + at) = static_cast<Pair>(ro);
      }
    }
    word |= __shfl_xor_sync(0xffffffffu, word, 1);
    word |= __shfl_xor_sync(0xffffffffu, word, 2);
    const int b = r0 + 8 * h, w_at = j * 4 + wj;
    if (oks[h] && q == 0) {
      a.wr[(size_t)b * wpr + w_at] = word;
      if (w_at < a.no_w) a.raster[(size_t)b * a.no_w + w_at] = word;
    }
  }
}

// One step. A work item is (tile of M streams, destination block j); the
// CTAs, one an SM, walk the items tile fastest: item blockIdx.x, then
// + gridDim.x, ... Each CTA has three kinds of warp, each with its own loop
// over the CTA's items:
//   - warps 0 .. M / 16 - 1, the consumer warpgroups: warpgroup wg owns rows
//     64 wg .. + 64 of a tile and all 128 lanes; its warp w rows
//     64 wg + 16 w .. + 16, and each thread the two rows g and g + 8 of its
//     warp's 16. They run an item's products and put its accumulators in
//     the stash;
//   - the next eight warps, the update warpgroups: the stashed item's
//     membrane update, while the consumers run the next item's products, so
//     the state's traffic overlaps them;
//   - the last warp, the producer: it fills the ring ahead of the consumers,
//     over item boundaries.
// R (uint8_t or uint16_t) holds refrac.
template <int M, typename R>
__global__ void __launch_bounds__(2 * M + kUpdaters + 32, 1) block_step_kernel(const StepArgs a) {
  using L = Smem<M>;
  constexpr int kConsumers = 2 * M;                       // threads of the M / 64 warpgroups
  extern __shared__ unsigned char smem_raw[];
  // Aligned to the 1024-byte swizzle atom.
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(sm), bars = smem_u32(sm + L::kBars);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  // The stash is full (arrivals: the consumers) or free (the updaters).
  const uint32_t stash_full = bars + 16 * kStages, stash_free = stash_full + 8;
  float* stash = reinterpret_cast<float*>(sm + L::kStash);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wpr = a.N >> 5, cw = 4 * a.n_in, K = a.S + a.n_in;
  const int n_items = a.tiles * (a.N / kBlock);

  if (kSplit == 3 || kSplit == 5)
    for (int i = tid; i < (int)(L::kBars / 16); i += blockDim.x)
      reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 33);                // the producer's 32 lanes and its byte count
      mbar_init(empty(st), M / 64);           // every consumer warpgroup
    }
    mbar_init(stash_full, kConsumers);
    mbar_init(stash_free, kUpdaters);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers + kUpdaters) {
    // ---- the producer warp --------------------------------------------------
    // Each slot's block, and the tile's 128 spike bits a row of the slot's
    // source block (step t - 1) or input slice (step t), zeros past B.
    int gs = 0;                                   // slots so far, over items
    long long p_wait = 0, p_t0 = kStamps ? clock64() : 0;
    for (int it = blockIdx.x; kSplit != 5 && it < n_items; it += gridDim.x) {
      const int j = it / a.tiles, row0 = (it % a.tiles) * M;
      const unsigned char* wt =
          reinterpret_cast<const unsigned char*>(a.wt) + (size_t)j * K * kTileBytes;
      for (int s = 0; s < K; ++s, ++gs) {
        const int st = gs % kStages;
        const long long w0 = kStamps ? clock64() : 0;
        if (gs >= kStages) mbar_wait(empty(st), (gs / kStages - 1) & 1);
        if (kStamps) p_wait += clock64() - w0;
        if (lane == 0) {
          mbar_expect(full(st), kSplit == 3 ? 0 : kTileBytes);
          if (kSplit != 3)
            bulk_load(ring + st * kTileBytes, wt + (size_t)s * kTileBytes, kTileBytes, full(st));
        }
        const uint32_t* base = a.xb;
        int stride = cw, off = 4 * (s - a.S);
        if (s < a.S) {
          base = a.rd;
          stride = wpr;
          off = 4 * (a.src_idx ? __ldg(a.src_idx + j * a.S + s) : s);
        }
        const uint32_t dst = smem_u32(sm + L::kBitsAt) + st * M * 16;
        for (int r = lane; r < M; r += 32) {
          const bool valid = row0 + r < a.B;
          cp_async16(dst + r * 16, base + (size_t)(valid ? row0 + r : 0) * stride + off, valid);
        }
        cp_async_arrive(full(st));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#if LSM_BLOCK_SPLIT == 6
    if (lane == 0 && blockIdx.x < 4096) {
      g_stamps[blockIdx.x][4] = p_wait;
      g_stamps[blockIdx.x][5] = clock64() - p_t0;
    }
#endif
    (void)p_wait; (void)p_t0;
    return;
  }

  if (tid >= kConsumers) {
    // ---- the update warpgroups ----------------------------------------------
    // Thread u updates for consumer threads u, u + 256, ... (the same lane at
    // the same place in a warp, so its quad reductions hold), then frees the
    // stash.
    const int u = tid - kConsumers;
    long long u_wait = 0;
    int k = 0;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++k) {
      const long long w0 = kStamps ? clock64() : 0;
      mbar_wait(stash_full, k & 1);
      if (kStamps) u_wait += clock64() - w0;
      const int j = it / a.tiles, row0 = (it % a.tiles) * M;
#pragma unroll 1
      for (int ct = u; ct < kConsumers; ct += kUpdaters)
#pragma unroll 1
        for (int wj = 0; wj < 4; ++wj) update_word<M, R>(a, stash, j, row0, wj, ct);
      mbar_arrive(stash_free);
    }
#if LSM_BLOCK_SPLIT == 6
    if (u == 0 && blockIdx.x < 4096) g_stamps[blockIdx.x][2] = u_wait;
#endif
    (void)u_wait;
    return;
  }

  // ---- the consumer warpgroups ----------------------------------------------
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const bool signal = (tid & 127) == 0;          // its thread that releases stages
  float acc[64];
  int gs = 0, k = 0;                              // slots and items so far
  long long c_wait = 0, c_mma = 0, c_stash = 0, c_t0 = kStamps ? clock64() : 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++k) {
    const int row0 = (it % a.tiles) * M;
    const int r0 = row0 + wg * 64 + (warp & 3) * 16 + g;  // rows r0 and r0 + 8
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll 1
    for (int s = 0; s < K; ++s, ++gs) {
      const int st = gs % kStages;
      const long long w0 = kStamps ? clock64() : 0;
      if (kSplit != 5) mbar_wait(full(st), (gs / kStages) & 1);  // the block and bits landed
      const long long w1 = kStamps ? clock64() : 0;
      if (kStamps) c_wait += w1 - w0;
      // The slot's 128 spike bits of rows r0 (x[0..3]) and r0 + 8 (x[4..7]);
      // slice kk holds lanes 16 kk .. + 16, this thread lanes 2 q, 2 q + 1
      // (+ 8): two bits to a pair of bf16 0/1, in the m16n8k16 A layout.
      const unsigned char* bits = sm + L::kBitsAt + st * M * 16 + (r0 - row0) * 16;
      const uint4 x0 = *reinterpret_cast<const uint4*>(bits);
      const uint4 x1 = *reinterpret_cast<const uint4*>(bits + 128);
      const uint32_t xb[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      // Every warpgroup multiplies, one whose rows all lie past B zeros: a
      // branch around the products would make ptxas serialize them.
      const uint32_t w_base = ring + st * kTileBytes;
      uint32_t af[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int sh = 16 * (kk & 1) + 2 * q;
        const uint32_t y0 = xb[kk >> 1] >> sh, y1 = xb[4 + (kk >> 1)] >> sh;
        af[kk][0] = bf16_pair(y0);
        af[kk][1] = bf16_pair(y1);
        af[kk][2] = bf16_pair(y0 >> 8);
        af[kk][3] = bf16_pair(y1 >> 8);
      }
      if (kProducts) {
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n128k16(acc, af[kk], sw128_desc(w_base + (kk >> 2) * kBlock * 128 + (kk & 3) * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_operand(af[kk][i]);
      }
      if (signal) mbar_arrive(empty(st));        // the stage is free
      if (kStamps) c_mma += clock64() - w1;
    }
    // The update warpgroups are done with the last item's stash.
    const long long w3 = kStamps ? clock64() : 0;
    if (k > 0) mbar_wait(stash_free, (k - 1) & 1);
    if (kStamps) c_stash += clock64() - w3;
#pragma unroll
    for (int i = 0; i < 64; ++i) stash[i * kConsumers + tid] = acc[i];
    mbar_arrive(stash_full);
  }
#if LSM_BLOCK_SPLIT == 6
  if (tid == 0 && blockIdx.x < 4096) {
    long long* out = g_stamps[blockIdx.x];
    out[0] = c_wait; out[1] = c_mma; out[3] = clock64() - c_t0; out[6] = k; out[7] = c_stash;
  }
#endif
  (void)c_wait; (void)c_mma; (void)c_stash; (void)c_t0;
}

// The weight blocks of every slot, K-major and in the byte order of the
// 128-byte swizzle (sw128 with 128 rows): element (n, k) of block (j, s) is
// W[j, s][k, n] for the recurrent slots and w_in[128 (s - S) + k, 128 j + n]
// (zero past channel C) for the input slices. One CTA per 64 x 64 quarter
// of a block.
__global__ void transpose_blocks_kernel(const uint16_t* w, const uint16_t* w_in, long long stride_j,
                                        long long stride_s, long long stride_r, int N, int S,
                                        int K, int C, uint16_t* wt) {
  __shared__ uint16_t tile[64][66];
  const int blk = blockIdx.x >> 2, quarter = blockIdx.x & 3;
  const int j = blk / K, s = blk % K;
  const int k0 = (quarter >> 1) * 64, n0 = (quarter & 1) * 64;
  const uint16_t* src;
  long long stride;
  int rows = kBlock;
  if (s < S) {
    src = w + j * stride_j + s * stride_s;
    stride = stride_r;
  } else {
    const int c0 = (s - S) * kBlock;
    src = w_in + (size_t)c0 * N + (size_t)j * kBlock;
    stride = N;
    rows = min(kBlock, C - c0);
  }
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
    const int r = i >> 6, c = i & 63;
    tile[r][c] = k0 + r < rows ? src[(k0 + r) * stride + n0 + c] : 0;
  }
  __syncthreads();
  uint16_t* dst = wt + (size_t)blk * kBlock * kBlock;
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) {
    const int r = i >> 6, c = i & 63;                      // r: lane n, c: lane k
    const int n = n0 + r, k = k0 + c;
    dst[sw128(kBlock, n, k >> 3) / 2 + (k & 7)] = tile[c][r];
  }
}

// x (B, C, T) 0/1 -> bits (T, B, cw): channel c of step t at bit c % 32 of
// word c / 32 (the words start zeroed).
__global__ void pack_input_kernel(const uint8_t* x, uint32_t* bits, int B, int C, int T,
                                  int cw) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)B * C * T || x[i] == 0) return;
  const int t = i % T, c = (i / T) % C, b = i / ((size_t)T * C);
  atomicOr(bits + ((size_t)t * B + b) * cw + (c >> 5), 1u << (c & 31));
}

// B6's carried state into the step layout: v_in -> v (v_out), refrac_in ->
// R (the launch picks R to hold refractory; larger carried counts
// saturate), s_in -> spike plane 0. N % 128 == 0, so a warp is one word.
template <typename R>
__global__ void load_state_kernel(const float* v_in, const int* refrac_in, const float* s_in,
                                  float* v, R* refrac, uint32_t* plane, size_t total) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= total) return;                                 // whole warps: total % 32 == 0
  v[i] = v_in[i];
  refrac[i] = static_cast<R>(min(max(refrac_in[i], 0), (1 << (8 * sizeof(R))) - 1));
  const unsigned word = __ballot_sync(0xffffffffu, s_in[i] != 0.f);
  if ((threadIdx.x & 31) == 0) plane[i >> 5] = word;
}

template <typename R>
__global__ void store_state_kernel(const R* refrac, const uint32_t* plane,
                                   int* refrac_out, float* s_out, size_t total) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  refrac_out[i] = refrac[i];
  s_out[i] = (plane[i >> 5] >> (i & 31)) & 1u ? 1.f : 0.f;
}

// The output neurons' statistics from the raster (T, B, no_w), one thread
// per (stream, output neuron), in step order.
template <bool kChunk>
__global__ void stats_kernel(const uint32_t* raster, int B, int T, int no, int no_w,
                             float isi_max, int win_len, int n_win, float* win, float* dst) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)B * no) return;
  const int b = i / no, n = i % no;
  OutputStats<kChunk> st;
  float* win_row = kChunk ? win + (size_t)b * n_win * no + n : nullptr;
  for (int t = 0; t < T; ++t) {
    const bool spike = (raster[((size_t)t * B + b) * no_w + (n >> 5)] >> (n & 31)) & 1u;
    st.step(spike, t, T, isi_max, win_len, n_win, win_row, no);
  }
  st.write(dst, (size_t)B * no, i);
}

unsigned grid_1d(size_t n, int threads) { return static_cast<unsigned>((n + threads - 1) / threads); }

// T launches of the step, as many CTAs as the card holds at once (one an
// SM) or as work items, if fewer.
template <int M, typename R>
int run_steps(const BlockLifArgs& a, StepArgs s, uint32_t* plane0, uint32_t* plane1,
              const uint32_t* xbits, uint32_t* raster, cudaStream_t stream) {
  constexpr int threads = 2 * M + kUpdaters + 32;
  const int smem = static_cast<int>(Smem<M>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(block_step_kernel<M, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_step_kernel<M, R>,
                                                           threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  s.tiles = (a.B + M - 1) / M;
  const int grid = min(s.tiles * (a.N / kBlock), max(per_sm, 1) * sms);
  for (int t = 0; t < a.T; ++t) {
    s.rd = t & 1 ? plane1 : plane0;
    s.wr = t & 1 ? plane0 : plane1;
    s.xb = xbits + (size_t)t * a.B * 4 * s.n_in;
    s.raster = raster + (size_t)t * a.B * s.no_w;
    block_step_kernel<M, R><<<grid, threads, smem, stream>>>(s);
    if (t == 0 && (err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Bytes a refractory counter takes: 8 bits up to 255, else 16.
int refrac_bytes(int refractory) { return refractory > 255 ? 2 : 1; }

template <typename R>
int launch_with(const BlockLifArgs& a, bool chunk, cudaStream_t stream) {
  const Layout L = layout(a.B, a.C, a.T, a.N, a.S, a.no, chunk, sizeof(R));
  unsigned char* sc = static_cast<unsigned char*>(a.scratch);
  const size_t total = (size_t)a.B * a.N, wpr = a.N / 32;
  uint16_t* wt = reinterpret_cast<uint16_t*>(sc + L.wt);
  uint32_t* plane0 = reinterpret_cast<uint32_t*>(sc + L.plane);
  uint32_t* plane1 = plane0 + (size_t)a.B * wpr;
  uint32_t* xbits = reinterpret_cast<uint32_t*>(sc + L.xbits);
  uint32_t* raster = reinterpret_cast<uint32_t*>(sc + L.raster);
  R* refrac = reinterpret_cast<R*>(sc + L.refrac);
  float* v = chunk ? a.v_out : reinterpret_cast<float*>(sc + L.v);
  const int n_in = in_slices(a.C), no_w = (a.no + 31) / 32, K = a.S + n_in;

  transpose_blocks_kernel<<<(a.N / kBlock) * K * 4, 256, 0, stream>>>(
      a.w, a.w_in, a.stride_j, a.stride_s, a.stride_r, a.N, a.S, K, a.C, wt);
  cudaError_t err = cudaMemsetAsync(xbits, 0, L.raster - L.xbits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_x = (size_t)a.B * a.C * a.T;
  if (n_x > 0)
    pack_input_kernel<<<grid_1d(n_x, 256), 256, 0, stream>>>(a.x, xbits, a.B, a.C, a.T,
                                                             4 * n_in);
  if (chunk) {
    load_state_kernel<<<grid_1d(total, 256), 256, 0, stream>>>(a.v_in, a.refrac_in, a.s_in, v,
                                                               refrac, plane0, total);
  } else if ((err = cudaMemsetAsync(plane0, 0, (size_t)a.B * wpr * 4, stream)) != cudaSuccess ||
             (err = cudaMemsetAsync(refrac, 0, total * sizeof(R), stream)) != cudaSuccess ||
             (err = cudaMemsetAsync(v, 0, total * 4, stream)) != cudaSuccess ||
             (err = cudaMemsetAsync(a.all_counts, 0, total * 4, stream)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  StepArgs s{};
  s.v = v; s.refrac = refrac; s.all_counts = chunk ? nullptr : a.all_counts;
  s.wt = wt; s.src_idx = a.src_idx; s.leak_keep = a.leak_keep;
  s.B = a.B; s.N = a.N; s.S = a.S; s.n_in = n_in; s.no_w = no_w;
  s.refractory = a.refractory; s.thr = a.thr;
  const int rc = a.tile == 128 ? run_steps<128, R>(a, s, plane0, plane1, xbits, raster, stream)
                               : run_steps<64, R>(a, s, plane0, plane1, xbits, raster, stream);
  if (rc != 0) return rc;

  const float isi_max = static_cast<float>(a.burst_isi_max);
  const unsigned g_out = grid_1d((size_t)a.B * a.no, 128);
  if (chunk) {
    stats_kernel<true><<<g_out, 128, 0, stream>>>(raster, a.B, a.T, a.no, no_w, isi_max,
                                                  a.win_len, a.n_win, a.win, a.seg);
    store_state_kernel<<<grid_1d(total, 256), 256, 0, stream>>>(
        refrac, a.T & 1 ? plane1 : plane0, a.refrac_out, a.s_out, total);
  } else {
    stats_kernel<false><<<g_out, 128, 0, stream>>>(raster, a.B, a.T, a.no, no_w, isi_max,
                                                   a.win_len, a.n_win, nullptr, a.stats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

size_t block_lif_scratch_bytes(int B, int C, int T, int N, int S, int no, bool chunk,
                               int refractory) {
  return layout(B, C, T, N, S, no, chunk, refrac_bytes(refractory)).total;
}

int launch_block_lif(const BlockLifArgs& a, bool chunk, cudaStream_t stream) {
  if (a.B <= 0) return 0;
  if (a.N <= 0 || a.N % kBlock || a.S <= 0 || a.C < 0 || a.no <= 0 || a.no > a.N ||
      a.T <= 0 || a.refractory < 0 || a.refractory > kMaxRefractory || !a.scratch ||
      (a.tile != 64 && a.tile != 128) ||
      (chunk && (a.win_len <= 0 || a.T != a.win_len * a.n_win)))
    return static_cast<int>(cudaErrorInvalidValue);
  return refrac_bytes(a.refractory) == 2 ? launch_with<uint16_t>(a, chunk, stream)
                                         : launch_with<uint8_t>(a, chunk, stream);
}

}  // namespace lsm

namespace {

lsm::BlockLifArgs sparse_args(const uint8_t* x, const uint16_t* w_blocks,
                              const int* src_idx, const uint16_t* w_in,
                              const float* leak_keep, int B, int C, int T,
                              int N, int S, int no, float thr, int refractory,
                              int burst_isi_max, int win_len, int n_win, int tile,
                              void* scratch) {
  lsm::BlockLifArgs a{};
  a.x = x; a.w = w_blocks; a.src_idx = src_idx; a.w_in = w_in;
  a.leak_keep = leak_keep;
  a.stride_r = 128;                       // w_blocks (nb, S, 128, 128)
  a.stride_s = 128LL * 128;
  a.stride_j = (long long)S * 128 * 128;
  a.B = B; a.C = C; a.T = T; a.N = N; a.S = S; a.no = no; a.thr = thr;
  a.refractory = refractory; a.burst_isi_max = burst_isi_max;
  a.win_len = win_len; a.n_win = n_win; a.tile = tile; a.scratch = scratch;
  return a;
}

}  // namespace

// Bytes of global scratch the block body needs for one call (the wrappers
// allocate it).
extern "C" long long lsm_block_lif_scratch_bytes(int B, int C, int T, int N, int S, int no,
                                                 int chunk, int refractory) {
  return static_cast<long long>(
      lsm::block_lif_scratch_bytes(B, C, T, N, S, no, chunk != 0, refractory));
}

// `tile`: streams a CTA, 64 or 128, as the host's plan picks it
// (ops/kernels/sparse_lif.py `block_plan`).
extern "C" int lsm_sparse_lif_stats(const uint8_t* x, const uint16_t* w_blocks,
                                    const int* src_idx, const uint16_t* w_in,
                                    const float* leak_keep, float* stats,
                                    float* all_counts, int B, int C, int T,
                                    int N, int S, int no, float thr,
                                    int refractory, int burst_isi_max,
                                    int win_len, int n_win, int tile, void* scratch,
                                    void* stream) {
  lsm::BlockLifArgs a = sparse_args(x, w_blocks, src_idx, w_in, leak_keep, B, C,
                                    T, N, S, no, thr, refractory,
                                    burst_isi_max, win_len, n_win, tile, scratch);
  a.stats = stats;
  a.all_counts = all_counts;
  return lsm::launch_block_lif(a, false, static_cast<cudaStream_t>(stream));
}

extern "C" int lsm_sparse_lif_chunk(const uint8_t* x, const uint16_t* w_blocks,
                                    const int* src_idx, const uint16_t* w_in,
                                    const float* leak_keep, const float* v_in,
                                    const int* refrac_in, const float* s_in,
                                    float* v_out, int* refrac_out, float* s_out,
                                    float* seg, float* win, int B, int C, int T,
                                    int N, int S, int no, float thr,
                                    int refractory, int burst_isi_max,
                                    int win_len, int n_win, int tile, void* scratch,
                                    void* stream) {
  lsm::BlockLifArgs a = sparse_args(x, w_blocks, src_idx, w_in, leak_keep, B, C,
                                    T, N, S, no, thr, refractory,
                                    burst_isi_max, win_len, n_win, tile, scratch);
  a.v_in = v_in; a.refrac_in = refrac_in; a.s_in = s_in;
  a.v_out = v_out; a.refrac_out = refrac_out; a.s_out = s_out;
  a.seg = seg; a.win = win;
  return lsm::launch_block_lif(a, true, static_cast<cudaStream_t>(stream));
}

#if LSM_BLOCK_SPLIT == 6
// The stamps of the last launch's first n CTAs (8 int64 each) into host memory.
extern "C" int lsm_block_stamps(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, lsm::g_stamps, (size_t)n * 64));
}
#endif
