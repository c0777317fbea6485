// Kernels B2 and B4: fused dense LIF reservoir with streaming spike
// statistics on Hopper (sm_90a).
//
// B2 replaces lsm_tpu/ops/pallas/lif_kernel.py:46 _lif_kernel; B4 replaces
// lsm_tpu/ops/pallas/lif_chunk_kernel.py:39 _lif_chunk_kernel, one
// continuous-mode chunk of T_c steps with the state carried in and out.
// Per step t:
//
//     drive = s_prev . bf16(W_rec) + x_t . bf16(W_in)      (f32 accumulate)
//     v     = refrac == 0 ? v * (1 - leak) + drive : 0
//     spike = refrac == 0 && v >= threshold;  reset v = 0, refrac = R
//
// and the output neurons (n < n_outputs) accumulate counts, spike-time
// moments, first/last spike, ISI moments and bursts (ISI <= burst_isi_max),
// with times relative to the start of the call. B2 adds windowed-rate
// moments (later steps fold into the last window) and all_counts over every
// neuron; B4 writes each rate window's count (one every win_len steps, no
// folding) and the final v, refrac and spike vector.
//
// Spikes are 0/1, so the drive is a sum of the W rows of the sources that
// fired, in ascending source order: the recurrent rows into one f32
// accumulator, the input rows into another, then their sum. Every body below
// keeps that order, so all of them give the same bits on any weights (and
// the plain twin's on dyadic ones, where every order gives the same sum).
// The host picks the body and its tiling (ops/kernels/lif.py dense_plan);
// the C entry points check the plan and run it, and compute none of it.
//
// The cluster body (N_pad = 64 K, K = 2..16, when the slices below fit).
// The TPU kept W_rec (2 MB bf16) resident in VMEM; an SM has 227 KB of
// shared memory, a thread-block cluster of 16 SMs 16 times that. CTA k of a
// cluster owns destination neurons 64 k .. 64 k + 63 and copies its slice of
// W_rec (N_pad rows x 64 columns, 128 KB at N_pad 1024) and of W_in (C rows)
// into shared memory once per call, each row as 32 words that pack columns
// l and l + 32 of the slice, so one 4-byte load gives a lane both of its
// neurons' weights and a warp reads 128 contiguous bytes, free of bank
// conflicts. A cluster takes M streams a round (one warp a stream, M <= 24)
// and walks rounds until the batch is done; the grid is as many clusters as
// the card holds at once (7 of 16 CTAs on a 132-SM H100). Per step each
// warp compacts its stream's input bit words, then (once they have landed)
// its recurrent spike words, into a list of source indices in ascending
// order (a warp scan of the words' popcounts), and adds one shared-memory
// row per listed source, eight row loads in flight before their adds; runs
// the LIF update and the output statistics in registers (window edges
// counted, not divided); ballots its 64 spikes into two words and sends
// them with st.async into the spike buffer of every CTA of the cluster,
// where each CTA's mbarrier for that buffer counts the bytes. The spike
// buffer is double-buffered by step parity, and no cluster-wide barrier
// runs per step: a CTA waits only for the K M word pairs of the step it
// reads (the proof that a buffer is free again is at the kernel); one
// cluster barrier ends each round, since a round's step 0 waits on
// nothing. Input
// bit words are built per warp for blocks of 32 steps (a lane reads one
// channel's 32 steps in four 8-byte loads, 32 ballots transpose them). B4
// builds step 0's recurrent words from the carried spike vector in each
// CTA, from global memory, so it waits on nothing.
// What bounds it: the issue of ~10 instructions per fired source row, warp
// and CTA (every CTA walks the same list for its own 64 columns) and, per
// step, the latency of the walk after the words land plus the st.async
// round trip (chip_smoke.py times B2 on all-zero spikes, the step without
// the walk); not bytes (each weight is read from global memory once per
// CTA per call) and not FLOPs.
// Budget at the flagship (N_pad 1024, C = 128, M = 24): 215,056 bytes of
// shared memory (W_rec 131,072, W_in 16,384, spike words 6,144, input
// words 12,288, source lists 49,152, barriers 16) and one CTA of 768
// threads an SM, so at most 80 registers a thread: v, refrac and the
// OutputStats of a lane's two neurons stay in registers (chip_smoke.py
// prints ptxas's register and spill lines).
//
// The one-thread body keeps the shapes whose slices do not fit the cluster
// (W_in of 2048 channels at redundancy 16 is 256 KB a CTA) or whose N_pad is
// not a multiple of 64 of at least 128: one CTA owns one stream for all T
// steps, one thread a neuron, and compacts each step's spike vector into a
// list of the sources that fired (two block barriers a step); with C >
// N_pad a second instantiation keeps the input list, C entries, in dynamic
// shared memory. It also serves as the reference the cluster body is held
// to on non-dyadic weights (chip_smoke.py and the kernel tests force it
// through the plan).
//
// Above 1024 padded neurons dense B2/B4 run on the stream-tiled block body
// of sparse_lif.cu (B5/B6) with the matrix seen as nb x nb blocks of 128,
// in the global scratch the caller passes (unused at <= 1024 neurons). The
// body has no size limit of its own: every slot offset and stride is 64-bit
// or bounded by N / 32 words, so its only limit is the scratch (nb^2 K-major
// blocks of 32 KB: 212 MB at 10240 neurons), which the wrapper holds against
// the card's free memory (ops/kernels/lif.py, `block_scratch`).

#include <atomic>

#include <cooperative_groups.h>

#include "lif_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_N = 1024;       // the one-thread body: one thread per padded neuron
constexpr int kSlice = 64;        // the cluster body: destination neurons a CTA
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster
constexpr int kMaxStreams = 24;   // streams a cluster round, one warp each
constexpr int kStepBlock = 32;    // steps of input bit words built at a time
constexpr int kSmemLimit = 232448;

// The plan's bodies, as ops/kernels/lif.py numbers them.
enum Body { kOneThread = 0, kCluster = 1, kBlock = 2 };

// M: the cluster body's streams a round, or the block body's streams a tile.
struct Plan {
  int body, K, M, threads, smem, clusters;
};

using lsm::bf16_bits_to_float;

struct LifArgs {
  const uint8_t* x;          // (B, C, T)
  const uint16_t* w_rec;     // (Np, Np) bf16, row = source
  const uint16_t* w_in;      // (Cp, Np) bf16
  const float* leak_keep;    // (Np,)
  float* stats;              // B2: (11, B, no)
  float* all_counts;         // B2: (B, Np)
  const float* v_in;         // B4: (B, Np) carried state in
  const int* refrac_in;
  const float* s_in;
  float* v_out;              // B4: (B, Np) state out
  int* refrac_out;
  float* s_out;
  float* seg;                // B4: (9, B, no) segment summary
  float* win;                // B4: (B, n_win, no) rate-window counts
  int B, C, T, Np, no;
  float thr;
  int refractory, burst_isi_max, win_len, n_win;
};

// ---- the one-thread body ---------------------------------------------------

// Block-wide stream compaction of two flag sets into ascending index lists:
// neuron n to rec_list where f_rec, channel n to in_list where f_in. Two
// barriers; on return both lists and their lengths are visible to all.
__device__ __forceinline__ void compact2(bool f_rec, bool f_in, int n,
                                         int* rec_list, int* in_list,
                                         int* cnt_rec, int* cnt_in,
                                         int& n_rec, int& n_in) {
  const int lane = n & 31, warp = n >> 5, nwarps = blockDim.x >> 5;
  const unsigned br = __ballot_sync(0xffffffffu, f_rec);
  const unsigned bi = __ballot_sync(0xffffffffu, f_in);
  if (lane == 0) {
    cnt_rec[warp] = __popc(br);
    cnt_in[warp] = __popc(bi);
  }
  __syncthreads();
  int off_r = 0, off_i = 0, tot_r = 0, tot_i = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int a = cnt_rec[w], c = cnt_in[w];
    if (w < warp) { off_r += a; off_i += c; }
    tot_r += a;
    tot_i += c;
  }
  const unsigned below = (1u << lane) - 1u;
  if (f_rec) rec_list[off_r + __popc(br & below)] = n;
  if (f_in) in_list[off_i + __popc(bi & below)] = n;
  n_rec = tot_r;
  n_in = tot_i;
  __syncthreads();
}

// Appends channel ch to in_list[n_in..] where f_in, in ascending order: the
// input channels past the first Np. Two barriers, as compact2.
__device__ __forceinline__ void compact_more(bool f_in, int n, int ch, int* in_list,
                                             int* cnt_in, int& n_in) {
  const int lane = n & 31, warp = n >> 5, nwarps = blockDim.x >> 5;
  const unsigned bi = __ballot_sync(0xffffffffu, f_in);
  if (lane == 0) cnt_in[warp] = __popc(bi);
  __syncthreads();
  int off = n_in, tot = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = cnt_in[w];
    if (w < warp) off += c;
    tot += c;
  }
  if (f_in) in_list[off + __popc(bi & ((1u << lane) - 1u))] = ch;
  n_in += tot;
  __syncthreads();
}

// The input channels past the first Np that are on at step t, appended to
// in_list in rounds of Np (thread n: channels n + Np, n + 2 Np, ...).
__device__ __forceinline__ void compact_rest(const uint8_t* xb, int t, int T, int C, int Np,
                                             int n, int* in_list, int* cnt_in, int& n_in) {
  for (int ch = n + Np; ch - n < C; ch += Np)
    compact_more(t < T && ch < C && xb[(size_t)ch * T + t] != 0, n, ch, in_list, cnt_in, n_in);
}

// kChunk = false: B2 (zero state, window moments, all_counts).
// kChunk = true:  B4 (carried state, segment summary, window counts).
// kManyIn: C > Np, the input list in C entries of dynamic shared memory.
template <bool kChunk, bool kManyIn>
__global__ void __launch_bounds__(MAX_N, 1)
lif_kernel(const LifArgs a) {
  __shared__ int rec_list[MAX_N];
  __shared__ int in_fixed[kManyIn ? 1 : MAX_N];
  extern __shared__ int in_many[];
  int* const in_list = kManyIn ? in_many : in_fixed;
  __shared__ int cnt_rec[MAX_N / 32];
  __shared__ int cnt_in[MAX_N / 32];

  const int n = threadIdx.x;
  const int b = blockIdx.x;
  const int C = a.C, T = a.T, Np = a.Np, no = a.no;
  const size_t row = (size_t)b * Np + n;
  const uint8_t* xb = a.x + (size_t)b * C * T;
  const float lk = a.leak_keep[n];
  const float isi_max = static_cast<float>(a.burst_isi_max);

  float v = 0.f;
  int refrac = 0;
  bool s_last = false;
  if (kChunk) {
    v = a.v_in[row];
    refrac = a.refrac_in[row];
    s_last = a.s_in[row] != 0.f;
  }
  lsm::OutputStats<kChunk> st;
  float* win_row = kChunk ? a.win + (size_t)b * a.n_win * no + n : nullptr;
  float allc = 0.f;

  int n_rec = 0, n_in = 0;
  compact2(s_last, n < C && xb[(size_t)n * T] != 0, n, rec_list, in_list,
           cnt_rec, cnt_in, n_rec, n_in);
  if (kManyIn) compact_rest(xb, 0, T, C, Np, n, in_list, cnt_in, n_in);

  for (int t = 0; t < T; ++t) {
    float acc_r = 0.f, acc_i = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_rec; ++i)
      acc_r += bf16_bits_to_float(a.w_rec[(size_t)rec_list[i] * Np + n]);
#pragma unroll 4
    for (int i = 0; i < n_in; ++i)
      acc_i += bf16_bits_to_float(a.w_in[(size_t)in_list[i] * Np + n]);
    const float drive = acc_r + acc_i;

    const bool active = refrac == 0;
    // No FMA contraction: the plain twin rounds the product and the sum.
    const float v_new = active ? __fadd_rn(__fmul_rn(v, lk), drive) : 0.f;
    const bool spike = active && v_new >= a.thr;
    v = spike ? 0.f : v_new;
    refrac = spike ? a.refractory : max(refrac - 1, 0);
    s_last = spike;

    if (!kChunk && spike) allc += 1.f;
    if (n < no) st.step(spike, t, T, isi_max, a.win_len, a.n_win, win_row, no);
    const bool next_in = (t + 1 < T) && n < C && xb[(size_t)n * T + t + 1] != 0;
    compact2(spike, next_in, n, rec_list, in_list, cnt_rec, cnt_in, n_rec, n_in);
    if (kManyIn) compact_rest(xb, t + 1, T, C, Np, n, in_list, cnt_in, n_in);
  }

  if (kChunk) {
    a.v_out[row] = v;
    a.refrac_out[row] = refrac;
    a.s_out[row] = s_last ? 1.f : 0.f;
  } else {
    a.all_counts[row] = allc;
  }
  if (n < no) st.write(kChunk ? a.seg : a.stats, (size_t)a.B * no, (size_t)b * no + n);
}

bool bad_shape(int C, int T, int Np, int no) {
  return Np <= 0 || Np > MAX_N || Np % 32 || C < 0 || no > Np || T <= 0;
}

// One CTA a batch row, one thread a padded neuron. With more channels than
// neurons the input list takes C entries of dynamic shared memory.
template <bool kChunk>
int launch_one_thread(const LifArgs& a, cudaStream_t s) {
  if (a.C <= a.Np) {
    lif_kernel<kChunk, false><<<a.B, a.Np, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = a.C * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lif_kernel<kChunk, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lif_kernel<kChunk, true><<<a.B, a.Np, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the cluster body ------------------------------------------------------

// A warp's source list: room for every neuron or input channel (a multiple
// of 32 either way, so a list of 16-bit entries stays 16-byte aligned).
__host__ __device__ inline int list_len(int Np, int C) {
  return max(Np, 32 * ((C + 31) / 32));
}

// Bytes of dynamic shared memory the cluster body lays out for M streams a
// round: two barriers (16 bytes), the W_rec slice (Np rows of 32 words), the W_in slice (C rounded
// up to 32 rows), two spike buffers of M x Np/32 words, the input words
// of kStepBlock steps, M streams and ceil(C / 32) words, and M source
// lists of list_len 16-bit entries. dense_plan in ops/kernels/lif.py
// sizes its plan by it (lsm_lif_cluster_smem).
size_t cluster_smem_bytes(int Np, int C, int M) {
  const size_t nw = Np / 32, cw = (C + 31) / 32;
  return 16 + 128 * (size_t)Np + 4096 * cw + 8 * (size_t)M * nw +
         4 * (size_t)kStepBlock * M * cw + 2 * (size_t)M * list_len(Np, C);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of this CTA's shared-memory word `a` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

// The one arrival of the barrier's phase, which then waits for `bytes`.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Two words into another CTA's shared memory, counted by its barrier.
__device__ __forceinline__ void st_async2(uint32_t addr, uint32_t lo, uint32_t hi, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n"
      :: "r"(addr), "r"(lo), "r"(hi), "r"(bar) : "memory");
}

// Columns col0 .. col0 + 63 of rows 0 .. rows-1 of a bf16 (rows, ld) matrix
// into dst (rows, 32) words: word l of a row packs column col0 + l (low
// half) and column col0 + 32 + l (high half). Sixteen-byte loads when the
// matrix is so aligned (ld is a multiple of 64, col0 of 64), else two bytes.
__device__ void load_slice(const uint16_t* src, int rows, int ld, int col0, uint32_t* dst) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = threadIdx.x; i < rows * 4; i += blockDim.x) {
    const int r = i >> 2, q = i & 3;
    const uint16_t* s = src + (size_t)r * ld + col0 + 8 * q;
    uint32_t lo[4], hi[4];
    if (vec) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(s));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(s + 32));
      lo[0] = a.x; lo[1] = a.y; lo[2] = a.z; lo[3] = a.w;
      hi[0] = b.x; hi[1] = b.y; hi[2] = b.z; hi[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = s[2 * j] | static_cast<uint32_t>(s[2 * j + 1]) << 16;
        hi[j] = s[32 + 2 * j] | static_cast<uint32_t>(s[33 + 2 * j]) << 16;
      }
    }
    // lo[j] holds columns 8q + 2j (low half) and 8q + 2j + 1 (high half).
    uint4 o[2];
    uint32_t* ow = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ow[2 * j] = __byte_perm(lo[j], hi[j], 0x5410);
      ow[2 * j + 1] = __byte_perm(lo[j], hi[j], 0x7632);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + (size_t)r * 32 + 8 * q);
    d[0] = o[0];
    d[1] = o[1];
  }
}

// One warp: the indices of the set bits of words[0 .. n), in ascending
// order, into list (16 bits each); returns their count. Lane k takes word
// k of each 32, a warp scan of the popcounts gives each lane its offset.
__device__ __forceinline__ int compact_bits(const uint32_t* words, int n, int lane,
                                            uint16_t* list) {
  __syncwarp();                               // the list's last walk is done
  int total = 0;
  for (int base = 0; base < n; base += 32) {
    const uint32_t mine = base + lane < n ? words[base + lane] : 0u;
    if (__ballot_sync(0xffffffffu, mine != 0u) == 0u) continue;
    const int c = __popc(mine);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    int off = total + incl - c;
    for (uint32_t bits = mine; bits; bits &= bits - 1)
      list[off++] = static_cast<uint16_t>((base + lane) * 32 + __ffs(bits) - 1);
    total += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  return total;
}

__device__ __forceinline__ void add_row(uint32_t p, float& a0, float& a1) {
  a0 += __uint_as_float(p << 16);
  a1 += __uint_as_float(p & 0xffff0000u);
}

// Adds to (a0, a1) the rows of w (32 words a row) that list[0 .. n) names,
// in list order: eight indices in one load, then their eight rows, then
// the adds, so the loads' latencies overlap and the adds keep their order.
// The list has room for reading up to 7 entries past n.
__device__ __forceinline__ void walk_list(const uint16_t* list, int n, const uint32_t* w,
                                          int lane, float& a0, float& a1) {
  const uint32_t* const col = w + lane;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(list + i);
    const uint32_t pairs[4] = {q.x, q.y, q.z, q.w};
    uint32_t p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = col[((pairs[u >> 1] >> (16 * (u & 1))) & 0xffffu) * 32];
#pragma unroll
    for (int u = 0; u < 8; ++u) add_row(p[u], a0, a1);
  }
  if (i < n) {
    const uint4 q = *reinterpret_cast<const uint4*>(list + i);
    const uint32_t pairs[4] = {q.x, q.y, q.z, q.w};
    uint32_t p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      // Entries past n are stale: read row 0 for them, and add nothing.
      const uint32_t idx = i + u < n ? (pairs[u >> 1] >> (16 * (u & 1))) & 0xffffu : 0u;
      p[u] = col[idx * 32];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i + u < n) add_row(p[u], a0, a1);
  }
}

// One warp: the input bit words of one stream for steps t0 .. t0 + 31,
// word cw of step t0 + j to dst[j * stride + cw]. Lane l reads channel
// 32 cw + l over the 32 steps (four 8-byte loads where the block lies
// inside T and is so aligned, else a byte a step); 32 ballots transpose
// them.
__device__ __forceinline__ void build_inputs(const uint8_t* xb, bool live, int C, int T,
                                             int t0, int lane, int cw_n, uint32_t* dst,
                                             int stride) {
  const bool whole = t0 + kStepBlock <= T &&
                     ((reinterpret_cast<uintptr_t>(xb + t0) | static_cast<uintptr_t>(T)) & 7) == 0;
  for (int cw = 0; cw < cw_n; ++cw) {
    const int c = cw * 32 + lane;
    const bool on = live && c < C;
    const uint8_t* xc = xb + (size_t)c * T + t0;
    uint32_t mine = 0;
    if (whole) {
      uint2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = on ? __ldg(reinterpret_cast<const uint2*>(xc) + k) : make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < kStepBlock; ++j) {
        const uint32_t four = (j & 4) ? v[j >> 3].y : v[j >> 3].x;
        const uint32_t word = __ballot_sync(0xffffffffu, (four >> (8 * (j & 3))) & 0xffu);
        if (lane == j) mine = word;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kStepBlock; ++j) {
        const bool f = on && t0 + j < T && xc[j] != 0;
        const uint32_t word = __ballot_sync(0xffffffffu, f);
        if (lane == j) mine = word;
      }
    }
    dst[lane * stride + cw] = mine;
  }
}

// The cluster body of B2 (kChunk = false) and B4 (kChunk = true). Lane l of
// warp w holds neurons 64 rank + l and 64 rank + 32 + l of stream
// (round first + w). Spike words of step t travel to step t + 1's buffer,
// (t + 1) & 1, of every CTA with st.async, each counted by that buffer's
// barrier; a CTA reads a buffer once its barrier has counted all K M word
// pairs. Why a buffer is free again when the next words arrive: a CTA
// sends step t + 1's words only after its barrier counted step t's words
// of every warp, and each warp sends those only after reading its stream's
// slot of the same buffer at step t - 1. Step 0 of a round waits on no
// barrier, yet sends step 1's words; so a cluster barrier ends every
// round: no CTA sends into a buffer, or counts on a barrier, that another
// CTA still reads, or still waits on, for the round before. Every CTA of a
// cluster walks the same rounds.
template <bool kChunk>
__global__ void __launch_bounds__(kMaxStreams * 32, 1)
lif_cluster_kernel(const LifArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int M = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = a.C, T = a.T, Np = a.Np, no = a.no;
  const int nw = Np >> 5, cw = (C + 31) >> 5;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);    // one per buffer
  uint32_t* const w_rec = smem + 4;                           // Np x 32
  uint32_t* const w_in = w_rec + (size_t)Np * 32;             // 32 cw x 32
  uint32_t* const spk = w_in + (size_t)cw * 1024;             // [2][M][nw]
  uint32_t* const inw = spk + 2 * M * nw;                     // [kStepBlock][M][cw]
  uint16_t* const list = reinterpret_cast<uint16_t*>(inw + kStepBlock * M * cw) +
                         warp * list_len(Np, C);              // this warp's sources
  const int col0 = rank * kSlice;
  const int n0 = col0 + lane, n1 = n0 + 32;
  const uint32_t bar0 = smem_addr(&bars[0]), bar1 = smem_addr(&bars[1]);
  const uint32_t tx_bytes = 8u * K * M;      // two words from each warp of each CTA

  if (threadIdx.x == 0) {
    mbar_init(bar0);
    mbar_init(bar1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar0, tx_bytes);
    mbar_expect(bar1, tx_bytes);
  }
  load_slice(a.w_rec, Np, Np, col0, w_rec);
  load_slice(a.w_in, C, Np, col0, w_in);
  const float lk0 = a.leak_keep[n0], lk1 = a.leak_keep[n1];
  const float isi_max = static_cast<float>(a.burst_isi_max);
  // Every CTA of the cluster runs, with its slices and barriers, before
  // any spike word crosses.
  cluster_sync();

  uint32_t parity = 0;                       // bit p: the phase buffer p waits for
  const int n_clusters = gridDim.x / K;
  for (int first = (blockIdx.x / K) * M; first < a.B; first += n_clusters * M) {
    const int b = first + warp;
    const bool live = b < a.B;                 // the last round may be ragged
    const size_t row = (size_t)(live ? b : 0) * Np;
    const uint8_t* xb = a.x + (size_t)(live ? b : 0) * C * T;
    float v0 = 0.f, v1 = 0.f;
    int r0 = 0, r1 = 0;
    bool s0 = false, s1 = false;
    if (kChunk) {
      if (live) {
        v0 = a.v_in[row + n0];
        v1 = a.v_in[row + n1];
        r0 = a.refrac_in[row + n0];
        r1 = a.refrac_in[row + n1];
      }
      // Step 0's recurrent words: the carried spike vector, read whole by
      // every CTA, into buffer 0 (no other CTA writes it before step 1).
      uint32_t* const carried = spk + warp * nw;
      for (int k = 0; k < nw; ++k) {
        const uint32_t word = __ballot_sync(0xffffffffu, live && a.s_in[row + k * 32 + lane] != 0.f);
        if (lane == 0) carried[k] = word;
      }
      __syncwarp();
    }
    lsm::OutputStats<kChunk> st0, st1;
    float allc0 = 0.f, allc1 = 0.f;
    const bool o0 = live && n0 < no, o1 = live && n1 < no;
    // Window w of this stream's output neurons: win0 + w no (B4).
    float* const win0 = kChunk && o0 ? a.win + (size_t)b * a.n_win * no + n0 : nullptr;
    float* const win1 = kChunk && o1 ? a.win + (size_t)b * a.n_win * no + n1 : nullptr;
    int to_edge = a.win_len, windows = 0;     // steps to the next window edge, edges passed

    for (int t = 0; t < T; ++t) {
      const int j = t % kStepBlock;
      if (j == 0) {
        build_inputs(xb, live, C, T, t, lane, cw, inw + warp * cw, M * cw);
        __syncwarp();
      }
      float ai0 = 0.f, ai1 = 0.f, ar0 = 0.f, ar1 = 0.f;
      walk_list(list, compact_bits(inw + (j * M + warp) * cw, cw, lane, list), w_in, lane,
                ai0, ai1);
      const int p = t & 1;
      const uint32_t bar = p ? bar1 : bar0;
      if (t > 0) {                             // step t - 1's words have all landed
        mbar_wait(bar, (parity >> p) & 1u);
        parity ^= 1u << p;
        if (threadIdx.x == 0) mbar_expect(bar, tx_bytes);   // its next phase
      }
      if (kChunk || t > 0)
        walk_list(list, compact_bits(spk + (p * M + warp) * nw, nw, lane, list), w_rec, lane,
                  ar0, ar1);

      // The one-thread body's update, for each of the lane's two neurons.
      const bool act0 = r0 == 0, act1 = r1 == 0;
      const float vn0 = act0 ? __fadd_rn(__fmul_rn(v0, lk0), ar0 + ai0) : 0.f;
      const float vn1 = act1 ? __fadd_rn(__fmul_rn(v1, lk1), ar1 + ai1) : 0.f;
      s0 = act0 && vn0 >= a.thr;
      s1 = act1 && vn1 >= a.thr;
      v0 = s0 ? 0.f : vn0;
      v1 = s1 ? 0.f : vn1;
      r0 = s0 ? a.refractory : max(r0 - 1, 0);
      r1 = s1 ? a.refractory : max(r1 - 1, 0);

      // Words 2 rank and 2 rank + 1 of this stream's slot in step t + 1's
      // buffer, lane r to CTA r.
      const uint32_t lo = __ballot_sync(0xffffffffu, s0);
      const uint32_t hi = __ballot_sync(0xffffffffu, s1);
      if (t + 1 < T && lane < K) {
        const int q = p ^ 1;
        st_async2(map_rank(smem_addr(spk + (q * M + warp) * nw + 2 * rank), lane), lo, hi,
                  map_rank(q ? bar1 : bar0, lane));
      }

      if (!kChunk) {
        allc0 += s0 ? 1.f : 0.f;
        allc1 += s1 ? 1.f : 0.f;
      }
      // OutputStats::step's window edges, counted instead of divided.
      const bool edge = --to_edge == 0;
      if (edge) {
        to_edge = a.win_len;
        ++windows;
      }
      const bool boundary = kChunk ? edge : (edge && windows < a.n_win) || t == T - 1;
      const size_t slot = kChunk ? (size_t)(windows - 1) * no : 0;
      const float tf = static_cast<float>(t);
      if (o0) st0.step_at(s0, tf, isi_max, boundary, win0 + slot);
      if (o1) st1.step_at(s1, tf, isi_max, boundary, win1 + slot);
    }

    if (live) {
      if (kChunk) {
        a.v_out[row + n0] = v0;
        a.v_out[row + n1] = v1;
        a.refrac_out[row + n0] = r0;
        a.refrac_out[row + n1] = r1;
        a.s_out[row + n0] = s0 ? 1.f : 0.f;
        a.s_out[row + n1] = s1 ? 1.f : 0.f;
      } else {
        a.all_counts[row + n0] = allc0;
        a.all_counts[row + n1] = allc1;
      }
    }
    float* const dst = kChunk ? a.seg : a.stats;
    if (o0) st0.write(dst, (size_t)a.B * no, (size_t)b * no + n0);
    if (o1) st1.write(dst, (size_t)a.B * no, (size_t)b * no + n1);
    // Every word of this round has landed and been read before any CTA
    // starts the next round; after the last round, no CTA leaves while
    // another may still address its shared memory.
    cluster_sync();
  }
}

// The cluster body's function attributes (any plan's shared memory, up to
// kSmemLimit, and clusters of 16), set once per device: every call sets
// the same values, so two threads that race here do no harm.
template <bool kChunk>
cudaError_t cluster_attributes() {
  constexpr int kDevices = 64;
  static std::atomic<bool> set[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && set[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(lif_cluster_kernel<kChunk>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lif_cluster_kernel<kChunk>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < kDevices) set[dev].store(true, std::memory_order_relaxed);
  return err;
}

// A launch configuration of `clusters` clusters of K CTAs; attr must outlive it.
cudaLaunchConfig_t cluster_config(int K, int threads, int smem, int clusters,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(clusters * K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool bad_cluster_plan(const LifArgs& a, const Plan& p) {
  return p.K < 2 || p.K > kMaxCluster || p.K * kSlice != a.Np || p.M < 1 ||
         p.M > kMaxStreams || p.threads != 32 * p.M || p.clusters < 1 ||
         p.smem > kSmemLimit || (size_t)p.smem < cluster_smem_bytes(a.Np, a.C, p.M);
}

template <bool kChunk>
int launch_cluster(const LifArgs& a, const Plan& p, cudaStream_t s) {
  const cudaError_t err = cluster_attributes<kChunk>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p.K, p.threads, p.smem, p.clusters, s, &attr);
  cudaLaunchKernelEx(&cfg, lif_cluster_kernel<kChunk>, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the block body (above 1024 padded neurons) ----------------------------

// The block body's arguments for a dense (Np, Np) matrix, row = source:
// Np / 128 slots, slot s reading source block s, `tile` streams a CTA.
lsm::BlockLifArgs wide_args(const LifArgs& d, int tile, void* scratch) {
  lsm::BlockLifArgs a{};
  a.x = d.x; a.w = d.w_rec; a.src_idx = nullptr; a.w_in = d.w_in;
  a.leak_keep = d.leak_keep; a.stats = d.stats; a.all_counts = d.all_counts;
  a.v_in = d.v_in; a.refrac_in = d.refrac_in; a.s_in = d.s_in;
  a.v_out = d.v_out; a.refrac_out = d.refrac_out; a.s_out = d.s_out;
  a.seg = d.seg; a.win = d.win;
  a.stride_j = 128;
  a.stride_s = 128LL * d.Np;
  a.stride_r = d.Np;
  a.B = d.B; a.C = d.C; a.T = d.T; a.N = d.Np; a.S = d.Np / 128; a.no = d.no;
  a.thr = d.thr; a.refractory = d.refractory; a.burst_isi_max = d.burst_isi_max;
  a.win_len = d.win_len; a.n_win = d.n_win; a.tile = tile; a.scratch = scratch;
  return a;
}

// Runs the body the plan names, or returns cudaErrorInvalidValue for a plan
// this shape cannot run.
template <bool kChunk>
int launch(const LifArgs& a, const Plan& p, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((p.body == kBlock) != (a.Np > MAX_N)) return invalid;
  if (p.body == kBlock) return lsm::launch_block_lif(wide_args(a, p.M, scratch), kChunk, s);
  if (bad_shape(a.C, a.T, a.Np, a.no)) return invalid;
  if (p.body == kOneThread) return launch_one_thread<kChunk>(a, s);
  if (p.body == kCluster && !bad_cluster_plan(a, p)) return launch_cluster<kChunk>(a, p, s);
  return invalid;
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the cluster body lays out at Np
// padded neurons, C input channels and M streams a round.
extern "C" long long lsm_lif_cluster_smem(int Np, int C, int M) {
  return static_cast<long long>(cluster_smem_bytes(Np, C, M));
}

// How many clusters of K CTAs of the cluster body (`threads` threads and
// `smem` bytes of dynamic shared memory each) the card holds at once.
extern "C" int lsm_lif_cluster_capacity(int chunk, int K, int threads, int smem, int* out) {
  *out = 0;
  const cudaError_t err = chunk ? cluster_attributes<true>() : cluster_attributes<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(K, threads, smem, 1, nullptr, &attr);
  return static_cast<int>(
      chunk ? cudaOccupancyMaxActiveClusters(out, lif_cluster_kernel<true>, &cfg)
            : cudaOccupancyMaxActiveClusters(out, lif_cluster_kernel<false>, &cfg));
}

extern "C" int lsm_lif_stats(const uint8_t* x, const uint16_t* w_rec,
                             const uint16_t* w_in, const float* leak_keep,
                             float* stats, float* all_counts, int B, int C,
                             int T, int Np, int no, float thr, int refractory,
                             int burst_isi_max, int win_len, int n_win,
                             int body, int K, int M, int threads, int smem,
                             int clusters, void* scratch, void* stream) {
  if (B <= 0) return 0;
  LifArgs a{};
  a.x = x; a.w_rec = w_rec; a.w_in = w_in; a.leak_keep = leak_keep;
  a.stats = stats; a.all_counts = all_counts;
  a.B = B; a.C = C; a.T = T; a.Np = Np; a.no = no; a.thr = thr;
  a.refractory = refractory; a.burst_isi_max = burst_isi_max;
  a.win_len = win_len; a.n_win = n_win;
  return launch<false>(a, Plan{body, K, M, threads, smem, clusters}, scratch, stream);
}

extern "C" int lsm_lif_chunk(const uint8_t* x, const uint16_t* w_rec,
                             const uint16_t* w_in, const float* leak_keep,
                             const float* v_in, const int* refrac_in,
                             const float* s_in, float* v_out, int* refrac_out,
                             float* s_out, float* seg, float* win, int B,
                             int C, int T, int Np, int no, float thr,
                             int refractory, int burst_isi_max, int win_len,
                             int n_win, int body, int K, int M, int threads,
                             int smem, int clusters, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (win_len <= 0 || T != win_len * n_win) return static_cast<int>(cudaErrorInvalidValue);
  LifArgs a{};
  a.x = x; a.w_rec = w_rec; a.w_in = w_in; a.leak_keep = leak_keep;
  a.v_in = v_in; a.refrac_in = refrac_in; a.s_in = s_in;
  a.v_out = v_out; a.refrac_out = refrac_out; a.s_out = s_out;
  a.seg = seg; a.win = win;
  a.B = B; a.C = C; a.T = T; a.Np = Np; a.no = no; a.thr = thr;
  a.refractory = refractory; a.burst_isi_max = burst_isi_max;
  a.win_len = win_len; a.n_win = n_win;
  return launch<true>(a, Plan{body, K, M, threads, smem, clusters}, scratch, stream);
}
