// Kernels B5 and B6: the block-sparse LIF reservoir with streaming spike
// statistics on Hopper (sm_90a), one templated body.
//
// B5 (kChunk = false) replaces lsm_tpu/ops/pallas/sparse_lif_kernel.py:54
// _sparse_lif_kernel: T steps from a zero state, windowed-rate moments and
// all_counts. B6 (kChunk = true) replaces
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
// What bounds it on an H100: at 10240 neurons the bf16 blocks are 34 MB,
// which fits the 50 MB L2 but no SM's 227 KB of shared memory, and every
// block reads R random partner blocks, so all N neurons of one utterance
// must finish step t before any starts step t + 1. The work, one add per
// recurrent edge of a neuron that fired, is a few GFLOP; the time goes to
// the L2 latency of the weight reads and the per-step block barriers.
//
// Design: B2's widened (of the two designs open, the simpler; a thread-block
// cluster exchanging spikes through distributed shared memory is left for a
// later PR). One CTA of 1024 threads per utterance or stream for all steps;
// thread i owns neurons i + 1024 m, so each warp holds 32 consecutive
// neurons of one block and its weight reads are coalesced, and the output
// neurons (n < no <= 1024) sit on distinct threads at m = 0, whose
// statistics stay in registers. v, refrac and all_counts live in shared
// memory (12 B a neuron). Each step compacts the neurons and input channels
// that fired into ascending lists in shared memory; as the neuron list is
// ascending, the fired neurons of source block a form one run, whose start
// is the list offset of its first warp slice. The thread of (j, lane) then
// adds w[j, s, r, lane] for each slot s and each fired lane r of block
// src_idx[j, s], and w_in[c, n] for each fired channel c: only the weight
// rows of sources that fired are read (~1 % of the block weights a step at
// the EDGE regime). No atomics: sums run in a fixed order, so results are
// deterministic, and bit-equal to any order when weights are dyadic. The
// product and the sum of the membrane update round separately (__fmul_rn,
// __fadd_rn), as the plain twin's do. B6 compacts the carried spike vector
// before its first step, so that step's recurrent drive comes from the
// previous chunk's last spikes.

#include "lif_common.cuh"

namespace lsm {
namespace {

constexpr int kThreads = 1024;       // one CTA; thread i owns neurons i + 1024 m
constexpr int kMaxChannels = 1024;   // input channels: one flag per thread

__host__ __device__ inline int warp_slices(int N) {
  return (N + kThreads - 1) / kThreads * 32;
}

// Shared memory of one CTA, in the order the kernel lays it out.
size_t smem_bytes(int N, int S, bool chunk, bool has_src) {
  const size_t nb = N / 128, E = warp_slices(N);
  const size_t words = (size_t)N * (chunk ? 2 : 3)   // v, refrac (, all_counts)
                       + (has_src ? nb * S : 0)      // src_idx
                       + 2 * E + 66;                 // slice counts and offsets
  return 4 * words + 2 * ((size_t)N + kMaxChannels); // the two index lists
}

// Block-wide compaction of each thread's spike flags (bit m: neuron
// tid + 1024 m) and its input-channel flag (channel tid) into ascending
// index lists. On return off[g] (g < E) is where the fired neurons of warp
// slice g, neurons [32 g, 32 g + 32), start in rec_list and off[E] is their
// total; off[E + 1 + w] is where the channels of warp w start in in_list
// and off[E + 33] their total. Three barriers; the first one also orders
// every read of the previous lists before they are overwritten.
__device__ __forceinline__ void compact(unsigned flags, bool f_in, int npt,
                                        int E, int* cnt, int* off,
                                        uint16_t* rec_list,
                                        uint16_t* in_list) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int m = 0; m < npt; ++m) {
    const unsigned b = __ballot_sync(0xffffffffu, (flags >> m) & 1u);
    if (lane == 0) cnt[m * 32 + warp] = __popc(b);
  }
  const unsigned bi = __ballot_sync(0xffffffffu, f_in);
  if (lane == 0) cnt[E + warp] = __popc(bi);
  __syncthreads();
  if (warp < 2) {
    // Warp 0 scans the E neuron slices (npt consecutive a lane), warp 1 the
    // 32 channel warps.
    const int per = warp == 0 ? npt : 1;
    const int* c = warp == 0 ? cnt : cnt + E;
    int* o = warp == 0 ? off : off + E + 1;
    int local = 0;
    for (int i = 0; i < per; ++i) local += c[lane * per + i];
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - local;
    for (int i = 0; i < per; ++i) {
      o[lane * per + i] = run;
      run += c[lane * per + i];
    }
    if (lane == 31) o[32 * per] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int m = 0; m < npt; ++m) {
    const bool f = (flags >> m) & 1u;
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (f) rec_list[off[m * 32 + warp] + __popc(b & below)] = tid + kThreads * m;
  }
  if (f_in) in_list[off[E + 1 + warp] + __popc(bi & below)] = tid;
  __syncthreads();
}

template <bool kChunk>
__global__ void __launch_bounds__(kThreads, 1)
block_lif_kernel(const BlockLifArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, S = a.S, T = a.T, C = a.C, no = a.no;
  const int nb = N >> 7;
  const int npt = (N + kThreads - 1) / kThreads;
  const int E = warp_slices(N);
  float* v_s = reinterpret_cast<float*>(smem);
  int* rf_s = reinterpret_cast<int*>(v_s + N);
  float* allc_s = reinterpret_cast<float*>(rf_s + N);
  int* src_s = reinterpret_cast<int*>(allc_s + (kChunk ? 0 : N));
  int* cnt = src_s + (a.src_idx ? nb * S : 0);     // E + 32
  int* off = cnt + E + 32;                         // E + 1 + 33
  uint16_t* rec_list = reinterpret_cast<uint16_t*>(off + E + 34);  // N
  uint16_t* in_list = rec_list + N;                // kMaxChannels

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * N;
  const uint8_t* xb = a.x + (size_t)b * C * T;
  const float isi_max = static_cast<float>(a.burst_isi_max);

  if (a.src_idx)
    for (int i = tid; i < nb * S; i += kThreads) src_s[i] = a.src_idx[i];
  unsigned fired = 0;
  for (int m = 0; m < npt; ++m) {
    const int n = tid + kThreads * m;
    if (n >= N) break;
    v_s[n] = kChunk ? a.v_in[row + n] : 0.f;
    rf_s[n] = kChunk ? a.refrac_in[row + n] : 0;
    if (!kChunk) allc_s[n] = 0.f;
    if (kChunk && a.s_in[row + n] != 0.f) fired |= 1u << m;
  }
  OutputStats<kChunk> st;
  float* win_row = kChunk ? a.win + (size_t)b * a.n_win * no + tid : nullptr;
  compact(fired, tid < C && xb[(size_t)tid * T] != 0, npt, E, cnt, off,
          rec_list, in_list);

  for (int t = 0; t < T; ++t) {
    const int n_in = off[E + 33];
    fired = 0;
    for (int m = 0; m < npt; ++m) {
      const int n = tid + kThreads * m;
      if (n >= N) break;                 // warp-uniform: N % 128 == 0
      const int j = n >> 7, lane = n & 127;
      const uint16_t* wj = a.w + j * a.stride_j + lane;
      float acc_r = 0.f;
      for (int s = 0; s < S; ++s) {
        const int src = a.src_idx ? src_s[j * S + s] : s;
        const int base = src << 7;
        const uint16_t* ws = wj + s * a.stride_s;
        const int end = off[4 * src + 4];
#pragma unroll 4
        for (int i = off[4 * src]; i < end; ++i)
          acc_r += bf16_bits_to_float(ws[(rec_list[i] - base) * a.stride_r]);
      }
      float acc_i = 0.f;
#pragma unroll 4
      for (int i = 0; i < n_in; ++i)
        acc_i += bf16_bits_to_float(a.w_in[(size_t)in_list[i] * N + n]);
      const float drive = acc_r + acc_i;

      const int refrac = rf_s[n];
      const bool active = refrac == 0;
      // No FMA contraction: the plain twin rounds the product and the sum.
      const float v_new =
          active ? __fadd_rn(__fmul_rn(v_s[n], a.leak_keep[n]), drive) : 0.f;
      const bool spike = active && v_new >= a.thr;
      v_s[n] = spike ? 0.f : v_new;
      rf_s[n] = spike ? a.refractory : max(refrac - 1, 0);
      if (spike) fired |= 1u << m;
      if (!kChunk && spike) allc_s[n] += 1.f;
      if (m == 0 && n < no)
        st.step(spike, t, T, isi_max, a.win_len, a.n_win, win_row, no);
    }
    const bool next_in = (t + 1 < T) && tid < C && xb[(size_t)tid * T + t + 1] != 0;
    compact(fired, next_in, npt, E, cnt, off, rec_list, in_list);
  }

  for (int m = 0; m < npt; ++m) {
    const int n = tid + kThreads * m;
    if (n >= N) break;
    if (kChunk) {
      a.v_out[row + n] = v_s[n];
      a.refrac_out[row + n] = rf_s[n];
      a.s_out[row + n] = (fired >> m) & 1u ? 1.f : 0.f;
    } else {
      a.all_counts[row + n] = allc_s[n];
    }
  }
  if (tid < no) st.write(kChunk ? a.seg : a.stats, (size_t)a.B * no, (size_t)b * no + tid);
}

}  // namespace

int launch_block_lif(const BlockLifArgs& a, bool chunk, cudaStream_t stream) {
  if (a.B <= 0) return 0;
  const size_t smem = smem_bytes(a.N, a.S, chunk, a.src_idx != nullptr);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (a.N <= 0 || a.N % 128 || a.S <= 0 || a.C > kMaxChannels || a.C > a.N ||
      a.no <= 0 || a.no > kThreads || a.no > a.N || a.T <= 0 ||
      warp_slices(a.N) / 32 > 32 || smem > (size_t)smem_max ||
      (chunk && (a.win_len <= 0 || a.T != a.win_len * a.n_win)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk) {
    cudaFuncSetAttribute(block_lif_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    block_lif_kernel<true><<<a.B, kThreads, smem, stream>>>(a);
  } else {
    cudaFuncSetAttribute(block_lif_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    block_lif_kernel<false><<<a.B, kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lsm

namespace {

lsm::BlockLifArgs sparse_args(const uint8_t* x, const uint16_t* w_blocks,
                              const int* src_idx, const uint16_t* w_in,
                              const float* leak_keep, int B, int C, int T,
                              int N, int S, int no, float thr, int refractory,
                              int burst_isi_max, int win_len, int n_win) {
  lsm::BlockLifArgs a{};
  a.x = x; a.w = w_blocks; a.src_idx = src_idx; a.w_in = w_in;
  a.leak_keep = leak_keep;
  a.stride_r = 128;                       // w_blocks (nb, S, 128, 128)
  a.stride_s = 128LL * 128;
  a.stride_j = (long long)S * 128 * 128;
  a.B = B; a.C = C; a.T = T; a.N = N; a.S = S; a.no = no; a.thr = thr;
  a.refractory = refractory; a.burst_isi_max = burst_isi_max;
  a.win_len = win_len; a.n_win = n_win;
  return a;
}

}  // namespace

// Bytes of shared memory one CTA of the block kernel needs, and what a
// block may have on the current card (the wrappers compare the two before a
// launch, so that a reservoir too wide for the kernel raises a ValueError).
extern "C" int lsm_block_lif_smem(int N, int S, int chunk, int has_src) {
  return static_cast<int>(lsm::smem_bytes(N, S, chunk != 0, has_src != 0));
}

extern "C" int lsm_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

extern "C" int lsm_sparse_lif_stats(const uint8_t* x, const uint16_t* w_blocks,
                                    const int* src_idx, const uint16_t* w_in,
                                    const float* leak_keep, float* stats,
                                    float* all_counts, int B, int C, int T,
                                    int N, int S, int no, float thr,
                                    int refractory, int burst_isi_max,
                                    int win_len, int n_win, void* stream) {
  lsm::BlockLifArgs a = sparse_args(x, w_blocks, src_idx, w_in, leak_keep, B, C,
                                    T, N, S, no, thr, refractory,
                                    burst_isi_max, win_len, n_win);
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
                                    int win_len, int n_win, void* stream) {
  lsm::BlockLifArgs a = sparse_args(x, w_blocks, src_idx, w_in, leak_keep, B, C,
                                    T, N, S, no, thr, refractory,
                                    burst_isi_max, win_len, n_win);
  a.v_in = v_in; a.refrac_in = refrac_in; a.s_in = s_in;
  a.v_out = v_out; a.refrac_out = refrac_out; a.s_out = s_out;
  a.seg = seg; a.win = win;
  return lsm::launch_block_lif(a, true, static_cast<cudaStream_t>(stream));
}
