// Kernel B2: fused dense LIF reservoir with streaming spike statistics on
// Hopper (sm_90a).
//
// Replaces lsm_tpu/ops/pallas/lif_kernel.py:46 _lif_kernel. Per step t:
//
//     drive = s_prev . bf16(W_rec) + x_t . bf16(W_in)      (f32 accumulate)
//     v     = refrac == 0 ? v * (1 - leak) + drive : 0
//     spike = refrac == 0 && v >= threshold;  reset v = 0, refrac = R
//
// and the output neurons (n < n_outputs) accumulate counts, spike-time
// moments, first/last spike, ISI moments, bursts (ISI <= burst_isi_max)
// and windowed-rate moments; every neuron accumulates all_counts.
//
// Design: the TPU kept W_rec (2 MB bf16) resident in VMEM; a Hopper SM has
// 227 KB of shared memory, so W streams from L2 (50 MB) instead. One CTA
// owns one batch row for all T steps, one thread per neuron: v, refrac
// and the statistics live in registers, and each step's spike vector is
// compacted in shared memory into a list of the neurons (and input
// channels) that fired. Spikes are 0/1, so the drive is a sum of the W rows
// of the sources that fired: each step reads only those rows (2 KB each,
// coalesced across the block) instead of the whole matrix. Bound: L2 load
// latency of those row reads and the two block barriers per step.
// No atomics: the sums run in ascending source order, so results are
// deterministic, and bit-equal to any order when weights are dyadic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 1024;

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Block-wide stream compaction of two flag sets into ascending index lists.
// Two barriers; on return both lists and their lengths are visible to all.
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

__global__ void __launch_bounds__(MAX_N, 1)
lif_stats_kernel(const uint8_t* __restrict__ x,          // (B, C, T)
                 const uint16_t* __restrict__ w_rec,     // (Np, Np) bf16
                 const uint16_t* __restrict__ w_in,      // (Cp, Np) bf16
                 const float* __restrict__ leak_keep,    // (Np,)
                 float* __restrict__ stats,              // (11, B, no)
                 float* __restrict__ all_counts,         // (B, Np)
                 int B, int C, int T, int Np, int no, float thr,
                 int refractory, int burst_isi_max, int win_len, int n_win) {
  __shared__ int rec_list[MAX_N];
  __shared__ int in_list[MAX_N];
  __shared__ int cnt_rec[MAX_N / 32];
  __shared__ int cnt_in[MAX_N / 32];

  const int n = threadIdx.x;
  const int b = blockIdx.x;
  const uint8_t* xb = x + (size_t)b * C * T;
  const float lk = leak_keep[n];
  const float isi_max = static_cast<float>(burst_isi_max);

  float v = 0.f;
  int refrac = 0;
  float counts = 0.f, sum_t = 0.f, sum_t2 = 0.f, first = INFINITY, last = -1.f;
  float n_isi = 0.f, sum_isi = 0.f, sum_isi2 = 0.f, bursts = 0.f;
  float prev_t = -1.f, c_cur = 0.f, win_sum = 0.f, win_sum2 = 0.f, allc = 0.f;

  int n_rec = 0, n_in = 0;
  compact2(false, n < C && xb[(size_t)n * T] != 0, n, rec_list, in_list,
           cnt_rec, cnt_in, n_rec, n_in);

  for (int t = 0; t < T; ++t) {
    float acc_r = 0.f, acc_i = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_rec; ++i)
      acc_r += bf16_bits_to_float(w_rec[(size_t)rec_list[i] * Np + n]);
#pragma unroll 4
    for (int i = 0; i < n_in; ++i)
      acc_i += bf16_bits_to_float(w_in[(size_t)in_list[i] * Np + n]);
    const float drive = acc_r + acc_i;

    const bool active = refrac == 0;
    // No FMA contraction: the plain twin rounds the product and the sum.
    const float v_new = active ? __fadd_rn(__fmul_rn(v, lk), drive) : 0.f;
    const bool spike = active && v_new >= thr;
    v = spike ? 0.f : v_new;
    refrac = spike ? refractory : max(refrac - 1, 0);

    if (spike) allc += 1.f;
    if (n < no) {
      const float tf = static_cast<float>(t);
      if (spike) {
        counts += 1.f;
        sum_t += tf;
        sum_t2 += tf * tf;
        first = fminf(first, tf);
        last = fmaxf(last, tf);
        if (prev_t >= 0.f) {
          const float isi = tf - prev_t;
          n_isi += 1.f;
          sum_isi += isi;
          sum_isi2 += isi * isi;
          if (isi <= isi_max) bursts += 1.f;
        }
        prev_t = tf;
        c_cur += 1.f;
      }
      // The first n_win-1 windows are win_len steps; every later step
      // folds into the last window.
      const bool boundary =
          (((t + 1) % win_len == 0) && ((t + 1) / win_len < n_win)) || t == T - 1;
      if (boundary) {
        win_sum += c_cur;
        win_sum2 += c_cur * c_cur;
        c_cur = 0.f;
      }
    }
    const bool next_in = (t + 1 < T) && n < C && xb[(size_t)n * T + t + 1] != 0;
    compact2(spike, next_in, n, rec_list, in_list, cnt_rec, cnt_in, n_rec, n_in);
  }

  all_counts[(size_t)b * Np + n] = allc;
  if (n < no) {
    const size_t plane = (size_t)B * no, o = (size_t)b * no + n;
    stats[0 * plane + o] = counts;
    stats[1 * plane + o] = sum_t;
    stats[2 * plane + o] = sum_t2;
    stats[3 * plane + o] = first;
    stats[4 * plane + o] = last;
    stats[5 * plane + o] = n_isi;
    stats[6 * plane + o] = sum_isi;
    stats[7 * plane + o] = sum_isi2;
    stats[8 * plane + o] = bursts;
    stats[9 * plane + o] = win_sum;
    stats[10 * plane + o] = win_sum2;
  }
}

}  // namespace

extern "C" int lsm_lif_stats(const uint8_t* x, const uint16_t* w_rec,
                             const uint16_t* w_in, const float* leak_keep,
                             float* stats, float* all_counts, int B, int C,
                             int T, int Np, int no, float thr, int refractory,
                             int burst_isi_max, int win_len, int n_win,
                             void* stream) {
  if (B <= 0) return 0;
  if (Np <= 0 || Np > MAX_N || Np % 32 || C > Np || no > Np || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  lif_stats_kernel<<<B, Np, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w_rec, w_in, leak_keep, stats, all_counts, B, C, T, Np, no, thr,
      refractory, burst_isi_max, win_len, n_win);
  return static_cast<int>(cudaGetLastError());
}
