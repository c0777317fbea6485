// Shared by lif.cu (B2, B4) and sparse_lif.cu (B5, B6): the bf16 weight
// read, the output neurons' streaming spike statistics, and the arguments of
// the block-structured LIF kernel that runs the block-sparse reservoir and
// the dense one above 1024 padded neurons.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lsm {

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// The spike statistics of one output neuron, times relative to the start of
// the call: counts, spike-time moments, first/last spike, ISI moments and
// bursts (ISI <= burst_isi_max).
// kChunk = false (B2, B5): windowed-rate moments; the first n_win-1 windows
//   are win_len steps and every later step folds into the last window.
// kChunk = true (B4, B6): each window's count is written every win_len steps
//   (the caller makes T a multiple of win_len), no folding.
template <bool kChunk>
struct OutputStats {
  float counts = 0.f, sum_t = 0.f, sum_t2 = 0.f, first = INFINITY, last = -1.f;
  float n_isi = 0.f, sum_isi = 0.f, sum_isi2 = 0.f, bursts = 0.f;
  float prev_t = -1.f, c_cur = 0.f, win_sum = 0.f, win_sum2 = 0.f;

  // win: B4/B6 only, this neuron's element of window 0 in (B, n_win, no).
  __device__ __forceinline__ void step(bool spike, int t, int T, float isi_max,
                                       int win_len, int n_win, float* win,
                                       int no) {
    bool boundary;
    if (kChunk) {
      boundary = (t + 1) % win_len == 0;
      if (boundary) win += (size_t)((t + 1) / win_len - 1) * no;
    } else {
      boundary = (((t + 1) % win_len == 0) && ((t + 1) / win_len < n_win)) || t == T - 1;
    }
    step_at(spike, static_cast<float>(t), isi_max, boundary, win);
  }

  // step() with the window boundary given: at a boundary B4/B6 write the
  // window's count to *win (this window's element), B2/B5 fold it into
  // the window moments.
  __device__ __forceinline__ void step_at(bool spike, float tf, float isi_max, bool boundary,
                                          float* win) {
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
    if (boundary) {
      if (kChunk) {
        *win = c_cur;
      } else {
        win_sum += c_cur;
        win_sum2 += c_cur * c_cur;
      }
      c_cur = 0.f;
    }
  }

  // dst: (11, B, no) for B2/B5, (9, B, no) for B4/B6; o = b * no + n.
  __device__ __forceinline__ void write(float* dst, size_t plane,
                                        size_t o) const {
    dst[0 * plane + o] = counts;
    dst[1 * plane + o] = sum_t;
    dst[2 * plane + o] = sum_t2;
    dst[3 * plane + o] = first;
    dst[4 * plane + o] = last;
    dst[5 * plane + o] = n_isi;
    dst[6 * plane + o] = sum_isi;
    dst[7 * plane + o] = sum_isi2;
    dst[8 * plane + o] = bursts;
    if (!kChunk) {
      dst[9 * plane + o] = win_sum;
      dst[10 * plane + o] = win_sum2;
    }
  }
};

// The block-structured LIF (sparse_lif.cu), one kernel launch a step. The
// recurrent weights are seen as 128 x 128 blocks: destination block j reads
// S slots, slot s from source block src_idx[j, s], and its bf16 weight from
// source lane r to destination lane l sits at
// w[j * stride_j + s * stride_s + r * stride_r + l]. The block-sparse
// reservoir stores (nb, S, 128, 128); a dense (N, N) matrix with row =
// source is the case S = nb, src_idx = nullptr (slot s reads block s),
// stride_j = 128, stride_s = 128 N, stride_r = N. Each call first copies the
// blocks K-major into its scratch, so any strides and alignment will do.
struct BlockLifArgs {
  const uint8_t* x;          // (B, C, T) 0/1
  const uint16_t* w;         // recurrent weights, bf16 bits
  const int* src_idx;        // (nb, S) int32, or nullptr
  const uint16_t* w_in;      // (Cp, N) bf16 bits
  const float* leak_keep;    // (N,) 1 - leak
  float* stats;              // B5: (11, B, no)
  float* all_counts;         // B5: (B, N)
  const float* v_in;         // B6: (B, N) carried state in
  const int* refrac_in;
  const float* s_in;
  float* v_out;              // B6: (B, N) state out
  int* refrac_out;
  float* s_out;
  float* seg;                // B6: (9, B, no) segment summary
  float* win;                // B6: (B, n_win, no) rate-window counts
  void* scratch;             // block_lif_scratch_bytes() of global scratch
  long long stride_j, stride_s, stride_r;
  int B, C, T, N, S, no;
  float thr;
  int refractory, burst_isi_max, win_len, n_win;
  int tile;                  // streams a CTA, 64 or 128, as the host's plan picks it
};

// The body keeps refrac between steps in 8 bits up to refractory 255 and in
// 16 bits above, so it takes refractory <= 65535.
constexpr int kMaxRefractory = 65535;

// Launch on `stream`; returns a cudaError_t (cudaErrorInvalidValue for a
// shape the kernel does not take, before any launch).
int launch_block_lif(const BlockLifArgs& a, bool chunk, cudaStream_t stream);

// Bytes of global scratch one launch_block_lif call needs.
size_t block_lif_scratch_bytes(int B, int C, int T, int N, int S, int no, bool chunk,
                               int refractory);

}  // namespace lsm
