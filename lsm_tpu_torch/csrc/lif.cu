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
// B4 compacts the carried spike vector before its first step, so that
// step's recurrent drive comes from the previous chunk's last spikes.
// One thread per neuron caps this body at 1024 padded neurons; a dense
// reservoir of 1025-4096 padded neurons runs on the stream-tiled block body
// of sparse_lif.cu (B5/B6) with its matrix seen as nb x nb blocks of 128,
// in the global scratch the caller passes (unused at <= 1024 neurons).

#include "lif_common.cuh"

namespace {

constexpr int MAX_N = 1024;       // this body: one thread per padded neuron
constexpr int MAX_WIDE_N = 4096;  // the block body: the largest dense draw

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

// kChunk = false: B2 (zero state, window moments, all_counts).
// kChunk = true:  B4 (carried state, segment summary, window counts).
template <bool kChunk>
__global__ void __launch_bounds__(MAX_N, 1)
lif_kernel(const LifArgs a) {
  __shared__ int rec_list[MAX_N];
  __shared__ int in_list[MAX_N];
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
  return Np <= 0 || Np > MAX_N || Np % 32 || C > Np || no > Np || T <= 0;
}

// The block body's arguments for a dense (Np, Np) matrix, row = source:
// Np / 128 slots, slot s reading source block s.
lsm::BlockLifArgs wide_args(const LifArgs& d, void* scratch) {
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
  a.win_len = d.win_len; a.n_win = d.n_win; a.scratch = scratch;
  return a;
}

// B2/B4 above 1024 padded neurons: the block body (up to MAX_WIDE_N).
int launch_wide(const LifArgs& d, bool chunk, void* scratch, void* stream) {
  if (d.Np > MAX_WIDE_N) return static_cast<int>(cudaErrorInvalidValue);
  return lsm::launch_block_lif(wide_args(d, scratch), chunk,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int lsm_lif_stats(const uint8_t* x, const uint16_t* w_rec,
                             const uint16_t* w_in, const float* leak_keep,
                             float* stats, float* all_counts, int B, int C,
                             int T, int Np, int no, float thr, int refractory,
                             int burst_isi_max, int win_len, int n_win,
                             void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (Np <= MAX_N && bad_shape(C, T, Np, no))
    return static_cast<int>(cudaErrorInvalidValue);
  LifArgs a{};
  a.x = x; a.w_rec = w_rec; a.w_in = w_in; a.leak_keep = leak_keep;
  a.stats = stats; a.all_counts = all_counts;
  a.B = B; a.C = C; a.T = T; a.Np = Np; a.no = no; a.thr = thr;
  a.refractory = refractory; a.burst_isi_max = burst_isi_max;
  a.win_len = win_len; a.n_win = n_win;
  if (Np > MAX_N) return launch_wide(a, false, scratch, stream);
  lif_kernel<false><<<B, Np, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lsm_lif_chunk(const uint8_t* x, const uint16_t* w_rec,
                             const uint16_t* w_in, const float* leak_keep,
                             const float* v_in, const int* refrac_in,
                             const float* s_in, float* v_out, int* refrac_out,
                             float* s_out, float* seg, float* win, int B,
                             int C, int T, int Np, int no, float thr,
                             int refractory, int burst_isi_max, int win_len,
                             int n_win, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if ((Np <= MAX_N && bad_shape(C, T, Np, no)) || win_len <= 0 ||
      T != win_len * n_win)
    return static_cast<int>(cudaErrorInvalidValue);
  LifArgs a{};
  a.x = x; a.w_rec = w_rec; a.w_in = w_in; a.leak_keep = leak_keep;
  a.v_in = v_in; a.refrac_in = refrac_in; a.s_in = s_in;
  a.v_out = v_out; a.refrac_out = refrac_out; a.s_out = s_out;
  a.seg = seg; a.win = win;
  a.B = B; a.C = C; a.T = T; a.Np = Np; a.no = no; a.thr = thr;
  a.refractory = refractory; a.burst_isi_max = burst_isi_max;
  a.win_len = win_len; a.n_win = n_win;
  if (Np > MAX_N) return launch_wide(a, true, scratch, stream);
  lif_kernel<true><<<B, Np, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
