// The continuous serving readout's window fold on Hopper (sm_90a): one pass
// that pushes a hop's segment summary into the nine segment rings and its
// rate-window counts into the window ring, folds the rings into
// whole-window statistics and writes the window features. One thread a
// (stream, output neuron) row.
//
// It replaces no TPU kernel: lsm_tpu's fold (models/reservoir.py
// fold_segment_stats and features_from_stats) is jnp code that XLA fuses.
// The port ran it op by op: nine torch.cat ring pushes and the window
// ring's, a Python loop of ~25 elementwise ops over each of the 10 ring
// slots and ~30 more for the features, ~380 launches a serving hop whose
// host time outlasted their device work at 1024 streams, and 2.7 ms of
// device time at 4096 streams.
//
// Bound: bytes. At 4096 streams x 400 outputs a hop reads the nine rings'
// surviving slots and the new segment (590 MB), writes the shifted rings
// (590 MB), reads and writes the window ring (131 MB) and writes the
// features (33 MB): 0.40 ms at 3.35 TB/s, against ~30 flops a row and
// slot. So the design keeps every access coalesced and reads each byte
// once:
//   - segment rings: row r = b * no + n of slot k lies at k * n_rows + r in
//     each (n_ring, B, no) ring, so consecutive threads take consecutive
//     rows and every load and store of a warp is one 128-byte line. The
//     thread walks the slots oldest first, loads the slot's nine fields
//     (nine independent loads in flight), stores them one slot older in the
//     new rings, and runs the fold's recurrence in registers. No shared
//     memory: each value is used once.
//   - window ring: (B, no, n_win) keeps a row's n_win counts together, so a
//     CTA copies its rows' contiguous stretch into shared memory with
//     coalesced loads, each thread shifts its row in place there (appending
//     the hop's counts, read coalesced from their (B, n_new, no) layout),
//     and the CTA writes the stretch back coalesced. On an H100 this pass
//     took 0.479 ms at 4096 streams and 0.122 ms at 1024, against 0.508
//     and 0.133 ms with each thread reading and writing its own row of
//     global memory (each warp store then scatters over the stretch).
//
// Arithmetic: the op order of the torch fold, each operation rounded on its
// own (__fadd_rn and __fmul_rn are never contracted into an FMA, __fdiv_rn
// is IEEE division), so the rings and features are bit-equal to the op-by-op
// path on the card. The fields other than sum_t2 are integer-valued, exact
// in float32 below 2^24 in any order; sum_t2 is summed slot by slot, as the
// torch loop does. A window mean is sum * win_factor, which the wrapper
// computes as PyTorch's CUDA mean does.
//
// The state is written out of place (the input rings are never written), so
// a snapshot that holds the old tensors stays valid. With no hop segment the
// same kernel folds the rings as they are and writes the features alone.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSeg = 9;         // SEG_KEYS, in this order:
enum Seg { kCounts, kSumT, kSumT2, kFirst, kLast, kNIsi, kSumIsi, kSumIsi2, kBursts };
constexpr int kKeys = 8;        // feature codes: FEATURE_SETS["all"]'s order
enum Key {
  kSpikeCounts, kSpikeVariances, kMeanSpikeTimes, kFirstSpikeTimes, kLastSpikeTimes,
  kMeanIsi, kIsiVariances, kBurstCounts
};
constexpr int kMaxKeys = 16;    // features a launch writes, 4 bits a code in one word
constexpr int kThreads = 128;   // rows a CTA
constexpr int kMaxSmem = 232448;

struct Rings {
  const float* in[kSeg];        // (n_ring, n_rows) each, slot 0 oldest
  const float* fresh[kSeg];     // (n_rows) each: the hop's segment (push only)
  float* out[kSeg];             // (n_ring, n_rows) each: the pushed rings (push only)
};

__global__ void __launch_bounds__(kThreads) fold_kernel(
    const Rings rg, bool push, int n_ring, long long n_rows, int no, int seg_len,
    float burst_isi_max, const float* __restrict__ win_in, const float* __restrict__ win_fresh,
    float* __restrict__ win_out, int n_win, int n_fresh, float win_factor,
    unsigned long long keys, int n_keys, float* __restrict__ feats) {
  extern __shared__ float wbuf[];       // [rows][n_win]: the CTA's window rows
  const int j = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(n_rows - r0 < kThreads ? n_rows - r0 : kThreads);
  const long long r = r0 + j;
  const bool live = j < rows;
  const long long b = r / no;
  const int n = static_cast<int>(r - b * no);

  // Window ring: in, shifted in place (push), out; the row's sum and sum of
  // squares for the rate-window variance.
  const int span = rows * n_win;
  for (int e = j; e < span; e += kThreads) wbuf[e] = win_in[r0 * n_win + e];
  __syncthreads();
  float wsum = 0.0f, wsq = 0.0f;
  if (live) {
    float* row = wbuf + j * n_win;
    const int n_keep = n_win - n_fresh;
    for (int t = 0; t < n_win; ++t) {
      const float w = t < n_keep ? row[t + n_fresh]
                                 : __ldg(win_fresh + (b * n_fresh + (t - n_keep)) * no + n);
      if (push) row[t] = w;              // reads run ahead of the writes
      wsum = __fadd_rn(wsum, w);
      wsq = __fadd_rn(wsq, __fmul_rn(w, w));
    }
  }
  if (push) {
    __syncthreads();
    for (int e = j; e < span; e += kThreads) win_out[r0 * n_win + e] = wbuf[e];
  }
  if (!live) return;

  // Segment rings: slot k of the pushed ring is slot k + 1 of the old one,
  // the hop's segment last; the fold's recurrence over the slots.
  const float inf = __int_as_float(0x7f800000);
  float counts = 0.0f, sum_t = 0.0f, sum_t2 = 0.0f, first = inf, last = -1.0f;
  float n_isi = 0.0f, sum_isi = 0.0f, sum_isi2 = 0.0f, bursts = 0.0f, carry = -1.0f;
  const int shift = push ? 1 : 0;
  for (int k = 0; k < n_ring; ++k) {
    const bool fresh = k + shift == n_ring;
    const long long src = static_cast<long long>(k + shift) * n_rows + r;
    float v[kSeg];
#pragma unroll
    for (int f = 0; f < kSeg; ++f) v[f] = fresh ? __ldg(rg.fresh[f] + r) : __ldg(rg.in[f] + src);
    if (push) {
      const long long dst = static_cast<long long>(k) * n_rows + r;
#pragma unroll
      for (int f = 0; f < kSeg; ++f) rg.out[f][dst] = v[f];
    }
    // The torch loop's Python scalars, each rounded to float32 as a CUDA
    // kernel takes a host scalar.
    const double offd = static_cast<double>(k) * seg_len;
    const float off = __double2float_rn(offd);
    const float off2 = __double2float_rn(2.0 * offd);
    const float offsq = __double2float_rn(offd * offd);
    const float ck = v[kCounts];
    counts = __fadd_rn(counts, ck);
    n_isi = __fadd_rn(n_isi, v[kNIsi]);
    sum_isi = __fadd_rn(sum_isi, v[kSumIsi]);
    sum_isi2 = __fadd_rn(sum_isi2, v[kSumIsi2]);
    bursts = __fadd_rn(bursts, v[kBursts]);
    sum_t = __fadd_rn(__fadd_rn(sum_t, v[kSumT]), __fmul_rn(off, ck));
    sum_t2 = __fadd_rn(__fadd_rn(__fadd_rn(sum_t2, v[kSumT2]), __fmul_rn(off2, v[kSumT])),
                       __fmul_rn(offsq, ck));
    const bool has = ck > 0.0f;
    const float fk = __fadd_rn(v[kFirst], off);   // inf stays inf when silent
    const float lk = __fadd_rn(v[kLast], off);
    first = fminf(first, has ? fk : inf);
    last = fmaxf(last, has ? lk : -1.0f);
    const bool cross = has && carry >= 0.0f;
    const float isi = cross ? __fsub_rn(fk, carry) : 0.0f;
    n_isi = __fadd_rn(n_isi, cross ? 1.0f : 0.0f);
    sum_isi = __fadd_rn(sum_isi, isi);
    sum_isi2 = __fadd_rn(sum_isi2, __fmul_rn(isi, isi));
    bursts = __fadd_rn(bursts, cross && isi <= burst_isi_max ? 1.0f : 0.0f);
    carry = has ? lk : carry;
  }

  // Features, in the order of `keys`; silent neurons (and ISI features
  // without an interval) read 0.
  const bool fired = counts > 0.0f;
  const bool has_isi = n_isi > 0.0f;
  const float safe_n_isi = fmaxf(n_isi, 1.0f);
  const float mean_isi = __fdiv_rn(sum_isi, safe_n_isi);
  const float win_mean = __fmul_rn(wsum, win_factor);
  const float win_var = __fsub_rn(__fmul_rn(wsq, win_factor), __fmul_rn(win_mean, win_mean));
  float* o = feats + b * static_cast<long long>(n_keys) * no + n;
  for (int q = 0; q < n_keys; ++q) {
    float x = 0.0f;
    switch (static_cast<int>((keys >> (4 * q)) & 15u)) {
      case kSpikeCounts: x = counts; break;
      case kSpikeVariances: x = fired ? fmaxf(win_var, 0.0f) : 0.0f; break;
      case kMeanSpikeTimes: x = fired ? __fdiv_rn(sum_t, fmaxf(counts, 1.0f)) : 0.0f; break;
      case kFirstSpikeTimes: x = fired ? first : 0.0f; break;
      case kLastSpikeTimes: x = fired ? last : 0.0f; break;
      case kMeanIsi: x = has_isi ? mean_isi : 0.0f; break;
      case kIsiVariances:
        x = has_isi ? fmaxf(__fsub_rn(__fdiv_rn(sum_isi2, safe_n_isi),
                                      __fmul_rn(mean_isi, mean_isi)), 0.0f)
                    : 0.0f;
        break;
      case kBurstCounts: x = bursts; break;
    }
    o[static_cast<long long>(q) * no] = x;
  }
}

}  // namespace

// Window features (B, n_keys * no) from the nine (n_ring, B, no) segment
// rings seg_in[] and the (B, no, n_win) window ring, n_rows = B * no. With
// seg_fresh[] (nine (B, no) fields of the hop's segment) and win_fresh
// (B, n_fresh, no), the rings are pushed first and written to seg_out[]
// and win_out; with seg_fresh null the rings are folded as they are (and
// seg_out, win_fresh, win_out, n_fresh are not read). keys: n_keys codes of
// FEATURE_SETS["all"]'s order. win_factor: the float32 factor of a mean
// over n_win.
extern "C" int lsm_fold_window(const float* const* seg_in, const float* const* seg_fresh,
                               float* const* seg_out, int n_ring, long long n_rows, int no,
                               int seg_len, float burst_isi_max, const float* win_in,
                               const float* win_fresh, float* win_out, int n_win, int n_fresh,
                               float win_factor, const int* keys, int n_keys, float* feats,
                               void* stream) {
  const bool push = seg_fresh != nullptr;
  if (n_ring < 1 || n_rows < 0 || no < 1 || n_rows % no != 0 || seg_len < 1 || n_win < 1 ||
      n_keys < 1 || n_keys > kMaxKeys || static_cast<size_t>(n_win) * kThreads *
      sizeof(float) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (push ? (n_fresh < 1 || n_fresh > n_win || seg_out == nullptr || win_fresh == nullptr ||
              win_out == nullptr)
           : n_fresh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Rings rg{};
  unsigned long long kc = 0;
  for (int f = 0; f < kSeg; ++f) {
    rg.in[f] = seg_in[f];
    rg.fresh[f] = push ? seg_fresh[f] : nullptr;
    rg.out[f] = push ? seg_out[f] : nullptr;
  }
  for (int q = 0; q < n_keys; ++q) {
    if (keys[q] < 0 || keys[q] >= kKeys) return static_cast<int>(cudaErrorInvalidValue);
    kc |= static_cast<unsigned long long>(keys[q]) << (4 * q);
  }
  if (n_rows == 0) return 0;
  const size_t smem = static_cast<size_t>(n_win) * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n_rows + kThreads - 1) / kThreads));
  fold_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rg, push, n_ring, n_rows, no, seg_len, burst_isi_max, win_in, win_fresh, win_out, n_win,
      push ? n_fresh : 0, win_factor, kc, n_keys, feats);
  return static_cast<int>(cudaGetLastError());
}
