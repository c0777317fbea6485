// The multi-threshold hysteresis (Schmitt-trigger) spike encoder on Hopper
// (sm_90a): one pass over the spectrogram, one thread a (row, filter) scan.
//
// It replaces no TPU kernel: lsm_tpu/ops/hysteresis.py is jnp code (an
// associative scan that XLA fuses). The port's first version was a Python
// loop over the time bins, two broadcast comparisons and a transposing uint8
// copy: ~3 launches a bin and five passes over (rows, thresholds, filters,
// bins) of bool, 12.5 ms at 2400 utterances of 128 filters x 100 bins, where
// reading the spectrogram once and writing the spikes once takes 0.073 ms at
// 3.35 TB/s. This kernel is that one pass.
//
// Per threshold k (descending; lower_k = f32(thr_k) - f32(gap), both
// computed on the host and passed as launch arguments, so no call copies
// anything to the device), on float32 values:
//
//     active_k = (x > thr_k) | (active_k & (x >= lower_k))
//
// NaN compares false both ways and turns every trigger off, as in the loop.
// The triggers of one (row, filter) live in a register bitmask, up to 32
// thresholds; the state carried between chunks is (B, n_thr, F) bool, read
// from state_in (or all off when it is null) and written to a separate
// state_out (when it is not null), never in place.
//
// Bound: bytes. Each element costs a handful of compares against the 8 bytes
// it moves at four thresholds (4 read, 4 written), so the design is about
// keeping both directions coalesced whatever the input layout. A CTA owns 64
// consecutive output rows r = b * F + f and walks the bins in tiles of up to
// 128, one tile when T <= 128 (the batch path's 100 bins, a serving hop's
// 10):
//   - load: the tile is copied into shared memory with cp.async, consecutive
//     threads on the input's unit-stride axis: bins when the time stride is 1
//     (the batch path's contiguous (B, F, T) spectrogram, where a one-tile
//     CTA reads one contiguous run), rows otherwise (the serving engine's
//     (B, F, T) view of a contiguous (T, B, F) tensor, filters contiguous).
//     Any element strides are taken, so neither layout is copied first, and
//     the copies hold no registers, so every element of the tile is in
//     flight at once.
//   - scan: thread j runs row j's triggers over the tile's bins, down a
//     column of the tile (conflict-free, rows padded to 65 words), writing
//     each bin's mask over the value it read.
//   - store: the spikes are interleaved, column t * n_thr + k of row r, so a
//     one-tile CTA's output is one contiguous run. At four thresholds one
//     (row, bin) is one 32-bit word, written by consecutive threads on
//     consecutive words; at other counts byte by byte, as coalesced.
// On an H100 at 2400 x 128 x 100, whole-row tiles copied by cp.async took
// 0.113 ms in a trial against 0.205 ms for 128-row CTAs that staged 32-bin
// tiles through registers; a plain copy of the spectrogram takes 0.084 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThr = 32;    // triggers in one 32-bit mask
constexpr int kRows = 64;      // (row, filter) scans a CTA, one a thread
constexpr int kMaxBins = 128;  // time bins a tile: 33 KB of shared memory at most

struct Levels {
  float on[kMaxThr];           // thresholds, descending
  float off[kMaxThr];          // on - gap, in float32
};

__device__ __forceinline__ void cp_async4(void* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Bits 0..3 of m as the bytes of one little-endian word: 0 or 1 each.
__device__ __forceinline__ uint32_t spread4(uint32_t m) {
  return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

// Steps (major, minor) of a flattened index e = major * extent + minor by
// kRows, given kRows = d_major * extent + d_minor.
__device__ __forceinline__ void advance(int& major, int& minor, int d_major, int d_minor,
                                        int extent) {
  minor += d_minor;
  major += d_major;
  if (minor >= extent) {
    minor -= extent;
    ++major;
  }
}

// kCap >= n_thr bounds the trigger loop at compile time (4 or 32).
template <int kCap>
__global__ void __launch_bounds__(kRows) hysteresis_kernel(
    const float* __restrict__ x, long long sB, long long sF, long long sT, int F, int T,
    int tile_bins, long long n_rows, int n_thr, const Levels lv,
    const uint8_t* __restrict__ state_in, uint8_t* __restrict__ state_out,
    uint8_t* __restrict__ out) {
  extern __shared__ uint32_t tile[];     // [tile_bins][kRows + 1]: values in, masks out
  __shared__ long long s_base[kRows];

  const int j = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n_rows - r0 < kRows ? n_rows - r0 : kRows);
  const long long b = (r0 + j) / F;
  const int f = static_cast<int>((r0 + j) - b * F);
  uint32_t m = 0;
  if (j < rows) {
    s_base[j] = b * sB + f * sF;
    if (state_in != nullptr) {
      for (int k = 0; k < n_thr; ++k)
        m |= static_cast<uint32_t>(state_in[(b * n_thr + k) * F + f] != 0) << k;
    }
  }
  __syncthreads();

  const bool bins_fast = sT == 1;
  const int row_bytes = T * n_thr;       // the entry point keeps this below 2^31
  for (int t0 = 0; t0 < T; t0 += tile_bins) {
    const int tt = T - t0 < tile_bins ? T - t0 : tile_bins;
    const int n = rows * tt;

    // Load: e runs over the tile with the unit-stride axis minor.
    {
      const int extent = bins_fast ? tt : rows;
      int major = j / extent, minor = j - (j / extent) * extent;
      const int d_major = kRows / extent, d_minor = kRows - (kRows / extent) * extent;
      for (int e = j; e < n; e += kRows) {
        const int jj = bins_fast ? major : minor, t = bins_fast ? minor : major;
        cp_async4(&tile[t * (kRows + 1) + jj],
                  x + s_base[jj] + static_cast<long long>(t0 + t) * sT);
        advance(major, minor, d_major, d_minor, extent);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    // Scan: row j over the tile's bins, each mask over its value.
    if (j < rows) {
      for (int t = 0; t < tt; ++t) {
        const float xv = __uint_as_float(tile[t * (kRows + 1) + j]);
        uint32_t next = 0;
#pragma unroll
        for (int k = 0; k < kCap; ++k) {
          if (k < n_thr) {
            const bool on = xv > lv.on[k] || (((m >> k) & 1u) != 0 && xv >= lv.off[k]);
            next |= static_cast<uint32_t>(on) << k;
          }
        }
        m = next;
        tile[t * (kRows + 1) + j] = m;
      }
    }
    __syncthreads();

    // Store: from column t0 * n_thr on, row jj of the CTA at row_bytes apart.
    uint8_t* o = out + r0 * row_bytes + t0 * n_thr;
    if (n_thr % 4 == 0) {
      const int words = kCap == 4 ? 1 : n_thr / 4;   // words a (row, bin)
      const int per_row = tt * words, row_words = row_bytes / 4;
      int jj = j / per_row, w = j - (j / per_row) * per_row;
      const int d_jj = kRows / per_row, d_w = kRows - (kRows / per_row) * per_row;
      for (int e = j; e < rows * per_row; e += kRows) {
        const int t = w / words, q = w - (w / words) * words;
        reinterpret_cast<uint32_t*>(o)[static_cast<long long>(jj) * row_words + w] =
            spread4(tile[t * (kRows + 1) + jj] >> (4 * q));
        advance(jj, w, d_jj, d_w, per_row);
      }
    } else {
      const int per_row = tt * n_thr;
      int jj = j / per_row, c = j - (j / per_row) * per_row;
      const int d_jj = kRows / per_row, d_c = kRows - (kRows / per_row) * per_row;
      for (int e = j; e < rows * per_row; e += kRows) {
        const int t = c / n_thr, k = c - (c / n_thr) * n_thr;
        o[static_cast<long long>(jj) * row_bytes + c] =
            static_cast<uint8_t>((tile[t * (kRows + 1) + jj] >> k) & 1u);
        advance(jj, c, d_jj, d_c, per_row);
      }
    }
    __syncthreads();                     // the next tile's copies overwrite these masks
  }

  if (state_out != nullptr && j < rows) {
    for (int k = 0; k < n_thr; ++k)
      state_out[(b * n_thr + k) * F + f] = static_cast<uint8_t>((m >> k) & 1u);
  }
}

}  // namespace

// spikes (B, F, T * n_thr) uint8 from x (B, F, T) float32 at element strides
// (sB, sF, sT); state_in (B, n_thr, F) bool or null (all off); state_out
// (B, n_thr, F) bool or null (not wanted). on/off are host arrays of n_thr
// floats, copied into the launch's arguments.
extern "C" int lsm_hysteresis_encode(const float* x, long long sB, long long sF, long long sT,
                                     int B, int F, int T, const float* on, const float* off,
                                     int n_thr, const unsigned char* state_in,
                                     unsigned char* state_out, unsigned char* out,
                                     void* stream) {
  if (n_thr <= 0 || n_thr > kMaxThr || B < 0 || F < 0 || T < 0 ||
      static_cast<long long>(T) * n_thr > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * F;
  if (n_rows == 0) return 0;
  Levels lv{};
  for (int k = 0; k < n_thr; ++k) {
    lv.on[k] = on[k];
    lv.off[k] = off[k];
  }
  const int tile_bins = T < kMaxBins ? (T > 0 ? T : 1) : kMaxBins;
  const size_t smem = static_cast<size_t>(tile_bins) * (kRows + 1) * sizeof(uint32_t);
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows));
  auto s = static_cast<cudaStream_t>(stream);
  if (n_thr <= 4)
    hysteresis_kernel<4><<<grid, kRows, smem, s>>>(x, sB, sF, sT, F, T, tile_bins, n_rows,
                                                   n_thr, lv, state_in, state_out, out);
  else
    hysteresis_kernel<kMaxThr><<<grid, kRows, smem, s>>>(x, sB, sF, sT, F, T, tile_bins,
                                                         n_rows, n_thr, lv, state_in,
                                                         state_out, out);
  return static_cast<int>(cudaGetLastError());
}
