// Kernels B1 and B3: gammatone sub-block energies on Hopper (sm_90a), one
// float32 biquad cascade per thread.
//
// B1 replaces lsm_tpu/ops/pallas/gtgram_kernel.py:70 _energy_kernel and its
// XLA phase 1 (lsm_tpu/ops/gammatone.py:345 gtgram_state_energy); B3 replaces
// the continuous-mode entry gtgram_kernel.py:205 gtgram_chunk_two_phase,
// which runs the same two phases from a carried cascade state. For each
// (batch row b, channel c) both run Slaney's four-section gammatone cascade
// over the row's samples and write the energy e = sum y^2 of every
// sub-block of g samples; B3 also writes the final state.
//
// The TPU ran the cascade in block form, one (g+8) x (g+8) matrix product a
// sub-block on the MXU ((g+8)^2 FMAs for g samples), because a TPU runs a
// scalar scan badly. An H100 has as many independent recurrences as
// (rows x channels), 131,072 at 1024 streams, so here each thread runs its
// (row, channel) recurrence sample by sample on the CUDA cores.
//
// Arithmetic. Section k is H(z) = (n0 + n1_k z^-1) / (1 + b1 z^-1 + b2 z^-2)
// (the 1/gain factor split evenly across the four sections), run in the
// delta-operator form of the transposed direct form II (delta = z - 1):
//
//     y   = n0 x + w1
//     w1 += beta1_k x - alpha1 y + w2        alpha1 = 2 + b1, beta1_k = 2 n0 + n1_k
//     w2 += beta2_k x - alpha2 y             alpha2 = 1 + b1 + b2, beta2_k = n0 + n1_k
//
// then e += y^2 after the last section: 25 float32 instructions a sample.
// The coefficients are formed in float64 and rounded once to float32
// (ops/gammatone.py cascade_coeffs). The low channels' poles sit near z = 1
// (radius 0.988 at 50 Hz): there b1 ~ -2 and b2 ~ 1 lose their small parts
// to rounding, and the plain form's state errors, one rounding of a large
// state a sample, are amplified by the resonance. The delta-operator states
// take small increments instead.
//
// State. The carried state is the block form's: section k's TDF2 states
// (s1, s2) at index 2k + j of (B, 8, C), with s1 = w1 and s2 = w2 - w1. Each
// sub-block converts it in (w2 = s1 + s2) and out (s2 = w2 - w1), so every
// sub-block runs the same instructions from the same float32 state wherever
// a chunk boundary falls: B3 chunks that thread the state are bit-equal to
// one call over the whole signal, and B3 from a zero state to B1.
//
// Layout. A CTA holds up to 128 channels of one row, one thread a channel,
// so a warp is 32 channels of one row. The row's samples pass through shared
// memory in tiles of 1024, double-buffered with cp.async; each sample is one
// broadcast load for the warp. Coefficients and state stay in registers.
// Energies are written (n_sub, B, C), coalesced across channels. Any g, C
// and B; the operands need only float32 alignment.
//
// Bound: float32 instruction throughput, 25 a sample, and the latency of each
// section's three-operation recurrence, hidden by the four sections and
// the unrolled samples in flight and by the other warps of the SM. No tensor
// cores, TF32 or bf16 on the state path, and no fast math: subnormals are
// kept (a silent stream decays into them).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kCoef = 11;         // n0, alpha1, alpha2, beta1[4], beta2[4]
constexpr int kTile = 1024;       // samples a row stages at a time
constexpr int kMaxThreads = 128;  // channels a CTA

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// kCarry = false: B1, from a zero state, no state out.
// kCarry = true:  B3, state_in -> state_out.
template <bool kCarry>
__global__ void __launch_bounds__(kMaxThreads)
gtgram_kernel(const float* __restrict__ wave,       // (B, n_sub * g)
              const float* __restrict__ coef,       // (C, kCoef)
              const float* __restrict__ state_in,   // (B, 8, C) if kCarry
              float* __restrict__ state_out,        // (B, 8, C) if kCarry
              float* __restrict__ out,              // (n_sub, B, C)
              int B, int C, int n_sub, int g) {
  __shared__ float xs[2][kTile];
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = c < C;
  const long long S = (long long)n_sub * g;
  const float* row = wave + (size_t)b * S;

  // Dead lanes (c >= C) run zeros and write nothing.
  float n0 = 0.f, a1 = 0.f, a2 = 0.f, be1[4], be2[4], s1[4], s2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) be1[k] = be2[k] = s1[k] = s2[k] = 0.f;
  if (live) {
    const float* q = coef + (size_t)c * kCoef;
    n0 = q[0];
    a1 = q[1];
    a2 = q[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      be1[k] = q[3 + k];
      be2[k] = q[7 + k];
      if (kCarry) {
        s1[k] = state_in[((size_t)b * 8 + 2 * k) * C + c];
        s2[k] = state_in[((size_t)b * 8 + 2 * k + 1) * C + c];
      }
    }
  }

  const int n_tiles = static_cast<int>((S + kTile - 1) / kTile);
  auto stage = [&](int t) {
    const long long base = (long long)t * kTile;
    const int n = static_cast<int>(min((long long)kTile, S - base));
    float* dst = xs[t & 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, row + base + i);
    cp_async_commit();
  };

  float w1[4], w2[4], e = 0.f;
  int pos = 0, k_sub = 0;           // sample within the sub-block, sub-block
  stage(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                // tile t has landed for every thread
    const float* xt = xs[t & 1];
    const int n = static_cast<int>(min((long long)kTile, S - (long long)t * kTile));
    for (int i = 0; i < n;) {
      if (pos == 0) {               // a sub-block starts: TDF2 -> delta state
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w1[k] = s1[k];
          w2[k] = __fadd_rn(s1[k], s2[k]);
        }
        e = 0.f;
      }
      const int m = min(n - i, g - pos);
      const float* xp = xt + i;
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        float x = xp[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float y = fmaf(n0, x, w1[k]);
          w1[k] = __fadd_rn(w1[k], fmaf(-a1, y, fmaf(be1[k], x, w2[k])));
          w2[k] = fmaf(-a2, y, fmaf(be2[k], x, w2[k]));
          x = y;
        }
        e = fmaf(x, x, e);
      }
      i += m;
      pos += m;
      if (pos == g) {               // the sub-block ends: delta -> TDF2 state
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s1[k] = w1[k];
          s2[k] = __fsub_rn(w2[k], w1[k]);
        }
        if (live) out[((size_t)k_sub * B + b) * C + c] = e;
        pos = 0;
        ++k_sub;
      }
    }
    __syncthreads();                // tile t's buffer is free for tile t + 2
  }
  if (kCarry && live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      state_out[((size_t)b * 8 + 2 * k) * C + c] = s1[k];
      state_out[((size_t)b * 8 + 2 * k + 1) * C + c] = s2[k];
    }
  }
}

template <bool kCarry>
int launch(const float* wave, const float* coef, const float* state_in, float* state_out,
           float* out, int B, int C, int n_sub, int g, void* stream) {
  if (n_sub <= 0 || g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || C <= 0) return 0;
  const int threads = std::min(kMaxThreads, (C + 31) / 32 * 32);
  const dim3 grid(B, (C + threads - 1) / threads);
  gtgram_kernel<kCarry><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      wave, coef, state_in, state_out, out, B, C, n_sub, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_gtgram_sub_energy(const float* wave, const float* coef, float* out,
                                     int B, int C, int n_sub, int g, void* stream) {
  return launch<false>(wave, coef, nullptr, nullptr, out, B, C, n_sub, g, stream);
}

extern "C" int lsm_gtgram_chunk(const float* wave, const float* coef, const float* state_in,
                                float* state_out, float* out, int B, int C, int n_sub, int g,
                                void* stream) {
  return launch<true>(wave, coef, state_in, state_out, out, B, C, n_sub, g, stream);
}

extern "C" const char* lsm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
