// Kernels B1 and B3: exact gammatone sub-block energies on Hopper (sm_90a).
//
// B1 replaces lsm_tpu/ops/pallas/gtgram_kernel.py:70 _energy_kernel and its
// XLA phase 1 (lsm_tpu/ops/gammatone.py:345 gtgram_state_energy); B3 replaces
// the continuous-mode entry gtgram_kernel.py:205 gtgram_chunk_two_phase,
// which runs the same two phases from a carried cascade state. For each
// (batch row b, channel c) the 4-biquad cascade runs in block form over
// sub-blocks of G samples:
//
//     z = [x_k (G samples); s (8 cascade states)]
//     y_m = sum_j K[c][m][j] z_j      (m < G)     e[k] = sum_m y_m^2
//     s'_t = sum_j K[c][G+t][j] z_j   (t < 8)
//
// One thread per (b, c): z lives in registers, the channel's (G+8)^2 block
// system in shared memory (read as 16-byte broadcasts). Exact float32 FMAs
// on the CUDA cores: the IIR state path must not go through TF32 or bf16.
// Bound: FMA issue plus the shared-memory operand loads that feed it.
// blockIdx.x = channel (fast), so the CTAs that share a batch tile's
// waveform run together and its re-reads hit L2.
//
// One body, templated on kCarry. B1 (kCarry = false) starts from a zero
// state and writes e as (n_sub, C, B). B3 (kCarry = true) loads the state
// from state_in (B, 8, C), writes the final state to state_out and e as
// (n_sub, B, C), the layout the continuous engine's window sums read. Both
// run the identical FMA sequence per sub-block, so feeding a signal to B3
// in chunks that thread the state gives bit for bit what one call over the
// whole signal gives.

#include <cuda_runtime.h>

namespace {

constexpr int G = 80;            // samples per sub-block
constexpr int Z = G + 8;         // block input: samples + cascade state
constexpr int BT = 64;           // batch rows (threads) per CTA

template <bool kCarry>
__global__ void __launch_bounds__(BT)
gtgram_kernel(const float* __restrict__ wave,       // (B, n_sub*G)
              const float* __restrict__ kmat,       // (C, Z, Z)
              const float* __restrict__ state_in,   // (B, 8, C) if kCarry
              float* __restrict__ state_out,        // (B, 8, C) if kCarry
              float* __restrict__ out,              // see above
              int B, int C, int n_sub) {
  __shared__ __align__(16) float km[Z * Z];
  const int c = blockIdx.x;
  const int b = blockIdx.y * BT + threadIdx.x;
  const float* src = kmat + (size_t)c * Z * Z;
  for (int i = threadIdx.x; i < Z * Z; i += BT) km[i] = src[i];
  __syncthreads();
  if (b >= B) return;            // no barrier follows

  float z[Z];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    z[G + s] = kCarry ? state_in[((size_t)b * 8 + s) * C + c] : 0.f;

  const float4* row = reinterpret_cast<const float4*>(wave + (size_t)b * n_sub * G);
  const float4* k4 = reinterpret_cast<const float4*>(km);

  for (int k = 0; k < n_sub; ++k) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const float4 v = __ldg(row + (size_t)k * (G / 4) + q);
      z[4 * q + 0] = v.x;
      z[4 * q + 1] = v.y;
      z[4 * q + 2] = v.z;
      z[4 * q + 3] = v.w;
    }
    float e = 0.f;
#pragma unroll 2
    for (int m = 0; m < G; ++m) {
      const float4* kr = k4 + m * (Z / 4);
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < Z / 4; ++q) {
        const float4 w = kr[q];
        y = fmaf(w.x, z[4 * q + 0], y);
        y = fmaf(w.y, z[4 * q + 1], y);
        y = fmaf(w.z, z[4 * q + 2], y);
        y = fmaf(w.w, z[4 * q + 3], y);
      }
      e = fmaf(y, y, e);
    }
    float sn[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4* kr = k4 + (G + t) * (Z / 4);
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < Z / 4; ++q) {
        const float4 w = kr[q];
        y = fmaf(w.x, z[4 * q + 0], y);
        y = fmaf(w.y, z[4 * q + 1], y);
        y = fmaf(w.z, z[4 * q + 2], y);
        y = fmaf(w.w, z[4 * q + 3], y);
      }
      sn[t] = y;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) z[G + t] = sn[t];
    if (kCarry)
      out[((size_t)k * B + b) * C + c] = e;
    else
      out[((size_t)k * C + c) * B + b] = e;
  }
  if (kCarry) {
#pragma unroll
    for (int t = 0; t < 8; ++t) state_out[((size_t)b * 8 + t) * C + c] = z[G + t];
  }
}

}  // namespace

extern "C" int lsm_gtgram_sub_energy(const float* wave, const float* kmat,
                                     float* out, int B, int C, int n_sub,
                                     void* stream) {
  if (B <= 0 || C <= 0 || n_sub <= 0) return 0;
  dim3 grid(C, (B + BT - 1) / BT);
  gtgram_kernel<false><<<grid, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      wave, kmat, nullptr, nullptr, out, B, C, n_sub);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lsm_gtgram_chunk(const float* wave, const float* kmat,
                                const float* state_in, float* state_out,
                                float* out, int B, int C, int n_sub,
                                void* stream) {
  if (B <= 0 || C <= 0 || n_sub <= 0) return 0;
  dim3 grid(C, (B + BT - 1) / BT);
  gtgram_kernel<true><<<grid, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      wave, kmat, state_in, state_out, out, B, C, n_sub);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lsm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
