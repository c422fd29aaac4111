// Damped oscillator-bank synthesis for Hopper (sm_90a).
//
//   out[a, t] = sum_m amp[a, m] * exp(-d[a, m] * (t + 1) / sr)
//                               * sin(2 pi * frac(f[a, m] * (t + 1) / sr))
//
// Replaces diffsound_tpu/audio/pallas_osc.py::_synth_kernel (launched there
// by pallas_synth).  The TPU kernel loops over the A audio rows inside one
// program and grids only over time blocks, with the M modes vectorised
// across lanes and a head/tail split of the phase increment to stay exact
// in f32.  Here every block owns one (audio row, 256-sample tile): grid
// (ceil(T / 256), A), one thread per output sample.
//
// What bounds it on an H100: the work is one expf and one sinpif (plus an
// f64 multiply and floor for the phase) per (a, m, t), against only
// A * T * 4 bytes of output and 3 * A * M * 4 bytes of input.  At the
// flagship size (A=1, M=16, T=8000: 128 k mode-samples, 32 KB out) the
// kernel is bound by launch latency, not by the SFUs or memory; at the
// material_real GT bank size (A=8, M=256, T=8000: 16 M mode-samples) it is
// bound by special-function and FP64 throughput.
//
// What the design does about it: the (A, M, T) phase and envelope tensors
// of the plain version are never formed.  Each block stages its row's mode
// parameters in shared memory (in tiles of 1024 modes, 12 KB), each thread
// accumulates its sample's mode sum in an f32 register and writes it once,
// masked at the ragged edge, so device-memory traffic is the output plus
// one read of the parameters per block.  The phase is reduced in f64 before
// the sine, which matches the plain version's f64 phase for long tails
// without the TPU's head/tail split; the sine then takes an argument
// already reduced to one period (sinpif(2 * frac)).  No fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockT = 256;     // samples per block, one per thread
constexpr int kModeTile = 1024;  // modes staged in shared memory at a time

__global__ void __launch_bounds__(kBlockT)
synth_constant_modes_kernel(const float* __restrict__ freqs,
                            const float* __restrict__ damps,
                            const float* __restrict__ amps,
                            float* __restrict__ out, int M, int T, double sr) {
  __shared__ float s_f[kModeTile];
  __shared__ float s_d[kModeTile];
  __shared__ float s_a[kModeTile];

  const int a = blockIdx.y;
  const int t = blockIdx.x * kBlockT + threadIdx.x;
  const bool live = t < T;
  const double tt = (double)(t + 1) / sr;                // f64 time for the phase
  const float tf = (float)(t + 1) / (float)sr;           // f32 time for the envelope
  const float* fr = freqs + (size_t)a * M;
  const float* dr = damps + (size_t)a * M;
  const float* ar = amps + (size_t)a * M;

  float acc = 0.0f;
  for (int m0 = 0; m0 < M; m0 += kModeTile) {
    const int mc = min(kModeTile, M - m0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < mc; i += kBlockT) {
      s_f[i] = fr[m0 + i];
      s_d[i] = dr[m0 + i];
      s_a[i] = ar[m0 + i];
    }
    __syncthreads();
    if (live) {
      for (int m = 0; m < mc; ++m) {
        const double c = (double)s_f[m] * tt;
        const float frac = (float)(c - floor(c));
        acc += s_a[m] * expf(-s_d[m] * tf) * sinpif(2.0f * frac);
      }
    }
  }
  if (live) out[(size_t)a * T + t] = acc;
}

}  // namespace

// freqs, damps, amps: (A, M) float32, contiguous, on the device.
// out: (A, T) float32, contiguous.  Launches on `stream`; returns the launch
// status (cudaGetLastError) without synchronising.
extern "C" cudaError_t synth_constant_modes_launch(const float* freqs,
                                                   const float* damps,
                                                   const float* amps, float* out,
                                                   int A, int M, int T, double sr,
                                                   cudaStream_t stream) {
  if (A <= 0 || T <= 0) return cudaSuccess;
  dim3 grid((T + kBlockT - 1) / kBlockT, A);
  synth_constant_modes_kernel<<<grid, kBlockT, 0, stream>>>(freqs, damps, amps, out,
                                                             M, T, sr);
  return cudaGetLastError();
}
