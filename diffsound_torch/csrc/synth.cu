// Damped oscillator-bank synthesis for Hopper (sm_90a), forward and backward.
//
//   out[a, t] = sum_m amp[a, m] * exp(-d[a, m] * (t + 1) / sr)
//                               * sin(2 pi * frac(f[a, m] * (t + 1) / sr))
//
// Replaces diffsound_tpu/audio/pallas_osc.py::_synth_kernel (launched there
// by pallas_synth) and the XLA recompute of its VJP (_synth_fused_bwd).  The
// TPU kernel loops over the A audio rows inside one program, grids over time
// blocks and evaluates one exp and one sin per (a, m, t) on the VPU.
//
// Block factorisation.  Cut the samples into rows of K = 64: t + 1 =
// (n0 + 1) + k with n0 = row * K and 0 <= k < K.  The angle-addition rule
// turns the mode sum of each audio row a into one matrix product,
//
//   out[a, n0 + k] = sum_m P[m, n0] C[m, k] + Q[m, n0] S[m, k]
//   P = amp e^{-d (n0+1)/sr} sin phi0,  Q = amp e^{-d (n0+1)/sr} cos phi0,
//   C = e^{-d k/sr} cos theta_k,        S = e^{-d k/sr} sin theta_k,
//
// (R x 2M) @ (2M x K) with R = ceil(T / K), where phi0 = 2 pi frac(f (n0+1)/sr)
// and theta_k = 2 pi frac(f k/sr), both reduced in f64 before the f32
// sincospif.  C and S are built the same way once more, from k = 8 j + i:
// sixteen oscillators per mode (i and 8 j) and one complex product per k.
// Transcendentals drop from A M T to A M (R + 16 ceil(R / 16)) in the
// forward, where each block of 16 rows builds its own table, and to
// A M (R + 16) in the backward.  Every envelope factor decays; the split is
// never e^{+x} e^{-y}, which would overflow.
//
// The backward factorises the same way.  With G = g cut into (R, K) rows,
// four products per block, G C^T, G S^T, G (kC)^T and G (kS)^T, weighted by
// s0 = e^{-d (n0+1)/sr} sin phi0, c0 = e^{-d (n0+1)/sr} cos phi0 and
// w = (n0+1)/sr and summed over the rows, give all three gradients:
//
//   grad_amp = sum (s0 GC + c0 GS)
//   grad_d   = -amp sum [w (s0 GC + c0 GS) + (s0 GCk + c0 GSk) / sr]
//   grad_f   = 2 pi amp sum [w (c0 GC - s0 GS) + (c0 GCk - s0 GSk) / sr]
//
// Tensor cores.  The products run on mma.sync.m16n8k8 in TF32 with the
// 3xTF32 split of both operands (hi = tf32(x), lo = tf32(x - hi); the sum
// lo*hi + hi*lo + hi*hi in f32 registers keeps about f32 accuracy, where
// plain TF32 misses the 1e-5 sum|amp| gate several times over).  Not wgmma:
// it takes 64-row tiles from shared-memory descriptors, and the whole
// product at the trainer's shape is (125 x 32) @ (32 x 64).  The tensor
// cores' f32 accumulation truncates, which over 1500 modes drifted twice
// past the gate; so hi*hi and the two cross terms go to separate
// accumulators, which start at zero for each tile of 64 modes (forward) or
// 16 rows (backward) and are then added into ordinary f32 sums.
//
// What bounds it on an H100: the bytes (inputs read once, outputs written
// once) and the multiply-adds at the TF32 tensor rate are both under 0.2 us
// at every shape the trainer runs.  What is left is latency: the launch,
// and the dependent chain of each oscillator (f64 phase reduction,
// sincospif, expf) with few warps per SM to hide it: the forward at the
// trainer's (1, 16, 8000) fills 8 blocks, at the ground-truth bank
// (8, 256, 8000) 64.  So the design keeps every oscillator's inputs in
// shared memory or registers, divides by sr nowhere (reciprocals instead),
// cuts the oscillators per block by the 8 + 8 split above, forms C and S in
// registers where the forward's mma reads them, and runs 8 warps a block.
//
// No fast math.  Each output is written by exactly one thread, and the
// backward reduces over rows in a fixed order (registers, warp shuffles,
// shared memory) without atomics, so both are bit-for-bit reproducible.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kK = 64;                      // samples per row
constexpr int kThreads = 256;               // eight warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                   // forward: sample rows per block
constexpr int kModeTile = 64;               // forward: modes per tile
constexpr int kLdP = kModeTile + 4;         // 68: conflict-free A-fragment reads
constexpr int kLdUV = 17;                   // oscillator table row, padded
constexpr int kBwdModes = 8;                // backward: modes per block
constexpr int kLdB = 4 * kBwdModes + 8;     // 40: conflict-free B-fragment reads
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative, each part exact in TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b in 3xTF32: big += hi*hi, small += lo*hi + hi*lo; lo*lo is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(small, alo, bhi);
  mma_tf32(small, ahi, blo);
  mma_tf32(big, ahi, bhi);
}

// e^{-d n/sr} (cos, sin)(2 pi frac(f n/sr)): the phase reduced in f64 so
// long tails stay exact, the decay's time n/sr in f32 as the plain version
// takes it.
__device__ __forceinline__ float2 oscillator(float f, float d, long long n, double inv_sr,
                                             float inv_srf) {
  const double cyc = (double)f * ((double)n * inv_sr);
  float s, c;
  sincospif(2.0f * (float)(cyc - floor(cyc)), &s, &c);
  const float e = expf(-d * ((float)n * inv_srf));
  return make_float2(e * c, e * s);
}

// The 16 oscillators of each of nm modes that C and S are built from:
// uv[j][i] at n = i and uv[j][8 + i] at n = 8 i, for i < 8.
__device__ __forceinline__ void oscillator_table(const float* __restrict__ f,
                                                 const float* __restrict__ d, int nm,
                                                 float2 (*__restrict__ uv)[kLdUV],
                                                 double inv_sr, float inv_srf) {
#pragma unroll 4
  for (int e = threadIdx.x; e < nm * 16; e += kThreads) {
    const int j = e >> 4, i = e & 15;
    uv[j][i] = oscillator(f[j], d[j], i < 8 ? i : 8 * (i - 8), inv_sr, inv_srf);
  }
}

// (C, S)[j][k] = e^{-d k/sr} (cos, sin)(theta_k), k = 8 hi + lo: one
// complex product of two table entries.
__device__ __forceinline__ float2 cs_entry(const float2 (*uv)[kLdUV], int j, int k) {
  const float2 u = uv[j][8 + (k >> 3)], v = uv[j][k & 7];
  return make_float2(u.x * v.x - u.y * v.y, u.y * v.x + u.x * v.y);
}

// Grid (ceil(R / kRows), A).  Warp w owns samples [8 w, 8 w + 8) of the
// block's 16 rows: one m16n8 accumulator tile.  Mode step s of the product
// covers modes 4 s .. 4 s + 3: its A columns are their P then their Q, its B
// rows their C then their S, which each thread forms in registers from the
// oscillator table (sample k = 8 w + g of warp w, lane group g).
__global__ void __launch_bounds__(kThreads)
synth_fwd_kernel(const float* __restrict__ freqs, const float* __restrict__ damps,
                 const float* __restrict__ amps, float* __restrict__ out, int M, int T,
                 double inv_sr) {
  __shared__ float s_f[kModeTile], s_d[kModeTile], s_a[kModeTile];
  __shared__ float2 s_uv[kModeTile][kLdUV];
  __shared__ float s_p[kRows][kLdP], s_q[kRows][kLdP];  // rows x modes

  const int a = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float inv_srf = (float)inv_sr;
  const float* fr = freqs + (size_t)a * M;
  const float* dr = damps + (size_t)a * M;
  const float* ar = amps + (size_t)a * M;

  // Thread j < kModeTile loads mode j of the next tile while this one runs;
  // modes past M get zero amplitude, so P = Q = 0 for them.
  float nf = 0.0f, nd = 0.0f, na = 0.0f;
  if (tid < kModeTile && tid < M) {
    nf = fr[tid];
    nd = dr[tid];
    na = ar[tid];
  }
  float acc[4] = {};
  for (int m0 = 0; m0 < M; m0 += kModeTile) {
    const int nm = (min(kModeTile, M - m0) + 3) & ~3;  // modes the mode steps read
    __syncthreads();  // the previous tile is consumed
    if (tid < kModeTile) {
      s_f[tid] = nf;
      s_d[tid] = nd;
      s_a[tid] = na;
      const int m = m0 + kModeTile + tid;
      nf = m < M ? fr[m] : 0.0f;
      nd = m < M ? dr[m] : 0.0f;
      na = m < M ? ar[m] : 0.0f;
    }
    __syncthreads();
    oscillator_table(s_f, s_d, nm, s_uv, inv_sr, inv_srf);
#pragma unroll 4
    for (int e = tid; e < kRows * nm; e += kThreads) {
      const int i = e / nm, j = e % nm;
      const float2 o = oscillator(s_f[j], s_d[j], (row0 + i) * kK + 1, inv_sr, inv_srf);
      s_p[i][j] = s_a[j] * o.y;
      s_q[i][j] = s_a[j] * o.x;
    }
    __syncthreads();
    float big[4] = {}, small[4] = {};
#pragma unroll 4
    for (int m4 = 0; m4 < nm; m4 += 4) {
      const int m = m4 + q;
      uint32_t ahi[4], alo[4], bhi[2], blo[2];
      split_tf32(s_p[g][m], ahi[0], alo[0]);
      split_tf32(s_p[g + 8][m], ahi[1], alo[1]);
      split_tf32(s_q[g][m], ahi[2], alo[2]);
      split_tf32(s_q[g + 8][m], ahi[3], alo[3]);
      const float2 cs = cs_entry(s_uv, m, warp * 8 + g);
      split_tf32(cs.x, bhi[0], blo[0]);
      split_tf32(cs.y, bhi[1], blo[1]);
      mma_3xtf32(big, small, ahi, alo, bhi, blo);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += big[i] + small[i];
  }

  // acc[2 h + e] is sample (row0 + g + 8 h) * K + warp * 8 + 2 q + e.
  float* o = out + (size_t)a * T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long idx = (row0 + g + 8 * h) * kK + warp * 8 + 2 * q;
    if (idx < T) o[idx] = acc[2 * h];
    if (idx + 1 < T) o[idx + 1] = acc[2 * h + 1];
  }
}

// Grid (ceil(M / kBwdModes), A).  The block's B operand, [C | S | kC | kS]
// for its 8 modes (K x 32), is split into TF32 hi and lo once and kept in
// shared memory; warp w walks the 16-row chunks w, w + 8, w + 16, ... of G.
// Thread (g, q) of a warp holds, for its rows g and g + 8 of a chunk, all
// four products of modes 2q and 2q + 1, so the epilogue needs no exchange.
__global__ void __launch_bounds__(kThreads)
synth_bwd_kernel(const float* __restrict__ freqs, const float* __restrict__ damps,
                 const float* __restrict__ amps, const float* __restrict__ gout,
                 float* __restrict__ grad, int A, int M, int T, double inv_sr) {
  __shared__ float s_f[kBwdModes], s_d[kBwdModes];
  __shared__ float2 s_uv[kBwdModes][kLdUV];
  __shared__ uint32_t s_bhi[kK][kLdB];
  __shared__ uint32_t s_blo[kK][kLdB];
  __shared__ float s_red[kWarps][kBwdModes][3];

  const int a = blockIdx.y;
  const int mb = blockIdx.x * kBwdModes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float inv_srf = (float)inv_sr;
  const float* gr = gout + (size_t)a * T;

  // Modes past M get f = d = 0: finite columns, and their sums are dropped.
  if (tid < kBwdModes) {
    const bool live = mb + tid < M;
    s_f[tid] = live ? freqs[(size_t)a * M + mb + tid] : 0.0f;
    s_d[tid] = live ? damps[(size_t)a * M + mb + tid] : 0.0f;
  }
  __syncthreads();
  oscillator_table(s_f, s_d, kBwdModes, s_uv, inv_sr, inv_srf);
  __syncthreads();
  for (int e = tid; e < kBwdModes * kK; e += kThreads) {
    const int j = e / kK, k = e % kK;
    const float2 cs = cs_entry(s_uv, j, k);
    const float col[4] = {cs.x, cs.y, (float)k * cs.x, (float)k * cs.y};
#pragma unroll
    for (int p = 0; p < 4; ++p)
      split_tf32(col[p], s_bhi[k][p * kBwdModes + j], s_blo[k][p * kBwdModes + j]);
  }
  __syncthreads();

  const float f0 = s_f[2 * q], f1 = s_f[2 * q + 1];
  const float d0 = s_d[2 * q], d1 = s_d[2 * q + 1];
  // per mode 2 q + e: grad_amp, grad_d / (-amp), grad_f / (2 pi amp)
  float sa[2] = {}, sd[2] = {}, sf[2] = {};
  const long long R = ((long long)T + kK - 1) / kK;
  for (long long r0 = warp * 16; r0 < R; r0 += kWarps * 16) {
    float big[4][4] = {}, small[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kK; kk += 8) {
      const long long i0 = (r0 + g) * kK + kk + q, i1 = i0 + 8 * kK;
      uint32_t ahi[4], alo[4];
      split_tf32(i0 < T ? gr[i0] : 0.0f, ahi[0], alo[0]);
      split_tf32(i1 < T ? gr[i1] : 0.0f, ahi[1], alo[1]);
      split_tf32(i0 + 4 < T ? gr[i0 + 4] : 0.0f, ahi[2], alo[2]);
      split_tf32(i1 + 4 < T ? gr[i1 + 4] : 0.0f, ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t bhi[2] = {s_bhi[kk + q][nt * 8 + g], s_bhi[kk + q + 4][nt * 8 + g]};
        const uint32_t blo[2] = {s_blo[kk + q][nt * 8 + g], s_blo[kk + q + 4][nt * 8 + g]};
        mma_3xtf32(big[nt], small[nt], ahi, alo, bhi, blo);
      }
    }
    // big + small [nt][2 h + e]: row r0 + g + 8 h, mode 2 q + e, product nt
    // (GC, GS, GCk, GSk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + g + 8 * h;
      if (row < R) {
        const long long n1 = row * kK + 1;
        const float w = (float)n1 * inv_srf;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const float2 o = oscillator(e ? f1 : f0, e ? d1 : d0, n1, inv_sr, inv_srf);
          const float s0 = o.y, c0 = o.x;
          const float gc = big[0][i] + small[0][i], gs = big[1][i] + small[1][i];
          const float gck = big[2][i] + small[2][i], gsk = big[3][i] + small[3][i];
          const float ps = s0 * gc + c0 * gs, pc = c0 * gc - s0 * gs;
          const float psk = s0 * gck + c0 * gsk, pck = c0 * gck - s0 * gsk;
          sa[e] += ps;
          sd[e] += w * ps + psk * inv_srf;
          sf[e] += w * pc + pck * inv_srf;
        }
      }
    }
  }

  // Sum over the eight lanes that share q, then over the warps in order.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      sa[e] += __shfl_xor_sync(0xffffffffu, sa[e], off);
      sd[e] += __shfl_xor_sync(0xffffffffu, sd[e], off);
      sf[e] += __shfl_xor_sync(0xffffffffu, sf[e], off);
    }
    if (g == 0) {
      s_red[warp][2 * q + e][0] = sa[e];
      s_red[warp][2 * q + e][1] = sd[e];
      s_red[warp][2 * q + e][2] = sf[e];
    }
  }
  __syncthreads();
  if (tid < kBwdModes && mb + tid < M) {
    float va = 0.0f, vd = 0.0f, vf = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      va += s_red[w][tid][0];
      vd += s_red[w][tid][1];
      vf += s_red[w][tid][2];
    }
    const size_t am = (size_t)a * M + mb + tid, plane = (size_t)A * M;
    const float amp = amps[am];
    grad[am] = kTwoPi * amp * vf;       // grad_f
    grad[plane + am] = -amp * vd;       // grad_d
    grad[2 * plane + am] = va;          // grad_amp
  }
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
  const long long rows = ((long long)T + kK - 1) / kK;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), A);
  synth_fwd_kernel<<<grid, kThreads, 0, stream>>>(freqs, damps, amps, out, M, T, 1.0 / sr);
  return cudaGetLastError();
}

// freqs, damps, amps: (A, M) float32; g: (A, T) float32, the cotangent of
// out; grad: (3, A, M) float32 receiving grad_f, grad_d, grad_amp.  All
// contiguous, on the device.  Launches on `stream`; returns the launch status.
extern "C" cudaError_t synth_constant_modes_bwd_launch(const float* freqs,
                                                       const float* damps,
                                                       const float* amps, const float* g,
                                                       float* grad, int A, int M, int T,
                                                       double sr, cudaStream_t stream) {
  if (A <= 0 || M <= 0) return cudaSuccess;
  dim3 grid((M + kBwdModes - 1) / kBwdModes, A);
  synth_bwd_kernel<<<grid, kThreads, 0, stream>>>(freqs, damps, amps, g, grad, A, M, T,
                                                  1.0 / sr);
  return cudaGetLastError();
}
