// Element-operator apply of the multi-pair trainer's batched refresh, for
// Hopper (sm_90a): K or M applied to every material pair's block in one
// launch.  For X in the (B, 3V, k) layout lobpcg_batched holds, pair b's
// Lame values mu_b, lam_b and an optional row scaling s (B, 3V),
//
//   K:  Y_b = S_b sum_e P_e^T (mu_b K_mu,e + lam_b K_lam,e) P_e S_b X_b
//   M:  Y_b = S_b sum_e P_e^T (|det A_e| Mref (x) I_3) P_e S_b X_b
//
// with P_e the gather of element e's N nodes (N = 4 at order 1, 10 at order
// 2; 3N x 3N blocks) and S_b = diag(s_b), the identity when s is null.
//
// Replaces no TPU kernel: on the TPU these applies are XLA's
// (diffsound_tpu/fem/assembly.py k_matvec, m_matvec).  It replaces the
// port's plain chain on the card, fem/assembly.py's gather of an
// (E, 3N, c) slab, two bmm, the material combination and a gather-sum
// through a zero row and a (V, D, 3c) slab padded to the largest valence,
// each of which went through device memory.
//
// Structure: a vertex owns its rows.  A block takes a patch of 16
// vertices (consecutive in first-touch order of the element list, the
// heaviest first) for one pair b and a chunk of columns.  It first stages
// in shared memory the patch's halo, the X rows of every node of its
// vertices' elements, and their scaling (cp.async, all copies in flight
// at once; for K it then scales the rows).  Then each warp takes a vertex
// v, lanes over the columns, and walks v's incidences (e, a), element e
// holding v as its node a, in ascending e N + a: the CSR order of
// fem.assembly's gather_idx.  A fill puts in the warp's shared memory,
// once per incidence and pair and never per column, the part of e's block
// that lands on v: for K the 3 x 3N rows of K_mu and of K_lam, one entry
// a lane, for M the N coefficients |det A_e| Mref[a, :] times the rows'
// scaling (each node's 3 x 3 block is a multiple of I_3); two incidences
// a fill at order 1 for K, three or eight for M, so most lanes fill.  The
// next fill's loads are in flight during this one's products, which
// broadcast each entry to the lanes and run it against the staged rows:
// K into six accumulators a column (v's three rows of K_mu x and of
// K_lam x, combined as mu K_mu x + lam K_lam x at the end), M into three.
// Every output entry is one thread's register sums in that fixed order:
// no float atomics, no buffer, and two calls give the same bits.
//
// Why not the other two deterministic structures.  Element colouring: the
// cube meshes' vertices lie in up to 24 tets, so a K apply would take some
// 24 launches (or grid barriers), and each colour rereads X and rereads
// and rewrites Y at its vertices: E N / V passes over Y in all, 6.7 at
// order 2 and 21 at order 1.  A per-chunk element buffer: it writes and
// rereads E 3N rows a column, the same 6.7x and 21x Y's rows, and a chunk
// small enough to stay in L2 (about 16 columns at order 2, 6 at order 1)
// streams the element blocks from device memory once per chunk.  The
// vertex walk computes each row of each element product once, so it does
// the element form's multiply-adds and writes each Y row once.  What it
// pays instead: a halo 6.7 (order 2) or 6.9 (order 1) times the patch's
// own rows is read from L2 into shared memory, and each X value read from
// there feeds 6 FMAs (K: v's three rows of two blocks) or 3 (M) where the
// element form would reuse it 3N or 6N times.  The grid runs the pairs fastest,
// so the blocks of one patch, in flight together, read its element rows
// once from device memory and its halo from L2.
//
// What bounds it on an H100: the apply's count (portbench/counts/
// element_apply.py) is operations-bound for K from about 130 columns
// (float32 FMAs at 67 TFLOP/s: tensor cores would need TF32, which this
// configuration forbids, or a 3xTF32 split) and bytes-bound below, and
// bytes-bound for M at order 2.  This kernel is bound by its shared
// memory traffic and the latency between its dependent loads: each K step
// reads two broadcast entries and then one X value a lane and column slot
// for 6 FMAs, twice the count's multiply-adds (the price of applying the
// material to the sums); the fills, the staging (the halo's 6.7x) and the
// two blocks an SM that a 66-column halo leaves (113 KB each) add to it.  Lanes past the
// chunk's columns idle (10 of 32 at 22 or 66 columns).  PERF.md has its
// times against the bound.
//
// Precision: IEEE float32 FMAs, no fast math, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPatch = 16;  // vertices a block: consecutive in the walk order
// the shared memory a block may stage its halo in: two blocks an SM
constexpr size_t kSmemBudget = 113 * 1024;

struct Args {
  const float* kmu;     // (E, 3N, 3N), K only
  const float* klam;    // (E, 3N, 3N), K only
  const float* mref;    // (N, N), M only
  const float* mscale;  // (E,) |det A_e|, M only
  const int* order;     // (V,) the vertex at each walk position
  const int* ptr;       // (V + 1,) each walk position's incidences in inc and loc
  const int* inc;       // incidences e N + a, ascending within a vertex
  const int* loc;       // (.., N) e's nodes as slots of the patch's halo
  const int* halo_ptr;  // (patches + 1,)
  const int* halo;      // each patch's halo: the nodes of its vertices' elements
  const float* x;       // (B, 3V, k)
  const float* mu;      // (B,), K only
  const float* lam;     // (B,), K only
  const float* scale;   // (B, 3V) or null
  float* y;             // (B, 3V, k)
  int V;
  int k;
  int max_halo;
  int cw;      // columns a chunk
  int chunks;  // chunks a pair
};

// Entry j of incidence q's row block (element e at its node a), as the
// walk broadcasts it.  K: entry j < 3N of the 3 x 3N rows of K_mu (.a) and
// of K_lam (.b); a.w the offset in the staged halo of the X row it
// multiplies.  M: node j < N, whose 3 x 3 block is |det A_e| Mref[a, j]
// I_3: that coefficient times the scaling of each of the node's three
// rows, and in a.w the offset of the first.
//
// K's entries are the element blocks' own: the material is applied to the
// two sums, mu (K_mu x) + lam (K_lam x), and the scaling to the staged X
// rows, as the plain chain applies both.  Folding either into the entries
// would round each entry once more, a fixed perturbation of the operator
// whose first-order effect on a Ritz value does not vanish on a rigid
// motion, as a rounding of x does; at order 1 it moved the refresh's
// lowest Ritz values (zero for a rigid motion) 5-10x further from
// float64's than the chain does.  M has no such null space: the same
// rounding moves each of its Ritz values by a few units of float32, so M
// folds the scaling into its coefficients and skips the scaling pass.
struct Entry {
  float4 a, b;
};

template <int N, bool MASS>
__device__ __forceinline__ Entry row_entry(const Args& p, int q, int j, const float* ds) {
  constexpr int R = 3 * N;
  const int t = p.inc[q];
  const int e = t / N, a = t - e * N;
  Entry w;
  if constexpr (MASS) {
    const int row = 3 * p.loc[q * N + j];
    const float m = p.mscale[e] * p.mref[a * N + j];
    w.a = make_float4(m * ds[row], m * ds[row + 1], m * ds[row + 2], __int_as_float(row * p.cw));
    w.b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    const int row = 3 * p.loc[q * N + j / 3] + j % 3;
    const long long off = ((long long)e * R + 3 * a) * R + j;
    w.a = make_float4(p.kmu[off], p.kmu[off + R], p.kmu[off + 2 * R],
                      __int_as_float(row * p.cw));
    w.b = make_float4(p.klam[off], p.klam[off + R], p.klam[off + 2 * R], 0.0f);
  }
  return w;
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async8(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

template <int N, int CPL, bool MASS>
__global__ void __launch_bounds__(kThreads) element_apply_kernel(const Args p) {
  constexpr int R = MASS ? N : 3 * N;  // entries of a row block
  constexpr int T = MASS ? 3 : 1;      // X rows an entry multiplies
  constexpr int G = MASS ? 2 : 3;      // steps whose loads are in flight together
  constexpr int kFill = 32 / R;        // incidences a fill
  constexpr int S = kFill * R;         // steps a fill
  static_assert(R <= 32, "one lane per entry of a row block");
  extern __shared__ float xs[];  // the halo's X rows (H, 3, cw), scaling, vertices
  __shared__ float4 block_rows[kWarps][S];
  __shared__ float4 block_lam[kWarps][MASS ? 1 : S];
  __shared__ int next_slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.chunks;
  const int c0 = (blockIdx.x - b * p.chunks) * p.cw;
  const int cw = min(p.cw, p.k - c0);
  const long long n = 3LL * p.V;
  const float* __restrict__ xb = p.x + (long long)b * n * p.k + c0;
  float* __restrict__ yb = p.y + (long long)b * n * p.k + c0;
  const float* __restrict__ sb = p.scale ? p.scale + (long long)b * n : nullptr;

  // stage the halo: rows 3h, 3h + 1, 3h + 2 of each halo vertex h, this
  // chunk's columns, and their scaling, all copies in flight at once;
  // then scale the rows
  const int h0 = p.halo_ptr[blockIdx.y], hn = p.halo_ptr[blockIdx.y + 1] - h0;
  float* ds = xs + p.max_halo * 3 * p.cw;  // (H, 3) the rows' scaling
  int* hv = reinterpret_cast<int*>(ds + 3 * p.max_halo);  // (H,) the halo's vertices
  for (int h = threadIdx.x; h < hn; h += kThreads) hv[h] = p.halo[h0 + h];
  if (threadIdx.x == 0) next_slot = 0;
  __syncthreads();
  // a whole even row: the three rows of a vertex are one run of 3k
  // floats, 8-byte aligned in both places
  const bool runs = p.chunks == 1 && (p.k & 1) == 0;
  for (int h = warp; h < hn; h += kWarps) {
    const long long row0 = 3LL * hv[h];
    if (runs) {
      for (int r = 2 * lane; r < 3 * cw; r += 64)
        copy_async8(xs + 3 * h * p.cw + r, xb + row0 * p.k + r);
    } else {
      for (int r = lane; r < 3 * cw; r += 32) {
        const int i = (r >= cw) + (r >= 2 * cw), c = r - i * cw;
        copy_async4(xs + (3 * h + i) * p.cw + c, xb + (row0 + i) * p.k + c);
      }
    }
    if (lane < 3) {
      if (sb) copy_async4(ds + 3 * h + lane, sb + row0 + lane);
      else ds[3 * h + lane] = 1.0f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (!MASS && sb) {
    for (int h = warp; h < hn; h += kWarps)
      for (int r = lane; r < 3 * cw; r += 32) {
        const int i = (r >= cw) + (r >= 2 * cw), c = r - i * cw;
        xs[(3 * h + i) * p.cw + c] *= ds[3 * h + i];
      }
    __syncthreads();
  }

  bool live[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) live[c] = lane + 32 * c < cw;
  const int pos0 = blockIdx.y * kPatch;
  const int npos = min(kPatch, p.V - pos0);
  while (true) {
    // the next vertex of the patch (the heaviest first); which warp takes
    // it changes no result
    int s = 0;
    if (lane == 0) s = atomicAdd(&next_slot, 1);
    s = __shfl_sync(0xffffffffu, s, 0);
    if (s >= npos) break;
    const int pos = pos0 + s, v = p.order[pos];
    // K: K_mu x (acc) and K_lam x (acl); M: M x (acc)
    float acc[3][CPL], acl[3][CPL];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = acl[i][c] = 0.0f;

    // kFill incidences a fill; an absent one's entries are zero and add
    // exact zeros
    const int q0 = p.ptr[pos], q1 = p.ptr[pos + 1];
    const int fq = lane / R, fj = lane - fq * R;
    Entry cur{};
    if (q0 + fq < q1 && lane < S) cur = row_entry<N, MASS>(p, q0 + fq, fj, ds);
    for (int q = q0; q < q1; q += kFill) {
      __syncwarp();
      if (lane < S) {
        block_rows[warp][lane] = cur.a;
        if constexpr (!MASS) block_lam[warp][lane] = cur.b;
      }
      __syncwarp();
      const int qn = q + kFill + fq;
      cur = Entry{};
      if (qn < q1 && lane < S) cur = row_entry<N, MASS>(p, qn, fj, ds);
      // G steps at a time: their loads in flight together, then their
      // multiply-adds in step order
#pragma unroll
      for (int j0 = 0; j0 < S; j0 += G) {
        float4 wa[G], wb[G];
        float xv[G][T][CPL];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (j0 + g < S) {
            wa[g] = block_rows[warp][j0 + g];
            if constexpr (!MASS) wb[g] = block_lam[warp][j0 + g];
            const float* xr = xs + __float_as_int(wa[g].w) + lane;
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
              for (int c = 0; c < CPL; ++c)
                xv[g][t][c] = live[c] ? xr[t * p.cw + 32 * c] : 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (j0 + g < S) {
#pragma unroll
            for (int c = 0; c < CPL; ++c) {
              // K: each row of v takes the entry's X row; M: row i of v
              // takes the node's row i
              acc[0][c] = fmaf(wa[g].x, xv[g][0][c], acc[0][c]);
              acc[1][c] = fmaf(wa[g].y, xv[g][T > 1 ? 1 : 0][c], acc[1][c]);
              acc[2][c] = fmaf(wa[g].z, xv[g][T > 2 ? 2 : 0][c], acc[2][c]);
              if constexpr (!MASS) {
                acl[0][c] = fmaf(wb[g].x, xv[g][0][c], acl[0][c]);
                acl[1][c] = fmaf(wb[g].y, xv[g][0][c], acl[1][c]);
                acl[2][c] = fmaf(wb[g].z, xv[g][0][c], acl[2][c]);
              }
            }
          }
        }
      }
    }
    if constexpr (!MASS) {
      const float cm = p.mu[b], cl = p.lam[b];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = cm * acc[i][c] + cl * acl[i][c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const long long r = 3LL * v + i;
      const float d = sb ? sb[r] : 1.0f;
      float* __restrict__ yr = yb + r * p.k + lane;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (live[c]) yr[32 * c] = acc[i][c] * d;
    }
  }
}

template <int N, int CPL, bool MASS>
cudaError_t launch_one(const Args& p, dim3 grid, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(element_apply_kernel<N, CPL, MASS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  element_apply_kernel<N, CPL, MASS><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N, bool MASS>
cudaError_t launch(const Args& p, int cpl, dim3 grid, size_t smem, cudaStream_t stream) {
  switch (cpl) {
    case 1: return launch_one<N, 1, MASS>(p, grid, smem, stream);
    case 2: return launch_one<N, 2, MASS>(p, grid, smem, stream);
    case 3: return launch_one<N, 3, MASS>(p, grid, smem, stream);
    default: return launch_one<N, 4, MASS>(p, grid, smem, stream);
  }
}

}  // namespace

// The vertices each block walks (the plan's patches).
extern "C" int element_apply_patch_size() { return kPatch; }

// mass 0: K (kmu, klam, mu, lam; mref, mscale unused), 1: M (mref, mscale;
// kmu, klam, mu, lam unused).  nodes: 4 or 10.  The plan's arrays (order,
// ptr, inc, loc, halo_ptr, halo; max_halo the largest halo) as
// fem/element_apply.py's apply_plan builds them.  All float32 or int32,
// contiguous, on one device; scale may be null.  Launches on `stream`;
// returns the launch status.
extern "C" cudaError_t element_apply_launch(
    int mass, int nodes, const float* kmu, const float* klam, const float* mref,
    const float* mscale, const int* order, const int* ptr, const int* inc, const int* loc,
    const int* halo_ptr, const int* halo, int max_halo, const float* x, const float* mu,
    const float* lam, const float* scale, float* y, int V, int B, int k,
    cudaStream_t stream) {
  if (V <= 0 || B <= 0 || k <= 0) return cudaSuccess;
  if (nodes != 4 && nodes != 10) return cudaErrorInvalidValue;
  // of the chunkings with at most 4 columns a lane whose staged halo fits
  // kSmemBudget, the one that leaves the fewest lanes idle, then the one
  // with the fewest chunks (each repeats the fills)
  const size_t per_col = (size_t)max_halo * 3 * sizeof(float);
  const size_t fixed = (size_t)max_halo * 4 * sizeof(float);  // scaling and vertices
  int chunks = 0, cw = 0;
  double best = -1.0;
  for (int ch = 1; ch <= k; ++ch) {
    const int width = (k + ch - 1) / ch, slots = (width + 31) / 32;
    if (slots > 4 || fixed + per_col * width > kSmemBudget) continue;
    const double eff = (double)k / ((double)ch * 32 * slots);
    if (eff > best + 1e-9) best = eff, chunks = ch, cw = width;
    if (slots == 1) break;  // narrower chunks only idle more lanes
  }
  if (chunks == 0) return cudaErrorInvalidConfiguration;
  const size_t smem = fixed + per_col * cw;
  const int cpl = (cw + 31) / 32;
  const long long gx = (long long)B * chunks;
  const int patches = (V + kPatch - 1) / kPatch;
  if (gx > 0x7fffffffLL || patches > 65535) return cudaErrorInvalidConfiguration;
  // pairs run fastest: the blocks of one patch read its element rows and
  // halo from L2
  const dim3 grid((unsigned)gx, (unsigned)patches);
  const Args p{kmu, klam, mref, mscale, order, ptr, inc, loc, halo_ptr, halo, x, mu, lam,
               scale, y, V, k, max_halo, cw, chunks};
  if (nodes == 4) return mass ? launch<4, true>(p, cpl, grid, smem, stream)
                              : launch<4, false>(p, cpl, grid, smem, stream);
  return mass ? launch<10, true>(p, cpl, grid, smem, stream)
              : launch<10, false>(p, cpl, grid, smem, stream);
}
