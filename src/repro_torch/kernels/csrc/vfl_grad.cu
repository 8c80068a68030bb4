// vfl_grad for Hopper (sm_90a): the forward mode z[p] = X[p] @ W[p], the
// backward mode g[p] = X[p]^T Theta[p] / denom (+ lam * W[p]), and the fused
// mode, which computes both in one launch, with its split-batch form.
//
// Replaces the Pallas TPU kernel src/repro/kernels/vfl_grad.py ::
// vfl_grad / _vfl_kernel (the pl.pallas_call at vfl_grad.py:343), which the
// JAX engine maps over the party axis with vmap.  Here the party axis is a
// leading dimension of the operands, so one launch covers all q parties:
//
//   forward:  x (P, B, D), w (P, D, M)          -> z (P, B, M)
//   backward: x (P, B, D), theta (P, B, M) with a party stride that may be
//             0 (one theta shared by every party), w (P, D, M) or none
//                                               -> g (P, D, M)
//   fused:    x (P, B, D), w (P, D, Mw), theta (P, Bb, Mth) as above
//                           -> z (P, Bf, Mw) over rows [B - Bf, B) and
//                              g (P, D, Mth) over rows [0, Bb); the fused
//                              mode is Bb = Bf = B, the split-batch form
//                              (the pipelined step) Bb + Bf = B, with Mw
//                              and Mth independent (Mw = 1 beside Mth = m
//                              block-diagonal columns)
//   f32 or bf16 x and w, f32 theta, every product accumulated with f32 FMA
//   (no TF32, no tensor cores), f32 out.
//
// What bounds it on this card.  Both modes are thin contractions: at most
// 2*M FLOP per element of X with M <= 2 on the linear path, far below the
// ~20 FLOP/byte where f32 FMA (67 TFLOP/s) overtakes HBM (3.35 TB/s), so the
// bound is the bytes: read X once, read the other operands once, write the
// output once.
//   * Minibatch steps, (8, 32, 512) against M = 1 or 2: ~0.5 MB, about
//     0.16 us at 3.35 TB/s.  A launch costs more than that: latency, not
//     bandwidth, sets the time, so one launch serves all parties.
//   * Full-dataset passes (full_gradient, saga_init), (8, 350000, 512) f32:
//     5.73 GB of X, 1.71 ms at 3.35 TB/s.  Here the bytes are the bound and
//     enough loads must be in flight on all 132 SMs to stream them.
//
// Design.  The TPU kernel's sequential grid axes become loops inside a
// block and its VMEM accumulators become registers.
//   * forward (two programs, chosen by the caller by M alone):
//     - narrow M (M <= kNarrow, the linear path; narrow_rows): lanes over
//       D, each lane owning fixed 16-byte groups of a row, one accumulator
//       per column, and a butterfly of warp shuffles completing each
//       column.  A lane issues all its loads of a row (16 values at d =
//       512: four float4, or two vectors of 8 bf16) and of its share of W
//       in one batch before its first FMA, so a minibatch step, one row a
//       warp, is one round trip (the earlier body, four dependent rounds
//       of scalar loads, took 2.89 us at (8, 64, 512); this one 1.79, on
//       an NVIDIA H100 80GB HBM3 at 700 W, tools/vfl_grad_ab.py).  Over the
//       full dataset each warp takes kStreamRows rows of one party, W kept
//       in registers, the next row's loads issued before the current
//       row's FMAs and butterfly, the rows read through the streaming
//       cache path, on a grid of 87,500 blocks that the card hands out
//       as SMs free: a persistent grid of one wave ran 3% slower (its
//       slowest SM sets its end), one row a warp 4% slower, plain loads
//       2% slower (this form 1,770 us, cuBLAS 1,807 in the same call);
//     - wide M (vfl_forward_wide: the deep encoder layers, (8, 64, 512)
//       against 32 columns and (8, 64, 32) against 16 in deep serving).
//       Every row needs all of its party's W (64 KB at layer 1), so a
//       tile of rows x columns re-reads W once per row tile and X once per
//       column tile: at these sizes latency and that L2-to-SM traffic
//       bound it, not HBM (1.6 MB, 0.49 us) nor the FMAs.  A block covers
//       kWideRows = 2 rows x kWideTileCols = 16 columns (4 KB of X, 32 KB
//       of W at layer 1); its 8 warps split D into fixed slices, and each
//       warp's lanes into 8 slots along D x 4 chunks of 4 columns, so the
//       lanes of a slot read 64 contiguous bytes of a W row (4 columns a
//       lane as one vector) and x as 16-byte vectors, a batch's loads all
//       issued before its FMAs.  The slots' sums are reduce-scattered over
//       lanes xor 16, 8, 4 and the warps' added in warp order through
//       shared memory.  Over D <= 64 (layer 2) the first slice is all of
//       D, so warps take rows instead, with the same bits.  The first form
//       (4 rows x 32 columns a block, each warp walking an eighth of D one
//       element at a time) took 7.24 us at deep layer 1, 6.87 at the
//       cache hit (64, 512) and 1.78 at layer 2; this form 4.35, 2.17 and
//       1.73.  Blocks of 4 rows were faster at layer 1 (3.94) but slower
//       at the hit (2.95) and layer 2 (1.85 with 2 rows a warp there, 2.59
//       with 4), 8 rows slower at all three (5.12, 3.74, 1.82); deep
//       serving launches each hit shape twice as often as layer 1, so 2
//       rows take least over its launches (NVIDIA H100 80GB HBM3, 700 W,
//       tools/vfl_grad_ab.py, one call).
//   * backward (two programs): every output g[p, d, m] is a sum over the B
//     rows, and on Hopper blocks run in no order, so nothing can carry a
//     sum across blocks the way the TPU kernel carries g_acc across its
//     sequential row grid (vfl_grad.py:165-196).
//     - vfl_backward_rows: a block of 8 warps owns one chunk of kChunkRows
//       rows, one party, one tile of kBwdTile = 64 columns d (lane j owns
//       columns j and j + 32 of the tile) and one group of up to kBwdCols
//       theta columns.  Warp v sums a fixed contiguous eighth of the
//       chunk's rows, issuing each batch of kBwdBatch rows' X loads (one
//       128-byte line per column half in f32) and theta loads (one
//       broadcast) before their FMAs; the eight partial sums are added in
//       warp order through shared memory.  When B fits one chunk (every
//       minibatch step) the block applies the epilogue (/denom, + lam*W)
//       and writes g directly: one launch per step.  Otherwise it writes
//       its chunk's partial sums to a workspace the wrapper allocates, and
//     - vfl_backward_reduce adds the chunks' partials: a block of 8 warps
//       owns 32 consecutive outputs (lane = output), warp v adds a fixed
//       contiguous range of the chunks in chunk order, its loads batched,
//       and the eight partials are added in warp order before the epilogue.
//     The minibatch steps are latency-bound: at (8, 32, 512) the rows
//     program runs 8 parties x 8 tiles = 64 blocks of 8 warps, each warp's
//     4 rows loaded in one round trip (a block per 128 columns, one thread
//     walking all 32 rows, took 3.10 us; this form 1.87, on an NVIDIA H100
//     80GB HBM3 at 700 W, tools/vfl_grad_ab.py).  Tiles of 32 columns (128
//     blocks) or 128 (32 blocks) and batches of 8 or 16 rows were slower
//     there, and so were a chunk-fastest 3-D grid and 64-bit block-index
//     arithmetic.  The full-dataset passes are bound by the bytes: 342
//     chunks x 8 parties x 8 tiles = 21,888 blocks, the 8 tiles of one
//     chunk adjacent in the grid so that each row's 2 KB are read
//     together.  The reduce of their (342, 8, 512, 1) workspace runs 128
//     blocks, each warp's 43 chunks in one batch of loads.
//     No float atomics: the summation order of every output depends only
//     on B (the chunking), never on scheduling or the grid, so an epoch
//     replays bit for bit.
//   * fused (one program, vfl_fused_split): a Hopper block cannot wait for
//     another, so the program's grid is the union of the two sides' grids:
//     its first blocks run the narrow (Mw <= kNarrow) or wide forward body
//     over the forward rows, the rest the rows program's body over the
//     backward rows, one backward block each.  The bodies are the
//     __device__ functions the single-mode programs call, so each output
//     sums in the same order as there; the split form needs no padding copy
//     (each side masks its own edges), and a backward side over more than
//     one chunk writes the workspace that vfl_backward_reduce adds.  One
//     launch per pipelined step.
// The ragged edges (rows past B, columns past D or M, the tail of D) are
// masked inside the kernels; the wrapper pads nothing.  In the forward
// programs an output's summation order depends only on D, M, its column
// and the dtype: never on B, the row's place in the batch, the load width,
// the operands' alignment or the geometry the launcher picks, so a row
// gives bit-identical z in any launch -- the serving cache (a hit against
// its cold dispatch), the fused mode (whose forward blocks run the same
// body) and an epoch's replay rely on that.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNarrow = 4;  // widest M taken by the lanes-over-D program
constexpr int kVecBytes = 16;  // one vector load: a lane's group of a row
constexpr int kLaneVals = 16;  // values of a row a lane holds at once
constexpr int kPass = 32 * kLaneVals;  // a row's elements per pass (512)
constexpr int kOneRowBlocks = 2048;  // the narrow forward's one-row grid
constexpr int kStreamRows = 4;  // rows a warp takes past that grid
constexpr int kVec = 1, kVecOnce = 2;  // the narrow forward's vector loads
constexpr int kWideCols = 4;    // columns a lane of the wide forward owns
constexpr int kWideChunks = 4;  // lanes of a warp across columns
constexpr int kWideSlots = 32 / kWideChunks;  // lanes of a warp across D
constexpr int kWideLaneK = 8;   // elements of D a lane takes a batch
constexpr int kWideRows = 2;    // rows a wide forward block (d > 64) or
                                // warp (d <= 64) takes
constexpr int kWideTileCols = kWideChunks * kWideCols;  // columns a block
constexpr int kWideBatch = kWideSlots * kWideLaneK;  // D a warp takes a batch
static_assert(kWideSlots == 8, "the slots' sums reduce over lanes 4, 8, 16");
static_assert(kWideRows * kWideCols % kWideSlots == 0,
              "the slots' sums reduce-scatter evenly");
// Rows of a wide forward block (wide_block): kWideRows over d >
// kWideBatch, kWideRows a warp over d <= kWideBatch.
__host__ __device__ constexpr long long wide_rows(long long d) {
  return d > kWideBatch ? kWideRows : kWideRows * kWarpsPerBlock;
}
constexpr int kBwdThreads = kWarpsPerBlock * 32;  // a backward block
constexpr int kBwdCols = 4;        // theta columns a block takes at M > 2
constexpr int kChunkRows = 1024;   // rows per backward block (one partial)
constexpr int kBwdLaneCols = 2;    // columns a lane owns, 32 apart
constexpr int kBwdTile = 32 * kBwdLaneCols;  // columns d per backward block
constexpr int kBwdBatch = 4;       // rows whose loads a warp issues at once
constexpr int kReduceBatch = 48;   // chunks whose loads a warp issues at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A 16-byte vector of the dtype: G = 4 f32 or 8 bf16 elements, widened to
// f32 exactly as to_f32 widens each (bf16 is the high half of an f32).
// Lanes<T>: a lane's share of a pass of a row, S such groups.
template <typename T>
struct Lanes {
  using Vec = std::conditional_t<sizeof(T) == 4, float4, uint4>;
  static constexpr int G = kVecBytes / static_cast<int>(sizeof(T));
  static constexpr int S = kLaneVals / G;
};

__device__ __forceinline__ void widen(float4 t, float (&v)[4]) {
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void widen(uint4 t, float (&v)[8]) {
  const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// One vector load at p (16-byte aligned); load16_once takes the streaming
// (evict-first) cache path, for rows that nothing reads again.
template <typename T>
__device__ __forceinline__ void load16(const T* p,
                                       float (&v)[Lanes<T>::G]) {
  widen(*reinterpret_cast<const typename Lanes<T>::Vec*>(p), v);
}
template <typename T>
__device__ __forceinline__ void load16_once(const T* p,
                                            float (&v)[Lanes<T>::G]) {
  widen(__ldcs(reinterpret_cast<const typename Lanes<T>::Vec*>(p)), v);
}

// kWideCols = 4 consecutive values at p (aligned to their size) as one
// vector load: 16 bytes of f32 or 8 of bf16, widened as to_f32 widens each.
__device__ __forceinline__ void load_cols(const float* p, float (&v)[4]) {
  widen(*reinterpret_cast<const float4*>(p), v);
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}
static_assert(kWideCols == 4, "load_cols reads four columns");

// The bodies below are __device__ functions that the per-mode programs and
// vfl_fused_split call alike, so a row or a column sums in the same order
// in every program that computes it.

// The narrow forward (m <= kNarrow), lanes over D.  A lane owns the
// 16-byte groups g = lane + 32 j (j = 0, 1, ...) of a row: kVecBytes of the
// dtype each (4 f32 or 8 bf16 elements, group g = elements [g G, g G + G)),
// and adds x[k] * w[k, c] into one accumulator per column c, j by j and
// element by element, for the elements k < d; a butterfly of warp shuffles
// (xor 16, 8, 4, 2, 1) then completes each column.  Which elements a lane
// owns, their order and the butterfly depend on d, the column and the
// dtype alone: never on the row's place, the batch, the load width, the
// pointers' alignment or the geometry the launcher picked (below), so a
// row gives bit-identical z in any launch -- the serving cache, the fused
// mode's z and an epoch's replay rely on that.
//
// A pass of a row is the kLaneVals values a lane holds at once (all of a
// row at d <= kPass = 512); its loads are issued in one batch before its
// FMAs.  `vec` is the launch's load mode (narrow_vec): vector loads
// (kVec, kVecOnce) where d is a whole number of groups and x and w are
// 16-byte aligned, else every element loaded alone (0), into the same
// registers.  Out-of-range groups and elements are loaded at a clamped
// index (masked loads let nvcc serialise a batch, see vfl_backward_reduce)
// and skipped by the FMAs.

// x of the lane's groups in pass p of row xr (ngroups = ceil(d / G) > 0).
template <typename T>
__device__ __forceinline__ void narrow_load_x(
    float (&xv)[Lanes<T>::S][Lanes<T>::G], const T* __restrict__ xr, int p,
    int d, int ngroups, int vec, int lane) {
  constexpr int S = Lanes<T>::S, G = Lanes<T>::G;
  if (vec == kVecOnce) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = min(lane + 32 * (p * S + s), ngroups - 1);
      load16_once(xr + g * G, xv[s]);
    }
  } else if (vec) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = min(lane + 32 * (p * S + s), ngroups - 1);
      load16(xr + g * G, xv[s]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        xv[s][e] = to_f32(xr[min((lane + 32 * (p * S + s)) * G + e, d - 1)]);
      }
    }
  }
}

// w (d, MW) of the same elements: group g's MW columns are G * MW
// consecutive values, element e's column c at wv[s][e * MW + c].
template <int MW, typename T>
__device__ __forceinline__ void narrow_load_w(
    float (&wv)[Lanes<T>::S][Lanes<T>::G * MW], const T* __restrict__ wp,
    int p, int d, int ngroups, int vec, int lane) {
  constexpr int S = Lanes<T>::S, G = Lanes<T>::G;
  if (vec) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = min(lane + 32 * (p * S + s), ngroups - 1);
#pragma unroll
      for (int u = 0; u < MW; ++u) {
        float v[G];
        load16(wp + (g * MW + u) * G, v);
#pragma unroll
        for (int i = 0; i < G; ++i) wv[s][u * G + i] = v[i];
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const int k = min((lane + 32 * (p * S + s)) * G + e, d - 1);
#pragma unroll
        for (int c = 0; c < MW; ++c) {
          wv[s][e * MW + c] = to_f32(wp[k * MW + c]);
        }
      }
    }
  }
}

// acc[c] += x[k] * w[k, c] over pass p's elements k < d, in element order.
template <int MW, int S, int G>
__device__ __forceinline__ void narrow_fma(float (&acc)[MW],
                                           const float (&xv)[S][G],
                                           const float (&wv)[S][G * MW],
                                           int p, int d, int lane) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int e = 0; e < G; ++e) {
      if ((lane + 32 * (p * S + s)) * G + e < d) {
#pragma unroll
        for (int c = 0; c < MW; ++c) {
          acc[c] = fmaf(xv[s][e], wv[s][e * MW + c], acc[c]);
        }
      }
    }
  }
}

// The butterfly of each column; lane c < MW writes column c of the row.
template <int MW>
__device__ __forceinline__ void narrow_store(const float (&acc)[MW],
                                             float* __restrict__ zr,
                                             int lane) {
  float out = 0.0f;
#pragma unroll
  for (int c = 0; c < MW; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == c) out = v;
  }
  if (lane < MW) zr[lane] = out;
}

// One warp's rows r, r + step, r + 2 step, ... < nrows of one party's x
// (xp, row stride d) against its w (wp), into zp (row stride MW).  At d <=
// kPass the warp loads its share of w once and keeps it in registers, and
// issues the next row's loads before the current row's FMAs and
// butterfly; a wider row takes its passes one after another, w reloaded
// with x.  r, step and nrows fit 32 bits (the launcher checks); pointers
// advance by a 64-bit stride, so no 64-bit multiply runs per row.
template <int MW, typename T>
__device__ __forceinline__ void narrow_rows(const T* __restrict__ xp,
                                            const T* __restrict__ wp,
                                            float* __restrict__ zp, int r,
                                            int step, int nrows, int d,
                                            int vec, int lane) {
  constexpr int S = Lanes<T>::S, G = Lanes<T>::G;
  if (r >= nrows) return;  // whole warp
  const T* xr = xp + static_cast<long long>(r) * d;
  float* zr = zp + static_cast<long long>(r) * MW;
  const long long xstep = static_cast<long long>(step) * d;
  const long long zstep = static_cast<long long>(step) * MW;
  if (d == 0) {  // an empty contraction: z = 0, nothing to load
    for (; r < nrows; r += step, zr += zstep) {
      if (lane < MW) zr[lane] = 0.0f;
    }
    return;
  }
  const int ngroups = (d + G - 1) / G;
  float wv[S][G * MW];
  float xa[S][G];
  if (d <= kPass) {
    narrow_load_w<MW>(wv, wp, 0, d, ngroups, vec, lane);
    narrow_load_x(xa, xr, 0, d, ngroups, vec, lane);
    for (;;) {
      const bool more = r + step < nrows;  // warp-uniform
      float xb[S][G];
      if (more) narrow_load_x(xb, xr + xstep, 0, d, ngroups, vec, lane);
      float acc[MW];
#pragma unroll
      for (int c = 0; c < MW; ++c) acc[c] = 0.0f;
      narrow_fma(acc, xa, wv, 0, d, lane);
      narrow_store(acc, zr, lane);
      if (!more) return;
      r += step;
      xr += xstep;
      zr += zstep;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int e = 0; e < G; ++e) xa[s][e] = xb[s][e];
      }
    }
  }
  const int passes = (d + kPass - 1) / kPass;
  for (; r < nrows; r += step, xr += xstep, zr += zstep) {
    float acc[MW];
#pragma unroll
    for (int c = 0; c < MW; ++c) acc[c] = 0.0f;
    for (int p = 0; p < passes; ++p) {
      narrow_load_w<MW>(wv, wp, p, d, ngroups, vec, lane);
      narrow_load_x(xa, xr, p, d, ngroups, vec, lane);
      narrow_fma(acc, xa, wv, p, d, lane);
    }
    narrow_store(acc, zr, lane);
  }
}

// Block bx of one party's forward blocks covers rows [bx * 8 * rpw,
// (bx + 1) * 8 * rpw): warp v of its 8 takes rows bx * 8 * rpw + v + 8 k
// (k < rpw), so the block's warps read consecutive rows side by side.
template <int MW, typename T>
__device__ __forceinline__ void narrow_block(const T* xp, const T* wp,
                                             float* zp, int bx, int rpw,
                                             int nrows, int d, int vec) {
  const int r0 = bx * kWarpsPerBlock * rpw;
  narrow_rows<MW>(xp, wp, zp, r0 + (threadIdx.x >> 5), kWarpsPerBlock,
                  min(nrows, r0 + kWarpsPerBlock * rpw), d, vec,
                  threadIdx.x & 31);
}

// The wide forward (m > kNarrow).  A block covers wide_rows(d) rows x
// kWideTileCols columns of one party: rows from r0 (< nrows) of xp (row
// stride d) against columns [c0, c0 + kWideTileCols) (< m) of wp (row
// stride m), into zp (row stride m).  Over d > kWideBatch, warp v takes a
// fixed slice of D, `per` = ceil(d / 8) rounded up to kWideBatch
// elements, in batches of kWideBatch, for the block's kWideRows rows;
// over d <= kWideBatch the first slice is all of D, so warp v takes all of
// it for kWideRows rows of its own from r0 + v * kWideRows, and its sums
// are final (the other slices would add zeros: the same bits).  Lane
// (slot, chunk) = (lane / kWideChunks, lane % kWideChunks) owns columns
// c0 + chunk * kWideCols + [0, kWideCols) and, in a batch starting at kb,
// the kWideLaneK elements kb + i * kWideSlots * G + slot * G + e (i <
// kWideLaneK / G, e < G; G elements of the dtype to a 16-byte vector).
// A batch's loads are issued together before its FMAs: each row's x as
// kWideLaneK / G vectors, and w's kWideCols columns of each element as one
// vector, so the lanes of a slot read 64 contiguous bytes of a w row and
// the warp's w loads touch 8 rows.  A lane adds x[r, k] * w[k,
// c] over its elements in that order; the 8 slots' sums are reduce-
// scattered over lanes xor 16, 8, 4; the 8 warps' sums are added in warp
// order through shared memory.  So a z sums in an order set by d and the
// dtype alone: never by m, the row count, the row's place, the column's
// place in the tile, the load width or the grid.  Out-of-range rows,
// columns and elements are loaded at a clamped index and never stored
// (rows, columns) or skipped by the FMAs (elements).  Every thread of the
// block calls it (it holds a barrier).
template <typename T>
__device__ __forceinline__ void wide_block(const T* __restrict__ xp,
                                           const T* __restrict__ wp,
                                           float* __restrict__ zp, int r0,
                                           int nrows, int c0, int d, int m,
                                           int vec) {
  constexpr int G = Lanes<T>::G, NV = kWideLaneK / G;
  constexpr int R = kWideRows, MW = kWideCols, V = R * MW;
  constexpr int VL = V / kWideSlots;  // sums a lane keeps after the scatter
  static_assert(kWideLaneK % G == 0, "a lane's elements are whole vectors");
  __shared__ float part[kWarpsPerBlock][R][kWideTileCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = lane / kWideChunks;
  const int col = c0 + lane % kWideChunks * MW;  // the lane's first column
  const bool split = d > kWideBatch;  // block-uniform
  const int per = ((d + kWarpsPerBlock - 1) / kWarpsPerBlock +
                   kWideBatch - 1) / kWideBatch * kWideBatch;
  const int k0 = split ? warp * per : 0;
  const int k1 = split ? min(d, (warp + 1) * per) : d;
  if (!split) r0 += warp * R;
  const bool xvec = vec & 1, wvec = vec & 2;
  float acc[R][MW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < MW; ++c) acc[r][c] = 0.0f;
  }
  for (int kb = k0; kb < k1; kb += kWideBatch) {
    float wv[kWideLaneK][MW];
    float xv[R][kWideLaneK];
#pragma unroll
    for (int i = 0; i < kWideLaneK; ++i) {
      const int k = kb + i / G * kWideSlots * G + slot * G + i % G;
      const T* wk = wp + static_cast<long long>(min(k, d - 1)) * m;
      if (wvec) {
        load_cols(wk + col, wv[i]);
      } else {
#pragma unroll
        for (int c = 0; c < MW; ++c) {
          wv[i][c] = to_f32(wk[min(col + c, m - 1)]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* xr = xp + static_cast<long long>(min(r0 + r, nrows - 1)) * d;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int k = kb + v * kWideSlots * G + slot * G;
        if (xvec) {
          float t[G];
          load16(xr + min(k, d - G), t);
#pragma unroll
          for (int e = 0; e < G; ++e) xv[r][v * G + e] = t[e];
        } else {
#pragma unroll
          for (int e = 0; e < G; ++e) {
            xv[r][v * G + e] = to_f32(xr[min(k + e, d - 1)]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWideLaneK; ++i) {
      if (kb + i / G * kWideSlots * G + slot * G + i % G < d) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < MW; ++c) {
            acc[r][c] = fmaf(xv[r][i], wv[i][c], acc[r][c]);
          }
        }
      }
    }
  }
  // the slots' sums: reduce-scatter over lane bits 4, 3, 2; the lane keeps
  // VL consecutive sums (row r, column c at index r * MW + c) from `base`
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = acc[i / MW][i % MW];
  int base = 0;
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int o = 16 >> lvl, half = V >> (lvl + 1);  // compile-time
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = up ? v[i + half] : v[i];
      const float send = up ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (up) base += half;
  }
  if (!split) {
#pragma unroll
    for (int i = 0; i < VL; ++i) {
      const int r = r0 + (base + i) / MW, c = col + (base + i) % MW;
      if (r < nrows && c < m) zp[static_cast<long long>(r) * m + c] = v[i];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < VL; ++i) {
    const int idx = base + i;
    part[warp][idx / MW][lane % kWideChunks * MW + idx % MW] = v[i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < R * kWideTileCols; o += kWarpsPerBlock * 32) {
    const int r = o / kWideTileCols, c = o % kWideTileCols;
    if (r0 + r < nrows && c0 + c < m) {
      float t = part[0][r][c];
#pragma unroll
      for (int w = 1; w < kWarpsPerBlock; ++w) t += part[w][r][c];
      zp[static_cast<long long>(r0 + r) * m + c0 + c] = t;
    }
  }
}

// Backward over one chunk, one block: lane j of warp v sums
// x[p, r, c0 + 32 k] * th[p, r, m0 + c] (c0 = tile * kBwdTile + j, k <
// kBwdLaneCols) over warp v's fixed slice of the chunk's rows [r0, r1), in
// row order, for the KC theta columns c < mc of the group; the slices'
// partial sums are added in warp order through shared memory.  xp points
// at the party's x, tp at column m0 of the party's theta (row stride m).
// direct != 0 (the rows fit one chunk): out is g (P, D, M) and the
// epilogue (/denom, + lam * w when w is given) is applied here; else out
// is the workspace (chunks, P, D, M).  A warp takes its rows kBwdBatch at a
// time (a minibatch step's 4 rows a warp in one batch), every load of a
// batch issued before its FMAs, which run row by row, so the order of every
// sum depends only on the chunk's row count.  Rows past r1, columns past D
// and theta columns past mc are masked, never returned: every thread of
// the block calls this (it holds a barrier).  Clamping the loads' indices
// instead of masking them cost this body 8% at the SGD step and 25% at the
// multi-dominator step on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/vfl_grad_ab.py); the reduce, below, clamps.
template <int KC, typename T>
__device__ __forceinline__ void bwd_tile(const T* __restrict__ xp,
                                         const float* __restrict__ tp,
                                         const T* __restrict__ w,
                                         float* __restrict__ out,
                                         long long r0, long long r1,
                                         long long party, long long parties,
                                         long long chunk, int tile, int d,
                                         int m, int m0, float denom,
                                         float lam, int direct) {
  constexpr int kL = kBwdLaneCols;
  __shared__ float part[kWarpsPerBlock][kL * KC][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = tile * kBwdTile + lane;
  const int mc = min(KC, m - m0);
  const int n = static_cast<int>(r1 - r0);
  const int per = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int re = min(n, (warp + 1) * per);
  const T* xc = xp + r0 * d;
  const float* tc = tp + r0 * m;
  float acc[kL][KC];
#pragma unroll
  for (int k = 0; k < kL; ++k) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[k][c] = 0.0f;
  }
  for (int r = min(n, warp * per); r < re; r += kBwdBatch) {
    const T* xr = xc + static_cast<long long>(r) * d;
    const float* tr = tc + static_cast<long long>(r) * m;
    float xv[kBwdBatch][kL], tv[kBwdBatch][KC];
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      const bool in = r + u < re;
#pragma unroll
      for (int k = 0; k < kL; ++k) {
        xv[u][k] = in && c0 + 32 * k < d
                       ? to_f32(xr[static_cast<long long>(u) * d + c0 +
                                   32 * k])
                       : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        tv[u][c] = in && c < mc ? tr[static_cast<long long>(u) * m + c]
                                : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdBatch; ++u) {
      if (r + u < re) {  // warp-uniform
#pragma unroll
        for (int k = 0; k < kL; ++k) {
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            acc[k][c] = fmaf(xv[u][k], tv[u][c], acc[k][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kL; ++k) {
#pragma unroll
    for (int c = 0; c < KC; ++c) part[warp][k * KC + c][lane] = acc[k][c];
  }
  __syncthreads();
  // warp v finishes the block's outputs k * KC + c = v, v + 8, ...
  for (int o = warp; o < kL * KC; o += kWarpsPerBlock) {
    const int col = c0 + 32 * (o / KC);
    const int c = o % KC;
    if (c < mc && col < d) {
      float s = part[0][o][lane];
#pragma unroll
      for (int v = 1; v < kWarpsPerBlock; ++v) s += part[v][o][lane];
      const long long i = (party * d + col) * m + m0 + c;
      if (direct) {
        float g = s / denom;
        if (w != nullptr) g = g + lam * to_f32(w[i]);
        out[i] = g;
      } else {
        out[chunk * parties * d * m + i] = s;
      }
    }
  }
}

// Backward block b of the grid over (column tile, theta-column group,
// party, chunk), the tile fastest, so the blocks that read one chunk's rows
// run side by side: rows [0, nb) of each party's block of x (rows rows a
// party) against theta (party stride th_pstride) into g or, for nb >
// kChunkRows, the workspace.  The rows program and the fused program's
// backward blocks both come here; the launcher keeps the grid under 2^31
// blocks, so b splits in 32-bit arithmetic.
template <int KC, typename T>
__device__ __forceinline__ void bwd_block(unsigned b, const T* x,
                                          const float* th, const T* w,
                                          float* out, long long parties,
                                          long long rows, long long nb, int d,
                                          int m, long long th_pstride,
                                          float denom, float lam) {
  const unsigned ntiles = (d + kBwdTile - 1) / kBwdTile;
  const unsigned groups = (m + KC - 1) / KC;
  const int tile = static_cast<int>(b % ntiles);
  b /= ntiles;
  const int m0 = static_cast<int>(b % groups) * KC;
  b /= groups;
  const long long party = b % static_cast<unsigned>(parties);
  const long long chunk = b / static_cast<unsigned>(parties);
  const long long r0 = chunk * kChunkRows;
  bwd_tile<KC>(x + party * rows * d, th + party * th_pstride + m0, w, out,
               r0, min(nb, r0 + kChunkRows), party, parties, chunk, tile, d,
               m, m0, denom, lam, nb <= kChunkRows ? 1 : 0);
}

// Lanes over D: block (bx, party), 8 warps of rpw rows each
// (narrow_block).
template <int MW, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_forward_narrow(const T* __restrict__ x, const T* __restrict__ w,
                   float* __restrict__ z, int rows, int d, int rpw,
                   int vec) {
  const long long party = blockIdx.y;
  narrow_block<MW>(x + party * rows * d, w + party * d * MW,
                   z + party * rows * MW, blockIdx.x, rpw, rows, d, vec);
}

// Block (row tile, party, column tile) covers wide_rows(d) rows x
// kWideTileCols columns of one party (wide_block); vec from wide_vec.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_forward_wide(const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ z, int rows, int d, int m, int vec) {
  const long long party = blockIdx.y;
  wide_block(x + party * rows * d, w + party * d * m, z + party * rows * m,
             blockIdx.x * static_cast<int>(wide_rows(d)), rows,
             blockIdx.z * kWideTileCols, d, m, vec);
}

// Backward, rows: backward block blockIdx.x of bwd_block's grid.
template <int KC, typename T>
__global__ void __launch_bounds__(kBwdThreads)
vfl_backward_rows(const T* __restrict__ x, const float* __restrict__ th,
                  const T* __restrict__ w, float* __restrict__ out,
                  long long parties, long long rows, int d, int m,
                  long long th_pstride, float denom, float lam) {
  bwd_block<KC>(blockIdx.x, x, th, w, out, parties, rows, rows, d, m,
                th_pstride, denom, lam);
}

// Backward, reduce: a block owns 32 consecutive outputs i of the (P, D, M)
// g, lane j output i0 + j; warp v adds the partials of a fixed contiguous
// range of the chunks in chunk order, each batch of kReduceBatch chunks'
// loads issued before their adds, then the eight ranges' sums are added in
// warp order and the epilogue applied.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
vfl_backward_reduce(const float* __restrict__ ws, const T* __restrict__ w,
                    float* __restrict__ g, long long chunks, long long outs,
                    float denom, float lam) {
  __shared__ float part[kWarpsPerBlock][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = i < outs;
  const long long per = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long ce = min(chunks, (warp + 1) * per);
  const float* wi = ws + (live ? i : 0);
  float s = 0.0f;
  for (long long c = min(chunks, warp * per); c < ce; c += kReduceBatch) {
    // unconditional loads at clamped indices: masked, nvcc left a batch of
    // 32 at one load per round trip (9.74 us over the (342, 8, 512, 1)
    // workspace, 3.52 clamped, 3.11 clamped at 48; same card and script
    // as in bwd_tile's note)
    float v[kReduceBatch];
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      v[u] = wi[min(c + u, ce - 1) * outs];
    }
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      if (c + u < ce) s += v[u];  // warp-uniform
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && live) {
    float t = part[0][lane];
#pragma unroll
    for (int v = 1; v < kWarpsPerBlock; ++v) t += part[v][lane];
    float o = t / denom;
    if (w != nullptr) o = o + lam * to_f32(w[i]);
    g[i] = o;
  }
}

// The fused mode and its split-batch form, one launch for every party.
// Each party's block of x holds `rows` rows; the forward side is rows
// [f0, f0 + nf) against w (P, D, mw) into z (P, nf, mw), the backward side
// rows [0, nb) against theta (P, nb, mth) (party stride th_pstride) into g
// (P, D, mth) or, for nb > kChunkRows, the per-chunk workspace.  The grid
// is the union of both programs' grids in one dimension: the first fblocks
// blocks are forward blocks (narrow: fbpp a party, the narrow program's
// blocks; wide: a (row tile, party, column tile) each), the rest backward
// blocks, each one block of vfl_backward_rows' grid (bwd_block) over the
// backward rows, KC chosen as there.  No block waits for another: the two
// sides share no output.  An instance holds one forward body, FW = mw's
// narrow body (1..kNarrow) or the wide one (0): with all five in one
// instance a pipelined SGD step's launch took 2.6 us of device time inside
// the epoch, with one 1.85, though both took 2.0 in a loop of launches
// (NVIDIA H100 80GB HBM3, 700 W, tools/vfl_grad_ab.py's epoch profile).
template <int KC, int FW, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_fused_split(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ th, float* __restrict__ z,
                float* __restrict__ out, long long parties, long long rows,
                long long f0, long long nf, long long nb, int d, int mw,
                int mth, long long th_pstride, float denom, float lam,
                int lamw, long long fblocks, int fbpp, int frpw,
                int vec) {
  const long long blk = blockIdx.x;
  if (blk < fblocks) {  // forward: block-uniform branch
    if constexpr (FW > 0) {
      // fblocks = parties * fbpp < 2^31: the block splits in 32 bits
      const unsigned party = static_cast<unsigned>(blk) / fbpp;
      const int bx = static_cast<int>(blk) - party * fbpp;
      narrow_block<FW>(x + (party * rows + f0) * d,
                       w + static_cast<long long>(party) * d * FW,
                       z + static_cast<long long>(party) * nf * FW, bx,
                       frpw, static_cast<int>(nf), d, vec);
    } else {
      const long long tile = wide_rows(d);
      const long long rtiles = (nf + tile - 1) / tile;
      const long long party = (blk / rtiles) % parties;
      wide_block(x + (party * rows + f0) * d,
                 w + party * static_cast<long long>(d) * mw,
                 z + party * nf * mw,
                 static_cast<int>(blk % rtiles * tile),
                 static_cast<int>(nf),
                 static_cast<int>(blk / (rtiles * parties)) * kWideTileCols,
                 d, mw, vec);
    }
    return;
  }
  bwd_block<KC>(static_cast<unsigned>(blk - fblocks), x, th,
                lamw ? w : static_cast<const T*>(nullptr), out, parties, rows,
                nb, d, mth, th_pstride, denom, lam);
}

// The fused program's instance for mw's forward body (KC given).
template <int KC, typename T>
auto fused_kernel(long long mw) {
  switch (mw) {
    case 1: return &vfl_fused_split<KC, 1, T>;
    case 2: return &vfl_fused_split<KC, 2, T>;
    case 3: return &vfl_fused_split<KC, 3, T>;
    case 4: return &vfl_fused_split<KC, 4, T>;
    default: return &vfl_fused_split<KC, 0, T>;
  }
}
static_assert(kNarrow == 4, "fused_kernel has one case per narrow M");

// Each program has its own entry point, so the caller knows which kernel a
// call launches: narrow takes 1 <= m <= kNarrow, wide takes m > kNarrow, and
// either refuses the other's m with cudaErrorInvalidValue.
bool bad_sizes(long long parties, long long rows, long long d, long long m) {
  return parties < 1 || rows < 1 || d < 0 || m < 1 || d > 0x7fffffffLL ||
         d * m > 0x7fffffffLL || parties > 65535;  // int W offsets, grid.y
}

// Rows a warp of the narrow forward takes: one while the grid of one-row
// warps stays within kOneRowBlocks blocks (every minibatch step), else
// kStreamRows (the full-dataset passes: tens of thousands of blocks that
// the card schedules as SMs free, each warp streaming its rows with w in
// registers).
int narrow_rpw(long long parties, long long rows) {
  return parties * ((rows + kWarpsPerBlock - 1) / kWarpsPerBlock) <=
                 kOneRowBlocks
             ? 1
             : kStreamRows;
}

// How the narrow forward loads (every choice sums in the same order):
// element by element (0), vectors (kVec: whole groups and 16-byte aligned
// x and w), or vectors of x through the streaming cache path (kVecOnce:
// warps of more than one row, which read rows that nothing reads again).
template <typename T>
int narrow_vec(const void* x, const void* w, long long d, int rpw) {
  if (d % Lanes<T>::G != 0 ||
      reinterpret_cast<uintptr_t>(x) % kVecBytes != 0 ||
      reinterpret_cast<uintptr_t>(w) % kVecBytes != 0) {
    return 0;
  }
  return rpw > 1 ? kVecOnce : kVec;
}

// How the wide forward loads (every choice sums in the same order): bit 0,
// x as 16-byte vectors (d whole groups, x 16-byte aligned); bit 1, w's
// kWideCols columns as one vector (m a multiple of kWideCols, w aligned to
// the vector).
template <typename T>
int wide_vec(const void* x, const void* w, long long d, long long m) {
  const int xv = d % Lanes<T>::G == 0 &&
                 reinterpret_cast<uintptr_t>(x) % kVecBytes == 0;
  const int wv = m % kWideCols == 0 &&
                 reinterpret_cast<uintptr_t>(w) % (kWideCols * sizeof(T)) ==
                     0;
  return xv | wv << 1;
}

// Column tiles of the wide forward's grid.
long long wide_ctiles(long long m) {
  return (m + kWideTileCols - 1) / kWideTileCols;
}

template <typename T>
int launch_narrow(const void* x, const void* w, void* z, long long parties,
                  long long rows, long long d, long long m, void* stream) {
  // rows < 2^30: a warp's row index plus its step stays in 32 bits
  if (bad_sizes(parties, rows, d, m) || m > kNarrow || rows >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = &vfl_forward_narrow<kNarrow, T>;
  if (m == 1) kernel = &vfl_forward_narrow<1, T>;
  if (m == 2) kernel = &vfl_forward_narrow<2, T>;
  if (m == 3) kernel = &vfl_forward_narrow<3, T>;
  const int rpw = narrow_rpw(parties, rows);
  const long long bpp = (rows + kWarpsPerBlock * rpw - 1) /
                        (kWarpsPerBlock * rpw);
  kernel<<<dim3(static_cast<unsigned>(bpp), static_cast<unsigned>(parties)),
           dim3(kWarpsPerBlock * 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(z), static_cast<int>(rows), static_cast<int>(d),
      rpw, narrow_vec<T>(x, w, d, rpw));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wide(const void* x, const void* w, void* z, long long parties,
                long long rows, long long d, long long m, void* stream) {
  // rows < 2^30: a warp's row index stays in 32 bits
  if (bad_sizes(parties, rows, d, m) || m <= kNarrow ||
      rows >= (1LL << 30) || wide_ctiles(m) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(
      static_cast<unsigned>((rows + wide_rows(d) - 1) / wide_rows(d)),
      static_cast<unsigned>(parties), static_cast<unsigned>(wide_ctiles(m)));
  vfl_forward_wide<T><<<grid, dim3(kWarpsPerBlock * 32), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(z), static_cast<int>(rows), static_cast<int>(d),
      static_cast<int>(m), wide_vec<T>(x, w, d, m));
  return static_cast<int>(cudaGetLastError());
}

long long bwd_chunks(long long rows) {
  return (rows + kChunkRows - 1) / kChunkRows;
}

// Theta columns a backward block covers (its template KC): M itself for
// the linear path's M of 1 and 2, else groups of kBwdCols.  The summation
// order of an output does not depend on it.
int bwd_cols(long long m) { return m <= 2 ? static_cast<int>(m) : kBwdCols; }

// Blocks of bwd_block's grid over nb rows (m >= 1).
long long bwd_blocks(long long parties, long long nb, long long d,
                     long long m) {
  const long long kc = bwd_cols(m);
  return bwd_chunks(nb) * parties * ((d + kBwdTile - 1) / kBwdTile) *
         ((m + kc - 1) / kc);
}

// g (or, for more than one chunk, the workspace) from x and theta; the
// wrapper sizes `out` from the same chunk count (BWD_CHUNK_ROWS).
template <typename T>
int launch_rows(const void* x, const void* th, const void* w, void* out,
                long long parties, long long rows, long long d, long long m,
                long long th_pstride, float denom, float lam, void* stream) {
  if (bad_sizes(parties, rows, d, m) || d < 1 || th_pstride < 0 ||
      bwd_blocks(parties, rows, d, m) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = &vfl_backward_rows<kBwdCols, T>;
  if (bwd_cols(m) == 1) kernel = &vfl_backward_rows<1, T>;
  if (bwd_cols(m) == 2) kernel = &vfl_backward_rows<2, T>;
  kernel<<<dim3(static_cast<unsigned>(bwd_blocks(parties, rows, d, m))),
           dim3(kBwdThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(th),
      static_cast<const T*>(w), static_cast<float*>(out), parties, rows,
      static_cast<int>(d), static_cast<int>(m), th_pstride, denom, lam);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const void* ws, const void* w, void* g, long long parties,
                  long long d, long long m, long long chunks, float denom,
                  float lam, void* stream) {
  const long long outs = parties * d * m;
  const long long blocks = (outs + 31) / 32;
  if (parties < 1 || d < 1 || m < 1 || chunks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vfl_backward_reduce<T><<<dim3(static_cast<unsigned>(blocks)),
                           dim3(kBwdThreads), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const T*>(w),
      static_cast<float*>(g), chunks, outs, denom, lam);
  return static_cast<int>(cudaGetLastError());
}

// The fused program: z for the forward rows and g (or, for nb > kChunkRows,
// the workspace the wrapper sizes from the same chunk count) for the
// backward rows, in one launch.  Non-split fused mode: f0 = 0, nf = nb =
// rows.  Split form: f0 = nb = split, nf = rows - split.
template <typename T>
int launch_fused(const void* x, const void* w, const void* th, void* z,
                 void* out, long long parties, long long rows, long long f0,
                 long long nf, long long nb, long long d, long long mw,
                 long long mth, long long th_pstride, float denom, float lam,
                 int lamw, void* stream) {
  if (bad_sizes(parties, rows, d, mw) || bad_sizes(parties, rows, d, mth) ||
      d < 1 || nf < 1 || nb < 1 || f0 < 0 || f0 + nf > rows || nb > rows ||
      nf >= (1LL << 30) || th_pstride < 0 || (lamw && mw != mth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = fused_kernel<kBwdCols, T>(mw);
  if (bwd_cols(mth) == 1) kernel = fused_kernel<1, T>(mw);
  if (bwd_cols(mth) == 2) kernel = fused_kernel<2, T>(mw);
  const int frpw = narrow_rpw(parties, nf);
  const long long fbpp = (nf + kWarpsPerBlock * frpw - 1) /
                         (kWarpsPerBlock * frpw);
  const long long fblocks =
      mw <= kNarrow ? parties * fbpp
                    : (nf + wide_rows(d) - 1) / wide_rows(d) * parties *
                          wide_ctiles(mw);
  const long long blocks = fblocks + bwd_blocks(parties, nb, d, mth);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kWarpsPerBlock * 32), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(th), static_cast<float*>(z),
      static_cast<float*>(out), parties, rows, f0, nf, nb,
      static_cast<int>(d), static_cast<int>(mw), static_cast<int>(mth),
      th_pstride, denom, lam, lamw, fblocks, static_cast<int>(fbpp), frpw,
      mw <= kNarrow
          ? narrow_vec<T>(static_cast<const T*>(x) + f0 * d, w, d, frpw)
          : wide_vec<T>(static_cast<const T*>(x) + f0 * d, w, d, mw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VFL_ENTRY(name, impl, T)                                            \
  extern "C" int name(const void* x, const void* w, void* z,                \
                      long long parties, long long rows, long long d,       \
                      long long m, void* stream) {                          \
    return impl<T>(x, w, z, parties, rows, d, m, stream);                   \
  }

VFL_ENTRY(vfl_forward_narrow_f32, launch_narrow, float)
VFL_ENTRY(vfl_forward_narrow_bf16, launch_narrow, __nv_bfloat16)
VFL_ENTRY(vfl_forward_wide_f32, launch_wide, float)
VFL_ENTRY(vfl_forward_wide_bf16, launch_wide, __nv_bfloat16)

#define VFL_ROWS_ENTRY(name, T)                                             \
  extern "C" int name(const void* x, const void* th, const void* w,        \
                      void* out, long long parties, long long rows,         \
                      long long d, long long m, long long th_pstride,       \
                      float denom, float lam, void* stream) {               \
    return launch_rows<T>(x, th, w, out, parties, rows, d, m, th_pstride,   \
                          denom, lam, stream);                              \
  }

VFL_ROWS_ENTRY(vfl_backward_rows_f32, float)
VFL_ROWS_ENTRY(vfl_backward_rows_bf16, __nv_bfloat16)

#define VFL_REDUCE_ENTRY(name, T)                                           \
  extern "C" int name(const void* ws, const void* w, void* g,              \
                      long long parties, long long d, long long m,          \
                      long long chunks, float denom, float lam,             \
                      void* stream) {                                       \
    return launch_reduce<T>(ws, w, g, parties, d, m, chunks, denom, lam,    \
                            stream);                                        \
  }

VFL_REDUCE_ENTRY(vfl_backward_reduce_f32, float)
VFL_REDUCE_ENTRY(vfl_backward_reduce_bf16, __nv_bfloat16)

#define VFL_FUSED_ENTRY(name, T)                                            \
  extern "C" int name(const void* x, const void* w, const void* th,        \
                      void* z, void* out, long long parties,                \
                      long long rows, long long f0, long long nf,           \
                      long long nb, long long d, long long mw,              \
                      long long mth, long long th_pstride, float denom,     \
                      float lam, int lamw, void* stream) {                  \
    return launch_fused<T>(x, w, th, z, out, parties, rows, f0, nf, nb, d,  \
                           mw, mth, th_pstride, denom, lam, lamw, stream);  \
  }

VFL_FUSED_ENTRY(vfl_fused_split_f32, float)
VFL_FUSED_ENTRY(vfl_fused_split_bf16, __nv_bfloat16)
