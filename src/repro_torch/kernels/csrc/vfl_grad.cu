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
//     - narrow M (M <= kNarrow, the linear path): one warp per row of X (one
//       sample of one party); the 32 lanes stride over D with coalesced
//       loads of the row and of W, keep one accumulator per column, and a
//       butterfly of warp shuffles completes each column;
//     - wide M (the deep encoder layers): a block covers kWideRows rows x
//       32 columns of one party, lane j owning column j; each of the 8
//       warps walks a fixed eighth of D, so every W load (coalesced across
//       lanes) serves kWideRows rows and 8 independent chains run per
//       block; the eight partial sums are added in warp order through
//       shared memory.
//   * backward (two programs): every output g[p, d, m] is a sum over the B
//     rows, and on Hopper blocks run in no order, so nothing can carry a
//     sum across blocks the way the TPU kernel carries g_acc across its
//     sequential row grid (vfl_grad.py:165-196).
//     - vfl_backward_rows: a block owns kBwdThreads consecutive columns d
//       of one party and one chunk of kChunkRows rows; thread d walks the
//       chunk's rows in order, its X loads coalesced across d and its
//       theta loads one broadcast per warp, keeping kBwdCols accumulators
//       (grid.z covers wider M).  When B fits one chunk (every minibatch
//       step) it applies the epilogue (/denom, + lam*W) and writes g
//       directly: one launch per step.  Otherwise it writes its chunk's
//       partial sums to a workspace the wrapper allocates, and
//     - vfl_backward_reduce adds the chunks' partials in chunk order, one
//       thread per output, and applies the epilogue.
//     Full-dataset passes: 342 chunks x 8 parties x 4 column tiles =
//     10,944 blocks of 128 threads, each thread with 1024 independent row
//     loads, so the card has many loads in flight.  No float atomics: the
//     summation order of every output depends only on B (the chunking),
//     never on scheduling, so an epoch replays bit for bit.
//   * fused (one program, vfl_fused_split): a Hopper block cannot wait for
//     another, so the program's grid is the union of the two sides' grids:
//     its first blocks run the narrow (Mw <= kNarrow) or wide forward body
//     over the forward rows, the rest the rows program's body over the
//     backward rows (two backward halves of kBwdThreads threads per
//     block).  The bodies are the __device__ functions the single-mode
//     programs call, so each output sums in the same order as there; the
//     split form needs no padding copy (each side masks its own edges),
//     and a backward side over more than one chunk writes the workspace
//     that vfl_backward_reduce adds.  One launch per pipelined step; the
//     backward body batches its row loads here (see bwd_chunk).
// The ragged edges (rows past B, columns past D or M, the tail of D) are
// masked inside the kernels; the wrapper pads nothing.  In the forward
// programs an output's summation order depends only on D, M and its column,
// never on B or on the row's place in the batch, so a request gives
// bit-identical partials in any batch -- the serving cache relies on that.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kNarrow = 4;  // widest M taken by the lanes-over-D program
constexpr int kNarrowBatch = 4;  // row strides whose loads a lane batches
constexpr int kWideRows = 4;  // rows per block of the lanes-over-M program
static_assert(kWideRows <= kWarpsPerBlock, "one finishing warp per row");
constexpr int kBwdThreads = 128;   // columns d per backward block
constexpr int kBwdCols = 4;        // theta columns per thread (grid.z: more)
constexpr int kChunkRows = 1024;   // rows per backward block (one partial)
constexpr int kBwdBatch = 8;       // rows whose loads a backward thread batches
constexpr int kReduceThreads = 256;
static_assert(2 * kBwdThreads == kWarpsPerBlock * 32,
              "a fused backward block holds two backward halves");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bodies below are __device__ functions that the per-mode programs and
// vfl_fused_split call alike, so a row or a column sums in the same order
// in every program that computes it.

// Lanes over D, one accumulator per column (m <= kNarrow): warp `lane`'s
// row xr against the party's w, written to zr (m values).  The loads of
// kNarrowBatch strides of the row are all loaded before their FMAs, so
// many are in flight whichever program inlines this body: left to itself
// nvcc scheduled this loop with one row load in flight once it became a
// shared function, 18% slower over the full dataset on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py).  The FMAs still run stride by
// stride, so every column sums in the same order.
template <typename T>
__device__ __forceinline__ void narrow_row(const T* __restrict__ xr,
                                           const T* __restrict__ wp,
                                           float* __restrict__ zr, int d,
                                           int m, int lane) {
  float acc[kNarrow];
#pragma unroll
  for (int j = 0; j < kNarrow; ++j) acc[j] = 0.0f;
  int k = lane;
  for (; k + 32 * (kNarrowBatch - 1) < d; k += 32 * kNarrowBatch) {
    float xv[kNarrowBatch], wv[kNarrowBatch][kNarrow];
#pragma unroll
    for (int u = 0; u < kNarrowBatch; ++u) {
      xv[u] = to_f32(xr[k + 32 * u]);
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) {
        wv[u][j] = j < m ? to_f32(wp[(k + 32 * u) * m + j]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kNarrowBatch; ++u) {
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) {
        if (j < m) acc[j] = fmaf(xv[u], wv[u][j], acc[j]);
      }
    }
  }
  for (; k < d; k += 32) {
    const float xv = to_f32(xr[k]);
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      if (j < m) acc[j] = fmaf(xv, to_f32(wp[k * m + j]), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kNarrow; ++j) {
    if (j < m) {  // warp-uniform: every lane takes the same branch
      float v = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) zr[j] = v;
    }
  }
}

// Lanes over columns (m > kNarrow): the block's nrow (<= kWideRows)
// consecutive rows from xp against column c = ctile * 32 + lane of the
// party's w, written to zp (row stride m).  Warp v walks its fixed slice
// of D in order, each W load serving all the rows, and the slices' partial
// sums are added in warp order through shared memory.  Every thread of the
// block calls it (it holds a barrier).
template <typename T>
__device__ __forceinline__ void wide_tile(const T* __restrict__ xp,
                                          const T* __restrict__ wp,
                                          float* __restrict__ zp, int nrow,
                                          int d, int m, int ctile) {
  __shared__ float part[kWarpsPerBlock][kWideRows][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = ctile * 32 + lane;
  const int per = (d + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int k0 = warp * per;
  const int k1 = min(d, k0 + per);
  float acc[kWideRows];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) acc[r] = 0.0f;
  if (c < m) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float wv = to_f32(wp[k * m + c]);
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        if (r < nrow) acc[r] = fmaf(to_f32(xp[r * d + k]), wv, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  if (warp < nrow && c < m) {  // warp r finishes row r
    float s = part[0][warp][lane];
#pragma unroll
    for (int v = 1; v < kWarpsPerBlock; ++v) s += part[v][warp][lane];
    zp[static_cast<long long>(warp) * m + c] = s;
  }
}

// Backward over one chunk: thread `col` sums x[p, r, col] * th[p, r, m0+j]
// over the chunk's rows r in [r0, r1) in order.  xc points at column col
// of the party's row 0, tp at column m0 of the party's theta (row stride
// m).  direct != 0 (the rows fit one chunk): out is g (P, D, M) and the
// epilogue (/denom, + lam * w when w is given) is applied here; else out
// is the workspace (chunks, P, D, M).  The caller has checked col < d.
// kBatch loads kBwdBatch rows before their FMAs.  The compiler
// keeps many loads in flight in vfl_backward_rows by itself, but not in
// vfl_fused_split, whose loop it left at one row's loads per round trip:
// about 166 ns a row there against 46 ns in vfl_backward_rows, over 1024
// rows on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py).  Batched,
// vfl_backward_rows ran slower, so only vfl_fused_split batches.  The
// FMAs run row by row either way, so both forms give the same numbers.
template <bool kBatch, typename T>
__device__ __forceinline__ void bwd_chunk(const T* __restrict__ xc,
                                          const float* __restrict__ tp,
                                          const T* __restrict__ w,
                                          float* __restrict__ out,
                                          long long r0, long long r1,
                                          long long party, long long parties,
                                          long long chunk, int col, int d,
                                          int m, int m0, float denom,
                                          float lam, int direct) {
  const int mc = min(kBwdCols, m - m0);
  float acc[kBwdCols];
#pragma unroll
  for (int j = 0; j < kBwdCols; ++j) acc[j] = 0.0f;
  long long r = r0;
  if constexpr (kBatch) {
    for (; r + kBwdBatch <= r1; r += kBwdBatch) {
      float xv[kBwdBatch], tv[kBwdBatch][kBwdCols];
#pragma unroll
      for (int u = 0; u < kBwdBatch; ++u) {
        xv[u] = to_f32(xc[(r + u) * d]);
#pragma unroll
        for (int j = 0; j < kBwdCols; ++j) {
          tv[u][j] = j < mc ? tp[(r + u) * m + j] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdBatch; ++u) {
#pragma unroll
        for (int j = 0; j < kBwdCols; ++j) {
          if (j < mc) acc[j] = fmaf(xv[u], tv[u][j], acc[j]);
        }
      }
    }
  }
#pragma unroll 8
  for (; r < r1; ++r) {
    const float xv = to_f32(xc[r * d]);
    const float* tr = tp + r * m;
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      if (j < mc) acc[j] = fmaf(xv, tr[j], acc[j]);
    }
  }
  const long long o = (party * d + col) * m + m0;
  if (direct) {
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      if (j < mc) {
        float v = acc[j] / denom;
        if (w != nullptr) v = v + lam * to_f32(w[o + j]);
        out[o + j] = v;
      }
    }
  } else {
    float* ws = out + chunk * parties * d * m + o;
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      if (j < mc) ws[j] = acc[j];
    }
  }
}

// Lanes over D, one warp per row of the flattened (P * rows) x.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_forward_narrow(const T* __restrict__ x, const T* __restrict__ w,
                   float* __restrict__ z, long long total, long long rows,
                   int d, int m) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= total) return;  // whole warp: row is warp-uniform
  narrow_row(x + row * d, w + (row / rows) * static_cast<long long>(d) * m,
             z + row * m, d, m, threadIdx.x & 31);
}

// Lanes over columns: block (row tile, party, column tile) covers
// kWideRows rows x 32 columns of one party.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_forward_wide(const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ z, long long rows, int d, int m) {
  const long long party = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * kWideRows;
  const long long left = rows - r0;
  wide_tile(x + (party * rows + r0) * d,
            w + party * static_cast<long long>(d) * m,
            z + (party * rows + r0) * m,
            left < kWideRows ? static_cast<int>(left) : kWideRows, d, m,
            static_cast<int>(blockIdx.z));
}

// Backward, rows: block (chunk, party, column tile x theta-column group).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
vfl_backward_rows(const T* __restrict__ x, const float* __restrict__ th,
                  const T* __restrict__ w, float* __restrict__ out,
                  long long rows, int d, int m, long long th_pstride,
                  float denom, float lam, int direct) {
  const long long chunk = blockIdx.x;
  const long long party = blockIdx.y;
  const int ntiles = (d + kBwdThreads - 1) / kBwdThreads;
  const int tile = static_cast<int>(blockIdx.z) % ntiles;
  const int m0 = (static_cast<int>(blockIdx.z) / ntiles) * kBwdCols;
  const int col = tile * kBwdThreads + static_cast<int>(threadIdx.x);
  if (col >= d) return;  // no barrier in this kernel
  const long long r0 = chunk * kChunkRows;
  bwd_chunk<false>(x + party * rows * d + col, th + party * th_pstride + m0,
                   w, out, r0, min(rows, r0 + kChunkRows), party,
                   static_cast<long long>(gridDim.y), chunk, col, d, m, m0,
                   denom, lam, direct);
}

// Backward, reduce: one thread per output i of the (P, D, M) g; adds the
// chunks' partials in chunk order, then the epilogue.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
vfl_backward_reduce(const float* __restrict__ ws, const T* __restrict__ w,
                    float* __restrict__ g, long long chunks, long long outs,
                    float denom, float lam) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= outs) return;
  float s = 0.0f;
#pragma unroll 8
  for (long long c = 0; c < chunks; ++c) s += ws[c * outs + i];
  float v = s / denom;
  if (w != nullptr) v = v + lam * to_f32(w[i]);
  g[i] = v;
}

// The fused mode and its split-batch form, one launch for every party.
// Each party's block of x holds `rows` rows; the forward side is rows
// [f0, f0 + nf) against w (P, D, mw) into z (P, nf, mw), the backward side
// rows [0, nb) against theta (P, nb, mth) (party stride th_pstride) into g
// (P, D, mth) or, for nb > kChunkRows, the per-chunk workspace.  The grid
// is the union of both programs' grids in one dimension: the first fblocks
// blocks are forward blocks (narrow: kWarpsPerBlock rows each; wide: a
// (row tile, party, column tile) each), the rest backward blocks, each
// holding two kBwdThreads-thread halves that run vfl_backward_rows' body
// for (chunk, party, column tile x theta-column group) in that order.
// No block waits for another: the two sides share no output.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_fused_split(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ th, float* __restrict__ z,
                float* __restrict__ out, long long parties, long long rows,
                long long f0, long long nf, long long nb, int d, int mw,
                int mth, long long th_pstride, float denom, float lam,
                int lamw, long long fblocks) {
  const long long blk = blockIdx.x;
  if (blk < fblocks) {  // forward: block-uniform branch
    if (mw <= kNarrow) {
      const long long row = blk * kWarpsPerBlock + (threadIdx.x >> 5);
      if (row >= parties * nf) return;  // whole warp; no barrier here
      const long long party = row / nf;
      narrow_row(x + (party * rows + f0 + row % nf) * d,
                 w + party * static_cast<long long>(d) * mw, z + row * mw,
                 d, mw, threadIdx.x & 31);
    } else {
      const long long rtiles = (nf + kWideRows - 1) / kWideRows;
      const long long rtile = blk % rtiles;
      const long long party = (blk / rtiles) % parties;
      const int ctile = static_cast<int>(blk / (rtiles * parties));
      const long long r0 = rtile * kWideRows;
      const long long left = nf - r0;
      wide_tile(x + (party * rows + f0 + r0) * d,
                w + party * static_cast<long long>(d) * mw,
                z + (party * nf + r0) * mw,
                left < kWideRows ? static_cast<int>(left) : kWideRows, d, mw,
                ctile);
    }
    return;
  }
  const long long chunks = (nb + kChunkRows - 1) / kChunkRows;
  const int ntiles = (d + kBwdThreads - 1) / kBwdThreads;
  const long long sub = (blk - fblocks) * 2 + (threadIdx.x >= kBwdThreads);
  const long long chunk = sub % chunks;
  const long long party = (sub / chunks) % parties;
  const long long tg = sub / (chunks * parties);
  const int groups = (mth + kBwdCols - 1) / kBwdCols;
  if (tg >= static_cast<long long>(ntiles) * groups) return;  // odd half
  const int tile = static_cast<int>(tg % ntiles);
  const int m0 = static_cast<int>(tg / ntiles) * kBwdCols;
  const int col = tile * kBwdThreads + (threadIdx.x & (kBwdThreads - 1));
  if (col >= d) return;
  const long long r0 = chunk * kChunkRows;
  bwd_chunk<true>(x + party * rows * d + col, th + party * th_pstride + m0,
                  lamw ? w : static_cast<const T*>(nullptr), out, r0,
                  min(nb, r0 + kChunkRows), party, parties, chunk, col, d,
                  mth, m0, denom, lam, chunks == 1 ? 1 : 0);
}

// Each program has its own entry point, so the caller knows which kernel a
// call launches: narrow takes 1 <= m <= kNarrow, wide takes m > kNarrow, and
// either refuses the other's m with cudaErrorInvalidValue.
bool bad_sizes(long long parties, long long rows, long long d, long long m) {
  return parties < 1 || rows < 1 || d < 0 || m < 1 || d > 0x7fffffffLL ||
         d * m > 0x7fffffffLL || parties > 65535;  // int W offsets, grid.y
}

template <typename T>
int launch_narrow(const void* x, const void* w, void* z, long long parties,
                  long long rows, long long d, long long m, void* stream) {
  const long long blocks =
      (parties * rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (bad_sizes(parties, rows, d, m) || m > kNarrow || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vfl_forward_narrow<T>
      <<<dim3(static_cast<unsigned>(blocks)), dim3(kWarpsPerBlock * 32), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<float*>(z), parties * rows, rows, static_cast<int>(d),
          static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wide(const void* x, const void* w, void* z, long long parties,
                long long rows, long long d, long long m, void* stream) {
  if (bad_sizes(parties, rows, d, m) || m <= kNarrow || (m + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((rows + kWideRows - 1) / kWideRows),
                  static_cast<unsigned>(parties),
                  static_cast<unsigned>((m + 31) / 32));
  vfl_forward_wide<T><<<grid, dim3(kWarpsPerBlock * 32), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(z), rows, static_cast<int>(d), static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

long long bwd_chunks(long long rows) {
  return (rows + kChunkRows - 1) / kChunkRows;
}

// g (or, for more than one chunk, the workspace) from x and theta; the
// wrapper sizes `out` from the same chunk count (BWD_CHUNK_ROWS).
template <typename T>
int launch_rows(const void* x, const void* th, const void* w, void* out,
                long long parties, long long rows, long long d, long long m,
                long long th_pstride, float denom, float lam, void* stream) {
  const long long chunks = rows < 1 ? 0 : bwd_chunks(rows);
  const long long ntiles = (d + kBwdThreads - 1) / kBwdThreads;
  const long long groups = (m + kBwdCols - 1) / kBwdCols;
  if (bad_sizes(parties, rows, d, m) || d < 1 || th_pstride < 0 ||
      chunks > 0x7fffffffLL || ntiles * groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(chunks),
                  static_cast<unsigned>(parties),
                  static_cast<unsigned>(ntiles * groups));
  vfl_backward_rows<T><<<grid, dim3(kBwdThreads), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(th),
      static_cast<const T*>(w), static_cast<float*>(out), rows,
      static_cast<int>(d), static_cast<int>(m), th_pstride, denom, lam,
      chunks == 1 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const void* ws, const void* w, void* g, long long parties,
                  long long d, long long m, long long chunks, float denom,
                  float lam, void* stream) {
  const long long outs = parties * d * m;
  const long long blocks = (outs + kReduceThreads - 1) / kReduceThreads;
  if (parties < 1 || d < 1 || m < 1 || chunks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vfl_backward_reduce<T><<<dim3(static_cast<unsigned>(blocks)),
                           dim3(kReduceThreads), 0,
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
      th_pstride < 0 || (lamw && mw != mth) || (mw + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long fblocks =
      mw <= kNarrow
          ? (parties * nf + kWarpsPerBlock - 1) / kWarpsPerBlock
          : (nf + kWideRows - 1) / kWideRows * parties * ((mw + 31) / 32);
  const long long subs = bwd_chunks(nb) * parties *
                         ((d + kBwdThreads - 1) / kBwdThreads) *
                         ((mth + kBwdCols - 1) / kBwdCols);
  const long long blocks = fblocks + (subs + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  vfl_fused_split<T><<<dim3(static_cast<unsigned>(blocks)),
                       dim3(kWarpsPerBlock * 32), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(th), static_cast<float*>(z),
      static_cast<float*>(out), parties, rows, f0, nf, nb,
      static_cast<int>(d), static_cast<int>(mw), static_cast<int>(mth),
      th_pstride, denom, lam, lamw, fblocks);
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
