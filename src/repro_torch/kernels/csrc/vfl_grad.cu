// vfl_grad for Hopper (sm_90a): the forward mode z[p] = X[p] @ W[p] and the
// backward mode g[p] = X[p]^T Theta[p] / denom (+ lam * W[p]).
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
constexpr int kWideRows = 4;  // rows per block of the lanes-over-M program
static_assert(kWideRows <= kWarpsPerBlock, "one finishing warp per row");
constexpr int kBwdThreads = 128;   // columns d per backward block
constexpr int kBwdCols = 4;        // theta columns per thread (grid.z: more)
constexpr int kChunkRows = 1024;   // rows per backward block (one partial)
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Lanes over D, one accumulator per column (m <= kNarrow).
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_forward_narrow(const T* __restrict__ x, const T* __restrict__ w,
                   float* __restrict__ z, long long total, long long rows,
                   int d, int m) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= total) return;  // whole warp: row is warp-uniform
  const T* xr = x + row * d;
  const T* wp = w + (row / rows) * static_cast<long long>(d) * m;
  float acc[kNarrow];
#pragma unroll
  for (int j = 0; j < kNarrow; ++j) acc[j] = 0.0f;
  for (int k = lane; k < d; k += 32) {
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
      if (lane == 0) z[row * m + j] = v;
    }
  }
}

// Lanes over columns (m > kNarrow).  Block (row tile, party, column tile)
// covers kWideRows rows x 32 columns of one party; warp v walks its fixed
// slice of D in order, each W load serving all kWideRows rows, and the
// slices' partial sums are added in warp order through shared memory.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vfl_forward_wide(const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ z, long long rows, int d, int m) {
  __shared__ float part[kWarpsPerBlock][kWideRows][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long party = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * kWideRows;
  const long long left = rows - r0;
  const int nrow = left < kWideRows ? static_cast<int>(left) : kWideRows;
  const int c = blockIdx.z * 32 + lane;
  const T* xp = x + (party * rows + r0) * d;
  const T* wp = w + party * static_cast<long long>(d) * m;
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
    z[(party * rows + r0 + warp) * m + c] = s;
  }
}

// Backward, rows: block (chunk, party, column tile x theta-column group).
// Thread `col` sums x[p, r, col] * theta[p, r, m0 + j] over the chunk's rows
// r in order.  direct != 0 (B fits one chunk): out is g (P, D, M) and the
// epilogue is applied here; else out is the workspace (chunks, P, D, M).
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
  const int mc = min(kBwdCols, m - m0);
  const long long r0 = chunk * kChunkRows;
  const long long r1 = min(rows, r0 + kChunkRows);
  const T* xc = x + party * rows * d + col;
  const float* tp = th + party * th_pstride + m0;
  float acc[kBwdCols];
#pragma unroll
  for (int j = 0; j < kBwdCols; ++j) acc[j] = 0.0f;
#pragma unroll 8
  for (long long r = r0; r < r1; ++r) {
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
    float* ws = out + chunk * static_cast<long long>(gridDim.y) * d * m + o;
#pragma unroll
    for (int j = 0; j < kBwdCols; ++j) {
      if (j < mc) ws[j] = acc[j];
    }
  }
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
