// vfl_grad, forward mode, for Hopper (sm_90a): z[p] = X[p] @ W[p].
//
// Replaces the forward side of the Pallas TPU kernel
// src/repro/kernels/vfl_grad.py :: vfl_grad / _vfl_kernel (the
// pl.pallas_call at vfl_grad.py:343), which the JAX engine maps over the
// party axis with vmap.  Here the party axis is a leading dimension of the
// operands, so one launch covers all q parties:
//
//   x (P, B, D), w (P, D, M), z (P, B, M);  f32 or bf16 in, f32 out,
//   every product accumulated with f32 FMA (no TF32, no tensor cores).
//
// What bounds it on this card.  At the serving shapes the contraction is
// thin: the linear path is (P=8, B=64, D=512) against one weight column
// (M=1), the deep encoder (B=64, D=512) against M=32 and (B=64, D=32)
// against M=16.  That is at most 2·M FLOP per 4-byte element of X, below
// the ~20 FLOP/byte where f32 FMA (67 TFLOP/s) overtakes HBM (3.35 TB/s),
// so the bound is the bytes: read X once, read W once, write z once.  At
// (8, 64, 512, 1) that is ~1.07 MB, about 0.32 us at 3.35 TB/s; a launch
// costs more than that, so one launch for all parties matters more than
// the inner loop.
//
// Design: the TPU kernel's sequential feature-tile grid axis becomes a
// loop over D inside a block, and its (B, M) VMEM accumulator becomes
// registers, so nothing is carried between blocks and no second pass or
// atomic is needed.  The work is too small to fill 132 SMs, so the design
// is about latency: enough independent loads in flight per SM.  Two
// programs, each with its own entry points, chosen by the caller by M alone:
//   * narrow M (M <= kNarrow, the linear path): one warp per row of X (one
//     request of one party); the 32 lanes stride over D with coalesced
//     loads of the row and of W, keep one accumulator per column, and a
//     butterfly of warp shuffles completes each column;
//   * wide M (the deep encoder layers): a block covers kWideRows rows x 32
//     columns of one party, lane j owning column j; each of the 8 warps
//     walks a fixed eighth of D, so every W load (coalesced across lanes)
//     serves kWideRows rows and 8 independent chains run per block; the
//     eight partial sums are added in warp order through shared memory.
// The ragged edges (rows past P*B, columns past M, the tail of D) are
// masked inside the kernel; the wrapper pads nothing.  The summation order
// of an output element depends only on D, M and its column, never on B or
// on the row's place in the batch, so a request gives bit-identical
// partials in any batch — the serving cache relies on that (a hit replays
// the cold dispatch exactly).
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
