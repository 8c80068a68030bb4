// selective_scan for Hopper (sm_90a): the mamba-1 recurrence
//
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t,   h_0 = 0
//   y_t = h_t . C_t + D (.) x_t,                          A = -exp(a_log)
//
// over xa (B, S, C) f32 or bf16, dt (B, S, C) f32, B_ssm and C_ssm
// (B, S, N) f32, a_log (C, N) f32 and d_skip (C) f32, giving y (B, S, C) in
// xa's dtype.  The state h is (B, C, N) f32 and never leaves the chip.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py ::
// selective_scan / _scan_kernel (the pl.pallas_call at selective_scan.py:62),
// which the model reaches from src/repro/models/ssm.py:113 once per layer
// of every prefill.  On the TPU the grid is (B, C blocks, S chunks) with the
// S axis sequential, carrying h in VMEM scratch from one chunk to the next.
// Hopper runs blocks in no order, so nothing can carry h between blocks:
// here the loop over S runs inside the block and h lives in registers.
//
// What bounds it on this card.  Per (b, t, c) it reads 2 + 4 bytes (bf16
// xa, f32 dt) and writes 2; B_t and C_t are shared by every channel.  At
// the falcon-mamba-7b prefill shape (4, 2048, 8192), N = 16, that is about
// 0.54 GB, 0.16 ms at 3.35 TB/s.  It also takes B*S*C*N = 1.07e9
// exponentials, one per state element per step, and the special-function
// units give 16 a clock per SM: about 0.26 ms on 132 SMs at 1.98 GHz.  So
// the exponentials set the bound; the FMAs around them (about 4 per
// exponential) need a quarter of that on the f32 pipes.
//
// Design.
//   * One thread per (b, c): a block covers kThreads consecutive channels
//     of one batch row, so loads of xa and dt and stores of y are coalesced
//     along C.  Thread c holds h[N] and A[N] * log2(e) in registers, so
//     exp(dt * A) is one multiply and one ex2.approx on the special-
//     function unit.
//   * B_t and C_t are the same for every channel of a batch row: the block
//     stages them in shared memory kChunk steps at a time, double-buffered
//     (the next chunk's loads are issued before the current chunk runs and
//     stored after it), one __syncthreads per chunk.
//   * Each thread loads xa and dt kAhead steps ahead of the step it
//     computes, so a group of loads is in flight while the last group's
//     exponentials run.
//   * The N products h[n] * C[n] are summed in n order with f32 FMA; y is
//     rounded once, to nearest even, into xa's dtype.
//   * N is a template parameter (4, 8 or 16: the test sweep and the
//     reduced and full configurations); any other N is refused.  Any S and
//     C are taken: threads past C compute nothing but join every barrier,
//     and steps past S are masked.  No Pallas divisibility limit applies.
//   * At the prefill shape only 32,768 threads run (256 blocks of 128 on
//     132 SMs), so latency may hold it above its bound; splitting N across
//     threads, or asynchronous copies of xa and dt, are later work.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 64;     // steps of B_t, C_t a block stages at once
constexpr int kAhead = 8;      // steps of xa, dt a thread loads ahead
static_assert(kChunk % kAhead == 0, "a load group never spans two chunks");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copies of the (S, N) rows of B_ssm and C_ssm for steps [t0, t0 + kChunk)
// into registers (zeros past S): each thread takes kStage of the chunk's
// kChunk * N values, coalesced.
template <int N>
struct Stage {
  static constexpr int kStage = kChunk * N / kThreads;
  static_assert(kChunk * N % kThreads == 0, "the chunk splits evenly");
  float b[kStage], c[kStage];

  __device__ __forceinline__ void load(const float* __restrict__ br,
                                       const float* __restrict__ cr,
                                       long long t0, long long s) {
    const long long base = t0 * N, end = s * N;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const long long k = base + threadIdx.x + i * kThreads;
      b[i] = k < end ? br[k] : 0.0f;
      c[i] = k < end ? cr[k] : 0.0f;
    }
  }

  __device__ __forceinline__ void put(float* sb, float* sc) const {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      sb[threadIdx.x + i * kThreads] = b[i];
      sc[threadIdx.x + i * kThreads] = c[i];
    }
  }
};

template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ xr,
                                           const float* __restrict__ dr,
                                           long long t, long long s,
                                           long long c, bool live,
                                           float (&xv)[kAhead],
                                           float (&dv)[kAhead]) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const bool in = live && t + u < s;
    xv[u] = in ? to_f32(xr[(t + u) * c]) : 0.0f;
    dv[u] = in ? dr[(t + u) * c] : 0.0f;
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const T* __restrict__ xa, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    T* __restrict__ y, long long s, long long c) {
  static_assert(N % 4 == 0, "B_t and C_t are read as float4");
  __shared__ __align__(16) float sb[2][kChunk * N];
  __shared__ __align__(16) float sc[2][kChunk * N];

  const long long row = blockIdx.y;
  const long long ch = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  const bool live = ch < c;
  const long long off = row * s * c + (live ? ch : 0);
  const T* xr = xa + off;
  const float* dr = dt + off;
  T* yr = y + off;
  const float* br = bm + row * s * N;
  const float* cr = cm + row * s * N;

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? -expf(a_log[ch * N + n]) * kLog2e : 0.0f;
    h[n] = 0.0f;
  }
  const float dsk = live ? d_skip[ch] : 0.0f;

  Stage<N> stage;
  stage.load(br, cr, 0, s);
  stage.put(sb[0], sc[0]);
  float xv[kAhead], dv[kAhead];
  load_group(xr, dr, 0, s, c, live, xv, dv);
  __syncthreads();

  for (long long t0 = 0; t0 < s; t0 += kChunk) {
    const int buf = static_cast<int>((t0 / kChunk) & 1);
    const bool more = t0 + kChunk < s;
    if (more) stage.load(br, cr, t0 + kChunk, s);
    for (int g = 0; g < kChunk && t0 + g < s; g += kAhead) {
      const long long tg = t0 + g;
      float xn[kAhead], dn[kAhead];
      load_group(xr, dr, tg + kAhead, s, c, live, xn, dn);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (live && tg + u < s) {
          const float4* bq =
              reinterpret_cast<const float4*>(&sb[buf][(g + u) * N]);
          const float4* cq =
              reinterpret_cast<const float4*>(&sc[buf][(g + u) * N]);
          const float x = xv[u], d = dv[u], dx = d * x;
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < N / 4; ++q) {
            const float4 bv = bq[q], cv = cq[q];
            const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
            const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = 4 * q + j;
              h[n] = fmaf(exp2_approx(d * a2[n]), h[n], dx * bb[j]);
              acc = fmaf(h[n], cc[j], acc);
            }
          }
          store(yr + (tg + u) * c, fmaf(dsk, x, acc));
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        xv[u] = xn[u];
        dv[u] = dn[u];
      }
    }
    if (more) stage.put(sb[buf ^ 1], sc[buf ^ 1]);
    __syncthreads();
  }
}

template <int N, typename T>
int launch_n(const void* xa, const void* dt, const void* bm, const void* cm,
             const void* a_log, const void* d_skip, void* y, long long b,
             long long s, long long c, void* stream) {
  const dim3 grid(static_cast<unsigned>((c + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  selective_scan_kernel<N, T><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xa), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<T*>(y), s, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xa, const void* dt, const void* bm, const void* cm,
           const void* a_log, const void* d_skip, void* y, long long b,
           long long s, long long c, long long n, void* stream) {
  if (b < 1 || s < 1 || c < 1 || b > 65535 ||
      (c + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n) {
    case 4:
      return launch_n<4, T>(xa, dt, bm, cm, a_log, d_skip, y, b, s, c,
                            stream);
    case 8:
      return launch_n<8, T>(xa, dt, bm, cm, a_log, d_skip, y, b, s, c,
                            stream);
    case 16:
      return launch_n<16, T>(xa, dt, bm, cm, a_log, d_skip, y, b, s, c,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define SCAN_ENTRY(name, T)                                                 \
  extern "C" int name(const void* xa, const void* dt, const void* bm,       \
                      const void* cm, const void* a_log,                    \
                      const void* d_skip, void* y, long long b,             \
                      long long s, long long c, long long n,                \
                      void* stream) {                                       \
    return launch<T>(xa, dt, bm, cm, a_log, d_skip, y, b, s, c, n, stream); \
  }

SCAN_ENTRY(selective_scan_f32, float)
SCAN_ENTRY(selective_scan_bf16, __nv_bfloat16)
