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
// units give 16 a clock per SM: 0.257 ms on 132 SMs at 1.98 GHz (the card
// holds that clock under this kernel, at about 660 W of its 700).  So the
// exponentials set the bound.  The issue slots come close behind it:
// around each exponential a lane issues an FMUL for its argument, dx * B,
// the state's FMA and the output's FMA, and each step adds its loads, so a
// warp issues about 7 instructions per exponential where the unit takes 8
// cycles.  Without the exponentials (a timing probe) this kernel still
// took 333 us: issue and latency, not the special-function units, hold it
// above the bound.
//
// Design.
//   * kLanes = 2 adjacent lanes share a channel, each holding N / kLanes
//     of its states (and A * log2(e) for them) in registers, so exp(dt * A)
//     is one multiply and one ex2.approx.f32 on the special-function unit.
//     A block of 128 threads covers 64 channels of one batch row: the
//     prefill shape runs 512 blocks, 15.5 warps an SM, all resident in one
//     wave (kMinBlocks: at most 128 registers a thread).
//   * Each lane sums its states' h * C in n order, lane 0 of the two
//     starting from D * x; the partials of kLanes consecutive steps are
//     reduce-scattered by warp shuffles (xor kLanes / 2, ..., 1), so lane q
//     ends with step q's y, p0 + p1, and stores it.  The order depends on
//     nothing but kLanes: two calls give the same bits.
//   * A block stages kSteps steps of xa, dt, B_t and C_t in shared memory
//     at a time, kStages chunks in flight, with cp.async copies of 16 bytes
//     (no registers held for them) refilling the buffer the last chunk
//     read, one barrier a chunk; the step loop reads them with immediate
//     offsets.  Steps past S and channels past C are zero-filled (x = dt =
//     0 leaves h as it is), so the step loop has no branch; a store's
//     pointer steps by kLanes rows and its bound is a 32-bit count.
//   * Operands that are not 16-byte aligned or C not a multiple of 8 (no
//     model shape) are staged element by element into the same layout, so
//     the sums are the same.
//   * N is a template parameter (4, 8 or 16: the test sweep and the
//     reduced and full configurations); any other N is refused.  Any S and
//     C are taken.  No Pallas divisibility limit applies.
// Measured at the prefill shape, bf16, a_log drawn per (channel, state)
// (NVIDIA H100 80GB HBM3, 700 W, tools/scan_ab.py, each beside the first
// form in one call): the first form, one thread owning a channel's 16
// states in 256 blocks of 128 with a branch per step, 648-652 us; this
// form 367-371.  Forms that lost: 4 lanes a channel (31 warps an SM, but
// capped at 64 registers, which spills) 479-550; the staging loops rolled
// 459 (398 unrolled, 2 lanes); two buffers and two barriers a chunk 391
// (beside 387); 8- or 32-step chunks 422 and 421; 64-thread blocks 411;
// two channels a lane, sharing each B and C read, 405-412; a store's
// 64-bit address and bound recomputed per store (about 10 instructions a
// step) 387-399; a degree-6 polynomial on the FMA pipes for 1, 2 or 3 of a
// lane's 8 exponentials 415, 463 and 508 (beside 389): the issue slots,
// not the special-function units, are the scarcer; reading B and C on
// every other step only (a probe) 396 beside 390: shared memory is not it
// either.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;                 // threads per block
constexpr int kLanes = 2;                     // lanes sharing a channel
constexpr int kChannels = kThreads / kLanes;  // channels per block
constexpr int kSteps = 16;                    // steps a chunk holds
constexpr int kStages = 3;                    // chunks staged at once
// blocks an SM must hold for the falcon-mamba-7b prefill (4 x 8192
// channels) to run in one wave on 132 SMs
constexpr int kMinBlocks = (4 * 8192 / kChannels + 131) / 132;
constexpr int kMaxRows = 65535;               // batch rows: grid.y
static_assert(kSteps % kLanes == 0, "a chunk holds whole shuffle groups");
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

// A 16-byte copy into shared memory; src_bytes = 0 writes zeros (src must
// still be a valid address).
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One buffer of a block's chunk: kSteps steps of its kChannels channels of
// xa and dt, and the steps' N values of B and C.
template <int N, typename T>
struct __align__(16) Chunk {
  T x[kSteps * kChannels];
  float d[kSteps * kChannels];
  float b[kSteps * N];
  float c[kSteps * N];
};

// Calls f(i) for i = threadIdx.x, + kThreads, ... < Total: a loop of a
// compile-time count, unrolled.
template <int Total, typename F>
__device__ __forceinline__ void for_each(F f) {
#pragma unroll
  for (int it = 0; it < (Total + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (Total % kThreads == 0 || i < Total) f(i);
  }
}

// Fills `ch` with steps [t0, t0 + kSteps) of one batch row for channels
// [c0, c0 + kChannels): xr and dr point at the row's (step 0, channel c0)
// of xa and dt, br and cr at its step 0 of B and C; zeros past S and past
// C.  vec: 16-byte cp.async copies (every operand 16-byte aligned, C a
// multiple of 8, so no copy straddles C), else element by element.
template <int N, typename T>
__device__ __forceinline__ void stage(Chunk<N, T>& ch,
                                      const T* __restrict__ xr,
                                      const float* __restrict__ dr,
                                      const float* __restrict__ br,
                                      const float* __restrict__ cr,
                                      long long t0, long long s, int left,
                                      long long c, bool vec) {
  // left: channels of the block below C (at most kChannels)
  if (vec) {
    constexpr int kXv = 16 / static_cast<int>(sizeof(T));  // xa per copy
    constexpr int kXp = kChannels / kXv, kDp = kChannels / 4, kBp = N / 4;
    for_each<kSteps * kXp>([&](int i) {
      const int u = i / kXp, j = i % kXp * kXv;
      const bool in = t0 + u < s && j < left;
      copy16(&ch.x[u * kChannels + j], in ? xr + (t0 + u) * c + j : xr,
             in ? 16 : 0);
    });
    for_each<kSteps * kDp>([&](int i) {
      const int u = i / kDp, j = i % kDp * 4;
      const bool in = t0 + u < s && j < left;
      copy16(&ch.d[u * kChannels + j], in ? dr + (t0 + u) * c + j : dr,
             in ? 16 : 0);
    });
    for_each<kSteps * kBp>([&](int i) {
      const int u = i / kBp, j = i % kBp * 4;
      const bool in = t0 + u < s;
      const long long k = (t0 + u) * N + j;
      copy16(&ch.b[u * N + j], in ? br + k : br, in ? 16 : 0);
      copy16(&ch.c[u * N + j], in ? cr + k : cr, in ? 16 : 0);
    });
    copy_commit();
    return;
  }
  for_each<kSteps * kChannels>([&](int i) {
    const int u = i / kChannels, j = i % kChannels;
    const bool in = t0 + u < s && j < left;
    const long long k = (t0 + u) * c + j;
    store(&ch.x[i], in ? to_f32(xr[k]) : 0.0f);  // exact for bf16
    ch.d[i] = in ? dr[k] : 0.0f;
  });
  for_each<kSteps * N>([&](int i) {
    const bool in = t0 + i / N < s;
    ch.b[i] = in ? br[t0 * N + i] : 0.0f;
    ch.c[i] = in ? cr[t0 * N + i] : 0.0f;
  });
}

// v[j] is this lane's partial y of step j of a group of L; the L lanes of
// the channel (q = lane % L) reduce-scatter them, xor L/2 first: lane q
// returns step q's sum, the same tree for every step.
template <int L>
__device__ __forceinline__ float scatter(float (&v)[L], int q) {
#pragma unroll
  for (int o = L / 2; o >= 1; o /= 2) {
    const bool up = (q & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float keep = up ? v[i + o] : v[i];
      const float send = up ? v[i] : v[i + o];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

// NL consecutive floats of shared memory at p (16-byte aligned when NL is
// a multiple of 4) into registers.
template <int NL>
__device__ __forceinline__ void read_states(const float* p, float (&v)[NL]) {
  if constexpr (NL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NL; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) v[i] = p[i];
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) selective_scan_kernel(
    const T* __restrict__ xa, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    T* __restrict__ y, long long s, long long c, int vec) {
  constexpr int L = kLanes, NL = N / L;
  static_assert(N % L == 0, "a channel's states split evenly");
  __shared__ __align__(16) Chunk<N, T> buf[kStages];

  const int q = threadIdx.x % L;  // the lane's slice of the states
  const int j = threadIdx.x / L;  // its channel in the block
  const long long row = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChannels;
  const long long ch = c0 + j;
  const bool live = ch < c;
  const long long cl = live ? ch : c - 1;  // a valid channel to read

  float a2[NL], h[NL];
#pragma unroll
  for (int n = 0; n < NL; ++n) {
    a2[n] = -expf(a_log[cl * N + q * NL + n]) * kLog2e;
    h[n] = 0.0f;
  }
  const float dq = q == 0 ? d_skip[cl] : 0.0f;  // D enters lane 0's sum
  T* yr = y + row * s * c + cl;
  const T* xr = xa + row * s * c + c0;
  const float* dr = dt + row * s * c + c0;
  const float* br = bm + row * s * N;
  const float* cr = cm + row * s * N;
  const int left = static_cast<int>(min(c - c0, static_cast<long long>(
                                                    kChannels)));

  const long long chunks = (s + kSteps - 1) / kSteps;
  // chunk k goes to buf[k % kStages]; chunks 0 .. kStages - 2 first, then
  // each iteration refills the buffer the last one read (every thread is
  // past it after the barrier), so copies run kStages - 1 chunks ahead and
  // one barrier a chunk suffices.  A commit group per chunk, empty past
  // the end, keeps the wait's count uniform.
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < chunks) {
      stage(buf[p], xr, dr, br, cr, p * kSteps, s, left, c, vec != 0);
    } else {
      copy_commit();
    }
  }
  for (long long k = 0; k < chunks; ++k) {
    copy_wait<kStages - 2>();  // this thread's copies of chunk k landed
    __syncthreads();           // everyone's, and chunk k - 1 is done
    const long long next = k + kStages - 1;
    if (next < chunks) {
      stage(buf[next % kStages], xr, dr, br, cr, next * kSteps, s, left, c,
            vec != 0);
    } else {
      copy_commit();
    }
    const Chunk<N, T>& cur = buf[k % kStages];
    const long long t0 = k * kSteps;
    // this lane stores steps t0 + q, t0 + q + L, ... while u0 < rem: the
    // pointer steps by L rows and the bound is a 32-bit count, so a store
    // costs no 64-bit arithmetic and no branch
    const int rem = live ? static_cast<int>(min(s - t0 - q, static_cast<
                                                  long long>(kSteps)))
                         : 0;
    T* yp = yr + (t0 + q) * c;
    const long long ystep = L * c;
#pragma unroll
    for (int u0 = 0; u0 < kSteps; u0 += L) {
      float v[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int u = u0 + i;
        const float x = to_f32(cur.x[u * kChannels + j]);
        const float d = cur.d[u * kChannels + j];
        const float dx = d * x;
        float bv[NL], cv[NL];
        read_states(&cur.b[u * N + q * NL], bv);
        read_states(&cur.c[u * N + q * NL], cv);
        float acc = dq * x;
#pragma unroll
        for (int n = 0; n < NL; ++n) {
          h[n] = fmaf(exp2_approx(d * a2[n]), h[n], dx * bv[n]);
          acc = fmaf(h[n], cv[n], acc);
        }
        v[i] = acc;
      }
      const float out = scatter<L>(v, q);
      if (u0 < rem) store(yp, out);
      yp += ystep;
    }
  }
}

// Shared memory is the carveout's whole share, so kMinBlocks blocks fit an
// SM; set once per instance before its first launch.
template <int N, typename T>
int launch_n(const void* xa, const void* dt, const void* bm, const void* cm,
             const void* a_log, const void* d_skip, void* y, long long b,
             long long s, long long c, void* stream) {
  auto kernel = &selective_scan_kernel<N, T>;
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = c % 8 == 0 && al(xa) && al(dt) && al(bm) && al(cm);
  const dim3 grid(static_cast<unsigned>((c + kChannels - 1) / kChannels),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xa), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<T*>(y), s, c, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xa, const void* dt, const void* bm, const void* cm,
           const void* a_log, const void* d_skip, void* y, long long b,
           long long s, long long c, long long n, void* stream) {
  if (b < 1 || s < 1 || c < 1 || b > kMaxRows ||
      (c + kChannels - 1) / kChannels > 0x7fffffffLL) {
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
