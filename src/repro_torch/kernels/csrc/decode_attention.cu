// decode_attention for Hopper (sm_90a): one-token attention over the q
// parties' shards of a KV cache, one launch for all of them
//
// For every shard i of `shards` blocks of s_loc positions (absolute
// positions offset + i * s_loc + t), every batch row b and query head h:
//
//   s_t = q[b, h] . k[b, t, h / rep] / sqrt(dh)   over the valid t,
//   m = max_t s_t,  l = sum_t exp(s_t - m),  o = sum_t exp(s_t - m) v[b, t, h / rep]
//
// with t valid where its absolute position lies in (pos - window, pos].
// o (shards, B, H, dh) is unnormalised and, with m and l (shards, B, H),
// all f32, ready for the log-sum-exp merge across shards (done outside,
// as the reference does it outside its kernel).  A shard with no valid
// position gives o = 0, l = 0 and m = -1e30, so the merge weighs it 0.
// q is (B, H, dh) and the caches (B, S, Hkv, dh), each given by its
// strides in elements with dh contiguous; pos is read from a 0-d int32
// device tensor, so a captured decode step can advance it without a new
// launch configuration.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention / _decode_kernel (the pl.pallas_call at
// decode_attention.py:79), the kernel form of the reference's
// local_decode_attention.  On the TPU the grid is (B, H, kv blocks) with
// the kv axis sequential and (m, l, acc) carried in VMEM; it serves one
// shard per call and needs s_loc to be a multiple of its block.  Here one
// block owns one (shard, KV head, batch row) and serves all `rep` query
// heads of the group, so each K/V row is read once for all of them; the
// block visits only the positions inside the window, and any s_loc is
// taken (the ragged edge is never read).
//
// What bounds it on this card.  It reads each valid K and V row once:
// at gemma3-4b's decode (B 4, Hkv 4, dh 256, bf16, 4,128 positions) a
// global layer reads 34 MB (10 us at 3.35 TB/s) for about 34 MFLOP; a
// local layer (window 1024) a quarter of that.  Memory bounds it.
//
// Design.  Eight warps per block; warp w takes positions lo + w, lo + w +
// 8, ..., kUnroll rows at a time with all their loads issued together.
// Lane j holds dh / 32 consecutive elements (one 16-byte load for bf16 at
// dh 256) of q (pre-scaled, f32), of the K/V rows and of the output
// accumulator; a score is a warp sum (xor shuffles), and each warp runs
// its own online softmax.  The warps' (m, l, acc) are merged in warp order
// through shared memory (no atomics: the result is the same bit for bit
// on every run).  dh (32, 64, 128, 256) and the largest group size (1, 2,
// 4, 8) are template parameters; any other dh, or rep > 8, is refused.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // K/V rows a warp has in flight

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* o;
  float* m;
  float* l;
  const int* pos;
  long long s_loc, offset, window;
  int b, h, hkv, rep;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// E consecutive elements at p (aligned to their size, or to 16 bytes).
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, float (&out)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    uint4 raw[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      raw[i] = reinterpret_cast<const uint4*>(p)[i];
    }
    const T* vals = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f32(vals[e]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f32(vals[e]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f32(vals[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f32(p[e]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

template <int DH, int REP, typename T>
__global__ void __launch_bounds__(kWarps * 32)
    decode_kernel(const Params p) {
  constexpr int kE = DH / 32;  // elements per lane: d = lane * kE + e
  __shared__ float sm_m[kWarps][REP], sm_l[kWarps][REP];
  __shared__ __align__(16) float sm_o[REP][DH];

  const int shard = blockIdx.x, g = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = p.rep;
  const long long off = p.offset + shard * p.s_loc;
  const long long pos = *p.pos;
  const long long lo = max(0LL, pos - p.window + 1 - off);
  const long long hi = min(p.s_loc, pos - off + 1);

  const T* qb = static_cast<const T*>(p.q) + bb * p.qsb + lane * kE;
  const T* kb = static_cast<const T*>(p.k) + bb * p.ksb + g * p.ksh +
                (shard * p.s_loc) * p.kss + lane * kE;
  const T* vb = static_cast<const T*>(p.v) + bb * p.vsb + g * p.vsh +
                (shard * p.s_loc) * p.vss + lane * kE;

  float qf[REP][kE], acc[REP][kE], m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rep) {
      load_row<T, kE>(qb + (g * rep + r) * p.qsh, qf[r]);
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      qf[r][e] = r < rep ? qf[r][e] * p.scale : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  for (long long t0 = lo + warp * kUnroll; t0 < hi;
       t0 += kWarps * kUnroll) {
    float kf[kUnroll][kE], vf[kUnroll][kE];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < hi) {
        load_row<T, kE>(kb + (t0 + u) * p.kss, kf[u]);
        load_row<T, kE>(vb + (t0 + u) * p.vss, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= hi) break;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= rep) break;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) part = fmaf(qf[r][e], kf[u][e], part);
        const float s = warp_sum(part);
        const float mn = fmaxf(m[r], s);
        const float alpha = expf(m[r] - mn);
        const float pe = expf(s - mn);
        l[r] = l[r] * alpha + pe;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[r][e] = fmaf(pe, vf[u][e], acc[r][e] * alpha);
        }
        m[r] = mn;
      }
    }
  }

  // merge the warps' partials, in warp order
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  float mstar[REP], corr[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    mstar[r] = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mstar[r] = fmaxf(mstar[r], sm_m[w][r]);
    corr[r] = expf(m[r] - mstar[r]);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          float* dst = &sm_o[r][lane * kE + e];
          const float add = acc[r][e] * corr[r];
          *dst = w == 0 ? add : *dst + add;
        }
      }
    }
    __syncthreads();
  }

  const long long head0 = (static_cast<long long>(shard) * p.b + bb) * p.h +
                          static_cast<long long>(g) * rep;
  for (int i = threadIdx.x; i < rep * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    p.o[(head0 + r) * DH + d] = sm_o[r][d];
  }
  if (threadIdx.x < rep) {
    const int r = threadIdx.x;
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      lsum += sm_l[w][r] * expf(sm_m[w][r] - mstar[r]);
    }
    p.m[head0 + r] = mstar[r];
    p.l[head0 + r] = lsum;
  }
}

template <int DH, int REP, typename T>
int launch_rep(const Params& p, long long shards, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(shards),
                  static_cast<unsigned>(p.hkv), static_cast<unsigned>(p.b));
  decode_kernel<DH, REP, T><<<grid, kWarps * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T>
int launch_dh(const Params& p, long long shards, cudaStream_t st) {
  if (p.rep <= 1) return launch_rep<DH, 1, T>(p, shards, st);
  if (p.rep <= 2) return launch_rep<DH, 2, T>(p, shards, st);
  if (p.rep <= 4) return launch_rep<DH, 4, T>(p, shards, st);
  return launch_rep<DH, 8, T>(p, shards, st);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, const void* pos, long long b, long long h,
           long long hkv, long long shards, long long s_loc, long long dh,
           long long offset, long long window, long long qsb, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb,
           long long vss, long long vsh, void* stream) {
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || h % hkv != 0 ||
      h / hkv > 8 || shards < 1 || shards > 0x7fffffffLL || s_loc < 1 ||
      window < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,
           k,
           v,
           static_cast<float*>(o),
           static_cast<float*>(m),
           static_cast<float*>(l),
           static_cast<const int*>(pos),
           s_loc,
           offset,
           window,
           static_cast<int>(b),
           static_cast<int>(h),
           static_cast<int>(hkv),
           static_cast<int>(h / hkv),
           qsb,
           qsh,
           ksb,
           kss,
           ksh,
           vsb,
           vss,
           vsh,
           static_cast<float>(1.0 / sqrt(static_cast<double>(dh)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch_dh<32, T>(p, shards, st);
    case 64:
      return launch_dh<64, T>(p, shards, st);
    case 128:
      return launch_dh<128, T>(p, shards, st);
    case 256:
      return launch_dh<256, T>(p, shards, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define DECODE_ENTRY(name, T)                                               \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      void* m, void* l, const void* pos, long long b,        \
                      long long h, long long hkv, long long shards,          \
                      long long s_loc, long long dh, long long offset,       \
                      long long window, long long qsb, long long qsh,        \
                      long long ksb, long long kss, long long ksh,           \
                      long long vsb, long long vss, long long vsh,           \
                      void* stream) {                                       \
    return launch<T>(q, k, v, o, m, l, pos, b, h, hkv, shards, s_loc, dh,   \
                     offset, window, qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, \
                     stream);                                               \
  }

DECODE_ENTRY(decode_attention_f32, float)
DECODE_ENTRY(decode_attention_bf16, __nv_bfloat16)
