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
// shard per call and needs s_loc to be a multiple of its block.
//
// What bounds it on this card.  It reads each valid K and V row once:
// at gemma3-4b's decode (B 4, Hkv 4, dh 256, bf16, 4,128 positions) a
// global layer reads 67 MB of K and V (20 us at 3.35 TB/s) for about 34
// MFLOP; a local layer (window 1024) a quarter of that.  Memory bounds it, so what
// counts is how many bytes are in flight on how many SMs, and that the
// arithmetic per row stays small.  The first form gave a whole shard to
// one block (128 blocks for 132 SMs, of which the window left 32-48 busy,
// each walking its rows in rounds that waited on memory one after the
// other) and scored each row with a 32-lane shuffle sum per query head.
//
// Design: split-KV.  Each shard is cut into `chunks` chunks of chunk_len
// <= 64 positions (fixed by the shapes on the host; the last may be
// shorter), and one block of four warps owns one (shard, chunk, KV head,
// batch row): the grid depends on the shapes only, never on pos.  A block
// whose chunk holds no valid position returns at once, so under the
// window only the chunks that hold it stream.  A block serves all `rep`
// query heads of its group from one read of each K/V row.  Two programs:
//   * bf16, on the tensor cores (mma.sync m16n8k16, f32 accumulation):
//     warp w owns the chunk's rows 16w..16w+15.  Its lanes copy the K rows
//     and then the V rows into shared memory with 16-byte cp.async, as two
//     stages of a ring, so the scores are computed while V is in flight.
//     S = Q K^T takes the group's query heads as the rows of A (at most 8
//     of the 16; q from registers) and K by ldmatrix as B; each head's
//     softmax over the 16 rows is reduced over the 4 lanes that share it;
//     then O^T = V^T P^T takes V by transposing ldmatrix as A and P, as it
//     lies in S's accumulator, as B (N = 8 heads), so O^T (dh x 8) needs
//     no shuffle.  P keeps its f32 accuracy, as the TPU kernel's does: it
//     is split into a bf16 high part and the bf16 rounding of the rest,
//     and each V tile takes one mma for each (about 2^-17 relative error
//     in P instead of bf16's 2^-9; the second mma adds little to a
//     memory-bound kernel).  The warps' (o, m, l) are merged through
//     shared memory, each output summing the warps in warp order.
//   * f32 (no tensor cores: f32 products stay f32; no served model's cache
//     is f32): each warp walks the chunk's rows kUnroll at a time, strided
//     by the block's warps, with dh spread over its lanes, and folds each
//     row into a running (m, l, acc) per head; the warps are merged in
//     warp order.
//
// A shard with one valid chunk writes its result directly.  Otherwise
// each valid chunk writes its partial (o, m, l) to an f32 workspace and
// takes a ticket from an integer counter of its (shard, KV head, batch
// row) after __threadfence(); the block that draws the last ticket merges
// the partials in a fixed order (so two calls agree bit for bit; no float
// atomics) and resets the counter to 0 for the next launch or graph
// replay.  A shard with no valid chunk is written (o = 0, l = 0, m =
// -1e30) by the block of its chunk 0.  dh (32, 64, 128, 256) is a
// template parameter and the group size is read at run time, up to 8 (any
// other dh, or rep > 8, is refused).  The bf16 program's merge keeps the
// loads of a bound on the group size in flight (loads past the group are
// wasted), so it has instances for groups of at most 2, 4 and 8 heads,
// the served models' 1, 2, 4 and 6; the f32 program has one.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing (the wrapper hands it the workspace and
// the counters, which must hold zeros before the first launch), does not
// synchronise, and returns cudaGetLastError() so the wrapper can raise on
// a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kChunk = 16 * kWarps;  // most rows a block owns
constexpr int kMaxRep = 8;
constexpr int kUnroll = 2;  // f32: K/V rows a warp has in flight
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* o;
  float* m;
  float* l;
  float* ws;    // chunk partials (shards, chunks, B, H, dh + 2)
  int* count;   // tickets (shards, Hkv, B), 0 between launches
  const int* pos;
  long long s_loc, offset, window, chunk_len;
  int b, h, hkv, rep, chunks;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale_log2;  // log2(e) / sqrt(dh): scores in the log2 domain
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory (zeros when `full` is false: no
// byte of `src` is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp2(x - ref) with the convention that a max of -inf weighs 0 (also
// where ref is -inf).
__device__ __forceinline__ float weight(float x, float ref) {
  return x == -INFINITY ? 0.f : exp2_approx(x - ref);
}

// Sum over the kLanes lanes that share a row (xor offsets below kLanes).
template <int kLanes>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, d);
  }
  return x;
}

// ---------------------------------------------------------------------------
// what a block owns, and how its chunk's result leaves it
// ---------------------------------------------------------------------------

struct Span {
  long long r_lo, r_hi;  // the chunk's valid rows, shard-relative
  long long head0;       // the group's first row of o/m/l (shard, b, head)
  int c_lo, c_hi;        // the shard's valid chunks
};

// The valid rows of block (shard, chunk) for KV head g of batch row bb;
// false where the block has nothing to do (after the block of chunk 0 of
// a shard with no valid position has written its empty result).
__device__ __forceinline__ bool block_span(const Params& p, int shard,
                                           int chunk, int g, int bb, int dh,
                                           Span* sp) {
  const long long pos = *p.pos;
  const long long off = p.offset + shard * p.s_loc;
  // this shard's valid positions [lo, hi), shard-relative
  const long long lo = max(0LL, pos - p.window + 1 - off);
  const long long hi = min(p.s_loc, pos - off + 1);
  sp->head0 = (static_cast<long long>(shard) * p.b + bb) * p.h +
              static_cast<long long>(g) * p.rep;
  if (hi <= lo) {
    if (chunk == 0) {
      for (int i = threadIdx.x; i < p.rep * dh; i += blockDim.x) {
        p.o[sp->head0 * dh + i] = 0.f;
      }
      if (threadIdx.x < p.rep) {
        p.m[sp->head0 + threadIdx.x] = kNegInf;
        p.l[sp->head0 + threadIdx.x] = 0.f;
      }
    }
    return false;
  }
  sp->c_lo = static_cast<int>(lo / p.chunk_len);
  sp->c_hi = static_cast<int>((hi - 1) / p.chunk_len);
  if (chunk < sp->c_lo || chunk > sp->c_hi) return false;
  sp->r_lo = max(lo, chunk * p.chunk_len);
  sp->r_hi = min(hi, (chunk + 1) * p.chunk_len);
  return true;
}

// The block's chunk result -- o (rep x DH) in shared rows `ld` floats
// apart, m (log2 domain) and l in sm_mb/sm_lb -- to the output where the
// shard has one valid chunk; else to the workspace, and the block that
// draws the last ticket merges the shard's partials.  `sm_w` is 2 x 32 x
// kMaxRep floats of scratch that may alias nothing the result uses; REP
// bounds rep.
template <int DH, int REP>
__device__ void finish_chunk(const Params& p, const Span& sp, int shard,
                             int chunk, int g, int bb, const float* sm_o,
                             int ld, float* sm_mb, float* sm_lb,
                             float* sm_w) {
  __shared__ int sm_last;
  const int rep = p.rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvalid = sp.c_hi - sp.c_lo + 1;
  if (nvalid == 1) {  // the shard's only chunk: the result itself
    for (int i = threadIdx.x; i < rep * DH; i += blockDim.x) {
      p.o[sp.head0 * DH + i] = sm_o[(i / DH) * ld + i % DH];
    }
    if (threadIdx.x < rep) {
      p.m[sp.head0 + threadIdx.x] = sm_mb[threadIdx.x] * kLn2;
      p.l[sp.head0 + threadIdx.x] = sm_lb[threadIdx.x];
    }
    return;
  }

  // this chunk's partial, then a ticket
  constexpr int kW = DH + 2;
  const long long part0 =
      ((static_cast<long long>(shard) * p.chunks + chunk) * p.b + bb) * p.h +
      static_cast<long long>(g) * rep;
  for (int i = threadIdx.x; i < rep * DH; i += blockDim.x) {
    p.ws[(part0 + i / DH) * kW + i % DH] = sm_o[(i / DH) * ld + i % DH];
  }
  if (threadIdx.x < rep) {
    p.ws[(part0 + threadIdx.x) * kW + DH] = sm_mb[threadIdx.x];
    p.ws[(part0 + threadIdx.x) * kW + DH + 1] = sm_lb[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  int* counter =
      p.count + (static_cast<long long>(shard) * p.hkv + g) * p.b + bb;
  if (threadIdx.x == 0) sm_last = atomicAdd(counter, 1) == nvalid - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch

  // The merge reads the partials of chunks c_lo..c_hi (`stride` floats
  // apart) from L2.  First a warp per head takes the max of the chunks' m
  // (lanes over chunks), keeping the first 32 chunks' m and l in shared
  // memory.  Then, 32 chunks at a time, each chunk's weight goes to shared
  // memory and the weighted l is summed, and each thread sums its kPer
  // outputs over the group's chunks in chunk order, the loads of 8 chunks
  // straight-line (a head past rep or a chunk past the group reads a valid
  // partial and weighs 0) so that they are in flight together.
  const long long stride = static_cast<long long>(p.b) * p.h * kW;
  const float* first =
      p.ws +
      (part0 + static_cast<long long>(sp.c_lo - chunk) * p.b * p.h) * kW;
  float* sm_lc = sm_w + 32 * kMaxRep;
  for (int r = warp; r < rep; r += kWarps) {
    float mx = -INFINITY;
    for (int c = lane; c < nvalid; c += 32) {
      const float mc = __ldcg(first + c * stride + r * kW + DH);
      if (c < 32) {
        sm_w[c * kMaxRep + r] = mc;
        sm_lc[c * kMaxRep + r] = __ldcg(first + c * stride + r * kW + DH + 1);
      }
      mx = fmaxf(mx, mc);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    }
    if (lane == 0) sm_mb[r] = mx;
  }
  __syncthreads();
  constexpr int kThreads = kWarps * 32;
  constexpr int kPer = (REP * DH + kThreads - 1) / kThreads;
  float osum[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) osum[k] = 0.f;
  for (int c0 = 0; c0 < nvalid; c0 += 32) {
    const int nc = min(32, nvalid - c0);
    for (int r = warp; r < rep; r += kWarps) {
      float lw = 0.f;
      if (lane < nc) {
        const float* part = first + (c0 + lane) * stride + r * kW;
        const float mc = c0 == 0 ? sm_w[lane * kMaxRep + r] : __ldcg(part + DH);
        const float lc =
            c0 == 0 ? sm_lc[lane * kMaxRep + r] : __ldcg(part + DH + 1);
        const float w = weight(mc, sm_mb[r]);
        lw = lc * w;
        sm_w[lane * kMaxRep + r] = w;
      }
      lw = row_sum<32>(lw);
      if (lane == 0) sm_lb[r] = (c0 == 0 ? 0.f : sm_lb[r]) + lw;
    }
    __syncthreads();
    for (int cb = 0; cb < nc; cb += 8) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int r = min(i / DH, rep - 1), d = i % DH;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = min(cb + u, nc - 1);
          const float w = i / DH < rep && cb + u < nc
                              ? sm_w[c * kMaxRep + r]
                              : 0.f;
          osum[k] = fmaf(__ldcg(first + (c0 + c) * stride + r * kW + d), w,
                         osum[k]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i / DH < rep) p.o[sp.head0 * DH + i] = osum[k];
  }
  if (threadIdx.x < rep) {
    p.m[sp.head0 + threadIdx.x] = sm_mb[threadIdx.x] * kLn2;
    p.l[sp.head0 + threadIdx.x] = sm_lb[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int DH>
struct MmaRows {
  static constexpr int kLd = DH + 8;  // padded smem row (bf16): no conflicts
  static constexpr int kOLd = DH + 4;  // the merged o's rows (f32)
  // K then V, kChunk rows each; after the warps are done with them, the
  // warps' o (kWarps x kMaxRep rows of kOLd f32), the merged o (kMaxRep
  // rows) and the merge's weights reuse the space
  static constexpr int kSmemBytes = 2 * kChunk * kLd * 2;
  static_assert(((kWarps + 1) * kMaxRep * kOLd + 2 * 32 * kMaxRep) * 4 <=
                    kSmemBytes,
                "the warps' o must fit where K and V were");
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; `.trans` hands out their transposes.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// (a, b) as a bf16 pair `hi` and the bf16 pair `lo` of what rounding
// left, so that hi + lo holds a and b to about 2^-17 of their size.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int DH, int REP>
__global__ void __launch_bounds__(kWarps * 32)
    decode_mma_kernel(const Params p) {
  using R = MmaRows<DH>;
  constexpr int kLd = R::kLd, kOLd = R::kOLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sm_m[kWarps][kMaxRep], sm_l[kWarps][kMaxRep];
  __shared__ float sm_mb[kMaxRep], sm_lb[kMaxRep];

  const int shard = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const int g = blockIdx.y, bb = blockIdx.z;
  Span sp;
  if (!block_span(p, shard, chunk, g, bb, DH, &sp)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rep = p.rep;

  // this warp's rows [t0, t0 + nrows) of the chunk, 16 smem rows each of K
  // and V; rows past the end are zeros
  const long long t0 = sp.r_lo + 16 * warp;
  const int nrows = static_cast<int>(max(0LL, min(16LL, sp.r_hi - t0)));
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            bb * p.ksb + g * p.ksh + (shard * p.s_loc) * p.kss;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            bb * p.vsb + g * p.vsh + (shard * p.s_loc) * p.vss;
  __nv_bfloat16* ks =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * 16 * kLd;
  __nv_bfloat16* vs = ks + kChunk * kLd;
  constexpr int kVec = DH / 8;  // 16-byte pieces of a row
  // stage 0: K, stage 1: V
#pragma unroll
  for (int stage = 0; stage < 2; ++stage) {
    const __nv_bfloat16* src = stage == 0 ? kb : vb;
    const long long sstride = stage == 0 ? p.kss : p.vss;
    __nv_bfloat16* dst = stage == 0 ? ks : vs;
#pragma unroll
    for (int i = lane; i < 16 * kVec; i += 32) {
      const int r = i / kVec, c = (i % kVec) * 8;
      const bool in = r < nrows;
      cp_async16(smem_addr(dst + r * kLd + c),
                 in ? src + (t0 + r) * sstride + c : src, in);
    }
    cp_async_commit();
  }

  // q: head gid of the group as row gid of A (rows 8-15 are zero)
  uint32_t qa[DH / 16][2];
  {
    const __nv_bfloat16* qrow = static_cast<const __nv_bfloat16*>(p.q) +
                                bb * p.qsb + (g * rep + gid) * p.qsh + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qa[kk][0] = gid < rep
                      ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk)
                      : 0u;
      qa[kk][1] = gid < rep
                      ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8)
                      : 0u;
    }
  }
  // ldmatrix row addresses: matrix l / 8 covers rows (l / 16) * 8.. and
  // columns ((l / 8) % 2) * 8..
  const int frag =
      ((lane >> 4) * 8 + (lane & 7)) * kLd + ((lane >> 3) & 1) * 8;

  cp_async_wait<1>();  // K landed (this lane's pieces) ...
  __syncwarp();        // ... and every lane's
  // S = Q K^T: head gid x rows 2tig, 2tig + 1 (n-tile 0) and 8 + those
  // (n-tile 1); two accumulators per n-tile halve the dependent chain
  float sacc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, smem_addr(ks + frag + kk * 16));
    mma_bf16(sacc[kk & 1], qa[kk][0], 0u, qa[kk][1], 0u, b[0], b[1]);
    mma_bf16(sacc[2 + (kk & 1)], qa[kk][0], 0u, qa[kk][1], 0u, b[2], b[3]);
  }
  float s[4] = {sacc[0][0] + sacc[1][0], sacc[0][1] + sacc[1][1],
                sacc[2][0] + sacc[3][0], sacc[2][1] + sacc[3][1]};
  float mt = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = (e >> 1) * 8 + 2 * tig + (e & 1);
    s[e] = row < nrows ? s[e] * p.scale_log2 : -INFINITY;
    mt = fmaxf(mt, s[e]);
  }
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
  float pe[4], lt = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    pe[e] = weight(s[e], mt);
    lt += pe[e];
  }
  lt += __shfl_xor_sync(0xffffffffu, lt, 1);
  lt += __shfl_xor_sync(0xffffffffu, lt, 2);
  // P^T as B: k = rows 2tig.. (and 8 + 2tig..), n = head gid; a bf16
  // high part and the bf16 rounding of what it leaves
  uint32_t phi[2], plo[2];
  split_bf16(pe[0], pe[1], &phi[0], &plo[0]);
  split_bf16(pe[2], pe[3], &phi[1], &plo[1]);

  cp_async_wait<0>();  // V landed
  __syncwarp();
  // O^T = V^T P^T: dh 16i + gid (+8) x heads 2tig, 2tig + 1
  float oacc[DH / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
    uint32_t a[4];
    ldsm_x4_trans(a, smem_addr(vs + frag + i * 16));
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    mma_bf16(oacc[i], a[0], a[1], a[2], a[3], plo[0], plo[1]);
    mma_bf16(oacc[i], a[0], a[1], a[2], a[3], phi[0], phi[1]);
  }

  // merge the warps: each writes its rescaled o^T to its own shared rows
  // of kOLd floats, then each output sums the warps in warp order
  if (tig == 0) {
    sm_m[warp][gid] = mt;
    sm_l[warp][gid] = lt;
  }
  __syncthreads();  // also: every warp is done with K and V
  float* sm_ow = reinterpret_cast<float*>(smem_raw);  // [warp][head][kOLd]
  float* sm_o = sm_ow + kWarps * kMaxRep * kOLd;     // [head][kOLd]
  float corr[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int hd = 2 * tig + e;
    float ms = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, sm_m[w][hd]);
    corr[e] = weight(sm_m[warp][hd], ms);
  }
#pragma unroll
  for (int i = 0; i < DH / 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hd = 2 * tig + (e & 1);
      const int d = i * 16 + gid + (e >> 1) * 8;
      sm_ow[(warp * kMaxRep + hd) * kOLd + d] = oacc[i][e] * corr[e & 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * DH; i += blockDim.x) {
    const int hd = i / DH, d = i % DH;
    float sum = sm_ow[hd * kOLd + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += sm_ow[(w * kMaxRep + hd) * kOLd + d];
    sm_o[hd * kOLd + d] = sum;
  }
  if (threadIdx.x < rep) {  // the block's (m, l) per head, log2 domain
    const int r = threadIdx.x;
    float ms = -INFINITY, ls = 0.f;
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, sm_m[w][r]);
    for (int w = 0; w < kWarps; ++w) ls += sm_l[w][r] * weight(sm_m[w][r], ms);
    sm_mb[r] = ms;
    sm_lb[r] = ls;
  }
  __syncthreads();
  finish_chunk<DH, REP>(p, sp, shard, chunk, g, bb, sm_o, kOLd, sm_mb, sm_lb,
                        sm_o + kMaxRep * kOLd);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// E consecutive f32 at p, aligned to their size (or to 16 bytes).
template <int E>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else if constexpr (E == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    decode_f32_kernel(const Params p) {
  constexpr int kE = DH / 32;  // elements per lane: d = lane * kE + e
  __shared__ float sm_m[kWarps][kMaxRep], sm_l[kWarps][kMaxRep];
  __shared__ float sm_mb[kMaxRep], sm_lb[kMaxRep];
  __shared__ __align__(16) float sm_o[kMaxRep][DH];
  __shared__ float sm_w[2 * 32 * kMaxRep];

  const int shard = blockIdx.x / p.chunks, chunk = blockIdx.x % p.chunks;
  const int g = blockIdx.y, bb = blockIdx.z;
  Span sp;
  if (!block_span(p, shard, chunk, g, bb, DH, &sp)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rep = p.rep;

  const float* qb = static_cast<const float*>(p.q) + bb * p.qsb + lane * kE;
  const float* kb = static_cast<const float*>(p.k) + bb * p.ksb + g * p.ksh +
                    (shard * p.s_loc) * p.kss + lane * kE;
  const float* vb = static_cast<const float*>(p.v) + bb * p.vsb + g * p.vsh +
                    (shard * p.s_loc) * p.vss + lane * kE;

  float qf[kMaxRep][kE], acc[kMaxRep][kE], m[kMaxRep], l[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) load_f32<kE>(qb + (g * rep + r) * p.qsh, qf[r]);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      qf[r][e] = r < rep ? qf[r][e] * p.scale_log2 : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (long long t0 = sp.r_lo + warp * kUnroll; t0 < sp.r_hi;
       t0 += kWarps * kUnroll) {
    float kf[kUnroll][kE], vf[kUnroll][kE];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < sp.r_hi) {
        load_f32<kE>(kb + (t0 + u) * p.kss, kf[u]);
        load_f32<kE>(vb + (t0 + u) * p.vss, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= sp.r_hi) break;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) part = fmaf(qf[r][e], kf[u][e], part);
        const float s = row_sum<32>(part);  // log2 domain, finite
        const float mn = fmaxf(m[r], s);
        const float alpha = exp2_approx(m[r] - mn);  // 0 while m is -inf
        const float pe = exp2_approx(s - mn);
        l[r] = l[r] * alpha + pe;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[r][e] = fmaf(pe, vf[u][e], acc[r][e] * alpha);
        }
        m[r] = mn;
      }
    }
  }

  // merge the warps in warp order (a warp with no rows weighs 0)
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  float corr[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    float ms = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, sm_m[w][r]);
    corr[r] = weight(m[r], ms);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
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
  if (threadIdx.x < rep) {  // the block's (m, l) per head, log2 domain
    const int r = threadIdx.x;
    float ms = -INFINITY, ls = 0.f;
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, sm_m[w][r]);
    for (int w = 0; w < kWarps; ++w) ls += sm_l[w][r] * weight(sm_m[w][r], ms);
    sm_mb[r] = ms;
    sm_lb[r] = ls;
  }
  __syncthreads();
  finish_chunk<DH, kMaxRep>(p, sp, shard, chunk, g, bb, &sm_o[0][0], DH,
                            sm_mb, sm_lb, sm_w);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The bf16 program for group sizes up to REP: the merge keeps REP heads'
// loads in flight.
template <int DH, int REP>
int launch_mma(const dim3& grid, const Params& p, cudaStream_t st) {
  // the dynamic shared memory and the largest carveout, set once per
  // device (so a launch inside a CUDA-graph capture makes no attribute
  // call)
  constexpr int kSmem = MmaRows<DH>::kSmemBytes;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices || !done[dev]) {
    cudaFuncSetAttribute(decode_mma_kernel<DH, REP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    cudaFuncSetAttribute(decode_mma_kernel<DH, REP>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  }
  decode_mma_kernel<DH, REP><<<grid, kWarps * 32, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Params& p, long long shards, bool bf16, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(shards * p.chunks),
                  static_cast<unsigned>(p.hkv), static_cast<unsigned>(p.b));
  if (!bf16) {
    decode_f32_kernel<DH><<<grid, kWarps * 32, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.rep <= 2) return launch_mma<DH, 2>(grid, p, st);
  if (p.rep <= 4) return launch_mma<DH, 4>(grid, p, st);
  return launch_mma<DH, kMaxRep>(grid, p, st);
}

int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, void* ws, void* count, const void* pos, long long b,
           long long h, long long hkv, long long shards, long long s_loc,
           long long dh, long long offset, long long window,
           long long chunks, long long chunk_len, long long qsb,
           long long qsh, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, bool bf16,
           void* stream) {
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || h % hkv != 0 ||
      h / hkv > kMaxRep || shards < 1 || s_loc < 1 || window < 1 ||
      chunks < 1 || chunk_len < 1 || chunk_len > kChunk ||
      chunks * chunk_len < s_loc || (chunks - 1) * chunk_len >= s_loc ||
      shards * chunks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,
           k,
           v,
           static_cast<float*>(o),
           static_cast<float*>(m),
           static_cast<float*>(l),
           static_cast<float*>(ws),
           static_cast<int*>(count),
           static_cast<const int*>(pos),
           s_loc,
           offset,
           window,
           chunk_len,
           static_cast<int>(b),
           static_cast<int>(h),
           static_cast<int>(hkv),
           static_cast<int>(h / hkv),
           static_cast<int>(chunks),
           qsb,
           qsh,
           ksb,
           kss,
           ksh,
           vsb,
           vss,
           vsh,
           static_cast<float>(kLog2e / sqrt(static_cast<double>(dh)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch_dh<32>(p, shards, bf16, st);
    case 64:
      return launch_dh<64>(p, shards, bf16, st);
    case 128:
      return launch_dh<128>(p, shards, bf16, st);
    case 256:
      return launch_dh<256>(p, shards, bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define DECODE_ENTRY(name, is_bf16)                                          \
  extern "C" int name(const void* q, const void* k, const void* v, void* o,  \
                      void* m, void* l, void* ws, void* count,               \
                      const void* pos, long long b, long long h,             \
                      long long hkv, long long shards, long long s_loc,      \
                      long long dh, long long offset, long long window,      \
                      long long chunks, long long chunk_len, long long qsb,  \
                      long long qsh, long long ksb, long long kss,           \
                      long long ksh, long long vsb, long long vss,           \
                      long long vsh, void* stream) {                         \
    return launch(q, k, v, o, m, l, ws, count, pos, b, h, hkv, shards, s_loc, \
                  dh, offset, window, chunks, chunk_len, qsb, qsh, ksb, kss,  \
                  ksh, vsb, vss, vsh, is_bf16, stream);                      \
  }

DECODE_ENTRY(decode_attention_f32, false)
DECODE_ENTRY(decode_attention_bf16, true)
