// flash_attention for Hopper (sm_90a): causal / sliding-window / GQA
// softmax attention with an online softmax
//
//   o[b, h, i] = sum_j p_ij v[b, h / rep, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = q[b, h, i] . k[b, h / rep, j] / sqrt(dh)
//
// over the keys j that the mask keeps: j <= i (causal) and j > i - window
// (a sliding window), query positions counted from 0 as keys are.  q is
// (B, H, Sq, dh), k and v (B, Hkv, Skv, dh) and o (B, H, Sq, dh), each
// given by its base pointer and its (batch, head, position) strides in
// elements, the last dimension contiguous: the model's (B, S, H, dh)
// projections reach the kernel as transposed views without a copy.  A row
// with no valid key gives 0, as the reference's max(l, 1e-30) does.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention / _flash_kernel (the pl.pallas_call at
// flash_attention.py:93).  On the TPU the grid is (B, H, q tiles, kv
// tiles) with the kv axis sequential, carrying (m, l, acc) in VMEM scratch
// and masking every tile.  Hopper runs blocks in no order, so here one
// block owns its query rows and loops over the kv tiles itself, and the
// tiles that the mask empties whole (above the causal diagonal, before the
// window) are never visited; the blocks with the longest rows start first.
//
// What bounds it on this card.  At gemma3-4b's prefill shape (4, 8, 4096,
// 256) bf16 a global layer needs 4 * B * H * (S^2 / 2) * dh = 275 GFLOP of
// products (0.28 ms at the 989 TFLOP/s dense bf16 tensor peak) against
// 84 MB of q, k, v and o (0.025 ms at 3.35 TB/s): the tensor cores bound
// it, and only wgmma reaches their rate (mma.sync, the first form's
// instruction, reached 17% of it here).
//
// Three programs behind one entry point per dtype:
//   * bf16 at dh 64, 128 and 256 (the model family's head dims),
//     warp-specialised: a block of three warpgroups.  One thread of the
//     first (the producer, which gives its registers up: setmaxnreg 24)
//     loads the consumers' Q tiles once and then streams the K and V tiles
//     by TMA into a ring of two stages, each stage's K and V guarded by a
//     full and an empty mbarrier, so a tile lands while the one before is
//     computed.  The tensor maps are built on the host for every call from
//     the operands' strides (4-d: dh, position, head, batch), so the
//     transposed views are read as they are; tiles land in 64-column
//     blocks with the 128-byte swizzle that the wgmma descriptors name.
//     The two consumer warpgroups (setmaxnreg 240) own 64 query rows
//     each, either the same rows of the two query heads of a GQA group
//     (rep even: each K/V tile serves both heads) or, for an odd rep, 128
//     consecutive rows of one head.  S = Q K^T is wgmma m64nBKk16 with Q
//     and K from shared memory; the online softmax stays in registers in
//     the accumulator's layout (a row's max and sum over the 4 lanes that
//     share it; exp2 with scale * log2(e) folded into one FMA; O rescaled
//     only when a row's max moved); P is rounded to bf16 in registers as
//     the A operand of O += P V, a wgmma with V's tile from shared memory
//     as the MN-major B (N = dh).  Keys per tile: 64 at dh 256, where O
//     takes 128 registers a thread and S 32; 128 below.  Only the tiles
//     that the causal diagonal or the window edge cut are masked element
//     by element; a consumer whose 64 rows a tile misses waits for it and
//     releases it without computing.
//   * bf16 at dh 32: four warps per block, each owning 16 query rows of a
//     64-row tile, through mma.sync m16n8k16 with ldmatrix fragments from
//     cp.async double-buffered tiles (the first form's program, kept for a
//     head dim that no model uses).
//   * f32: plain f32 arithmetic on the CUDA cores, no TF32 (the reference
//     test's f32 tolerance is 2e-6).  Each warp owns 2 query rows, lanes
//     split dh, and K and V tiles are staged in shared memory as f32.
// dh is a template parameter (32, 64, 128 or 256); any other is refused.
// Any Sq, Skv, B, H and Hkv dividing H are taken: rows and keys past the
// ends are masked in the kernel (TMA fills zeros past them).  The window
// is a runtime value, so one compiled program serves every layer.
//
// Plain C interface, loaded with ctypes: each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue where a tensor map cannot
// be built) so the wrapper can raise on a refused launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq, skv;
  int h, hkv;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int causal;
  long long window;  // keys j > i - window; a huge value for none
  float scale;
};

// The kv range [lo, hi) that query rows [q0, q0 + rows) can see.
__device__ __forceinline__ void kv_range(const Params& p, long long q0,
                                         int rows, long long* lo,
                                         long long* hi) {
  *hi = p.causal ? min(p.skv, q0 + rows) : p.skv;
  *lo = max(0LL, q0 - p.window + 1);
}

__device__ __forceinline__ bool key_valid(const Params& p, long long qi,
                                          long long kv) {
  return kv < p.skv && (!p.causal || qi >= kv) && kv > qi - p.window;
}

// ---------------------------------------------------------------------------
// bf16 at dh 32: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block

template <int DH>
struct MmaTile {
  static constexpr int kBK = 64;                   // keys per kv tile
  static constexpr int kLd = DH + 8;               // padded smem row
  // Q, then two K tiles and two V tiles (double-buffered)
  static constexpr int kSmemBytes = (kMmaBQ + 4 * kBK) * kLd * 2;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; `.trans` hands out their transposes.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory without passing through registers
// (zeros when `full` is false: no byte of `src` is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// rows [r0, r0 + nrows) of a (position, DH) operand of T into shared rows
// of `ld` elements, asynchronously, zeros past `limit`.
template <typename T, int DH>
__device__ __forceinline__ void stage_async(T* dst, int ld, const T* src,
                                            long long stride, long long r0,
                                            int nrows, long long limit) {
  constexpr int kVec = DH * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // T per vector
  for (int i = threadIdx.x; i < nrows * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * kPer;
    const bool in = r0 + r < limit;
    cp_async16(dst + r * ld + c, src + (in ? (r0 + r) * stride + c : 0), in);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_mma_kernel(const Params p) {
  constexpr int kBK = MmaTile<DH>::kBK;
  constexpr int kLd = MmaTile<DH>::kLd;
  constexpr int kNT = kBK / 8;   // score n-tiles per kv tile
  constexpr int kND = DH / 8;    // output n-tiles
  static_assert(kNT % 2 == 0 && kND % 2 == 0, "ldmatrix.x4 takes pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kbuf = qs + kMmaBQ * kLd;   // [2][kBK][kLd]
  __nv_bfloat16* vbuf = kbuf + 2 * kBK * kLd;

  const long long qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int g = hh / (p.h / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const long long q0 = qt * kMmaBQ;
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + bb * p.qsb + hh * p.qsh;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + bb * p.ksb + g * p.ksh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + bb * p.vsb + g * p.vsh;

  long long lo, hi;
  kv_range(p, q0, kMmaBQ, &lo, &hi);
  const long long t_first = (lo / kBK) * kBK;
  const int ntiles =
      t_first < hi ? static_cast<int>((hi - t_first + kBK - 1) / kBK) : 0;

  // group 0: Q and the first kv tile
  stage_async<__nv_bfloat16, DH>(qs, kLd, qb, p.qss, q0, kMmaBQ, p.sq);
  if (ntiles > 0) {
    stage_async<__nv_bfloat16, DH>(kbuf, kLd, kb, p.kss, t_first, kBK,
                                   p.skv);
    stage_async<__nv_bfloat16, DH>(vbuf, kLd, vb, p.vss, t_first, kBK,
                                   p.skv);
  }
  cp_async_commit();

  // this thread's two rows: r0 = warp*16 + gid and r1 = r0 + 8
  const long long qi0 = q0 + warp * 16 + gid, qi1 = qi0 + 8;
  const float sl2 = p.scale * kLog2e;  // scores kept in the log2 domain
  float oacc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // per-lane ldmatrix row addresses (see the fragment layouts of mma)
  const __nv_bfloat16* qa_row = qs + (warp * 16 + (lane & 15)) * kLd +
                                (lane >> 4) * 8;
  const int kb_off = ((lane >> 4) * 8 + (lane & 7)) * kLd +
                     ((lane >> 3) & 1) * 8;
  const int vb_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                     (lane >> 4) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const long long t0 = t_first + static_cast<long long>(it) * kBK;
    if (it + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const int nb = (it + 1) & 1;
      stage_async<__nv_bfloat16, DH>(kbuf + nb * kBK * kLd, kLd, kb, p.kss,
                                     t0 + kBK, kBK, p.skv);
      stage_async<__nv_bfloat16, DH>(vbuf + nb * kBK * kLd, kLd, vb, p.vss,
                                     t0 + kBK, kBK, p.skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    const __nv_bfloat16* ks = kbuf + (it & 1) * kBK * kLd;
    const __nv_bfloat16* vs = vbuf + (it & 1) * kBK * kLd;

    // S = Q K^T for this warp's 16 rows and the tile's kBK keys
    float sacc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa_row + kk * 16);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, ks + n * 8 * kLd + kb_off + kk * 16);
        mma_bf16(sacc[n], a, b[0], b[1]);
        mma_bf16(sacc[n + 1], a, b[2], b[3]);
      }
    }

    // mask (only a tile that the mask cuts for some row of the block),
    // scale, and the online softmax over the tile
    const bool whole = t0 + kBK <= p.skv &&
                       (!p.causal || t0 + kBK - 1 <= q0) &&
                       t0 > q0 + kMmaBQ - 1 - p.window;
    float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kv = t0 + n * 8 + 2 * tig + (e & 1);
        const bool ok = whole || key_valid(p, e < 2 ? qi0 : qi1, kv);
        sacc[n][e] = ok ? sacc[n][e] * sl2 : kNegInf;
      }
      mt0 = fmaxf(mt0, fmaxf(sacc[n][0], sacc[n][1]));
      mt1 = fmaxf(mt1, fmaxf(sacc[n][2], sacc[n][3]));
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, d));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, d));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sacc[n][e];
        const float pe =
            s == kNegInf ? 0.f : exp2_approx(s - (e < 2 ? mn0 : mn1));
        sacc[n][e] = pe;
        if (e < 2) {
          ps0 += pe;
        } else {
          ps1 += pe;
        }
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    // rescale the accumulator only when a row's max moved in this warp
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        oacc[n][0] *= al0;
        oacc[n][1] *= al0;
        oacc[n][2] *= al1;
        oacc[n][3] *= al1;
      }
    }

    // O += P V: P (16 x kBK) in registers as the A operand, V's B
    // fragments by transposing loads
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * j][0], sacc[2 * j][1]);
      a[1] = pack_bf16(sacc[2 * j][2], sacc[2 * j][3]);
      a[2] = pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]);
      a[3] = pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < kND; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + j * 16 * kLd + vb_off + n * 8);
        mma_bf16(oacc[n], a, b[0], b[1]);
        mma_bf16(oacc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // all reads of this buffer done before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + bb * p.osb + hh * p.osh + 2 * tig;
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    if (qi0 < p.sq) {
      *reinterpret_cast<uint32_t*>(ob + qi0 * p.oss + n * 8) =
          pack_bf16(oacc[n][0] * inv0, oacc[n][1] * inv0);
    }
    if (qi1 < p.sq) {
      *reinterpret_cast<uint32_t*>(ob + qi1 * p.oss + n * 8) =
          pack_bf16(oacc[n][2] * inv1, oacc[n][3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at dh 64, 128 and 256: wgmma on TMA-fed tiles, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWsThreads = 384;  // a producer warpgroup and two consumers
constexpr int kWsRows = 64;      // query rows of a consumer warpgroup
constexpr int kWsStages = 2;     // K/V ring depth

template <int DH>
struct WsTile {
  static constexpr int kBK = DH == 256 ? 64 : 128;  // keys per kv tile
  static constexpr int kCB = DH / 64;  // 128-byte column blocks of a row
  static constexpr int kQBytes = kWsRows * DH * 2;  // one consumer's Q
  static constexpr int kKVBytes = kBK * DH * 2;     // one K or V tile
  // Q of both consumers, the K ring, the V ring, then the mbarriers; a
  // kilobyte of slack aligns the tiles to the swizzle's 1024 bytes
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kWsStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOffset + 128 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map (dh, position, head, batch) into shared
// memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma operand descriptor for a tile laid out as TMA's 128-byte swizzle
// writes it: rows of 128 bytes, 8-row atoms of 1024 bytes (SBO); `lbo` is
// the step between 64-element column blocks for an MN-major operand
// (ignored for a K-major one).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), A and B bf16 in shared
// memory, both K-major, given by their descriptors; D is overwritten
// where scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128), A and B bf16 in shared
// memory, both K-major, given by their descriptors; D is overwritten
// where scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16) * B (16 x 64): A bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B bf16 in shared memory,
// MN-major (transposed), given by its descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) * B (16 x 128): A bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B bf16 in shared memory,
// MN-major (transposed), given by its descriptor.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16) * B (16 x 256): A bf16 in registers (the
// m16n8k16 A fragment of each warp's 16 rows), B bf16 in shared memory,
// MN-major (transposed), given by its descriptor.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// kPair: the two consumers take the same 64 rows of the two query heads
// 2y and 2y + 1 of blockIdx.y = y (one KV head when rep is even), else
// 128 consecutive rows of query head y.
template <int DH, bool kPair>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_ws_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using Tile = WsTile<DH>;
  constexpr int kBK = Tile::kBK, kCB = Tile::kCB;
  constexpr int kRows = kPair ? kWsRows : 2 * kWsRows;  // rows per block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + 2 * Tile::kQBytes;
  const uint32_t s_v = s_k + kWsStages * Tile::kKVBytes;
  const uint32_t bar_q = s_q + Tile::kBarOffset;
  const uint32_t bar_kfull = bar_q + 8, bar_vfull = bar_kfull + 8 * kWsStages;
  const uint32_t bar_kfree = bar_vfull + 8 * kWsStages;
  const uint32_t bar_vfree = bar_kfree + 8 * kWsStages;

  const long long q0 = (gridDim.x - 1 - blockIdx.x) * static_cast<long long>(
                           kRows);  // longest rows first
  const int bb = blockIdx.z;
  const int head0 = kPair ? 2 * blockIdx.y : blockIdx.y;
  const int g = head0 / (p.h / p.hkv);
  long long lo, hi;
  kv_range(p, q0, kRows, &lo, &hi);
  const long long t_first = (lo / kBK) * kBK;
  const int ntiles =
      t_first < hi ? static_cast<int>((hi - t_first + kBK - 1) / kBK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(bar_kfull + 8 * s, 1);
      mbar_init(bar_vfull + 8 * s, 1);
      mbar_init(bar_kfree + 8 * s, 2 * kWsRows * 2);  // every consumer
      mbar_init(bar_vfree + 8 * s, 2 * kWsRows * 2);  // thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * Tile::kQBytes);
      for (int c = 0; c < 2; ++c) {
        const int row = static_cast<int>(q0 + (kPair ? 0 : kWsRows * c));
        for (int cb = 0; cb < kCB; ++cb) {
          tma_load_4d(s_q + c * Tile::kQBytes + cb * kWsRows * 128, &tq,
                      bar_q, cb * 64, row, head0 + (kPair ? c : 0), bb);
        }
      }
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % kWsStages;
        const uint32_t free_parity = ((it / kWsStages) & 1) ^ 1;
        const int t0 = static_cast<int>(t_first + it * kBK);
        if (it >= kWsStages) mbar_wait(bar_kfree + 8 * st, free_parity);
        mbar_expect_tx(bar_kfull + 8 * st, Tile::kKVBytes);
        for (int cb = 0; cb < kCB; ++cb) {
          tma_load_4d(s_k + st * Tile::kKVBytes + cb * kBK * 128, &tk,
                      bar_kfull + 8 * st, cb * 64, t0, g, bb);
        }
        if (it >= kWsStages) mbar_wait(bar_vfree + 8 * st, free_parity);
        mbar_expect_tx(bar_vfull + 8 * st, Tile::kKVBytes);
        for (int cb = 0; cb < kCB; ++cb) {
          tma_load_4d(s_v + st * Tile::kKVBytes + cb * kBK * 128, &tv,
                      bar_vfull + 8 * st, cb * 64, t0, g, bb);
        }
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int hh = head0 + (kPair ? c : 0);
    const long long qr0 = q0 + (kPair ? 0 : kWsRows * c);
    const long long row0 = qr0 + warp * 16 + gid, row1 = row0 + 8;
    long long wlo, whi;
    kv_range(p, qr0, kWsRows, &wlo, &whi);
    const bool live = qr0 < p.sq;
    const float sl2 = p.scale * kLog2e;  // scores to the log2 domain
    const uint32_t qs = s_q + c * Tile::kQBytes;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);

    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kWsStages;
      const uint32_t full_parity = (it / kWsStages) & 1;
      const long long t0 = t_first + static_cast<long long>(it) * kBK;
      // a tile the mask empties for these 64 rows is waited for and
      // released, never computed
      const bool work = live && t0 < whi && t0 + kBK > wlo;
      float sacc[kBK / 2];
      uint32_t pa[kBK / 16][4];

      mbar_wait(bar_kfull + 8 * st, full_parity);
      if (work) {
        // S = Q K^T over dh in steps of 16: +32 bytes inside a column
        // block, the next block after four steps
        const uint32_t ks = s_k + st * Tile::kKVBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t col = (kk & 3) * 32;
          wgmma_ss<kBK>(
              sacc, desc_sw128(qs + (kk >> 2) * kWsRows * 128 + col, 16),
              desc_sw128(ks + (kk >> 2) * kBK * 128 + col, 16), kk > 0);
        }
        wgmma_commit_wait();
        fence_regs(sacc);
      }
      mbar_arrive(bar_kfree + 8 * st);

      if (work) {
        // mask only a tile that the mask cuts for some row
        const bool whole = t0 + kBK <= p.skv &&
                           (!p.causal || t0 + kBK - 1 <= qr0) &&
                           t0 > qr0 + kWsRows - 1 - p.window;
        if (!whole) {
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const long long kv = t0 + j * 8 + 2 * tig + (e & 1);
              if (!key_valid(p, e < 2 ? row0 : row1, kv)) {
                sacc[4 * j + e] = -INFINITY;
              }
            }
          }
        }
        float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mt0 = fmaxf(mt0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
          mt1 = fmaxf(mt1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
#pragma unroll
        for (int d = 1; d < 4; d <<= 1) {
          mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, d));
          mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, d));
        }
        const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
        // a row with no valid key so far keeps 0 as its reference, so
        // exp2(-inf - ref) gives 0, never NaN
        const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * sl2;
        const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * sl2;
        const float al0 = m0 == mn0 ? 1.f : exp2_approx(fmaf(m0, sl2, -ms0));
        const float al1 = m1 == mn1 ? 1.f : exp2_approx(fmaf(m1, sl2, -ms1));
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe =
                exp2_approx(fmaf(sacc[4 * j + e], sl2, e < 2 ? -ms0 : -ms1));
            sacc[4 * j + e] = pe;
            if (e < 2) {
              ps0 += pe;
            } else {
              ps1 += pe;
            }
          }
        }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
        // rescale O only when a row's max moved in this warp
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) {
            o[4 * j] *= al0;
            o[4 * j + 1] *= al0;
            o[4 * j + 2] *= al1;
            o[4 * j + 3] *= al1;
          }
        }
        // P in bf16 as the A fragments of P V, 16 keys each
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
      }

      mbar_wait(bar_vfull + 8 * st, full_parity);
      if (work) {
        // O += P V over the tile's keys in steps of 16 (two 8-row atoms)
        const uint32_t vs = s_v + st * Tile::kKVBytes;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_rs<DH>(o, pa[kk], desc_sw128(vs + kk * 16 * 128, kBK * 128));
        }
        wgmma_commit_wait();
        fence_regs(o);
      }
      mbar_arrive(bar_vfree + 8 * st);
    }

#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, d);
      l1 += __shfl_xor_sync(0xffffffffu, l1, d);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob =
        static_cast<__nv_bfloat16*>(p.o) + bb * p.osb + hh * p.osh + 2 * tig;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (row0 < p.sq) {
        *reinterpret_cast<uint32_t*>(ob + row0 * p.oss + j * 8) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      }
      if (row1 < p.sq) {
        *reinterpret_cast<uint32_t*>(ob + row1 * p.oss + j * 8) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Rows = 2;                     // query rows per warp
constexpr int kF32BQ = kF32Warps * kF32Rows;    // query rows per block
constexpr int kF32BK = 32;                      // keys per kv tile

template <int DH>
__global__ void __launch_bounds__(kF32Warps * 32)
    flash_f32_kernel(const Params p) {
  constexpr int kE = DH / 32;  // dh elements per lane: d = e * 32 + lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kF32BK * DH;

  const long long qt = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int g = hh / (p.h / p.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q0 = qt * kF32BQ;
  const float* qb = static_cast<const float*>(p.q) + bb * p.qsb + hh * p.qsh;
  const float* kb = static_cast<const float*>(p.k) + bb * p.ksb + g * p.ksh;
  const float* vb = static_cast<const float*>(p.v) + bb * p.vsb + g * p.vsh;

  float qr[kF32Rows][kE], acc[kF32Rows][kE], m[kF32Rows], l[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const long long qi = q0 + warp * kF32Rows + r;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      qr[r][e] = qi < p.sq ? qb[qi * p.qss + e * 32 + lane] * p.scale : 0.f;
      acc[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  long long lo, hi;
  kv_range(p, q0, kF32BQ, &lo, &hi);
  for (long long t0 = (lo / kF32BK) * kF32BK; t0 < hi; t0 += kF32BK) {
    __syncthreads();
    stage_async<float, DH>(ks, DH, kb, p.kss, t0, kF32BK, p.skv);
    stage_async<float, DH>(vs, DH, vb, p.vss, t0, kF32BK, p.skv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const long long qi = q0 + warp * kF32Rows + r;
      float s[kF32BK];
      unsigned valid = 0u;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kF32BK; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          part = fmaf(qr[r][e], ks[j * DH + e * 32 + lane], part);
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, d);
        }
        const bool ok = key_valid(p, qi, t0 + j);
        valid |= unsigned(ok) << j;
        s[j] = ok ? part : kNegInf;
        mt = fmaxf(mt, s[j]);
      }
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kF32BK; ++j) {
        const float pe = (valid >> j) & 1u ? expf(s[j] - mn) : 0.f;
        psum += pe;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[r][e] = fmaf(pe, vs[j * DH + e * 32 + lane], acc[r][e]);
        }
      }
      l[r] = l[r] * alpha + psum;
      m[r] = mn;
    }
  }

  float* ob = static_cast<float*>(p.o) + bb * p.osb + hh * p.osh;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const long long qi = q0 + warp * kF32Rows + r;
    if (qi < p.sq) {
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        ob[qi * p.oss + e * 32 + lane] = acc[r][e] / den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, once per device (so a launch inside a CUDA-graph capture makes
// no attribute call).
template <typename K>
void allow_smem(K* kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices || !done[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// A bf16 operand (B, heads, positions, dh) by its element strides, as the
// 4-d tensor map (dh, position, head, batch) that TMA reads in boxes of 64
// columns by `rows` positions, 128-byte swizzled, zeros past the ends.  A
// dimension of one element takes any stride.
bool tensor_map(CUtensorMap* map, const void* base, long long dh,
                long long s, long long heads, long long b, long long ss,
                long long sh, long long sb, int rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  auto bytes = [dh](long long stride, long long n) {
    return static_cast<cuuint64_t>(n > 1 ? 2 * stride : 2 * dh);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {bytes(ss, s), bytes(sh, heads), bytes(sb, b)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, bool kPair>
int launch_ws(const Params& p, long long b, cudaStream_t st) {
  using Tile = WsTile<DH>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, DH, p.sq, p.h, b, p.qss, p.qsh, p.qsb, kWsRows) ||
      !tensor_map(&tk, p.k, DH, p.skv, p.hkv, b, p.kss, p.ksh, p.ksb,
                  Tile::kBK) ||
      !tensor_map(&tv, p.v, DH, p.skv, p.hkv, b, p.vss, p.vsh, p.vsb,
                  Tile::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int rows = kPair ? kWsRows : 2 * kWsRows;
  const dim3 grid(static_cast<unsigned>((p.sq + rows - 1) / rows),
                  static_cast<unsigned>(kPair ? p.h / 2 : p.h),
                  static_cast<unsigned>(b));
  static bool done[kMaxDevices] = {};
  allow_smem(flash_ws_kernel<DH, kPair>, Tile::kSmemBytes, done);
  flash_ws_kernel<DH, kPair>
      <<<grid, kWsThreads, Tile::kSmemBytes, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Params& p, long long b, bool bf16, cudaStream_t st) {
  if (bf16) {
    if constexpr (DH >= 64) {
      return (p.h / p.hkv) % 2 == 0 ? launch_ws<DH, true>(p, b, st)
                                    : launch_ws<DH, false>(p, b, st);
    } else {
      const dim3 grid(static_cast<unsigned>((p.sq + kMmaBQ - 1) / kMmaBQ),
                      static_cast<unsigned>(p.h), static_cast<unsigned>(b));
      static bool done[kMaxDevices] = {};
      const int smem = MmaTile<DH>::kSmemBytes;
      allow_smem(flash_mma_kernel<DH>, smem, done);
      flash_mma_kernel<DH><<<grid, kMmaWarps * 32, smem, st>>>(p);
    }
  } else {
    const dim3 grid(static_cast<unsigned>((p.sq + kF32BQ - 1) / kF32BQ),
                    static_cast<unsigned>(p.h), static_cast<unsigned>(b));
    static bool done[kMaxDevices] = {};
    const int smem = 2 * kF32BK * DH * 4;
    allow_smem(flash_f32_kernel<DH>, smem, done);
    flash_f32_kernel<DH><<<grid, kF32Warps * 32, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o,
           long long b, long long h, long long hkv, long long sq,
           long long skv, long long dh, long long qsb, long long qsh,
           long long qss, long long ksb, long long ksh, long long kss,
           long long vsb, long long vsh, long long vss, long long osb,
           long long osh, long long oss, long long causal, long long window,
           bool bf16, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || skv < 1 ||
      b > 65535 || h > 65535 || window < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,   k,   v,   o,   sq,  skv, static_cast<int>(h),
           static_cast<int>(hkv), qsb, qsh, qss, ksb, ksh, kss,
           vsb, vsh, vss, osb, osh, oss, static_cast<int>(causal != 0),
           window,
           static_cast<float>(1.0 / sqrt(static_cast<double>(dh)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch_dh<32>(p, b, bf16, st);
    case 64:
      return launch_dh<64>(p, b, bf16, st);
    case 128:
      return launch_dh<128>(p, b, bf16, st);
    case 256:
      return launch_dh<256>(p, b, bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define FLASH_ENTRY(name, is_bf16)                                          \
  extern "C" int name(const void* q, const void* k, const void* v, void* o, \
                      long long b, long long h, long long hkv, long long sq, \
                      long long skv, long long dh, long long qsb,            \
                      long long qsh, long long qss, long long ksb,           \
                      long long ksh, long long kss, long long vsb,           \
                      long long vsh, long long vss, long long osb,           \
                      long long osh, long long oss, long long causal,        \
                      long long window, void* stream) {                     \
    return launch(q, k, v, o, b, h, hkv, sq, skv, dh, qsb, qsh, qss, ksb,   \
                  ksh, kss, vsb, vsh, vss, osb, osh, oss, causal, window,    \
                  is_bf16, stream);                                         \
  }

FLASH_ENTRY(flash_attention_f32, false)
FLASH_ENTRY(flash_attention_bf16, true)
