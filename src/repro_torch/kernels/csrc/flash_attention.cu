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
// block owns one (b, h, q tile) and loops over the kv tiles itself, and
// the tiles that the mask empties whole (above the causal diagonal, before
// the window) are never visited.
//
// What bounds it on this card.  At gemma3-4b's prefill shape (4, 8, 4096,
// 256) bf16 a global layer needs 4 * B * H * (S^2 / 2) * dh = 275 GFLOP of
// products (0.28 ms at the 989 TFLOP/s dense bf16 tensor peak) against
// 84 MB of q, k, v and o (0.025 ms at 3.35 TB/s): the tensor cores bound
// it.
//
// Two programs behind one entry point per dtype:
//   * bf16 (the model's path): four warps per block, each owning 16 query
//     rows of a 64-row tile.  Q K^T and P V run on the tensor cores through
//     mma.sync m16n8k16 (bf16 operands, f32 accumulation); the scores stay
//     in registers in the accumulator layout, the row max and sum-exp are
//     reduced over the four lanes that share a row, and P is rounded to
//     bf16 in registers as the A operand of P V (the Pallas kernel keeps P
//     in f32; the reference model path rounds the normalised P to bf16).
//     The output accumulator (16 x dh per warp) stays in registers for the
//     whole kv loop.  Q, K and V tiles reach shared memory by cp.async,
//     the K/V tiles double-buffered (tile i + 1 loads while tile i is
//     computed), in rows padded by 16 bytes, and the fragments are read
//     with ldmatrix (V's transposed), so they hit distinct banks.  TMA,
//     wgmma and warp specialisation are later work.
//   * f32: plain f32 arithmetic on the CUDA cores, no TF32 (the reference
//     test's f32 tolerance is 2e-6).  Each warp owns 2 query rows, lanes
//     split dh, and K and V tiles are staged in shared memory as f32.
// dh is a template parameter (32, 64, 128 or 256); any other is refused.
// Any Sq, Skv, B, H and Hkv dividing H are taken: rows and keys past the
// ends are masked in the kernel.  The window is a runtime value, so one
// compiled program serves every layer.
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
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block

template <int DH>
struct MmaTile {
  static constexpr int kBK = DH >= 256 ? 32 : 64;  // keys per kv tile
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

template <int DH>
int launch_dh(const Params& p, long long b, bool bf16, cudaStream_t st) {
  const int bq = bf16 ? kMmaBQ : kF32BQ;
  const dim3 grid(static_cast<unsigned>((p.sq + bq - 1) / bq),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  if (bf16) {
    static bool done[kMaxDevices] = {};
    const int smem = MmaTile<DH>::kSmemBytes;
    allow_smem(flash_mma_kernel<DH>, smem, done);
    flash_mma_kernel<DH><<<grid, kMmaWarps * 32, smem, st>>>(p);
  } else {
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
