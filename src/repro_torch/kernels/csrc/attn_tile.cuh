// Tile walk of the two prefill kernels (flash_prefill.cu, B2, and
// paged_prefix.cu, B3): swizzled shared-memory tiles filled by cp.async,
// the two tile products, and the online-softmax step between them, so the
// two designs share one arithmetic.
//
// A block of kWarps = 4 warps owns 64 MT query rows; warp w owns MT row
// tiles of 16 (rows 16 MT w .. 16 MT w + 16 MT - 1).  With MT = 2 every
// K/V fragment loaded from shared memory feeds two MMAs, at twice the
// accumulator registers; each kernel picks MT and the keys per K/V tile,
// BK, for its shapes (at head_dim 256 one row tile's f32 accumulator is
// already 128 registers a thread).  Scores and the accumulator live in
// registers in the layout of an m16n8k16 MMA accumulator: lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of each of its row
// tiles, columns 8 j + 2 t and 8 j + 2 t + 1 of every 8-wide column
// tile j.  Q stays in shared memory and is read as A fragments per tile.
//
// bf16 inputs run on the tensor cores (mma.sync m16n8k16, f32
// accumulation): S = Q K^T on bf16 operands is exact up to summation
// order; for P V the f32 probabilities are split into P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), two MMAs into one f32 accumulator, which keeps
// about 16 mantissa bits of P (rounding P to one bf16 would cost the 1e-4
// parity with the f32 plain versions).  f32 inputs (the tests' dtype)
// take the same tile walk with both products on the FMA units; only the
// two products differ between the instantiations.
//
// Shared-memory tiles are rows of 16-byte chunks; chunk c of row r sits at
// chunk c ^ (r % 8), so the eight rows an ldmatrix phase reads fall in
// eight different bank groups.  Chunks past the head_dim D and rows with
// nothing to read are zero-filled by cp.async (src-size 0), so padded
// rows never feed NaN into a product.
#pragma once

#include "common.cuh"

namespace repro {
namespace tile {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;


// Swizzled tile of rows of DP elements of T.
template <typename T, int DP>
struct Layout {
  static constexpr int kEpc = 16 / sizeof(T);   // elements per chunk
  static constexpr int kCh = DP / kEpc;         // chunks per row
  static_assert(kCh % 8 == 0, "the swizzle needs 8 chunks per row");
  __device__ static __forceinline__ int at(int r, int c) {
    return (r * kCh + (c ^ (r & 7))) * kEpc;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with ok false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b: a 16x16 row-major bf16 A fragment, b one 16x8 column-major
// bf16 B fragment (two registers), c the f32 accumulator fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair (x in the low half), and the residuals
// x - bf16(x), y - bf16(y) as a second pair.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Issue the copies of ROWS rows of K and V into two swizzled tiles: row r
// of both from element offset off(r) of k / v (off(r) < 0: zero-filled,
// nothing read).  Chunks at or past D are zero-filled.  All kThreads
// threads take part; the caller commits the group.
template <typename T, int DP, int ROWS, typename Off>
__device__ __forceinline__ void load_rows(T* __restrict__ ks,
                                          T* __restrict__ vs,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v, int D,
                                          Off off) {
  using L = Layout<T, DP>;
  static_assert((ROWS * L::kCh) % kThreads == 0, "whole copy rounds");
#pragma unroll
  for (int it = 0; it < ROWS * L::kCh / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / L::kCh, c = i % L::kCh;
    const long long o = off(r);
    const bool ok = o >= 0 && c * L::kEpc < D;
    const long long src = ok ? o + c * L::kEpc : 0;
    cp_async16(ks + L::at(r, c), k + src, ok);
    if (vs != nullptr) cp_async16(vs + L::at(r, c), v + src, ok);
  }
}

// One warp's share of the online softmax over a block's key tiles: MT row
// tiles of 16 query rows, BK keys per tile, head_dim padded to DP.  With
// kSharedRows every warp takes the block's first 16 MT rows (bf16 only:
// B4's walk gives each warp its own keys of one row tile instead).
template <typename T, int DP, int BK, int MT, bool kSharedRows = false>
struct WarpAttn {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kMma || !kSharedRows, "shared rows need the MMA path");
  using Elem = T;
  static constexpr int kBk = BK, kMt = MT, kDp = DP;
  static constexpr int kRows = kWarps * 16 * MT;   // query rows per block
  static constexpr int kNt = BK / 8;   // key column tiles
  static constexpr int kDt = DP / 8;   // head-dim column tiles
  using L = Layout<T, DP>;
  using Scores = float[MT][kNt][4];

  float o[MT][kDt][4];
  float m[MT][2], l[MT][2];   // rows g, g + 8 of each row tile (l: this
                              // lane's share until finish)

  // The warp's first row in the block.
  __device__ static __forceinline__ int warp_row() {
    return kSharedRows ? 0 : (threadIdx.x / 32) * 16 * MT;
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < kDt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
      m[mt][0] = m[mt][1] = NEG_INF;
      l[mt][0] = l[mt][1] = 0.f;
    }
  }

  // s = Q K^T for the warp's rows against the tile's BK keys (unscaled).
  __device__ __forceinline__ void scores(Scores& s, const T* qs,
                                         const T* ks) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // A fragments of head dims 16 kk .. +15 of each row tile
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], qs + L::at(warp_row() + 16 * mt + lane % 16,
                                    2 * kk + lane / 16));
#pragma unroll
        for (int jj = 0; jj < kNt / 2; ++jj) {
          // keys 16 jj .. +15: matrices (keys 0-7 | 8-15) x (dims lo | hi)
          uint32_t b[4];
          ldsm_x4(b, ks + L::at(16 * jj + lane % 8 + 8 * (lane / 16),
                                2 * kk + (lane / 8) % 2));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jj], a[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * jj + 1], a[mt], b[2], b[3]);
          }
        }
      }
    } else {
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = warp_row() + 16 * mt + g;
#pragma unroll 1
        for (int c = 0; c < L::kCh; ++c) {
          const float4 qa =
              *reinterpret_cast<const float4*>(qs + L::at(r0, c));
          const float4 qb =
              *reinterpret_cast<const float4*>(qs + L::at(r0 + 8, c));
#pragma unroll
          for (int j = 0; j < kNt; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float4 kx = *reinterpret_cast<const float4*>(
                  ks + L::at(8 * j + 2 * t + e, c));
              s[mt][j][e] +=
                  qa.x * kx.x + qa.y * kx.y + qa.z * kx.z + qa.w * kx.w;
              s[mt][j][2 + e] +=
                  qb.x * kx.x + qb.y * kx.y + qb.z * kx.z + qb.w * kx.w;
            }
        }
      }
    }
  }

  // The online-softmax step: scale, soft cap, then the mask (vis(mt, rr,
  // key): row g + 8 rr of row tile mt sees tile key `key`; with `full`
  // every key is visible to every row of the warp and vis is not asked);
  // masked scores take NEG_INF and their p is 0.  Leaves p in s and
  // rescales the accumulator.  The branches on the cap and on `full` are
  // uniform across the warp and taken once per tile.
  template <typename Vis>
  __device__ __forceinline__ void softmax(Scores& s, float scale,
                                          float soft_cap, bool full,
                                          Vis vis) {
    if (soft_cap > 0.f) {
      if (full)
        step<true, true>(s, scale, soft_cap, vis);
      else
        step<true, false>(s, scale, soft_cap, vis);
    } else {
      if (full)
        step<false, true>(s, scale, soft_cap, vis);
      else
        step<false, false>(s, scale, soft_cap, vis);
    }
  }

  template <bool kCap, bool kFull, typename Vis>
  __device__ __forceinline__ void step(Scores& s, float scale,
                                       float soft_cap, Vis vis) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale;
          if constexpr (kCap) x = tanhf(x / soft_cap) * soft_cap;
          if constexpr (!kFull)
            x = vis(mt, e >> 1, 8 * j + 2 * t + (e & 1)) ? x : NEG_INF;
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
      bool none[2];   // the row has seen no visible key yet
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[mt][rr], mx[rr]);
        alpha[rr] = __expf(m[mt][rr] - m_new);
        m[mt][rr] = m_new;
        none[rr] = m_new == NEG_INF;
      }
      // A masked score is NEG_INF, so exp(score - m) is exactly 0 once the
      // row has a finite max; a row with none yet has all its scores
      // masked (exp(0) = 1 there) and gets p = 0 explicitly.
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = __expf(s[mt][j][e] - m[mt][e >> 1]);
          if constexpr (!kFull) p = none[e >> 1] ? 0.f : p;
          s[mt][j][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        l[mt][rr] = alpha[rr] * l[mt][rr] + sum[rr];
#pragma unroll
      for (int n = 0; n < kDt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[e >> 1];
    }
  }

  // o += P V over the tile's BK keys.  f32 goes through this warp's
  // (16 MT, BK) slice of the P scratch (p_scratch_floats).
  __device__ __forceinline__ void pv(const Scores& p, const T* vs,
                                     float* p_scratch) {
    const int lane = threadIdx.x % 32;
    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A fragments of keys 16 kk .. +15 from score tiles 2 kk, 2 kk + 1
        uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1], hi[mt][0],
                     lo[mt][0]);
          split_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3], hi[mt][1],
                     lo[mt][1]);
          split_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1], hi[mt][2],
                     lo[mt][2]);
          split_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3], hi[mt][3],
                     lo[mt][3]);
        }
#pragma unroll
        for (int nn = 0; nn < kDt / 2; ++nn) {
          // transposed: matrices (keys 0-7 | 8-15) x (dims 16 nn | +8)
          uint32_t b[4];
          ldsm_x4_t(b, vs + L::at(16 * kk + lane % 8 + 8 * ((lane / 8) % 2),
                                  2 * nn + lane / 16));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * nn], hi[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * nn], lo[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * nn + 1], hi[mt], b[2], b[3]);
            mma_bf16(o[mt][2 * nn + 1], lo[mt], b[2], b[3]);
          }
        }
      }
    } else {
      const int g = lane / 4, t = lane % 4;
      float* pw = p_scratch + warp_row() * BK;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pw[(16 * mt + g + 8 * (e >> 1)) * BK + 8 * j + 2 * t + (e & 1)] =
                p[mt][j][e];
      __syncwarp();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p0 = pw + (16 * mt + g) * BK;
        const float* p1 = p0 + 8 * BK;
#pragma unroll 1
        for (int key = 0; key < BK; ++key) {
#pragma unroll
          for (int n = 0; n < kDt; ++n) {
            const float2 vx = *reinterpret_cast<const float2*>(
                vs + L::at(key, 2 * n + t / 2) + 2 * (t % 2));
            o[mt][n][0] += p0[key] * vx.x;
            o[mt][n][1] += p0[key] * vx.y;
            o[mt][n][2] += p1[key] * vx.x;
            o[mt][n][3] += p1[key] * vx.y;
          }
        }
      }
      __syncwarp();   // pw is rewritten by the next tile
    }
  }

  // Sum l over the four lanes that share a row.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[mt][rr] += __shfl_xor_sync(0xffffffffu, l[mt][rr], 1);
        l[mt][rr] += __shfl_xor_sync(0xffffffffu, l[mt][rr], 2);
      }
  }

  // Write row g + 8 rr of row tile mt: the f32 partial (o, l, m) or, with
  // out non-null, o / max(l, 1e-30) in T.  `row` is the row's index into
  // (rows, D) outputs and (rows,) l / m.
  __device__ __forceinline__ void store(int mt, int rr, size_t row, int D,
                                        float* __restrict__ o_part,
                                        float* __restrict__ l_out,
                                        float* __restrict__ m_out,
                                        T* __restrict__ out) const {
    const int t = threadIdx.x % 4;
    const float(&om)[kDt][4] = o[mt];
    if (out != nullptr) {
      const float den = fmaxf(l[mt][rr], 1e-30f);
#pragma unroll
      for (int n = 0; n < kDt; ++n) {
        const int d = 8 * n + 2 * t;
        if (d >= D) break;
        if constexpr (kMma) {
          *reinterpret_cast<__nv_bfloat162*>(out + row * D + d) =
              __floats2bfloat162_rn(om[n][2 * rr] / den,
                                    om[n][2 * rr + 1] / den);
        } else {
          *reinterpret_cast<float2*>(out + row * D + d) =
              make_float2(om[n][2 * rr] / den, om[n][2 * rr + 1] / den);
        }
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < kDt; ++n) {
      const int d = 8 * n + 2 * t;
      if (d >= D) break;
      *reinterpret_cast<float2*>(o_part + row * D + d) =
          make_float2(om[n][2 * rr], om[n][2 * rr + 1]);
    }
    if (t == 0) {
      l_out[row] = l[mt][rr];
      m_out[row] = m[mt][rr];
    }
  }
};

// Dynamic shared memory of a block of WA = WarpAttn<T, DP, BK, MT>: the
// Q tile, two K/V stages, and for f32 inputs a scratch for P between the
// two FMA products, in that order.
template <typename WA>
__host__ __device__ constexpr int p_scratch_floats() {
  return WA::kMma ? 0 : WA::kRows * WA::kBk;
}

template <typename WA>
constexpr size_t tile_smem() {
  return (static_cast<size_t>(WA::kRows) + 4 * WA::kBk) * WA::kDp *
             sizeof(typename WA::Elem) +
         p_scratch_floats<WA>() * sizeof(float);
}

}  // namespace tile

// Whether every pointer is 16-byte aligned (the cp.async copies need it).
inline bool aligned16() { return true; }
template <typename... P>
inline bool aligned16(const void* p, P... rest) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && aligned16(rest...);
}

}  // namespace repro
