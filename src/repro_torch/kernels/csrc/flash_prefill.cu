// Causal GQA flash attention for prefill, with sliding window, soft cap and
// a query position offset; writes the normalized output or the
// unnormalized (o, l, m) partials of chunked prefill's in-flight suffix.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (_flash_kernel / flash_prefill).  The TPU kernel walks the KV blocks as
// a sequential grid axis with (m, l, acc) carried in VMEM scratch; here
// one block owns (sequence, head, 32-query tile) and loops over 32-key
// tiles itself, with the online softmax state in registers: TPR threads
// per query row, each holding 16 of the row's D dimensions of q and of the
// accumulator (dimension d belongs to thread d % TPR, so a row's threads
// read adjacent shared-memory words).  TPR = 4, 8 or 16 covers D <= 64,
// 128 or 256.  GQA goes through h / G in the K/V offsets; key tiles wholly
// in the future of the query tile (or before its window) are skipped,
// which leaves the result unchanged: a fully masked tile scales the
// running state by exp(0) = 1 and adds nothing.
//
// Bound on the H100: flops at long sequences (4 * S^2 / 2 * D per head
// against 4 * S * D bytes), bytes only for short chunks.  This first design
// runs on the FMA units with K/V tiles staged in shared memory as f32, far
// from the tensor cores' rate; mma.sync / wgmma tiles are later work.
#include "common.cuh"

namespace repro {

constexpr int kBQ = 32;                  // query rows per block
constexpr int kBK = 32;                  // keys per shared-memory tile
constexpr int kDPT = 16;                 // dimensions per thread

// q: (B, S, H, D); k, v: (B, L, KV, D).  Queries sit at positions
// seq_offset + r of the key axis.  partials: o_part (B, S, H, D) f32 and
// l, m (B, S, H) f32; otherwise out (B, S, H, D) in T.
template <typename T, int TPR>
__global__ void __launch_bounds__(kBQ * TPR)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ o_part,
             float* __restrict__ l_out, float* __restrict__ m_out,
             T* __restrict__ out, int S, int L, int H, int KV, int D,
             int seq_offset, float scale, int window, float soft_cap,
             int partials) {
  extern __shared__ float smem[];
  float* ks = smem;              // (kBK, D)
  float* vs = ks + kBK * D;      // (kBK, D)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int r = qt * kBQ + tid / TPR;
  const bool row_ok = r < S;
  const int pq = seq_offset + r;

  float qr[kDPT], acc[kDPT];
  const T* qrow =
      q + ((static_cast<size_t>(b) * S + (row_ok ? r : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = part + TPR * i;
    qr[i] = (row_ok && d < D) ? to_f32(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m_run = NEG_INF, l_run = 0.f;

  // keys the tile's queries can see: causal end, window start
  const int r_last = min(qt * kBQ + kBQ, S) - 1;
  const int k_end = min(L, seq_offset + r_last + 1);
  int k_begin = 0;
  if (window > 0) {
    k_begin = max(0, seq_offset + qt * kBQ - window + 1);
    k_begin -= k_begin % kBK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile has been consumed
    for (int i = tid; i < kBK * D; i += kBQ * TPR) {
      const int t = i / D, d = i - t * D;
      const int kk = k0 + t;
      float kx = 0.f, vx = 0.f;
      if (kk < L) {
        const size_t src = ((static_cast<size_t>(b) * L + kk) * KV + kvh) * D + d;
        kx = to_f32(k[src]);
        vx = to_f32(v[src]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    float sc[kBK];
    float mt = NEG_INF;
#pragma unroll
    for (int t = 0; t < kBK; ++t) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kDPT; ++i) {
        const int d = part + TPR * i;
        if (d < D) a += qr[i] * ks[t * D + d];
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      a = cap_score(a * scale, soft_cap);
      const int kk = k0 + t;
      sc[t] = (kk < L && key_visible(kk, pq, window)) ? a : NEG_INF;
      mt = fmaxf(mt, sc[t]);
    }
    const float m_new = fmaxf(m_run, mt);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kBK; ++t) {
      const int kk = k0 + t;
      // p is zeroed by the mask after exp (masked rows keep l = 0)
      sc[t] = (kk < L && key_visible(kk, pq, window)) ? expf(sc[t] - m_new)
                                                       : 0.f;
      psum += sc[t];
    }
    l_run = alpha * l_run + psum;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = part + TPR * i;
      float a = acc[i] * alpha;
      if (d < D) {
#pragma unroll
        for (int t = 0; t < kBK; ++t) a += sc[t] * vs[t * D + d];
      }
      acc[i] = a;
    }
    m_run = m_new;
  }

  if (!row_ok) return;
  const size_t row = (static_cast<size_t>(b) * S + r) * H + h;
  if (partials) {
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = part + TPR * i;
      if (d < D) o_part[row * D + d] = acc[i];
    }
    if (part == 0) {
      l_out[row] = l_run;
      m_out[row] = m_run;
    }
  } else {
    const float den = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = part + TPR * i;
      if (d < D) out[row * D + d] = from_f32<T>(acc[i] / den);
    }
  }
}

template <typename T, int TPR>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* o, void* l, void* m, int B, int S, int L,
                         int H, int KV, int D, int seq_offset, float scale,
                         int window, float soft_cap, int partials,
                         cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kBK) * D * sizeof(float);
  cudaError_t err = allow_smem(flash_kernel<T, TPR>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, TPR><<<grid, kBQ * TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), partials ? static_cast<float*>(o) : nullptr,
      static_cast<float*>(l), static_cast<float*>(m),
      partials ? nullptr : static_cast<T*>(o), S, L, H, KV, D, seq_offset,
      scale, window, soft_cap, partials);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* o, void* l, void* m, int B, int S, int L,
                           int H, int KV, int D, int seq_offset, float scale,
                           int window, float soft_cap, int partials,
                           cudaStream_t stream) {
  if (D <= 4 * kDPT)
    return launch_flash<T, 4>(q, k, v, o, l, m, B, S, L, H, KV, D,
                              seq_offset, scale, window, soft_cap, partials,
                              stream);
  if (D <= 8 * kDPT)
    return launch_flash<T, 8>(q, k, v, o, l, m, B, S, L, H, KV, D,
                              seq_offset, scale, window, soft_cap, partials,
                              stream);
  return launch_flash<T, 16>(q, k, v, o, l, m, B, S, L, H, KV, D, seq_offset,
                             scale, window, soft_cap, partials, stream);
}

}  // namespace repro

// o is the f32 partial output when partials != 0 (then l, m are written),
// else the normalized output in the input type (l, m unused).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, void* l, void* m, int B, int S, int L,
                             int H, int KV, int D, int seq_offset,
                             float scale, int window, float soft_cap,
                             int partials, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 16 * repro::kDPT ||
      H > 65535 || B > 65535 || L < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_flash<float>(q, k, v, o, l, m, B, S, L, H, KV, D,
                                        seq_offset, scale, window, soft_cap,
                                        partials, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_flash<__nv_bfloat16>(
        q, k, v, o, l, m, B, S, L, H, KV, D, seq_offset, scale, window,
        soft_cap, partials, st);
  return cudaErrorInvalidValue;
}
