// The mLSTM recurrence over a whole sequence, forward and backward: the
// port's counterpart of the jax.lax.scan in src/repro/models/layers.py
// (mlstm_apply).  No TPU kernel: XLA compiles that scan into one loop on
// the device and differentiates through it; PyTorch has no scan, and a
// loop stepped from Python costs ~14 small kernels per token and layer.
//
// Forward, per (b, h) and step t, in f32 and in JAX's order:
//   a = log_f + m;  m' = max(a, log_i);
//   f' = exp(a - m');  i' = exp(log_i - m')
//   C = f' C + i' v k^T;  n = f' n + i' k;  s = n . q
//   y = C q / max(|s|, exp(-m'))
// One block owns kFwdRows value rows of one (b, h)'s C (D x D) in
// registers, one column per thread.  The stabilizer m and the normalizer n
// are computed redundantly by every block of (b, h): the same operations
// in the same order give the same bits, so blocks share nothing.  Per step
// a block reduces s and its rows of C q over its threads (one barrier); the
// next step's q, k, v and gates are loaded while this one computes.  A
// recorded forward (chunk > 0) writes the carries before every chunk-th
// step and every step's m' and s for the backward.
//
// Backward, given dy (the gradient of y; the carries take none): the
// chunks are walked from last to first.  Each block recomputes its rows of
// the chunk's C_t (and n_t) from the checkpoint into a scratch buffer of
// its own, then steps dC (its rows, registers) and dn (redundantly, every
// block) back through the chunk.  Per step:
//   dden = -(dy . y) / den splits through den = max(|s|, g), g = exp(-m'),
//     into ds (to s, times sign s; 0 at s = 0) and dg (to m', times -g),
//     half each at a tie (bwd_prep_kernel, all steps at once: it needs only
//     the saved y, m' and s);
//   dC_t = dC + (dy / den) q^T;  dn_t = dn + ds q;
//   dq = C_t^T dy / den + ds n_t;  dv = i' dC_t k;  dk = i' (dC_t^T v + dn_t)
//   dF = <dC_t, C_{t-1}> + dn_t . n_{t-1};  dI = k . (dC_t^T v + dn_t)
//   dC = f' dC_t;  dn = f' dn_t.
// dq, dk, dF and dI sum over the value rows of every block of (b, h): each
// block writes its partial (block 0 adds the n terms once), reduce_kernel
// and mrev_kernel add them up.  mrev_kernel then runs the scalar reverse of
// the m recurrence, dm carried from step to step through max and exp back
// to log_i, log_f and m.
//
// Bound on the H100: latency.  Each step depends on the last; per step a
// block moves ~2 D floats and does ~4 kFwdRows D flops, far below the
// memory and FMA rates, so the floor is S times the latency of one step
// (a block reduction and its barrier).  Built without fast math: exp(-1e30)
// is 0 and m is carried exactly, as in the plain version.
#include "common.cuh"

namespace repro {
namespace mlstm {

constexpr int kFwdRows = 8;    // value rows of C per forward block
constexpr int kBwdRows = 16;   // per backward block (the caller passes
                               // the rows it sized its scratch for)
constexpr int kMaxWarps = 32;  // D <= 1024, one thread per column
constexpr int kRevTile = 1024; // steps per tile of mrev_kernel

struct Gates {
  float a, mn, fe, ie;
};

// One step's stabilizer from the gates and the previous m.
__device__ __forceinline__ Gates gates(float lf, float li, float mprev) {
  Gates g;
  g.a = lf + mprev;
  g.mn = fmaxf(g.a, li);
  g.fe = expf(g.a - g.mn);
  g.ie = expf(li - g.mn);
  return g;
}

// x's share of the gradient of max(x, y): 1, 0.5 at a tie, 0.
__device__ __forceinline__ float tie_weight(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

// q, k, v, y: (B, S, H, D); li, lf, ms, ss: (B, S, H); C0, Cout: (B, H, D,
// D); n0, nout: (B, H, D); m0, mout: (B, H); ckC: (B, NC, H, D, D), ckn:
// (B, NC, H, D), NC = ceil(S / chunk) (unused when chunk = 0).
// grid (B * H, ceil(D / kFwdRows)), block round_up(D, 32) threads.
__global__ void fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ lf, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ y, float* __restrict__ Cout,
    float* __restrict__ nout, float* __restrict__ mout,
    float* __restrict__ ckC, float* __restrict__ ckn,
    float* __restrict__ ms, float* __restrict__ ss, int S, int H, int D,
    int chunk) {
  constexpr int RB = kFwdRows;
  __shared__ float red[2][kMaxWarps][RB + 1];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * RB;
  const int kk = threadIdx.x, lane = kk & 31, warp = kk >> 5;
  const int nw = blockDim.x >> 5;
  const bool col = kk < D;
  const long long DD = static_cast<long long>(D) * D;
  const int NC = chunk > 0 ? (S + chunk - 1) / chunk : 0;

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    c[r] = (col && r0 + r < D) ? C0[bh * DD + (long long)(r0 + r) * D + kk]
                               : 0.f;
  float nv = col ? n0[(long long)bh * D + kk] : 0.f;
  float mm = m0[bh];

  // step t's inputs, loaded one step ahead
  float qn = 0.f, kn = 0.f, lin = 0.f, lfn = 0.f, vn[RB];
  auto load = [&](int t) {
    const long long i = ((long long)b * S + t) * H + h;
    qn = col ? q[i * D + kk] : 0.f;
    kn = col ? k[i * D + kk] : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) vn[r] = r0 + r < D ? v[i * D + r0 + r] : 0.f;
    lin = li[i];
    lfn = lf[i];
  };
  load(0);
  for (int t = 0; t < S; ++t) {
    const long long i = ((long long)b * S + t) * H + h;
    const float qt = qn, kt = kn, lit = lin, lft = lfn;
    float vt[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) vt[r] = vn[r];
    if (t + 1 < S) load(t + 1);
    if (chunk > 0 && t % chunk == 0 && col) {
      const long long ck = ((long long)b * NC + t / chunk) * H + h;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r0 + r < D) ckC[ck * DD + (long long)(r0 + r) * D + kk] = c[r];
      if (blockIdx.y == 0) ckn[ck * D + kk] = nv;
    }
    const Gates g = gates(lft, lit, mm);
    float part[RB + 1];
    nv = g.fe * nv + g.ie * kt;
    part[RB] = nv * qt;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      c[r] = g.fe * c[r] + g.ie * (vt[r] * kt);
      part[r] = c[r] * qt;
    }
#pragma unroll
    for (int j = 0; j <= RB; ++j) part[j] = warp_sum(part[j]);
    float(*buf)[RB + 1] = red[t & 1];
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j <= RB; ++j) buf[warp][j] = part[j];
    }
    // one barrier a step: a buffer is written again two steps later, after
    // every reader of it has passed the next step's barrier
    __syncthreads();
    if (kk < RB && r0 + kk < D) {
      float s = 0.f, acc = 0.f;
      for (int w = 0; w < nw; ++w) {
        s += buf[w][RB];
        acc += buf[w][kk];
      }
      const float den = fmaxf(fabsf(s), expf(-g.mn));
      y[i * D + r0 + kk] = acc / den;
      if (kk == 0 && blockIdx.y == 0 && chunk > 0) {
        ms[i] = g.mn;
        ss[i] = s;
      }
    }
    mm = g.mn;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (col && r0 + r < D) Cout[bh * DD + (long long)(r0 + r) * D + kk] = c[r];
  if (blockIdx.y == 0) {
    if (col) nout[(long long)bh * D + kk] = nv;
    if (kk == 0) mout[bh] = mm;
  }
}

// Per (b, t, h), one warp each: dden = -(dy . y) / den, split into ds (to
// s) and dmg (to m', through g = exp(-m')).  N = B * S * H.
__global__ void bwd_prep_kernel(const float* __restrict__ dy,
                                const float* __restrict__ y,
                                const float* __restrict__ ms,
                                const float* __restrict__ ss,
                                float* __restrict__ ds,
                                float* __restrict__ dmg, long long N, int D) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= N) return;
  float acc = 0.f;
  for (int x = lane; x < D; x += 32) acc += dy[i * D + x] * y[i * D + x];
  acc = warp_sum(acc);
  if (lane == 0) {
    const float s = ss[i], g = expf(-ms[i]), as = fabsf(s);
    const float dden = -acc / fmaxf(as, g);
    const float ws = tie_weight(as, g);
    const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
    ds[i] = dden * ws * sg;
    dmg[i] = dden * (1.f - ws) * -g;
  }
}

// grid (B * H, NB = ceil(D / RB)), block DP = round_up(D, 32) threads.
// Cs: (B * H * NB, chunk + 1, RB, DP) and Ns: (B * H * NB, chunk + 1, DP),
// each thread's own states of the current chunk (step 0: the checkpoint).
// dv: (B, S, H, D); dq_part, dk_part: (B, S, H, NB, D); dF_part, dI_part:
// (B, S, H, NB).
template <int RB>
__global__ void bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ lf, const float* __restrict__ m0,
    const float* __restrict__ ckC, const float* __restrict__ ckn,
    const float* __restrict__ ms, const float* __restrict__ ss,
    const float* __restrict__ dy, const float* __restrict__ ds,
    float* __restrict__ Cs, float* __restrict__ Ns, float* __restrict__ dv,
    float* __restrict__ dq_part, float* __restrict__ dk_part,
    float* __restrict__ dF_part, float* __restrict__ dI_part, int S, int H,
    int D, int chunk) {
  __shared__ float red[2][kMaxWarps][RB + 2];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int blk = blockIdx.y, NB = gridDim.y, r0 = blk * RB;
  const bool lead = blk == 0;
  const int kk = threadIdx.x, lane = kk & 31, warp = kk >> 5;
  const int nw = blockDim.x >> 5, DP = blockDim.x;
  const bool col = kk < D;
  const long long DD = static_cast<long long>(D) * D;
  const int NC = (S + chunk - 1) / chunk;
  const long long own = static_cast<long long>(bh * NB + blk) * (chunk + 1);
  float* cs = Cs + own * RB * DP;
  float* ns = Ns + own * DP;
  auto idx = [&](int t) { return ((long long)b * S + t) * H + h; };

  float dC[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) dC[r] = 0.f;
  float dn = 0.f;
  int step = 0;
  for (int j = NC - 1; j >= 0; --j) {
    const int t0 = j * chunk, t1 = min(S, t0 + chunk);
    // the chunk's states, recomputed from its checkpoint
    const long long ck = ((long long)b * NC + j) * H + h;
    float c[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      c[r] = (col && r0 + r < D) ? ckC[ck * DD + (long long)(r0 + r) * D + kk]
                                 : 0.f;
      cs[r * DP + kk] = c[r];
    }
    float nv = col ? ckn[ck * D + kk] : 0.f;
    ns[kk] = nv;
    float mm = t0 == 0 ? m0[bh] : ms[idx(t0 - 1)];
    for (int t = t0; t < t1; ++t) {
      const long long i = idx(t);
      const float kt = col ? k[i * D + kk] : 0.f;
      const Gates g = gates(lf[i], li[i], mm);
      nv = g.fe * nv + g.ie * kt;
      const int u = t - t0 + 1;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float vr = r0 + r < D ? v[i * D + r0 + r] : 0.f;
        c[r] = g.fe * c[r] + g.ie * (vr * kt);
        cs[(u * RB + r) * DP + kk] = c[r];
      }
      ns[u * DP + kk] = nv;
      mm = g.mn;
    }
    // dC and dn stepped back through the chunk
    for (int t = t1 - 1; t >= t0; --t) {
      const long long i = idx(t);
      const int u = t - t0;
      const float qt = col ? q[i * D + kk] : 0.f;
      const float kt = col ? k[i * D + kk] : 0.f;
      const Gates g = gates(lf[i], li[i], t == 0 ? m0[bh] : ms[idx(t - 1)]);
      const float den = fmaxf(fabsf(ss[i]), expf(-g.mn));
      const float dst = ds[i];
      const float dnt = dn + dst * qt;
      float part[RB + 2];
      float w = lead ? dnt : 0.f, dqp = 0.f, dfp = 0.f;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const bool row = r0 + r < D;
        const float vr = row ? v[i * D + r0 + r] : 0.f;
        const float dnum = row ? dy[i * D + r0 + r] / den : 0.f;
        const float ct = cs[((u + 1) * RB + r) * DP + kk];
        const float cp = cs[(u * RB + r) * DP + kk];
        const float dct = dC[r] + dnum * qt;
        dqp += ct * dnum;
        w += dct * vr;
        dfp += dct * cp;
        part[r] = dct * kt;
        dC[r] = g.fe * dct;
      }
      if (lead) {
        dqp += dst * ns[(u + 1) * DP + kk];
        dfp += dnt * ns[u * DP + kk];
      }
      part[RB] = dfp;
      part[RB + 1] = kt * w;
      if (col) {
        dq_part[(i * NB + blk) * D + kk] = dqp;
        dk_part[(i * NB + blk) * D + kk] = g.ie * w;
      }
      dn = g.fe * dnt;
#pragma unroll
      for (int x = 0; x < RB + 2; ++x) part[x] = warp_sum(part[x]);
      float(*buf)[RB + 2] = red[step & 1];
      if (lane == 0) {
#pragma unroll
        for (int x = 0; x < RB + 2; ++x) buf[warp][x] = part[x];
      }
      __syncthreads();
      if (kk < RB + 2) {
        float tot = 0.f;
        for (int x = 0; x < nw; ++x) tot += buf[x][kk];
        if (kk < RB) {
          if (r0 + kk < D) dv[i * D + r0 + kk] = g.ie * tot;
        } else if (kk == RB) {
          dF_part[i * NB + blk] = tot;
        } else {
          dI_part[i * NB + blk] = tot;
        }
      }
      ++step;
    }
  }
}

// dq, dk = the sums of the blocks' partials.  grid B * S * H.
__global__ void reduce_kernel(const float* __restrict__ dq_part,
                              const float* __restrict__ dk_part,
                              float* __restrict__ dq, float* __restrict__ dk,
                              int NB, int D) {
  const long long i = blockIdx.x;
  for (int x = threadIdx.x; x < D; x += blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int j = 0; j < NB; ++j) {
      a += dq_part[(i * NB + j) * D + x];
      c += dk_part[(i * NB + j) * D + x];
    }
    dq[i * D + x] = a;
    dk[i * D + x] = c;
  }
}

// The reverse of the m recurrence, one block per (b, h): the threads turn
// a tile of steps' dF and dI (summed over the blocks' partials) into
// dA = dF f', dB = dI i' and max's tie weight, then one thread carries dm
// from the last step to the first:
//   dm' = dm + dmg - dA - dB;  dlog_f = da = dA + w dm';
//   dlog_i = dB + (1 - w) dm';  dm = da.
__global__ void mrev_kernel(const float* __restrict__ li,
                            const float* __restrict__ lf,
                            const float* __restrict__ m0,
                            const float* __restrict__ ms,
                            const float* __restrict__ dF_part,
                            const float* __restrict__ dI_part,
                            const float* __restrict__ dmg,
                            float* __restrict__ dli, float* __restrict__ dlf,
                            int S, int H, int NB) {
  __shared__ float sA[kRevTile], sB[kRevTile], sW[kRevTile], sG[kRevTile];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  float dm = 0.f;
  for (int hi = S; hi > 0; hi -= kRevTile) {
    const int lo = max(0, hi - kRevTile);
    for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
      const long long i = ((long long)b * S + t) * H + h;
      float dF = 0.f, dI = 0.f;
      for (int j = 0; j < NB; ++j) {
        dF += dF_part[i * NB + j];
        dI += dI_part[i * NB + j];
      }
      const Gates g = gates(lf[i], li[i], t == 0 ? m0[bh] : ms[i - H]);
      sA[t - lo] = dF * g.fe;
      sB[t - lo] = dI * g.ie;
      sW[t - lo] = tie_weight(g.a, li[i]);
      sG[t - lo] = dmg[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        const int u = t - lo;
        const long long i = ((long long)b * S + t) * H + h;
        const float dmt = dm + sG[u] - sA[u] - sB[u];
        const float da = sA[u] + sW[u] * dmt;
        dli[i] = sB[u] + (1.f - sW[u]) * dmt;
        dlf[i] = da;
        dm = da;
      }
    }
    __syncthreads();
  }
}

inline int round_warp(int d) { return (d + 31) / 32 * 32; }

}  // namespace mlstm
}  // namespace repro

// q, k, v: (B, S, H, D) f32; li, lf: (B, S, H); C0: (B, H, D, D); n0: (B, H,
// D); m0: (B, H).  Writes y (B, S, H, D), C, n, m (the last carries) and,
// for chunk > 0, ckC (B, ceil(S / chunk), H, D, D), ckn (B, .., H, D), ms,
// ss (B, S, H).  D <= 1024.  Returns the cudaError_t of the launch.
extern "C" int mlstm_scan_forward(
    const void* q, const void* k, const void* v, const void* li,
    const void* lf, const void* C0, const void* n0, const void* m0, void* y,
    void* C, void* n, void* m, void* ckC, void* ckn, void* ms, void* ss,
    int B, int S, int H, int D, int chunk, void* stream) {
  using namespace repro::mlstm;
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 32 * kMaxWarps || chunk < 0)
    return cudaErrorInvalidValue;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  fwd_kernel<<<dim3(B * H, (D + kFwdRows - 1) / kFwdRows), round_warp(D), 0,
               static_cast<cudaStream_t>(stream)>>>(
      cf(q), cf(k), cf(v), cf(li), cf(lf), cf(C0), cf(n0), cf(m0), f(y), f(C),
      f(n), f(m), f(ckC), f(ckn), f(ms), f(ss), S, H, D, chunk);
  return cudaGetLastError();
}

// dy, q, k, v, y: (B, S, H, D) f32; li, lf, ms, ss: (B, S, H); m0: (B, H);
// ckC, ckn: the forward's checkpoints every chunk steps.  Writes dq, dk,
// dv (B, S, H, D) and dli, dlf (B, S, H).  Scratch (xlstm_scan.py allocates
// it for `rows` value rows a block, which must be kBwdRows; NB = ceil(D /
// rows), DP = round_up(D, 32)): Cs (B H NB, chunk + 1, rows, DP), Ns (B H
// NB, chunk + 1, DP), dq_part and dk_part (B, S, H, NB, D), dF_part and
// dI_part (B, S, H, NB), ds and dmg (B, S, H).  Four launches on the
// stream.  Returns the first cudaError_t.
extern "C" int mlstm_scan_backward(
    const void* dy, const void* q, const void* k, const void* v,
    const void* li, const void* lf, const void* m0, const void* ckC,
    const void* ckn, const void* ms, const void* ss, const void* y, void* dq,
    void* dk, void* dv, void* dli, void* dlf, void* Cs, void* Ns,
    void* dq_part, void* dk_part, void* dF_part, void* dI_part, void* ds,
    void* dmg, int B, int S, int H, int D, int chunk, int rows,
    void* stream) {
  using namespace repro::mlstm;
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 32 * kMaxWarps || chunk < 1
      || rows != kBwdRows)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const long long N = static_cast<long long>(B) * S * H;
  const int NB = (D + kBwdRows - 1) / kBwdRows;
  bwd_prep_kernel<<<static_cast<unsigned>((N * 32 + 255) / 256), 256, 0,
                    st>>>(cf(dy), cf(y), cf(ms), cf(ss), f(ds), f(dmg), N,
                          D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kernel<kBwdRows><<<dim3(B * H, NB), round_warp(D), 0, st>>>(
      cf(q), cf(k), cf(v), cf(li), cf(lf), cf(m0), cf(ckC), cf(ckn), cf(ms),
      cf(ss), cf(dy), cf(ds), f(Cs), f(Ns), f(dv), f(dq_part), f(dk_part),
      f(dF_part), f(dI_part), S, H, D, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<<<static_cast<unsigned>(N), min(round_warp(D), 256), 0,
                  st>>>(cf(dq_part), cf(dk_part), f(dq), f(dk), NB, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mrev_kernel<<<B * H, 256, 0, st>>>(cf(li), cf(lf), cf(m0), cf(ms),
                                     cf(dF_part), cf(dI_part), cf(dmg),
                                     f(dli), f(dlf), S, H, NB);
  return cudaGetLastError();
}
