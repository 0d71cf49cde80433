// The sLSTM recurrence over a whole sequence, forward and backward: the
// port's counterpart of the jax.lax.scan in src/repro/models/layers.py
// (slstm_apply).  No TPU kernel: XLA compiles that scan into one loop on
// the device and differentiates through it.
//
// Forward, per step t, in f32 and in JAX's order:
//   pre = pre_x_t + h r_w, split into (z, i, f, o) of d each;
//   z = tanh, o = sigmoid, log f = log_sigmoid;
//   a = log f + m;  m' = max(a, i);  f' = exp(a - m');  i' = exp(i - m')
//   c = f' c + i' z;  n = f' n + i';  h = o c / max(n, 1)
// Every step mixes all of d through r_w (d x 4d), so a step needs the
// whole of the previous step's h.  Two designs, chosen by shape before any
// launch (xlstm_scan.slstm_route):
//
// * The persistent forward (slstm_scan_forward_persistent), for S > 1:
//   one cooperative launch for the whole sequence, one block per SM.  A
//   block owns kPUnits = 8 hidden units and their 32 columns of r_w (z, i,
//   f, o of each), loaded into shared memory once a call (128 KiB at d =
//   1,024) and kept there for all S steps; its units' c, n, m stay in the
//   registers of the threads that update them.  Per step a block waits at
//   a grid barrier for h_{t-1} (one counter in global memory: a block adds
//   1 with red.release once its h is stored, one thread polls it with
//   ld.acquire, as CUTLASS's grid barrier does; a flag per block, polled
//   by a thread each, was slower on the H100; h is then read
//   with ld.global.cg, past the SMs' L1, which is not coherent across
//   SMs), stages h_{t-1}'s rows transposed in shared memory, runs
//   the (rows x d) x (d x 32) product on the FMA units (16 warps split d;
//   a lane holds 4 columns x the rows, r_w in 16-byte loads), reduces it
//   over the warps, adds pre_x_t (loaded one step ahead) and updates its
//   units.  The launch refuses (returns an error, never hangs) when the
//   grid cannot be co-resident; the counter is zeroed on the stream before
//   it.  Bound: latency per step, the barrier plus the product (8 B d^2
//   FMAs a step over the SMs) plus the staging of h (B d floats from L2 to
//   every block).
// * The step forward (slstm_scan_forward): one launch per step, all
//   launched from one host call on the stream, for S = 1 (a decode step:
//   one plain launch, which a captured CUDA graph replays) and for shapes
//   the persistent kernel does not take (more than 8 rows, more units than
//   SMs x 8, or r_w's slice and h beyond a block's shared memory).  A
//   block owns kUnits hidden units (their 4 kUnits columns of r_w, one per
//   lane) and up to kRows batch rows; its warps split the reduction over
//   d, each keeping 16 loads of r_w in flight (the loop unrolled), with
//   h_{t-1} staged in shared memory; r_w (16 MiB at d = 1024) is read from
//   L2 on every step: ~3 us at L2's rate, beside a launch, per step.
// A recorded forward (save) keeps every step's pre-activations and c, n,
// m for the backward, in either design.
//
// Backward: dh_t = dy_t + dpre_{t+1} r_w^T, then the step's elementwise
// backward with dc, dn, dm carried per unit and row (the gradient of max to
// the larger side, half to each at a tie, as torch.maximum's and JAX's
// max's).  dr_w = sum_t h_{t-1}^T dpre_t is one matrix product after the
// kernel (xlstm_scan.py), as the other plain products of the port.  Two
// designs, chosen by shape before any launch (xlstm_scan.slstm_bwd_route):
//
// * The persistent backward (slstm_scan_backward_persistent), from the
//   route's least S on: one cooperative launch for the whole reversed
//   sequence, one block per SM.  A block owns kPUnits = 8 hidden units and
//   their 8 rows of r_w (4d floats each), loaded into shared memory once a
//   call (128 KiB at d = 1,024) and kept there for all S steps; its units'
//   dc, dn, dm stay in the registers of the threads that update them (the
//   step's elementwise backward is bwd_unit, the step design's too, so the
//   two designs differ only in the order of dh's sums).  Per step a block
//   waits at the forward's grid barrier for dpre_{t+1} (the same counter: a
//   block adds 1 with red.release once its dpre_t is stored, one thread polls
//   it with ld.acquire), then streams dpre_{t+1}'s rows from L2 into
//   registers (ld.global.cg, past the SMs' L1, which is not coherent across
//   SMs; a thread takes 16-byte columns of every row, all their loads in
//   flight, without staging them in shared memory: B 4d floats a row would
//   not fit beside r_w's rows at 8 rows) and multiplies them with its units'
//   rows out of shared memory on the FMA units.  The thread's 8 x rows
//   partial sums are reduced over its warp by a reduce-scatter (each level
//   halves the sums a lane keeps), then over the warps.  The threads of the
//   units then run the step's elementwise backward, with step t - 1's inputs
//   (dy, the four pre-activations, c, n, m and their previous values) loaded
//   one step ahead, store dpre_t's 32 columns and arrive.  The launch refuses
//   (returns an error, never hangs) when the grid cannot be co-resident; the
//   counter is zeroed on the stream before it.  Bound: latency per step, the
//   barrier plus the read of dpre_{t+1} (B 4d floats from L2 to every block)
//   plus the product (8 B 4d FMAs a block).
// * The step backward (slstm_scan_backward): one launch per step from the
//   last, for the shapes the persistent kernel does not take (more than 8
//   rows, more units than SMs x 8, a single step): a warp per unit reads
//   its row of r_w from L2 in 16-byte loads, dpre_{t+1} staged in shared
//   memory, and the carried dc, dn, dm go through global memory between
//   launches.  Bound: latency per step, r_w read from L2 each step, as the
//   step forward.
//
// Built without fast math: exp(-1e30) is 0 and m is carried exactly, as in
// the plain version.
#include "common.cuh"

namespace repro {
namespace slstm {

constexpr int kUnits = 8;       // hidden units per forward block (32 lanes:
                                // z, i, f, o of each)
constexpr int kRows = 8;        // batch rows per block
constexpr int kFwdWarps = 16;   // forward: the warps split the rows of r_w
constexpr int kWarps = 8;       // backward: one unit per warp
                                // (the unroll of its loops)

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// log(sigmoid(x)), as PyTorch's CPU log_sigmoid computes it
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float tie_weight(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

// Step t.  pre_x, pres: (B, S, 4d); r_w: (d, 4d); hprev: row b at
// hprev + b * hstride (h0, or y's step t - 1); cin/nin/min: the carries
// in (c0.. at t = 0, else the outputs, updated in place); y: (B, S, d);
// cout/nout/mout: (B, d); cs/ns/msv: (B, S, d).  grid (ceil(d / kUnits),
// ceil(B / kRows)), kFwdWarps * 32 threads, min(B, kRows) * d floats of
// dynamic shared memory (h_{t-1}'s rows).
__global__ void __launch_bounds__(kFwdWarps * 32) fwd_step(
    const float* __restrict__ pre_x, const float* __restrict__ r_w,
    const float* hprev, long long hstride, const float* cin,
    const float* nin, const float* min_, float* y, float* cout, float* nout,
    float* mout, float* __restrict__ pres, float* __restrict__ cs,
    float* __restrict__ ns, float* __restrict__ msv, int B, int S, int d,
    int t, int save) {
  extern __shared__ float hs[];  // [kRows][d]
  __shared__ float red[kFwdWarps][kRows][32];
  __shared__ float pre_s[kRows][32];
  const int j0 = blockIdx.x * kUnits, b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d4 = 4LL * d;
#pragma unroll 4
  for (int x = tid; x < nb * d; x += blockDim.x)
    hs[x] = hprev[(b0 + x / d) * hstride + x % d];
  __syncthreads();
  // lane -> column (gate, unit) of this block's 4 kUnits columns
  const int gate = lane / kUnits, u = lane % kUnits;
  const long long gcol = gate * static_cast<long long>(d) + j0 + u;
  float acc[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) acc[b] = 0.f;
  if (j0 + u < d) {
#pragma unroll 16
    for (int x = warp; x < d; x += kFwdWarps) {
      const float r = r_w[x * d4 + gcol];
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        if (b < nb) acc[b] += hs[b * d + x] * r;
    }
  }
#pragma unroll
  for (int b = 0; b < kRows; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();
  if (tid < kRows * 32) {
    const int b = tid / 32, l = tid % 32;
    const long long col = (l / kUnits) * static_cast<long long>(d) + j0
                          + l % kUnits;
    if (b < nb && j0 + l % kUnits < d) {
      float dot = 0.f;
      for (int w = 0; w < kFwdWarps; ++w) dot += red[w][b][l];
      const long long row = static_cast<long long>(b0 + b) * S + t;
      const float pre = pre_x[row * d4 + col] + dot;
      pre_s[b][l] = pre;
      if (save) pres[row * d4 + col] = pre;
    }
  }
  __syncthreads();
  if (tid < kRows * kUnits) {
    const int b = tid / kUnits, uu = tid % kUnits, j = j0 + uu;
    if (b < nb && j < d) {
      const long long sb = static_cast<long long>(b0 + b) * d + j;
      const long long row = static_cast<long long>(b0 + b) * S + t;
      const float z = tanhf(pre_s[b][uu]);
      const float li = pre_s[b][kUnits + uu];
      const float a = log_sigmoid(pre_s[b][2 * kUnits + uu]) + min_[sb];
      const float o = sigmoid(pre_s[b][3 * kUnits + uu]);
      const float mn = fmaxf(a, li);
      const float fe = expf(a - mn), ie = expf(li - mn);
      const float c = fe * cin[sb] + ie * z;
      const float n = fe * nin[sb] + ie;
      y[row * d + j] = o * c / fmaxf(n, 1.f);
      cout[sb] = c;
      nout[sb] = n;
      mout[sb] = mn;
      if (save) {
        cs[row * d + j] = c;
        ns[row * d + j] = n;
        msv[row * d + j] = mn;
      }
    }
  }
}

// Step t's inputs to one (row, unit) of the elementwise backward: dy, the
// four pre-activations, c, n, m after the step and before it.
struct BwdIn {
  float dy, pz, pi, pf, po, ct, nt, mt, cp, np, mp;
};

__device__ __forceinline__ BwdIn bwd_inputs(
    const float* __restrict__ dy, const float* __restrict__ pres,
    const float* __restrict__ cs, const float* __restrict__ ns,
    const float* __restrict__ msv, const float* __restrict__ c0,
    const float* __restrict__ n0, const float* __restrict__ m0, int b, int j,
    int S, int d, int t) {
  const long long row = static_cast<long long>(b) * S + t, d4 = 4LL * d;
  const long long x = row * d + j, sb = static_cast<long long>(b) * d + j;
  BwdIn in;
  in.dy = dy[x];
  in.pz = pres[row * d4 + j];
  in.pi = pres[row * d4 + d + j];
  in.pf = pres[row * d4 + 2 * d + j];
  in.po = pres[row * d4 + 3 * d + j];
  in.ct = cs[x];
  in.nt = ns[x];
  in.mt = msv[x];
  in.cp = t ? cs[x - d] : c0[sb];
  in.np = t ? ns[x - d] : n0[sb];
  in.mp = t ? msv[x - d] : m0[sb];
  return in;
}

// The step's elementwise backward for one (row, unit), dh = in.dy + dhr:
// writes dpre_t's four gate columns of unit j into dp (the row's 4d
// floats) and carries dc, dn, dm to step t - 1.
__device__ __forceinline__ void bwd_unit(const BwdIn& in, float dhr,
                                         float& dc, float& dn, float& dm,
                                         float* dp, int d, int j) {
  const float dh = in.dy + dhr;
  const float z = tanhf(in.pz), o = sigmoid(in.po);
  const float a = log_sigmoid(in.pf) + in.mp;
  const float fe = expf(a - in.mt), ie = expf(in.pi - in.mt);
  const float nn = fmaxf(in.nt, 1.f);
  const float d_o = dh * in.ct / nn;
  const float dct = dc + dh * o / nn;
  const float dnt =
      dn - dh * (o * in.ct) / (nn * nn) * tie_weight(in.nt, 1.f);
  const float dA = (dct * in.cp + dnt * in.np) * fe;
  const float dB = (dct * z + dnt) * ie;
  const float dmt = dm - dA - dB;
  const float wa = tie_weight(a, in.pi);
  const float da = dA + wa * dmt;
  dp[j] = dct * ie * (1.f - z * z);
  dp[d + j] = dB + (1.f - wa) * dmt;
  dp[2 * d + j] = da * sigmoid(-in.pf);
  dp[3 * d + j] = d_o * o * (1.f - o);
  dc = dct * fe;
  dn = dnt * fe;
  dm = da;
}

// Step t of the backward.  dy: (B, S, d); pres, dpre: (B, S, 4d); cs, ns,
// msv: the forward's (B, S, d); c0, n0, m0: (B, d); dc, dn, dm: the
// carried gradients (B, d), zero before the last step.  grid (ceil(d /
// kWarps), ceil(B / kRows)), kWarps * 32 threads, rows * tc floats of
// dynamic shared memory: dpre_{t+1}'s rows staged tc columns at a time
// (rows = min(B, kRows); tc a multiple of 4, 4d where it fits).
__global__ void __launch_bounds__(kWarps * 32) bwd_step(
    const float* __restrict__ dy, const float* __restrict__ r_w,
    const float* __restrict__ pres, const float* __restrict__ cs,
    const float* __restrict__ ns, const float* __restrict__ msv,
    const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, float* dpre, float* dc, float* dn,
    float* dm, int B, int S, int d, int t, int tc) {
  extern __shared__ __align__(16) float tile[];  // [rows][tc]
  const int b0 = blockIdx.y * kRows, nb = min(kRows, B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + warp;  // this warp's unit
  const long long d4 = 4LL * d;
  float acc[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) acc[b] = 0.f;
  if (t + 1 < S) {
    // 16-byte loads: rows of 4d floats, tiles of a multiple of 4
    for (long long c0_ = 0; c0_ < d4; c0_ += tc) {
      const int w4 = static_cast<int>(min(static_cast<long long>(tc),
                                          d4 - c0_)) / 4;
      __syncthreads();
#pragma unroll 4
      for (int x = threadIdx.x; x < nb * w4; x += blockDim.x) {
        const int b = x / w4, c = x % w4;
        reinterpret_cast<float4*>(tile + b * tc)[c] =
            reinterpret_cast<const float4*>(
                dpre + (static_cast<long long>(b0 + b) * S + t + 1) * d4
                + c0_)[c];
      }
      __syncthreads();
      if (j < d) {
        const float4* rr = reinterpret_cast<const float4*>(r_w + j * d4
                                                           + c0_);
#pragma unroll 8
        for (int c = lane; c < w4; c += 32) {
          const float4 r = rr[c];
#pragma unroll
          for (int b = 0; b < kRows; ++b) {
            if (b < nb) {
              const float4 h = reinterpret_cast<const float4*>(
                  tile + b * tc)[c];
              acc[b] += h.x * r.x + h.y * r.y + h.z * r.z + h.w * r.w;
            }
          }
        }
      }
    }
  }
  float dhr = 0.f;
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    const float s = warp_sum(acc[b]);
    if (lane == b) dhr = s;
  }
  if (j >= d || lane >= nb) return;
  const int b = b0 + lane;
  const long long sb = static_cast<long long>(b) * d + j;
  float c = dc[sb], n = dn[sb], m = dm[sb];
  bwd_unit(bwd_inputs(dy, pres, cs, ns, msv, c0, n0, m0, b, j, S, d, t), dhr,
           c, n, m, dpre + (static_cast<long long>(b) * S + t) * d4, d, j);
  dc[sb] = c;
  dn[sb] = n;
  dm[sb] = m;
}

// ---------------------------------------------------------------------------
// The persistent forward
// ---------------------------------------------------------------------------

constexpr int kPUnits = 8;               // hidden units per block: 32 columns
constexpr int kPWarps = 16;
constexpr int kPThreads = kPWarps * 32;
constexpr int kPMaxRows = 8;             // batch rows a call takes
constexpr int kXStep = kPWarps * 4;      // rows of r_w per pass of a block
constexpr long long kSpinLimit = 20000000000LL;  // cycles at a grid barrier

// Floats of dynamic shared memory for `rows` (1, 2, 4, 8) staged rows and
// d padded to dpad (a multiple of kXStep): r_w's slice, h transposed and
// the warps' partial products.  xlstm_scan.slstm_persistent_smem repeats
// this count for the route.
constexpr long long persistent_floats(int rows, int dpad) {
  return static_cast<long long>(dpad) * 32 + static_cast<long long>(dpad) * rows
         + kPWarps * rows * 32;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// RB: rows staged (B rounded up to 1, 2, 4 or 8).  pre_x, pres: (B, S,
// 4d); r_w: (d, 4d); c0, n0, m0, h0: (B, d); y: (B, S, d) (h_t, which the
// next step reads); cout, nout, mout, hout: (B, d); cs, ns, msv: (B, S, d);
// arrived: the grid barrier's counter, zero at the launch (after step t
// each block adds 1; S gridDim.x stays below 2^31).  grid ceil(d / kPUnits)
// blocks (co-resident), kPThreads threads, persistent_floats(RB, dpad)
// floats of dynamic shared memory.
template <int RB>
__global__ void __launch_bounds__(kPThreads, 1) fwd_persistent(
    const float* __restrict__ pre_x, const float* __restrict__ r_w,
    const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, const float* __restrict__ h0, float* y,
    float* __restrict__ cout, float* __restrict__ nout,
    float* __restrict__ mout, float* __restrict__ hout,
    float* __restrict__ pres, float* __restrict__ cs,
    float* __restrict__ ns, float* __restrict__ msv, int* arrived, int B,
    int S, int d, int dpad, int save) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                          // [dpad][32]: columns (gate, unit)
  float* hT = rs + dpad * 32;              // [dpad][RB]: h_{t-1}[b][x]
  float* red = hT + dpad * RB;             // [kPWarps][RB][32]
  const int nblk = gridDim.x, j0 = blockIdx.x * kPUnits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d4 = 4LL * d;

  // r_w's slice, once a call; padded rows and units beyond d are zeros
  for (int i = tid; i < dpad * 32; i += kPThreads) {
    const int x = i >> 5, l = i & 31, j = j0 + (l & 7);
    rs[i] = (x < d && j < d) ? r_w[x * d4 + (l >> 3) * static_cast<long long>(d) + j]
                             : 0.f;
  }
  for (int i = tid; i < dpad * RB; i += kPThreads) hT[i] = 0.f;

  // Warp b < RB finishes row b: lane l sums column l (gate l / 8, unit l %
  // 8) over the warps and adds pre_x, loaded one step ahead; lanes 0-7
  // then gather their unit's four gates and update it, c, n, m kept in
  // their registers for the whole sequence.
  const int ub = warp, uj = j0 + (lane & 7);
  const bool row_ok = warp < RB && ub < B && uj < d;
  const bool upd = row_ok && lane < kPUnits;
  const long long pcol = (lane >> 3) * static_cast<long long>(d) + uj;
  float px = row_ok ? pre_x[static_cast<long long>(ub) * S * d4 + pcol] : 0.f;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  if (upd) {
    c = c0[ub * static_cast<long long>(d) + uj];
    n = n0[ub * static_cast<long long>(d) + uj];
    m = m0[ub * static_cast<long long>(d) + uj];
  }

  const int kq = lane >> 3, cg = lane & 7;
  for (int t = 0; t < S; ++t) {
    if (t > 0 && tid == 0) {
      // every block's h_{t-1} is stored: t arrivals from each block
      const long long start = clock64();
      while (ld_acquire(arrived) < t * nblk) {
        // a block that never arrives is a fault, not a wait: stop the
        // kernel with an error after ~10 s rather than hang the card
        if (clock64() - start > kSpinLimit) __trap();
      }
    }
    __syncthreads();
    {
      // h_{t-1}, read past L1: a thread's x, every row's load in flight
      const float* hp = t == 0 ? h0 : y + static_cast<long long>(t - 1) * d;
      const long long hs = t == 0 ? d : static_cast<long long>(S) * d;
      for (int x = tid; x < d; x += kPThreads) {
        float hv[RB];
#pragma unroll
        for (int b = 0; b < RB; ++b) hv[b] = b < B ? __ldcg(hp + b * hs + x) : 0.f;
        if constexpr (RB >= 4) {
#pragma unroll
          for (int q4 = 0; q4 < RB / 4; ++q4)
            *reinterpret_cast<float4*>(hT + x * RB + 4 * q4) = make_float4(
                hv[4 * q4], hv[4 * q4 + 1], hv[4 * q4 + 2], hv[4 * q4 + 3]);
        } else if constexpr (RB == 2) {
          *reinterpret_cast<float2*>(hT + x * 2) = make_float2(hv[0], hv[1]);
        } else {
          hT[x] = hv[0];
        }
      }
    }
    __syncthreads();
    float acc[RB][4];
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[b][k] = 0.f;
#pragma unroll 4
    for (int x = warp * 4 + kq; x < dpad; x += kXStep) {
      const float4 r = *reinterpret_cast<const float4*>(rs + x * 32 + cg * 4);
      float hv[RB];
      if constexpr (RB >= 4) {
#pragma unroll
        for (int q4 = 0; q4 < RB / 4; ++q4) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(hT + x * RB + 4 * q4);
          hv[4 * q4] = v4.x;
          hv[4 * q4 + 1] = v4.y;
          hv[4 * q4 + 2] = v4.z;
          hv[4 * q4 + 3] = v4.w;
        }
      } else if constexpr (RB == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(hT + x * 2);
        hv[0] = v2.x;
        hv[1] = v2.y;
      } else {
        hv[0] = hT[x];
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        acc[b][0] = fmaf(hv[b], r.x, acc[b][0]);
        acc[b][1] = fmaf(hv[b], r.y, acc[b][1]);
        acc[b][2] = fmaf(hv[b], r.z, acc[b][2]);
        acc[b][3] = fmaf(hv[b], r.w, acc[b][3]);
      }
    }
    // over the warp's four interleaved rows of r_w, then over the warps
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = acc[b][k];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[b][k] = v;
      }
    if (kq == 0) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
        *reinterpret_cast<float4*>(red + (warp * RB + b) * 32 + cg * 4) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    }
    __syncthreads();
    if (warp < RB) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < kPWarps; ++w) dot += red[(w * RB + warp) * 32 + lane];
      const float pre = px + dot;
      const long long row = static_cast<long long>(ub) * S + t;
      if (row_ok) {
        if (save) pres[row * d4 + pcol] = pre;
        if (t + 1 < S) px = pre_x[(row + 1) * d4 + pcol];
      }
      const float pi = __shfl_down_sync(0xffffffffu, pre, kPUnits);
      const float pf = __shfl_down_sync(0xffffffffu, pre, 2 * kPUnits);
      const float po = __shfl_down_sync(0xffffffffu, pre, 3 * kPUnits);
      if (upd) {
        const float z = tanhf(pre);
        const float a = log_sigmoid(pf) + m;
        const float o = sigmoid(po);
        const float mn = fmaxf(a, pi);
        const float fe = expf(a - mn), ie = expf(pi - mn);
        c = fe * c + ie * z;
        n = fe * n + ie;
        h = o * c / fmaxf(n, 1.f);
        m = mn;
        y[row * d + uj] = h;
        if (save) {
          cs[row * d + uj] = c;
          ns[row * d + uj] = n;
          msv[row * d + uj] = mn;
        }
      }
      // arrive once its RB warps have stored their h_t (bar.sync 1 among
      // them; the release add orders the stores the barrier saw before
      // it, as CUTLASS's grid barrier does)
      asm volatile("bar.sync 1, %0;" ::"r"(RB * 32) : "memory");
      if (tid == 0 && t + 1 < S) red_release_add(arrived, 1);
    }
  }
  if (upd) {
    const long long sb = static_cast<long long>(ub) * d + uj;
    cout[sb] = c;
    nout[sb] = n;
    mout[sb] = m;
    hout[sb] = h;
  }
}

// The host-side limits a cooperative launch of one kernel checks: the
// card's once a process and device, the kernel's shared-memory limit and
// occupancy when its size changes (queries on every call cost tens of
// microseconds of host time); per device, since the attribute and the
// occupancy are a device's.  One static instance per kernel.
struct CoopCache {
  int optin[repro::kMaxDevices], coop[repro::kMaxDevices],
      per_sm[repro::kMaxDevices];
  size_t smem_set[repro::kMaxDevices], smem_seen[repro::kMaxDevices];
};

// Ready a cooperative launch of nblk blocks of kPThreads threads and smem
// bytes of `kernel` over S steps of a counter barrier: an error when the
// card cannot take it (every block must be resident at once, or the grid
// barrier would wait forever: refuse instead), else the counter zeroed on
// the stream.
template <typename K>
cudaError_t cooperative_ready(CoopCache& c, K kernel, size_t smem, int nblk,
                              int S, int* arrived, cudaStream_t st) {
  const int dev = repro::device_slot();
  const int sms = repro::sm_count();
  if (dev < 0 || sms < 1) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  }
  cudaError_t err = cudaSuccess;
  if (c.optin[dev] == 0) {
    if ((err = cudaDeviceGetAttribute(
             &c.coop[dev], cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &c.optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
               != cudaSuccess)
      return err;
  }
  if (!c.coop[dev] || smem > static_cast<size_t>(c.optin[dev]))
    return cudaErrorInvalidConfiguration;
  if (smem > c.smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    c.smem_set[dev] = smem;
  }
  if (smem != c.smem_seen[dev]) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm[dev], kernel,
                                                        kPThreads, smem);
    if (err != cudaSuccess) return err;
    c.smem_seen[dev] = smem;
  }
  if (static_cast<long long>(c.per_sm[dev]) * sms < nblk)
    return cudaErrorCooperativeLaunchTooLarge;
  if (static_cast<long long>(S) * nblk >= (1LL << 31))
    return cudaErrorInvalidValue;
  return cudaMemsetAsync(arrived, 0, sizeof(int), st);
}

template <int RB>
cudaError_t launch_persistent(const float* pre_x, const float* r_w,
                              const float* c0, const float* n0,
                              const float* m0, const float* h0, float* y,
                              float* c, float* n, float* m, float* h,
                              float* pres, float* cs, float* ns, float* ms,
                              int* arrived, int B, int S, int d, int save,
                              cudaStream_t st) {
  static CoopCache cache;
  int dpad = (d + kXStep - 1) / kXStep * kXStep;
  const size_t smem = sizeof(float) * persistent_floats(RB, dpad);
  const int nblk = (d + kPUnits - 1) / kPUnits;
  const auto kernel = fwd_persistent<RB>;
  const cudaError_t err =
      cooperative_ready(cache, kernel, smem, nblk, S, arrived, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&pre_x, &r_w, &c0, &n0, &m0, &h0, &y,  &c,     &n,
                  &m,     &h,   &pres, &cs, &ns, &ms, &arrived, &B, &S,
                  &d,     &dpad, &save};
  return cudaLaunchCooperativeKernel((const void*)kernel,
                                     dim3(nblk), dim3(kPThreads), args, smem,
                                     st);
}

// ---------------------------------------------------------------------------
// The persistent backward
// ---------------------------------------------------------------------------

// Floats of dynamic shared memory of the persistent backward for `rows`
// (1, 2, 4, 8) rows at width d: the block's kPUnits rows of r_w (4d floats
// each) and the warps' partial sums (kPWarps x rows x kPUnits).
// xlstm_scan.slstm_bwd_persistent_smem repeats this count for the route.
constexpr long long bwd_persistent_floats(int rows, int d) {
  return 4LL * kPUnits * d + static_cast<long long>(kPWarps) * rows * kPUnits;
}

// A reduce-scatter over a warp's lanes, level after level from offset O:
// v holds N partial sums a lane (N a power of 2); at a level a lane keeps
// the half of its sums that its bit O selects and adds its partner's copy
// of that half, so each lane ends with max(N / 32, 1) sums over the whole
// warp, those of the indices base + k (the lanes that differ only in the
// bits past N's levels hold the same sums).  N - 1 shuffles, plus one a
// level past N's, in place of 5 N for N separate warp sums.
template <int N, int O, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[M], int lane,
                                               int& base) {
  if constexpr (O > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2>(v, lane, base);
    } else {
      constexpr int H = N / 2;
      const bool hi = lane & O;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = hi ? v[k] : v[k + H];
        const float keep = hi ? v[k + H] : v[k];
        v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (hi) base += H;
      reduce_scatter<H, O / 2>(v, lane, base);
    }
  }
}

// RB: rows (B rounded up to 1, 2, 4 or 8).  The step backward's arguments
// (dpre 16-byte aligned), without the carries' scratch; arrived: the grid
// barrier's counter, zero at the launch (after reversed step k each block
// adds 1; S gridDim.x stays below 2^31).  grid ceil(d / kPUnits) blocks
// (co-resident), kPThreads threads, bwd_persistent_floats(RB, d) floats of
// dynamic shared memory.
template <int RB>
__global__ void __launch_bounds__(kPThreads, 1) bwd_persistent(
    const float* __restrict__ dy, const float* __restrict__ r_w,
    const float* __restrict__ pres, const float* __restrict__ cs,
    const float* __restrict__ ns, const float* __restrict__ msv,
    const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, float* dpre, int* arrived, int B, int S,
    int d) {
  constexpr int kN = RB * kPUnits;           // (row, unit) sums: b * 8 + u
  constexpr int kKeep = kN >= 32 ? kN / 32 : 1;  // of them a lane keeps
  constexpr int kG = RB >= 8 ? 1 : 2;        // 16-byte columns in flight
  constexpr int kEWarps = (kN + 31) / 32;    // warps of the units' threads
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                            // [kPUnits][4d]: rows j0 + u
  float* red = rs + 4LL * kPUnits * d;       // [kPWarps][kN]
  const int nblk = gridDim.x, j0 = blockIdx.x * kPUnits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d4 = 4LL * d;

  // r_w's rows, once a call; units beyond d are zeros
  for (long long i = tid; i < kPUnits * d4; i += kPThreads)
    rs[i] = j0 + i / d4 < d ? r_w[j0 * d4 + i] : 0.f;

  // thread tid < kN updates row tid / 8 of unit j0 + tid % 8, its dc, dn,
  // dm kept in registers for the whole sequence
  const int eb = tid / kPUnits, ej = j0 + tid % kPUnits;
  const bool upd = tid < kN && eb < B && ej < d;
  float dc = 0.f, dn = 0.f, dm = 0.f;
  BwdIn in{};
  if (upd) in = bwd_inputs(dy, pres, cs, ns, msv, c0, n0, m0, eb, ej, S, d,
                           S - 1);
  const float4* rs4 = reinterpret_cast<const float4*>(rs);

  for (int t = S - 1; t >= 0; --t) {
    float dhr = 0.f;
    if (t + 1 < S) {
      if (tid == 0) {
        // every block's dpre_{t+1} is stored: S - 1 - t arrivals from each
        const long long start = clock64();
        while (ld_acquire(arrived) < (S - 1 - t) * nblk) {
          // a block that never arrives is a fault, not a wait: stop the
          // kernel with an error after ~10 s rather than hang the card
          if (clock64() - start > kSpinLimit) __trap();
        }
      }
      __syncthreads();
      // dh_r[b][u] = sum over 4d columns of dpre_{t+1}[b] r_w[j0 + u]: a
      // thread's 16-byte columns c, every row's loads in flight, read past
      // L1
      float acc[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k] = 0.f;
      for (int c = tid; c < d; c += kG * kPThreads) {
        float4 x[kG][RB];
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            const int cc = c + g * kPThreads;
            x[g][b] = cc < d && b < B
                          ? __ldcg(reinterpret_cast<const float4*>(
                                       dpre + (static_cast<long long>(b) * S
                                               + t + 1) * d4) + cc)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int cc = c + g * kPThreads;
          if (cc < d) {
#pragma unroll
            for (int u = 0; u < kPUnits; ++u) {
              const float4 r = rs4[static_cast<long long>(u) * d + cc];
#pragma unroll
              for (int b = 0; b < RB; ++b) {
                float a = acc[b * kPUnits + u];
                a = fmaf(x[g][b].x, r.x, a);
                a = fmaf(x[g][b].y, r.y, a);
                a = fmaf(x[g][b].z, r.z, a);
                a = fmaf(x[g][b].w, r.w, a);
                acc[b * kPUnits + u] = a;
              }
            }
          }
        }
      }
      int base = 0;
      reduce_scatter<kN, 16>(acc, lane, base);
#pragma unroll
      for (int k = 0; k < kKeep; ++k) red[warp * kN + base + k] = acc[k];
      __syncthreads();
      if (tid < kN) {
#pragma unroll
        for (int w = 0; w < kPWarps; ++w) dhr += red[w * kN + tid];
      }
    }
    if (warp < kEWarps) {
      if (upd)
        bwd_unit(in, dhr, dc, dn, dm,
                 dpre + (static_cast<long long>(eb) * S + t) * d4, d, ej);
      // arrive once the units' warps have stored their dpre_t (bar.sync 1
      // among them; the release add orders the stores the barrier saw
      // before it, as the forward's)
      asm volatile("bar.sync 1, %0;" ::"r"(kEWarps * 32) : "memory");
      if (tid == 0 && t > 0) red_release_add(arrived, 1);
      // step t - 1's inputs, off the critical path: in flight while the
      // block waits at the next barrier
      if (upd && t > 0)
        in = bwd_inputs(dy, pres, cs, ns, msv, c0, n0, m0, eb, ej, S, d,
                        t - 1);
    }
  }
}

template <int RB>
cudaError_t launch_bwd_persistent(const float* dy, const float* r_w,
                                  const float* pres, const float* cs,
                                  const float* ns, const float* ms,
                                  const float* c0, const float* n0,
                                  const float* m0, float* dpre, int* arrived,
                                  int B, int S, int d, cudaStream_t st) {
  static CoopCache cache;
  const size_t smem = sizeof(float) * bwd_persistent_floats(RB, d);
  const int nblk = (d + kPUnits - 1) / kPUnits;
  const auto kernel = bwd_persistent<RB>;
  const cudaError_t err =
      cooperative_ready(cache, kernel, smem, nblk, S, arrived, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&dy, &r_w, &pres, &cs, &ns, &ms, &c0, &n0,
                  &m0, &dpre, &arrived, &B, &S, &d};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblk),
                                     dim3(kPThreads), args, smem, st);
}

}  // namespace slstm
}  // namespace repro

// pre_x: (B, S, 4d) f32; r_w: (d, 4d); c0, n0, m0, h0: (B, d).  Writes y
// (B, S, d), the last c, n, m, h (B, d) and, with save, pres (B, S, 4d),
// cs, ns, ms (B, S, d).  S launches on the stream (and one copy of the
// last h).  Returns the first cudaError_t.
extern "C" int slstm_scan_forward(
    const void* pre_x, const void* r_w, const void* c0, const void* n0,
    const void* m0, const void* h0, void* y, void* c, void* n, void* m,
    void* h, void* pres, void* cs, void* ns, void* ms, int B, int S, int d,
    int save, void* stream) {
  using namespace repro::slstm;
  if (B < 1 || S < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const size_t smem = sizeof(float) * (B < kRows ? B : kRows) * d;
  cudaError_t err = repro::allow_smem(fwd_step, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  for (int t = 0; t < S; ++t) {
    const float* hprev =
        t == 0 ? cf(h0) : cf(y) + static_cast<long long>(t - 1) * d;
    const long long hstride = t == 0 ? d : static_cast<long long>(S) * d;
    fwd_step<<<grid, kFwdWarps * 32, smem, st>>>(
        cf(pre_x), cf(r_w), hprev, hstride, t == 0 ? cf(c0) : cf(c),
        t == 0 ? cf(n0) : cf(n), t == 0 ? cf(m0) : cf(m), f(y), f(c), f(n),
        f(m), f(pres), f(cs), f(ns), f(ms), B, S, d, t, save);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaMemcpy2DAsync(h, sizeof(float) * d,
                           cf(y) + static_cast<long long>(S - 1) * d,
                           sizeof(float) * S * d, sizeof(float) * d, B,
                           cudaMemcpyDeviceToDevice, st);
}

// The persistent forward: the step forward's arguments and arrived, a
// scratch int for the grid barrier (zeroed here on the stream).  B <= 8, and
// ceil(d / 8) blocks of 512 threads with their shared memory must be
// co-resident: otherwise it returns an error and launches nothing.  One
// cooperative launch.  Returns the first cudaError_t.
extern "C" int slstm_scan_forward_persistent(
    const void* pre_x, const void* r_w, const void* c0, const void* n0,
    const void* m0, const void* h0, void* y, void* c, void* n, void* m,
    void* h, void* pres, void* cs, void* ns, void* ms, void* arrived, int B,
    int S, int d, int save, void* stream) {
  using namespace repro::slstm;
  if (B < 1 || B > kPMaxRows || S < 1 || d < 1) return cudaErrorInvalidValue;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* fl = static_cast<int*>(arrived);
#define REPRO_SLSTM_PERSISTENT(RB)                                          \
  launch_persistent<RB>(cf(pre_x), cf(r_w), cf(c0), cf(n0), cf(m0), cf(h0), \
                        f(y), f(c), f(n), f(m), f(h), f(pres), f(cs), f(ns), \
                        f(ms), fl, B, S, d, save, st)
  if (B == 1) return REPRO_SLSTM_PERSISTENT(1);
  if (B == 2) return REPRO_SLSTM_PERSISTENT(2);
  if (B <= 4) return REPRO_SLSTM_PERSISTENT(4);
  return REPRO_SLSTM_PERSISTENT(8);
#undef REPRO_SLSTM_PERSISTENT
}

// dy: (B, S, d) f32; r_w: (d, 4d); pres (B, S, 4d), cs, ns, ms (B, S, d):
// the recorded forward's; c0, n0, m0: (B, d).  Writes dpre (B, S, 4d) (the
// gradient of pre_x); carries: (3, B, d) scratch for dc, dn, dm.  S
// launches on the stream.  Returns the first cudaError_t.
extern "C" int slstm_scan_backward(
    const void* dy, const void* r_w, const void* pres, const void* cs,
    const void* ns, const void* ms, const void* c0, const void* n0,
    const void* m0, void* dpre, void* carries, int B, int S, int d,
    void* stream) {
  using namespace repro::slstm;
  if (B < 1 || S < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  float* dc = static_cast<float*>(carries);
  float* dn = dc + static_cast<long long>(B) * d;
  float* dm = dn + static_cast<long long>(B) * d;
  cudaError_t err = cudaMemsetAsync(carries, 0, sizeof(float) * 3 * B * d, st);
  if (err != cudaSuccess) return err;
  // stage all 4d columns of dpre_{t+1}'s rows at once where they fit
  const int rows = B < kRows ? B : kRows;
  const int max_cols = (200 * 1024 / (4 * rows)) / 4 * 4;
  const int tc = 4 * d < max_cols ? 4 * d : max_cols;
  const size_t smem = sizeof(float) * rows * tc;
  if ((err = repro::allow_smem(bwd_step, smem)) != cudaSuccess) return err;
  const dim3 grid((d + kWarps - 1) / kWarps, (B + kRows - 1) / kRows);
  for (int t = S - 1; t >= 0; --t) {
    bwd_step<<<grid, kWarps * 32, smem, st>>>(
        cf(dy), cf(r_w), cf(pres), cf(cs), cf(ns), cf(ms), cf(c0), cf(n0),
        cf(m0), static_cast<float*>(dpre), dc, dn, dm, B, S, d, t, tc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The persistent backward: the step backward's arguments with arrived, a
// scratch int for the grid barrier (zeroed here on the stream), in place
// of the carries; dpre 16-byte aligned.  B <= 8, and ceil(d / 8) blocks of
// 512 threads with their shared memory must be co-resident: otherwise it
// returns an error and launches nothing.  One cooperative launch.  Returns
// the first cudaError_t.
extern "C" int slstm_scan_backward_persistent(
    const void* dy, const void* r_w, const void* pres, const void* cs,
    const void* ns, const void* ms, const void* c0, const void* n0,
    const void* m0, void* dpre, void* arrived, int B, int S, int d,
    void* stream) {
  using namespace repro::slstm;
  if (B < 1 || B > kPMaxRows || S < 1 || d < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dpre) % 16) return cudaErrorMisalignedAddress;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(dpre);
  int* fl = static_cast<int*>(arrived);
#define REPRO_SLSTM_BWD_PERSISTENT(RB)                                       \
  launch_bwd_persistent<RB>(cf(dy), cf(r_w), cf(pres), cf(cs), cf(ns),      \
                            cf(ms), cf(c0), cf(n0), cf(m0), dp, fl, B, S, d, \
                            st)
  if (B == 1) return REPRO_SLSTM_BWD_PERSISTENT(1);
  if (B == 2) return REPRO_SLSTM_BWD_PERSISTENT(2);
  if (B <= 4) return REPRO_SLSTM_BWD_PERSISTENT(4);
  return REPRO_SLSTM_BWD_PERSISTENT(8);
#undef REPRO_SLSTM_BWD_PERSISTENT
}
