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
// whole of the previous step's h: one launch per step, all launched from
// one host call on the stream (a captured decode step, S = 1, is one plain
// launch).  A block owns kUnits hidden units (their 4 kUnits columns of
// r_w, one per lane) and up to kRows batch rows; its warps split the
// reduction over d, each keeping 16 loads of r_w in flight (the loop
// unrolled), with h_{t-1} staged in shared memory; r_w (16 MiB at d =
// 1024) is read from L2 on every step.  A recorded forward (save) keeps
// every step's pre-activations and c, n, m for the backward.
//
// Backward, one launch per step from the last: the recurrent gradient
// dh_t = dy_t + dpre_{t+1} r_w^T (a warp per unit reading its row of r_w
// in 16-byte loads, dpre_{t+1} staged in shared memory), then the step's
// elementwise backward with dc, dn, dm carried per unit and row (the
// gradient of max to the larger side, half to each at a tie, as
// torch.maximum's and JAX's max's).  dr_w = sum_t h_{t-1}^T dpre_t is one
// matrix product after the kernel (xlstm_scan.py), as the other plain
// products of the port.
//
// Bound on the H100: latency per step.  A step reads r_w once (4 d^2
// floats) and does 8 B d^2 flops; at d = 1024 that is 16 MiB from L2,
// ~3 us at its rate, beside a launch; S steps of that are the floor of
// this design (r_w resident in shared memory across steps would remove
// the L2 read: a later redesign).  Built without fast math: exp(-1e30) is
// 0 and m is carried exactly, as in the plain version.
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
  const int b = lane;
  const long long row = static_cast<long long>(b0 + b) * S + t;
  const long long sb = static_cast<long long>(b0 + b) * d + j;
  const float dh = dy[row * d + j] + dhr;
  const float pz = pres[row * d4 + j], pi = pres[row * d4 + d + j];
  const float pf = pres[row * d4 + 2 * d + j];
  const float po = pres[row * d4 + 3 * d + j];
  const float z = tanhf(pz), o = sigmoid(po);
  const float ct = cs[row * d + j], nt = ns[row * d + j];
  const float mt = msv[row * d + j];
  const float cp = t ? cs[(row - 1) * d + j] : c0[sb];
  const float np = t ? ns[(row - 1) * d + j] : n0[sb];
  const float mp = t ? msv[(row - 1) * d + j] : m0[sb];
  const float a = log_sigmoid(pf) + mp;
  const float fe = expf(a - mt), ie = expf(pi - mt);
  const float nn = fmaxf(nt, 1.f);
  const float d_o = dh * ct / nn;
  const float dct = dc[sb] + dh * o / nn;
  const float dnt = dn[sb] - dh * (o * ct) / (nn * nn) * tie_weight(nt, 1.f);
  const float dA = (dct * cp + dnt * np) * fe;
  const float dB = (dct * z + dnt) * ie;
  const float dmt = dm[sb] - dA - dB;
  const float wa = tie_weight(a, pi);
  const float da = dA + wa * dmt;
  dpre[row * d4 + j] = dct * ie * (1.f - z * z);
  dpre[row * d4 + d + j] = dB + (1.f - wa) * dmt;
  dpre[row * d4 + 2 * d + j] = da * sigmoid(-pf);
  dpre[row * d4 + 3 * d + j] = d_o * o * (1.f - o);
  dc[sb] = dct * fe;
  dn[sb] = dnt * fe;
  dm[sb] = da;
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
