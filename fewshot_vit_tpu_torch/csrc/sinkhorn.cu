// Log-domain Sinkhorn over a flat batch of small transport problems, CUDA C++
// for sm_90a.
//
// Replaces fewshot_vit_tpu/kernels/sinkhorn.py::_sinkhorn_kernel (the Pallas
// TPU kernel behind sinkhorn_pallas), with its math in its order. Per problem:
//   log_k = -cost / reg;  f = g = 0;  then `iters` rounds of
//     f_i = log w1_i - LSE_j(log_k_ij + g_j)
//     g_j = log w2_j - LSE_i(log_k_ij + f_i)
//   with LSE(x) = m + log(sum exp(x - m)), m = max x;
//   flow_ij = exp((log_k_ij + f_i) + g_j).
// fp32 throughout, IEEE division for -cost / reg.
//
// What bounds it: every round evaluates 2 * N1 * N2 exponentials against
// (N1 * N2 + N1 + N2) floats read from and N1 * N2 written to device memory
// once per problem, so over 100 rounds the special-function units (16 exp2
// per clock per SM), not the bytes, set the least time. All rounds therefore
// run on-chip, as in the TPU kernel: device memory sees one read of cost, w1
// and w2 and one write of the flow. The problems are smaller than a warp
// (N = 9, 13, 25), so what a design must do is keep the lanes and the
// scheduler's slots busy: few instructions per exponential, no idle lanes.
//
// Two routes, chosen by the Python wrapper (kernels/sinkhorn.py) from the
// shape, never silently:
//
// 1. Packed route (sinkhorn_packed_kernel): N1, N2 <= 32.
//    - Lanes are packed: for N1, N2 <= 16 a warp holds two problems, one per
//      half-warp, in step; up to 32 one problem. 26 of 32 lanes work at
//      N = 13.
//    - Lane i owns row i (for the row pass) and column i (for the column
//      pass) of log_k, padded to 16 or 32 with -inf by a template parameter,
//      so both loops unroll fully and carry no bounds test. The column is in
//      registers; the row too at 16, and at 32 it is read from a
//      conflict-free shared-memory tile (64 registers of log_k would cost a
//      quarter of the resident warps). x_j = log_k_ij + g_j is computed once
//      and kept for the maximum and the sum. f and g travel as 16-byte
//      broadcast loads from 2 x 32 floats of shared memory per warp. Lanes
//      beyond N hold all -inf rows: their result (NaN) is dropped for 0.
//    - Base-2 domain: log_k is scaled by log2(e) once, the log marginals are
//      log2, and every exponential and logarithm is one special-function
//      instruction (ex2.approx, lg2.approx) instead of expf/logf's ten.
//      The order of the TPU kernel's arithmetic is kept (max, sum of
//      2^(x - m), m + log2(sum), flow 2^((log_k + f) + g)). Against the plain
//      version the flow moves by at most 7e-6, as with expf/logf (6e-6).
//    - One warp per CTA: 1500 (N <= 16) or 3000 CTAs spread evenly over the
//      SMs and all are resident at once (69 and 80 registers a thread).
//
// 2. General route (sinkhorn_kernel): N1, N2 <= 64 (pyramid configurations
//    reach 38), expf/logf. One warp per problem, kWarps problems per CTA, no
//    block-wide synchronisation. The warp stages log_k once in shared memory
//    at an odd row stride (N2 | 1), so the row pass (lane i walks row i) and
//    the column pass (lane j walks column j) both read 32 distinct banks.
//    Each lane owns rows lane and lane + 32; f and g sit in shared memory
//    next to log_k, written by their owning lane and read as broadcasts by
//    the others, with __syncwarp() between the two half-rounds. The log
//    marginals stay in the owning lane's registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ---- general route ----
constexpr int kWarps = 4;      // problems per CTA
constexpr int kMaxNodes = 64;  // N1, N2 limit: two rows or columns per lane
constexpr int kSlots = kMaxNodes / 32;

__global__ void __launch_bounds__(kWarps * 32)
sinkhorn_kernel(const float* __restrict__ cost, const float* __restrict__ w1,
                const float* __restrict__ w2, float* __restrict__ flow, int batch,
                int n1, int n2, float reg, int iters) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= batch) return;
  const int stride = n2 | 1;  // odd: see the design note
  float* lk = smem + warp * (n1 * stride + n1 + n2);
  float* f = lk + n1 * stride;
  float* g = f + n1;
  const int nn = n1 * n2;

  const float* cb = cost + b * nn;
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n2;
    lk[i * stride + (e - i * n2)] = -cb[e] / reg;
  }
  float lw1[kSlots], lw2[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int r = lane + 32 * s;
    lw1[s] = r < n1 ? logf(w1[b * n1 + r]) : 0.f;
    lw2[s] = r < n2 ? logf(w2[b * n2 + r]) : 0.f;
    if (r < n1) f[r] = 0.f;
    if (r < n2) g[r] = 0.f;
  }
  __syncwarp();

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {  // rows: f_i from g
      const int i = lane + 32 * s;
      if (i < n1) {
        const float* row = lk + i * stride;
        float m = -INFINITY;
        for (int j = 0; j < n2; ++j) m = fmaxf(m, row[j] + g[j]);
        float sum = 0.f;
        for (int j = 0; j < n2; ++j) sum += expf(row[j] + g[j] - m);
        f[i] = lw1[s] - (m + logf(sum));
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {  // columns: g_j from f
      const int j = lane + 32 * s;
      if (j < n2) {
        float m = -INFINITY;
        for (int i = 0; i < n1; ++i) m = fmaxf(m, lk[i * stride + j] + f[i]);
        float sum = 0.f;
        for (int i = 0; i < n1; ++i) sum += expf(lk[i * stride + j] + f[i] - m);
        g[j] = lw2[s] - (m + logf(sum));
      }
    }
    __syncwarp();
  }

  float* ob = flow + b * nn;
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n2;
    const int j = e - i * n2;
    ob[e] = expf((lk[i * stride + j] + f[i]) + g[j]);
  }
}

// ---------------------------------------------------------------------------
// Packed route: N1, N2 <= 32
// ---------------------------------------------------------------------------

constexpr int kPackedWarps = 1;  // warps per CTA: no block-wide step, so small CTAs spread best
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// log2(sum_j 2^(lk(j) + pot[j])) over a lane's NP values of log_k, pot read
// as 16-byte broadcasts from shared memory. x = lk + pot is computed once and
// kept for the maximum and the sum; four partial maxima and sums shorten the
// dependent chains.
template <int NP, typename Lk>
__device__ __forceinline__ float lse2(Lk lk, const float* pot) {
  float x[NP];
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(pot)[q];
    x[4 * q] = lk(4 * q) + t.x;
    x[4 * q + 1] = lk(4 * q + 1) + t.y;
    x[4 * q + 2] = lk(4 * q + 2) + t.z;
    x[4 * q + 3] = lk(4 * q + 3) + t.w;
  }
  float m[4] = {x[0], x[1], x[2], x[3]};
#pragma unroll
  for (int j = 4; j < NP; ++j) m[j & 3] = fmaxf(m[j & 3], x[j]);
  const float mx = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NP; ++j) s[j & 3] += ex2(x[j] - mx);
  return mx + lg2((s[0] + s[1]) + (s[2] + s[3]));
}

// NP lanes per problem (16: two problems per warp, one per half-warp; 32: one).
// Lane i of a problem owns row i and column i of log_k, padded to NP with
// -inf, in the base-2 domain (log_k * log2(e)). The column sits in registers.
// The row sits in registers too at NP = 16; at NP = 32 a second 32 registers
// would cost a quarter of the resident warps, so the row is read from the
// warp's shared-memory tile (row stride 33: lane i's j-th word is in bank
// (i + j) % 32, no conflicts). f and g travel through 2 x 32 floats of shared
// memory per warp.
template <int NP>
__global__ void __launch_bounds__(kPackedWarps * 32)
sinkhorn_packed_kernel(const float* __restrict__ cost, const float* __restrict__ w1,
                       const float* __restrict__ w2, float* __restrict__ flow, int batch, int n1,
                       int n2, float reg, int iters) {
  constexpr int kLd = NP + 1;  // odd row stride of the staged tile
  constexpr int kPerWarp = 32 / NP;
  __shared__ __align__(16) float fs[kPackedWarps][32];
  __shared__ __align__(16) float gs[kPackedWarps][32];
  __shared__ float tiles[kPackedWarps][kPerWarp * NP * kLd];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane / NP;     // which of the warp's problems
  const int li = lane - half * NP;  // row and column this lane owns
  const long long b0 = ((long long)blockIdx.x * kPackedWarps + warp) * kPerWarp;
  const long long b = b0 + half;
  const bool valid = b < batch;   // an odd batch leaves the last half-warp without a problem
  const bool row_on = valid && li < n1;
  const bool col_on = valid && li < n2;
  const int nn = n1 * n2;

  // stage log_k * log2(e) with coalesced reads; everything beyond (n1, n2) is -inf
  float* tile = tiles[warp];
  for (int e = lane; e < kPerWarp * NP * kLd; e += 32) tile[e] = -INFINITY;
  __syncwarp();
  for (int p = 0; p < kPerWarp; ++p) {
    if (b0 + p >= batch) break;
    const float* cb = cost + (b0 + p) * nn;
    for (int e = lane; e < nn; e += 32) {
      const int i = e / n2;
      tile[(p * NP + i) * kLd + (e - i * n2)] = (-cb[e] / reg) * kLog2e;
    }
  }
  __syncwarp();
  const float* mine = tile + half * NP * kLd;
  float lkc[NP];  // column li
#pragma unroll
  for (int i = 0; i < NP; ++i) lkc[i] = mine[i * kLd + li];
  const float* row = mine + li * kLd;
  float lkr[NP <= 16 ? NP : 1];  // row li, in registers at NP = 16
  if constexpr (NP <= 16) {
#pragma unroll
    for (int j = 0; j < NP; ++j) lkr[j] = row[j];
  }
  const float lw1 = row_on ? log2f(w1[b * n1 + li]) : 0.f;
  const float lw2 = col_on ? log2f(w2[b * n2 + li]) : 0.f;
  float* fw = fs[warp];
  float* gw = gs[warp];
  const float* fh = fw + half * NP;  // this problem's potentials
  const float* gh = gw + half * NP;
  float g = 0.f;
  fw[lane] = 0.f;
  gw[lane] = 0.f;
  __syncwarp();

  // Lanes beyond N1 (N2) hold an all -inf row (column): their sum is NaN and
  // is dropped for 0, which keeps -inf + 0 = -inf in the other pass.
  for (int it = 0; it < iters; ++it) {
    float f;
    if constexpr (NP <= 16) {
      f = lw1 - lse2<NP>([&](int j) { return lkr[j]; }, gh);
    } else {
      f = lw1 - lse2<NP>([&](int j) { return row[j]; }, gh);
    }
    fw[lane] = row_on ? f : 0.f;
    __syncwarp();
    g = lw2 - lse2<NP>([&](int i) { return lkc[i]; }, fh);
    g = col_on ? g : 0.f;
    gw[lane] = g;
    __syncwarp();
  }

  // lane j writes column j: consecutive lanes, consecutive addresses
  float* ob = flow + (valid ? b : 0) * nn;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (col_on && i < n1) ob[i * n2 + li] = ex2((lkc[i] + fh[i]) + g);
}

template <int NP>
cudaError_t packed_launch(const float* cost, const float* w1, const float* w2, float* flow,
                          int batch, int n1, int n2, float reg, int iters, cudaStream_t stream) {
  constexpr int kPerCta = kPackedWarps * (32 / NP);
  const unsigned blocks = unsigned((batch + kPerCta - 1) / kPerCta);
  sinkhorn_packed_kernel<NP><<<blocks, kPackedWarps * 32, 0, stream>>>(cost, w1, w2, flow, batch,
                                                                      n1, n2, reg, iters);
  return cudaGetLastError();
}

}  // namespace

// cost (batch, n1, n2), w1 (batch, n1), w2 (batch, n2), flow (batch, n1, n2):
// contiguous float32 device arrays. route: 0 = general (N1, N2 <= 64),
// 1 = packed (N1, N2 <= 32). Launches on `stream` of `device` and returns
// cudaGetLastError().
extern "C" int sinkhorn_forward(int device, int route, const void* cost, const void* w1,
                                const void* w2, void* flow, int batch, int n1, int n2, float reg,
                                int iters, void* stream) {
  if (batch < 1 || n1 < 1 || n1 > kMaxNodes || n2 < 1 || n2 > kMaxNodes || iters < 0 ||
      !(reg > 0.f) || (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* c = static_cast<const float*>(cost);
  const float* a = static_cast<const float*>(w1);
  const float* b = static_cast<const float*>(w2);
  float* out = static_cast<float*>(flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const int n = n1 > n2 ? n1 : n2;
    if (n > 32) return cudaErrorInvalidValue;
    if (n <= 16) return packed_launch<16>(c, a, b, out, batch, n1, n2, reg, iters, s);
    return packed_launch<32>(c, a, b, out, batch, n1, n2, reg, iters, s);
  }
  const int stride = n2 | 1;
  const size_t smem = sizeof(float) * kWarps * size_t(n1 * stride + n1 + n2);
  err = cudaFuncSetAttribute(sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = unsigned((batch + kWarps - 1) / kWarps);
  sinkhorn_kernel<<<blocks, kWarps * 32, smem, s>>>(c, a, b, out, batch, n1, n2, reg, iters);
  return cudaGetLastError();
}
