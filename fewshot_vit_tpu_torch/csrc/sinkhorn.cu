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
// and w2 and one write of the flow. The problems are small (N = 9, 13, 25 on
// the shipped configurations, 38 with a feature pyramid, 196 over a 14 x 14
// map), so what a design must do is keep the lanes and the scheduler's slots
// busy: few instructions per exponential, few idle lanes.
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
// 2. General route (sinkhorn_kernel): every shape up to N1, N2 <= 232
//    (kMaxNodes: a problem's padded log_k fills one CTA's shared memory at
//    232). It serves pyramid configurations (38 nodes), larger encoder maps
//    (visformer_small's 14 x 14 = 196, 209 with a pyramid) and any forced
//    call.
//    - A problem is padded to NP (a template parameter: every 8 up to 64,
//      every 16 up to 176, then 200, 216 and 232; the smallest that holds
//      max(N1, N2)) and staged once as an NP x (NP + 1) tile of
//      log_k * log2(e) in shared memory, -inf in the padding, with f and g
//      beside it (0 in the padding). Lane t of a problem owns row t and
//      column t, NP lanes a problem: at N = 38, 2 of 40 idle, where the old
//      one-warp-per-problem kernel left 26 of 64 idle. Up to 64 nodes
//      several problems share a CTA (4 at NP = 40 and 56, 2 at 48; 160 to
//      224 threads) and one problem's lanes may straddle two warps; beyond
//      64 one problem takes a CTA.
//    - Both passes read 32 distinct banks: the row stride NP + 1 is odd and
//      NP a multiple of 8, so lane g of a CTA reads word g * (NP + 1) + j in
//      the row pass and g + i * (NP + 1) (plus a multiple of 32) in the
//      column pass. The potentials are read as 16-byte broadcasts.
//    - One log-sum-exp per lane and half-round, as the packed route's:
//      x = log_k + pot is computed once and kept in registers (up to
//      kCache = 192 values, beyond that read again for the sum), four
//      partial maxima and four partial sums (element j on chain j % 4),
//      ex2.approx / lg2.approx, in the TPU kernel's order (max, sum of
//      2^(x - m), m + log2(sum)). The loops run over all NP elements,
//      fully unrolled: the smem offsets are immediates and no guard splits
//      the schedule.
//    - __syncthreads() between the half-rounds: the CTA's problems move in
//      step. Lanes beyond N1 (N2) hold all -inf rows (columns): their NaN is
//      dropped for 0, which keeps -inf + 0 = -inf in the other pass.
//    - What bounds it: the special-function units (two exponentials per
//      element and round); the issue slots come next (about six instructions
//      per element), shared memory (one read per element and pass, half the
//      special-function time) after them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// ---------------------------------------------------------------------------
// General route: N1, N2 <= kMaxNodes
// ---------------------------------------------------------------------------

constexpr int kMaxNodes = 232;  // NP x (NP + 1) floats of log_k plus 2 NP potentials <= 227 KB
constexpr int kCache = 192;     // x values a lane keeps in registers through a log-sum-exp
constexpr int kGeneralThreads = 256;

// problems a CTA holds at padded size NP: up to 64 nodes as many as fill
// whole warps (NP = 40: 4 problems in 160 threads), beyond that one
template <int NP>
__host__ __device__ constexpr int general_problems() {
  return NP == 40 ? 4 : NP == 48 ? 2 : NP == 56 ? 4 : 1;
}

// log2(sum_j 2^(lk[j * STEP] + pot[j])) over j < NP, in the order of the TPU
// kernel's lse: the maximum m, then the sum of 2^(x - m), then m +
// log2(sum). x is computed once and kept for the sum up to kCache values;
// beyond that it is computed again. Element j goes to partial chain j % 4 of
// the maximum and of the sum. The length is the template's, not the
// problem's: a runtime guard per chunk made the kernel 10-20% slower on an
// H100 (the padding is -inf and adds 0).
template <int NP, int STEP>
__device__ __forceinline__ float lse2_general(const float* __restrict__ lk,
                                              const float* __restrict__ pot) {
  constexpr int C = NP < kCache ? NP : kCache;
  const float4* pot4 = reinterpret_cast<const float4*>(pot);
  float x[C];
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float4 p = pot4[q];
    const float v[4] = {lk[(4 * q) * STEP] + p.x, lk[(4 * q + 1) * STEP] + p.y,
                        lk[(4 * q + 2) * STEP] + p.z, lk[(4 * q + 3) * STEP] + p.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < C) x[4 * q + k] = v[k];
      m[k] = fmaxf(m[k], v[k]);
    }
  }
  const float mx = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < C; ++j) s[j & 3] += ex2(x[j] - mx);
#pragma unroll
  for (int j = C; j < NP; ++j) s[j & 3] += ex2((lk[j * STEP] + pot[j]) - mx);
  return mx + lg2((s[0] + s[1]) + (s[2] + s[3]));
}

template <int NP>
__global__ void __launch_bounds__(kGeneralThreads)
sinkhorn_kernel(const float* __restrict__ cost, const float* __restrict__ w1,
                const float* __restrict__ w2, float* __restrict__ flow, int batch, int n1,
                int n2, float reg, int iters) {
  constexpr int kStride = NP + 1;  // odd, and NP a multiple of 8: see the design note
  constexpr int kP = general_problems<NP>();
  constexpr int kTile = NP * kStride;
  extern __shared__ __align__(16) float smem[];
  float* tiles = smem;                // kP tiles of log_k * log2(e)
  float* fs = smem + kP * kTile;      // kP x NP potentials f, then g
  float* gs = fs + kP * NP;
  const int tid = threadIdx.x;
  const int p = tid / NP;             // which of the CTA's problems
  const int t = tid - p * NP;         // the row and column this lane owns
  const long long b0 = (long long)blockIdx.x * kP;
  const long long b = b0 + p;
  const bool active = p < kP;         // lanes beyond the CTA's problems only meet the barriers
  const bool valid = active && b < batch;
  const int nn = n1 * n2;

  for (int e = tid; e < kP * kTile; e += blockDim.x) tiles[e] = -INFINITY;
  for (int e = tid; e < 2 * kP * NP; e += blockDim.x) fs[e] = 0.f;
  __syncthreads();
  const long long nb = batch - b0 < kP ? batch - b0 : kP;  // the CTA's problems, contiguous in cost
  const float* cb = cost + b0 * nn;
  for (int e = tid; e < nb * nn; e += blockDim.x) {
    const int q = e / nn;
    const int r = e - q * nn;
    const int i = r / n2;
    tiles[q * kTile + i * kStride + (r - i * n2)] = (-cb[e] / reg) * kLog2e;
  }
  const float lw1 = valid && t < n1 ? log2f(w1[b * n1 + t]) : 0.f;
  const float lw2 = valid && t < n2 ? log2f(w2[b * n2 + t]) : 0.f;
  __syncthreads();

  const float* lk = tiles + (active ? p : 0) * kTile;
  float* f = fs + (active ? p : 0) * NP;
  float* g = gs + (active ? p : 0) * NP;
  float gt = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (active) {
      const float ft = lw1 - lse2_general<NP, 1>(lk + t * kStride, g);
      f[t] = t < n1 ? ft : 0.f;
    }
    __syncthreads();
    if (active) {
      gt = lw2 - lse2_general<NP, kStride>(lk + t, f);
      gt = t < n2 ? gt : 0.f;
      g[t] = gt;
    }
    __syncthreads();
  }

  // lane t writes column t: consecutive lanes, consecutive addresses
  if (valid && t < n2) {
    float* ob = flow + b * nn;
    for (int i = 0; i < n1; ++i) ob[i * n2 + t] = ex2((lk[i * kStride + t] + f[i]) + gt);
  }
}

template <int NP>
cudaError_t general_launch(const float* cost, const float* w1, const float* w2, float* flow,
                           int batch, int n1, int n2, float reg, int iters, cudaStream_t stream) {
  constexpr int kP = general_problems<NP>();
  constexpr int kThreads = kP > 1 ? kP * NP : (NP + 31) / 32 * 32;
  const size_t smem = sizeof(float) * size_t(kP) * (NP * (NP + 1) + 2 * NP);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = unsigned((batch + kP - 1) / kP);
  sinkhorn_kernel<NP><<<blocks, kThreads, smem, stream>>>(cost, w1, w2, flow, batch, n1, n2, reg,
                                                          iters);
  return cudaGetLastError();
}

// the padded sizes: every 8 up to 64, every 16 to 176, then 200 (visformer_small's
// 14 x 14 = 196 nodes), 216 (209 with a feature pyramid) and kMaxNodes
cudaError_t general_route(const float* c, const float* a, const float* b, float* out, int batch,
                          int n1, int n2, float reg, int iters, cudaStream_t s) {
  const int n = n1 > n2 ? n1 : n2;
#define SINKHORN_GENERAL_SIZE(NP) \
  if (n <= NP) return general_launch<NP>(c, a, b, out, batch, n1, n2, reg, iters, s)
  SINKHORN_GENERAL_SIZE(40);
  SINKHORN_GENERAL_SIZE(48);
  SINKHORN_GENERAL_SIZE(56);
  SINKHORN_GENERAL_SIZE(64);
  SINKHORN_GENERAL_SIZE(80);
  SINKHORN_GENERAL_SIZE(96);
  SINKHORN_GENERAL_SIZE(112);
  SINKHORN_GENERAL_SIZE(128);
  SINKHORN_GENERAL_SIZE(144);
  SINKHORN_GENERAL_SIZE(160);
  SINKHORN_GENERAL_SIZE(176);
  SINKHORN_GENERAL_SIZE(200);
  SINKHORN_GENERAL_SIZE(216);
#undef SINKHORN_GENERAL_SIZE
  return general_launch<kMaxNodes>(c, a, b, out, batch, n1, n2, reg, iters, s);
}

}  // namespace

// cost (batch, n1, n2), w1 (batch, n1), w2 (batch, n2), flow (batch, n1, n2):
// contiguous float32 device arrays. route: 0 = general (N1, N2 <= 232),
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
  return general_route(c, a, b, out, batch, n1, n2, reg, iters, s);
}
