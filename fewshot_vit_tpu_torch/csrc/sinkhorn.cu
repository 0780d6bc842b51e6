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
// fp32 throughout, IEEE division, expf/logf (no fast-math intrinsics).
//
// What bounds it: every round evaluates 2 * N1 * N2 exponentials against
// (N1 * N2 + N1 + N2) floats read from and N1 * N2 written to device memory
// once per problem, so over 100 rounds the special-function units (16 exp2
// per clock per SM), not the bytes, set the least time. All rounds therefore
// run on-chip, as in the TPU kernel: device memory sees one read of cost, w1
// and w2 and one write of the flow.
//
// Design: one warp per problem, kWarps problems per CTA, no block-wide
// synchronisation. The warp stages log_k once in shared memory at an odd row
// stride (N2 | 1), so the row pass (lane i walks row i) and the column pass
// (lane j walks column j) both read 32 distinct banks. Each lane owns rows
// lane and lane + 32 (N1, N2 <= 64); f and g sit in shared memory next to
// log_k, written by their owning lane and read as broadcasts by the others,
// with __syncwarp() between the two half-rounds. The log marginals stay in
// the owning lane's registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

}  // namespace

// cost (batch, n1, n2), w1 (batch, n1), w2 (batch, n2), flow (batch, n1, n2):
// contiguous float32 device arrays. Launches on `stream` of `device` and
// returns cudaGetLastError().
extern "C" int sinkhorn_forward(int device, const void* cost, const void* w1, const void* w2,
                                void* flow, int batch, int n1, int n2, float reg, int iters,
                                void* stream) {
  if (batch < 1 || n1 < 1 || n1 > kMaxNodes || n2 < 1 || n2 > kMaxNodes || iters < 0 ||
      !(reg > 0.f))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int stride = n2 | 1;
  const size_t smem = sizeof(float) * kWarps * size_t(n1 * stride + n1 + n2);
  err = cudaFuncSetAttribute(sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = unsigned((batch + kWarps - 1) / kWarps);
  sinkhorn_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<float*>(flow), batch, n1, n2, reg, iters);
  return cudaGetLastError();
}
