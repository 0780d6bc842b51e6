// Fused multi-head self-attention for short token axes, CUDA C++ for sm_90a.
//
// Replaces fewshot_vit_tpu/kernels/attention.py::_mhsa_kernel (the Pallas TPU
// kernel behind fused_mhsa): per (batch, head), o = softmax(q k^T * scale) v
// with fp32 scores, fp32 softmax and fp32 accumulation, output in the input
// dtype. In bf16 the probabilities are rounded to bf16 before the second
// product, as the TPU kernel's p.astype(v.dtype) does.
//
// What bounds it: at the visformer stage-2 shape (T=100, hd=42) one launch
// reads q, k, v and writes o once, 8 bytes per (b, h, t, d) element in bf16,
// and does 4*T*hd flops per row: about 50 flops per byte, under the H100's
// ~295 bf16 flops per byte, so the least time is set by bytes. This first
// version multiplies on the CUDA cores in fp32, not on the tensor cores, so
// it runs above that bound; tensor-core products (mma / wgmma) are later work.
//
// Design: one CTA of 8 warps per (batch*head, tile of 64 query rows); each
// warp owns 8 rows. The q tile is staged in shared memory as fp32, then K and
// then V in chunks of 32 keys. A row's scores for all keys stay in shared
// memory (T <= 512), so the softmax is the exact max / exp / sum / divide of
// the TPU kernel, not an online rescaling.
//   pass 1:  lane l scores key (chunk*32 + l) against the warp's 8 rows;
//   softmax: per row, max and sum by warp shuffle;
//   pass 2:  lane l accumulates output dims l, l+32, ... over the chunk's keys.
// Global rows are staged with scalar loads: hd=42 gives 84-byte (bf16) and
// 168-byte (fp32) rows, which are not 16-byte multiples, so no vector global
// load is assumed aligned. Ragged edges (T not a multiple of 32 or 64, hd not
// a multiple of 32) are zero-filled in shared memory and their keys masked
// with -inf scores. Inputs may be strided views: the wrapper passes element
// strides for (batch, head, token); the last dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kChunk = 32;                    // keys per staged chunk
constexpr int kMaxTokens = 512;
constexpr int kMaxHeadDim = 128;

struct Strides {  // element strides of (batch, head, token)
  long long b, h, t;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dst[r * dst_stride + d] = src[(row0 + r) * src_stride + d] as fp32, for
// r < nrows and d < width; zero where row0 + r >= n_tok or d >= hd.
template <typename T>
__device__ void stage_rows(float* dst, int dst_stride, int width, const T* src,
                           long long src_stride, int row0, int nrows, int n_tok, int hd) {
  for (int e = threadIdx.x; e < nrows * width; e += blockDim.x) {
    const int r = e / width;
    const int d = e - r * width;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_tok && d < hd) x = to_f(src[row * src_stride + d]);
    dst[r * dst_stride + d] = x;
  }
}

// NSLOT = ceil(hd / 32): output dims held by each lane in pass 2.
template <typename T, int NSLOT>
__global__ void __launch_bounds__(kWarps * 32)
mhsa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so,
            int n_heads, int n_tok, int hd, int n_tiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWidth = NSLOT * 32;       // staged K/V row width (zero padded)
  constexpr int kKvStride = kWidth + 1;    // odd: lane-per-key reads hit distinct banks
  const int hdp = (hd + 3) & ~3;           // q row stride, float4 aligned
  const int tp = (n_tok + kChunk - 1) / kChunk * kChunk;  // score row stride
  float* sc = smem;                        // kRows x tp: scores, then probabilities
  float* qs = sc + kRows * tp;             // kRows x hdp
  float* kvs = qs + kRows * hdp;           // kChunk x kKvStride

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int row0 = tile * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRowsPerWarp;    // first CTA-local row of this warp
  const bool active = row0 + wrow < n_tok;
  const int n_chunks = tp / kChunk;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  stage_rows(qs, hdp, hdp, qb, sq.t, row0, kRows, n_tok, hd);

  // pass 1: scores
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    stage_rows(kvs, kKvStride, kWidth, kb, sk.t, c * kChunk, kChunk, n_tok, hd);
    __syncthreads();
    if (!active) continue;
    float acc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
    const float* krow = kvs + lane * kKvStride;
    for (int d = 0; d < hdp; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (wrow + r) * hdp + d);
        acc[r] = fmaf(qv.x, k0, acc[r]);
        acc[r] = fmaf(qv.y, k1, acc[r]);
        acc[r] = fmaf(qv.z, k2, acc[r]);
        acc[r] = fmaf(qv.w, k3, acc[r]);
      }
    }
    const int key = c * kChunk + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      sc[(wrow + r) * tp + key] = key < n_tok ? acc[r] * scale : -INFINITY;
  }

  // softmax over each of the warp's rows
  __syncwarp();
  if (active) {
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float* srow = sc + (wrow + r) * tp;
      float m = -INFINITY;
      for (int j = lane; j < tp; j += 32) m = fmaxf(m, srow[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < tp; j += 32) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int j = lane; j < tp; j += 32) srow[j] = to_f(from_f<T>(srow[j] / s));
    }
  }

  // pass 2: o = p v
  float acc[kRowsPerWarp][NSLOT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) acc[r][i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    stage_rows(kvs, kKvStride, kWidth, vb, sv.t, c * kChunk, kChunk, n_tok, hd);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < kChunk; j += 4) {
      float vv[4][NSLOT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < NSLOT; ++i) vv[jj][i] = kvs[(j + jj) * kKvStride + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(sc + (wrow + r) * tp + c * kChunk + j);
#pragma unroll
        for (int i = 0; i < NSLOT; ++i) {
          acc[r][i] = fmaf(p.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(p.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(p.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(p.w, vv[3][i], acc[r][i]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + wrow + r;
    if (row >= n_tok) break;
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) ob[row * so.t + d] = from_f<T>(acc[r][i]);
    }
  }
}

template <typename T, int NSLOT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const long long* st,
                   int batch, int n_heads, int n_tok, int hd, float scale, cudaStream_t stream) {
  const int hdp = (hd + 3) & ~3;
  const int tp = (n_tok + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * (size_t(kRows) * tp + size_t(kRows) * hdp +
                                       size_t(kChunk) * (NSLOT * 32 + 1));
  cudaError_t err = cudaFuncSetAttribute(mhsa_kernel<T, NSLOT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_tok + kRows - 1) / kRows;
  const long long blocks = (long long)batch * n_heads * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  mhsa_kernel<T, NSLOT><<<unsigned(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, n_heads, n_tok, hd, n_tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const long long* st,
                     int batch, int n_heads, int n_tok, int hd, float scale, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, stream);
    default: return launch<T, 4>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, stream);
  }
}

}  // namespace

// q, k, v, o: (batch, heads, tokens, hd) device arrays of one dtype
// (0 = float32, 1 = bfloat16) whose last dim is contiguous; strides: 12 host
// int64s, the (batch, head, token) element strides of q, k, v, o in that
// order. Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int mhsa_forward(int dtype, int device, const void* q, const void* k, const void* v,
                            void* o, const long long* strides, int batch, int n_heads,
                            int n_tok, int hd, float scale, void* stream) {
  if (batch < 1 || n_heads < 1 || n_tok < 1 || n_tok > kMaxTokens || hd < 1 ||
      hd > kMaxHeadDim || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, strides, batch, n_heads, n_tok, hd, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, batch, n_heads, n_tok, hd, scale, s);
}
