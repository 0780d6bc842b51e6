// LayerNorm over the last axis from bf16 to bf16, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA (no
// pl.pallas_call), and the port ran it as three passes through device
// memory: x.float() (bf16 read, fp32 written), PyTorch's fp32 LayerNorm
// (fp32 read and written), .to(bf16) (fp32 read, bf16 written): 20 bytes an
// element. This kernel computes the same function in one pass, 4 bytes an
// element:
//
//   y[r, :] = bf16( w * ((x[r, :] - mean) * rsqrt(var + eps)) + b )
//
// with x read as bf16, the mean and the biased variance (two passes over the
// row held in registers: the mean, then the centred squares) in fp32, the
// fp32 weight and bias, and one rounding to bf16 on the store: the roundings
// of the three-pass path, with fp32 sums in another order.
//
// What bounds it: 2 bytes read and 2 written an element and a few flops,
// far under the H100's ~295 bf16 flops a byte: device-memory bytes set the
// least time, 4 bytes an element at 3.35 TB/s (a Swin-T batch of 2,560
// images at 224 px normalises 9.54 G elements: 11.4 ms). PyTorch's
// LayerNorm gives a CTA to each row, so at Swin's widths (96 to 1,536
// values) its cost follows rows, not bytes. The design is for bytes:
// - A row is spread over `lanes` threads of one warp (a power of two, up to
//   32), each holding V 16-byte vectors of 8 values (thread l of a row holds
//   vectors l, l + lanes, ...): a 96-wide row is 4 threads of 3 vectors, a
//   768-wide row a warp of 3 vectors, 1,536 a warp of 6. Neighbouring
//   threads load and store neighbouring 16-byte vectors, so a warp's access
//   covers whole 32-byte sectors.
// - The row's sums are reduced over its threads by xor shuffles, within the
//   aligned group of lanes, so no shared memory and no barrier per row.
// - A CTA of 256 threads does 256 / lanes rows a step and walks the rows
//   with a grid stride; the grid is as many CTAs as the SMs hold at once, so
//   the fp32 weight and bias are staged in shared memory once a CTA (as two
//   planes of float4, conflict-free) and every SM keeps tens of KB of loads
//   in flight.
// - Widths: every multiple of 8 up to 2,048 (V up to 8; vectors past the
//   row's end are masked). Any row count: the whole CTA steps together, and
//   the rows past the end load nothing and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;       // 16-byte vectors a thread: widths up to 32 * 8 * 8
constexpr int kMaxWidth = 32 * kMaxVec * 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);             // the low half: element 2i
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const unsigned*>(&p);
}

// the sum over the aligned group of `lanes` threads that holds one row
__device__ __forceinline__ float group_sum(float s, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const uint4* __restrict__ x, const float* __restrict__ weight,
                      const float* __restrict__ bias, uint4* __restrict__ y, long long rows,
                      int vecs, int lanes_log2, float eps) {
  // weight then bias, each as two planes of float4: [0, vecs) holds values
  // 0-3 of every vector, [vecs, 2 vecs) values 4-7
  extern __shared__ float4 wb[];
  const int c = vecs * 8;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const int slot = ((i & 7) >> 2) * vecs + (i >> 3);
    reinterpret_cast<float*>(wb + slot)[i & 3] = weight[i];
    reinterpret_cast<float*>(wb + 2 * vecs + slot)[i & 3] = bias[i];
  }
  __syncthreads();

  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads >> lanes_log2;  // rows a CTA step
  const int group = threadIdx.x >> lanes_log2;
  const float inv_c = 1.f / float(c);
  const float4* sw = wb;
  const float4* sb = wb + 2 * vecs;

  // the CTA steps together, so every lane of a warp reaches every shuffle
  for (long long base = (long long)blockIdx.x * groups; base < rows;
       base += (long long)gridDim.x * groups) {
    const long long row = base + group;
    const bool live = row < rows;
    const uint4* xr = x + row * vecs;
    float v[V][8];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + k * lanes;
      const uint4 u = (live && j < vecs) ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
      unpack8(u, v[k]);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[k][e];
    const float mean = group_sum(s, lanes) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (lane + k * lanes < vecs) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[k][e] - mean;
          q = fmaf(d, d, q);
        }
      }
    }
    const float rstd = rsqrtf(group_sum(q, lanes) * inv_c + eps);
    if (!live) continue;
    uint4* yr = y + row * vecs;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = lane + k * lanes;
      if (j >= vecs) continue;
      const float4 w0 = sw[j], w1 = sw[vecs + j], b0 = sb[j], b1 = sb[vecs + j];
      const float w8[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = fmaf(w8[e], (v[k][e] - mean) * rstd, b8[e]);
      yr[j] = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                         pack_bf16(o[6], o[7]));
    }
  }
}

// CTAs of layer_norm_kernel<V> an SM holds at once, per device: 0 unknown
int resident[kMaxDevices][kMaxVec + 1];
int sm_count[kMaxDevices];

template <int V>
cudaError_t launch(int device, const void* x, const float* w, const float* b, void* y,
                   long long rows, int vecs, int lanes_log2, float eps, cudaStream_t stream) {
  const size_t smem = size_t(4) * vecs * sizeof(float4);
  if (resident[device][V] == 0) {
    int n = 0, sms = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layer_norm_kernel<V>, kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sm_count[device] = sms;
    resident[device][V] = n > 0 ? n : 1;
  }
  const long long groups = kThreads >> lanes_log2;
  const long long steps = (rows + groups - 1) / groups;
  const long long full = (long long)sm_count[device] * resident[device][V];
  const unsigned grid = unsigned(steps < full ? steps : full);
  layer_norm_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(x), w, b, static_cast<uint4*>(y), rows, vecs, lanes_log2, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, c) bf16, contiguous, 16-byte aligned; weight, bias: (c,)
// float32, contiguous. c a multiple of 8, 8 <= c <= 2048; rows >= 0 (0
// launches nothing). Launches on `stream` of `device` and returns
// cudaGetLastError().
extern "C" int layer_norm_forward(int device, const void* x, const void* weight,
                                  const void* bias, void* y, long long rows, int c, float eps,
                                  void* stream) {
  if (device < 0 || device >= kMaxDevices || rows < 0 || c < 8 || c > kMaxWidth || c % 8)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(x) % 16 ||
      reinterpret_cast<unsigned long long>(y) % 16 ||
      reinterpret_cast<unsigned long long>(weight) % 4 ||
      reinterpret_cast<unsigned long long>(bias) % 4)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // at least 3 vectors a thread, at most a warp a row
  const int vecs = c / 8;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (6 << lanes_log2) <= vecs) ++lanes_log2;
  const int v = (vecs + (1 << lanes_log2) - 1) >> lanes_log2;
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 1: return launch<1>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 2: return launch<2>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 3: return launch<3>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 4: return launch<4>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 5: return launch<5>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 6: return launch<6>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 7: return launch<7>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    case 8: return launch<8>(device, x, w, b, y, rows, vecs, lanes_log2, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
