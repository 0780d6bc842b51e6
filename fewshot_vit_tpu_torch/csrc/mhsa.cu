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
// ~295 bf16 flops per byte, so the least time is set by bytes. The rows are
// 84 bytes at a 1512-byte token stride inside the packed qkv tensor: 4-byte
// aligned, not 16-byte aligned, so neither 16-byte vector loads nor a TMA
// tensor map over the per-head view apply. With tensor-core products the
// arithmetic is a sixth of that time; what holds the kernel above its bound is
// the 4-byte load path (see below), which alone takes longer than the bound
// at that shape.
//
// Two routes, chosen by the Python wrapper (kernels/attention.py) from dtype
// and shape, never silently:
//
// 1. Tensor-core route (mhsa_tc_kernel): bf16, T <= 128, hd <= 128.
//    - Both products are mma.sync.m16n8k16 bf16 -> fp32. hd is zero-padded to
//      a multiple of 16 and the keys to a multiple of 16 in shared memory
//      only; padded keys get score -inf, padded head dims are never stored.
//    - One warp owns 16 query rows and holds its whole 16 x T score row block
//      in registers (at most 16 n-tiles x 4 fp32). Scale, mask, max and sum
//      across the quad by two shuffles each, exponentiate, normalise, round
//      to bf16: the accumulator layout of S is the A-operand layout of the
//      second mma, so scores and probabilities never touch shared memory.
//    - One CTA covers all of T for a head (7 warps at T = 100), so K and V
//      are staged once per head. Q, K, V sit in shared memory as bf16 at a
//      row stride of (padded hd + 8) elements, an odd number of 16-byte
//      units, so ldmatrix (Q, K) and ldmatrix.trans (V) are conflict-free.
//    - Producer and consumer warps. Three more warps of the CTA do nothing
//      but stage q, k, v: 4-byte cp.async (2-byte scalar loads when a
//      pointer, a stride or hd is odd) into a ring of three shared-memory
//      slots (two where three do not fit twice on an SM), announced to the
//      consumers through named barriers. Measured on the H100: 4-byte copies
//      back up in the load pipe, and a warp that sends them waits there, so
//      when the computing warps sent their own copies the kernel took the
//      sum of its load, compute and store times; with producers the three
//      overlap.
//    - CTAs are persistent: as many as the card holds at one time, CTA c
//      taking items c, c + gridDim.x, ... The CTAs that run together thus
//      work on neighbouring items, the heads of the same images, whose
//      84-byte rows share 32-byte sectors in L2.
//    - The output tile goes through the shared-memory rows of the warp's own
//      q (no other warp reads them) and out to device memory a whole 84-byte
//      row per instruction, through the (batch, head, token) strides; only
//      the hd real columns of a head are written.
//    - exp(x * scale - m) is 2^(x * c2 - m2) with c2 = scale * log2(e): one
//      multiply, one subtract and one ex2.approx per score; the row is
//      normalised by one reciprocal. Both errors are far below the bf16
//      rounding of the probabilities that follows.
//
// 2. General route (mhsa_kernel): fp32 at any shape (TF32 products would
//    break the 1e-4 agreement with the plain version) and bf16 with T > 128,
//    up to T = 512. fp32 FMAs on the CUDA cores. One CTA of 8 warps per
//    (batch*head, tile of 64 query rows); each warp owns 8 rows. The q tile
//    is staged in shared memory as fp32, then K and then V in chunks of 32
//    keys; a row's scores for all keys stay in shared memory, so the softmax
//    is the exact max / exp / sum / divide, not an online rescaling. Global
//    rows are staged with scalar loads; ragged edges are zero-filled in
//    shared memory and their keys masked with -inf scores.
//
// Inputs may be strided views: the wrapper passes element strides for
// (batch, head, token); the last dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

namespace {

// ---- general route ----
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

// ---------------------------------------------------------------------------
// Tensor-core route
// ---------------------------------------------------------------------------

constexpr int kTcMaxTokens = 128;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shapes of one instantiation of the tensor-core kernel. KT16: key blocks of
// 16 it covers (T <= 16 * KT16); D16: blocks of 16 head dims (hd <= 16 * D16).
template <int KT16, int D16>
struct TcCfg {
  static constexpr int kDS = D16 * 16 + 8;  // row stride: 2 * D16 + 1 units of 16 bytes (odd)
  static constexpr int kRowsPad = KT16 * 16;
  static constexpr int kTile = kRowsPad * kDS;  // elements of one staged q, k or v
  static constexpr int kSlotBytes = 3 * kTile * int(sizeof(__nv_bfloat16));
  // three slots where two CTAs of them fit an SM's 227 KB, else two
  static constexpr int kStages = 3 * kSlotBytes <= 113 * 1024 ? 3 : 2;
  static constexpr int kSmem = kStages * kSlotBytes;
  // with three slots the producers announce an item one item late (see the kernel)
  static constexpr int kLag = kStages - 2;
  static constexpr int kMinBlocks = (KT16 <= 7 && D16 <= 3) ? 2 : 1;  // no spills at either
};
constexpr int kTcProducers = 3;  // warps of a CTA that do nothing but stage

// Named barriers (0 is __syncthreads'): a slot's "full" barrier is passed
// when the producers' copies have landed, its "empty" barrier when every
// consumer warp is done with it.
constexpr int kTcFull = 1;
constexpr int kTcEmpty = 4;

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one special-function instruction
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The producer warp stages rows [0, rows_pad) of one item's q, k and v into
// the three tiles of a shared-memory slot (tile_elems apart) at row stride
// DS. One walk serves the three tensors: producer thread t of n takes 4-byte
// word t, t + n, ... of the padded tile, and steps its (row, word) pair without dividing.
// vec: 4-byte cp.async (pointers 4-byte aligned, even strides, even hd);
// else 2-byte scalar loads. Rows >= n_tok and columns >= hd become zero when
// `fill`: the padding of a slot is the same for every item, so only a slot's
// first use needs it.
template <int D16, int DS>
__device__ __forceinline__ void tc_stage(__nv_bfloat16* dst, int tile_elems,
                                         const __nv_bfloat16* qb, const __nv_bfloat16* kb,
                                         const __nv_bfloat16* vb, long long tq, long long tk,
                                         long long tv, int rows_pad, int n_tok, int hd, bool vec,
                                         bool fill, int tid) {
  constexpr int W = D16 * 8;  // 4-byte words per padded row
  constexpr int kThreads = 32 * kTcProducers;
  constexpr int dr = kThreads / W, dc = kThreads - dr * W;
  int r = tid / W, c = tid - r * W;
  while (r < rows_pad) {
    const int d = 2 * c;
    __nv_bfloat16* out = dst + r * DS + d;
    if (r < n_tok && d < hd) {
      const __nv_bfloat16* qi = qb + r * tq + d;
      const __nv_bfloat16* ki = kb + r * tk + d;
      const __nv_bfloat16* vi = vb + r * tv + d;
      if (vec) {
        const unsigned a = smem_u32(out);
        cp_async4(a, qi);
        cp_async4(a + 2 * tile_elems, ki);
        cp_async4(a + 4 * tile_elems, vi);
      } else {
        const bool pair = d + 1 < hd;
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        out[0] = qi[0];
        out[1] = pair ? qi[1] : zero;
        out[tile_elems] = ki[0];
        out[tile_elems + 1] = pair ? ki[1] : zero;
        out[2 * tile_elems] = vi[0];
        out[2 * tile_elems + 1] = pair ? vi[1] : zero;
      }
    } else if (fill) {
      *reinterpret_cast<unsigned*>(out) = 0u;
      *reinterpret_cast<unsigned*>(out + tile_elems) = 0u;
      *reinterpret_cast<unsigned*>(out + 2 * tile_elems) = 0u;
    }
    c += dc;
    r += dr;
    if (c >= W) {
      c -= W;
      ++r;
    }
  }
}

// blockDim.x is 32 per 16 query rows plus the producer warps, which are the
// last ones.
template <int KT16, int D16>
__global__ void __launch_bounds__((KT16 + kTcProducers) * 32, TcCfg<KT16, D16>::kMinBlocks)
mhsa_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides sq,
               Strides sk, Strides sv, Strides so, int n_heads, int n_tok, int hd, int n_items,
               float scale, int vec) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  using Cfg = TcCfg<KT16, D16>;
  constexpr int DS = Cfg::kDS, kRowsPad = Cfg::kRowsPad, kTile = Cfg::kTile;
  constexpr int kStages = Cfg::kStages, kLag = Cfg::kLag;
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // kStages x (q, k, v)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_thr = blockDim.x;  // every named barrier counts all of them
  const bool use_vec = vec != 0;

  // Item i of this CTA is blockIdx.x + i * gridDim.x: the CTAs that run at
  // one time work on neighbouring items, so the heads of an image, whose
  // 84-byte rows share 32-byte sectors, are read and written close in time.
  const int first = blockIdx.x;
  const int step = gridDim.x;
  const int n_mine = first < n_items ? (n_items - first + step - 1) / step : 0;

  const int n_cons = (n_thr >> 5) - kTcProducers;  // consumer warps
  if (warp >= n_cons) {
    // Producer warps. Their copies queue up in the load pipe and they wait
    // there; the consumer warps never start a global load, so they never wait
    // with them. With three slots an item is announced "full" kLag = 1 item
    // late, after the next one's copies are queued, so that the queue does
    // not run dry while the producers wait for an item to land.
    int slot = 0, lagged = 0;
    for (int i = 0, item = first; i < n_mine; ++i, item += step) {
      if (i >= kStages) named_sync(kTcEmpty + slot, n_thr);
      const int b = item / n_heads;
      const int h = item - b * n_heads;
      tc_stage<D16, DS>(bufs + slot * 3 * kTile, kTile, q + b * sq.b + h * sq.h,
                        k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h, sq.t, sk.t, sv.t,
                        kRowsPad, n_tok, hd, use_vec, i < kStages, threadIdx.x - n_cons * 32);
      cp_async_commit();
      if (i >= kLag) {
        cp_async_wait<kLag>();
        __threadfence_block();
        named_arrive(kTcFull + lagged, n_thr);
        lagged = lagged + 1 == kStages ? 0 : lagged + 1;
      }
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
    if (kLag > 0 && n_mine > 0) {
      cp_async_wait<0>();
      __threadfence_block();
      named_arrive(kTcFull + lagged, n_thr);
    }
    return;
  }

  const int g = lane >> 2;    // row of the mma fragment
  const int tig = lane & 3;   // column pair of the mma fragment
  const float c2 = scale * 1.4426950408889634f;
  int slot = 0;
  for (int i = 0, item = first; i < n_mine; ++i, item += step) {
    named_sync(kTcFull + slot, n_thr);
    __nv_bfloat16* qs = bufs + slot * 3 * kTile;
    const __nv_bfloat16* ks = qs + kTile;
    const __nv_bfloat16* vs = ks + kTile;

    // S = Q K^T: the warp's 16 rows against all keys, k-steps of 16 head dims
    float s[2 * KT16][4];
#pragma unroll
    for (int j = 0; j < 2 * KT16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    const unsigned q_addr = smem_u32(qs + (warp * 16 + (lane & 15)) * DS + (lane >> 4) * 8);
    const unsigned k_addr =
        smem_u32(ks + ((lane & 7) + ((lane >> 4) << 3)) * DS + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < D16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int jj = 0; jj < KT16; ++jj) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, k_addr + (jj * 16 * DS + kk * 16) * 2);
        mma_bf16(s[2 * jj], a, bfr[0], bfr[1]);
        mma_bf16(s[2 * jj + 1], a, bfr[2], bfr[3]);
      }
    }

    // exact softmax over the row, in registers: rows g (c = 0, 1) and g + 8.
    // exp(x * scale - m) is taken as 2^(x * c2 - m2) with c2 = scale * log2(e)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * KT16; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] *= c2;
      if (8 * j + 8 > n_tok) {  // only the last n-tiles hold padded keys
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (8 * j + 2 * tig + (c & 1) >= n_tok) s[j][c] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KT16; ++j) {
      s[j][0] = ex2(s[j][0] - m0);
      s[j][1] = ex2(s[j][1] - m0);
      s[j][2] = ex2(s[j][2] - m1);
      s[j][3] = ex2(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    const float inv0 = 1.f / quad_sum(sum0);
    const float inv1 = 1.f / quad_sum(sum1);
    unsigned p[KT16][4];  // A fragments of P, one per k-step of 16 keys
#pragma unroll
    for (int jj = 0; jj < KT16; ++jj) {
      p[jj][0] = pack_bf16(s[2 * jj][0] * inv0, s[2 * jj][1] * inv0);
      p[jj][1] = pack_bf16(s[2 * jj][2] * inv1, s[2 * jj][3] * inv1);
      p[jj][2] = pack_bf16(s[2 * jj + 1][0] * inv0, s[2 * jj + 1][1] * inv0);
      p[jj][3] = pack_bf16(s[2 * jj + 1][2] * inv1, s[2 * jj + 1][3] * inv1);
    }

    // O = P V, k-steps of 16 keys, two n-tiles (16 head dims) per ldmatrix
    float acc[2 * D16][4];
#pragma unroll
    for (int j = 0; j < 2 * D16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    const unsigned v_addr =
        smem_u32(vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * DS + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < KT16; ++jj) {
#pragma unroll
      for (int dd = 0; dd < D16; ++dd) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, v_addr + (jj * 16 * DS + dd * 16) * 2);
        mma_bf16(acc[2 * dd], p[jj], bfr[0], bfr[1]);
        mma_bf16(acc[2 * dd + 1], p[jj], bfr[2], bfr[3]);
      }
    }

    // The warp's 16 rows of the staged q are read by this warp alone, and it
    // is done with them: the output tile goes there as bf16, and from there to
    // device memory a whole row per instruction, so that a row's 32-byte
    // sectors are written whole. Only the hd real columns of real rows go out.
    __nv_bfloat16* ow = qs + warp * 16 * DS;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2 * D16; ++j) {
      *reinterpret_cast<unsigned*>(ow + g * DS + 8 * j + 2 * tig) = pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<unsigned*>(ow + (g + 8) * DS + 8 * j + 2 * tig) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
    {
      const int b = item / n_heads;
      const int h = item - b * n_heads;
      __nv_bfloat16* ob = o + b * so.b + h * so.h + warp * 16 * so.t;
      const int rows = min(16, n_tok - warp * 16);
      if (use_vec) {
        for (int r = 0; r < rows; ++r) {
          const unsigned* src = reinterpret_cast<const unsigned*>(ow + r * DS);
          unsigned* dst = reinterpret_cast<unsigned*>(ob + r * so.t);
          for (int c = lane; 2 * c < hd; c += 32) dst[c] = src[c];
        }
      } else {
        for (int r = 0; r < rows; ++r)
          for (int c = lane; c < hd; c += 32) ob[r * so.t + c] = ow[r * DS + c];
      }
    }
    // this warp is done with the slot; the producers refill it for item i + kStages
    if (i + kStages < n_mine) named_arrive(kTcEmpty + slot, n_thr);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

template <int KT16, int D16>
cudaError_t tc_launch(const void* q, const void* k, const void* v, void* o, const long long* st,
                      int device, int batch, int n_heads, int n_tok, int hd, float scale, int vec,
                      cudaStream_t stream) {
  constexpr size_t smem = TcCfg<KT16, D16>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(mhsa_tc_kernel<KT16, D16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long long n_items = (long long)batch * n_heads;
  if (n_items > 0x7fff0000LL) return cudaErrorInvalidConfiguration;  // item + step stays an int
  const int warps = (n_tok + 15) / 16 + kTcProducers;  // one per 16 query rows, and the producers
  // as many CTAs as the card holds at one time; each walks its share of the items
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mhsa_tc_kernel<KT16, D16>,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sm_count(device);
  const unsigned blocks = unsigned(n_items < resident ? n_items : resident);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  mhsa_tc_kernel<KT16, D16><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, sv, so,
      n_heads, n_tok, hd, int(n_items), scale, vec);
  return cudaGetLastError();
}

template <int KT16>
cudaError_t tc_dispatch_hd(const void* q, const void* k, const void* v, void* o,
                           const long long* st, int device, int batch, int n_heads, int n_tok,
                           int hd, float scale, int vec, cudaStream_t s) {
#define TC_LAUNCH(D) \
  return tc_launch<KT16, D>(q, k, v, o, st, device, batch, n_heads, n_tok, hd, scale, vec, s)
  if (hd <= 48) TC_LAUNCH(3);
  if (hd <= 64) TC_LAUNCH(4);
  if (hd <= 96) TC_LAUNCH(6);
  TC_LAUNCH(8);
#undef TC_LAUNCH
}

cudaError_t tc_dispatch(const void* q, const void* k, const void* v, void* o, const long long* st,
                        int device, int batch, int n_heads, int n_tok, int hd, float scale,
                        int vec, cudaStream_t s) {
#define TC_HD(K) \
  return tc_dispatch_hd<K>(q, k, v, o, st, device, batch, n_heads, n_tok, hd, scale, vec, s)
  if (n_tok <= 32) TC_HD(2);
  if (n_tok <= 64) TC_HD(4);
  if (n_tok <= 112) TC_HD(7);
  TC_HD(8);
#undef TC_HD
}

// 4-byte accesses need 4-byte aligned pointers, even strides and an even hd
bool tc_vec_ok(const void* q, const void* k, const void* v, const void* o, const long long* st,
               int hd) {
  if (hd & 1) return false;
  for (const void* p : {q, k, v, o})
    if (reinterpret_cast<unsigned long long>(p) & 3ull) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] & 1LL) return false;
  return true;
}

}  // namespace

// q, k, v, o: (batch, heads, tokens, hd) device arrays of one dtype
// (0 = float32, 1 = bfloat16) whose last dim is contiguous; strides: 12 host
// int64s, the (batch, head, token) element strides of q, k, v, o in that
// order. route: 0 = general (CUDA cores), 1 = tensor cores (bf16, T <= 128);
// vec (tensor-core route): 1 = 4-byte accesses, refused if anything is
// misaligned. Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int mhsa_forward(int dtype, int device, int route, int vec, const void* q,
                            const void* k, const void* v, void* o, const long long* strides,
                            int batch, int n_heads, int n_tok, int hd, float scale,
                            void* stream) {
  if (batch < 1 || n_heads < 1 || n_tok < 1 || n_tok > kMaxTokens || hd < 1 ||
      hd > kMaxHeadDim || (dtype != 0 && dtype != 1) || (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || n_tok > kTcMaxTokens) return cudaErrorInvalidValue;
    if (vec && !tc_vec_ok(q, k, v, o, strides, hd)) return cudaErrorInvalidValue;
    return tc_dispatch(q, k, v, o, strides, device, batch, n_heads, n_tok, hd, scale, vec, s);
  }
  if (dtype == 0) return dispatch<float>(q, k, v, o, strides, batch, n_heads, n_tok, hd, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, batch, n_heads, n_tok, hd, scale, s);
}
