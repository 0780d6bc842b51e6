// NesT's block attention between the qkv and proj GEMMs, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package runs NesT's attention
// (fewshot_vit_tpu/models/nest.py) as XLA ops, and the port ran it as torch
// ops: two einsums on a 32x32-tile GEMM, their permute copies, the scale and
// the softmax. At 224 px a NesT-T level-1 layer holds 196 tokens a block, so
// that path wrote 2,560 x 16 x 3 x 196^2 = 4.72 G bf16 scores a layer for a
// batch of 2,560 images, then scaled them, softmaxed them and read them back.
// This kernel computes
//
//   out[blk, t, h*hd : (h+1)*hd] = softmax(q_h k_h^T * scale) v_h over the block,
//
// for every block blk of the flattened (B, T) axis, token t and head h,
// reading q, k, v from the packed (B, T, N, 3C) output of the qkv GEMM
// (features ordered (3, heads, hd)) and writing (B, T, N, C) with each
// head's channels contiguous (channel = h*hd + d, head-major). The reference
// merges heads head-dim-major (channel = d*H + h), which written directly is
// 2-byte stores at a stride of H; the proj GEMM takes its weight with the
// input columns permuted instead (models/nest.py), the same sum over the
// same products, so nothing of size B*T*N*C is copied between the two.
//
// Numerics, as the window kernel's: scores on the tensor cores
// (mma.sync.m16n8k16 bf16 -> fp32); the scale folded into a base-2 exponent;
// keys padded to a multiple of 8 (16 for p v) and masked to -inf; an exact
// fp32 softmax over the whole row (no online rescaling: a row's 196 scores
// sit in registers); the probabilities rounded to bf16; p v on the tensor
// cores with fp32 accumulation; the output rounded to bf16. Padded query
// rows are computed and never stored.
//
// What bounds it: one CTA does one (block, head). At hd 32 it reads
// 3 x 196 x 64 bytes of q, k, v and writes 196 x 64 bytes: for a NesT-T batch
// of 2,560 images 30.8 GB over its 12 layers, 9.2 ms at 3.35 TB/s. Its q k^T
// and p v are 3.0 TFLOP (3.1 ms at 989 TFLOP/s), and its 26.6 G exponentials
// (208 rows x 200 keys a (block, head)) about 7 ms on the special-function
// units: bytes first, exponentials close behind, then the fp32 work around
// each score (max, the scaled exponent's FMA, the sum, the normalisation,
// the bf16 pack). The design:
// - A head's q, k or v row is hd contiguous bf16, 64 bytes at a 16-byte
//   aligned offset of its token's 3C-wide row: four 16-byte cp.async.cg (L2
//   only) each, one pass over each byte. The CTAs of neighbouring blockIdx
//   are the heads of one block, so the sectors of a token's row are fetched
//   from device memory once.
// - Q, K, V of the (block, head) in shared memory as bf16 at a row stride of
//   hd + 8 elements (five 16-byte units: ldmatrix and ldmatrix.trans are
//   conflict-free), 16 KT rows each (KT = key steps of 16), rows past the
//   block's tokens zeroed: 49,920 bytes at 196 tokens, dynamic shared memory.
// - Four warps take the 16-row query strips in turn (13 strips at 196
//   tokens). A warp keeps its strip's 16 x 200 scores in registers (25
//   n-tiles of 8 keys, 100 fp32 a lane): the accumulator layout of S is the
//   A-operand layout of P V, as in mhsa.cu's tensor-core route, so the
//   probabilities never leave registers. Exponentials stop at the last
//   n-tile that holds a key (200 of 208 at 196 tokens).
// - The output strip goes through the warp's own rows of Q in shared memory
//   (done with once S is computed) and out a whole 64-byte row per four
//   lanes, as 16-byte stores.
// - One (block, head) a CTA, no persistent loop: several CTAs an SM overlap
//   one's copies with the others' arithmetic.
// Instantiated for n-tiles of 8 keys NT = 4, 13 and 25: up to 32, 104 and
// 200 tokens (NesT's 80 px blocks of 25 and 100 tokens, and 196).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HD = 32;          // head width: every NesT-T level's
constexpr int kMaxTokens = 200;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int DS = HD + 8;      // row stride: HD / 8 + 1 units of 16 bytes (odd)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float ex2(float x) {  // 2^x, one special-function instruction
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NT>
__host__ __device__ constexpr int tile_rows() {  // rows of each of Q, K, V in shared memory: 16 a key step
  return 16 * ((NT + 1) / 2);
}

// One CTA per (block, head): blockIdx.x = blk * heads + h, blk over the
// flattened (B, T) axis; n <= 8 NT tokens a block.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT > 13 ? 3 : 4)
block_attn_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                  int n, int heads, float c2) {
  constexpr int KT = (NT + 1) / 2;   // key steps of 16 for P V
  constexpr int kRows = tile_rows<NT>();
  constexpr int kChunks = HD / 8;    // 16-byte chunks a row
  constexpr int kPerTok = 3 * kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(smem);  // q, k, v tiles
  const __nv_bfloat16* const ks = qs + kRows * DS;
  const __nv_bfloat16* const vs = ks + kRows * DS;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int h = blockIdx.x % heads;
  const long long blk = blockIdx.x / heads;
  const int C = heads * HD;
  const __nv_bfloat16* const src = qkv + blk * n * 3LL * C + h * HD;

  for (int c = tid; c < n * kPerTok; c += nthreads) {
    const int t = c / kPerTok;
    const int r = c - t * kPerTok;
    const int which = r / kChunks;
    const int ch = r - which * kChunks;
    cp_async16(smem_u32(qs + which * kRows * DS + t * DS + ch * 8),
               src + (long long)t * 3 * C + which * C + ch * 8);
  }
  cp_async_commit();
  for (int c = tid; c < (kRows - n) * kPerTok; c += nthreads) {
    const int t = n + c / kPerTok;
    const int r = c - (c / kPerTok) * kPerTok;
    const int which = r / kChunks;
    const int ch = r - which * kChunks;
    *reinterpret_cast<uint4*>(qs + which * kRows * DS + t * DS + ch * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;     // row of the mma fragment
  const int tig = lane & 3;    // column pair of the mma fragment
  const int strips = (n + 15) >> 4;
  const unsigned k_addr =
      smem_u32(ks + ((lane & 7) + ((lane >> 4) << 3)) * DS + ((lane >> 3) & 1) * 8);
  const unsigned v_addr =
      smem_u32(vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * DS + (lane >> 4) * 8);
  __nv_bfloat16* const dst = out + blk * n * (long long)C + h * HD;

  for (int st = warp; st < strips; st += nthreads >> 5) {
    // S = Q K^T: the strip's 16 rows against 8 NT keys, k-steps of 16 head dims
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    const unsigned q_addr = smem_u32(qs + (st * 16 + (lane & 15)) * DS + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, k_addr + (jj * 16 * DS + kk * 16) * 2);
        mma_bf16(s[2 * jj], a, bfr[0], bfr[1]);
        if (2 * jj + 1 < NT) mma_bf16(s[2 * jj + 1], a, bfr[2], bfr[3]);
      }
    }

    // padded keys to -inf; row maxima: rows g (c = 0, 1) and g + 8 (c = 2, 3),
    // keys 8j + 2 tig + (c & 1)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (8 * j + 8 > n) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * tig + e >= n) s[j][e] = s[j][2 + e] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    const float mc0 = quad_max(m0) * c2;
    const float mc1 = quad_max(m1) * c2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], c2, -mc0));
      s[j][1] = ex2(fmaf(s[j][1], c2, -mc0));
      s[j][2] = ex2(fmaf(s[j][2], c2, -mc1));
      s[j][3] = ex2(fmaf(s[j][3], c2, -mc1));
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    const float inv0 = 1.f / quad_sum(sum0);
    const float inv1 = 1.f / quad_sum(sum1);
    unsigned p[KT][4];  // A fragments of P, one per k-step of 16 keys
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
      p[jj][0] = pack_bf16(s[2 * jj][0] * inv0, s[2 * jj][1] * inv0);
      p[jj][1] = pack_bf16(s[2 * jj][2] * inv1, s[2 * jj][3] * inv1);
      if (2 * jj + 1 < NT) {
        p[jj][2] = pack_bf16(s[2 * jj + 1][0] * inv0, s[2 * jj + 1][1] * inv0);
        p[jj][3] = pack_bf16(s[2 * jj + 1][2] * inv1, s[2 * jj + 1][3] * inv1);
      } else {  // keys 8 NT .. 16 KT - 1: no score, probability 0
        p[jj][2] = p[jj][3] = 0u;
      }
    }

    // O = P V, k-steps of 16 keys, two n-tiles (16 head dims) per ldmatrix
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) {
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, v_addr + (jj * 16 * DS + dd * 16) * 2);
        mma_bf16(acc[2 * dd], p[jj], bfr[0], bfr[1]);
        mma_bf16(acc[2 * dd + 1], p[jj], bfr[2], bfr[3]);
      }
    }

    // The strip's 16 rows of the staged q are read by this warp alone, and it
    // is done with them: the output strip goes there as bf16, and from there
    // to each token's row, four lanes a 64-byte row.
    __nv_bfloat16* const ow = qs + st * 16 * DS;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<unsigned*>(ow + g * DS + 8 * j + 2 * tig) = pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<unsigned*>(ow + (g + 8) * DS + 8 * j + 2 * tig) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int c = lane; c < 16 * kChunks; c += 32) {
      const int r = c / kChunks;
      const int ch = c - r * kChunks;
      const int t = st * 16 + r;
      if (t < n)
        *reinterpret_cast<uint4*>(dst + (long long)t * C + ch * 8) =
            *reinterpret_cast<const uint4*>(ow + r * DS + ch * 8);
    }
  }
}

template <int NT>
cudaError_t launch(const void* qkv, void* out, long long items, int n, int heads, float scale,
                   cudaStream_t stream) {
  const size_t smem = 3 * tile_rows<NT>() * DS * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_attn_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const int strips = (n + 15) / 16;
  const int threads = 32 * (strips < kWarps ? strips : kWarps);
  block_attn_kernel<NT><<<unsigned(items), threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), n, heads,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// qkv: (blocks, n, 3 * heads * 32) bf16, contiguous, features ordered
// (3, heads, 32), blocks the flattened (batch, blocks-an-image) axis;
// out: (blocks, n, heads * 32) bf16, contiguous, head h's channels at
// h * 32 .. h * 32 + 31. 1 <= n <= 200; qkv and out 16-byte aligned.
// Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int block_attn_forward(int device, const void* qkv, void* out, long long blocks, int n,
                                  int heads, float scale, void* stream) {
  if (blocks < 1 || heads < 1 || n < 1 || n > kMaxTokens) return cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(qkv) % 16 ||
      reinterpret_cast<unsigned long long>(out) % 16)
    return cudaErrorInvalidValue;
  const long long items = blocks * heads;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32) return launch<4>(qkv, out, items, n, heads, scale, s);
  if (n <= 104) return launch<13>(qkv, out, items, n, heads, scale, s);
  return launch<25>(qkv, out, items, n, heads, scale, s);
}
