// Swin's shifted-window attention between the qkv and proj GEMMs, CUDA C++
// for sm_90a.
//
// Replaces no TPU kernel: the JAX package runs Swin's window attention
// (fewshot_vit_tpu/models/swin.py) as XLA ops, and the port ran it as torch
// ops: roll, partition, q and k relayouts, q k^T, scale, bias gather and add,
// mask add, softmax, p v, reverse, roll back. Each of those moved the whole
// activation or the whole score tensor through device memory (at 224 px a
// stage-1 block writes and re-reads 2.4 GB of bf16 scores for a batch of
// 2,560 images). This kernel does the shifted, biased and masked attention
// of every window by addressing alone:
//
//   out[b, y, x, h*hd : (h+1)*hd] for every token of the (B, R, R) grid =
//   softmax(q k^T * scale + bias + mask) v over the token's window,
//
// reading q, k, v from the packed (B, R, R, 3C) output of the qkv GEMM
// (features ordered (3, heads, hd)) and writing (B, R, R, C) for the proj
// GEMM, both un-rolled and un-partitioned:
//
// - Window (wy, wx) of a block shifted by s holds the tokens of the grid
//   rolled by -s: its token (i, j) lives at ((wy*ws + i + s) mod R,
//   (wx*ws + j + s) mod R). The kernel reads each token from there and writes
//   its output back to the same place, so the roll, the partition, the
//   reverse and the roll back cost nothing.
// - The relative-position bias is gathered from the ((2ws-1)^2, heads) fp32
//   table, staged for the CTA's head in shared memory (scaled by log2(e)),
//   at (di + ws - 1)(2ws - 1) + (dj + ws - 1): with off(t) = i(2ws-1) + j a
//   token's offset, that is off(q) - off(k) + off(last token).
// - The mask adds -100 (as shifted_window_mask does, not -inf) where two
//   tokens' regions differ. A region comes from the rolled coordinate
//   y' = wy*ws + i on each axis: 0 below R - ws, 1 below R - s, else 2. No
//   mask tensor is read; an unshifted block has one region.
// - Scores, bias, mask and softmax in fp32; the probabilities rounded to
//   bf16 for p v; products on the tensor cores (mma.sync.m16n8k16 bf16 ->
//   fp32), accumulation in fp32, output bf16. Scores never leave registers.
//
// What bounds it: one CTA does one (window, head): it reads 49 tokens x 3 x
// 64 bytes of q, k, v (hd 32) and writes 49 x 64 bytes, and does 4 n^2 hd =
// 307 kflops (the tile pads 49 tokens to 64): about 24 flops a byte, far under
// the H100's ~295 bf16 flops a byte. Device-memory bytes set the least time:
// at a 2,560-image batch the stage-1 kernel reads 4.62 GB and writes 1.54 GB,
// 1.84 ms at 3.35 TB/s. The design keeps those bytes to one pass and the
// accesses wide:
// - A head's q, k or v row is hd contiguous bf16, 64 bytes at a 16-byte
//   aligned offset of its token's 3C-wide row: each is four 16-byte
//   cp.async.cg (L2 only), and each output row four 16-byte stores. The
//   CTAs of neighbouring blockIdx are the heads of one window, so the
//   32-byte sectors of a token's row are fetched once from device memory.
// - One item a CTA, no persistent loop, and eight CTAs an SM (17 KB of
//   shared memory, 128 threads and at most 64 registers a thread, no
//   spills): one CTA's copies overlap the others' arithmetic and stores.
//   Measured on the H100 at Swin-T's stage-1 shape, 2,560 images: 3.30 ms;
//   with six CTAs an SM (74 registers) 3.38 ms; persistent CTAs with two
//   shared-memory stages, the next item's copies in flight during the
//   current one's arithmetic, 3.70 ms (80 registers, six CTAs an SM).
// - Q, K, V sit in shared memory as bf16 at a row stride of hd + 8 elements
//   (an odd number of 16-byte units), so ldmatrix (Q, K) and ldmatrix.trans
//   (V) are conflict-free. Rows past the window's tokens are zeros; padded
//   keys get score -inf.
// - Four warps, 16 query rows each, each keeping its 16 x 64 score block in
//   registers: the accumulator layout of S is the A-operand layout of P V, as
//   in mhsa.cu's tensor-core route. The output tile goes through the warp's
//   own rows of Q in shared memory and out a whole 64-byte row per four
//   lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;     // tokens a window, padded: at most an 8 x 8 window
constexpr int kMaxWindow = 8;
constexpr int HD = 32;        // head width: every Swin-T stage's
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTable = (2 * kMaxWindow - 1) * (2 * kMaxWindow - 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -100.f * kLog2e;  // shifted_window_mask's -100, in the base-2 domain
// a token's entry in the CTA's table: its bias offset i(2ws-1) + j in the
// low byte, its region (0..8) in the second, a padded row's flag above
constexpr int kRegionBits = 0xf00;
constexpr int kPad = 1 << 16;

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

// The grid position of token t of window (wy, wx): the rolled grid's
// (wy*ws + i, wx*ws + j) read at +shift, modulo R.
__device__ __forceinline__ int token_pos(int t, int wy, int wx, int res, int window, int shift) {
  const int i = t / window, j = t - (t / window) * window;
  int y = wy * window + i + shift;
  int x = wx * window + j + shift;
  if (y >= res) y -= res;
  if (x >= res) x -= res;
  return y * res + x;
}

// One CTA per (image, window, head); blockIdx.x = ((b * nw + wy) * nw + wx) * heads + h.
__global__ void __launch_bounds__(kThreads, 8)
window_attn_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ table,
                   __nv_bfloat16* __restrict__ out, int res, int window, int shift, int heads,
                   float c2) {
  constexpr int DS = HD + 8;         // row stride: HD / 8 + 1 units of 16 bytes (odd)
  constexpr int D16 = HD / 16;       // k-steps of Q K^T
  constexpr int kChunks = HD / 8;    // 16-byte chunks a row
  constexpr int kPerTok = 3 * kChunks;
  constexpr int KT16 = kRows / 16;   // key blocks of 16
  __shared__ __align__(16) __nv_bfloat16 tiles[3][kRows * DS];  // q, k, v
  __shared__ float bias[kMaxTable];
  __shared__ int info[kRows];
  __shared__ int pos[kRows];

  const int tid = threadIdx.x;
  const int nw = res / window;
  const int n = window * window;
  const int tw = 2 * window - 1;
  const int item = blockIdx.x;
  const int h = item % heads;
  const int win = item / heads;
  const int wx = win % nw;
  const int wy = (win / nw) % nw;
  const long long img = (long long)(win / (nw * nw)) * res * res;  // the image's first token
  const int C = heads * HD;

  // q, k, v rows of the window's tokens, straight from the shifted positions
  for (int c = tid; c < n * kPerTok; c += kThreads) {
    const int t = c / kPerTok;
    const int r = c - t * kPerTok;
    const int which = r / kChunks;
    const int ch = r - which * kChunks;
    const __nv_bfloat16* src = qkv + (img + token_pos(t, wy, wx, res, window, shift)) * 3 * C +
                               which * C + h * HD + ch * 8;
    cp_async16(smem_u32(&tiles[which][t * DS + ch * 8]), src);
  }
  cp_async_commit();
  for (int c = tid; c < (kRows - n) * kPerTok; c += kThreads) {
    const int t = n + c / kPerTok;
    const int r = c - (c / kPerTok) * kPerTok;
    const int which = r / kChunks;
    const int ch = r - which * kChunks;
    *reinterpret_cast<uint4*>(&tiles[which][t * DS + ch * 8]) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < tw * tw; i += kThreads) bias[i] = __ldg(table + i * heads + h) * kLog2e;
  const int last = (window - 1) * tw + (window - 1);  // the last token's offset
  if (tid < kRows) {
    int e = last | kPad;  // a padded row: a bias offset that keeps every index in the table
    if (tid < n) {
      const int i = tid / window, j = tid - (tid / window) * window;
      int region = 0;
      if (shift > 0) {
        const int yr = wy * window + i, xr = wx * window + j;  // rolled coordinates
        const int ry = yr < res - window ? 0 : (yr < res - shift ? 1 : 2);
        const int rx = xr < res - window ? 0 : (xr < res - shift ? 1 : 2);
        region = 3 * ry + rx;
      }
      e = i * tw + j + (region << 8);
      pos[tid] = token_pos(tid, wy, wx, res, window, shift);
    }
    info[tid] = e;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (warp * 16 >= n) return;  // no query row of this warp is a token
  const int g = lane >> 2;     // row of the mma fragment
  const int tig = lane & 3;    // column pair of the mma fragment
  const __nv_bfloat16* qs = tiles[0];
  const __nv_bfloat16* ks = tiles[1];
  const __nv_bfloat16* vs = tiles[2];

  // S = Q K^T: the warp's 16 rows against all 64 keys, k-steps of 16 head dims
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

  // scale, bias, mask in the base-2 domain: rows g (c = 0, 1) and g + 8
  // (c = 2, 3), keys 8j + 2 tig + (c & 1)
  const int qi0 = info[warp * 16 + g], qi1 = info[warp * 16 + g + 8];
  const int base0 = (qi0 & 0xff) + last, base1 = (qi1 & 0xff) + last;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * KT16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ki = info[8 * j + 2 * tig + e];
      const int koff = ki & 0xff;
      float t0 = fmaf(s[j][e], c2, bias[base0 - koff]);
      float t1 = fmaf(s[j][2 + e], c2, bias[base1 - koff]);
      if ((qi0 ^ ki) & kRegionBits) t0 += kMask;
      if ((qi1 ^ ki) & kRegionBits) t1 += kMask;
      if (ki & kPad) t0 = t1 = -INFINITY;
      s[j][e] = t0;
      s[j][2 + e] = t1;
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
  // each token's own place, four lanes a 64-byte row.
  __nv_bfloat16* ow = tiles[0] + warp * 16 * DS;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2 * D16; ++j) {
    *reinterpret_cast<unsigned*>(ow + g * DS + 8 * j + 2 * tig) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<unsigned*>(ow + (g + 8) * DS + 8 * j + 2 * tig) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int ch = c - r * kChunks;
    const int t = warp * 16 + r;
    if (t < n)
      *reinterpret_cast<uint4*>(out + (img + pos[t]) * C + h * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(ow + r * DS + ch * 8);
  }
}

cudaError_t launch(const void* qkv, const void* table, void* out, long long items, int res,
                   int window, int shift, int heads, float scale, cudaStream_t stream) {
  window_attn_kernel<<<unsigned(items), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
      static_cast<__nv_bfloat16*>(out), res, window, shift, heads, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// qkv: (batch, res, res, 3 * heads * 32) bf16, contiguous, features
// ordered (3, heads, 32); table: ((2 window - 1)^2, heads) float32,
// contiguous; out: (batch, res, res, heads * 32) bf16, contiguous.
// The block is shifted by `shift` (0: unshifted, no mask); window <= 8,
// res a multiple of it. qkv and out 16-byte aligned. Launches on
// `stream` of `device` and returns cudaGetLastError().
extern "C" int window_attn_forward(int device, const void* qkv, const void* table, void* out,
                                   int batch, int res, int window, int shift, int heads,
                                   float scale, void* stream) {
  if (batch < 1 || heads < 1 || window < 1 || window > kMaxWindow || res < window ||
      res % window || shift < 0 || shift >= window || (shift > 0 && res == window))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(qkv) % 16 ||
      reinterpret_cast<unsigned long long>(out) % 16 ||
      reinterpret_cast<unsigned long long>(table) % 4)
    return cudaErrorInvalidValue;
  const long long nw = res / window;
  const long long items = (long long)batch * nw * nw * heads;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch(qkv, table, out, items, res, window, shift, heads, scale,
                static_cast<cudaStream_t>(stream));
}
