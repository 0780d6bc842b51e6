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
// at that shape. In fp32 the rows are 168 bytes, 8-byte aligned, and the
// three TF32 products of a 3xTF32 product (below) put the arithmetic near the
// bytes: about 25 flops per byte against the TF32 tensor cores' ~148 / 3.
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
// 2. General route (mhsa_general_kernel): fp32 at any shape, and bf16 with
//    T > 128, up to T = 512 and hd = 128. Both products on the tensor cores
//    with mma.sync, one warp per 16 query rows:
//    - bf16: m16n8k16 bf16 -> fp32, fragments through ldmatrix as in route 1.
//    - fp32: 3xTF32 on m16n8k8.tf32. Each operand x is split into hi, x
//      rounded to TF32 (round to nearest, ties away, as cvt.rna rounds, in
//      two integer instructions), and lo = x - hi, which the tensor cores
//      read truncated to TF32; a product is lo*hi + hi*lo + hi*hi, the
//      dropped lo*lo term below 2^-21 of it, while one TF32 product (2^-11)
//      breaks the 1e-4 agreement with the plain version. Each k-step's
//      three products are summed from zero and added to the running sum by
//      fp32 adds. Measured on the H100: the tensor cores' fp32 accumulation
//      truncates, and with every k-step chained into the running sum on the
//      tensor cores the output sat several times further from float64 than
//      the plain fp32 version; neither ex2.approx nor rounding lo (instead
//      of truncating it) moved that. With the adds it sits closer to float64
//      than the plain version (chip_smoke.py phase 4 prints both and holds
//      it), as the plain-torch model of this arithmetic in
//      tests/test_torch_mhsa_general.py does against the TPU kernel in
//      interpret mode; the adds cost time (PERF.md). cvt.rna for both parts
//      of the split ran slower. The k index of every
//      fp32 mma is permuted inside each k-step of 8 (operand column c stands
//      for element 2c, column c + 4 for element 2c + 1): then a thread's
//      q and k pairs are one 8-byte shared-memory load each, and the
//      accumulator layout of S is the A-operand layout of P.V, with V's
//      B fragments read at the same permuted keys.
//    - Keys are padded to the instantiation's block (64, 104 in fp32, or
//      128 keys; T = 100 in fp32 pads to 104, the m16n8k8 tile), head dims
//      to 48, 64, 96 or 128; padded keys get score -inf, padded q and k
//      columns and padded v rows are zeros in shared memory. No branch
//      guards an mma: measured on the H100, runtime tile bounds in the
//      loops cost more than the padding.
//    - T <= 128: one CTA covers all of T for a head (7 warps at T = 100),
//      K and V are staged once per head and each warp keeps its 16 x T score
//      block in registers: the exact max / exp / sum / normalise of route 1.
//      q and K go in a first cp.async group, V in a second that lands while
//      the scores are computed.
//    - 128 < T <= 512: up to 8 warps (128 query rows) a CTA, and keys in
//      blocks of 64 through a ring of two shared-memory stages. Pass A
//      computes S block by block for each row's max and sum (a running max,
//      the sum rescaled when it moves); pass B computes S again and forms
//      p = 2^(s*c2 - m) / l, rounded to bf16 in bf16, before P.V. The
//      probabilities are thus normalised before the second product, as the
//      TPU kernel does, which an online-softmax rescaling of the output
//      would not keep. Computing QK^T twice makes the arithmetic 1.5x that
//      of one pass.
//    - Copies are cp.async of the widest width the pointers, strides and hd
//      allow (16, 8 or 4 bytes; the wrapper finds it), 2-byte scalar loads
//      for bf16 where nothing wider fits. Non-persistent grid: the CTAs of
//      one SM overlap each other's loads and math.
//
// Inputs may be strided views: the wrapper passes element strides for
// (batch, head, token); the last dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxTokens = 512;
constexpr int kMaxHeadDim = 128;

struct Strides {  // element strides of (batch, head, token)
  long long b, h, t;
};

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

// ---------------------------------------------------------------------------
// General route
// ---------------------------------------------------------------------------

constexpr int kGenMaxWarps = 8;  // 16 query rows a warp, 128 a CTA

// x = hi + lo. hi: x rounded to TF32, half away from zero as cvt.rna rounds
// (half a unit of the 13 dropped bits added, then cleared: two integer
// instructions where cvt.rna takes several). lo = x - hi, exact in fp32; the
// tensor cores read its top 19 bits (they ignore a TF32 operand's low 13).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: c += a * b, the k-step's lo*hi + hi*lo + hi*hi summed by the
// tensor cores from zero (the small terms first), then added to c by fp32
// adds, which round to nearest. The tensor cores' own fp32 accumulation
// truncates; chaining every k-step's products into c there, the truncations
// of a long sum add up (see the note at the top).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh[0], bh[1]);
  mma_tf32(t, ah, bl[0], bl[1]);
  mma_tf32(t, ah, bh[0], bh[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// One width-byte copy global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_zfill(unsigned dst, const void* src, int width,
                                               int src_bytes) {
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
}

// Rows [row0, row0 + rows) of one (batch, head)'s q, k or v into shared memory
// at row stride ds, columns [0, HDP); zeros where the row is >= n_tok or the
// column >= hd. W: bytes a copy, 16, 8 or 4 by cp.async, or 2 (bf16) by scalar
// loads; it divides hd * sizeof(T), so a copy is all real or all pad.
template <typename T, int HDP, int W>
__device__ __forceinline__ void gen_stage_w(T* dst, int ds, const T* src, long long st, int row0,
                                            int rows, int n_tok, int hd) {
  constexpr int kPer = W / int(sizeof(T));  // elements a copy
  constexpr int kCpr = HDP / kPer;          // copies a row
  for (int e = threadIdx.x; e < rows * kCpr; e += blockDim.x) {
    const int r = e / kCpr;
    const int c = (e - r * kCpr) * kPer;
    const int row = row0 + r;
    const bool real = row < n_tok && c < hd;
    T* d = dst + r * ds + c;
    const T* from = real ? src + row * st + c : src;
    if constexpr (W == 2) {
      *d = real ? *from : __float2bfloat16(0.f);
    } else {
      cp_async_zfill(smem_u32(d), from, W, real ? W : 0);
    }
  }
}

template <typename T, int HDP>
__device__ __forceinline__ void gen_stage(T* dst, int ds, const T* src, long long st, int row0,
                                          int rows, int n_tok, int hd, int width) {
  if (width == 16) {
    gen_stage_w<T, HDP, 16>(dst, ds, src, st, row0, rows, n_tok, hd);
  } else if (width == 8) {
    gen_stage_w<T, HDP, 8>(dst, ds, src, st, row0, rows, n_tok, hd);
  } else if constexpr (sizeof(T) == 4) {
    gen_stage_w<T, HDP, 4>(dst, ds, src, st, row0, rows, n_tok, hd);
  } else if (width == 4) {
    gen_stage_w<T, HDP, 4>(dst, ds, src, st, row0, rows, n_tok, hd);
  } else {
    gen_stage_w<T, HDP, 2>(dst, ds, src, st, row0, rows, n_tok, hd);
  }
}

// Shapes of one instantiation of the general kernel. NKT: n-tiles of 8 keys a
// block of keys holds (a warp's scores for it stay in registers); ND8: tiles
// of 8 head dims (hd <= 8 * ND8). Every loop runs over the whole instantiation
// (keys padded to 8 * NKT, head dims to 8 * ND8, zeros in shared memory), so
// no branch guards an mma. Shared-memory row strides, in elements:
// fp32 q and k at 8 * ND8 + 8 (8 or 24 mod 32 words: the 8-byte fragment
// loads of a half-warp hit distinct banks), v at 8 * ND8 + 4 (4 mod 8: the
// scalar B-fragment loads at keys 2 * tig, 2 * tig + 1 do); bf16 all three at
// 8 * ND8 + 8, an odd number of 16-byte units, for ldmatrix.
template <typename T, int NKT, int ND8>
struct GenCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kKeys = NKT * 8;  // keys a block
  static constexpr int kHdp = ND8 * 8;   // head dims staged
  static constexpr int kSQ = kHdp + 8;
  static constexpr int kSK = kSQ;
  static constexpr int kSV = kF32 ? kHdp + 4 : kSQ;
  static constexpr int kMinBlocks = (ND8 <= 8 || (!kF32 && NKT == 8)) ? 2 : 1;
};

// S = Q K^T for the warp's 16 rows against the block's 8 * NKT keys
template <typename T, int NKT, int ND8>
__device__ __forceinline__ void gen_scores(float (&s)[NKT][4], const T* qw, const T* ks,
                                           int lane) {
  using Cfg = GenCfg<T, NKT, ND8>;
  constexpr int SQ = Cfg::kSQ, SK = Cfg::kSK;
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
  const int g = lane >> 2, tig = lane & 3;
  if constexpr (Cfg::kF32) {
    // operand column tig stands for head dim 2 * tig, column tig + 4 for 2 * tig + 1
    const float* qa = qw + g * SQ + 2 * tig;
    const float* kp = ks + g * SK + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < ND8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * SQ + 8 * kk);
      unsigned ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(kp + 8 * j * SK + 8 * kk);
        unsigned bh[2], bl[2];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        mma_3xtf32(s[j], ah, al, bh, bl);
      }
    }
  } else {
    const unsigned q_addr = smem_u32(qw + (lane & 15) * SQ + (lane >> 4) * 8);
    const unsigned k_addr =
        smem_u32(ks + ((lane & 7) + ((lane >> 4) << 3)) * SK + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < ND8 / 2; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int jj = 0; jj < NKT / 2; ++jj) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, k_addr + (jj * 16 * SK + kk * 16) * 2);
        mma_bf16(s[2 * jj], a, bfr[0], bfr[1]);
        mma_bf16(s[2 * jj + 1], a, bfr[2], bfr[3]);
      }
    }
  }
}

// Scores of keys >= n_tok (key0: the block's first) -> -inf: the last n-tiles only
template <int NKT>
__device__ __forceinline__ void gen_mask(float (&s)[NKT][4], int key0, int n_tok, int tig) {
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    if (key0 + 8 * j + 8 > n_tok) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (key0 + 8 * j + 2 * tig + (c & 1) >= n_tok) s[j][c] = -INFINITY;
    }
  }
}

// The thread's max over its columns of rows g (m0) and g + 8 (m1)
template <int NKT>
__device__ __forceinline__ void gen_max(const float (&s)[NKT][4], float& m0, float& m1) {
  m0 = m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
}

// O += P V over the block's 8 * NKT keys; p holds the probabilities of rows
// g (c = 0, 1) and g + 8 (c = 2, 3) in the accumulator layout of S.
template <typename T, int NKT, int ND8>
__device__ __forceinline__ void gen_pv(float (&o)[ND8][4], const float (&p)[NKT][4], const T* vs,
                                       int lane) {
  using Cfg = GenCfg<T, NKT, ND8>;
  constexpr int SV = Cfg::kSV;
  if constexpr (Cfg::kF32) {
    // keys permuted as head dims are in gen_scores: operand column tig of a
    // k-step of 8 keys is key 2 * tig, column tig + 4 key 2 * tig + 1, so the
    // thread's own scores are its A fragment and V is read at those keys
    const int g = lane >> 2, tig = lane & 3;
    const float* vp = vs + 2 * tig * SV + g;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      unsigned ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);
      split_tf32(p[j][2], ah[1], al[1]);
      split_tf32(p[j][1], ah[2], al[2]);
      split_tf32(p[j][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < ND8; ++n) {
        unsigned bh[2], bl[2];
        split_tf32(vp[8 * j * SV + 8 * n], bh[0], bl[0]);
        split_tf32(vp[8 * j * SV + SV + 8 * n], bh[1], bl[1]);
        mma_3xtf32(o[n], ah, al, bh, bl);
      }
    }
  } else {
    const unsigned v_addr =
        smem_u32(vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * SV + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NKT / 2; ++jj) {
      const unsigned pa[4] = {pack_bf16(p[2 * jj][0], p[2 * jj][1]),
                              pack_bf16(p[2 * jj][2], p[2 * jj][3]),
                              pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]),
                              pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3])};
#pragma unroll
      for (int dd = 0; dd < ND8 / 2; ++dd) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, v_addr + (jj * 16 * SV + dd * 16) * 2);
        mma_bf16(o[2 * dd], pa, bfr[0], bfr[1]);
        mma_bf16(o[2 * dd + 1], pa, bfr[2], bfr[3]);
      }
    }
  }
}

// blockDim.x is 32 per 16 query rows of the CTA's tile; gridDim.x is
// batch * heads * n_qtiles, the query tiles of an item next to each other.
template <typename T, int NKT, int ND8>
__global__ void __launch_bounds__(kGenMaxWarps * 32, GenCfg<T, NKT, ND8>::kMinBlocks)
mhsa_general_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so,
                    int n_heads, int n_tok, int hd, int n_qtiles, float scale, int width) {
  using Cfg = GenCfg<T, NKT, ND8>;
  constexpr bool kF32 = Cfg::kF32;
  constexpr int SQ = Cfg::kSQ, SK = Cfg::kSK, SV = Cfg::kSV, KB = Cfg::kKeys, HDP = Cfg::kHdp;
  constexpr int kStage = KB * (SK + SV);  // elements of a stage: K and V of a block
  extern __shared__ __align__(16) unsigned char gen_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3, g = lane >> 2;
  const int rows_q = (blockDim.x >> 5) * 16;
  const int item = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - item * n_qtiles) * rows_q;
  const int b = item / n_heads, h = item - b * n_heads;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  const int n_blocks = (n_tok + KB - 1) / KB;
  T* qs = reinterpret_cast<T*>(gen_smem);
  T* stages = qs + rows_q * SQ;
  const T* qw = qs + warp * 16 * SQ;
  const bool active = row0 + warp * 16 < n_tok;
  const float c2 = scale * 1.4426950408889634f;

  float o_acc[ND8][4];
#pragma unroll
  for (int n = 0; n < ND8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o_acc[n][c] = 0.f;

  gen_stage<T, HDP>(qs, SQ, qb, sq.t, row0, rows_q, n_tok, hd, width);
  if (n_blocks == 1) {
    // all keys in one block: q and K land first, V while the scores are taken
    gen_stage<T, HDP>(stages, SK, kb, sk.t, 0, KB, n_tok, hd, width);
    cp_async_commit();
    gen_stage<T, HDP>(stages + KB * SK, SV, vb, sv.t, 0, KB, n_tok, hd, width);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[NKT][4];
    if (active) {
      gen_scores<T, NKT, ND8>(s, qw, stages, lane);
      gen_mask<NKT>(s, 0, n_tok, tig);
      // exact softmax over the row: rows g (c = 0, 1) and g + 8 (c = 2, 3)
      float m0, m1;
      gen_max<NKT>(s, m0, m1);
      const float mc0 = quad_max(m0) * c2, mc1 = quad_max(m1) * c2;
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        s[j][0] = ex2(fmaf(s[j][0], c2, -mc0));
        s[j][1] = ex2(fmaf(s[j][1], c2, -mc0));
        s[j][2] = ex2(fmaf(s[j][2], c2, -mc1));
        s[j][3] = ex2(fmaf(s[j][3], c2, -mc1));
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        s[j][0] *= inv0;
        s[j][1] *= inv0;
        s[j][2] *= inv1;
        s[j][3] *= inv1;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (active) gen_pv<T, NKT, ND8>(o_acc, s, stages + KB * SK, lane);
  } else {
    // job j < n_blocks: pass A over block j (K only); job n_blocks + i: pass B
    // over block i (K and V). Job j is staged in stage j & 1 while job j - 1
    // is computed.
    const int n_jobs = 2 * n_blocks;
    auto issue = [&](int j) {
      T* st = stages + (j & 1) * kStage;
      const int key0 = (j < n_blocks ? j : j - n_blocks) * KB;
      gen_stage<T, HDP>(st, SK, kb, sk.t, key0, KB, n_tok, hd, width);
      if (j >= n_blocks) gen_stage<T, HDP>(st + KB * SK, SV, vb, sv.t, key0, KB, n_tok, hd, width);
      cp_async_commit();
    };
    // the running max (of raw scores) and sum of this thread's columns
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    issue(0);
    for (int j = 0; j < n_jobs; ++j) {
      if (j + 1 < n_jobs) {
        issue(j + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const T* ks = stages + (j & 1) * kStage;
        float s[NKT][4];
        gen_scores<T, NKT, ND8>(s, qw, ks, lane);
        gen_mask<NKT>(s, (j < n_blocks ? j : j - n_blocks) * KB, n_tok, tig);
        if (j < n_blocks) {
          // pass A: a running max of the thread's columns, the sum rescaled to it
          float b0, b1;
          gen_max<NKT>(s, b0, b1);
          const float n0 = fmaxf(m0, b0), n1 = fmaxf(m1, b1);
          const float nc0 = n0 * c2, nc1 = n1 * c2;
          l0 *= ex2(fmaf(m0, c2, -nc0));
          l1 *= ex2(fmaf(m1, c2, -nc1));
#pragma unroll
          for (int jj = 0; jj < NKT; ++jj) {
            l0 += ex2(fmaf(s[jj][0], c2, -nc0)) + ex2(fmaf(s[jj][1], c2, -nc0));
            l1 += ex2(fmaf(s[jj][2], c2, -nc1)) + ex2(fmaf(s[jj][3], c2, -nc1));
          }
          m0 = n0;
          m1 = n1;
          if (j == n_blocks - 1) {  // the row's max and sum over the quad
            const float r0 = quad_max(m0), r1 = quad_max(m1);
            l0 = 1.f / quad_sum(l0 * ex2((m0 - r0) * c2));
            l1 = 1.f / quad_sum(l1 * ex2((m1 - r1) * c2));
            m0 = r0 * c2;  // from here on max * c2
            m1 = r1 * c2;
          }
        } else {
          // pass B: p = 2^(s * c2 - max * c2) / l, then O += P V
#pragma unroll
          for (int jj = 0; jj < NKT; ++jj) {
            s[jj][0] = ex2(fmaf(s[jj][0], c2, -m0)) * l0;
            s[jj][1] = ex2(fmaf(s[jj][1], c2, -m0)) * l0;
            s[jj][2] = ex2(fmaf(s[jj][2], c2, -m1)) * l1;
            s[jj][3] = ex2(fmaf(s[jj][3], c2, -m1)) * l1;
          }
          gen_pv<T, NKT, ND8>(o_acc, s, ks + KB * SK, lane);
        }
      }
      __syncthreads();  // every warp is done with stage j & 1 before job j + 2 refills it
    }
  }

  if (!active) return;
  // straight from the accumulators: rows g and g + 8, columns 8n + 2tig, + 1
  T* ob = o + b * so.b + h * so.h;
  const bool pairs = width >= int(2 * sizeof(T));  // 2-element stores aligned (hd even)
#pragma unroll
  for (int n = 0; n < ND8; ++n) {
    const int d = 8 * n + 2 * tig;
    if (d >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + warp * 16 + g + 8 * half;
      if (row >= n_tok) continue;
      T* dst = ob + row * so.t + d;
      const float x0 = o_acc[n][2 * half], x1 = o_acc[n][2 * half + 1];
      if constexpr (kF32) {
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          dst[0] = x0;
          if (d + 1 < hd) dst[1] = x1;
        }
      } else {
        if (pairs) {
          *reinterpret_cast<unsigned*>(dst) = pack_bf16(x0, x1);
        } else {
          dst[0] = __float2bfloat16(x0);
          if (d + 1 < hd) dst[1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

template <typename T, int NKT, int ND8>
cudaError_t gen_launch(const void* q, const void* k, const void* v, void* o, const long long* st,
                       int batch, int n_heads, int n_tok, int hd, float scale, int width,
                       cudaStream_t stream) {
  using Cfg = GenCfg<T, NKT, ND8>;
  const int n_blocks = (n_tok + Cfg::kKeys - 1) / Cfg::kKeys;
  // the fewest query tiles of at most 8 warps, the warps spread evenly over them
  const int row_tiles = (n_tok + 15) / 16;
  const int n_qtiles = (row_tiles + kGenMaxWarps - 1) / kGenMaxWarps;
  const int warps = (row_tiles + n_qtiles - 1) / n_qtiles;
  const size_t smem = sizeof(T) * (size_t(warps) * 16 * Cfg::kSQ +
                                   size_t(n_blocks > 1 ? 2 : 1) * Cfg::kKeys *
                                       (Cfg::kSK + Cfg::kSV));
  cudaError_t err = cudaFuncSetAttribute(mhsa_general_kernel<T, NKT, ND8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)batch * n_heads * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  mhsa_general_kernel<T, NKT, ND8><<<unsigned(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, n_heads, n_tok, hd, n_qtiles, scale, width);
  return cudaGetLastError();
}

template <typename T, int NKT>
cudaError_t gen_dispatch_hd(const void* q, const void* k, const void* v, void* o,
                            const long long* st, int batch, int n_heads, int n_tok, int hd,
                            float scale, int width, cudaStream_t s) {
#define GEN_LAUNCH(D) \
  return gen_launch<T, NKT, D>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, width, s)
  if (hd <= 48) GEN_LAUNCH(6);
  if (hd <= 64) GEN_LAUNCH(8);
  if (hd <= 96) GEN_LAUNCH(12);
  GEN_LAUNCH(16);
#undef GEN_LAUNCH
}

// Keys a block, by T: up to 64 in 8 n-tiles; fp32 up to 104 (visformer stage
// 2's 100 keys, padded to the m16n8k8 tile) in 13; up to 128 in 16; beyond
// 128, blocks of 64 and two passes.
template <typename T>
cudaError_t gen_dispatch(const void* q, const void* k, const void* v, void* o,
                         const long long* st, int batch, int n_heads, int n_tok, int hd,
                         float scale, int width, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (n_tok > 64 && n_tok <= 104)
      return gen_dispatch_hd<T, 13>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, width, s);
  }
  if (n_tok > 64 && n_tok <= 128)
    return gen_dispatch_hd<T, 16>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, width, s);
  return gen_dispatch_hd<T, 8>(q, k, v, o, st, batch, n_heads, n_tok, hd, scale, width, s);
}

// width-byte accesses: width 2, 4, 8 or 16 and at least one element; every
// pointer width-aligned; every stride and hd a whole number of width bytes
bool width_ok(const void* q, const void* k, const void* v, const void* o, const long long* st,
              int hd, int elem, int width) {
  if ((width != 2 && width != 4 && width != 8 && width != 16) || width < elem) return false;
  if ((hd * elem) % width) return false;
  for (const void* p : {q, k, v, o})
    if (reinterpret_cast<unsigned long long>(p) % width) return false;
  for (int i = 0; i < 12; ++i)
    if ((st[i] * elem) % width) return false;
  return true;
}

}  // namespace

// q, k, v, o: (batch, heads, tokens, hd) device arrays of one dtype
// (0 = float32, 1 = bfloat16) whose last dim is contiguous; strides: 12 host
// int64s, the (batch, head, token) element strides of q, k, v, o in that
// order. route: 0 = general (tensor cores, 3xTF32 in fp32), 1 = tensor-core
// route (bf16, T <= 128); width: the bytes of one global access the
// pointers, strides and hd allow (2, 4, 8 or 16), refused if anything is
// misaligned for it. Launches on `stream` of `device` and
// returns cudaGetLastError().
extern "C" int mhsa_forward(int dtype, int device, int route, int width, const void* q,
                            const void* k, const void* v, void* o, const long long* strides,
                            int batch, int n_heads, int n_tok, int hd, float scale,
                            void* stream) {
  if (batch < 1 || n_heads < 1 || n_tok < 1 || n_tok > kMaxTokens || hd < 1 ||
      hd > kMaxHeadDim || (dtype != 0 && dtype != 1) || route < 0 || route > 1)
    return cudaErrorInvalidValue;
  if (!width_ok(q, k, v, o, strides, hd, dtype == 0 ? 4 : 2, width)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || n_tok > kTcMaxTokens) return cudaErrorInvalidValue;
    return tc_dispatch(q, k, v, o, strides, device, batch, n_heads, n_tok, hd, scale,
                       width >= 4 ? 1 : 0, s);
  }
  if (dtype == 0)
    return gen_dispatch<float>(q, k, v, o, strides, batch, n_heads, n_tok, hd, scale, width, s);
  return gen_dispatch<__nv_bfloat16>(q, k, v, o, strides, batch, n_heads, n_tok, hd, scale, width,
                                     s);
}
