// flash_block_update for Hopper (sm_90a): attention under the reference's
// online softmax, the whole K/V block loop in one launch.
//
// Replaces the Pallas TPU kernel
// alink_tpu/dl/attn_pallas.py::flash_block_update (pl.pallas_call at
// attn_pallas.py:114) and the lax.scan over K/V blocks
// around it in alink_tpu/dl/attention.py::blockwise_attention. Per block of
// `block` keys, the update of the plain version
// alink_tpu_torch/dl/attn_cuda.py::flash_block_update_ref:
//   s  = round(q·kᵀ) · scale                (round = to the input type)
//   s  = -1e30 where the key is masked (kvalid, qk_ok, causal, zero padding)
//   m' = max(m, rowmax s);  corr = exp(max(m − m', −1e30))
//   p  = exp(s − m');       l' = l·corr + Σp (over the fp32 p)
//   o' = o·corr + round(round(p)·v)    (p·v summed per block, then added)
// and after the last block o / max(l, 1e-30), in the input type.
//
// Two entries launch the same kernels (FlashArgs in flash_block_update.h):
// - fused (alink_tpu_torch/dl/attn_cuda.py::flash_blockwise): nb blocks,
//   empty state, o/m/l kept in registers, the normalised output written in
//   the caller's (B, S, H, D) layout. q, k and v are read in place by strides
//   (the unbind views of the (B, S, 3, H, D) qkv product). Keys in
//   [K, nb·block) are the reference's zero padding: masked, v = 0, so on a
//   fully masked row each adds p = 1 to l and nothing to o, as there.
// - per block (flash_block_update): nb = 1, block = K, a (Q, K) qk_ok mask,
//   o/m/l read from and written to memory in fp32.
//
// Bound. At the serving shape (B, S, H, D) = (32, 512, 12, 64), bf16, blocks
// of 128: q, k, v read once and the output written once are 100.7 MB, 30.1 µs
// at 3.35 TB/s; 4·B·H·S²·D = 25.8 GFLOP is 26.1 µs at 989 TFLOP/s. Bytes
// bound it, near the ridge, so both products must run on tensor cores and
// nothing but q, k, v and the output may touch device memory.
//
// Design (bf16): Hopper's wgmma for both products, TMA for the loads. One
// CTA of one warpgroup (4 warps) owns one (b, h, 64-row Q tile); each warp
// holds 16 rows' o, m and l in registers for the whole loop. K/V tiles of KT
// keys (128 for D ≤ 64, else 64) come by TMA, one thread issuing the boxes
// into a 2-stage ring with an mbarrier a stage, so that tile i+1 lands while
// tile i computes; TMA writes the 128-byte swizzle that the wgmma operand
// descriptors read (64 columns a region), fills rows past the tensor with
// zeros and reads q, k, v in place by strides. S = Q·Kᵀ is an SS wgmma
// (m64nKTk16) into registers; p is rounded to bf16 in registers and is the A
// operand of the P·V RS wgmma (m64nDk16, V N-major), summed in its own fp32
// accumulator per block. A block wider than KT takes two passes over its
// tiles (rowmax, then p and p·v, S recomputed) so that p is formed against
// the block's max, as in the reference. Ragged Q, K and blocks, and D ≤ 128
// (a multiple of 8, padded to 64 or 128 by the zero fill) are handled in the
// kernel; nothing is padded in memory. The fused D ≤ 64 instances are held to
// 168 registers, three CTAs an SM, which measured faster than two without
// spills. exp is ex2.approx of an FMA (see the p loop). Not yet: a
// persistent grid, warp-specialised producer/consumer warpgroups (ROADMAP
// B1).
//
// Design (fp32): CUDA-core FMA loops, as TF32 tensor cores would break the
// fp32 contract (atol 1e-5). One CTA of 256 threads per (b, h, 64-row Q
// tile), four threads a row; the fused block loop as above, each block's
// scores in a shared (64 × block) tile.

#include "flash_block_update.h"

#include <cuda.h>   // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>

namespace {

constexpr float NEG = -1e30f;   // the reference's finite mask value

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 128;   // one warpgroup: 4 warps of 16 query rows
constexpr int WG_ROWS = 64;
constexpr int ATOM = 64;          // values in a 128-byte swizzled row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x and y rounded to bf16 (round to nearest even), one paired conversion
__device__ __forceinline__ void round_bf16x2(float& x, float& y) {
  const uint32_t u = pack_bf16(x, y);
  x = __uint_as_float(u << 16);
  y = __uint_as_float(u & 0xffff0000u);
}

// 2^x, flushing subnormal results to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- TMA and mbarriers ---

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival of a phase, which then waits for bytes of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// more bytes for the current phase, without arriving
__device__ __forceinline__ void mbar_add_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(&map)) : "memory");
}
// one box of a 4-d tensor map into shared memory, completing on bar;
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// tensor maps of q (64-row boxes), k and v (KT-row boxes): boxes of 64
// values a row in the 128-byte swizzle; dims (D, S, H, B), or (D, H, S, B)
// where h_first (the two middle dims in order of stride)
struct FlashMaps {
  CUtensorMap q, k, v;
  int q_h_first, k_h_first, v_h_first;
};

// rows [s0, s0 + box rows) of head h, batch b, as DT / 64 column regions of
// `region` values each
template <int DT>
__device__ __forceinline__ void tma_rows(bf16* dst, int region,
                                         const CUtensorMap& map, int h_first,
                                         uint64_t* bar, int s0, int h, int b) {
#pragma unroll
  for (int c = 0; c < DT / ATOM; ++c)
    tma_load(dst + c * region, map, bar, c * ATOM, h_first ? h : s0,
             h_first ? s0 : h, b);
}

// --- wgmma: warpgroup products, operands in shared memory or registers ---

// descriptor of a tile in the 128-byte swizzle that TMA writes: rows of 128
// bytes, 8-row groups 1,024 bytes apart; lbo: bytes between 64-column
// regions (read where the operand is N-major and wider than 64)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register accesses across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(r[j][i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// d (64 × N, fp32) = a (64 × 16, K-major in smem) · b (N × 16, K-major in
// smem)ᵀ, plus d when accumulate; N = 8 × the rows of d
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 × N, fp32) = a (64 × 16 in registers, the mma A-fragment layout)
// · b (16 × N, N-major in smem), plus d when accumulate
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// a key of a tile being loaded: in the tile's block, with data (not zero
// padding), its kvalid
struct KeyBias {
  bool in_block, has_data;
  int valid;
};

// per-pair masks beyond kvalid, fixed at compile time
enum MaskMode { MASK_KEYS = 0, MASK_CAUSAL = 1, MASK_QK_OK = 2 };

// DT: head dim rounded up (64 or 128); KT: keys per tile; MODE: causal
// (fused entry) or a (Q, block) qk_ok mask (per-block entry); MINB: CTAs an
// SM must hold
template <int DT, int KT, int MODE, int MINB>
__global__ void __launch_bounds__(WG_THREADS, MINB)
flash_block_update_kernel(const FlashArgs a,
                          const __grid_constant__ FlashMaps maps) {
  constexpr int NT = KT / 8;    // score n-tiles
  constexpr int DN = DT / 8;    // output n-tiles
  constexpr int QREG = WG_ROWS * ATOM, KREG = KT * ATOM;   // region sizes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // tiles 1,024-byte aligned: the swizzle is a function of the address
  unsigned char* smem_al =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(smem_al);        // WG_ROWS × DT
  bf16* k_s = q_s + WG_ROWS * DT;                       // 2 × KT × DT
  bf16* v_s = k_s + 2 * KT * DT;                        // 2 × KT × DT
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * KT * DT);   // 2 × KT
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias_s + 2 * KT);  // 2

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * WG_ROWS;

  // steps: one per tile of a block that fits one tile; else a rowmax pass
  // over the block's tiles (K only), then the p·v pass (K and V)
  const int ntiles = (a.block + KT - 1) / KT;
  const int spb = ntiles == 1 ? 1 : 2 * ntiles;
  const int nsteps = a.nb * spb;

  static_assert(KT <= WG_THREADS, "one key a thread");
  // step (blk, r), r < ntiles of a two-pass block being the rowmax pass:
  // one thread puts the K (and V) boxes of KT rows from key k0 in flight;
  // rows past the tensor are zeros, rows past the block are masked out
  auto issue = [&](int blk, int r, int buf) {
    const int tile = r < ntiles ? r : r - ntiles;
    const int k0 = blk * a.block + tile * KT;
    const int tlen = min(KT, a.block - tile * KT);
    const bool with_v = ntiles == 1 || r >= ntiles;
    if (threadIdx.x == 0) {
      mbar_expect(&bar[buf], (with_v ? 2 : 1) * KT * DT * sizeof(bf16));
      tma_rows<DT>(k_s + buf * KT * DT, KREG, maps.k, maps.k_h_first,
                   &bar[buf], k0, h, b);
      if (with_v)
        tma_rows<DT>(v_s + buf * KT * DT, KREG, maps.v, maps.v_h_first,
                     &bar[buf], k0, h, b);
    }
    // this thread's key: its mask value is loaded now and turned into the
    // key's score bias when stored, after the current tile's compute
    const int j = threadIdx.x, key = k0 + j;
    KeyBias kb{j < tlen, key < a.K, 1};
    if (kb.in_block && kb.has_data && a.kvalid != nullptr)
      kb.valid = a.kvalid[(int64_t)b * a.K + key];
    return kb;
  };
  // the bias: 0 valid, -1e30 masked, -inf not a key of the tile's block
  auto store_bias = [&](const KeyBias& kb, int buf) {
    if (threadIdx.x < KT)
      bias_s[buf * KT + threadIdx.x] =
          !kb.in_block ? neg_inf() : kb.has_data && kb.valid > 0 ? 0.f : NEG;
  };

  if (threadIdx.x == 0) {
    prefetch_map(maps.k);
    prefetch_map(maps.v);
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    // the Q tile rides on the first step's barrier, whose one arrival
    // comes with the first K/V tiles
    mbar_add_tx(&bar[0], WG_ROWS * DT * sizeof(bf16));
    tma_rows<DT>(q_s, QREG, maps.q, maps.q_h_first, &bar[0], q0, h, b);
  }
  store_bias(issue(0, 0, 0), 0);
  __syncthreads();

  // this thread's rows: e = 0 → g, e = 1 → g + 8 of the warp's 16
  int qi[2];
  qi[0] = q0 + warp * 16 + g;
  qi[1] = qi[0] + 8;
  const int64_t bhq = (int64_t)bh * a.Q;

  float o[DN][4], m[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = a.m_in != nullptr && qi[e] < a.Q;
    m[e] = in ? a.m_in[bhq + qi[e]] : NEG;
    l[e] = in ? a.l_in[bhq + qi[e]] : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = 8 * j + 2 * t;
      float2 x = make_float2(0.f, 0.f);
      if (a.o_in != nullptr && qi[e] < a.Q && d < a.D)
        x = *reinterpret_cast<const float2*>(a.o_in + (bhq + qi[e]) * a.D + d);
      o[j][2 * e] = x.x;
      o[j][2 * e + 1] = x.y;
    }
  }

  float pv[DN][4];
  float m_blk[2], m_new[2], corr[2], lsum[2][2], ml[2][2];

  for (int step = 0, blk = 0, r = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    const bool last_r = r == spb - 1;
    // the n-th use of a buffer completes its barrier's n-th phase
    mbar_wait(&bar[buf], (step >> 1) & 1);

    const bool max_pass = ntiles > 1 && r < ntiles;
    const int tile = r < ntiles ? r : r - ntiles;
    const int k0 = blk * a.block + tile * KT;
    const bf16* kt = k_s + buf * KT * DT;
    const bf16* vt = v_s + buf * KT * DT;
    const float* bt = bias_s + buf * KT;

    if (r == 0) m_blk[0] = m_blk[1] = neg_inf();

    // S = Q·Kᵀ over the whole tile (keys past the block's are masked
    // below): a k-step is 16 values, 32 bytes along a region's rows
    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk)
      wgmma_ss(s,
               desc_sw128(smem_u32(q_s + (kk / 4) * QREG), 0) + 2 * (kk % 4),
               desc_sw128(smem_u32(kt + (kk / 4) * KREG), 0) + 2 * (kk % 4),
               kk > 0);
    wgmma_commit();
    // meanwhile the next step's tiles go to the other buffer, free since the
    // last step's closing barrier
    KeyBias next{};
    if (step + 1 < nsteps)
      next = issue(last_r ? blk + 1 : blk, last_r ? 0 : r + 1, buf ^ 1);
    wgmma_wait();
    fence_regs(s);

    // round, scale, mask: x = round(s)·scale + bias. A masked key's sum is
    // -1e30 exactly (|round(s)·scale| is far below half an ulp of 1e30), a
    // key past the block's stays -inf; causal and qk_ok pull a key down to
    // -1e30 with fminf, which leaves -inf as it is.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
      round_bf16x2(s[j][0], s[j][1]);
      round_bf16x2(s[j][2], s[j][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[j][i] = fmaf(s[j][i], a.scale, i & 1 ? bias.y : bias.x);
    }
    if constexpr (MODE == MASK_CAUSAL) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (qi[i >> 1] < k0 + 8 * j + 2 * t + (i & 1))
            s[j][i] = fminf(s[j][i], NEG);
    }
    if constexpr (MODE == MASK_QK_OK) {   // row and column clamped
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (a.qk_ok[(int64_t)min(qi[i >> 1], a.Q - 1) * a.block +
                      min(tile * KT + 8 * j + 2 * t + (i & 1),
                          a.block - 1)] <= 0)
            s[j][i] = fminf(s[j][i], NEG);
    }
    if (ntiles == 1 || max_pass) {
      // the tile's row max: two partial maxima a row, then the row's lanes
      float mx[2][2] = {{neg_inf(), neg_inf()}, {neg_inf(), neg_inf()}};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mx[j & 1][i >> 1] = fmaxf(mx[j & 1][i >> 1], s[j][i]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = fmaxf(mx[0][e], mx[1][e]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        m_blk[e] = fmaxf(m_blk[e], x);
      }
    }

    if (!max_pass) {
      const bool first = ntiles == 1 || r == ntiles;   // the block's p·v
      if (first) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m_new[e] = fmaxf(m[e], m_blk[e]);
          corr[e] = expf(fmaxf(m[e] - m_new[e], NEG));
          lsum[e][0] = lsum[e][1] = 0.f;
          // p = 2^(s·L − m'·L) with L = log2 e. A row whose keys were all
          // masked so far (m' = -1e30) takes L = 2^-100 instead, which is
          // exact on ±1e30: its masked keys get p = 1, as exp(0) in the
          // reference, and keys past the block's still get 0.
          const bool empty = m_new[e] == NEG;
          ml[e][0] = empty ? 0x1p-100f : 1.4426950408889634f;
          ml[e][1] = m_new[e] * ml[e][0];
        }
      }
      // p as above (ex2.approx): l sums it in fp32 (two partial sums a
      // row), p·v takes it rounded to bf16 in the A-fragment layout, 16 keys
      // a k-step
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[c][i] = ex2(fmaf(s[2 * kk + c][i], ml[i >> 1][0],
                               -ml[i >> 1][1]));
            lsum[i >> 1][c] += p[c][i];
          }
        pa[kk][0] = pack_bf16(p[0][0], p[0][1]);
        pa[kk][1] = pack_bf16(p[0][2], p[0][3]);
        pa[kk][2] = pack_bf16(p[1][0], p[1][1]);
        pa[kk][3] = pack_bf16(p[1][2], p[1][3]);
      }
      // P·V: a k-step is 16 keys, 16 rows of 128 bytes; the block's first
      // tile starts the sum, so pv is not live before it
      const uint64_t dv = desc_sw128(smem_u32(vt), KREG * sizeof(bf16));
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs(pv, pa[kk], dv + kk * (16 * 128 >> 4), !first || kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(pv);
      fence_regs(pa);   // read by the products until the wait
      if (last_r) {     // the block's last tile
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = lsum[e][0] + lsum[e][1];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          l[e] = __fadd_rn(__fmul_rn(l[e], corr[e]), x);
          m[e] = m_new[e];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          round_bf16x2(pv[j][0], pv[j][1]);
          round_bf16x2(pv[j][2], pv[j][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[j][i] = __fadd_rn(__fmul_rn(o[j][i], corr[i >> 1]), pv[j][i]);
        }
      }
    }
    if (step + 1 < nsteps) store_bias(next, buf ^ 1);
    __syncthreads();   // the buffer is refilled two steps on
    blk += last_r;
    r = last_r ? 0 : r + 1;
  }

  if (a.o_out != nullptr) {   // per-block entry: the fp32 state
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (qi[e] >= a.Q) continue;
      if (t == 0) {
        a.m_out[bhq + qi[e]] = m[e];
        a.l_out[bhq + qi[e]] = l[e];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = 8 * j + 2 * t;
        if (d < a.D)
          *reinterpret_cast<float2*>(a.o_out + (bhq + qi[e]) * a.D + d) =
              make_float2(o[j][2 * e], o[j][2 * e + 1]);
      }
    }
    return;
  }
  // fused entry: o / max(l, 1e-30) in bf16
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (qi[e] >= a.Q) continue;
    const float lc = fmaxf(l[e], 1e-30f);
    bf16* out = static_cast<bf16*>(a.out) +
                (((int64_t)b * a.Q + qi[e]) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < a.D)
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            __fdiv_rn(o[j][2 * e], lc), __fdiv_rn(o[j][2 * e + 1], lc));
    }
  }
}

// the bf16 instances: 128-key tiles for D ≤ 64, 64-key tiles for D ≤ 128
// (registers: s, p·v and o)
template <int DT>
struct Bf16Cfg {
  static constexpr int KT = DT == 64 ? 128 : 64;
  static size_t smem() {
    return 1024 + sizeof(bf16) * ((size_t)WG_ROWS * DT + 4 * (size_t)KT * DT) +
           sizeof(float) * 2 * KT + 2 * sizeof(uint64_t);
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, fetched through the runtime (the
// library links no libcuda); null when the driver lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &q) == cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 (B, ·, ·, D) tensor with S rows a head, by element strides, in
// boxes of `rows` rows of 64 values, 128-byte swizzled; the two middle dims
// in order of stride
cudaError_t encode_rows(CUtensorMap* map, int* h_first, const void* ptr,
                        const FlashArgs& a, int S, int64_t sb, int64_t sh,
                        int64_t ss, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const bool hf = sh < ss;
  *h_first = hf;
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)(hf ? a.H : S),
                              (cuuint64_t)(hf ? S : a.H), (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)(hf ? sh : ss) * sizeof(bf16),
                                 (cuuint64_t)(hf ? ss : sh) * sizeof(bf16),
                                 (cuuint64_t)sb * sizeof(bf16)};
  const cuuint32_t box[4] = {ATOM, hf ? 1u : (cuuint32_t)rows,
                             hf ? (cuuint32_t)rows : 1u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int DT, int MODE>
cudaError_t launch_bf16(const FlashArgs& a, cudaStream_t stream) {
  using C = Bf16Cfg<DT>;
  // the fused D ≤ 64 instances held to 168 registers, three CTAs an SM
  constexpr int MINB = DT == 64 && MODE != MASK_QK_OK ? 3 : 1;
  auto kern = flash_block_update_kernel<DT, C::KT, MODE, MINB>;
  const size_t smem = C::smem();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  FlashMaps maps{};
  if ((err = encode_rows(&maps.q, &maps.q_h_first, a.q, a, a.Q, a.q_sb,
                         a.q_sh, a.q_ss, WG_ROWS)) != cudaSuccess ||
      (err = encode_rows(&maps.k, &maps.k_h_first, a.k, a, a.K, a.k_sb,
                         a.k_sh, a.k_ss, C::KT)) != cudaSuccess ||
      (err = encode_rows(&maps.v, &maps.v_h_first, a.v, a, a.K, a.v_sb,
                         a.v_sh, a.v_ss, C::KT)) != cudaSuccess)
    return err;
  dim3 grid((a.Q + WG_ROWS - 1) / WG_ROWS, a.B * a.H);
  kern<<<grid, WG_THREADS, smem, stream>>>(a, maps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA loops
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per CTA
constexpr int KC = 64;          // keys per staged chunk
constexpr int TPR = 4;          // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KPT = KC / TPR;   // scores per thread per chunk

// stage nrows rows (row i at src + i·rs) of D values into smem with row
// stride ld (D + 1, against bank conflicts); rows ≥ nvalid become 0
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t rs,
                                      int nrows, int nvalid, int D, int ld) {
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    dst[r * ld + c] = r < nvalid ? src[r * rs + c] : 0.f;
  }
}

// DPT: output columns per thread (D ≤ TPR · DPT)
template <int DPT>
__global__ void __launch_bounds__(THREADS)
flash_block_update_fp32_kernel(const FlashArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, ldd = D + 1, lds = a.block + 1;
  float* q_s = smem;                 // BQ × ldd: the Q tile
  float* kv_s = q_s + BQ * ldd;      // KC × ldd: one K or V chunk
  float* s_s = kv_s + KC * ldd;      // BQ × lds: scores, then p

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, a.Q - q0);
  const int r = threadIdx.x / TPR;   // this thread's row in the tile
  const int g = threadIdx.x % TPR;   // and its lane within the row
  const int qi = q0 + r;
  const bool row_ok = r < nq;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int64_t row = (int64_t)bh * a.Q + qi;

  stage(q_s, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh +
                 q0 * a.q_ss, a.q_ss, BQ, nq, D, ldd);

  float o[DPT];
  const bool carried = a.m_in != nullptr && row_ok;
  float m = carried ? a.m_in[row] : NEG;
  float l = carried ? a.l_in[row] : 0.f;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = g + TPR * j;
    o[j] = a.o_in != nullptr && row_ok && d < D ? a.o_in[row * D + d] : 0.f;
  }

  for (int blk = 0; blk < a.nb; ++blk) {
    const int kb0 = blk * a.block;

    // pass 1: this row's scores against the block's keys, and their max
    float mx = neg_inf();
    for (int c0 = 0; c0 < a.block; c0 += KC) {
      const int kc = min(KC, a.block - c0);
      const int key0 = kb0 + c0;
      __syncthreads();               // Q staged / previous chunk consumed
      stage(kv_s, kp + key0 * a.k_ss, a.k_ss, KC, min(kc, a.K - key0), D, ldd);
      __syncthreads();
      float acc[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qv = q_s[r * ldd + d];
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          acc[j] = fmaf(qv, kv_s[(g + TPR * j) * ldd + d], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = g + TPR * j;
        if (c < kc) {
          const int kk = c0 + c, key = key0 + c;
          const bool ok =
              key < a.K &&
              (a.kvalid == nullptr || a.kvalid[(int64_t)b * a.K + key] > 0) &&
              (!a.causal || qi >= key) &&
              (a.qk_ok == nullptr || !row_ok ||
               a.qk_ok[(int64_t)qi * a.block + kk] > 0);
          const float s = ok ? acc[j] * a.scale : NEG;
          s_s[r * lds + kk] = s;
          mx = fmaxf(mx, s);
        }
      }
    }
    // the four lanes of a row are adjacent in the warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(fmaxf(m - m_new, NEG));

    // p = exp(s − m'); each thread rewrites exactly the scores it wrote
    float lsum = 0.f;
    for (int kk = g; kk < a.block; kk += TPR) {
      const float p = expf(s_s[r * lds + kk] - m_new);
      lsum += p;
      s_s[r * lds + kk] = p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);

    // pass 2: p·v for this thread's columns d = g + TPR·j
    float pv[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) pv[j] = 0.f;
    for (int c0 = 0; c0 < a.block; c0 += KC) {
      const int kc = min(KC, a.block - c0);
      const int key0 = kb0 + c0;
      __syncthreads();               // p written / previous chunk consumed
      stage(kv_s, vp + key0 * a.v_ss, a.v_ss, KC, min(kc, a.K - key0), D, ldd);
      __syncthreads();
      for (int c = 0; c < kc; ++c) {
        const float p = s_s[r * lds + c0 + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          if (g + TPR * j < D)
            pv[j] = fmaf(p, kv_s[c * ldd + g + TPR * j], pv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      o[j] = __fadd_rn(__fmul_rn(o[j], corr), pv[j]);
    l = __fadd_rn(__fmul_rn(l, corr), lsum);
    m = m_new;
  }

  if (!row_ok) return;
  if (a.o_out != nullptr) {
    if (g == 0) {
      a.m_out[row] = m;
      a.l_out[row] = l;
    }
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (g + TPR * j < D) a.o_out[row * D + g + TPR * j] = o[j];
  } else {
    const float lc = fmaxf(l, 1e-30f);
    float* out = static_cast<float*>(a.out) +
                 (((int64_t)b * a.Q + qi) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (g + TPR * j < D) out[g + TPR * j] = __fdiv_rn(o[j], lc);
  }
}

template <int DPT>
cudaError_t launch_fp32(const FlashArgs& a, cudaStream_t stream) {
  auto kern = flash_block_update_fp32_kernel<DPT>;
  const size_t smem = flash_smem_bytes(0, a.block, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Q + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

size_t flash_smem_bytes(int dtype, int block, int D) {
  if (dtype == 1) return D <= 64 ? Bf16Cfg<64>::smem() : Bf16Cfg<128>::smem();
  return sizeof(float) *
         ((size_t)(BQ + KC) * (D + 1) + (size_t)BQ * (block + 1));
}

cudaError_t flash_launch(int dtype, const FlashArgs& a, cudaStream_t stream) {
  if (dtype == 1) {
    const int mode = a.qk_ok != nullptr ? MASK_QK_OK
                     : a.causal         ? MASK_CAUSAL
                                        : MASK_KEYS;
#define FBU_BF16(DT)                                                         \
  return mode == MASK_QK_OK    ? launch_bf16<DT, MASK_QK_OK>(a, stream)  \
         : mode == MASK_CAUSAL ? launch_bf16<DT, MASK_CAUSAL>(a, stream) \
                               : launch_bf16<DT, MASK_KEYS>(a, stream)
    if (a.D <= 64) FBU_BF16(64);
    FBU_BF16(128);
#undef FBU_BF16
  }
  return a.D <= 16 * TPR ? launch_fp32<16>(a, stream)
                         : launch_fp32<32>(a, stream);
}
