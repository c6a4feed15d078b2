// Long-context causal (optionally sliding-window) flash attention for
// sm_90a on the tensor cores, with K/V fed through a producer's ring.
//
// Replaces the Pallas TPU kernel modegpt_tpu/kernels/flash_attention.py
// (`flash_attention_hbm`, body `_attn_kernel_hbm`), which the forward takes
// for T > 8192: softmax(q k^T) v per head with an online softmax over key
// tiles, GQA (kv head = q head / group), q/k width `hd` and v width `hd_v`
// independent and unaligned up to 256 (compressed models carry head dims
// such as 88, 90 or a padded 126), and a key visible iff
// q - window < k <= q  (window <= 0: plain causal). As the Pallas kernel:
//
//   * q is scaled in its own dtype before the product (the JAX wrapper
//     pre-scales it); scores and accumulators are f32; bfloat16 inputs
//     round the probabilities to bf16 before the P.V product, and the
//     row sums take them unrounded; the output is acc / max(l, 1e-30) in
//     q's dtype;
//   * float32 inputs keep float32 accuracy (the Pallas kernel runs them at
//     Precision.HIGHEST): every product is split into TF32 parts,
//     x = big + small with big = tf32(x) and small = x - big, and
//     big.big + big.small + small.big is accumulated in f32 (3xTF32). A
//     single TF32 pass would leave ~1e-3 of error where the tolerance is
//     rtol 2e-4 / atol 2e-5 (tests/test_torch_attention.py pins both).
//
// What bounds it on an H100: at the long-context shape (B=1, H=32, Hk=8,
// T=16384, hd=hd_v=128) the work is 2*B*H*(T(T+1)/2)*(hd+hd_v) = 2.2 TFLOP
// over ~0.7 GB of q/k/v/o (bf16: half), thousands of FLOPs per byte, so
// the tensor cores bound it, not HBM: bf16 at 989 TFLOP/s (2.22 ms); f32
// as three TF32 products at 494.7 TFLOP/s (13.3 ms; the CUDA cores' 67
// TFLOP/s would give 32.8 ms). What the design does about it:
//
//   * bf16 on the tensor cores through wgmma, a consumer warpgroup's 64
//     query rows at a time: scores m64nBKk16 with q and k both read from
//     shared memory through 128-byte-swizzle K-major descriptors; P.V
//     m64n(hd_v)k16 with the probabilities in registers (the score
//     accumulator's layout is the A-operand layout, so they are only
//     rounded to bf16 and packed) and v an MN-major operand the tensor
//     core transposes. Each product is issued, committed and waited for
//     before the softmax touches its registers (no overlap between them
//     yet).
//   * f32 through mma.sync m16n8k8 TF32, issued three times per product,
//     a warp's 16 query rows at a time: wgmma's TF32 form takes only
//     K-major operands, and P.V reduces over keys, down v's rows.
//     Operands come from shared memory with ldmatrix (q, k) or 32-bit
//     loads (v, whose fragment runs down the key axis). q's fragment is
//     split once per k-step and reused across the key tile, k's and v's
//     as they are read, p's from the score registers; each of the three
//     passes runs over every n-tile, so no MMA waits on the one before
//     it. The P.V A-fragment is the score accumulator itself: the key
//     order inside each 8-key step is permuted (k-index t <-> key 2t, t+4
//     <-> 2t+1) and v's rows read in the same order, so no shuffle is
//     needed.
//   * Warp specialisation: 8 consumer warps (two warpgroups, 16 query
//     rows a warp, 128 a block) and a producer warpgroup. The producers
//     keep a ring of 2-4 K/V stages (as many as fit in 227 KB) full; K
//     and V of a stage have their own full/empty mbarriers, so K of tile
//     t+2 loads while the consumers still run P.V on tile t. The
//     consumers never copy K/V.
//   * Copies: where a row is a multiple of 16 bytes and the base 16-byte
//     aligned (hd 128 in both dtypes, f32 hd 88), one producer thread
//     issues a TMA box per 128-byte column panel (cp.async.bulk.tensor,
//     128-byte swizzle, tensor map [B*Hk, T, d] so rows past T and columns
//     past d arrive as zeros) and the other three warps exit. Otherwise
//     (f32 hd 126 and 90, odd bf16 widths, K/V views at an 8-byte offset)
//     the four warps issue the widest cp.async that row and base allow
//     (16, 8 or 4 bytes; plain 2-byte copies for odd bf16 rows) into the
//     same swizzled layout, a warp per row in turn, and signal the
//     stage's mbarrier with cp.async.mbarrier.arrive (the bf16 consumers
//     then fence the async proxy before wgmma reads them). One warp's
//     small copies could not keep up (on an H100, one warp took 80 ms at
//     f32 hd 126 where four take 43, and TMA 40 at hd 128).
//     The choice is made at launch from the pointers and widths. The rest
//     of the gap at hd 126 is the misaligned rows themselves: TMA boxes
//     of rows landing shifted and realigned in shared memory measured no
//     better (1.08-1.12x).
//   * Shared layout: every tile is a stack of 128-byte column panels, 16-
//     byte chunk c of row r stored at chunk c ^ (r % 8) (TMA's 128-byte
//     swizzle, which is also wgmma's canonical 128B layout), so the eight
//     rows of every ldmatrix and of every f32 v fragment fall in 32
//     distinct banks. Head dims are zero-padded to the MMA depth (8 for
//     TF32, 16 for bf16) inside the panels.
//   * Masks run only on tiles that cross a warp's diagonal or window edge;
//     tiles no row of a product (a warp's in f32, a warpgroup's in bf16)
//     can see are skipped (the stage is only released).
//   * Causal imbalance: blockIdx.y counts query tiles from the last one
//     and blockIdx.x (advanced fastest) runs over batch*heads, so every
//     head's heaviest blocks start in the first wave.
//   * Head dims above 128 take 64-row blocks (4 consumer warps) and 32-key
//     tiles so that the output accumulators (up to 128 registers) and the
//     f32 tiles fit.
//   * Every q/k/v/o offset is 64-bit: B*H*T*hd passes 2^31 at long context.
//
// Left for later: overlapping one tile's softmax with the next tile's
// wgmma (two warpgroups ping-ponging), a persistent grid walking tiles
// heaviest first, clusters multicasting a K/V tile to the query blocks of
// one kv head, and fp8.
//
// The tile loop is a template over the dtype, the key tile, the consumer
// warps and the output width. Two C entries instantiate it through the
// same host-side selection: `modegpt_flash_attention_hbm` (this kernel,
// T > 8192) and `modegpt_flash_attention`, the port of the Pallas
// `flash_attention` (body `_attn_kernel`) that the forward takes for
// 128 <= T <= 8192. The two Pallas kernels compute the same function and
// differ only in how they stream K/V on the TPU; here one loop serves
// both. At the main path's dense shape (B=2, H=32, Hk=8, T=2048, hd=128,
// f32) the short-context entry does 2*B*H*(T(T+1)/2)*(hd+hd_v) = 68.8
// GFLOP over 100 MB, bound by the 3xTF32 rate (0.417 ms), as here.
//
// The PTX helpers (mbarriers, cp.async, ldmatrix, the TF32 split, the
// mma.sync forms) are in ptx.cuh, shared with ragged_decode.cu; TMA and
// wgmma, which only this kernel issues, are below.

#include <cuda.h>  // CUtensorMap and its enums (types only; the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int PANEL = 128;          // bytes per panel row
constexpr int SMEM_LIMIT = 232448;  // the H100's per-block opt-in
constexpr int MAX_STAGES = 4;
constexpr int PW = 4;               // producer warps: one warpgroup
constexpr float NEG_INF = -1e30f;   // the running max's start: finite, so exp2(m_old - m_new) = 1 on empty rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t MINUS_INF_BITS = 0xff800000u;  // a masked score

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hk, seq, hd, hd_v;
  float scale;  // rounded to q's dtype by the caller
  int window;
  int k_copy, v_copy;  // 0: TMA; else the cp.async width in bytes (16, 8, 4; 2 = plain copies)
  int q_panels, v_panels;
  int stages;
};

// ---- TMA (the other PTX helpers are in ptx.cuh) ----

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma (bf16): one warpgroup's 64 query rows ----

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// from one 64-element panel to the next), stride byte offset 1024 (the
// next 8-row group), swizzle mode 128B.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// d[64 x N] += A[64 x 16] B[16 x N]^T, both K-major in shared memory
// (scores: q rows against key rows).
template <int N> __device__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
template <> __device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15"
      " }, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      " }, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (the probabilities
// in the mma.sync m16n8k16 A layout, a warp per 16 rows), B MN-major in
// shared memory (v rows, transposed by the tensor core).
template <int N> __device__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db);
template <> __device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      " }, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47"
      " }, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63"
      " }, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127"
      " }, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of (row, column byte cb) in a stack of 128-byte panels of
// `rows` rows each, with TMA's 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int rows, int row, int cb) {
  return (uint32_t)((cb >> 7) * rows * PANEL + row * PANEL + ((((cb >> 4) & 7) ^ (row & 7)) << 4) + (cb & 15));
}

// The producers' cp.async path: rows [0, rows) of a row-major source with
// `row_bytes` per row into a swizzled tile of BK rows, `w` bytes a copy.
// Lane l owns the chunks l, l + 32, ... of a row (a warp's copies of one
// row are contiguous), producer warp pw the rows pw, pw + PW, ...; then
// the stage's barrier is signalled once each thread's copies have landed.
template <int BK>
__device__ __forceinline__ void copy_tile(unsigned char* smem, uint32_t smem_base, uint32_t tile,
                                          const char* src, int rows, int row_bytes, int w,
                                          uint32_t bar, int pw, int lane) {
  for (int cb = lane * w; cb < row_bytes; cb += 32 * w) {
    const uint32_t col = tile + (uint32_t)((cb >> 7) * BK * PANEL + (cb & 15));
    const int chunk = (cb >> 4) & 7;
    const char* s = src + (int64_t)pw * row_bytes + cb;
#pragma unroll 4
    for (int r = pw; r < rows; r += PW) {
      const uint32_t dst = col + r * PANEL + ((chunk ^ (r & 7)) << 4);
      if (w >= 4) {
        cp_async(dst, s, w);
      } else {  // bf16 rows of odd width
        *reinterpret_cast<uint16_t*>(smem + (dst - smem_base)) = *reinterpret_cast<const uint16_t*>(s);
      }
      s += PW * row_bytes;
    }
  }
  if (w >= 4) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
  } else {
    mbar_arrive(bar);
  }
}

// One block: BQ = 16*CW query rows of one (batch, head) against its key
// tiles. NV: output n-tiles of 8 columns held per thread (hd_v <= 8*NV, a
// multiple of 4); the V tile holds 8*NV columns, zero past hd_v.
template <typename T, int BK, int CW, int NV>
__global__ void __launch_bounds__((CW + PW) * 32, 1)
attention_tile_loop(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    const Params p) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BQ = 16 * CW;
  constexpr int ES = (int)sizeof(T);
  constexpr int NS = BK / 8;  // score n-tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);

  const uint32_t kt_bytes = (uint32_t)p.q_panels * BK * PANEL;
  const uint32_t vt_bytes = (uint32_t)p.v_panels * BK * PANEL;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + (uint32_t)p.q_panels * BQ * PANEL;
  const uint32_t sV = sK + p.stages * kt_bytes;
  const uint32_t bars = sV + p.stages * vt_bytes;
  auto full_k = [&](int s) { return bars + 8u * s; };
  auto full_v = [&](int s) { return bars + 8u * (p.stages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 * p.stages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (3 * p.stages + s); };

  const int bh = blockIdx.x;
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // heaviest query tiles first
  const int b = bh / p.H;
  const int kvh = b * p.Hk + (bh % p.H) / (p.H / p.Hk);
  const int q0 = qt * BQ;
  const int k_end = min(q0 + BQ, p.seq);  // keys at or past k_end are masked for every row
  const int k_first = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_first = k_first / BK;
  const int t_end = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // The cp.async paths write neither pad columns nor rows past T: zero the
  // ring once so they hold finite values (0 * NaN would poison the sums).
  if (p.k_copy != 0 || p.v_copy != 0) {
    uint4* z = reinterpret_cast<uint4*>(smem + (sK - base));
    const int n = (int)((bars - sK) / 16);
    for (int i = tid; i < n; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full_k(s), p.k_copy == 0 ? 1 : PW * 32);
      mbar_init(full_v(s), p.v_copy == 0 ? 1 : PW * 32);
      mbar_init(empty_k(s), CW * 32);
      mbar_init(empty_v(s), CW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeroed ring before TMA writes
  __syncthreads();

  if (warp >= CW) {
    // ---- producer: one warpgroup keeps the K/V ring full ----
    const int pw = warp - CW;
    if (pw > 0 && p.k_copy == 0 && p.v_copy == 0) return;  // TMA needs one thread
    const int krow = p.hd * ES, vrow = p.hd_v * ES;
    const char* kb = static_cast<const char*>(p.k) + (int64_t)kvh * p.seq * krow;
    const char* vb = static_cast<const char*>(p.v) + (int64_t)kvh * p.seq * vrow;
    int slot = 0;
    uint32_t phase = 0;
    for (int t = t_first; t < t_end; ++t) {
      const int k0 = t * BK;
      const int rows = min(BK, p.seq - k0);
      mbar_wait(empty_k(slot), phase ^ 1);
      if (p.k_copy == 0) {
        if (pw == 0 && lane == 0) {
          mbar_arrive_expect_tx(full_k(slot), kt_bytes);
          for (int pn = 0; pn < p.q_panels; ++pn)
            tma_load_3d(sK + slot * kt_bytes + pn * BK * PANEL, &tm_k, full_k(slot), pn * (PANEL / ES), k0, kvh);
        }
      } else {
        copy_tile<BK>(smem, base, sK + slot * kt_bytes, kb + (int64_t)k0 * krow, rows, krow, p.k_copy,
                      full_k(slot), pw, lane);
      }
      mbar_wait(empty_v(slot), phase ^ 1);
      if (p.v_copy == 0) {
        if (pw == 0 && lane == 0) {
          mbar_arrive_expect_tx(full_v(slot), vt_bytes);
          for (int pn = 0; pn < p.v_panels; ++pn)
            tma_load_3d(sV + slot * vt_bytes + pn * BK * PANEL, &tm_v, full_v(slot), pn * (PANEL / ES), k0, kvh);
        }
      } else {
        copy_tile<BK>(smem, base, sV + slot * vt_bytes, vb + (int64_t)k0 * vrow, rows, vrow, p.v_copy,
                      full_v(slot), pw, lane);
      }
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumers: 16 query rows per warp ----
    const int w0 = q0 + warp * 16;
    const int g = lane / 4, t4 = lane % 4;
    const int ksteps = (p.hd * ES + 31) / 32;  // 32-byte k-steps: 8 f32 or 16 bf16 columns
    const int q_cols = p.q_panels * (PANEL / ES);

    // q rows of this warp, scaled and rounded in q's dtype, zero past hd
    // and past T; bf16 products read a warpgroup's 64 rows through the
    // async proxy
    const int wg = warp / 4;
    {
      const T* qb = static_cast<const T*>(p.q) + (int64_t)bh * p.seq * p.hd;
      for (int r = 0; r < 16; ++r) {
        const int qi = w0 + r;
        for (int c = lane; c < q_cols; c += 32) {
          const float x = (qi < p.seq && c < p.hd) ? to_f(qb[(int64_t)qi * p.hd + c]) * p.scale : 0.f;
          *reinterpret_cast<T*>(smem + (sQ - base) + swz(BQ, warp * 16 + r, c * ES)) = from_f<T>(x);
        }
      }
      if constexpr (F32) {
        __syncwarp();
      } else {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
    }

    float o[NV][4];
#pragma unroll
    for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};  // rows g and g + 8

    // ldmatrix lane roles: lane supplies row (lane & 7) of matrix lane / 8
    const int mi = lane >> 3, r8 = lane & 7;
    const uint32_t q_lane = sQ + (uint32_t)(warp * 16 + (mi & 1) * 8 + r8) * PANEL;
    const int q_hi = mi >> 1;  // matrices 2, 3: the k-step's second 16 bytes
    const uint32_t k_lane_row = (uint32_t)((mi >> 1) * 8 + r8) * PANEL;
    const int k_hi = mi & 1;

    // the rows one product covers: a warp's 16 (mma.sync) or its
    // warpgroup's 64 (wgmma); a tile is skipped only when none sees it
    constexpr int PR = F32 ? 16 : 64;
    const int p0 = F32 ? w0 : q0 + wg * 64;
    const uint32_t q_wg = sQ + (uint32_t)(wg * 64) * PANEL;

    int slot = 0;
    uint32_t phase = 0;
    for (int t = t_first; t < t_end; ++t) {
      const int k0 = t * BK;
      const bool live = p0 < p.seq && k0 <= p0 + PR - 1 && (p.window <= 0 || k0 + BK - 1 > p0 - p.window);
      const bool whole = k0 + BK - 1 <= w0 && k0 + BK <= p.seq && (p.window <= 0 || k0 > w0 + 15 - p.window);
      const uint32_t kt = sK + slot * kt_bytes;
      const uint32_t vt = sV + slot * vt_bytes;

      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

      mbar_wait(full_k(slot), phase);
      if (live) {
        if constexpr (F32) {
#pragma unroll 2
          for (int ks = 0; ks < ksteps; ++ks) {
            const int cq = 2 * ks + q_hi;
            uint32_t a[4];
            ldmatrix_x4(a, q_lane + (cq >> 3) * BQ * PANEL + (((cq & 7) ^ r8) << 4));
            const int ck = 2 * ks + k_hi;
            const uint32_t k_addr = kt + (ck >> 3) * BK * PANEL + k_lane_row + (((ck & 7) ^ r8) << 4);
            // the three TF32 passes each run over all n-tiles, so that no
            // MMA waits on the one before it
            uint32_t a_big[4], a_small[4], bk[NS / 2][4], bk_small[NS / 2][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), a_big[e], a_small[e]);
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) ldmatrix_x4(bk[jp], k_addr + jp * 16 * PANEL);
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp)
#pragma unroll
              for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(bk[jp][e]), bk[jp][e], bk_small[jp][e]);
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) {
              mma_tf32(s[2 * jp], a_small, bk[jp][0], bk[jp][1]);
              mma_tf32(s[2 * jp + 1], a_small, bk[jp][2], bk[jp][3]);
            }
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) {
              mma_tf32(s[2 * jp], a_big, bk_small[jp][0], bk_small[jp][1]);
              mma_tf32(s[2 * jp + 1], a_big, bk_small[jp][2], bk_small[jp][3]);
            }
#pragma unroll
            for (int jp = 0; jp < NS / 2; ++jp) {
              mma_tf32(s[2 * jp], a_big, bk[jp][0], bk[jp][1]);
              mma_tf32(s[2 * jp + 1], a_big, bk[jp][2], bk[jp][3]);
            }
          }
        } else {
          // k may have landed through cp.async (the generic proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wgmma_fence();
          for (int ks = 0; ks < ksteps; ++ks) {
            const uint32_t off = (uint32_t)(ks & 3) * 32;
            wgmma_ss<BK>(&s[0][0], gmma_desc(q_wg + (ks >> 2) * BQ * PANEL + off, 16),
                         gmma_desc(kt + (ks >> 2) * BK * PANEL + off, 16));
          }
          wgmma_commit();
          wgmma_wait();
        }
      }
      mbar_arrive(empty_k(slot));

      if (live) {
        if (!whole) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = w0 + g + (e >= 2 ? 8 : 0);
              const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
              if (!(kj <= qi && kj < p.seq && (p.window <= 0 || kj > qi - p.window))) s[j][e] = __uint_as_float(MINUS_INF_BITS);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = __uint_as_float(MINUS_INF_BITS);
#pragma unroll
          for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_r[h], mx);
          const float alpha = exp2f((m_r[h] - m_new) * LOG2E);
          const float ml = m_new * LOG2E;
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const float pe = exp2f(fmaf(s[j][e], LOG2E, -ml));
              rs += pe;
              s[j][e] = pe;
            }
          l_r[h] = l_r[h] * alpha + rs;
          m_r[h] = m_new;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            o[n][2 * h] *= alpha;
            o[n][2 * h + 1] *= alpha;
          }
        }
      }

      mbar_wait(full_v(slot), phase);
      if (live) {
        if constexpr (F32) {
          // v fragment: rows (keys) 2*t4 and 2*t4 + 1 of each 8-key step,
          // column 8n + g; the odd row's chunk index differs in bit 0
          const uint32_t v_lane = vt + (uint32_t)(2 * t4) * PANEL + ((g >> 2) << 4) + 4 * (g & 3);
          uint32_t cx[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cx[i] = (uint32_t)(((2 * i) ^ (2 * t4)) << 4);
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            uint32_t a_big[4], a_small[4];
            split_tf32(s[j][0], a_big[0], a_small[0]);  // (row g,     k t)   = key 2t
            split_tf32(s[j][2], a_big[1], a_small[1]);  // (row g + 8, k t)   = key 2t
            split_tf32(s[j][1], a_big[2], a_small[2]);  // (row g,     k t+4) = key 2t + 1
            split_tf32(s[j][3], a_big[3], a_small[3]);  // (row g + 8, k t+4) = key 2t + 1
            const uint32_t row_j = v_lane + j * 8 * PANEL;
#pragma unroll
            for (int n0 = 0; n0 < NV; n0 += 4) {  // one 32-column group: a panel's worth in f32
              uint32_t vb[4][2], vs[4][2];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t addr = row_j + (n0 >> 2) * BK * PANEL + cx[i];
                split_tf32(__uint_as_float(lds32(addr)), vb[i][0], vs[i][0]);
                split_tf32(__uint_as_float(lds32((addr + PANEL) ^ 16u)), vb[i][1], vs[i][1]);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], a_small, vb[i][0], vb[i][1]);
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], a_big, vs[i][0], vs[i][1]);
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_tf32(o[n0 + i], a_big, vb[i][0], vb[i][1]);
            }
          }
        } else {
          uint32_t a[NS / 2][4];
#pragma unroll
          for (int kk = 0; kk < NS / 2; ++kk) {
            a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NS / 2; ++kk)
            wgmma_rs<8 * NV>(&o[0][0], a[kk], gmma_desc(vt + kk * 16 * PANEL, BK * PANEL));
          wgmma_commit();
          wgmma_wait();
        }
      }
      mbar_arrive(empty_v(slot));
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }

    // epilogue: the four lanes of a row hold parts of its sum
    T* ob = static_cast<T*>(p.o) + (int64_t)bh * p.seq * p.hd_v;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qi = w0 + g + 8 * h;
      if (qi >= p.seq) continue;
      T* orow = ob + (int64_t)qi * p.hd_v;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col < p.hd_v) orow[col] = from_f<T>(o[n][2 * h] * inv);
        if (col + 1 < p.hd_v) orow[col + 1] = from_f<T>(o[n][2 * h + 1] * inv);
      }
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [B*Hk, T, d] tensor map whose box is one 128-byte column panel of BK
// rows, 128-byte swizzled; reads past T or d fill zeros.
template <typename T>
bool encode_panel_map(CUtensorMap* map, const void* ptr, int rows_outer, int seq, int d, int bk) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)rows_outer};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(T), (cuuint64_t)d * sizeof(T) * seq};
  const cuuint32_t box[3] = {(cuuint32_t)(PANEL / sizeof(T)), (cuuint32_t)bk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType dt =
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 0 (TMA) where the rows are whole 16-byte chunks on a 16-byte aligned
// base; otherwise the widest cp.async (16, 8 or 4 bytes) that divides a
// row's byte width and the base's alignment, or 2 for odd bf16 rows.
int copy_mode(const void* p, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (row_bytes % 16 == 0 && a % 16 == 0) return 0;
  for (int w = 8; w >= 4; w /= 2)
    if (row_bytes % w == 0 && a % w == 0) return w;
  return 2;
}

template <typename T, int BK, int CW, int NV>
cudaError_t launch_cfg(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int seq,
                       int hd, int hd_v, float scale, int window, cudaStream_t stream) {
  constexpr int BQ = 16 * CW;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.H = H;
  p.Hk = Hk;
  p.seq = seq;
  p.hd = hd;
  p.hd_v = hd_v;
  p.scale = scale;
  p.window = window;
  p.q_panels = (hd * (int)sizeof(T) + PANEL - 1) / PANEL;
  p.v_panels = (8 * NV * (int)sizeof(T) + PANEL - 1) / PANEL;
  p.k_copy = copy_mode(k, hd * (int)sizeof(T));
  p.v_copy = copy_mode(v, hd_v * (int)sizeof(T));

  const size_t fixed = 1024 + (size_t)p.q_panels * BQ * PANEL;
  const size_t per_stage = (size_t)(p.q_panels + p.v_panels) * BK * PANEL + 4 * 8;
  const int stages = (int)std::min<size_t>(MAX_STAGES, (SMEM_LIMIT - fixed) / per_stage);
  if (fixed > (size_t)SMEM_LIMIT || stages < 2) return cudaErrorInvalidValue;
  p.stages = stages;
  const size_t smem = fixed + stages * per_stage;

  CUtensorMap tm_k, tm_v;
  memset(&tm_k, 0, sizeof(tm_k));
  memset(&tm_v, 0, sizeof(tm_v));
  if (p.k_copy == 0 && !encode_panel_map<T>(&tm_k, k, B * Hk, seq, hd, BK)) return cudaErrorInvalidValue;
  if (p.v_copy == 0 && !encode_panel_map<T>(&tm_v, v, B * Hk, seq, hd_v, BK)) return cudaErrorInvalidValue;

  auto kernel = attention_tile_loop<T, BK, CW, NV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (seq + BQ - 1) / BQ);
  kernel<<<grid, (CW + PW) * 32, smem, stream>>>(tm_k, tm_v, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int seq, int hd,
                   int hd_v, float scale, int window, cudaStream_t stream) {
  if (hd <= 128 && hd_v <= 128) {  // 128-row blocks, 64-key tiles, hd_v rounded up to 64, 96 or 128
    if (hd_v <= 64) return launch_cfg<T, 64, 8, 8>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, stream);
    if (hd_v <= 96) return launch_cfg<T, 64, 8, 12>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, stream);
    return launch_cfg<T, 64, 8, 16>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, stream);
  }
  // head dims up to 256: 64-row blocks and 32-key tiles
  return launch_cfg<T, 32, 4, 32>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, stream);
}

int launch_dtype(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int seq, int hd,
                 int hd_v, float scale, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes; both entries share one signature.
// dtype: 0 = float32, 1 = bfloat16. q [B,H,T,hd], k [B,Hk,T,hd], v
// [B,Hk,T,hd_v], o [B,H,T,hd_v], all contiguous on the current device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int modegpt_flash_attention_hbm(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int Hk, int seq, int hd, int hd_v,
                                           float scale, int window, int dtype, void* stream) {
  return launch_dtype(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, dtype, stream);
}

// K1, the short-context kernel: the same tile loop.
extern "C" int modegpt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Hk, int seq, int hd, int hd_v,
                                       float scale, int window, int dtype, void* stream) {
  return launch_dtype(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, dtype, stream);
}
