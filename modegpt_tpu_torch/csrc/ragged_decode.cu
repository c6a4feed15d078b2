// Ragged GQA attention over a slot-table KV pool, for sm_90a: split-K
// decode on the CUDA cores and prefill chunks on the tensor cores.
//
// Replaces the Pallas TPU kernel modegpt_tpu/kernels/ragged_decode.py
// (`ragged_gqa_attend`, body `_kernel`; `ragged_gqa_decode` is its S=1
// form). Slot b's query s sits at position pos[b]+s and attends keys t in
// [lo(s), pos[b]+s] with lo(s) = max(0, pos[b]+s+1-window) (0 without a
// window), t < T. q is pre-scaled. The cache pool is either q's dtype or
// int8 codes with per-(slot, head, position) float32 scales: k_scale
// multiplies the score columns before softcap and masking, v_scale the
// probability rows AFTER the normaliser l has summed the unscaled p.
// Softcap is cap*tanh(s/cap). float32 keeps float32 accuracy (FMA on the
// CUDA cores, or three TF32 products on the tensor cores); bfloat16 keeps
// f32 scores and accumulators and rounds p (times v_scale) to bf16 before
// the P.V product. The output is acc / max(l, 1e-30) in q's dtype; keys
// at or past the pool's end are never read, and a row with no live key
// (a windowed row wholly past the end) is zero.
//
// A kv head's G*S query rows (row = g*S + s, contiguous in q's
// [B, H, S, R] layout) all read the same K/V rows, so every form reads a
// K/V tile once per kv head, never once per query head.
//
// What bounds it on an H100, and what the design does about it:
//
//   * Decode (G*S <= 16 rows; serving: S=1, 8 slots, 32 heads over 8 kv
//     heads, ranks ~126) does ~G/2 FLOP per byte of live K/V: it is bound
//     by the bytes of each slot's live K/V rows at 3.35 TB/s, ~7 us.
//     Flash-decoding: the grid is one block per (key split, kv head,
//     slot); the split is sized from T at launch so that the grid holds
//     ~1024 blocks (64 keys a split at T = 1024 and 64 slot-heads). pos
//     lives on the device, so a split outside its slot's live range exits
//     at once. Each block's 128 threads copy 32-key K/V tiles with
//     cp.async into a double-buffered ring, as wide as the row and base
//     allow (16 bytes; 8 for f32 rank 126, whose 504-byte rows are only
//     8-byte aligned; int8 codes as raw bytes, widened in registers). Work
//     is spread over keys, not rows: each warp owns 8 keys of the tile and
//     each lane one key and a quarter of its 16-byte chunks, dotted
//     against all G*S rows (held in shared memory), so no warp idles at
//     G=1. Each warp keeps its own online softmax; at the end the block
//     merges its four warps into one partial (m, l, acc) per row.
//   * Chunks (G*S > 16: per-slot prefill, S=128) are FLOP-bound (~128 FLOP
//     per byte at S=128): on the tensor cores with K2's arithmetic,
//     mma.sync m16n8k8 TF32 issued three times per product for f32
//     (big.big + big.small + small.big), m16n8k16 for bf16; 4 warps of 16
//     rows (64 rows a block), 32-key tiles, the score accumulator reused
//     as the P.V operand (f32: keys permuted inside each 8-key step, as
//     K2). K/V tiles are cp.async'd into a double-buffered ring of rows
//     padded to a stride of 16 mod 128 bytes (conflict-free 32-bit fragment
//     loads); int8 codes are converted to q's dtype as they are staged
//     (exact: |code| <= 127). Keys are split as in decode (a 128-token
//     chunk of one slot gives only 64 row blocks).
//   * Both forms write (m, l, acc) per (split, row) to f32 scratch that
//     the wrapper allocates; a second small kernel rescales each by
//     exp(m_i - M) and sums. A split with no live key for a row leaves
//     m = -1e30 (finite), l = 0, acc = 0, so it adds exactly nothing, and
//     splits outside the live range are skipped by the same rule that let
//     their blocks exit.
//
// The PTX helpers are in ptx.cuh, shared with flash_attention_hbm.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;  // an empty running max: finite, so exp(NEG_INF - NEG_INF) * 0 adds nothing
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t MINUS_INF_BITS = 0xff800000u;  // a masked score
constexpr int SMEM_LIMIT = 232448;  // the H100's per-block opt-in

// decode form
constexpr int DW = 4;              // warps a block
constexpr int DKW = 8;             // keys a warp owns in a tile
constexpr int DBK = DW * DKW;      // keys a tile (32)
constexpr int DEC_ROWS = 16;       // the decode form takes G*S <= 16
constexpr int DEC_TARGET = 1024;   // blocks the decode grid aims at, dead splits included
// chunk form
constexpr int CW = 4;              // warps a block, 16 query rows each
constexpr int CBQ = 16 * CW;       // query rows a block (64)
constexpr int CBK = 32;            // keys a tile
constexpr int CH_TARGET = 512;     // blocks the chunk grid aims at

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 scales [B, Hk, T] or null
  const float* vs;
  const int* pos;
  void* o;
  float* ml;   // [B*Hk, nsplit, rows, 2]: (m, l) of each (split, row)
  float* acc;  // [B*Hk, nsplit, rows, Rv]: the unnormalised P.V of each (split, row)
  int H, Hk, S, T, Rq, Rv, window;
  float softcap;
  int rows;                // G*S
  int split, nsplit;       // keys a split; ceil(T / split)
  int k_copy, v_copy;      // bytes a copy: 16, 8, 4 (cp.async) or 2, 1 (plain loads)
  int k_stride, v_stride;  // bytes a shared K / V row
  int q_stride;            // chunk form: bytes a shared q row
};

struct Range {  // inclusive; empty when lo > hi
  int lo, hi;
};

// Keys live for query positions pos + [s_lo, s_hi] (the union of their
// ranges), clamped to the pool.
__device__ __forceinline__ Range live_keys(const Args& a, int p0, int s_lo, int s_hi) {
  Range r;
  r.lo = a.window > 0 ? max(0, p0 + s_lo + 1 - a.window) : 0;
  r.hi = min(p0 + s_hi, a.T - 1);
  return r;
}

// Copy rows [0, n) of a row-major source (row_bytes a row) into shared
// rows of `stride` bytes, w bytes a copy: cp.async for 16, 8 and 4, plain
// loads for 2 and 1. The block's threads walk the copies of all rows in
// turn, so neighbouring threads copy neighbouring bytes.
__device__ __forceinline__ void stage_raw(unsigned char* dst, const unsigned char* src, int n, int row_bytes,
                                          int stride, int w) {
  const int per_row = row_bytes / w;
  const int total = n * per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * w;
    const unsigned char* s = src + (int64_t)r * row_bytes + c;
    unsigned char* d = dst + r * stride + c;
    if (w >= 4) {
      cp_async(smem_u32(d), s, w);
    } else if (w == 2) {
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
    } else {
      *d = *s;
    }
  }
}

// One 16-byte chunk of a shared K row, widened to f32.
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[16]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * i + e] = (float)(int8_t)(w[i] >> (8 * e));
}

__device__ __forceinline__ float warp_max8(float x) {  // over lanes that differ in bits 0-2
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 4));
}

__device__ __forceinline__ float warp_sum8(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x + __shfl_xor_sync(FULL, x, 4);
}

// ---- decode form: one block per (split, kv head, slot) ----

// Key kk of a warp's tile into the P.V sums: acc[r][c] += p[r][kk] *
// v[kk][col] over the lane's output columns (col = lane + 32 c). sPw is
// the warp's [RMAX][DKW] probabilities.
template <typename KV, int RMAX, int VPT>
__device__ __forceinline__ void pv_key(const KV* vrow, const float* sPw, int kk, int lane, int Rv, int rows,
                                       float (&acc)[RMAX][VPT]) {
  float pv[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) pv[r] = sPw[r * DKW + kk];
#pragma unroll
  for (int c = 0; c < VPT; ++c) {
    const int col = lane + WARP * c;
    if (col < Rv) {
      const float vv = to_f(vrow[col]);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < rows) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
    }
  }
}

// T: q / output dtype; KV: pool dtype (T, or int8_t with scales); RMAX >=
// rows; VPT: output columns a lane holds (Rv <= 32 * VPT).
template <typename T, typename KV, int RMAX, int VPT>
__global__ void __launch_bounds__(DW * WARP) decode_split(const Args a) {
  constexpr int ES = (int)sizeof(KV);
  constexpr int EPC = 16 / ES;  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int p0 = a.pos[b];
  const Range pair = live_keys(a, p0, 0, a.S - 1);
  const int k_lo = max(pair.lo, sp * a.split);
  const int k_hi = min(pair.hi, sp * a.split + a.split - 1);
  if (k_lo > k_hi) return;  // the combine skips this split by the same rule

  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const int G = a.H / a.Hk;
  const int k_row = a.Rq * ES, v_row = a.Rv * ES;
  const int nck = (k_row + 15) / 16;  // 16-byte chunks of a K row
  const int qld = nck * EPC;          // floats of a shared q row, zero past Rq
  float* sQ = reinterpret_cast<float*>(smem);  // [RMAX][qld]
  float* sP = sQ + RMAX * qld;                 // [DW][RMAX][DKW]: p * v_scale, rounded to T
  unsigned char* ring = reinterpret_cast<unsigned char*>(sP + DW * RMAX * DKW);
  const int stage_bytes = DBK * (a.k_stride + a.v_stride);
  auto sK = [&](int st) { return ring + st * stage_bytes; };
  auto sV = [&](int st) { return ring + st * stage_bytes + DBK * a.k_stride; };

  const int64_t pair_i = (int64_t)b * a.Hk + kvh;
  const unsigned char* kb = static_cast<const unsigned char*>(a.k) + pair_i * a.T * k_row;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v) + pair_i * a.T * v_row;
  const float* ksb = a.ks != nullptr ? a.ks + pair_i * a.T : nullptr;
  const float* vsb = a.vs != nullptr ? a.vs + pair_i * a.T : nullptr;
  const T* qb = static_cast<const T*>(a.q) + ((int64_t)b * a.H + (int64_t)kvh * G) * a.S * a.Rq;

  for (int i = tid; i < RMAX * qld; i += blockDim.x) {
    const int r = i / qld, c = i - r * qld;
    sQ[i] = (r < a.rows && c < a.Rq) ? to_f(qb[(int64_t)r * a.Rq + c]) : 0.f;
  }
  // the bytes past a K row up to its last chunk's end: zero (q is zero
  // there, and 0 * NaN would poison the score); copies never write them
  const int k_tail = nck * 16 - k_row;
  for (int i = tid; i < 2 * DBK * k_tail; i += blockDim.x) {
    const int r = i / k_tail, c = i - r * k_tail;
    sK(r / DBK)[(r % DBK) * a.k_stride + k_row + c] = 0;
  }
  __syncthreads();

  const int n_tiles = (k_hi - k_lo + DBK) / DBK;
  auto load = [&](int tile, int st) {
    const int t0 = k_lo + tile * DBK;
    const int n = min(DBK, k_hi + 1 - t0);
    stage_raw(sK(st), kb + (int64_t)t0 * k_row, n, k_row, a.k_stride, a.k_copy);
    stage_raw(sV(st), vb + (int64_t)t0 * v_row, n, v_row, a.v_stride, a.v_copy);
    cp_async_commit();
  };

  const int kl = warp * DKW + (lane & 7);  // this lane's key in the tile
  const int j = lane >> 3;                 // and its quarter of the row's chunks
  int lo[RMAX], hi[RMAX];
  float m[RMAX], l[RMAX], acc[RMAX][VPT];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int s = r % a.S;
    const Range rr = live_keys(a, p0, s, s);
    lo[r] = r < a.rows ? rr.lo : 1;
    hi[r] = r < a.rows ? rr.hi : 0;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < VPT; ++c) acc[r][c] = 0.f;
  }

  load(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      load(tile + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile have landed

    const int t0 = k_lo + tile * DBK;
    const int t = t0 + kl;
    const bool in_tile = t <= k_hi;
    float part[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) part[r] = 0.f;
    const unsigned char* krow = sK(st) + kl * a.k_stride;
    for (int c = j; c < nck; c += 4) {
      float kf[EPC];
      load_chunk(krow + c * 16, kf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < a.rows) {
          const float4* qr = reinterpret_cast<const float4*>(sQ + r * qld + c * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 qv = qr[e];
            part[r] = fmaf(qv.x, kf[4 * e], part[r]);
            part[r] = fmaf(qv.y, kf[4 * e + 1], part[r]);
            part[r] = fmaf(qv.z, kf[4 * e + 2], part[r]);
            part[r] = fmaf(qv.w, kf[4 * e + 3], part[r]);
          }
        }
      }
    }
    const float kscale = (ksb != nullptr && in_tile) ? ksb[t] : 1.f;
    const float vscale = (vsb != nullptr && in_tile) ? vsb[t] : 1.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < a.rows) {
        float x = part[r];
        x += __shfl_xor_sync(FULL, x, 8);
        x += __shfl_xor_sync(FULL, x, 16);
        if (ksb != nullptr) x *= kscale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const bool ok = in_tile && t >= lo[r] && t <= hi[r];
        const float m_new = fmaxf(m[r], warp_max8(ok ? x : NEG_INF));
        const float alpha = expf(m[r] - m_new);
        const float p = ok ? expf(x - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum8(p);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < VPT; ++c) acc[r][c] *= alpha;
        if (j == 0) sP[(warp * RMAX + r) * DKW + (lane & 7)] = round_to<T>(vsb != nullptr ? p * vscale : p);
      }
    }
    __syncwarp();  // each warp reads back only its own probabilities

    const int nk = min(DKW, k_hi + 1 - (t0 + warp * DKW));
    const unsigned char* vt = sV(st) + warp * DKW * a.v_stride;
    const float* sPw = sP + warp * RMAX * DKW;
    if constexpr (RMAX == 1) {
      // the one-row form's key loop stays rolled: unrolled (the
      // compiler's 4-way unroll), it summed P.V wrongly on an H100 with m
      // and l right, where the same loop rolled is exact
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk)
        pv_key<KV, RMAX, VPT>(reinterpret_cast<const KV*>(vt + kk * a.v_stride), sPw, kk, lane, a.Rv, a.rows, acc);
    } else {
      for (int kk = 0; kk < nk; ++kk)
        pv_key<KV, RMAX, VPT>(reinterpret_cast<const KV*>(vt + kk * a.v_stride), sPw, kk, lane, a.Rv, a.rows, acc);
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  // merge the four warps into this split's partial (the ring is free now)
  float* sM = reinterpret_cast<float*>(ring);  // [DW][RMAX]
  float* sL = sM + DW * RMAX;                   // [DW][RMAX]
  float* sA = sL + DW * RMAX;                   // [DW][RMAX][Rv]
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < a.rows) {
      if (lane == 0) {
        sM[warp * RMAX + r] = m[r];
        sL[warp * RMAX + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < VPT; ++c) {
        const int col = lane + WARP * c;
        if (col < a.Rv) sA[(warp * RMAX + r) * a.Rv + col] = acc[r][c];
      }
    }
  }
  __syncthreads();
  const int64_t part0 = (pair_i * a.nsplit + sp) * a.rows;
  for (int i = tid; i < a.rows * a.Rv; i += blockDim.x) {
    const int r = i / a.Rv, col = i - r * a.Rv;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DW; ++w) M = fmaxf(M, sM[w * RMAX + r]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float e = expf(sM[w * RMAX + r] - M);
      A += e * sA[(w * RMAX + r) * a.Rv + col];
      L += e * sL[w * RMAX + r];
    }
    a.acc[part0 * a.Rv + i] = A;
    if (col == 0) {
      a.ml[(part0 + r) * 2] = M;
      a.ml[(part0 + r) * 2 + 1] = L;
    }
  }
}

// ---- chunk form: one block per (split x 64-row block, kv head, slot) ----

// NV: output n-tiles of 8 columns a thread holds (Rv <= 8 * NV).
template <typename T, typename KV, int NV>
__global__ void __launch_bounds__(CW * WARP) chunk_split(const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int CES = (int)sizeof(T);  // shared tiles hold q's dtype
  constexpr int NS = CBK / 8;          // score n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const int nrb = (a.rows + CBQ - 1) / CBQ;
  const int sp = blockIdx.x / nrb, rb = blockIdx.x - sp * nrb;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int p0 = a.pos[b];
  const Range pair = live_keys(a, p0, 0, a.S - 1);
  const int sk0 = sp * a.split, sk1 = sk0 + a.split - 1;
  if (max(pair.lo, sk0) > min(pair.hi, sk1)) return;  // the combine skips this split

  // this block's rows hold positions pos + [s_lo, s_hi] (all of them once
  // the rows wrap past S): the union of their key ranges, cut to the split
  const int r0 = rb * CBQ;
  const int r_end = min(r0 + CBQ, a.rows);
  int s_lo = 0, s_hi = a.S - 1;
  if (r_end - r0 < a.S && r0 % a.S <= (r_end - 1) % a.S) {
    s_lo = r0 % a.S;
    s_hi = (r_end - 1) % a.S;
  }
  const Range blk = live_keys(a, p0, s_lo, s_hi);
  const int k_lo = max(blk.lo, sk0), k_hi = min(blk.hi, sk1);  // may be empty: empty partials

  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const int G = a.H / a.Hk;
  const int ksteps = (a.Rq * CES + 31) / 32;  // 32-byte k-steps: 8 f32 or 16 bf16 columns
  const int q_cols = ksteps * (32 / CES);
  const uint32_t sQ = smem_u32(smem);
  unsigned char* ring = smem + CBQ * a.q_stride;
  const int stage_bytes = CBK * (a.k_stride + a.v_stride);
  auto sK = [&](int st) { return ring + st * stage_bytes; };
  auto sV = [&](int st) { return ring + st * stage_bytes + CBK * a.k_stride; };

  const int64_t pair_i = (int64_t)b * a.Hk + kvh;
  const int k_row = a.Rq * (int)sizeof(KV), v_row = a.Rv * (int)sizeof(KV);
  const unsigned char* kb = static_cast<const unsigned char*>(a.k) + pair_i * a.T * k_row;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v) + pair_i * a.T * v_row;
  const float* ksb = a.ks != nullptr ? a.ks + pair_i * a.T : nullptr;
  const float* vsb = a.vs != nullptr ? a.vs + pair_i * a.T : nullptr;
  const T* qb = static_cast<const T*>(a.q) + ((int64_t)b * a.H + (int64_t)kvh * G) * a.S * a.Rq;

  // the ring once to zero: pad columns and rows no copy writes must hold
  // finite values (0 * NaN would poison the sums)
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < 2 * stage_bytes / 16; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < CBQ * q_cols; i += blockDim.x) {
    const int r = i / q_cols, c = i - r * q_cols;
    const T x = (r0 + r < a.rows && c < a.Rq) ? qb[(int64_t)(r0 + r) * a.Rq + c] : from_f<T>(0.f);
    *reinterpret_cast<T*>(smem + r * a.q_stride + c * CES) = x;
  }
  __syncthreads();

  const int n_tiles = max(0, (k_hi - k_lo + CBK) / CBK);
  auto load = [&](int tile, int st) {
    const int t0 = k_lo + tile * CBK;
    const int n = min(CBK, k_hi + 1 - t0);
    if constexpr (INT8) {  // codes converted to q's dtype as they are staged
      for (int i = tid; i < n * a.Rq; i += blockDim.x) {
        const int r = i / a.Rq, c = i - r * a.Rq;
        *reinterpret_cast<T*>(sK(st) + r * a.k_stride + c * CES) =
            from_f<T>((float)reinterpret_cast<const int8_t*>(kb)[(int64_t)(t0 + r) * a.Rq + c]);
      }
      for (int i = tid; i < n * a.Rv; i += blockDim.x) {
        const int r = i / a.Rv, c = i - r * a.Rv;
        *reinterpret_cast<T*>(sV(st) + r * a.v_stride + c * CES) =
            from_f<T>((float)reinterpret_cast<const int8_t*>(vb)[(int64_t)(t0 + r) * a.Rv + c]);
      }
    } else {
      stage_raw(sK(st), kb + (int64_t)t0 * k_row, n, k_row, a.k_stride, a.k_copy);
      stage_raw(sV(st), vb + (int64_t)t0 * v_row, n, v_row, a.v_stride, a.v_copy);
    }
    cp_async_commit();
  };

  // this warp's 16 rows: g and g + 8 of them are this lane's
  const int g = lane >> 2, t4 = lane & 3;
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    const int s = row % a.S;
    const Range rr = live_keys(a, p0, s, s);
    lo[h] = row < a.rows ? rr.lo : 1;
    hi[h] = row < a.rows ? rr.hi : 0;
  }
  // the warp's union, to skip tiles none of its rows can see
  int w_lo = min(lo[0], lo[1]), w_hi = max(hi[0], hi[1]);
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(FULL, w_lo, off));
    w_hi = max(w_hi, __shfl_xor_sync(FULL, w_hi, off));
  }

  float o[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const uint32_t q_lane = sQ + (uint32_t)((warp * 16 + g) * a.q_stride + 4 * t4);
  const uint32_t q8 = 8u * a.q_stride;

  if (n_tiles > 0) load(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      load(tile + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int t0 = k_lo + tile * CBK;
    if (t0 <= w_hi && t0 + CBK - 1 >= w_lo) {
      const uint32_t kt = smem_u32(sK(st));
      const uint32_t vt = smem_u32(sV(st));
      float s[NS][4];
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;

      // scores: a = q rows (g, g+8), b = key rows 8jn + g; 32 bytes a k-step
      const uint32_t k_lane = kt + (uint32_t)(g * a.k_stride + 4 * t4);
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint32_t qa = q_lane + 32 * ks;
        uint32_t af[4] = {lds32(qa), lds32(qa + q8), lds32(qa + 16), lds32(qa + q8 + 16)};
        if constexpr (F32) {
          uint32_t a_big[4], a_small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(af[e]), a_big[e], a_small[e]);
#pragma unroll
          for (int jn = 0; jn < NS; ++jn) {
            const uint32_t kaddr = k_lane + (uint32_t)(8 * jn * a.k_stride) + 32 * ks;
            uint32_t b0, b1, b0s, b1s;
            split_tf32(__uint_as_float(lds32(kaddr)), b0, b0s);
            split_tf32(__uint_as_float(lds32(kaddr + 16)), b1, b1s);
            mma_tf32(s[jn], a_small, b0, b1);
            mma_tf32(s[jn], a_big, b0s, b1s);
            mma_tf32(s[jn], a_big, b0, b1);
          }
        } else {
#pragma unroll
          for (int jn = 0; jn < NS; ++jn) {
            const uint32_t kaddr = k_lane + (uint32_t)(8 * jn * a.k_stride) + 32 * ks;
            mma_bf16(s[jn], af, lds32(kaddr), lds32(kaddr + 16));
          }
        }
      }

      // k_scale, softcap and the mask; then the online softmax (rows g, g+8)
      float vsc[NS][2];
#pragma unroll
      for (int jn = 0; jn < NS; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t0 + 8 * jn + 2 * t4 + e;
          const bool in = key <= k_hi;
          const float ksc = (ksb != nullptr && in) ? ksb[key] : 1.f;
          vsc[jn][e] = (vsb != nullptr && in) ? vsb[key] : 1.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = s[jn][2 * h + e];
            if (ksb != nullptr) x *= ksc;
            if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
            const bool ok = in && key >= lo[h] && key <= hi[h];
            s[jn][2 * h + e] = ok ? x : __uint_as_float(MINUS_INF_BITS);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = __uint_as_float(MINUS_INF_BITS);
#pragma unroll
        for (int jn = 0; jn < NS; ++jn) mx = fmaxf(mx, fmaxf(s[jn][2 * h], s[jn][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        const float alpha = exp2f((m_r[h] - m_new) * LOG2E);
        const float ml = m_new * LOG2E;
        float rs = 0.f;
#pragma unroll
        for (int jn = 0; jn < NS; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = exp2f(fmaf(s[jn][2 * h + e], LOG2E, -ml));
            rs += pe;  // l sums the unscaled p
            s[jn][2 * h + e] = vsb != nullptr ? pe * vsc[jn][e] : pe;
          }
        l_r[h] = l_r[h] * alpha + rs;
        m_r[h] = m_new;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          o[n][2 * h] *= alpha;
          o[n][2 * h + 1] *= alpha;
        }
      }

      // P.V: the score accumulator is the A operand
      if constexpr (F32) {
        // keys permuted inside each 8-key step (k t <-> key 2t, t+4 <->
        // 2t+1); v's fragment rows 2*t4 and 2*t4 + 1, column 8n + g
        const uint32_t v_lane = vt + (uint32_t)(2 * t4 * a.v_stride + 4 * g);
#pragma unroll
        for (int jn = 0; jn < NS; ++jn) {
          uint32_t a_big[4], a_small[4];
          split_tf32(s[jn][0], a_big[0], a_small[0]);
          split_tf32(s[jn][2], a_big[1], a_small[1]);
          split_tf32(s[jn][1], a_big[2], a_small[2]);
          split_tf32(s[jn][3], a_big[3], a_small[3]);
          const uint32_t row = v_lane + (uint32_t)(8 * jn * a.v_stride);
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            uint32_t b0, b1, b0s, b1s;
            split_tf32(__uint_as_float(lds32(row + 32 * n)), b0, b0s);
            split_tf32(__uint_as_float(lds32(row + a.v_stride + 32 * n)), b1, b1s);
            mma_tf32(o[n], a_small, b0, b1);
            mma_tf32(o[n], a_big, b0s, b1s);
            mma_tf32(o[n], a_big, b0, b1);
          }
        }
      } else {
        // keys in order; p rounded to bf16 as it is packed
        const uint32_t v_lane = vt + (uint32_t)(2 * t4 * a.v_stride + 2 * g);
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const uint32_t row = v_lane + (uint32_t)(16 * kk * a.v_stride);
          const uint32_t row8 = row + 8u * a.v_stride;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const uint32_t b0 = lds16(row + 16 * n) | (lds16(row + a.v_stride + 16 * n) << 16);
            const uint32_t b1 = lds16(row8 + 16 * n) | (lds16(row8 + a.v_stride + 16 * n) << 16);
            mma_bf16(o[n], af, b0, b1);
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  // this split's partials of rows g and g + 8: the four lanes of a row
  // hold parts of its l
  const int64_t part0 = (pair_i * a.nsplit + sp) * a.rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= a.rows) continue;
    if (t4 == 0) {
      a.ml[(part0 + row) * 2] = m_r[h];
      a.ml[(part0 + row) * 2 + 1] = l;
    }
    float* acc = a.acc + (part0 + row) * a.Rv;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < a.Rv) acc[col] = o[n][2 * h];
      if (col + 1 < a.Rv) acc[col + 1] = o[n][2 * h + 1];
    }
  }
}

// ---- the combine: one warp per (row, kv head, slot) ----

template <typename T>
__global__ void __launch_bounds__(4 * WARP) combine_splits(const Args a) {
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r = blockIdx.x * 4 + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (r >= a.rows) return;
  const int p0 = a.pos[b];
  const Range pair = live_keys(a, p0, 0, a.S - 1);
  int sp0 = 0, sp1 = -1;  // the splits whose blocks ran
  if (pair.lo <= pair.hi) {
    sp0 = pair.lo / a.split;
    sp1 = pair.hi / a.split;
  }
  const int64_t pair_i = (int64_t)b * a.Hk + kvh;
  const int64_t stride = a.rows;  // partials of one row, split to split
  const float* ml = a.ml + (pair_i * a.nsplit * a.rows + r) * 2;
  const float* acc = a.acc + (pair_i * a.nsplit * a.rows + r) * a.Rv;

  float M = NEG_INF;
  for (int sp = sp0 + lane; sp <= sp1; sp += WARP) M = fmaxf(M, ml[sp * stride * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
  float L = 0.f;
  for (int sp = sp0 + lane; sp <= sp1; sp += WARP) L += expf(ml[sp * stride * 2] - M) * ml[sp * stride * 2 + 1];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(FULL, L, off);
  const float denom = fmaxf(L, 1e-30f);

  const int G = a.H / a.Hk;
  T* out = static_cast<T*>(a.o) + (((int64_t)b * a.H + (int64_t)kvh * G) * a.S + r) * a.Rv;
  for (int col = lane; col < a.Rv; col += WARP) {
    float A = 0.f;
    for (int sp = sp0; sp <= sp1; ++sp) A += expf(ml[sp * stride * 2] - M) * acc[sp * stride * a.Rv + col];
    out[col] = from_f<T>(A / denom);
  }
}

// ---- host side ----

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A shared row of `bytes`: whole 128-byte lines plus 16, so that eight
// rows at one 16-byte column (the decode form's chunk loads) and the
// eight rows of an mma fragment (the chunk form's 32-bit loads) fall in
// distinct banks.
int shared_stride(int bytes) { return round_up(bytes, 128) + 16; }

// The widest copy (16, 8, 4, 2 or 1 bytes) dividing a row's byte width
// and the base's alignment.
int copy_width(const void* p, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  int w = 16;
  while (w > 1 && (row_bytes % w != 0 || a % w != 0)) w /= 2;
  return w;
}

// Keys a split: T spread so that `units` blocks per split times the
// splits make about `target` blocks, in whole tiles of `granule` keys.
int split_keys(int T, int64_t units, int granule, int target) {
  const int64_t want = ((int64_t)T * units + target - 1) / target;
  return (int)std::min<int64_t>(round_up(T, granule), std::max<int64_t>(granule, (want + granule - 1) / granule * granule));
}

struct Plan {
  bool decode;
  int rows, split, nsplit;
};

Plan plan(int B, int H, int Hk, int S, int T) {
  Plan p;
  p.rows = (H / Hk) * S;
  p.decode = p.rows <= DEC_ROWS;
  const int64_t pairs = (int64_t)B * Hk;
  p.split = p.decode ? split_keys(T, pairs, DBK, DEC_TARGET)
                     : split_keys(T, pairs * ((p.rows + CBQ - 1) / CBQ), CBK, CH_TARGET);
  p.nsplit = (T + p.split - 1) / p.split;
  return p;
}

template <typename K>
cudaError_t launch_kernel(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t st, const Args& a) {
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV, int RMAX>
cudaError_t launch_decode(const Args& a, int B, cudaStream_t st) {
  constexpr int ES = (int)sizeof(KV), EPC = 16 / ES;
  const int qld = (a.Rq * ES + 15) / 16 * EPC;
  const size_t fixed = sizeof(float) * ((size_t)RMAX * qld + (size_t)DW * RMAX * DKW);
  const size_t ring = 2 * (size_t)DBK * (a.k_stride + a.v_stride);
  const size_t merge = sizeof(float) * (size_t)DW * RMAX * (2 + a.Rv);
  const size_t smem = fixed + std::max(ring, merge);
  const dim3 grid(a.nsplit, a.Hk, B);
  if (a.Rv <= 128) return launch_kernel(decode_split<T, KV, RMAX, 4>, grid, DW * WARP, smem, st, a);
  return launch_kernel(decode_split<T, KV, RMAX, 8>, grid, DW * WARP, smem, st, a);
}

template <typename T, typename KV>
cudaError_t launch(Args a, int B, cudaStream_t st) {
  const Plan p = plan(B, a.H, a.Hk, a.S, a.T);
  a.rows = p.rows;
  a.split = p.split;
  a.nsplit = p.nsplit;
  a.k_copy = copy_width(a.k, a.Rq * (int)sizeof(KV));
  a.v_copy = copy_width(a.v, a.Rv * (int)sizeof(KV));
  cudaError_t err;
  if (p.decode) {
    a.k_stride = shared_stride(a.Rq * (int)sizeof(KV));
    a.v_stride = shared_stride(a.Rv * (int)sizeof(KV));
    if (p.rows == 1) {  // multi-head attention's decode step
      err = launch_decode<T, KV, 1>(a, B, st);
    } else if (p.rows <= 4) {
      err = launch_decode<T, KV, 4>(a, B, st);
    } else {
      err = launch_decode<T, KV, 16>(a, B, st);
    }
  } else {
    constexpr int CES = (int)sizeof(T);
    const int v_cols = a.Rv <= 64 ? 64 : a.Rv <= 128 ? 128 : 256;
    a.q_stride = a.k_stride = shared_stride(round_up(a.Rq * CES, 32));
    a.v_stride = shared_stride(v_cols * CES);
    const size_t smem = (size_t)CBQ * a.q_stride + 2 * (size_t)CBK * (a.k_stride + a.v_stride);
    const dim3 grid((a.rows + CBQ - 1) / CBQ * a.nsplit, a.Hk, B);
    if (v_cols == 64) {
      err = launch_kernel(chunk_split<T, KV, 8>, grid, CW * WARP, smem, st, a);
    } else if (v_cols == 128) {
      err = launch_kernel(chunk_split<T, KV, 16>, grid, CW * WARP, smem, st, a);
    } else {
      err = launch_kernel(chunk_split<T, KV, 32>, grid, CW * WARP, smem, st, a);
    }
  }
  if (err != cudaSuccess) return err;
  combine_splits<T><<<dim3((a.rows + 3) / 4, a.Hk, B), 4 * WARP, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Floats of f32 scratch that modegpt_ragged_gqa_attend needs for these
// shapes (its partials), or 0 for shapes it refuses.
extern "C" long long modegpt_ragged_gqa_workspace(int B, int H, int Hk, int S, int T_len, int Rq, int Rv) {
  if (B < 1 || S < 1 || T_len < 1 || Hk < 1 || H % Hk || Rq < 1 || Rv < 1) return 0;
  const Plan p = plan(B, H, Hk, S, T_len);
  return (long long)B * Hk * p.nsplit * p.rows * (Rv + 2);
}

// C interface, loaded with ctypes. dtype (of q and o): 0 = float32,
// 1 = bfloat16. k/v are q's dtype when k_scale is null, else int8 codes
// with float32 scales k_scale/v_scale [B,Hk,T]. q [B,H,S,Rq], k
// [B,Hk,T,Rq], v [B,Hk,T,Rv], pos [B] int32, o [B,H,S,Rv], all contiguous
// on the current device; workspace holds modegpt_ragged_gqa_workspace()
// floats. window <= 0: full attention; softcap <= 0: none. Two kernels
// are launched on `stream` (the split form, then the combine). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int modegpt_ragged_gqa_attend(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* pos, void* o, void* workspace, int B, int H, int Hk,
                                         int S, int T_len, int Rq, int Rv, int window, float softcap,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Rq < 1 || Rv < 1 || Rq > 256 || Rv > 256 || Hk < 1 || H % Hk) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr) || workspace == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(pos);
  a.o = o;
  a.H = H;
  a.Hk = Hk;
  a.S = S;
  a.T = T_len;
  a.Rq = Rq;
  a.Rv = Rv;
  a.window = window;
  a.softcap = softcap;
  const Plan p = plan(B, H, Hk, S, T_len);
  a.ml = static_cast<float*>(workspace);
  a.acc = a.ml + (int64_t)B * Hk * p.nsplit * p.rows * 2;
  const bool quant = a.ks != nullptr;
  if (dtype == 0 && !quant) return (int)launch<float, float>(a, B, st);
  if (dtype == 0 && quant) return (int)launch<float, int8_t>(a, B, st);
  if (dtype == 1 && !quant) return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, B, st);
  if (dtype == 1 && quant) return (int)launch<__nv_bfloat16, int8_t>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
