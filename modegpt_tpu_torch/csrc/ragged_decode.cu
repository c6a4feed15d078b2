// Ragged GQA attention over a slot-table KV pool, for sm_90a.
//
// Replaces the Pallas TPU kernel modegpt_tpu/kernels/ragged_decode.py
// (`ragged_gqa_attend`, body `_kernel`; `ragged_gqa_decode` is its S=1
// form). Slot b's query s sits at position pos[b]+s and attends keys t in
// [lo(s), pos[b]+s] with lo(s) = max(0, pos[b]+s+1-window) (0 without a
// window), t < T. q is pre-scaled. The cache pool is either q's dtype or
// int8 codes with per-(slot, head, position) float32 scales: k_scale
// multiplies the score columns before softcap and masking, v_scale the
// probability rows AFTER the normaliser l has summed the unscaled p.
// Softcap is cap*tanh(s/cap). float32 runs in true float32 (FMA, never
// TF32); bfloat16 keeps f32 scores and accumulators and rounds p to bf16
// before the P.V product. The output is acc / max(l, 1e-30) in q's dtype;
// keys at or past the pool's end are never read, and a row with no live
// key (a windowed row wholly past the end) is zero.
//
// What bounds it on an H100: at serving decode (S=1, 8 slots, 32 heads
// over 8 kv heads, ranks ~128) each query row does ~2*(Rq+Rv) FLOPs per
// live key while the live K/V rows are read once from device memory:
// about G/2 FLOP per byte in f32, far below the card's ~20 FLOP/byte f32
// ridge. The bound is the device-memory bytes of each slot's live K/V
// rows (3.35 TB/s); a prefill chunk (S=128) carries G*S rows per key and
// is bound by the f32 FMA rate instead.
//
// The design, and what it does about that bound: one block owns one
// (slot, kv head, tile of query rows), where the G*S rows of a kv head
// are its query heads times its positions (row = g*S + s, contiguous in
// q's [B, H, S, R] layout), so each K/V tile is read once per kv head,
// never repeated per query head. The block walks only the slot's live
// key tiles, from the window's first tile to the last row's position
// (clamped to the pool), so decode reads each slot's live rows and no
// more. K/V tiles of 64 keys are staged in shared memory as float32
// (rows padded to an odd stride against bank conflicts); each warp owns
// RPT query rows, each lane two keys of the tile for the scores and
// eight output columns for the accumulator, and the online softmax
// (m, l) is reduced with warp shuffles. Decode (G*S <= 16 rows) uses
// 4 warps x 1 row; prefill chunks 8 warps x 4 rows. Split-K over long
// caches, cp.async/TMA staging and tensor cores for bf16 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int KPT = 2;             // keys per lane in a tile
constexpr int BK = WARP * KPT;     // keys per tile (64)
constexpr int VPT = 256 / WARP;    // output columns per lane: 8 * 32 = 256 >= Rv
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = WARP / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = WARP / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

// T: q / output dtype; KV: cache dtype (T, or int8_t with scales).
// NW warps per block, RPT query rows per warp.
template <typename T, typename KV, int NW, int RPT>
__global__ void __launch_bounds__(NW * WARP)
ragged_attend_kernel(const T* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
                     const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                     const int* __restrict__ pos, T* __restrict__ o, int H, int Hk, int S,
                     int T_len, int Rq, int Rv, int window, float softcap) {
  constexpr int BQ = NW * RPT;
  constexpr int THREADS = NW * WARP;
  extern __shared__ float smem[];
  const int ldq = odd_stride(Rq);
  const int ldv = odd_stride(Rv);
  float* sQ = smem;             // [BQ][ldq]
  float* sK = sQ + BQ * ldq;    // [BK][ldq]
  float* sV = sK + BK * ldq;    // [BK][ldv]
  float* sP = sV + BK * ldv;    // [BQ][BK]
  float* sKs = sP + BQ * BK;    // [BK]
  float* sVs = sKs + BK;        // [BK]

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * BQ;
  const int G = H / Hk;
  const int rows = G * S;
  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const int lane = tid % WARP;
  const int p0 = pos[b];
  const bool quantized = k_scale != nullptr;

  // this kv head's G*S query rows are contiguous in q and o
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  const T* qb = q + head0 * S * Rq;
  T* ob = o + head0 * S * Rv;
  const size_t kv_head = (size_t)b * Hk + kvh;
  const KV* kb = k + kv_head * T_len * Rq;
  const KV* vb = v + kv_head * T_len * Rv;
  const float* ksb = quantized ? k_scale + kv_head * T_len : nullptr;
  const float* vsb = quantized ? v_scale + kv_head * T_len : nullptr;

  // staging loops: warp w copies rows w, w+NW, ...; lanes walk the columns
  for (int r = warp; r < BQ; r += NW)
    for (int c = lane; c < Rq; c += WARP)
      sQ[r * ldq + c] = r0 + r < rows ? to_f(qb[(size_t)(r0 + r) * Rq + c]) : 0.f;

  // positions spanned by this tile's rows -> the union of their key ranges
  const int r_end = min(r0 + BQ, rows);
  int s_lo = S, s_hi = -1;
  if (r_end - r0 >= S) {
    s_lo = 0;
    s_hi = S - 1;
  } else {
    for (int r = r0; r < r_end; ++r) {
      s_lo = min(s_lo, r % S);
      s_hi = max(s_hi, r % S);
    }
  }
  const int t_first = window > 0 ? max(0, p0 + s_lo + 1 - window) : 0;
  const int t_last = min(p0 + s_hi, T_len - 1);

  int limit[RPT], lo[RPT];
  bool valid[RPT];
  float m[RPT], l[RPT], acc[RPT][VPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + warp * RPT + i;
    valid[i] = r < rows;
    limit[i] = p0 + (valid[i] ? r % S : 0);
    lo[i] = window > 0 ? max(0, limit[i] + 1 - window) : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (t_first / BK) * BK; k0 <= t_last; k0 += BK) {
    __syncthreads();  // the previous tile's sK / sV reads are done
    for (int r = warp; r < BK; r += NW) {
      const bool in_pool = k0 + r < T_len;
      const size_t t = (size_t)(k0 + r);
      for (int c = lane; c < Rq; c += WARP) sK[r * ldq + c] = in_pool ? to_f(kb[t * Rq + c]) : 0.f;
      for (int c = lane; c < Rv; c += WARP) sV[r * ldv + c] = in_pool ? to_f(vb[t * Rv + c]) : 0.f;
    }
    if (quantized) {
      for (int i = tid; i < BK; i += THREADS) {
        sKs[i] = k0 + i < T_len ? ksb[k0 + i] : 0.f;
        sVs[i] = k0 + i < T_len ? vsb[k0 + i] : 0.f;
      }
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Rq; ++d) {
      float kv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = sK[(lane + WARP * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = sQ[(warp * RPT + i) * ldq + d];
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bool ok[KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = lane + WARP * j;
        const int t = k0 + kk;
        float x = s[i][j];
        if (quantized) x *= sKs[kk];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = x;
        ok[j] = valid[i] && t <= limit[i] && t >= lo[i] && t < T_len;
        if (ok[j]) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = lane + WARP * j;
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(warp * RPT + i) * BK + kk] = round_to<T>(quantized ? p * sVs[kk] : p);
      }
      l[i] = l[i] * alpha + warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < VPT; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // each warp reads back only its own rows of sP

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(warp * RPT + i) * BK + kk];
#pragma unroll
      for (int c = 0; c < VPT; ++c) {
        const int col = lane + WARP * c;
        if (col < Rv) {
          const float vv = sV[kk * ldv + col];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!valid[i]) continue;
    const int r = r0 + warp * RPT + i;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      const int col = lane + WARP * c;
      if (col < Rv) ob[(size_t)r * Rv + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, typename KV, int NW, int RPT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   const int* pos, void* o, int B, int H, int Hk, int S, int T_len, int Rq, int Rv,
                   int window, float softcap, cudaStream_t stream) {
  constexpr int BQ = NW * RPT;
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * odd_stride(Rq) +
                                       (size_t)BK * odd_stride(Rv) + (size_t)BQ * BK + 2 * BK);
  cudaError_t err = cudaFuncSetAttribute(ragged_attend_kernel<T, KV, NW, RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = (H / Hk) * S;
  const dim3 grid((rows + BQ - 1) / BQ, Hk, B);
  ragged_attend_kernel<T, KV, NW, RPT><<<grid, NW * WARP, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, pos,
      static_cast<T*>(o), H, Hk, S, T_len, Rq, Rv, window, softcap);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, const int* pos, void* o, int B, int H, int Hk, int S,
                          int T_len, int Rq, int Rv, int window, float softcap, cudaStream_t st) {
  if ((H / Hk) * S <= 16)  // decode: one row per warp
    return launch<T, KV, 4, 1>(q, k, v, ks, vs, pos, o, B, H, Hk, S, T_len, Rq, Rv, window,
                               softcap, st);
  return launch<T, KV, 8, 4>(q, k, v, ks, vs, pos, o, B, H, Hk, S, T_len, Rq, Rv, window, softcap,
                             st);
}

}  // namespace

// C interface, loaded with ctypes. dtype (of q and o): 0 = float32,
// 1 = bfloat16. k/v are q's dtype when k_scale is null, else int8 codes
// with float32 scales k_scale/v_scale [B,Hk,T]. q [B,H,S,Rq], k
// [B,Hk,T,Rq], v [B,Hk,T,Rv], pos [B] int32, o [B,H,S,Rv], all contiguous
// on the current device. window <= 0: full attention; softcap <= 0: none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int modegpt_ragged_gqa_attend(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* pos, void* o, int B, int H, int Hk, int S,
                                         int T_len, int Rq, int Rv, int window, float softcap,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* p = static_cast<const int*>(pos);
  if (Rq < 1 || Rv < 1 || Rq > 256 || Rv > 256 || Hk < 1 || H % Hk) return (int)cudaErrorInvalidValue;
  if ((ks == nullptr) != (vs == nullptr)) return (int)cudaErrorInvalidValue;
  const bool quant = ks != nullptr;
  if (dtype == 0 && !quant)
    return (int)dispatch_rows<float, float>(q, k, v, ks, vs, p, o, B, H, Hk, S, T_len, Rq, Rv,
                                            window, softcap, st);
  if (dtype == 0 && quant)
    return (int)dispatch_rows<float, int8_t>(q, k, v, ks, vs, p, o, B, H, Hk, S, T_len, Rq, Rv,
                                             window, softcap, st);
  if (dtype == 1 && !quant)
    return (int)dispatch_rows<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, p, o, B, H, Hk, S,
                                                            T_len, Rq, Rv, window, softcap, st);
  if (dtype == 1 && quant)
    return (int)dispatch_rows<__nv_bfloat16, int8_t>(q, k, v, ks, vs, p, o, B, H, Hk, S, T_len,
                                                     Rq, Rv, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
