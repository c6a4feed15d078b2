// Causal (optionally sliding-window) flash attention for sm_90a.
//
// Replaces the Pallas TPU kernel modegpt_tpu/kernels/flash_attention.py
// (`flash_attention`, body `_attn_kernel`): softmax(q k^T) v per head with
// an online softmax over key tiles, GQA (kv head = q head / group),
// q/k width `hd` and v width `hd_v` independent and not aligned (the
// compressed models carry head dims such as 44, 88 or 90), and a key
// visible iff  q - window < k <= q  (window <= 0: plain causal).
//
// Precision follows the TPU kernel: float32 inputs run in true float32
// (FMA on the CUDA cores, never TF32, which is what HIGHEST means);
// bfloat16 inputs keep f32 scores and accumulators, and the
// probabilities are rounded to bf16 before the P.V product. q is scaled
// in its own dtype before the product, as the JAX wrapper pre-scales it.
// The output is acc / max(l, 1e-30), written in q's dtype.
//
// What bounds it on an H100: at the main path's shape (T=2048, hd=hd_v=128,
// f32) the work is 2*B*H*(T^2/2)*(hd+hd_v) FLOPs over ~100 MB of q/k/v/o,
// about 600 FLOPs per byte, so the bound is the f32 CUDA-core rate
// (67 TFLOP/s), not HBM (3.35 TB/s). In bf16 the bound would be the
// tensor cores, which this first version does not use.
//
// The design, and what it does about that bound: one block of 256
// threads owns one (batch*head, 64-query tile). It walks 64-key tiles
// from the window's first tile (0 without a window) to the causal
// frontier, so masked tiles above the diagonal are never read. Q, the
// current K and V tiles and the probability tile sit in shared memory as
// float32 (rows padded by one word against bank conflicts); each thread
// holds a 4x4 block of scores and a 4 x (hd_v/16) block of the output
// accumulator in registers, so the [T, T] score matrix never leaves the
// SM. Each score element costs one shared load per operand per 4 FMAs;
// the shared-memory load rate, not the FMA rate, is what keeps this
// version below the bound. wgmma, TMA and a cp.async pipeline are left
// to later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int LANES = 16;     // threads sharing one row group
constexpr int RPT = 4;        // query rows per thread (16 * 4 = BQ)
constexpr int KPT = BK / LANES;  // key columns per thread (4)
constexpr int MAX_VPT = 16;   // output columns per thread: 16 * 16 = 256 >= hd_v
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float through T (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float lane_group_max(float x) {
  for (int off = LANES / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lane_group_sum(float x) {
  for (int off = LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H, int Hk,
                       int seq, int hd, int hd_v, float scale, int window) {
  extern __shared__ float smem[];
  const int ldq = hd + 1;
  const int ldv = hd_v + 1;
  const int ldp = BK + 1;
  float* sQ = smem;              // [BQ][ldq]
  float* sK = sQ + BQ * ldq;     // [BK][ldq]
  float* sV = sK + BK * ldq;     // [BK][ldv]
  float* sP = sV + BK * ldv;     // [BQ][ldp]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = b * Hk + (bh % H) / (H / Hk);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / LANES;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid % LANES;  // column lane: key columns tx + LANES*j

  const T* qb = q + (size_t)bh * seq * hd;
  const T* kb = k + (size_t)kvh * seq * hd;
  const T* vb = v + (size_t)kvh * seq * hd_v;
  T* ob = o + (size_t)bh * seq * hd_v;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd;
    const int qi = q0 + r;
    sQ[r * ldq + c] = qi < seq ? round_to<T>(to_f(qb[(size_t)qi * hd + c]) * scale) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][MAX_VPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_VPT; ++c) acc[i][c] = 0.f;
  }

  const int k_end = min(q0 + BQ, seq);  // keys at or past k_end are masked for every row
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_first / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, c = i - r * hd;
      const int kj = k0 + r;
      sK[r * ldq + c] = kj < seq ? to_f(kb[(size_t)kj * hd + c]) : 0.f;
    }
    for (int i = tid; i < BK * hd_v; i += THREADS) {
      const int r = i / hd_v, c = i - r * hd_v;
      const int kj = k0 + r;
      sV[r * ldv + c] = kj < seq ? to_f(vb[(size_t)kj * hd_v + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = sK[(tx + LANES * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + ty * RPT + i;
      bool ok[KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = k0 + tx + LANES * j;
        ok[j] = kj <= qi && kj < seq && (window <= 0 || kj > qi - window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], lane_group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty * RPT + i) * ldp + tx + LANES * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + lane_group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAX_VPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < MAX_VPT; ++c) {
        const int col = tx + LANES * c;
        if (col < hd_v) {
          const float vv = sV[kk * ldv + col];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    if (qi >= seq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < MAX_VPT; ++c) {
      const int col = tx + LANES * c;
      if (col < hd_v) ob[(size_t)qi * hd_v + col] = from_f<T>(acc[i][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk,
                   int seq, int hd, int hd_v, float scale, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (hd + 1) + (size_t)BK * (hd_v + 1) + (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (seq + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hk, seq, hd, hd_v, scale, window);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B,H,T,hd], k [B,Hk,T,hd], v [B,Hk,T,hd_v], o [B,H,T,hd_v], all
// contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int modegpt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Hk, int seq, int hd, int hd_v,
                                       float scale, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
