// Long-context causal (optionally sliding-window) flash attention for
// sm_90a, with K/V streamed through a two-stage cp.async ring.
//
// Replaces the Pallas TPU kernel modegpt_tpu/kernels/flash_attention.py
// (`flash_attention_hbm`, body `_attn_kernel_hbm`), which the forward takes
// for T > 8192: softmax(q k^T) v per head with an online softmax over key
// tiles, GQA (kv head = q head / group), q/k width `hd` and v width `hd_v`
// independent and unaligned (compressed models carry head dims such as 88
// or 90), and a key visible iff  q - window < k <= q  (window <= 0: plain
// causal). It computes what the short-context kernel (flash_attention.cu)
// computes, with the same arithmetic in the same order (with 64-key tiles
// the two agree bit for bit; tests/test_torch_cuda.py checks it):
//
//   * float32 inputs run in true float32 (FMA on the CUDA cores, never
//     TF32); bfloat16 inputs keep f32 scores and accumulators and round the
//     probabilities to bf16 before the P.V product;
//   * q is scaled in its own dtype before the product, as the JAX wrapper
//     pre-scales it; the output is acc / max(l, 1e-30) in q's dtype;
//   * key tiles run from the window's first tile to the causal frontier.
//
// What bounds it on an H100: at the long-context shape (B=1, H=32, Hk=8,
// T=16384, hd=hd_v=128, f32) the work is 2*B*H*(T(T+1)/2)*(hd+hd_v) = 2.2
// TFLOP over ~670 MB of q/k/v/o, about 3,300 FLOPs per byte, against a
// ridge of 20 FLOPs per byte: the bound is the f32 CUDA-core rate (67
// TFLOP/s, ~33 ms), not HBM (3.35 TB/s, ~0.2 ms). What the design does
// about it:
//
//   * Each block keeps one 64-row query tile in shared memory (as f32,
//     scaled) and streams its key/value tiles through a two-stage ring: the
//     copy of tile k+1 (cp.async + commit_group) is issued before tile k is
//     computed, and cp.async.wait_group 1 + __syncthreads() makes tile k
//     visible. The Pallas kernel's 2-slot DMA double buffer maps onto this
//     ring; the short-context kernel stages each tile synchronously.
//   * The inner products read shared memory 16 bytes (four values) at a
//     time: each thread holds a 4 x (BK/16) block of scores and a 4 x (4
//     per 64 columns) block of the output accumulator, so one 16-byte
//     load feeds 16 FMAs (K1's 4-byte loads feed 4). Rows are padded by
//     16 bytes (+4 f32 words), which keeps 16-byte cp.async destinations
//     aligned and makes the 16-byte reads of eight lanes fall in 32
//     distinct banks.
//   * Under the causal mask query tile i walks i+1 key tiles (1 to 256 at
//     T=16384), so the block index is mapped heaviest first: blockIdx.y
//     counts query tiles from the last one, and blockIdx.x (which the
//     hardware advances fastest) runs over batch*heads, so the longest
//     blocks of every head start in the first wave and the light ones fill
//     the tail.
//   * K/V stay in their input dtype in shared memory (bf16 halves the
//     ring). Shared memory is sized per head dim: 64-key tiles (~186 KB at
//     f32, hd = hd_v = 128), or 32-key tiles where that exceeds the 227 KB
//     opt-in (f32 head dims above ~150).
//   * cp.async needs aligned source and destination: the copy width (16, 8
//     or 4 bytes) is picked at launch from each row's byte width and base
//     pointer (a compressed hd_v = 90 row is 360 B in f32, 8-aligned), and
//     bf16 rows of odd width fall back to plain 2-byte copies.
//   * Every q/k/v/o offset is 64-bit: B*H*T*hd passes 2^31 at long context.
//
// Tensor cores (wgmma for bf16, 3xTF32 for f32), TMA and warp
// specialisation are left to later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int LANES = 16;     // threads sharing one row group
constexpr int RPT = 4;        // query rows per thread (16 * 4 = BQ)
constexpr int MAX_C4 = 4;     // 4-column groups per thread: 4 * 4 * 16 = 256 >= hd_v
constexpr int PAD_BYTES = 16; // shared row padding
constexpr int SMEM_LIMIT = 232448;  // the H100's per-block opt-in
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Four consecutive elements from shared memory as floats (16-byte aligned
// for float, 8-byte aligned for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float lane_group_max(float x) {
  for (int off = LANES / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lane_group_sum(float x) {
  for (int off = LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Copy rows [k0, k0 + BK) of a [seq, width] row-major tile source into a
// shared tile with `ld_bytes` bytes per row, `vec` bytes per copy. Rows at
// or past `seq` are left as they are (zeroed at the start, or a previous
// tile's finite values): their probabilities are exactly 0.
template <int BK>
__device__ __forceinline__ void issue_tile(char* dst, const char* src, int64_t k0, int seq,
                                           int row_bytes, int ld_bytes, int vec, int tid) {
  const int per_row = row_bytes / vec;
  const int rows = (int)min((int64_t)BK, (int64_t)seq - k0);
  const char* base = src + k0 * row_bytes;
  for (int i = tid; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    if (vec >= 4) {
      cp_async(dst + r * ld_bytes + c, base + (int64_t)r * row_bytes + c, vec);
    } else {  // bf16 rows of odd width: 2-byte plain copies
      *reinterpret_cast<uint16_t*>(dst + r * ld_bytes + c) =
          *reinterpret_cast<const uint16_t*>(base + (int64_t)r * row_bytes + c);
    }
  }
}

template <typename T, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_hbm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H, int Hk, int seq,
                           int hd, int hd_v, float scale, int window, int vec_k, int vec_v) {
  constexpr int KPT = BK / LANES;  // key columns per thread
  extern __shared__ __align__(16) char smem[];
  const int hd4 = (hd + 3) & ~3;
  const int hdv4 = (hd_v + 3) & ~3;
  const int ldq = hd4 + 4;                                              // f32 words
  const int ldk_b = ((hd * (int)sizeof(T) + 15) & ~15) + PAD_BYTES;     // bytes
  const int ldv_b = ((hd_v * (int)sizeof(T) + 15) & ~15) + PAD_BYTES;   // bytes
  const int ldk = ldk_b / (int)sizeof(T), ldv = ldv_b / (int)sizeof(T);  // elements
  constexpr int ldp = BK + 4;
  float* sQ = reinterpret_cast<float*>(smem);                   // [BQ][ldq]
  char* sK = smem + (size_t)BQ * ldq * sizeof(float);           // 2 x [BK][ldk_b]
  char* sV = sK + 2 * (size_t)BK * ldk_b;                       // 2 x [BK][ldv_b]
  float* sP = reinterpret_cast<float*>(sV + 2 * (size_t)BK * ldv_b);  // [BQ][ldp]

  const int n_qt = gridDim.y;
  const int bh = blockIdx.x;
  const int qt = n_qt - 1 - (int)blockIdx.y;  // heaviest query tiles first
  const int b = bh / H;
  const int64_t kvh = (int64_t)b * Hk + (bh % H) / (H / Hk);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / LANES;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid % LANES;  // column lane

  const T* qb = q + (int64_t)bh * seq * hd;
  const char* kb = reinterpret_cast<const char*>(k + kvh * seq * hd);
  const char* vb = reinterpret_cast<const char*>(v + kvh * seq * hd_v);
  T* ob = o + (int64_t)bh * seq * hd_v;

  // Zero the K/V ring once: pad columns and never-copied rows must hold
  // finite values (0 * NaN would poison the accumulator).
  {
    const int words = (int)((2 * (size_t)BK * (ldk_b + ldv_b)) / 16);
    float4* p = reinterpret_cast<float4*>(sK);
    for (int i = tid; i < words; i += THREADS) p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < BQ * ldq; i += THREADS) {
    const int r = i / ldq, c = i - r * ldq;
    const int qi = q0 + r;
    sQ[i] = (qi < seq && c < hd) ? round_to<T>(to_f(qb[(int64_t)qi * hd + c]) * scale) : 0.f;
  }
  __syncthreads();

  float m[RPT], l[RPT], acc[RPT][MAX_C4][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int k_end = min(q0 + BQ, seq);  // keys at or past k_end are masked for every row
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_first / BK;
  const int t_end = (k_end + BK - 1) / BK;
  const int krow_b = hd * (int)sizeof(T), vrow_b = hd_v * (int)sizeof(T);

  issue_tile<BK>(sK, kb, (int64_t)t_first * BK, seq, krow_b, ldk_b, vec_k, tid);
  issue_tile<BK>(sV, vb, (int64_t)t_first * BK, seq, vrow_b, ldv_b, vec_v, tid);
  cp_async_commit();

  for (int t = t_first; t < t_end; ++t) {
    const int slot = (t - t_first) & 1;
    if (t + 1 < t_end) {  // the other slot was released by the last iteration's final barrier
      const int64_t kn = (int64_t)(t + 1) * BK;
      issue_tile<BK>(sK + (slot ^ 1) * BK * ldk_b, kb, kn, seq, krow_b, ldk_b, vec_k, tid);
      issue_tile<BK>(sV + (slot ^ 1) * BK * ldv_b, vb, kn, seq, vrow_b, ldv_b, vec_v, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();  // tile t has landed (for this thread's copies)
    __syncthreads();      // ... and for every thread's

    const T* tK = reinterpret_cast<const T*>(sK + slot * BK * ldk_b);
    const T* tV = reinterpret_cast<const T*>(sV + slot * BK * ldv_b);
    const int k0 = t * BK;

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = load4(sQ + (ty * RPT + i) * ldq + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = load4(tK + (tx + LANES * j) * ldk + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
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
      for (int c = 0; c < MAX_C4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = load4(sP + (ty * RPT + i) * ldp + kk);
#pragma unroll
      for (int c = 0; c < MAX_C4; ++c) {
        const int col = 4 * tx + 4 * LANES * c;
        if (col < hdv4) {
          const float4 v0 = load4(tV + (kk + 0) * ldv + col);
          const float4 v1 = load4(tV + (kk + 1) * ldv + col);
          const float4 v2 = load4(tV + (kk + 2) * ldv + col);
          const float4 v3 = load4(tV + (kk + 3) * ldv + col);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {  // key order kk, kk+1, kk+2, kk+3 per column
            acc[i][c][0] = fmaf(pv[i].x, v0.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i].x, v0.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i].x, v0.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i].x, v0.w, acc[i][c][3]);
            acc[i][c][0] = fmaf(pv[i].y, v1.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i].y, v1.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i].y, v1.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i].y, v1.w, acc[i][c][3]);
            acc[i][c][0] = fmaf(pv[i].z, v2.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i].z, v2.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i].z, v2.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i].z, v2.w, acc[i][c][3]);
            acc[i][c][0] = fmaf(pv[i].w, v3.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i].w, v3.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i].w, v3.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i].w, v3.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();  // this tile's slot and sP are free for the next iteration
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    if (qi >= seq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < MAX_C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 4 * LANES * c + e;
        if (col < hd_v) ob[(int64_t)qi * hd_v + col] = from_f<T>(acc[i][c][e] * inv);
      }
  }
}

template <typename T>
size_t smem_bytes(int bk, int hd, int hd_v) {
  const size_t ldq = ((hd + 3) & ~3) + 4;
  const size_t ldk_b = ((hd * sizeof(T) + 15) & ~(size_t)15) + PAD_BYTES;
  const size_t ldv_b = ((hd_v * sizeof(T) + 15) & ~(size_t)15) + PAD_BYTES;
  return sizeof(float) * BQ * ldq + 2 * (size_t)bk * (ldk_b + ldv_b) + sizeof(float) * BQ * (bk + 4);
}

// The widest cp.async (16, 8 or 4 bytes) that divides a row's byte width
// and the base pointer's alignment; 2 for bf16 rows of odd width.
int copy_width(const void* p, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int w = 16; w >= 4; w /= 2)
    if (row_bytes % w == 0 && a % w == 0) return w;
  return 2;
}

template <typename T, int BK>
cudaError_t launch_bk(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk,
                      int seq, int hd, int hd_v, float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(BK, hd, hd_v);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_hbm_kernel<T, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_k = copy_width(k, hd * (int)sizeof(T));
  const int vec_v = copy_width(v, hd_v * (int)sizeof(T));
  const dim3 grid(B * H, (seq + BQ - 1) / BQ);
  flash_attention_hbm_kernel<T, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hk, seq, hd, hd_v, scale, window, vec_k, vec_v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk,
                   int seq, int hd, int hd_v, float scale, int window, cudaStream_t stream) {
  if (smem_bytes<T>(64, hd, hd_v) <= (size_t)SMEM_LIMIT)
    return launch_bk<T, 64>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, stream);
  if (smem_bytes<T>(32, hd, hd_v) <= (size_t)SMEM_LIMIT)
    return launch_bk<T, 32>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B,H,T,hd], k [B,Hk,T,hd], v [B,Hk,T,hd_v], o [B,H,T,hd_v], all
// contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int modegpt_flash_attention_hbm(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int Hk, int seq, int hd, int hd_v,
                                           float scale, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, seq, hd, hd_v, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
