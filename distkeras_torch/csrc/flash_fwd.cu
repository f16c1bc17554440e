// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/flash_attention.py ::
// _fwd_kernel (launched from _forward).  Same function: causal / offset
// masking by global position, online softmax with f32 running max,
// denominator and accumulator, o written in the input dtype and the per-row
// logsumexp in f32; fully masked rows give o = 0 and lse = 0.
//
// Design.  One thread block per (batch, head, tile of 64 query rows); four
// threads share a query row, each holding a quarter of the head dim of q
// and of the output accumulator in registers.  The block walks key tiles
// staged in shared memory (K and V tile together at most 32 KB), skips
// tiles wholly in the causal future, and for each tile computes the 64
// (or 32) scores of its row with a 4-lane shuffle reduction, then applies
// the online-softmax update.  p is rounded to the input dtype before the
// p @ V product, as the Pallas kernel does.  Inputs are read in the
// framework's [B, L, H, D] layout through strides (no transpose copy);
// the head dim must be contiguous and every row 16-byte aligned, because
// tiles move, and are read back from shared memory, 16 bytes at a time.
//
// Bound.  At the scoring shape (B 8, H 8, L 640, D 64, causal, bf16) the
// function moves ~21 MB and does ~3.4 GFLOP: memory-bound on an H100.  This
// first kernel uses CUDA-core FMAs, not tensor cores (mma / wgmma), so it
// is compute-limited well above that bound; PERF.md records its time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kLanes = 4;     // threads per query row
constexpr int kThreads = kBQ * kLanes;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T <-> floats (shared- and global-memory rows are 16-byte aligned)
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse,
                 long long qsb, long long qsl, long long qsh,
                 long long ksb, long long ksl, long long ksh,
                 long long vsb, long long vsl, long long vsh,
                 int H, int Lq, int Lk, int causal, int q_offset, int k_offset,
                 float scale) {
  // K and V tiles together stay within 32 KB of static shared memory
  constexpr int BK = (2 * 64 * D * (int)sizeof(T) <= 32768) ? 64 : 32;
  constexpr int DS = D / kLanes;  // head-dim slice held by one thread
  constexpr int V = Vec16<T>::N;
  static_assert(DS % V == 0, "a thread's head-dim slice is whole 16-byte vectors");
  __shared__ __align__(16) T ks[BK][D];
  __shared__ __align__(16) T vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int part = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + row;
  const bool row_valid = qi < Lq;
  const int q_pos = q_offset + qi;

  float qr[DS];
  float acc[DS];
  const T* qrow = q + b * qsb + (long long)min(qi, Lq - 1) * qsl + h * qsh + part * DS;
#pragma unroll
  for (int t = 0; t < DS; ++t) {
    qr[t] = to_f(qrow[t]);
    acc[t] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys past the block's last visible position are never loaded
  int k_end = Lk;
  if (causal) {
    const int last_q_pos = q_offset + min(q0 + kBQ, Lq) - 1;
    k_end = max(0, min(Lk, last_q_pos - k_offset + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    // 16-byte copies: the wrapper guarantees aligned rows (strides are
    // multiples of 16 bytes)
    for (int i = tid; i < BK * (D / V); i += kThreads) {
      const int j = i / (D / V), d = (i % (D / V)) * V;
      const int kj = k0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kj < Lk) {
        kv = *reinterpret_cast<const uint4*>(k + b * ksb + (long long)kj * ksl + h * ksh + d);
        vv = *reinterpret_cast<const uint4*>(v + b * vsb + (long long)kj * vsl + h * vsh + d);
      }
      *reinterpret_cast<uint4*>(&ks[j][d]) = kv;
      *reinterpret_cast<uint4*>(&vs[j][d]) = vv;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DS; c += V) {
        float kf[V];
        Vec16<T>::load(&ks[j][part * DS + c], kf);
#pragma unroll
        for (int t = 0; t < V; ++t) dot += qr[c + t] * kf[t];
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      const bool visible = kj < Lk && (!causal || q_pos >= k_offset + kj);
      s[j] = visible ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {
      const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int t = 0; t < DS; ++t) acc[t] *= corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
        l += p;
        const float pr = to_f(from_f<T>(p));  // p in v's dtype for p @ V
#pragma unroll
        for (int c = 0; c < DS; c += V) {
          float vf[V];
          Vec16<T>::load(&vs[j][part * DS + c], vf);
#pragma unroll
          for (int t = 0; t < V; ++t) acc[c + t] += pr * vf[t];
        }
      }
      m = m_new;
    }
  }

  if (row_valid) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * Lq + qi) * H + h) * D + part * DS;
#pragma unroll
    for (int t = 0; t < DS; ++t) orow[t] = from_f<T>(acc[t] / denom);
    if (part == 0) {
      lse[((long long)b * H + h) * Lq + qi] = (l > 0.f) ? m + logf(denom) : 0.f;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const long long* st, int B, int H, int Lq, int Lk, int causal,
                   int q_offset, int k_offset, float scale, cudaStream_t stream) {
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], H, Lq, Lk, causal, q_offset, k_offset,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* st, int B, int H, int Lq, int Lk,
                       int causal, int q_offset, int k_offset, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" int dk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, long long qsb, long long qsl, long long qsh,
                            long long ksb, long long ksl, long long ksh,
                            long long vsb, long long vsl, long long vsh,
                            int B, int H, int Lq, int Lk, int D, int dtype,
                            int causal, int q_offset, int k_offset, float scale,
                            void* stream) {
  const long long st[9] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(D, q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, st, B, H, Lq, Lk, causal, q_offset, k_offset, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
