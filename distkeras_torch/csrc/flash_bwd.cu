// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU backward kernels of
// distkeras_tpu/ops/flash_attention.py:
//   dk_flash_bwd_fused -> _bwd_fused_kernel (launched by _fused_backward_call)
//   dk_flash_bwd_dq    -> _bwd_dq_kernel    (the split tier, launched by _backward)
//   dk_flash_bwd_dkv   -> _bwd_dkv_kernel   (the split tier, launched by _backward)
// All three rebuild the same [q row, key] terms as _recompute_p_ds, in one
// device function: s = (q . k) * scale from input-dtype operands with f32
// accumulation, p = exp(s - lse) (masked entries exactly 0), dp = dO . v,
// ds = p * (dp - delta), where delta = rowsum(dO * O) - dlse comes from the
// wrapper.  Rounding points follow the Pallas code: dV takes p rounded to
// dO's dtype, dK takes ds rounded to q's dtype, dQ takes ds rounded to q's
// dtype (fused) or k's dtype (split); the kernels take one dtype for all
// four, so the rounding is the same in both tiers.  dq and dk are scaled by
// `scale` at the end.
//
// Design.  A row of the block's own tile is shared by D/16 threads, each
// holding 16 elements of it in registers (16-byte vectors interleaved over
// the lanes, so a row read from shared memory is conflict-free).  The dot
// products reduce over those lanes with warp shuffles.
// - dkv / fused: one block per (batch, head, tile of 64 key rows), holding
//   k, v and the f32 dK, dV accumulators of its rows.  It streams 64-row
//   tiles of q and dO (with their lse and delta) through shared memory and
//   skips the q rows that see none of its keys (the causal counterpart of
//   _block_visible).  The fused kernel also writes the rounded ds of each
//   q tile to shared memory and adds ds . K for that tile into an f32 dQ
//   workspace [B, Lq, H, D] with atomicAdd: the GPU form of the Pallas
//   kernel's [Lq, D] scratch.  The wrapper scales and casts it.  The order
//   of the atomic adds varies from run to run, so dQ of the fused tier is
//   not bitwise reproducible; the split tier is.
// - dq: one block per (batch, head, tile of 64 q rows), holding q, dO and
//   the f32 dQ accumulator, streaming 64-row tiles of k and v, stopping at
//   the last key any of its rows can see.
// Inputs are read in the framework's [B, L, H, D] layout through strides;
// the head dim must be contiguous and every row 16-byte aligned.  Outputs
// are contiguous [B, L, H, D].  Shared memory is dynamic (up to 114 KB for
// the fused kernel at D = 128 in float32), so each launch first raises the
// kernel's limit with cudaFuncSetAttribute.
//
// Bound.  At the training shape (B 8, L 2048, H 4, D 128, bf16, causal) the
// fused backward does 10 * D flops per visible score (~86 GFLOP) and moves
// ~118 MB: operations-bound on the tensor cores (~0.087 ms).  These first
// kernels use CUDA-core FMAs, not mma / wgmma, so they sit far above that
// bound; PERF.md records their times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kRows = 64;  // rows a block owns: keys (dkv, fused) or queries (dq)
constexpr int kTile = 64;  // rows of each tile streamed through shared memory
constexpr int kSlice = 16; // head-dim elements one thread holds of a row

template <int D> struct Layout {
  static constexpr int kLanes = D / kSlice;  // threads sharing one row
  static constexpr int kThreads = kRows * kLanes;
};

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
// x rounded to T and read back: the Pallas kernel's `.astype(dtype)`
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16 bytes of T <-> floats (rows are 16-byte aligned)
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  }
  __device__ __forceinline__ static void store(T* p, const float* in) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// first element of the c-th 16-byte vector a lane holds of a row
template <typename T, int D>
__device__ __forceinline__ int vec_col(int c, int part) {
  return (c * Layout<D>::kLanes + part) * Vec16<T>::N;
}

template <int LANES> __device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a lane's 16 elements of row `r` of a [rows, D] tile (global or shared)
template <typename T, int D>
__device__ __forceinline__ void load_slice(const T* r, int part, float* out) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int c = 0; c < kSlice / V; ++c) Vec16<T>::load(r + vec_col<T, D>(c, part), out + c * V);
}

template <typename T, int D>
__device__ __forceinline__ void store_slice(T* r, int part, const float* in) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int c = 0; c < kSlice / V; ++c) Vec16<T>::store(r + vec_col<T, D>(c, part), in + c * V);
}

// The shared recompute (_recompute_p_ds): for one (q row, key) pair whose
// q-side row is `a_row` and key-side slices are held by the lanes, the two
// lane-reduced dot products.  `a` and `g` are the q and dO rows (dkv /
// fused) or the k and v rows (dq); `x`, `y` the lane's register slices of
// the other side.
template <typename T, int D>
__device__ __forceinline__ void dots(const T* a, const T* g, const float* x,
                                     const float* y, int part, float& s, float& dp) {
  constexpr int V = Vec16<T>::N;
  s = 0.f;
  dp = 0.f;
#pragma unroll
  for (int c = 0; c < kSlice / V; ++c) {
    float af[V], gf[V];
    Vec16<T>::load(a + vec_col<T, D>(c, part), af);
    Vec16<T>::load(g + vec_col<T, D>(c, part), gf);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      s += af[t] * x[c * V + t];
      dp += gf[t] * y[c * V + t];
    }
  }
  s = lane_sum<Layout<D>::kLanes>(s);
  dp = lane_sum<Layout<D>::kLanes>(dp);
}

// p and ds for one pair: p = exp(s * scale - lse) where visible, else 0
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float delta,
                                     bool visible, float scale, float& p, float& ds) {
  p = visible ? expf(s * scale - lse) : 0.f;
  ds = p * (dp - delta);
}

// a lane's slice of y += w * row
template <typename T, int D>
__device__ __forceinline__ void axpy(const T* row, float w, int part, float* y) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int c = 0; c < kSlice / V; ++c) {
    float f[V];
    Vec16<T>::load(row + vec_col<T, D>(c, part), f);
#pragma unroll
    for (int t = 0; t < V; ++t) y[c * V + t] += w * f[t];
  }
}

struct Strides {  // in elements: batch, row and head stride of q, k, v, dO
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, ob, ol, oh;
};

// copy rows [r0, r0 + n) of a strided [B, L, H, D] tensor into a [kTile, D]
// shared tile, zero-filling the rest
template <typename T, int D, int THREADS>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs, int r0, int n,
                                      int tid) {
  constexpr int V = Vec16<T>::N;
  for (int idx = tid; idx < kTile * (D / V); idx += THREADS) {
    const int i = idx / (D / V), d = (idx % (D / V)) * V;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (i < n) x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + i) * rs + d);
    *reinterpret_cast<uint4*>(dst + i * D + d) = x;
  }
}

template <typename T, int D, bool FUSED>
size_t kv_smem_bytes() {
  size_t n = 2 * kTile * D * sizeof(T) + 2 * kTile * sizeof(float);
  if (FUSED) n += kRows * D * sizeof(T) + kTile * (kRows + 1) * sizeof(float);
  return n;
}

// dK and dV (and, FUSED, the dQ partial sums) for one tile of key rows:
// the body of the fused and the dkv kernel
template <typename T, int D, bool FUSED>
__device__ __forceinline__ void kv_tile(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        float* __restrict__ dq_acc, T* __restrict__ dk,
                                        T* __restrict__ dv, const Strides& st, int H, int Lq,
                                        int Lk, int causal, int q_offset, int k_offset,
                                        float scale) {
  constexpr int LANES = Layout<D>::kLanes;
  constexpr int THREADS = Layout<D>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                         // [kTile][D]
  T* dos = qs + kTile * D;                                    // [kTile][D]
  float* lse_s = reinterpret_cast<float*>(dos + kTile * D);  // [kTile]
  float* delta_s = lse_s + kTile;                             // [kTile]
  T* ks = reinterpret_cast<T*>(delta_s + kTile);              // FUSED: [kRows][D]
  float* ds_s = reinterpret_cast<float*>(ks + kRows * D);     // FUSED: [kTile][kRows + 1]

  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int part = tid % LANES;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kj = k0 + row;
  const bool row_valid = kj < Lk;
  const int k_pos = k_offset + kj;

  float kr[kSlice], vr[kSlice], dkr[kSlice], dvr[kSlice];
  {
    const long long kc = min(kj, Lk - 1);
    load_slice<T, D>(k + b * st.kb + kc * st.kl + h * st.kh, part, kr);
    load_slice<T, D>(v + b * st.vb + kc * st.vl + h * st.vh, part, vr);
#pragma unroll
    for (int t = 0; t < kSlice; ++t) {
      if (!row_valid) kr[t] = vr[t] = 0.f;
      dkr[t] = 0.f;
      dvr[t] = 0.f;
    }
    if constexpr (FUSED) store_slice<T, D>(ks + row * D, part, kr);  // exact: kr came from T
  }

  // q rows before the first one that sees key k0 contribute nothing
  int q_begin = 0;
  if (causal) q_begin = max(0, min(Lq, k_offset + k0 - q_offset));
  const long long stat0 = ((long long)b * H + h) * Lq;

  for (int q0 = q_begin; q0 < Lq; q0 += kTile) {
    const int nq = min(kTile, Lq - q0);
    __syncthreads();  // previous tile fully consumed
    stage<T, D, THREADS>(qs, q + b * st.qb + h * st.qh, st.ql, q0, nq, tid);
    stage<T, D, THREADS>(dos, dout + b * st.ob + h * st.oh, st.ol, q0, nq, tid);
    for (int i = tid; i < kTile; i += THREADS) {
      lse_s[i] = i < nq ? lse[stat0 + q0 + i] : 0.f;
      delta_s[i] = i < nq ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < nq; ++i) {
      float s, dp, p, ds;
      dots<T, D>(qs + i * D, dos + i * D, kr, vr, part, s, dp);
      const bool visible = row_valid && (!causal || q_offset + q0 + i >= k_pos);
      p_ds(s, dp, lse_s[i], delta_s[i], visible, scale, p, ds);
      const float dsr = round_to<T>(ds);
      axpy<T, D>(dos + i * D, round_to<T>(p), part, dvr);
      axpy<T, D>(qs + i * D, dsr, part, dkr);
      if constexpr (FUSED) {
        if (part == 0) ds_s[i * (kRows + 1) + row] = dsr;
      }
    }

    if constexpr (FUSED) {
      __syncthreads();
      // dQ[q0 + i, d] += sum_j ds[i, j] * K[j, d] over this block's keys
      for (int idx = tid; idx < nq * D; idx += THREADS) {
        const int i = idx / D, d = idx % D;
        const float* dsrow = ds_s + i * (kRows + 1);
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < kRows; ++j) acc += dsrow[j] * to_f(ks[j * D + d]);
        atomicAdd(dq_acc + (((long long)b * Lq + q0 + i) * H + h) * D + d, acc);
      }
    }
  }

  if (row_valid) {
    const long long base = (((long long)b * Lk + kj) * H + h) * D;
#pragma unroll
    for (int t = 0; t < kSlice; ++t) dkr[t] *= scale;
    store_slice<T, D>(dk + base, part, dkr);
    store_slice<T, D>(dv + base, part, dvr);
  }
}

#define DK_KV_PARAMS                                                                   \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,           \
      const T *__restrict__ dout, const float *__restrict__ lse,                        \
      const float *__restrict__ delta, float *__restrict__ dq_acc, T *__restrict__ dk,  \
      T *__restrict__ dv, Strides st, int H, int Lq, int Lk, int causal, int q_offset,  \
      int k_offset, float scale
#define DK_KV_ARGS q, k, v, dout, lse, delta, dq_acc, dk, dv, st, H, Lq, Lk, causal, \
                   q_offset, k_offset, scale

// B2: dK, dV and the atomic dQ partial sums
template <typename T, int D>
__global__ void __launch_bounds__(Layout<D>::kThreads) flash_bwd_fused_kernel(DK_KV_PARAMS) {
  kv_tile<T, D, true>(DK_KV_ARGS);
}

// B3b: dK and dV only (the split tier's second kernel)
template <typename T, int D>
__global__ void __launch_bounds__(Layout<D>::kThreads) flash_bwd_dkv_kernel(DK_KV_PARAMS) {
  kv_tile<T, D, false>(DK_KV_ARGS);
}

// B3a: dQ for one tile of q rows (the split tier's first kernel)
template <typename T, int D>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Strides st, int H, int Lq, int Lk, int causal,
                    int q_offset, int k_offset, float scale) {
  constexpr int LANES = Layout<D>::kLanes;
  constexpr int THREADS = Layout<D>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [kTile][D]
  T* vs = ks + kTile * D;              // [kTile][D]

  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int part = tid % LANES;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi = q0 + row;
  const bool row_valid = qi < Lq;
  const int q_pos = q_offset + qi;

  float qr[kSlice], gr[kSlice], dqr[kSlice];
  const long long qc = min(qi, Lq - 1);
  load_slice<T, D>(q + b * st.qb + qc * st.ql + h * st.qh, part, qr);
  load_slice<T, D>(dout + b * st.ob + qc * st.ol + h * st.oh, part, gr);
#pragma unroll
  for (int t = 0; t < kSlice; ++t) dqr[t] = 0.f;
  const long long stat = ((long long)b * H + h) * Lq + qc;
  const float lse_i = lse[stat];
  const float delta_i = delta[stat];

  // keys past the block's last visible position are never loaded
  int k_end = Lk;
  if (causal) {
    const int last_q_pos = q_offset + min(q0 + kRows, Lq) - 1;
    k_end = max(0, min(Lk, last_q_pos - k_offset + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, k_end - k0);
    __syncthreads();  // previous tile fully consumed
    stage<T, D, THREADS>(ks, k + b * st.kb + h * st.kh, st.kl, k0, nk, tid);
    stage<T, D, THREADS>(vs, v + b * st.vb + h * st.vh, st.vl, k0, nk, tid);
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float s, dp, p, ds;
      dots<T, D>(ks + j * D, vs + j * D, qr, gr, part, s, dp);
      const bool visible = row_valid && (!causal || q_pos >= k_offset + k0 + j);
      p_ds(s, dp, lse_i, delta_i, visible, scale, p, ds);
      axpy<T, D>(ks + j * D, round_to<T>(ds), part, dqr);
    }
  }

  if (row_valid) {
#pragma unroll
    for (int t = 0; t < kSlice; ++t) dqr[t] *= scale;
    store_slice<T, D>(dq + (((long long)b * Lq + qi) * H + h) * D, part, dqr);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  Strides st;
  int B, H, Lq, Lk, causal, q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

enum Which { kFused = 0, kDkv = 1, kDq = 2 };

template <typename T, int D, bool FUSED>
cudaError_t launch_kv(const Args& a) {
  auto kernel = FUSED ? flash_bwd_fused_kernel<T, D> : flash_bwd_dkv_kernel<T, D>;
  const size_t smem = kv_smem_bytes<T, D, FUSED>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lk + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, Layout<D>::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.st, a.H, a.Lq, a.Lk, a.causal, a.q_offset, a.k_offset,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = 2 * kTile * D * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kRows - 1) / kRows, a.H, a.B);
  kernel<<<grid, Layout<D>::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.st, a.H, a.Lq, a.Lk,
      a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  switch (which) {
    case kFused: return launch_kv<T, D, true>(a);
    case kDkv: return launch_kv<T, D, false>(a);
    case kDq: return launch_dq<T, D>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int D, Which which, const Args& a) {
  switch (D) {
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        const long long* s, int B, int H, int Lq, int Lk, int D, int dtype, int causal,
        int q_offset, int k_offset, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]},
               B, H, Lq, Lk, causal, q_offset, k_offset, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(D, which, a);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, which, a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The three entry points share one argument list.  dtype: 0 = float32,
// 1 = bfloat16.  Strides are in elements, (batch, row, head) for q, k, v and
// dO in that order.  dq is the f32 workspace (fused, zeroed by the caller)
// or the output (dq); the fused and dkv kernels write dk and dv.
#define DK_FLASH_BWD_ENTRY(NAME, WHICH)                                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* dout,      \
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,   \
                      long long qsb, long long qsl, long long qsh, long long ksb,          \
                      long long ksl, long long ksh, long long vsb, long long vsl,         \
                      long long vsh, long long osb, long long osl, long long osh, int B,  \
                      int H, int Lq, int Lk, int D, int dtype, int causal, int q_offset,  \
                      int k_offset, float scale, void* stream) {                          \
    const long long s[12] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh}; \
    return run(WHICH, q, k, v, dout, lse, delta, dq, dk, dv, s, B, H, Lq, Lk, D, dtype,   \
               causal, q_offset, k_offset, scale, stream);                                \
  }

DK_FLASH_BWD_ENTRY(dk_flash_bwd_fused, kFused)
DK_FLASH_BWD_ENTRY(dk_flash_bwd_dkv, kDkv)
DK_FLASH_BWD_ENTRY(dk_flash_bwd_dq, kDq)
