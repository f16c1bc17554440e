// Fused single-token decode step for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/decode_step.py ::
// _decode_kernel (launched from _fused_call): one decode token through all
// L transformer blocks,
//   LN0 -> qkv -> attention over the cache (positions <= pos) -> proj +
//   residual -> LN1 -> up -> gelu(tanh) -> down + residual,
// returning the hidden state before the final norm.
//
// Design: one persistent cooperative launch per token (one block per SM)
// that walks the L layers.  The TPU kernel carries the hidden state across a
// sequential grid over layers; Hopper blocks run in no order, so the five
// phases of a layer are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()), each phase needing all of the
// previous one's output.  One launch instead of 5 * L keeps the host's
// launch cost and the gaps between kernels out of every token.
//
//   LN0 + qkv     LN0 (f32 stats, eps 1e-6) into shared memory, then one
//                 warp per output row of wqkv [3HD, E]: q to a scratch row,
//                 the new k and v rows written IN PLACE into the caches at
//                 position pos (the port's caches are mutable tensors).
//   attention     one block per (b, h): scores of all positions <= pos in
//                 f32 (a thread per key row, its 16-byte loads unrolled),
//                 softmax max/sum, p divided then rounded to the compute
//                 dtype, p @ V with f32 accumulation (a thread per 16-byte
//                 chunk of a value row).
//   proj          over the attention output, residual add.
//   LN1 + up      gelu (tanh form) on the rounded product.
//   down          over the MLP activation, residual add.
//
// Rounding points are those of the Pallas kernel: the residual stream is
// held in the compute dtype, LN statistics are f32, qkv, the softmax
// probabilities, the attention output, the up projection and each matmul
// before its residual add are rounded to the compute dtype.
//
// Bound: per token every block weight is read once (12 E^2 elements per
// layer) plus the K and V cache rows 0..pos of every layer: memory-bound at
// decode batch sizes.  The gemv reads weight rows with 16-byte loads.
// Caches are [L, B, S, H, D] (the port's prefill layout, no transpose).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBatch = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-6f;

enum Mode { kLnQkv = 0, kResid = 1, kLnUp = 2 };

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
template <typename T> __device__ __forceinline__ float round_f(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// elements of T in 16 bytes
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Loads of data this kernel also writes (hidden state, scratch rows, the
// caches) go through L2 only (ld.global.cg): an SM must not read a line its
// L1 cached before another SM rewrote it between two grid barriers.
__device__ __forceinline__ uint4 ld_cg16(const void* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}
template <typename T> __device__ __forceinline__ float ld_cg(const T* p);
template <> __device__ __forceinline__ float ld_cg<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ float ld_cg<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_f(e[i]);
}

struct StepArgs {
  void* x;              // [B, E] hidden state, updated in place
  const float* ln;      // [L, 4, E]
  const void* wqkv;     // [L, 3HD, E]
  const void* wproj;    // [L, E, HD]
  const void* wup;      // [L, F, E]
  const void* wdown;    // [L, E, F]
  void* kc;             // [L, B, S, H, D]
  void* vc;
  void* q_buf;          // [B, HD]
  void* o_buf;          // [B, HD]
  void* h_buf;          // [B, F]
  int L, B, E, H, F, S, pos;
  float scale;
};

extern __shared__ __align__(16) unsigned char g_smem[];

// One gemv phase: the block's input rows [B, K] go to shared memory (then
// through LayerNorm for kLnQkv / kLnUp), then every warp of the grid takes output rows
// n of W [N, K].  The first chunks of a warp's first row are loaded before
// the prologue, so their memory latency overlaps it.
template <typename T, int MODE>
__device__ void gemv_phase(const T* xin, const float* ln_scale, const float* ln_bias,
                           const T* w, int N, int K, int B, T* out, T* q_out, T* k_row,
                           T* v_row, long long cache_bstride, int HD) {
  constexpr int V = Vec16<T>::N;
  constexpr int kPre = 8;  // 16-byte chunks per lane loaded ahead
  T* xs = reinterpret_cast<T*>(g_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // rows interleave across blocks, so a phase with few rows still uses every SM
  const int first = blockIdx.x + gridDim.x * warp;
  const int stride = gridDim.x * kWarps;

  uint4 pre[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int k = (lane + 32 * i) * V;
    pre[i] = (first < N && k < K)
                 ? __ldg(reinterpret_cast<const uint4*>(w + (long long)first * K + k))
                 : make_uint4(0, 0, 0, 0);
  }

  // one batched copy of the input rows; LayerNorm then works in shared memory
  uint4* dst = reinterpret_cast<uint4*>(xs);
  for (int i = tid; i < B * K / V; i += kThreads) dst[i] = ld_cg16(xin + (long long)i * V);
  if (MODE == kLnQkv || MODE == kLnUp) {
    __syncthreads();
    // one warp per row, normalized in place; two-pass variance as the
    // Pallas kernel's _ln
    for (int b = warp; b < B; b += kWarps) {
      T* xr = xs + b * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f(xr[k]);
      const float mu = warp_sum(s) / K;
      float var = 0.f;
      for (int k = lane; k < K; k += 32) var += (to_f(xr[k]) - mu) * (to_f(xr[k]) - mu);
      const float rstd = rsqrtf(warp_sum(var) / K + kLnEps);
      for (int k = lane; k < K; k += 32) {
        xr[k] = from_f<T>((to_f(xr[k]) - mu) * rstd * ln_scale[k] + ln_bias[k]);
      }
    }
  }
  __syncthreads();

  for (int n = first; n < N; n += stride) {
    float acc[kMaxBatch];
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) acc[b] = 0.f;
    auto chunk = [&](const uint4& raw, int k) {
      float wv[V];
      unpack16<T>(raw, wv);
#pragma unroll
      for (int b = 0; b < kMaxBatch; ++b) {
        if (b < B) {
          float xv[V];
          unpack16<T>(*reinterpret_cast<const uint4*>(xs + b * K + k), xv);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[b] += wv[i] * xv[i];
        }
      }
    };
    int k_rest = lane * V;
    if (n == first) {
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int k = (lane + 32 * i) * V;
        if (k < K) chunk(pre[i], k);
      }
      k_rest += kPre * 32 * V;
    }
    for (int k = k_rest; k < K; k += 32 * V) {
      chunk(__ldg(reinterpret_cast<const uint4*>(w + (long long)n * K + k)), k);
    }
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b < B) {
        const float val = warp_sum(acc[b]);
        if (lane == b) {
          if (MODE == kLnQkv) {
            const T r = from_f<T>(val);
            if (n < HD) {
              q_out[b * HD + n] = r;
            } else if (n < 2 * HD) {
              k_row[b * cache_bstride + (n - HD)] = r;
            } else {
              v_row[b * cache_bstride + (n - 2 * HD)] = r;
            }
          } else if (MODE == kResid) {
            T* xo = out + (long long)b * N + n;
            *xo = from_f<T>(ld_cg(xo) + round_f<T>(val));
          } else {
            out[(long long)b * N + n] = from_f<T>(gelu_tanh(round_f<T>(val)));
          }
        }
      }
    }
  }
}

__device__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = is_max ? -INFINITY : 0.f;
  for (int i = 0; i < kWarps; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Shared memory of the attention phase, in floats: q [D], scores [S],
// partial p @ V sums [kThreads * V], reduction scratch [32].
template <typename T>
__host__ __device__ constexpr int attn_part_floats() {
  return kThreads * (16 / (int)sizeof(T));
}

// Attention for one (b, h) pair on one block.  Every thread keeps one key
// row's 16-byte loads in flight (the head dim is a template constant, so
// they unroll); the p @ V pass gives each thread one 16-byte chunk of a
// value row, kThreads / (D / V) rows at a time.
template <typename T, int D>
__device__ void attention_item(const T* q, const T* kc, const T* vc, T* o, int b, int h,
                               int H, int S, int pos, float scale) {
  constexpr int V = Vec16<T>::N;
  constexpr int kChunks = D / V;             // 16-byte chunks per row
  constexpr int kRows = kThreads / kChunks;  // value rows per pass
  float* qs = reinterpret_cast<float*>(g_smem);
  float* sc = qs + D;
  float* part = sc + S;
  float* red = part + attn_part_floats<T>();
  const int n = pos + 1;
  const int HD = H * D;
  const int tid = threadIdx.x;

  __syncthreads();  // shared memory free from the previous item
  for (int d = tid; d < D; d += kThreads) qs[d] = ld_cg(q + b * HD + h * D + d);
  __syncthreads();

  const long long row_stride = HD;  // between positions
  const T* kb = kc + (long long)b * S * HD + h * D;
  const T* vb = vc + (long long)b * S * HD + h * D;
  float mx = -INFINITY;
  for (int t = tid; t < n; t += kThreads) {
    const T* kr = kb + t * row_stride;
    float kv[D];
#pragma unroll
    for (int d = 0; d < D; d += V) unpack16<T>(ld_cg16(kr + d), kv + d);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot += qs[d] * kv[d];
    const float s = dot * scale;
    sc[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = tid; t < n; t += kThreads) {
    const float p = expf(sc[t] - mx);
    sc[t] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);
  for (int t = tid; t < n; t += kThreads) sc[t] = round_f<T>(sc[t] / sum);
  __syncthreads();

  const int g = tid / kChunks, c = (tid % kChunks) * V;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int t = g; t < n; t += kRows) {
    float vv[V];
    unpack16<T>(ld_cg16(vb + t * row_stride + c), vv);
    const float p = sc[t];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += p * vv[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) part[g * D + c + i] = acc[i];
  __syncthreads();
  for (int dd = tid; dd < D; dd += kThreads) {
    float r = 0.f;
    for (int gg = 0; gg < kRows; ++gg) r += part[gg * D + dd];
    o[b * HD + h * D + dd] = from_f<T>(r);
  }
}

// The whole step: every block walks the layers, and the grid meets at a
// barrier between phases (each phase needs all of the previous one).  Every
// thread reaches every barrier: no thread leaves a loop early.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(StepArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int HD = a.H * D;
  const int E = a.E, F = a.F, B = a.B;
  T* x = static_cast<T*>(a.x);
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  T* q_buf = static_cast<T*>(a.q_buf);
  T* o_buf = static_cast<T*>(a.o_buf);
  T* h_buf = static_cast<T*>(a.h_buf);
  const long long cache_bstride = (long long)a.S * HD;
  for (int l = 0; l < a.L; ++l) {
    const float* ln = a.ln + (long long)l * 4 * E;
    const long long layer_cache = (long long)l * B * a.S * HD;
    T* k_row = kc + layer_cache + (long long)a.pos * HD;
    T* v_row = vc + layer_cache + (long long)a.pos * HD;

    gemv_phase<T, kLnQkv>(x, ln, ln + E, static_cast<const T*>(a.wqkv) + (long long)l * 3 * HD * E,
                          3 * HD, E, B, nullptr, q_buf, k_row, v_row, cache_bstride, HD);
    grid.sync();
    for (int item = blockIdx.x; item < B * a.H; item += gridDim.x) {
      attention_item<T, D>(q_buf, kc + layer_cache, vc + layer_cache, o_buf, item / a.H,
                           item % a.H, a.H, a.S, a.pos, a.scale);
    }
    grid.sync();
    gemv_phase<T, kResid>(o_buf, nullptr, nullptr,
                          static_cast<const T*>(a.wproj) + (long long)l * E * HD, E, HD, B, x,
                          nullptr, nullptr, nullptr, 0, HD);
    grid.sync();
    gemv_phase<T, kLnUp>(x, ln + 2 * E, ln + 3 * E,
                         static_cast<const T*>(a.wup) + (long long)l * F * E, F, E, B, h_buf,
                         nullptr, nullptr, nullptr, 0, HD);
    grid.sync();
    gemv_phase<T, kResid>(h_buf, nullptr, nullptr,
                          static_cast<const T*>(a.wdown) + (long long)l * E * F, E, F, B, x,
                          nullptr, nullptr, nullptr, 0, HD);
    grid.sync();
  }
}

// Shared memory a block needs: the widest gemv input or the attention phase.
template <typename T>
size_t step_smem(const StepArgs& a, int D) {
  const size_t gemv = (size_t)a.B * std::max(a.E, std::max(a.F, a.H * D)) * sizeof(T);
  const size_t attn = (size_t)(D + a.S + attn_part_floats<T>() + 32) * sizeof(float);
  return std::max(gemv, attn);
}

struct GridCache {
  std::mutex mu;
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <typename T, int D>
cudaError_t launch_step(StepArgs a, cudaStream_t stream) {
  static GridCache cache;
  const size_t smem = step_smem<T>(a, D);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  int blocks;
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    if (cache.device != device || cache.smem != smem) {
      if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(decode_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
      }
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel<T, D>,
                                                        kThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      cache.device = device;
      cache.smem = smem;
      // one block per SM: its registers are uncapped (__launch_bounds__(.., 1))
      cache.blocks = sms;
    }
    blocks = cache.blocks;
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_kernel<T, D>),
                                  dim3(blocks), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const StepArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_step<T, 32>(a, stream);
    case 64: return launch_step<T, 64>(a, stream);
    case 128: return launch_step<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* dk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B, E] is updated in place to the hidden state after the last layer.
// ln [L, 4, E] f32 (ln0 scale, ln0 bias, ln1 scale, ln1 bias); weights are
// stacked [L, N, K]; caches [L, B, S, H, D]; scratch q/o [B, H*D], h [B, F].
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int dk_decode_step(void* x, const void* ln, const void* wqkv,
                              const void* wproj, const void* wup, const void* wdown,
                              void* kc, void* vc, void* q_buf, void* o_buf, void* h_buf,
                              int L, int B, int E, int H, int D, int F, int S, int pos,
                              int dtype, void* stream) {
  if (B < 1 || B > kMaxBatch || pos < 0 || pos >= S || H * D != E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StepArgs a{x, static_cast<const float*>(ln), wqkv, wproj, wup, wdown, kc, vc,
             q_buf, o_buf, h_buf, L, B, E, H, F, S, pos, 1.0f / sqrtf((float)D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(a, D, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(a, D, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
