// Ragged paged attention for Hopper (sm_90a): the hand-written CUDA
// counterpart of paddle_tpu/ops/ragged_paged_attn.py::_stream_impl, the
// TPU Pallas kernel that carries every paged window of the serving
// engine's attn_impl="ragged" path (one-token decode lanes and prefill
// chunks side by side, per-slot pos / width / block table as data), in
// both of its legs: fp pools (B1) and int8 pools with per-block per-head
// f32 scales (B2, Engine(kv_dtype="int8"), the same function's
// k_scale / v_scale branch at :141-163).
//
// What it computes, per slot b and head h: walk the slot's block table
// up to the causal horizon n_live = min(nb, (pos + max(width, 1) - 1) / bs
// + 1); for each live block take f32 scores of the query lanes against
// the block's K rows, mask position j*bs + r > pos + s to -1e30, and run
// the flash online-softmax recurrence (running max m, normalizer l,
// accumulator acc rescaled by exp(m_old - m_new), probabilities
// multiplied by the mask so a fully masked tile adds exactly 0).  The
// output is acc / l in q's dtype, and lanes >= width are written as 0.
// With int8 pools each streamed block is dequantized as it is staged:
// (float)code * scale[block, h], the scale read once per block, so the
// pool is never dequantized whole and the f32 values exist only in
// shared memory.
//
// What bounds it on an H100: bytes.  Each slot's live K/V rows are read
// once per head, q and the output once; the arithmetic is about
// 4 * lanes * hd flops per K/V row, far below the card's ~20 flop/byte
// fp32 (~295 bf16) balance point, so the floor is the live K/V bytes over
// 3.35 TB/s (a quarter of them for int8 codes, plus the scale rows).
//
// What the design does about it: one CUDA block per (slot, head), so a
// B=8, H=16 batch fills 128 of the 132 SMs and every block streams only
// its own head's slice of its slot's live blocks; the walk stops at the
// causal horizon (the TPU kernel's early exit), and only the slot's real
// lanes (s < width) are computed, so a decode lane (width 1) does one
// row's work inside a window sized for the 64-token prefill chunk.  K
// and V of one paged block sit in shared memory as f32 whatever the pool
// type (K rows padded by one float against bank conflicts) and every
// thread of the block works on them with scalar FMAs.  No tensor cores,
// TMA or pipelining yet: the loads of block j+1 do not overlap the math
// of block j.  The kernel is templated over (q/out type, pool type): the
// fp and int8 legs share every line but the staging conversion.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kMaskValue = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a pool element as f32: fp pools convert, int8 codes are multiplied by
// their block's per-head scale
template <typename P>
__device__ __forceinline__ float dequant(P x, float) {
  return to_float<P>(x);
}
template <>
__device__ __forceinline__ float dequant<int8_t>(int8_t x, float s) {
  return (float)x * s;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory, in floats: q rows [W][hd], acc [W][hd], one K block
// [bs][hd+1], one V block [bs][hd], probabilities [W][bs], and m, l and
// the per-lane correction [W] each.
__host__ __device__ inline size_t smem_floats(int W, int hd, int bs) {
  return 2 * (size_t)W * hd + (size_t)bs * (hd + 1) + (size_t)bs * hd +
         (size_t)W * bs + 3 * (size_t)W;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attn_kernel(const T* __restrict__ q, const P* __restrict__ k,
                         const P* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ tables,
                         const int* __restrict__ pos,
                         const int* __restrict__ width, T* __restrict__ out,
                         int W, int H, int hd, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int ks = hd + 1;  // padded K row stride

  float* q_s = smem;
  float* acc = q_s + (size_t)W * hd;
  float* k_s = acc + (size_t)W * hd;
  float* v_s = k_s + (size_t)bs * ks;
  float* p_s = v_s + (size_t)bs * hd;
  float* m_s = p_s + (size_t)W * bs;
  float* l_s = m_s + W;
  float* c_s = l_s + W;

  const int p = pos[b];
  const int w = min(max(width[b], 0), W);
  // causal horizon; a parked width-0 slot still walks block 0 (it
  // computes no lane, and its output is all zeros)
  const int n_live = min(nb, (p + max(w, 1) - 1) / bs + 1);
  const int64_t row_stride = (int64_t)H * hd;

  for (int i = tid; i < w * hd; i += kThreads) {
    const int s = i / hd, d = i - s * hd;
    q_s[i] = to_float(q[((int64_t)b * W + s) * row_stride + (int64_t)h * hd + d]);
    acc[i] = 0.f;
  }
  for (int s = tid; s < w; s += kThreads) {
    m_s[s] = kMaskValue;
    l_s[s] = 0.f;
  }
  __syncthreads();

  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  for (int j = 0; j < n_live; ++j) {
    const int64_t blk = tables[(int64_t)b * nb + j];
    const int64_t base = blk * bs;
    const float k_sc = kQuant ? k_scale[blk * H + h] : 1.f;
    const float v_sc = kQuant ? v_scale[blk * H + h] : 1.f;
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int64_t off = (base + r) * row_stride + (int64_t)h * hd + d;
      k_s[r * ks + d] = dequant<P>(k[off], k_sc);
      v_s[i] = dequant<P>(v[off], v_sc);
    }
    __syncthreads();

    // scores of the real lanes against this block, masked
    for (int i = tid; i < w * bs; i += kThreads) {
      const int s = i / bs, r = i - s * bs;
      const float* qr = q_s + s * hd;
      const float* kr = k_s + r * ks;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      p_s[i] = (j * bs + r <= p + s) ? dot * scale : kMaskValue;
    }
    __syncthreads();

    // online-softmax update, one lane per thread
    for (int s = tid; s < w; s += kThreads) {
      float* row = p_s + s * bs;
      float bm = row[0];
      for (int r = 1; r < bs; ++r) bm = fmaxf(bm, row[r]);
      const float m_old = m_s[s];
      const float m_new = fmaxf(m_old, bm);
      float sum = 0.f;
      for (int r = 0; r < bs; ++r) {
        const float vis = (j * bs + r <= p + s) ? 1.f : 0.f;
        const float e = expf(row[r] - m_new) * vis;
        row[r] = e;
        sum += e;
      }
      const float corr = expf(m_old - m_new);
      l_s[s] = l_s[s] * corr + sum;
      m_s[s] = m_new;
      c_s[s] = corr;
    }
    __syncthreads();

    for (int i = tid; i < w * hd; i += kThreads) {
      const int s = i / hd, d = i - s * hd;
      const float* pr = p_s + s * bs;
      float a = 0.f;
      for (int r = 0; r < bs; ++r) a = fmaf(pr[r], v_s[r * hd + d], a);
      acc[i] = acc[i] * c_s[s] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < W * hd; i += kThreads) {
    const int s = i / hd, d = i - s * hd;
    const float o = (s < w) ? acc[i] / l_s[s] : 0.f;
    out[((int64_t)b * W + s) * row_stride + (int64_t)h * hd + d] =
        from_float<T>(o);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tables, const void* pos,
           const void* width, void* out, int B, int W, int H, int hd, int bs,
           int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(W, hd, bs) * sizeof(float);
  ragged_paged_attn_kernel<T, P><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<const int*>(width),
      static_cast<T*>(out), W, H, hd, bs, nb, scale);
  return (int)cudaGetLastError();
}

// The kernel instantiation of (dtype, quant): 0 = float32, 1 = bfloat16
// for q and out; quant = int8 pools with scales, else pools of q's dtype.
const void* kernel_of(int dtype, int quant) {
  if (dtype == 0)
    return quant ? (const void*)ragged_paged_attn_kernel<float, int8_t>
                 : (const void*)ragged_paged_attn_kernel<float, float>;
  if (dtype == 1)
    return quant
        ? (const void*)ragged_paged_attn_kernel<__nv_bfloat16, int8_t>
        : (const void*)ragged_paged_attn_kernel<__nv_bfloat16,
                                                __nv_bfloat16>;
  return nullptr;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for these shapes, in bytes (the
// same for fp and int8 pools: tiles are staged as f32 either way).
size_t ragged_paged_attn_smem_bytes(int W, int hd, int bs) {
  return smem_floats(W, hd, bs) * sizeof(float);
}

// Raise the instantiation's dynamic shared-memory limit to smem bytes:
// called once per (dtype, quant, card) and again only when a config needs
// more, not before every launch.  Returns the CUDA error (0 on success).
int ragged_paged_attn_prepare(int dtype, int quant, int smem) {
  const void* fn = kernel_of(dtype, quant);
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// dtype: 0 = float32, 1 = bfloat16 for q and out.  k_scale / v_scale:
// null for fp pools (k and v then share q's dtype), else f32 [NB, H] and
// k, v are int8 codes.  tables, pos and width are int32.  Layouts: q and
// out [B, W, H, hd]; k and v [NB * bs, H, hd]; tables [B, nb].  Returns
// cudaGetLastError() after the launch (0 on success).
int ragged_paged_attn_launch(int dtype, const void* q, const void* k,
                             const void* v, const void* k_scale,
                             const void* v_scale, const void* tables,
                             const void* pos, const void* width, void* out,
                             int B, int W, int H, int hd, int bs, int nb,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool quant = k_scale != nullptr;
#define RPA_ARGS \
  q, k, v, k_scale, v_scale, tables, pos, width, out, B, W, H, hd, bs, nb, \
      scale, s
  if (dtype == 0)
    return quant ? launch<float, int8_t>(RPA_ARGS)
                 : launch<float, float>(RPA_ARGS);
  if (dtype == 1)
    return quant ? launch<__nv_bfloat16, int8_t>(RPA_ARGS)
                 : launch<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
#undef RPA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
