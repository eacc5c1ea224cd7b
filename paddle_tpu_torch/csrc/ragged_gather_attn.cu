// Ragged gather attention for Hopper (sm_90a): the hand-written CUDA
// counterpart of paddle_tpu/ops/ragged_paged_attn.py::_gather_impl, the
// TPU Pallas kernel behind the serving engine's
// attn_impl="ragged_gather" (the A/B body beside the streaming kernel),
// with fp pools and with int8 pools plus per-block per-head f32 scales.
//
// What it computes, per slot b and head h: the slot's whole logical row
// of L = nb * bs cache positions, gathered through every entry of its
// block table (int8 blocks dequantized as (float)code * scale[block, h]),
// f32 scores of the real query lanes against it scaled by 1/sqrt(hd),
// position l > pos + s masked to -1e30, ONE softmax over L per lane
// (max, exp(x - max), sum, divide), and the probabilities times the
// gathered V row.  Lanes >= width are written as 0.  It walks the whole
// table, not the causal horizon: that is the TPU kernel's defined work,
// and what makes it the baseline the streaming kernel is measured
// against.
//
// What bounds it on an H100: bytes.  Every table entry's K and V block
// is read (for one head), q and the output once; about 4 * lanes * hd
// flops per K/V row, far below the balance point.
//
// What the design does about it, and what differs from the TPU: the TPU
// kernel holds the gathered [L, H, hd] row in VMEM; on the H100 one
// head's row at L = 1024, hd = 64 in f32 is 256 KB, over a block's
// 227 KB of shared memory.  So a block holds the SCORES instead: one
// CUDA block per (slot, head, tile of kTileLanes query lanes) keeps a
// [kTileLanes, L] f32 score tile (64 KB at L = 1024) in shared memory.
// Pass 1 streams every K block through shared memory and writes the
// masked scores; each warp then runs the monolithic softmax of its lanes
// with warp shuffles; pass 2 streams the V blocks and accumulates P.V.
// A tile whose lanes all lie at or past width writes zeros and returns,
// so a decode slot (width 1) runs one tile of the window's four.
// Scalar f32 FMAs over shared-memory tiles, no tensor cores or
// pipelining yet.  The wrapper asks for the shared-memory size and
// raises for a context whose score tile does not fit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTileLanes = 16;
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: q rows [T][hd], acc [T][hd], one K or V block
// [bs][hd+1] (padded against bank conflicts), scores [T][nb*bs].
__host__ __device__ inline size_t smem_floats(int hd, int bs, int nb) {
  return 2 * (size_t)kTileLanes * hd + (size_t)bs * (hd + 1) +
         (size_t)kTileLanes * nb * bs;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
ragged_gather_attn_kernel(const T* __restrict__ q, const P* __restrict__ k,
                          const P* __restrict__ v,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos,
                          const int* __restrict__ width, T* __restrict__ out,
                          int W, int H, int hd, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int n_tiles = (W + kTileLanes - 1) / kTileLanes;
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int ks = hd + 1;
  const int L = nb * bs;

  float* q_s = smem;
  float* acc = q_s + (size_t)kTileLanes * hd;
  float* kv_s = acc + (size_t)kTileLanes * hd;
  float* sc = kv_s + (size_t)bs * ks;

  const int p = pos[b];
  const int w = min(max(width[b], 0), W);
  const int s0 = tile * kTileLanes;
  const int nt = min(kTileLanes, W - s0);          // lanes of this tile
  const int wt = max(0, min(nt, w - s0));          // its real lanes
  const int64_t row_stride = (int64_t)H * hd;
  T* out_t = out + ((int64_t)b * W + s0) * row_stride + (int64_t)h * hd;

  if (wt == 0) {  // every lane of the tile is past width
    for (int i = tid; i < nt * hd; i += kThreads) {
      const int s = i / hd, d = i - s * hd;
      out_t[s * row_stride + d] = from_float<T>(0.f);
    }
    return;
  }
  const T* q_t = q + ((int64_t)b * W + s0) * row_stride + (int64_t)h * hd;
  for (int i = tid; i < wt * hd; i += kThreads) {
    const int s = i / hd, d = i - s * hd;
    q_s[i] = to_float(q_t[s * row_stride + d]);
    acc[i] = 0.f;
  }

  // pass 1: masked scores against every table entry's K block
  for (int j = 0; j < nb; ++j) {
    const int64_t blk = tables[(int64_t)b * nb + j];
    const int64_t base = blk * bs;
    const float k_sc = kQuant ? k_scale[blk * H + h] : 1.f;
    __syncthreads();  // the previous block is consumed; q_s is written
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      kv_s[r * ks + d] = dequant<P>(
          k[(base + r) * row_stride + (int64_t)h * hd + d], k_sc);
    }
    __syncthreads();
    for (int i = tid; i < wt * bs; i += kThreads) {
      const int s = i / bs, r = i - s * bs;
      const float* qr = q_s + s * hd;
      const float* kr = kv_s + r * ks;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int l = j * bs + r;
      sc[(size_t)s * L + l] = (l <= p + s0 + s) ? dot * scale : kMaskValue;
    }
  }
  __syncthreads();

  // one softmax over L per lane, one warp per lane; position 0 is
  // visible to every lane, so the max is a real score and masked
  // entries come out as exactly 0
  const int warp = tid / 32, lane = tid % 32;
  for (int s = warp; s < wt; s += kThreads / 32) {
    float* row = sc + (size_t)s * L;
    float m = kMaskValue;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, row[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(row[l] - m);
      row[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) row[l] = row[l] / sum;
  }

  // pass 2: probabilities times every table entry's V block
  for (int j = 0; j < nb; ++j) {
    const int64_t blk = tables[(int64_t)b * nb + j];
    const int64_t base = blk * bs;
    const float v_sc = kQuant ? v_scale[blk * H + h] : 1.f;
    __syncthreads();  // the softmax, or the previous block, is done
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      kv_s[r * ks + d] = dequant<P>(
          v[(base + r) * row_stride + (int64_t)h * hd + d], v_sc);
    }
    __syncthreads();
    // thread tid owns the same acc elements in every block j
    for (int i = tid; i < wt * hd; i += kThreads) {
      const int s = i / hd, d = i - s * hd;
      const float* pr = sc + (size_t)s * L + j * bs;
      float a = 0.f;
      for (int r = 0; r < bs; ++r) a = fmaf(pr[r], kv_s[r * ks + d], a);
      acc[i] += a;
    }
  }

  for (int i = tid; i < nt * hd; i += kThreads) {
    const int s = i / hd, d = i - s * hd;
    out_t[s * row_stride + d] = from_float<T>(s < wt ? acc[i] : 0.f);
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tables, const void* pos,
           const void* width, void* out, int B, int W, int H, int hd, int bs,
           int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(hd, bs, nb) * sizeof(float);
  const int n_tiles = (W + kTileLanes - 1) / kTileLanes;
  ragged_gather_attn_kernel<T, P><<<B * H * n_tiles, kThreads, smem,
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<const int*>(width),
      static_cast<T*>(out), W, H, hd, bs, nb, scale);
  return (int)cudaGetLastError();
}

const void* kernel_of(int dtype, int quant) {
  if (dtype == 0)
    return quant ? (const void*)ragged_gather_attn_kernel<float, int8_t>
                 : (const void*)ragged_gather_attn_kernel<float, float>;
  if (dtype == 1)
    return quant
        ? (const void*)ragged_gather_attn_kernel<__nv_bfloat16, int8_t>
        : (const void*)ragged_gather_attn_kernel<__nv_bfloat16,
                                                 __nv_bfloat16>;
  return nullptr;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes, for head dim hd,
// block size bs and nb table entries (the score tile grows with L).
size_t ragged_gather_attn_smem_bytes(int hd, int bs, int nb) {
  return smem_floats(hd, bs, nb) * sizeof(float);
}

// Query lanes per CUDA block (the score tile's rows).
int ragged_gather_attn_tile_lanes(void) { return kTileLanes; }

// Raise the instantiation's dynamic shared-memory limit to smem bytes
// (once per (dtype, quant, card), and again only for a larger config).
int ragged_gather_attn_prepare(int dtype, int quant, int smem) {
  const void* fn = kernel_of(dtype, quant);
  if (!fn) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Arguments and layouts as ragged_paged_attn_launch: dtype 0 = float32,
// 1 = bfloat16 for q and out; k_scale / v_scale null for fp pools of q's
// dtype, else f32 [NB, H] with int8 code pools.  Returns
// cudaGetLastError() after the launch (0 on success).
int ragged_gather_attn_launch(int dtype, const void* q, const void* k,
                              const void* v, const void* k_scale,
                              const void* v_scale, const void* tables,
                              const void* pos, const void* width, void* out,
                              int B, int W, int H, int hd, int bs, int nb,
                              float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool quant = k_scale != nullptr;
#define RGA_ARGS \
  q, k, v, k_scale, v_scale, tables, pos, width, out, B, W, H, hd, bs, nb, \
      scale, s
  if (dtype == 0)
    return quant ? launch<float, int8_t>(RGA_ARGS)
                 : launch<float, float>(RGA_ARGS);
  if (dtype == 1)
    return quant ? launch<__nv_bfloat16, int8_t>(RGA_ARGS)
                 : launch<__nv_bfloat16, __nv_bfloat16>(RGA_ARGS);
#undef RGA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
