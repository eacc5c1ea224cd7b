// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the upstream Pallas TPU flash-attention kernel that
// paddle_tpu/nn/functional/attention.py (_flash_attention) calls:
// jax/experimental/pallas/ops/tpu/flash_attention.py —
//   flash_fwd      <- _flash_attention_impl     (pallas_call of
//                     _flash_attention_kernel)
//   flash_bwd_dkv  <- _flash_attention_bwd_dkv  (_flash_attention_dkv_kernel)
//   flash_bwd_dq   <- _flash_attention_bwd_dq   (_flash_attention_dq_kernel)
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous [B, S, H, D] (paddle's
// order); lse and di are f32 [B, H, S]; segment ids are int32 [B, S] or
// null.  One sequence length for q and k.  Masks: causal (key j visible to
// query i iff j <= i) and segment ids (visible iff the ids match),
// combined.
//
// What bounds it on this card: at the training slice (B=4, H=16, S=2048,
// D=128, bf16) the forward does 6.9e10 causal FLOPs over 134 MB of
// q/k/v/o, so the tensor cores' 989 TFLOP/s set the bound (0.07 ms), not
// the 3.35 TB/s of HBM (0.04 ms).  These kernels are the simple, correct
// first version: scalar f32 FMAs over shared-memory tiles, so they run at
// the CUDA cores' fp32 rate, far from that bound.  They serve float32 only
// (the tensor cores would compute it as TF32); bf16 runs on the tensor
// cores in flash_attention_sm90.cu.
//
// Design, against the TPU kernel's shape:
// * The TPU grid walks k-blocks in order and carries m, l and the output
//   accumulator in VMEM from one grid step to the next.  Here each CUDA
//   block owns one (b, h, 64-row tile) and loops over the other tiles
//   itself, keeping the carries in registers; blocks run in any order.
// * 64x64 tiles, 256 threads as a 16x16 grid: thread (ty, tx) owns rows
//   ty + 16 i and columns tx + 16 j (i, j < 4) of a score tile, and
//   head-dim columns tx + 16 c of its rows' accumulators.  A row's 16
//   owners sit in one half-warp, so row max and row sum are four xor
//   shuffles.
// * Tiles are staged in shared memory as f32 with a row stride of D + 1
//   floats, so the 16 threads that read column d of 16 different rows hit
//   16 different banks.
// * Masked entries use -1e30 and probabilities are multiplied out to
//   exactly 0 (never exp of a masked score): m stays finite, so
//   exp(m_old - m_new) never makes a NaN, and a fully masked tile (segment
//   ids) contributes exactly 0.  Every row keeps its diagonal, so l > 0.
// * Causal: forward and dQ stop at the diagonal tile; dK/dV starts there.
// * Backward: p = exp(s * scale - lse) recomputed, ds = p * (dp - di) with
//   di = rowsum(o * do) computed by the caller (the upstream also computes
//   it outside Pallas).  dK/dV and dQ are separate kernels, so nothing is
//   accumulated across blocks and no atomics are needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // q and k tile rows
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kTile + 1;
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Stage rows r0 .. r0+63 of head h of batch b from a [B, S, H, D] tensor
// into dst (f32, row stride D + 1).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int h, int r0, int S, int H) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] =
        to_f32(src[((size_t)(b * S + r0 + r) * H + h) * D + d]);
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int* seg, int b,
                                         int r0, int S) {
  if (seg != nullptr && threadIdx.x < kTile)
    dst[threadIdx.x] = seg[(size_t)b * S + r0 + threadIdx.x];
}

// Reduce across the 16 lanes of a half-warp (one row's owners).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(int qi, int kj, int causal,
                                        const int* seg_q, const int* seg_k,
                                        bool has_seg, int qr, int kr) {
  return (!causal || kj <= qi) && (!has_seg || seg_q[qr] == seg_k[kr]);
}

// Shared memory per block, in bytes, for each kernel (D = head dim).
constexpr size_t tile_bytes(int D) { return sizeof(float) * kTile * (D + 1); }
constexpr size_t p_bytes() { return sizeof(float) * kTile * kLdP; }
constexpr size_t smem_fwd(int D) {
  return 3 * tile_bytes(D) + p_bytes() + 2 * kTile * sizeof(int);
}
constexpr size_t smem_dkv(int D) {
  return 4 * tile_bytes(D) + 2 * p_bytes() + 2 * kTile * sizeof(float) +
         2 * kTile * sizeof(int);
}
constexpr size_t smem_dq(int D) {
  return 4 * tile_bytes(D) + p_bytes() + 2 * kTile * sizeof(int);
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, h, b).  Online softmax over the k tiles
// up to the diagonal (causal) or all of them; writes o and lse.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ o, float* __restrict__ lse, int H, int S,
                     int causal, float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  int* seg_q = reinterpret_cast<int*>(Ps + kTile * kLdP);
  int* seg_k = seg_q + kTile;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_seg = seg != nullptr;

  load_tile<T, D>(Qs, q, b, h, q0, S, H);
  load_seg(seg_q, seg, b, q0, S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, b, h, k0, S, H);
    load_tile<T, D>(Vs, v, b, h, k0, S, H);
    load_seg(seg_k, seg, b, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
      bool vis[4];
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = tx + 16 * j;
        vis[j] = visible(q0 + qr, k0 + kr, causal, seg_q, seg_k, has_seg,
                         qr, kr);
        s[i][j] = vis[j] ? s[i][j] * scale : kMask;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[qr * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float inv = 1.f / l[i];
    T* orow = o + ((size_t)(b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0) lse[((size_t)b * H + h) * S + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (k tile, h, b).  Loops over the q tiles from the
// diagonal (causal) or from 0; recomputes p^T from lse and accumulates
// dV += p^T do and dK += ds^T q (times scale at the end).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         const int* __restrict__ seg, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int S, int causal,
                         float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Pt = dOs + kTile * LD;   // p^T  [k row][q col]
  float* dSt = Pt + kTile * kLdP; // ds^T [k row][q col]
  float* lse_s = dSt + kTile * kLdP;
  float* di_s = lse_s + kTile;
  int* seg_k = reinterpret_cast<int*>(di_s + kTile);
  int* seg_q = seg_k + kTile;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_seg = seg != nullptr;
  const float* lse_bh = lse + ((size_t)b * H + h) * S;
  const float* di_bh = di + ((size_t)b * H + h) * S;

  load_tile<T, D>(Ks, k, b, h, k0, S, H);
  load_tile<T, D>(Vs, v, b, h, k0, S, H);
  load_seg(seg_k, seg, b, k0, S);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = S / kTile;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, q, b, h, q0, S, H);
    load_tile<T, D>(dOs, dout, b, h, q0, S, H);
    load_seg(seg_q, seg, b, q0, S);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse_bh[q0 + threadIdx.x];
      di_s[threadIdx.x] = di_bh[q0 + threadIdx.x];
    }
    __syncthreads();

    // s^T[kr][qc] = k[kr] . q[qc];  dp^T[kr][qc] = v[kr] . do[qc]
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + d];
        dov[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const bool vis = visible(q0 + qc, k0 + kr, causal, seg_q, seg_k,
                                 has_seg, qc, kr);
        const float p = vis ? expf(st[i][j] * scale - lse_s[qc]) : 0.f;
        Pt[kr * kLdP + qc] = p;
        dSt[kr * kLdP + qc] = p * (dpt[i][j] - di_s[qc]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], dov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty + 16 * i) * kLdP + qq];
        dsv[i] = dSt[(ty + 16 * i) * kLdP + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dov[c] = dOs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t off = ((size_t)(b * S + k0 + ty + 16 * i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c] * scale);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, h, b).  Loops over the k tiles up to the
// diagonal (causal) or all of them; dQ += ds k (times scale at the end).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        const int* __restrict__ seg, T* __restrict__ dq,
                        int H, int S, int causal, float scale) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dS = Vs + kTile * LD;   // [q row][k col]
  int* seg_q = reinterpret_cast<int*>(dS + kTile * kLdP);
  int* seg_k = seg_q + kTile;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_seg = seg != nullptr;

  load_tile<T, D>(Qs, q, b, h, q0, S, H);
  load_tile<T, D>(dOs, dout, b, h, q0, S, H);
  load_seg(seg_q, seg, b, q0, S);
  float lse_r[4], di_r[4], dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = ((size_t)b * H + h) * S + q0 + ty + 16 * i;
    lse_r[i] = lse[r];
    di_r[i] = di[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : S / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k, b, h, k0, S, H);
    load_tile<T, D>(Vs, v, b, h, k0, S, H);
    load_seg(seg_k, seg, b, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        dov[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = tx + 16 * j;
        const bool vis = visible(q0 + qr, k0 + kr, causal, seg_q, seg_k,
                                 has_seg, qr, kr);
        const float p = vis ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dS[qr * kLdP + kr] = p * (dp[i][j] - di_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dS[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) dq_acc[i][c] = fmaf(dsv[i], kv[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + ((size_t)(b * S + q0 + ty + 16 * i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f32<T>(dq_acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
template <typename T, int D>
int fwd_typed(const void* q, const void* k, const void* v, const void* seg,
              void* o, void* lse, int B, int H, int S, int causal,
              float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = smem_fwd(D);
  kern<<<dim3(S / kTile, H, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg, (T*)o,
      (float*)lse, H, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, const void* seg, void* dk,
              void* dv, int B, int H, int S, int causal, float scale,
              cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = smem_dkv(D);
  kern<<<dim3(S / kTile, H, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)di, (const int*)seg, (T*)dk, (T*)dv, H,
      S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* di, const void* seg, void* dq,
             int B, int H, int S, int causal, float scale,
             cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = smem_dq(D);
  kern<<<dim3(S / kTile, H, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)di, (const int*)seg, (T*)dq, H, S,
      causal, scale);
  return (int)cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory ceiling to what it uses, on the
// current device.  Called once per (kernel, dtype, D, device) before the
// first launch, not before every launch.
int set_smem_limit(const void* fn, size_t smem) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
template <typename T, int D>
int prepare_fwd(size_t smem) {
  return set_smem_limit((const void*)flash_fwd_kernel<T, D>, smem);
}
template <typename T, int D>
int prepare_dkv(size_t smem) {
  return set_smem_limit((const void*)flash_bwd_dkv_kernel<T, D>, smem);
}
template <typename T, int D>
int prepare_dq(size_t smem) {
  return set_smem_limit((const void*)flash_bwd_dq_kernel<T, D>, smem);
}

// dtype 0 = float32 (bf16 runs in flash_attention_sm90.cu); D = 64 or 128.
// -1: unsupported.
#define FLASH_DISPATCH(FN, ...)                                   \
  if (dtype == 0 && D == 64) return FN<float, 64>(__VA_ARGS__);   \
  if (dtype == 0 && D == 128) return FN<float, 128>(__VA_ARGS__); \
  return -1;

}  // namespace

extern "C" {

// kernel 0 = fwd, 1 = bwd_dkv, 2 = bwd_dq
size_t flash_smem_bytes(int kernel, int D) {
  if (kernel == 0) return smem_fwd(D);
  if (kernel == 1) return smem_dkv(D);
  return smem_dq(D);
}

int flash_prepare(int kernel, int dtype, int D) {
  if (kernel == 0) {
    FLASH_DISPATCH(prepare_fwd, smem_fwd(D))
  }
  if (kernel == 1) {
    FLASH_DISPATCH(prepare_dkv, smem_dkv(D))
  }
  if (kernel == 2) {
    FLASH_DISPATCH(prepare_dq, smem_dq(D))
  }
  return -1;
}

int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v,
                     const void* seg, void* o, void* lse, int B, int H, int S,
                     int D, int causal, float scale, void* stream) {
  if (S % kTile) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(fwd_typed, q, k, v, seg, o, lse, B, H, S, causal, scale,
                     st)
}

int flash_bwd_dkv_launch(int dtype, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* di, const void* seg, void* dk, void* dv,
                         int B, int H, int S, int D, int causal, float scale,
                         void* stream) {
  if (S % kTile) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dkv_typed, q, k, v, dout, lse, di, seg, dk, dv, B, H, S,
                     causal, scale, st)
}

int flash_bwd_dq_launch(int dtype, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* di, const void* seg, void* dq, int B,
                        int H, int S, int D, int causal, float scale,
                        void* stream) {
  if (S % kTile) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  FLASH_DISPATCH(dq_typed, q, k, v, dout, lse, di, seg, dq, B, H, S, causal,
                 scale, st)
}

}  // extern "C"
