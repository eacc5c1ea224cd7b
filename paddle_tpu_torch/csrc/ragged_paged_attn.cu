// Ragged paged attention for Hopper (sm_90a): the hand-written CUDA
// counterpart of both Pallas kernels of paddle_tpu/ops/ragged_paged_attn.py,
// the kernels behind every paged window of the serving engine (one-token
// decode lanes and prefill chunks side by side, per-slot pos / width /
// block table as data), each over fp pools and over int8 pools with
// per-block per-head f32 scales (Engine(kv_dtype="int8")):
// * _stream_impl (:125, call :222; the int8 branch :141-163), behind
//   attn_impl="ragged": B1 over fp pools, B2 over int8 pools;
// * _gather_impl (:232, call :314), behind attn_impl="ragged_gather", the
//   A/B body beside it: B3;
// * and sharded_ragged_paged_attention (:377, shard_map at :470), B4,
//   which runs the unchanged kernel on every shard of an (mp, dp) serving
//   mesh: here one launch covers every rank that shares a card.
//
// What it computes, per slot b and head h: score the query lanes against
// the slot's K rows, mask position j*bs + r > pos + s, and run the flash
// online-softmax recurrence (running max m, normalizer l, accumulator acc
// rescaled by exp(m_old - m_new), masked probabilities exactly 0).  The
// output is acc / l in q's dtype, and lanes >= width are written as 0.
// With int8 pools each row is dequantized as (float)code * scale[block,
// h], the scale read once per row of a piece, so the pool is never
// dequantized whole.  The two bodies differ in the rows they walk:
// * the stream body (ragged_paged_attn_kernel) walks the slot's table up
//   to the causal horizon n_live = min(nb, (pos + max(width, 1) - 1) / bs
//   + 1), since every block past it is fully masked;
// * the gather body (ragged_gather_attn_kernel) reads and scores EVERY
//   table entry of a slot with a real lane (n_live = nb), the TPU gather
//   kernel's defined work (it gathers the whole row of L = nb * bs
//   positions and takes one softmax over it), which is what makes it the
//   baseline the stream body is measured against.  A piece wholly past
//   the horizon keeps m = -1e30 and l = 0, so its merge factor
//   exp2(-1e30 - max) is exactly 0; piece 0 holds position 0, visible to
//   every lane, so the normalizer is positive.  Allclose to one softmax
//   over the row, not bitwise: the pieces sum in another order.
//
// What bounds it on an H100: bytes.  Each walked K/V row is read once per
// head, q and the output once; the arithmetic is about 4 * lanes * hd
// flops per K/V row, far below the card's ~20 flop/byte fp32 balance
// point, so the floor is the walked K/V bytes over 3.35 TB/s (a quarter
// of them for int8 codes, plus the scale rows).
//
// What the design does about it: the walk is split, so that a long slot
// no longer sets the launch's time alone.
// * Pieces.  A slot's table splits into pieces of G = kPieceRows / bs
//   paged blocks (G = 1 for bs >= kPieceRows).  The grid is (R*B*H,
//   pieces) with pieces = ceil(nb / G): the split depends on the table's
//   length and the block size only, never on the ranks, B, H or the card,
//   so a launch over some of a batch's slots or heads (a mesh rank's)
//   computes every (slot, head) in the same order, bitwise.  A piece past
//   the rows its slot walks exits at once.
// * A piece stages its rows into shared memory with cp.async, in the
//   pool's own type (int8 codes stay int8 there), one commit group per 32
//   rows; the first pass over the rows waits for each group as it lands,
//   so loads overlap arithmetic, and the other blocks on the SM overlap
//   the rest (two or three at hd=64: shared memory holds fp32 pools to
//   two, registers int8 pools).
// * Four warps split the lanes: warp i takes the 16-lane blocks i, i + 4,
//   ..., so a 64-lane prefill chunk runs on all four and a decode lane
//   (width 1) on one warp, which walks the piece alone.  In a warp, a
//   thread owns 4 lanes x 4 rows of each 32-row step's scores (lanes
//   lg + 4 i, rows rg + 8 j, so the four lanes' q rows and the eight
//   threads' K rows fall in distinct banks) and 4 lanes x hd/8 columns of
//   the accumulator.  The online softmax lives in registers: a lane's
//   step max by three shuffles over its 8 row-group threads, its l as a
//   per-thread partial sum reduced once at the end of the piece, and each
//   probability broadcast to the accumulator's owners by a shuffle.
// * fp32 stays on CUDA-core FMAs (TF32 would break the fp32 tolerances),
//   and so does bf16.
// * Combine, in the same launch.  A slot with one walked piece (a stream
//   slot's decode lane up to kPieceRows of context, every slot of a short
//   table) writes its output and the zeros past width directly.
//   Otherwise each piece writes its partial (m, l, acc) per lane into an
//   f32 workspace that the caller allocates ([R*B*H, pieces, W, hd],
//   [R*B*H, pieces, W, 2], then [R*B*H, pieces, W] for the merge's
//   factors) and adds one to its (slot, head)'s counter; the piece that
//   brings the counter to the walked piece count merges every piece in
//   piece order (so the result does not depend on which piece finished
//   last), writes the zeros past width and sets the counter back to 0 for
//   the next launch.
// * Rank groups (B4).  One launch covers up to kMaxRanks mesh ranks that
//   share a card, each with its own q, pools and scales (RankArgs, passed
//   by value) and its dp index d; the grid's first dimension runs over
//   (rank, slot, head).  The block tables, pos and width are the whole
//   batch's: rank r's slot b is global slot d * B + b, and a table entry
//   (a GLOBAL block id) is localized to the rank's pool shard as it is
//   read, entry - d * nb_local.  An unsharded call is a group of one rank
//   with d = 0.  Each (slot, head) runs the same pieces in the same order
//   as in the unsharded launch, so the mesh's result is bitwise the
//   unsharded one.
// The kernel is templated over (q/out type, pool type, head dim, body):
// the fp and int8 legs share every line but the dequantizing multiplies,
// and the two bodies every line but the rows they walk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;    // four warps
constexpr int kPieceRows = 128;  // K/V rows a piece walks (G = this / bs)
constexpr int kStepRows = 32;    // rows of one step: 8 row groups x 4
constexpr int kLaneBlock = 16;   // lanes a warp carries: 4 lane groups x 4
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRanks = 8;     // mesh ranks one launch covers

// Each rank's operands in a group launch: q [B, W, H, hd], the pools
// [NB_local * bs, H, hd] and, for int8 pools, the scales [NB_local, H];
// d is the rank's dp index.
struct RankArgs {
  const void* q[kMaxRanks];
  const void* k[kMaxRanks];
  const void* v[kMaxRanks];
  const float* k_scale[kMaxRanks];
  const float* v_scale[kMaxRanks];
  int d[kMaxRanks];
};

__host__ __device__ inline int piece_blocks(int bs) {
  return bs >= kPieceRows ? 1 : kPieceRows / bs;
}
__host__ __device__ inline int n_pieces(int nb, int bs) {
  const int g = piece_blocks(bs);
  return (nb + g - 1) / g;
}
__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}
// rows of a piece's staging buffers: whole steps
__host__ __device__ inline int staged_rows(int bs) {
  const int r = piece_blocks(bs) * bs;
  return (r + kStepRows - 1) / kStepRows * kStepRows;
}

// Shared memory in bytes: q lanes [round16(W)][hd + 4] f32, K rows
// [rows][hd + 16 / elem] and V rows [rows][hd] in the pool's type, and the
// rows' dequantization scales (int8) [2][rows] f32.
__host__ __device__ inline size_t smem_bytes(int W, int hd, int bs,
                                             int elem) {
  const size_t R = staged_rows(bs);
  const size_t wp = (W + kLaneBlock - 1) / kLaneBlock * kLaneBlock;
  return align16(wp * (hd + 4) * 4) + align16(R * (hd * elem + 16)) +
         align16(R * hd * elem) + 2 * R * 4;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

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

// four consecutive elements of shared memory as f32 (aligned to 4 elements)
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* o) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}
__device__ __forceinline__ void ld4(const int8_t* p, float* o) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  o[0] = (float)x.x, o[1] = (float)x.y, o[2] = (float)x.z, o[3] = (float)x.w;
}
template <int N, typename P>
__device__ __forceinline__ void ldn(const P* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) ld4(p + i, o + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_float(p[i]);
  }
}

// N bytes from global src to shared dst, or N zero bytes when !valid
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of this thread's groups are pending (at most 3:
// waiting for fewer is only stricter).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One (rank, slot, head, piece) a block.  B and H are a rank's slots and
// heads; scale_log2 = log2(e) / sqrt(hd).  kGather: walk every table
// entry (B3), else up to the causal horizon (B1, B2).
template <typename T, typename P, int HD, bool kGather>
__device__ __forceinline__ void attn_body(
    const RankArgs& ra, const int* __restrict__ tables,
    const int* __restrict__ pos, const int* __restrict__ width,
    T* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
    int B, int W, int H, int bs, int nb, int nb_local, float scale_log2) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int QS = HD + 4;                // q row stride, floats
  constexpr int KS = HD + 16 / sizeof(P);   // K row stride, elements
  constexpr int CPT = HD / 8;               // accumulator columns a thread
  constexpr int RB = HD * sizeof(P);        // bytes of a pool row
  constexpr int CHUNK = RB < 16 ? RB : 16;  // cp.async size
  constexpr int CPR = RB / CHUNK;           // chunks a row
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ bool merges;  // this piece finished its (slot, head) last

  // bg: the slot's row in the group's output [R*B, W, H, hd]
  const int bh = blockIdx.x, bg = bh / H, h = bh % H, c = blockIdx.y;
  const int rk = bg / B, b = bg % B, dp_i = ra.d[rk];
  const int slot = dp_i * B + b;                  // in the whole batch
  const int64_t blk_base = (int64_t)dp_i * nb_local;  // the shard's first
  const T* __restrict__ q = static_cast<const T*>(ra.q[rk]);
  const P* __restrict__ k = static_cast<const P*>(ra.k[rk]);
  const P* __restrict__ v = static_cast<const P*>(ra.v[rk]);
  const float* __restrict__ k_scale = ra.k_scale[rk];
  const float* __restrict__ v_scale = ra.v_scale[rk];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = piece_blocks(bs), NP = n_pieces(nb, bs);
  const int p = pos[slot];
  const int w = min(max(width[slot], 0), W);
  // the walked blocks: every entry, or up to the causal horizon; a parked
  // width-0 slot walks nothing and writes zeros
  const int n_live =
      kGather ? nb : min(nb, (p + max(w, 1) - 1) / bs + 1);
  const int n_pc = (n_live + G - 1) / G;
  const bool direct = n_pc == 1 || w == 0;
  const int64_t hs = (int64_t)H * HD;  // row stride of q, out and pools
  if (c >= n_pc || (w == 0 && c > 0)) return;
  if (direct) {  // the zeros past width
    for (int i = tid; i < (W - w) * HD; i += kThreads) {
      const int s = w + i / HD, d = i % HD;
      out[((int64_t)bg * W + s) * hs + (int64_t)h * HD + d] =
          from_float<T>(0.f);
    }
    if (w == 0) return;
  }

  const int wp = (W + kLaneBlock - 1) / kLaneBlock * kLaneBlock;
  const int R = staged_rows(bs);
  float* q_s = reinterpret_cast<float*>(smem);
  P* k_s = reinterpret_cast<P*>(smem + align16((size_t)wp * QS * 4));
  P* v_s = reinterpret_cast<P*>(reinterpret_cast<uint8_t*>(k_s) +
                                align16((size_t)R * KS * sizeof(P)));
  float* ks_row = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(v_s) +
                                           align16((size_t)R * HD * sizeof(P)));
  float* vs_row = ks_row + R;

  const int row0 = c * G * bs;                  // the piece's first row
  const int rows = min(G * bs, n_live * bs - row0);  // its live rows
  const int n_steps = (rows + kStepRows - 1) / kStepRows;

  // q of the real lanes as f32, zeros up to the lane blocks' end
  for (int i = tid; i < wp * HD; i += kThreads) {
    const int s = i / HD, d = i % HD;
    q_s[s * QS + d] =
        s < w ? to_float(q[((int64_t)b * W + s) * hs + (int64_t)h * HD + d])
              : 0.f;
  }
  // K/V rows, one cp.async group a step; rows past the live ones are zeros
  const int* table = tables + (int64_t)slot * nb;
  for (int st = 0; st < n_steps; ++st) {
    for (int i = tid; i < kStepRows * CPR; i += kThreads) {
      const int r = st * kStepRows + i / CPR, ch = i % CPR;
      const bool live = r < rows;
      const int jb = (row0 + r) / bs;
      const int64_t blk = live ? table[jb] - blk_base : 0;
      const int64_t off =
          ((blk * bs + (row0 + r) - (int64_t)jb * bs) * hs + (int64_t)h * HD) *
              (int64_t)sizeof(P) + ch * CHUNK;
      const int64_t src = live ? off : 0;
      const uint8_t* ksrc = reinterpret_cast<const uint8_t*>(k) + src;
      const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(v) + src;
      cp_async<CHUNK>(reinterpret_cast<uint8_t*>(k_s + r * KS) + ch * CHUNK,
                      ksrc, live);
      cp_async<CHUNK>(reinterpret_cast<uint8_t*>(v_s + r * HD) + ch * CHUNK,
                      vsrc, live);
      if (kQuant && ch == 0) {
        ks_row[r] = live ? k_scale[blk * H + h] : 0.f;
        vs_row[r] = live ? v_scale[blk * H + h] : 0.f;
      }
    }
    cp_async_commit();
  }

  const int rg = lane & 7, lg = lane >> 3;
  const int n_lb = (w + kLaneBlock - 1) / kLaneBlock;
  float m[4], l[4], acc[4][CPT];

  auto init = [&] {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kMaskValue;
      l[i] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
    }
  };
  // one 32-row step of lane block lb: scores, online softmax, P V
  auto step = [&](int lb, int st) {
    const int l0 = lb * kLaneBlock + lg;  // lanes l0 + 4 i
    const int sr = st * kStepRows;        // rows sr + rg + 8 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld4(q_s + (l0 + 4 * i) * QS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) ld4(k_s + (sr + rg + 8 * j) * KS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lane_pos = p + l0 + 4 * i;
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr + rg + 8 * j;
        const bool vis = r < rows && row0 + r <= lane_pos;
        const float sc = kQuant ? scale_log2 * ks_row[r] : scale_log2;
        x[j] = vis ? s[i][j] * sc : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at -1e30
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = x[j] == -INFINITY ? 0.f : exp2f(x[j] - m_new);
        sum += e;
        pv[i][j] = kQuant ? e * vs_row[sr + rg + 8 * j] : e;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= corr;
    }
    // acc += P V: row sr + r's probabilities live in thread rg = r % 8,
    // register j = r / 8 of its lane group
#pragma unroll
    for (int r = 0; r < kStepRows; ++r) {
      float vv[CPT];
      ldn<CPT>(v_s + (sr + r) * HD + rg * CPT, vv);
      const int src = (lane & ~7) | (r & 7);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = __shfl_sync(0xffffffffu, pv[i][r >> 3], src);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
          acc[i][cc] = fmaf(pr, vv[cc], acc[i][cc]);
      }
    }
  };
  // lane block lb's result: the output (one live piece) or the partial
  auto finish = [&](int lb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
      const int s = lb * kLaneBlock + lg + 4 * i;
      if (s >= w) continue;
      if (direct) {
        T* o = out + ((int64_t)bg * W + s) * hs + (int64_t)h * HD + rg * CPT;
        const float inv = 1.f / l[i];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
          o[cc] = from_float<T>(acc[i][cc] * inv);
      } else {
        const int64_t at = ((int64_t)bh * NP + c) * W + s;
        float* a = ws + at * HD + rg * CPT;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) a[cc] = acc[i][cc];
        if (rg == 0) {
          float* ml = ws + (int64_t)gridDim.x * NP * W * HD + at * 2;
          ml[0] = m[i];
          ml[1] = l[i];
        }
      }
    }
  };

  // First pass: lane block `warp`, each step as soon as its rows landed
  // (every warp takes part in the barriers, with a lane block or not).
  const bool first = warp < n_lb;
  if (first) init();
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait_pending(n_steps - 1 - st);
    __syncthreads();
    if (first) step(warp, st);
  }
  if (first) finish(warp);
  // lanes past 64: the later lane blocks, over rows already staged
  for (int lb = warp + 4; lb < n_lb; lb += 4) {
    init();
    for (int st = 0; st < n_steps; ++st) step(lb, st);
    finish(lb);
  }
  if (direct) return;

  // The last piece of (slot, head) to finish merges them all.  Every
  // piece's partial is published (fence) before its count is.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    merges = atomicAdd(counters + bh, 1) == n_pc - 1;
    if (merges) counters[bh] = 0;
  }
  __syncthreads();
  if (!merges) return;
  __threadfence();
  // Other blocks' partials are read through L2 (__ldcg), never a stale
  // L1.  First each (lane, piece) pair's factor exp2(m - max) / l_sum, in
  // a slot of its own; then every output column as the pieces'
  // accumulators times their factors, summed in piece order.  Each
  // thread's loads over the pieces are independent, so they overlap.
  const int64_t n_part = (int64_t)gridDim.x * NP * W;  // partials a launch
  const float* ml = ws + n_part * HD;
  float* fac = ws + n_part * (HD + 2);
  const int64_t at0 = (int64_t)bh * NP * W;  // lane 0 of piece 0
  for (int i = tid; i < w * n_pc; i += kThreads) {
    const int s = i / n_pc, pc = i % n_pc;
    float mx = kMaskValue, lsum = 0.f;
#pragma unroll 8
    for (int k = 0; k < n_pc; ++k)
      mx = fmaxf(mx, __ldcg(ml + (at0 + k * W + s) * 2));
#pragma unroll 8
    for (int k = 0; k < n_pc; ++k) {
      const float* e = ml + (at0 + k * W + s) * 2;
      lsum += __ldcg(e + 1) * exp2f(__ldcg(e) - mx);
    }
    fac[at0 + pc * W + s] =
        exp2f(__ldcg(ml + (at0 + pc * W + s) * 2) - mx) / lsum;
  }
  __syncthreads();
  constexpr int C4 = HD / 4;  // float4 columns a lane
  for (int i = tid; i < W * C4; i += kThreads) {
    const int s = i / C4, c = i % C4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < w) {
#pragma unroll 8
      for (int pc = 0; pc < n_pc; ++pc) {
        const int64_t e = at0 + pc * W + s;
        const float f = __ldcg(fac + e);
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(ws + e * HD) + c);
        o.x = fmaf(x.x, f, o.x);
        o.y = fmaf(x.y, f, o.y);
        o.z = fmaf(x.z, f, o.z);
        o.w = fmaf(x.w, f, o.w);
      }
    }
    T* dst = out + ((int64_t)bg * W + s) * hs + (int64_t)h * HD + 4 * c;
    dst[0] = from_float<T>(o.x);
    dst[1] = from_float<T>(o.y);
    dst[2] = from_float<T>(o.z);
    dst[3] = from_float<T>(o.w);
  }
}

// The two bodies as kernels of their own names, apart in a profile.
#define RPA_PARAMS                                                        \
  const __grid_constant__ RankArgs ra, const int* __restrict__ tables,    \
      const int* __restrict__ pos, const int* __restrict__ width,         \
      T* __restrict__ out, float* __restrict__ ws,                        \
      int* __restrict__ counters, int B, int W, int H, int bs, int nb,    \
      int nb_local, float scale_log2
#define RPA_BODY_ARGS                                                     \
  ra, tables, pos, width, out, ws, counters, B, W, H, bs, nb, nb_local,   \
      scale_log2
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attn_kernel(RPA_PARAMS) {
  attn_body<T, P, HD, false>(RPA_BODY_ARGS);
}
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_gather_attn_kernel(RPA_PARAMS) {
  attn_body<T, P, HD, true>(RPA_BODY_ARGS);
}
#undef RPA_PARAMS
#undef RPA_BODY_ARGS

template <typename T, typename P, int HD>
const void* kernel_fn(bool gather) {
  return gather ? (const void*)ragged_gather_attn_kernel<T, P, HD>
                : (const void*)ragged_paged_attn_kernel<T, P, HD>;
}

template <typename T, typename P>
const void* kernel_hd(int hd, bool gather) {
  switch (hd) {
    case 8: return kernel_fn<T, P, 8>(gather);
    case 16: return kernel_fn<T, P, 16>(gather);
    case 32: return kernel_fn<T, P, 32>(gather);
    case 64: return kernel_fn<T, P, 64>(gather);
    case 128: return kernel_fn<T, P, 128>(gather);
  }
  return nullptr;
}

}  // namespace

// The piece kernels of each (q dtype, pool type) pair, every head dim and
// both bodies, behind a C function of their own.  ops/_build.py compiles
// this file once for each RPA_PART, in parallel, and links the objects:
// parts 0-3 instantiate one pair each (the bulk of the compile), part 4
// is the C interface below.
#ifndef RPA_PART
#error "compile with -DRPA_PART=0..4 (ops/_build.py)"
#endif

extern "C" {
const void* rpa_kernels_f32(int hd, int gather);
const void* rpa_kernels_f32_int8(int hd, int gather);
const void* rpa_kernels_bf16(int hd, int gather);
const void* rpa_kernels_bf16_int8(int hd, int gather);

#if RPA_PART == 0
const void* rpa_kernels_f32(int hd, int gather) {
  return kernel_hd<float, float>(hd, gather != 0);
}
#endif
#if RPA_PART == 1
const void* rpa_kernels_f32_int8(int hd, int gather) {
  return kernel_hd<float, int8_t>(hd, gather != 0);
}
#endif
#if RPA_PART == 2
const void* rpa_kernels_bf16(int hd, int gather) {
  return kernel_hd<__nv_bfloat16, __nv_bfloat16>(hd, gather != 0);
}
#endif
#if RPA_PART == 3
const void* rpa_kernels_bf16_int8(int hd, int gather) {
  return kernel_hd<__nv_bfloat16, int8_t>(hd, gather != 0);
}
#endif
}  // extern "C"

#if RPA_PART == 4
namespace {

// The piece kernel of (dtype, quant, hd, body): dtype 0 = float32, 1 =
// bfloat16 for q and out; quant = int8 pools with scales, else pools of
// q's dtype; gather = the gather body, else the stream body.
const void* kernel_of(int dtype, int quant, int hd, bool gather) {
  if (dtype == 0)
    return quant ? rpa_kernels_f32_int8(hd, gather)
                 : rpa_kernels_f32(hd, gather);
  if (dtype == 1)
    return quant ? rpa_kernels_bf16_int8(hd, gather)
                 : rpa_kernels_bf16(hd, gather);
  return nullptr;
}

}  // namespace

extern "C" {

// Pieces a slot's table of nb blocks of bs rows splits into (the grid's
// second dimension; the workspace holds this many partials a slot, head
// and lane).
int ragged_paged_attn_pieces(int nb, int bs) { return n_pieces(nb, bs); }

// Dynamic shared memory a block needs for these shapes at most, in bytes:
// with f32 pools (bf16 and int8 pools stage fewer bytes, and a launch
// asks for what its pool type needs).
size_t ragged_paged_attn_smem_bytes(int W, int hd, int bs) {
  return smem_bytes(W, hd, bs, 4);
}

// Raise the piece kernels' dynamic shared-memory limit to smem bytes, for
// both bodies and every head dim of (dtype, quant): called once per
// (dtype, quant, card) and again only when a config needs more, not before
// every launch.  Returns the CUDA error (0 on success).
int ragged_paged_attn_prepare(int dtype, int quant, int smem) {
  const int head_dims[] = {8, 16, 32, 64, 128};
  for (int gather = 0; gather < 2; ++gather) {
    for (int hd : head_dims) {
      const void* fn = kernel_of(dtype, quant, hd, gather);
      if (!fn) return (int)cudaErrorInvalidValue;
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// One launch over n_ranks (1 to kMaxRanks) ranks that share the card.
// dtype: 0 = float32, 1 = bfloat16 for q and out.  gather: 1 = the gather
// body (B3), 0 = the stream body (B1, B2).  ranks: 5 * n_ranks pointers,
// q, k, v, k_scale, v_scale of every rank in turn (q of rank r at
// ranks[r], k at ranks[n_ranks + r], ...).  Per rank r: q [B, W, H, hd];
// k, v [nb_local * bs, H, hd], 16-byte aligned, in q's dtype when k_scale
// and v_scale are null, else int8 codes with f32 scales [nb_local, H]
// (every rank alike); d[r] its dp index.  tables [n_slots,
// nb] of GLOBAL block ids (rank r's slot b is row d[r] * B + b, its entries
// are localized as entry - d[r] * nb_local), pos and width [n_slots]; all
// int32.  out [n_ranks * B, W, H, hd] in q's dtype.  ws: f32 workspace of
// n_ranks * B * H * pieces * W * (hd + 3) floats (ragged_paged_attn_pieces),
// and counters: int32 [n_ranks * B * H], all 0 (the launch leaves them 0,
// so one set serves every launch on a stream); both null when there is one
// piece.  hd is 8, 16, 32, 64 or 128.  An unsharded call is one rank with
// d = 0.  Returns cudaGetLastError() after the launch (0 on success).
int ragged_paged_attn_launch(int dtype, int gather, int n_ranks,
                             const void* const* ranks, const int* d,
                             const void* tables, const void* pos,
                             const void* width, void* out, void* ws,
                             void* counters, int B, int W, int H, int hd,
                             int bs, int nb, int nb_local, float scale,
                             void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxRanks) return (int)cudaErrorInvalidValue;
  const void* const* k_scale = ranks + 3 * n_ranks;
  const void* const* v_scale = ranks + 4 * n_ranks;
  const bool quant = k_scale[0] != nullptr;
  RankArgs ra = {};
  for (int r = 0; r < n_ranks; ++r) {
    if ((k_scale[r] != nullptr) != quant || (v_scale[r] != nullptr) != quant)
      return (int)cudaErrorInvalidValue;
    ra.q[r] = ranks[r];
    ra.k[r] = ranks[n_ranks + r];
    ra.v[r] = ranks[2 * n_ranks + r];
    ra.k_scale[r] = static_cast<const float*>(k_scale[r]);
    ra.v_scale[r] = static_cast<const float*>(v_scale[r]);
    ra.d[r] = d[r];
  }
  const int np = n_pieces(nb, bs);
  if (np > 1 && (ws == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_of(dtype, quant, hd, gather != 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int elem = quant ? 1 : (dtype == 0 ? 4 : 2);
  const size_t smem = smem_bytes(W, hd, bs, elem);
  float scale_log2 = scale * kLog2e;
  void* args[] = {&ra,  (void*)&tables, (void*)&pos, (void*)&width,
                  &out, &ws, &counters, &B, &W, &H, &bs, &nb, &nb_local,
                  &scale_log2};
  const cudaError_t err = cudaLaunchKernel(
      fn, dim3(n_ranks * B * H, np), dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // RPA_PART == 4
