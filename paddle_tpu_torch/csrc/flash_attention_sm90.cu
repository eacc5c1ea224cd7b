// Flash attention for Hopper's tensor cores (sm_90a), bf16 and fp16: the
// forward kernel (B5a), the dK/dV kernel (B5b) and the dQ kernel (B5c).
//
// Replaces, for bf16 and fp16 inputs at head dims 64 and 128, the three
// pallas_calls of the upstream TPU flash-attention kernel that
// paddle_tpu/nn/functional/attention.py (_flash_attention) calls,
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//   flash_fwd_sm90      <- _flash_attention_impl    (_flash_attention_kernel)
//   flash_bwd_dkv_sm90  <- _flash_attention_bwd_dkv (_flash_attention_dkv_kernel)
//   flash_bwd_dq_sm90   <- _flash_attention_bwd_dq  (_flash_attention_dq_kernel)
// float32 inputs keep the scalar kernels of flash_attention.cu.
//
// Contract, as flash_attention.cu's: q, k, v, o, do, dq, dk, dv contiguous
// [B, S, H, D] in one element type T, bf16 or fp16 (every kernel is a
// template over T: wgmma takes .bf16 and .f16 operands at the same shapes,
// and the TMA maps name the element type); lse and di f32 [B, H, S]; segment ids int32 [B, S] or
// null; one length S for q and k, a multiple of 64; masks causal (key j
// visible to query i iff j <= i) and segment ids, combined.
//
// What bounds it: at the training slice (B=4, H=16, S=2048, D=128) the
// forward does 6.9e10 causal FLOPs, dK/dV 1.37e11 and dQ 1.03e11, so the
// tensor cores' 989 TFLOP/s set the bounds (0.0695, 0.139 and 0.104 ms),
// well above HBM's (0.04 ms).  The design follows from that:
// * Every product of a tile runs on the tensor cores as wgmma m64nNk16,
//   T operands and f32 accumulators in registers, one consumer
//   warpgroup per 64 rows.  Rounding P and dS to T before their
//   products is what the TPU kernel does (p.astype(v.dtype),
//   ds.T.astype(do.dtype), ds.astype(k.dtype)).  In fp16 the rounded P is
//   at most 1 and the scores stay in f32, so only dS and the outputs can
//   leave fp16's range, as they can in the TPU kernel's fp16.
// * Q K^T (forward, dQ), K Q^T and V dO^T (dK/dV) and dO V^T (dQ) read both
//   operands from shared memory, K-major.  P V, P^T dO, dS^T Q and dS K
//   take P, P^T, dS^T, dS as the register A operand, converted from the
//   first product's accumulator with no shuffle (its row/column layout is
//   the A fragment's), and V, dO, Q, K as an MN-major B operand (the
//   descriptor's transpose bit), one m64n64 product per 64-column atom.
// * Warp specialization: a producer warpgroup, of which one thread issues
//   every copy (TMA boxes of 64 columns x 64 or 128 rows through 4-d
//   tensor maps over [B, S, H, D], so the H*D row stride costs nothing and
//   rows past S arrive as zeros), and two consumer warpgroups; setmaxnreg
//   moves registers from the producer (24) to the consumers (240).  Tiles
//   land as T in the 128-byte swizzle that wgmma reads without bank
//   conflicts, in a ring of two stages handed over by mbarriers (full:
//   the copies' bytes arrived; empty: every consumer warp is done).
// * Forward: tile kt's Q K^T is issued together with tile kt-1's P V, and
//   tile kt's softmax runs while they execute; the two consumer
//   warpgroups take turns issuing (named barriers), so one's softmax
//   overlaps the other's products.
// * Softmax in registers in the log2 domain: the raw row max, then
//   p = exp2(s * sm_scale log2 e - m) as one FFMA and one ex2; a row's
//   four owner threads reduce its max by two shuffles, its sum once, at
//   the end.  The backward kernels know lse, so p = exp2(s * sm_scale
//   log2 e - lse log2 e) needs no max at all.
// * Masks only on the tiles that need them (the causal diagonal, segment
//   ids, the ragged last k tile), in a separately compiled path.  A masked
//   score is -inf in the forward and a masked probability is selected to 0
//   in the backward kernels, so either is exactly 0; m starts at -1e30 and
//   stays finite, and a fully masked tile adds nothing.
// * Grid (B*H, tiles), the tile from blockIdx.y: all heads' longest causal
//   tiles (the forward's and dQ's last q tiles, dK/dV's first k tiles)
//   launch first, so the grid's tail is short work.
// * dQ is a kernel of its own, as upstream's is: each block owns its q
//   rows' dQ and writes it once, with no atomics, so the result does not
//   depend on the schedule.
//
// Forward: 384 threads per 128-row q tile (64 rows a consumer), k tiles of
// 128 rows; dK/dV: 384 threads per 128-row k tile (64 rows a consumer), q
// tiles of 64 rows; dQ: 384 threads per 128-row q tile (64 rows a
// consumer), k tiles of 64 rows.  Shared memory at D=128: 166,472 B
// (forward), 134,184 B (dK/dV) and 132,648 B (dQ): one block per SM.  The
// consumers' registers hold the forward's S 64 + O 64 floats and two P sets
// of 32, dK/dV's dK 64 + dV 64 + S^T 32 + dP^T 32 floats a thread, and
// dQ's dQ 64 + S 32 + dP 32 floats and a dS set of 16 words.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using fp16 = __half;

// dtype codes of the C entry points (ops/flash_attention.py _DTYPE_CODE)
constexpr int kCodeBf16 = 1;
constexpr int kCodeFp16 = 2;

template <typename T>
constexpr bool kIsHalf = std::is_same<T, fp16>::value;

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// -- PTX helpers -------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over `count` threads: wait there, or arrive and go on.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Pins an accumulator's registers at this point of the program, so that
// the compiler moves none of their reads or writes across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(d[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to T (nearest even) as one 32-bit word, lo in the low
// half: the register A operand of a wgmma, and a paired output store.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<T>(lo, hi);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile starting at
// addr (the swizzle atom's 1024-byte alignment is the caller's): LBO and
// SBO in bytes.  K-major: SBO is the stride between 8-row groups (1024),
// LBO unused.  MN-major: LBO is the stride between 64-element column
// atoms, SBO between 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// -- wgmma -------------------------------------------------------------------
// The accumulator operand lists of the wgmma shapes used here.
#define WG_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_D64                                                              \
  WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),  \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),      \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),      \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),      \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),      \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),      \
      "+f"(d[62]), "+f"(d[63])
#define WG_R32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define WG_R64                                                              \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
         "%57, %58, %59, %60, %61, %62, %63"

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B in shared memory, both
// K-major; TY ("bf16" or "f16") in, f32 accumulators.
#define WGMMA_SS_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
               WG_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                     \
               : WG_D32                                                      \
               : "l"(da), "l"(db), "r"(accumulate))
// D[64 x 128] (+)= A[64 x 16] B[16 x 128], as WGMMA_SS_N64.
#define WGMMA_SS_N128(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
               WG_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                      \
               : WG_D64                                                       \
               : "l"(da), "l"(db), "r"(accumulate))
// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (T pairs in the
// accumulator's row/column layout), B in shared memory, MN-major.
#define WGMMA_RS_N64(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
               WG_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"       \
               : WG_D32                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B in shared memory, both
// K-major; T in, f32 accumulators.  accumulate = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (kIsHalf<T>)
    WGMMA_SS_N64("f16");
  else
    WGMMA_SS_N64("bf16");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B in shared memory, both
// K-major; T in, f32 accumulators.  accumulate = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (kIsHalf<T>)
    WGMMA_SS_N128("f16");
  else
    WGMMA_SS_N128("bf16");
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (T pairs in the
// accumulator's row/column layout), B in shared memory, MN-major.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (kIsHalf<T>)
    WGMMA_RS_N64("f16");
  else
    WGMMA_RS_N64("bf16");
}

// acc[D/64][32] += A (registers, 64 x 16) B, where B is 16 rows of a
// swizzled [D/64 atoms][rows][64] tile, MN-major: one m64n64k16 product per
// 64-column atom (the LBO field of the descriptor is then never read).
template <typename T, int NA>
__device__ __forceinline__ void wgmma_rs_atoms(float (&acc)[NA][32],
                                               const uint32_t (&a)[4],
                                               uint32_t b_addr,
                                               uint32_t atom_bytes) {
#pragma unroll
  for (int hh = 0; hh < NA; ++hh)
    wgmma_rs_n64<T>(acc[hh], a,
                    desc_sw128(b_addr + hh * atom_bytes, 16, 1024));
}

// -- mbarriers and TMA --------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The producer's arrival, announcing `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// One box of a 4-d tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// bytes (a multiple of 16) from global src into shared dst; completes on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- forward ------------------------------------------------------------------
// A producer warpgroup (one thread issues every TMA copy) and two consumer
// warpgroups of 64 q rows each; the ring of K and V stages is handed over
// by mbarriers.
constexpr int kFwdThreads = 384;
constexpr int kFwdBM = 128;  // q rows a block (64 a consumer warpgroup)
constexpr int kFwdBN = 128;  // k rows a tile

template <int D>
struct FwdSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t kTile = kFwdBN * D * 2;  // 128 rows, Q's too
  static constexpr uint32_t kQ = 0;
  __host__ __device__ static constexpr uint32_t k_k(int st) {
    return kTile + st * 2 * kTile;
  }
  __host__ __device__ static constexpr uint32_t k_v(int st) {
    return k_k(st) + kTile;
  }
  static constexpr uint32_t kSegQ = 5 * kTile;
  __host__ __device__ static constexpr uint32_t seg_k(int st) {
    return kSegQ + 512 + st * 512;
  }
  // mbarriers: Q full; K full, V full, K empty, V empty per stage
  static constexpr uint32_t kBarQ = kSegQ + 3 * 512;
  __host__ __device__ static constexpr uint32_t bar(int kind, int st) {
    return kBarQ + 8 + 16 * kind + 8 * st;
  }
  static constexpr uint32_t kBytes = kBarQ + 8 + 4 * 16 + 1024;
};
enum { kKFull, kVFull, kKEmpty, kVEmpty };

template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          const int* __restrict__ seg, T* __restrict__ o,
                          float* __restrict__ lse, int H, int S, int causal,
                          float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (S + kFwdBM - 1) / kFwdBM;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kFwdBM;
  const int n_kt = causal ? qt + 1 : (S + kFwdBN - 1) / kFwdBN;
  const bool has_seg = seg != nullptr;
  // S is a multiple of 64: the second consumer's rows are all past S or
  // all real
  const int n_consumers = q0 + 64 < S ? 2 : 1;

  if (tid == 0) {
    mbar_init(base + L::kBarQ, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(base + L::bar(kKFull, st), 1);
      mbar_init(base + L::bar(kVFull, st), 1);
      // each consumer warp releases a stage it has read
      mbar_init(base + L::bar(kKEmpty, st), 4 * n_consumers);
      mbar_init(base + L::bar(kVEmpty, st), 4 * n_consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid != 0) return;
    const uint32_t seg_q_bytes = has_seg ? min(kFwdBM, S - q0) * 4 : 0;
    mbar_expect_tx(base + L::kBarQ, L::kTile + seg_q_bytes);
    for (int a = 0; a < D / 64; ++a)
      tma_load_4d(base + L::kQ + a * (kFwdBM * 128), &tq, base + L::kBarQ,
                  64 * a, h, q0, b);
    if (has_seg)
      bulk_load(base + L::kSegQ, seg + (size_t)b * S + q0, seg_q_bytes,
                base + L::kBarQ);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt & 1, parity = ((kt >> 1) & 1) ^ 1;
      const int k0 = kt * kFwdBN;
      const uint32_t seg_k_bytes = has_seg ? min(kFwdBN, S - k0) * 4 : 0;
      mbar_wait(base + L::bar(kKEmpty, st), parity);
      mbar_expect_tx(base + L::bar(kKFull, st), L::kTile + seg_k_bytes);
      for (int a = 0; a < D / 64; ++a)
        tma_load_4d(base + L::k_k(st) + a * (kFwdBN * 128), &tk,
                    base + L::bar(kKFull, st), 64 * a, h, k0, b);
      if (has_seg)
        bulk_load(base + L::seg_k(st), seg + (size_t)b * S + k0, seg_k_bytes,
                  base + L::bar(kKFull, st));
      mbar_wait(base + L::bar(kVEmpty, st), parity);
      mbar_expect_tx(base + L::bar(kVFull, st), L::kTile);
      for (int a = 0; a < D / 64; ++a)
        tma_load_4d(base + L::k_v(st) + a * (kFwdBN * 128), &tv,
                    base + L::bar(kVFull, st), 64 * a, h, k0, b);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = wg - 1;  // consumer warpgroup: q rows q0 + 64 cw ..
  if (cw >= n_consumers) return;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int* seg_q = reinterpret_cast<const int*>(gbase + L::kSegQ);
  // This warpgroup's 64 rows start at qw0; this thread owns rows row0 and
  // row0 + 8, and in each 8-column chunk of a tile the columns cq, cq + 1.
  const int qw0 = q0 + 64 * cw;
  const int row0 = qw0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  // O: column chunk j (8 columns) of the 64-column atom hh is
  // oacc[hh][4 j .. 4 j + 3]
  float oacc[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[hh][i] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};

  // Ping-pong of the two consumer warpgroups on named barriers 1 and 2: a
  // warpgroup issues its products only after the other has issued its
  // own, so that one's softmax runs while the other's products do.
  const bool pingpong = n_consumers == 2;
  auto my_turn = [&] {
    if (pingpong) named_bar_sync(1 + cw, 256);
  };
  auto their_turn = [&] {
    if (pingpong) named_bar_arrive(2 - cw, 256);
  };
  if (pingpong && cw == 1) named_bar_arrive(1, 256);

  // S = Q K^T over D in steps of 16 (four steps a 64-column atom)
  auto issue_qk = [&](float (&s)[kFwdBN / 2], int st) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t step = (ks % 4) * 32;
      const uint64_t da = desc_sw128(
          base + L::kQ + (ks / 4) * (kFwdBM * 128) + cw * (64 * 128) + step,
          16, 1024);
      const uint64_t db = desc_sw128(
          base + L::k_k(st) + (ks / 4) * (kFwdBN * 128) + step, 16, 1024);
      wgmma_ss_n128<T>(s, da, db, ks > 0);
    }
    wgmma_commit();
  };
  // O += P V over the tile's keys in steps of 16 rows of V
  auto issue_pv = [&](const uint32_t (&pa)[kFwdBN / 16][4], int st) {
#pragma unroll
    for (int kk = 0; kk < kFwdBN / 16; ++kk)
      wgmma_rs_atoms<T>(oacc, pa[kk], base + L::k_v(st) + kk * (16 * 128),
                     kFwdBN * 128);
    wgmma_commit();
  };
  // Online softmax of tile kt's raw scores (log2 domain: m is the row
  // max times sm_scale log2 e): P (T, the A operand of P V) and the
  // rescale of the rows' earlier sums.  Masked scores become -inf, whose
  // exp2 is exactly 0; m starts at -1e30 and stays finite.  Releases the
  // tile's K once its segment ids are read.
  auto softmax = [&](auto masked, float (&s)[kFwdBN / 2], int kt,
                     uint32_t (&pa)[kFwdBN / 16][4], float (&corr)[2]) {
    const int k0 = kt * kFwdBN, st = kt & 1;
    if constexpr (decltype(masked)::value) {
      const int* seg_k = reinterpret_cast<const int*>(gbase + L::seg_k(st));
#pragma unroll
      for (int j = 0; j < kFwdBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + cq + (e & 1);
          const int qi = row0 + 8 * (e >> 1);
          const bool vis = kj < S && (!causal || kj <= qi) &&
                           (!has_seg || seg_k[kj - k0] == seg_q[qi - q0]);
          if (!vis) s[4 * j + e] = -INFINITY;
        }
      }
    }
    if (lane == 0) mbar_arrive(base + L::bar(kKEmpty, st));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kFwdBN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int kk = 0; kk < kFwdBN / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // elements 8 kk + 2 i (+1) of s: row i & 1, chunk 2 kk + i / 2
        const float mi = m[i & 1];
        const float p0 = ex2(fmaf(s[8 * kk + 2 * i], scale_log2, -mi));
        const float p1 = ex2(fmaf(s[8 * kk + 2 * i + 1], scale_log2, -mi));
        l[i & 1] += p0 + p1;
        pa[kk][i] = pack2<T>(p0, p1);
      }
    }
  };
  // the causal diagonal, the ragged last tile and segment ids need masks
  auto softmax_tile = [&](float (&s)[kFwdBN / 2], int kt,
                          uint32_t (&pa)[kFwdBN / 16][4], float (&corr)[2]) {
    const int k0 = kt * kFwdBN;
    if (has_seg || k0 + kFwdBN > S || (causal && k0 + kFwdBN - 1 > qw0))
      softmax(Bool<true>(), s, kt, pa, corr);
    else
      softmax(Bool<false>(), s, kt, pa, corr);
  };

  // Tile kt's Q K^T is issued with tile kt-1's P V, and its softmax runs
  // while P V does; O takes tile kt's rescale once P V is done.  P
  // alternates between two register sets, tile kt's in pa[kt % 2], so
  // that no copy defines a product's operand.
  uint32_t pa0[kFwdBN / 16][4], pa1[kFwdBN / 16][4];
  float corr[2];
  auto step = [&](int kt, uint32_t (&pa)[kFwdBN / 16][4],
                  uint32_t (&pa_next)[kFwdBN / 16][4]) {
    const int st = kt & 1, pst = st ^ 1;
    float s[kFwdBN / 2];
    mbar_wait(base + L::bar(kKFull, st), (kt >> 1) & 1);
    mbar_wait(base + L::bar(kVFull, pst), ((kt - 1) >> 1) & 1);
    fence_regs(pa);
    fence_regs(oacc);
    my_turn();
    wgmma_fence();
    issue_qk(s, st);
    issue_pv(pa, pst);
    their_turn();
    wgmma_wait<1>();
    fence_regs(s);
    softmax_tile(s, kt, pa_next, corr);
    wgmma_wait<0>();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(base + L::bar(kVEmpty, pst));
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[hh][i] *= corr[(i >> 1) & 1];
  };
  auto last_pv = [&](uint32_t (&pa)[kFwdBN / 16][4]) {
    const int last = n_kt - 1, st = last & 1;
    mbar_wait(base + L::bar(kVFull, st), (last >> 1) & 1);
    fence_regs(pa);
    fence_regs(oacc);
    my_turn();
    wgmma_fence();
    issue_pv(pa, st);
    // the second warpgroup's last hand-over would have no taker
    if (cw == 0) their_turn();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(base + L::bar(kVEmpty, st));
  };

  mbar_wait(base + L::kBarQ, 0);
  {
    float s[kFwdBN / 2];
    mbar_wait(base + L::bar(kKFull, 0), 0);
    my_turn();
    wgmma_fence();
    issue_qk(s, 0);
    their_turn();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, 0, pa0, corr);
  }
  for (int kt = 1; kt < n_kt; kt += 2) {
    step(kt, pa0, pa1);
    if (kt + 1 < n_kt) step(kt + 1, pa1, pa0);
  }
  if ((n_kt - 1) & 1)
    last_pv(pa1);
  else
    last_pv(pa0);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    const float inv = 1.f / l[r];
    T* orow = o + ((size_t)(b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(orow + 8 * j + cq, oacc[j / 8][4 * (j % 8) + 2 * r] * inv,
                oacc[j / 8][4 * (j % 8) + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[((size_t)b * H + h) * S + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// -- dK/dV --------------------------------------------------------------------
// A producer warpgroup (one thread issues every copy) and two consumer
// warpgroups of 64 k rows each; the ring of q tiles (Q, dO, lse, di) is
// handed over by mbarriers.
constexpr int kBwdThreads = 384;
constexpr int kBwdBN = 128;  // k rows a block (64 a consumer warpgroup)
constexpr int kBwdBM = 64;   // q rows a tile

template <int D>
struct DkvSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kBwdBN * D * 2;
  static constexpr uint32_t kTile = kBwdBM * D * 2;
  static constexpr uint32_t kQ0 = 2 * kBwdBN * D * 2;  // Q, dO of stage 0, 1
  __host__ __device__ static constexpr uint32_t k_q(int st) {
    return kQ0 + st * 2 * kTile;
  }
  __host__ __device__ static constexpr uint32_t k_do(int st) {
    return k_q(st) + kTile;
  }
  // per stage: lse, di, q segment ids (64 words each)
  static constexpr uint32_t kSmall0 = kQ0 + 4 * kTile;
  __host__ __device__ static constexpr uint32_t k_lse(int st) {
    return kSmall0 + st * 768;
  }
  __host__ __device__ static constexpr uint32_t k_di(int st) {
    return k_lse(st) + 256;
  }
  __host__ __device__ static constexpr uint32_t k_segq(int st) {
    return k_lse(st) + 512;
  }
  static constexpr uint32_t kSegK = kSmall0 + 2 * 768;
  // mbarriers: K and V full; per stage, q tile full and empty
  static constexpr uint32_t kBarKV = kSegK + 512;
  __host__ __device__ static constexpr uint32_t bar_full(int st) {
    return kBarKV + 8 + 8 * st;
  }
  __host__ __device__ static constexpr uint32_t bar_empty(int st) {
    return kBarKV + 24 + 8 * st;
  }
  static constexpr uint32_t kBytes = kBarKV + 40 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_sm90_kernel(
        __grid_constant__ const CUtensorMap tq,
        __grid_constant__ const CUtensorMap tk,
        __grid_constant__ const CUtensorMap tv,
        __grid_constant__ const CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ di,
        const int* __restrict__ seg, T* __restrict__ dk,
        T* __restrict__ dv, int H, int S, int causal, float scale,
        float scale_log2) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kBwdBN;
  const int q_begin = causal ? k0 / kBwdBM : 0;
  const int n_qt = S / kBwdBM;
  const bool has_seg = seg != nullptr;
  // S is a multiple of 64: the second consumer's k rows are all past S or
  // all real
  const int n_consumers = k0 + 64 < S ? 2 : 1;

  if (tid == 0) {
    mbar_init(base + L::kBarKV, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(base + L::bar_full(st), 1);
      // each consumer warp releases a stage it has read
      mbar_init(base + L::bar_empty(st), 4 * n_consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid != 0) return;
    const size_t row_bh = ((size_t)b * H + h) * S;  // lse / di of (b, h)
    const uint32_t seg_k_bytes = has_seg ? min(kBwdBN, S - k0) * 4 : 0;
    mbar_expect_tx(base + L::kBarKV, 2 * kBwdBN * D * 2 + seg_k_bytes);
    for (int a = 0; a < D / 64; ++a) {
      tma_load_4d(base + L::kK + a * (kBwdBN * 128), &tk, base + L::kBarKV,
                  64 * a, h, k0, b);
      tma_load_4d(base + L::kV + a * (kBwdBN * 128), &tv, base + L::kBarKV,
                  64 * a, h, k0, b);
    }
    if (has_seg)
      bulk_load(base + L::kSegK, seg + (size_t)b * S + k0, seg_k_bytes,
                base + L::kBarKV);
    for (int qt = q_begin; qt < n_qt; ++qt) {
      const int it = qt - q_begin, st = it & 1;
      const int q0 = qt * kBwdBM;
      mbar_wait(base + L::bar_empty(st), ((it >> 1) & 1) ^ 1);
      const uint32_t full = base + L::bar_full(st);
      mbar_expect_tx(full, 2 * L::kTile + 512 + (has_seg ? 256 : 0));
      for (int a = 0; a < D / 64; ++a) {
        tma_load_4d(base + L::k_q(st) + a * (kBwdBM * 128), &tq, full,
                    64 * a, h, q0, b);
        tma_load_4d(base + L::k_do(st) + a * (kBwdBM * 128), &tdo, full,
                    64 * a, h, q0, b);
      }
      bulk_load(base + L::k_lse(st), lse + row_bh + q0, 256, full);
      bulk_load(base + L::k_di(st), di + row_bh + q0, 256, full);
      if (has_seg)
        bulk_load(base + L::k_segq(st), seg + (size_t)b * S + q0, 256, full);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = wg - 1;  // consumer warpgroup: k rows k0 + 64 cw ..
  if (cw >= n_consumers) return;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int* seg_k = reinterpret_cast<const int*>(gbase + L::kSegK);
  // This warpgroup's 64 k rows start at kw0; this thread owns k rows row0
  // and row0 + 8, and in each 8-column chunk of a q tile the columns cq
  // and cq + 1.
  const int kw0 = k0 + 64 * cw;
  const int row0 = kw0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  // dK, dV: column chunk j of the 64-column atom hh is [hh][4 j .. 4 j + 3]
  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[hh][i] = dv_acc[hh][i] = 0.f;

  mbar_wait(base + L::kBarKV, 0);
  for (int qt = q_begin; qt < n_qt; ++qt) {
    const int it = qt - q_begin, st = it & 1;
    const int q0 = qt * kBwdBM;
    mbar_wait(base + L::bar_full(st), (it >> 1) & 1);
    // causal: a q tile wholly above this warpgroup's keys adds nothing
    if (!(causal && q0 + kBwdBM - 1 < kw0)) {
      // S^T = K Q^T and dP^T = V dO^T over D in steps of 16
      float sacc[kBwdBM / 2], dpacc[kBwdBM / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t a_off = (ks / 4) * (kBwdBN * 128) + cw * (64 * 128) +
                               (ks % 4) * 32;
        const uint32_t b_off = (ks / 4) * (kBwdBM * 128) + (ks % 4) * 32;
        wgmma_ss_n64<T>(sacc, desc_sw128(base + L::kK + a_off, 16, 1024),
                     desc_sw128(base + L::k_q(st) + b_off, 16, 1024), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t a_off = (ks / 4) * (kBwdBN * 128) + cw * (64 * 128) +
                               (ks % 4) * 32;
        const uint32_t b_off = (ks / 4) * (kBwdBM * 128) + (ks % 4) * 32;
        wgmma_ss_n64<T>(dpacc, desc_sw128(base + L::kV + a_off, 16, 1024),
                     desc_sw128(base + L::k_do(st) + b_off, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);

      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - di);
      // masked entries are exactly 0
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::k_lse(st));
      const float* di_s = reinterpret_cast<const float*>(gbase + L::k_di(st));
      const int* seg_q = reinterpret_cast<const int*>(gbase + L::k_segq(st));
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < kBwdBM / 8; ++j) {
          const int qc = 8 * j + cq;
          const float2 lz = *reinterpret_cast<const float2*>(lse_s + qc);
          const float2 dz = *reinterpret_cast<const float2*>(di_s + qc);
          const float lse2[2] = {lz.x * kLog2e, lz.y * kLog2e};
          const float dis[2] = {dz.x, dz.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(sacc[4 * j + e], scale_log2, -lse2[e & 1]));
            if constexpr (decltype(masked)::value) {
              const int kr = row0 + 8 * (e >> 1);
              const int qi = q0 + qc + (e & 1);
              const bool vis =
                  (!causal || kr <= qi) &&
                  (!has_seg || seg_k[kr - k0] == seg_q[qc + (e & 1)]);
              p = vis ? p : 0.f;
            }
            dpacc[4 * j + e] = p * (dpacc[4 * j + e] - dis[e & 1]);
            sacc[4 * j + e] = p;
          }
        }
      };
      if (has_seg || (causal && q0 < kw0 + 63))
        probs(Bool<true>());
      else
        probs(Bool<false>());
      uint32_t pa[kBwdBM / 16][4], dsa[kBwdBM / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBwdBM / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack2<T>(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
          dsa[kk][i] =
              pack2<T>(dpacc[8 * kk + 2 * i], dpacc[8 * kk + 2 * i + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q over the tile's q rows, 16 at a time
      // (operands pinned first, so that ptxas does not serialize them)
      fence_regs(pa);
      fence_regs(dsa);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdBM / 16; ++kk)
        wgmma_rs_atoms<T>(dv_acc, pa[kk], base + L::k_do(st) + kk * (16 * 128),
                       kBwdBM * 128);
#pragma unroll
      for (int kk = 0; kk < kBwdBM / 16; ++kk)
        wgmma_rs_atoms<T>(dk_acc, dsa[kk], base + L::k_q(st) + kk * (16 * 128),
                       kBwdBM * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    if (lane == 0) mbar_arrive(base + L::bar_empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = ((size_t)(b * S + row0 + 8 * r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float* dkj = &dk_acc[j / 8][4 * (j % 8) + 2 * r];
      const float* dvj = &dv_acc[j / 8][4 * (j % 8) + 2 * r];
      store2<T>(dk + off + 8 * j + cq, dkj[0] * scale, dkj[1] * scale);
      store2<T>(dv + off + 8 * j + cq, dvj[0], dvj[1]);
    }
  }
}

// -- dQ ----------------------------------------------------------------------
// A producer warpgroup (one thread issues every copy) and two consumer
// warpgroups of 64 q rows each; Q and dO of the block stay in shared memory,
// and the ring of k tiles (K, V, the k segment ids) is handed over by
// mbarriers.  lse, di and the q segment ids of a consumer thread's two rows
// sit in its registers.
constexpr int kDqThreads = 384;
constexpr int kDqBM = 128;  // q rows a block (64 a consumer warpgroup)
constexpr int kDqBN = 64;   // k rows a tile

template <int D>
struct DqSmem {  // byte offsets from the 1024-aligned base
  static constexpr uint32_t kQTile = kDqBM * D * 2;
  static constexpr uint32_t kKTile = kDqBN * D * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQTile;
  __host__ __device__ static constexpr uint32_t k_k(int st) {
    return 2 * kQTile + st * 2 * kKTile;
  }
  __host__ __device__ static constexpr uint32_t k_v(int st) {
    return k_k(st) + kKTile;
  }
  __host__ __device__ static constexpr uint32_t seg_k(int st) {
    return 2 * kQTile + 4 * kKTile + st * 256;
  }
  // mbarriers: Q and dO full; per stage, k tile full and empty
  static constexpr uint32_t kBarQ = seg_k(2);
  __host__ __device__ static constexpr uint32_t bar_full(int st) {
    return kBarQ + 8 + 8 * st;
  }
  __host__ __device__ static constexpr uint32_t bar_empty(int st) {
    return kBarQ + 24 + 8 * st;
  }
  static constexpr uint32_t kBytes = kBarQ + 40 + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_sm90_kernel(
        __grid_constant__ const CUtensorMap tq,
        __grid_constant__ const CUtensorMap tk,
        __grid_constant__ const CUtensorMap tv,
        __grid_constant__ const CUtensorMap tdo,
        const float* __restrict__ lse, const float* __restrict__ di,
        const int* __restrict__ seg, T* __restrict__ dq, int H, int S,
        int causal, float scale, float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (S + kDqBM - 1) / kDqBM;
  const int qt = causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kDqBM;
  // S is a multiple of 64: the second consumer's rows are all past S or
  // all real, and no k tile is ragged
  const int n_consumers = q0 + 64 < S ? 2 : 1;
  const int n_kt = causal ? (q0 + 64 * n_consumers) / kDqBN : S / kDqBN;
  const bool has_seg = seg != nullptr;

  if (tid == 0) {
    mbar_init(base + L::kBarQ, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(base + L::bar_full(st), 1);
      // each consumer warp releases a stage it has read
      mbar_init(base + L::bar_empty(st), 4 * n_consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<24>();
    if (tid != 0) return;
    mbar_expect_tx(base + L::kBarQ, 2 * L::kQTile);
    for (int a = 0; a < D / 64; ++a) {
      tma_load_4d(base + L::kQ + a * (kDqBM * 128), &tq, base + L::kBarQ,
                  64 * a, h, q0, b);
      tma_load_4d(base + L::kDo + a * (kDqBM * 128), &tdo, base + L::kBarQ,
                  64 * a, h, q0, b);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt & 1, k0 = kt * kDqBN;
      mbar_wait(base + L::bar_empty(st), ((kt >> 1) & 1) ^ 1);
      const uint32_t full = base + L::bar_full(st);
      mbar_expect_tx(full, 2 * L::kKTile + (has_seg ? 256 : 0));
      for (int a = 0; a < D / 64; ++a) {
        tma_load_4d(base + L::k_k(st) + a * (kDqBN * 128), &tk, full, 64 * a,
                    h, k0, b);
        tma_load_4d(base + L::k_v(st) + a * (kDqBN * 128), &tv, full, 64 * a,
                    h, k0, b);
      }
      if (has_seg)
        bulk_load(base + L::seg_k(st), seg + (size_t)b * S + k0, 256, full);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = wg - 1;  // consumer warpgroup: q rows q0 + 64 cw ..
  if (cw >= n_consumers) return;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  // This warpgroup's 64 rows start at qw0; this thread owns rows row0 and
  // row0 + 8, and in each 8-column chunk of a k tile the columns cq, cq + 1.
  const int qw0 = q0 + 64 * cw;
  const int row0 = qw0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float lse2[2], dis[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = ((size_t)b * H + h) * S + row0 + 8 * r;
    lse2[r] = lse[i] * kLog2e;
    dis[r] = di[i];
    if (has_seg) segq[r] = seg[(size_t)b * S + row0 + 8 * r];
  }
  // causal: the k tiles past this warpgroup's last row add nothing
  const int my_kt = causal ? (qw0 + 64) / kDqBN : n_kt;

  // dQ: column chunk j (8 columns) of the 64-column atom hh is
  // dq_acc[hh][4 j .. 4 j + 3]
  float dq_acc[D / 64][32];
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[hh][i] = 0.f;

  mbar_wait(base + L::kBarQ, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * kDqBN;
    mbar_wait(base + L::bar_full(st), (kt >> 1) & 1);
    if (kt < my_kt) {
      // S = Q K^T and dP = dO V^T over D in steps of 16
      float sacc[kDqBN / 2], dpacc[kDqBN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t a_off =
            (ks / 4) * (kDqBM * 128) + cw * (64 * 128) + (ks % 4) * 32;
        const uint32_t b_off = (ks / 4) * (kDqBN * 128) + (ks % 4) * 32;
        wgmma_ss_n64<T>(sacc, desc_sw128(base + L::kQ + a_off, 16, 1024),
                     desc_sw128(base + L::k_k(st) + b_off, 16, 1024), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t a_off =
            (ks / 4) * (kDqBM * 128) + cw * (64 * 128) + (ks % 4) * 32;
        const uint32_t b_off = (ks / 4) * (kDqBN * 128) + (ks % 4) * 32;
        wgmma_ss_n64<T>(dpacc, desc_sw128(base + L::kDo + a_off, 16, 1024),
                     desc_sw128(base + L::k_v(st) + b_off, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);

      // P = exp2(S scale log2e - lse log2e), dS = P (dP - di), rounded to
      // T as the A operand of dS K; masked entries are exactly 0
      const int* seg_k = reinterpret_cast<const int*>(gbase + L::seg_k(st));
      uint32_t dsa[kDqBN / 16][4];
      auto probs = [&](auto masked) {
#pragma unroll
        for (int kk = 0; kk < kDqBN / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // elements 8 kk + 2 i (+1): row i & 1, chunk 2 kk + i / 2
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 8 * kk + 2 * i + e, r = i & 1;
              float p = ex2(fmaf(sacc[x], scale_log2, -lse2[r]));
              if constexpr (decltype(masked)::value) {
                const int kc = 8 * (2 * kk + i / 2) + cq + e;
                const bool vis =
                    (!causal || k0 + kc <= row0 + 8 * r) &&
                    (!has_seg || seg_k[kc] == segq[r]);
                p = vis ? p : 0.f;
              }
              ds[e] = p * (dpacc[x] - dis[r]);
            }
            dsa[kk][i] = pack2<T>(ds[0], ds[1]);
          }
        }
      };
      if (has_seg || (causal && k0 + kDqBN - 1 > qw0))
        probs(Bool<true>());
      else
        probs(Bool<false>());

      // dQ += dS K over the tile's k rows, 16 at a time (operands pinned
      // first, so that ptxas does not serialize the products)
      fence_regs(dsa);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqBN / 16; ++kk)
        wgmma_rs_atoms<T>(dq_acc, dsa[kk], base + L::k_k(st) + kk * (16 * 128),
                       kDqBN * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
    }
    if (lane == 0) mbar_arrive(base + L::bar_empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* drow = dq + ((size_t)(b * S + row0 + 8 * r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(drow + 8 * j + cq, dq_acc[j / 8][4 * (j % 8) + 2 * r] * scale,
                dq_acc[j / 8][4 * (j % 8) + 2 * r + 1] * scale);
  }
}

// -- host side ----------------------------------------------------------------
size_t smem_bytes(int kernel, int D) {
  if (kernel == 0) return D == 128 ? FwdSmem<128>::kBytes : FwdSmem<64>::kBytes;
  if (kernel == 1)
    return D == 128 ? DkvSmem<128>::kBytes : DkvSmem<64>::kBytes;
  return D == 128 ? DqSmem<128>::kBytes : DqSmem<64>::kBytes;
}

template <typename T>
const void* kernel_fn_t(int kernel, int D) {
  if (kernel == 0)
    return D == 128 ? (const void*)flash_fwd_sm90_kernel<T, 128>
                    : (const void*)flash_fwd_sm90_kernel<T, 64>;
  if (kernel == 1)
    return D == 128 ? (const void*)flash_bwd_dkv_sm90_kernel<T, 128>
                    : (const void*)flash_bwd_dkv_sm90_kernel<T, 64>;
  return D == 128 ? (const void*)flash_bwd_dq_sm90_kernel<T, 128>
                  : (const void*)flash_bwd_dq_sm90_kernel<T, 64>;
}

const void* kernel_fn(int kernel, int dtype, int D) {
  return dtype == kCodeFp16 ? kernel_fn_t<fp16>(kernel, D)
                            : kernel_fn_t<bf16>(kernel, D);
}

// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint: the library
// links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA map of a [B, S, H, D] tensor of T (2-byte bf16 or fp16) as 4-d
// (D, H, S, B): boxes of 64 columns of one head over `rows` rows of S,
// 128-byte swizzled; rows past S read as zeros.  0, or a nonzero code when
// the map cannot be made.
template <typename T>
int tensor_map_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
                    int D, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map,
      kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -3;
}

bool supported(int kernel, int dtype, int D, int S) {
  return kernel >= 0 && kernel <= 2 &&
         (dtype == kCodeBf16 || dtype == kCodeFp16) && (D == 64 || D == 128) &&
         S > 0 && S % 64 == 0;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg,
               void* o, void* lse, int B, int H, int S, int D, int causal,
               float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int rc = 0;
  if ((rc = tensor_map_bshd<T>(&tq, q, B, S, H, D, kFwdBM)) ||
      (rc = tensor_map_bshd<T>(&tk, k, B, S, H, D, kFwdBN)) ||
      (rc = tensor_map_bshd<T>(&tv, v, B, S, H, D, kFwdBN)))
    return rc;
  const dim3 grid(B * H, (S + kFwdBM - 1) / kFwdBM);
  const float sl2 = scale * kLog2e;
  if (D == 128)
    flash_fwd_sm90_kernel<T, 128><<<grid, kFwdThreads, smem_bytes(0, D), st>>>(
        tq, tk, tv, (const int*)seg, (T*)o, (float*)lse, H, S, causal, sl2);
  else
    flash_fwd_sm90_kernel<T, 64><<<grid, kFwdThreads, smem_bytes(0, D), st>>>(
        tq, tk, tv, (const int*)seg, (T*)o, (float*)lse, H, S, causal, sl2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* di,
                   const void* seg, void* dk, void* dv, int B, int H, int S,
                   int D, int causal, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = 0;
  if ((rc = tensor_map_bshd<T>(&tq, q, B, S, H, D, kBwdBM)) ||
      (rc = tensor_map_bshd<T>(&tk, k, B, S, H, D, kBwdBN)) ||
      (rc = tensor_map_bshd<T>(&tv, v, B, S, H, D, kBwdBN)) ||
      (rc = tensor_map_bshd<T>(&tdo, dout, B, S, H, D, kBwdBM)))
    return rc;
  const dim3 grid(B * H, (S + kBwdBN - 1) / kBwdBN);
  const float sl2 = scale * kLog2e;
  if (D == 128)
    flash_bwd_dkv_sm90_kernel<T, 128>
        <<<grid, kBwdThreads, smem_bytes(1, D), st>>>(
            tq, tk, tv, tdo, (const float*)lse, (const float*)di,
            (const int*)seg, (T*)dk, (T*)dv, H, S, causal, scale, sl2);
  else
    flash_bwd_dkv_sm90_kernel<T, 64>
        <<<grid, kBwdThreads, smem_bytes(1, D), st>>>(
            tq, tk, tv, tdo, (const float*)lse, (const float*)di,
            (const int*)seg, (T*)dk, (T*)dv, H, S, causal, scale, sl2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di,
                  const void* seg, void* dq, int B, int H, int S, int D,
                  int causal, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = 0;
  if ((rc = tensor_map_bshd<T>(&tq, q, B, S, H, D, kDqBM)) ||
      (rc = tensor_map_bshd<T>(&tk, k, B, S, H, D, kDqBN)) ||
      (rc = tensor_map_bshd<T>(&tv, v, B, S, H, D, kDqBN)) ||
      (rc = tensor_map_bshd<T>(&tdo, dout, B, S, H, D, kDqBM)))
    return rc;
  const dim3 grid(B * H, (S + kDqBM - 1) / kDqBM);
  const float sl2 = scale * kLog2e;
  if (D == 128)
    flash_bwd_dq_sm90_kernel<T, 128>
        <<<grid, kDqThreads, smem_bytes(2, D), st>>>(
            tq, tk, tv, tdo, (const float*)lse, (const float*)di,
            (const int*)seg, (T*)dq, H, S, causal, scale, sl2);
  else
    flash_bwd_dq_sm90_kernel<T, 64>
        <<<grid, kDqThreads, smem_bytes(2, D), st>>>(
            tq, tk, tv, tdo, (const float*)lse, (const float*)di,
            (const int*)seg, (T*)dq, H, S, causal, scale, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kernel 0 = fwd, 1 = bwd_dkv, 2 = bwd_dq; dtype 1 = bf16, 2 = fp16 (the
// codes of flash_attention.cu's entry points); D = 64 or 128.
size_t flash_sm90_smem_bytes(int kernel, int D) {
  return supported(kernel, kCodeBf16, D, 64) ? smem_bytes(kernel, D) : 0;
}

// Raise a kernel's dynamic shared-memory ceiling to what it uses, on the
// current device; once per (kernel, dtype, D, device), before the first
// launch.
int flash_sm90_prepare(int kernel, int dtype, int D) {
  if (!supported(kernel, dtype, D, 64)) return -1;
  return (int)cudaFuncSetAttribute(kernel_fn(kernel, dtype, D),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(kernel, D));
}

int flash_fwd_sm90_launch(int dtype, const void* q, const void* k,
                          const void* v, const void* seg, void* o, void* lse,
                          int B, int H, int S, int D, int causal, float scale,
                          void* stream) {
  if (!supported(0, dtype, D, S)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == kCodeFp16
             ? launch_fwd<fp16>(q, k, v, seg, o, lse, B, H, S, D, causal,
                                scale, st)
             : launch_fwd<bf16>(q, k, v, seg, o, lse, B, H, S, D, causal,
                                scale, st);
}

int flash_bwd_dkv_sm90_launch(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* lse, const void* di,
                              const void* seg, void* dk, void* dv, int B,
                              int H, int S, int D, int causal, float scale,
                              void* stream) {
  if (!supported(1, dtype, D, S)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == kCodeFp16
             ? launch_bwd_dkv<fp16>(q, k, v, dout, lse, di, seg, dk, dv, B,
                                    H, S, D, causal, scale, st)
             : launch_bwd_dkv<bf16>(q, k, v, dout, lse, di, seg, dk, dv, B,
                                    H, S, D, causal, scale, st);
}

int flash_bwd_dq_sm90_launch(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* di, const void* seg, void* dq, int B,
                             int H, int S, int D, int causal, float scale,
                             void* stream) {
  if (!supported(2, dtype, D, S)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == kCodeFp16
             ? launch_bwd_dq<fp16>(q, k, v, dout, lse, di, seg, dq, B, H, S,
                                   D, causal, scale, st)
             : launch_bwd_dq<bf16>(q, k, v, dout, lse, di, seg, dq, B, H, S,
                                   D, causal, scale, st);
}

}  // extern "C"
