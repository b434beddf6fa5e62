// Flash-attention forward for Hopper (sm_90a): O and the per-row LSE.
//
// Replaces fedml_tpu/ops/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind _flash_single / flash_attention_with_lse).  Same function, per
// (batch, head) slice of q [Lq, D], k/v [Lk, D]:
//
//   s   = (q k^T) / sqrt(D)                     fp32 accumulation
//   s   = where(kpos <= qpos, s, -1e30)         causal only
//   m   = running row max, l = running row sum of exp(s - m)   (online softmax)
//   acc = sum over KV tiles of cast(exp(s - m), v.dtype) @ v    fp32 accumulation
//   o   = cast(acc / max(l, 1e-30), q.dtype)
//   lse = m + log(max(l, 1e-30))                fp32
//
// The TPU grid walked (q block, kv block) in order and carried m/l/acc in
// scratch memory across the kv axis.  Here one thread block owns one (query
// tile, head, batch) and a loop inside the block over KV tiles takes the
// place of that sequential axis; m, l and the accumulator stay in registers
// for the whole loop.  Under `causal`, KV tiles wholly past the diagonal are
// never loaded (kpos <= qpos, top-left aligned when Lq != Lk).  Ragged tails
// (L not a multiple of the tile, e.g. the L = 80 of the shakespeare path) are
// zero-filled on load and masked.  Inputs are read in place through element
// strides (batch, row, head; the D axis contiguous), so the q/k/v column
// blocks of the transformer's fused QKV projection need no copy; the wrapper
// checks that every base and stride keeps rows 16-byte aligned.
//
// Three instantiations.  The wrapper's plan (ops/flash_attention.py::
// _flash_plan) picks one from the dtype and D and is launched as given; the
// entry point refuses a plan that names a kernel, tile, block or shared-memory
// size it was not built with (built_for):
//   wgmma  bf16, D 64 or 128 (v3).  Persistent: one block of 384 threads per
//          SM runs the 128-query tiles of every (batch, head) that the
//          plan's schedule gives it, in its order (under `causal`, heaviest
//          first), each with the count of KV tiles it reads.
//          Warpgroup 0 is the producer, warpgroups 1 and 2 each own 64 of a
//          tile's 128 query rows.  One producer thread moves each tile's Q,
//          then every 128-key K and V tile, by TMA (cp.async.bulk.tensor over
//          4-D tensor maps (D, H, L, B) of the strided views, built on the
//          host per call; 128-byte swizzle; rows past L arrive as zeros) into
//          a two-stage ring with a full/empty mbarrier pair per stage and per
//          operand, the ring running on from one q tile into the next.
//          S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//          (K rows are D-contiguous: the K-major B operand).  O += P V is
//          wgmma m64nDk16 with A = P from registers (the S accumulator, cast
//          to bf16, is already the A fragment) and B = V from shared memory
//          as the MN-major operand (the descriptor's transpose bit).  Tile
//          j's Q K^T is issued together with tile j - 1's P V, so a
//          warpgroup's softmax (one FFMA and one ex2.approx per score) runs
//          while its P V is on the tensor cores.  The producer hands its
//          registers to the consumers (setmaxnreg).  O is staged in its own
//          tile (same swizzle, no bank conflicts) and stored 16 bytes a
//          thread while the next q tile's Q and K/V arrive.
//   mma    bf16, D 8, 16 or 32 (v2).  4 warps, one 64-query tile; each warp
//          owns 16 query rows.  S = Q K^T and O += P V go through mma.sync
//          m16n8k16 (bf16 in, fp32 accumulate).  K/V tiles are double-buffered
//          by cp.async; fragments come from shared memory by ldmatrix (V's
//          transposed, out of the row-major tile); the row stride is padded by
//          16 bytes so the 8 rows of each 8x8 load hit all 32 banks.  P is
//          cast to bf16 in registers and reused as the A operand of P V
//          directly from the S accumulator layout.  D < 16 is zero-padded in
//          shared memory to the MMA depth of 16.
//   fma    fp32, every D.  CUDA-core FMA in full fp32 (never TF32): 256
//          threads as 16 x 16, each thread owning 4 query rows x 4 keys of S
//          and 4 rows x D/16 columns of O; P goes through shared memory.
//
// What bounds it on the H100, at the fedllm bench shape (B 8, L 1024, H 10,
// D 128, bf16, causal): q, k, v and o are 84 MB, 0.025 ms at 3.35 TB/s; the
// visible causal work is 21.5 GFLOP, 0.022 ms at the 989 TFLOP/s bf16 tensor
// rate (24.2 GFLOP as 128 x 128 tiles compute it).  So the kernel sits at the
// ridge and must keep the tensor cores fed.  v2 could not: 8 warps per SM,
// each a serial chain of ldmatrix, mma.sync and softmax; B fragments read by
// every warp for its own 16 rows (about 16 FLOP per byte of shared memory);
// 64-row q tiles that read every visible K/V tile from L2 twice as often as
// 128-row ones; and the heaviest causal tiles dispatched last.  v3 answers
// each: wgmma reads B once per warpgroup from shared memory at the full
// tensor rate, TMA moves tiles without registers or instructions, the
// 128-row tile halves the L2 traffic, and the heavy-first deal balances the
// SMs.  The softmax's MUFU and ALU work is what the tensor cores still wait
// on: one FFMA and ex2.approx per score instead of a multiply and exp2f took
// 9-16% off the kernel (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per KV tile (== kBQ, so tile kt is visible from query tile qt iff kt <= qt)
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.69314718055994531f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Lq]
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  int batch, heads, lq, lk;
  float scale_log2;  // log2(e) / sqrt(D): scores live in the log2 domain
  int causal;
  // v3: the plan's schedule, [sched_rows][gridDim.x] of (q tile, head,
  // batch, KV tiles); the k-th tile of block b is sched[k * gridDim.x + b],
  // and a q tile of -1 ends the block's list
  const int4* sched;
  int sched_rows;
};

// Number of KV tiles v2's query tile qt reads.
__device__ __forceinline__ int kv_tiles(const Params& p, int qt) {
  const int nk = (p.lk + kBK - 1) / kBK;
  return p.causal ? min(nk, qt + 1) : nk;
}

// A score that the mask removes: past the sequence end, or past the diagonal.
__device__ __forceinline__ bool masked(const Params& p, int key, int qpos) {
  return key >= p.lk || (p.causal && key > qpos);
}

// ----------------------------------------------------------------- bf16 path

template <int D>
struct MmaCfg {
  static constexpr int kDK = D < 16 ? 16 : D;  // Q K^T depth, padded to the MMA k of 16
  static constexpr int kRS = kDK + 8;          // smem row stride (elements): 8 ldmatrix rows hit 32 banks
  static constexpr int kTile = kBQ * kRS;      // one 64-row Q, K or V tile
  static constexpr int kSmemBytes = 5 * kTile * 2;  // Q + two K + two V tiles
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not wait; zero-fills when !valid
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row major) * b (16x8, column major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying rows [row0, row0 + 64) of one (batch, head) slice into a
// smem tile [64][DK]; rows past `lim` and columns past D become zeros.
template <int D, int DK, int RS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int lim,
                                                int tid) {
  constexpr int kChunks = DK / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * kChunks; c += 128) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool valid = row0 + r < lim && cc * 8 < D;
    cp_async16(dst + r * RS + cc * 8, valid ? src + (row0 + r) * row_stride + cc * 8 : src,
               valid);
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(const Params p) {
  using Cfg = MmaCfg<D>;
  constexpr int DK = Cfg::kDK, RS = Cfg::kRS, kTile = Cfg::kTile;
  constexpr int kSteps = DK / 16;  // k-steps of Q K^T
  constexpr int kNtS = kBK / 8;    // n-tiles of S per warp
  constexpr int kNtO = D / 8;      // n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kTile;      // two buffers
  __nv_bfloat16* vs = ks + 2 * kTile;  // two buffers, V row-major like K

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment group and thread-in-group
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix this lane addresses
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int n_tiles = kv_tiles(p, qt);

  // Q, then KV tile 0, in flight at once; the loop keeps tile kt + 1 in
  // flight while it computes on tile kt
  load_tile_async<D, DK, RS>(qs, qg, p.q_sl, q0, p.lq, tid);
  cp_async_commit();
  load_tile_async<D, DK, RS>(ks, kg, p.k_sl, 0, p.lk, tid);
  load_tile_async<D, DK, RS>(vs, vg, p.v_sl, 0, p.lk, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + lr + 8 * (lm & 1)) * RS + kk * 16 + 8 * (lm >> 1));
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  float o[kNtO][4];
#pragma unroll
  for (int nt = 0; nt < kNtO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const __nv_bfloat16* kb = ks + (kt & 1) * kTile;
    const __nv_bfloat16* vb = vs + (kt & 1) * kTile;
    if (kt + 1 < n_tiles) {
      // the other buffer was last read in iteration kt - 1, which ended in a barrier
      load_tile_async<D, DK, RS>(ks + ((kt + 1) & 1) * kTile, kg, p.k_sl, k0 + kBK, p.lk, tid);
      load_tile_async<D, DK, RS>(vs + ((kt + 1) & 1) * kTile, vg, p.v_sl, k0 + kBK, p.lk, tid);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just started
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt visible to every warp

    float s[kNtS][4];
#pragma unroll
    for (int j = 0; j < kNtS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kNtS; j += 2) {
        // B fragments of n-tiles j and j + 1 (keys 8j.., d lo/hi halves of the k-step)
        uint32_t bf[4];
        ldsm_x4(bf, kb + (j * 8 + lr + 8 * (lm >> 1)) * RS + kk * 16 + 8 * (lm & 1));
        mma_bf16(s[j], qf[kk], bf[0], bf[1]);
        mma_bf16(s[j + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // accumulator element e of n-tile j: row r0 + 8 * (e >> 1), key k0 + 8j + 2t + (e & 1)
    const bool edge = (k0 + kBK > p.lk) || (p.causal && k0 + kBK - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNtS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * p.scale_log2;
        if (edge && masked(p, k0 + j * 8 + 2 * t + (e & 1), qpos[e >> 1])) val = kNegInf;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four threads of a group hold one row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kNtS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = pv;
        l[e >> 1] += pv;  // the row sum takes p before its cast, as the TPU kernel's does
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNtO; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // O += P V: n-tiles 2kk and 2kk + 1 of S are the A fragment of keys [16kk, 16kk + 16);
    // V's B fragments come transposed out of the row-major tile
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = vb + (kk * 16 + lr) * RS;
#pragma unroll
      for (int nt = 0; nt + 1 < kNtO; nt += 2) {
        uint32_t bf[4];  // n-tiles nt and nt + 1 (d 8nt.., keys lo/hi halves)
        ldsm_x4_trans(bf, vrow + 8 * (lm & 1) * RS + nt * 8 + 8 * (lm >> 1));
        mma_bf16(o[nt], a, bf[0], bf[1]);
        mma_bf16(o[nt + 1], a, bf[2], bf[3]);
      }
      if (kNtO & 1) {  // D = 8: one n-tile
        uint32_t bf[2];
        ldsm_x2_trans(bf, vrow + 8 * (lm & 1) * RS + (kNtO - 1) * 8);
        mma_bf16(o[kNtO - 1], a, bf[0], bf[1]);
      }
    }
    __syncthreads();  // every warp is done with tile kt before its buffer is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.lq) continue;
    __nv_bfloat16* orow = og + qpos[r] * p.o_sl + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kNtO; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8) =
          pack_bf16(o[nt][2 * r] * inv[r], o[nt][2 * r + 1] * inv[r]);
    if (t == 0)
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.lq + qpos[r]] =
          (m[r] + log2f(l[r])) * kLn2;
  }
}

// ----------------------------------------------------------------- fp32 path

template <int D>
struct FmaCfg {
  static constexpr int kDP = D < 16 ? 16 : D;  // O columns padded to 16 threads' worth
  static constexpr int kQS = kDP + 1;          // Q/K smem row stride (floats); odd, so rows hit distinct banks
  static constexpr int kVS = kDP;
  static constexpr int kPS = kBK + 1;
  static constexpr int kSmemBytes = (kBQ * kQS + kBK * kQS + kBK * kVS + kBQ * kPS) * 4;
};

// rows [row0, row0 + 64) of one slice -> smem [64][width] fp32; zeros past lim / D.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, int stride, int width,
                                              const float* src, long long row_stride,
                                              int row0, int lim, int tid) {
  const int chunks = width / 4;
  for (int c = tid; c < 64 * chunks; c += 256) {
    const int r = c / chunks, cc = c % chunks;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < lim && cc * 4 < D)
      val = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + cc * 4);
    float* d = dst + r * stride + cc * 4;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(const Params p) {
  using Cfg = FmaCfg<D>;
  constexpr int DP = Cfg::kDP, QS = Cfg::kQS, VS = Cfg::kVS, PS = Cfg::kPS;
  constexpr int kCols = DP / 16;  // O columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBQ * QS;
  float* vs = ks + kBK * QS;
  float* ps = vs + kBK * VS;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // thread (ty, tx) owns rows ty + 16i, keys tx + 16j and O columns tx + 16c;
  // the 16 threads sharing a row are one half-warp
  const int q0 = qt * kBQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows_f32<D>(qs, QS, DP, qg, p.q_sl, q0, p.lq, tid);
  float o[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  const int n_tiles = kv_tiles(p, qt);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows_f32<D>(ks, QS, DP, kg, p.k_sl, k0, p.lk, tid);
    load_rows_f32<D>(vs, VS, DP, vg, p.v_sl, k0, p.lk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    const bool edge = (k0 + kBK > p.lk) || (p.causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float val = s[i][j] * p.scale_log2;
        if (edge && masked(p, k0 + tx + 16 * j, qpos)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = exp2f(s[i][j] - mx);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = pv;
        rs += pv;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // P complete
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[key * VS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = ps[(ty + 16 * i) * PS + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(pv, vv[c], o[i][c]);
      }
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    li = fmaxf(li, 1e-30f);
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.lq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < D) og[qpos * p.o_sl + col] = o[i][c] / li;
    }
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.lq + qpos] = (m[i] + log2f(li)) * kLn2;
  }
}

// ----------------------------------------------------------------- bf16 wgmma path (v3)

constexpr int kWgBQ = 128;      // query rows per block: two consumer warpgroups x 64
constexpr int kWgBN = 128;      // keys per KV tile: the N of the S = Q K^T wgmma
constexpr int kWgStages = 2;    // depth of the K and V rings
constexpr int kWgThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kBoxBytes = 128 * 128;  // one TMA box: 128 rows of 64 bf16, one 128-byte swizzle row each
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 x (24 + 240 + 240) = the SM's 65,536 registers
// Dynamic shared memory of one v3 block.  A tile is D / 64 boxes side by
// side, each [128 rows][128 bytes] in TMA's 128-byte swizzle (8-row atoms
// of 1024 bytes).  O is staged in its own tile, so the next q tile's Q can
// arrive while this one's O is stored.  The base is rounded up to 1024
// bytes, hence the slack.
template <int D>
struct WgLayout {
  static constexpr int kTile = (D / 64) * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kO = kTile;
  static constexpr int kK = 2 * kTile;                  // kWgStages K tiles
  static constexpr int kV = kK + kWgStages * kTile;     // kWgStages V tiles
  static constexpr int kBar = kV + kWgStages * kTile;   // q_full, q_empty, k/v full and empty per stage
  static constexpr int kBytes = kBar + 128 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box (64 of D, 1 head, 128 rows, 1 batch) of a 4-D tensor map
// (D, H, L, B) into shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WG_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)

// d (64 rows x 128 keys, fp32) (+)= A (64 x 16, K-major smem) * B (128 x 16,
// K-major smem)^T; accumulate when `acc`, else overwrite.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D64
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 rows x N of D, fp32) += A (64 x 16 keys, bf16 registers) * B (16
// keys x N, smem, MN-major: the trailing 1 transposes it).
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : WG_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 64, "wgmma_pv takes D 64 or 128");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : WG_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef WG_D64
#undef WG_D32
#undef WG_D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile for this thread's two rows (accumulator
// element i: row qpos0 + 8 * ((i >> 1) & 1), key k0 + 8 * (i >> 2) + 2t +
// (i & 1)), m in the log2 domain: the row max is taken over the raw scores
// and scaled once, each p is one FFMA and one ex2.  s becomes p in place
// and alpha the factor that rescales the earlier O.
__device__ __forceinline__ void wg_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], const Params& p, int k0,
                                           int qpos0, int t, bool edge) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (edge && masked(p, k0 + 8 * (i >> 2) + 2 * t + (i & 1), qpos0 + 8 * r)) s[i] = kNegInf;
    mx[r] = fmaxf(mx[r], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four threads of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * p.scale_log2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float pv = ex2(fmaf(s[i], p.scale_log2, -m[r]));
    s[i] = pv;
    l[r] += pv;  // the row sum takes p before its cast, as the TPU kernel's does
  }
}

// P (fp32 accumulator layout) -> the bf16 A fragments of the 8 k-steps of
// P V: keys [16kk, 16kk + 16) are accumulator chunks 2kk and 2kk + 1.
__device__ __forceinline__ void wg_pack_p(uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void wg_rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// S = Q K^T over D: k-step kk reads 32 bytes of every row, in box kk / 4.
template <int D>
__device__ __forceinline__ void wg_issue_qk(float (&s)[64], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_qk(s, sw128_desc(q_base + off, 16, 1024), sw128_desc(k_base + off, 16, 1024), kk > 0);
  }
}

// O += P V over the tile's 128 keys: k-step kk reads V rows [16kk, 16kk + 16)
// (two 8-row atoms, 1024 bytes apart); along D the boxes are kBoxBytes apart.
template <int D>
__device__ __forceinline__ void wg_issue_pv(float (&o)[D / 2], const uint32_t (&pa)[8][4],
                                            uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<D>(o, pa[kk], sw128_desc(v_base + kk * 16 * 128, kBoxBytes, 1024));
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = WgLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBar;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + kWgStages + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + 2 * kWgStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * kWgStages + s); };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads each q tile's Q and keeps the K/V ring full
    // across the block's q tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int ring = 0;  // K/V tiles loaded so far
      for (int k = 0; k < p.sched_rows; ++k) {
        const int4 w = __ldg(p.sched + k * gridDim.x + blockIdx.x);
        if (w.x < 0) break;  // past this block's last q tile
        const int qt = w.x, h = w.y, b = w.z, n_tiles = w.w;
        mbar_wait(q_empty, (k & 1) ^ 1);  // the last q tile's GEMMs are done with Q
        mbar_expect_tx(q_full, L::kTile);
        for (int hb = 0; hb < D / 64; ++hb)
          tma_load(base + L::kQ + hb * kBoxBytes, &tm_q, q_full, hb * 64, h, qt * kWgBQ, b);
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int s = ring % kWgStages;
          const uint32_t ph = (ring / kWgStages) & 1;
          mbar_wait(k_empty(s), ph ^ 1);
          mbar_expect_tx(k_full(s), L::kTile);
          for (int hb = 0; hb < D / 64; ++hb)
            tma_load(base + L::kK + s * L::kTile + hb * kBoxBytes, &tm_k, k_full(s), hb * 64, h,
                     it * kWgBN, b);
          mbar_wait(v_empty(s), ph ^ 1);
          mbar_expect_tx(v_full(s), L::kTile);
          for (int hb = 0; hb < D / 64; ++hb)
            tma_load(base + L::kV + s * L::kTile + hb * kBoxBytes, &tm_v, v_full(s), hb * 64, h,
                     it * kWgBN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;  // this warpgroup's rows: [64cw, 64cw + 64) of the q tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_base = base + L::kQ + cw * 64 * 128;
    unsigned char* stage = smem + L::kO + cw * 64 * 128;  // this warpgroup's O rows
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float o[D / 2];
    float m[2], l[2];  // l: this thread's share of the row sum
    float alpha[2];
    float s[64];
    uint32_t pa[8][4];
    int ring = 0;  // K/V tiles consumed so far
    for (int k = 0; k < p.sched_rows; ++k) {
      const int4 w = __ldg(p.sched + k * gridDim.x + blockIdx.x);
      if (w.x < 0) break;
      const int qt = w.x, h = w.y, b = w.z, n_tiles = w.w;
      const int q0 = qt * kWgBQ;
      const int wq0 = q0 + cw * 64;              // first row of the warpgroup
      const int qpos0 = wq0 + warp * 16 + g;     // this thread's rows: qpos0, qpos0 + 8
      auto edge_tile = [&](int k0) {
        return (k0 + kWgBN > p.lk) || (p.causal && k0 + kWgBN - 1 > wq0);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      mbar_wait(q_full, k & 1);
      if (n_tiles > 0) {
        // tile it's Q K^T is issued with tile it - 1's P V, and its softmax
        // runs while that P V is still on the tensor cores
        mbar_wait(k_full(ring % kWgStages), (ring / kWgStages) & 1);
        wgmma_fence();
        wg_issue_qk<D>(s, q_base, base + L::kK + (ring % kWgStages) * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        release(k_empty(ring % kWgStages));
        if (n_tiles == 1) release(q_empty);  // the q tile's last Q K^T is done
        wg_softmax(s, m, l, alpha, p, 0, qpos0, t, edge_tile(0));
        wg_pack_p(pa, s);
        for (int it = 1; it < n_tiles; ++it) {
          const int cur = ring + it, prev = cur - 1;
          const int sc = cur % kWgStages, sp = prev % kWgStages;
          const int k0 = it * kWgBN;
          mbar_wait(k_full(sc), (cur / kWgStages) & 1);
          wgmma_fence();
          wg_issue_qk<D>(s, q_base, base + L::kK + sc * L::kTile);
          wgmma_commit();
          if (it > 1) wg_rescale<D>(o, alpha);  // under the Q K^T, before P V adds to O
          mbar_wait(v_full(sp), (prev / kWgStages) & 1);
          wgmma_fence();
          wg_issue_pv<D>(o, pa, base + L::kV + sp * L::kTile);
          wgmma_commit();
          wgmma_wait<1>();
          release(k_empty(sc));
          if (it == n_tiles - 1) release(q_empty);  // the next q tile's Q may come in
          wg_softmax(s, m, l, alpha, p, k0, qpos0, t, edge_tile(k0));
          wgmma_wait<0>();
          release(v_empty(sp));
          wg_pack_p(pa, s);
        }
        const int last = ring + n_tiles - 1;
        if (n_tiles > 1) wg_rescale<D>(o, alpha);
        mbar_wait(v_full(last % kWgStages), (last / kWgStages) & 1);
        wgmma_fence();
        wg_issue_pv<D>(o, pa, base + L::kV + (last % kWgStages) * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        release(v_empty(last % kWgStages));
      } else {
        release(q_empty);
      }
      ring += n_tiles;

      // epilogue: normalise, stage O (bf16) in this warpgroup's rows of the O
      // tile in the same swizzle, then 16-byte stores of the rows < Lq
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-30f);
        inv[r] = 1.f / l[r];
      }
      named_bar_sync(1 + cw, 128);  // the warpgroup is done storing the last q tile's O
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const int rr = warp * 16 + g + 8 * r, col = 8 * (i >> 2) + 2 * t;
        const int c = (col & 63) >> 3;
        *reinterpret_cast<uint32_t*>(stage + (col >> 6) * kBoxBytes + rr * 128 +
                                     ((c ^ (rr & 7)) << 4) + 4 * t) =
            pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
      }
      named_bar_sync(1 + cw, 128);
      constexpr int kChunks = D / 8;  // 16-byte chunks per row
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll 4
      for (int ci = tid; ci < 64 * kChunks; ci += 128) {
        const int rr = ci / kChunks, cc = ci % kChunks;
        if (wq0 + rr >= p.lq) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(stage + (cc >> 3) * kBoxBytes +
                                                          rr * 128 + (((cc & 7) ^ (rr & 7)) << 4));
        *reinterpret_cast<uint4*>(og + static_cast<long long>(wq0 + rr) * p.o_sl + cc * 8) = val;
      }
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = qpos0 + 8 * r;
          if (qpos < p.lq)
            p.lse[(static_cast<long long>(b) * p.heads + h) * p.lq + qpos] =
                (m[r] + log2f(l[r])) * kLn2;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- plan and launch

enum Route { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };
constexpr int kPlanRefused = -1;  // the wrapper's plan is not one this library was built for
constexpr int kNoEncoder = -2;    // libcuda has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = -3; // cuTensorMapEncodeTiled refused a q/k/v view

// The wrapper's plan (ops/flash_attention.py::_flash_plan): the route, its
// tiles and ring, the block, its shared memory, the grid and, for wgmma, the
// schedule.  The plan decides; the library only checks it.
struct Plan {
  int route, bq, bn, stages, threads, smem, gx, gy, gz;
};

// Whether `pl` names a kernel this library was built with, at that kernel's
// own tiles, block and shared memory, over a grid it indexes: wgmma for bf16
// with D 64 or 128, mma for bf16 with D <= 32, fma for fp32.
template <int D>
bool built_for(const Plan& pl, const Params& p, int is_bf16) {
  const bool v2_grid = pl.gx == (p.lq + kBQ - 1) / kBQ && pl.gy == p.heads && pl.gz == p.batch;
  switch (pl.route) {
    case kRouteWgmma:
      return D >= 64 && is_bf16 && pl.bq == kWgBQ && pl.bn == kWgBN && pl.stages == kWgStages &&
             pl.threads == kWgThreads && pl.smem == WgLayout<D>::kBytes && pl.gx > 0 &&
             pl.gy == 1 && pl.gz == 1 && p.sched != nullptr && p.sched_rows > 0;
    case kRouteMma:
      return D <= 32 && is_bf16 && pl.bq == kBQ && pl.bn == kBK && pl.stages == 2 &&
             pl.threads == 128 && pl.smem == MmaCfg<D>::kSmemBytes && v2_grid;
    case kRouteFma:
      return !is_bf16 && pl.bq == kBQ && pl.bn == kBK && pl.stages == 1 && pl.threads == 256 &&
             pl.smem == FmaCfg<D>::kSmemBytes && v2_grid;
    default:
      return false;
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up through the runtime once.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D map (D, H, L, B) over one bf16 [B, L, H, D] view with element
// strides (sb, sl, sh), box (64, 1, 128, 1), 128-byte swizzle; rows past L
// read as zeros.  A dimension of extent 1 gets the dense stride (its own
// stride never matters, and TMA wants every stride a positive multiple of 16).
int make_map(CUtensorMap* map, const void* ptr, int d, int heads, int len, int batch,
             long long sb, long long sl, long long sh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t s_h = heads == 1 ? 2ull * d : 2ull * sh;
  const cuuint64_t s_l = len == 1 ? s_h * heads : 2ull * sl;
  const cuuint64_t s_b = batch == 1 ? s_l * len : 2ull * sb;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {s_h, s_l, s_b};
  const cuuint32_t box[4] = {64, 1, kWgBQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <typename Kernel>
int set_smem(Kernel kern, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int D>
int launch_wgmma(const Params& p, const Plan& plan, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, D, p.heads, p.lq, p.batch, p.q_sb, p.q_sl, p.q_sh);
  if (err == 0) err = make_map(&tk, p.k, D, p.heads, p.lk, p.batch, p.k_sb, p.k_sl, p.k_sh);
  if (err == 0) err = make_map(&tv, p.v, D, p.heads, p.lk, p.batch, p.v_sb, p.v_sl, p.v_sh);
  if (err == 0) err = set_smem(flash_fwd_wgmma<D>, plan.smem);
  if (err != 0) return err;
  flash_fwd_wgmma<D><<<dim3(plan.gx, plan.gy, plan.gz), plan.threads, plan.smem, stream>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const Params& p, int is_bf16, const Plan& plan, cudaStream_t stream) {
  if (!built_for<D>(plan, p, is_bf16)) return kPlanRefused;
  const dim3 grid(plan.gx, plan.gy, plan.gz);
  int err;
  switch (plan.route) {
    case kRouteWgmma:
      if constexpr (D >= 64) return launch_wgmma<D>(p, plan, stream);
      return kPlanRefused;
    case kRouteMma:
      if constexpr (D <= 32) {
        err = set_smem(flash_fwd_bf16<D>, plan.smem);
        if (err != 0) return err;
        flash_fwd_bf16<D><<<grid, plan.threads, plan.smem, stream>>>(p);
        return static_cast<int>(cudaGetLastError());
      }
      return kPlanRefused;
    default:
      err = set_smem(flash_fwd_f32<D>, plan.smem);
      if (err != 0) return err;
      flash_fwd_f32<D><<<grid, plan.threads, plan.smem, stream>>>(p);
      return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" {

// q [B, Lq, H, D], k/v [B, Lk, H, D] of one dtype (bf16 when is_bf16, else
// fp32), each addressed as base + b*sb + l*sl + h*sh + d with the strides in
// elements; every base and stride must keep rows 16-byte aligned.  o is
// written through its own strides in the same dtype; lse [B, H, Lq] fp32
// contiguous.  D in {8, 16, 32, 64, 128}.  (route, bq, bn, stages, threads,
// smem_bytes, grid_x/y/z) is the wrapper's plan, launched as given once
// built_for accepts it; for wgmma, sched is its schedule on the device,
// int32 [sched_rows][grid_x][4] of (q tile, head, batch, KV tiles), a q
// tile of -1 past a block's last (see Params).  Returns the cudaError_t of
// the launch, or kPlanRefused / kNoEncoder / kEncodeFailed (negative).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int heads, int lq, int lk, int d,
                        long long q_sb, long long q_sl, long long q_sh,
                        long long k_sb, long long k_sl, long long k_sh,
                        long long v_sb, long long v_sl, long long v_sh,
                        long long o_sb, long long o_sl, long long o_sh,
                        int causal, int is_bf16, int route, int bq, int bn, int stages,
                        int threads, int smem_bytes, int grid_x, int grid_y, int grid_z,
                        const void* sched, int sched_rows, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.batch = batch;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  p.causal = causal;
  p.sched = static_cast<const int4*>(sched);
  p.sched_rows = sched_rows;
  const Plan plan = {route, bq, bn, stages, threads, smem_bytes, grid_x, grid_y, grid_z};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return dispatch<8>(p, is_bf16, plan, st);
    case 16: return dispatch<16>(p, is_bf16, plan, st);
    case 32: return dispatch<32>(p, is_bf16, plan, st);
    case 64: return dispatch<64>(p, is_bf16, plan, st);
    case 128: return dispatch<128>(p, is_bf16, plan, st);
    default: return kPlanRefused;
  }
}

}  // extern "C"
