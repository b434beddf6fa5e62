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
// scratch memory across the kv axis.  Here one thread block owns one
// (64-query tile, head, batch) and a loop inside the block over 64-key tiles
// takes the place of that sequential axis; m, l and the accumulator stay in
// registers for the whole loop.  Under `causal`, KV tiles wholly past the
// diagonal are never loaded.  Ragged tails (L not a multiple of 64, e.g. the
// L = 80 of the shakespeare path) are zero-filled on load and masked.
//
// Inputs are read in place through element strides (batch, row, head; the D
// axis contiguous), so the q/k/v column blocks of the transformer's fused QKV
// projection need no copy.  Rows are fetched as 16-byte vectors, which the
// wrapper guarantees by checking alignment.
//
// Two instantiations:
//   bf16  4 warps; each warp owns 16 query rows.  S = Q K^T and O += P V go
//         through mma.sync m16n8k16 (bf16 in, fp32 accumulate).  K/V tiles are
//         double-buffered: cp.async copies tile kt + 1 into shared memory while
//         the warps compute on tile kt.  Fragments come from shared memory by
//         ldmatrix (V's transposed, out of the row-major tile); the row stride
//         is padded by 16 bytes so the 8 rows of each 8x8 load hit all 32
//         banks.  P is cast to bf16 in registers and reused as the A operand of
//         P V directly from the S accumulator layout.  D < 16 is zero-padded in
//         shared memory to the MMA depth of 16.
//   fp32  CUDA-core FMA in full fp32 (never TF32): 256 threads as 16 x 16, each
//         thread owning 4 query rows x 4 keys of S and 4 rows x D/16 columns
//         of O; P goes through shared memory.
//
// What bounds it on the H100, at the fedllm bench shape (B 8, L 1024, H 10,
// D 128, bf16, causal): q, k, v and o are 84 MB, 0.025 ms at 3.35 TB/s; the
// visible causal work is 21.5 GFLOP, 0.022 ms at the 989 TFLOP/s bf16 tensor
// rate.  So the kernel sits near the ridge: it must read each K/V tile once
// per query tile from L2 and keep the tensor cores fed.  mma.sync with a
// two-stage cp.async ring is the simple form of that; wgmma with TMA-fed K/V
// tiles and warp specialisation are later work.

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
  int heads, lq, lk;
  float scale_log2;  // log2(e) / sqrt(D): scores live in the log2 domain
  int causal;
};

// Number of KV tiles query tile qt reads.
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

// ----------------------------------------------------------------- launch

template <typename Kernel>
int launch(Kernel kern, int threads, int smem, const Params& p, int batch,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.lq + kBQ - 1) / kBQ, p.heads, batch);
  kern<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_dtype(const Params& p, int batch, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_fwd_bf16<D>, 128, MmaCfg<D>::kSmemBytes, p, batch, stream);
  return launch(flash_fwd_f32<D>, 256, FmaCfg<D>::kSmemBytes, p, batch, stream);
}

}  // namespace

extern "C" {

// q [B, Lq, H, D], k/v [B, Lk, H, D] of one dtype (bf16 when is_bf16, else
// fp32), each addressed as base + b*sb + l*sl + h*sh + d with the strides in
// elements; every base and stride must keep rows 16-byte aligned.  o is
// written through its own strides in the same dtype; lse [B, H, Lq] fp32
// contiguous.  D in {8, 16, 32, 64, 128}.  Returns the cudaError_t of the
// launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int batch, int heads, int lq, int lk, int d,
                        long long q_sb, long long q_sl, long long q_sh,
                        long long k_sb, long long k_sl, long long k_sh,
                        long long v_sb, long long v_sl, long long v_sh,
                        long long o_sb, long long o_sl, long long o_sh,
                        int causal, int is_bf16, void* stream) {
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
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return dispatch_dtype<8>(p, batch, is_bf16, st);
    case 16: return dispatch_dtype<16>(p, batch, is_bf16, st);
    case 32: return dispatch_dtype<32>(p, batch, is_bf16, st);
    case 64: return dispatch_dtype<64>(p, batch, is_bf16, st);
    case 128: return dispatch_dtype<128>(p, batch, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
