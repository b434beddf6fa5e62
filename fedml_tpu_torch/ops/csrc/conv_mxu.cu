// Implicit-GEMM 3x3 convolution for Hopper (sm_90a), NHWC / HWIO.
//
// Replaces fedml_tpu/ops/conv_mxu.py::_conv_kernel (the Pallas TPU kernel
// behind conv3x3_mxu).  Same function:
//
//   out[M = N*Ho*Wo, Cout] = patches(x)[M, K = 9*Cin] @ w[K, Cout]
//
// with explicit padding 1 and stride 1 or 2 (at stride 2 out[i] reads padded
// rows 2i..2i+2, the even-centre windows of torch's padding=1, stride=2 and
// NOT "SAME"), patch column order k = t*Cin + c with tap (ty, tx) =
// divmod(t, 3), fp32 accumulation for fp32 and bf16 inputs, an optional fp32
// per-channel mul/add + ReLU epilogue, a cast to the output dtype, and
// optional per-channel (sum, sumsq) of the EMITTED (post-cast) values.
//
// What bounds it on the H100: at ResNet-56's shapes (N=64) every 3x3 conv
// is ~0.30 GFLOP and moves 1.1-4.2 MB (input, weights and output once).
// The stage-1 body (16->16, 32x32) moves 4.2 MB: 1.25 us at 3.35 TB/s; the
// stage-3 body (64->64, 8x8) 1.1 MB: 0.33 us.  The arithmetic is 0.30 us at
// the 989 TFLOP/s bf16 tensor-core peak and stays under 1 us at the lower
// rate mma.sync reaches, so each conv is bound by bytes and by latency (a
// few dependent L2 round trips per block, a launch), never by the tensor
// cores.  That is why v3 uses mma.sync and not wgmma: a 64-row warpgroup
// tile would only cut the block count, which is what the small stages lack.
//
// Shared by both paths:
//   - no padded copy and no materialized patch matrix: each block gathers
//     its patch tile straight from the NHWC input into shared memory, the
//     zero border by bounds checks (the nine-fold re-reads of a pixel hit
//     L1/L2, not HBM);
//   - the epilogue and the moments run on the fp32 accumulators, so
//     BatchNorm's batch statistics cost no second pass over the output;
//   - moments are per-block partials written to a [2, num_blocks, Cout]
//     fp32 buffer and summed over the blocks in a fixed order by a second,
//     one-launch kernel (moments_reduce_kernel): no atomics, so a run is
//     deterministic (blocks run in no order and nothing carries between
//     them, unlike the TPU grid);
//   - the block count is the wrapper's: it passes the block rows it chose
//     (ops/conv_mxu.py), allocates the partials for ceil(M / rows) blocks,
//     and an entry point refuses rows it was not built for.
//
// v3, the tensor-core path (bf16, Cin % 8 == 0, Cin <= 128, 16-byte-aligned
// x; every 3x3 conv of ResNet-56 but the 3-channel stem):
//   - mma.sync m16n8k16 bf16 -> fp32.  A fragments by ldmatrix from the
//     patch tile, B fragments by ldmatrix.trans straight out of the
//     row-major [9*Cin, Cout] weights;
//   - the K axis is cut into 32-wide stages of 16-byte chunks; a chunk is 8
//     channels of one tap of one pixel, contiguous in NHWC, copied by one
//     cp.async.ca (through L1, where the block's other pixels find it
//     again; zero-fill form for the border, the K tail and the M tail).  A per-chunk tap table and a per-pixel window table are built
//     once per block, so the loop does no division and no per-element check;
//   - a 5-deep cp.async ring over steps (every step of ResNet-56's stage-1
//     and stage-3 convs in flight at once), one __syncthreads per step;
//   - the whole weight matrix stays resident in shared memory (rows padded
//     by 16 bytes so ldmatrix.trans is conflict-free), streamed in with the
//     first steps that need each row and never reloaded;
//   - 4 warps per block, each a 16-row m-tile x all Cout.  The block owns
//     BM = 64 / k_split pixels; its k_split warp groups take interleaved
//     K stages and are summed through shared memory before the epilogue.
//     The wrapper picks the largest BM that still gives each of the 132
//     SMs a block: at least 256 blocks for a ResNet-56 conv at N=64 (v2:
//     64 at the 8x8 stage);
//   - the epilogue stages the fp32 tile in shared memory, applies
//     affine -> ReLU -> bf16, stores 16 bytes per thread, and reduces the
//     moments of the bf16 values by warp shuffles, then across warps.
//
// v2, the CUDA-core path (fp32, where TF32 would break the 1e-4 contract;
// Cin % 8 != 0, i.e. the stem's K = 27; an unaligned x): each block owns
// BM = 4096 / Cout output pixels x all Cout and loops over K in 32-wide
// slices, zero-padded in shared memory; each of its 256 threads keeps a 4
// pixel x 4 channel tile of fp32 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;   // output pixels per thread
constexpr int kTN = 4;   // output channels per thread
constexpr int kBK = 32;  // K slice staged in shared memory per step
constexpr int kFar = 1 << 20;  // an offset that fails every bounds check

template <int CO>
struct Tile {
  static constexpr int kColGroups = CO / kTN;              // threads across Cout
  static constexpr int kRowGroups = kThreads / kColGroups;  // threads across pixels
  static constexpr int kBM = kRowGroups * kTM;              // output pixels per block
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ mul, const float* __restrict__ add,
               T* __restrict__ y, float* __restrict__ psum,
               float* __restrict__ psq, int n, int h, int wd, int ci, int ho,
               int wo, int stride, int relu) {
  using Cfg = Tile<CO>;
  constexpr int BM = Cfg::kBM;
  // patch tile, K-major; the +1 column makes the transposed store (threads
  // walk K) hit 32 different banks
  __shared__ float a_s[kBK][BM + 1];
  __shared__ float b_s[kBK][CO];
  // per output pixel of the block: the input row/col of its top-left tap
  // (-1 = the padded border; kFar past the end of the output) and that
  // tap's element offset in x.  Per K column of the current slice: the
  // tap's row/col offset inside the window (kFar for the zero padding of
  // K) and its element offset from the window's top-left.  With both
  // tables the gather needs no integer division.
  __shared__ int row_h[BM], row_w[BM], row_base[BM];
  __shared__ int k_dy[kBK], k_dx[kBK], k_off[kBK];
  __shared__ float red[2][Cfg::kRowGroups][CO];

  const int tid = threadIdx.x;
  const int hw_out = ho * wo;
  const int M = n * hw_out;
  const int K = 9 * ci;
  const int m0 = blockIdx.x * BM;

  for (int r = tid; r < BM; r += kThreads) {
    const int m = m0 + r;
    if (m < M) {
      const int img = m / hw_out;
      const int rem = m - img * hw_out;
      const int oh = rem / wo;
      const int ow = rem - oh * wo;
      row_h[r] = oh * stride - 1;
      row_w[r] = ow * stride - 1;
      row_base[r] = ((img * h + row_h[r]) * wd + row_w[r]) * ci;
    } else {
      row_h[r] = kFar;
      row_w[r] = kFar;
      row_base[r] = 0;
    }
  }
  const int tc = tid % Cfg::kColGroups;  // this thread's channel group
  const int tr = tid / Cfg::kColGroups;  // this thread's pixel group
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (tid < kBK) {
      const int k = k0 + tid;
      if (k < K) {
        const int t = k / ci;
        const int ty = t / 3;
        const int tx = t - ty * 3;
        k_dy[tid] = ty;
        k_dx[tid] = tx;
        k_off[tid] = (ty * wd + tx) * ci + (k - t * ci);
      } else {
        k_dy[tid] = kFar;
        k_dx[tid] = kFar;
        k_off[tid] = 0;
      }
    }
    __syncthreads();
    // gather: consecutive threads take consecutive k of one pixel, so the
    // reads of one tap's channels are contiguous in the NHWC input
    for (int e = tid; e < kBK * BM; e += kThreads) {
      const int kk = e % kBK;
      const int r = e / kBK;
      const int ih = row_h[r] + k_dy[kk];
      const int iw = row_w[r] + k_dx[kk];
      float v = 0.f;
      if (static_cast<unsigned>(ih) < static_cast<unsigned>(h) &&
          static_cast<unsigned>(iw) < static_cast<unsigned>(wd))
        v = to_f32(x[row_base[r] + k_off[kk]]);
      a_s[kk][r] = v;
    }
    for (int e = tid; e < kBK * CO; e += kThreads) {
      const int kk = e / CO;
      const int c = e - kk * CO;
      const int k = k0 + kk;
      b_s[kk][c] = k < K ? to_f32(w[static_cast<size_t>(k) * CO + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = a_s[kk][tr * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = b_s[kk][tc * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: affine + ReLU in fp32, cast, store; moments of the stored values
  float s[kTN], sq[kTN], mj[kTN], aj[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int c = tc * kTN + j;
    s[j] = 0.f;
    sq[j] = 0.f;
    mj[j] = mul ? mul[c] : 1.f;
    aj[j] = add ? add[c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + tr * kTM + i;
    if (m < M) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        float v = acc[i][j] * mj[j] + aj[j];
        if (relu) v = fmaxf(v, 0.f);
        const T o = from_f32<T>(v);
        y[static_cast<size_t>(m) * CO + tc * kTN + j] = o;
        const float e = to_f32(o);
        s[j] += e;
        sq[j] += e * e;
      }
    }
  }
  if (psum == nullptr) return;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[0][tr][tc * kTN + j] = s[j];
    red[1][tr][tc * kTN + j] = sq[j];
  }
  __syncthreads();
  if (tid < CO) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < Cfg::kRowGroups; ++r) {
      a += red[0][r][tid];
      b += red[1][r][tid];
    }
    psum[static_cast<size_t>(blockIdx.x) * CO + tid] = a;
    psq[static_cast<size_t>(blockIdx.x) * CO + tid] = b;
  }
}

template <typename T, int CO>
int launch(const void* x, const void* w, const float* mul, const float* add,
           void* y, float* psum, float* psq, int n, int h, int wd, int ci,
           int stride, int relu, int bm, cudaStream_t stream) {
  if (bm != Tile<CO>::kBM) return static_cast<int>(cudaErrorInvalidValue);
  const int ho = h / stride, wo = wd / stride;
  const int m = n * ho * wo;
  const int blocks = (m + bm - 1) / bm;
  conv3x3_kernel<T, CO><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mul, add,
      static_cast<T*>(y), psum, psq, n, h, wd, ci, ho, wo, stride, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const float* mul, const float* add,
             void* y, float* psum, float* psq, int n, int h, int wd, int ci,
             int co, int stride, int relu, int bm, cudaStream_t stream) {
  switch (co) {
    case 16: return launch<T, 16>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, bm, stream);
    case 32: return launch<T, 32>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, bm, stream);
    case 64: return launch<T, 64>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, bm, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------- v3: tensor-core path

constexpr int kTcThreads = 128;   // 4 warps, each one 16-row m-tile x all Cout
constexpr int kTcRows = 64;       // patch rows staged per step: BM * k_split
constexpr int kTcBK = 32;         // K columns per stage: two m16n8k16 k-steps
constexpr int kTcAS = kTcBK + 8;  // patch row stride (elements): 80 B, so ldmatrix's 8 rows hit 32 banks
constexpr int kTcRing = 5;        // steps in flight in the cp.async ring
constexpr int kTcMaxCin = 128;    // keeps the resident weights and the tap table in shared memory

__host__ __device__ __forceinline__ int tc_kpad(int ci) {
  return (9 * ci + kTcBK - 1) / kTcBK * kTcBK;
}

// Byte offsets of the dynamic shared memory: resident weights [kpad][co + 8]
// bf16; the patch ring [kTcRing][kTcRows][kTcAS] bf16, reused after the K
// loop as the fp32 accumulator tile [kTcRows][co + 8]; the per-warp moment
// partials [2][4][co] fp32; the tap table 3 x [kpad / 8] int.
// ops/conv_mxu.py::_tc_smem_bytes mirrors `total`; the entry point refuses
// a size that differs.
struct TcLayout {
  int ring, wred, tab, total;
};

__host__ __device__ __forceinline__ TcLayout tc_layout(int ci, int co) {
  const int kpad = tc_kpad(ci);
  const int ring_bytes = kTcRing * kTcRows * kTcAS * 2;
  const int red_bytes = kTcRows * (co + 8) * 4;
  TcLayout l;
  l.ring = kpad * (co + 8) * 2;
  l.wred = l.ring + (ring_bytes > red_bytes ? ring_bytes : red_bytes);
  l.tab = l.wred + 2 * 4 * co * 4;
  l.total = l.tab + (3 * (kpad / 8) * 4 + 15) / 16 * 16;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not wait; zero-fills when !valid
// (src must still be a mapped address).  Through L1 (.ca): the blocks on an
// SM read the same weights, and a block's neighbouring pixels each other's
// taps (measured faster than .cg, which bypasses L1, at every ResNet-56
// shape; the weights alone halved the stage-1 conv).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
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

// c += a (16x16, row major) * b (16x8, column major); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: BM output pixels x all CO channels.  Warp `warp` multiplies
// rows [16 * warp, 16 * warp + 16) of each staged patch tile: the m-tile
// warp % (BM / 16) of the block and K part warp / (BM / 16), which takes
// stages kp, kp + KS, kp + 2 KS, ...
template <int CO, int BM>
__global__ void __launch_bounds__(kTcThreads)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ mul, const float* __restrict__ add,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ psum,
                  float* __restrict__ psq, int n, int h, int wd, int ci, int ho,
                  int wo, int stride, int relu) {
  constexpr int KS = kTcRows / BM;  // k_split
  constexpr int WS = CO + 8;        // weight row stride (bf16) and accumulator tile stride (fp32)
  constexpr int NT = CO / 8;        // n-tiles of 8 channels
  constexpr int CG = CO / 8;        // 16-byte output chunks per pixel
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout lay = tc_layout(ci, CO);
  const int kpad = tc_kpad(ci);
  const int nchunks = kpad / 8;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + lay.ring);
  float* acc_tile = reinterpret_cast<float*>(smem + lay.ring);  // after the K loop
  float* wred = reinterpret_cast<float*>(smem + lay.wred);
  int* tab_dy = reinterpret_cast<int*>(smem + lay.tab);
  int* tab_dx = tab_dy + nchunks;
  int* tab_off = tab_dx + nchunks;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix this lane addresses
  const int M = n * ho * wo;
  const int K = 9 * ci;
  const int m0 = blockIdx.x * BM;
  const int nstages = kpad / kTcBK;
  const int nsteps = (nstages + KS - 1) / KS;

  // per 16-byte chunk j of the K axis (8 channels of one tap, as Cin % 8 == 0):
  // the tap's row/col offset in the window (kFar past K: a zero chunk) and
  // its element offset from the window's top-left
  for (int j = tid; j < nchunks; j += kTcThreads) {
    const int k = j * 8;
    if (k < K) {
      const int t = k / ci;
      const int ty = t / 3, tx = t - 3 * ty;
      tab_dy[j] = ty;
      tab_dx[j] = tx;
      tab_off[j] = (ty * wd + tx) * ci + (k - t * ci);
    } else {
      tab_dy[j] = kFar;
      tab_dx[j] = kFar;
      tab_off[j] = 0;
    }
  }
  // this thread's two patch chunks per step: column chunk q of staged rows
  // r and r + 32, i.e. pixel rr of K part kp; the window's top-left row/col
  // (kFar past the end of the output) and its element offset in x
  const int q = tid & 3;
  int a_row[2], a_kp[2], a_h[2], a_w[2];
  long long a_base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 2) + 32 * i;
    const int kp = r / BM;
    const int m = m0 + r - kp * BM;
    a_row[i] = r;
    a_kp[i] = kp;
    if (m < M) {
      const int img = m / (ho * wo);
      const int rem = m - img * ho * wo;
      const int oh = rem / wo;
      const int ow = rem - oh * wo;
      a_h[i] = oh * stride - 1;
      a_w[i] = ow * stride - 1;
      a_base[i] = (static_cast<long long>(img * h + a_h[i]) * wd + a_w[i]) * ci;
    } else {
      a_h[i] = kFar;
      a_w[i] = kFar;
      a_base[i] = 0;
    }
  }
  __syncthreads();  // the tap table

  // Start step st: the patch chunks of stages st*KS .. st*KS + KS - 1 into
  // ring slot st % kTcRing, and those stages' weight rows into their
  // resident place (rows past K zero-filled).
  auto start_step = [&](int st) {
    __nv_bfloat16* slot = ring + (st % kTcRing) * (kTcRows * kTcAS);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = st * KS + a_kp[i];
      if (s < nstages) {
        const int j = s * (kTcBK / 8) + q;
        const int ih = a_h[i] + tab_dy[j];
        const int iw = a_w[i] + tab_dx[j];
        const bool valid = static_cast<unsigned>(ih) < static_cast<unsigned>(h) &&
                           static_cast<unsigned>(iw) < static_cast<unsigned>(wd);
        cp_async16(slot + a_row[i] * kTcAS + q * 8, valid ? x + a_base[i] + tab_off[j] : x, valid);
      }
    }
    const int k0 = st * KS * kTcBK;
    for (int e = tid; e < KS * kTcBK * CG; e += kTcThreads) {
      const int row = e / CG;
      const int c = e - row * CG;
      const int k = k0 + row;
      if (k < kpad) {
        const bool valid = k < K;
        cp_async16(ws + k * WS + c * 8, valid ? w + static_cast<size_t>(k) * CO + c * 8 : w, valid);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kTcRing - 1; ++st) {
    if (st < nsteps) start_step(st);
    cp_async_commit();
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int kp = warp / (BM / 16);
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<kTcRing - 2>();  // this thread's copies of step st have landed
    __syncthreads();               // everyone's have; every warp is done with step st - 1
    if (st + kTcRing - 1 < nsteps) start_step(st + kTcRing - 1);  // into step st - 1's slot
    cp_async_commit();
    const int s = st * KS + kp;
    if (s < nstages) {
      const __nv_bfloat16* at = ring + (st % kTcRing) * (kTcRows * kTcAS) + warp * 16 * kTcAS;
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, at + (lr + 8 * (lm & 1)) * kTcAS + kk * 16 + 8 * (lm >> 1));
        // rows k of this k-step, lo/hi halves; columns of n-tiles nt and nt + 1
        const __nv_bfloat16* wrow =
            ws + (s * kTcBK + kk * 16 + lr + 8 * (lm & 1)) * WS + 8 * (lm >> 1);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, wrow + nt * 8);
          mma_bf16(acc[nt], af, bf[0], bf[1]);
          mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the fp32 accumulator tile

  // accumulator element e of n-tile nt: row 16 * warp + g + 8 * (e >> 1),
  // column 8 * nt + 2 * t + (e & 1)
  {
    const int g = lane >> 2, t = lane & 3;
    float* row0 = acc_tile + (warp * 16 + g) * WS + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(row0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(row0 + 8 * WS + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();

  // epilogue: thread tid always owns channels [8 * cg, 8 * cg + 8) (the
  // thread count is a multiple of CG); it sums the K parts of a pixel's
  // chunk, applies affine + ReLU in fp32, casts, stores 16 bytes, and
  // accumulates the moments of the bf16 values
  const int cg = tid % CG;
  float mj[8], aj[8], s8[8], q8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mj[j] = mul ? mul[cg * 8 + j] : 1.f;
    aj[j] = add ? add[cg * 8 + j] : 0.f;
    s8[j] = 0.f;
    q8[j] = 0.f;
  }
  for (int e = tid; e < BM * CG; e += kTcThreads) {
    const int rr = e / CG;
    const int m = m0 + rr;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
#pragma unroll
    for (int p = 0; p < KS; ++p) {
      const float4* src = reinterpret_cast<const float4*>(acc_tile + (p * BM + rr) * WS + cg * 8);
      const float4 lo = src[0], hi = src[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    uint32_t packed[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float a = v[2 * jj] * mj[2 * jj] + aj[2 * jj];
      float b = v[2 * jj + 1] * mj[2 * jj + 1] + aj[2 * jj + 1];
      if (relu) {
        a = fmaxf(a, 0.f);
        b = fmaxf(b, 0.f);
      }
      const __nv_bfloat162 o = __floats2bfloat162_rn(a, b);
      packed[jj] = *reinterpret_cast<const uint32_t*>(&o);
      if (m < M) {
        const float ea = __low2float(o), eb = __high2float(o);
        s8[2 * jj] += ea;
        q8[2 * jj] += ea * ea;
        s8[2 * jj + 1] += eb;
        q8[2 * jj + 1] += eb * eb;
      }
    }
    if (m < M)
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * CO + cg * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  if (psum == nullptr) return;
  // lanes with one cg differ in the bits above log2(CG): fold them, then
  // lanes [0, CG) hold the warp's sums for channels [8 * lane, 8 * lane + 8)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = CG; off < 32; off <<= 1) {
      s8[j] += __shfl_xor_sync(0xffffffffu, s8[j], off);
      q8[j] += __shfl_xor_sync(0xffffffffu, q8[j], off);
    }
  }
  if (lane < CG) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wred[warp * CO + lane * 8 + j] = s8[j];
      wred[(4 + warp) * CO + lane * 8 + j] = q8[j];
    }
  }
  __syncthreads();
  if (tid < CO) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a += wred[r * CO + tid];
      b += wred[(4 + r) * CO + tid];
    }
    psum[static_cast<size_t>(blockIdx.x) * CO + tid] = a;
    psq[static_cast<size_t>(blockIdx.x) * CO + tid] = b;
  }
}

template <int CO, int BM>
int launch_tc(const void* x, const void* w, const float* mul, const float* add,
              void* y, float* psum, float* psq, int n, int h, int wd, int ci,
              int stride, int relu, int smem_bytes, cudaStream_t stream) {
  const auto kernel = conv3x3_tc_kernel<CO, BM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ho = h / stride, wo = wd / stride;
  const int m = n * ho * wo;
  const int blocks = (m + BM - 1) / BM;
  kernel<<<blocks, kTcThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), mul, add,
      static_cast<__nv_bfloat16*>(y), psum, psq, n, h, wd, ci, ho, wo, stride, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int CO>
int dispatch_tc(const void* x, const void* w, const float* mul, const float* add,
                void* y, float* psum, float* psq, int n, int h, int wd, int ci,
                int stride, int relu, int bm, int smem_bytes, cudaStream_t stream) {
  switch (bm) {
    case 64: return launch_tc<CO, 64>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, smem_bytes, stream);
    case 32: return launch_tc<CO, 32>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, smem_bytes, stream);
    case 16: return launch_tc<CO, 16>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Sums the per-block moment partials [2][nb][co] over the blocks, in block
// order within each thread's rows and then in a fixed tree: out [2][co].
// Block 0 takes the sums, block 1 the sums of squares.
constexpr int kReduceThreads = 1024;

__global__ void __launch_bounds__(kReduceThreads)
moments_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int nb, int co) {
  __shared__ float red[kReduceThreads];
  const float* p = part + static_cast<size_t>(blockIdx.x) * nb * co;
  const int groups = kReduceThreads / co;  // co divides the thread count
  const int c = threadIdx.x % co;
  float a = 0.f;
#pragma unroll 8
  for (int r = threadIdx.x / co; r < nb; r += groups) a += p[static_cast<size_t>(r) * co + c];
  red[threadIdx.x] = a;
  __syncthreads();
  for (int half = groups / 2; half > 0; half /= 2) {
    if (threadIdx.x < half * co) red[threadIdx.x] += red[threadIdx.x + half * co];
    __syncthreads();
  }
  if (threadIdx.x < co) out[blockIdx.x * co + threadIdx.x] = red[threadIdx.x];
}

}  // namespace

extern "C" {

// part [2, nb, co] fp32 (the (sum, sumsq) partials of nb blocks) -> out
// [2, co] fp32; co in {16, 32, 64}.  Returns the cudaError_t of the launch.
int conv3x3_mxu_moments_reduce(const void* part, void* out, int nb, int co, void* stream) {
  if (co != 16 && co != 32 && co != 64) return static_cast<int>(cudaErrorInvalidValue);
  moments_reduce_kernel<<<2, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nb, co);
  return static_cast<int>(cudaGetLastError());
}

// v2.  x [n, h, wd, ci] and w [9*ci, co] of one dtype (bf16 when is_bf16,
// else fp32), contiguous; y [n, h/stride, wd/stride, co] of that dtype.
// mul/add [co] fp32 or null (identity); psum/psq [ceil(m / bm), co] fp32 or
// null (no moments), m = n*(h/stride)*(wd/stride).  bm must be 4096 / co.
// Returns the cudaError_t of the launch.
int conv3x3_mxu_fwd(const void* x, const void* w, const void* mul,
                    const void* add, void* y, void* psum, void* psq, int n,
                    int h, int wd, int ci, int co, int stride, int relu,
                    int is_bf16, int bm, void* stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  const float* mulf = static_cast<const float*>(mul);
  const float* addf = static_cast<const float*>(add);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, co, stride, relu, bm, st);
  return dispatch<float>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, co, stride, relu, bm, st);
}

// v3, bf16 only.  The same tensors as conv3x3_mxu_fwd, with x and w
// 16-byte aligned and ci % 8 == 0, ci <= 128.  (bm, k_split) is the
// wrapper's tile plan: one of (64, 1), (32, 2), (16, 4); psum/psq hold
// ceil(m / bm) rows.  smem_bytes must equal the kernel's own layout for
// (ci, co).  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for anything above it does not take).
int conv3x3_mxu_tc_fwd(const void* x, const void* w, const void* mul,
                       const void* add, void* y, void* psum, void* psq, int n,
                       int h, int wd, int ci, int co, int stride, int relu,
                       int bm, int k_split, int smem_bytes, void* stream) {
  const bool ok = (stride == 1 || stride == 2) && ci > 0 && ci % 8 == 0 &&
                  ci <= kTcMaxCin && bm * k_split == kTcRows &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                  smem_bytes == tc_layout(ci, co).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* mulf = static_cast<const float*>(mul);
  const float* addf = static_cast<const float*>(add);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 16: return dispatch_tc<16>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, stride, relu, bm, smem_bytes, st);
    case 32: return dispatch_tc<32>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, stride, relu, bm, smem_bytes, st);
    case 64: return dispatch_tc<64>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, stride, relu, bm, smem_bytes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
