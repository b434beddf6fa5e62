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
// What bounds it on the H100: at ResNet-56's shapes the conv is small and
// memory-bound.  The stage-1 body (16->16 channels, 32x32, N=64) in bf16
// moves ~4.2 MB (2.1 MB in, 2.1 MB out) for 0.30 GFLOP: ~72 FLOP/byte, far
// under the ~295 FLOP/byte where bf16 tensor cores become the limit, so the
// floor is ~1.3 us of HBM traffic, not arithmetic.  The design therefore
// spends no effort on tensor cores (CUDA-core FMA, fp32 accumulators) and
// all of it on touching HBM once:
//   - no padded copy and no materialized patch matrix: each block gathers
//     its patch tile straight from the NHWC input into shared memory, with
//     the zero border done by bounds checks (the nine-fold re-reads of a
//     pixel hit L1/L2, not HBM);
//   - K (27 for the stem, which is no multiple of 8/16) is zero-padded
//     inside shared memory to the 32-wide K slice;
//   - the epilogue and the moments run on the accumulators in registers, so
//     BatchNorm's batch statistics cost no second pass over the output;
//   - moments are per-block partials written to a [num_blocks, Cout] fp32
//     buffer and summed by the wrapper: no atomics, so a run is
//     deterministic (blocks run in no order and nothing carries between
//     them, unlike the TPU grid).
// Each block owns BM output pixels x all Cout (16/32/64) and loops over K in
// 32-wide slices; each of its 256 threads keeps a 4 pixel x 4 channel tile
// of fp32 accumulators.  wgmma/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

template <int CO>
int block_rows() {
  return Tile<CO>::kBM;
}

int rows_for(int co) {
  switch (co) {
    case 16: return block_rows<16>();
    case 32: return block_rows<32>();
    case 64: return block_rows<64>();
    default: return -1;
  }
}

template <typename T, int CO>
int launch(const void* x, const void* w, const float* mul, const float* add,
           void* y, float* psum, float* psq, int n, int h, int wd, int ci,
           int stride, int relu, cudaStream_t stream) {
  const int ho = h / stride, wo = wd / stride;
  const int m = n * ho * wo;
  const int blocks = (m + Tile<CO>::kBM - 1) / Tile<CO>::kBM;
  conv3x3_kernel<T, CO><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mul, add,
      static_cast<T*>(y), psum, psq, n, h, wd, ci, ho, wo, stride, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const float* mul, const float* add,
             void* y, float* psum, float* psq, int n, int h, int wd, int ci,
             int co, int stride, int relu, cudaStream_t stream) {
  switch (co) {
    case 16: return launch<T, 16>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, stream);
    case 32: return launch<T, 32>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, stream);
    case 64: return launch<T, 64>(x, w, mul, add, y, psum, psq, n, h, wd, ci, stride, relu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Rows of the [num_blocks, Cout] moment-partial buffers for an output of
// m = N*Ho*Wo pixels; -1 for a Cout the kernel does not take.
int conv3x3_mxu_num_blocks(int m, int co) {
  const int bm = rows_for(co);
  return bm < 0 ? -1 : (m + bm - 1) / bm;
}

// x [n, h, wd, ci] and w [9*ci, co] of one dtype (bf16 when is_bf16, else
// fp32), contiguous; y [n, h/stride, wd/stride, co] of that dtype.  mul/add
// [co] fp32 or null (identity); psum/psq [num_blocks, co] fp32 or null (no
// moments).  Returns the cudaError_t of the launch.
int conv3x3_mxu_fwd(const void* x, const void* w, const void* mul,
                    const void* add, void* y, void* psum, void* psq, int n,
                    int h, int wd, int ci, int co, int stride, int relu,
                    int is_bf16, void* stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  const float* mulf = static_cast<const float*>(mul);
  const float* addf = static_cast<const float*>(add);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, co, stride, relu, st);
  return dispatch<float>(x, w, mulf, addf, y, ps, pq, n, h, wd, ci, co, stride, relu, st);
}

}  // extern "C"
