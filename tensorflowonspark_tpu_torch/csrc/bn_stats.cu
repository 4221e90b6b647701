// Batch-norm channel statistics for Hopper (sm_90a): hand-written
// counterparts of the two Pallas kernels of tensorflowonspark_tpu/ops/bn_kernels.py.
//
//   tfos_bn_pair_stats   B4, replaces _pair_kernel  (bn_kernels.py:101)
//       x (rows, C)      -> sum(x),  sum(x*x)    fp32 (C,) each
//   tfos_bn_cross_stats  B5, replaces _cross_kernel (bn_kernels.py:109)
//       dy, x (rows, C)  -> sum(dy), sum(dy*x)   fp32 (C,) each
//
// Bound. Each kernel reads every input element once and does three fp32
// operations on it (convert aside): under 2 operations per byte, where the
// card does ~20 fp32 operations per byte of HBM. So bytes bound it:
// rows*C*elem (B4) or twice that (B5) over 3.35 TB/s. ResNet-50 at batch 256,
// 224x224, bf16 streams 5.69 GB through B4 and 11.38 GB through B5 per train
// step: 1.70 and 3.40 ms.
//
// Design. The Pallas kernels carry their sums in a VMEM-resident output
// block across a sequential row grid. Blocks of a CUDA grid run in no order,
// so instead:
//  - threads own channel vectors: thread x of a block row owns VEC adjacent
//    channels (one 16-byte load: 8 bf16 or 4 fp32) and walks down the rows,
//    so neighbouring threads read neighbouring addresses; its sums stay in
//    fp32 registers. kUnroll rows are loaded before any is summed, so each
//    thread keeps kUnroll 16-byte loads (2*kUnroll for B5) in flight;
//  - the thread rows of a block (threadIdx.y) are summed in shared memory in
//    a fixed tree order;
//  - the rows are cut into gridDim.y contiguous splits, so that even C = 64
//    (8 channel vectors, one block column) puts several blocks on each of the
//    132 SMs; each split writes its partial sums into a (splits, 2, C) fp32
//    workspace that the Python wrapper allocates;
//  - a second kernel sums the splits of each channel in fp64: 32 thread
//    rows per channel each take every 32nd split in order, then a fixed tree
//    sums the rows, so repeated runs agree bit for bit (no float atomics);
//  - the ragged end of a split is masked, for both streams of B5 at once: a
//    row past the end is never read, so garbage (or NaN) there cannot leak;
//  - C not a multiple of VEC, or a base pointer that is not 16-byte aligned,
//    takes the scalar instance (VEC = 1) of the same kernel.
// The wrapper (ops/bn_kernels.py) chooses the geometry: the block width tx
// (channel vectors per block row, a power of two up to 32), the number of
// splits and the rows of each split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxSplits = 65535;
constexpr int kFinalX = 32;  // finalize: channels per block
constexpr int kFinalY = 32;  // finalize: thread rows over the splits

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC adjacent channels of one row, loaded with one instruction.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_f32(float (&f)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Vec<float, 4> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void to_f32(float (&f)[4]) const {
    f[0] = raw.x;
    f[1] = raw.y;
    f[2] = raw.z;
    f[3] = raw.w;
  }
};

template <typename T>
struct Vec<T, 1> {
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = p[0]; }
  __device__ __forceinline__ void to_f32(float (&f)[1]) const { f[0] = ::to_f32(raw); }
};

// Partial sums of one row split: (sum a, sum a*a) or, with CROSS,
// (sum a, sum a*b), written to ws[split][0][:] and ws[split][1][:].
template <typename T, int VEC, bool CROSS>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ ws, long long rows, int C,
                     long long rows_per_split) {
  __shared__ float red[2 * VEC][kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int cv = blockIdx.x * bx + tx;  // this thread's channel vector
  const bool live_c = cv < C / VEC;
  const long long c0 = (long long)cv * VEC;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);

  float s[VEC], q[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = q[v] = 0.f;

  for (long long r0 = r_begin + ty; r0 < r_end; r0 += (long long)by * kUnroll) {
    Vec<T, VEC> va[kUnroll], vb[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + (long long)u * by;
      live[u] = live_c && r < r_end;  // the ragged end of the split is masked
      if (live[u]) {
        va[u].load(a + r * C + c0);
        if constexpr (CROSS) vb[u].load(b + r * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      float fa[VEC];
      va[u].to_f32(fa);
      if constexpr (CROSS) {
        float fb[VEC];
        vb[u].to_f32(fb);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          s[v] += fa[v];
          q[v] += fa[v] * fb[v];
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          s[v] += fa[v];
          q[v] += fa[v] * fa[v];
        }
      }
    }
  }

  // sum the block's thread rows: a fixed tree over threadIdx.y
  const int t = ty * bx + tx;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    red[v][t] = s[v];
    red[VEC + v][t] = q[v];
  }
  __syncthreads();
  for (int half = by / 2; half > 0; half /= 2) {
    if (ty < half) {
      const int o = t + half * bx;
#pragma unroll
      for (int k = 0; k < 2 * VEC; ++k) red[k][t] += red[k][o];
    }
    __syncthreads();
  }
  if (ty == 0 && live_c) {
    float* out = ws + (long long)blockIdx.y * 2 * C + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      out[v] = red[v][tx];
      out[C + v] = red[VEC + v][tx];
    }
  }
}

// out_a[c] = sum over splits of ws[s][0][c]; out_b likewise from ws[s][1].
// A block covers kFinalX channels (x) with kFinalY thread rows (y): thread
// row y sums splits y, y + kFinalY, ... in order, in fp64, and the rows are
// then summed in a fixed tree, so the result does not depend on the
// schedule.
__global__ void __launch_bounds__(kFinalX * kFinalY)
stats_finalize_kernel(const float* __restrict__ ws, float* __restrict__ out_a,
                      float* __restrict__ out_b, int splits, int C) {
  __shared__ double red[2][kFinalY][kFinalX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinalX + tx;
  double sa = 0.0, sb = 0.0;
  if (c < C) {
    for (int s = ty; s < splits; s += kFinalY) {  // every split's partial, in a fixed order
      sa += ws[2LL * s * C + c];
      sb += ws[(2LL * s + 1) * C + c];
    }
  }
  red[0][ty][tx] = sa;
  red[1][ty][tx] = sb;
  __syncthreads();
  for (int half = kFinalY / 2; half > 0; half /= 2) {
    if (ty < half) {
      red[0][ty][tx] += red[0][ty + half][tx];
      red[1][ty][tx] += red[1][ty + half][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && c < C) {
    out_a[c] = (float)red[0][0][tx];
    out_b[c] = (float)red[1][0][tx];
  }
}

template <typename T, int VEC, bool CROSS>
void launch_partial(dim3 grid, dim3 block, cudaStream_t stream, const void* a, const void* b,
                    float* ws, long long rows, int C, long long rows_per_split) {
  stats_partial_kernel<T, VEC, CROSS><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), ws, rows, C, rows_per_split);
}

// dtype: 0 float32, 1 bfloat16. vec: 16 / element size, or 1 (scalar loads).
template <bool CROSS>
int launch(const void* a, const void* b, void* ws_, void* out_a, void* out_b, long long rows,
           int C, int dtype, int vec, int tx, int splits, long long rows_per_split,
           void* stream_) {
  if (rows <= 0 || C <= 0 || vec <= 0 || C % vec || tx <= 0 || tx > 32 || kThreads % tx ||
      splits <= 0 || splits > kMaxSplits || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  float* ws = static_cast<float*>(ws_);
  const int nvec = C / vec;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((nvec + tx - 1) / tx, splits);
  if (dtype == 1 && vec == 8) {
    launch_partial<__nv_bfloat16, 8, CROSS>(grid, block, stream, a, b, ws, rows, C, rows_per_split);
  } else if (dtype == 1 && vec == 1) {
    launch_partial<__nv_bfloat16, 1, CROSS>(grid, block, stream, a, b, ws, rows, C, rows_per_split);
  } else if (dtype == 0 && vec == 4) {
    launch_partial<float, 4, CROSS>(grid, block, stream, a, b, ws, rows, C, rows_per_split);
  } else if (dtype == 0 && vec == 1) {
    launch_partial<float, 1, CROSS>(grid, block, stream, a, b, ws, rows, C, rows_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_finalize_kernel<<<(C + kFinalX - 1) / kFinalX, dim3(kFinalX, kFinalY), 0, stream>>>(
      ws, static_cast<float*>(out_a), static_cast<float*>(out_b), splits, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfos_bn_pair_stats(const void* x, void* ws, void* out_sum, void* out_sq,
                                  long long rows, int C, int dtype, int vec, int tx,
                                  int splits, long long rows_per_split, void* stream) {
  return launch<false>(x, nullptr, ws, out_sum, out_sq, rows, C, dtype, vec, tx, splits,
                       rows_per_split, stream);
}

extern "C" int tfos_bn_cross_stats(const void* dy, const void* x, void* ws, void* out_sum,
                                   void* out_dot, long long rows, int C, int dtype, int vec,
                                   int tx, int splits, long long rows_per_split, void* stream) {
  return launch<true>(dy, x, ws, out_sum, out_dot, rows, C, dtype, vec, tx, splits,
                      rows_per_split, stream);
}
