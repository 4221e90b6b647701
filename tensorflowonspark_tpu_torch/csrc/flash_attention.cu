// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of tensorflowonspark_tpu/ops/flash_attention.py:
//   fwd_mma_kernel / fwd_kernel  <- _fwd_kernel  (flash_attention.py:134, pallas_call :303)
//   dq_mma_kernel  / dq_kernel   <- _dq_kernel   (flash_attention.py:343, pallas_call :550)
//   dkv_mma_kernel / dkv_kernel  <- _dkv_kernel  (flash_attention.py:400, pallas_call :600)
// (the *_mma_kernel for bf16 inputs, the others for fp32).
//
// What bounds them on an H100 SXM (989 TFLOP/s dense bf16 in the tensor
// cores, 67 TFLOP/s fp32 outside them, 3.35 TB/s HBM), at the llama_1b
// training shape (B=8, S=1024, H=16, D=128, bf16, causal; the products
// count only the live half of each score matrix):
//   fwd:   2 products (QK^T, PV) = 3.4e10 FLOP -> 35 us; reads Q, K, V and
//          writes O and LSE: 135 MB -> 40 us. Bound by bytes.
//   dQ:    3 products (QK^T, dO V^T, dS K) = 5.2e10 FLOP -> 52 us; reads
//          Q, K, V, dO, LSE, delta, writes dQ: 169 MB -> 50 us.
//   dK/dV: 4 products (QK^T, dO V^T, P^T dO, dS^T Q) = 6.9e10 FLOP -> 69 us;
//          reads Q, K, V, dO, LSE, delta, writes dK, dV: 202 MB -> 60 us.
// All three sit near the ridge, so the design keeps every score tile
// (S, P, dP, dS) on chip: only the inputs, outputs and the two fp32 row
// statistics cross HBM, and each input tile is read once per block that
// needs it.
//
// Two implementations share the grid, the masks and the tile skipping:
//   - bf16 inputs (the training path) run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate); P and dS are rounded to
//     bf16 before their products, as FlashAttention-2 does;
//   - fp32 inputs run fp32 FMA tiles, exact to fp32 rounding.
// Neither uses wgmma or TMA yet, nor overlaps the next tile's loads with
// the current tile's products.
//
// Design (one block owns one output tile and loops over the other axis;
// nothing is carried across blocks, since Hopper runs blocks in no order):
//   - fwd, dQ: a block owns (batch*q-head, 64 query rows) and streams the
//     64-key tiles of its KV head. GQA is index arithmetic on the KV head,
//     with no repeat of K/V.
//   - dK/dV: a block owns (batch*kv-head, 64 keys) and streams the query
//     tiles of every q head of its GQA group, so the group sum of
//     flash_attention.py:626-632 happens in fp32 inside the block.
//   - Tiles whose keys are all outside the end-aligned causal frontier or
//     below the sliding window are never visited (O(S*W) work under a
//     window); masked entries inside a visited tile get probability 0.
//   - Q/K/V/dO are read in their (B, S, H, D) layout straight from the
//     model's projections: no transpose. LSE and delta are fp32 (B*Hq, Sq).
//   - Dead rows (no live key): O = 0 and LSE = NEG_INF; their dQ is 0 and
//     they add nothing to dK/dV. NEG_INF is the finite -1e30 of the JAX
//     package.
// Inputs: fp32 or bf16, head dim 64 or 128, 16-byte aligned.
// Each entry point returns cudaGetLastError() (or -1 for an unsupported
// dtype/head dim); the launch goes on the caller's stream and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;     // query rows per tile
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads of an fp32 block: 16 x 16
constexpr int LDP = BK + 1;  // padded row stride of a (64, 64) score tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* seg;
  void* out;       // fwd: O; dq: dQ; dkv: dK
  void* out2;      // dkv: dV
  float* lse_out;  // fwd: LSE
  int b, sq, sk, hq, hk;
  int causal, window;
  float scale;
};

// Copy a (64, D) tile of rows s0.. of head h, batch b, from an fp32
// (B, S, H, D) tensor into shared memory with row stride D + 1. Rows past
// S are 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b, int s0,
                                          int S, int H, int h) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D;
    const int s = s0 + r;
    float x = 0.f;
    if (s < S) x = src[(((size_t)b * S + s) * H + h) * D + d];
    dst[r * LD + d] = x;
  }
}

// acc[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d]  (a (64, 64) tile of A B^T)
template <int D>
__device__ __forceinline__ void tile_abt(float acc[4][4], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[ty+16i][r] * X[r][tx+16j]   (P X, P a score tile)
template <int D>
__device__ __forceinline__ void tile_px(float acc[4][D / 16], const float* P, const float* X,
                                        int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * LDP + r];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = X[r * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r P[r][ty+16i] * X[r][tx+16j]   (P^T X)
template <int D>
__device__ __forceinline__ void tile_ptx(float acc[4][D / 16], const float* P, const float* X,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[r * LDP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float x = X[r * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
    }
  }
}

// Sum over the 16 lanes that hold one row (lanes differ only in bits 0-3).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Query i attends key j: in range, end-aligned causal (j <= i + sk - sq),
// inside the window (i + sk - sq - j < window), same segment.
__device__ __forceinline__ bool is_live(const Args& a, int i, int j, int seg_i, int seg_j) {
  const int off = a.sk - a.sq;
  bool ok = (i < a.sq) && (j < a.sk);
  if (a.causal) ok = ok && (j <= i + off);
  if (a.window > 0) ok = ok && (i + off - j < a.window);
  if (a.seg) ok = ok && (seg_i == seg_j);
  return ok;
}

// Keys [lo, hi) that queries [q0, q0 + BQ) can reach.
__device__ __forceinline__ void key_range(const Args& a, int q0, int& lo, int& hi) {
  const int off = a.sk - a.sq;
  lo = 0;
  hi = a.sk;
  if (a.causal) hi = min(a.sk, min(q0 + BQ, a.sq) + off);
  if (a.window > 0) lo = max(0, q0 + off - a.window + 1);
  lo = (lo / BK) * BK;
}

// Queries [lo, hi) that can reach keys [k0, k0 + BK).
__device__ __forceinline__ void query_range(const Args& a, int k0, int& lo, int& hi) {
  const int off = a.sk - a.sq;
  lo = 0;
  hi = a.sq;
  if (a.causal) lo = max(0, k0 - off);
  if (a.window > 0) hi = min(a.sq, min(k0 + BK, a.sk) - 1 - off + a.window);
  lo = (lo / BQ) * BQ;
}

// (The two loaders below cover their 64 entries with threads 0..63, so
// they serve the 256-thread and the 128-thread blocks alike.)
__device__ __forceinline__ void load_seg(int* dst, const Args& a, int bi, int s0, int S, int fill) {
  if (a.seg == nullptr) return;
  for (int t = threadIdx.x; t < 64; t += NT)
    dst[t] = (s0 + t < S) ? a.seg[(size_t)bi * S + s0 + t] : fill;
}

template <int D>
__global__ void __launch_bounds__(NT) fwd_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* Ps = Vs + 64 * LD;
  int* segq = reinterpret_cast<int*>(Ps + 64 * LDP);
  int* segk = segq + 64;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int bi = bh / a.hq, h = bh % a.hq;
  const int hkv = h / (a.hq / a.hk);

  load_tile<D>(Qs, static_cast<const float*>(a.q), bi, q0, a.sq, a.hq, h);
  load_seg(segq, a, bi, q0, a.sq, -1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  int k_lo, k_hi;
  key_range(a, q0, k_lo, k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, static_cast<const float*>(a.k), bi, k0, a.sk, a.hk, hkv);
    load_tile<D>(Vs, static_cast<const float*>(a.v), bi, k0, a.sk, a.hk, hkv);
    load_seg(segk, a, bi, k0, a.sk, -2);
    __syncthreads();

    float s[4][4];
    tile_abt<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = is_live(a, q0 + r, k0 + c, a.seg ? segq[r] : 0, a.seg ? segk[c] : 0);
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] > NEG_INF / 2) ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LDP + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_px<D>(acc, Ps, Vs, ty, tx);
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.sq) continue;
    const bool dead = !(l[i] > 0.f);
    const float inv = dead ? 0.f : 1.f / l[i];
    float* row = out + (((size_t)bi * a.sq + qi) * a.hq + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) row[tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) a.lse_out[(size_t)bh * a.sq + qi] = dead ? NEG_INF : m[i] + logf(l[i]);
  }
}

// P = exp(scale*QK^T - LSE) on live entries of live rows, else 0;
// dS = P * (dO V^T - delta). Rows r = ty+16i of the Q tile, keys c = tx+16j.
template <int D>
__device__ __forceinline__ void probs_and_ds(const Args& a, float p[4][4], float ds[4][4],
                                             const float* Qs, const float* Ks, const float* dOs,
                                             const float* Vs, const float* lse_s,
                                             const float* delta_s, const int* segq,
                                             const int* segk, int q0, int k0, int ty, int tx) {
  float dp[4][4];
  tile_abt<D>(p, Qs, Ks, ty, tx);
  tile_abt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float lse = lse_s[r];
    const float dlt = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = (lse > NEG_INF / 2) &&
                      is_live(a, q0 + r, k0 + c, a.seg ? segq[r] : 0, a.seg ? segk[c] : 0);
      p[i][j] = ok ? expf(p[i][j] * a.scale - lse) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dlt);
    }
  }
}

__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, const Args& a,
                                               int bh, int q0) {
  for (int t = threadIdx.x; t < 64; t += NT) {
    const bool in = q0 + t < a.sq;
    lse_s[t] = in ? a.lse[(size_t)bh * a.sq + q0 + t] : NEG_INF;
    delta_s[t] = in ? a.delta[(size_t)bh * a.sq + q0 + t] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* dSs = Vs + 64 * LD;
  float* lse_s = dSs + 64 * LDP;
  float* delta_s = lse_s + 64;
  int* segq = reinterpret_cast<int*>(delta_s + 64);
  int* segk = segq + 64;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int bi = bh / a.hq, h = bh % a.hq;
  const int hkv = h / (a.hq / a.hk);

  load_tile<D>(Qs, static_cast<const float*>(a.q), bi, q0, a.sq, a.hq, h);
  load_tile<D>(dOs, static_cast<const float*>(a.dout), bi, q0, a.sq, a.hq, h);
  load_row_stats(lse_s, delta_s, a, bh, q0);
  load_seg(segq, a, bi, q0, a.sq, -1);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  int k_lo, k_hi;
  key_range(a, q0, k_lo, k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile<D>(Ks, static_cast<const float*>(a.k), bi, k0, a.sk, a.hk, hkv);
    load_tile<D>(Vs, static_cast<const float*>(a.v), bi, k0, a.sk, a.hk, hkv);
    load_seg(segk, a, bi, k0, a.sk, -2);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_ds<D>(a, p, ds, Qs, Ks, dOs, Vs, lse_s, delta_s, segq, segk, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_px<D>(acc, dSs, Ks, ty, tx);  // dQ += dS K
  }

  float* dq = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.sq) continue;
    float* row = dq + (((size_t)bi * a.sq + qi) * a.hq + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) row[tx + 16 * j] = acc[i][j] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dkv_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LD;
  float* dSs = Ps + 64 * LDP;
  float* lse_s = dSs + 64 * LDP;
  float* delta_s = lse_s + 64;
  int* segq = reinterpret_cast<int*>(delta_s + 64);
  int* segk = segq + 64;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const int bkh = blockIdx.y;
  const int bi = bkh / a.hk, hkv = bkh % a.hk;
  const int group = a.hq / a.hk;

  load_tile<D>(Ks, static_cast<const float*>(a.k), bi, k0, a.sk, a.hk, hkv);
  load_tile<D>(Vs, static_cast<const float*>(a.v), bi, k0, a.sk, a.hk, hkv);
  load_seg(segk, a, bi, k0, a.sk, -2);

  // rows of these accumulators are keys k0 + ty + 16i
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[i][j] = dv[i][j] = 0.f;

  int q_lo, q_hi;
  query_range(a, k0, q_lo, q_hi);
  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const int bh = bi * a.hq + h;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();
      load_tile<D>(Qs, static_cast<const float*>(a.q), bi, q0, a.sq, a.hq, h);
      load_tile<D>(dOs, static_cast<const float*>(a.dout), bi, q0, a.sq, a.hq, h);
      load_row_stats(lse_s, delta_s, a, bh, q0);
      load_seg(segq, a, bi, q0, a.sq, -1);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_ds<D>(a, p, ds, Qs, Ks, dOs, Vs, lse_s, delta_s, segq, segk, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
          dSs[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      tile_ptx<D>(dv, Ps, dOs, ty, tx);  // dV += P^T dO
      tile_ptx<D>(dk, dSs, Qs, ty, tx);  // dK += dS^T Q
    }
  }

  float* dkp = static_cast<float*>(a.out);
  float* dvp = static_cast<float*>(a.out2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= a.sk) continue;
    const size_t base = (((size_t)bi * a.sk + kj) * a.hk + hkv) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dkp[base + tx + 16 * j] = dk[i][j] * a.scale;
      dvp[base + tx + 16 * j] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the same three kernels on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate). A block has 4 warps; each warp owns
// 16 rows of the block's 64 (query rows in fwd/dQ, keys in dK/dV). Tiles
// stay bf16 in shared memory with a row stride of D + 8 elements, so the
// fragment loads of a warp hit 32 distinct banks. Score tiles never leave
// registers: the accumulator layout of S (or P, dS) is reused as the A
// operand of the next product, rounded to bf16 as FlashAttention-2 does.
// ---------------------------------------------------------------------------

constexpr int MT = 128;  // threads of an mma block (4 warps)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (64, D) bf16 tile of rows s0.. of head h into shared memory (row stride
// D + 8), 16 bytes per load; rows past S are 0.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int b, int s0,
                                               int S, int H, int h) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < 64 * VPR; e += MT) {
    const int r = e / VPR, c = (e % VPR) * 8;
    const int s = s0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (s < S) x = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// acc[j] (j < N/8) = X[r0.., :] Y[n0 + 8j.., :]^T over the D columns:
// A rows r0..r0+15 of X, B[k][n] = Y[n][k] (both row-major, stride D + 8).
template <int D, int N>
__device__ __forceinline__ void mma_xyt(float acc[N / 8][4], const bf16* X, int r0,
                                        const bf16* Y, int n0, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int k0 = kk * 16 + t * 2;
    uint32_t a[4];
    a[0] = ld32(X + (r0 + g) * LD + k0);
    a[1] = ld32(X + (r0 + g + 8) * LD + k0);
    a[2] = ld32(X + (r0 + g) * LD + k0 + 8);
    a[3] = ld32(X + (r0 + g + 8) * LD + k0 + 8);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* y = Y + (n0 + j * 8 + g) * LD + k0;
      mma16816(acc[j], a, ld32(y), ld32(y + 8));
    }
  }
}

// acc[n] (n < D/8) += P Z[z0.., :], with P a (16, K) tile held in the
// accumulator layout p[K/8][4] (rounded to bf16 here) and B[k][n] = Z[z0+k][n].
template <int D, int K>
__device__ __forceinline__ void mma_pz(float acc[D / 8][4], const float p[K / 8][4],
                                       const bf16* Z, int z0, int g, int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_f2(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_f2(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_f2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_f2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* z = Z + (z0 + kk * 16 + t * 2) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* zn = z + n * 8;
      mma16816(acc[n], a, pack_h2(zn[0], zn[LD]), pack_h2(zn[8 * LD], zn[9 * LD]));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MT) fwd_mma_kernel(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ float smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + 64 * LD;
  bf16* Vs = Ks + 64 * LD;
  int* segq = reinterpret_cast<int*>(Vs + 64 * LD);
  int* segk = segq + 64;

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int bi = bh / a.hq, h = bh % a.hq;
  const int hkv = h / (a.hq / a.hk);
  const int r0 = w * 16;  // this warp's rows of the tile

  load_tile_bf16<D>(Qs, static_cast<const bf16*>(a.q), bi, q0, a.sq, a.hq, h);
  load_seg(segq, a, bi, q0, a.sq, -1);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int k_lo, k_hi;
  key_range(a, q0, k_lo, k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile_bf16<D>(Ks, static_cast<const bf16*>(a.k), bi, k0, a.sk, a.hk, hkv);
    load_tile_bf16<D>(Vs, static_cast<const bf16*>(a.v), bi, k0, a.sk, a.hk, hkv);
    load_seg(segk, a, bi, k0, a.sk, -2);
    __syncthreads();

    float s[8][4];
    mma_xyt<D, 64>(s, Qs, r0, Ks, 0, g, t);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8, c = j * 8 + t * 2 + (e & 1);
        const bool ok = is_live(a, q0 + r, k0 + c, a.seg ? segq[r] : 0, a.seg ? segk[c] : 0);
        s[j][e] = ok ? s[j][e] * a.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (s[j][e] > NEG_INF / 2) ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = alpha[i] * l[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    mma_pz<D, 64>(o, s, Vs, 0, g, t);
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + i * 8;
    if (qi >= a.sq) continue;
    const bool dead = !(l[i] > 0.f);
    const float inv = dead ? 0.f : 1.f / l[i];
    bf16* row = out + (((size_t)bi * a.sq + qi) * a.hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + t * 2) =
          pack_f2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t == 0) a.lse_out[(size_t)bh * a.sq + qi] = dead ? NEG_INF : m[i] + logf(l[i]);
  }
}

// A live entry of a row that has a live key at all (LSE above NEG_INF).
__device__ __forceinline__ bool live_entry(const Args& a, float lse, int qi, int kj, int seg_i,
                                           int seg_j) {
  return lse > NEG_INF / 2 && is_live(a, qi, kj, seg_i, seg_j);
}

template <int D>
__global__ void __launch_bounds__(MT) dq_mma_kernel(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ float smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + 64 * LD;
  bf16* Ks = dOs + 64 * LD;
  bf16* Vs = Ks + 64 * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + 64 * LD);
  float* delta_s = lse_s + 64;
  int* segq = reinterpret_cast<int*>(delta_s + 64);
  int* segk = segq + 64;

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int bi = bh / a.hq, h = bh % a.hq;
  const int hkv = h / (a.hq / a.hk);
  const int r0 = w * 16;

  load_tile_bf16<D>(Qs, static_cast<const bf16*>(a.q), bi, q0, a.sq, a.hq, h);
  load_tile_bf16<D>(dOs, static_cast<const bf16*>(a.dout), bi, q0, a.sq, a.hq, h);
  load_row_stats(lse_s, delta_s, a, bh, q0);
  load_seg(segq, a, bi, q0, a.sq, -1);

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int k_lo, k_hi;
  key_range(a, q0, k_lo, k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile_bf16<D>(Ks, static_cast<const bf16*>(a.k), bi, k0, a.sk, a.hk, hkv);
    load_tile_bf16<D>(Vs, static_cast<const bf16*>(a.v), bi, k0, a.sk, a.hk, hkv);
    load_seg(segk, a, bi, k0, a.sk, -2);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_xyt<D, 64>(s, Qs, r0, Ks, 0, g, t);
    mma_xyt<D, 64>(dp, dOs, r0, Vs, 0, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8, c = j * 8 + t * 2 + (e & 1);
        const bool ok = live_entry(a, lse_s[r], q0 + r, k0 + c, a.seg ? segq[r] : 0,
                                   a.seg ? segk[c] : 0);
        const float p = ok ? expf(s[j][e] * a.scale - lse_s[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_s[r]);  // dS
      }
    mma_pz<D, 64>(dq, s, Ks, 0, g, t);  // dQ += dS K
  }

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + i * 8;
    if (qi >= a.sq) continue;
    bf16* row = out + (((size_t)bi * a.sq + qi) * a.hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + t * 2) =
          pack_f2(dq[n][2 * i] * a.scale, dq[n][2 * i + 1] * a.scale);
  }
}

// dK/dV: each warp owns 16 keys; the 64 queries of a loaded tile are
// taken 32 at a time to bound the registers held beside dK and dV.
template <int D>
__global__ void __launch_bounds__(MT) dkv_mma_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int QS = 32;
  extern __shared__ float smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + 64 * LD;
  bf16* Qs = Vs + 64 * LD;
  bf16* dOs = Qs + 64 * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + 64 * LD);
  float* delta_s = lse_s + 64;
  int* segq = reinterpret_cast<int*>(delta_s + 64);
  int* segk = segq + 64;

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int bkh = blockIdx.y;
  const int bi = bkh / a.hk, hkv = bkh % a.hk;
  const int group = a.hq / a.hk;
  const int r0 = w * 16;  // this warp's keys of the tile

  load_tile_bf16<D>(Ks, static_cast<const bf16*>(a.k), bi, k0, a.sk, a.hk, hkv);
  load_tile_bf16<D>(Vs, static_cast<const bf16*>(a.v), bi, k0, a.sk, a.hk, hkv);
  load_seg(segk, a, bi, k0, a.sk, -2);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int q_lo, q_hi;
  query_range(a, k0, q_lo, q_hi);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hkv * group + gi;
    const int bh = bi * a.hq + h;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();
      load_tile_bf16<D>(Qs, static_cast<const bf16*>(a.q), bi, q0, a.sq, a.hq, h);
      load_tile_bf16<D>(dOs, static_cast<const bf16*>(a.dout), bi, q0, a.sq, a.hq, h);
      load_row_stats(lse_s, delta_s, a, bh, q0);
      load_seg(segq, a, bi, q0, a.sq, -1);
      __syncthreads();
#pragma unroll
      for (int qs = 0; qs < 64; qs += QS) {
        // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries
        float st[QS / 8][4], dpt[QS / 8][4];
        mma_xyt<D, QS>(st, Ks, r0, Qs, qs, g, t);
        mma_xyt<D, QS>(dpt, Vs, r0, dOs, qs, g, t);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = r0 + g + (e >> 1) * 8, qc = qs + j * 8 + t * 2 + (e & 1);
            const bool ok = live_entry(a, lse_s[qc], q0 + qc, k0 + kr,
                                       a.seg ? segq[qc] : 0, a.seg ? segk[kr] : 0);
            const float p = ok ? expf(st[j][e] * a.scale - lse_s[qc]) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - delta_s[qc]);  // dS^T
          }
        mma_pz<D, QS>(dv, st, dOs, qs, g, t);   // dV += P^T dO
        mma_pz<D, QS>(dk, dpt, Qs, qs, g, t);   // dK += dS^T Q
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(a.out);
  bf16* dvp = static_cast<bf16*>(a.out2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + r0 + g + i * 8;
    if (kj >= a.sk) continue;
    const size_t base = (((size_t)bi * a.sk + kj) * a.hk + hkv) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkp + base + n * 8 + t * 2) =
          pack_f2(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + base + n * 8 + t * 2) =
          pack_f2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <int D> constexpr size_t fwd_mma_smem() {
  return 3 * 64 * (D + 8) * sizeof(bf16) + 128 * sizeof(int);
}
template <int D> constexpr size_t bwd_mma_smem() {
  return 4 * 64 * (D + 8) * sizeof(bf16) + 128 * sizeof(float) + 128 * sizeof(int);
}

template <int D> constexpr size_t fwd_smem() {
  return (3 * 64 * (D + 1) + 64 * LDP) * sizeof(float) + 128 * sizeof(int);
}
template <int D> constexpr size_t dq_smem() {
  return (4 * 64 * (D + 1) + 64 * LDP + 128) * sizeof(float) + 128 * sizeof(int);
}
template <int D> constexpr size_t dkv_smem() {
  return (4 * 64 * (D + 1) + 2 * 64 * LDP + 128) * sizeof(float) + 128 * sizeof(int);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads, const Args& a, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

enum Which { FWD, DQ, DKV };

// fp32 inputs: the FMA kernels
template <int D>
int dispatch_f32(Which w, const Args& a, dim3 gq, dim3 gk, void* stream) {
  switch (w) {
    case FWD: return launch(fwd_kernel<D>, fwd_smem<D>(), gq, NT, a, stream);
    case DQ: return launch(dq_kernel<D>, dq_smem<D>(), gq, NT, a, stream);
    case DKV: return launch(dkv_kernel<D>, dkv_smem<D>(), gk, NT, a, stream);
  }
  return -1;
}

// bf16 inputs: the tensor-core kernels
template <int D>
int dispatch_bf16(Which w, const Args& a, dim3 gq, dim3 gk, void* stream) {
  switch (w) {
    case FWD: return launch(fwd_mma_kernel<D>, fwd_mma_smem<D>(), gq, MT, a, stream);
    case DQ: return launch(dq_mma_kernel<D>, bwd_mma_smem<D>(), gq, MT, a, stream);
    case DKV: return launch(dkv_mma_kernel<D>, bwd_mma_smem<D>(), gk, MT, a, stream);
  }
  return -1;
}

// dtype 0 = float32, 1 = bfloat16
int dispatch(Which w, int dtype, int d, const Args& a, void* stream) {
  const dim3 gq((a.sq + BQ - 1) / BQ, a.b * a.hq);
  const dim3 gk((a.sk + BK - 1) / BK, a.b * a.hk);
  if (dtype == 0 && d == 64) return dispatch_f32<64>(w, a, gq, gk, stream);
  if (dtype == 0 && d == 128) return dispatch_f32<128>(w, a, gq, gk, stream);
  if (dtype == 1 && d == 64) return dispatch_bf16<64>(w, a, gq, gk, stream);
  if (dtype == 1 && d == 128) return dispatch_bf16<128>(w, a, gq, gk, stream);
  return -1;
}

Args make_args(const void* q, const void* k, const void* v, const void* seg, int b, int sq,
               int sk, int hq, int hk, int causal, int window, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg = static_cast<const int*>(seg);
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.hq = hq;
  a.hk = hk;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k/v (B, Sk, Hk, D), seg (B, S) int32 or null ->
// out (B, Sq, Hq, D), lse (B*Hq, Sq) fp32. window <= 0 means none.
int tfos_flash_fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
                   void* lse, int b, int sq, int sk, int hq, int hk, int d, int dtype,
                   int causal, int window, float scale, void* stream) {
  Args a = make_args(q, k, v, seg, b, sq, sk, hq, hk, causal, window, scale);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return dispatch(FWD, dtype, d, a, stream);
}

// + dout (B, Sq, Hq, D), lse/delta (B*Hq, Sq) fp32 -> dq (B, Sq, Hq, D)
int tfos_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* seg, void* dq, int b, int sq,
                  int sk, int hq, int hk, int d, int dtype, int causal, int window, float scale,
                  void* stream) {
  Args a = make_args(q, k, v, seg, b, sq, sk, hq, hk, causal, window, scale);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return dispatch(DQ, dtype, d, a, stream);
}

// -> dk, dv (B, Sk, Hk, D), summed over each GQA group in fp32
int tfos_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                   int b, int sq, int sk, int hq, int hk, int d, int dtype, int causal,
                   int window, float scale, void* stream) {
  Args a = make_args(q, k, v, seg, b, sq, sk, hq, hk, causal, window, scale);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  return dispatch(DKV, dtype, d, a, stream);
}

}  // extern "C"
