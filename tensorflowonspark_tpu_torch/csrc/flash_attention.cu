// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of tensorflowonspark_tpu/ops/flash_attention.py:
//   fwd_wgmma_kernel / fwd_kernel  <- _fwd_kernel  (flash_attention.py:134, pallas_call :303)
//   dq_wgmma_kernel  / dq_kernel   <- _dq_kernel   (flash_attention.py:343, pallas_call :550)
//   dkv_wgmma_kernel / dkv_kernel  <- _dkv_kernel  (flash_attention.py:400, pallas_call :600)
// (the first of each pair for bf16 inputs, the second for fp32).
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
// Two implementations share the masks and the tile skipping:
//   - bf16 (the training path): warp-specialised blocks of one TMA
//     producer warpgroup and two wgmma consumer warpgroups over a ring of
//     shared-memory stages completed on mbarriers (hopper.cuh and the
//     section "bf16 forward (B1), dQ (B2) and dK/dV (B3)" below). Only
//     wgmma reaches the card's dense bf16 rate, TMA moves a tile with no
//     thread's loads or registers, and the ring overlaps the next tile's
//     copy with the current tile's products. Wholly live tiles skip the
//     mask.
//   - fp32 inputs run fp32 FMA tiles, exact to fp32 rounding.
// On the tensor cores P and dS are rounded to bf16 before their products,
// as FlashAttention-2 and -3 do.
//
// Design (one block owns one output tile and loops over the other axis;
// nothing is carried across blocks, since Hopper runs blocks in no order):
//   - fwd, dQ: a block owns (batch*q-head, query rows: 128 in the wgmma
//     kernels, 64 in fp32) and streams the key tiles of its KV head. GQA
//     is index arithmetic on the KV head, with no repeat of K/V. The wgmma
//     grids run the last query tiles, the heaviest under causal masking,
//     first: grid (B*Hq, Sq/128), one block (384 threads) per SM, with
//     225 KB of shared memory at D=128 in the forward (Q and three K/V
//     stages) and 193 KB in dQ (Q, dO and four 64-key K/V stages).
//   - dK/dV: a block owns (batch*kv-head, keys: 128 in the wgmma kernel,
//     64 otherwise) and streams the query tiles of every q head of its GQA
//     group, so the group sum of flash_attention.py:626-632 happens in fp32
//     inside the block, with no atomics (results repeat bit for bit). Grid
//     (B*Hk, Sk/128) for the wgmma kernel, low (heaviest) key tiles first,
//     one block (163 KB at D=128: K, V and three Q/dO stages) per SM.
//   - Tiles whose keys are all outside the end-aligned causal frontier or
//     below the sliding window are never visited (O(S*W) work under a
//     window); masked entries inside a visited tile get probability 0.
//   - Q/K/V/dO are read in their (B, S, H, D) layout straight from the
//     model's projections: no transpose. The TMA maps are 4-D over
//     (B, S, H, D), so rows past S of a ragged end come back as zeros, not
//     the next batch's rows. LSE and delta are fp32 (B*Hq, Sq).
//   - Dead rows (no live key): O = 0 and LSE = NEG_INF; their dQ is 0 and
//     they add nothing to dK/dV. NEG_INF is the finite -1e30 of the JAX
//     package.
// Inputs: fp32 or bf16, head dim 64 or 128, 16-byte aligned.
// Each entry point returns cudaGetLastError() (or -1 for an unsupported
// dtype/head dim, -2 when a TMA tensor map cannot be encoded); the launch
// goes on the caller's stream and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// Keys [lo, hi) that queries [q0, q0 + bq) can reach; lo on a bk boundary.
__device__ __forceinline__ void key_range(const Args& a, int q0, int& lo, int& hi, int bq = BQ,
                                          int bk = BK) {
  const int off = a.sk - a.sq;
  lo = 0;
  hi = a.sk;
  if (a.causal) hi = min(a.sk, min(q0 + bq, a.sq) + off);
  if (a.window > 0) lo = max(0, q0 + off - a.window + 1);
  lo = (lo / bk) * bk;
}

// Queries [lo, hi) that can reach keys [k0, k0 + bk); lo on a bq boundary.
__device__ __forceinline__ void query_range(const Args& a, int k0, int& lo, int& hi, int bk = BK,
                                            int bq = BQ) {
  const int off = a.sk - a.sq;
  lo = 0;
  hi = a.sq;
  if (a.causal) lo = max(0, k0 - off);
  if (a.window > 0) hi = min(a.sq, min(k0 + bk, a.sk) - 1 - off + a.window);
  lo = (lo / bq) * bq;
}

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
// bf16 forward (B1), dQ (B2) and dK/dV (B3) on Hopper's asynchronous units.
//
// A block is three warpgroups. Warpgroup 0 is the producer: one thread
// issues TMA tile loads into a ring of shared-memory stages, each stage
// completed on a "full" mbarrier; it keeps 24 registers (setmaxnreg).
// Warpgroups 1 and 2 are consumers with 240 registers each: they wait on
// a stage's full barrier, run their products with wgmma (fp32 accumulators
// in registers), and release the stage on its "empty" barrier (one arrival
// per consumer warp). Score tiles never leave registers: the accumulator
// of S (or dS, P^T, dS^T), rounded to bf16, is the A operand of the next
// product (the wgmma RS form). The same swizzled tile is read K-major by
// one product and MN-major by the next (hopper.cuh).
//
// A tile that is wholly live (in range, below the causal frontier, inside
// the window, no segments) takes the unmasked path; any other tile masks
// its dead entries to -inf before the exponential, with is_live's
// arithmetic. Softmax runs in base 2 with scale * log2(e) folded in; LSE
// stays natural at the interface.
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG_THREADS = 128;
constexpr int HOPPER_THREADS = 3 * WG_THREADS;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128*24 + 256*240 <= 65536
constexpr int ENCODE_FAILED = -2;  // the TMA tensor map could not be encoded

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [i0, i0 + ni) and keys [j0, j0 + nj) all in range and inside the
// window, with no segments: everything of is_live but the causal frontier.
__device__ __forceinline__ bool tile_plain(const Args& a, int i0, int ni, int j0, int nj) {
  bool ok = i0 + ni <= a.sq && j0 + nj <= a.sk && a.seg == nullptr;
  if (a.window > 0) ok = ok && (i0 + ni - 1 + a.sk - a.sq - j0 < a.window);
  return ok;
}

// Key j is not past query i's causal frontier.
__device__ __forceinline__ bool below_frontier(const Args& a, int i, int j) {
  return !a.causal || j <= i + a.sk - a.sq;
}

// No query of [i0, i0 + ni) attends a key of [j0, j0 + nj).
__device__ __forceinline__ bool tile_dead(const Args& a, int i0, int ni, int j0, int nj) {
  const int off = a.sk - a.sq;
  return i0 >= a.sq || j0 >= a.sk || (a.causal && i0 + ni - 1 + off < j0) ||
         (a.window > 0 && i0 + off - (j0 + nj - 1) >= a.window);
}

// The shared memory of a block, 1024-byte aligned (128-byte swizzle).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t s = smem_u32(raw);
  return raw + (((s + 1023) & ~1023u) - s);
}

// The producer thread's K/V stream (B1, B2): n_tiles tiles of NK keys of KV
// head hkv, from key k_lo on. Tile `it` goes into stage s = it % ST (K at
// sKV + 2 s KV_BYTES, V after it) once the consumers have released that
// stage; full[ST] are the barriers at bars + 8, empty[ST] follow them.
template <int D, int NK, int ST>
__device__ __forceinline__ void produce_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                           uint32_t sKV, uint32_t bars, int k_lo, int n_tiles,
                                           int hkv, int bi) {
  constexpr uint32_t KV_BYTES = NK * D * 2;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, k0 = k_lo + it * NK;
    const uint32_t full = bars + 8 * (1 + s), kv = sKV + s * 2 * KV_BYTES;
    mbar_wait(bars + 8 * (1 + ST + s), ((it / ST) & 1) ^ 1);
    mbar_arrive_expect_tx(full, 2 * KV_BYTES);
    for (int p = 0; p < D / 64; ++p) {
      tma_load_4d(kv + p * NK * 128, tk, full, 64 * p, hkv, k0, bi);
      tma_load_4d(kv + KV_BYTES + p * NK * 128, tv, full, 64 * p, hkv, k0, bi);
    }
  }
}

// B1: a block owns 128 query rows of one (batch, q head), 64 per consumer
// warpgroup, and streams 128-key K/V tiles through STAGES stages.
template <int D>
struct FwdTiles {
  static constexpr int BM = 128, BN = 128, STAGES = 3;
  static constexpr uint32_t Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  // alignment slack, Q, STAGES x (K, V), barriers
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = FwdTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES, NO = D / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(aligned_smem(smem_raw));
  const uint32_t sKV = sQ + T::Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t bars = sKV + ST * 2 * T::KV_BYTES;  // Q full, full[ST], empty[ST]

  const int bh = blockIdx.x, bi = bh / a.hq, h = bh % a.hq, hkv = h / (a.hq / a.hk);
  const int q0 = ((a.sq + BM - 1) / BM - 1 - (int)blockIdx.y) * BM;  // last (heaviest) first
  int k_lo, k_hi;
  key_range(a, q0, k_lo, k_hi, BM, BN);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + ST + s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bars, T::Q_BYTES);
      for (int p = 0; p < D / 64; ++p) tma_load_4d(sQ + p * BM * 128, &tq, bars, 64 * p, h, q0, bi);
      produce_kv<D, BN, ST>(&tk, &tv, sKV, bars, k_lo, n_tiles, hkv, bi);
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1, wi = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + 64 * cw;  // this warpgroup's first query row
    const int r0 = qw0 + 16 * wi + g;  // this thread's rows: r0 and r0 + 8
    const float sl = a.scale * LOG2E;
    int segq[2] = {0, 0};
    if (a.seg)
      for (int i = 0; i < 2; ++i)
        segq[i] = r0 + 8 * i < a.sq ? a.seg[(size_t)bi * a.sq + r0 + 8 * i] : -1;

    float o[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] = 0.f;
    mbar_wait(bars, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST, k0 = k_lo + it * BN;
      const uint32_t sK = sKV + s * 2 * T::KV_BYTES, sV = sK + T::KV_BYTES;
      mbar_wait(bars + 8 * (1 + s), (it / ST) & 1);

      float sc[BN / 2];  // S = Q K^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, kmajor_desc(sQ, BM, 64 * cw, kk), kmajor_desc(sK, BN, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      const bool full_tile = tile_plain(a, qw0, 64, k0, BN) && below_frontier(a, qw0, k0 + BN - 1);
      if (!full_tile) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int r = r0 + 8 * ((e >> 1) & 1), c = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          const int segk = a.seg && c < a.sk ? a.seg[(size_t)bi * a.sk + c] : -2;
          if (!is_live(a, r, c, segq[(e >> 1) & 1], segk)) sc[e] = -INFINITY;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF}, alpha[2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * sl);  // finite: m starts at NEG_INF
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      uint32_t pf[BN / 16][4];  // P in bf16, the A operand of P V
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const float p0 = exp2f(fmaf(sc[e], sl, -m[r & 1]));
          const float p1 = exp2f(fmaf(sc[e + 1], sl, -m[r & 1]));
          l[r & 1] += p0 + p1;
          pf[kk][r] = pack_f2(p0, p1);
        }
#pragma unroll
      for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];

      wgmma_fence();  // O += P V
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(o, pf[kk], mn_desc(sV, BN, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(pf);
      if (lane == 0) mbar_arrive(bars + 8 * (1 + ST + s));
    }

    bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qi = r0 + 8 * i;
      if (qi >= a.sq) continue;
      const bool dead = !(l[i] > 0.f);
      const float inv = dead ? 0.f : 1.f / l[i];
      bf16* row = out + (((size_t)bi * a.sq + qi) * a.hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
            pack_f2(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (t == 0) a.lse_out[(size_t)bh * a.sq + qi] = dead ? NEG_INF : m[i] * LN2 + logf(l[i]);
    }
  }
}

// B2: a block owns 128 query rows of one (batch, q head), 64 per consumer
// warpgroup. Q and dO stay resident; KEYS-key K/V tiles of its KV head
// stream through STAGES stages. Per tile, S = Q K^T and dP = dO V^T
// (K-major, one commit), dS = P * (dP - delta) in registers, then
// dQ += dS K with dS the register A operand and the same K tile read
// MN-major. Each consumer thread keeps its two rows' LSE (times log2 e)
// and delta in registers. Key tiles are 64 wide, not B1's 128: a
// warpgroup then skips the diagonal tile past its own rows, and 128-key
// tiles (S, dP and dQ: 192 accumulator registers a thread) spilled.
template <int D>
struct DqTiles {
  static constexpr int QROWS = 128, KEYS = 64, STAGES = 4;
  static constexpr uint32_t QT_BYTES = QROWS * D * 2, KV_BYTES = KEYS * D * 2;
  // alignment slack, Q, dO, STAGES x (K, V), barriers
  static constexpr size_t SMEM = 1024 + 2 * QT_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const Args a) {
  using T = DqTiles<D>;
  constexpr int NQ = T::QROWS, NK = T::KEYS, ST = T::STAGES, NO = D / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = smem_u32(aligned_smem(smem_raw)), sdO = sQ + T::QT_BYTES;
  const uint32_t sKV = sdO + T::QT_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t bars = sKV + ST * 2 * T::KV_BYTES;  // Q/dO full, full[ST], empty[ST]

  const int bh = blockIdx.x, bi = bh / a.hq, h = bh % a.hq, hkv = h / (a.hq / a.hk);
  const int q0 = ((a.sq + NQ - 1) / NQ - 1 - (int)blockIdx.y) * NQ;  // last (heaviest) first
  int k_lo, k_hi;
  key_range(a, q0, k_lo, k_hi, NQ, NK);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + NK - 1) / NK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + ST + s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bars, 2 * T::QT_BYTES);
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(sQ + p * NQ * 128, &tq, bars, 64 * p, h, q0, bi);
        tma_load_4d(sdO + p * NQ * 128, &tdo, bars, 64 * p, h, q0, bi);
      }
      produce_kv<D, NK, ST>(&tk, &tv, sKV, bars, k_lo, n_tiles, hkv, bi);
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1, wi = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + 64 * cw;  // this warpgroup's first query row
    const int r0 = qw0 + 16 * wi + g;  // this thread's rows: r0 and r0 + 8
    const float sl = a.scale * LOG2E;
    int segq[2] = {0, 0};
    float lse2[2], dlt[2];
    for (int i = 0; i < 2; ++i) {
      const int qi = r0 + 8 * i;
      const bool in = qi < a.sq;
      const float lse = in ? a.lse[(size_t)bh * a.sq + qi] : NEG_INF;
      lse2[i] = lse > NEG_INF / 2 ? lse * LOG2E : INFINITY;  // a dead row's P: exp2(-inf) = 0
      dlt[i] = in ? a.delta[(size_t)bh * a.sq + qi] : 0.f;
      if (a.seg) segq[i] = in ? a.seg[(size_t)bi * a.sq + qi] : -1;
    }

    float dq[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) dq[e] = 0.f;
    mbar_wait(bars, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST, k0 = k_lo + it * NK;
      const uint32_t sK = sKV + s * 2 * T::KV_BYTES, sV = sK + T::KV_BYTES;
      mbar_wait(bars + 8 * (1 + s), (it / ST) & 1);
      if (!tile_dead(a, qw0, 64, k0, NK)) {
        float sc[NK / 2], dp[NK / 2];  // S = Q K^T, dP = dO V^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(sc, kmajor_desc(sQ, NQ, 64 * cw, kk), kmajor_desc(sK, NK, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, kmajor_desc(sdO, NQ, 64 * cw, kk), kmajor_desc(sV, NK, 0, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);

        const bool full_tile = tile_plain(a, qw0, 64, k0, NK) && below_frontier(a, qw0, k0 + NK - 1);
        if (!full_tile) {
#pragma unroll
          for (int e = 0; e < NK / 2; ++e) {
            const int r = r0 + 8 * ((e >> 1) & 1), c = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            const int segk = a.seg && c < a.sk ? a.seg[(size_t)bi * a.sk + c] : -2;
            if (!is_live(a, r, c, segq[(e >> 1) & 1], segk)) sc[e] = -INFINITY;
          }
        }
        uint32_t dsf[NK / 16][4];  // dS in bf16, the A operand of dS K
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 8 * kk + 2 * r + c;
              ds[c] = exp2f(fmaf(sc[e], sl, -lse2[r & 1])) * (dp[e] - dlt[r & 1]);
            }
            dsf[kk][r] = pack_f2(ds[0], ds[1]);
          }

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs(dq, dsf[kk], mn_desc(sK, NK, kk));  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dq);
        fence_frag(dsf);
      }
      if (lane == 0) mbar_arrive(bars + 8 * (1 + ST + s));
    }

    bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = r0 + 8 * i;
      if (qi >= a.sq) continue;
      bf16* row = out + (((size_t)bi * a.sq + qi) * a.hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
            pack_f2(dq[4 * j + 2 * i] * a.scale, dq[4 * j + 2 * i + 1] * a.scale);
    }
  }
}

// B3: a block owns 128 keys of one (batch, kv head), 64 per consumer
// warpgroup, and streams 64-query Q/dO tiles of every q head of its GQA
// group through STAGES stages, with each tile's LSE (times log2 e) and
// delta, which the producer warp writes beside it.
template <int D>
struct DkvTiles {
  static constexpr int KEYS = 128, QROWS = 64, STAGES = 3;
  static constexpr uint32_t KV_BYTES = KEYS * D * 2, QT_BYTES = QROWS * D * 2;
  // alignment slack, K, V, STAGES x (Q, dO), STAGES x (lse2, delta), barriers
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * QT_BYTES +
                                 STAGES * 2 * QROWS * 4 + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const Args a) {
  using T = DkvTiles<D>;
  constexpr int NK = T::KEYS, NQ = T::QROWS, ST = T::STAGES, NO = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(base), sV = sK + T::KV_BYTES;
  const uint32_t sQT = sV + T::KV_BYTES;  // stage s: Q at sQT + 2 s QT_BYTES, dO after it
  float* rowstat = reinterpret_cast<float*>(base + 2 * T::KV_BYTES + ST * 2 * T::QT_BYTES);
  const uint32_t bars = smem_u32(rowstat + ST * 2 * NQ);  // K/V full, full[ST], empty[ST]

  const int bkh = blockIdx.x, bi = bkh / a.hk, hkv = bkh % a.hk, group = a.hq / a.hk;
  const int k0 = blockIdx.y * NK;  // low key tiles, the heaviest under causal masking, first
  int q_lo, q_hi;
  query_range(a, k0, q_lo, q_hi, NK, NQ);
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + NQ - 1) / NQ : 0;  // query tiles per q head

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * (1 + s), 32);
      mbar_init(bars + 8 * (1 + ST + s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {  // producer: warp 0
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(bars, 2 * T::KV_BYTES);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(sK + p * NK * 128, &tk, bars, 64 * p, hkv, k0, bi);
          tma_load_4d(sV + p * NK * 128, &tv, bars, 64 * p, hkv, k0, bi);
        }
      }
      for (int it = 0; it < group * n_q; ++it) {
        const int s = it % ST, h = hkv * group + it / n_q, q0 = q_lo + (it % n_q) * NQ;
        const uint32_t full = bars + 8 * (1 + s), qt = sQT + s * 2 * T::QT_BYTES;
        const size_t row0 = ((size_t)bi * a.hq + h) * a.sq;
        mbar_wait(bars + 8 * (1 + ST + s), ((it / ST) & 1) ^ 1);
        float* lse2 = rowstat + s * 2 * NQ;
        for (int r = lane; r < NQ; r += 32) {
          const bool in = q0 + r < a.sq;
          const float lse = in ? a.lse[row0 + q0 + r] : NEG_INF;
          lse2[r] = lse > NEG_INF / 2 ? lse * LOG2E : INFINITY;  // a dead row's P: exp2(-inf) = 0
          lse2[NQ + r] = in ? a.delta[row0 + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * T::QT_BYTES);
          for (int p = 0; p < D / 64; ++p) {
            tma_load_4d(qt + p * NQ * 128, &tq, full, 64 * p, h, q0, bi);
            tma_load_4d(qt + T::QT_BYTES + p * NQ * 128, &tdo, full, 64 * p, h, q0, bi);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = threadIdx.x / WG_THREADS - 1, wi = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wk0 = k0 + 64 * cw;  // this warpgroup's first key
    const int r0 = wk0 + 16 * wi + g;  // this thread's keys: r0 and r0 + 8
    const float sl = a.scale * LOG2E;
    int segk[2] = {0, 0};
    if (a.seg)
      for (int i = 0; i < 2; ++i)
        segk[i] = r0 + 8 * i < a.sk ? a.seg[(size_t)bi * a.sk + r0 + 8 * i] : -2;

    float dk[NO], dv[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) dk[e] = dv[e] = 0.f;
    mbar_wait(bars, 0);

    for (int it = 0; it < group * n_q; ++it) {
      const int s = it % ST, q0 = q_lo + (it % n_q) * NQ;
      const uint32_t sQ = sQT + s * 2 * T::QT_BYTES, sdO = sQ + T::QT_BYTES;
      const float* lse2 = rowstat + s * 2 * NQ;
      mbar_wait(bars + 8 * (1 + s), (it / ST) & 1);
      if (!tile_dead(a, q0, NQ, wk0, 64)) {
        float st[NQ / 2], dpt[NQ / 2];  // S^T = K Q^T, dP^T = V dO^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(st, kmajor_desc(sK, NK, 64 * cw, kk), kmajor_desc(sQ, NQ, 0, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dpt, kmajor_desc(sV, NK, 64 * cw, kk), kmajor_desc(sdO, NQ, 0, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(st);
        fence_acc(dpt);

        const bool full_tile = tile_plain(a, q0, NQ, wk0, 64) && below_frontier(a, q0, wk0 + 63);
        if (!full_tile) {
#pragma unroll
          for (int e = 0; e < NQ / 2; ++e) {
            const int qi = q0 + 8 * (e >> 2) + 2 * t + (e & 1), kj = r0 + 8 * ((e >> 1) & 1);
            const int segq = a.seg && qi < a.sq ? a.seg[(size_t)bi * a.sq + qi] : -1;
            if (!is_live(a, qi, kj, segq, segk[(e >> 1) & 1])) st[e] = -INFINITY;
          }
        }
        uint32_t pf[NQ / 16][4], dsf[NQ / 16][4];  // P^T and dS^T in bf16
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float p[2], ds[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 8 * kk + 2 * r + c, qc = 8 * (e >> 2) + 2 * t + c;
              p[c] = exp2f(fmaf(st[e], sl, -lse2[qc]));
              ds[c] = p[c] * (dpt[e] - lse2[NQ + qc]);
            }
            pf[kk][r] = pack_f2(p[0], p[1]);
            dsf[kk][r] = pack_f2(ds[0], ds[1]);
          }

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs(dv, pf[kk], mn_desc(sdO, NQ, kk));  // dV += P^T dO
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs(dk, dsf[kk], mn_desc(sQ, NQ, kk));  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dk);
        fence_acc(dv);
        fence_frag(pf);
        fence_frag(dsf);
      }
      if (lane == 0) mbar_arrive(bars + 8 * (1 + ST + s));
    }

    bf16* dkp = static_cast<bf16*>(a.out);
    bf16* dvp = static_cast<bf16*>(a.out2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = r0 + 8 * i;
      if (kj >= a.sk) continue;
      const size_t base_j = (((size_t)bi * a.sk + kj) * a.hk + hkv) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkp + base_j + 8 * j + 2 * t) =
            pack_f2(dk[4 * j + 2 * i] * a.scale, dk[4 * j + 2 * i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvp + base_j + 8 * j + 2 * t) =
            pack_f2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename Kernel, typename... Maps>
int launch_hopper(Kernel kernel, size_t smem, dim3 grid, const Args& a, void* stream,
                  const Maps&... maps) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, HOPPER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(maps..., a);
  return (int)cudaGetLastError();
}

// The tensor maps of q (and dO, unless tdo is null) with boxes of qrows rows
// and of k and v with boxes of keys rows; false if one cannot be encoded.
template <int D>
bool encode_maps(const Args& a, int qrows, int keys, CUtensorMap* tq, CUtensorMap* tk,
                 CUtensorMap* tv, CUtensorMap* tdo) {
  return bshd_map(tq, a.q, a.b, a.sq, a.hq, D, qrows) &&
         bshd_map(tk, a.k, a.b, a.sk, a.hk, D, keys) &&
         bshd_map(tv, a.v, a.b, a.sk, a.hk, D, keys) &&
         (tdo == nullptr || bshd_map(tdo, a.dout, a.b, a.sq, a.hq, D, qrows));
}

template <int D>
int launch_fwd_wgmma(const Args& a, void* stream) {
  using T = FwdTiles<D>;
  CUtensorMap tq, tk, tv;
  if (!encode_maps<D>(a, T::BM, T::BN, &tq, &tk, &tv, nullptr)) return ENCODE_FAILED;
  const dim3 grid(a.b * a.hq, (a.sq + T::BM - 1) / T::BM);
  return launch_hopper(fwd_wgmma_kernel<D>, T::SMEM, grid, a, stream, tq, tk, tv);
}

template <int D>
int launch_dq_wgmma(const Args& a, void* stream) {
  using T = DqTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_maps<D>(a, T::QROWS, T::KEYS, &tq, &tk, &tv, &tdo)) return ENCODE_FAILED;
  const dim3 grid(a.b * a.hq, (a.sq + T::QROWS - 1) / T::QROWS);
  return launch_hopper(dq_wgmma_kernel<D>, T::SMEM, grid, a, stream, tq, tk, tv, tdo);
}

template <int D>
int launch_dkv_wgmma(const Args& a, void* stream) {
  using T = DkvTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_maps<D>(a, T::QROWS, T::KEYS, &tq, &tk, &tv, &tdo)) return ENCODE_FAILED;
  const dim3 grid(a.b * a.hk, (a.sk + T::KEYS - 1) / T::KEYS);
  return launch_hopper(dkv_wgmma_kernel<D>, T::SMEM, grid, a, stream, tq, tk, tv, tdo);
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

// fp32 inputs: the FMA kernels, 64-row tiles
template <int D>
int dispatch_f32(Which w, const Args& a, void* stream) {
  const dim3 gq((a.sq + BQ - 1) / BQ, a.b * a.hq);
  const dim3 gk((a.sk + BK - 1) / BK, a.b * a.hk);
  switch (w) {
    case FWD: return launch(fwd_kernel<D>, fwd_smem<D>(), gq, NT, a, stream);
    case DQ: return launch(dq_kernel<D>, dq_smem<D>(), gq, NT, a, stream);
    case DKV: return launch(dkv_kernel<D>, dkv_smem<D>(), gk, NT, a, stream);
  }
  return -1;
}

// bf16 inputs: the Hopper kernels (TMA producer, wgmma consumers)
template <int D>
int dispatch_bf16(Which w, const Args& a, void* stream) {
  switch (w) {
    case FWD: return launch_fwd_wgmma<D>(a, stream);
    case DQ: return launch_dq_wgmma<D>(a, stream);
    case DKV: return launch_dkv_wgmma<D>(a, stream);
  }
  return -1;
}

// dtype 0 = float32, 1 = bfloat16
int dispatch(Which w, int dtype, int d, const Args& a, void* stream) {
  if (dtype == 0 && d == 64) return dispatch_f32<64>(w, a, stream);
  if (dtype == 0 && d == 128) return dispatch_f32<128>(w, a, stream);
  if (dtype == 1 && d == 64) return dispatch_bf16<64>(w, a, stream);
  if (dtype == 1 && d == 128) return dispatch_bf16<128>(w, a, stream);
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
