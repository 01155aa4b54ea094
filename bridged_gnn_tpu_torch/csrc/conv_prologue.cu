// AdaptedConv's domain-shift prologue for Hopper (sm_90a), forward and
// backward.
//
// Replaces no TPU kernel: the JAX package leaves the prologue
// (bridged_gnn_tpu/nn/ktgnn.py, the domain means, the gated shifts and the
// two linear paths before the attention) to XLA, which fuses it. Written as
// plain PyTorch ops it is ~15 full-width ops a conv: each masked mean a
// broadcast product written out and summed, the [N, 2D] concatenation
// [x ‖ dd] under the two gate gemvs, the gated shifts written as two shifted
// copies of x, and the two linears over those copies. At the benchmark's
// size (N = 131,072, D = 256) that moves ~3.6 GB for the first conv of a
// forward where one read of x and the [N, 2H] outputs carry the
// information.
//
// The arithmetic is the same, regrouped. With a_g_s2t.weight = [p_x ‖ p_d],
// a_g_t2s.weight = [q_x ‖ q_d], c and t the central and target row masks,
// dd = mean_c − mean_t, v_t = W_t dd and v_s = W_s dd:
//   a_i   = tanh(x_i·p_x + dd·p_d)     b_i = tanh(x_i·q_x + dd·q_d)
//   u_s2t = x W_tᵀ + β_t − (a ⊙ c) ⊗ v_t     (= lin_t(x − a·c·dd))
//   u_t2s = x W_sᵀ + β_s + (b ⊙ t) ⊗ v_s     (= lin_s(x + b·t·dd))
// The caller runs the one projection GEMM x [W_t; W_s]ᵀ (cuBLAS, at the
// configured matmul precision) between these kernels:
//
//   conv_prologue_pass_kernel      one read of x: both domains' masked
//                                  column sums and counts over the rows
//                                  below n_sum, one partial row per block,
//                                  and the per-row gate dots x_i·p_x and
//                                  x_i·q_x in f32;
//   conv_prologue_finish_kernel    one block: the partial rows summed in
//                                  block order, dd (counts clamped at 1, on
//                                  the card), v_t, v_s, dd·p_d and dd·q_d
//                                  (or the same from a given dd);
//   conv_prologue_epilogue_kernel  one pass over the GEMM's [N, 2H]: the
//                                  gates' tanh, the rank-1 corrections and
//                                  the biases, both message tables written
//                                  in the message dtype, and (a, b) a row
//                                  for the backward.
// Backward, around the two GEMMs dW = dYᵀ x and dx = dY W:
//   conv_prologue_bwd_kernel       one pass over the cotangents [N, 2H]
//                                  (and x): the GEMM's cotangent dY in f32,
//                                  the per-row gate cotangents dz, and one
//                                  partial row per block of the column sums
//                                  for β, for the v terms (Σ a·c·dU), for
//                                  the gates' weights (Σ dz·x) and Σ dz;
//   conv_prologue_bwd_finish_kernel  one block: those sums in block order,
//                                  the biases' and gates' gradients, the
//                                  rank-1 correction of dW in place, and
//                                  the cotangent of dd;
//   conv_prologue_dx_kernel        dx += dz_a·p_x + dz_b·q_x + the means'
//                                  rank-1 terms, in place on the GEMM's dx.
//
// Bound: bytes. The passes read x (134 MB at D = 256) or the [N, 2H]
// tables once and write [N, 2] per-row scalars, a few KB of partials, or
// the message tables; the finishes touch KBs. Every sum is taken in a fixed
// order: lanes over their columns, a warp's rows in order, the warps of a
// block in warp order, the blocks in block order; no atomics, so two
// launches give bit-identical outputs. Accumulators live in shared memory,
// one row of the partial's width per warp, so any width runs (a block takes
// fewer warps past ~1,600 columns).
//
// Build: see attention_fwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kWarps = 16;           // warps of a pass block, at most
constexpr int kMaxBlocks = 256;      // row blocks of a pass, at most
constexpr int kMinRowsPerWarp = 4;   // fewer rows leave a block mostly idle
constexpr int kFinishThreads = 1024;
constexpr int kTile = 256;           // columns a finish sums at once
constexpr int kSmemBudget = 200 * 1024;
constexpr int kRowsPerWarp = 4;      // rows a warp of an epilogue takes
constexpr int kEpiWarps = 8;

__host__ int pass_blocks(int n) {
  const int per = kWarps * kMinRowsPerWarp;
  const int nb = (n + per - 1) / per;
  return nb < 1 ? 1 : (nb > kMaxBlocks ? kMaxBlocks : nb);
}

// Warps a pass block takes so that each has `width` f32 accumulators and
// the block `extra` floats besides in kSmemBudget; 0 if not even one fits.
__host__ int pass_warps(int width, int extra) {
  const long long per = 4LL * width;
  long long w = (kSmemBudget - 4LL * extra) / per;
  return w < 1 ? 0 : (w > kWarps ? kWarps : static_cast<int>(w));
}

__device__ __forceinline__ bool flag(const uint8_t* m, long long r) {
  return m[r] != 0;
}

// Adds the block's warps' accumulator rows in warp order into the block's
// partial row.
__device__ __forceinline__ void write_partial(const float* acc, int warps,
                                              int w, float* part) {
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < warps; ++q) s += acc[q * w + k];
    part[k] = s;
  }
}

// Sums nb partial rows of width w in block order into tot (shared): 1024
// threads as 4 groups of 256 columns, each group a quarter of the rows
// (rows g, g + 4, ...), the groups added in order.
__device__ void sum_parts(const float* __restrict__ parts, int nb, int w,
                          float* tot, float* red) {
  const int c = threadIdx.x % kTile, g = threadIdx.x / kTile;
  for (int base = 0; base < w; base += kTile) {
    const int k = base + c;
    float s = 0.f;
    if (k < w) {
#pragma unroll 8
      for (int b = g; b < nb; b += 4)
        s += parts[static_cast<long long>(b) * w + k];
    }
    red[g * kTile + c] = s;
    __syncthreads();
    if (g == 0 && k < w)
      tot[k] = ((red[c] + red[kTile + c]) + red[2 * kTile + c]) +
               red[3 * kTile + c];
    __syncthreads();
  }
}

// ------------------------------------------------------------- forward

// Block b takes rows [b·rpb, (b+1)·rpb); its warp q rows q, q + warps, ...
// of them, two at a time. Accumulator row of a warp: [S_c (d) | S_t (d) |
// n_c | n_t]; shared memory also holds p_x and q_x.
__global__ void conv_prologue_pass_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ central,
    const uint8_t* __restrict__ target, const float* __restrict__ wg1,
    const float* __restrict__ wg2, int n, int d, int n_sum, int rpb,
    float* __restrict__ parts, float* __restrict__ gd) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = 2 * d + 2;
  float* acc = smem + warp * w;
  float* px = smem + warps * w;
  float* qx = px + d;
  for (int k = threadIdx.x; k < warps * w; k += blockDim.x) smem[k] = 0.f;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    px[k] = wg1[k];
    qx[k] = wg2[k];
  }
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = min(static_cast<long long>(n), r0 + rpb);
  float nc = 0.f, nt = 0.f;
  for (long long r = r0 + warp; r < r1; r += 2 * warps) {
    const long long s = r + warps;  // the second row, if any
    const bool two = s < r1;
    const bool c0 = r < n_sum && flag(central, r);
    const bool t0 = r < n_sum && flag(target, r);
    const bool c1 = two && s < n_sum && flag(central, s);
    const bool t1 = two && s < n_sum && flag(target, s);
    float* d0 = c0 ? acc : (t0 ? acc + d : nullptr);
    float* d1 = c1 ? acc : (t1 ? acc + d : nullptr);
    const float* x0 = x + r * d;
    const float* x1 = x + (two ? s : r) * d;
    float p0 = 0.f, q0 = 0.f, p1 = 0.f, q1 = 0.f;
#pragma unroll 4
    for (int k = lane; k < d; k += 32) {
      const float v0 = x0[k];
      const float v1 = two ? x1[k] : 0.f;
      p0 = fmaf(v0, px[k], p0);
      q0 = fmaf(v0, qx[k], q0);
      p1 = fmaf(v1, px[k], p1);
      q1 = fmaf(v1, qx[k], q1);
      if (d0 != nullptr) d0[k] += v0;
      if (d1 != nullptr) d1[k] += v1;
    }
    p0 = group_sum<32>(p0);
    q0 = group_sum<32>(q0);
    p1 = group_sum<32>(p1);
    q1 = group_sum<32>(q1);
    if (lane == 0) {
      gd[2 * r] = p0;
      gd[2 * r + 1] = q0;
      if (two) {
        gd[2 * s] = p1;
        gd[2 * s + 1] = q1;
      }
    }
    nc += static_cast<float>(c0) + static_cast<float>(c1);
    nt += static_cast<float>(t0) + static_cast<float>(t1);
  }
  if (lane == 0) {
    acc[2 * d] = nc;
    acc[2 * d + 1] = nt;
  }
  __syncthreads();
  write_partial(smem, warps, w,
                parts + static_cast<long long>(blockIdx.x) * w);
}

// aux = [v_t (h) | v_s (h) | dd·p_d | dd·q_d | max(n_c, 1) | max(n_t, 1)].
__global__ void __launch_bounds__(kFinishThreads) conv_prologue_finish_kernel(
    const float* __restrict__ parts, int nb, const float* __restrict__ dd_in,
    const float* __restrict__ wg1, const float* __restrict__ wg2,
    const float* __restrict__ wt, const float* __restrict__ ws, int d, int h,
    float* __restrict__ dd_out, float* __restrict__ aux) {
  extern __shared__ float smem[];
  float* red = smem;
  float* dd = smem + 4 * kTile;  // the sums, then dd in their first d
  if (dd_in == nullptr) {
    sum_parts(parts, nb, 2 * d + 2, dd, red);
    const float cc = fmaxf(dd[2 * d], 1.f), ct = fmaxf(dd[2 * d + 1], 1.f);
    __syncthreads();
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      const float v = dd[k] / cc - dd[d + k] / ct;
      dd[k] = v;
      dd_out[k] = v;
    }
    if (threadIdx.x == 0) {
      aux[2 * h + 2] = cc;
      aux[2 * h + 3] = ct;
    }
  } else {
    for (int k = threadIdx.x; k < d; k += blockDim.x) dd[k] = dd_in[k];
    if (threadIdx.x == 0) aux[2 * h + 2] = aux[2 * h + 3] = 1.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < 2 * h + 2; j += blockDim.x >> 5) {
    const float* row = j < h ? wt + static_cast<long long>(j) * d
                       : j < 2 * h ? ws + static_cast<long long>(j - h) * d
                       : (j == 2 * h ? wg1 : wg2) + d;
    float s = 0.f;
    for (int k = lane; k < d; k += 32) s = fmaf(row[k], dd[k], s);
    s = group_sum<32>(s);
    if (lane == 0) aux[j] = s;
  }
}

// A warp per row, kRowsPerWarp rows each; p is the GEMM's [n, 2h] (u_s2t's
// columns first, from W_t).
template <typename TOut>
__global__ void __launch_bounds__(32 * kEpiWarps)
conv_prologue_epilogue_kernel(
    const float* __restrict__ p, const float* __restrict__ gd,
    const float* __restrict__ aux, const float* __restrict__ bt,
    const float* __restrict__ bs, const uint8_t* __restrict__ central,
    const uint8_t* __restrict__ target, int n, int h,
    TOut* __restrict__ u_t2s, TOut* __restrict__ u_s2t,
    float* __restrict__ ab) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kEpiWarps + (threadIdx.x >> 5);
  const float sda = aux[2 * h], sdb = aux[2 * h + 1];
  const long long r0 = warp * kRowsPerWarp;
  const long long r1 = min(static_cast<long long>(n), r0 + kRowsPerWarp);
  for (long long r = r0; r < r1; ++r) {
    const float a = tanhf(gd[2 * r] + sda);
    const float b = tanhf(gd[2 * r + 1] + sdb);
    const float ac = flag(central, r) ? a : 0.f;
    const float bt_ = flag(target, r) ? b : 0.f;
    if (lane == 0) {
      ab[2 * r] = a;
      ab[2 * r + 1] = b;
    }
    const float* pr = p + r * 2 * h;
    for (int j = lane; j < h; j += 32) {
      const float vs = __ldcs(pr + j), vt = __ldcs(pr + h + j);
      __stcs(u_s2t + r * h + j,
             from_f32<TOut>((vs + bt[j]) - ac * aux[j]));
      __stcs(u_t2s + r * h + j,
             from_f32<TOut>((vt + bs[j]) + bt_ * aux[h + j]));
    }
  }
}

// ------------------------------------------------------------ backward

// Accumulator row of a warp: [Σ dU_s2t (h) | Σ dU_t2s (h) | Σ a·c·dU_s2t (h)
// | Σ b·t·dU_t2s (h) | Σ dz_a·x (d) | Σ dz_b·x (d) | Σ dz_a | Σ dz_b];
// shared memory also holds v_t and v_s. A warp walks its rows in order.
template <typename TG>
__global__ void conv_prologue_bwd_kernel(
    const TG* __restrict__ g_t2s, const TG* __restrict__ g_s2t,
    const float* __restrict__ x, const float* __restrict__ ab,
    const float* __restrict__ aux, const uint8_t* __restrict__ central,
    const uint8_t* __restrict__ target, int n, int d, int h, int rpb,
    float* __restrict__ dy, float* __restrict__ dz,
    float* __restrict__ parts) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = 4 * h + 2 * d + 2;
  float* acc = smem + warp * w;
  float* v = smem + warps * w;  // v_t then v_s
  for (int k = threadIdx.x; k < warps * w; k += blockDim.x) smem[k] = 0.f;
  for (int k = threadIdx.x; k < 2 * h; k += blockDim.x) v[k] = aux[k];
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = min(static_cast<long long>(n), r0 + rpb);
  float sza = 0.f, szb = 0.f;
  for (long long r = r0 + warp; r < r1; r += warps) {
    const bool c = flag(central, r), t = flag(target, r);
    const float a = ab[2 * r], b = ab[2 * r + 1];
    const float ac = c ? a : 0.f, bt_ = t ? b : 0.f;
    const TG* gs = g_s2t + r * h;
    const TG* gt = g_t2s + r * h;
    float* dyr = dy + r * 2 * h;
    float sa = 0.f, sb = 0.f;
    for (int j = lane; j < h; j += 32) {
      const float es = to_f32(gs[j]), et = to_f32(gt[j]);
      sa = fmaf(es, v[j], sa);
      sb = fmaf(et, v[h + j], sb);
      __stcs(dyr + j, es);
      __stcs(dyr + h + j, et);
      acc[j] += es;
      acc[h + j] += et;
      acc[2 * h + j] = fmaf(ac, es, acc[2 * h + j]);
      acc[3 * h + j] = fmaf(bt_, et, acc[3 * h + j]);
    }
    sa = group_sum<32>(sa);
    sb = group_sum<32>(sb);
    const float za = c ? -sa * (1.f - a * a) : 0.f;
    const float zb = t ? sb * (1.f - b * b) : 0.f;
    if (lane == 0) {
      dz[2 * r] = za;
      dz[2 * r + 1] = zb;
    }
    sza += za;
    szb += zb;
    if (c || t) {
      const float* xr = x + r * d;
      float* dp = acc + 4 * h;
#pragma unroll 4
      for (int k = lane; k < d; k += 32) {
        const float e = xr[k];
        dp[k] = fmaf(za, e, dp[k]);
        dp[d + k] = fmaf(zb, e, dp[d + k]);
      }
    }
  }
  if (lane == 0) {
    acc[4 * h + 2 * d] = sza;
    acc[4 * h + 2 * d + 1] = szb;
  }
  __syncthreads();
  write_partial(smem, warps, w,
                parts + static_cast<long long>(blockIdx.x) * w);
}

__global__ void __launch_bounds__(kFinishThreads)
conv_prologue_bwd_finish_kernel(
    const float* __restrict__ parts, int nb, const float* __restrict__ dd,
    const float* __restrict__ dd_ext, const float* __restrict__ wt,
    const float* __restrict__ ws, const float* __restrict__ wg1,
    const float* __restrict__ wg2, int d, int h, float* __restrict__ dw,
    float* __restrict__ dbt, float* __restrict__ dbs,
    float* __restrict__ dwg1, float* __restrict__ dwg2,
    float* __restrict__ d_dd) {
  extern __shared__ float smem[];
  float* red = smem;
  float* tot = smem + 4 * kTile;
  sum_parts(parts, nb, 4 * h + 2 * d + 2, tot, red);
  const float* gs = tot + 2 * h;  // Σ a·c·dU_s2t
  const float* gt = tot + 3 * h;  // Σ b·t·dU_t2s
  const float* sp = tot + 4 * h;  // Σ dz_a·x
  const float* sq = sp + d;       // Σ dz_b·x
  const float sza = tot[4 * h + 2 * d], szb = tot[4 * h + 2 * d + 1];
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    dbt[j] = tot[j];
    dbs[j] = tot[h + j];
  }
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    const float e = dd[k];
    dwg1[k] = sp[k];
    dwg1[d + k] = sza * e;
    dwg2[k] = sq[k];
    dwg2[d + k] = szb * e;
    float s = dd_ext == nullptr ? 0.f : dd_ext[k];
    for (int j = 0; j < h; ++j)
      s = fmaf(-wt[static_cast<long long>(j) * d + k], gs[j], s);
    for (int j = 0; j < h; ++j)
      s = fmaf(ws[static_cast<long long>(j) * d + k], gt[j], s);
    s = fmaf(sza, wg1[d + k], s);
    s = fmaf(szb, wg2[d + k], s);
    d_dd[k] = s;
  }
  const long long total = 2LL * h * d;
  for (long long e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = static_cast<int>(e / d);
    const int k = static_cast<int>(e - static_cast<long long>(j) * d);
    dw[e] += j < h ? -gs[j] * dd[k] : gt[j - h] * dd[k];
  }
}

// A warp per row, kRowsPerWarp rows each; the means' terms d_dd/n_c and
// −d_dd/n_t for the rows below n_sum, taken once a block into shared
// memory.
__global__ void __launch_bounds__(32 * kEpiWarps) conv_prologue_dx_kernel(
    float* __restrict__ dx, const float* __restrict__ dz,
    const float* __restrict__ d_dd, const float* __restrict__ aux,
    const float* __restrict__ wg1, const float* __restrict__ wg2,
    const uint8_t* __restrict__ central, const uint8_t* __restrict__ target,
    int n, int d, int h, int n_sum) {
  extern __shared__ float smem[];
  float* mc = smem;      // d_dd / n_c
  float* mt = smem + d;  // d_dd / n_t
  const float cc = aux[2 * h + 2], ct = aux[2 * h + 3];
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    mc[k] = d_dd[k] / cc;
    mt[k] = d_dd[k] / ct;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kEpiWarps + (threadIdx.x >> 5);
  const long long r0 = warp * kRowsPerWarp;
  const long long r1 = min(static_cast<long long>(n), r0 + kRowsPerWarp);
  for (long long r = r0; r < r1; ++r) {
    const float za = dz[2 * r], zb = dz[2 * r + 1];
    const bool c = r < n_sum && flag(central, r);
    const bool t = r < n_sum && flag(target, r);
    float* row = dx + r * d;
    for (int k = lane; k < d; k += 32) {
      float e = row[k];
      e = fmaf(za, wg1[k], e);
      e = fmaf(zb, wg2[k], e);
      if (c) e += mc[k];
      if (t) e -= mt[k];
      row[k] = e;
    }
  }
}

// ------------------------------------------------------------- launches

cudaError_t set_smem(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int epi_blocks(int n) {
  const int per = kEpiWarps * kRowsPerWarp;
  const int nb = (n + per - 1) / per;
  return nb < 1 ? 1 : nb;
}

template <typename TOut>
int epilogue_any(const void* p, const void* gd, const void* aux,
                 const void* bt, const void* bs, const void* central,
                 const void* target, int n, int h, void* u_t2s, void* u_s2t,
                 void* ab, void* stream) {
  if (n < 0 || h < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  conv_prologue_epilogue_kernel<TOut>
      <<<epi_blocks(n), 32 * kEpiWarps, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(p), static_cast<const float*>(gd),
          static_cast<const float*>(aux), static_cast<const float*>(bt),
          static_cast<const float*>(bs), static_cast<const uint8_t*>(central),
          static_cast<const uint8_t*>(target), n, h, static_cast<TOut*>(u_t2s),
          static_cast<TOut*>(u_s2t), static_cast<float*>(ab));
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int bwd_any(const void* g_t2s, const void* g_s2t, const void* x,
            const void* ab, const void* aux, const void* central,
            const void* target, int n, int d, int h, int nb, void* dy,
            void* dz, void* parts, void* stream) {
  if (n < 0 || d < 1 || h < 1 || nb != pass_blocks(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = 4 * h + 2 * d + 2;
  const int warps = pass_warps(w, 2 * h);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * (warps * static_cast<long long>(w) + 2 * h);
  cudaError_t rc = set_smem(reinterpret_cast<const void*>(
                                &conv_prologue_bwd_kernel<TG>), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int rpb = (n + nb - 1) / nb;
  conv_prologue_bwd_kernel<TG>
      <<<nb, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TG*>(g_t2s), static_cast<const TG*>(g_s2t),
          static_cast<const float*>(x), static_cast<const float*>(ab),
          static_cast<const float*>(aux), static_cast<const uint8_t*>(central),
          static_cast<const uint8_t*>(target), n, d, h, rpb > 0 ? rpb : 1,
          static_cast<float*>(dy), static_cast<float*>(dz),
          static_cast<float*>(parts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The row blocks of a pass over n rows: the partial rows the finishes sum.
extern "C" int conv_prologue_blocks(int n) { return pass_blocks(n); }

extern "C" int conv_prologue_pass(const void* x, const void* central,
                                  const void* target, const void* wg1,
                                  const void* wg2, int n, int d, int n_sum,
                                  int nb, void* parts, void* gd,
                                  void* stream) {
  if (n < 0 || d < 1 || n_sum < 0 || n_sum > n || nb != pass_blocks(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = 2 * d + 2;
  const int warps = pass_warps(w, 2 * d);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * (warps * static_cast<long long>(w) + 2 * d);
  cudaError_t rc = set_smem(
      reinterpret_cast<const void*>(&conv_prologue_pass_kernel), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int rpb = (n + nb - 1) / nb;
  conv_prologue_pass_kernel<<<nb, 32 * warps, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(central),
      static_cast<const uint8_t*>(target), static_cast<const float*>(wg1),
      static_cast<const float*>(wg2), n, d, n_sum, rpb > 0 ? rpb : 1,
      static_cast<float*>(parts), static_cast<float*>(gd));
  return static_cast<int>(cudaGetLastError());
}

// parts [nb, 2d + 2] from conv_prologue_pass, or dd_in [d] (parts unused).
extern "C" int conv_prologue_finish(const void* parts, int nb,
                                    const void* dd_in, const void* wg1,
                                    const void* wg2, const void* wt,
                                    const void* ws, int d, int h,
                                    void* dd_out, void* aux, void* stream) {
  if (d < 1 || h < 1 || (dd_in == nullptr && nb < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * (4 * kTile + 2 * d + 2);
  cudaError_t rc = set_smem(
      reinterpret_cast<const void*>(&conv_prologue_finish_kernel), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  conv_prologue_finish_kernel<<<1, kFinishThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), nb, static_cast<const float*>(dd_in),
      static_cast<const float*>(wg1), static_cast<const float*>(wg2),
      static_cast<const float*>(wt), static_cast<const float*>(ws), d, h,
      static_cast<float*>(dd_out), static_cast<float*>(aux));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_prologue_epilogue(const void* p, const void* gd,
                                      const void* aux, const void* bt,
                                      const void* bs, const void* central,
                                      const void* target, int n, int h,
                                      void* u_t2s, void* u_s2t, void* ab,
                                      void* stream) {
  return epilogue_any<float>(p, gd, aux, bt, bs, central, target, n, h,
                             u_t2s, u_s2t, ab, stream);
}

// The same writing bf16 message tables.
extern "C" int conv_prologue_epilogue_bf16(const void* p, const void* gd,
                                           const void* aux, const void* bt,
                                           const void* bs,
                                           const void* central,
                                           const void* target, int n, int h,
                                           void* u_t2s, void* u_s2t,
                                           void* ab, void* stream) {
  return epilogue_any<__nv_bfloat16>(p, gd, aux, bt, bs, central, target, n,
                                     h, u_t2s, u_s2t, ab, stream);
}

extern "C" int conv_prologue_bwd(const void* g_t2s, const void* g_s2t,
                                 const void* x, const void* ab,
                                 const void* aux, const void* central,
                                 const void* target, int n, int d, int h,
                                 int nb, void* dy, void* dz, void* parts,
                                 void* stream) {
  return bwd_any<float>(g_t2s, g_s2t, x, ab, aux, central, target, n, d, h,
                        nb, dy, dz, parts, stream);
}

// The same reading bf16 cotangents of bf16 message tables.
extern "C" int conv_prologue_bwd_bf16(const void* g_t2s, const void* g_s2t,
                                      const void* x, const void* ab,
                                      const void* aux, const void* central,
                                      const void* target, int n, int d,
                                      int h, int nb, void* dy, void* dz,
                                      void* parts, void* stream) {
  return bwd_any<__nv_bfloat16>(g_t2s, g_s2t, x, ab, aux, central, target,
                                n, d, h, nb, dy, dz, parts, stream);
}

extern "C" int conv_prologue_bwd_finish(const void* parts, int nb,
                                        const void* dd, const void* dd_ext,
                                        const void* wt, const void* ws,
                                        const void* wg1, const void* wg2,
                                        int d, int h, void* dw, void* dbt,
                                        void* dbs, void* dwg1, void* dwg2,
                                        void* d_dd, void* stream) {
  if (d < 1 || h < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4LL * (4 * kTile + 4 * h + 2 * d + 2);
  cudaError_t rc = set_smem(
      reinterpret_cast<const void*>(&conv_prologue_bwd_finish_kernel), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  conv_prologue_bwd_finish_kernel<<<1, kFinishThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), nb, static_cast<const float*>(dd),
      static_cast<const float*>(dd_ext), static_cast<const float*>(wt),
      static_cast<const float*>(ws), static_cast<const float*>(wg1),
      static_cast<const float*>(wg2), d, h, static_cast<float*>(dw),
      static_cast<float*>(dbt), static_cast<float*>(dbs),
      static_cast<float*>(dwg1), static_cast<float*>(dwg2),
      static_cast<float*>(d_dd));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv_prologue_dx(void* dx, const void* dz, const void* d_dd,
                                const void* aux, const void* wg1,
                                const void* wg2, const void* central,
                                const void* target, int n, int d, int h,
                                int n_sum, void* stream) {
  if (n < 0 || d < 1 || h < 1 || n_sum < 0 || n_sum > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long smem = 8LL * d;
  cudaError_t rc = set_smem(
      reinterpret_cast<const void*>(&conv_prologue_dx_kernel), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  conv_prologue_dx_kernel<<<epi_blocks(n), 32 * kEpiWarps, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dx), static_cast<const float*>(dz),
      static_cast<const float*>(d_dd), static_cast<const float*>(aux),
      static_cast<const float*>(wg1), static_cast<const float*>(wg2),
      static_cast<const uint8_t*>(central),
      static_cast<const uint8_t*>(target), n, d, h, n_sum);
  return static_cast<int>(cudaGetLastError());
}
