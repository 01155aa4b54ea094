// Padded SpMM (gather and reduce by key) for Hopper (sm_90a).
//
//   gather_reduce  replaces the TPU kernel _reduce_kernel
//                  (bridged_gnn_tpu/ops/pallas_padded.py:33) in its
//                  destination-keyed use: slot_reduce_pallas and
//                  gather_reduce_pallas (pallas_padded.py:109-140) behind
//                  padded_slot_reduce / padded_gather_reduce
//                  (bridged_gnn_tpu/ops/blocked_segment.py:361-440), which
//                  BlockedOps.spmm runs for every aggregation of the model
//                  zoo, together with the row gather x[other_slot] and the
//                  weight fold vals·w that the JAX wrappers ran in XLA
//                  around the Pallas call.
//
// It computes, for every key row r over its entries k in [lo, hi) of
// ranges[r],
//   out[r] = Σ_k w(k) · x[idx[k]]        (entries with idx[k] < 0 skipped)
// in f32, in entry order; w(k) = w[wmap ? wmap[k] : k], or 1 when w is
// null (the unweighted instantiation reads no weight). Rows without
// entries, and rows past ranges, get zero. One entry point serves both
// directions of the SpMM y[v] = Σ_{(u,v)} w_uv · x[u]:
//   * forward: the layout's dst_ranges over the slots, idx = slot_src (-1
//     on pad and masked slots), w = the per-slot weights;
//   * the x-gradient dx[u] = Σ_{(u,v)} w_uv · dy[v] (JAX spmm_bwd,
//     blocked_segment.py:649-661, the transposed SpMM): the sender CSR,
//     ranges = src_ranges, idx = src_dst (each entry's destination row),
//     wmap = src_slots (each entry's slot, for its weight).
//
// Design for the card. The TPU kernel built a one-hot [nb, Et] matrix per
// destination block in VMEM and reduced the block's gathered slot rows in
// one MXU dot, after XLA had gathered the rows into a [B, Et, D] array in
// HBM. Here nothing per slot is written: each row's entries are a
// contiguous range, and the kernel gathers the x rows itself and sums them
// in registers. It is the sender reduce's walk (slot_reduce.cu) with one
// accumulator, a gather index and a weight:
//   * Lane groups. A warp splits into groups of G = min(32, ⌈D/4⌉) lanes,
//     rounded up to a power of two; each lane holds 4 columns (16-byte
//     loads when D % 4 == 0 and x is 16-byte aligned). A light row gets one
//     group, so 32/G rows share a warp. A group requests the rows of 4/kPer
//     entries, and the indices and weights of the next ones, before it adds
//     the first, so each lane keeps several loads in flight.
//   * Heavy rows. A row with more than kHeavyEntries entries (listed by the
//     host: dst_heavy forward, src_heavy backward) gets a block of its own:
//     its 16 warps each take one contiguous chunk of the entries, the
//     groups of a warp stride over the chunk, the groups merge by shuffles
//     and the warps in shared memory, in warp order. The grid puts these
//     blocks first; a light group returns at once on a heavy row.
//   * Column chunks. A lane group holds 4·G·kPer columns, at most 512; a
//     wider D is summed in column chunks of 512, each a pass over the
//     row's entries (plain, not fast).
// Every sum is taken in a fixed order, with no atomics: two launches give
// bit-identical outputs. f32 only (the JAX package refuses bf16 messages
// for the zoo).
//
// Bound: bytes. Per entry the kernel reads one index (and one weight) and
// one gathered D-wide f32 row, and does one multiply-add per element: at
// D = 64 that is 256 bytes of row for 128 operations. A row of x is read
// once per edge that reaches it; when x is larger than L2 (33.5 MB at
// D = 64 on the 131,072-node bench graph, 67 MB at D = 128) the gathers
// land in DRAM, so the time is set by the rate of scattered 256- and
// 512-byte row reads rather than by the bytes the bound counts (each row
// once).
//
// Build: see attention_fwd.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kWarps = 16;          // warps per block, light or heavy
constexpr int kHeavyEntries = 128;  // = HEAVY_SLOTS in Python

// One group sums the entries k0, k0 + stride, ... below hi, in that order,
// into acc. Lane gl of the group holds columns c0 + 4·(gl + kG·i) + j. The
// indices (and weights) of the next kU entries are requested before this
// step's rows are added. Index and weight arrays are read once: streaming
// loads; x rows are reused by other entries: cached loads.
template <bool kVec, int kG, int kPer, bool kW>
__device__ __forceinline__ void sum_entries(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ wmap,
    const float* __restrict__ w, const float* __restrict__ x, int d, int c0,
    int k0, int hi, int stride, int gl, float (&acc)[kPer][4]) {
  constexpr int kU = 4 / kPer;  // entries in flight per group
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int p[kU];
  float wt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int ku = k0 + u * stride;
    p[u] = ku < hi ? __ldcs(idx + ku) : -1;
    wt[u] = 1.f;
    if (kW && ku < hi) wt[u] = __ldcs(w + (wmap ? __ldcs(wmap + ku) : ku));
  }
  for (int k = k0; k < hi; k += kU * stride) {
    int next[kU];
    float wnext[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ku = k + (kU + u) * stride;
      next[u] = ku < hi ? __ldcs(idx + ku) : -1;
      wnext[u] = 1.f;
      if (kW && ku < hi)
        wnext[u] = __ldcs(w + (wmap ? __ldcs(wmap + ku) : ku));
    }
    float v[kU][kPer][4];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (p[u] >= 0) {
          load4<kVec>(x + (long long)p[u] * d, c0 + 4 * (gl + kG * i), d,
                      v[u][i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[u][i][j] = 0.f;
        }
      }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (p[u] < 0) continue;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kW) {
            acc[i][j] = fmaf(wt[u], v[u][i][j], acc[i][j]);
          } else {
            acc[i][j] += v[u][i][j];
          }
        }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      p[u] = next[u];
      wt[u] = wnext[u];
    }
  }
}

template <bool kVec, int kG, int kPer, bool kW>
__global__ void __launch_bounds__(kWarps * 32, 2)
gather_reduce_kernel(const int32_t* __restrict__ ranges,  // [n_ranges, 2]
                     const int32_t* __restrict__ idx,     // [entries]
                     const int32_t* __restrict__ wmap,    // [entries] | null
                     const float* __restrict__ w,         // weights | null
                     const float* __restrict__ x,         // [N_x, D]
                     const int32_t* __restrict__ heavy,   // [n_heavy] rows
                     int n_heavy, int d, int n_ranges, int n_rows,
                     float* __restrict__ out)  // [n_rows, D]
{
  constexpr int kGroups = 32 / kG;
  constexpr int kWP = 4 * kG * kPer;  // padded D, the width of a chunk
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kG;
  const int gl = lane % kG;
  float acc[kPer][4];

  if (blockIdx.x >= n_heavy) {  // light: one group per row
    const long long row =
        ((long long)(blockIdx.x - n_heavy) * kWarps + warp) * kGroups + grp;
    if (row >= n_rows) return;
    int lo = 0, hi = 0;
    if (row < n_ranges) {
      lo = ranges[2 * row];
      hi = ranges[2 * row + 1];
    }
    if (hi - lo > kHeavyEntries) return;  // a heavy block owns it
    float* __restrict__ orow = out + row * d;
    for (int c0 = 0; c0 < d; c0 += kWP) {
      sum_entries<kVec, kG, kPer, kW>(idx, wmap, w, x, d, c0, lo, hi, 1, gl,
                                      acc);
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        store4<kVec>(orow, c0 + 4 * (gl + kG * i), d, acc[i]);
    }
    return;
  }

  // Heavy row: warp `warp` takes the warp-th of kWarps contiguous chunks of
  // its entries; the groups of the warp stride over the chunk.
  __shared__ float s_part[kWarps][kWP];
  const int r = heavy[blockIdx.x];
  if (r >= n_rows || r >= n_ranges) return;
  const int lo = ranges[2 * r];
  const int hi = ranges[2 * r + 1];
  const int chunk = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(hi, lo + warp * chunk);
  const int whi = min(hi, wlo + chunk);
  float* __restrict__ orow = out + (long long)r * d;
  for (int c0 = 0; c0 < d; c0 += kWP) {
    sum_entries<kVec, kG, kPer, kW>(idx, wmap, w, x, d, c0, wlo + grp, whi,
                                    kGroups, gl, acc);
    // merge the groups: a butterfly over lane distances kG, ..., 16 (a sum
    // of two floats is the same on both partners)
#pragma unroll
    for (int o = kG; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
    if (lane < kG) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s_part[warp][4 * (gl + kG * i) + j] = acc[i][j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < min(kWP, d - c0); c += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += s_part[v][c];
      __stcs(orow + c0 + c, s);
    }
    __syncthreads();  // s_part is reused by the next chunk
  }
}

template <bool kVec, bool kW>
cudaError_t launch(const void* ranges, const void* idx, const void* wmap,
                   const void* w, const void* x, const void* heavy,
                   int n_heavy, int d, int n_ranges, int n_rows, void* out,
                   cudaStream_t st) {
  const dim3 block(kWarps * 32);
#define BGNN_LAUNCH(G, PER)                                                  \
  gather_reduce_kernel<kVec, G, PER, kW>                                     \
      <<<dim3(n_heavy + (n_rows + kWarps * (32 / G) - 1) /                   \
                            (kWarps * (32 / G))),                            \
         block, 0, st>>>(                                                    \
          static_cast<const int32_t*>(ranges),                               \
          static_cast<const int32_t*>(idx),                                  \
          static_cast<const int32_t*>(wmap), static_cast<const float*>(w),   \
          static_cast<const float*>(x), static_cast<const int32_t*>(heavy),  \
          n_heavy, d, n_ranges, n_rows, static_cast<float*>(out))
  // G = min(32, ⌈D/4⌉) rounded up to a power of two; 4·G·PER >= D up to
  // D = 512, wider D in chunks of 512
  if (d <= 4) {
    BGNN_LAUNCH(1, 1);
  } else if (d <= 8) {
    BGNN_LAUNCH(2, 1);
  } else if (d <= 16) {
    BGNN_LAUNCH(4, 1);
  } else if (d <= 32) {
    BGNN_LAUNCH(8, 1);
  } else if (d <= 64) {
    BGNN_LAUNCH(16, 1);
  } else if (d <= 128) {
    BGNN_LAUNCH(32, 1);
  } else if (d <= 256) {
    BGNN_LAUNCH(32, 2);
  } else {
    BGNN_LAUNCH(32, 4);
  }
#undef BGNN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// ranges [n_ranges, 2], idx and (optional) wmap [entries] int32; w f32
// weights (null: unweighted); x [N_x, D] f32; heavy [n_heavy] rows with
// more than kHeavyEntries entries; out [n_rows, D] f32.
extern "C" int gather_reduce(const void* ranges, const void* idx,
                             const void* wmap, const void* w, const void* x,
                             const void* heavy, int n_heavy, int d,
                             int n_ranges, int n_rows, void* out,
                             void* stream) {
  if (d < 1 || n_ranges < 0 || n_rows < 1 || n_heavy < 0 || x == nullptr ||
      (wmap != nullptr && w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out);
  cudaError_t rc;
  if (w != nullptr) {
    rc = vec ? launch<true, true>(ranges, idx, wmap, w, x, heavy, n_heavy, d,
                                  n_ranges, n_rows, out, st)
             : launch<false, true>(ranges, idx, wmap, w, x, heavy, n_heavy,
                                   d, n_ranges, n_rows, out, st);
  } else {
    rc = vec ? launch<true, false>(ranges, idx, wmap, w, x, heavy, n_heavy,
                                   d, n_ranges, n_rows, out, st)
             : launch<false, false>(ranges, idx, wmap, w, x, heavy, n_heavy,
                                    d, n_ranges, n_rows, out, st);
  }
  return static_cast<int>(rc);
}

extern "C" int gather_reduce_heavy_entries() { return kHeavyEntries; }
