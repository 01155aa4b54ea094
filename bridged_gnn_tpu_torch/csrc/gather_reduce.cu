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
// Bound: bytes. Per entry the kernel reads one index (and one weight) and
// gathers one row of x, and does one multiply-add per element gathered:
// at D = 64 that is 256 bytes of row for 128 operations. The bound counts
// each row of x once from DRAM; a graph without sender locality (the
// bench graph is uniform random) reads a row once per edge that reaches
// it, so what the walk can reach is the rate of scattered row reads: from
// L2 while the rows it gathers fit there, from DRAM, at a fraction of that
// rate, once they do not (on the 131,072-node bench graph the table is
// 33.5 MB at D = 64, inside the 50 MB L2, and 67 MB at D = 128).
//
// Design for the card. The TPU kernel built a one-hot [nb, Et] matrix per
// destination block in VMEM and reduced the block's gathered slot rows in
// one MXU dot, after XLA had gathered the rows into a [B, Et, D] array in
// HBM. Here nothing per slot is written: each row's entries are a
// contiguous range, and the kernel gathers the x rows itself and sums them
// in registers.
//   * Column panels sized to L2. The m = ⌈D/4⌉ column quads are split into
//     n = ⌈m / (P/4)⌉ panels of ⌊m/n⌋ or ⌈m/n⌉ quads, P <= kMaxPanel
//     columns given by the host (fused_kernels.gather_panel: the widest
//     power-of-two panel whose N_x·P·4 bytes fill no more than a measured
//     share of L2, or one panel when the whole table does). The panel is
//     blockIdx.y, the slowest index of the grid, so the blocks in flight
//     all gather from one panel: its rows stay in L2 while every key row
//     sums it. Each panel walks the entries again, so a call of n panels
//     reads the indices n times (4.19M entries: 16.8 MB per panel on the
//     bench graph, as much again for the weights), streamed and evicted
//     first: 4 or 8 bytes per entry against a DRAM gather of the panel's
//     row. A weighted transpose of several panels gets its weights in the
//     sender CSR's order from the host (one gather through src_slots for
//     the call), not through wmap in every panel.
//   * Lane groups from the panel. A warp splits into groups of G lanes,
//     G the power of two that covers the widest panel's quads (16 at a
//     64-column panel); each lane holds 4 columns (16-byte loads when
//     D % 4 == 0 and x is 16-byte aligned). A light row gets one group, so
//     32/G rows share a warp. A group keeps kU entries in flight whatever
//     the width, fixed by G in launch: 8 at groups of 4 to 16 lanes (a
//     panel of 9 to 64 columns), 4 with 1 or 2 lanes (there 8 entries'
//     indices and weights spill past the 64 registers a thread has at two
//     blocks per SM) and with 32. It requests their rows before it adds
//     the first. The indices and weights of the next kU entries are
//     fetched one per lane, coalesced, during that wait and handed out by
//     shuffles within the group, so the in-flight rows and not the indices
//     take the registers.
//   * Heavy rows. A row with more than kHeavyEntries entries (listed by the
//     host: dst_heavy forward, src_heavy backward) gets blocks of its own:
//     their 16 warps each take one contiguous chunk of the entries,
//     S = 32 / group_lanes(D) strands of a warp stride over the chunk,
//     the strands merge by shuffles and the warps in shared memory, in
//     warp order. S follows D and not the panel, so a heavy row's order,
//     like a light row's entry order, is the same at every panel width.
//     A panel narrower than D leaves a warp 32/G groups for S strands:
//     the other groups take the next panels, so one block sums
//     group_lanes(D)/G panels side by side (at D = 128 in two 64-column
//     panels, both in the first panel's block; the later panel's block
//     returns at once). The grid puts these blocks first in each panel; a
//     light group returns at once on a heavy row.
// Every sum is taken in a fixed order, with no atomics: two launches, and
// launches at any two panel widths, give bit-identical outputs, the same
// as one walk of the whole width would. f32 only (the JAX package refuses
// bf16 messages for the zoo).
//
// Build: see attention_fwd.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kWarps = 16;          // warps per block, light or heavy
constexpr int kHeavyEntries = 128;  // = HEAVY_SLOTS in Python
constexpr int kMaxPanel = 128;      // columns, 32 lanes × 4; = MAX_PANEL in
                                    // Python

// The quads of D in panels of at most `panel` columns (see the header).
__host__ __device__ inline int panel_count(int d, int panel) {
  const int q = (panel + 3) / 4;
  return ((d + 3) / 4 + q - 1) / q;
}

// Panel p of n: columns [c0, c1).
__device__ __forceinline__ void panel_columns(int p, int n, int d, int& c0,
                                              int& c1) {
  const int m = (d + 3) / 4;
  c0 = 4 * (int)((long long)p * m / n);
  c1 = min(d, 4 * (int)((long long)(p + 1) * m / n));
}

// The value lane `src` of this lane's group holds (kG lanes, mask gmask).
template <int kG, typename T>
__device__ __forceinline__ T from_lane(unsigned gmask, T v, int src) {
  if constexpr (kG == 1) {
    return v;
  } else {
    return __shfl_sync(gmask, v, src, kG);
  }
}

// The indices and weights of the kU entries k, k + stride, ... (below hi;
// -1 past it), spread over the group: entry u with lane u % kG, in slot
// u / kG. Index, slot and weight arrays are read once: streaming loads.
template <int kG, int kU, bool kW>
__device__ __forceinline__ void load_batch(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ wmap,
    const float* __restrict__ w, int k, int hi, int stride, int gl,
    int (&p)[(kU + kG - 1) / kG], float (&wt)[(kU + kG - 1) / kG]) {
#pragma unroll
  for (int s = 0; s < (kU + kG - 1) / kG; ++s) {
    const int u = s * kG + gl;
    const int ku = k + u * stride;
    const bool in = u < kU && ku < hi;
    p[s] = in ? __ldcs(idx + ku) : -1;
    wt[s] = 1.f;
    if (kW && in) wt[s] = __ldcs(w + (wmap ? __ldcs(wmap + ku) : ku));
  }
}

// One group sums the entries k0, k0 + stride, ... below hi, in that order,
// into acc: lane gl holds columns c0 + 4·gl + j of the panel, of width
// `width`. Every lane of the group runs this with the same k0, hi and
// stride. x rows are reused by other entries: cached loads.
template <bool kVec, int kG, int kU, bool kW>
__device__ __forceinline__ void sum_entries(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ wmap,
    const float* __restrict__ w, const float* __restrict__ x, int d, int c0,
    int width, int k0, int hi, int stride, int gl, unsigned gmask,
    float (&acc)[4]) {
  constexpr int kS = (kU + kG - 1) / kG;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
  int p[kS];
  float wt[kS];
  load_batch<kG, kU, kW>(idx, wmap, w, k0, hi, stride, gl, p, wt);
  const float* __restrict__ xc = x + c0;
  for (int k = k0; k < hi; k += kU * stride) {
    int pu[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      pu[u] = from_lane<kG>(gmask, p[u / kG], u % kG);
    float v[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (pu[u] >= 0) {
        load4<kVec>(xc + (long long)pu[u] * d, 4 * gl, width, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = 0.f;
      }
    }
    // the next entries' indices and weights, while the rows are in flight
    int pn[kS];
    float wn[kS];
    load_batch<kG, kU, kW>(idx, wmap, w, k + kU * stride, hi, stride, gl, pn,
                           wn);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float wu = kW ? from_lane<kG>(gmask, wt[u / kG], u % kG) : 1.f;
      if (pu[u] < 0) continue;  // the same on every lane of the group
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kW) {
          acc[j] = fmaf(wu, v[u][j], acc[j]);
        } else {
          acc[j] += v[u][j];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      p[s] = pn[s];
      wt[s] = wn[s];
    }
  }
}

template <bool kVec, int kG, int kU, bool kW>
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kG;
  const int gl = lane % kG;
  const unsigned gmask =
      kG == 32 ? kFull : ((1u << (kG & 31)) - 1u) << (grp * kG);
  int c0, c1;
  panel_columns(blockIdx.y, gridDim.y, d, c0, c1);
  const int width = c1 - c0;
  float acc[4];

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
    sum_entries<kVec, kG, kU, kW>(idx, wmap, w, x, d, c0, width, lo, hi, 1,
                                  gl, gmask, acc);
    store4<kVec>(out + row * d + c0, 4 * gl, width, acc);
    return;
  }

  // Heavy row: warp `warp` takes the warp-th of kWarps contiguous chunks of
  // its entries. Its groups form `slots` sets of `strands` (the strands of
  // a whole-width walk); set `slot` strides over the chunk in panel
  // blockIdx.y + slot, and the block of a later panel of the same sets
  // has nothing to do.
  const int strands = 32 / group_lanes(d);  // <= kGroups: the panel <= D
  const int slots = kGroups / strands;
  if (blockIdx.y % slots != 0) return;
  __shared__ float s_part[kWarps][4 * 32];  // [warp][slot·4·kG + column]
  const int r = heavy[blockIdx.x];
  if (r >= n_rows || r >= n_ranges) return;
  const int lo = ranges[2 * r];
  const int hi = ranges[2 * r + 1];
  const int chunk = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(hi, lo + warp * chunk);
  const int whi = min(hi, wlo + chunk);
  const int slot = grp / strands;
  const int hp = blockIdx.y + slot;  // this set's panel
  const bool on = hp < gridDim.y;
  if (on) panel_columns(hp, gridDim.y, d, c0, c1);
  sum_entries<kVec, kG, kU, kW>(idx, wmap, w, x, d, c0, on ? c1 - c0 : 0,
                                on ? wlo + grp % strands : whi, whi,
                                strands, gl, gmask, acc);
  // merge each set's strands: a butterfly over lane distances kG, ...,
  // kG·strands/2, within the set's aligned kG·strands lanes (a sum of two
  // floats is the same on both partners)
  for (int o = kG; o < kG * strands; o <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
  if (grp % strands == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s_part[warp][4 * (slot * kG + gl) + j] = acc[j];
  }
  __syncthreads();
  const int t = threadIdx.x;  // slots · 4·kG <= 128 < the block's threads
  const int tp = blockIdx.y + t / (4 * kG);
  if (t >= slots * 4 * kG || tp >= gridDim.y) return;
  panel_columns(tp, gridDim.y, d, c0, c1);
  const int c = t % (4 * kG);
  if (c >= c1 - c0) return;
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) s += s_part[v][t];
  __stcs(out + (long long)r * d + c0 + c, s);
}

template <bool kVec, bool kW>
cudaError_t launch(const void* ranges, const void* idx, const void* wmap,
                   const void* w, const void* x, const void* heavy,
                   int n_heavy, int d, int n_ranges, int n_rows, int panel,
                   void* out, cudaStream_t st) {
  const int n_panels = panel_count(d, panel);
  const int m = (d + 3) / 4;
  // G covers the widest panel's ⌈m/n⌉ quads
  const int g = group_lanes(4 * ((m + n_panels - 1) / n_panels));
  const dim3 block(kWarps * 32);
#define BGNN_LAUNCH(G, U)                                                    \
  gather_reduce_kernel<kVec, G, U, kW>                                       \
      <<<dim3(n_heavy + (n_rows + kWarps * (32 / G) - 1) /                   \
                            (kWarps * (32 / G)),                             \
              n_panels),                                                     \
         block, 0, st>>>(                                                    \
          static_cast<const int32_t*>(ranges),                               \
          static_cast<const int32_t*>(idx),                                  \
          static_cast<const int32_t*>(wmap), static_cast<const float*>(w),   \
          static_cast<const float*>(x), static_cast<const int32_t*>(heavy),  \
          n_heavy, d, n_ranges, n_rows, static_cast<float*>(out))
  switch (g) {
    case 1: BGNN_LAUNCH(1, 4); break;
    case 2: BGNN_LAUNCH(2, 4); break;
    case 4: BGNN_LAUNCH(4, 8); break;
    case 8: BGNN_LAUNCH(8, 8); break;
    case 16: BGNN_LAUNCH(16, 8); break;
    default: BGNN_LAUNCH(32, 4); break;
  }
#undef BGNN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// ranges [n_ranges, 2], idx and (optional) wmap [entries] int32; w f32
// weights (null: unweighted); x [N_x, D] f32; heavy [n_heavy] rows with
// more than kHeavyEntries entries; panel: the widest column panel, at most
// kMaxPanel; out [n_rows, D] f32.
extern "C" int gather_reduce(const void* ranges, const void* idx,
                             const void* wmap, const void* w, const void* x,
                             const void* heavy, int n_heavy, int d,
                             int n_ranges, int n_rows, int panel, void* out,
                             void* stream) {
  if (d < 1 || n_ranges < 0 || n_rows < 1 || n_heavy < 0 || x == nullptr ||
      (wmap != nullptr && w == nullptr) || panel < 1 || panel > kMaxPanel ||
      panel_count(d, panel) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(out);
  cudaError_t rc;
  if (w != nullptr) {
    rc = vec ? launch<true, true>(ranges, idx, wmap, w, x, heavy, n_heavy, d,
                                  n_ranges, n_rows, panel, out, st)
             : launch<false, true>(ranges, idx, wmap, w, x, heavy, n_heavy,
                                   d, n_ranges, n_rows, panel, out, st);
  } else {
    rc = vec ? launch<true, false>(ranges, idx, wmap, w, x, heavy, n_heavy,
                                   d, n_ranges, n_rows, panel, out, st)
             : launch<false, false>(ranges, idx, wmap, w, x, heavy, n_heavy,
                                    d, n_ranges, n_rows, panel, out, st);
  }
  return static_cast<int>(rc);
}

extern "C" int gather_reduce_heavy_entries() { return kHeavyEntries; }
extern "C" int gather_reduce_max_panel() { return kMaxPanel; }
