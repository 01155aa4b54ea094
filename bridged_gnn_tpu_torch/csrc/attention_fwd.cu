// Fused KT-GNN attention forward for Hopper (sm_90a).
//
// Two kernels, one walk:
//   attention_sel_fwd  replaces the TPU kernel _attention_sel_kernel
//                      (bridged_gnn_tpu/ops/pallas_fused.py:501) together with
//                      the sender-row gather _gather_sel_rows that feeds it
//                      (bridged_gnn_tpu/ops/fused_attention.py:555).
//   attention_fwd      replaces _attention_kernel (pallas_fused.py:168) together
//                      with its gather _gather_rows (fused_attention.py:101).
//
// Both compute, for every destination row v over its incoming edge slots k,
//   logit_k = a_sel · leaky_relu(m_sel[s_k] + ud[v])
//   softmax over the slots of v, shifted by v's own running max,
// and aggregate the sender rows with those weights. The destination's domain
// flag c[v] picks the branch: m_sel = c ? u1 : u2 and a_sel = c ? a1 : a2.
//   selective:     out[v] = Σ_k ex_k · m_sel[s_k] / den_v   ([R, D])
//                  ex_k = exp(logit_k − max_v) per slot, den_v = Σ_k ex_k.
//   concatenated:  out[v] = [Σ_k α_k u1[s_k] ‖ Σ_k α_k u2[s_k]]   ([R, 2D])
//                  α_k = ex_k / den_v per slot; the wrapper picks the branch.
// A destination with no slot gets a zero row and den = 1. Pad slots of the
// layout and masked edges get ex = α = 0.
//
// Design for the card rather than the TPU. The TPU kernel expanded one-hot
// [nb, Et] matrices through its matrix unit and read pre-gathered [Et, D]
// messages. Here each destination's slots are one contiguous run (edges are
// dst-sorted); the kernel streams them once, keeps an online softmax (running
// max, rescaled sum and accumulators) in registers and gathers each sender
// row straight from the u tables. No [Et, D] message array and no one-hot
// matrix ever reach device memory.
//
// Bound: bytes. Per slot the kernel reads one D-wide f32 sender row (two for
// the concatenated kernel) and does ~5·D flops (~8·D concatenated), far below
// the card's 67 TFLOP/s f32 rate per byte moved. The bound counts each
// sender row once; the kernels read a row once per slot (~33 times on the
// main path), scattered, so what limits them is either the chain of
// dependent loads per slot (index, row, logit reduction, exp) with too few
// chains in flight, or, once enough are in flight and the u tables outgrow
// the 50 MB L2 (67 MB at D = 64), the row traffic itself (2·S·D·4 bytes).
// The selective kernel reads only the destination's table (33.5 MB at
// D = 64 while the grid walks the central rows, which bridged graphs put
// first); with senders spread uniformly over the graph that table still
// does not stay in L2: the bench graph's D = 64 call reads its 1.1 GB of
// rows at ~2.9 TB/s on an H100 SXM, the DRAM rate.
//
// Both kernels are built for loads in flight:
//   * Lane groups. A row's lanes split into groups of G = min(32, ⌈D/4⌉)
//     lanes, rounded up to a power of two; each lane of a group holds 4
//     columns (16-byte vector loads when D % 4 == 0 and the tables are
//     16-byte aligned). Each group takes its own slots of the row, two per
//     step, so a warp keeps 2·32/G sender rows in flight: 32 at D = 8, 4 at
//     D = 64. A group reduces its logit with log2 G shuffles and keeps its
//     own online-softmax state; the groups merge by shuffles at the end of
//     the row. The row's lanes load the sender ids of 32 slots at once and
//     hand them out by shuffle, so a step waits on its row loads only.
//   * Light rows. One warp takes one row at D > 8; at D <= 8 two rows (four
//     at D <= 4) share a warp, 16 (8) lanes each, since a main-path row of
//     ~33 slots would leave most of the groups of a whole warp idle and the
//     grid would need twice the waves.
//   * Heavy rows. A row with more than kHeavySlots slots (listed by the host
//     as the layout's dst_heavy) gets a block of its own: its 16 warps each
//     take one contiguous chunk of the row and merge their states in shared
//     memory in warp order. The grid puts these blocks first, then one block
//     for every 16 light warps; a light row's lanes skip a heavy row.
//     kHeavySlots = 128: a light warp at D = 64 (two groups) walks a row in
//     steps of four slots, each a chain of ~1–2 µs, so a 128-slot row takes
//     ~30–60 µs, about one wave of a bench-size call; the main path's ordinary
//     rows (at most ~70 slots) stay light and only hub rows go heavy.
//   * Each slot's raw logit is stored while the row is walked; once the
//     groups (and a heavy block's warps) have merged, the row's lanes
//     rewrite it as ex or α under the row's final max.
//   * Index, destination rows and outputs are touched once: streaming loads
//     and stores (evict-first), so that L2 keeps the u tables.
//   No atomics: every sum is taken in a fixed order, so two launches on the
//   same inputs give bit-identical outputs.
//
// Why the selective kernel no longer keeps its first loop. It was one warp
// per destination row with the lanes striding over D and one sender row in
// flight per warp: each slot a dependent chain (shuffle, row load, a 5-step
// warp sum, exp). At D = 8, 24 of the 32 lanes idled, and the D = 8 call took
// as long as the D = 64 call (0.40 against 0.50 ms, 25× and 9.7× their
// bounds); a long row of a single layout was walked by one warp. The loop
// was a latency wall, not a traffic wall, which is what the design above
// answers, so the two forwards now share it; the selective form loads one
// table, keeps one accumulator and writes ex and den.
//
// Message types. The u tables and ud are f32 or bf16 (T, chosen at compile
// time; the entry points *_bf16 take bf16). A bf16 lane loads its 4 columns
// as one 8-byte access and widens them to f32: logits, the softmax state,
// the accumulators and every output (out, ex or α, den) are f32, and the
// wrapper rounds out to bf16 once. The lane-to-column map, kPer, the heavy
// blocks and the launch switch are those of f32; the bf16 kernel moves half
// the row bytes.
//
// Wide rows. A lane group holds at most kLaneGroupColumns = 256 columns
// in registers (lane_groups.cuh). Wider rows take attention_fwd_wide_kernel,
// chosen at launch: one block per destination row; its warps take the row's
// slots in turn, each reduces one slot's logit over all D columns and stores
// it; the block reduces the row's max and sum (warps by butterfly, then in
// warp order) and rewrites the logits as ex; then each thread takes the
// columns c, c + 256, ... and sums ex·m over the row's slots in slot order.
// Every sender row is read twice. It is plain, not fast; the main path's
// widths (8 and 64) never take it.
//
// Build: one nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -c
//        -Xcompiler -fPIC per source, linked with -shared (see
//        bridged_gnn_tpu_torch/ops/fused_kernels.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kWarps = 16;      // warps per block, light or heavy
constexpr int kWideWarps = 8;   // warps per block of the wide path

// Online-softmax state of one lane: the running max and sum (equal on all
// lanes of a group) and the lane's columns of the accumulators: acc1 sums
// the selected table's rows (selective) or u1's (concatenated), acc2 u2's
// (concatenated only).
template <int kPer>
struct FwdState {
  float mx, den;
  float acc1[kPer][4], acc2[kPer][4];
};

// The kSub lanes of a sub-warp walk the slots [lo, hi) of one destination:
// group g of its kSub/kG groups takes slots lo + g + kSub/kG·t, two per
// step. The sub-warp loads the sender ids of kSub slots at once and hands
// them to the groups by shuffle, so a step waits on its row loads only.
// Every lane of the warp runs the most steps any of its rows needs, so the
// shuffles see the whole warp; an empty range walks nothing. The
// selective form reads the rows of t1 alone (the destination's table); the
// concatenated one reads t1 = u1 and t2 = u2 and takes the logit from the
// destination's branch. Writes each slot's raw logit (−inf on masked
// slots) and leaves the row's merged state in `st`, equal on every lane of
// the sub-warp for mx and den and on every group for the accumulators.
template <int kG, int kPer, bool kVec, int kSub, bool kConcat, typename T>
__device__ __forceinline__ void fwd_walk(
    const int32_t* __restrict__ src, int lo, int hi,
    const T* __restrict__ t1, const T* __restrict__ t2,
    const float (&dst)[kPer][4], const float (&av)[kPer][4], bool is_c,
    float slope, int d, float* __restrict__ slot_w, FwdState<kPer>& st) {
  constexpr int kGroups = kSub / kG;  // groups per row
  const int lane = threadIdx.x & 31;
  const int sl = lane % kSub;
  const int grp = sl / kG;
  const int gl = sl % kG;
  st.mx = -INFINITY;
  st.den = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st.acc1[i][j] = st.acc2[i][j] = 0.f;

  int steps = (hi - lo + 2 * kGroups - 1) / (2 * kGroups);
#pragma unroll
  for (int o = kSub; o < 32; o <<= 1)
    steps = max(steps, __shfl_xor_sync(kFull, steps, o));
  int my_s = -1;  // the sender id of slot w0 + sl of the current window
  for (int t = 0; t < steps; ++t) {
    const int base = lo + 2 * kGroups * t;
    const int ka = base + grp;
    const int kb = ka + kGroups;
    int sa, sb;
    if (kG == 1) {  // one lane per group: each loads its own two ids
      sa = ka < hi ? __ldcs(src + ka) : -1;
      sb = kb < hi ? __ldcs(src + kb) : -1;
    } else {  // a window of kSub ids serves kG/2 steps
      const int off = (2 * kGroups * t) % kSub;  // the same on every lane
      if (off == 0) my_s = base + sl < hi ? __ldcs(src + base + sl) : -1;
      sa = __shfl_sync(kFull, my_s, lane - sl + off + grp);
      sb = __shfl_sync(kFull, my_s, lane - sl + off + grp + kGroups);
    }
    float m1a[kPer][4], m2a[kPer][4], m1b[kPer][4], m2b[kPer][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = 4 * (gl + kG * i);
      if (sa >= 0) {
        load4<kVec>(t1 + (long long)sa * d, c, d, m1a[i]);
        if constexpr (kConcat)
          load4<kVec>(t2 + (long long)sa * d, c, d, m2a[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) m1a[i][j] = m2a[i][j] = 0.f;
      }
      if (sb >= 0) {
        load4<kVec>(t1 + (long long)sb * d, c, d, m1b[i]);
        if constexpr (kConcat)
          load4<kVec>(t2 + (long long)sb * d, c, d, m2b[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) m1b[i][j] = m2b[i][j] = 0.f;
      }
    }
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool other = kConcat && !is_c;  // the logit reads u2's row
        const float za = (other ? m2a[i][j] : m1a[i][j]) + dst[i][j];
        const float zb = (other ? m2b[i][j] : m1b[i][j]) + dst[i][j];
        pa += (za >= 0.f ? za : slope * za) * av[i][j];
        pb += (zb >= 0.f ? zb : slope * zb) * av[i][j];
      }
    pa = group_sum<kG>(pa);
    pb = group_sum<kG>(pb);
    const float la = sa >= 0 ? pa : -INFINITY;
    const float lb = sb >= 0 ? pb : -INFINITY;
    if (gl == 0) {  // raw logits; rescaled into ex or α once the row is done
      if (ka < hi) slot_w[ka] = la;
      if (kb < hi) slot_w[kb] = lb;
    }
    const float nm = fmaxf(st.mx, fmaxf(la, lb));
    if (nm != -INFINITY) {
      const float sc = expf(st.mx - nm);  // 0 while the state is empty
      const float ea = expf(la - nm);     // 0 on a masked or missing slot
      const float eb = expf(lb - nm);
      st.den = st.den * sc + ea + eb;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st.acc1[i][j] = st.acc1[i][j] * sc + ea * m1a[i][j] + eb * m1b[i][j];
          if constexpr (kConcat)
            st.acc2[i][j] =
                st.acc2[i][j] * sc + ea * m2a[i][j] + eb * m2b[i][j];
        }
      st.mx = nm;
    }
  }

  // Merge the row's groups: a butterfly over lane distances kG, ...,
  // kSub/2. Both partners compute the same products and sum (no
  // contraction into an FMA), so every group ends with the same state.
#pragma unroll
  for (int o = kG; o < kSub; o <<= 1) {
    const float omx = __shfl_xor_sync(kFull, st.mx, o);
    const float oden = __shfl_xor_sync(kFull, st.den, o);
    const float nm = fmaxf(st.mx, omx);
    const float s = st.mx == -INFINITY ? 0.f : expf(st.mx - nm);
    const float so = omx == -INFINITY ? 0.f : expf(omx - nm);
    st.den = __fadd_rn(__fmul_rn(st.den, s), __fmul_rn(oden, so));
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float o1 = __shfl_xor_sync(kFull, st.acc1[i][j], o);
        st.acc1[i][j] = __fadd_rn(__fmul_rn(st.acc1[i][j], s),
                                  __fmul_rn(o1, so));
        if constexpr (kConcat) {
          const float o2 = __shfl_xor_sync(kFull, st.acc2[i][j], o);
          st.acc2[i][j] = __fadd_rn(__fmul_rn(st.acc2[i][j], s),
                                    __fmul_rn(o2, so));
        }
      }
    st.mx = nm;
  }
}

// A slot's output weight from its raw logit under the row's final max:
// ex (selective) or α = ex / den (concatenated); 0 on a masked slot.
template <bool kConcat>
__device__ __forceinline__ float weight_of(float logit, float mx,
                                           float den_safe) {
  if (logit == -INFINITY) return 0.f;
  const float ex = expf(logit - mx);
  return kConcat ? ex / den_safe : ex;
}

// The pad slots behind the last row of each layout block are zeroed by the
// lanes that own that row, `stride` apart from `first`.
__device__ __forceinline__ void zero_tail(float* __restrict__ slot_w, int row,
                                          int hi, int node_block, int tile_e,
                                          int first, int stride) {
  if (row % node_block != node_block - 1) return;
  const long long tail_end = (long long)(row / node_block + 1) * tile_e;
  for (long long k = hi + first; k < tail_end; k += stride) slot_w[k] = 0.f;
}

// Two blocks per SM caps a thread at 64 registers; at D > 128 (kPer = 2)
// that would spill, so those widths take one block per SM.
template <int kG, int kPer, bool kVec, bool kConcat, typename T>
__global__ void __launch_bounds__(kWarps * 32, kPer == 1 ? 2 : 1)
attention_fwd_kernel(const int32_t* __restrict__ src,     // [S] sender or -1
                     const int32_t* __restrict__ ranges,  // [R_lay, 2]
                     const T* __restrict__ u1,            // [N_in, D]
                     const T* __restrict__ u2,            // [N_in, D]
                     const T* __restrict__ ud,            // [n_out, D]
                     const bool* __restrict__ central,    // [n_out]
                     const float* __restrict__ a1,        // [D]
                     const float* __restrict__ a2,        // [D]
                     const int32_t* __restrict__ heavy,   // [n_heavy] rows
                     int n_heavy, float slope, int d, int n_rows_layout,
                     int n_out, int node_block, int tile_e,
                     float* __restrict__ out,      // [n_out, D] or [n_out, 2D]
                     float* __restrict__ slot_w,   // [S] ex or alpha
                     float* __restrict__ den_out)  // [n_out] (selective)
{
  constexpr int kDP = 4 * kG * kPer;  // padded D
  constexpr int kRows = light_rows_per_warp(kG);
  constexpr int kSub = 32 / kRows;    // lanes per light row
  constexpr int kHalves = kConcat ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % kG;
  float dst[kPer][4], av[kPer][4];
  FwdState<kPer> st;

  if (blockIdx.x >= n_heavy) {
    // Light rows: sub-warp `sub` owns row `row` unless the row lies past the
    // layout or is heavy (a heavy block owns it, pad tail included). Lanes
    // of rows they do not own walk an empty range, for the shuffles.
    const int sl = lane % kSub;
    const int row =
        ((blockIdx.x - n_heavy) * kWarps + warp) * kRows + lane / kSub;
    int lo = 0, hi = 0;
    bool mine = false;
    if (row < n_rows_layout) {
      lo = ranges[2 * row];
      hi = ranges[2 * row + 1];
      mine = hi - lo <= kHeavySlots;
    }
    if (mine) zero_tail(slot_w, row, hi, node_block, tile_e, sl, kSub);
    const bool live = mine && row < n_out;
    if (!live) hi = lo;
    const bool is_c = live && central[row];
    const float* __restrict__ a = is_c ? a1 : a2;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = 4 * (sl % kG + kG * i);
      if (live) {
        load4<kVec, true>(ud + (long long)row * d, c, d, dst[i]);
        load4<kVec>(a, c, d, av[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[i][j] = av[i][j] = 0.f;
      }
    }
    fwd_walk<kG, kPer, kVec, kSub, kConcat>(src, lo, hi,
                                            kConcat || is_c ? u1 : u2, u2,
                                            dst, av, is_c, slope, d, slot_w,
                                            st);
    const float den_safe = st.den == 0.f ? 1.f : st.den;
    if (live && sl < kG) {  // the row's group 0 writes it
      float* __restrict__ orow = out + (long long)row * kHalves * d;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float v1[4], v2[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v1[j] = st.acc1[i][j] / den_safe;
          v2[j] = st.acc2[i][j] / den_safe;
        }
        const int c = 4 * (sl + kG * i);
        store4<kVec>(orow, c, d, v1);
        if constexpr (kConcat) store4<kVec>(orow + d, c, d, v2);
      }
      if (!kConcat && sl == 0) __stcs(den_out + row, den_safe);
    }
    __syncwarp();  // the row's raw logits, visible to all its lanes
    for (int k = lo + sl; k < hi; k += kSub)
      __stcs(slot_w + k, weight_of<kConcat>(slot_w[k], st.mx, den_safe));
    return;
  }

  // Heavy row: warp w walks the w-th of kWarps contiguous chunks, then the
  // warps' states merge in shared memory in warp order.
  const int row = heavy[blockIdx.x];
  const int lo = ranges[2 * row];
  const int hi = ranges[2 * row + 1];
  zero_tail(slot_w, row, hi, node_block, tile_e, threadIdx.x, blockDim.x);
  if (row >= n_out) return;  // the whole block
  const bool is_c = central[row];
  const float* __restrict__ a = is_c ? a1 : a2;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = 4 * (gl + kG * i);
    load4<kVec, true>(ud + (long long)row * d, c, d, dst[i]);
    load4<kVec>(a, c, d, av[i]);
  }
  __shared__ float s_mx[kWarps], s_den[kWarps];
  __shared__ float s_acc[kWarps][kHalves][kDP];
  const int chunk = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(hi, lo + warp * chunk);
  const int whi = min(hi, wlo + chunk);
  fwd_walk<kG, kPer, kVec, 32, kConcat>(src, wlo, whi,
                                        kConcat || is_c ? u1 : u2, u2, dst,
                                        av, is_c, slope, d, slot_w, st);
  if (lane == 0) {
    s_mx[warp] = st.mx;
    s_den[warp] = st.den;
  }
  if (lane < kG) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_acc[warp][0][4 * (gl + kG * i) + j] = st.acc1[i][j];
        if constexpr (kConcat)
          s_acc[warp][kHalves - 1][4 * (gl + kG * i) + j] = st.acc2[i][j];
      }
  }
  __syncthreads();  // also makes every warp's raw logits visible

  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_mx[w]);
  float scale[kWarps];
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    scale[w] = s_mx[w] == -INFINITY ? 0.f : expf(s_mx[w] - mx);
    den += s_den[w] * scale[w];
  }
  const float den_safe = den == 0.f ? 1.f : den;
  float* __restrict__ orow = out + (long long)row * kHalves * d;
  for (int t = threadIdx.x; t < kHalves * kDP; t += blockDim.x) {
    const int half = t / kDP;
    const int c = t % kDP;
    if (c >= d) continue;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += s_acc[w][half][c] * scale[w];
    __stcs(orow + half * d + c, acc / den_safe);
  }
  if (!kConcat && threadIdx.x == 0) __stcs(den_out + row, den_safe);
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x)
    __stcs(slot_w + k, weight_of<kConcat>(slot_w[k], mx, den_safe));
}

// The sum or the max of one value per thread of a kWideWarps-warp block,
// returned on every thread: each warp by a butterfly (both partners combine
// the same two numbers), then the warps' results in warp order.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s_red[0];
#pragma unroll
  for (int w = 1; w < kWideWarps; ++w)
    r = kMax ? fmaxf(r, s_red[w]) : r + s_red[w];
  __syncthreads();  // s_red is free again
  return r;
}

// D > kLaneGroupColumns: one block per destination row (see the header).
template <bool kConcat, typename T>
__global__ void __launch_bounds__(kWideWarps * 32)
attention_fwd_wide_kernel(const int32_t* __restrict__ src,
                          const int32_t* __restrict__ ranges,
                          const T* __restrict__ u1,
                          const T* __restrict__ u2,
                          const T* __restrict__ ud,
                          const bool* __restrict__ central,
                          const float* __restrict__ a1,
                          const float* __restrict__ a2, float slope, int d,
                          int n_out, int node_block, int tile_e,
                          float* __restrict__ out,
                          float* __restrict__ slot_w,
                          float* __restrict__ den_out) {
  __shared__ float s_red[kWideWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int lo = ranges[2 * row];
  const int hi = ranges[2 * row + 1];
  zero_tail(slot_w, row, hi, node_block, tile_e, threadIdx.x, blockDim.x);
  if (row >= n_out) return;  // the whole block
  const bool is_c = central[row];
  const T* __restrict__ tab = is_c ? u1 : u2;
  const float* __restrict__ a = is_c ? a1 : a2;
  const T* __restrict__ urow = ud + (long long)row * d;

  // 1. each slot's logit, the warps taking the slots in turn
  for (int k = lo + warp; k < hi; k += kWideWarps) {
    const int s = src[k];
    float logit = -INFINITY;
    if (s >= 0) {
      const T* __restrict__ m = tab + (long long)s * d;
      float part = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float z = to_f32(m[c]) + to_f32(urow[c]);
        part += (z >= 0.f ? z : slope * z) * a[c];
      }
      logit = group_sum<32>(part);
    }
    if (lane == 0) slot_w[k] = logit;
  }
  __syncthreads();

  // 2. the row's max and sum; each thread rewrites its slots' logits as ex
  float mx = -INFINITY;
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x)
    mx = fmaxf(mx, slot_w[k]);
  mx = block_reduce<true>(mx, s_red);
  float den = 0.f;
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const float ex = weight_of<false>(slot_w[k], mx, 1.f);
    slot_w[k] = ex;
    den += ex;
  }
  den = block_reduce<false>(den, s_red);  // its barrier publishes ex
  const float den_safe = den == 0.f ? 1.f : den;

  // 3. each thread's columns, summed over the slots in slot order
  float* __restrict__ orow = out + (long long)row * (kConcat ? 2 : 1) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc1 = 0.f, acc2 = 0.f;
    for (int k = lo; k < hi; ++k) {
      const int s = src[k];
      if (s < 0) continue;
      const float ex = slot_w[k];
      if constexpr (kConcat) {
        acc1 += ex * to_f32(u1[(long long)s * d + c]);
        acc2 += ex * to_f32(u2[(long long)s * d + c]);
      } else {
        acc1 += ex * to_f32(tab[(long long)s * d + c]);
      }
    }
    __stcs(orow + c, acc1 / den_safe);
    if constexpr (kConcat) __stcs(orow + d + c, acc2 / den_safe);
  }
  if constexpr (kConcat) {
    __syncthreads();  // every thread is done reading ex
    for (int k = lo + threadIdx.x; k < hi; k += blockDim.x)
      slot_w[k] = slot_w[k] / den_safe;
  } else {
    if (threadIdx.x == 0) den_out[row] = den_safe;
  }
}

template <bool kConcat, typename T>
cudaError_t launch(const void* src, const void* ranges, const void* u1,
                   const void* u2, const void* ud, const void* central,
                   const void* a1, const void* a2, float slope, int d,
                   int n_rows_layout, int n_out, int node_block, int tile_e,
                   const void* heavy, int n_heavy, void* out, void* slot_w,
                   void* den, cudaStream_t st) {
  if (d < 1 || n_rows_layout < 1 || n_out > n_rows_layout ||
      node_block < 1 || tile_e < 1 || n_heavy < 0 ||
      (!kConcat && den == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (d > kLaneGroupColumns) {
    attention_fwd_wide_kernel<kConcat, T>
        <<<dim3(n_rows_layout), dim3(kWideWarps * 32), 0, st>>>(
            static_cast<const int32_t*>(src),
            static_cast<const int32_t*>(ranges),
            static_cast<const T*>(u1), static_cast<const T*>(u2),
            static_cast<const T*>(ud), static_cast<const bool*>(central),
            static_cast<const float*>(a1), static_cast<const float*>(a2),
            slope, d, n_out, node_block, tile_e, static_cast<float*>(out),
            static_cast<float*>(slot_w), static_cast<float*>(den));
    return cudaGetLastError();
  }
  const bool vec = d % 4 == 0 && aligned_vec<T>(u1) && aligned_vec<T>(u2) &&
                   aligned_vec<T>(ud) && aligned16(a1) && aligned16(a2) &&
                   aligned16(out);
  const dim3 block(kWarps * 32);
  // one block per heavy row, then one per kWarps·kRows light rows
#define BGNN_LAUNCH(G, PER, VEC)                                             \
  attention_fwd_kernel<G, PER, VEC, kConcat, T>                              \
      <<<dim3(n_heavy + (n_rows_layout + kWarps * light_rows_per_warp(G) -  \
                         1) /                                                \
                            (kWarps * light_rows_per_warp(G))),              \
         block, 0, st>>>(                                                    \
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(ranges), \
      static_cast<const T*>(u1), static_cast<const T*>(u2),                  \
      static_cast<const T*>(ud), static_cast<const bool*>(central),          \
      static_cast<const float*>(a1), static_cast<const float*>(a2),          \
      static_cast<const int32_t*>(heavy), n_heavy, slope, d, n_rows_layout,  \
      n_out, node_block, tile_e, static_cast<float*>(out),                   \
      static_cast<float*>(slot_w), static_cast<float*>(den))
#define BGNN_LAUNCH_VEC(G, PER) \
  if (vec) {                    \
    BGNN_LAUNCH(G, PER, true);  \
  } else {                      \
    BGNN_LAUNCH(G, PER, false); \
  }
  switch (group_lanes(d)) {
    case 1: BGNN_LAUNCH_VEC(1, 1) break;
    case 2: BGNN_LAUNCH_VEC(2, 1) break;
    case 4: BGNN_LAUNCH_VEC(4, 1) break;
    case 8: BGNN_LAUNCH_VEC(8, 1) break;
    case 16: BGNN_LAUNCH_VEC(16, 1) break;
    default:
      if (d <= 128) {
        BGNN_LAUNCH_VEC(32, 1)
      } else {
        BGNN_LAUNCH_VEC(32, 2)
      }
  }
#undef BGNN_LAUNCH_VEC
#undef BGNN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// The entry points: f32 tables, and *_bf16 for bf16 ones (the same
// arguments; every output stays f32).
#define BGNN_FWD_ENTRIES(SUFFIX, T)                                          \
  extern "C" int attention_sel_fwd##SUFFIX(                                  \
      const void* src, const void* ranges, const void* u1, const void* u2,  \
      const void* ud, const void* central, const void* a1, const void* a2,  \
      float slope, int d, int n_rows_layout, int n_out, int node_block,     \
      int tile_e, const void* heavy, int n_heavy, void* out, void* ex,      \
      void* den, void* stream) {                                            \
    return static_cast<int>(launch<false, T>(                               \
        src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,  \
        n_out, node_block, tile_e, heavy, n_heavy, out, ex, den,            \
        static_cast<cudaStream_t>(stream)));                                \
  }                                                                         \
  extern "C" int attention_fwd##SUFFIX(                                      \
      const void* src, const void* ranges, const void* u1, const void* u2,  \
      const void* ud, const void* central, const void* a1, const void* a2,  \
      float slope, int d, int n_rows_layout, int n_out, int node_block,     \
      int tile_e, const void* heavy, int n_heavy, void* out, void* alpha,   \
      void* stream) {                                                       \
    return static_cast<int>(launch<true, T>(                                \
        src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,  \
        n_out, node_block, tile_e, heavy, n_heavy, out, alpha, nullptr,     \
        static_cast<cudaStream_t>(stream)));                                \
  }
BGNN_FWD_ENTRIES(, float)
BGNN_FWD_ENTRIES(_bf16, __nv_bfloat16)
#undef BGNN_FWD_ENTRIES

// The bounds both attention sources share (lane_groups.cuh).
extern "C" int attention_fwd_heavy_slots() { return kHeavySlots; }
extern "C" int attention_lane_group_columns() {
  return kLaneGroupColumns;
}
