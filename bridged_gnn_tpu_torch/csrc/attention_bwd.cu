// Fused KT-GNN attention backward for Hopper (sm_90a).
//
// Two kernels, one loop:
//   attention_sel_bwd  replaces the TPU kernel _attention_sel_bwd_kernel
//                      (bridged_gnn_tpu/ops/pallas_fused.py:614) together with
//                      the sender-row gather that feeds it
//                      (fused_attention.py:674).
//   attention_bwd      replaces _attention_bwd_kernel (pallas_fused.py:281)
//                      together with its gather (fused_attention.py:200).
//
// For every destination row v, over its edge slots k with sender s_k, the
// forward computed (attention_fwd.cu)
//   z_k = m_sel[s_k] + ud[v],   logit_k = a_sel · leaky_relu(z_k),
//   α_k = softmax_v(logit_k),   out[v] = Σ_k α_k · m_sel[s_k],
// with the branch picked by the destination's flag c[v]: m_sel = c ? u1 : u2
// and a_sel = c ? a1 : a2. Given dout[v] and the forward's out[v] this kernel
// forms
//   S_v  = Σ_k α_k (m_k · dout[v]) = dout[v] · out[v]   (once per row; the
//          identity FlashAttention's backward uses as rowsum(dO ∘ O))
//   dα_k = m_sel[s_k] · dout[v],
//   dl_k = α_k·dα_k − α_k·S_v                       (softmax Jacobian)
//   dz_k = dl_k · a_sel · (z_k > 0 ? 1 : slope)     (leaky-relu gate)
// and writes
//   dm_k     = α_k · dout[v] + dz_k  per slot, D wide (the sender row's
//              cotangent in the destination's branch),
//   slot_c_k = c[v] per slot, the branch the sender-side reduce
//              (slot_reduce.cu) routes dm_k into (du1 or du2),
//   dud[v]   = Σ_k dz_k              (the destination's own row),
//   [da1 ‖ da2] += Σ_k dl_k · leaky_relu(z_k) into the destination's half,
//              as one partial per thread block; the wrapper sums them.
// The selective kernel reads the forward's ex and den (α = ex / den), the
// concatenated one α itself; apart from that they are the same kernel. The
// TPU's concatenated kernel wrote dm 2D wide with the unselected half zero;
// here both write it D wide with the branch flag, which halves the tiered
// path's dm traffic in the write and in the reduce's read. Pad slots and
// masked slots get dm = 0 and slot_c = 0.
//
// Bound: bytes. Per real slot the kernel reads a D-wide sender row (index
// and weight with it) and writes a D-wide dm row, against ~13·D flops, far
// below the card's f32 rate per byte. What limits it at the main path's
// widths is the chain of dependent loads per slot (index, row, dα
// reduction) with too few chains in flight, and, once enough are in flight,
// the scattered row reads at D = 64 (1.1 GB per bench call, from 67 MB of u
// tables that do not fit the 50 MB L2) plus the 1.1 GB dm write.
//
// Design for the card (the design of attention_fwd, attention_fwd.cu):
//   * One gather pass. S_v comes from dout and out before the slot loop, so
//     each row's slots are walked once: per slot, gather the sender row,
//     form dα, dl, the gate, dz and dm, accumulate dud and da.
//   * Lane groups. A row's lanes split into groups of G = min(32, ⌈D/4⌉)
//     lanes, rounded up to a power of two; each lane holds 4 columns
//     (16-byte loads and stores when D % 4 == 0 and the tensors are 16-byte
//     aligned). Each group takes its own slots of the row, two per step, so
//     a warp keeps 2·32/G sender rows in flight: 32 at D = 8, 4 at D = 64.
//     A group reduces dα with log2 G shuffles and keeps its own dud and da
//     accumulators; the groups merge them by a butterfly of shuffles at the
//     end of the row. The row's lanes load the sender ids and weights of 32
//     slots at once and hand them out by shuffle.
//   * Light rows. One warp takes one row at D > 8; at D <= 8 two rows (four
//     at D <= 4) share a warp.
//   * Heavy rows. A row with more than kHeavySlots slots (the layout's
//     dst_heavy) gets a block of its own, first in the grid: its 16 warps
//     each take one contiguous chunk of the row and merge dud and da in
//     shared memory in warp order. A light row's lanes skip a heavy row.
//     kHeavySlots is the forward's bound, for the forward's reason.
//   * The [da1 ‖ da2] partial is one row per thread block: each block sums
//     its rows' da in row order (a heavy block its warps' in warp order) in
//     shared memory; the wrapper sums the partials in block order.
//   * Index, weights, the row's own rows (ud, dout, out) and every output
//     are touched once: streaming loads and stores (evict-first), so that
//     L2 keeps the u tables.
//   No atomics: every sum is taken in a fixed order, so two launches on the
//   same inputs give bit-identical outputs.
//
// Message types. The u tables, ud and dm are f32 or bf16 (T, chosen at
// compile time; the entry points *_bf16 take bf16), as in attention_fwd.cu:
// bf16 rows are widened on load, every sum is f32, and each dm element is
// rounded to bf16 once, at its store (pad tails get bf16 zeros). The
// weights, out, dout, dud and da stay f32.
//
// Wide rows. Past kLaneGroupColumns = 256 columns a lane group cannot hold a
// row in registers, so those widths take attention_bwd_wide_kernel, chosen
// at launch. A block takes kWideRows rows in turn; per row it reduces S_v,
// then its warps take the slots in turn and store each slot's dl (from dα,
// reduced over all D columns) in a per-slot scratch the wrapper allocates
// for wide widths only, with the slot's branch flag; then each thread takes
// the columns c, c + 256, ... and walks the row's slots in order, writing dm
// and summing dud and da. Each block's da partial row accumulates its rows
// in row order, each thread on its own columns. Every sender row is read
// twice: plain, not fast; the main path's widths never take it.
//
// Build: see attention_fwd.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kWarps = 16;      // warps per block, light or heavy
constexpr int kWideWarps = 8;   // warps per block of the wide path
constexpr int kWideRows = 16;   // destination rows per block of the wide path

// Per-lane state of one destination row: its own rows' columns and the
// row's dud and da accumulators.
template <int kPer>
struct Row {
  float go[kPer][4], dst[kPer][4], av[kPer][4];
  float dud[kPer][4], da[kPer][4];
};

// Load the row's dout, ud and a_sel columns into `r` and return S_v =
// dout[v] · out[v] (the same value on every group of the row).
template <int kG, int kPer, bool kVec, typename T>
__device__ __forceinline__ float load_row(
    int row, bool live, int gl, const float* __restrict__ dout,
    const float* __restrict__ out, const T* __restrict__ ud,
    const float* __restrict__ a, int d, Row<kPer>& r) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = 4 * (gl + kG * i);
    if (live) {
      float ov[4];
      load4<kVec, true>(dout + (long long)row * d, c, d, r.go[i]);
      load4<kVec, true>(out + (long long)row * d, c, d, ov);
      load4<kVec, true>(ud + (long long)row * d, c, d, r.dst[i]);
      load4<kVec>(a, c, d, r.av[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) s += r.go[i][j] * ov[j];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r.go[i][j] = r.dst[i][j] = r.av[i][j] = 0.f;
    }
  }
  return group_sum<kG>(s);
}

// The kSub lanes of a sub-warp walk the slots [lo, hi) of one destination
// once: group g of its kSub/kG groups takes slots lo + g + kSub/kG·t, two per
// step. The sub-warp loads the sender ids and weights of kSub slots at once
// and hands them to the groups by shuffle. Every lane of the warp runs the
// most steps any of its rows needs, so the shuffles see the whole warp; an
// empty range walks nothing. Writes every slot's dm row and branch flag and
// leaves the row's dud and da sums in r, equal on every group.
template <int kG, int kPer, bool kVec, int kSub, bool kConcat, typename T>
__device__ __forceinline__ void bwd_walk(
    const int32_t* __restrict__ src, const float* __restrict__ slot_w,
    int lo, int hi, const T* __restrict__ tab, float den_v, float s_v,
    bool is_c, float slope, int d, T* __restrict__ dm,
    uint8_t* __restrict__ slot_c, Row<kPer>& r) {
  constexpr int kGroups = kSub / kG;  // groups per row
  const int lane = threadIdx.x & 31;
  const int sl = lane % kSub;
  const int grp = sl / kG;
  const int gl = sl % kG;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r.dud[i][j] = r.da[i][j] = 0.f;

  int steps = (hi - lo + 2 * kGroups - 1) / (2 * kGroups);
#pragma unroll
  for (int o = kSub; o < 32; o <<= 1)
    steps = max(steps, __shfl_xor_sync(kFull, steps, o));
  int my_s = -1;     // sender id of slot w0 + sl of the current window
  float my_w = 0.f;  // its weight (ex or α)
  for (int t = 0; t < steps; ++t) {
    const int base = lo + 2 * kGroups * t;
    const int ka = base + grp;
    const int kb = ka + kGroups;
    int sa, sb;
    float wa, wb;
    if (kG == 1) {  // one lane per group: each loads its own two slots
      sa = ka < hi ? __ldcs(src + ka) : -1;
      sb = kb < hi ? __ldcs(src + kb) : -1;
      wa = ka < hi ? __ldcs(slot_w + ka) : 0.f;
      wb = kb < hi ? __ldcs(slot_w + kb) : 0.f;
    } else {  // a window of kSub slots serves kG/2 steps
      const int off = (2 * kGroups * t) % kSub;  // the same on every lane
      if (off == 0) {
        const int k = base + sl;
        my_s = k < hi ? __ldcs(src + k) : -1;
        my_w = k < hi ? __ldcs(slot_w + k) : 0.f;
      }
      const int ia = lane - sl + off + grp;
      sa = __shfl_sync(kFull, my_s, ia);
      sb = __shfl_sync(kFull, my_s, ia + kGroups);
      wa = __shfl_sync(kFull, my_w, ia);
      wb = __shfl_sync(kFull, my_w, ia + kGroups);
    }
    float ma[kPer][4], mb[kPer][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = 4 * (gl + kG * i);
      if (sa >= 0) {
        load4<kVec>(tab + (long long)sa * d, c, d, ma[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) ma[i][j] = 0.f;
      }
      if (sb >= 0) {
        load4<kVec>(tab + (long long)sb * d, c, d, mb[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) mb[i][j] = 0.f;
      }
    }
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa += ma[i][j] * r.go[i][j];
        pb += mb[i][j] * r.go[i][j];
      }
    pa = group_sum<kG>(pa);
    pb = group_sum<kG>(pb);
    // α is 0 on a masked or missing slot, and so are dl, dz and dm
    const float aa = sa >= 0 ? (kConcat ? wa : wa / den_v) : 0.f;
    const float ab = sb >= 0 ? (kConcat ? wb : wb / den_v) : 0.f;
    const float dla = aa * pa - aa * s_v;
    const float dlb = ab * pb - ab * s_v;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float dma[4], dmb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float za = ma[i][j] + r.dst[i][j];
        const float zb = mb[i][j] + r.dst[i][j];
        const float dza = dla * r.av[i][j] * (za > 0.f ? 1.f : slope);
        const float dzb = dlb * r.av[i][j] * (zb > 0.f ? 1.f : slope);
        dma[j] = sa >= 0 ? aa * r.go[i][j] + dza : 0.f;
        dmb[j] = sb >= 0 ? ab * r.go[i][j] + dzb : 0.f;
        r.dud[i][j] += dza + dzb;
        r.da[i][j] += dla * (za >= 0.f ? za : slope * za) +
                      dlb * (zb >= 0.f ? zb : slope * zb);
      }
      const int c = 4 * (gl + kG * i);
      if (ka < hi) store4<kVec>(dm + (long long)ka * d, c, d, dma);
      if (kb < hi) store4<kVec>(dm + (long long)kb * d, c, d, dmb);
    }
    if (gl == 0) {
      if (ka < hi) slot_c[ka] = sa >= 0 && is_c ? 1 : 0;
      if (kb < hi) slot_c[kb] = sb >= 0 && is_c ? 1 : 0;
    }
  }

  // Merge the row's groups: a butterfly over lane distances kG, ...,
  // kSub/2; both partners add the same two numbers, so every group ends
  // with the same sums.
#pragma unroll
  for (int o = kG; o < kSub; o <<= 1)
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r.dud[i][j] += __shfl_xor_sync(kFull, r.dud[i][j], o);
        r.da[i][j] += __shfl_xor_sync(kFull, r.da[i][j], o);
      }
}

// Four elements of T as one access: 16 bytes in f32, 8 in bf16.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

// The pad slots behind the last row of each layout block get dm = 0 and
// slot_c = 0, written by the lanes that own that row, `stride` apart from
// `first`.
template <bool kVec, typename T>
__device__ __forceinline__ void zero_tail(T* __restrict__ dm,
                                          uint8_t* __restrict__ slot_c,
                                          int row, int hi, int d,
                                          int node_block, int tile_e,
                                          int first, int stride) {
  if (row % node_block != node_block - 1) return;
  const long long end = (long long)(row / node_block + 1) * tile_e;
  for (long long k = hi + first; k < end; k += stride) slot_c[k] = 0;
  if (kVec) {  // d % 4 == 0: the tail starts on a 4-element boundary
    using V = typename Vec4<T>::type;
    V* q = reinterpret_cast<V*>(dm);
    for (long long e = (long long)hi * d / 4 + first; e < end * d / 4;
         e += stride)
      __stcs(q + e, V{});
  } else {
    for (long long e = (long long)hi * d + first; e < end * d; e += stride)
      __stcs(dm + e, from_f32<T>(0.f));
  }
}

// Two blocks per SM caps a thread at 64 registers; at D > 128 (kPer = 2)
// that would spill, so those widths take one block per SM.
template <int kG, int kPer, bool kVec, bool kConcat, typename T>
__global__ void __launch_bounds__(kWarps * 32, kPer == 1 ? 2 : 1)
attention_bwd_kernel(const int32_t* __restrict__ src,     // [S] sender or -1
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
                     const float* __restrict__ slot_w,  // [S] ex or alpha
                     const float* __restrict__ den,     // [n_out] (selective)
                     const float* __restrict__ out,     // [n_out, D]
                     const float* __restrict__ dout,    // [n_out, D]
                     T* __restrict__ dm,                // [S, D]
                     float* __restrict__ dud,           // [n_out, D]
                     float* __restrict__ da_part,       // [grid, 2D]
                     uint8_t* __restrict__ slot_c)      // [S]
{
  constexpr int kDP = 4 * kG * kPer;  // padded D
  constexpr int kRows = light_rows_per_warp(kG);
  constexpr int kSub = 32 / kRows;    // lanes per light row
  // da of each row of a light block (each warp of a heavy block), with the
  // row's branch (-1: no row); dud of each warp of a heavy block
  __shared__ float s_da[kWarps * kRows][kDP];
  __shared__ int s_c[kWarps * kRows];
  __shared__ float s_dud[kWarps][kDP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane % kG;
  float* __restrict__ part = da_part + (long long)blockIdx.x * 2 * d;
  Row<kPer> r;

  if (blockIdx.x >= n_heavy) {
    // Light rows: sub-warp `sub` owns row `row` unless the row lies past the
    // layout or is heavy (a heavy block owns it, pad tail included). Lanes
    // of rows they do not own walk an empty range, for the shuffles.
    const int sl = lane % kSub;
    const int sub = warp * kRows + lane / kSub;
    const int row = (blockIdx.x - n_heavy) * kWarps * kRows + sub;
    int lo = 0, hi = 0;
    bool mine = false;
    if (row < n_rows_layout) {
      lo = ranges[2 * row];
      hi = ranges[2 * row + 1];
      mine = hi - lo <= kHeavySlots;
    }
    if (mine)
      zero_tail<kVec>(dm, slot_c, row, hi, d, node_block, tile_e, sl, kSub);
    const bool live = mine && row < n_out;
    if (!live) hi = lo;
    const bool is_c = live && central[row];
    const float s_v = load_row<kG, kPer, kVec>(row, live, gl, dout, out, ud,
                                               is_c ? a1 : a2, d, r);
    const float den_v = kConcat || !live ? 1.f : den[row];
    bwd_walk<kG, kPer, kVec, kSub, kConcat>(src, slot_w, lo, hi,
                                            is_c ? u1 : u2, den_v, s_v, is_c,
                                            slope, d, dm, slot_c, r);
    if (sl < kG) {  // the row's group 0
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = 4 * (gl + kG * i);
        if (live) store4<kVec>(dud + (long long)row * d, c, d, r.dud[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s_da[sub][c + j] = r.da[i][j];
      }
      if (sl == 0) s_c[sub] = live ? (is_c ? 1 : 0) : -1;
    }
    __syncthreads();
    // the block's [da1 ‖ da2] partial: its rows in row order
    for (int t = threadIdx.x; t < 2 * d; t += blockDim.x) {
      const int want = t < d ? 1 : 0;
      const int c = t < d ? t : t - d;
      float sum = 0.f;
#pragma unroll 4
      for (int k = 0; k < kWarps * kRows; ++k)
        if (s_c[k] == want) sum += s_da[k][c];
      __stcs(part + t, sum);
    }
    return;
  }

  // Heavy row: warp w walks the w-th of kWarps contiguous chunks, then the
  // warps' dud and da merge in shared memory in warp order.
  const int row = heavy[blockIdx.x];
  const int lo = ranges[2 * row];
  int hi = ranges[2 * row + 1];
  zero_tail<kVec>(dm, slot_c, row, hi, d, node_block, tile_e, threadIdx.x,
                  blockDim.x);
  const bool live = row < n_out;  // the same on the whole block
  if (!live) hi = lo;
  const bool is_c = live && central[row];
  const float s_v = load_row<kG, kPer, kVec>(row, live, gl, dout, out, ud,
                                             is_c ? a1 : a2, d, r);
  const float den_v = kConcat || !live ? 1.f : den[row];
  const int chunk = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(hi, lo + warp * chunk);
  const int whi = min(hi, wlo + chunk);
  bwd_walk<kG, kPer, kVec, 32, kConcat>(src, slot_w, wlo, whi, is_c ? u1 : u2,
                                        den_v, s_v, is_c, slope, d, dm,
                                        slot_c, r);
  if (lane < kG) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_dud[warp][4 * (gl + kG * i) + j] = r.dud[i][j];
        s_da[warp][4 * (gl + kG * i) + j] = r.da[i][j];
      }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_dud[w][t];
    if (live) __stcs(dud + (long long)row * d + t, sum);
  }
  for (int t = threadIdx.x; t < 2 * d; t += blockDim.x) {
    const bool own = live && (t < d) == is_c;
    const int c = t < d ? t : t - d;
    float sum = 0.f;
    if (own) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_da[w][c];
    }
    __stcs(part + t, sum);
  }
}

// D > kLaneGroupColumns: kWideRows destination rows per block, in turn (see
// the header). `scratch` [S] takes each slot's dl.
template <bool kConcat, typename T>
__global__ void __launch_bounds__(kWideWarps * 32)
attention_bwd_wide_kernel(const int32_t* __restrict__ src,
                          const int32_t* __restrict__ ranges,
                          const T* __restrict__ u1,
                          const T* __restrict__ u2,
                          const T* __restrict__ ud,
                          const bool* __restrict__ central,
                          const float* __restrict__ a1,
                          const float* __restrict__ a2, float slope, int d,
                          int n_rows_layout, int n_out, int node_block,
                          int tile_e, const float* __restrict__ slot_w,
                          const float* __restrict__ den,
                          const float* __restrict__ out,
                          const float* __restrict__ dout,
                          T* __restrict__ dm, float* __restrict__ dud,
                          float* __restrict__ da_part,
                          uint8_t* __restrict__ slot_c,
                          float* __restrict__ scratch) {
  __shared__ float s_red[kWideWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the block's [da1 ‖ da2] partial: the thread of column c owns entries c
  // and d + c, so it adds its rows' sums there without a barrier
  float* __restrict__ part = da_part + (long long)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    part[c] = part[d + c] = 0.f;
  const int r0 = blockIdx.x * kWideRows;
  const int r1 = min(n_rows_layout, r0 + kWideRows);
  for (int row = r0; row < r1; ++row) {
    const int lo = ranges[2 * row];
    const int hi = ranges[2 * row + 1];
    zero_tail<false>(dm, slot_c, row, hi, d, node_block, tile_e, threadIdx.x,
                     blockDim.x);
    if (row >= n_out) continue;  // the whole block
    const bool is_c = central[row];
    const T* __restrict__ tab = is_c ? u1 : u2;
    const float* __restrict__ a = is_c ? a1 : a2;
    const float* __restrict__ go = dout + (long long)row * d;
    const T* __restrict__ urow = ud + (long long)row * d;
    const float den_v = kConcat ? 1.f : den[row];
    // S_v = dout[v] · out[v]: each warp by a butterfly, the warps in order
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      s += go[c] * out[(long long)row * d + c];
    s = group_sum<32>(s);
    if (lane == 0) s_red[warp] = s;
    __syncthreads();
    float s_v = 0.f;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) s_v += s_red[w];

    // 1. each slot's dl and branch flag, the warps taking the slots in turn
    for (int k = lo + warp; k < hi; k += kWideWarps) {
      const int sk = src[k];
      float dl = 0.f;  // 0 on a masked slot, and so are dz and dm
      if (sk >= 0) {
        const T* __restrict__ m = tab + (long long)sk * d;
        float p = 0.f;
        for (int c = lane; c < d; c += 32) p += to_f32(m[c]) * go[c];
        p = group_sum<32>(p);
        const float al = kConcat ? slot_w[k] : slot_w[k] / den_v;
        dl = al * p - al * s_v;
      }
      if (lane == 0) {
        scratch[k] = dl;
        slot_c[k] = sk >= 0 && is_c ? 1 : 0;
      }
    }
    __syncthreads();  // publishes dl; s_red is free again

    // 2. each thread's columns of dm, dud and da, the slots in order
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float g = go[c];
      const float u = to_f32(urow[c]);
      const float av = a[c];
      float dud_c = 0.f, da_c = 0.f;
      for (int k = lo; k < hi; ++k) {
        const int sk = src[k];
        float v = 0.f;
        if (sk >= 0) {
          const float al = kConcat ? slot_w[k] : slot_w[k] / den_v;
          const float dl = scratch[k];
          const float z = to_f32(tab[(long long)sk * d + c]) + u;
          const float dz = dl * av * (z > 0.f ? 1.f : slope);
          v = al * g + dz;
          dud_c += dz;
          da_c += dl * (z >= 0.f ? z : slope * z);
        }
        __stcs(dm + (long long)k * d + c, from_f32<T>(v));
      }
      __stcs(dud + (long long)row * d + c, dud_c);
      part[(is_c ? 0 : d) + c] += da_c;
    }
  }
}

// One block per heavy row, then one per kWarps·kRows light rows; wide
// widths one per kWideRows rows.
int grid_size(int n_rows_layout, int n_heavy, int d) {
  if (d > kLaneGroupColumns)
    return (n_rows_layout + kWideRows - 1) / kWideRows;
  const int per = kWarps * light_rows_per_warp(group_lanes(d));
  return n_heavy + (n_rows_layout + per - 1) / per;
}

template <bool kConcat, typename T>
cudaError_t launch(const void* src, const void* ranges, const void* u1,
                   const void* u2, const void* ud, const void* central,
                   const void* a1, const void* a2, float slope, int d,
                   int n_rows_layout, int n_out, int node_block, int tile_e,
                   const void* heavy, int n_heavy, const void* slot_w,
                   const void* den, const void* out, const void* dout,
                   void* dm, void* dud, void* da_part, int n_parts,
                   void* slot_c, void* scratch, void* stream) {
  if (d < 1 || n_rows_layout < 1 || n_out > n_rows_layout ||
      node_block < 1 || tile_e < 1 || n_heavy < 0 ||
      n_parts != grid_size(n_rows_layout, n_heavy, d) ||
      (d > kLaneGroupColumns && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kLaneGroupColumns) {
    attention_bwd_wide_kernel<kConcat, T>
        <<<dim3(n_parts), dim3(kWideWarps * 32), 0, st>>>(
            static_cast<const int32_t*>(src),
            static_cast<const int32_t*>(ranges),
            static_cast<const T*>(u1), static_cast<const T*>(u2),
            static_cast<const T*>(ud), static_cast<const bool*>(central),
            static_cast<const float*>(a1), static_cast<const float*>(a2),
            slope, d, n_rows_layout, n_out, node_block, tile_e,
            static_cast<const float*>(slot_w), static_cast<const float*>(den),
            static_cast<const float*>(out), static_cast<const float*>(dout),
            static_cast<T*>(dm), static_cast<float*>(dud),
            static_cast<float*>(da_part), static_cast<uint8_t*>(slot_c),
            static_cast<float*>(scratch));
    return cudaGetLastError();
  }
  const bool vec = d % 4 == 0 && aligned_vec<T>(u1) && aligned_vec<T>(u2) &&
                   aligned_vec<T>(ud) && aligned16(a1) && aligned16(a2) &&
                   aligned16(out) && aligned16(dout) && aligned_vec<T>(dm) &&
                   aligned16(dud);
  const dim3 grid(n_parts);
  const dim3 block(kWarps * 32);
#define BGNN_LAUNCH(G, PER, VEC)                                             \
  attention_bwd_kernel<G, PER, VEC, kConcat, T><<<grid, block, 0, st>>>(     \
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(ranges), \
      static_cast<const T*>(u1), static_cast<const T*>(u2),                  \
      static_cast<const T*>(ud), static_cast<const bool*>(central),          \
      static_cast<const float*>(a1), static_cast<const float*>(a2),          \
      static_cast<const int32_t*>(heavy), n_heavy, slope, d, n_rows_layout,  \
      n_out, node_block, tile_e, static_cast<const float*>(slot_w),          \
      static_cast<const float*>(den), static_cast<const float*>(out),        \
      static_cast<const float*>(dout), static_cast<T*>(dm),                  \
      static_cast<float*>(dud), static_cast<float*>(da_part),                \
      static_cast<uint8_t*>(slot_c))
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

extern "C" int attention_bwd_grid(int n_rows_layout, int n_heavy, int d) {
  return grid_size(n_rows_layout, n_heavy, d);
}

// The entry points: f32 tables and dm, and *_bf16 for bf16 ones (the same
// arguments).
#define BGNN_BWD_ENTRIES(SUFFIX, T)                                          \
  extern "C" int attention_sel_bwd##SUFFIX(                                  \
      const void* src, const void* ranges, const void* u1, const void* u2,  \
      const void* ud, const void* central, const void* a1, const void* a2,  \
      float slope, int d, int n_rows_layout, int n_out, int node_block,     \
      int tile_e, const void* heavy, int n_heavy, const void* ex,           \
      const void* den, const void* out, const void* dout, void* dm,         \
      void* dud, void* da_part, int n_parts, void* slot_c, void* scratch,   \
      void* stream) {                                                       \
    return static_cast<int>(launch<false, T>(                               \
        src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,  \
        n_out, node_block, tile_e, heavy, n_heavy, ex, den, out, dout, dm,  \
        dud, da_part, n_parts, slot_c, scratch, stream));                   \
  }                                                                         \
  extern "C" int attention_bwd##SUFFIX(                                      \
      const void* src, const void* ranges, const void* u1, const void* u2,  \
      const void* ud, const void* central, const void* a1, const void* a2,  \
      float slope, int d, int n_rows_layout, int n_out, int node_block,     \
      int tile_e, const void* heavy, int n_heavy, const void* alpha,        \
      const void* out, const void* dout, void* dm, void* dud,               \
      void* da_part, int n_parts, void* slot_c, void* scratch,              \
      void* stream) {                                                       \
    return static_cast<int>(launch<true, T>(                                \
        src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,  \
        n_out, node_block, tile_e, heavy, n_heavy, alpha, nullptr, out,     \
        dout, dm, dud, da_part, n_parts, slot_c, scratch, stream));         \
  }
BGNN_BWD_ENTRIES(, float)
BGNN_BWD_ENTRIES(_bf16, __nv_bfloat16)
#undef BGNN_BWD_ENTRIES
