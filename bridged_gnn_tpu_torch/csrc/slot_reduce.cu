// Sender-keyed slot reduce for Hopper (sm_90a).
//
//   slot_reduce  replaces the TPU kernel _reduce_kernel
//                (bridged_gnn_tpu/ops/pallas_padded.py:33) as the attention
//                backwards use it: the src-keyed reduce of the per-slot
//                cotangents (_gather_rows_vjp and _gather_sel_vjp,
//                bridged_gnn_tpu/ops/fused_attention.py:104, :563), together
//                with the dst-slot -> src-slot reorder (dm_flat[src_from_dst])
//                that the JAX caller ran before the Pallas call.
//
// It computes, for every sender row r over its CSR entries k, reading the
// dst-ordered slot rows by index and splitting them by the per-slot branch
// flag b (a backward's slot_c),
//   out[r] = [Σ_{k: b=1} vals[slots[k]] ‖ Σ_{k: b=0} vals[slots[k]]]
// ([n_rows, 2W]): a slot's W-wide row goes to out[r, :W] when its
// destination is central and to out[r, W:] otherwise. That folds in the
// [dm·c ‖ dm·(1−c)] of _gather_sel_vjp and the 2D-wide dm of
// _attention_bwd_kernel without an [S, 2D] temporary. Senders without
// entries, and rows past the CSR, get zero.
//
// Design for the card. The TPU kernel reduced a padded src-keyed [B, Et]
// grid with one-hot matmuls. Here the index is a CSR by sender over the real
// slots only (a padded sender grid would give every block a tile as wide as
// the heaviest hub sender's ~850 slots), and the kernel is built to keep many
// independent row loads in flight:
//   * Lane groups. A warp splits into groups of G = min(32, ⌈W/4⌉) lanes,
//     rounded up to a power of two; each lane holds 4 columns (16-byte
//     vector loads when W % 4 == 0 and vals is 16-byte aligned). A light
//     sender gets one group, so 32/G senders share a warp (16 at W = 8, 8 at
//     W = 16): a grid over 131k senders of one or two entries each, like the
//     hub graph's heavy tier, needs 32/G times fewer waves than one warp per
//     sender. A group requests the rows of 4/kPer entries before it adds the
//     first, and the slot ids of the next ones with them, so each lane
//     keeps several loads in flight and a step waits on one load.
//   * Heavy senders. A sender with more than kHeavyEntries entries (listed by
//     the host as the layout's src_heavy) gets a block of its own: its 16
//     warps each take one contiguous chunk of the entries, the groups of a
//     warp stride over the chunk, the groups merge by shuffles and the warps
//     in shared memory, in warp order. The grid puts these blocks first; a
//     light group returns at once on a heavy sender. kHeavyEntries = 128: a
//     light group walks its entries 4 at a time in chains of ~1.5 µs (index,
//     branch flag, row), so a 128-entry sender takes ~50 µs, about one wave
//     of a bench-size call; the main path's ordinary senders (at most ~70
//     entries) stay light and only hub senders (~850) go heavy.
//   * Column chunks. A lane group holds 4·G·kPer columns, at most 512; a
//     wider W is reduced in column chunks of 512, each a pass over the
//     sender's entries (plain, not fast; the main path's widths take one).
// Every sum is taken in a fixed order (a light sender's in CSR order, as
// before), with no atomics: two launches give bit-identical outputs.
//
// Message types. vals is f32 or bf16 (T, chosen at compile time; the entry
// point slot_reduce_bf16 takes a bf16 dm): a bf16 row is read as 8-byte
// quads and widened, and every sum and the output stay f32, in the same
// order as for f32 rows.
//
// Bound: bytes. Per entry the kernel reads one scattered W-wide f32 row
// (bf16: half the bytes) and adds it: one flop per 4 bytes. Each slot row
// is read exactly once, in sender order, so the reads land at random in an
// array far larger than L2
// (147 MB at W = 8 on the bench graph): at small W the time is set by the
// rate of scattered 32- and 64-byte DRAM reads rather than by bandwidth.
// Slot rows and outputs are touched once: streaming loads and stores.
//
// Build: see attention_fwd.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_groups.cuh"

namespace {

constexpr int kWarps = 16;          // warps per block, light or heavy
constexpr int kHeavyEntries = 128;  // see the header; = HEAVY_SLOTS in Python

// Every slot row is read once and every output row written once: streaming
// (evict-first) loads (load4<kVec, true>) and stores keep L2 for the index
// and the flags.

// One group sums the entries k0, k0 + stride, ... below hi, in that order,
// into acc1 (branch 1) and acc2 (branch 0). Lane gl of the group holds
// columns c0 + 4·(gl + kG·i) + j of the chunk starting at c0. The slot ids
// of the next kU entries are requested before this step's rows are added.
template <bool kVec, int kG, int kPer, typename T>
__device__ __forceinline__ void sum_entries(
    const int32_t* __restrict__ slots, const T* __restrict__ vals,
    const uint8_t* __restrict__ branch, int w, int c0, int k0, int hi,
    int stride, int gl, float (&acc1)[kPer][4], float (&acc2)[kPer][4]) {
  constexpr int kU = 4 / kPer;  // entries in flight per group
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  int p[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int ku = k0 + u * stride;
    p[u] = ku < hi ? __ldcs(slots + ku) : -1;
  }
  for (int k = k0; k < hi; k += kU * stride) {
    int next[kU];
    bool b[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ku = k + (kU + u) * stride;
      next[u] = ku < hi ? __ldcs(slots + ku) : -1;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) b[u] = p[u] >= 0 && branch[p[u]];
    float v[kU][kPer][4];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (p[u] >= 0) {
          load4<kVec, true>(vals + (long long)p[u] * w,
                            c0 + 4 * (gl + kG * i), w, v[u][i]);
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
          if (b[u]) {
            acc1[i][j] += v[u][i][j];
          } else {
            acc2[i][j] += v[u][i][j];
          }
        }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) p[u] = next[u];
  }
}

template <bool kVec, int kG, int kPer, typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
slot_reduce_kernel(const int32_t* __restrict__ ranges,  // [n_ranges, 2]
                   const int32_t* __restrict__ slots,   // [R] dst slot
                   const T* __restrict__ vals,          // [S, W]
                   const uint8_t* __restrict__ branch,  // [S]
                   const int32_t* __restrict__ heavy,   // [n_heavy] senders
                   int n_heavy, int w, int n_ranges, int n_rows,
                   float* __restrict__ out)  // [n_rows, 2W]
{
  constexpr int kGroups = 32 / kG;
  constexpr int kWP = 4 * kG * kPer;  // padded W, the width of a chunk
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kG;
  const int gl = lane % kG;
  const long long ow = 2 * w;
  float acc1[kPer][4], acc2[kPer][4];

  if (blockIdx.x >= n_heavy) {  // light: one group per sender
    const long long row =
        ((long long)(blockIdx.x - n_heavy) * kWarps + warp) * kGroups + grp;
    if (row >= n_rows) return;
    int lo = 0, hi = 0;
    if (row < n_ranges) {
      lo = ranges[2 * row];
      hi = ranges[2 * row + 1];
    }
    if (hi - lo > kHeavyEntries) return;  // a heavy block owns it
    float* __restrict__ orow = out + row * ow;
    for (int c0 = 0; c0 < w; c0 += kWP) {
      sum_entries<kVec, kG, kPer>(slots, vals, branch, w, c0, lo, hi, 1, gl,
                                  acc1, acc2);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = c0 + 4 * (gl + kG * i);
        store4<kVec>(orow, c, w, acc1[i]);
        store4<kVec>(orow + w, c, w, acc2[i]);
      }
    }
    return;
  }

  // Heavy sender: warp `warp` takes the warp-th of kWarps contiguous chunks
  // of its entries; the groups of the warp stride over the chunk.
  __shared__ float s_part[kWarps][kWP];
  const int r = heavy[blockIdx.x];
  const int lo = ranges[2 * r];
  const int hi = ranges[2 * r + 1];
  const int chunk = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(hi, lo + warp * chunk);
  const int whi = min(hi, wlo + chunk);
  float* __restrict__ orow = out + (long long)r * ow;
  for (int c0 = 0; c0 < w; c0 += kWP) {
    sum_entries<kVec, kG, kPer>(slots, vals, branch, w, c0, wlo + grp, whi,
                                kGroups, gl, acc1, acc2);
    // merge the groups: a butterfly over lane distances kG, ..., 16 (a sum
    // of two floats is the same on both partners)
#pragma unroll
    for (int o = kG; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] += __shfl_xor_sync(kFull, acc1[i][j], o);
          acc2[i][j] += __shfl_xor_sync(kFull, acc2[i][j], o);
        }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (lane < kG) {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s_part[warp][4 * (gl + kG * i) + j] =
                half ? acc2[i][j] : acc1[i][j];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < min(kWP, w - c0); c += blockDim.x) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) s += s_part[v][c];
        __stcs(orow + half * w + c0 + c, s);
      }
      __syncthreads();  // s_part is reused by the next half or chunk
    }
  }
}

template <bool kVec, typename T>
cudaError_t launch(const void* ranges, const void* slots, const void* vals,
                   const void* branch, const void* heavy, int n_heavy, int w,
                   int n_ranges, int n_rows, void* out, cudaStream_t st) {
  const dim3 block(kWarps * 32);
#define BGNN_LAUNCH(G, PER)                                                  \
  slot_reduce_kernel<kVec, G, PER, T>                                        \
      <<<dim3(n_heavy + (n_rows + kWarps * (32 / G) - 1) /                   \
                            (kWarps * (32 / G))),                            \
         block, 0, st>>>(                                                    \
          static_cast<const int32_t*>(ranges),                               \
          static_cast<const int32_t*>(slots),                                \
          static_cast<const T*>(vals),                                       \
          static_cast<const uint8_t*>(branch),                               \
          static_cast<const int32_t*>(heavy), n_heavy, w, n_ranges, n_rows,  \
          static_cast<float*>(out))
  // G = min(32, ⌈W/4⌉) rounded up to a power of two; 4·G·PER >= W up to
  // W = 512, wider W in chunks of 512
  if (w <= 4) {
    BGNN_LAUNCH(1, 1);
  } else if (w <= 8) {
    BGNN_LAUNCH(2, 1);
  } else if (w <= 16) {
    BGNN_LAUNCH(4, 1);
  } else if (w <= 32) {
    BGNN_LAUNCH(8, 1);
  } else if (w <= 64) {
    BGNN_LAUNCH(16, 1);
  } else if (w <= 128) {
    BGNN_LAUNCH(32, 1);
  } else if (w <= 256) {
    BGNN_LAUNCH(32, 2);
  } else {
    BGNN_LAUNCH(32, 4);
  }
#undef BGNN_LAUNCH
  return cudaGetLastError();
}

template <typename T>
int launch_any(const void* ranges, const void* slots, const void* vals,
               const void* branch, const void* heavy, int n_heavy, int w,
               int n_ranges, int n_rows, void* out, void* stream) {
  if (w < 1 || n_ranges < 0 || n_rows < 1 || n_heavy < 0 ||
      branch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && aligned_vec<T>(vals) && aligned16(out);
  const cudaError_t rc =
      vec ? launch<true, T>(ranges, slots, vals, branch, heavy, n_heavy, w,
                            n_ranges, n_rows, out, st)
          : launch<false, T>(ranges, slots, vals, branch, heavy, n_heavy, w,
                             n_ranges, n_rows, out, st);
  return static_cast<int>(rc);
}

}  // namespace

extern "C" int slot_reduce(const void* ranges, const void* slots,
                           const void* vals, const void* branch,
                           const void* heavy, int n_heavy, int w,
                           int n_ranges, int n_rows, void* out,
                           void* stream) {
  return launch_any<float>(ranges, slots, vals, branch, heavy, n_heavy, w,
                           n_ranges, n_rows, out, stream);
}

// The same with a bf16 vals (a bf16 dm); out stays f32.
extern "C" int slot_reduce_bf16(const void* ranges, const void* slots,
                                const void* vals, const void* branch,
                                const void* heavy, int n_heavy, int w,
                                int n_ranges, int n_rows, void* out,
                                void* stream) {
  return launch_any<__nv_bfloat16>(ranges, slots, vals, branch, heavy,
                                   n_heavy, w, n_ranges, n_rows, out, stream);
}

extern "C" int slot_reduce_heavy_entries() { return kHeavyEntries; }
