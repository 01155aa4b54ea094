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
// It computes, for every sender row r over its CSR entries k,
//   out[r] = Σ_k vals[slots[k]]                      ([n_rows, W]),
// reading the dst-ordered slot rows by index. With a per-slot branch flag
// (the selective backward's slot_c) each D-wide row goes to one half of a
// [n_rows, 2W] output: out[r, :W] when the slot's destination is central,
// out[r, W:] otherwise. That folds in _gather_sel_vjp's [dm·c ‖ dm·(1−c)]
// without an [S, 2D] temporary. Senders without entries, and rows past the
// CSR, get zero.
//
// Design for the card. The TPU kernel reduced a padded src-keyed [B, Et]
// grid with one-hot matmuls. Here the index is a CSR by sender over the real
// slots only (a padded sender grid would give every block a tile as wide as
// the heaviest hub sender's ~850 slots). One warp owns one sender row and
// walks its entries in order, so each row's sum is taken in a fixed order:
// no atomics, bit-identical from run to run. Lanes stride over W (kPer
// values per lane, W <= 512); the warp loads 32 slot ids at a time and
// broadcasts them by shuffle.
//
// Bound: bytes. Per entry the kernel reads one scattered W-wide f32 row and
// adds it: one flop per 4 bytes.
//
// Build: see attention_bwd.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxW = 512;

template <bool kSplit, int kPer>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
slot_reduce_kernel(const int32_t* __restrict__ ranges,  // [n_ranges, 2]
                   const int32_t* __restrict__ slots,   // [R] dst slot
                   const float* __restrict__ vals,      // [S, W]
                   const uint8_t* __restrict__ branch,  // [S] (split only)
                   int w, int n_ranges, int n_rows,
                   float* __restrict__ out)  // [n_rows, W] or [n_rows, 2W]
{
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  int lo = 0, hi = 0;
  if (row < n_ranges) {
    lo = ranges[2 * row];
    hi = ranges[2 * row + 1];
  }
  float acc1[kPer], acc2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    acc1[i] = 0.f;
    acc2[i] = 0.f;
  }
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int kk = k0 + lane;
    const int my_p = kk < hi ? slots[kk] : 0;
    const int my_b = (kSplit && kk < hi) ? branch[my_p] : 1;
    const int cnt = min(32, hi - k0);
    for (int j = 0; j < cnt; ++j) {
      const long long p = __shfl_sync(kFull, my_p, j);
      const int b = __shfl_sync(kFull, my_b, j);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        const float v = c < w ? vals[p * w + c] : 0.f;
        if (!kSplit || b) {
          acc1[i] += v;
        } else {
          acc2[i] += v;
        }
      }
    }
  }
  const long long ow = kSplit ? 2 * w : w;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < w) {
      out[row * ow + c] = acc1[i];
      if (kSplit) out[row * ow + w + c] = acc2[i];
    }
  }
}

template <bool kSplit>
cudaError_t launch(const void* ranges, const void* slots, const void* vals,
                   const void* branch, int w, int n_ranges, int n_rows,
                   void* out, cudaStream_t st) {
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
#define BGNN_LAUNCH(PER)                                                     \
  slot_reduce_kernel<kSplit, PER><<<grid, block, 0, st>>>(                   \
      static_cast<const int32_t*>(ranges), static_cast<const int32_t*>(slots), \
      static_cast<const float*>(vals), static_cast<const uint8_t*>(branch),  \
      w, n_ranges, n_rows, static_cast<float*>(out))
  if (w <= 32) {
    BGNN_LAUNCH(1);
  } else if (w <= 64) {
    BGNN_LAUNCH(2);
  } else if (w <= 128) {
    BGNN_LAUNCH(4);
  } else if (w <= 256) {
    BGNN_LAUNCH(8);
  } else {
    BGNN_LAUNCH(16);
  }
#undef BGNN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int slot_reduce(const void* ranges, const void* slots,
                           const void* vals, const void* branch, int w,
                           int n_ranges, int n_rows, void* out,
                           void* stream) {
  if (w < 1 || w > kMaxW || n_ranges < 0 || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      branch != nullptr
          ? launch<true>(ranges, slots, vals, branch, w, n_ranges, n_rows,
                         out, st)
          : launch<false>(ranges, slots, vals, branch, w, n_ranges, n_rows,
                          out, st);
  return static_cast<int>(rc);
}
