// Fused KT-GNN attention forward for Hopper (sm_90a).
//
// Two kernels, one loop:
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
// messages. Here one warp owns one destination row: its slots are one
// contiguous run (edges are dst-sorted), so the warp streams them once, keeps
// an online softmax (running max, rescaled sum and accumulator) in registers
// and gathers each sender row straight from the u table. No [Et, D] message
// array and no one-hot matrix ever reach device memory. Lanes stride over D
// (kPer values per lane, D <= 256); the warp loads 32 sender ids at a time
// and broadcasts them by shuffle.
//
// Bound: bytes. Per slot the kernel reads a D-wide f32 sender row (two for the
// concatenated kernel) and does ~5·D flops, far below the card's 67 TFLOP/s
// f32 rate per byte moved. The rows are scattered 4·D-byte reads, so the
// achieved rate sits below the 3.35 TB/s streaming rate; the row-per-warp
// split keeps each such read coalesced across the warp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see bridged_gnn_tpu_torch/ops/fused_kernels.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kConcat, int kPer>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
attention_fwd_kernel(const int32_t* __restrict__ src,     // [S] sender or -1
                     const int32_t* __restrict__ ranges,  // [R_lay, 2]
                     const float* __restrict__ u1,        // [N_in, D]
                     const float* __restrict__ u2,        // [N_in, D]
                     const float* __restrict__ ud,        // [n_out, D]
                     const bool* __restrict__ central,    // [n_out]
                     const float* __restrict__ a1,        // [D]
                     const float* __restrict__ a2,        // [D]
                     float slope, int d, int n_rows_layout, int n_out,
                     int node_block, int tile_e,
                     float* __restrict__ out,      // [n_out, D] or [n_out, 2D]
                     float* __restrict__ slot_w,   // [S] ex or alpha
                     float* __restrict__ den_out)  // [n_out] (selective only)
{
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows_layout) return;
  const int lo = ranges[2 * row];
  const int hi = ranges[2 * row + 1];

  // The last row of a block ends where its block's real slots end; its warp
  // zeroes the pad slots behind them.
  if (row % node_block == node_block - 1) {
    const long long tail_end = (long long)(row / node_block + 1) * tile_e;
    for (long long k = hi + lane; k < tail_end; k += 32) slot_w[k] = 0.f;
  }
  if (row >= n_out) return;

  const bool is_c = central[row];
  const float* __restrict__ tab = is_c ? u1 : u2;
  const float* __restrict__ a = is_c ? a1 : a2;

  float dst[kPer], av[kPer], acc1[kPer], acc2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    const bool ok = c < d;
    dst[i] = ok ? ud[(long long)row * d + c] : 0.f;
    av[i] = ok ? a[c] : 0.f;
    acc1[i] = 0.f;
    acc2[i] = 0.f;
  }

  float mx = -INFINITY;
  float den = 0.f;
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int kk = k0 + lane;
    const int my_s = kk < hi ? src[kk] : -1;
    const int cnt = min(32, hi - k0);
    float my_logit = 0.f;
    for (int j = 0; j < cnt; ++j) {
      const int sj = __shfl_sync(kFull, my_s, j);
      if (sj < 0) {  // masked edge: no weight (uniform across the warp)
        if (lane == j) my_logit = -INFINITY;
        continue;
      }
      const long long s = sj;
      float m[kPer], m1[kPer], m2[kPer];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        if (kConcat) {
          m1[i] = c < d ? u1[s * d + c] : 0.f;
          m2[i] = c < d ? u2[s * d + c] : 0.f;
          m[i] = is_c ? m1[i] : m2[i];
        } else {
          m[i] = c < d ? tab[s * d + c] : 0.f;
        }
        const float z = m[i] + dst[i];
        const float h = z >= 0.f ? z : slope * z;
        part += h * av[i];
      }
      const float logit = warp_sum(part);
      const float new_mx = fmaxf(mx, logit);
      const float scale = expf(mx - new_mx);
      const float p = expf(logit - new_mx);
      den = den * scale + p;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (kConcat) {
          acc1[i] = acc1[i] * scale + p * m1[i];
          acc2[i] = acc2[i] * scale + p * m2[i];
        } else {
          acc1[i] = acc1[i] * scale + p * m[i];
        }
      }
      mx = new_mx;
      if (lane == j) my_logit = logit;
    }
    if (kk < hi) slot_w[kk] = my_logit;  // raw logit; rescaled below
  }

  const float den_safe = den == 0.f ? 1.f : den;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      if (kConcat) {
        out[(long long)row * 2 * d + c] = acc1[i] / den_safe;
        out[(long long)row * 2 * d + d + c] = acc2[i] / den_safe;
      } else {
        out[(long long)row * d + c] = acc1[i] / den_safe;
      }
    }
  }
  if (!kConcat && lane == 0) den_out[row] = den_safe;

  // Each lane rewrites the logits it stored itself, so no lane reads
  // another lane's write.
  for (int k = lo + lane; k < hi; k += 32) {
    const float l = slot_w[k];
    const float ex = l == -INFINITY ? 0.f : expf(l - mx);
    slot_w[k] = kConcat ? ex / den_safe : ex;
  }
}

template <bool kConcat>
cudaError_t launch(const void* src, const void* ranges, const void* u1,
                   const void* u2, const void* ud, const void* central,
                   const void* a1, const void* a2, float slope, int d,
                   int n_rows_layout, int n_out, int node_block, int tile_e,
                   void* out, void* slot_w, void* den, void* stream) {
  if (d < 1 || d > 256 || n_rows_layout < 1 || n_out > n_rows_layout ||
      node_block < 1 || tile_e < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((n_rows_layout + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BGNN_LAUNCH(PER)                                                    \
  attention_fwd_kernel<kConcat, PER><<<grid, block, 0, st>>>(               \
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(ranges), \
      static_cast<const float*>(u1), static_cast<const float*>(u2),          \
      static_cast<const float*>(ud), static_cast<const bool*>(central),      \
      static_cast<const float*>(a1), static_cast<const float*>(a2), slope, d, \
      n_rows_layout, n_out, node_block, tile_e, static_cast<float*>(out),    \
      static_cast<float*>(slot_w), static_cast<float*>(den))
  if (d <= 32) {
    BGNN_LAUNCH(1);
  } else if (d <= 64) {
    BGNN_LAUNCH(2);
  } else if (d <= 128) {
    BGNN_LAUNCH(4);
  } else {
    BGNN_LAUNCH(8);
  }
#undef BGNN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int attention_sel_fwd(const void* src, const void* ranges,
                                 const void* u1, const void* u2,
                                 const void* ud, const void* central,
                                 const void* a1, const void* a2, float slope,
                                 int d, int n_rows_layout, int n_out,
                                 int node_block, int tile_e, void* out,
                                 void* ex, void* den, void* stream) {
  return static_cast<int>(launch<false>(src, ranges, u1, u2, ud, central,
                                        a1, a2, slope, d, n_rows_layout, n_out,
                                        node_block, tile_e, out, ex, den,
                                        stream));
}

extern "C" int attention_fwd(const void* src, const void* ranges,
                             const void* u1, const void* u2, const void* ud,
                             const void* central, const void* a1,
                             const void* a2, float slope, int d,
                             int n_rows_layout, int n_out, int node_block,
                             int tile_e, void* out, void* alpha,
                             void* stream) {
  return static_cast<int>(launch<true>(src, ranges, u1, u2, ud, central, a1,
                                       a2, slope, d, n_rows_layout, n_out,
                                       node_block, tile_e, out, alpha, nullptr,
                                       stream));
}
