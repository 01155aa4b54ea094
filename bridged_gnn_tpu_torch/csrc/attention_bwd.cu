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
// and a_sel = c ? a1 : a2. Given dout[v] this kernel forms
//   dα_k = m_sel[s_k] · dout[v],   S_v = Σ_k α_k · dα_k,
//   dl_k = α_k·dα_k − α_k·S_v                      (softmax Jacobian)
//   dz_k = dl_k · a_sel · (z_k > 0 ? 1 : slope)    (leaky-relu gate)
// and writes
//   dm_k   = α_k · dout[v] + dz_k   per slot (the sender row's cotangent),
//   dud[v] = Σ_k dz_k               (the destination's own row),
//   [da1 ‖ da2] += Σ_k dl_k · leaky_relu(z_k) into the destination's half,
//            as one partial per thread block; the wrapper sums the partials.
// The selective kernel reads the forward's ex and den (α = ex / den; the
// forward shifted by each destination's own max) and writes dm D wide plus
// the slot's branch flag (slot_c), which the sender-side reduce
// (slot_reduce.cu) uses to route each row into du1 or du2. The concatenated
// kernel reads α and writes dm 2D wide, the unselected half zero, as the TPU
// kernel did. Pad slots and masked slots get dm = 0 and slot_c = 0.
//
// Design for the card. One warp owns one destination row and walks its
// contiguous slot run twice: pass 1 gathers each sender row by index and
// sums S_v; pass 2 gathers it again and forms dl, dz, dm, dud and the da
// terms. No [Et, D] message array and no one-hot matrix is read. Lanes
// stride over D (kPer values per lane, D <= 256). The da partials are summed
// across the block's warps in shared memory in a fixed order: no atomics, so
// every gradient is bit-identical from run to run.
//
// Bound: bytes. Per real slot the kernel reads a D-wide sender row and
// writes a D-wide (2D concatenated) dm row, against ~11·D flops, far below
// the card's f32 rate per byte. Writing dm costs S·D·4 bytes (~1.17 GB at
// D=64 on the 131k-node bench layout); fusing it into the sender-side
// reduce is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC (see bridged_gnn_tpu_torch/ops/fused_kernels.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxD = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kConcat, int kPer>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
attention_bwd_kernel(const int32_t* __restrict__ src,     // [S] sender or -1
                     const int32_t* __restrict__ ranges,  // [R_lay, 2]
                     const float* __restrict__ u1,        // [N_in, D]
                     const float* __restrict__ u2,        // [N_in, D]
                     const float* __restrict__ ud,        // [n_out, D]
                     const bool* __restrict__ central,    // [n_out]
                     const float* __restrict__ a1,        // [D]
                     const float* __restrict__ a2,        // [D]
                     float slope, int d, int n_rows_layout, int n_out,
                     int node_block, int tile_e,
                     const float* __restrict__ slot_w,  // [S] ex or alpha
                     const float* __restrict__ den,     // [n_out] (selective)
                     const float* __restrict__ dout,    // [n_out, D]
                     float* __restrict__ dm,            // [S, D] or [S, 2D]
                     float* __restrict__ dud,           // [n_out, D]
                     float* __restrict__ da_part,       // [grid, 2D]
                     uint8_t* __restrict__ slot_c)      // [S] (selective)
{
  __shared__ float sda[kWarpsPerBlock][2 * kMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  const int wd = kConcat ? 2 * d : d;  // dm row width

  float da_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) da_acc[i] = 0.f;
  bool is_c = false;

  if (row < n_rows_layout) {
    const int lo = ranges[2 * row];
    const int hi = ranges[2 * row + 1];
    // The last row of a block ends where its block's real slots end; its
    // warp zeroes the pad slots behind them.
    if (row % node_block == node_block - 1) {
      const long long tail_end = (long long)(row / node_block + 1) * tile_e;
      for (long long e = (long long)hi * wd + lane; e < tail_end * wd;
           e += 32) {
        dm[e] = 0.f;
      }
      if (!kConcat) {
        for (long long k = hi + lane; k < tail_end; k += 32) slot_c[k] = 0;
      }
    }
    if (row < n_out) {
      is_c = central[row];
      const float* __restrict__ tab = is_c ? u1 : u2;
      const float* __restrict__ a = is_c ? a1 : a2;
      const float den_v = kConcat ? 1.f : den[row];
      // column offset of the selected half in a concatenated dm row, and
      // of the half that stays zero
      const int sel_off = (kConcat && !is_c) ? d : 0;
      const int zero_off = kConcat ? (is_c ? d : 0) : 0;

      float dst[kPer], go[kPer], av[kPer], dud_acc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        const bool ok = c < d;
        dst[i] = ok ? ud[(long long)row * d + c] : 0.f;
        go[i] = ok ? dout[(long long)row * d + c] : 0.f;
        av[i] = ok ? a[c] : 0.f;
        dud_acc[i] = 0.f;
      }

      // pass 1: S_v = Σ_k α_k · (m_k · dout_v)
      float ssum = 0.f;
      for (int k0 = lo; k0 < hi; k0 += 32) {
        const int kk = k0 + lane;
        const int my_s = kk < hi ? src[kk] : -1;
        const float my_w = kk < hi ? slot_w[kk] : 0.f;
        const int cnt = min(32, hi - k0);
        for (int j = 0; j < cnt; ++j) {
          const int sj = __shfl_sync(kFull, my_s, j);
          const float wj = __shfl_sync(kFull, my_w, j);
          if (sj < 0) continue;  // masked edge (uniform across the warp)
          const float alpha = kConcat ? wj : wj / den_v;
          const long long s = sj;
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int c = lane + 32 * i;
            const float m = c < d ? tab[s * d + c] : 0.f;
            part += m * go[i];
          }
          ssum += alpha * warp_sum(part);
        }
      }

      // pass 2: re-gather each row; dl, dz, dm, dud and the da terms
      for (int k0 = lo; k0 < hi; k0 += 32) {
        const int kk = k0 + lane;
        const int my_s = kk < hi ? src[kk] : -1;
        const float my_w = kk < hi ? slot_w[kk] : 0.f;
        const int cnt = min(32, hi - k0);
        for (int j = 0; j < cnt; ++j) {
          const int sj = __shfl_sync(kFull, my_s, j);
          const float wj = __shfl_sync(kFull, my_w, j);
          const long long k = k0 + j;
          float* __restrict__ dm_row = dm + k * wd;
          if (sj < 0) {
            for (int c = lane; c < wd; c += 32) dm_row[c] = 0.f;
            if (!kConcat && lane == 0) slot_c[k] = 0;
            continue;
          }
          const float alpha = kConcat ? wj : wj / den_v;
          const long long s = sj;
          float m[kPer];
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int c = lane + 32 * i;
            m[i] = c < d ? tab[s * d + c] : 0.f;
            part += m[i] * go[i];
          }
          const float dalpha = warp_sum(part);
          const float dl = alpha * dalpha - alpha * ssum;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int c = lane + 32 * i;
            if (c < d) {
              const float z = m[i] + dst[i];
              const float h = z >= 0.f ? z : slope * z;
              const float g = z > 0.f ? 1.f : slope;
              const float dz = dl * av[i] * g;
              dm_row[sel_off + c] = alpha * go[i] + dz;
              if (kConcat) dm_row[zero_off + c] = 0.f;
              dud_acc[i] += dz;
              da_acc[i] += dl * h;
            }
          }
          if (!kConcat && lane == 0) slot_c[k] = is_c ? 1 : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        if (c < d) dud[(long long)row * d + c] = dud_acc[i];
      }
    }
  }

  // [da1 ‖ da2] partial of this block: each warp fills its destination's
  // half, then the block sums its warps in a fixed order.
  const int own = is_c ? 0 : d;
  const int other = is_c ? d : 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      sda[warp][own + c] = da_acc[i];
      sda[warp][other + c] = 0.f;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * d; t += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) sum += sda[w][t];
    da_part[(long long)blockIdx.x * 2 * d + t] = sum;
  }
}

template <bool kConcat>
cudaError_t launch(const void* src, const void* ranges, const void* u1,
                   const void* u2, const void* ud, const void* central,
                   const void* a1, const void* a2, float slope, int d,
                   int n_rows_layout, int n_out, int node_block, int tile_e,
                   const void* slot_w, const void* den, const void* dout,
                   void* dm, void* dud, void* da_part, int n_parts,
                   void* slot_c, void* stream) {
  const int grid_x = (n_rows_layout + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (d < 1 || d > kMaxD || n_rows_layout < 1 || n_out > n_rows_layout ||
      node_block < 1 || tile_e < 1 || n_parts != grid_x) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(grid_x);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BGNN_LAUNCH(PER)                                                    \
  attention_bwd_kernel<kConcat, PER><<<grid, block, 0, st>>>(               \
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(ranges), \
      static_cast<const float*>(u1), static_cast<const float*>(u2),          \
      static_cast<const float*>(ud), static_cast<const bool*>(central),      \
      static_cast<const float*>(a1), static_cast<const float*>(a2), slope, d, \
      n_rows_layout, n_out, node_block, tile_e,                              \
      static_cast<const float*>(slot_w), static_cast<const float*>(den),     \
      static_cast<const float*>(dout), static_cast<float*>(dm),              \
      static_cast<float*>(dud), static_cast<float*>(da_part),                \
      static_cast<uint8_t*>(slot_c))
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

extern "C" int attention_bwd_rows_per_block() { return kWarpsPerBlock; }

extern "C" int attention_sel_bwd(const void* src, const void* ranges,
                                 const void* u1, const void* u2,
                                 const void* ud, const void* central,
                                 const void* a1, const void* a2, float slope,
                                 int d, int n_rows_layout, int n_out,
                                 int node_block, int tile_e, const void* ex,
                                 const void* den, const void* dout, void* dm,
                                 void* dud, void* da_part, int n_parts,
                                 void* slot_c, void* stream) {
  return static_cast<int>(launch<false>(
      src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,
      n_out, node_block, tile_e, ex, den, dout, dm, dud, da_part, n_parts,
      slot_c, stream));
}

extern "C" int attention_bwd(const void* src, const void* ranges,
                             const void* u1, const void* u2, const void* ud,
                             const void* central, const void* a1,
                             const void* a2, float slope, int d,
                             int n_rows_layout, int n_out, int node_block,
                             int tile_e, const void* alpha, const void* dout,
                             void* dm, void* dud, void* da_part, int n_parts,
                             void* stream) {
  return static_cast<int>(launch<true>(
      src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,
      n_out, node_block, tile_e, alpha, nullptr, dout, dm, dud, da_part,
      n_parts, nullptr, stream));
}
