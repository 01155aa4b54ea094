// graphcore: native graph-construction routines for bridged_gnn_tpu_torch.
//
// The port's own copy of the JAX package's native/graphcore.cpp: the
// build-time graph operations (edge coalesce, destination sort, CSR row
// pointers, degrees, chunk metadata, edge partitioning) run on the host
// once per graph, and so does the port's own sender index of a slot
// layout. Coalesce and sort pack each edge into one 64-bit key
// and radix-sort the keys, where the JAX package's copy sorts an index
// array with an indirect comparison. bridged_gnn_tpu_torch/io/native.py
// compiles this file with g++ into bridged_gnn_tpu_torch/_build/ at first
// use and binds its C entry points with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pack each edge into one unsigned key, dst in the high bits and src in
// the low ones, so that the keys' order is the edges' (dst, src) order.
// Returns the src field's width in bits, or -1 when an id is negative or
// the two fields do not fit in 64 bits.
static int pack_keys(const int64_t* src, const int64_t* dst, int64_t e,
                     std::vector<uint64_t>& keys, uint64_t& max_key) {
  int64_t max_src = 0, max_dst = 0, min_id = 0;
  for (int64_t i = 0; i < e; ++i) {
    max_src = std::max(max_src, src[i]);
    max_dst = std::max(max_dst, dst[i]);
    min_id = std::min(min_id, std::min(src[i], dst[i]));
  }
  if (min_id < 0) return -1;
  const int src_bits = 64 - __builtin_clzll(static_cast<uint64_t>(max_src) | 1);
  const int dst_bits = 64 - __builtin_clzll(static_cast<uint64_t>(max_dst) | 1);
  if (src_bits + dst_bits > 64) return -1;
  keys.resize(e);
  for (int64_t i = 0; i < e; ++i)
    keys[i] = (static_cast<uint64_t>(dst[i]) << src_bits) |
              static_cast<uint64_t>(src[i]);
  max_key = (static_cast<uint64_t>(max_dst) << src_bits) |
            static_cast<uint64_t>(max_src);
  return src_bits;
}

// LSD radix sort of the keys, 11 bits a pass, as many passes as the
// largest key has digits.
static void radix_sort(std::vector<uint64_t>& keys, uint64_t max_key) {
  constexpr int kBits = 11;
  constexpr size_t kBuckets = size_t{1} << kBits;
  const int bits = 64 - __builtin_clzll(max_key | 1);
  std::vector<uint64_t> tmp(keys.size());
  std::vector<size_t> count(kBuckets);
  for (int shift = 0; shift < bits; shift += kBits) {
    std::fill(count.begin(), count.end(), 0);
    for (uint64_t k : keys) ++count[(k >> shift) & (kBuckets - 1)];
    size_t sum = 0;
    for (size_t& c : count) {
      const size_t n = c;
      c = sum;
      sum += n;
    }
    for (uint64_t k : keys) tmp[count[(k >> shift) & (kBuckets - 1)]++] = k;
    keys.swap(tmp);
  }
}

// Sort edges by (dst, src) and drop duplicates.
// in:  src[e], dst[e]  (int64, non-negative)
// out: out_src, out_dst (caller-allocated, capacity e)
// returns: number of unique edges, or -1 when the ids do not pack
int64_t gc_coalesce(const int64_t* src, const int64_t* dst, int64_t e,
                    int64_t* out_src, int64_t* out_dst) {
  std::vector<uint64_t> keys;
  uint64_t max_key = 0;
  const int src_bits = pack_keys(src, dst, e, keys, max_key);
  if (src_bits < 0) return -1;
  radix_sort(keys, max_key);
  const uint64_t src_mask = (uint64_t{1} << src_bits) - 1;
  int64_t n = 0;
  for (int64_t i = 0; i < e; ++i) {
    if (i > 0 && keys[i] == keys[i - 1]) continue;
    out_src[n] = static_cast<int64_t>(keys[i] & src_mask);
    out_dst[n] = static_cast<int64_t>(keys[i] >> src_bits);
    ++n;
  }
  return n;
}

// Sort edges by (dst, src) keeping duplicates (equal edges are equal, so
// the sort is as stable as it needs to be). Returns 0, or -1 when the ids
// do not pack.
int64_t gc_sort_by_dst(const int64_t* src, const int64_t* dst, int64_t e,
                       int64_t* out_src, int64_t* out_dst) {
  std::vector<uint64_t> keys;
  uint64_t max_key = 0;
  const int src_bits = pack_keys(src, dst, e, keys, max_key);
  if (src_bits < 0) return -1;
  radix_sort(keys, max_key);
  const uint64_t src_mask = (uint64_t{1} << src_bits) - 1;
  for (int64_t i = 0; i < e; ++i) {
    out_src[i] = static_cast<int64_t>(keys[i] & src_mask);
    out_dst[i] = static_cast<int64_t>(keys[i] >> src_bits);
  }
  return 0;
}

// CSR row pointers from dst-sorted edges: row_ptr has n+1 entries.
void gc_csr_rowptr(const int64_t* dst_sorted, int64_t e, int64_t n,
                   int64_t* row_ptr) {
  std::memset(row_ptr, 0, sizeof(int64_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) row_ptr[dst_sorted[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) row_ptr[v + 1] += row_ptr[v];
}

// In/out degrees.
void gc_degrees(const int64_t* src, const int64_t* dst, int64_t e, int64_t n,
                int64_t* in_deg, int64_t* out_deg) {
  std::memset(in_deg, 0, sizeof(int64_t) * n);
  std::memset(out_deg, 0, sizeof(int64_t) * n);
  for (int64_t i = 0; i < e; ++i) {
    out_deg[src[i]]++;
    in_deg[dst[i]]++;
  }
}

// Pallas segment-kernel chunk metadata over dst-sorted (padded) edges:
// for each node block, the [first, last] edge-chunk covering its edges.
// Returns max_chunks.
int64_t gc_chunk_meta(const int64_t* dst_sorted, int64_t e_pad,
                      int64_t n_pad, int64_t node_block, int64_t edge_chunk,
                      int32_t* chunk_base, int32_t* num_chunks) {
  int64_t n_blocks = (n_pad + node_block - 1) / node_block;
  int64_t max_chunks = 1;
  const int64_t* begin = dst_sorted;
  const int64_t* end = dst_sorted + e_pad;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t lo = b * node_block;
    const int64_t hi = lo + node_block;
    const int64_t s = std::lower_bound(begin, end, lo) - begin;
    const int64_t t = std::lower_bound(begin, end, hi) - begin;
    chunk_base[b] = static_cast<int32_t>(s / edge_chunk);
    int32_t nc = 0;
    if (t > s) nc = static_cast<int32_t>((t - 1) / edge_chunk + 1 - chunk_base[b]);
    num_chunks[b] = nc;
    if (nc > max_chunks) max_chunks = nc;
  }
  return max_chunks;
}

// Sender-keyed CSR over a slot layout's real slots
// (ops/blocked_segment.py::_sender_csr_np): a stable counting sort of the
// slots by sender, in one count pass, one scan and one scatter.
// in:  slot_src[n_slots] (int32: each slot's sender, negative on masked
//      and pad slots)
// out: src_ranges[num_senders * 2] (each sender's [begin, end) of CSR
//      entries), src_slots (capacity: the real slot count; the real slots,
//      ascending within each sender)
// returns: the real slot count, or -1, having written nothing, when a
// sender id is at or above num_senders
int64_t gc_sender_csr(const int32_t* slot_src, int64_t n_slots,
                      int64_t num_senders, int32_t* src_ranges,
                      int32_t* src_slots) {
  if (num_senders < 0) return -1;
  // slot layouts index their slots in int32, so every count fits in one
  std::vector<int32_t> next(num_senders);
  for (int64_t k = 0; k < n_slots; ++k) {
    const int32_t s = slot_src[k];
    if (s < 0) continue;
    if (s >= num_senders) return -1;
    ++next[s];
  }
  int32_t sum = 0;
  for (int64_t v = 0; v < num_senders; ++v) {
    src_ranges[2 * v] = sum;
    const int32_t n = next[v];
    next[v] = sum;
    sum += n;
    src_ranges[2 * v + 1] = sum;
  }
  for (int64_t k = 0; k < n_slots; ++k) {
    const int32_t s = slot_src[k];
    if (s >= 0) src_slots[next[s]++] = static_cast<int32_t>(k);
  }
  return sum;
}

// Greedy contiguous edge partition into p shards of near-equal edge count
// respecting chunk alignment. out: shard_start[p+1] (edge offsets).
void gc_edge_partition(int64_t e, int64_t p, int64_t align,
                       int64_t* shard_start) {
  for (int64_t i = 0; i <= p; ++i) {
    int64_t pos = (e * i) / p;
    shard_start[i] = (pos / align) * align;
  }
  shard_start[p] = e;
}

}  // extern "C"
