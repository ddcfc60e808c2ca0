// Native .jf record sorting + packing.
//
// The .jf "binary/sorted" format stores records sorted by
// (pos = hash(key) & mask, key MSB-first) — reference jellyfish
// binary_dumper.hpp:19-41 (records) and sorted_dumper.hpp:57-103 (ordering).
// The r3 numpy path (io/jf.py write_jf) spent ~64 s on a 55.7 M-record dump
// (three stable argsorts + strided byte packing); running on the background
// .jf-writer thread it starved the concurrent polish scan on a 2-vCPU host
// (r4 instrumented race: pass 0 took 112 s vs 8 s for pass 1).
//
// Design: LSD radix with 16-bit digits over COMPACT STRUCTS (record payload
// + little-endian sort suffix), not index permutations — every pass streams
// structs into 65536 sequential bucket runs instead of doing a random
// gather per element (index radix measured latency-bound: 27-48 s for the
// same 55.7 M records).
//
// Also exposes jt_mix32_batch: the murmur3-32 key hash (identical to
// jasper_tpu.ops.hashing.mix32) so .jf loads skip the ~25 s numpy murmur.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Digit width: 16-bit halves the passes but scatters into 65536 write
// streams; 8-bit doubles passes with only 256 streams. Which wins depends
// on the host's TLB/cache; JT_RADIX8=1 forces 8-bit for benchmarking.
inline bool use_16bit_digits() {
  static const bool v = getenv("JT_RADIX8") == nullptr;
  return v;
}

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t mix32(const uint32_t* w, int W) {
  uint32_t h = 0x6A737072u;
  for (int j = 0; j < W; ++j) {
    uint32_t k = w[j] * 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= (uint32_t)(4 * W);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// One stable counting pass: digit = `width` (1|2) little-endian bytes at
// struct offset `off`. src -> dst (distinct buffers).
void struct_radix_pass(const uint8_t* src, uint8_t* dst, int64_t n,
                       int stride, int off, int width) {
  int n_buckets = width == 2 ? 65536 : 256;
  std::vector<int64_t> hist(n_buckets, 0);
  const uint8_t* p = src + off;
  if (width == 2) {
    for (int64_t i = 0; i < n; ++i, p += stride) {
      uint16_t d;
      memcpy(&d, p, 2);
      ++hist[d];
    }
  } else {
    for (int64_t i = 0; i < n; ++i, p += stride) ++hist[*p];
  }
  int64_t sum = 0;
  for (int d = 0; d < n_buckets; ++d) {
    int64_t c = hist[d];
    hist[d] = sum;
    sum += c;
  }
  p = src;
  if (width == 2) {
    for (int64_t i = 0; i < n; ++i, p += stride) {
      uint16_t d;
      memcpy(&d, p + off, 2);
      memcpy(dst + hist[d]++ * stride, p, stride);
    }
  } else {
    for (int64_t i = 0; i < n; ++i, p += stride) {
      memcpy(dst + hist[p[off]]++ * stride, p, stride);
    }
  }
}

// LSD radix over a little-endian sort field [sort_off, sort_off+sort_bytes):
// 16-bit digit passes from the bottom, one 8-bit pass if sort_bytes is odd.
// Returns the buffer holding the sorted structs (a or b).
uint8_t* struct_radix(uint8_t* a, uint8_t* b, int64_t n, int stride,
                      int sort_off, int sort_bytes) {
  int byte = 0;
  while (byte < sort_bytes) {
    int width = (use_16bit_digits() && sort_bytes - byte >= 2) ? 2 : 1;
    struct_radix_pass(a, b, n, stride, sort_off + byte, width);
    byte += width;
    uint8_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" {

// murmur3-32 of each key row (same function as ops.hashing.mix32 and
// jt_table.cc's probe hash).
void jt_mix32_batch(const uint32_t* keys, int64_t n, int W, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = mix32(keys + i * W, W);
}

// Stable record order by (pos, key MSB-first); out_order: uint32 [n].
//
// The sort field is the little-endian concatenation [key kb bytes | pos
// pos_bytes] — ascending order of that composite IS (pos, key) order, since
// pos occupies the most significant bytes. Struct: [idx u32][sort field].
void jt_jf_sort_order(const uint32_t* keys, const uint64_t* pos, int64_t n,
                      int W, int kb, int pos_bytes, uint32_t* out_order) {
  if (n <= 0 || W <= 0 || kb <= 0 || kb > 4 * W || pos_bytes < 0 ||
      pos_bytes > 8)
    return;
  int stride = 4 + kb + pos_bytes;
  std::vector<uint8_t> bufa((size_t)n * stride), bufb((size_t)n * stride);
  const uint8_t* kbytes = (const uint8_t*)keys;
  int64_t kstride = 4 * (int64_t)W;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* s = bufa.data() + i * stride;
    uint32_t idx = (uint32_t)i;
    memcpy(s, &idx, 4);
    memcpy(s + 4, kbytes + i * kstride, kb);
    memcpy(s + 4 + kb, &pos[i], pos_bytes);
  }
  uint8_t* res = struct_radix(bufa.data(), bufb.data(), n, stride, 4,
                              kb + pos_bytes);
  for (int64_t i = 0; i < n; ++i)
    memcpy(&out_order[i], res + i * stride, 4);
}

// Sort records by (pos, key) and pack them as the .jf record section:
// kb little-endian key bytes + counter_len little-endian count bytes
// (saturating), per record. out: uint8 [n * (kb + counter_len)].
//
// identity_lsize >= 0 selects the identity-matrix fast path (the layout
// write_jf always emits, like real jellyfish's small-key arrays,
// large_hash_array.hpp:998-1001): pos = low lsize key bits, so (pos, key)
// order equals ascending order of the composite
//   (pos << (2k - lsize)) | (key >> lsize)
// computed here from the key alone (requires 2k <= 64); `pos` may be NULL.
// Otherwise (identity_lsize < 0) `pos` supplies the hash positions and the
// sort field is [key kb | pos pos_bytes].
//
// Struct layout during the sort: [record rec bytes][sort field]; the final
// pack is one sequential stride-to-record copy.
void jt_jf_sort_pack(const uint32_t* keys, const uint64_t* counts,
                     const uint64_t* pos, int64_t n, int W, int kb,
                     int counter_len, int pos_bytes, int k,
                     int identity_lsize, uint8_t* out) {
  if (n <= 0 || W <= 0 || kb <= 0 || kb > 4 * W || counter_len <= 0 ||
      counter_len > 8 || pos_bytes < 0 || pos_bytes > 8)
    return;
  int rec = kb + counter_len;
  const bool identity = identity_lsize >= 0;
  if (identity && (2 * k > 64 || identity_lsize > 2 * k)) return;
  if (!identity && pos == nullptr) return;
  int sort_bytes = identity ? (2 * k + 7) / 8 : kb + pos_bytes;
  int stride = rec + sort_bytes;
  std::vector<uint8_t> bufa((size_t)n * stride), bufb((size_t)n * stride);
  const uint8_t* kbytes = (const uint8_t*)keys;
  int64_t kstride = 4 * (int64_t)W;
  uint64_t max_val =
      counter_len >= 8 ? ~0ull : ((1ull << (8 * counter_len)) - 1);
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* s = bufa.data() + i * stride;
    memcpy(s, kbytes + i * kstride, kb);
    uint64_t c = counts[i];
    if (c > max_val) c = max_val;
    memcpy(s + kb, &c, counter_len);
    if (identity) {
      uint64_t key = 0;
      memcpy(&key, kbytes + i * kstride, kb < 8 ? kb : 8);
      uint64_t p = key & ((identity_lsize >= 64)
                              ? ~0ull
                              : ((1ull << identity_lsize) - 1));
      uint64_t comp = (p << (2 * k - identity_lsize)) | (key >> identity_lsize);
      memcpy(s + rec, &comp, sort_bytes);
    } else {
      memcpy(s + rec, kbytes + i * kstride, kb);
      memcpy(s + rec + kb, &pos[i], pos_bytes);
    }
  }
  uint8_t* res = struct_radix(bufa.data(), bufb.data(), n, stride, rec,
                              sort_bytes);
  for (int64_t i = 0; i < n; ++i)
    memcpy(out + i * rec, res + i * stride, rec);
}

// K-way merge of sorted level runs (the chromosome-scale counting finish).
//
// Each input stream s holds n[s] records (h uint32, key uint32[W],
// count uint32), sorted ascending by (h, key MSB-first) with distinct keys
// WITHIN a stream (the LSM level invariant). Equal keys across streams sum
// (saturating at 2^32-1, the binary dump clamp). Outputs are the merged
// distinct records in (h, key) order. Returns the output record count.
//
// Rationale: merging all levels on DEVICE doubles peak memory (concat+sort
// of the full record set); per-level pulls + this host merge bound device
// memory at the
// largest single level. Reference analog: jellyfish's k-way heap merge of
// sorted .jf files, jf:jellyfish/merge_files.cc:45-101.
extern "C" int64_t jt_merge_runs_multi(
    const uint32_t* const* hs, const uint32_t* const* keys,
    const uint32_t* const* counts, const int64_t* n, int n_streams, int W,
    uint32_t* out_h, uint32_t* out_keys, uint32_t* out_counts) {
  if (n_streams <= 0 || W <= 0) return 0;
  // (h, key) comparison: h first, then key words MSB-first
  auto less = [&](int a, int64_t ia, int b, int64_t ib) {
    uint32_t ha = hs[a][ia], hb = hs[b][ib];
    if (ha != hb) return ha < hb;
    const uint32_t* ka = keys[a] + ia * W;
    const uint32_t* kb = keys[b] + ib * W;
    for (int j = W - 1; j >= 0; --j)
      if (ka[j] != kb[j]) return ka[j] < kb[j];
    return false;
  };
  // simple heap over stream heads (n_streams is small: levels
  // x devices, typically < 64)
  std::vector<int64_t> idx(n_streams, 0);
  std::vector<int> heap;
  heap.reserve(n_streams);
  auto heap_less = [&](int a, int b) { return less(a, idx[a], b, idx[b]); };
  auto sift_down = [&](size_t i) {
    for (;;) {
      size_t l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < heap.size() && heap_less(heap[l], heap[m])) m = l;
      if (r < heap.size() && heap_less(heap[r], heap[m])) m = r;
      if (m == i) break;
      std::swap(heap[i], heap[m]);
      i = m;
    }
  };
  for (int s = 0; s < n_streams; ++s)
    if (n[s] > 0) heap.push_back(s);
  for (int64_t i = (int64_t)heap.size() / 2 - 1; i >= 0; --i) sift_down(i);

  int64_t out = -1;
  while (!heap.empty()) {
    int s = heap[0];
    int64_t i = idx[s];
    bool same = out >= 0 && out_h[out] == hs[s][i];
    if (same) {
      const uint32_t* kk = keys[s] + i * W;
      for (int j = 0; j < W; ++j)
        if (out_keys[out * W + j] != kk[j]) {
          same = false;
          break;
        }
    }
    if (same) {
      uint64_t c = (uint64_t)out_counts[out] + counts[s][i];
      out_counts[out] = c > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)c;
    } else {
      ++out;
      out_h[out] = hs[s][i];
      memcpy(out_keys + out * W, keys[s] + i * W, 4 * (size_t)W);
      out_counts[out] = counts[s][i];
    }
    if (++idx[s] >= n[s]) {
      heap[0] = heap.back();
      heap.pop_back();
    }
    sift_down(0);
  }
  return out + 1;
}

// Sort .jf records into (mix32, key) order in one pass: computes h, radix-
// sorts compact [key kb | count u32 | h u32] structs by the little-endian
// [key kb | h] composite (h most significant == (h, key) order), and emits
// the sorted columns. Replaces the load path's separate order + three
// fancy-index gathers (10.8 s + 9 s at 55.7 M records) — the startup cost
// of QueryMerFile / .jf-reuse runs (reference mmaps instead,
// jf:include/jellyfish/mapped_file.hpp).
extern "C" void jt_sort_run_records(const uint32_t* keys,
                                    const uint64_t* counts, int64_t n, int W,
                                    int kb, uint32_t* out_keys,
                                    uint32_t* out_counts, uint32_t* out_h) {
  if (n <= 0 || W <= 0 || kb <= 0 || kb > 4 * W) return;
  int rec = kb + 4 + 4;            // key bytes + count u32 + h u32
  int stride = rec + kb + 4;       // + sort field [key kb | h 4]
  std::vector<uint8_t> bufa((size_t)n * stride), bufb((size_t)n * stride);
  const uint8_t* kbytes = (const uint8_t*)keys;
  int64_t kstride = 4 * (int64_t)W;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* s = bufa.data() + i * stride;
    memcpy(s, kbytes + i * kstride, kb);
    uint64_t c = counts[i];
    uint32_t c32 = c > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)c;
    memcpy(s + kb, &c32, 4);
    uint32_t hh = mix32(keys + i * W, W);
    memcpy(s + kb + 4, &hh, 4);
    memcpy(s + rec, s, kb);          // sort field: key bytes...
    memcpy(s + rec + kb, &hh, 4);    // ...then h (most significant)
  }
  uint8_t* res = struct_radix(bufa.data(), bufb.data(), n, stride, rec,
                              kb + 4);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = res + i * stride;
    uint32_t* dk = out_keys + i * W;
    for (int j = 0; j < W; ++j) dk[j] = 0;
    memcpy(dk, s, kb);
    memcpy(&out_counts[i], s + kb, 4);
    memcpy(&out_h[i], s + kb + 4, 4);
  }
}

// Waterfall table build: place a (mix32, key)-ascending DISTINCT record
// stream into the bucketed table layout (table/kmer_table.py: rows of 64
// uint32, sw words per slot, home bucket = top log2(n_buckets) hash bits).
// slot_i = max(slot_{i-1} + 1, home_bucket * S) — one sequential pass, the
// C twin of HostKmerTable.from_sorted_run's cummax (numpy: 18.5 s at
// 55.7 M records; here memcpy speed). tab must be zeroed,
// (n_buckets + pad_buckets) * 64 uint32. Returns 0 on success, 1 when a
// record would overflow the pad region (caller doubles n_slots, retries).
// Incremental form: io_last_slot carries the highest slot used so far
// (initialize to -1); slices pushed in run order build bit-identically to
// the one-shot call (the streaming builder that overlaps the d2h pull).
extern "C" int jt_waterfall_extend(const uint32_t* keys, const uint32_t* counts,
                                   const uint32_t* h, int64_t n, int W, int sw,
                                   int64_t n_buckets, int pad_buckets,
                                   uint32_t* tab, int64_t* io_last_slot) {
  if (n < 0 || W <= 0 || sw <= 0 || sw > 64 || W >= sw ||
      n_buckets <= 0 || pad_buckets < 0 || io_last_slot == nullptr)
    return 1;
  int S = 64 / sw;  // slots per bucket; rows may have spare tail words
  int64_t total_slots = (n_buckets + pad_buckets) * (int64_t)S;
  int64_t slot = *io_last_slot;
  for (int64_t i = 0; i < n; ++i) {
    // home = mulhi(h, n_buckets): hash range-mapped onto [0, n_buckets)
    // (ops.hashing.home_of) — monotone in h, n_buckets need not be pow2
    int64_t home =
        n_buckets <= 1 ? 0 : (int64_t)(((uint64_t)h[i] * (uint64_t)n_buckets) >> 32);
    int64_t target = home * S;
    slot = slot + 1 > target ? slot + 1 : target;
    if (slot >= total_slots || slot / S - home > pad_buckets) return 1;
    // word-major rows: slot s's word j at bucket*64 + j*S + s
    uint32_t* dst = tab + (slot / S) * 64 + (slot % S);
    for (int j = 0; j < W; ++j) dst[j * S] = keys[i * W + j];
    dst[W * S] = counts[i];
  }
  *io_last_slot = slot;
  return 0;
}

extern "C" int jt_waterfall_build(const uint32_t* keys, const uint32_t* counts,
                                  const uint32_t* h, int64_t n, int W, int sw,
                                  int64_t n_buckets, int pad_buckets,
                                  uint32_t* tab) {
  int64_t last = -1;
  return jt_waterfall_extend(keys, counts, h, n, W, sw, n_buckets,
                             pad_buckets, tab, &last);
}

}  // extern "C"
