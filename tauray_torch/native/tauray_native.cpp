// Native host library of tauray_torch, the PyTorch/CUDA port; the port's
// own copy of tauray_tpu/native/tauray_native.cpp, whose functions,
// arithmetic and outputs it keeps. One change: tr_huf_decode finds a long
// code's candidates by a binary search of the prefix-sorted list, where
// tauray_tpu's scans every long code for each long symbol (a read of a
// noisy 1080p frame took longer than the Python decoder's dict lookup).
//
// The reference implements its host runtime (asset IO, acceleration
// structure builds) in C++ (reference: src/*.cc, external tinyexr); the
// port keeps the same split: torch and the CUDA kernels of csrc/ own the
// device path, this file owns host-side hot loops. It is host C++, not a
// device kernel, built with g++ on first use and loaded with ctypes
// (tauray_torch/native/__init__.py).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -ffp-contract=off
//            tauray_native.cpp -o libtauray_native.so
// (-ffp-contract=off keeps the Morton grid's (c - lo) / ext * 1023 equal
// to numpy's float32 arithmetic on any host CPU.)
//
// Functions:
//   tr_huf_decode   — ImfHuf-compatible Huffman decode (EXR PIZ codec;
//                     mirrors tauray_torch/io/exr.py _huf_decode, the slow
//                     loop of every PIZ read: envmaps, goldens)
//   tr_morton_order — Morton-code ordering of triangle centroids (the
//                     Morton cluster order of tauray_tpu's ops/cluster.py,
//                     which neither package takes at its defaults)

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr int kDecBits = 14;
constexpr int kDecSize = 1 << kDecBits;
constexpr uint64_t kDecMask = kDecSize - 1;

struct LongCode {
  uint32_t prefix;  // 14-bit prefix
  uint32_t sym;
  uint32_t len;
};

}  // namespace

extern "C" {

// Returns 0 on success, <0 on malformed stream. `hcode[sym]` is the
// packed (code << 6 | length) canonical table (already unpacked by the
// Python side), `rlc` the run-length symbol, `out`/`n_out` the
// destination uint16 buffer.
int64_t tr_huf_decode(const uint8_t* data, int64_t nbits,
                      const int64_t* hcode, int64_t im, int64_t iM,
                      int64_t rlc, uint16_t* out, int64_t n_out) {
  std::vector<int32_t> short_len(kDecSize, 0);
  std::vector<int64_t> short_lit(kDecSize, 0);
  std::vector<LongCode> longs;
  for (int64_t sym = im; sym <= iM; ++sym) {
    const int64_t packed = hcode[sym];
    const int l = static_cast<int>(packed & 63);
    if (l == 0) continue;
    const uint64_t code = static_cast<uint64_t>(packed) >> 6;
    if (l <= kDecBits) {
      const int64_t idx = static_cast<int64_t>(code) << (kDecBits - l);
      const int64_t cnt = int64_t{1} << (kDecBits - l);
      for (int64_t k = 0; k < cnt; ++k) {
        short_len[idx + k] = l;
        short_lit[idx + k] = sym;
      }
    } else {
      longs.push_back({static_cast<uint32_t>(code >> (l - kDecBits)),
                       static_cast<uint32_t>(sym),
                       static_cast<uint32_t>(l)});
    }
  }
  // shorter codes first among longs sharing a prefix (matches exr.py)
  std::stable_sort(longs.begin(), longs.end(),
                   [](const LongCode& a, const LongCode& b) {
                     return a.prefix != b.prefix ? a.prefix < b.prefix
                                                 : a.len < b.len;
                   });

  const int64_t nbytes = (nbits + 7) / 8;
  uint64_t c = 0;
  int lc = 0;
  int64_t pos = 0;
  int64_t oi = 0;

  auto emit = [&](int64_t lit) -> bool {
    if (lit == rlc) {
      while (lc < 8) {
        if (pos >= nbytes) return false;
        c = (c << 8) | data[pos++];
        lc += 8;
      }
      lc -= 8;
      const int64_t cs = (c >> lc) & 0xFF;
      if (oi == 0 || oi + cs > n_out) return false;
      const uint16_t prev = out[oi - 1];
      for (int64_t k = 0; k < cs; ++k) out[oi + k] = prev;
      oi += cs;
    } else {
      if (oi >= n_out) return false;
      out[oi++] = static_cast<uint16_t>(lit);
    }
    return true;
  };

  while (pos < nbytes) {
    c = (c << 8) | data[pos++];
    lc += 8;
    while (lc >= kDecBits) {
      const uint64_t idx = (c >> (lc - kDecBits)) & kDecMask;
      const int l = short_len[idx];
      int64_t lit;
      if (l) {
        lit = short_lit[idx];
        lc -= l;
      } else {
        lit = -1;
        // longs is sorted by prefix: visit only this prefix's codes, in
        // the order a scan of the whole list would meet them
        auto it = std::lower_bound(
            longs.begin(), longs.end(), idx,
            [](const LongCode& a, uint64_t p) { return a.prefix < p; });
        for (; it != longs.end() && it->prefix == idx; ++it) {
          const LongCode& lcd = *it;
          const int sl = static_cast<int>(lcd.len);
          while (lc < sl && pos < nbytes) {
            c = (c << 8) | data[pos++];
            lc += 8;
          }
          const int64_t packed = hcode[lcd.sym];
          if (lc >= sl &&
              ((c >> (lc - sl)) & ((uint64_t{1} << sl) - 1)) ==
                  (static_cast<uint64_t>(packed) >> 6)) {
            lit = lcd.sym;
            lc -= sl;
            break;
          }
        }
        if (lit < 0) return -1;
      }
      if (!emit(lit)) return -2;
    }
  }

  const int pad = static_cast<int>((8 - nbits) & 7);
  c >>= pad;
  lc -= pad;
  while (lc > 0) {
    const uint64_t idx =
        lc < kDecBits ? (c << (kDecBits - lc)) & kDecMask
                      : (c >> (lc - kDecBits)) & kDecMask;
    const int l = short_len[idx];
    if (l && l <= lc) {
      const int64_t lit = short_lit[idx];
      lc -= l;
      if (lit == rlc) {
        if (lc < 8) return -3;
        lc -= 8;
        const int64_t cs = (c >> lc) & 0xFF;
        if (oi == 0 || oi + cs > n_out) return -2;
        const uint16_t prev = out[oi - 1];
        for (int64_t k = 0; k < cs; ++k) out[oi + k] = prev;
        oi += cs;
      } else {
        if (oi >= n_out) return -2;
        out[oi++] = static_cast<uint16_t>(lit);
      }
    } else {
      break;
    }
  }
  return oi == n_out ? 0 : -4;
}

// Morton ordering of triangle centroids (mirrors ops/cluster.py
// build_cluster_tracer: 10-bit grid per axis over the valid-centroid
// bounds, invalid triangles sorted last, ties by original index).
void tr_morton_order(const float* centroids, const uint8_t* valid,
                     int64_t n, int64_t* order_out) {
  float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
  bool any = false;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    any = true;
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], centroids[i * 3 + d]);
      hi[d] = std::max(hi[d], centroids[i * 3 + d]);
    }
  }
  if (!any) {
    // no valid triangles: bounds over all centroids instead
    for (int d = 0; d < 3; ++d) { lo[d] = 3e38f; hi[d] = -3e38f; }
    for (int64_t i = 0; i < n; ++i)
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], centroids[i * 3 + d]);
        hi[d] = std::max(hi[d], centroids[i * 3 + d]);
      }
  }
  float ext[3];
  for (int d = 0; d < 3; ++d)
    ext[d] = std::max(hi[d] - lo[d], 1e-12f);

  auto expand = [](uint64_t v) {
    v &= 0x3FF;
    v = (v | (v << 16)) & 0x30000FF;
    v = (v | (v << 8)) & 0x300F00F;
    v = (v | (v << 4)) & 0x30C30C3;
    v = (v | (v << 2)) & 0x9249249;
    return v;
  };

  std::vector<std::pair<uint64_t, int64_t>> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t code = 0;
    uint64_t g[3];
    for (int d = 0; d < 3; ++d) {
      float t = (centroids[i * 3 + d] - lo[d]) / ext[d] * 1023.0f;
      t = std::min(std::max(t, 0.0f), 1023.0f);
      g[d] = static_cast<uint64_t>(t);
    }
    code = expand(g[0]) | (expand(g[1]) << 1) | (expand(g[2]) << 2);
    if (!valid[i]) code += uint64_t{1} << 32;
    keys[i] = {code, i};
  }
  std::stable_sort(keys.begin(), keys.end());
  for (int64_t i = 0; i < n; ++i) order_out[i] = keys[i].second;
}

}  // extern "C"
