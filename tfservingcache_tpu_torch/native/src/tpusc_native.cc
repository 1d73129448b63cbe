// tpusc_native — the PyTorch port's copy of the JAX package's native host
// tier (tfservingcache_tpu/native/src/tpusc_native.cc). Everything below
// this comment is that source unchanged: the ring, the LRU index, the JSON
// encoder and the request parser behave exactly as the reference's do.
//
// C++ behind a plain-C ABI, built at first use by g++ and loaded with
// ctypes (tfservingcache_tpu_torch/native/__init__.py), with pure-Python
// fallbacks for a machine without a C++ compiler.
//
// Placement parity is a hard requirement: a mixed fleet where some nodes run
// the native ring and some the Python fallback must route every key to the
// same owners.  The ring therefore uses the exact hash the Python side uses —
// BLAKE2b with an 8-byte digest (RFC 7693), value read big-endian — and the
// exact tie-breaking sort (point, then member string).
//
// Components:
//   - blake2b64: unkeyed BLAKE2b-64 (written from RFC 7693, not copied)
//   - Ring:      consistent-hash ring, vnodes per member, get_n distinct
//   - Lru:       byte-budgeted LRU index with max-item cap and atomic
//                two-phase eviction reporting
//
// Thread-safety: each object carries its own shared_mutex; lookups take the
// shared side so concurrent request routing never serializes.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <list>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

// ---------------------------------------------------------------------------
// BLAKE2b (RFC 7693), unkeyed, 8-byte digest
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kIv[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL,
    0x3C6EF372FE94F82BULL, 0xA54FF53A5F1D36F1ULL,
    0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL,
};

constexpr uint8_t kSigma[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts only (x86/arm) — fine here
  return v;
}

inline void g_mix(uint64_t v[16], int a, int b, int c, int d, uint64_t x,
                  uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

void compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
              bool last) {
  uint64_t m[16];
  for (int i = 0; i < 16; i++) m[i] = load_le64(block + 8 * i);
  uint64_t v[16];
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[8 + i] = kIv[i];
  v[12] ^= t;  // low word of the 128-bit offset; inputs here are < 2^64
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = kSigma[r % 10];
    g_mix(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    g_mix(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    g_mix(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    g_mix(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    g_mix(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    g_mix(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    g_mix(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    g_mix(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

// 8-byte-digest BLAKE2b of `data`, returned as the big-endian integer the
// Python side computes via int.from_bytes(blake2b(digest_size=8), "big").
uint64_t blake2b64(const uint8_t* data, size_t len) {
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = kIv[i];
  h[0] ^= 0x01010000ULL ^ 8ULL;  // depth 1, fanout 1, key 0, digest 8

  uint8_t block[128];
  size_t off = 0;
  // all blocks before the last are full; the final (possibly empty) chunk is
  // zero-padded and compressed with the final flag
  while (len - off > 128) {
    compress(h, data + off, static_cast<uint64_t>(off) + 128, false);
    off += 128;
  }
  size_t rem = len - off;
  std::memset(block, 0, sizeof(block));
  if (rem) std::memcpy(block, data + off, rem);
  compress(h, block, static_cast<uint64_t>(len), true);

  // digest bytes = little-endian h[0]; value = those 8 bytes read big-endian
  uint64_t out = 0;
  for (int i = 0; i < 8; i++) {
    out = (out << 8) | ((h[0] >> (8 * i)) & 0xFF);
  }
  return out;
}

uint64_t point_of(const std::string& s) {
  return blake2b64(reinterpret_cast<const uint8_t*>(s.data()), s.size());
}

// ---------------------------------------------------------------------------
// Consistent-hash ring
// ---------------------------------------------------------------------------

struct Ring {
  explicit Ring(int vnodes) : vnodes(vnodes) {}

  int vnodes;
  mutable std::shared_mutex mu;
  std::vector<uint64_t> points;   // sorted
  std::vector<uint32_t> owner_ix; // parallel: index into members
  std::vector<std::string> members;

  void set_members(std::vector<std::string> new_members) {
    // dedupe, keep deterministic (point, owner-string) sort like the Python
    // side's tuple sort
    std::sort(new_members.begin(), new_members.end());
    new_members.erase(std::unique(new_members.begin(), new_members.end()),
                      new_members.end());
    std::vector<std::pair<uint64_t, uint32_t>> pairs;
    pairs.reserve(new_members.size() * vnodes);
    for (uint32_t mi = 0; mi < new_members.size(); mi++) {
      for (int i = 0; i < vnodes; i++) {
        pairs.emplace_back(
            point_of(new_members[mi] + "#" + std::to_string(i)), mi);
      }
    }
    std::sort(pairs.begin(), pairs.end(),
              [&](const auto& a, const auto& b) {
                if (a.first != b.first) return a.first < b.first;
                return new_members[a.second] < new_members[b.second];
              });
    std::unique_lock lk(mu);
    members = std::move(new_members);
    points.resize(pairs.size());
    owner_ix.resize(pairs.size());
    for (size_t i = 0; i < pairs.size(); i++) {
      points[i] = pairs[i].first;
      owner_ix[i] = pairs[i].second;
    }
  }

  // N distinct members clockwise from the key's point, '\n'-joined into out.
  // Returns bytes needed (incl. NUL); caller retries with a bigger buffer if
  // the return exceeds cap.
  int get_n(const std::string& key, int n, char* out, int cap) const {
    if (n < 1) n = 1;
    std::shared_lock lk(mu);
    if (points.empty()) {
      if (cap > 0) out[0] = '\0';
      return 1;
    }
    n = std::min<int>(n, static_cast<int>(members.size()));
    uint64_t p = point_of(key);
    size_t idx = std::lower_bound(points.begin(), points.end(), p) -
                 points.begin();
    if (idx == points.size()) idx = 0;
    std::vector<bool> seen(members.size(), false);
    std::string joined;
    int found = 0;
    for (size_t step = 0; step < points.size() && found < n; step++) {
      uint32_t mi = owner_ix[(idx + step) % points.size()];
      if (!seen[mi]) {
        seen[mi] = true;
        if (found) joined += '\n';
        joined += members[mi];
        found++;
      }
    }
    int needed = static_cast<int>(joined.size()) + 1;
    if (needed <= cap) std::memcpy(out, joined.c_str(), needed);
    return needed;
  }
};

// ---------------------------------------------------------------------------
// Byte-budgeted LRU index
// ---------------------------------------------------------------------------

struct Lru {
  Lru(long long capacity, long long max_items)
      : capacity(capacity), max_items(max_items) {}

  long long capacity;
  long long max_items;  // -1 = unbounded
  long long total = 0;
  mutable std::shared_mutex mu;
  std::list<std::pair<std::string, long long>> order;  // LRU front, MRU back
  std::unordered_map<std::string,
                     std::list<std::pair<std::string, long long>>::iterator>
      index;

  bool contains(const std::string& k) const {
    std::shared_lock lk(mu);
    return index.count(k) != 0;
  }

  // returns size if present (touching unless touch=0), -1 if absent
  long long get(const std::string& k, int touch) {
    if (!touch) {  // pure read: shared side, so resident checks never serialize
      std::shared_lock lk(mu);
      auto it = index.find(k);
      return it == index.end() ? -1 : it->second->second;
    }
    std::unique_lock lk(mu);
    auto it = index.find(k);
    if (it == index.end()) return -1;
    order.splice(order.end(), order, it->second);
    return it->second->second;
  }

  // Evictions needed to fit `extra` bytes / `extra_items` items, LRU-first,
  // optionally pretending key `skip` (a being-replaced entry) is already
  // gone.  Pure planning — no mutation.  Shared by put and ensure_free so
  // the two paths can never diverge.
  std::vector<std::string> plan_evictions(long long extra, int extra_items,
                                          const std::string* skip) const {
    std::vector<std::string> out;
    long long t = total;
    long long items = static_cast<long long>(order.size());
    if (skip) {
      auto it = index.find(*skip);
      if (it != index.end()) {
        t -= it->second->second;
        items--;
      }
    }
    for (auto it = order.begin(); it != order.end(); ++it) {
      if (skip && it->first == *skip) continue;
      if (t + extra <= capacity &&
          (max_items < 0 || items + extra_items <= max_items)) {
        break;
      }
      out.push_back(it->first);
      t -= it->second;
      items--;
    }
    return out;
  }

  void drop(const std::string& k) {
    auto it = index.find(k);
    if (it == index.end()) return;
    total -= it->second->second;
    order.erase(it->second);
    index.erase(it);
  }
};

std::string join_lines(const std::vector<std::string>& v) {
  std::string out;
  for (size_t i = 0; i < v.size(); i++) {
    if (i) out += '\n';
    out += v[i];
  }
  return out;
}

// write a string into (out, cap); returns needed bytes incl. NUL
int write_out(const std::string& s, char* out, int cap) {
  int needed = static_cast<int>(s.size()) + 1;
  if (needed <= cap && out) std::memcpy(out, s.c_str(), needed);
  return needed;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

unsigned long long tpusc_blake2b64(const char* data, long long len) {
  return blake2b64(reinterpret_cast<const uint8_t*>(data),
                   static_cast<size_t>(len));
}

void* tpusc_ring_new(int vnodes) { return new Ring(vnodes); }

void tpusc_ring_free(void* r) { delete static_cast<Ring*>(r); }

void tpusc_ring_set_members(void* r, const char** members, int n) {
  std::vector<std::string> v;
  v.reserve(n);
  for (int i = 0; i < n; i++) v.emplace_back(members[i]);
  static_cast<Ring*>(r)->set_members(std::move(v));
}

int tpusc_ring_len(void* r) {
  Ring* ring = static_cast<Ring*>(r);
  std::shared_lock lk(ring->mu);
  return static_cast<int>(ring->members.size());
}

int tpusc_ring_members(void* r, char* out, int cap) {
  Ring* ring = static_cast<Ring*>(r);
  std::shared_lock lk(ring->mu);
  return write_out(join_lines(ring->members), out, cap);
}

int tpusc_ring_get_n(void* r, const char* key, int n, char* out, int cap) {
  return static_cast<Ring*>(r)->get_n(key, n, out, cap);
}

void* tpusc_lru_new(long long capacity, long long max_items) {
  return new Lru(capacity, max_items);
}

void tpusc_lru_free(void* l) { delete static_cast<Lru*>(l); }

long long tpusc_lru_total(void* l) {
  Lru* lru = static_cast<Lru*>(l);
  std::shared_lock lk(lru->mu);
  return lru->total;
}

int tpusc_lru_len(void* l) {
  Lru* lru = static_cast<Lru*>(l);
  std::shared_lock lk(lru->mu);
  return static_cast<int>(lru->index.size());
}

int tpusc_lru_contains(void* l, const char* key) {
  return static_cast<Lru*>(l)->contains(key) ? 1 : 0;
}

long long tpusc_lru_get(void* l, const char* key, int touch) {
  return static_cast<Lru*>(l)->get(key, touch);
}

// Insert/replace `key` with `size`, evicting LRU entries to fit.
// On success writes '\n'-joined evicted keys (replaced old entry NOT
// included) and returns bytes needed; if the buffer is too small returns the
// needed size WITHOUT mutating (caller retries).  Returns -1 on capacity
// error (item larger than the whole budget).
int tpusc_lru_put(void* l, const char* key, long long size, char* out,
                  int cap) {
  Lru* lru = static_cast<Lru*>(l);
  std::string k(key);
  std::unique_lock lk(lru->mu);
  if (size > lru->capacity) return -1;

  // plan as if the old entry were already gone; like the Python tier,
  // max_items == 0 still admits the new item after draining everything
  std::vector<std::string> plan = lru->plan_evictions(size, 1, &k);
  std::string joined = join_lines(plan);
  int needed = static_cast<int>(joined.size()) + 1;
  if (needed > cap) {
    return needed;  // caller retries with a bigger buffer; nothing mutated
  }

  lru->drop(k);
  for (const auto& ek : plan) lru->drop(ek);
  lru->order.emplace_back(k, size);
  lru->index[k] = std::prev(lru->order.end());
  lru->total += size;
  std::memcpy(out, joined.c_str(), needed);
  return needed;
}

// returns old size if removed, -1 if absent
long long tpusc_lru_remove(void* l, const char* key) {
  Lru* lru = static_cast<Lru*>(l);
  std::unique_lock lk(lru->mu);
  auto it = lru->index.find(key);
  if (it == lru->index.end()) return -1;
  long long size = it->second->second;
  lru->total -= size;
  lru->order.erase(it->second);
  lru->index.erase(it);
  return size;
}

// Evict until `n` bytes are free.  Same buffer protocol as put; -1 when n
// exceeds the whole capacity.
int tpusc_lru_ensure_free(void* l, long long n, char* out, int cap) {
  Lru* lru = static_cast<Lru*>(l);
  std::unique_lock lk(lru->mu);
  if (n > lru->capacity) return -1;
  std::vector<std::string> plan = lru->plan_evictions(n, 0, nullptr);
  std::string joined = join_lines(plan);
  int needed = static_cast<int>(joined.size()) + 1;
  if (needed > cap) return needed;
  for (const auto& ek : plan) lru->drop(ek);
  std::memcpy(out, joined.c_str(), needed);
  return needed;
}

// '\n'-joined keys; mru_first mirrors the reference ListModels order
int tpusc_lru_keys(void* l, int mru_first, char* out, int cap) {
  Lru* lru = static_cast<Lru*>(l);
  std::shared_lock lk(lru->mu);
  std::vector<std::string> keys;
  keys.reserve(lru->order.size());
  for (const auto& kv : lru->order) keys.push_back(kv.first);  // LRU first
  if (mru_first) std::reverse(keys.begin(), keys.end());
  return write_out(join_lines(keys), out, cap);
}

void tpusc_lru_clear(void* l) {
  Lru* lru = static_cast<Lru*>(l);
  std::unique_lock lk(lru->mu);
  lru->order.clear();
  lru->index.clear();
  lru->total = 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JSON tensor encoder
//
// The REST ":predict" response path serializes output tensors as JSON number
// lists; CPython's json.dumps walks a Python list tree at ~1 M floats/s,
// which caps an LM's (B, vocab) last-token response at <100 qps per host
// core.  This encoder writes the nested-list JSON straight from the numpy
// buffer with std::to_chars (shortest round-trip representation for the
// SOURCE dtype, so float32 prints "0.1", not the 17-digit double repr of
// the nearest double — parse-equal after the client's float32 cast, and
// ~40% smaller).  Non-finite values print the tokens Python's json module
// emits (NaN / Infinity / -Infinity) so existing clients see no change.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
inline char* write_num(char* p, T v) {
  auto r = std::to_chars(p, p + 32, v);
  return r.ptr;
}

template <typename T>
inline char* write_float(char* p, T v) {
  if (std::isfinite(v)) {
    auto r = std::to_chars(p, p + 30, v);
    // json.dumps prints integral floats as "3.0", and json.loads turns a
    // bare "3" into an int — keep the float-typedness on the wire
    bool has_mark = false;
    for (char* q = p; q != r.ptr; ++q) {
      if (*q == '.' || *q == 'e' || *q == 'E') { has_mark = true; break; }
    }
    if (!has_mark) { *r.ptr++ = '.'; *r.ptr++ = '0'; }
    return r.ptr;
  }
  const char* s = std::isnan(v) ? "NaN" : (v > 0 ? "Infinity" : "-Infinity");
  size_t n = std::strlen(s);
  std::memcpy(p, s, n);
  return p + n;
}

inline char* write_bool(char* p, uint8_t v) {
  const char* s = v ? "true" : "false";
  size_t n = std::strlen(s);
  std::memcpy(p, s, n);
  return p + n;
}

template <typename T, typename Writer>
char* enc_dim(const T*& d, const int64_t* shape, int ndim, int dim, char* p,
              Writer w) {
  if (dim == ndim) {
    return w(p, *d++);
  }
  *p++ = '[';
  for (int64_t i = 0; i < shape[dim]; ++i) {
    if (i) { *p++ = ','; *p++ = ' '; }  // ", " = json.dumps's default
    p = enc_dim(d, shape, ndim, dim + 1, p, w);
  }
  *p++ = ']';
  return p;
}

template <typename T, typename Writer>
long long enc_typed(const void* data, const int64_t* shape, int ndim,
                    char* out, long long cap, int per_elem, Writer w) {
  long long n = 1, brackets = 1;
  for (int k = 0; k < ndim; ++k) {
    n *= shape[k];
    if (k + 1 < ndim) brackets += n;
  }
  if (ndim == 0) brackets = 0;
  // worst case: every element + ", " separator + ".0", every bracket pair
  long long bound = n * (per_elem + 4) + brackets * 2 + 16;
  if (bound > cap) return -bound;  // caller retries with the returned size
  const T* d = static_cast<const T*>(data);
  char* p = enc_dim(d, shape, ndim, 0, out, w);
  return p - out;
}

}  // namespace

extern "C" {

// kind: 1=float32 2=float64 3=int32 4=int64 5=bool8 6=uint8
// Returns bytes written; -1 = unsupported kind; any other negative value is
// -(required capacity) — retry with that size.
long long tpusc_json_encode(const void* data, int kind, const int64_t* shape,
                            int ndim, char* out, long long cap) {
  switch (kind) {
    case 1:
      return enc_typed<float>(data, shape, ndim, out, cap, 24,
                              [](char* p, float v) { return write_float(p, v); });
    case 2:
      return enc_typed<double>(data, shape, ndim, out, cap, 26,
                               [](char* p, double v) { return write_float(p, v); });
    case 3:
      return enc_typed<int32_t>(data, shape, ndim, out, cap, 12,
                                [](char* p, int32_t v) { return write_num(p, v); });
    case 4:
      return enc_typed<int64_t>(data, shape, ndim, out, cap, 21,
                                [](char* p, int64_t v) { return write_num(p, v); });
    case 5:
      return enc_typed<uint8_t>(data, shape, ndim, out, cap, 6,
                                [](char* p, uint8_t v) { return write_bool(p, v); });
    case 6:
      return enc_typed<uint8_t>(data, shape, ndim, out, cap, 4,
                                [](char* p, uint8_t v) { return write_num(p, v); });
    default:
      return -1;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JSON request parser with dense-tensor extraction
//
// The decode side of the REST hot path: json.loads of a ":predict" body
// builds one Python object per number (~1 M numbers/s).  This parser walks
// the body once; every maximal dense numeric array of >= kTensorMinElems
// elements becomes a flat typed buffer + shape, and the remaining skeleton
// (envelope keys, small lists, strings) is re-emitted as JSON with each
// extracted tensor replaced by a placeholder string the Python side swaps
// for a numpy array.  Anything unusual — ragged shapes, mixed types, depth
// bombs, out-of-range ints — declines extraction (span-copied verbatim) or
// fails the whole parse, and the caller falls back to Python json.loads.
//
// Number/int semantics match Python's json: a token is integral iff it has
// no '.', 'e', 'E'; NaN/Infinity/-Infinity are accepted as doubles.
// ---------------------------------------------------------------------------

namespace jsonp {

constexpr int kMaxDepth = 64;
constexpr int kTensorMaxDims = 32;  // = the ctypes bridge's shape buffer
constexpr long long kTensorMinElems = 64;

struct Tensor {
  bool is_int = true;
  std::vector<int64_t> shape;
  std::vector<double> vals;
  std::vector<int64_t> ivals;
};

struct Parser {
  const char* s;
  long long n;
  long long i = 0;
  bool ok = true;
  bool declined = false;  // structurally fine for json.loads, beyond us
  std::string err;
  std::string out;          // skeleton JSON
  std::string nonce;
  std::vector<Tensor> tensors;

  explicit Parser(const char* text, long long len, const char* nonce_)
      : s(text), n(len), nonce(nonce_) {
    out.reserve(256);
  }

  void fail(const std::string& m) {
    if (ok) {
      ok = false;
      err = m + " at offset " + std::to_string(i);
    }
  }

  void skip_ws() {
    while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' || s[i] == '\r'))
      i++;
  }

  bool lit(const char* w) {
    long long len = static_cast<long long>(std::strlen(w));
    if (i + len <= n && std::memcmp(s + i, w, len) == 0) {
      i += len;
      return true;
    }
    return false;
  }

  // scan a string token (assumes s[i] == '"'); returns false on error
  bool scan_string() {
    i++;  // opening quote
    while (i < n) {
      unsigned char c = s[i];
      if (c == '"') {
        i++;
        return true;
      }
      if (c == '\\') {
        i += 2;
        if (i > n) break;
        continue;
      }
      if (c < 0x20) {
        fail("control character in string");
        return false;
      }
      i++;
    }
    fail("unterminated string");
    return false;
  }

  // scan a number token; *integral = no '.', 'e', 'E'
  bool scan_number(bool* integral) {
    long long start = i;
    *integral = true;
    if (i < n && s[i] == '-') i++;
    if (i >= n || !(s[i] >= '0' && s[i] <= '9')) {
      fail("bad number");
      return false;
    }
    if (s[i] == '0') {
      i++;  // JSON: a leading zero cannot be followed by more digits
      if (i < n && s[i] >= '0' && s[i] <= '9') {
        fail("leading zero");
        return false;
      }
    } else {
      while (i < n && s[i] >= '0' && s[i] <= '9') i++;
    }
    if (i < n && s[i] == '.') {
      *integral = false;
      i++;
      if (i >= n || !(s[i] >= '0' && s[i] <= '9')) {
        fail("bad number fraction");
        return false;
      }
      while (i < n && s[i] >= '0' && s[i] <= '9') i++;
    }
    if (i < n && (s[i] == 'e' || s[i] == 'E')) {
      *integral = false;
      i++;
      if (i < n && (s[i] == '+' || s[i] == '-')) i++;
      if (i >= n || !(s[i] >= '0' && s[i] <= '9')) {
        fail("bad number exponent");
        return false;
      }
      while (i < n && s[i] >= '0' && s[i] <= '9') i++;
    }
    (void)start;
    return true;
  }

  // Try to parse the array starting at s[i] (s[i]=='[') as a dense numeric
  // nd-array into t.  On structural mismatch (non-number leaf, ragged),
  // returns false with i restored — caller re-parses generically.  Hard
  // syntax errors set ok=false.
  bool try_tensor(Tensor* t) {
    long long save = i;
    t->shape.clear();
    t->vals.clear();
    t->ivals.clear();
    t->is_int = true;
    std::vector<int64_t> shape;      // discovered on the first spine
    std::vector<int64_t> counts;     // current index per depth
    if (!tensor_dim(t, &shape, 0)) {
      i = save;
      return false;
    }
    t->shape = shape;
    long long total = 1;
    for (int64_t d : shape) total *= d;
    if (total != static_cast<long long>(t->vals.size())) {
      i = save;  // decline cleanly: the generic path re-parses from the start
      return false;
    }
    (void)counts;
    return ok;
  }

  bool tensor_dim(Tensor* t, std::vector<int64_t>* shape, int depth) {
    if (depth >= kTensorMaxDims) return false;  // rank-capped: decline, not fail
    if (i >= n || s[i] != '[') return false;
    i++;
    skip_ws();
    bool first_spine = static_cast<int>(shape->size()) <= depth;
    if (first_spine) shape->push_back(0);
    int64_t count = 0;
    bool saw_leaf = false, saw_arr = false;
    if (i < n && s[i] == ']') {
      i++;
      // empty dim: record 0; deeper shape unknown — only accept if this is
      // the innermost level seen so far (shape stays [..., 0])
      if (!first_spine && (*shape)[depth] != 0) return false;
      (*shape)[depth] = 0;
      return true;
    }
    while (i < n) {
      skip_ws();
      if (i < n && s[i] == '[') {
        if (saw_leaf) return false;  // mixed leaf/array siblings: not dense
        saw_arr = true;
        if (!tensor_dim(t, shape, depth + 1)) return false;
      } else {
        if (saw_arr) return false;
        saw_leaf = true;
        // numeric leaf required; leaves only allowed at the deepest level
        if (static_cast<int>(shape->size()) != depth + 1) return false;
        long long tok_start = i;
        if (i < n && (s[i] == 'N' || s[i] == 'I' ||
                      (s[i] == '-' && i + 1 < n && s[i + 1] == 'I'))) {
          // NaN / Infinity / -Infinity
          double v;
          if (lit("NaN")) v = std::nan("");
          else if (lit("Infinity")) v = std::numeric_limits<double>::infinity();
          else if (lit("-Infinity")) v = -std::numeric_limits<double>::infinity();
          else return false;
          t->is_int = false;
          t->vals.push_back(v);
        } else if (i < n && (s[i] == '-' || (s[i] >= '0' && s[i] <= '9'))) {
          bool integral;
          if (!scan_number(&integral)) return false;  // hard error recorded
          double d;
          auto r = std::from_chars(s + tok_start, s + i, d);
          if (r.ec != std::errc()) return false;
          t->vals.push_back(d);
          if (t->is_int && integral) {
            int64_t iv;
            auto ri = std::from_chars(s + tok_start, s + i, iv);
            if (ri.ec != std::errc() || ri.ptr != s + i) {
              // integral but outside int64: a float64 demotion would lose
              // precision AND diverge from the json.loads fallback, which
              // yields exact Python ints (np.asarray gives an exact uint64
              // array for [2^63, 2^64)) — decline extraction so the whole
              // array takes the verbatim/fallback path (ADVICE r3)
              return false;
            } else {
              t->ivals.push_back(iv);
            }
          } else {
            t->is_int = false;
          }
        } else {
          return false;  // string/object/bool/null leaf: not a tensor
        }
      }
      count++;
      skip_ws();
      if (i < n && s[i] == ',') {
        i++;
        continue;
      }
      if (i < n && s[i] == ']') {
        i++;
        break;
      }
      fail("expected ',' or ']'");
      return false;
    }
    if (first_spine) {
      (*shape)[depth] = count;
    } else if ((*shape)[depth] != count) {
      return false;  // ragged
    }
    return true;
  }

  void emit_placeholder(size_t k) {
    out += "\"\\u0007";
    out += nonce;
    out += ':';
    out += std::to_string(k);
    out += '"';
  }

  void value(int depth) {
    if (!ok) return;
    if (depth >= kMaxDepth) {
      declined = true;  // valid JSON may continue deeper: let json.loads try
      fail("nesting too deep");
      return;
    }
    skip_ws();
    if (i >= n) {
      fail("unexpected end");
      return;
    }
    char c = s[i];
    if (c == '{') {
      out += '{';
      i++;
      skip_ws();
      if (i < n && s[i] == '}') {
        i++;
        out += '}';
        return;
      }
      while (ok) {
        skip_ws();
        if (i >= n || s[i] != '"') {
          fail("expected object key");
          return;
        }
        long long key_start = i;
        if (!scan_string()) return;
        out.append(s + key_start, i - key_start);
        skip_ws();
        if (i >= n || s[i] != ':') {
          fail("expected ':'");
          return;
        }
        i++;
        out += ':';
        value(depth + 1);
        if (!ok) return;
        skip_ws();
        if (i < n && s[i] == ',') {
          i++;
          out += ',';
          continue;
        }
        if (i < n && s[i] == '}') {
          i++;
          out += '}';
          return;
        }
        fail("expected ',' or '}'");
        return;
      }
      return;
    }
    if (c == '[') {
      Tensor t;
      long long before = i;
      if (try_tensor(&t) && ok) {
        long long total = static_cast<long long>(t.vals.size());
        if (total >= kTensorMinElems) {
          tensors.push_back(std::move(t));
          emit_placeholder(tensors.size() - 1);
          return;
        }
        // parsed fine but small: keep the original text span verbatim
        out.append(s + before, i - before);
        return;
      }
      if (!ok) return;
      // generic array
      out += '[';
      i++;
      skip_ws();
      if (i < n && s[i] == ']') {
        i++;
        out += ']';
        return;
      }
      while (ok) {
        value(depth + 1);
        if (!ok) return;
        skip_ws();
        if (i < n && s[i] == ',') {
          i++;
          out += ',';
          continue;
        }
        if (i < n && s[i] == ']') {
          i++;
          out += ']';
          return;
        }
        fail("expected ',' or ']'");
        return;
      }
      return;
    }
    if (c == '"') {
      long long start = i;
      if (!scan_string()) return;
      out.append(s + start, i - start);
      return;
    }
    if (lit("true")) { out += "true"; return; }
    if (lit("false")) { out += "false"; return; }
    if (lit("null")) { out += "null"; return; }
    if (lit("NaN")) { out += "NaN"; return; }
    if (lit("Infinity")) { out += "Infinity"; return; }
    if (c == '-' && lit("-Infinity")) { out += "-Infinity"; return; }
    if (c == '-' || (c >= '0' && c <= '9')) {
      long long start = i;
      bool integral;
      if (!scan_number(&integral)) return;
      out.append(s + start, i - start);
      return;
    }
    fail("unexpected character");
  }

  void parse() {
    value(0);
    if (!ok) return;
    skip_ws();
    if (i != n) fail("trailing data");
  }
};

}  // namespace jsonp

extern "C" {

void* tpusc_json_parse(const char* text, long long len, const char* nonce) {
  auto* p = new jsonp::Parser(text, len, nonce);
  p->parse();
  return p;
}

int tpusc_jp_ok(void* h) { return static_cast<jsonp::Parser*>(h)->ok ? 1 : 0; }

int tpusc_jp_declined(void* h) {
  return static_cast<jsonp::Parser*>(h)->declined ? 1 : 0;
}

const char* tpusc_jp_error(void* h) {
  return static_cast<jsonp::Parser*>(h)->err.c_str();
}

const char* tpusc_jp_skeleton(void* h, long long* len) {
  auto* p = static_cast<jsonp::Parser*>(h);
  *len = static_cast<long long>(p->out.size());
  return p->out.data();
}

int tpusc_jp_ntensors(void* h) {
  return static_cast<int>(static_cast<jsonp::Parser*>(h)->tensors.size());
}

// -> ndim; shape copied into shape_out (cap entries); is_int + nelems set
int tpusc_jp_tensor_info(void* h, int k, int* is_int, int64_t* shape_out,
                         int cap, long long* nelems) {
  auto& t = static_cast<jsonp::Parser*>(h)->tensors[k];
  *is_int = t.is_int ? 1 : 0;
  int ndim = static_cast<int>(t.shape.size());
  for (int d = 0; d < ndim && d < cap; d++) shape_out[d] = t.shape[d];
  *nelems = static_cast<long long>(t.vals.size());
  return ndim;
}

const void* tpusc_jp_tensor_data(void* h, int k) {
  auto& t = static_cast<jsonp::Parser*>(h)->tensors[k];
  return t.is_int ? static_cast<const void*>(t.ivals.data())
                  : static_cast<const void*>(t.vals.data());
}

void tpusc_jp_free(void* h) { delete static_cast<jsonp::Parser*>(h); }

}  // extern "C"
