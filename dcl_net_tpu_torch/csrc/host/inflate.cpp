// Fast whole-buffer DEFLATE (zlib-wrapped) decompressor for the PNG
// decoder (png_decoder.cpp), the port's own copy of the JAX package's
// csrc/inflate.cpp.
//
// The native PNG color decode is bound by inflate, so this is a
// libdeflate-style one-shot decompressor exploiting what zlib's streaming
// API cannot assume:
//   - the WHOLE compressed stream is in memory (PNG IDAT concatenation),
//   - the EXACT output size is known (PNG geometry), so there is no window
//     management and no output growth logic,
//   - a 64-bit bit buffer refilled branchlessly with one unaligned 8-byte
//     load covers a full literal/length+distance+extras decode (<= 48 bits)
//     per refill,
//   - two-level Huffman tables (root-10 litlen / root-8 dist) resolve
//     almost every symbol with a single L1-resident lookup,
//   - match copies run 8 bytes per store (the output buffer carries 8
//     bytes of slack for the overrun).
//
// Contract: dclx_inflate(in, n, out, out_len) decodes a complete zlib
// stream (RFC 1950 header + RFC 1951 deflate + adler32) producing EXACTLY
// out_len bytes. The out buffer must have out_len + 8 writable bytes (the
// slack is never part of the defined output). Returns 0 on success, <0 on
// any anomaly — the caller falls back to zlib, so anomalies only need to be
// DETECTED, never recovered from. Integrity: the stream's adler32 is
// verified over the produced output.

#include <zlib.h>  // adler32 for the integrity check

#include <cstdint>
#include <cstring>

namespace {

// ---- table entry layout (uint32) ----
//   [5:0]   nbits: code bits consumed by this entry (subtable entries store
//           length-minus-root; the root consume happens at the pointer)
//   [28:6]  payload (kind-specific)
//   [31:29] kind
enum Kind : uint32_t {
  kLiteral = 0,
  kLength = 1,
  kEob = 2,
  kSubPtr = 3,
  kDist = 4,
  kInvalid = 7,
};
constexpr uint32_t kInvalidEntry = 0xFFFFFFFFu;

inline uint32_t make_entry(Kind kind, uint32_t payload, uint32_t nbits) {
  return (uint32_t(kind) << 29) | (payload << 6) | nbits;
}
inline uint32_t entry_kind(uint32_t e) { return e >> 29; }
inline uint32_t entry_payload(uint32_t e) { return (e >> 6) & 0x7FFFFF; }
inline uint32_t entry_nbits(uint32_t e) { return e & 0x3F; }

// length codes 257..285 (RFC 1951 3.2.5)
const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
// distance codes 0..29
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,    9,
                                13,   17,   25,   33,   49,   65,   97,
                                129,  193,  257,  385,  513,  769,  1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                              11, 4,  12, 3, 13, 2, 14, 1, 15};

inline uint32_t bitreverse(uint32_t code, int len) {
  // codes are at most 15 bits
  code = ((code & 0x5555) << 1) | ((code >> 1) & 0x5555);
  code = ((code & 0x3333) << 2) | ((code >> 2) & 0x3333);
  code = ((code & 0x0F0F) << 4) | ((code >> 4) & 0x0F0F);
  code = ((code & 0x00FF) << 8) | ((code >> 8) & 0x00FF);
  return code >> (16 - len);
}

// Build a two-level decode table from canonical code lengths.
//   lens[n]: bits per symbol (0 = unused); root: first-level bits;
//   maker(sym, nbits) -> entry (nbits slot filled by caller convention).
// Fills table[0 .. (1<<root)-1] plus fixed-size 2^(15-root) subtables
// appended after the root table. table_cap guards the append. Incomplete
// trees leave invalid entries (error surfaces on use — matches how a
// 1-code distance tree is legal until a second code is referenced);
// over-subscribed trees return -1.
template <typename Maker>
int build_table(const uint8_t* lens, int n, int root, uint32_t* table,
                int table_cap, Maker maker) {
  int count[16] = {0};
  for (int i = 0; i < n; ++i) count[lens[i]]++;
  // Kraft: over-subscription is malformed
  int left = 1;
  for (int len = 1; len <= 15; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return -1;
  }
  for (int i = 0; i < (1 << root); ++i) table[i] = kInvalidEntry;

  // canonical order: (length, symbol)
  int offs[17];
  offs[1] = 0;
  for (int len = 1; len < 16; ++len) offs[len + 1] = offs[len] + count[len];
  int total_coded = offs[16];
  if (total_coded == 0) return 1 << root;  // empty tree: all-invalid table
  uint16_t sorted[320];
  {
    int pos[16];
    std::memcpy(pos, offs, sizeof(pos));
    for (int i = 0; i < n; ++i)
      if (lens[i]) sorted[pos[lens[i]]++] = uint16_t(i);
  }

  const int sub_bits = 15 - root;
  const int sub_size = 1 << sub_bits;
  int next_sub = 1 << root;  // append position for subtables
  int cur_prefix = -1;

  uint32_t code = 0;
  int prev_len = lens[sorted[0]];
  code = 0;
  for (int k = 0; k < total_coded; ++k) {
    int sym = sorted[k];
    int len = lens[sym];
    if (len > prev_len) {
      code <<= (len - prev_len);
      prev_len = len;
    }
    uint32_t rev = bitreverse(code, len);
    uint32_t e = maker(sym, uint32_t(len));
    if (len <= root) {
      for (uint32_t i = rev; i < (1u << root); i += (1u << len)) table[i] = e;
    } else {
      int prefix = int(rev & ((1u << root) - 1));
      if (prefix != cur_prefix) {
        if (next_sub + sub_size > table_cap) return -1;
        for (int i = 0; i < sub_size; ++i)
          table[next_sub + i] = kInvalidEntry;
        table[prefix] =
            make_entry(kSubPtr, uint32_t(next_sub), uint32_t(sub_bits));
        cur_prefix = prefix;
        next_sub += sub_size;
      }
      // entry consumes len-root bits beyond the root consume
      uint32_t se = (e & ~0x3Fu) | uint32_t(len - root);
      uint32_t sub_base = entry_payload(table[prefix]);
      uint32_t idx = rev >> root;
      for (uint32_t i = idx; i < uint32_t(sub_size);
           i += (1u << (len - root)))
        table[sub_base + i] = se;
    }
    code++;
  }
  return next_sub;
}

inline uint32_t litlen_maker(int sym, uint32_t len) {
  if (sym < 256) return make_entry(kLiteral, uint32_t(sym), len);
  if (sym == 256) return make_entry(kEob, 0, len);
  int i = sym - 257;
  if (i >= 29) return kInvalidEntry;
  return make_entry(kLength,
                    uint32_t(kLenBase[i]) | (uint32_t(kLenExtra[i]) << 16),
                    len);
}

inline uint32_t dist_maker(int sym, uint32_t len) {
  if (sym >= 30) return kInvalidEntry;
  return make_entry(kDist,
                    uint32_t(kDistBase[sym]) | (uint32_t(kDistExtra[sym]) << 16),
                    len);
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bits = 0;
  unsigned nbits = 0;
  int overrun = 0;  // zero-bytes appended past end (legal only at stream end)

  explicit BitReader(const uint8_t* s, const uint8_t* e) : p(s), end(e) {}

  inline void refill() {
    if (end - p >= 8) {
      uint64_t w;
      std::memcpy(&w, p, 8);  // little-endian hosts only (x86/arm64)
      bits |= w << nbits;
      p += (63 - nbits) >> 3;
      nbits |= 56;
    } else {
      while (nbits <= 56) {
        uint8_t b = 0;
        if (p < end) b = *p++;
        else ++overrun;
        bits |= uint64_t(b) << nbits;
        nbits += 8;
      }
    }
  }
  inline uint64_t peek(unsigned n) const { return bits & ((1ull << n) - 1); }
  inline void consume(unsigned n) { bits >>= n; nbits -= n; }
  inline uint64_t read(unsigned n) {
    uint64_t v = peek(n);
    consume(n);
    return v;
  }
  // byte position accounting for unconsumed whole bytes in the buffer
  inline const uint8_t* byte_pos() const { return p - (nbits >> 3); }
};

// decode one symbol via a two-level table; returns entry, consumes bits
inline uint32_t decode_entry(BitReader& br, const uint32_t* table, int root) {
  uint32_t e = table[br.peek(unsigned(root))];
  if (entry_kind(e) == kSubPtr) {
    uint32_t sub_bits = entry_nbits(e);
    uint32_t sub = entry_payload(e) +
                   uint32_t((br.bits >> root) & ((1u << sub_bits) - 1));
    br.consume(unsigned(root));
    e = table[sub];
    if (e == kInvalidEntry) return kInvalidEntry;
    br.consume(entry_nbits(e));
    return e;
  }
  if (e == kInvalidEntry) return kInvalidEntry;
  br.consume(entry_nbits(e));
  return e;
}

constexpr int kLitlenRoot = 11;
constexpr int kDistRoot = 8;
// root + worst-case fixed 2^(15-root) subtables (one per long code)
constexpr int kLitlenCap = (1 << kLitlenRoot) + 288 * (1 << (15 - kLitlenRoot));
constexpr int kDistCap = (1 << kDistRoot) + 30 * (1 << (15 - kDistRoot));

struct Tables {
  uint32_t litlen[kLitlenCap];
  uint32_t dist[kDistCap];
};

int build_fixed(Tables* t) {
  uint8_t lens[288];
  for (int i = 0; i < 144; ++i) lens[i] = 8;
  for (int i = 144; i < 256; ++i) lens[i] = 9;
  for (int i = 256; i < 280; ++i) lens[i] = 7;
  for (int i = 280; i < 288; ++i) lens[i] = 8;
  if (build_table(lens, 288, kLitlenRoot, t->litlen, kLitlenCap,
                  litlen_maker) < 0)
    return -1;
  uint8_t dlens[30];
  std::memset(dlens, 5, sizeof(dlens));
  if (build_table(dlens, 30, kDistRoot, t->dist, kDistCap, dist_maker) < 0)
    return -1;
  return 0;
}

// decode the dynamic-block header's code-length-coded lens
int read_dynamic_header(BitReader& br, Tables* t) {
  br.refill();
  int hlit = int(br.read(5)) + 257;
  int hdist = int(br.read(5)) + 1;
  int hclen = int(br.read(4)) + 4;
  if (hlit > 286 || hdist > 30) return -4;

  uint8_t cl_lens[19] = {0};
  for (int i = 0; i < hclen; ++i) {
    if (br.nbits < 3) br.refill();
    cl_lens[kClOrder[i]] = uint8_t(br.read(3));
  }
  uint32_t cl_table[1 << 7];
  // code-length codes are <= 7 bits: single-level root-7 table
  if (build_table(cl_lens, 19, 7, cl_table, 1 << 7,
                  [](int sym, uint32_t len) {
                    return make_entry(kLiteral, uint32_t(sym), len);
                  }) < 0)
    return -4;

  uint8_t lens[288 + 30] = {0};
  int n = hlit + hdist;
  int i = 0;
  while (i < n) {
    br.refill();
    uint32_t e = cl_table[br.peek(7)];
    if (e == kInvalidEntry) return -4;
    br.consume(entry_nbits(e));
    int sym = int(entry_payload(e));
    if (sym < 16) {
      lens[i++] = uint8_t(sym);
    } else if (sym == 16) {
      if (i == 0) return -4;
      int rep = 3 + int(br.read(2));
      if (i + rep > n) return -4;
      uint8_t v = lens[i - 1];
      while (rep--) lens[i++] = v;
    } else if (sym == 17) {
      int rep = 3 + int(br.read(3));
      if (i + rep > n) return -4;
      while (rep--) lens[i++] = 0;
    } else {  // 18
      int rep = 11 + int(br.read(7));
      if (i + rep > n) return -4;
      while (rep--) lens[i++] = 0;
    }
  }
  if (lens[256] == 0) return -4;  // no end-of-block code
  if (build_table(lens, hlit, kLitlenRoot, t->litlen, kLitlenCap,
                  litlen_maker) < 0)
    return -4;
  if (build_table(lens + hlit, hdist, kDistRoot, t->dist, kDistCap,
                  dist_maker) < 0)
    return -4;
  return 0;
}

}  // namespace

extern "C" {

// See file header for the contract. Errors: -3 malformed zlib wrapper,
// -4 malformed deflate stream / output-size mismatch, -5 adler mismatch.
int dclx_inflate(const uint8_t* in, size_t in_len, uint8_t* out,
                 size_t out_len) {
  if (in_len < 2 + 4) return -3;
  // RFC 1950: CM=8 (deflate), no preset dictionary, header checksum
  if ((in[0] & 0x0F) != 8 || (in[1] & 0x20) != 0 ||
      ((unsigned(in[0]) << 8) | in[1]) % 31 != 0)
    return -3;

  BitReader br(in + 2, in + in_len - 4);  // trailer = adler32
  uint8_t* const out_start = out;
  uint8_t* const out_end = out + out_len;
  static thread_local Tables tables;

  for (;;) {
    br.refill();
    int bfinal = int(br.read(1));
    int btype = int(br.read(2));

    if (btype == 0) {
      // stored block: realign to a byte boundary, then bulk copy.
      // The unconsumed buffer may hold refill-appended virtual zero bytes
      // (overrun) ABOVE the real ones; real unconsumed bytes sit directly
      // before p.
      br.consume(br.nbits & 7);
      size_t buf_bytes = br.nbits >> 3;
      if (buf_bytes < size_t(br.overrun)) return -4;  // consumed virtual bits
      const uint8_t* pos = br.p - (buf_bytes - size_t(br.overrun));
      if (br.end - pos < 4) return -4;
      unsigned len = unsigned(pos[0]) | (unsigned(pos[1]) << 8);
      unsigned nlen = unsigned(pos[2]) | (unsigned(pos[3]) << 8);
      if ((len ^ 0xFFFF) != nlen) return -4;
      pos += 4;
      if (size_t(br.end - pos) < len || size_t(out_end - out) < len)
        return -4;
      std::memcpy(out, pos, len);
      out += len;
      br = BitReader(pos + len, br.end);
    } else if (btype == 1 || btype == 2) {
      if (btype == 1) {
        if (build_fixed(&tables) != 0) return -4;
      } else {
        int rc = read_dynamic_header(br, &tables);
        if (rc != 0) return rc;
      }
      for (;;) {
        br.refill();  // covers litlen(15)+extra(5)+dist(15)+extra(13)=48 bits
        uint32_t e = decode_entry(br, tables.litlen, kLitlenRoot);
        uint32_t kind = entry_kind(e);
        if (kind == kLiteral) {
          if (out >= out_end) return -4;
          *out++ = uint8_t(entry_payload(e));
          // a refill holds >= 56 bits: decode more literals without refill
          while (br.nbits >= 15 + 6) {
            e = tables.litlen[br.peek(kLitlenRoot)];
            if (entry_kind(e) != kLiteral) break;
            br.consume(entry_nbits(e));
            if (out >= out_end) return -4;
            *out++ = uint8_t(entry_payload(e));
          }
          continue;
        }
        if (kind == kEob) break;
        if (kind != kLength) return -4;
        uint32_t payload = entry_payload(e);
        size_t len = (payload & 0xFFFF) + br.read(payload >> 16);

        e = decode_entry(br, tables.dist, kDistRoot);
        if (entry_kind(e) != kDist) return -4;
        payload = entry_payload(e);
        size_t dist = (payload & 0xFFFF) + br.read(payload >> 16);

        if (dist > size_t(out - out_start) || len > size_t(out_end - out))
          return -4;
        const uint8_t* src = out - dist;
        uint8_t* dst = out;
        out += len;
        if (dist >= 8) {
          // word-wide copy; out buffer has 8 bytes of slack for the overrun
          do {
            uint64_t w;
            std::memcpy(&w, src, 8);
            std::memcpy(dst, &w, 8);
            src += 8;
            dst += 8;
          } while (dst < out);
        } else if (dist == 1) {
          // run of one byte (RLE-heavy content): broadcast + word stores
          // (8-byte slack covers the overrun)
          uint64_t w = 0x0101010101010101ull * *src;
          do {
            std::memcpy(dst, &w, 8);
            dst += 8;
          } while (dst < out);
        } else if (len <= 16) {
          while (dst < out) {
            *dst = *(dst - dist);
            ++dst;
          }
        } else {
          // short period (filtered RGB rows emit dist-3 matches): double
          // the copied run — each memcpy's source is fully written,
          // adjacent, and period-aligned (chunk stays a multiple of dist)
          size_t chunk = dist;
          size_t rem = len;
          while (rem > chunk) {
            std::memcpy(dst, dst - chunk, chunk);
            dst += chunk;
            rem -= chunk;
            chunk <<= 1;
          }
          std::memcpy(dst, dst - chunk, rem);  // rem <= chunk: source done
        }
      }
    } else {
      return -4;
    }
    if (bfinal) break;
  }

  if (out != out_end) return -4;
  // NOTE: br.overrun > 0 here is legal — the final EOB code can sit in the
  // stream's last byte, and the preceding refill already padded zeros. The
  // adler32 over the produced output is the integrity arbiter.
  uint32_t want = (uint32_t(in[in_len - 4]) << 24) |
                  (uint32_t(in[in_len - 3]) << 16) |
                  (uint32_t(in[in_len - 2]) << 8) | uint32_t(in[in_len - 1]);
  uint32_t got = uint32_t(
      adler32(adler32(0L, Z_NULL, 0), out_start, uInt(out_len)));
  if (got != want) return -5;
  return 0;
}

}  // extern "C"
