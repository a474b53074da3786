// Native PNG decoder for the port's host data loaders
// (dcl_net_tpu_torch/data/png.py), the port's own copy of the JAX package's
// csrc/png_decoder.cpp.
//
// The reference's loaders decode three PNGs per frame with PIL (reference
// YCBV/dataloader_train_YCBV.py:105-210); PIL's decode spends most of its
// time outside zlib, in unfilter, mode handling and the numpy copy. This
// decoder does one inflate over the IDAT chunks, an in-place per-row
// unfilter, and writes straight into the caller's numpy buffer.
//
// Output conventions MATCH np.array(PIL.Image.open(...)):
//   gray 8-bit        -> [H, W]    u8
//   gray 16-bit       -> [H, W]    u16 (host-endian; PNG is big-endian)
//   gray+alpha 8-bit  -> [H, W, 2] u8
//   RGB 8/16-bit      -> [H, W, 3] u8/u16
//   RGBA 8/16-bit     -> [H, W, 4] u8/u16
//   palette 8-bit     -> [H, W]    u8 PALETTE INDICES (PIL mode 'P' semantics)
//
// Unsupported, reported as -2 (the caller decodes those with PIL):
// interlaced (Adam7), bit depths 1/2/4. Errors: -1 bad signature/truncated,
// -3 zlib error, -4 malformed stream.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PngInfo {
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  int channels = 0;  // output channels (palette stays 1 = indices)
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette -> indices
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

int parse_ihdr(const uint8_t* data, size_t len, PngInfo* info) {
  if (len < 8 + 25 || std::memcmp(data, kSig, 8) != 0) return -1;
  const uint8_t* p = data + 8;
  uint32_t chunk_len = be32(p);
  if (chunk_len != 13 || std::memcmp(p + 4, "IHDR", 4) != 0) return -4;
  const uint8_t* d = p + 8;
  info->w = be32(d);
  info->h = be32(d + 4);
  info->bit_depth = d[8];
  info->color_type = d[9];
  // d[10] compression (must be 0), d[11] filter (must be 0)
  info->interlace = d[12];
  info->channels = channels_of(info->color_type);
  if (info->w == 0 || info->h == 0 || info->channels == 0 || d[10] != 0 ||
      d[11] != 0)
    return -4;
  if (info->interlace != 0) return -2;
  if (info->bit_depth != 8 && info->bit_depth != 16) return -2;
  if (info->color_type == 3 && info->bit_depth != 8) return -2;
  return 0;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return pb <= pc ? uint8_t(b) : uint8_t(c);
}

// Unfilter one scanline in place. prev == nullptr for the first row.
int unfilter_row(int filter, uint8_t* row, const uint8_t* prev, size_t stride,
                 size_t bpp) {
  switch (filter) {
    case 0:
      return 0;
    case 1:  // Sub
      for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
      return 0;
    case 2:  // Up
      if (prev)
        for (size_t i = 0; i < stride; ++i) row[i] += prev[i];
      return 0;
    case 3:  // Average
      if (prev) {
        for (size_t i = 0; i < bpp; ++i) row[i] += prev[i] >> 1;
        for (size_t i = bpp; i < stride; ++i)
          row[i] += uint8_t((row[i - bpp] + prev[i]) >> 1);
      } else {
        for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp] >> 1;
      }
      return 0;
    case 4:  // Paeth
      if (prev) {
        for (size_t i = 0; i < bpp; ++i) row[i] += prev[i];  // a=c=0
        for (size_t i = bpp; i < stride; ++i)
          row[i] += paeth(row[i - bpp], prev[i], prev[i - bpp]);
      } else {
        for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
      }
      return 0;
    default:
      return -4;
  }
}

}  // namespace

// inflate.cpp: libdeflate-style one-shot inflate; out must carry 8 bytes
// of slack
extern "C" int dclx_inflate(const uint8_t* in, size_t in_len, uint8_t* out,
                            size_t out_len);

namespace {

// Gather the IDAT payloads (one zlib stream split across chunks) into a
// contiguous buffer and run the fast one-shot inflate. Returns 0 and fills
// raw[0..raw_size) on success; nonzero = caller runs the zlib path.
int fast_inflate_idat(const uint8_t* data, size_t len, uint8_t* raw,
                      size_t raw_size, std::vector<uint8_t>* scratch) {
  scratch->clear();
  size_t off = 8 + 25;
  while (off + 12 <= len) {
    uint32_t clen = be32(data + off);
    const uint8_t* ctype = data + off + 4;
    if (off + 12 + clen > len) return -4;
    if (std::memcmp(ctype, "IDAT", 4) == 0)
      scratch->insert(scratch->end(), data + off + 8, data + off + 8 + clen);
    else if (std::memcmp(ctype, "IEND", 4) == 0)
      break;
    off += 12 + clen;
  }
  if (scratch->empty()) return -4;
  return dclx_inflate(scratch->data(), scratch->size(), raw, raw_size);
}

}  // namespace

extern "C" {

// Probe header: fills output-array geometry. Returns 0 on success.
int dclx_png_probe(const uint8_t* data, size_t len, int* w, int* h,
                   int* channels, int* bytes_per_chan) {
  PngInfo info;
  int rc = parse_ihdr(data, len, &info);
  if (rc != 0) return rc;
  *w = int(info.w);
  *h = int(info.h);
  *channels = info.channels;
  *bytes_per_chan = info.bit_depth / 8;
  return 0;
}

// Decode into caller buffer of probe-reported size (h*w*channels elements
// of u8 or u16, C-contiguous). Returns 0 on success.
int dclx_png_decode(const uint8_t* data, size_t len, uint8_t* out) {
  PngInfo info;
  int rc = parse_ihdr(data, len, &info);
  if (rc != 0) return rc;

  const size_t stride = size_t(info.w) * info.channels * (info.bit_depth / 8);
  const size_t bpp = size_t(info.channels) * (info.bit_depth / 8);
  const size_t raw_size = size_t(info.h) * (stride + 1);
  // +8: dclx_inflate's word-wide match copies may overrun by up to 7 bytes
  std::vector<uint8_t> raw(raw_size + 8);

  // Fast path: one-shot libdeflate-style inflate over the concatenated
  // IDAT payloads (inflate.cpp). Any anomaly (malformed stream, adler
  // mismatch) falls back to zlib's streaming inflate.
  thread_local std::vector<uint8_t> scratch;
  const bool inflated =
      fast_inflate_idat(data, len, raw.data(), raw_size, &scratch) == 0;

  if (!inflated) {
    // Streaming inflate across the IDAT chunks (no concatenation copy).
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return -3;
    zs.next_out = raw.data();
    zs.avail_out = uInt(raw_size);
    int zrc = Z_OK;
    size_t off = 8 + 25;  // past signature + IHDR
    bool done = false;
    while (!done && off + 12 <= len) {
      uint32_t clen = be32(data + off);
      const uint8_t* ctype = data + off + 4;
      if (off + 12 + clen > len) {
        inflateEnd(&zs);
        return -4;
      }
      if (std::memcmp(ctype, "IDAT", 4) == 0) {
        zs.next_in = const_cast<uint8_t*>(data + off + 8);
        zs.avail_in = clen;
        zrc = inflate(&zs, Z_NO_FLUSH);
        if (zrc == Z_STREAM_END) done = true;
        else if (zrc != Z_OK && zrc != Z_BUF_ERROR) {
          inflateEnd(&zs);
          return -3;
        }
      } else if (std::memcmp(ctype, "IEND", 4) == 0) {
        done = true;
      }
      off += 12 + clen;
    }
    // Every row must come from the stream: one that ends short of raw_size
    // (Z_STREAM_END early) would leave its last rows to whatever the failed
    // fast path wrote there.
    const bool filled = (zs.avail_out == 0);
    inflateEnd(&zs);
    if (!filled) return -4;
  }

  // Unfilter rows in place, then emit into the caller buffer.
  uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < info.h; ++y) {
    uint8_t* rp = raw.data() + size_t(y) * (stride + 1);
    int f = rp[0];
    if (unfilter_row(f, rp + 1, prev, stride, bpp) != 0) return -4;
    prev = rp + 1;
  }
  if (info.bit_depth == 8) {
    for (uint32_t y = 0; y < info.h; ++y)
      std::memcpy(out + size_t(y) * stride,
                  raw.data() + size_t(y) * (stride + 1) + 1, stride);
  } else {
    // 16-bit: PNG is big-endian; emit host-endian u16.
    uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
    const size_t vals_per_row = size_t(info.w) * info.channels;
    for (uint32_t y = 0; y < info.h; ++y) {
      const uint8_t* rp = raw.data() + size_t(y) * (stride + 1) + 1;
      uint16_t* orow = o16 + size_t(y) * vals_per_row;
      for (size_t i = 0; i < vals_per_row; ++i)
        orow[i] = uint16_t((rp[2 * i] << 8) | rp[2 * i + 1]);
    }
  }
  return 0;
}

}  // extern "C"
