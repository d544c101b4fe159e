// Native stereo sample loader: threaded image decode + crop/pad into
// caller-provided float buffers, delivered in submission order.
//
// Port of real_time_self_adaptive_deep_stereo_tpu/runtime/stereo_loader.cc,
// with its C ABI (sl_create, sl_destroy, sl_submit, sl_next), its crops
// (centred crop or zero pad; training crops from std::mt19937_64(seed);
// the ground truth width-aligned to the left image) and its formats: PNG
// (8/16-bit; 16-bit divided by 256, KITTI's disparity encoding), JPEG,
// PFM (little/big endian), PGM/PPM binary. Added here: sl_route and
// sl_last_error, and decoders for machines without the image libraries.
//
// The route is picked at compile time from the headers the compiler finds:
//   SL_PNG_ROUTE 1  PNG through libpng (png.h), as the JAX package's loader;
//   SL_PNG_ROUTE 2  PNG through this file's own decoder on zlib's inflate
//                   (zlib.h): non-interlaced 8-bit grey, RGB, RGBA and
//                   16-bit grey, the five row filters (what data/png.py takes);
//   SL_PNG_ROUTE 3  the same decoder on this file's own RFC 1950/1951 inflate.
//   SL_HAVE_JPEG    1 with jpeglib.h; 0 fails a JPEG sample with an error
//                   that names the missing header.
// Test-only defines, which the tests use to hold routes 2 and 3 against
// libpng where png.h exists: SL_FORCE_OWN_PNG (route 2, or 3 without
// zlib.h) and SL_FORCE_OWN_INFLATE (with it: route 3); and
// SL_FORCE_NO_JPEG, to see a JPEG refused where jpeglib.h exists.
//
// Build (runtime/native.py does it, linking what the route needs):
//   g++ -O3 -fPIC -shared -std=c++17 stereo_loader.cc -o libstereo_loader.so
//       [-lpng] [-lz] [-ljpeg] -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#if !defined(SL_FORCE_OWN_PNG) && __has_include(<png.h>)
#define SL_PNG_ROUTE 1
#include <png.h>
#elif !defined(SL_FORCE_OWN_INFLATE) && __has_include(<zlib.h>)
#define SL_PNG_ROUTE 2
#include <zlib.h>
#else
#define SL_PNG_ROUTE 3
#endif

#if !defined(SL_FORCE_NO_JPEG) && __has_include(<jpeglib.h>)
#define SL_HAVE_JPEG 1
extern "C" {
#include <jpeglib.h>
}
#else
#define SL_HAVE_JPEG 0
#endif

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<float> data;  // HWC
  bool ok = false;
  std::string error;  // why it is not ok
};

const unsigned char kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

// ------------------------------------------------------------------ decode

#if SL_PNG_ROUTE == 1

Image decode_png(FILE* f) {
  Image img;
  img.error = "libpng could not decode the file";
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);

  int channels = png_get_channels(png, info);
  const bool sixteen = bit_depth == 16;
  std::vector<png_byte> row(png_get_rowbytes(png, info));

  img.h = (int)h;
  img.w = (int)w;
  img.c = channels;
  img.data.resize((size_t)h * w * channels);
  // 16-bit disparity PNGs decode to value/256 (KITTI), 8-bit stays raw.
  const float scale16 = 1.0f / 256.0f;
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = img.data.data() + (size_t)y * w * channels;
    if (sixteen) {
      for (size_t i = 0; i < (size_t)w * channels; ++i) {
        uint16_t v = (uint16_t)((row[2 * i] << 8) | row[2 * i + 1]);  // PNG is big-endian
        dst[i] = (float)v * scale16;
      }
    } else {
      for (size_t i = 0; i < (size_t)w * channels; ++i) dst[i] = (float)row[i];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  img.error.clear();
  return img;
}

#else  // SL_PNG_ROUTE 2 or 3: this file's own PNG decoder

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

#if SL_PNG_ROUTE == 2

// zlib stream -> exactly `want` bytes
std::vector<uint8_t> inflate_exact(const std::vector<uint8_t>& src, size_t want) {
  std::vector<uint8_t> out(want + 1);  // one spare byte tells "more than want" apart
  uLongf n = (uLongf)out.size();
  int rc = uncompress(out.data(), &n, src.data(), (uLong)src.size());
  if (rc == Z_BUF_ERROR && n == out.size()) throw DecodeError("image data larger than its header says");
  if (rc != Z_OK) throw DecodeError("zlib could not inflate the image data (code " + std::to_string(rc) + ")");
  if (n != want)
    throw DecodeError("image data holds " + std::to_string(n) + " bytes, want " + std::to_string(want));
  out.resize(want);
  return out;
}

#else  // SL_PNG_ROUTE 3: RFC 1950 (zlib wrapper) and RFC 1951 (deflate)

struct BitReader {
  const uint8_t* p;
  size_t n, pos = 0;
  uint32_t buf = 0;
  int cnt = 0;
  int bits(int need) {  // the next `need` bits, least significant first
    uint32_t v = buf;
    while (cnt < need) {
      if (pos >= n) throw DecodeError("deflate stream ends early");
      v |= (uint32_t)p[pos++] << cnt;
      cnt += 8;
    }
    buf = need < 32 ? v >> need : 0;
    cnt -= need;
    return (int)(v & ((1u << need) - 1u));
  }
};

struct Huffman {
  short count[16];   // codes of each length
  short symbol[320];  // symbols ordered by code
};

// canonical code from code lengths: 0 complete, > 0 incomplete, < 0 over-subscribed
int build_huffman(Huffman& h, const short* length, int n) {
  for (int len = 0; len < 16; ++len) h.count[len] = 0;
  for (int s = 0; s < n; ++s) h.count[length[s]]++;
  if (h.count[0] == n) return 0;
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return left;
  }
  short offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h.count[len];
  for (int s = 0; s < n; ++s)
    if (length[s] != 0) h.symbol[offs[length[s]]++] = (short)s;
  return left;
}

int decode_symbol(BitReader& s, const Huffman& h) {
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= s.bits(1);
    int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  throw DecodeError("invalid Huffman code in the deflate stream");
}

const short kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                            31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const short kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                             2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const short kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                             193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                             6145, 8193, 12289, 16385, 24577};
const short kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                              6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

void put(std::vector<uint8_t>& out, size_t want, uint8_t v) {
  if (out.size() >= want) throw DecodeError("image data larger than its header says");
  out.push_back(v);
}

void inflate_codes(BitReader& s, std::vector<uint8_t>& out, size_t want, const Huffman& lencode,
                   const Huffman& distcode) {
  for (;;) {
    int sym = decode_symbol(s, lencode);
    if (sym < 256) {
      put(out, want, (uint8_t)sym);
    } else if (sym == 256) {
      return;
    } else {
      sym -= 257;
      if (sym >= 29) throw DecodeError("invalid length code in the deflate stream");
      int len = kLenBase[sym] + s.bits(kLenExtra[sym]);
      int dsym = decode_symbol(s, distcode);
      if (dsym >= 30) throw DecodeError("invalid distance code in the deflate stream");
      size_t dist = (size_t)(kDistBase[dsym] + s.bits(kDistExtra[dsym]));
      if (dist > out.size()) throw DecodeError("deflate distance reaches before the data");
      for (int i = 0; i < len; ++i) put(out, want, out[out.size() - dist]);
    }
  }
}

std::vector<uint8_t> inflate_exact(const std::vector<uint8_t>& src, size_t want) {
  if (src.size() < 6) throw DecodeError("zlib stream too short");
  const int cmf = src[0], flg = src[1];
  if ((cmf & 15) != 8 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20))
    throw DecodeError("not a zlib stream of deflate data without a dictionary");
  BitReader s{src.data() + 2, src.size() - 2};
  std::vector<uint8_t> out;
  out.reserve(want);
  short lengths[320];
  Huffman lencode, distcode;
  int last;
  do {
    last = s.bits(1);
    int type = s.bits(2);
    if (type == 0) {  // stored: whole bytes after dropping the partial one
      s.buf = 0;
      s.cnt = 0;
      if (s.pos + 4 > s.n) throw DecodeError("deflate stream ends early");
      unsigned len = s.p[s.pos] | (s.p[s.pos + 1] << 8);
      unsigned nlen = s.p[s.pos + 2] | (s.p[s.pos + 3] << 8);
      s.pos += 4;
      if (len != (~nlen & 0xffffu)) throw DecodeError("stored deflate block with a bad length");
      if (s.pos + len > s.n) throw DecodeError("deflate stream ends early");
      for (unsigned i = 0; i < len; ++i) put(out, want, s.p[s.pos + i]);
      s.pos += len;
    } else if (type == 1) {  // fixed codes
      int sym = 0;
      for (; sym < 144; ++sym) lengths[sym] = 8;
      for (; sym < 256; ++sym) lengths[sym] = 9;
      for (; sym < 280; ++sym) lengths[sym] = 7;
      for (; sym < 288; ++sym) lengths[sym] = 8;
      build_huffman(lencode, lengths, 288);
      for (sym = 0; sym < 30; ++sym) lengths[sym] = 5;
      build_huffman(distcode, lengths, 30);
      inflate_codes(s, out, want, lencode, distcode);
    } else if (type == 2) {  // dynamic codes
      static const short order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
      int nlen = s.bits(5) + 257, ndist = s.bits(5) + 1, ncode = s.bits(4) + 4;
      if (nlen > 286 || ndist > 30) throw DecodeError("bad code counts in the deflate stream");
      int i = 0;
      for (; i < ncode; ++i) lengths[order[i]] = (short)s.bits(3);
      for (; i < 19; ++i) lengths[order[i]] = 0;
      if (build_huffman(lencode, lengths, 19) != 0) throw DecodeError("bad code-length code in the deflate stream");
      i = 0;
      while (i < nlen + ndist) {
        int sym = decode_symbol(s, lencode);
        if (sym < 16) {
          lengths[i++] = (short)sym;
          continue;
        }
        short len = 0;
        int repeat;
        if (sym == 16) {
          if (i == 0) throw DecodeError("repeat with no length before it in the deflate stream");
          len = lengths[i - 1];
          repeat = 3 + s.bits(2);
        } else if (sym == 17) {
          repeat = 3 + s.bits(3);
        } else {
          repeat = 11 + s.bits(7);
        }
        if (i + repeat > nlen + ndist) throw DecodeError("too many lengths in the deflate stream");
        while (repeat--) lengths[i++] = len;
      }
      if (lengths[256] == 0) throw DecodeError("no end-of-block code in the deflate stream");
      int err = build_huffman(lencode, lengths, nlen);
      if (err < 0 || (err > 0 && nlen - lencode.count[0] != 1))
        throw DecodeError("bad literal/length code in the deflate stream");
      err = build_huffman(distcode, lengths + nlen, ndist);
      if (err < 0 || (err > 0 && ndist - distcode.count[0] != 1))
        throw DecodeError("bad distance code in the deflate stream");
      inflate_codes(s, out, want, lencode, distcode);
    } else {
      throw DecodeError("deflate block of reserved type 3");
    }
  } while (!last);
  if (out.size() != want)
    throw DecodeError("image data holds " + std::to_string(out.size()) + " bytes, want " + std::to_string(want));
  // Adler-32 of the data, big-endian, after the deflate stream's last whole byte
  uint32_t a = 1, b = 0;
  for (uint8_t v : out) {
    a = (a + v) % 65521u;
    b = (b + a) % 65521u;
  }
  if (s.pos + 4 > s.n || be32(s.p + s.pos) != ((b << 16) | a)) throw DecodeError("zlib checksum mismatch");
  return out;
}

#endif  // SL_PNG_ROUTE == 3

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

Image decode_png_bytes(const std::vector<uint8_t>& file) {
  Image img;
  size_t pos = 8;
  bool have_header = false, ended = false;
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 12 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    const uint8_t* kind = &file[pos + 4];
    if (pos + 12 + (size_t)len > file.size()) break;
    const uint8_t* body = &file[pos + 8];
    if (!memcmp(kind, "IHDR", 4) && len >= 13) {
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
      have_header = true;
    } else if (!memcmp(kind, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(kind, "IEND", 4)) {
      ended = true;
      break;
    }
    pos += 12 + (size_t)len;
  }
  if (!ended) throw DecodeError("truncated PNG (no IEND chunk)");
  if (!have_header || idat.empty()) throw DecodeError("PNG without IHDR or IDAT");
  if (interlace) throw DecodeError("interlaced PNGs are not supported");
  const int channels = color == 0 ? 1 : color == 2 ? 3 : color == 6 ? 4 : 0;
  if (!channels)
    throw DecodeError("PNG colour type " + std::to_string(color) +
                      " is not supported (grey, RGB and RGBA only)");
  if (!(depth == 8 || (depth == 16 && channels == 1)))
    throw DecodeError(std::to_string(depth) + "-bit PNG of colour type " + std::to_string(color) +
                      " is not supported (8-bit grey, RGB, RGBA and 16-bit grey only)");
  const size_t bpp = (size_t)channels * depth / 8, stride = (size_t)w * bpp;
  std::vector<uint8_t> raw = inflate_exact(idat, (stride + 1) * h);
  std::vector<uint8_t> zero(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* cur = &raw[y * (stride + 1) + 1];
    const uint8_t* prev = y ? &raw[(y - 1) * (stride + 1) + 1] : zero.data();
    const int filter = cur[-1];
    switch (filter) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(cur[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(cur[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        throw DecodeError("unknown PNG row filter " + std::to_string(filter));
    }
  }
  img.h = (int)h;
  img.w = (int)w;
  img.c = channels;
  img.data.resize((size_t)h * w * channels);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* row = &raw[y * (stride + 1) + 1];
    float* dst = img.data.data() + (size_t)y * w * channels;
    if (depth == 16) {  // big-endian; value/256 (KITTI), as libpng's route
      for (size_t i = 0; i < (size_t)w; ++i) dst[i] = (float)((row[2 * i] << 8) | row[2 * i + 1]) / 256.0f;
    } else {
      for (size_t i = 0; i < stride; ++i) dst[i] = (float)row[i];
    }
  }
  img.ok = true;
  return img;
}

Image decode_png(FILE* f) {
  std::vector<uint8_t> file(kPngSignature, kPngSignature + 8);  // already read and checked
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = fread(chunk, 1, sizeof(chunk), f)) > 0) file.insert(file.end(), chunk, chunk + n);
  try {
    return decode_png_bytes(file);
  } catch (const std::exception& e) {
    Image img;
    img.error = e.what();
    return img;
  }
}

#endif  // SL_PNG_ROUTE

#if SL_HAVE_JPEG
Image decode_jpeg(FILE* f) {
  Image img;
  img.error = "libjpeg could not decode the file";
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  jpeg_start_decompress(&cinfo);
  img.h = cinfo.output_height;
  img.w = cinfo.output_width;
  img.c = cinfo.output_components;
  img.data.resize((size_t)img.h * img.w * img.c);
  std::vector<unsigned char> row((size_t)img.w * img.c);
  unsigned char* rp = row.data();
  for (int y = 0; y < img.h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = img.data.data() + (size_t)y * img.w * img.c;
    for (size_t i = 0; i < row.size(); ++i) dst[i] = (float)row[i];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  img.error.clear();
  return img;
}
#else
Image decode_jpeg(FILE*) {
  Image img;
  img.error = "JPEG needs jpeglib.h, which this build of the loader did not find";
  return img;
}
#endif

Image decode_pfm(FILE* f) {
  Image img;
  img.error = "bad PFM file";
  char header[3] = {0};
  if (fscanf(f, "%2s", header) != 1) return img;
  int channels = 0;
  if (strcmp(header, "PF") == 0) channels = 3;
  else if (strcmp(header, "Pf") == 0) channels = 1;
  else return img;
  int w, h;
  double scale;
  if (fscanf(f, "%d %d %lf", &w, &h, &scale) != 3) return img;
  fgetc(f);  // single whitespace after header
  const bool little = scale < 0;
  img.h = h;
  img.w = w;
  img.c = channels;
  img.data.resize((size_t)h * w * channels);
  std::vector<float> rowbuf((size_t)w * channels);
  // PFM rows are bottom-to-top
  for (int y = h - 1; y >= 0; --y) {
    if (fread(rowbuf.data(), sizeof(float), rowbuf.size(), f) != rowbuf.size()) return img;
    if (!little) {
      for (auto& v : rowbuf) {
        uint32_t u;
        memcpy(&u, &v, 4);
        u = __builtin_bswap32(u);
        memcpy(&v, &u, 4);
      }
    }
    memcpy(img.data.data() + (size_t)y * w * channels, rowbuf.data(),
           rowbuf.size() * sizeof(float));
  }
  img.ok = true;
  img.error.clear();
  return img;
}

Image decode_pnm(FILE* f) {  // binary PGM (P5) / PPM (P6)
  Image img;
  img.error = "bad PGM/PPM file";
  char header[3] = {0};
  if (fscanf(f, "%2s", header) != 1) return img;
  int channels = 0;
  if (strcmp(header, "P5") == 0) channels = 1;
  else if (strcmp(header, "P6") == 0) channels = 3;
  else return img;
  int w, h, maxv;
  if (fscanf(f, "%d %d %d", &w, &h, &maxv) != 3) return img;
  fgetc(f);
  img.h = h;
  img.w = w;
  img.c = channels;
  img.data.resize((size_t)h * w * channels);
  if (maxv < 256) {
    std::vector<unsigned char> buf((size_t)h * w * channels);
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) return img;
    for (size_t i = 0; i < buf.size(); ++i) img.data[i] = (float)buf[i];
  } else {
    std::vector<uint16_t> buf((size_t)h * w * channels);
    if (fread(buf.data(), 2, buf.size(), f) != buf.size()) return img;
    for (size_t i = 0; i < buf.size(); ++i)
      img.data[i] = (float)(uint16_t)((buf[i] >> 8) | (buf[i] << 8)) / 256.0f;
  }
  img.ok = true;
  img.error.clear();
  return img;
}

Image load_image_file(const std::string& path) {
  Image img;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    img.error = path + ": cannot open the file";
    return img;
  }
  unsigned char sig[8] = {0};
  size_t n = fread(sig, 1, 8, f);
  if (n >= 8 && memcmp(sig, kPngSignature, 8) == 0) {
    img = decode_png(f);  // stream already positioned after signature
  } else {
    rewind(f);
    if (n >= 2 && sig[0] == 0xFF && sig[1] == 0xD8) img = decode_jpeg(f);
    else if (n >= 2 && sig[0] == 'P' && (sig[1] == 'F' || sig[1] == 'f')) img = decode_pfm(f);
    else if (n >= 2 && sig[0] == 'P' && (sig[1] == '5' || sig[1] == '6')) img = decode_pnm(f);
    else img.error = "not a PNG, JPEG, PFM or PGM/PPM file";
  }
  fclose(f);
  if (!img.ok) img.error = path + ": " + img.error;
  return img;
}

// ------------------------------------------------------------- crop / pad

// centered crop-or-zero-pad to (th, tw) with `tc` output channels
// (replicates gray->RGB, drops alpha)
void crop_or_pad(const Image& src, float* dst, int th, int tw, int tc) {
  memset(dst, 0, (size_t)th * tw * tc * sizeof(float));
  int sy = src.h > th ? (src.h - th) / 2 : 0;
  int sx = src.w > tw ? (src.w - tw) / 2 : 0;
  int dy = src.h < th ? (th - src.h) / 2 : 0;
  int dx = src.w < tw ? (tw - src.w) / 2 : 0;
  int ch = std::min(src.h - sy, th - dy);
  int cw = std::min(src.w - sx, tw - dx);
  for (int y = 0; y < ch; ++y) {
    const float* srow = src.data.data() + ((size_t)(sy + y) * src.w + sx) * src.c;
    float* drow = dst + ((size_t)(dy + y) * tw + dx) * tc;
    for (int x = 0; x < cw; ++x) {
      for (int c = 0; c < tc; ++c) {
        int sc = src.c == 1 ? 0 : std::min(c, src.c - 1);
        drow[(size_t)x * tc + c] = srow[(size_t)x * src.c + sc];
      }
    }
  }
}

// aligned random crop at (r0, c0)
void crop_at(const Image& src, float* dst, int th, int tw, int tc, int r0, int c0) {
  for (int y = 0; y < th; ++y) {
    int sy = std::min(r0 + y, src.h - 1);
    const float* srow = src.data.data() + ((size_t)sy * src.w) * src.c;
    float* drow = dst + ((size_t)y * tw) * tc;
    for (int x = 0; x < tw; ++x) {
      int sx = std::min(c0 + x, src.w - 1);
      for (int c = 0; c < tc; ++c) {
        int sc = src.c == 1 ? 0 : std::min(c, src.c - 1);
        drow[(size_t)x * tc + c] = srow[(size_t)sx * src.c + sc];
      }
    }
  }
}

// keep the first `w` columns. The JAX package's loader lowers gt.w alone,
// and so reads a ground truth wider than its image with the wrong row stride.
void narrow(Image& img, int w) {
  if (img.w <= w) return;
  for (int y = 0; y < img.h; ++y)
    memmove(img.data.data() + (size_t)y * w * img.c, img.data.data() + (size_t)y * img.w * img.c,
            (size_t)w * img.c * sizeof(float));
  img.w = w;
  img.data.resize((size_t)img.h * w * img.c);
}

// ------------------------------------------------------------------ loader

struct Job {
  long id;
  std::string left, right, gt, proxy;
  int crop_h, crop_w;
  bool train;
  uint64_t seed;
};

struct Result {
  long id;
  int real_width = -1;  // -1 => decode error
  std::vector<float> left, right, gt, proxy;
  bool has_proxy = false;
  std::string error;
};

struct Loader {
  std::vector<std::thread> workers;
  std::deque<Job> jobs;
  std::map<long, Result> done;
  long next_submit = 0;
  long next_deliver = 0;
  size_t capacity;
  bool shutdown = false;
  std::string last_error;  // of the last sample sl_next failed
  std::mutex mu;
  std::condition_variable cv_job, cv_done, cv_space;

  explicit Loader(int n_workers, size_t cap) : capacity(cap) {
    for (int i = 0; i < n_workers; ++i)
      workers.emplace_back([this] { this->work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv_job.notify_all();
    cv_done.notify_all();
    cv_space.notify_all();
    for (auto& t : workers) t.join();
  }

  void work() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return shutdown || !jobs.empty(); });
        if (shutdown) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      Result res;
      res.id = job.id;
      process(job, res);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[res.id] = std::move(res);
      }
      cv_done.notify_all();
    }
  }

  static void process(const Job& job, Result& res) {
    Image left = load_image_file(job.left);
    if (!left.ok) {
      res.error = left.error;
      return;
    }
    Image right = load_image_file(job.right);
    if (!right.ok) {
      res.error = right.error;
      return;
    }
    Image gt;
    if (!job.gt.empty()) {
      gt = load_image_file(job.gt);
      if (!gt.ok) {
        res.error = gt.error;
        return;
      }
      narrow(gt, left.w);  // width-align (data_reader.py:145)
    } else {
      gt.h = left.h; gt.w = left.w; gt.c = 1;
      gt.data.assign((size_t)gt.h * gt.w, 0.0f);
      gt.ok = true;
    }
    Image proxy;
    if (!job.proxy.empty()) {
      proxy = load_image_file(job.proxy);
      if (!proxy.ok) {
        res.error = proxy.error;
        return;
      }
      res.has_proxy = true;
    }

    const int th = job.crop_h, tw = job.crop_w;
    res.left.resize((size_t)th * tw * 3);
    res.right.resize((size_t)th * tw * 3);
    res.gt.resize((size_t)th * tw);
    if (res.has_proxy) res.proxy.resize((size_t)th * tw);

    if (job.train) {
      std::mt19937_64 rng(job.seed);
      int max_r = std::max(left.h - th - 1, 1);
      int max_c = std::max(left.w - tw - 1, 1);
      int r0 = (int)(rng() % (uint64_t)max_r);
      int c0 = (int)(rng() % (uint64_t)max_c);
      crop_at(left, res.left.data(), th, tw, 3, r0, c0);
      crop_at(right, res.right.data(), th, tw, 3, r0, c0);
      crop_at(gt, res.gt.data(), th, tw, 1, r0, c0);
      if (res.has_proxy) crop_at(proxy, res.proxy.data(), th, tw, 1, r0, c0);
    } else {
      crop_or_pad(left, res.left.data(), th, tw, 3);
      crop_or_pad(right, res.right.data(), th, tw, 3);
      crop_or_pad(gt, res.gt.data(), th, tw, 1);
      if (res.has_proxy) crop_or_pad(proxy, res.proxy.data(), th, tw, 1);
    }
    res.real_width = left.w;
  }
};

}  // namespace

extern "C" {

void* sl_create(int workers, int capacity) {
  return new Loader(std::max(1, workers), (size_t)std::max(1, capacity));
}

void sl_destroy(void* p) { delete (Loader*)p; }

// Enqueue a sample; blocks if the pipeline is full. Returns the job id.
long sl_submit(void* p, const char* left, const char* right, const char* gt,
               const char* proxy, int crop_h, int crop_w, int train,
               uint64_t seed) {
  Loader* L = (Loader*)p;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_space.wait(lk, [&] {
    return L->shutdown ||
           (L->next_submit - L->next_deliver) < (long)L->capacity;
  });
  if (L->shutdown) return -1;
  long id = L->next_submit++;
  L->jobs.push_back(Job{id, left, right, gt ? gt : "", proxy ? proxy : "",
                        crop_h, crop_w, train != 0, seed});
  lk.unlock();
  L->cv_job.notify_one();
  return id;
}

// Blocks until the next sample (submission order) is decoded; copies it
// into the caller's buffers. Returns real_width, or -1 on decode error
// (sl_last_error says why), -2 on shutdown. has_proxy_out is set to 0/1.
int sl_next(void* p, float* left, float* right, float* gt, float* proxy,
            int* has_proxy_out) {
  Loader* L = (Loader*)p;
  Result res;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    long want = L->next_deliver;
    L->cv_done.wait(lk, [&] { return L->shutdown || L->done.count(want); });
    if (L->shutdown && !L->done.count(want)) return -2;
    res = std::move(L->done[want]);
    L->done.erase(want);
    L->next_deliver++;
    if (res.real_width < 0) L->last_error = res.error;
  }
  L->cv_space.notify_all();
  if (res.real_width < 0) return -1;
  memcpy(left, res.left.data(), res.left.size() * sizeof(float));
  memcpy(right, res.right.data(), res.right.size() * sizeof(float));
  memcpy(gt, res.gt.data(), res.gt.size() * sizeof(float));
  if (has_proxy_out) *has_proxy_out = res.has_proxy ? 1 : 0;
  if (res.has_proxy && proxy)
    memcpy(proxy, res.proxy.data(), res.proxy.size() * sizeof(float));
  return res.real_width;
}

// The message of the last sample sl_next returned -1 for, into buf (n bytes).
void sl_last_error(void* p, char* buf, int n) {
  Loader* L = (Loader*)p;
  std::lock_guard<std::mutex> lk(L->mu);
  snprintf(buf, (size_t)std::max(n, 1), "%s", L->last_error.c_str());
}

// The decode route this library was built with (see the top of the file).
const char* sl_route() {
#if SL_PNG_ROUTE == 1
  const char* png = "PNG by libpng";
#elif SL_PNG_ROUTE == 2
  const char* png = "PNG by the loader's own decoder on zlib's inflate";
#else
  const char* png = "PNG by the loader's own decoder and inflate";
#endif
  static const std::string route =
      std::string(png) + (SL_HAVE_JPEG ? ", JPEG by libjpeg" : ", no JPEG (jpeglib.h missing)");
  return route.c_str();
}

}  // extern "C"
