// Native image decoding for the dataset layer.
//
// The reference's message/dataset layer is C++ (srrg2_core message sources +
// OpenCV imread; reference srrg2_proslam configurations/kitti.conf:617-745,
// apps/convert_stereo_to_srrg2.cpp).  This library is the JAX framework's
// native equivalent: a dependency-free PNG (zlib) + PGM/PPM decoder used by
// the prefetching dataset reader (prefetcher.cpp) so image decode never
// blocks the device feed.
//
// Supported: PNG non-interlaced, bit depth 8/16, color types gray(0),
// RGB(2), gray+alpha(4), RGBA(6) — covers KITTI/EuRoC (8-bit gray),
// TUM rgb (8-bit RGB), TUM/ICL depth (16-bit gray) — and binary PGM/PPM
// with maxval up to 65535 (the reference's bundled ICL/xtion depth images).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

// Returns malloc'd pixel buffer (row-major, channels interleaved, 16-bit
// values in host byte order) or nullptr.
uint8_t* decode_png(const std::vector<uint8_t>& file, int* w, int* h,
                    int* channels, int* bitdepth) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || std::memcmp(file.data(), sig, 8) != 0) return nullptr;

  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;

  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    if (pos + 12 + len > file.size()) return nullptr;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return nullptr;
      width = be32(data);
      height = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!width || !height || interlace != 0) return nullptr;
  if (depth != 8 && depth != 16) return nullptr;
  int nch;
  switch (color) {
    case 0: nch = 1; break;  // gray
    case 2: nch = 3; break;  // rgb
    case 4: nch = 2; break;  // gray+alpha
    case 6: nch = 4; break;  // rgba
    default: return nullptr;  // palette unsupported
  }

  const size_t bytes_per_px = size_t(nch) * (depth / 8);
  const size_t stride = size_t(width) * bytes_per_px;
  std::vector<uint8_t> raw(height * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return nullptr;
  }

  uint8_t* out = static_cast<uint8_t*>(std::malloc(height * stride));
  if (!out) return nullptr;
  const int bpp = static_cast<int>(bytes_per_px);
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* cur = src + 1;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y ? out + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = (x >= size_t(bpp)) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = cur[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          std::free(out);
          return nullptr;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }

  // 16-bit PNG samples are big-endian; swap into host (little) order
  if (depth == 16) {
    for (size_t i = 0; i + 1 < height * stride; i += 2) {
      std::swap(out[i], out[i + 1]);
    }
  }
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  *channels = nch;
  *bitdepth = depth;
  return out;
}

// ---------------------------------------------------------------------------
// PGM / PPM (binary P5 / P6)
// ---------------------------------------------------------------------------

bool pnm_token(const std::vector<uint8_t>& f, size_t& pos, long* value) {
  // skip whitespace + comments
  while (pos < f.size()) {
    if (f[pos] == '#') {
      while (pos < f.size() && f[pos] != '\n') ++pos;
    } else if (std::isspace(f[pos])) {
      ++pos;
    } else {
      break;
    }
  }
  long v = 0;
  bool any = false;
  while (pos < f.size() && std::isdigit(f[pos])) {
    v = v * 10 + (f[pos] - '0');
    ++pos;
    any = true;
  }
  *value = v;
  return any;
}

uint8_t* decode_pnm(const std::vector<uint8_t>& file, int* w, int* h,
                    int* channels, int* bitdepth) {
  if (file.size() < 2 || file[0] != 'P') return nullptr;
  int nch;
  if (file[1] == '5') nch = 1;
  else if (file[1] == '6') nch = 3;
  else return nullptr;
  size_t pos = 2;
  long width, height, maxval;
  if (!pnm_token(file, pos, &width) || !pnm_token(file, pos, &height) ||
      !pnm_token(file, pos, &maxval)) {
    return nullptr;
  }
  ++pos;  // single whitespace after maxval
  int depth = maxval > 255 ? 16 : 8;
  size_t stride = size_t(width) * nch * (depth / 8);
  size_t need = stride * height;
  if (pos + need > file.size()) return nullptr;
  uint8_t* out = static_cast<uint8_t*>(std::malloc(need));
  if (!out) return nullptr;
  if (depth == 16) {
    // PNM 16-bit is big-endian; swap to host order
    const uint8_t* src = &file[pos];
    for (size_t i = 0; i + 1 < need; i += 2) {
      out[i] = src[i + 1];
      out[i + 1] = src[i];
    }
  } else {
    std::memcpy(out, &file[pos], need);
  }
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  *channels = nch;
  *bitdepth = depth;
  return out;
}

}  // namespace

extern "C" {

// Decode any supported image file.  Returns a malloc'd interleaved pixel
// buffer (16-bit samples in host order) or nullptr; caller frees with
// psl_free.
uint8_t* psl_decode_file(const char* path, int* w, int* h, int* channels,
                         int* bitdepth) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) return nullptr;
  if (file.size() >= 8 && file[0] == 137 && file[1] == 'P') {
    return decode_png(file, w, h, channels, bitdepth);
  }
  if (file.size() >= 2 && file[0] == 'P') {
    return decode_pnm(file, w, h, channels, bitdepth);
  }
  return nullptr;
}

void psl_free(void* p) { std::free(p); }

}  // extern "C"
