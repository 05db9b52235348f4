// Native image IO + undistortion (C++17, no external deps).
//
// A copy of gaussctrl_exp_tpu/native/imageio.cpp for the PyTorch port, whose
// loader builds it with g++ and binds it with ctypes
// (gaussctrl_exp_tpu_torch/native/__init__.py). It replaces the image decode
// and OpenCV undistort of the reference's data caching
// (gc_datamanager.py:112-186, through nerfstudio's _undistort_image). One
// `load_undistort_batch` call decodes + undistorts a whole scene's views on a
// std::thread pool and writes the float32 (V,H,W,3) cache the DataManager
// serves. Every other image read, write and resize of the port calls Pillow,
// as the JAX package does.
//
//   * JPEG: baseline sequential (SOF0/SOF1), canonical Huffman, restart
//     markers, 4:4:4 / 4:2:2 / 4:2:0 / grayscale, AAN float IDCT,
//     center-aligned triangle chroma upsampling (libjpeg "fancy" equivalent).
//     Progressive JPEGs return an error and the Python side falls back to PIL.
//   * Undistort: inverse-map remap under the OPENCV rational model subset the
//     scenes use — radial (1+k1r²+k2r⁴+k3r⁶)/(1+k4r²) + tangential p1,p2 —
//     bilinear sampling, constant-black border (OpenCV undistort semantics).
//
// Held against the JAX package's build of the same source in
// tests/test_torch_data.py.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG baseline decoder
// ---------------------------------------------------------------------------

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  // canonical decode state: per code length 1..16
  int32_t mincode[17];
  int32_t maxcode[18];  // maxcode[l] = largest code of length l (-1 if none)
  int32_t valptr[17];
  uint8_t vals[256];
  bool present = false;

  void build(const uint8_t counts[16], const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    int32_t code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct BitReader {
  const uint8_t* data;
  size_t size, pos;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;  // saw a non-stuffed marker: feed zero bits

  explicit BitReader(const uint8_t* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

  void align() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
  }

  int next_byte() {
    if (hit_marker || pos >= size) return -1;
    uint8_t b = data[pos++];
    if (b == 0xFF) {
      if (pos < size && data[pos] == 0x00) {
        pos++;  // stuffed
        return 0xFF;
      }
      pos--;  // leave marker for the scan loop
      hit_marker = true;
      return -1;
    }
    return b;
  }

  int get_bit() {
    if (bitcnt == 0) {
      int b = next_byte();
      if (b < 0) return 0;  // pad with zeros past marker (libjpeg behavior)
      bitbuf = (uint32_t)b;
      bitcnt = 8;
    }
    bitcnt--;
    return (bitbuf >> bitcnt) & 1;
  }

  int32_t get_bits(int n) {
    int32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | get_bit();
    return v;
  }

  int decode(const HuffTable& t) {
    int32_t code = get_bit();
    int l = 1;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bit();
      if (++l > 16) return -1;
    }
    return t.vals[t.valptr[l] + (code - t.mincode[l])];
  }
};

inline int32_t extend(int32_t v, int s) {
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

// AAN float inverse DCT (the scaled 8x8 float algorithm of Arai-Agui-Nakajima):
// dequant tables are pre-scaled by the aan factors and the 1/8 descale.
// 1D butterfly over a strided 8-vector; correctness pinned by idct_test vs a
// brute-force DCT-III in tests/test_native.py.
inline void idct_aan_1d(const float* in, int is, float* out, int os) {
  float t0 = in[0], t1 = in[2 * is], t2 = in[4 * is], t3 = in[6 * is];
  float a10 = t0 + t2, a11 = t0 - t2;
  float a13 = t1 + t3, a12 = (t1 - t3) * 1.414213562f - a13;
  t0 = a10 + a13;
  t3 = a10 - a13;
  t1 = a11 + a12;
  t2 = a11 - a12;
  float i1 = in[is], i3 = in[3 * is], i5 = in[5 * is], i7 = in[7 * is];
  float z13 = i5 + i3, z10 = i5 - i3, z11 = i1 + i7, z12 = i1 - i7;
  float t7 = z11 + z13;
  float t11 = (z11 - z13) * 1.414213562f;
  float z5 = (z10 + z12) * 1.847759065f;
  float t10 = 1.082392200f * z12 - z5;
  float t12 = -2.613125930f * z10 + z5;
  float t6 = t12 - t7;
  float t5 = t11 - t6;
  float t4 = t10 + t5;
  out[0] = t0 + t7;
  out[7 * os] = t0 - t7;
  out[os] = t1 + t6;
  out[6 * os] = t1 - t6;
  out[2 * os] = t2 + t5;
  out[5 * os] = t2 - t5;
  out[3 * os] = t3 - t4;
  out[4 * os] = t3 + t4;
}

void idct_aan(const float in[64], float out[64]) {
  float ws[64];
  for (int c = 0; c < 8; c++) idct_aan_1d(in + c, 8, ws + c, 8);
  for (int r = 0; r < 8; r++) idct_aan_1d(ws + r * 8, 1, out + r * 8, 1);
}

const double kAan[8] = {1.0,
                        1.387039845322148,
                        1.306562964876377,
                        1.175875602419359,
                        1.0,
                        0.785694958387102,
                        0.541196100146197,
                        0.275899379282943};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int plane_w = 0, plane_h = 0;   // padded to MCU grid
  int used_w = 0, used_h = 0;     // ceil(W*h/Hmax), ceil(H*v/Vmax)
  std::vector<float> plane;
  int32_t dc_pred = 0;
};

struct JpegImage {
  int width = 0, height = 0, ncomp = 0;
  std::vector<uint8_t> rgb;  // width*height*3
};

// Decode a baseline JPEG from memory. Returns empty on failure/unsupported.
bool decode_jpeg(const uint8_t* buf, size_t n, JpegImage& img, std::string& err) {
  if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8) {
    err = "not a JPEG";
    return false;
  }
  float qtab[4][64];  // dequant pre-scaled by AAN factors, in raster order
  bool qset[4] = {false, false, false, false};
  HuffTable hdc[4], hac[4];
  Component comp[4];
  int ncomp = 0, W = 0, H = 0, Hmax = 1, Vmax = 1;
  int restart_interval = 0;
  bool have_sof = false;

  size_t p = 2;
  while (p + 4 <= n) {
    if (buf[p] != 0xFF) {
      p++;
      continue;
    }
    uint8_t m = buf[p + 1];
    if (m == 0xFF) {
      p++;
      continue;
    }
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
      p += 2;
      continue;
    }
    if (m == 0xD9) break;  // EOI
    size_t len = ((size_t)buf[p + 2] << 8) | buf[p + 3];
    size_t seg = p + 2, segend = p + 2 + len;
    if (segend > n) {
      err = "truncated segment";
      return false;
    }
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xC3 || m == 0xC5 || m == 0xC7 ||
        m == 0xC9 || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF) {
      err = "unsupported SOF (progressive/lossless/arithmetic)";
      return false;
    }
    if (m == 0xC0 || m == 0xC1) {  // SOF0/1 baseline
      int prec = buf[seg + 2];
      if (prec != 8) {
        err = "unsupported precision";
        return false;
      }
      H = (buf[seg + 3] << 8) | buf[seg + 4];
      W = (buf[seg + 5] << 8) | buf[seg + 6];
      ncomp = buf[seg + 7];
      if (ncomp != 1 && ncomp != 3) {
        err = "unsupported component count";
        return false;
      }
      for (int c = 0; c < ncomp; c++) {
        comp[c].id = buf[seg + 8 + c * 3];
        comp[c].h = buf[seg + 9 + c * 3] >> 4;
        comp[c].v = buf[seg + 9 + c * 3] & 15;
        comp[c].tq = buf[seg + 10 + c * 3];
        if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4) {
          err = "bad sampling";
          return false;
        }
        Hmax = std::max(Hmax, comp[c].h);
        Vmax = std::max(Vmax, comp[c].v);
      }
      have_sof = true;
    } else if (m == 0xC4) {  // DHT
      size_t q = seg + 2;
      while (q + 17 <= segend) {
        int tc = buf[q] >> 4, th = buf[q] & 15;
        if (th > 3) {
          err = "bad DHT id";
          return false;
        }
        uint8_t counts[16];
        int nv = 0;
        for (int i = 0; i < 16; i++) {
          counts[i] = buf[q + 1 + i];
          nv += counts[i];
        }
        if (q + 17 + nv > segend || nv > 256) {
          err = "bad DHT";
          return false;
        }
        (tc ? hac[th] : hdc[th]).build(counts, buf + q + 17, nv);
        q += 17 + nv;
      }
    } else if (m == 0xDB) {  // DQT
      size_t q = seg + 2;
      while (q < segend) {
        int pq = buf[q] >> 4, tq = buf[q] & 15;
        if (tq > 3) {
          err = "bad DQT id";
          return false;
        }
        q++;
        for (int i = 0; i < 64; i++) {
          int v = pq ? ((buf[q] << 8) | buf[q + 1]) : buf[q];
          q += pq ? 2 : 1;
          int rast = kZigzag[i];
          qtab[tq][rast] = (float)(v * kAan[rast / 8] * kAan[rast % 8] * 0.125);
        }
        qset[tq] = true;
      }
    } else if (m == 0xDD) {  // DRI
      restart_interval = (buf[seg + 2] << 8) | buf[seg + 3];
    } else if (m == 0xDA) {  // SOS
      if (!have_sof) {
        err = "SOS before SOF";
        return false;
      }
      int ns = buf[seg + 2];
      if (ns != ncomp) {
        err = "non-interleaved scan unsupported";
        return false;
      }
      for (int s = 0; s < ns; s++) {
        int cid = buf[seg + 3 + s * 2];
        int tt = buf[seg + 4 + s * 2];
        for (int c = 0; c < ncomp; c++)
          if (comp[c].id == cid) {
            comp[c].td = tt >> 4;
            comp[c].ta = tt & 15;
          }
      }
      // allocate planes
      int mcux = (W + 8 * Hmax - 1) / (8 * Hmax);
      int mcuy = (H + 8 * Vmax - 1) / (8 * Vmax);
      for (int c = 0; c < ncomp; c++) {
        comp[c].plane_w = mcux * 8 * comp[c].h;
        comp[c].plane_h = mcuy * 8 * comp[c].v;
        comp[c].used_w = (W * comp[c].h + Hmax - 1) / Hmax;
        comp[c].used_h = (H * comp[c].v + Vmax - 1) / Vmax;
        comp[c].plane.assign((size_t)comp[c].plane_w * comp[c].plane_h, 0.f);
        comp[c].dc_pred = 0;
        if (!qset[comp[c].tq] || !hdc[comp[c].td].present || !hac[comp[c].ta].present) {
          err = "missing tables";
          return false;
        }
      }
      BitReader br(buf, n, segend);
      float coef[64], pix[64];
      int mcu_count = 0;
      for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && mcu_count == restart_interval) {
            // byte-align and consume RSTn
            br.align();
            if (br.pos + 1 < br.size && br.data[br.pos] == 0xFF &&
                br.data[br.pos + 1] >= 0xD0 && br.data[br.pos + 1] <= 0xD7)
              br.pos += 2;
            for (int c = 0; c < ncomp; c++) comp[c].dc_pred = 0;
            mcu_count = 0;
          }
          for (int c = 0; c < ncomp; c++) {
            Component& co = comp[c];
            const float* qt = qtab[co.tq];
            for (int by = 0; by < co.v; by++) {
              for (int bx = 0; bx < co.h; bx++) {
                std::memset(coef, 0, sizeof(coef));
                int s = br.decode(hdc[co.td]);
                if (s < 0) {
                  err = "huffman error";
                  return false;
                }
                int32_t diff = extend(br.get_bits(s), s);
                co.dc_pred += diff;
                coef[0] = co.dc_pred * qt[0];
                for (int k = 1; k < 64;) {
                  int rs = br.decode(hac[co.ta]);
                  if (rs < 0) {
                    err = "huffman error";
                    return false;
                  }
                  int r = rs >> 4, sz = rs & 15;
                  if (sz == 0) {
                    if (r != 15) break;
                    k += 16;
                    continue;
                  }
                  k += r;
                  if (k > 63) break;
                  int rast = kZigzag[k];
                  coef[rast] = extend(br.get_bits(sz), sz) * qt[rast];
                  k++;
                }
                idct_aan(coef, pix);
                int ox = (mx * co.h + bx) * 8, oy = (my * co.v + by) * 8;
                for (int y = 0; y < 8; y++) {
                  float* dst = co.plane.data() + (size_t)(oy + y) * co.plane_w + ox;
                  for (int x = 0; x < 8; x++) dst[x] = pix[y * 8 + x] + 128.0f;
                }
              }
            }
          }
          mcu_count++;
        }
      }
      // upsample + color convert
      img.width = W;
      img.height = H;
      img.ncomp = ncomp;
      img.rgb.resize((size_t)W * H * 3);
      auto sample = [&](const Component& co, int x, int y) -> float {
        // center-aligned bilinear resample of the component plane to full res
        if (co.used_w == W && co.used_h == H)
          return co.plane[(size_t)y * co.plane_w + x];
        float sx = (float)co.used_w / W, sy = (float)co.used_h / H;
        float fx = (x + 0.5f) * sx - 0.5f, fy = (y + 0.5f) * sy - 0.5f;
        int x0 = (int)std::floor(fx), y0 = (int)std::floor(fy);
        float ax = fx - x0, ay = fy - y0;
        int x1 = std::min(x0 + 1, co.used_w - 1), y1 = std::min(y0 + 1, co.used_h - 1);
        x0 = std::max(x0, 0);
        y0 = std::max(y0, 0);
        const float* pl = co.plane.data();
        float v00 = pl[(size_t)y0 * co.plane_w + x0], v01 = pl[(size_t)y0 * co.plane_w + x1];
        float v10 = pl[(size_t)y1 * co.plane_w + x0], v11 = pl[(size_t)y1 * co.plane_w + x1];
        return (v00 * (1 - ax) + v01 * ax) * (1 - ay) + (v10 * (1 - ax) + v11 * ax) * ay;
      };
      auto clamp8 = [](float v) -> uint8_t {
        return (uint8_t)(v < 0.f ? 0 : (v > 255.f ? 255 : (int)(v + 0.5f)));
      };
      for (int y = 0; y < H; y++) {
        uint8_t* row = img.rgb.data() + (size_t)y * W * 3;
        for (int x = 0; x < W; x++) {
          if (ncomp == 1) {
            uint8_t g = clamp8(comp[0].plane[(size_t)y * comp[0].plane_w + x]);
            row[x * 3] = row[x * 3 + 1] = row[x * 3 + 2] = g;
          } else {
            float Y = sample(comp[0], x, y);
            float Cb = sample(comp[1], x, y) - 128.0f;
            float Cr = sample(comp[2], x, y) - 128.0f;
            row[x * 3 + 0] = clamp8(Y + 1.402f * Cr);
            row[x * 3 + 1] = clamp8(Y - 0.344136f * Cb - 0.714136f * Cr);
            row[x * 3 + 2] = clamp8(Y + 1.772f * Cb);
          }
        }
      }
      return true;
    }
    p = segend;
  }
  err = "no scan found";
  return false;
}

bool decode_jpeg_file(const char* path, JpegImage& img, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = "open failed";
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  size_t rd = std::fread(buf.data(), 1, n, f);
  std::fclose(f);
  if ((long)rd != n) {
    err = "read failed";
    return false;
  }
  return decode_jpeg(buf.data(), n, img, err);
}

// ---------------------------------------------------------------------------
// Undistortion remap (OPENCV model subset: k1,k2,k3,k4 radial-rational + p1,p2)
// ---------------------------------------------------------------------------

// dist6 = (k1, k2, k3, k4, p1, p2) — the dataparser's storage order
// (nerfstudio OPENCV convention; cv2 call maps it to [k1,k2,p1,p2,k3,k4]).
// Split like cv2.initUndistortRectifyMap + cv2.remap so the (double-precision,
// transcendental-heavy) map is computed once per distinct intrinsics and the
// per-view work is a float bilinear gather.
void compute_map(int H, int W, const double K[9], const double dist6[6],
                 const double newK[9], float* map /* H*W*2: us, vs */) {
  const double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const double nfx = newK[0], ncx = newK[2], nfy = newK[4], ncy = newK[5];
  const double k1 = dist6[0], k2 = dist6[1], k3 = dist6[2], k4 = dist6[3];
  const double p1 = dist6[4], p2 = dist6[5];
  for (int v = 0; v < H; v++) {
    float* m = map + (size_t)v * W * 2;
    double yn = (v - ncy) / nfy;
    for (int u = 0; u < W; u++) {
      double xn = (u - ncx) / nfx;
      double r2 = xn * xn + yn * yn;
      double radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (1.0 + r2 * k4);
      double xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn);
      double yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn;
      m[u * 2 + 0] = (float)(fx * xd + cx);
      m[u * 2 + 1] = (float)(fy * yd + cy);
    }
  }
}

void remap_bilinear(const float* src, int H, int W, int C, const float* map, float* dst) {
  for (int v = 0; v < H; v++) {
    float* out = dst + (size_t)v * W * C;
    const float* m = map + (size_t)v * W * 2;
    for (int u = 0; u < W; u++) {
      float us = m[u * 2], vs = m[u * 2 + 1];
      int x0 = (int)std::floor(us), y0 = (int)std::floor(vs);
      float ax = us - x0, ay = vs - y0;
      if (x0 >= 0 && y0 >= 0 && x0 + 1 < W && y0 + 1 < H) {  // fast interior
        const float* r0 = src + ((size_t)y0 * W + x0) * C;
        const float* r1 = r0 + (size_t)W * C;
        for (int c = 0; c < C; c++)
          out[(size_t)u * C + c] = (r0[c] * (1 - ax) + r0[C + c] * ax) * (1 - ay) +
                                   (r1[c] * (1 - ax) + r1[C + c] * ax) * ay;
      } else {
        for (int c = 0; c < C; c++) {
          auto at = [&](int yy, int xx) -> float {
            if (xx < 0 || xx >= W || yy < 0 || yy >= H) return 0.f;  // BORDER_CONSTANT
            return src[((size_t)yy * W + xx) * C + c];
          };
          out[(size_t)u * C + c] =
              (at(y0, x0) * (1 - ax) + at(y0, x0 + 1) * ax) * (1 - ay) +
              (at(y0 + 1, x0) * (1 - ax) + at(y0 + 1, x0 + 1) * ax) * ay;
        }
      }
    }
  }
}

void undistort_into(const float* src, int H, int W, int C, const double K[9],
                    const double dist6[6], const double newK[9], float* dst) {
  std::vector<float> map((size_t)H * W * 2);
  compute_map(H, W, K, dist6, newK, map.data());
  remap_bilinear(src, H, W, C, map.data(), dst);
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Test hook: AAN IDCT of one raster-order coefficient block that has already
// been pre-scaled by aan[r]*aan[c]/8 (the decoder folds that into dequant).
void idct_test(const float* in, float* out) { idct_aan(in, out); }

// Decode one JPEG. Returns a handle (or nullptr). Query w/h, copy RGB8 out.
void* img_open(const char* path) {
  auto* im = new JpegImage();
  std::string err;
  if (!decode_jpeg_file(path, *im, err)) {
    delete im;
    return nullptr;
  }
  return im;
}

int img_width(void* h) { return ((JpegImage*)h)->width; }
int img_height(void* h) { return ((JpegImage*)h)->height; }

void img_copy(void* h, uint8_t* dst) {
  auto* im = (JpegImage*)h;
  std::memcpy(dst, im->rgb.data(), im->rgb.size());
}

void img_close(void* h) { delete (JpegImage*)h; }

// Undistort one float32 HxWxC image (standalone entry for tests/tools).
void undistort_f32(const float* src, int H, int W, int C, const double* K,
                   const double* dist6, const double* newK, float* dst) {
  undistort_into(src, H, W, C, K, dist6, newK, dst);
}

// Batch: decode n JPEGs, undistort each with its per-view K/dist/newK, write
// float32 [n, H, W, 3] in [0,1]. Views whose dist6 is all-zero skip the remap.
// Ks/dists/newKs: [n,9]/[n,6]/[n,9] row-major doubles. Returns the number of
// successfully loaded views; failed views (decode error / size mismatch) get
// index written into failed[] (caller-sized n) for a Python-side fallback.
int load_undistort_batch(const char** paths, int n, int H, int W, const double* Ks,
                         const double* dists, const double* newKs, float* out,
                         int* failed, int nthreads) {
  std::atomic<int> next(0), nfail(0), nok(0);
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min(nthreads, n));
  auto worker = [&]() {
    std::vector<float> tmp((size_t)H * W * 3);
    std::vector<float> map;
    double cached[24];  // K(9) + dist(6) + newK(9) the current map was built for
    bool have_map = false;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      JpegImage im;
      std::string err;
      if (!decode_jpeg_file(paths[i], im, err)) {
        failed[nfail.fetch_add(1)] = i;
        continue;
      }
      // integer-factor box downsample when the file is an exact multiple of
      // the target (downscale_factor with no images_{d}/ folder on disk)
      int r = (W > 0 && im.width % W == 0) ? im.width / W : 0;
      if (!(r >= 1 && r <= 8 && im.width == r * W && im.height == r * H)) {
        failed[nfail.fetch_add(1)] = i;
        continue;
      }
      float* dst = out + (size_t)i * H * W * 3;
      const double* Ki = Ks + (size_t)i * 9;
      const double* d6 = dists + (size_t)i * 6;
      const double* nKi = newKs + (size_t)i * 9;
      bool distorted = false;
      for (int j = 0; j < 6; j++) distorted |= d6[j] != 0.0;
      const uint8_t* rgb = im.rgb.data();
      float* plane = distorted ? tmp.data() : dst;
      if (r == 1) {
        for (size_t j = 0; j < (size_t)H * W * 3; j++) plane[j] = rgb[j] * (1.0f / 255.0f);
      } else {
        const float inv = 1.0f / (255.0f * r * r);
        for (int y = 0; y < H; y++)
          for (int x = 0; x < W; x++)
            for (int c = 0; c < 3; c++) {
              float acc = 0.f;
              for (int dy = 0; dy < r; dy++)
                for (int dx = 0; dx < r; dx++)
                  acc += rgb[(((size_t)(y * r + dy) * im.width) + x * r + dx) * 3 + c];
              plane[((size_t)y * W + x) * 3 + c] = acc * inv;
            }
      }
      if (distorted) {
        // views of one scene usually share intrinsics: reuse the remap map
        bool same = have_map;
        for (int j = 0; same && j < 9; j++) same = cached[j] == Ki[j] && cached[15 + j] == nKi[j];
        for (int j = 0; same && j < 6; j++) same = cached[9 + j] == d6[j];
        if (!same) {
          map.resize((size_t)H * W * 2);
          compute_map(H, W, Ki, d6, nKi, map.data());
          std::memcpy(cached, Ki, 9 * sizeof(double));
          std::memcpy(cached + 9, d6, 6 * sizeof(double));
          std::memcpy(cached + 15, nKi, 9 * sizeof(double));
          have_map = true;
        }
        remap_bilinear(tmp.data(), H, W, 3, map.data(), dst);
      }
      nok.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return nok.load();
}

}  // extern "C"
