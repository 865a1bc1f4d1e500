// Native runtime components for tpuray: PNG codec + scene-archive codec.
//
// The equivalent of the reference's C host runtime: png_dump
// (cpu_ray.c:108-165), the wrapper's PNG loader (opencl_wrap.c:241-320) and
// the scene archive dump_robj/extract_robj (cpu_obj.c:51-101).  The compute
// path is jax/XLA; this library is the IO side, loaded via ctypes
// (tpuray/native_lib.py).  Exposes a flat C ABI.
//
// Archive layout (verified against the committed 723-byte render.map;
// SURVEY.md §2): [u8 n][n x rsphere(96B)][u8 n][n x rplane(96B)]
// [u8 n][n x rlight(48B)], little-endian, float3 stored as 16 B, material
// 64 B at offset 32 of sphere/plane.  A "TPURAY2\0" v2 section appends
// [u32 n][n x rtriangle(112B)] for the triangle extension.

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG codec
// ---------------------------------------------------------------------------

// Write tightly-packed RGB8 rows as a PNG (png_dump equivalent, but taking
// [h][w][3] u8 instead of the reference's packed 0RGB uint words).
int tpuray_write_png(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 0;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
    std::fclose(fp);
    return 0;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = const_cast<png_bytep>(rgb + static_cast<size_t>(y) * w * 3);
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return 1;
}

static int read_png_impl(const char* path, uint8_t* out, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 0;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return 0;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  // normalize every input to 8-bit RGB (the reference handles palette/gray/
  // alpha variants by hand, opencl_wrap.c:262-300; libpng transforms do it)
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  int width = png_get_image_width(png, info);
  int height = png_get_image_height(png, info);
  if (w) *w = width;
  if (h) *h = height;
  if (out) {
    std::vector<png_bytep> rows(height);
    for (int y = 0; y < height; ++y)
      rows[y] = out + static_cast<size_t>(y) * width * 3;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 1;
}

int tpuray_read_png_size(const char* path, int* w, int* h) {
  return read_png_impl(path, nullptr, w, h);
}

int tpuray_read_png(const char* path, uint8_t* out) {
  return read_png_impl(path, out, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// Scene archive codec
// ---------------------------------------------------------------------------

// On-disk struct images.  These mirror the reference's #pragma pack(push,16)
// layout (cpu_obj.h:8-50) — sizes asserted below against the verified
// byte-level parse.
struct TrMaterial {
  float rgb[3];
  float pad0;
  float ambient, diffuse, specular;
  uint32_t shininess;
  uint32_t transperent;  // reference spelling
  uint32_t dielectric;
  float n, reflectivity;
  int32_t texture_id;
  float texture_scale;
  uint8_t pad1[8];
};
struct TrSphere {
  float origin[3];
  float pad0;
  float radius;
  uint8_t pad1[12];
  TrMaterial mat;
};
struct TrPlane {
  float normal[3];
  float pad0;
  float point[3];
  float pad1;
  TrMaterial mat;
};
struct TrLight {
  float origin[3];
  float pad0;
  float radius, intensity;
  uint8_t pad1[8];
  float rgb[3];
  float pad2;
};
struct TrTriangle {
  float v0[3];
  float pad0;
  float v1[3];
  float pad1;
  float v2[3];
  float pad2;
  TrMaterial mat;
};

static_assert(sizeof(TrMaterial) == 64, "rmaterial must be 64 B");
static_assert(sizeof(TrSphere) == 96, "rsphere must be 96 B");
static_assert(sizeof(TrPlane) == 96, "rplane must be 96 B");
static_assert(sizeof(TrLight) == 48, "rlight must be 48 B");
static_assert(sizeof(TrTriangle) == 112, "rtriangle must be 112 B");

static const char kV2Magic[8] = {'T', 'P', 'U', 'R', 'A', 'Y', '2', '\0'};

static bool read_all(const char* path, std::vector<uint8_t>* buf) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  long n = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  buf->resize(n < 0 ? 0 : static_cast<size_t>(n));
  bool ok = n >= 0 && std::fread(buf->data(), 1, buf->size(), fp) == buf->size();
  std::fclose(fp);
  return ok;
}

// Parse section counts + offsets.  Returns 0 on malformed archive.
static int scene_parse(const std::vector<uint8_t>& buf, int* ns, int* np,
                       int* nl, int* nt, size_t offs[4]) {
  size_t off = 0, n = buf.size();
  if (off + 1 > n) return 0;
  *ns = buf[off++];
  offs[0] = off;
  off += static_cast<size_t>(*ns) * sizeof(TrSphere);
  if (off + 1 > n) return 0;
  *np = buf[off++];
  offs[1] = off;
  off += static_cast<size_t>(*np) * sizeof(TrPlane);
  if (off + 1 > n) return 0;
  *nl = buf[off++];
  offs[2] = off;
  off += static_cast<size_t>(*nl) * sizeof(TrLight);
  if (off > n) return 0;
  *nt = 0;
  offs[3] = off;
  if (off + sizeof(kV2Magic) + 4 <= n &&
      std::memcmp(buf.data() + off, kV2Magic, sizeof(kV2Magic)) == 0) {
    off += sizeof(kV2Magic);
    uint32_t cnt;
    std::memcpy(&cnt, buf.data() + off, 4);
    off += 4;
    offs[3] = off;
    if (off + cnt * sizeof(TrTriangle) > n) return 0;
    *nt = static_cast<int>(cnt);
  }
  return 1;
}

int tpuray_scene_counts(const char* path, int* ns, int* np, int* nl, int* nt) {
  std::vector<uint8_t> buf;
  if (!read_all(path, &buf)) return 0;
  size_t offs[4];
  return scene_parse(buf, ns, np, nl, nt, offs);
}

// extract_robj equivalent (cpu_obj.c:76-101): callers size the out arrays
// from tpuray_scene_counts.
int tpuray_scene_read(const char* path, TrSphere* spheres, TrPlane* planes,
                      TrLight* lights, TrTriangle* tris) {
  std::vector<uint8_t> buf;
  if (!read_all(path, &buf)) return 0;
  int ns, np, nl, nt;
  size_t offs[4];
  if (!scene_parse(buf, &ns, &np, &nl, &nt, offs)) return 0;
  if (spheres) std::memcpy(spheres, buf.data() + offs[0], ns * sizeof(TrSphere));
  if (planes) std::memcpy(planes, buf.data() + offs[1], np * sizeof(TrPlane));
  if (lights) std::memcpy(lights, buf.data() + offs[2], nl * sizeof(TrLight));
  if (tris && nt) std::memcpy(tris, buf.data() + offs[3], nt * sizeof(TrTriangle));
  return 1;
}

// dump_robj equivalent (cpu_obj.c:51-74), with zeroed padding (the reference
// fwrites raw stack structs, leaking uninitialized pad bytes).
int tpuray_scene_write(const char* path, const TrSphere* spheres, int ns,
                       const TrPlane* planes, int np, const TrLight* lights,
                       int nl, const TrTriangle* tris, int nt) {
  if (ns < 0 || ns > 255 || np < 0 || np > 255 || nl < 0 || nl > 255 || nt < 0)
    return 0;
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 0;
  bool ok = true;
  uint8_t c;
  c = static_cast<uint8_t>(ns);
  ok = ok && std::fwrite(&c, 1, 1, fp) == 1;
  ok = ok && (ns == 0 ||
              std::fwrite(spheres, sizeof(TrSphere), ns, fp) == (size_t)ns);
  c = static_cast<uint8_t>(np);
  ok = ok && std::fwrite(&c, 1, 1, fp) == 1;
  ok = ok && (np == 0 ||
              std::fwrite(planes, sizeof(TrPlane), np, fp) == (size_t)np);
  c = static_cast<uint8_t>(nl);
  ok = ok && std::fwrite(&c, 1, 1, fp) == 1;
  ok = ok && (nl == 0 ||
              std::fwrite(lights, sizeof(TrLight), nl, fp) == (size_t)nl);
  if (ok && nt > 0) {
    uint32_t cnt = static_cast<uint32_t>(nt);
    ok = std::fwrite(kV2Magic, sizeof(kV2Magic), 1, fp) == 1 &&
         std::fwrite(&cnt, 4, 1, fp) == 1 &&
         std::fwrite(tris, sizeof(TrTriangle), nt, fp) == (size_t)nt;
  }
  std::fclose(fp);
  return ok ? 1 : 0;
}

}  // extern "C"
