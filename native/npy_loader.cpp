// Native data loader for mmwave_radar_processing_jax.
//
// The device pipeline consumes batches of radar ADC frames as split re/im
// float32 planes; recordings store one complex64/complex128 .npy cube per
// frame.  Feeding a >2k-frames/s device from Python (np.load per file +
// real/imag copies, GIL-bound) becomes the bottleneck, so this C++ loader
// does the whole host-side feed stage natively:
//
//   - minimal NPY header parsing (v1/v2, C-order, complex64/128 + float32/64)
//   - a thread pool mapping frame files -> slots of one preallocated,
//     contiguous split-plane batch buffer (deinterleaving re/im on the fly)
//
// Exposed as a C ABI consumed via ctypes (no pybind11 dependency);
// see mmwave_radar_processing_jax/data/native_loader.py.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libnpy_loader.so
//        npy_loader.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Dtype : int {
  DT_UNKNOWN = 0,
  DT_C64 = 1,   // complex64  (2x float32)
  DT_C128 = 2,  // complex128 (2x float64)
  DT_F32 = 3,
  DT_F64 = 4,
};

struct NpyInfo {
  Dtype dtype = DT_UNKNOWN;
  long elems = 0;         // product of shape
  long data_offset = 0;   // header bytes before payload
  int ndim = 0;
  long shape[8] = {0};
  bool fortran = false;
};

// Parse just enough of the NPY header: magic, version, header dict.
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(header.data(), 1, header_len, f) != header_len) return false;

  // dtype
  auto dpos = header.find("'descr':");
  if (dpos == std::string::npos) return false;
  auto q0 = header.find('\'', dpos + 8);
  auto q1 = header.find('\'', q0 + 1);
  std::string descr = header.substr(q0 + 1, q1 - q0 - 1);
  if (descr == "<c8") info->dtype = DT_C64;
  else if (descr == "<c16") info->dtype = DT_C128;
  else if (descr == "<f4") info->dtype = DT_F32;
  else if (descr == "<f8") info->dtype = DT_F64;
  else return false;

  info->fortran = header.find("'fortran_order': True") != std::string::npos;
  if (info->fortran) return false;  // C-order only

  // shape tuple
  auto spos = header.find("'shape':");
  if (spos == std::string::npos) return false;
  auto p0 = header.find('(', spos);
  auto p1 = header.find(')', p0);
  std::string shape_str = header.substr(p0 + 1, p1 - p0 - 1);
  info->ndim = 0;
  info->elems = 1;
  const char* s = shape_str.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    long v = strtol(s, const_cast<char**>(&s), 10);
    if (info->ndim < 8) info->shape[info->ndim++] = v;
    info->elems *= v;
  }
  return info->ndim > 0;
}

// Load one frame's payload into split planes (or a single plane for reals).
bool load_frame_split(const char* path, float* re_out, float* im_out,
                      long expect_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.elems != expect_elems) {
    fclose(f);
    return false;
  }
  fseek(f, info.data_offset, SEEK_SET);
  bool ok = true;
  const long n = info.elems;
  constexpr long CHUNK = 1 << 16;
  switch (info.dtype) {
    case DT_C64: {
      std::vector<float> buf(2 * CHUNK);
      for (long off = 0; off < n && ok; off += CHUNK) {
        long m = std::min(CHUNK, n - off);
        ok = fread(buf.data(), sizeof(float) * 2, m, f) == (size_t)m;
        for (long i = 0; i < m; ++i) {
          re_out[off + i] = buf[2 * i];
          im_out[off + i] = buf[2 * i + 1];
        }
      }
      break;
    }
    case DT_C128: {
      std::vector<double> buf(2 * CHUNK);
      for (long off = 0; off < n && ok; off += CHUNK) {
        long m = std::min(CHUNK, n - off);
        ok = fread(buf.data(), sizeof(double) * 2, m, f) == (size_t)m;
        for (long i = 0; i < m; ++i) {
          re_out[off + i] = (float)buf[2 * i];
          im_out[off + i] = (float)buf[2 * i + 1];
        }
      }
      break;
    }
    case DT_F32: {
      ok = fread(re_out, sizeof(float), n, f) == (size_t)n;
      if (ok && im_out) memset(im_out, 0, sizeof(float) * n);
      break;
    }
    case DT_F64: {
      std::vector<double> buf(CHUNK);
      for (long off = 0; off < n && ok; off += CHUNK) {
        long m = std::min(CHUNK, n - off);
        ok = fread(buf.data(), sizeof(double), m, f) == (size_t)m;
        for (long i = 0; i < m; ++i) re_out[off + i] = (float)buf[i];
      }
      if (ok && im_out) memset(im_out, 0, sizeof(float) * n);
      break;
    }
    default:
      ok = false;
  }
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Inspect one NPY file: fills shape (max 8 dims); returns ndim or -1.
// dtype_out: Dtype enum value.
int mrp_npy_info(const char* path, long* shape_out, int* dtype_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  bool ok = parse_npy_header(f, &info);
  fclose(f);
  if (!ok) return -1;
  for (int i = 0; i < info.ndim; ++i) shape_out[i] = info.shape[i];
  *dtype_out = info.dtype;
  return info.ndim;
}

// Bulk-load `count` frames (paths as a NUL-separated buffer) into contiguous
// split-plane batch buffers of `frame_elems` elements per frame.
// Returns number of frames loaded successfully.
int mrp_load_frames_split(const char* paths, int count, float* re_out,
                          float* im_out, long frame_elems, int nthreads) {
  std::vector<const char*> frame_paths;
  frame_paths.reserve(count);
  const char* p = paths;
  for (int i = 0; i < count; ++i) {
    frame_paths.push_back(p);
    p += strlen(p) + 1;
  }

  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next{0};
  std::atomic<int> loaded{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) break;
      float* re = re_out + (long)i * frame_elems;
      float* im = im_out ? im_out + (long)i * frame_elems : nullptr;
      if (load_frame_split(frame_paths[i], re, im, frame_elems)) {
        loaded.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return loaded.load();
}

}  // extern "C"
