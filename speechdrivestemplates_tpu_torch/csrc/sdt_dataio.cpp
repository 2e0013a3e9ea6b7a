// sdt_dataio: the native item loader of the PyTorch port (host C++, not a kernel).
//
// The port's copy of the JAX package's native data-loader core. One call runs a
// train or val item's whole pipeline on one clip npz: the zip entries (STORED and
// DEFLATE, ZIP64 sizes), the npy payloads (v1 / v2, '<f4' or '<f8'), the
// 137 -> 122 -> 121 keypoint selection, root-centering on keypoint 1, the head and
// hand re-rooting of hierarchical poses, the per-speaker z-score, and the audio
// crop or zero-pad. It computes what datasets/gesture_dataset.py's numpy route
// computes, in the same float32 operations in the same order, so the two agree
// bit for bit (built with -ffp-contract=off: no fused multiply-adds).
//
// The C ABI is the JAX core's: sdt_load_clip and sdt_dataio_abi_version (1). The
// library is built at first use by datasets/native_loader.py:
//   c++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off -o libsdt_dataio.so \
//       sdt_dataio.cpp -lz
// for the host's baseline instruction set (no -march=native), so a build directory
// that moves between hosts still runs. Every call keeps its state on its own stack
// and heap: threads may call it at once (ctypes releases the GIL).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  long n = ok ? std::ftell(f) : -1;
  ok = n >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out->resize(static_cast<size_t>(n));
    ok = std::fread(out->data(), 1, out->size(), f) == out->size();
  }
  std::fclose(f);
  return ok;
}

uint16_t rd16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint64_t rd64(const uint8_t* p) {
  return uint64_t(rd32(p)) | (uint64_t(rd32(p + 4)) << 32);
}

// An npy payload: its element type, shape and little-endian data.
struct Npy {
  char dtype = 0;  // 'f' float32, 'd' float64, 0 anything else
  bool fortran = false;
  std::vector<long> shape;
  const uint8_t* data = nullptr;
  size_t nbytes = 0;
  std::vector<uint8_t> owned;  // the inflated entry, when it was DEFLATE'd

  size_t size() const {
    size_t n = 1;
    for (long d : shape) n *= static_cast<size_t>(d);
    return n;
  }
  // A payload this loader reads: a float type in C order, whole.
  bool readable() const {
    if (dtype == 0 || fortran) return false;
    return size() * (dtype == 'f' ? 4 : 8) <= nbytes;
  }
  float at(size_t i) const {  // memcpy: a STORED entry's data may be unaligned
    if (dtype == 'f') {
      float v;
      std::memcpy(&v, data + i * 4, 4);
      return v;
    }
    double v;
    std::memcpy(&v, data + i * 8, 8);
    return static_cast<float>(v);
  }
};

bool parse_npy(const uint8_t* p, size_t n, Npy* out) {
  if (n < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return false;
  const int major = p[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(p + 8);
    hoff = 10;
  } else {
    if (n < 12) return false;
    hlen = rd32(p + 8);
    hoff = 12;
  }
  if (hoff + hlen > n) return false;
  const std::string hdr(reinterpret_cast<const char*>(p + hoff), hlen);

  auto value_of = [&](const std::string& key) -> std::string {
    size_t k = hdr.find(key);
    if (k == std::string::npos) return "";
    size_t c = hdr.find(':', k);
    return c == std::string::npos ? "" : hdr.substr(c + 1, 64);
  };
  const std::string descr = value_of("'descr'");
  if (descr.find("<f4") != std::string::npos) out->dtype = 'f';
  else if (descr.find("<f8") != std::string::npos) out->dtype = 'd';
  else out->dtype = 0;
  out->fortran = value_of("'fortran_order'").find("True") != std::string::npos;

  const size_t sh = hdr.find("'shape'");
  if (sh == std::string::npos) return false;
  const size_t l = hdr.find('(', sh), r = hdr.find(')', sh);
  if (l == std::string::npos || r == std::string::npos || r < l) return false;
  out->shape.clear();
  long cur = -1;
  for (char c : hdr.substr(l + 1, r - l - 1)) {
    if (c >= '0' && c <= '9') cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    else if (cur >= 0) { out->shape.push_back(cur); cur = -1; }
  }
  if (cur >= 0) out->shape.push_back(cur);

  out->data = p + hoff + hlen;
  out->nbytes = n - hoff - hlen;
  return true;
}

// The zip entry ``name``, STORED or DEFLATE'd, parsed as an npy payload.
bool zip_find(const std::vector<uint8_t>& zip, const std::string& name, Npy* out) {
  const uint8_t* p = zip.data();
  const size_t n = zip.size();
  size_t off = 0;
  while (off + 30 <= n) {
    if (rd32(p + off) != 0x04034b50) break;
    const uint16_t method = rd16(p + off + 8);
    uint64_t csize = rd32(p + off + 18);
    uint64_t usize = rd32(p + off + 22);
    const uint16_t nlen = rd16(p + off + 26);
    const uint16_t elen = rd16(p + off + 28);
    if (off + 30 + nlen + elen > n) return false;
    const std::string ename(reinterpret_cast<const char*>(p + off + 30), nlen);
    // ZIP64 (numpy's savez writes it): the real sizes are in extra field 0x0001
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu) {
      const uint8_t* e = p + off + 30 + nlen;
      size_t eoff = 0;
      while (eoff + 4 <= elen) {
        const uint16_t tag = rd16(e + eoff);
        const uint16_t sz = rd16(e + eoff + 2);
        if (tag == 0x0001) {
          size_t f = eoff + 4;
          if (usize == 0xFFFFFFFFu && sz >= 8) { usize = rd64(e + f); f += 8; }
          if (csize == 0xFFFFFFFFu && sz >= 16) { csize = rd64(e + f); }
          break;
        }
        eoff += 4 + sz;
      }
    }
    const size_t data_off = off + 30 + nlen + elen;
    if (data_off + csize > n) return false;
    if (ename == name) {
      if (method == 0) return parse_npy(p + data_off, csize, out);
      if (method != 8) return false;
      out->owned.resize(usize);
      z_stream zs{};
      if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;
      zs.next_in = const_cast<uint8_t*>(p + data_off);
      zs.avail_in = static_cast<uInt>(csize);
      zs.next_out = out->owned.data();
      zs.avail_out = static_cast<uInt>(usize);
      const int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) return false;
      return parse_npy(out->owned.data(), usize, out);
    }
    off = data_off + csize;
  }
  return false;
}

// 137 -> 122: the upper body 0..7, the two keypoints 15 and 16, then 25..136
// (face and hands); the lower body is dropped. A constant table: no first-call
// initialisation for two threads to race on.
struct Select122 {
  int idx[122];
  constexpr Select122() : idx() {
    int k = 0;
    for (int i = 0; i < 8; ++i) idx[k++] = i;
    idx[k++] = 15;
    idx[k++] = 16;
    for (int i = 25; i < 137; ++i) idx[k++] = i;
  }
};
constexpr Select122 kSel122{};

// the re-rooting anchors in keypoint-121 space (ops/pose.py)
constexpr int kHandRootL = 6, kHandRootR = 3, kHeadRoot = 39;

}  // namespace

extern "C" {

// Load one clip npz and run the item pipeline.
//   poses_out  : float[num_frames*2*121]  z-scored root-relative poses (x row, y row)
//   scores_out : float[num_frames*2*121]  detection scores, repeated over x and y
//   audio_out  : float[audio_len]         the waveform cropped or zero-padded
//   mean/std   : float[242]               the speaker's statistics (x.. then y..)
// Returns 0, or: -1 the file does not read; -2 no pose.npy; -3 no audio.npy;
// -4 the pose is not (T, 3, 137); -5 fewer than num_frames frames; -6 a payload
// that is not float32 / float64 in C order, or shorter than its shape.
int sdt_load_clip(const char* path, int num_frames, int hierarchical,
                  const float* mean, const float* stddev,
                  float* poses_out, float* scores_out,
                  float* audio_out, long audio_len) {
  std::vector<uint8_t> zip;
  if (!read_file(path, &zip)) return -1;

  Npy pose, audio;
  if (!zip_find(zip, "pose.npy", &pose)) return -2;
  if (!zip_find(zip, "audio.npy", &audio)) return -3;
  if (pose.shape.size() != 3 || pose.shape[1] != 3 || pose.shape[2] != 137)
    return -4;
  if (pose.shape[0] < num_frames) return -5;
  if (!pose.readable() || !audio.readable()) return -6;

  const size_t a_avail = audio.size();
  for (long i = 0; i < audio_len; ++i)
    audio_out[i] = static_cast<size_t>(i) < a_avail ? audio.at(i) : 0.0f;

  for (int t = 0; t < num_frames; ++t) {
    float x122[122], y122[122], s122[122];
    const size_t base = static_cast<size_t>(t) * 3 * 137;
    for (int k = 0; k < 122; ++k) {
      const int src = kSel122.idx[k];
      x122[k] = pose.at(base + src);
      y122[k] = pose.at(base + 137 + src);
      s122[k] = pose.at(base + 2 * 137 + src);
    }
    // centre on keypoint 1 of the 122 layout, then drop it -> 121
    const float rx = x122[1], ry = y122[1];
    float x[121], y[121], s[121];
    for (int k = 0, j = 0; k < 122; ++k) {
      if (k == 1) continue;
      x[j] = x122[k] - rx;
      y[j] = y122[k] - ry;
      s[j] = s122[k];
      ++j;
    }
    if (hierarchical) {
      const float hx = x[kHeadRoot], hy = y[kHeadRoot];
      for (int k = 9; k < 79; ++k) {
        if (k == kHeadRoot) continue;
        x[k] -= hx;
        y[k] -= hy;
      }
      const float lx = x[kHandRootL], ly = y[kHandRootL];
      for (int k = 79; k < 100; ++k) { x[k] -= lx; y[k] -= ly; }
      const float rx2 = x[kHandRootR], ry2 = y[kHandRootR];
      for (int k = 100; k < 121; ++k) { x[k] -= rx2; y[k] -= ry2; }
    }
    float* po = poses_out + static_cast<size_t>(t) * 2 * 121;
    float* so = scores_out + static_cast<size_t>(t) * 2 * 121;
    for (int k = 0; k < 121; ++k) {
      po[k] = (x[k] - mean[k]) / stddev[k];
      po[121 + k] = (y[k] - mean[121 + k]) / stddev[121 + k];
      so[k] = s[k];
      so[121 + k] = s[k];
    }
  }
  return 0;
}

// The ABI's version, checked by the Python binding.
int sdt_dataio_abi_version() { return 1; }

}  // extern "C"
