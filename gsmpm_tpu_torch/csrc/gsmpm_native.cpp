// gsmpm_tpu_torch native IO tier: threaded binary-PLY codec for 3DGS
// checkpoints.
//
// The 3DGS checkpoint layout (62 float32 properties per vertex) is what the
// gaussian-splatting GaussianModel.load_ply/save_ply read and write. This is
// the port's native data loader: one pass over the file with a multithreaded
// interleaved<->planar transpose, exposed to Python via ctypes
// (gsmpm_tpu_torch/io/_native.py). Host-side only -- all device compute
// stays in PyTorch and the CUDA kernels. The same source as gsmpm_tpu's
// csrc/gsmpm_native.cpp; only these comments differ.
//
// Build: gsmpm_tpu_torch/utils/build.py (g++ -O3 -std=c++17 -shared -fPIC
// -pthread, with gsmpm_video.cpp).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxHeader = 65536;

struct Header {
  long long n_vertex = -1;
  std::vector<std::string> names;
  long long data_offset = 0;
  bool all_f32 = true;
  bool little_binary = false;
};

// Parse the PLY header of the (single) vertex element. Returns false on
// malformed input. Only "property float <name>" rows keep all_f32 true.
bool parse_header(FILE* f, Header* h) {
  std::string buf(kMaxHeader, '\0');
  size_t got = fread(&buf[0], 1, kMaxHeader, f);
  buf.resize(got);
  size_t end = buf.find("end_header\n");
  if (end == std::string::npos) return false;
  h->data_offset = static_cast<long long>(end + strlen("end_header\n"));
  if (buf.compare(0, 4, "ply\n") != 0 && buf.compare(0, 5, "ply\r\n") != 0)
    return false;

  size_t pos = 0;
  bool in_vertex = false;
  while (pos < end) {
    size_t eol = buf.find('\n', pos);
    if (eol == std::string::npos || eol > end) eol = end;
    std::string line = buf.substr(pos, eol - pos);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    pos = eol + 1;

    if (line.rfind("format ", 0) == 0) {
      h->little_binary = line.find("binary_little_endian") != std::string::npos;
    } else if (line.rfind("element ", 0) == 0) {
      if (line.rfind("element vertex ", 0) == 0) {
        h->n_vertex = atoll(line.c_str() + strlen("element vertex "));
        in_vertex = true;
      } else {
        in_vertex = false;
      }
    } else if (in_vertex && line.rfind("property ", 0) == 0) {
      // "property <type> <name>"
      size_t sp1 = line.find(' ');
      size_t sp2 = line.find(' ', sp1 + 1);
      if (sp2 == std::string::npos) return false;
      std::string type = line.substr(sp1 + 1, sp2 - sp1 - 1);
      if (type != "float" && type != "float32") h->all_f32 = false;
      h->names.push_back(line.substr(sp2 + 1));
    }
  }
  return h->n_vertex >= 0;
}

void transpose_rows(const float* inter, float* planar, long long n,
                    int n_props, long long row0, long long row1) {
  for (long long r = row0; r < row1; ++r) {
    const float* src = inter + r * n_props;
    for (int p = 0; p < n_props; ++p) planar[(long long)p * n + r] = src[p];
  }
}

void interleave_rows(const float* planar, float* inter, long long n,
                     int n_props, long long row0, long long row1) {
  for (long long r = row0; r < row1; ++r) {
    float* dst = inter + r * n_props;
    for (int p = 0; p < n_props; ++p) dst[p] = planar[(long long)p * n + r];
  }
}

void run_threads(int n_threads, long long n,
                 const std::function<void(long long, long long)>& fn) {
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  long long chunk = (n + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    long long r0 = i * chunk;
    long long r1 = std::min(n, r0 + chunk);
    if (r0 >= r1) break;
    ts.emplace_back(fn, r0, r1);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Header probe. names_buf receives '\n'-joined property names (vertex
// element). Returns 0 ok; -1 io error; -2 malformed; -3 names_buf too small.
// all_f32 = 1 when every vertex property is float32 AND the file is
// binary_little_endian (the fast-path precondition).
int gsn_ply_header(const char* path, long long* n_vertex, int* n_props,
                   char* names_buf, int names_cap, long long* data_offset,
                   int* all_f32) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  bool ok = parse_header(f, &h);
  fclose(f);
  if (!ok) return -2;
  std::string joined;
  for (size_t i = 0; i < h.names.size(); ++i) {
    if (i) joined += '\n';
    joined += h.names[i];
  }
  if ((int)joined.size() + 1 > names_cap) return -3;
  memcpy(names_buf, joined.c_str(), joined.size() + 1);
  *n_vertex = h.n_vertex;
  *n_props = (int)h.names.size();
  *data_offset = h.data_offset;
  *all_f32 = (h.all_f32 && h.little_binary) ? 1 : 0;
  return 0;
}

// Read the interleaved f32 vertex block into a planar (n_props, n) buffer.
// Returns 0 ok; -1 io error; -4 short read.
int gsn_ply_read_f32_planar(const char* path, long long data_offset,
                            long long n, int n_props, float* out,
                            int n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)data_offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  std::vector<float> inter((size_t)n * n_props);
  size_t want = (size_t)n * n_props;
  size_t got = fread(inter.data(), sizeof(float), want, f);
  fclose(f);
  if (got != want) return -4;
  run_threads(n_threads, n, [&](long long r0, long long r1) {
    transpose_rows(inter.data(), out, n, n_props, r0, r1);
  });
  return 0;
}

// Write header (ascii, caller-built) + interleaved f32 block from planar
// (n_props, n) data. Returns 0 ok; -1 io error.
int gsn_ply_write_f32_planar(const char* path, const char* header,
                             const float* planar, long long n, int n_props,
                             int n_threads) {
  std::vector<float> inter((size_t)n * n_props);
  run_threads(n_threads, n, [&](long long r0, long long r1) {
    interleave_rows(planar, inter.data(), n, n_props, r0, r1);
  });
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t hlen = strlen(header);
  bool ok = fwrite(header, 1, hlen, f) == hlen;
  ok = ok && fwrite(inter.data(), sizeof(float), inter.size(), f) ==
                 inter.size();
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

}  // extern "C"
