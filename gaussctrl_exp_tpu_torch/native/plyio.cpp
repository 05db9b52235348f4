// Native PLY point-cloud reader (C++17, no external deps).
//
// A copy of gaussctrl_exp_tpu/native/plyio.cpp for the PyTorch port. It
// replaces the reference's open3d PLY dependency (gc_dataparser_ns.py:447-449)
// with a small self-contained library exposed over a C ABI and driven from
// gaussctrl_exp_tpu_torch/data/ply.py through ctypes. Handles ascii and
// binary little/big-endian vertex elements with float/double positions and
// uchar/float colors; other properties are skipped by size. Parsing is
// single-pass over a fully buffered file.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 plyio.cpp -o libplyio.so
// (the port's loader does this at first use, into gaussctrl_exp_tpu_torch/_build/)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Property {
  std::string name;
  int size = 0;       // bytes
  char kind = 'f';    // f=float, d=double, u=uint8, i=other-int
};

struct PlyInfo {
  long n_vertex = 0;
  bool ascii = false;
  bool big_endian = false;
  std::vector<Property> props;
  size_t data_offset = 0;
  std::vector<char> file;  // whole file
  std::string error;
};

int prop_size(const std::string& t) {
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32" || t == "float" ||
      t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

char prop_kind(const std::string& t) {
  if (t == "float" || t == "float32") return 'f';
  if (t == "double" || t == "float64") return 'd';
  if (t == "uchar" || t == "uint8") return 'u';
  return 'i';
}

double swap_read(const char* p, const Property& pr, bool big) {
  unsigned char buf[8];
  std::memcpy(buf, p, pr.size);
  if (big) {
    for (int i = 0; i < pr.size / 2; i++) std::swap(buf[i], buf[pr.size - 1 - i]);
  }
  switch (pr.kind) {
    case 'f': {
      float v;
      std::memcpy(&v, buf, 4);
      return v;
    }
    case 'd': {
      double v;
      std::memcpy(&v, buf, 8);
      return v;
    }
    case 'u':
      return buf[0];
    default: {  // generic little-endian int of pr.size bytes
      int64_t v = 0;
      std::memcpy(&v, buf, pr.size);
      return static_cast<double>(v);
    }
  }
}

}  // namespace

extern "C" {

// Opens + parses the header. Returns an opaque handle (or null on error).
void* ply_open(const char* path) {
  auto* info = new PlyInfo();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    delete info;
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  info->file.resize(size);
  if (std::fread(info->file.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    delete info;
    return nullptr;
  }
  std::fclose(f);

  // header lines
  size_t pos = 0;
  bool in_vertex = false;
  bool ok_magic = false;
  while (pos < info->file.size()) {
    size_t eol = pos;
    while (eol < info->file.size() && info->file[eol] != '\n') eol++;
    std::string line(info->file.data() + pos, eol - pos);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    pos = eol + 1;

    if (!ok_magic) {
      if (line != "ply") {
        delete info;
        return nullptr;
      }
      ok_magic = true;
      continue;
    }
    if (line.rfind("format", 0) == 0) {
      info->ascii = line.find("ascii") != std::string::npos;
      info->big_endian = line.find("big_endian") != std::string::npos;
    } else if (line.rfind("element", 0) == 0) {
      char name[64];
      long cnt;
      if (std::sscanf(line.c_str(), "element %63s %ld", name, &cnt) == 2) {
        in_vertex = std::strcmp(name, "vertex") == 0;
        if (in_vertex) info->n_vertex = cnt;
      }
    } else if (line.rfind("property", 0) == 0 && in_vertex) {
      char type[32], name[64];
      if (std::sscanf(line.c_str(), "property %31s %63s", type, name) == 2) {
        if (std::strcmp(type, "list") == 0) {
          delete info;
          return nullptr;  // list property in vertex element unsupported
        }
        Property p;
        p.name = name;
        p.size = prop_size(type);
        p.kind = prop_kind(type);
        if (p.size < 0) {
          delete info;
          return nullptr;
        }
        info->props.push_back(p);
      }
    } else if (line == "end_header") {
      info->data_offset = pos;
      return info;
    }
  }
  delete info;
  return nullptr;
}

long ply_num_vertices(void* h) { return static_cast<PlyInfo*>(h)->n_vertex; }

int ply_has_rgb(void* h) {
  auto* info = static_cast<PlyInfo*>(h);
  int found = 0;
  for (auto& p : info->props)
    if (p.name == "red" || p.name == "green" || p.name == "blue") found++;
  return found == 3;
}

// Fills xyz (n*3 float32) and rgb (n*3 uint8, may be null). Returns 0 on ok.
int ply_read(void* h, float* xyz, uint8_t* rgb) {
  auto* info = static_cast<PlyInfo*>(h);
  int ix = -1, iy = -1, iz = -1, ir = -1, ig = -1, ib = -1;
  size_t stride = 0;
  std::vector<size_t> offsets(info->props.size());
  for (size_t i = 0; i < info->props.size(); i++) {
    offsets[i] = stride;
    stride += info->props[i].size;
    const std::string& n = info->props[i].name;
    if (n == "x") ix = i;
    else if (n == "y") iy = i;
    else if (n == "z") iz = i;
    else if (n == "red") ir = i;
    else if (n == "green") ig = i;
    else if (n == "blue") ib = i;
  }
  if (ix < 0 || iy < 0 || iz < 0) return 1;

  if (info->ascii) {
    const char* p = info->file.data() + info->data_offset;
    const char* end = info->file.data() + info->file.size();
    for (long v = 0; v < info->n_vertex; v++) {
      for (size_t i = 0; i < info->props.size(); i++) {
        char* next;
        double val = std::strtod(p, &next);
        if (next == p) return 2;
        p = next;
        if (static_cast<int>(i) == ix) xyz[v * 3 + 0] = static_cast<float>(val);
        else if (static_cast<int>(i) == iy) xyz[v * 3 + 1] = static_cast<float>(val);
        else if (static_cast<int>(i) == iz) xyz[v * 3 + 2] = static_cast<float>(val);
        else if (rgb && static_cast<int>(i) == ir) rgb[v * 3 + 0] = static_cast<uint8_t>(val);
        else if (rgb && static_cast<int>(i) == ig) rgb[v * 3 + 1] = static_cast<uint8_t>(val);
        else if (rgb && static_cast<int>(i) == ib) rgb[v * 3 + 2] = static_cast<uint8_t>(val);
      }
      if (p > end) return 3;
    }
    return 0;
  }

  const char* base = info->file.data() + info->data_offset;
  if (info->data_offset + stride * info->n_vertex > info->file.size()) return 3;
  for (long v = 0; v < info->n_vertex; v++) {
    const char* row = base + v * stride;
    xyz[v * 3 + 0] = static_cast<float>(swap_read(row + offsets[ix], info->props[ix], info->big_endian));
    xyz[v * 3 + 1] = static_cast<float>(swap_read(row + offsets[iy], info->props[iy], info->big_endian));
    xyz[v * 3 + 2] = static_cast<float>(swap_read(row + offsets[iz], info->props[iz], info->big_endian));
    if (rgb && ir >= 0) {
      rgb[v * 3 + 0] = static_cast<uint8_t>(swap_read(row + offsets[ir], info->props[ir], info->big_endian));
      rgb[v * 3 + 1] = static_cast<uint8_t>(swap_read(row + offsets[ig], info->props[ig], info->big_endian));
      rgb[v * 3 + 2] = static_cast<uint8_t>(swap_read(row + offsets[ib], info->props[ib], info->big_endian));
    }
  }
  return 0;
}

void ply_close(void* h) { delete static_cast<PlyInfo*>(h); }

}  // extern "C"
