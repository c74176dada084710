// mtt_serve: serve an AOTInductor package of serving.export_program(format="aoti")
// from a process that runs libtorch alone, with no Python in it.
//
// The C++ counterpart of serving.load_program for the "aoti" format, as TF
// Serving is the JAX SavedModel's server. It reads the artifact directory
// (manifest.json, params.npz, package.pt2), dlopens the ops library
// (csrc/mtt_ops.cpp built in the mtt namespace) with RTLD_GLOBAL so that the
// package's calls of mtt::* resolve through the dispatcher, loads the package
// with torch::inductor::AOTIModelPackageLoader, and serves the rows of
// --context (and --text) in batches of --batch, the last padded by repeating its
// last row, as Forecaster pads it. One pass writes each output as OUT/<name>.npy
// (real rows only); --repeat more passes are timed and held bit-equal to it,
// batch by batch.
//
//   mtt_serve ARTIFACT_DIR --context C.npy [--text T.npy] --out DIR
//             [--device cuda|cpu] [--batch N] [--repeat R] [--ops-lib PATH]
//
// The device is CUDA unless --device cpu. It refuses, by name and with exit code
// 2, what it cannot serve: an artifact that is not an AOTInductor package (a
// torch.export program), a device not in the manifest's platforms, a
// multimodal artifact without --text, inputs of another shape. The ops library
// defaults to libmtt_ops.so beside this binary. The GEMMs run with TF32 off, as
// the Python serving path runs them. Lines before the last: load seconds, series/s
// of the timed passes (synchronised), the ops' kernel launches, the matmul flags
// the GEMMs ran under. The last line is one JSON object with the same numbers.
// --context and --text are float32 .npy files.
//
// Inputs come in the order of the package's own in_spec (get_call_spec()[0],
// a serialised pytree of ((params, context[, text]), {})), the params by the
// names in its dict context, never by an assumed order; output names come
// from the out_spec. params.npz is numpy's zip of raw-byte leaves (stored,
// written with zip64 extra fields: sizes and offsets are read from the central
// directory), each viewed by the manifest's leaf_spec dtype and shape.

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#ifdef MTT_WITH_CUDA
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <dlfcn.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <charconv>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <iostream>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <type_traits>
#include <vector>

namespace fs = std::filesystem;

namespace {

// An input the server refuses: exit code 2, the message names it.
struct Refusal : std::runtime_error {
  using std::runtime_error::runtime_error;
};

double now_s() {
  return std::chrono::duration<double>(std::chrono::steady_clock::now().time_since_epoch()).count();
}

// --- JSON (manifest.json and the package's pytree specs) ---------------------

struct Json {
  enum Kind { Null, Bool, Number, String, Array, Object } kind = Null;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> items;                          // Array
  std::vector<std::pair<std::string, Json>> fields;  // Object, in file order

  const Json* find(const std::string& key) const {
    for (const auto& [k, v] : fields)
      if (k == key) return &v;
    return nullptr;
  }
  const Json& at(const std::string& key) const {
    const Json* v = find(key);
    if (v == nullptr) throw std::runtime_error("JSON object has no key '" + key + "'");
    return *v;
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& text) : s_(text) {}

  Json parse() {
    Json v = value();
    space();
    if (i_ != s_.size()) fail("trailing characters");
    return v;
  }

 private:
  const std::string& s_;
  size_t i_ = 0;

  [[noreturn]] void fail(const std::string& what) {
    throw std::runtime_error("bad JSON at offset " + std::to_string(i_) + ": " + what);
  }
  void space() {
    while (i_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[i_]))) ++i_;
  }
  bool take(const char* word) {
    const size_t n = std::strlen(word);
    if (s_.compare(i_, n, word) != 0) return false;
    i_ += n;
    return true;
  }
  void expect(char c) {
    space();
    if (i_ >= s_.size() || s_[i_] != c) fail(std::string("expected '") + c + "'");
    ++i_;
  }
  static void utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
      out += char(cp);
    } else if (cp < 0x800) {
      out += char(0xC0 | (cp >> 6));
      out += char(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += char(0xE0 | (cp >> 12));
      out += char(0x80 | ((cp >> 6) & 0x3F));
      out += char(0x80 | (cp & 0x3F));
    } else {
      out += char(0xF0 | (cp >> 18));
      out += char(0x80 | ((cp >> 12) & 0x3F));
      out += char(0x80 | ((cp >> 6) & 0x3F));
      out += char(0x80 | (cp & 0x3F));
    }
  }
  uint32_t hex4() {
    if (i_ + 4 > s_.size()) fail("short \\u escape");
    const uint32_t cp = std::stoul(s_.substr(i_, 4), nullptr, 16);
    i_ += 4;
    return cp;
  }
  std::string string() {
    expect('"');
    std::string out;
    while (true) {
      if (i_ >= s_.size()) fail("unterminated string");
      const char c = s_[i_++];
      if (c == '"') return out;
      if (c != '\\') {
        out += c;
        continue;
      }
      if (i_ >= s_.size()) fail("unterminated escape");
      const char e = s_[i_++];
      switch (e) {
        case '"': case '\\': case '/': out += e; break;
        case 'b': out += '\b'; break;
        case 'f': out += '\f'; break;
        case 'n': out += '\n'; break;
        case 'r': out += '\r'; break;
        case 't': out += '\t'; break;
        case 'u': {
          uint32_t cp = hex4();
          if (cp >= 0xD800 && cp < 0xDC00 && take("\\u")) cp = 0x10000 + ((cp - 0xD800) << 10) + (hex4() - 0xDC00);
          utf8(out, cp);
          break;
        }
        default: fail("bad escape");
      }
    }
  }
  Json value() {
    space();
    if (i_ >= s_.size()) fail("unexpected end");
    Json v;
    const char c = s_[i_];
    if (c == '{') {
      v.kind = Json::Object;
      ++i_;
      space();
      if (i_ < s_.size() && s_[i_] == '}') { ++i_; return v; }
      while (true) {
        std::string key = string();
        expect(':');
        v.fields.emplace_back(std::move(key), value());
        space();
        if (i_ < s_.size() && s_[i_] == ',') { ++i_; continue; }
        expect('}');
        return v;
      }
    }
    if (c == '[') {
      v.kind = Json::Array;
      ++i_;
      space();
      if (i_ < s_.size() && s_[i_] == ']') { ++i_; return v; }
      while (true) {
        v.items.push_back(value());
        space();
        if (i_ < s_.size() && s_[i_] == ',') { ++i_; continue; }
        expect(']');
        return v;
      }
    }
    if (c == '"') {
      v.kind = Json::String;
      v.str = string();
      return v;
    }
    if (take("true")) { v.kind = Json::Bool; v.b = true; return v; }
    if (take("false")) { v.kind = Json::Bool; return v; }
    if (take("null")) return v;
    size_t used = 0;
    v.kind = Json::Number;
    try {
      v.num = std::stod(s_.substr(i_, 32), &used);
    } catch (const std::exception&) {
      fail("not a value");
    }
    i_ += used;
    return v;
  }
};

Json parse_json(const std::string& text) { return JsonParser(text).parse(); }

std::string read_file(const fs::path& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot read " + path.string());
  std::ostringstream out;
  out << f.rdbuf();
  return out.str();
}

std::string json_str(const std::string& s) {
  std::string out = "\"";
  for (const char c : s) {
    if (c == '"' || c == '\\') out += '\\';
    out += c;
  }
  return out + "\"";
}

// --- .npy ---------------------------------------------------------------------

struct NpyHeader {
  std::string descr;
  std::vector<int64_t> shape;
  size_t data_offset = 0;
};

// The header of a .npy file held at p (n bytes): dtype descr, shape, where the data starts.
NpyHeader npy_header(const char* p, size_t n, const std::string& what) {
  if (n < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) throw std::runtime_error(what + " is not a .npy file");
  const int major = static_cast<unsigned char>(p[6]);
  size_t len = 0, start = 0;
  if (major == 1) {
    len = static_cast<unsigned char>(p[8]) | (static_cast<unsigned char>(p[9]) << 8);
    start = 10;
  } else {
    if (n < 12) throw std::runtime_error(what + ": short .npy header");
    uint32_t l;
    std::memcpy(&l, p + 8, 4);
    len = l;
    start = 12;
  }
  if (start + len > n) throw std::runtime_error(what + ": short .npy header");
  const std::string h(p + start, len);
  NpyHeader out;
  out.data_offset = start + len;
  auto field = [&](const std::string& key) {
    const size_t at = h.find("'" + key + "'");
    if (at == std::string::npos) throw std::runtime_error(what + ": .npy header has no " + key);
    return h.substr(h.find(':', at) + 1);
  };
  const std::string d = field("descr");
  const size_t q0 = d.find('\''), q1 = d.find('\'', q0 + 1);
  out.descr = d.substr(q0 + 1, q1 - q0 - 1);
  const std::string order = field("fortran_order");
  if (order.find("True") == order.find_first_not_of(' '))
    throw std::runtime_error(what + ": Fortran-ordered arrays are not read");
  const std::string s = field("shape");
  const std::string dims = s.substr(s.find('(') + 1, s.find(')') - s.find('(') - 1);
  std::stringstream ss(dims);
  std::string item;
  while (std::getline(ss, item, ','))
    if (item.find_first_not_of(" ") != std::string::npos) out.shape.push_back(std::stoll(item));
  return out;
}

// A float32 array from a .npy file, as a contiguous CPU tensor.
at::Tensor read_npy_float(const fs::path& path) {
  const std::string bytes = read_file(path);
  const NpyHeader h = npy_header(bytes.data(), bytes.size(), path.string());
  if (h.descr != "<f4") throw Refusal(path.string() + " holds dtype " + h.descr + "; float32 (<f4) expected");
  at::Tensor t = at::empty(h.shape, at::TensorOptions().dtype(at::kFloat));
  const size_t need = t.numel() * t.element_size();
  if (h.data_offset + need > bytes.size()) throw std::runtime_error(path.string() + " is truncated");
  std::memcpy(t.data_ptr(), bytes.data() + h.data_offset, need);
  return t;
}

// A CPU tensor as a float32 .npy file (version 1.0).
void write_npy(const fs::path& path, const at::Tensor& x) {
  const at::Tensor t = x.to(at::kFloat).contiguous();
  std::string shape;
  for (const int64_t d : t.sizes()) shape += std::to_string(d) + ",";
  if (t.dim() > 1) shape.pop_back();
  std::string header = "{'descr': '<f4', 'fortran_order': False, 'shape': (" + shape + "), }";
  header.append(63 - (10 + header.size()) % 64, ' ');  // the data starts at a multiple of 64
  header += '\n';
  std::ofstream f(path, std::ios::binary);
  f.write("\x93NUMPY\x01\x00", 8);
  const uint16_t len = header.size();
  f.write(reinterpret_cast<const char*>(&len), 2);
  f << header;
  f.write(static_cast<const char*>(t.data_ptr()), t.numel() * t.element_size());
  if (!f) throw std::runtime_error("cannot write " + path.string());
}

// --- params.npz: numpy's zip of raw-byte .npy members ----------------------------

class MappedFile {
 public:
  explicit MappedFile(const fs::path& path) {
    const int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) throw std::runtime_error("cannot open " + path.string());
    struct stat st;
    ::fstat(fd, &st);
    size_ = st.st_size;
    data_ = size_ ? static_cast<const char*>(::mmap(nullptr, size_, PROT_READ, MAP_PRIVATE, fd, 0)) : nullptr;
    ::close(fd);
    if (data_ == MAP_FAILED) throw std::runtime_error("cannot map " + path.string());
  }
  ~MappedFile() {
    if (data_ != nullptr && data_ != MAP_FAILED) ::munmap(const_cast<char*>(data_), size_);
  }
  const char* data() const { return data_; }
  size_t size() const { return size_; }

 private:
  const char* data_ = nullptr;
  size_t size_ = 0;
};

template <typename T>
T le(const char* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

// Member name -> (offset, size) of its stored bytes. Sizes and offsets come from the
// central directory and its zip64 extra fields (numpy writes every member with
// force_zip64, so the local headers' 32-bit sizes are placeholders).
std::map<std::string, std::pair<size_t, size_t>> zip_members(const MappedFile& f, const std::string& what) {
  const char* p = f.data();
  const size_t n = f.size();
  size_t eocd = std::string::npos;  // the end-of-directory record, before a comment of up to 64 KiB
  for (size_t i = n < 22 ? 0 : n - 22 + 1; i-- > 0 && n - i <= 22 + 65535;)
    if (le<uint32_t>(p + i) == 0x06054b50) { eocd = i; break; }
  if (eocd == std::string::npos) throw std::runtime_error(what + " is not a zip file");
  uint64_t entries = le<uint16_t>(p + eocd + 10), cd_offset = le<uint32_t>(p + eocd + 16);
  if (eocd >= 20 && le<uint32_t>(p + eocd - 20) == 0x07064b50) {  // zip64 end-of-directory locator
    const uint64_t rec = le<uint64_t>(p + eocd - 20 + 8);
    if (rec + 56 > n || le<uint32_t>(p + rec) != 0x06064b50) throw std::runtime_error(what + ": bad zip64 record");
    entries = le<uint64_t>(p + rec + 32);
    cd_offset = le<uint64_t>(p + rec + 48);
  }
  std::map<std::string, std::pair<size_t, size_t>> out;
  size_t at = cd_offset;
  for (uint64_t e = 0; e < entries; ++e) {
    if (at + 46 > n || le<uint32_t>(p + at) != 0x02014b50) throw std::runtime_error(what + ": bad central directory");
    const uint16_t method = le<uint16_t>(p + at + 10);
    uint64_t csize = le<uint32_t>(p + at + 20), usize = le<uint32_t>(p + at + 24);
    const uint16_t name_len = le<uint16_t>(p + at + 28), extra_len = le<uint16_t>(p + at + 30),
                   comment_len = le<uint16_t>(p + at + 32);
    uint64_t local = le<uint32_t>(p + at + 42);
    const std::string name(p + at + 46, name_len);
    for (size_t x = at + 46 + name_len; x + 4 <= at + 46 + name_len + extra_len;) {
      const uint16_t id = le<uint16_t>(p + x), len = le<uint16_t>(p + x + 2);
      if (id == 0x0001) {  // zip64: the 32-bit fields set to 0xFFFFFFFF, in this order
        size_t y = x + 4;
        if (usize == 0xFFFFFFFFu) { usize = le<uint64_t>(p + y); y += 8; }
        if (csize == 0xFFFFFFFFu) { csize = le<uint64_t>(p + y); y += 8; }
        if (local == 0xFFFFFFFFu) { local = le<uint64_t>(p + y); }
      }
      x += 4 + len;
    }
    if (method != 0) throw Refusal(what + ": member " + name + " is compressed; numpy's savez stores members");
    if (local + 30 > n || le<uint32_t>(p + local) != 0x04034b50) throw std::runtime_error(what + ": bad local header");
    const size_t data = local + 30 + le<uint16_t>(p + local + 26) + le<uint16_t>(p + local + 28);
    if (data + csize > n) throw std::runtime_error(what + ": member " + name + " is truncated");
    out[name] = {data, csize};
    at += 46 + name_len + extra_len + comment_len;
  }
  return out;
}

std::pair<at::ScalarType, size_t> leaf_dtype(const std::string& name) {
  static const std::map<std::string, std::pair<at::ScalarType, size_t>> types = {
      {"float32", {at::kFloat, 4}}, {"bfloat16", {at::kBFloat16, 2}}, {"float16", {at::kHalf, 2}},
      {"int64", {at::kLong, 8}},    {"int32", {at::kInt, 4}},         {"bool", {at::kBool, 1}}};
  const auto it = types.find(name);
  if (it == types.end()) throw Refusal("params leaf dtype " + name + " is not one mtt_serve reads");
  return it->second;
}

// params.npz's leaves by name, each its raw bytes viewed by leaf_spec, on device.
std::map<std::string, at::Tensor> read_params(const fs::path& path, const Json& leaf_spec, const at::Device& device) {
  const MappedFile f(path);
  const auto members = zip_members(f, path.string());
  std::map<std::string, at::Tensor> out;
  for (const auto& [name, meta] : leaf_spec.fields) {
    const auto it = members.find(name + ".npy");
    if (it == members.end()) throw std::runtime_error(path.string() + " has no leaf " + name);
    const char* npy = f.data() + it->second.first;
    const NpyHeader h = npy_header(npy, it->second.second, path.string() + ":" + name);
    std::vector<int64_t> shape;
    for (const Json& d : meta.at("shape").items) shape.push_back(static_cast<int64_t>(d.num));
    const auto [dtype, size] = leaf_dtype(meta.at("dtype").str);
    at::Tensor t = at::empty(shape, at::TensorOptions().dtype(dtype));
    const size_t bytes = t.numel() * size;
    if (h.descr != "|u1" || h.shape.size() != 1 || static_cast<size_t>(h.shape[0]) != bytes ||
        h.data_offset + bytes > it->second.second)
      throw std::runtime_error("params leaf " + name + " is not " + std::to_string(bytes) + " raw bytes");
    std::memcpy(t.data_ptr(), npy + h.data_offset, bytes);
    out[name] = t.to(device);
  }
  return out;
}

// --- the package's pytree specs --------------------------------------------------

// The leaves of a serialised treespec ([1, node]) in flattening order, each as the path
// of keys (a tuple's position, a dict's key) from the root.
void leaves(const Json& node, std::vector<std::string>& path, std::vector<std::vector<std::string>>& out) {
  const Json& type = node.at("type");
  const auto& children = node.at("children_spec").items;
  if (type.kind == Json::Null) {
    out.push_back(path);
    return;
  }
  std::vector<std::string> keys;
  if (type.str == "builtins.dict") {
    for (const Json& k : parse_json(node.at("context").str).items) keys.push_back(k.str);
  } else if (type.str == "builtins.tuple") {
    for (size_t i = 0; i < children.size(); ++i) keys.push_back(std::to_string(i));
  } else {
    throw Refusal("the package's call spec holds a " + type.str + ", which mtt_serve does not flatten");
  }
  if (keys.size() != children.size()) throw std::runtime_error("a treespec's context and children differ");
  for (size_t i = 0; i < children.size(); ++i) {
    path.push_back(keys[i]);
    leaves(children[i], path, out);
    path.pop_back();
  }
}

std::vector<std::vector<std::string>> spec_leaves(const std::string& spec) {
  const Json root = parse_json(spec);
  if (root.kind != Json::Array || root.items.size() != 2) throw std::runtime_error("unexpected treespec " + spec);
  std::vector<std::string> path;
  std::vector<std::vector<std::string>> out;
  leaves(root.items[1], path, out);
  return out;
}

// --- options -----------------------------------------------------------------------

struct Options {
  fs::path artifact, context, text, out, ops_lib;
  std::string device = "cuda";
  int64_t batch = 64, repeat = 1;
};

Options parse_args(int argc, char** argv) {
  Options o;
  auto usage = [] {
    return Refusal(
        "usage: mtt_serve ARTIFACT_DIR --context C.npy [--text T.npy] --out DIR [--device cuda|cpu] "
        "[--batch N] [--repeat R] [--ops-lib PATH]");
  };
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) throw usage();
      return argv[++i];
    };
    if (a == "--context") o.context = next();
    else if (a == "--text") o.text = next();
    else if (a == "--out") o.out = next();
    else if (a == "--device") o.device = next();
    else if (a == "--batch") o.batch = std::stoll(next());
    else if (a == "--repeat") o.repeat = std::stoll(next());
    else if (a == "--ops-lib") o.ops_lib = next();
    else if (!a.empty() && a[0] != '-' && o.artifact.empty()) o.artifact = a;
    else throw usage();
  }
  if (o.artifact.empty() || o.context.empty() || o.out.empty() || o.batch < 1 || o.repeat < 0) throw usage();
  if (o.device != "cuda" && o.device != "cpu") throw Refusal("--device must be cuda or cpu, not '" + o.device + "'");
  if (o.ops_lib.empty()) o.ops_lib = fs::read_symlink("/proc/self/exe").parent_path() / "libmtt_ops.so";
  return o;
}

void sync(const at::Device& device) {
#ifdef MTT_WITH_CUDA
  if (device.is_cuda()) c10::cuda::device_synchronize();
#endif
}

// A double in the shortest form that reads back to it: numbers are reported unrounded.
std::string num(double x) {
  char buf[32];
  return std::string(buf, std::to_chars(buf, buf + sizeof(buf), x).ptr);
}

// Whether cuBLAS may reduce in reduced precision (the Python flag
// torch.backends.cuda.matmul.allow_{bf16,fp16}_reduced_precision_reduction): a bool in some
// releases of libtorch, an option whose first value allows it in others.
template <typename T>
bool reduced_allowed(T option) {
  if constexpr (std::is_same_v<T, bool>) return option;
  else return static_cast<int>(option) == 0;
}

std::string precision_name(at::Float32MatmulPrecision p) {
  switch (p) {
    case at::Float32MatmulPrecision::HIGHEST: return "highest";
    case at::Float32MatmulPrecision::HIGH: return "high";
    default: return "medium";
  }
}

int serve(const Options& o, double t_main) {
  const Json manifest = parse_json(read_file(o.artifact / "manifest.json"));
  const std::string format = manifest.at("format").str;
  if (format == "torch.export")
    throw Refusal(o.artifact.string() + " holds a torch.export program (program.pt2); mtt_serve serves only "
                  "AOTInductor packages (export with format=\"aoti\")");
  if (format != "aoti") throw Refusal(o.artifact.string() + " holds a '" + format + "' artifact, not an AOTInductor package");
  std::vector<std::string> platforms;
  for (const Json& p : manifest.at("platforms").items) platforms.push_back(p.str);
  if (std::find(platforms.begin(), platforms.end(), o.device) == platforms.end()) {
    std::string list;
    for (const auto& p : platforms) list += (list.empty() ? "'" : ", '") + p + "'";
    throw Refusal(o.artifact.string() + " holds an AOTInductor package compiled for [" + list +
                  "]; it cannot serve on '" + o.device + "' (export it again on that device)");
  }
  const bool multimodal = manifest.at("multimodal").b;
  if (multimodal && o.text.empty()) throw Refusal("this artifact was exported multimodal: pass --text");
#ifndef MTT_WITH_CUDA
  if (o.device == "cuda") throw Refusal("this mtt_serve was built without CUDA; pass --device cpu");
#else
  if (o.device == "cuda" && c10::cuda::device_count() == 0) throw Refusal("no CUDA device is available");
#endif
  const at::Device device = o.device == "cuda" ? at::Device(at::kCUDA, 0) : at::Device(at::kCPU);

  const int64_t context_len = static_cast<int64_t>(manifest.at("context_len").num);
  at::Tensor context = read_npy_float(o.context);
  if (context.dim() != 2 || context.size(0) < 1 || context.size(1) != context_len)
    throw Refusal(o.context.string() + " has shape " + c10::str(context.sizes()) + "; expected (N, " +
                  std::to_string(context_len) + ")");
  at::Tensor text;
  if (multimodal) {
    text = read_npy_float(o.text);
    const int64_t patches = static_cast<int64_t>(manifest.at("num_patches").num);
    const int64_t dims = static_cast<int64_t>(manifest.at("text_dims").num);
    if (text.dim() != 3 || text.size(0) != context.size(0) || text.size(1) != patches || text.size(2) != dims)
      throw Refusal(o.text.string() + " has shape " + c10::str(text.sizes()) + "; expected (" +
                    std::to_string(context.size(0)) + ", " + std::to_string(patches) + ", " +
                    std::to_string(dims) + ")");
  }

  // The GEMMs run under stated flags: TF32 off, as the Python serving path runs them.
  auto& ctx = at::globalContext();
  ctx.setAllowTF32CuBLAS(false);
  ctx.setFloat32MatmulPrecision("highest");

  const double t_load = now_s();
  void* ops = ::dlopen(o.ops_lib.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (ops == nullptr) throw std::runtime_error("cannot load the ops library " + o.ops_lib.string() + ": " + ::dlerror());
  using Launches = int64_t (*)(const char*);
  using Reset = void (*)();
  const auto launches = reinterpret_cast<Launches>(::dlsym(ops, "mtt_ops_launches"));
  const auto reset = reinterpret_cast<Reset>(::dlsym(ops, "mtt_ops_reset_launches"));
  if (launches == nullptr || reset == nullptr) throw std::runtime_error(o.ops_lib.string() + " is not the mtt ops library");
  torch::inductor::AOTIModelPackageLoader loader((o.artifact / "package.pt2").string(), "model", false, 1,
                                                 device.is_cuda() ? device.index() : -1);
  const double package_s = now_s() - t_load;
  const auto params = read_params(o.artifact / "params.npz", manifest.at("leaf_spec"), device);
  sync(device);
  const double load_s = now_s() - t_load;

  const std::vector<std::string> spec = loader.get_call_spec();
  const auto in_leaves = spec_leaves(spec.at(0));
  std::vector<std::string> out_names;
  for (const auto& path : spec_leaves(spec.at(1))) out_names.push_back(path.empty() ? "output" : path.back());
  // Each input leaf: a params leaf by name, or the context or text row block.
  std::vector<std::pair<int, const at::Tensor*>> order;  // 0 param, 1 context, 2 text
  for (const auto& path : in_leaves) {
    if (path.size() == 3 && path[0] == "0" && path[1] == "0") {
      const auto it = params.find(path[2]);
      if (it == params.end()) throw std::runtime_error("the package takes params leaf " + path[2] + ", absent from params.npz");
      order.emplace_back(0, &it->second);
    } else if (path.size() == 2 && path[0] == "0" && path[1] == "1") {
      order.emplace_back(1, nullptr);
    } else if (path.size() == 2 && path[0] == "0" && path[1] == "2" && multimodal) {
      order.emplace_back(2, nullptr);
    } else {
      std::string joined;
      for (const auto& k : path) joined += "/" + k;
      throw Refusal("the package takes an input at " + joined + ", which mtt_serve does not supply");
    }
  }

  void* stream = nullptr;
#ifdef MTT_WITH_CUDA
  if (device.is_cuda()) stream = c10::cuda::getCurrentCUDAStream(device.index()).stream();
#endif
  const int64_t rows = context.size(0), batch = o.batch;
  const int64_t batches = (rows + batch - 1) / batch;
  // One pass over every row: each batch's outputs on the host, real rows only.
  auto pass = [&]() {
    std::vector<std::vector<at::Tensor>> outs(batches);
    for (int64_t b = 0; b < batches; ++b) {
      const int64_t start = b * batch, real = std::min(batch, rows - start);
      auto pad = [&](const at::Tensor& x) {
        at::Tensor part = x.narrow(0, start, real);
        if (real < batch) {
          std::vector<int64_t> shape(part.sizes().begin(), part.sizes().end());
          shape[0] = batch - real;
          part = at::cat({part, part.narrow(0, real - 1, 1).expand(shape)});
        }
        return part.to(device);
      };
      const at::Tensor c = pad(context);
      const at::Tensor t = multimodal ? pad(text) : at::Tensor();
      std::vector<at::Tensor> inputs;
      inputs.reserve(order.size());
      for (const auto& [kind, param] : order) inputs.push_back(kind == 0 ? *param : kind == 1 ? c : t);
      for (const at::Tensor& y : loader.run(inputs, stream)) outs[b].push_back(y.to(at::kCPU).narrow(0, 0, real));
    }
    sync(device);
    return outs;
  };

  reset();
  const auto first = pass();
  if (first.at(0).size() != out_names.size())
    throw std::runtime_error("the package returned " + std::to_string(first[0].size()) + " outputs, its out_spec names " +
                             std::to_string(out_names.size()));
  std::vector<double> rates;
  for (int64_t r = 0; r < o.repeat; ++r) {
    const double start = now_s();
    const auto again = pass();
    rates.push_back(rows / (now_s() - start));
    for (int64_t b = 0; b < batches; ++b)
      for (size_t k = 0; k < out_names.size(); ++k)
        if (!at::equal(again[b][k], first[b][k]))
          throw std::runtime_error("pass " + std::to_string(r + 1) + " batch " + std::to_string(b) + " output " +
                                   out_names[k] + " differs from the first pass");
  }
  fs::create_directories(o.out);
  std::string shapes;
  for (size_t k = 0; k < out_names.size(); ++k) {
    std::vector<at::Tensor> parts;
    for (const auto& b : first) parts.push_back(b[k]);
    const at::Tensor y = at::cat(parts);
    write_npy(o.out / (out_names[k] + ".npy"), y);
    shapes += (k ? ", " : "") + json_str(out_names[k]) + ": " + c10::str(y.sizes());
  }

  const char* ops_names[4] = {"fused_causal_attention", "flash_causal_attention", "fused_qkv_causal_attention",
                              "fused_chronos_attention"};
  const int64_t served = batches * (o.repeat + 1);
  std::string counts_text, counts_json;
  for (const char* op : ops_names) {
    const int64_t n = launches(op);
    counts_json += std::string(counts_json.empty() ? "" : ", ") + json_str(op) + ": " + std::to_string(n);
    if (n) counts_text += std::string(counts_text.empty() ? "" : ", ") + op + " " + std::to_string(n) + " (" +
                          num(static_cast<double>(n) / served) + " a batch)";
  }
  const bool tf32 = ctx.allowTF32CuBLAS();
  const std::string precision = precision_name(ctx.float32MatmulPrecision());
  const bool bf16_red = reduced_allowed(ctx.allowBF16ReductionCuBLAS());
  const bool fp16_red = reduced_allowed(ctx.allowFP16ReductionCuBLAS());
  std::vector<double> sorted = rates;
  std::sort(sorted.begin(), sorted.end());
  const double median = sorted.empty() ? 0.0 : sorted[sorted.size() / 2];
  std::string rates_text, rates_json;
  for (const double r : rates) {
    rates_text += (rates_text.empty() ? "" : ", ") + num(r);
    rates_json += (rates_json.empty() ? "" : ", ") + num(r);
  }

  std::cout << "[mtt_serve] ops library " << o.ops_lib.string() << "; package " << (o.artifact / "package.pt2").string()
            << " on " << device << "\n";
  std::cout << "[mtt_serve] load " << num(load_s) << " s (ops library and package " << num(package_s)
            << " s, params.npz " << num(load_s - package_s) << " s)\n";
  std::cout << "[mtt_serve] " << rows << " series in " << batches << " batches of " << batch << ", " << o.repeat
            << " timed passes after one warm-up pass, synchronised: median " << num(median) << " series/s ("
            << rates_text << "); every pass bit-equal to the first, batch by batch\n";
  std::cout << "[mtt_serve] kernel launches over " << served << " batches: "
            << (counts_text.empty() ? "none" : counts_text) << "\n";
  std::cout << "[mtt_serve] matmul flags: allow_tf32_cublas=" << tf32 << " float32_matmul_precision=" << precision
            << " allow_bf16_reduced_precision_reduction=" << bf16_red
            << " allow_fp16_reduced_precision_reduction=" << fp16_red << "\n";
  std::cout << "{\"t_main\": " << num(t_main) << ", \"load_s\": " << num(load_s)
            << ", \"package_load_s\": " << num(package_s) << ", \"device\": " << json_str(c10::str(device))
            << ", \"series\": " << rows << ", \"batch\": " << batch << ", \"batches\": " << served
            << ", \"series_per_s\": [" << rates_json << "], \"launches\": {" << counts_json
            << "}, \"flags\": {\"allow_tf32_cublas\": " << (tf32 ? "true" : "false")
            << ", \"float32_matmul_precision\": " << json_str(precision)
            << ", \"allow_bf16_reduced_precision_reduction\": " << (bf16_red ? "true" : "false")
            << ", \"allow_fp16_reduced_precision_reduction\": " << (fp16_red ? "true" : "false") << "}, \"outputs\": {" << shapes << "}}"
            << std::endl;
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const double t_main = now_s();
  try {
    return serve(parse_args(argc, argv), t_main);
  } catch (const Refusal& e) {
    std::cerr << "mtt_serve: " << e.what() << std::endl;
    return 2;
  } catch (const c10::Error& e) {
    std::cerr << "mtt_serve: " << e.what_without_backtrace() << std::endl;
    return 1;
  } catch (const std::exception& e) {
    std::cerr << "mtt_serve: " << e.what() << std::endl;
    return 1;
  }
}
