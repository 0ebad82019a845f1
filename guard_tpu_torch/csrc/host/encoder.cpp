// guard_tpu_torch native columnar encoder (host side of the port).
//
// A copy of the JAX package's encoder (native/encoder.cpp): parses JSON
// documents and emits the node/edge columns and the shared
// string-intern table the device walk consumes (the layout is
// guard_tpu_torch/ops/encoder.py's). The parser is the JAX package's;
// the output is not: where that encoder pads every document of a batch
// to the largest one (a dense (D, max nodes) block per column), this
// one returns the columns RAGGED: every document's nodes and edges
// concatenated, with per-document offsets. The port cuts its
// per-size-bucket batches out of these columns on the host
// (ops/encoder.groups_from_ragged), the batches `encode_bucketed`
// builds from document trees.
//
// C ABI (used from Python via ctypes, guard_tpu_torch/ops/native_encoder.py):
//   guard_encode_json_ragged(docs, n_docs) -> RaggedBatch*
//   guard_ragged_free(RaggedBatch*)
//
// Build: g++ -O2 -fPIC -shared -std=c++17 (ops/_native_lib.build) ->
// libguard_ragged_encoder.so in the port's library directory

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// value kinds — must match guard_tpu_torch/core/values.py
// ---------------------------------------------------------------------------
enum Kind : int32_t {
  K_NULL = 0,
  K_STRING = 1,
  K_BOOL = 3,
  K_INT = 4,
  K_FLOAT = 5,
  K_LIST = 7,
  K_MAP = 8,
};

struct Interner {
  std::unordered_map<std::string, int32_t> ids;
  std::vector<std::string> strings;

  int32_t intern(const std::string& s) {
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(strings.size());
    ids.emplace(s, id);
    strings.push_back(s);
    return id;
  }
};

struct DocColumns {
  std::vector<int32_t> node_kind, node_parent, scalar_id, child_count;
  std::vector<int32_t> num_hi, num_lo;
  std::vector<int32_t> edge_parent, edge_child, edge_key_id, edge_index;
  // doc has a number with no exact encoding (int outside i64); must be
  // evaluated by the CPU oracle (guard_tpu_torch/ops/encoder.py num_key)
  bool num_exotic = false;
};

// Order-preserving exact (hi, lo) int32 key pair for numerics — MUST
// match guard_tpu_torch/ops/encoder.py num_key(): lexicographic signed
// (hi, lo) compare == exact i64 / f64-total-order compare. The XOR with
// 2^31 reinterpreted as int32 equals the arithmetic bias subtraction.
static void int_key(long long iv, int32_t* hi, int32_t* lo) {
  unsigned long long u =
      static_cast<unsigned long long>(iv) + 0x8000000000000000ULL;
  *hi = static_cast<int32_t>(static_cast<uint32_t>(u >> 32) ^ 0x80000000U);
  *lo = static_cast<int32_t>(static_cast<uint32_t>(u) ^ 0x80000000U);
}

static void float_key(double fv, int32_t* hi, int32_t* lo) {
  if (fv == 0.0) fv = 0.0;  // collapse -0.0
  unsigned long long b;
  memcpy(&b, &fv, 8);
  unsigned long long u = (b >> 63) ? ~b : (b | 0x8000000000000000ULL);
  *hi = static_cast<int32_t>(static_cast<uint32_t>(u >> 32) ^ 0x80000000U);
  *lo = static_cast<int32_t>(static_cast<uint32_t>(u) ^ 0x80000000U);
}

// ---------------------------------------------------------------------------
// Minimal recursive-descent JSON parser writing columns directly.
// ---------------------------------------------------------------------------
struct Parser {
  const char* p;
  const char* end;
  DocColumns* out;
  Interner* interner;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
  }

  bool parse_string_raw(std::string& s) {
    if (p >= end || *p != '"') return false;
    p++;
    s.clear();
    while (p < end && *p != '"') {
      char c = *p++;
      if (c == '\\' && p < end) {
        char e = *p++;
        switch (e) {
          case 'n': s.push_back('\n'); break;
          case 't': s.push_back('\t'); break;
          case 'r': s.push_back('\r'); break;
          case 'b': s.push_back('\b'); break;
          case 'f': s.push_back('\f'); break;
          case '/': s.push_back('/'); break;
          case '\\': s.push_back('\\'); break;
          case '"': s.push_back('"'); break;
          case 'u': {
            if (end - p < 4) return false;
            unsigned code = 0;
            for (int i = 0; i < 4; i++) {
              char h = *p++;
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else return false;
            }
            // UTF-8 encode (BMP only; surrogate pairs kept as-is)
            if (code < 0x80) {
              s.push_back(static_cast<char>(code));
            } else if (code < 0x800) {
              s.push_back(static_cast<char>(0xC0 | (code >> 6)));
              s.push_back(static_cast<char>(0x80 | (code & 0x3F)));
            } else {
              s.push_back(static_cast<char>(0xE0 | (code >> 12)));
              s.push_back(static_cast<char>(0x80 | ((code >> 6) & 0x3F)));
              s.push_back(static_cast<char>(0x80 | (code & 0x3F)));
            }
            break;
          }
          default: return false;
        }
      } else {
        s.push_back(c);
      }
    }
    if (p >= end) return false;
    p++;  // closing quote
    return true;
  }

  int32_t new_node(int32_t kind, int32_t parent) {
    int32_t idx = static_cast<int32_t>(out->node_kind.size());
    out->node_kind.push_back(kind);
    out->node_parent.push_back(parent);
    out->scalar_id.push_back(-1);
    out->num_hi.push_back(0);
    out->num_lo.push_back(0);
    out->child_count.push_back(0);
    return idx;
  }

  // returns node index or -1 on failure
  int32_t parse_value(int32_t parent) {
    skip_ws();
    if (p >= end) return -1;
    char c = *p;
    if (c == '{') return parse_map(parent);
    if (c == '[') return parse_list(parent);
    if (c == '"') {
      std::string s;
      if (!parse_string_raw(s)) return -1;
      int32_t idx = new_node(K_STRING, parent);
      out->scalar_id[idx] = interner->intern(s);
      return idx;
    }
    if (c == 't' && end - p >= 4 && strncmp(p, "true", 4) == 0) {
      p += 4;
      int32_t idx = new_node(K_BOOL, parent);
      int_key(1, &out->num_hi[idx], &out->num_lo[idx]);
      return idx;
    }
    if (c == 'f' && end - p >= 5 && strncmp(p, "false", 5) == 0) {
      p += 5;
      int32_t idx = new_node(K_BOOL, parent);
      int_key(0, &out->num_hi[idx], &out->num_lo[idx]);
      return idx;
    }
    if (c == 'n' && end - p >= 4 && strncmp(p, "null", 4) == 0) {
      p += 4;
      return new_node(K_NULL, parent);
    }
    // number
    const char* start = p;
    bool is_float = false;
    if (p < end && (*p == '-' || *p == '+')) p++;
    while (p < end &&
           ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' || *p == 'E' ||
            *p == '+' || *p == '-')) {
      if (*p == '.' || *p == 'e' || *p == 'E') is_float = true;
      p++;
    }
    if (p == start) return -1;
    std::string num(start, p - start);
    char* endp = nullptr;
    if (is_float) {
      double v = strtod(num.c_str(), &endp);
      if (endp == num.c_str()) return -1;
      int32_t idx = new_node(K_FLOAT, parent);
      float_key(v, &out->num_hi[idx], &out->num_lo[idx]);
      return idx;
    }
    // integers parse exactly as i64 (the reference compares native
    // i64, path_value.rs:1071-1191); out-of-range ints have no exact
    // device encoding and flag the doc for CPU-oracle evaluation
    errno = 0;
    long long v = strtoll(num.c_str(), &endp, 10);
    if (endp == num.c_str()) return -1;
    int32_t idx = new_node(K_INT, parent);
    if (errno == ERANGE) {
      out->num_exotic = true;
    } else {
      int_key(v, &out->num_hi[idx], &out->num_lo[idx]);
    }
    return idx;
  }

  int32_t parse_map(int32_t parent) {
    p++;  // '{'
    int32_t idx = new_node(K_MAP, parent);
    skip_ws();
    if (p < end && *p == '}') {
      p++;
      return idx;
    }
    int32_t count = 0;
    while (p < end) {
      skip_ws();
      std::string key;
      if (!parse_string_raw(key)) return -1;
      skip_ws();
      if (p >= end || *p != ':') return -1;
      p++;
      int32_t child = parse_value(idx);
      if (child < 0) return -1;
      out->edge_parent.push_back(idx);
      out->edge_child.push_back(child);
      out->edge_key_id.push_back(interner->intern(key));
      out->edge_index.push_back(-1);
      count++;
      skip_ws();
      if (p < end && *p == ',') {
        p++;
        continue;
      }
      if (p < end && *p == '}') {
        p++;
        out->child_count[idx] = count;
        return idx;
      }
      return -1;
    }
    return -1;
  }

  int32_t parse_list(int32_t parent) {
    p++;  // '['
    int32_t idx = new_node(K_LIST, parent);
    skip_ws();
    if (p < end && *p == ']') {
      p++;
      return idx;
    }
    int32_t count = 0;
    while (p < end) {
      int32_t child = parse_value(idx);
      if (child < 0) return -1;
      out->edge_parent.push_back(idx);
      out->edge_child.push_back(child);
      out->edge_key_id.push_back(-1);
      out->edge_index.push_back(count);
      count++;
      skip_ws();
      if (p < end && *p == ',') {
        p++;
        continue;
      }
      if (p < end && *p == ']') {
        p++;
        out->child_count[idx] = count;
        return idx;
      }
      return -1;
    }
    return -1;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Ragged output: every document's columns concatenated in document order,
// with offsets; node_parent and edge_parent/edge_child are indices local to
// the document. An unparseable document contributes no node and no edge.
// ---------------------------------------------------------------------------
struct RaggedBatch {
  int32_t n_docs;
  int32_t n_strings;
  int64_t n_nodes;  // total over the documents
  int64_t n_edges;
  const int64_t* node_offset;  // (n_docs + 1): document i's nodes are
  const int64_t* edge_offset;  // [node_offset[i], node_offset[i + 1])
  const int32_t* node_kind;
  const int32_t* node_parent;
  const int32_t* scalar_id;
  const int32_t* num_hi;
  const int32_t* num_lo;
  const int32_t* child_count;
  const int32_t* edge_parent;
  const int32_t* edge_child;
  const int32_t* edge_key_id;
  const int32_t* edge_index;
  const uint8_t* doc_exotic;  // (n_docs)
  const char* string_blob;    // concatenated NUL-terminated strings
  int64_t string_blob_len;
  int32_t error_doc;  // -1 ok; else index of first unparseable doc
  void* owner;        // the storage behind the pointers above
};

}  // extern "C"

namespace {

struct RaggedOwner {
  RaggedBatch pub{};
  DocColumns all;
  std::vector<int64_t> node_offset, edge_offset;
  std::vector<uint8_t> doc_exotic;
  std::string blob;
};

template <typename T>
void append(std::vector<T>& to, const std::vector<T>& from) {
  to.insert(to.end(), from.begin(), from.end());
}

}  // namespace

extern "C" {

RaggedBatch* guard_encode_json_ragged(const char** docs, int32_t n_docs) {
  auto* o = new RaggedOwner();
  Interner interner;
  DocColumns cur;
  int32_t error_doc = -1;
  o->node_offset.assign(1, 0);
  o->edge_offset.assign(1, 0);
  o->doc_exotic.assign(n_docs > 0 ? n_docs : 1, 0);

  for (int32_t i = 0; i < n_docs; i++) {
    // cleared, not reallocated: the vectors keep their capacity
    for (auto* v : {&cur.node_kind, &cur.node_parent, &cur.scalar_id,
                    &cur.child_count, &cur.num_hi, &cur.num_lo,
                    &cur.edge_parent, &cur.edge_child, &cur.edge_key_id,
                    &cur.edge_index}) {
      v->clear();
    }
    cur.num_exotic = false;
    Parser parser;
    parser.p = docs[i];
    parser.end = docs[i] + strlen(docs[i]);
    parser.out = &cur;
    parser.interner = &interner;
    int32_t root = parser.parse_value(-1);
    parser.skip_ws();
    if (root < 0 || parser.p != parser.end) {
      if (error_doc < 0) error_doc = i;
    } else {
      append(o->all.node_kind, cur.node_kind);
      append(o->all.node_parent, cur.node_parent);
      append(o->all.scalar_id, cur.scalar_id);
      append(o->all.num_hi, cur.num_hi);
      append(o->all.num_lo, cur.num_lo);
      append(o->all.child_count, cur.child_count);
      append(o->all.edge_parent, cur.edge_parent);
      append(o->all.edge_child, cur.edge_child);
      append(o->all.edge_key_id, cur.edge_key_id);
      append(o->all.edge_index, cur.edge_index);
      o->doc_exotic[i] = cur.num_exotic ? 1 : 0;
    }
    o->node_offset.push_back(static_cast<int64_t>(o->all.node_kind.size()));
    o->edge_offset.push_back(static_cast<int64_t>(o->all.edge_parent.size()));
  }

  for (const auto& s : interner.strings) {
    o->blob.append(s);
    o->blob.push_back('\0');
  }

  RaggedBatch* b = &o->pub;
  b->n_docs = n_docs;
  b->n_strings = static_cast<int32_t>(interner.strings.size());
  b->n_nodes = static_cast<int64_t>(o->all.node_kind.size());
  b->n_edges = static_cast<int64_t>(o->all.edge_parent.size());
  b->node_offset = o->node_offset.data();
  b->edge_offset = o->edge_offset.data();
  b->node_kind = o->all.node_kind.data();
  b->node_parent = o->all.node_parent.data();
  b->scalar_id = o->all.scalar_id.data();
  b->num_hi = o->all.num_hi.data();
  b->num_lo = o->all.num_lo.data();
  b->child_count = o->all.child_count.data();
  b->edge_parent = o->all.edge_parent.data();
  b->edge_child = o->all.edge_child.data();
  b->edge_key_id = o->all.edge_key_id.data();
  b->edge_index = o->all.edge_index.data();
  b->doc_exotic = o->doc_exotic.data();
  b->string_blob = o->blob.data();
  b->string_blob_len = static_cast<int64_t>(o->blob.size());
  b->error_doc = error_doc;
  b->owner = o;
  return b;
}

void guard_ragged_free(RaggedBatch* b) {
  if (!b) return;
  delete static_cast<RaggedOwner*>(b->owner);
}

}  // extern "C"
