// Fast parser for the weather-particle-simulator XML interchange format.
//
// The port's copy of native/xmlparse.cc. The reference parses these
// files with Python ElementTree (common/bad_weather.py:185-248). The
// format is rigid (<frame id t d rs> elements with <drop pid wp1 wp2 wd1
// wd2 ip1 ip2 iw1 iw2/> children, vectors as "(a;b;c)"), so this parser
// scans the buffer directly. Exposed through a minimal C ABI consumed via
// ctypes (raintpu_torch/particles/native.py); cold parses matter when a
// render farm touches thousands of sequence files.
//
// Built by raintpu_torch/cuda_build.py (g++ -O2 -fPIC -std=c++17 -shared)
// into raintpu_torch/_build/ at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Drop {
  int64_t pid;
  double wp1[3], wp2[3];
  double wd1, wd2;
  double ip1[2], ip2[2];
  double iw1, iw2;
};

struct Frame {
  int32_t id = 0, exposure = 0, start = 0, declared = 0;
  std::vector<Drop> drops;
};

struct Sim {
  std::vector<Frame> frames;
  std::string error;
};

// Find `needle` in [p, end); returns pointer past the needle or null.
const char* find_past(const char* p, const char* end, const char* needle) {
  size_t n = strlen(needle);
  const char* last = end - n;
  for (; p <= last; ++p) {
    if (p[0] == needle[0] && memcmp(p, needle, n) == 0) return p + n;
  }
  return nullptr;
}

// Parse attr="..." following p; returns value range in [*vb, *ve).
// The attribute name must be preceded by whitespace — otherwise e.g.
// looking up frame attribute `d` would match inside `id="..."`.
bool attr_value(const char* p, const char* end, const char* name,
                const char** vb, const char** ve) {
  std::string pat = std::string(name) + "=\"";
  const char* cur = p;
  while (true) {
    const char* v = find_past(cur, end, pat.c_str());
    if (!v) return false;
    const char* match = v - pat.size();
    if (match > p && (match[-1] == ' ' || match[-1] == '\t' ||
                      match[-1] == '\n' || match[-1] == '\r')) {
      const char* q = static_cast<const char*>(memchr(v, '"', end - v));
      if (!q) return false;
      *vb = v;
      *ve = q;
      return true;
    }
    cur = match + 1;
  }
}

double to_f(const char* b, const char* e) {
  char buf[64];
  size_t n = static_cast<size_t>(e - b);
  if (n >= sizeof(buf)) n = sizeof(buf) - 1;
  memcpy(buf, b, n);
  buf[n] = 0;
  return atof(buf);
}

int64_t to_i(const char* b, const char* e) {
  char buf[32];
  size_t n = static_cast<size_t>(e - b);
  if (n >= sizeof(buf)) n = sizeof(buf) - 1;
  memcpy(buf, b, n);
  buf[n] = 0;
  return atoll(buf);
}

// "(a;b;c)" -> out[dim]
bool vec_parse(const char* b, const char* e, double* out, int dim) {
  if (b >= e || *b != '(') return false;
  ++b;
  for (int i = 0; i < dim; ++i) {
    const char* sep = static_cast<const char*>(
        memchr(b, i == dim - 1 ? ')' : ';', e - b));
    if (!sep) return false;
    out[i] = to_f(b, sep);
    b = sep + 1;
  }
  return true;
}

bool attr_f(const char* p, const char* end, const char* name, double* out) {
  const char *vb, *ve;
  if (!attr_value(p, end, name, &vb, &ve)) return false;
  *out = to_f(vb, ve);
  return true;
}

bool attr_i(const char* p, const char* end, const char* name, int64_t* out) {
  const char *vb, *ve;
  if (!attr_value(p, end, name, &vb, &ve)) return false;
  *out = to_i(vb, ve);
  return true;
}

bool attr_vec(const char* p, const char* end, const char* name, double* out,
              int dim) {
  const char *vb, *ve;
  if (!attr_value(p, end, name, &vb, &ve)) return false;
  return vec_parse(vb, ve, out, dim);
}

}  // namespace

extern "C" {

void* rt_parse_xml(const char* path) {
  Sim* sim = new Sim();
  FILE* f = fopen(path, "rb");
  if (!f) {
    sim->error = "cannot open file";
    return sim;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  if (size > 0 && fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    sim->error = "short read";
    return sim;
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = p + size;
  while (true) {
    const char* fp = find_past(p, end, "<frame");
    if (!fp) break;
    // Attribute scan limited to the tag itself.
    const char* tag_end =
        static_cast<const char*>(memchr(fp, '>', end - fp));
    if (!tag_end) {
      sim->error = "malformed frame tag";
      break;
    }
    // A zero-drop frame is written self-closing (<frame ... />); it has
    // no </frame>, so searching for one would swallow the NEXT frame's
    // content (drops mis-attributed, a frame skipped).
    bool self_closing = tag_end > fp && tag_end[-1] == '/';
    const char* fend =
        self_closing ? nullptr : find_past(tag_end, end, "</frame>");
    const char* scan_end =
        self_closing ? tag_end : (fend ? fend : end);

    Frame fr;
    int64_t v;
    if (attr_i(fp, tag_end, "id", &v)) fr.id = static_cast<int32_t>(v);
    if (attr_i(fp, tag_end, "t", &v)) fr.exposure = static_cast<int32_t>(v);
    if (attr_i(fp, tag_end, "d", &v)) fr.start = static_cast<int32_t>(v);
    if (attr_i(fp, tag_end, "rs", &v)) fr.declared = static_cast<int32_t>(v);

    const char* dp = tag_end;
    while (true) {
      const char* d = find_past(dp, scan_end, "<drop");
      if (!d) break;
      const char* dte =
          static_cast<const char*>(memchr(d, '>', scan_end - d));
      if (!dte) break;
      Drop dr;
      memset(&dr, 0, sizeof(dr));
      int64_t pid = 0;
      bool ok = attr_i(d, dte, "pid", &pid);
      dr.pid = pid;
      ok = attr_vec(d, dte, "wp1", dr.wp1, 3) && ok;
      ok = attr_vec(d, dte, "wp2", dr.wp2, 3) && ok;
      ok = attr_f(d, dte, "wd1", &dr.wd1) && ok;
      ok = attr_f(d, dte, "wd2", &dr.wd2) && ok;
      ok = attr_vec(d, dte, "ip1", dr.ip1, 2) && ok;
      ok = attr_vec(d, dte, "ip2", dr.ip2, 2) && ok;
      ok = attr_f(d, dte, "iw1", &dr.iw1) && ok;
      ok = attr_f(d, dte, "iw2", &dr.iw2) && ok;
      if (!ok) {
        sim->error = "malformed drop attributes";
        break;
      }
      fr.drops.push_back(dr);
      dp = dte;
    }
    if (!sim->error.empty()) break;
    sim->frames.push_back(std::move(fr));
    if (self_closing) {
      p = tag_end + 1;
    } else if (fend) {
      p = fend;
    } else {
      break;
    }
  }
  return sim;
}

const char* rt_error(void* h) {
  Sim* sim = static_cast<Sim*>(h);
  return sim->error.empty() ? nullptr : sim->error.c_str();
}

int32_t rt_num_frames(void* h) {
  return static_cast<int32_t>(static_cast<Sim*>(h)->frames.size());
}

void rt_frame_info(void* h, int32_t idx, int32_t* out) {
  const Frame& f = static_cast<Sim*>(h)->frames[idx];
  out[0] = f.id;
  out[1] = f.exposure;
  out[2] = f.start;
  out[3] = f.declared;
  out[4] = static_cast<int32_t>(f.drops.size());
}

// Fill flat arrays for frame idx; caller allocates n_drops-sized arrays.
void rt_frame_data(void* h, int32_t idx, int64_t* pid, double* ip1,
                   double* ip2, double* iw1, double* iw2, double* wp1,
                   double* wp2, double* wd1, double* wd2) {
  const Frame& f = static_cast<Sim*>(h)->frames[idx];
  for (size_t i = 0; i < f.drops.size(); ++i) {
    const Drop& d = f.drops[i];
    pid[i] = d.pid;
    ip1[2 * i] = d.ip1[0];
    ip1[2 * i + 1] = d.ip1[1];
    ip2[2 * i] = d.ip2[0];
    ip2[2 * i + 1] = d.ip2[1];
    iw1[i] = d.iw1;
    iw2[i] = d.iw2;
    for (int k = 0; k < 3; ++k) {
      wp1[3 * i + k] = d.wp1[k];
      wp2[3 * i + k] = d.wp2[k];
    }
    wd1[i] = d.wd1;
    wd2[i] = d.wd2;
  }
}

void rt_free(void* h) { delete static_cast<Sim*>(h); }

}  // extern "C"
