// Native chemistry kernels for the mmdti_tpu host pipeline.
//
// Implements the same spring/repulsion conformer refinement as
// mmdti_tpu/chem/conformer.py::_refine (bond springs, 1-3 angle-distance
// springs, soft nonbonded repulsion; gradient descent with momentum and a
// linearly decaying step), plus a pairwise distance matrix.  This replaces the
// role RDKit's C++ core plays in the reference host hot loop
// (the reference's data/conformer.py:114-145,210) with a dependency-free
// implementation callable via ctypes (see mmdti_tpu/chem/native.py).
//
// Build: make -C csrc   (produces libmmchem.so)

#include <cmath>
#include <cctype>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

static void refine_inner(int n, float* coords,
                         int nb, const int* bond_idx, const float* bond_len,
                         int na, const int* ang_idx, const float* ang_len,
                         int nn, const int* nb_idx,
                         int iters);

// Shared term builder: adjacency + 1-3 angle-distance terms, same math as
// mmdti_tpu/chem/conformer.py::_bond_angle_terms.  mask bit0 = bonded,
// bit1 = has a 1-3 term (the 1-3 dedup intentionally does NOT exclude
// bonded pairs — a 3-ring closure bond coexists with its angle term).
// Adjacency is built in bond-insertion order, which fixes WHICH center
// emits a deduplicated 1-3 term.
static void build_angle_terms(int n, int nb, const int* bonds,
                              const double* orders, const double* bond_lens,
                              const int* flags,
                              std::vector<unsigned char>* mask_out,
                              std::vector<int>* aidx,
                              std::vector<float>* alen) {
  std::vector<std::vector<std::pair<int, int>>> adj(n);  // (neighbor, bond)
  mask_out->assign((size_t)n * n, 0);
  std::vector<unsigned char>& mask = *mask_out;
  for (int b = 0; b < nb; ++b) {
    int i = bonds[2 * b], j = bonds[2 * b + 1];
    adj[i].push_back({j, b});
    adj[j].push_back({i, b});
    mask[(size_t)i * n + j] |= 1;
    mask[(size_t)j * n + i] |= 1;
  }

  const double pi = 3.14159265358979323846;
  for (int j = 0; j < n; ++j) {
    int deg = (int)adj[j].size();
    if (deg < 2) continue;
    double maxo = 0.0;
    bool all_ge2 = true;
    for (auto& e : adj[j]) {
      double o = orders[e.second];
      if (o > maxo) maxo = o;
      if (o < 2.0) all_ge2 = false;
    }
    double theta;
    if (maxo >= 3.0 || (deg == 2 && maxo >= 2.0 && all_ge2))
      theta = pi;  // sp: linear
    else if ((flags[j] & 1) || maxo >= 2.0 || (flags[j] & 2))
      theta = 120.0 * pi / 180.0;
    else
      theta = 109.47 * pi / 180.0;
    double cos_t = std::cos(theta);
    for (int x = 0; x < deg; ++x) {
      for (int y = x + 1; y < deg; ++y) {
        int i = adj[j][x].first, k = adj[j][y].first;
        if (mask[(size_t)i * n + k] & 2) continue;
        mask[(size_t)i * n + k] |= 2;
        mask[(size_t)k * n + i] |= 2;
        double d1 = bond_lens[adj[j][x].second];
        double d2 = bond_lens[adj[j][y].second];
        double v = d1 * d1 + d2 * d2 - 2.0 * d1 * d2 * cos_t;
        if (v < 1e-6) v = 1e-6;
        aidx->push_back(i);
        aidx->push_back(k);
        alen->push_back((float)std::sqrt(v));
      }
    }
  }
}

extern "C" {

// Pair-index arrays come across a ctypes boundary: an out-of-range atom
// index would be an out-of-bounds WRITE in refine_inner (it scatters into
// grad[3*i]) and take the whole Python process down — validate at the ABI
// edge and fail soft instead (the binding falls back to the numpy path).
static bool pairs_in_range(int n, int count, const int* idx) {
  if (count > 0 && !idx) return false;
  for (int p = 0; p < 2 * count; ++p)
    if (idx[p] < 0 || idx[p] >= n) return false;
  return true;
}

// coords: [n,3] float32, updated in place. Returns 0 on success.
int mmchem_refine(int n, float* coords,
                  int nb, const int* bond_idx, const float* bond_len,
                  int na, const int* ang_idx, const float* ang_len,
                  int nn, const int* nb_idx,
                  int iters) {
  if (n <= 0 || !coords) return 1;
  if (!pairs_in_range(n, nb, bond_idx) || !pairs_in_range(n, na, ang_idx) ||
      !pairs_in_range(n, nn, nb_idx))
    return 1;
  refine_inner(n, coords, nb, bond_idx, bond_len, na, ang_idx, ang_len,
               nn, nb_idx, iters);
  return 0;
}

// ABI version of the embed/terms entries — bump when their signatures
// change; the Python binding refuses those paths on a mismatch so a
// stale MMCHEM_LIB build degrades to the refine/numpy ladder instead of
// miscalling.  v3: adds mmchem_terms (angle-term building without refine,
// feeding the accelerator-side refinement — ops/device_refine.py).
int mmchem_abi_version() { return 4; }

// Angle-term building only (same math as the mmchem_embed path below,
// shared via build_angle_terms): the device-refine provider builds bond
// terms directly from the bond list and needs no nonbonded enumeration
// (the accelerator masks nonbonded pairs from the term indices), so this
// is the only per-molecule O(deg^2) loop left on the host.  Writes at most
// cap_na terms into out_aidx [cap_na*2] / out_alen [cap_na]; returns the
// term count, or -1 on error / overflow (caller falls back to Python).
int mmchem_terms(int n, int nb, const int* bonds, const double* orders,
                 const double* bond_lens, const int* flags,
                 int cap_na, int* out_aidx, float* out_alen) {
  if (n <= 0 || !flags || cap_na < 0) return -1;
  if (nb > 0 && (!bonds || !orders || !bond_lens)) return -1;
  if (!pairs_in_range(n, nb, bonds)) return -1;
  std::vector<unsigned char> mask;
  std::vector<int> aidx;
  std::vector<float> alen;
  build_angle_terms(n, nb, bonds, orders, bond_lens, flags, &mask, &aidx, &alen);
  int na = (int)alen.size();
  if (na > cap_na) return -1;
  if (na > 0 && (!out_aidx || !out_alen)) return -1;
  std::memcpy(out_aidx, aidx.data(), sizeof(int) * 2 * na);
  std::memcpy(out_alen, alen.data(), sizeof(float) * na);
  return na;
}

// Combined entry: build the (bond, 1-3 angle-distance, nonbonded) term arrays
// from the molecular graph natively, then refine — the same term math as
// mmdti_tpu/chem/conformer.py::_build_terms, which previously ran as
// per-molecule Python loops (the O(n^2) nonbonded enumeration dominated the
// host featurization profile).
//
//   bonds:     [nb,2] int32 atom indices, insertion order (defines adjacency
//              order, which fixes WHICH center emits a deduplicated 1-3 term)
//   orders:    [nb] float64 bond orders (1.0 / 1.5 aromatic / 2.0 / 3.0)
//   bond_lens: [nb] float64 ideal bond lengths, computed by the Python
//              caller (single source: conformer._ideal_bond_length)
//   flags:     [n] int32 bitmask — bit0 aromatic atom, bit1 boron-like
//              (forces the 120-degree angle rule)
int mmchem_embed(int n, float* coords,
                 int nb, const int* bonds, const double* orders,
                 const double* bond_lens, const int* flags,
                 int iters) {
  if (n <= 0 || !coords || !flags) return 1;
  if (nb > 0 && (!bonds || !orders || !bond_lens)) return 1;
  if (!pairs_in_range(n, nb, bonds)) return 1;  // adj/mask writes index by these

  // Bond targets: double math in the 1-3 law, float32 spring targets
  // (matches the numpy path, which computes targets in double and casts the
  // term array).
  std::vector<float> blen(nb);
  for (int b = 0; b < nb; ++b) blen[b] = (float)bond_lens[b];

  std::vector<unsigned char> mask;
  std::vector<int> aidx;
  std::vector<float> alen;
  build_angle_terms(n, nb, bonds, orders, bond_lens, flags, &mask, &aidx, &alen);

  // Nonbonded: every pair with neither a bond nor a 1-3 term (includes
  // cross-fragment pairs).
  std::vector<int> nidx;
  for (int i = 0; i < n; ++i)
    for (int k = i + 1; k < n; ++k)
      if (!mask[(size_t)i * n + k]) {
        nidx.push_back(i);
        nidx.push_back(k);
      }

  refine_inner(n, coords, nb, bonds, blen.data(),
               (int)(alen.size()), aidx.data(), alen.data(),
               (int)(nidx.size() / 2), nidx.data(), iters);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SMILES parsing (ABI v4).  A line-faithful port of
// mmdti_tpu/chem/smiles.py::parse_smiles + implicit_h + add_hydrogens —
// the per-molecule Python parse was the largest remaining host cost in the
// device-refine featurization path.  Semantics notes carried over:
//   * implicit-H rounding uses round-half-to-even (Python round());
//   * divalent aromatic heteroatoms (o, s, se) never get an implicit H;
//   * ring perception is SKIPPED: in_ring flags feed nothing downstream of
//     this entry (the Python parser stays the source of truth for
//     validity checking and scaffold work).
// On any parse error the entry returns -1 and the Python binding falls
// back to the Python parser (which raises the detailed SmilesError).
// ---------------------------------------------------------------------------

namespace smi {

struct PAtom {
  char sym[3];
  bool aromatic;
  int explicit_h;  // -1 = implicit rule applies
};

struct PBond {
  int a1, a2;
  double order;
};

static bool is_element(const std::string& s) {
  static const char* kElems[] = {
      "H",  "He", "Li", "Be", "B",  "C",  "N",  "O",  "F",  "Ne", "Na", "Mg",
      "Al", "Si", "P",  "S",  "Cl", "Ar", "K",  "Ca", "Sc", "Ti", "V",  "Cr",
      "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
      "Rb", "Sr", "Y",  "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
      "In", "Sn", "Sb", "Te", "I",  "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
      "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Yb", "Lu", "Hf", "Ta", "W",
      "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn",
      "U",  "*"};
  for (const char* e : kElems)
    if (s == e) return true;
  return false;
}

static double bond_order(char c) {
  switch (c) {
    case '-': return 1.0;
    case '=': return 2.0;
    case '#': return 3.0;
    case '$': return 4.0;
    case ':': return 1.5;
    case '/': return 1.0;
    case '\\': return 1.0;
  }
  return 0.0;
}

static bool is_bond_char(char c) {
  return c == '-' || c == '=' || c == '#' || c == '$' || c == ':' ||
         c == '/' || c == '\\';
}

// [isotope? symbol @...? H<n>? +|-<n>? (:map)?] — mirrors _read_bracket_atom.
static bool read_bracket(const std::string& s, size_t pos, PAtom* atom,
                         size_t* next) {
  size_t close = s.find(']', pos);
  if (close == std::string::npos) return false;
  std::string body = s.substr(pos + 1, close - pos - 1);
  size_t k = 0;
  while (k < body.size() && isdigit((unsigned char)body[k])) ++k;  // isotope
  bool aromatic = false;
  std::string sym;
  if (k < body.size()) {
    if (k + 1 < body.size() && isupper((unsigned char)body[k]) &&
        islower((unsigned char)body[k + 1]) &&
        is_element(body.substr(k, 2))) {
      sym = body.substr(k, 2);
      k += 2;
    } else if (body[k] == '*') {
      sym = "*";
      k += 1;
    } else if (isupper((unsigned char)body[k])) {
      sym = body.substr(k, 1);
      if (!is_element(sym)) return false;
      k += 1;
    } else if (islower((unsigned char)body[k])) {
      std::string cand = body.substr(k, 2);
      if (cand.size() == 2 && islower((unsigned char)cand[1]) &&
          (cand == "se" || cand == "as" || cand == "te" || cand == "si")) {
        cand[0] = (char)toupper((unsigned char)cand[0]);
        sym = cand;
        k += 2;
      } else {
        sym = std::string(1, (char)toupper((unsigned char)body[k]));
        k += 1;
      }
      if (!is_element(sym)) return false;
      aromatic = true;
    }
  }
  if (sym.empty()) return false;
  // chirality: mirrors the Python skip (incl. named classes like @TH1)
  while (k < body.size() && body[k] == '@') {
    ++k;
    while (k < body.size() && isupper((unsigned char)body[k]) &&
           std::string("THALSPBO").find(body[k]) != std::string::npos) {
      std::string two = body.substr(k, 2);
      if (two == "TH" || two == "AL" || two == "SP" || two == "TB" ||
          two == "OH") {
        k += 2;
        while (k < body.size() && isdigit((unsigned char)body[k])) ++k;
      }
      break;
    }
  }
  int hcount = 0;
  if (k < body.size() && body[k] == 'H') {
    ++k;
    std::string num;
    while (k < body.size() && isdigit((unsigned char)body[k])) num += body[k++];
    hcount = num.empty() ? 1 : atoi(num.c_str());
  }
  while (k < body.size() && (body[k] == '+' || body[k] == '-')) {
    int sign = body[k] == '+' ? 1 : -1;
    ++k;
    std::string num;
    while (k < body.size() && isdigit((unsigned char)body[k])) num += body[k++];
    if (num.empty()) {
      char rep = sign > 0 ? '+' : '-';
      while (k < body.size() && (body[k] == '+' || body[k] == '-') &&
             body[k] == rep)
        ++k;
    }
  }
  if (k < body.size() && body[k] == ':') {
    ++k;
    while (k < body.size() && isdigit((unsigned char)body[k])) ++k;
  }
  if (k != body.size()) return false;
  std::memset(atom->sym, 0, 3);
  std::memcpy(atom->sym, sym.c_str(), sym.size() > 2 ? 2 : sym.size());
  atom->aromatic = aromatic;
  atom->explicit_h = hcount;
  *next = close + 1;
  return true;
}

// default valences for implicit-H; empty = 0 implicit H
static void valences(const char* sym, int* out, int* count) {
  *count = 0;
  std::string s(sym);
  if (s == "B") { out[0] = 3; *count = 1; }
  else if (s == "C") { out[0] = 4; *count = 1; }
  else if (s == "N") { out[0] = 3; out[1] = 5; *count = 2; }
  else if (s == "O") { out[0] = 2; *count = 1; }
  else if (s == "P") { out[0] = 3; out[1] = 5; *count = 2; }
  else if (s == "S") { out[0] = 2; out[1] = 4; out[2] = 6; *count = 3; }
  else if (s == "F" || s == "Cl" || s == "Br" || s == "I") {
    out[0] = 1; *count = 1;
  }
}

struct Graph {
  std::vector<PAtom> atoms;
  std::vector<PBond> bonds;
};

static bool parse(const std::string& input, Graph* g) {
  // strip() equivalent
  size_t b = input.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return false;
  size_t e = input.find_last_not_of(" \t\r\n");
  std::string s = input.substr(b, e - b + 1);

  int prev = -1;
  bool have_prev = false;
  char pending = 0;  // 0 = none
  std::vector<std::pair<int, char>> branch;          // (prev, unused)
  std::vector<std::pair<std::string, std::pair<int, char>>> rings;

  auto attach = [&](int idx) -> bool {
    if (!have_prev && pending) return false;
    if (have_prev) {
      double order;
      bool arom;
      if (pending) {
        order = bond_order(pending);
        arom = pending == ':';
      } else if (g->atoms[prev].aromatic && g->atoms[idx].aromatic) {
        order = 1.5; arom = true;
      } else {
        order = 1.0; arom = false;
      }
      (void)arom;
      if (prev == idx) return false;
      g->bonds.push_back({prev, idx, order});
    }
    prev = idx;
    have_prev = true;
    pending = 0;
    return true;
  };

  auto add_atom = [&](const std::string& sym, bool aromatic, int eh) -> int {
    PAtom a;
    std::memset(a.sym, 0, 3);
    std::memcpy(a.sym, sym.c_str(), sym.size() > 2 ? 2 : sym.size());
    a.aromatic = aromatic;
    a.explicit_h = eh;
    g->atoms.push_back(a);
    return (int)g->atoms.size() - 1;
  };

  size_t i = 0, n = s.size();
  while (i < n) {
    char c = s[i];
    if (c == '[') {
      PAtom a;
      size_t next;
      if (!read_bracket(s, i, &a, &next)) return false;
      g->atoms.push_back(a);
      if (!attach((int)g->atoms.size() - 1)) return false;
      i = next;
    } else if (isupper((unsigned char)c)) {
      std::string two = s.substr(i, 2);
      if (two == "Cl" || two == "Br") {
        if (!attach(add_atom(two, false, -1))) return false;
        i += 2;
      } else if (c == 'B' || c == 'C' || c == 'N' || c == 'O' || c == 'P' ||
                 c == 'S' || c == 'F' || c == 'I') {
        if (!attach(add_atom(std::string(1, c), false, -1))) return false;
        i += 1;
      } else {
        return false;  // atom requires brackets
      }
    } else if (c == 'b' || c == 'c' || c == 'n' || c == 'o' || c == 'p' ||
               c == 's') {
      if (!attach(add_atom(std::string(1, (char)toupper((unsigned char)c)),
                           true, -1)))
        return false;
      i += 1;
    } else if (c == '*') {
      if (!attach(add_atom("*", false, -1))) return false;
      i += 1;
    } else if (is_bond_char(c)) {
      if (pending) return false;
      pending = c;
      i += 1;
    } else if (c == '(') {
      if (!have_prev) return false;
      if (pending) return false;
      branch.push_back({prev, 0});
      i += 1;
    } else if (c == ')') {
      if (branch.empty()) return false;
      if (pending) return false;
      prev = branch.back().first;
      branch.pop_back();
      have_prev = true;
      pending = 0;
      i += 1;
    } else if (isdigit((unsigned char)c) || c == '%') {
      if (!have_prev) return false;
      std::string key;
      if (c == '%') {
        if (i + 2 >= n || !isdigit((unsigned char)s[i + 1]) ||
            !isdigit((unsigned char)s[i + 2]))
          return false;
        key = s.substr(i + 1, 2);
        i += 3;
      } else {
        key = std::string(1, c);
        i += 1;
      }
      int found = -1;
      for (size_t r = 0; r < rings.size(); ++r)
        if (rings[r].first == key) { found = (int)r; break; }
      if (found >= 0) {
        int other = rings[found].second.first;
        char obond = rings[found].second.second;
        rings.erase(rings.begin() + found);
        if (other == prev) return false;
        char bond_sym = pending ? pending : obond;
        double order;
        if (bond_sym) {
          order = bond_order(bond_sym);
        } else if (g->atoms[other].aromatic && g->atoms[prev].aromatic) {
          order = 1.5;
        } else {
          order = 1.0;
        }
        if (other == prev) return false;
        g->bonds.push_back({other, prev, order});
        pending = 0;
      } else {
        rings.push_back({key, {prev, pending}});
        pending = 0;
      }
    } else if (c == '.') {
      if (pending) return false;
      have_prev = false;
      prev = -1;
      i += 1;
    } else if (c == ' ' || c == '\t') {
      break;  // SMILES ends at whitespace (title section)
    } else {
      return false;
    }
  }
  if (pending) return false;
  if (!branch.empty()) return false;
  if (!rings.empty()) return false;
  if (g->atoms.empty()) return false;
  return true;
}

static int implicit_h(const Graph& g, int i,
                      const std::vector<double>& bond_sum,
                      const std::vector<int>& degree) {
  const PAtom& a = g.atoms[i];
  if (a.explicit_h >= 0) return a.explicit_h;
  int v[3], vc;
  valences(a.sym, v, &vc);
  if (vc == 0 || a.sym[0] == '*') return 0;
  double need = bond_sum[i];
  if (a.aromatic) {
    if (v[0] <= 2) return 0;  // divalent aromatic heteroatoms: no phantom H
    double lower = 1.5 * degree[i];
    if (lower > need) need = lower;
  }
  for (int k = 0; k < vc; ++k) {
    if (v[k] + 1e-9 >= need) {
      // Python round(): half-to-even
      double d = std::nearbyint((double)v[k] - need);
      int h = (int)d;
      return h > 0 ? h : 0;
    }
  }
  return 0;
}

}  // namespace smi

extern "C" {

// Parse a SMILES string and expand implicit hydrogens (the exact
// featurization graph builtin_smi2coords starts from).  Outputs:
//   sym_out   [cap_atoms*3] char — 2-char symbols, NUL padded
//   flags_out [cap_atoms] int   — bit0 aromatic, bit1 boron (B)
//   bonds_out [cap_bonds*2] int, orders_out [cap_bonds] double
//   n_bonds_out — bond count (heavy + H bonds)
// Returns the atom count AFTER H expansion, or -1 on parse error /
// overflowed caps (caller falls back to the Python parser).
int mmchem_parse(const char* smiles, int cap_atoms, char* sym_out,
                 int* flags_out, int cap_bonds, int* bonds_out,
                 double* orders_out, int* n_bonds_out) {
  if (!smiles || !sym_out || !flags_out || !bonds_out || !orders_out ||
      !n_bonds_out)
    return -1;
  smi::Graph g;
  if (!smi::parse(smiles, &g)) return -1;
  int nh = (int)g.atoms.size();
  std::vector<double> bond_sum(nh, 0.0);
  std::vector<int> degree(nh, 0);
  for (const auto& b : g.bonds) {
    if (b.a1 < 0 || b.a1 >= nh || b.a2 < 0 || b.a2 >= nh) return -1;
    bond_sum[b.a1] += b.order;
    bond_sum[b.a2] += b.order;
    degree[b.a1] += 1;
    degree[b.a2] += 1;
  }
  // count hydrogens to add
  std::vector<int> hcount(nh);
  int total = nh;
  for (int i = 0; i < nh; ++i) {
    hcount[i] = smi::implicit_h(g, i, bond_sum, degree);
    total += hcount[i];
  }
  int nb_total = (int)g.bonds.size() + (total - nh);
  if (total > cap_atoms || nb_total > cap_bonds) return -1;
  for (int i = 0; i < nh; ++i) {
    std::memcpy(sym_out + 3 * i, g.atoms[i].sym, 3);
    flags_out[i] = (g.atoms[i].aromatic ? 1 : 0) |
                   ((g.atoms[i].sym[0] == 'B' && g.atoms[i].sym[1] == 0) ? 2 : 0);
  }
  int nb = 0;
  for (const auto& b : g.bonds) {
    bonds_out[2 * nb] = b.a1;
    bonds_out[2 * nb + 1] = b.a2;
    orders_out[nb] = b.order;
    ++nb;
  }
  int next = nh;
  for (int i = 0; i < nh; ++i) {
    for (int h = 0; h < hcount[i]; ++h) {
      std::memset(sym_out + 3 * next, 0, 3);
      sym_out[3 * next] = 'H';
      flags_out[next] = 0;
      bonds_out[2 * nb] = i;
      bonds_out[2 * nb + 1] = next;
      orders_out[nb] = 1.0;
      ++nb;
      ++next;
    }
  }
  *n_bonds_out = nb;
  return total;
}

}  // extern "C"

// Shared gradient-descent core (bond/angle springs + soft nonbonded
// repulsion, momentum, linearly decaying step, per-iteration recentering).
//
// The nonbonded term is pruned with a Verlet neighbor list: a pair farther
// apart than nb_floor contributes EXACTLY zero gradient, so iterating only
// the pairs within nb_floor + vmargin — with the list rebuilt before the
// accumulated worst-case drift could let an outside pair dip under the
// floor — is bit-identical to the full O(n^2) enumeration.  The list holds
// indices into the caller's pair array in ascending scan order, so the
// surviving contributions accumulate in exactly the original sequence.
// This is where the refine time went for molecules beyond ~30 heavy atoms
// (~90% of a 150-atom refine was far-pair sqrt's); a spatial-grid variant
// was tried first and measured SLOWER (per-iteration cell arrays cost more
// than the pruning saved at these n).
static void refine_inner(int n, float* coords,
                         int nb, const int* bond_idx, const float* bond_len,
                         int na, const int* ang_idx, const float* ang_len,
                         int nn, const int* nb_idx,
                         int iters) {
  std::vector<double> x(3 * n), vel(3 * n, 0.0), grad(3 * n);
  for (int i = 0; i < 3 * n; ++i) x[i] = coords[i];

  const double nb_floor = 2.2;
  const double lr0 = 0.05;

  // Verlet-list pruning for the nonbonded term: a pair farther apart than
  // nb_floor contributes EXACTLY zero gradient, so iterating only pairs
  // within nb_floor + margin (rebuilt before the accumulated worst-case
  // displacement can invalidate the list) is bit-identical to the full
  // O(n^2) enumeration — the list keeps the pair array's original order,
  // so surviving contributions accumulate in the same sequence.  Engaged
  // only for large pair counts, where the full loop dominated refine time.
  const bool use_vlist = nn >= 2048;
  const double vmargin = 1.0;
  std::vector<int> live;      // indices into nb_idx, ascending
  double travel = 1e300;      // worst-case pair-distance drift since rebuild
  if (use_vlist) live.reserve((size_t)nn / 4 + 64);

  for (int it = 0; it < iters; ++it) {
    const double lr = lr0 * (1.0 - 0.9 * (double)it / (double)iters);
    std::memset(grad.data(), 0, sizeof(double) * 3 * n);

    auto spring = [&](int i, int j, double target, double k) {
      double d0 = x[3 * i] - x[3 * j];
      double d1 = x[3 * i + 1] - x[3 * j + 1];
      double d2 = x[3 * i + 2] - x[3 * j + 2];
      double dist = std::sqrt(d0 * d0 + d1 * d1 + d2 * d2) + 1e-9;
      double c = k * 2.0 * (dist - target) / dist;
      grad[3 * i] += c * d0;     grad[3 * j] -= c * d0;
      grad[3 * i + 1] += c * d1; grad[3 * j + 1] -= c * d1;
      grad[3 * i + 2] += c * d2; grad[3 * j + 2] -= c * d2;
    };

    for (int b = 0; b < nb; ++b)
      spring(bond_idx[2 * b], bond_idx[2 * b + 1], bond_len[b], 1.0);
    for (int a = 0; a < na; ++a)
      spring(ang_idx[2 * a], ang_idx[2 * a + 1], ang_len[a], 0.6);

    auto repel = [&](int i, int j) {
      double d0 = x[3 * i] - x[3 * j];
      double d1 = x[3 * i + 1] - x[3 * j + 1];
      double d2 = x[3 * i + 2] - x[3 * j + 2];
      double dist = std::sqrt(d0 * d0 + d1 * d1 + d2 * d2) + 1e-9;
      double pen = nb_floor - dist;
      if (pen > 0.0) {
        double c = -0.3 * 2.0 * pen / dist;
        grad[3 * i] += c * d0;     grad[3 * j] -= c * d0;
        grad[3 * i + 1] += c * d1; grad[3 * j + 1] -= c * d1;
        grad[3 * i + 2] += c * d2; grad[3 * j + 2] -= c * d2;
      }
    };

    if (!use_vlist) {
      for (int p = 0; p < nn; ++p) repel(nb_idx[2 * p], nb_idx[2 * p + 1]);
    } else {
      if (travel >= vmargin) {
        // rebuild: every pair currently within nb_floor + vmargin.  A pair
        // outside the list needs its distance to shrink by > vmargin to
        // ever dip under nb_floor, and per-iteration drift is bounded by
        // 2 * max|vel| (the recenter shift cancels in pair distances).
        live.clear();
        const double keep = nb_floor + vmargin;
        const double keep2 = keep * keep;
        for (int p = 0; p < nn; ++p) {
          int i = nb_idx[2 * p], j = nb_idx[2 * p + 1];
          double d0 = x[3 * i] - x[3 * j];
          double d1 = x[3 * i + 1] - x[3 * j + 1];
          double d2 = x[3 * i + 2] - x[3 * j + 2];
          if (d0 * d0 + d1 * d1 + d2 * d2 < keep2) live.push_back(p);
        }
        travel = 0.0;
      }
      for (int p : live) repel(nb_idx[2 * p], nb_idx[2 * p + 1]);
    }

    double cx = 0.0, cy = 0.0, cz = 0.0, maxv2 = 0.0;
    for (int i = 0; i < n; ++i) {
      for (int k = 0; k < 3; ++k) {
        vel[3 * i + k] = 0.8 * vel[3 * i + k] - lr * grad[3 * i + k];
        x[3 * i + k] += vel[3 * i + k];
      }
      double v2 = vel[3 * i] * vel[3 * i] + vel[3 * i + 1] * vel[3 * i + 1]
                + vel[3 * i + 2] * vel[3 * i + 2];
      if (v2 > maxv2) maxv2 = v2;
      cx += x[3 * i]; cy += x[3 * i + 1]; cz += x[3 * i + 2];
    }
    if (use_vlist) travel += 2.0 * std::sqrt(maxv2);
    if (n > 1) {
      cx /= n; cy /= n; cz /= n;
      for (int i = 0; i < n; ++i) {
        x[3 * i] -= cx; x[3 * i + 1] -= cy; x[3 * i + 2] -= cz;
      }
    }
  }
  for (int i = 0; i < 3 * n; ++i) coords[i] = (float)x[i];
}

// out: [n,n] float32 pairwise Euclidean distances.
extern "C" void mmchem_distance_matrix(int n, const float* coords, float* out) {
  for (int i = 0; i < n; ++i) {
    out[i * n + i] = 0.0f;
    for (int j = i + 1; j < n; ++j) {
      float d0 = coords[3 * i] - coords[3 * j];
      float d1 = coords[3 * i + 1] - coords[3 * j + 1];
      float d2 = coords[3 * i + 2] - coords[3 * j + 2];
      float d = std::sqrt(d0 * d0 + d1 * d1 + d2 * d2);
      out[i * n + j] = d;
      out[j * n + i] = d;
    }
  }
}
