// Native synthesis core of bellpepper_tpu_torch: a copy of
// bellpepper_tpu/native/synthesis.cpp, built by this package's loader
// (bellpepper_tpu_torch/native/__init__.py) so the port needs nothing of
// the JAX package at run time. tests/test_torch_witness.py holds the two
// builders' templates and tapes equal array for array.
//
// A C++ circuit builder ("graph builder") for the bit-oriented gadget
// family: AllocatedBit ops with Boolean constant-folding, UInt32/MultiEq,
// full sha256/blake2s compression synthesis, and the AllocatedNum field
// gadgets. It emits
//   * COO A/B/C triples with a deduplicated coefficient table, and
//   * the flat witness-tape op stream that WitnessProgram compiles.
//
// Semantics mirror the reference gadgets bit-for-bit (same constraint
// formulas and allocation order as
// crates/bellpepper-core/src/gadgets/boolean.rs and
// crates/bellpepper/src/gadgets/{uint32,multieq,sha256,blake2s}.rs).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o synthesis.so synthesis.cpp

#include <array>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// 256-bit big integers (little-endian 64-bit words), mod-p arithmetic.
// ---------------------------------------------------------------------
struct U256 {
  uint64_t w[4];
  bool operator==(const U256& o) const {
    return !memcmp(w, o.w, sizeof(w));
  }
};

struct U256Hash {
  size_t operator()(const U256& v) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t x : v.w) {
      h ^= x;
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

static inline U256 u256_zero() { return U256{{0, 0, 0, 0}}; }
static inline U256 u256_one() { return U256{{1, 0, 0, 0}}; }

static inline bool u256_is_zero(const U256& a) {
  return !(a.w[0] | a.w[1] | a.w[2] | a.w[3]);
}

static inline int u256_cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; --i) {
    if (a.w[i] != b.w[i]) return a.w[i] < b.w[i] ? -1 : 1;
  }
  return 0;
}

static inline U256 u256_add(const U256& a, const U256& b, bool* carry_out) {
  U256 r;
  unsigned __int128 c = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 s = (unsigned __int128)a.w[i] + b.w[i] + c;
    r.w[i] = (uint64_t)s;
    c = s >> 64;
  }
  if (carry_out) *carry_out = c != 0;
  return r;
}

static inline U256 u256_sub(const U256& a, const U256& b) {
  U256 r;
  unsigned __int128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    unsigned __int128 d =
        (unsigned __int128)a.w[i] - b.w[i] - (uint64_t)borrow;
    r.w[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return r;
}

static inline U256 addmod(const U256& a, const U256& b, const U256& p) {
  bool carry;
  U256 s = u256_add(a, b, &carry);
  if (carry || u256_cmp(s, p) >= 0) s = u256_sub(s, p);
  return s;
}

static inline U256 submod(const U256& a, const U256& b, const U256& p) {
  if (u256_cmp(a, b) >= 0) return u256_sub(a, b);
  bool carry;
  U256 s = u256_add(a, p, &carry);
  (void)carry;
  return u256_sub(s, b);
}

static inline U256 negmod(const U256& a, const U256& p) {
  if (u256_is_zero(a)) return a;
  return u256_sub(p, a);
}

// Double mod p (used to build powers-of-two tables).
static inline U256 doublemod(const U256& a, const U256& p) {
  return addmod(a, a, p);
}

// ---------------------------------------------------------------------
// Views: a Boolean is a constant or a (possibly negated) variable.
// Encoding (int64):
//   bit0      : kind (0 = constant, 1 = variable)
//   constant  : bit1 = value
//   variable  : bit1 = negated, bits2.. = slotcode = (index << 1) | is_aux
// ---------------------------------------------------------------------
typedef int64_t View;

static inline View view_const(bool v) { return (int64_t)(v ? 2 : 0); }
static inline View view_var(int64_t slotcode, bool neg) {
  return 1 | (neg ? 2 : 0) | (slotcode << 2);
}
static inline bool view_is_const(View v) { return (v & 1) == 0; }
static inline bool view_const_val(View v) { return (v & 2) != 0; }
static inline bool view_neg(View v) { return (v & 2) != 0; }
static inline int64_t view_slot(View v) { return v >> 2; }
static inline View view_not(View v) {
  return view_is_const(v) ? view_const(!view_const_val(v)) : (v ^ 2);
}

static inline int64_t slotcode_aux(int64_t j) { return (j << 1) | 1; }
static inline int64_t slotcode_input(int64_t i) { return i << 1; }

// ---------------------------------------------------------------------
// Linear combinations: sorted (inputs before aux, then by index) term
// vectors with merge-on-insert — the Indexer semantics (lc.rs:40-122).
// ---------------------------------------------------------------------
struct LC {
  // key = (is_aux << 62) | index — preserves inputs-first ordering.
  std::vector<std::pair<int64_t, U256>> terms;

  void add(int64_t slotcode, const U256& coeff, const U256& p) {
    int64_t is_aux = slotcode & 1;
    int64_t idx = slotcode >> 1;
    int64_t key = (is_aux << 62) | idx;
    // fast path: append / update last
    if (!terms.empty() && terms.back().first == key) {
      terms.back().second = addmod(terms.back().second, coeff, p);
      return;
    }
    if (terms.empty() || terms.back().first < key) {
      terms.emplace_back(key, coeff);
      return;
    }
    // binary search
    size_t lo = 0, hi = terms.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (terms[mid].first < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < terms.size() && terms[lo].first == key) {
      terms[lo].second = addmod(terms[lo].second, coeff, p);
    } else {
      terms.insert(terms.begin() + lo, {key, coeff});
    }
  }

  void add_scaled(const LC& other, const U256& scale, const U256& p);
  void clear() { terms.clear(); }
};

// Tape opcodes — ids must match the _OPCODE_NAMES order of the Python loader.
enum OpCode {
  OP_XOR = 0,
  OP_AND = 1,
  OP_AND_NOT = 2,
  OP_NOR = 3,
  OP_CH = 4,
  OP_MAJ = 5,
  OP_ADDMANY = 6,
  OP_FADD = 7,
  OP_FMUL = 8,
  OP_FINV = 9,
  OP_COPY = 10,
  OP_PACK = 11,
  OP_FBITS_LE = 12,
  OP_SELECT = 13,
  OP_LOOKUP = 14,
  OP_NUM_ISZERO = 15,
  OP_NUM_INV_OR_ONE = 16,
};

static inline int u256_bit(const U256& a, int i) {
  return (int)((a.w[i / 64] >> (i % 64)) & 1);
}

struct Builder {
  U256 p;
  int num_bits;   // p.bit_length()
  int capacity;   // num_bits - 1
  int64_t num_inputs = 1;  // ONE
  int64_t num_aux = 0;
  int64_t num_constraints = 0;

  std::vector<int32_t> rows[3], cols[3], cids[3];
  std::vector<U256> coeff_table;
  std::unordered_map<U256, int32_t, U256Hash> coeff_lookup;

  // Powers of two mod p, up to 2^600 (MultiEq scaling, addmany coeffs).
  std::vector<U256> pow2;

  // tape: flat int64 stream: opcode, n_outs, outs..., n_args, args...
  // (args: slots for bit ops; views for ch/maj; addmany: n_words then
  //  n_words*32 views)
  std::vector<int64_t> tape;

  // active MultiEq scope
  bool multieq_active = false;
  int64_t me_bits_used = 0;
  LC me_lhs, me_rhs;

  explicit Builder(const uint64_t pw[4]) {
    memcpy(p.w, pw, sizeof(p.w));
    num_bits = 0;
    for (int i = 3; i >= 0; --i) {
      if (p.w[i]) {
        num_bits = i * 64 + 64 - __builtin_clzll(p.w[i]);
        break;
      }
    }
    capacity = num_bits - 1;
    pow2.resize(600);
    pow2[0] = u256_one();
    for (int i = 1; i < 600; ++i) pow2[i] = doublemod(pow2[i - 1], p);
    coeff_table.push_back(u256_one());
    coeff_lookup.emplace(u256_one(), 0);
  }

  int32_t coeff_id(const U256& c) {
    auto it = coeff_lookup.find(c);
    if (it != coeff_lookup.end()) return it->second;
    int32_t id = (int32_t)coeff_table.size();
    coeff_table.push_back(c);
    coeff_lookup.emplace(c, id);
    return id;
  }

  int64_t alloc_aux() { return num_aux++; }

  void record_lc(int mat, int64_t row, const LC& lc) {
    for (auto& t : lc.terms) {
      if (u256_is_zero(t.second)) continue;
      int64_t is_aux = (t.first >> 62) & 1;
      int64_t idx = t.first & ((1ll << 62) - 1);
      rows[mat].push_back((int32_t)row);
      // aux marked with bitwise-not, fixed at extraction (ShapeCS trick).
      cols[mat].push_back((int32_t)(is_aux ? ~idx : idx));
      cids[mat].push_back(coeff_id(t.second));
    }
  }

  void enforce(const LC& a, const LC& b, const LC& c) {
    int64_t row = num_constraints++;
    record_lc(0, row, a);
    record_lc(1, row, b);
    record_lc(2, row, c);
  }

  // ----- tape helpers -----
  void tape_bitop(int opcode, int64_t out_slotcode, int64_t a_slotcode,
                  int64_t b_slotcode) {
    tape.push_back(opcode);
    tape.push_back(1);
    tape.push_back(out_slotcode);
    tape.push_back(2);
    tape.push_back(a_slotcode);
    tape.push_back(b_slotcode);
  }

  void tape_viewop(int opcode, int64_t out_slotcode, View a, View b, View c) {
    tape.push_back(opcode);
    tape.push_back(1);
    tape.push_back(out_slotcode);
    tape.push_back(3);
    tape.push_back(a);
    tape.push_back(b);
    tape.push_back(c);
  }
};

void LC::add_scaled(const LC& other, const U256& scale, const U256& p) {
  for (auto& t : other.terms) {
    // re-add by key: reconstruct slotcode
    int64_t is_aux = (t.first >> 62) & 1;
    int64_t idx = t.first & ((1ll << 62) - 1);
    int64_t slotcode = (idx << 1) | is_aux;
    // scale * coeff: coefficients here are ±2^i-sums; use full mulmod.
    // schoolbook 4x4 → 512-bit, reduce by shifted-subtract long division.
    uint64_t prod[8] = {0};
    for (int i = 0; i < 4; ++i) {
      unsigned __int128 carry = 0;
      for (int j = 0; j < 4; ++j) {
        unsigned __int128 cur =
            (unsigned __int128)t.second.w[i] * scale.w[j] + prod[i + j] +
            (uint64_t)carry;
        prod[i + j] = (uint64_t)cur;
        carry = cur >> 64;
      }
      prod[i + 4] += (uint64_t)carry;
    }
    // Reduce the 512-bit product mod p by bitwise long division. This is
    // cold code (once per term per MultiEq scale), so simplicity wins.
    int top = -1;
    for (int i = 7; i >= 0 && top < 0; --i)
      if (prod[i]) top = i * 64 + 63 - __builtin_clzll(prod[i]);
    U256 rem = u256_zero();
    if (top >= 0) {
      auto get_bit = [&](int i) { return (prod[i / 64] >> (i % 64)) & 1; };
      for (int i = top; i >= 0; --i) {
        U256 r2;
        r2.w[3] = (rem.w[3] << 1) | (rem.w[2] >> 63);
        r2.w[2] = (rem.w[2] << 1) | (rem.w[1] >> 63);
        r2.w[1] = (rem.w[1] << 1) | (rem.w[0] >> 63);
        r2.w[0] = (rem.w[0] << 1) | get_bit(i);
        rem = r2;
        if (u256_cmp(rem, p) >= 0) rem = u256_sub(rem, p);
      }
    }
    add(slotcode, rem, p);
  }
}

}  // namespace

namespace {

// ---------------------------------------------------------------------
// Boolean gadget ops — formulas and folding rules mirror the Python
// gadgets (and therefore boolean.rs) exactly.
// ---------------------------------------------------------------------

// Allocate a free bit with its booleanity constraint (1 - a)*a = 0.
View alloc_bit(Builder& B) {
  int64_t j = B.alloc_aux();
  int64_t sc = slotcode_aux(j);
  LC a, b, c;
  a.add(slotcode_input(0), u256_one(), B.p);
  a.add(sc, negmod(u256_one(), B.p), B.p);
  b.add(sc, u256_one(), B.p);
  B.enforce(a, b, c);
  return view_var(sc, false);
}

// AllocatedBit-level ops (both operands plain variables).
View bit_xor(Builder& B, int64_t sa, int64_t sb) {
  int64_t j = B.alloc_aux();
  int64_t so = slotcode_aux(j);
  // (a + a) * b = a + b - c
  LC a, b, c;
  U256 two = addmod(u256_one(), u256_one(), B.p);
  a.add(sa, two, B.p);
  b.add(sb, u256_one(), B.p);
  c.add(sa, u256_one(), B.p);
  c.add(sb, u256_one(), B.p);
  c.add(so, negmod(u256_one(), B.p), B.p);
  B.enforce(a, b, c);
  B.tape_bitop(OP_XOR, so, sa, sb);
  return view_var(so, false);
}

View bit_and(Builder& B, int64_t sa, int64_t sb) {
  int64_t j = B.alloc_aux();
  int64_t so = slotcode_aux(j);
  LC a, b, c;
  a.add(sa, u256_one(), B.p);
  b.add(sb, u256_one(), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  B.tape_bitop(OP_AND, so, sa, sb);
  return view_var(so, false);
}

View bit_and_not(Builder& B, int64_t sa, int64_t sb) {
  int64_t j = B.alloc_aux();
  int64_t so = slotcode_aux(j);
  // a * (1 - b) = c
  LC a, b, c;
  a.add(sa, u256_one(), B.p);
  b.add(slotcode_input(0), u256_one(), B.p);
  b.add(sb, negmod(u256_one(), B.p), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  B.tape_bitop(OP_AND_NOT, so, sa, sb);
  return view_var(so, false);
}

View bit_nor(Builder& B, int64_t sa, int64_t sb) {
  int64_t j = B.alloc_aux();
  int64_t so = slotcode_aux(j);
  // (1 - a) * (1 - b) = c
  LC a, b, c;
  a.add(slotcode_input(0), u256_one(), B.p);
  a.add(sa, negmod(u256_one(), B.p), B.p);
  b.add(slotcode_input(0), u256_one(), B.p);
  b.add(sb, negmod(u256_one(), B.p), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  B.tape_bitop(OP_NOR, so, sa, sb);
  return view_var(so, false);
}

// Boolean-level XOR with the reference's rewrite rules.
View bool_xor(Builder& B, View a, View b) {
  if (view_is_const(a) && !view_const_val(a)) return b;
  if (view_is_const(b) && !view_const_val(b)) return a;
  if (view_is_const(a)) return view_not(b);
  if (view_is_const(b)) return view_not(a);
  bool na = view_neg(a), nb = view_neg(b);
  if (na == nb) return bit_xor(B, view_slot(a), view_slot(b));
  // Is xor Not = not(Is xor Is), Is operand first.
  if (!na) return view_not(bit_xor(B, view_slot(a), view_slot(b)));
  return view_not(bit_xor(B, view_slot(b), view_slot(a)));
}

// Boolean-level AND with is/not dispatch.
View bool_and(Builder& B, View a, View b) {
  if ((view_is_const(a) && !view_const_val(a)) ||
      (view_is_const(b) && !view_const_val(b)))
    return view_const(false);
  if (view_is_const(a)) return b;
  if (view_is_const(b)) return a;
  bool na = view_neg(a), nb = view_neg(b);
  if (!na && nb) return bit_and_not(B, view_slot(a), view_slot(b));
  if (na && !nb) return bit_and_not(B, view_slot(b), view_slot(a));
  if (na && nb) return bit_nor(B, view_slot(a), view_slot(b));
  return bit_and(B, view_slot(a), view_slot(b));
}

// LC projection of a Boolean view with coefficient (boolean.rs:437-455).
void lc_add_view(Builder& B, LC& lc, View v, const U256& coeff) {
  if (view_is_const(v)) {
    if (view_const_val(v)) lc.add(slotcode_input(0), coeff, B.p);
    return;
  }
  if (!view_neg(v)) {
    lc.add(view_slot(v), coeff, B.p);
  } else {
    lc.add(slotcode_input(0), coeff, B.p);
    lc.add(view_slot(v), negmod(coeff, B.p), B.p);
  }
}

// sha256_ch with constant special cases (boolean.rs:536-641).
View bool_ch(Builder& B, View a, View b, View c) {
  if (view_is_const(a) && view_is_const(b) && view_is_const(c)) {
    bool av = view_const_val(a), bv = view_const_val(b), cv = view_const_val(c);
    return view_const((av && bv) ^ (!av && cv));
  }
  if (view_is_const(a) && !view_const_val(a)) return c;
  if (view_is_const(b) && !view_const_val(b))
    return bool_and(B, view_not(a), c);
  if (view_is_const(c) && !view_const_val(c)) return bool_and(B, a, b);
  if (view_is_const(c) && view_const_val(c))
    return view_not(bool_and(B, a, view_not(b)));
  if (view_is_const(b) && view_const_val(b))
    return view_not(bool_and(B, view_not(a), view_not(c)));
  // a == Constant(true) falls through (like the reference).
  int64_t j = B.alloc_aux();
  int64_t so = slotcode_aux(j);
  U256 one = u256_one();
  // (b - c) * a = ch - c
  LC A, Bm, C;
  lc_add_view(B, A, b, one);
  lc_add_view(B, A, c, negmod(one, B.p));
  lc_add_view(B, Bm, a, one);
  C.add(so, one, B.p);
  lc_add_view(B, C, c, negmod(one, B.p));
  B.enforce(A, Bm, C);
  B.tape_viewop(OP_CH, so, a, b, c);
  return view_var(so, false);
}

// sha256_maj with constant special cases (boolean.rs:644-759).
View bool_maj(Builder& B, View a, View b, View c) {
  if (view_is_const(a) && view_is_const(b) && view_is_const(c)) {
    bool av = view_const_val(a), bv = view_const_val(b), cv = view_const_val(c);
    return view_const((av && bv) ^ (av && cv) ^ (bv && cv));
  }
  if (view_is_const(a) && !view_const_val(a)) return bool_and(B, b, c);
  if (view_is_const(b) && !view_const_val(b)) return bool_and(B, a, c);
  if (view_is_const(c) && !view_const_val(c)) return bool_and(B, a, b);
  if (view_is_const(c) && view_const_val(c))
    return view_not(bool_and(B, view_not(a), view_not(b)));
  if (view_is_const(b) && view_const_val(b))
    return view_not(bool_and(B, view_not(a), view_not(c)));
  if (view_is_const(a) && view_const_val(a))
    return view_not(bool_and(B, view_not(b), view_not(c)));
  // alloc maj FIRST, then bc = b AND c (allocation order matters).
  int64_t j = B.alloc_aux();
  int64_t so = slotcode_aux(j);
  View bc = bool_and(B, b, c);
  U256 one = u256_one();
  U256 negone = negmod(one, B.p);
  // (2bc - b - c) * a = bc - maj
  LC A, Bm, C;
  lc_add_view(B, A, bc, one);
  lc_add_view(B, A, bc, one);
  lc_add_view(B, A, b, negone);
  lc_add_view(B, A, c, negone);
  lc_add_view(B, Bm, a, one);
  lc_add_view(B, C, bc, one);
  C.add(so, negone, B.p);
  B.enforce(A, Bm, C);
  B.tape_viewop(OP_MAJ, so, a, b, c);
  return view_var(so, false);
}

// ---------------------------------------------------------------------
// MultiEq (multieq.rs:6-67)
// ---------------------------------------------------------------------
void multieq_accumulate(Builder& B) {
  LC one_lc;
  one_lc.add(slotcode_input(0), u256_one(), B.p);
  B.enforce(B.me_lhs, one_lc, B.me_rhs);
  B.me_lhs.clear();
  B.me_rhs.clear();
  B.me_bits_used = 0;
}

void multieq_enforce_equal(Builder& B, int64_t num_bits, const LC& lhs,
                           const LC& rhs) {
  if (B.capacity <= B.me_bits_used + num_bits) multieq_accumulate(B);
  const U256& coeff = B.pow2[B.me_bits_used];
  B.me_lhs.add_scaled(lhs, coeff, B.p);
  B.me_rhs.add_scaled(rhs, coeff, B.p);
  B.me_bits_used += num_bits;
}

// ---------------------------------------------------------------------
// UInt32 words as arrays of 32 views (LSB first) + addmany
// (uint32.rs:304-406).
// ---------------------------------------------------------------------
typedef std::array<View, 32> Word;

Word word_const(uint32_t v) {
  Word w;
  for (int i = 0; i < 32; ++i) w[i] = view_const((v >> i) & 1);
  return w;
}

Word word_rotr(const Word& w, int by) {
  by &= 31;
  Word r;
  for (int i = 0; i < 32; ++i) r[i] = w[(i + by) & 31];
  return r;
}

Word word_shr(const Word& w, int by) {
  Word r;
  for (int i = 0; i < 32; ++i)
    r[i] = (i + by < 32) ? w[i + by] : view_const(false);
  return r;
}

Word word_xor(Builder& B, const Word& a, const Word& b) {
  Word r;
  for (int i = 0; i < 32; ++i) r[i] = bool_xor(B, a[i], b[i]);
  return r;
}

Word word_ch(Builder& B, const Word& a, const Word& b, const Word& c) {
  Word r;
  for (int i = 0; i < 32; ++i) r[i] = bool_ch(B, a[i], b[i], c[i]);
  return r;
}

Word word_maj(Builder& B, const Word& a, const Word& b, const Word& c) {
  Word r;
  for (int i = 0; i < 32; ++i) r[i] = bool_maj(B, a[i], b[i], c[i]);
  return r;
}

Word addmany(Builder& B, const std::vector<Word>& operands) {
  uint64_t max_value = (uint64_t)operands.size() * 0xFFFFFFFFull;
  bool all_constants = true;
  uint64_t const_sum = 0;
  LC lc;
  for (auto& op : operands) {
    uint32_t val = 0;
    for (int i = 0; i < 32; ++i) {
      lc_add_view(B, lc, op[i], B.pow2[i]);
      if (view_is_const(op[i])) {
        if (view_const_val(op[i])) val |= (1u << i);
      } else {
        all_constants = false;
      }
    }
    const_sum += val;
  }
  if (all_constants) return word_const((uint32_t)const_sum);

  // Allocate result bits (booleanity via alloc_bit), batch the equality.
  std::vector<int64_t> out_slots;
  LC result_lc;
  int i = 0;
  Word result{};
  while (max_value != 0) {
    View v = alloc_bit(B);
    out_slots.push_back(view_slot(v));
    result_lc.add(view_slot(v), B.pow2[i], B.p);
    if (i < 32) result[i] = v;
    max_value >>= 1;
    ++i;
  }
  multieq_enforce_equal(B, i, lc, result_lc);

  // Tape: addmany op with ALL result bits (incl. carries) + operand views.
  B.tape.push_back(OP_ADDMANY);
  B.tape.push_back((int64_t)out_slots.size());
  for (int64_t s : out_slots) B.tape.push_back(s);
  B.tape.push_back(-(int64_t)operands.size());  // negative marks word count
  for (auto& op : operands)
    for (int k = 0; k < 32; ++k) B.tape.push_back(op[k]);
  return result;
}

// ---------------------------------------------------------------------
// SHA-256 compression (sha256.rs:83-271), allocation order preserved.
// ---------------------------------------------------------------------
const uint32_t SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

struct Maybe {
  bool concrete;
  Word word;                  // when concrete
  std::vector<Word> deferred; // when not

  Word compute(Builder& B, const std::vector<Word>& others) {
    if (concrete && others.empty()) return word;
    std::vector<Word> ops = concrete ? std::vector<Word>{word} : deferred;
    for (auto& o : others) ops.push_back(o);
    if (concrete && ops.size() == 1) return word;
    return addmany(B, ops);
  }
};

void sha256_compression(Builder& B, const View in_bits[512],
                        const Word state[8], Word out[8]) {
  std::vector<Word> w;
  w.reserve(64);
  for (int i = 0; i < 16; ++i) {
    Word word;
    // from_bits_be: input bit groups are big-endian per 32.
    for (int j = 0; j < 32; ++j) word[j] = in_bits[i * 32 + (31 - j)];
    w.push_back(word);
  }
  // one MultiEq scope for the whole compression (sha256.rs:102)
  bool had_me = B.multieq_active;
  B.multieq_active = true;

  for (int i = 16; i < 64; ++i) {
    Word s0 = word_xor(B, word_rotr(w[i - 15], 7), word_rotr(w[i - 15], 18));
    s0 = word_xor(B, s0, word_shr(w[i - 15], 3));
    Word s1 = word_xor(B, word_rotr(w[i - 2], 17), word_rotr(w[i - 2], 19));
    s1 = word_xor(B, s1, word_shr(w[i - 2], 10));
    w.push_back(addmany(B, {w[i - 16], s0, w[i - 7], s1}));
  }

  Maybe a{true, state[0], {}};
  Word b = state[1], c = state[2], d = state[3];
  Maybe e{true, state[4], {}};
  Word f = state[5], g = state[6], h = state[7];

  for (int i = 0; i < 64; ++i) {
    Word new_e = e.compute(B, {});
    Word s1 = word_xor(B, word_rotr(new_e, 6), word_rotr(new_e, 11));
    s1 = word_xor(B, s1, word_rotr(new_e, 25));
    Word ch = word_ch(B, new_e, f, g);
    std::vector<Word> temp1 = {h, s1, ch, word_const(SHA_K[i]), w[i]};

    Word new_a = a.compute(B, {});
    Word s0 = word_xor(B, word_rotr(new_a, 2), word_rotr(new_a, 13));
    s0 = word_xor(B, s0, word_rotr(new_a, 22));
    Word maj = word_maj(B, new_a, b, c);

    h = g;
    g = f;
    f = new_e;
    e.concrete = false;
    e.deferred = temp1;
    e.deferred.push_back(d);
    d = c;
    c = b;
    b = new_a;
    a.concrete = false;
    a.deferred = temp1;
    a.deferred.push_back(s0);
    a.deferred.push_back(maj);
  }

  out[0] = a.compute(B, {state[0]});
  out[1] = addmany(B, {state[1], b});
  out[2] = addmany(B, {state[2], c});
  out[3] = addmany(B, {state[3], d});
  out[4] = e.compute(B, {state[4]});
  out[5] = addmany(B, {state[5], f});
  out[6] = addmany(B, {state[6], g});
  out[7] = addmany(B, {state[7], h});

  // close the MultiEq scope (Drop, multieq.rs:61-67)
  if (!had_me) {
    if (B.me_bits_used > 0) multieq_accumulate(B);
    B.multieq_active = false;
  }
}

// ---------------------------------------------------------------------
// BLAKE2s compression (blake2s.rs:171-315)
// ---------------------------------------------------------------------
const int BSIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};

void mixing_g(Builder& B, Word v[16], int a, int b, int c, int d,
              const Word& x, const Word& y) {
  v[a] = addmany(B, {v[a], v[b], x});
  v[d] = word_rotr(word_xor(B, v[d], v[a]), 16);
  v[c] = addmany(B, {v[c], v[d]});
  v[b] = word_rotr(word_xor(B, v[b], v[c]), 12);
  v[a] = addmany(B, {v[a], v[b], y});
  v[d] = word_rotr(word_xor(B, v[d], v[a]), 8);
  v[c] = addmany(B, {v[c], v[d]});
  v[b] = word_rotr(word_xor(B, v[b], v[c]), 7);
}

void blake2s_compression(Builder& B, Word h[8], const Word m[16], uint64_t t,
                         bool f) {
  static const uint32_t IV[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372,
                                 0xA54FF53A, 0x510E527F, 0x9B05688C,
                                 0x1F83D9AB, 0x5BE0CD19};
  Word v[16];
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  for (int i = 0; i < 8; ++i) v[8 + i] = word_const(IV[i]);

  v[12] = word_xor(B, v[12], word_const((uint32_t)t));
  v[13] = word_xor(B, v[13], word_const((uint32_t)(t >> 32)));
  if (f) v[14] = word_xor(B, v[14], word_const(0xFFFFFFFFu));

  bool had_me = B.multieq_active;
  B.multieq_active = true;
  for (int i = 0; i < 10; ++i) {
    const int* s = BSIGMA[i % 10];
    mixing_g(B, v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    mixing_g(B, v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    mixing_g(B, v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    mixing_g(B, v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    mixing_g(B, v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    mixing_g(B, v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    mixing_g(B, v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    mixing_g(B, v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  if (!had_me) {
    if (B.me_bits_used > 0) multieq_accumulate(B);
    B.multieq_active = false;
  }

  for (int i = 0; i < 8; ++i) {
    h[i] = word_xor(B, h[i], v[i]);
    h[i] = word_xor(B, h[i], v[i + 8]);
  }
}

// ---------------------------------------------------------------------
// AllocatedNum family (field-valued gadgets) — constraint formulas and
// tape ops mirror gadgets/num.py + multipack.py (and therefore
// num.rs:279-403, multipack.rs:76-105) exactly, so config-1-style field
// circuits synthesize natively with bit-exact artifact parity.
// ---------------------------------------------------------------------

// A free field-valued aux slot (no constraint, no tape op; the witness
// value arrives through the free-field inputs of the witness program).
int64_t alloc_num(Builder& B) { return slotcode_aux(B.alloc_aux()); }

// (a + b) * 1 = c   (num.rs:279-309)
int64_t num_add(Builder& B, int64_t sa, int64_t sb) {
  int64_t so = slotcode_aux(B.alloc_aux());
  B.tape_bitop(OP_FADD, so, sa, sb);
  LC a, b, c;
  a.add(sa, u256_one(), B.p);
  a.add(sb, u256_one(), B.p);
  b.add(slotcode_input(0), u256_one(), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  return so;
}

// a * b = c   (num.rs:311-341)
int64_t num_mul(Builder& B, int64_t sa, int64_t sb) {
  int64_t so = slotcode_aux(B.alloc_aux());
  B.tape_bitop(OP_FMUL, so, sa, sb);
  LC a, b, c;
  a.add(sa, u256_one(), B.p);
  b.add(sb, u256_one(), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  return so;
}

// a * a = c   (num.rs:343-373); tape op is fmul with duplicated operand.
int64_t num_square(Builder& B, int64_t sa) {
  int64_t so = slotcode_aux(B.alloc_aux());
  B.tape_bitop(OP_FMUL, so, sa, sa);
  LC a, b, c;
  a.add(sa, u256_one(), B.p);
  b.add(sa, u256_one(), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  return so;
}

// a * inv = 1 with an ephemeral inverse witness (num.rs:375-403).
void num_assert_nonzero(Builder& B, int64_t sa) {
  int64_t si = slotcode_aux(B.alloc_aux());
  B.tape.push_back(OP_FINV);
  B.tape.push_back(1);
  B.tape.push_back(si);
  B.tape.push_back(1);
  B.tape.push_back(sa);
  LC a, b, c;
  a.add(sa, u256_one(), B.p);
  b.add(si, u256_one(), B.p);
  c.add(slotcode_input(0), u256_one(), B.p);
  B.enforce(a, b, c);
}

// (sum 2^i * bit_i) * 1 = num   (multipack.rs:76-105). Bits are Boolean
// VIEWS with constant folding in the LC projection (boolean.rs:437-455):
// constant true adds coeff*one, Is(v) adds coeff*v, Not(v) adds
// coeff*one - coeff*v. Caller slices to field capacity.
int64_t pack_bits(Builder& B, const int64_t* views, int n) {
  int64_t so = slotcode_aux(B.alloc_aux());
  B.tape.push_back(OP_PACK);
  B.tape.push_back(1);
  B.tape.push_back(so);
  B.tape.push_back(n);
  for (int i = 0; i < n; i++) B.tape.push_back(views[i]);
  LC a, b, c;
  U256 coeff = u256_one();
  for (int i = 0; i < n; i++) {
    View v = views[i];
    if (view_is_const(v)) {
      if (view_const_val(v)) a.add(slotcode_input(0), coeff, B.p);
    } else if (view_neg(v)) {
      a.add(slotcode_input(0), coeff, B.p);
      a.add(view_slot(v), negmod(coeff, B.p), B.p);
    } else {
      a.add(view_slot(v), coeff, B.p);
    }
    coeff = addmod(coeff, coeff, B.p);
  }
  b.add(slotcode_input(0), u256_one(), B.p);
  c.add(so, u256_one(), B.p);
  B.enforce(a, b, c);
  return so;
}

// Full in-field strict LE bit decomposition (num.rs:128-251; mirrors
// gadgets/num.py to_bits_le_strict): run-of-ones k-ary AND over the
// big-endian bits of p-1; at each zero of p-1 the bit is allocated
// conditionally against the AND of the preceding run. Writes NUM_BITS
// Boolean views, LSB first, into out_views.
void num_to_bits_le_strict(Builder& B, int64_t sa, int64_t* out_views) {
  const int n = B.num_bits;
  U256 pm1 = u256_sub(B.p, u256_one());
  U256 one = u256_one();
  U256 neg1 = negmod(one, B.p);

  std::vector<int64_t> result;  // slotcodes, big-endian order
  result.reserve(n);
  std::vector<int64_t> current_run;
  bool have_last = false;
  int64_t last_run = 0;

  auto kary_and = [&](std::vector<int64_t>& v) {
    int64_t cur = v[0];
    for (size_t i = 1; i < v.size(); ++i)
      cur = view_slot(bit_and(B, cur, v[i]));
    return cur;
  };

  for (int i = 0; i < n; ++i) {
    if (u256_bit(pm1, n - 1 - i)) {
      int64_t sc = view_slot(alloc_bit(B));
      current_run.push_back(sc);
      result.push_back(sc);
    } else {
      if (!current_run.empty()) {
        if (have_last) current_run.push_back(last_run);
        last_run = kary_and(current_run);
        have_last = true;
        current_run.clear();
      }
      // alloc_conditionally (boolean.rs:27-64): (1 - run - a) * a = 0.
      // p's top bit is 1, so a zero of p-1 is always preceded by a run.
      int64_t sc = slotcode_aux(B.alloc_aux());
      LC a, b, c;
      a.add(slotcode_input(0), one, B.p);
      a.add(last_run, neg1, B.p);
      a.add(sc, neg1, B.p);
      b.add(sc, one, B.p);
      B.enforce(a, b, c);
      result.push_back(sc);
    }
  }

  // Tape: fbits_le with LSB-first outs.
  B.tape.push_back(OP_FBITS_LE);
  B.tape.push_back((int64_t)result.size());
  for (int i = (int)result.size() - 1; i >= 0; --i)
    B.tape.push_back(result[i]);
  B.tape.push_back(1);
  B.tape.push_back(sa);

  // Unpacking: (0) * (0) = sum 2^i bit_i - sa  over LE order.
  LC a, b, c;
  U256 coeff = one;
  for (int i = (int)result.size() - 1; i >= 0; --i) {
    c.add(result[i], coeff, B.p);
    coeff = doublemod(coeff, B.p);
  }
  c.add(sa, neg1, B.p);
  B.enforce(a, b, c);

  for (int i = 0; i < n; ++i)
    out_views[i] = view_var(result[n - 1 - i], false);
}

// conditionally_reverse (num.rs:408-454): (b, a) if cond else (a, b).
// (a-b)*cond = a-c ; (b-a)*cond = b-d. Mirrors gadgets/num.py.
void num_cond_reverse(Builder& B, int64_t sa, int64_t sb, View cond,
                      int64_t out2[2]) {
  U256 one = u256_one();
  U256 neg1 = negmod(one, B.p);

  int64_t sc = slotcode_aux(B.alloc_aux());
  B.tape.push_back(OP_SELECT);
  B.tape.push_back(1);
  B.tape.push_back(sc);
  B.tape.push_back(3);
  B.tape.push_back(cond);
  B.tape.push_back(sb);
  B.tape.push_back(sa);
  {
    LC A, Bm, C;
    A.add(sa, one, B.p);
    A.add(sb, neg1, B.p);
    lc_add_view(B, Bm, cond, one);
    C.add(sa, one, B.p);
    C.add(sc, neg1, B.p);
    B.enforce(A, Bm, C);
  }

  int64_t sd = slotcode_aux(B.alloc_aux());
  B.tape.push_back(OP_SELECT);
  B.tape.push_back(1);
  B.tape.push_back(sd);
  B.tape.push_back(3);
  B.tape.push_back(cond);
  B.tape.push_back(sa);
  B.tape.push_back(sb);
  {
    LC A, Bm, C;
    A.add(sb, one, B.p);
    A.add(sa, neg1, B.p);
    lc_add_view(B, Bm, cond, one);
    C.add(sb, one, B.p);
    C.add(sd, neg1, B.p);
    B.enforce(A, Bm, C);
  }
  out2[0] = sc;
  out2[1] = sd;
}

// 3-constraint is-zero over an AllocatedNum slot (boolean_utils.rs:52-98;
// mirrors gadgets/boolean_utils.py alloc_num_is_zero for the 1-term LC):
// result·x = 0 and (x + result)·q = 1 with q = x⁻¹ or 1.
View num_is_zero(Builder& B, int64_t sa) {
  U256 one = u256_one();
  View r = alloc_bit(B);
  int64_t sr = view_slot(r);
  B.tape.push_back(OP_NUM_ISZERO);
  B.tape.push_back(1);
  B.tape.push_back(sr);
  B.tape.push_back(1);  // n_terms
  B.tape.push_back(1);  // coeff
  B.tape.push_back(sa);
  {
    LC A, Bm, C;
    A.add(sr, one, B.p);
    Bm.add(sa, one, B.p);
    B.enforce(A, Bm, C);
  }
  int64_t sq = slotcode_aux(B.alloc_aux());
  B.tape.push_back(OP_NUM_INV_OR_ONE);
  B.tape.push_back(1);
  B.tape.push_back(sq);
  B.tape.push_back(1);
  B.tape.push_back(1);
  B.tape.push_back(sa);
  {
    LC A, Bm, C;
    A.add(sa, one, B.p);
    A.add(sr, one, B.p);
    Bm.add(sq, one, B.p);
    C.add(slotcode_input(0), one, B.p);
    B.enforce(A, Bm, C);
  }
  return r;
}

// Möbius / inclusion-exclusion multilinear coefficient synthesis
// (lookup.rs:11-28; mirrors gadgets/lookup.py synth).
void synth_coeffs(Builder& B, int w, const U256* constants, U256* assignment) {
  int n = 1 << w;
  for (int i = 0; i < n; ++i) {
    U256 cur = submod(constants[i], assignment[i], B.p);
    assignment[i] = cur;
    for (int j = i + 1; j < n; ++j)
      if ((j & i) == i) assignment[j] = addmod(assignment[j], cur, B.p);
  }
}

void tape_lookup(Builder& B, int64_t out, const View bits[3], const U256* table,
                 int n_table) {
  B.tape.push_back(OP_LOOKUP);
  B.tape.push_back(1);
  B.tape.push_back(out);
  B.tape.push_back(3);  // n index bits
  for (int i = 0; i < 3; ++i) B.tape.push_back(bits[i]);
  for (int i = 0; i < n_table; ++i)
    for (int j = 0; j < 4; ++j) B.tape.push_back((int64_t)table[i].w[j]);
}

// 3-bit window table lookup returning (x, y) slotcodes (lookup.rs:32-118;
// mirrors gadgets/lookup.py lookup3_xy). coords: 8 (x, y) pairs.
void lookup3_xy(Builder& B, const View bits[3], const U256* coords_x,
                const U256* coords_y, int64_t out2[2]) {
  U256 one = u256_one();
  int64_t sx = slotcode_aux(B.alloc_aux());
  int64_t sy = slotcode_aux(B.alloc_aux());
  tape_lookup(B, sx, bits, coords_x, 8);
  tape_lookup(B, sy, bits, coords_y, 8);

  U256 xc[8], yc[8];
  for (int i = 0; i < 8; ++i) xc[i] = yc[i] = u256_zero();
  synth_coeffs(B, 3, coords_x, xc);
  synth_coeffs(B, 3, coords_y, yc);

  View precomp = bool_and(B, bits[1], bits[2]);

  auto coord_row = [&](const U256* c, int64_t so) {
    LC A, Bm, C;
    A.add(slotcode_input(0), c[0b001], B.p);
    lc_add_view(B, A, bits[1], c[0b011]);
    lc_add_view(B, A, bits[2], c[0b101]);
    lc_add_view(B, A, precomp, c[0b111]);
    lc_add_view(B, Bm, bits[0], one);
    C.add(so, one, B.p);
    C.add(slotcode_input(0), negmod(c[0b000], B.p), B.p);
    lc_add_view(B, C, bits[1], negmod(c[0b010], B.p));
    lc_add_view(B, C, bits[2], negmod(c[0b100], B.p));
    lc_add_view(B, C, precomp, negmod(c[0b110], B.p));
    B.enforce(A, Bm, C);
  };
  coord_row(xc, sx);
  coord_row(yc, sy);
  out2[0] = sx;
  out2[1] = sy;
}

// 2-bit lookup with sign-bit conditional negation (lookup.rs:122-187;
// mirrors gadgets/lookup.py lookup3_xy_with_conditional_negation). Returns
// the allocated y slotcode; x comes back as a constraint-free LC on the
// Python side (Num), so nothing to allocate here. coords: 4 (x, y) pairs.
int64_t lookup3_xy_cn(Builder& B, const View bits[3], const U256* coords_y) {
  U256 one = u256_one();
  int64_t sy = slotcode_aux(B.alloc_aux());
  // Device table: sign bit is the top index bit; upper half negated.
  U256 table[8];
  for (int i = 0; i < 4; ++i) table[i] = coords_y[i];
  for (int i = 0; i < 4; ++i) table[4 + i] = negmod(coords_y[i], B.p);
  tape_lookup(B, sy, bits, table, 8);

  U256 yc[4];
  for (int i = 0; i < 4; ++i) yc[i] = u256_zero();
  synth_coeffs(B, 2, coords_y, yc);

  View precomp = bool_and(B, bits[0], bits[1]);

  // y_lc = y3·precomp + y2·b1 + y1·b0 + y0·one
  LC y_lc;
  lc_add_view(B, y_lc, precomp, yc[0b11]);
  lc_add_view(B, y_lc, bits[1], yc[0b10]);
  lc_add_view(B, y_lc, bits[0], yc[0b01]);
  y_lc.add(slotcode_input(0), yc[0b00], B.p);

  // (y_lc + y_lc) * sign = y_lc - y
  LC A, Bm, C;
  A.add_scaled(y_lc, addmod(one, one, B.p), B.p);
  lc_add_view(B, Bm, bits[2], one);
  C.add_scaled(y_lc, one, B.p);
  C.add(sy, negmod(one, B.p), B.p);
  B.enforce(A, Bm, C);
  return sy;
}

}  // namespace

// ---------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------
extern "C" {

void* bp_builder_new(const uint64_t p_words[4]) {
  return new Builder(p_words);
}
void bp_builder_free(void* b) { delete (Builder*)b; }

int64_t bp_alloc_bit(void* b) { return alloc_bit(*(Builder*)b); }
int64_t bp_const_view(int v) { return view_const(v != 0); }
int64_t bp_not(int64_t v) { return view_not(v); }
int64_t bp_xor(void* b, int64_t va, int64_t vb) {
  return bool_xor(*(Builder*)b, va, vb);
}
int64_t bp_and(void* b, int64_t va, int64_t vb) {
  return bool_and(*(Builder*)b, va, vb);
}
int64_t bp_ch(void* b, int64_t va, int64_t vb, int64_t vc) {
  return bool_ch(*(Builder*)b, va, vb, vc);
}
int64_t bp_maj(void* b, int64_t va, int64_t vb, int64_t vc) {
  return bool_maj(*(Builder*)b, va, vb, vc);
}

void bp_multieq_begin(void* b) { ((Builder*)b)->multieq_active = true; }
void bp_multieq_end(void* b) {
  Builder& B = *(Builder*)b;
  if (B.me_bits_used > 0) multieq_accumulate(B);
  B.multieq_active = false;
}

void bp_addmany(void* b, const int64_t* words, int n_words, int64_t* out32) {
  Builder& B = *(Builder*)b;
  std::vector<Word> ops(n_words);
  for (int i = 0; i < n_words; ++i)
    for (int j = 0; j < 32; ++j) ops[i][j] = words[i * 32 + j];
  Word r = addmany(B, ops);
  for (int j = 0; j < 32; ++j) out32[j] = r[j];
}

void bp_sha256_compression(void* b, const int64_t* in_bits512,
                           const int64_t* state256, int64_t* out256) {
  Builder& B = *(Builder*)b;
  Word state[8], out[8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 32; ++j) state[i][j] = state256[i * 32 + j];
  sha256_compression(B, in_bits512, state, out);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 32; ++j) out256[i * 32 + j] = out[i][j];
}

void bp_sha256_iv(int64_t* out256) {
  static const uint32_t IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  for (int i = 0; i < 8; ++i) {
    Word w = word_const(IV[i]);
    for (int j = 0; j < 32; ++j) out256[i * 32 + j] = w[j];
  }
}

void bp_blake2s_compression(void* b, int64_t* h256, const int64_t* m512,
                            uint64_t t, int f) {
  Builder& B = *(Builder*)b;
  Word h[8], m[16];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 32; ++j) h[i][j] = h256[i * 32 + j];
  for (int i = 0; i < 16; ++i)
    for (int j = 0; j < 32; ++j) m[i][j] = m512[i * 32 + j];
  blake2s_compression(B, h, m, t, f != 0);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 32; ++j) h256[i * 32 + j] = h[i][j];
}

int64_t bp_num_inputs(void* b) { return ((Builder*)b)->num_inputs; }
int64_t bp_num_aux(void* b) { return ((Builder*)b)->num_aux; }
int64_t bp_num_constraints(void* b) { return ((Builder*)b)->num_constraints; }
int64_t bp_nnz(void* b, int mat) {
  return (int64_t)((Builder*)b)->rows[mat].size();
}

void bp_get_coo(void* b, int mat, int32_t* rows, int32_t* cols,
                int32_t* cids) {
  Builder& B = *(Builder*)b;
  size_t n = B.rows[mat].size();
  memcpy(rows, B.rows[mat].data(), n * 4);
  memcpy(cids, B.cids[mat].data(), n * 4);
  // resolve aux markers against the final input count
  for (size_t i = 0; i < n; ++i) {
    int32_t c = B.cols[mat][i];
    cols[i] = c >= 0 ? c : (int32_t)B.num_inputs + (~c);
  }
}

int64_t bp_coeff_count(void* b) {
  return (int64_t)((Builder*)b)->coeff_table.size();
}
void bp_get_coeffs(void* b, uint64_t* out) {
  Builder& B = *(Builder*)b;
  for (size_t i = 0; i < B.coeff_table.size(); ++i)
    memcpy(out + i * 4, B.coeff_table[i].w, 32);
}

int64_t bp_tape_len(void* b) { return (int64_t)((Builder*)b)->tape.size(); }
void bp_get_tape(void* b, int64_t* out) {
  Builder& B = *(Builder*)b;
  memcpy(out, B.tape.data(), B.tape.size() * 8);
}

}  // extern "C"

namespace {

// Resolved-tape export: slotcodes are resolved to global slots (inputs
// first, against the FINAL input count) and Boolean views expand to
// (kind, slot_or_value, negated) triples — the exact integers
// the tape Ops carry. Emits TWO buffers: an operand
// stream (outs then args, contiguous per op) and an op table with one
// (opcode, n_outs, marker, outs_off, args_off) row per op — every arg
// width is a static function of (opcode, n_outs, marker), so the Python
// decoder batches ops group-wise with numpy fancy indexing instead of
// walking the stream element by element (the per-element Python
// resolution was the hot loop of NativeBuilder.finish at sha256 scale).
void resolve_tape(const Builder& B, std::vector<int64_t>& out,
                  std::vector<int64_t>& optable) {
  auto slot = [&](int64_t sc) {
    return (sc & 1) ? B.num_inputs + (sc >> 1) : (sc >> 1);
  };
  auto put = [&](int64_t v) { out.push_back(v); };
  auto put_view = [&](int64_t v) {
    if (!(v & 1)) {
      put(0);  // V_CONST
      put((v & 2) ? 1 : 0);
      put(0);
    } else {
      put(1);  // V_VAR
      put(slot(v >> 2));
      put((v & 2) ? 1 : 0);
    }
  };
  const std::vector<int64_t>& t = B.tape;
  size_t i = 0;
  while (i < t.size()) {
    int64_t opcode = t[i];
    int64_t n_outs = t[i + 1];
    i += 2;
    optable.push_back(opcode);
    optable.push_back(n_outs);
    int64_t marker_slot = (int64_t)optable.size();
    optable.push_back(0);  // marker, patched below
    optable.push_back((int64_t)out.size());
    for (int64_t k = 0; k < n_outs; ++k) put(slot(t[i + k]));
    i += n_outs;
    int64_t marker = t[i];
    optable[marker_slot] = marker;
    optable.push_back((int64_t)out.size());
    i += 1;
    switch (opcode) {
      case OP_ADDMANY: {
        int64_t n_views = (-marker) * 32;
        for (int64_t k = 0; k < n_views; ++k) put_view(t[i + k]);
        i += n_views;
        break;
      }
      case OP_CH:
      case OP_MAJ:
      case OP_PACK:
        for (int64_t k = 0; k < marker; ++k) put_view(t[i + k]);
        i += marker;
        break;
      case OP_SELECT:
        put_view(t[i]);
        put(slot(t[i + 1]));
        put(slot(t[i + 2]));
        i += 3;
        break;
      case OP_LOOKUP: {
        for (int64_t k = 0; k < marker; ++k) put_view(t[i + k]);
        i += marker;
        int64_t n_words = (int64_t)4 << marker;
        for (int64_t k = 0; k < n_words; ++k) put(t[i + k]);
        i += n_words;
        break;
      }
      case OP_NUM_ISZERO:
      case OP_NUM_INV_OR_ONE:
        for (int64_t k = 0; k < marker; ++k) {
          put(t[i + 2 * k]);
          put(slot(t[i + 2 * k + 1]));
        }
        i += 2 * marker;
        break;
      default:  // bit ops + fbits_le: plain slots
        for (int64_t k = 0; k < marker; ++k) put(slot(t[i + k]));
        i += marker;
    }
  }
}

}  // namespace

extern "C" {

// Multi-call protocol: bp_tape_resolved_len fills thread-local buffers
// and returns the operand-stream length; bp_tape_op_count returns the
// op-table row count; bp_get_tape_resolved copies both out and frees
// them.
static thread_local std::vector<int64_t> g_resolved;
static thread_local std::vector<int64_t> g_optable;

int64_t bp_tape_resolved_len(void* b) {
  g_resolved.clear();
  g_optable.clear();
  resolve_tape(*(Builder*)b, g_resolved, g_optable);
  return (int64_t)g_resolved.size();
}

int64_t bp_tape_op_count(void* b) {
  (void)b;
  return (int64_t)(g_optable.size() / 5);
}

void bp_get_tape_resolved(void* b, int64_t* out, int64_t* ops_out) {
  (void)b;
  memcpy(out, g_resolved.data(), g_resolved.size() * 8);
  memcpy(ops_out, g_optable.data(), g_optable.size() * 8);
  g_resolved.clear();
  g_resolved.shrink_to_fit();
  g_optable.clear();
  g_optable.shrink_to_fit();
}

int64_t bp_alloc_num(void* b) { return alloc_num(*(Builder*)b); }
int64_t bp_num_add(void* b, int64_t sa, int64_t sb) {
  return num_add(*(Builder*)b, sa, sb);
}
int64_t bp_num_mul(void* b, int64_t sa, int64_t sb) {
  return num_mul(*(Builder*)b, sa, sb);
}
int64_t bp_num_square(void* b, int64_t sa) {
  return num_square(*(Builder*)b, sa);
}
void bp_num_assert_nonzero(void* b, int64_t sa) {
  num_assert_nonzero(*(Builder*)b, sa);
}
int64_t bp_pack_bits(void* b, const int64_t* views, int n) {
  return pack_bits(*(Builder*)b, views, n);
}

void bp_num_to_bits_strict(void* b, int64_t sa, int64_t* out_views) {
  num_to_bits_le_strict(*(Builder*)b, sa, out_views);
}

void bp_num_cond_reverse(void* b, int64_t sa, int64_t sb, int64_t cond,
                         int64_t* out2) {
  num_cond_reverse(*(Builder*)b, sa, sb, cond, out2);
}

int64_t bp_num_is_zero(void* b, int64_t sa) {
  return num_is_zero(*(Builder*)b, sa);
}

// coords: 8 x-values then 8 y-values, 4 little-endian u64 words each.
void bp_lookup3_xy(void* b, const int64_t* bits3, const uint64_t* coords,
                   int64_t* out2) {
  U256 cx[8], cy[8];
  for (int i = 0; i < 8; ++i) {
    memcpy(cx[i].w, coords + i * 4, 32);
    memcpy(cy[i].w, coords + 32 + i * 4, 32);
  }
  View bits[3] = {bits3[0], bits3[1], bits3[2]};
  lookup3_xy(*(Builder*)b, bits, cx, cy, out2);
}

// coords: 4 y-values, 4 little-endian u64 words each.
int64_t bp_lookup3_xy_cn(void* b, const int64_t* bits3,
                         const uint64_t* coords_y) {
  U256 cy[4];
  for (int i = 0; i < 4; ++i) memcpy(cy[i].w, coords_y + i * 4, 32);
  View bits[3] = {bits3[0], bits3[1], bits3[2]};
  return lookup3_xy_cn(*(Builder*)b, bits, cy);
}

}  // extern "C"
