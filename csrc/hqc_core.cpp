// hqc_core: native HQC-RMRS model for the SCA-LDPC JAX framework.
//
// Re-implements, from the public HQC specification, the KEM internals that the
// reference consumes through its liboqs submodule (reference:
// simulate_rs/src/hqc.rs + dependencies/liboqs-rs-bindings, not vendored):
// keygen, encapsulation with attacker-chosen plaintext and r1, decapsulation
// with intermediate outputs, the e' extraction, rejection-sampling counting
// (the timing side channel), and a cycle-timed decapsulation oracle.
//
// NOT bit-compatible with liboqs key/ciphertext encodings (the submodule is
// not available to verify against); self-consistent, with the same structural
// properties the attack relies on:
//   - e' == y*r1 when r2 = e = 0          (hqc.rs:228-290, hqc.py:1201-1226)
//   - decoding fails iff > delta Reed-Muller blocks decode wrongly
//   - decaps re-encrypts with rejection sampling, so decaps timing leaks the
//     plaintext's seed-expansion count   (hqc.rs:175-200)
//
// Exposed as a flat C ABI consumed via ctypes (models/hqc/model.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <ctime>
#include <random>

#if defined(__x86_64__)
#include <x86intrin.h>
#include <cpuid.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Keccak-f[1600] and SHAKE256
// ---------------------------------------------------------------------------

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rotl64(uint64_t x, int s) { return (x << s) | (x >> (64 - s)); }

static void keccak_f1600(uint64_t st[25]) {
  static const int rho[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  static const int pi[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                             15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  for (int round = 0; round < 24; round++) {
    uint64_t bc[5];
    // theta
    for (int i = 0; i < 5; i++)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; i++) {
      uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    uint64_t t = st[1];
    for (int i = 0; i < 24; i++) {
      int j = pi[i];
      uint64_t tmp = st[j];
      st[j] = rotl64(t, rho[i]);
      t = tmp;
    }
    // chi
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; i++) bc[i] = st[j + i];
      for (int i = 0; i < 5; i++)
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
    }
    st[0] ^= KECCAK_RC[round];
  }
}

struct Shake256 {
  uint64_t st[25];
  uint8_t buf[136];  // rate = 136 bytes for SHAKE256
  size_t buf_len;
  size_t squeeze_pos;
  bool absorbing;

  void init() {
    memset(st, 0, sizeof(st));
    buf_len = 0;
    squeeze_pos = 136;
    absorbing = true;
  }

  void absorb(const uint8_t* data, size_t len) {
    while (len > 0) {
      size_t take = 136 - buf_len;
      if (take > len) take = len;
      memcpy(buf + buf_len, data, take);
      buf_len += take;
      data += take;
      len -= take;
      if (buf_len == 136) {
        for (int i = 0; i < 17; i++) {
          uint64_t w;
          memcpy(&w, buf + 8 * i, 8);
          st[i] ^= w;
        }
        keccak_f1600(st);
        buf_len = 0;
      }
    }
  }

  void finalize(uint8_t domain = 0x1F) {
    buf[buf_len++] = domain;
    memset(buf + buf_len, 0, 136 - buf_len);
    buf[135] |= 0x80;
    for (int i = 0; i < 17; i++) {
      uint64_t w;
      memcpy(&w, buf + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f1600(st);
    absorbing = false;
    squeeze_pos = 0;
  }

  void squeeze(uint8_t* out, size_t len) {
    while (len > 0) {
      if (squeeze_pos == 136) {
        keccak_f1600(st);
        squeeze_pos = 0;
      }
      size_t take = 136 - squeeze_pos;
      if (take > len) take = len;
      uint8_t block[136];
      for (int i = 0; i < 17; i++) memcpy(block + 8 * i, &st[i], 8);
      memcpy(out, block + squeeze_pos, take);
      squeeze_pos += take;
      out += take;
      len -= take;
    }
  }
};

static void shake256(uint8_t* out, size_t outlen, const uint8_t* in, size_t inlen,
                     uint8_t domain) {
  Shake256 s;
  s.init();
  s.absorb(in, inlen);
  s.finalize(domain);
  s.squeeze(out, outlen);
}

// ---------------------------------------------------------------------------
// Parameter sets (public HQC-RMRS specification values)
// ---------------------------------------------------------------------------

struct HqcParams {
  int security;
  int n;        // ring size (prime)
  int n1;       // RS code length (symbols)
  int n2;       // RM block length (bits) = 128 * mult
  int mult;     // RM(1,7) duplication
  int k;        // plaintext bytes (RS dimension)
  int delta;    // RS correction capability
  int omega;    // secret weight (x, y)
  int omega_e;  // e weight
  int omega_r;  // r1, r2 weight
};

static const HqcParams PARAMS[3] = {
    // hqc-128
    {128, 17669, 46, 384, 3, 16, 15, 66, 75, 75},
    // hqc-192
    {192, 35851, 56, 640, 5, 24, 16, 100, 114, 114},
    // hqc-256
    {256, 57637, 90, 640, 5, 32, 29, 131, 149, 149},
};

static const int SEED_BYTES = 40;

static inline const HqcParams& P(int ver) { return PARAMS[ver]; }
static inline int n_words(int ver) { return (P(ver).n + 63) / 64; }
static inline int n_bytes(int ver) { return (P(ver).n + 7) / 8; }
static inline int n1n2(int ver) { return P(ver).n1 * P(ver).n2; }
static inline int n1n2_bytes(int ver) { return (n1n2(ver) + 7) / 8; }

// Public key: pk_seed (40) || s (n_bytes).  Secret key: sk_seed (40) || pk.
int hqc_pk_bytes(int ver) { return SEED_BYTES + n_bytes(ver); }
int hqc_sk_bytes(int ver) { return SEED_BYTES + hqc_pk_bytes(ver); }
int hqc_ct_bytes(int ver) { return n_bytes(ver) + n1n2_bytes(ver); }
int hqc_ss_bytes(int ver) { return 64; }
int hqc_pt_bytes(int ver) { return P(ver).k; }

long long hqc_param(int ver, const char* what) {
  const HqcParams& p = P(ver);
  if (!strcmp(what, "N")) return p.n;
  if (!strcmp(what, "N1")) return p.n1;
  if (!strcmp(what, "N2")) return p.n2;
  if (!strcmp(what, "N1N2")) return (long long)p.n1 * p.n2;
  if (!strcmp(what, "SECURITY")) return p.security;
  if (!strcmp(what, "DELTA")) return p.delta;
  if (!strcmp(what, "OMEGA")) return p.omega;
  if (!strcmp(what, "OMEGA_E")) return p.omega_e;
  if (!strcmp(what, "OMEGA_R")) return p.omega_r;
  if (!strcmp(what, "MULT")) return p.mult;
  if (!strcmp(what, "K")) return p.k;
  return -1;
}

// ---------------------------------------------------------------------------
// Seed expander with expansion/rejection accounting (the side channel)
// ---------------------------------------------------------------------------

struct SeedExpander {
  Shake256 xof;
  uint8_t* buf;
  size_t buf_cap;
  size_t buf_len;
  size_t pos;
  long expansions;
  long rejections;
  // Block-aligned expansions: each expand() starts at a fresh Keccak block
  // boundary, so every expansion costs exactly ceil(chunk/136) permutations
  // regardless of history.  This mirrors the reference's per-vector
  // seedexpander calls on liboqs (fresh full-block squeezes each call) and
  // makes the timing side channel LINEAR in the expansion count; without it
  // the partial-block carry makes two-expansion garbage re-encryptions
  // time identically to the three-expansion attack plaintext, capping the
  // fail-class oracle accuracy at ~0.92 instead of P(extra<3)=0.994
  // (measured per-vector-pattern diagnostics, round 2).  Keygen keeps the
  // carried-block behavior so existing key fixtures derive unchanged.
  bool block_aligned;

  void init(const uint8_t* seed, size_t seed_len) {
    xof.init();
    xof.absorb(seed, seed_len);
    xof.finalize(0x1F);
    buf = nullptr;
    buf_cap = buf_len = pos = 0;
    expansions = 0;
    rejections = 0;
    block_aligned = false;
  }
  void release() { free(buf); buf = nullptr; }

  // One "seed expansion": squeeze `chunk` fresh bytes, discarding leftovers
  // (each fixed-weight sampling batch starts a new expansion, mirroring the
  // per-vector seedexpander calls whose count the timing oracle observes).
  void expand(size_t chunk) {
    if (buf_cap < chunk) {
      buf = (uint8_t*)realloc(buf, chunk);
      buf_cap = chunk;
    }
    if (block_aligned) xof.squeeze_pos = 136;  // next squeeze: fresh block
    xof.squeeze(buf, chunk);
    buf_len = chunk;
    pos = 0;
    expansions++;
  }

  // 24-bit big-endian candidate; triggers a fresh expansion on exhaustion.
  uint32_t next24(size_t chunk) {
    if (pos + 3 > buf_len) expand(chunk);
    uint32_t v = ((uint32_t)buf[pos] << 16) | ((uint32_t)buf[pos + 1] << 8) |
                 (uint32_t)buf[pos + 2];
    pos += 3;
    return v;
  }
};

// Fixed-weight vector sampling with rejection counting.  Each vector draws an
// initial batch of 3*weight bytes (one expansion); every threshold rejection
// or duplicate costs 3 more bytes, overflowing into further expansions.
static void sample_fixed_weight(SeedExpander& se, int ver, int weight,
                                uint32_t* out_pos) {
  const uint32_t n = (uint32_t)P(ver).n;
  const uint32_t threshold = (0xFFFFFFu / n) * n;  // largest multiple of n
  const size_t chunk = (size_t)3 * weight;
  se.expand(chunk);
  int got = 0;
  while (got < weight) {
    uint32_t cand = se.next24(chunk);
    if (cand >= threshold) {
      se.rejections++;
      continue;
    }
    uint32_t v = cand % n;
    bool dup = false;
    for (int i = 0; i < got; i++)
      if (out_pos[i] == v) { dup = true; break; }
    if (dup) {
      se.rejections++;
      continue;
    }
    out_pos[got++] = v;
  }
}

// Dense uniform ring element from the expander.
static void sample_dense(SeedExpander& se, int ver, uint64_t* out) {
  int nb = n_bytes(ver);
  se.expand((size_t)nb);
  memset(out, 0, (size_t)n_words(ver) * 8);
  memcpy(out, se.buf, (size_t)nb);
  // Mask the tail beyond n bits.
  int nbits = P(ver).n;
  int tail = nbits % 64;
  if (tail) out[nbits / 64] &= ((~0ULL) >> (64 - tail));
}

// ---------------------------------------------------------------------------
// GF(2)[x]/(x^n - 1) arithmetic on u64 words
// ---------------------------------------------------------------------------

static void ring_add(int ver, uint64_t* acc, const uint64_t* b) {
  int w = n_words(ver);
  for (int i = 0; i < w; i++) acc[i] ^= b[i];
}

// acc2 (>= 2w+2 words) ^= dense << shift, NO modular fold.  Word-granular:
// constant-time in the data (the decaps timing channel must stay the SHAKE
// rejection-sampling expansion count, not ring-arithmetic bit patterns).
static void xor_shifted_raw(int w, uint64_t* acc2, const uint64_t* dense,
                            uint32_t shift) {
  const int word_shift = (int)(shift / 64);
  const int bit_shift = (int)(shift % 64);
  if (bit_shift == 0) {
    for (int i = 0; i < w; i++) acc2[i + word_shift] ^= dense[i];
  } else {
    for (int i = 0; i < w; i++) {
      acc2[i + word_shift] ^= dense[i] << bit_shift;
      acc2[i + word_shift + 1] ^= dense[i] >> (64 - bit_shift);
    }
  }
}

// out = tmp mod (x^n - 1), tmp holding a < 2n-bit polynomial (2w+2 words).
// Bits [n, 2n) fold onto [0, n): one word-wise shifted XOR.
static void ring_fold(int ver, uint64_t* out, const uint64_t* tmp) {
  const int nbits = P(ver).n;
  const int w = n_words(ver);
  const int W = nbits / 64;
  const int s = nbits % 64;
  for (int i = 0; i < w; i++) out[i] = tmp[i];
  if (s == 0) {
    for (int i = 0; i < w; i++) out[i] ^= tmp[W + i];
  } else {
    for (int i = 0; i < w; i++)
      out[i] ^= (tmp[W + i] >> s) | (tmp[W + i + 1] << (64 - s));
    out[W] &= ((~0ULL) >> (64 - s));  // clear bits >= n
  }
}

// out = sparse * dense (cyclic product; sparse given as positions):
// accumulate every shifted copy into a double-width scratch, fold once.
static void ring_mul_sparse(int ver, uint64_t* out, const uint32_t* sparse,
                            int weight, const uint64_t* dense) {
  const int w = n_words(ver);
  static thread_local uint64_t* tmp = nullptr;
  static thread_local int tmp_cap = 0;
  if (tmp_cap < 2 * w + 2) {
    tmp = (uint64_t*)realloc(tmp, sizeof(uint64_t) * (2 * w + 2));
    tmp_cap = 2 * w + 2;
  }
  memset(tmp, 0, sizeof(uint64_t) * (2 * w + 2));
  for (int i = 0; i < weight; i++) xor_shifted_raw(w, tmp, dense, sparse[i]);
  ring_fold(ver, out, tmp);
}

static inline int get_bit(const uint64_t* v, int i) {
  return (int)((v[i / 64] >> (i % 64)) & 1);
}
static inline void set_bit(uint64_t* v, int i) { v[i / 64] |= (1ULL << (i % 64)); }

// ---------------------------------------------------------------------------
// GF(256), Reed-Solomon [n1, k, 2*delta+1]
// ---------------------------------------------------------------------------

static uint8_t GF_EXP[512];
static uint8_t GF_LOG[256];
static bool gf_ready = false;

static void gf_init() {
  if (gf_ready) return;
  int x = 1;
  for (int i = 0; i < 255; i++) {
    GF_EXP[i] = (uint8_t)x;
    GF_LOG[x] = (uint8_t)i;
    x <<= 1;
    if (x & 0x100) x ^= 0x11D;  // HQC's primitive polynomial
  }
  for (int i = 255; i < 512; i++) GF_EXP[i] = GF_EXP[i - 255];
  GF_LOG[0] = 0;
  gf_ready = true;
}

static inline uint8_t gf_mul(uint8_t a, uint8_t b) {
  // Branchless (mask instead of early-out): RS decode must do the same
  // work for every input so the decaps timing channel stays the
  // re-encryption rejection sampling (see rs_decode below).
  uint8_t m = (uint8_t)(-(int)(a != 0) & -(int)(b != 0));
  return m & GF_EXP[GF_LOG[a] + GF_LOG[b]];
}
static inline uint8_t gf_inv(uint8_t a) { return GF_EXP[255 - GF_LOG[a]]; }

// Systematic RS encode via LFSR division by the generator polynomial
// g(x) = prod_{i=1}^{2 delta} (x - alpha^i).
static void rs_generator(int ver, uint8_t* g /* size 2*delta+1 */) {
  gf_init();
  int twod = 2 * P(ver).delta;
  g[0] = 1;
  for (int i = 1; i <= twod; i++) g[i] = 0;
  for (int i = 1; i <= twod; i++) {
    uint8_t root = GF_EXP[i % 255];
    // g *= (x - root): new g[j] = g[j-1] + root*g[j]
    for (int j = i; j >= 1; j--) g[j] = g[j - 1] ^ gf_mul(root, g[j]);
    g[0] = gf_mul(root, g[0]);
  }
}

static void rs_encode(int ver, const uint8_t* msg /* k */, uint8_t* cw /* n1 */) {
  const HqcParams& p = P(ver);
  int twod = 2 * p.delta;  // n1 - k
  uint8_t g[2 * 64 + 1];
  rs_generator(ver, g);
  // codeword = [parity (twod) | message (k)], message in high positions.
  uint8_t rem[2 * 64];
  memset(rem, 0, sizeof(rem));
  for (int i = p.k - 1; i >= 0; i--) {
    uint8_t fb = msg[i] ^ rem[twod - 1];
    for (int j = twod - 1; j >= 1; j--)
      rem[j] = rem[j - 1] ^ gf_mul(fb, g[j]);
    rem[0] = gf_mul(fb, g[0]);
  }
  for (int i = 0; i < twod; i++) cw[i] = rem[i];
  for (int i = 0; i < p.k; i++) cw[twod + i] = msg[i];
}

static void rs_syndromes(int ver, const uint8_t* cw, uint8_t* synd) {
  gf_init();
  const HqcParams& p = P(ver);
  const int twod = 2 * p.delta;
  for (int i = 0; i < twod; i++) {
    uint8_t s = 0;
    for (int j = 0; j < p.n1; j++)
      s ^= gf_mul(cw[j], GF_EXP[((i + 1) * j) % 255]);
    synd[i] = s;
  }
}

// Bounded-distance RS decode (syndromes + Berlekamp-Massey + Chien + Forney).
// Returns 0 on success (<= delta errors corrected), -1 on failure.
//
// CONSTANT WORK: every call executes the full pipeline with fixed loop
// bounds regardless of the error pattern (no all-zero-syndrome early out,
// no early failure returns; corrections are committed through a success
// mask).  The liboqs implementation the reference attacks is constant-time,
// which is what makes decaps timing ≡ re-encryption rejection sampling
// (hqc.rs:175-200); a bounded-distance decoder with data-dependent phases
// leaks ~3k GF ops between clean and corrupted words — measured on this
// model, that INVERTED the timing channel (modified ciphertexts decapsed
// ~9k cycles slower).  On failure the word is left pristine; decrypt_core
// then folds the (nonzero) syndrome in as the deterministic miscorrection.
// `synd_out` (optional, 2*delta bytes) receives the INPUT word's syndromes
// — on failure exactly what the caller's fold needs, saving a third
// syndrome pass per decapsulation.
static int rs_decode(int ver, uint8_t* cw /* n1, corrected in place */,
                     uint8_t* synd_out = nullptr) {
  gf_init();
  const HqcParams& p = P(ver);
  const int twod = 2 * p.delta;
  const int delta = p.delta;
  uint8_t synd[2 * 64];
  rs_syndromes(ver, cw, synd);
  if (synd_out) memcpy(synd_out, synd, (size_t)twod);

  // Berlekamp-Massey, flattened: fixed loop bounds, branch decisions
  // applied as byte masks.  C's degree never exceeds L, so summing its
  // full fixed range adds only zero terms.
  uint8_t C[2 * 64 + 1], B[2 * 64 + 1], T[2 * 64 + 1];
  memset(C, 0, sizeof(C));
  memset(B, 0, sizeof(B));
  C[0] = B[0] = 1;
  int L = 0, m = 1;
  uint8_t b = 1;
  for (int nIdx = 0; nIdx < twod; nIdx++) {
    uint8_t d = synd[nIdx];
    for (int i = 1; i <= nIdx; i++) d ^= gf_mul(C[i], synd[nIdx - i]);
    uint8_t dm = (uint8_t)-(int)(d != 0);          // update at all?
    uint8_t sw = dm & (uint8_t)-(int)(2 * L <= nIdx);  // length change?
    uint8_t coef = gf_mul(d, gf_inv(b));  // 0 when d == 0 (b is never 0)
    memcpy(T, C, sizeof(C));
    for (int i = 0; i <= twod; i++) {
      uint8_t bb = (i >= m) ? B[i - m] : 0;
      C[i] ^= gf_mul(coef, bb);
    }
    for (int i = 0; i <= twod; i++) B[i] = (uint8_t)((B[i] & ~sw) | (T[i] & sw));
    b = (uint8_t)((b & ~sw) | (d & sw));
    int L2 = nIdx + 1 - L;
    L = (sw ? L2 : L);
    m = (sw ? 1 : m + 1);
  }
  int fail = (L > delta);

  // Chien search over all codeword positions: error at j iff
  // C(alpha^{-j}) == 0.  Fixed inner bound delta (C[i>L] == 0 when the
  // decode can succeed; when L > delta `fail` already stands).
  uint8_t is_err[128];
  int n_err = 0;
  for (int j = 0; j < p.n1; j++) {
    uint8_t v = C[0];
    for (int i = 1; i <= delta; i++)
      v ^= gf_mul(C[i], GF_EXP[(((255 - j) % 255) * i) % 255]);
    is_err[j] = (uint8_t)-(int)(v == 0);
    n_err += (int)(v == 0);
  }
  fail |= (n_err != L);

  // Forney at every position (masked): Omega = S*C mod x^{2delta},
  // e_j = Omega(X^-1) / Lambda'(X^-1) committed only where is_err.
  uint8_t omega[2 * 64];
  for (int i = 0; i < twod; i++) {
    uint8_t acc = 0;
    int jmax = i < delta ? i : delta;
    for (int j = 0; j <= jmax; j++) acc ^= gf_mul(C[j], synd[i - j]);
    omega[i] = acc;
  }
  uint8_t corr[128];
  for (int j = 0; j < p.n1; j++) {
    uint8_t xinv = GF_EXP[(255 - j) % 255];  // alpha^{-j}
    uint8_t num = 0, den = 0;
    uint8_t xp = 1;
    for (int i = 0; i < twod; i++) {
      num ^= gf_mul(omega[i], xp);
      xp = gf_mul(xp, xinv);
    }
    // C'(x): odd-degree terms
    xp = 1;
    uint8_t xinv2 = gf_mul(xinv, xinv);
    for (int i = 1; i <= delta; i += 2) {
      den ^= gf_mul(C[i], xp);
      xp = gf_mul(xp, xinv2);
    }
    fail |= (is_err[j] & (uint8_t)-(int)(den == 0)) != 0;
    // Narrow-sense (syndromes at alpha^1..alpha^2delta)
    uint8_t mag = gf_mul(num, gf_inv(den));
    corr[j] = (uint8_t)(mag & is_err[j]);
  }

  // Verify the tentative correction, then commit on success only.
  uint8_t tent[128] = {0};
  for (int j = 0; j < p.n1; j++) tent[j] = (uint8_t)(cw[j] ^ corr[j]);
  uint8_t vs[2 * 64];
  rs_syndromes(ver, tent, vs);
  uint8_t any = 0;
  for (int i = 0; i < twod; i++) any |= vs[i];
  fail |= (any != 0);
  uint8_t ok_mask = (uint8_t)~(uint8_t)-(int)(fail != 0);
  for (int j = 0; j < p.n1; j++) cw[j] ^= (uint8_t)(corr[j] & ok_mask);
  return fail ? -1 : 0;
}

// Test hooks for the Python conformance suite.
int hqc_rs_encode(int ver, const uint8_t* msg, uint8_t* cw) {
  rs_encode(ver, msg, cw);
  return 0;
}
int hqc_rs_decode(int ver, uint8_t* cw) { return rs_decode(ver, cw); }

// ---------------------------------------------------------------------------
// Duplicated Reed-Muller RM(1,7)
// ---------------------------------------------------------------------------

// Encode one byte into 128 bits: bit j = <j, m[0:7]> xor m[7].
static void rm_encode_symbol(uint8_t m, uint8_t bits[128]) {
  int msb = (m >> 7) & 1;
  int low = m & 0x7F;
  for (int j = 0; j < 128; j++)
    bits[j] = (uint8_t)((__builtin_popcount(j & low) & 1) ^ msb);
}

// Decode `mult` copies via sum + fast Hadamard transform.
static uint8_t rm_decode_block(const int16_t f_in[128]) {
  int32_t w[128];
  for (int i = 0; i < 128; i++) w[i] = f_in[i];
  for (int step = 1; step < 128; step <<= 1) {
    for (int i = 0; i < 128; i += step << 1) {
      for (int j = i; j < i + step; j++) {
        int32_t a = w[j], b = w[j + step];
        w[j] = a + b;
        w[j + step] = a - b;
      }
    }
  }
  int best_u = 0;
  int32_t best_abs = -1;
  for (int u = 0; u < 128; u++) {
    int32_t a = w[u] < 0 ? -w[u] : w[u];
    if (a > best_abs) {
      best_abs = a;
      best_u = u;
    }
  }
  uint8_t m = (uint8_t)best_u;
  if (w[best_u] < 0) m |= 0x80;
  return m;
}

// Encode n1 RS symbols into n1*n2 bits (mult copies of RM(1,7) each).
static void rm_encode(int ver, const uint8_t* symbols, uint64_t* out_bits) {
  const HqcParams& p = P(ver);
  memset(out_bits, 0, (size_t)n_words(ver) * 8);
  uint8_t bits[128];
  for (int s = 0; s < p.n1; s++) {
    rm_encode_symbol(symbols[s], bits);
    int base = s * p.n2;
    for (int c = 0; c < p.mult; c++) {
      for (int j = 0; j < 128; j++) {
        if (bits[j]) set_bit(out_bits, base + c * 128 + j);
      }
    }
  }
}

// Decode n1n2 bits into n1 symbols (multiplicity-summed +-1 correlations).
static void rm_decode(int ver, const uint64_t* in_bits, uint8_t* symbols) {
  const HqcParams& p = P(ver);
  for (int s = 0; s < p.n1; s++) {
    int16_t f[128];
    int base = s * p.n2;
    for (int j = 0; j < 128; j++) {
      int acc = 0;
      for (int c = 0; c < p.mult; c++)
        acc += 1 - 2 * get_bit(in_bits, base + c * 128 + j);
      f[j] = (int16_t)acc;
    }
    symbols[s] = rm_decode_block(f);
  }
}

// ---------------------------------------------------------------------------
// HQC KEM
// ---------------------------------------------------------------------------

// mG: plaintext -> concatenated RS+RM codeword (n bits, top bits zero)
static void encode_mg(int ver, const uint8_t* m, uint64_t* out) {
  uint8_t rs[128];
  rs_encode(ver, m, rs);
  rm_encode(ver, rs, out);
}

static void derive_h(int ver, const uint8_t* pk_seed, uint64_t* h) {
  SeedExpander se;
  se.init(pk_seed, SEED_BYTES);
  sample_dense(se, ver, h);
  se.release();
}

static void derive_xy(int ver, const uint8_t* sk_seed, uint32_t* x_pos,
                      uint32_t* y_pos) {
  SeedExpander se;
  se.init(sk_seed, SEED_BYTES);
  sample_fixed_weight(se, ver, P(ver).omega, x_pos);
  sample_fixed_weight(se, ver, P(ver).omega, y_pos);
  se.release();
}

static void os_random(uint8_t* out, size_t len) {
  static std::random_device rd;
  for (size_t i = 0; i < len; i += 4) {
    uint32_t v = rd();
    size_t take = len - i < 4 ? len - i : 4;
    memcpy(out + i, &v, take);
  }
}

int hqc_keypair(int ver, uint8_t* pk, uint8_t* sk) {
  uint8_t sk_seed[SEED_BYTES], pk_seed[SEED_BYTES];
  os_random(sk_seed, SEED_BYTES);
  os_random(pk_seed, SEED_BYTES);

  int w = n_words(ver);
  uint64_t* h = new uint64_t[w];
  uint64_t* s = new uint64_t[w];
  uint64_t* hy = new uint64_t[w];
  uint32_t x_pos[256], y_pos[256];

  derive_h(ver, pk_seed, h);
  derive_xy(ver, sk_seed, x_pos, y_pos);

  // s = x + h*y
  ring_mul_sparse(ver, hy, y_pos, P(ver).omega, h);
  memset(s, 0, (size_t)w * 8);
  for (int i = 0; i < P(ver).omega; i++) set_bit(s, (int)x_pos[i]);
  ring_add(ver, s, hy);

  memcpy(pk, pk_seed, SEED_BYTES);
  memcpy(pk + SEED_BYTES, s, (size_t)n_bytes(ver));
  memcpy(sk, sk_seed, SEED_BYTES);
  memcpy(sk + SEED_BYTES, pk, (size_t)hqc_pk_bytes(ver));

  delete[] h;
  delete[] s;
  delete[] hy;
  return 0;
}

int hqc_secrets_from_key(int ver, const uint8_t* sk, uint64_t* x_words,
                         uint32_t* y_pos) {
  uint32_t x_pos[256];
  derive_xy(ver, sk, x_pos, y_pos);
  memset(x_words, 0, (size_t)n_words(ver) * 8);
  for (int i = 0; i < P(ver).omega; i++) set_bit(x_words, (int)x_pos[i]);
  return P(ver).omega;
}

// Sample the encryption randomness for plaintext m, counting expansions and
// rejections.  Sampling order: e (omega_e), r1 (omega_r), r2 (omega_r).
static void sample_encrypt_randomness(int ver, const uint8_t* m, uint32_t* e_pos,
                                      uint32_t* r1_pos, uint32_t* r2_pos,
                                      long* expansions, long* rejections) {
  uint8_t theta[64];
  shake256(theta, 64, m, (size_t)P(ver).k, 0x02);  // G(m), domain-separated
  SeedExpander se;
  se.init(theta, 64);
  se.block_aligned = true;  // re-encryption path: linear per-expansion cost
  sample_fixed_weight(se, ver, P(ver).omega_e, e_pos);
  sample_fixed_weight(se, ver, P(ver).omega_r, r1_pos);
  sample_fixed_weight(se, ver, P(ver).omega_r, r2_pos);
  if (expansions) *expansions = se.expansions;
  if (rejections) *rejections = se.rejections;
  se.release();
}

// Per-vector extra-expansion pattern: out[0..2] = extra expansions drawn
// while sampling e, r1, r2 respectively (beyond each vector's initial one).
// Diagnostic for the timing side channel: the cycle cost of an expansion
// depends on which vector's sampling triggers it.
void hqc_expansion_pattern(int ver, const uint8_t* pt, int* out3) {
  uint8_t theta[64];
  shake256(theta, 64, pt, (size_t)P(ver).k, 0x02);
  SeedExpander se;
  se.init(theta, 64);
  se.block_aligned = true;  // mirror the re-encryption path
  uint32_t pos[256];
  long prev = 0;
  const int weights[3] = {P(ver).omega_e, P(ver).omega_r, P(ver).omega_r};
  for (int i = 0; i < 3; i++) {
    sample_fixed_weight(se, ver, weights[i], pos);
    out3[i] = (int)(se.expansions - prev - 1);  // minus the initial one
    prev = se.expansions;
  }
  se.release();
}

long long hqc_num_rejections(int ver, const uint8_t* pt) {
  uint32_t e_pos[256], r1_pos[256], r2_pos[256];
  long expansions = 0, rejections = 0;
  sample_encrypt_randomness(ver, pt, e_pos, r1_pos, r2_pos, &expansions,
                            &rejections);
  // Reference format: seedexpansions * 1000 + rejections (hqc.rs:66-74)
  return (long long)expansions * 1000 + rejections;
}

// Core encryption: u = r1 + h*r2 ; v = truncate(mG + s*r2 + e)
static void encrypt_with(int ver, const uint8_t* pk, const uint8_t* m,
                         const uint32_t* e_pos, int e_w, const uint32_t* r1_pos,
                         int r1_w, const uint32_t* r2_pos, int r2_w, uint64_t* u,
                         uint64_t* v) {
  int w = n_words(ver);
  uint64_t* h = new uint64_t[w];
  uint64_t* s = new uint64_t[w];
  uint64_t* tmp = new uint64_t[w];

  derive_h(ver, pk, h);
  memset(s, 0, (size_t)w * 8);
  memcpy(s, pk + SEED_BYTES, (size_t)n_bytes(ver));

  // u = r1 + h * r2
  ring_mul_sparse(ver, u, r2_pos, r2_w, h);
  for (int i = 0; i < r1_w; i++) {
    int b = (int)r1_pos[i];
    u[b / 64] ^= (1ULL << (b % 64));
  }

  // v = mG + s*r2 + e, truncated to n1n2 bits
  encode_mg(ver, m, v);
  ring_mul_sparse(ver, tmp, r2_pos, r2_w, s);
  ring_add(ver, v, tmp);
  for (int i = 0; i < e_w; i++) {
    int b = (int)e_pos[i];
    v[b / 64] ^= (1ULL << (b % 64));
  }
  // truncate v to n1n2 bits
  int lim = n1n2(ver);
  for (int i = lim; i < P(ver).n; i++) {
    if (get_bit(v, i)) v[i / 64] ^= (1ULL << (i % 64));
  }
  delete[] h;
  delete[] s;
  delete[] tmp;
}

static void pack_ct(int ver, const uint64_t* u, const uint64_t* v, uint8_t* ct) {
  memcpy(ct, u, (size_t)n_bytes(ver));
  memcpy(ct + n_bytes(ver), v, (size_t)n1n2_bytes(ver));
}

static void unpack_ct(int ver, const uint8_t* ct, uint64_t* u, uint64_t* v) {
  int w = n_words(ver);
  memset(u, 0, (size_t)w * 8);
  memset(v, 0, (size_t)w * 8);
  memcpy(u, ct, (size_t)n_bytes(ver));
  memcpy(v, ct + n_bytes(ver), (size_t)n1n2_bytes(ver));
  int tail = P(ver).n % 64;
  if (tail) u[P(ver).n / 64] &= ((~0ULL) >> (64 - tail));
}

static void derive_ss(int ver, const uint8_t* m, const uint8_t* ct, uint8_t* ss) {
  Shake256 sx;
  sx.init();
  uint8_t dom = 0x04;
  sx.absorb(&dom, 1);
  sx.absorb(m, (size_t)P(ver).k);
  sx.absorb(ct, (size_t)hqc_ct_bytes(ver));
  sx.finalize(0x1F);
  sx.squeeze(ss, 64);
}

int hqc_encaps(int ver, const uint8_t* pk, uint8_t* ct, uint8_t* ss) {
  uint8_t m[64];
  os_random(m, (size_t)P(ver).k);
  uint32_t e_pos[256], r1_pos[256], r2_pos[256];
  sample_encrypt_randomness(ver, m, e_pos, r1_pos, r2_pos, nullptr, nullptr);
  int w = n_words(ver);
  uint64_t* u = new uint64_t[w];
  uint64_t* v = new uint64_t[w];
  encrypt_with(ver, pk, m, e_pos, P(ver).omega_e, r1_pos, P(ver).omega_r, r2_pos,
               P(ver).omega_r, u, v);
  pack_ct(ver, u, v, ct);
  derive_ss(ver, m, ct, ss);
  delete[] u;
  delete[] v;
  return 0;
}

// Attacker-chosen plaintext and sparse r1; r2 = e = 0 (hqc.rs:100-125).
int hqc_encaps_with_pt_r1(int ver, const uint8_t* pk, const uint8_t* pt,
                          const uint32_t* r1_pos, int r1_len, uint8_t* ct,
                          uint8_t* ss) {
  int w = n_words(ver);
  uint64_t* u = new uint64_t[w];
  uint64_t* v = new uint64_t[w];
  encrypt_with(ver, pk, pt, nullptr, 0, r1_pos, r1_len, nullptr, 0, u, v);
  pack_ct(ver, u, v, ct);
  derive_ss(ver, pt, ct, ss);
  delete[] u;
  delete[] v;
  return 0;
}

// Decryption core: m' = RS-RM-decode(v - u*y); also exposes intermediates.
static void decrypt_core(int ver, const uint8_t* ct, const uint8_t* sk,
                         uint8_t* m_out, uint8_t* rm_symbols,
                         uint64_t* decoder_input, uint64_t* u, uint64_t* v) {
  int w = n_words(ver);
  uint32_t x_pos[256], y_pos[256];
  derive_xy(ver, sk, x_pos, y_pos);
  unpack_ct(ver, ct, u, v);
  // decoder_input = v + u*y  (GF(2): minus == plus)
  ring_mul_sparse(ver, decoder_input, y_pos, P(ver).omega, u);
  ring_add(ver, decoder_input, v);
  // truncate to n1n2 bits for decoding
  static thread_local uint64_t* trunc = nullptr;
  static thread_local int trunc_cap = 0;
  if (trunc_cap < w) {
    trunc = (uint64_t*)realloc(trunc, sizeof(uint64_t) * w);
    trunc_cap = w;
  }
  memcpy(trunc, decoder_input, (size_t)w * 8);
  for (int i = n1n2(ver); i < P(ver).n; i++)
    if (get_bit(trunc, i)) trunc[i / 64] ^= (1ULL << (i % 64));

  rm_decode(ver, trunc, rm_symbols);
  uint8_t rs_cw[128];
  memcpy(rs_cw, rm_symbols, (size_t)P(ver).n1);
  uint8_t synd[2 * 64];
  int ok = rs_decode(ver, rs_cw, synd);
  const HqcParams& p = P(ver);
  // systematic: message in high positions (always extracted — a real RS
  // decoder has no separate failure path; it just emits a miscorrected
  // word).  On bounded-distance failure, fold the (nonzero) syndrome
  // bytes in as the deterministic miscorrection: O(k) xors, so the decode
  // path's timing stays flat and the decaps timing channel remains the
  // re-encryption rejection sampling (hqc.rs:175-200's leak) — an earlier
  // SHAKE-on-failure branch here cost ~450k cycles and INVERTED it.
  memcpy(m_out, rs_cw + 2 * p.delta, (size_t)p.k);
  // Constant work: the fold is always computed and committed through a
  // failure mask.  `synd` holds the syndromes of the INPUT word: on
  // failure rs_decode left cw pristine so they are exactly the fold input;
  // on success the mask is zero and m_out is untouched.
  const int twod = 2 * p.delta;
  uint8_t fm = (uint8_t)-(int)(ok != 0);
  for (int i = 0; i < p.k; i++)
    m_out[i] ^= (uint8_t)(fm &
        (synd[(2 * i) % twod] ^ synd[(2 * i + 1) % twod] ^ 0x5A));
}

int hqc_decode_intermediates(int ver, const uint8_t* ct, const uint8_t* sk,
                             uint8_t* m_out, uint8_t* rs_enc, uint8_t* rm_dec,
                             uint8_t* inp, uint64_t* u, uint64_t* v) {
  int w = n_words(ver);
  uint64_t* dec_in = new uint64_t[w];
  uint8_t rm_symbols[128];
  decrypt_core(ver, ct, sk, m_out, rm_symbols, dec_in, u, v);
  // rs_enc: RS re-encoding of the decoded message (reference returns the
  // rsencoded intermediate for debug comparison, hqc.rs:146-172)
  rs_encode(ver, m_out, rs_enc);
  memcpy(rm_dec, rm_symbols, (size_t)P(ver).n1);
  memcpy(inp, dec_in, (size_t)n1n2_bytes(ver));
  delete[] dec_in;
  return 0;
}

// e' = v + u*y + mG over the full n bits (== y*r1 when r2 = e = 0).
int hqc_eprime(int ver, const uint8_t* ct, const uint8_t* sk, const uint8_t* pt,
               uint8_t* out /* n_bytes */) {
  int w = n_words(ver);
  uint64_t* u = new uint64_t[w];
  uint64_t* v = new uint64_t[w];
  uint64_t* acc = new uint64_t[w];
  uint64_t* mg = new uint64_t[w];
  uint32_t x_pos[256], y_pos[256];
  derive_xy(ver, sk, x_pos, y_pos);
  unpack_ct(ver, ct, u, v);
  ring_mul_sparse(ver, acc, y_pos, P(ver).omega, u);
  ring_add(ver, acc, v);
  encode_mg(ver, pt, mg);
  ring_add(ver, acc, mg);
  memcpy(out, acc, (size_t)n_bytes(ver));
  delete[] u;
  delete[] v;
  delete[] acc;
  delete[] mg;
  return 0;
}

// Full decapsulation with re-encryption (the rejection-sampling timing leak).
int hqc_decaps(int ver, const uint8_t* ct, const uint8_t* sk, uint8_t* ss) {
  int w = n_words(ver);
  uint64_t* u = new uint64_t[w];
  uint64_t* v = new uint64_t[w];
  uint64_t* dec_in = new uint64_t[w];
  uint64_t* u2 = new uint64_t[w];
  uint64_t* v2 = new uint64_t[w];
  uint8_t m[64];
  uint8_t rm_symbols[128];
  decrypt_core(ver, ct, sk, m, rm_symbols, dec_in, u, v);

  // Re-encrypt with m's randomness; timing depends on its rejection sampling.
  const uint8_t* pk = sk + SEED_BYTES;
  uint32_t e_pos[256], r1_pos[256], r2_pos[256];
  sample_encrypt_randomness(ver, m, e_pos, r1_pos, r2_pos, nullptr, nullptr);
  encrypt_with(ver, pk, m, e_pos, P(ver).omega_e, r1_pos, P(ver).omega_r, r2_pos,
               P(ver).omega_r, u2, v2);
  uint8_t ct2[16384];
  pack_ct(ver, u2, v2, ct2);
  int same = memcmp(ct, ct2, (size_t)hqc_ct_bytes(ver)) == 0 ? 1 : 0;
  derive_ss(ver, m, ct, ss);
  if (!same) ss[0] ^= 0xFF;  // implicit rejection marker
  delete[] u;
  delete[] v;
  delete[] dec_in;
  delete[] u2;
  delete[] v2;
  return same;
}

// Cycle-timed decapsulation oracle (hqc.rs:175-200): returns per-measurement
// cycle counts; cross-core samples are discarded (count reported via n_out).
int hqc_decode_oracle(int ver, const uint8_t* ct, const uint8_t* sk,
                      uint64_t num_measurements, uint64_t* out,
                      uint64_t* n_out) {
  uint8_t ss[64];
  uint64_t kept = 0;
  for (uint64_t i = 0; i < num_measurements; i++) {
#if defined(__x86_64__)
    unsigned int aux_start = 0, aux_stop = 0;
    unsigned int eax, ebx, ecx, edx;
    __get_cpuid(0, &eax, &ebx, &ecx, &edx);  // serialize
    uint64_t start = __rdtscp(&aux_start);
    hqc_decaps(ver, ct, sk, ss);
    // rdtscp waits for prior instructions; CPUID serializes AFTER the read
    // so its variable latency stays outside the measured window
    uint64_t stop = __rdtscp(&aux_stop);
    __get_cpuid(0, &eax, &ebx, &ecx, &edx);
    if (aux_start == aux_stop) out[kept++] = stop - start;
#else
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    hqc_decaps(ver, ct, sk, ss);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    out[kept++] = (uint64_t)(t1.tv_sec - t0.tv_sec) * 1000000000ULL +
                  (uint64_t)(t1.tv_nsec - t0.tv_nsec);
#endif
  }
  *n_out = kept;
  return 0;
}

}  // extern "C"
