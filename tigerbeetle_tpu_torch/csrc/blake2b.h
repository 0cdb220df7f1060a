// Keyed BLAKE2b (RFC 7693), shared by the native runtime components.
//
// Digests are bit-identical to Python's hashlib.blake2b(data,
// digest_size=16, key=...) — the wire/disk checksum contract is shared
// across the Python and C++ runtimes (tigerbeetle_tpu/vsr/checksum.py).
// Header-only so storage_engine.cpp and tb_client.cpp stay single-file
// g++ builds with no link-time coupling.

#pragma once

#include <cstdint>
#include <cstring>

namespace tbp {

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t b2b_rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

struct B2BState {
  uint64_t h[8];
  uint64_t t[2];
  uint8_t buf[128];
  size_t buflen;
  size_t outlen;
};

static inline void b2b_compress(B2BState *S, const uint8_t *block, int last) {
  uint64_t v[16], m[16];
  for (int i = 0; i < 8; i++) v[i] = S->h[i];
  for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
  v[12] ^= S->t[0];
  v[13] ^= S->t[1];
  if (last) v[14] = ~v[14];
  for (int i = 0; i < 16; i++) memcpy(&m[i], block + 8 * i, 8);

#define TBP_B2B_G(a, b, c, d, x, y)                                           \
  v[a] = v[a] + v[b] + (x);                                                   \
  v[d] = b2b_rotr64(v[d] ^ v[a], 32);                                         \
  v[c] = v[c] + v[d];                                                         \
  v[b] = b2b_rotr64(v[b] ^ v[c], 24);                                         \
  v[a] = v[a] + v[b] + (y);                                                   \
  v[d] = b2b_rotr64(v[d] ^ v[a], 16);                                         \
  v[c] = v[c] + v[d];                                                         \
  v[b] = b2b_rotr64(v[b] ^ v[c], 63);

  for (int r = 0; r < 12; r++) {
    const uint8_t *s = B2B_SIGMA[r];
    TBP_B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    TBP_B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    TBP_B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    TBP_B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    TBP_B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    TBP_B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    TBP_B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    TBP_B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef TBP_B2B_G
  for (int i = 0; i < 8; i++) S->h[i] ^= v[i] ^ v[i + 8];
}

static inline void b2b_init(B2BState *S, size_t outlen, const uint8_t *key,
                            size_t keylen) {
  memset(S, 0, sizeof(*S));
  S->outlen = outlen;
  for (int i = 0; i < 8; i++) S->h[i] = B2B_IV[i];
  // Parameter block word 0: digest_length | key_length<<8 | fanout<<16
  // | depth<<24 (sequential mode: fanout=1, depth=1).
  S->h[0] ^= (uint64_t)outlen | ((uint64_t)keylen << 8) | (1ULL << 16) |
             (1ULL << 24);
  if (keylen > 0) {
    // Keyed mode: the zero-padded key is the first 128-byte block.
    memcpy(S->buf, key, keylen);
    S->buflen = 128;
  }
}

static inline void b2b_update(B2BState *S, const uint8_t *in, size_t inlen) {
  while (inlen > 0) {
    if (S->buflen == 128) {
      // Buffer full and more input follows: not the final block.
      S->t[0] += 128;
      if (S->t[0] < 128) S->t[1]++;
      b2b_compress(S, S->buf, 0);
      S->buflen = 0;
    }
    size_t take = 128 - S->buflen;
    if (take > inlen) take = inlen;
    memcpy(S->buf + S->buflen, in, take);
    S->buflen += take;
    in += take;
    inlen -= take;
  }
}

static inline void b2b_final(B2BState *S, uint8_t *out) {
  S->t[0] += S->buflen;
  if (S->t[0] < S->buflen) S->t[1]++;
  memset(S->buf + S->buflen, 0, 128 - S->buflen);
  b2b_compress(S, S->buf, 1);
  for (size_t i = 0; i < S->outlen; i++)
    out[i] = (uint8_t)(S->h[i >> 3] >> (8 * (i & 7)));
}

static inline void checksum16(const uint8_t *data, size_t len,
                              const uint8_t *key, size_t key_len,
                              uint8_t *out16) {
  B2BState S;
  b2b_init(&S, 16, key, key_len);
  b2b_update(&S, data, len);
  b2b_final(&S, out16);
}

}  // namespace tbp
