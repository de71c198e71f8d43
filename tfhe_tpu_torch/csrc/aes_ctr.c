/* AES-128-CTR keystream — the native engine behind tfhe_tpu_torch's CSPRNG
 * (the port's own copy of tfhe_tpu/native/aes_ctr.c, same bytes out).
 *
 * Produces the byte stream AES_k(0) || AES_k(1) || ... with the 128-bit
 * counter serialized little-endian (low 64 bits in bytes 0..7), exactly
 * matching tfhe_tpu_torch.utils.csprng.AesCtrGenerator (and the reference
 * tfhe-csprng soft/aesni block ciphers). Built with cc at first use by
 * tfhe_tpu_torch/_build.py and loaded with ctypes.
 *
 * AES-NI with 8-block pipelining when available (runtime cpuid check),
 * portable table-free fallback otherwise.
 */
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) || defined(_M_X64)
#include <cpuid.h>
#include <wmmintrin.h>
#define HAVE_X86 1
#endif

/* ---------------- portable AES-128 (encrypt only) ---------------- */

static const uint8_t SBOX[256] = {
0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16};

static const uint8_t RCON[10] = {1,2,4,8,16,32,64,128,0x1b,0x36};

static void key_expand(const uint8_t key[16], uint8_t rk[176]) {
    memcpy(rk, key, 16);
    for (int i = 4; i < 44; i++) {
        uint8_t t[4];
        memcpy(t, rk + (i - 1) * 4, 4);
        if (i % 4 == 0) {
            uint8_t tmp = t[0];
            t[0] = SBOX[t[1]] ^ RCON[i / 4 - 1];
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[tmp];
        }
        for (int j = 0; j < 4; j++)
            rk[i * 4 + j] = rk[(i - 4) * 4 + j] ^ t[j];
    }
}

static uint8_t xt(uint8_t x) { return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b)); }

static void soft_encrypt_block(const uint8_t rk[176], const uint8_t in[16],
                               uint8_t out[16]) {
    uint8_t s[16];
    for (int i = 0; i < 16; i++) s[i] = in[i] ^ rk[i];
    for (int rnd = 1; rnd <= 9; rnd++) {
        uint8_t t[16];
        /* SubBytes + ShiftRows (column-major state: byte 4c+r) */
        for (int c = 0; c < 4; c++)
            for (int r = 0; r < 4; r++)
                t[4 * c + r] = SBOX[s[4 * ((c + r) & 3) + r]];
        /* MixColumns */
        for (int c = 0; c < 4; c++) {
            uint8_t a0 = t[4*c], a1 = t[4*c+1], a2 = t[4*c+2], a3 = t[4*c+3];
            uint8_t sum = a0 ^ a1 ^ a2 ^ a3;
            s[4*c]   = a0 ^ sum ^ xt(a0 ^ a1) ^ rk[rnd*16 + 4*c];
            s[4*c+1] = a1 ^ sum ^ xt(a1 ^ a2) ^ rk[rnd*16 + 4*c+1];
            s[4*c+2] = a2 ^ sum ^ xt(a2 ^ a3) ^ rk[rnd*16 + 4*c+2];
            s[4*c+3] = a3 ^ sum ^ xt(a3 ^ a0) ^ rk[rnd*16 + 4*c+3];
        }
    }
    for (int c = 0; c < 4; c++)
        for (int r = 0; r < 4; r++)
            out[4*c+r] = SBOX[s[4 * ((c + r) & 3) + r]] ^ rk[160 + 4*c + r];
}

/* ---------------- AES-NI path ---------------- */

#ifdef HAVE_X86
static int has_aesni(void) {
    unsigned a, b, c, d;
    if (!__get_cpuid(1, &a, &b, &c, &d)) return 0;
    return (c >> 25) & 1;
}

__attribute__((target("aes,sse4.1")))
static void ni_expand(const uint8_t key[16], __m128i rk[11]) {
    /* standard AES-128 key schedule with AESKEYGENASSIST */
    #define EXP(i, rcon) { \
        __m128i t = _mm_aeskeygenassist_si128(rk[i-1], rcon); \
        t = _mm_shuffle_epi32(t, 0xff); \
        __m128i k = rk[i-1]; \
        k = _mm_xor_si128(k, _mm_slli_si128(k, 4)); \
        k = _mm_xor_si128(k, _mm_slli_si128(k, 4)); \
        k = _mm_xor_si128(k, _mm_slli_si128(k, 4)); \
        rk[i] = _mm_xor_si128(k, t); }
    rk[0] = _mm_loadu_si128((const __m128i*)key);
    EXP(1,0x01) EXP(2,0x02) EXP(3,0x04) EXP(4,0x08) EXP(5,0x10)
    EXP(6,0x20) EXP(7,0x40) EXP(8,0x80) EXP(9,0x1b) EXP(10,0x36)
    #undef EXP
}

__attribute__((target("aes,sse4.1")))
static void ni_ctr(const uint8_t key[16], uint64_t first_block,
                   uint64_t n_blocks, uint8_t *out) {
    __m128i rk[11];
    ni_expand(key, rk);
    uint64_t i = 0;
    for (; i + 8 <= n_blocks; i += 8) {
        __m128i b[8];
        for (int j = 0; j < 8; j++)
            b[j] = _mm_set_epi64x(0, (long long)(first_block + i + j));
        for (int j = 0; j < 8; j++) b[j] = _mm_xor_si128(b[j], rk[0]);
        for (int r = 1; r <= 9; r++)
            for (int j = 0; j < 8; j++) b[j] = _mm_aesenc_si128(b[j], rk[r]);
        for (int j = 0; j < 8; j++) {
            b[j] = _mm_aesenclast_si128(b[j], rk[10]);
            _mm_storeu_si128((__m128i*)(out + (i + j) * 16), b[j]);
        }
    }
    for (; i < n_blocks; i++) {
        __m128i b = _mm_set_epi64x(0, (long long)(first_block + i));
        b = _mm_xor_si128(b, rk[0]);
        for (int r = 1; r <= 9; r++) b = _mm_aesenc_si128(b, rk[r]);
        b = _mm_aesenclast_si128(b, rk[10]);
        _mm_storeu_si128((__m128i*)(out + i * 16), b);
    }
}
#endif

/* ---------------- public entry ---------------- */

/* out must hold 16 * n_blocks bytes; counters are little-endian with the
 * high 64 bits zero (stream positions < 2^68 bytes). */
void aes128_ctr_stream(const uint8_t key[16], uint64_t first_block,
                       uint64_t n_blocks, uint8_t *out) {
#ifdef HAVE_X86
    if (has_aesni()) {
        ni_ctr(key, first_block, n_blocks, out);
        return;
    }
#endif
    uint8_t rk[176];
    key_expand(key, rk);
    for (uint64_t i = 0; i < n_blocks; i++) {
        uint8_t ctr[16] = {0};
        uint64_t c = first_block + i;
        for (int j = 0; j < 8; j++) ctr[j] = (uint8_t)(c >> (8 * j));
        soft_encrypt_block(rk, ctr, out + i * 16);
    }
}
