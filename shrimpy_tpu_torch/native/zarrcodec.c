/*
 * The chunk codec of the port's zarr engine (io/chunkstore.py): the blosc 1
 * container around zstd, decoded and encoded here and called through ctypes.
 *
 *   zc_blosc_info      the 16-byte header: version, versionlz, flags,
 *                      typesize, nbytes, blocksize, cbytes, block count.
 *   zc_blosc_decode    blocks [first, last) of a container into dst: the block
 *                      starts, split or whole streams (flag 0x10), streams
 *                      stored raw, the memcpyed form (flag 0x02) and byte
 *                      unshuffle (flag 0x01). Only zstd streams are decoded
 *                      (flag bits 5-7 = 4); any other compressor, and
 *                      bitshuffle (flag 0x04), return an error code.
 *   zc_blosc_memcpyed  the header of the memcpyed container, which the raw
 *                      bytes follow (c-blosc writes this form itself for a
 *                      buffer that does not compress; every blosc reader
 *                      takes it). The caller writes the bytes after it from
 *                      where they are, without a copy.
 *   zc_zstd_decompress a zstd stream of one or more frames (RFC 8878):
 *                      raw, RLE and compressed blocks; raw, RLE, Huffman
 *                      (one and four streams) and treeless literals with
 *                      weights direct or FSE-coded; predefined, RLE, FSE
 *                      and repeat modes of the three sequence codes; repeat
 *                      offsets; skippable frames; the xxHash64 checksum.
 *   zc_all_equal       whether a buffer is one value repeated (a chunk
 *                      equal to the fill value is not stored).
 *   zc_zstd_compress   one zstd frame of a buffer, levels 1-3 (the
 *                      decoder's mirror; see "zstd encoder" below).
 *   zc_blosc_blocksize c-blosc's block size for zstd at a clevel.
 *   zc_blosc_encode    blocks [first, last) of a blosc-zstd container: each
 *                      an int32 size and a zstd frame of the block (byte-
 *                      shuffled first where asked), or the block's bytes.
 *   zc_blosc_header    the container's header and block starts from the
 *                      sizes zc_blosc_encode gave.
 *
 * Every entry point checks its bounds and returns a negative ZC_E* code on
 * bad input; none reads or writes past a buffer it was given. Blocks of one
 * container are independent, so the caller encodes and decodes ranges of
 * them on several threads at once (ctypes releases the GIL). Counters of
 * the modes a decode took are added into an int64 array the caller passes
 * (or NULL).
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
  ZC_E_TRUNCATED = -1,   /* input ends early */
  ZC_E_CORRUPT = -2,     /* input is not a valid stream */
  ZC_E_DST = -3,         /* output does not fit the destination */
  ZC_E_CHECKSUM = -4,    /* zstd content checksum mismatch */
  ZC_E_DICTIONARY = -5,  /* zstd frame needs a dictionary */
  ZC_E_COMPRESSOR = -6,  /* blosc compressor other than zstd */
  ZC_E_BITSHUFFLE = -7,  /* blosc bitshuffle */
  ZC_E_HEADER = -8,      /* blosc header invalid */
  ZC_E_NOMEM = -9,       /* allocation failed */
  ZC_E_SIZE = -10,       /* decoded size differs from the declared one */
  ZC_E_ARG = -11         /* bad argument */
};

/* Counter slots (io/chunkstore.py::COUNTERS names them). */
enum {
  C_FRAMES, C_SKIPPABLE, C_CHECKSUMS, C_BLOCK_RAW, C_BLOCK_RLE, C_BLOCK_COMPRESSED,
  C_LIT_RAW, C_LIT_RLE, C_LIT_HUF1, C_LIT_HUF4, C_LIT_TREELESS,
  C_HUF_DIRECT, C_HUF_FSE,
  C_LL_PREDEF, C_LL_RLE, C_LL_FSE, C_LL_REPEAT,
  C_OF_PREDEF, C_OF_RLE, C_OF_FSE, C_OF_REPEAT,
  C_ML_PREDEF, C_ML_RLE, C_ML_FSE, C_ML_REPEAT,
  C_SEQUENCES, C_BLOSC_BLOCKS, C_BLOSC_RAW_STREAMS, C_BLOSC_MEMCPYED,
  C_COUNT
};

int64_t zc_counter_count(void) { return C_COUNT; }

#define BUMP(c, i, n) do { if (c) (c)[i] += (n); } while (0)

static uint32_t rd32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

static uint64_t rd64(const uint8_t *p) { return (uint64_t)rd32(p) | ((uint64_t)rd32(p + 4) << 32); }

static inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); } /* v > 0 */

/* ------------------------------------------------------------------ */
/* xxHash64                                                            */
/* ------------------------------------------------------------------ */

#define P64_1 0x9E3779B185EBCA87ULL
#define P64_2 0xC2B2AE3D27D4EB4FULL
#define P64_3 0x165667B19E3779F9ULL
#define P64_4 0x85EBCA77C2B2AE63ULL
#define P64_5 0x27D4EB2F165667C5ULL

static uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static uint64_t xxh_round(uint64_t acc, uint64_t in) {
  acc += in * P64_2;
  acc = rotl64(acc, 31);
  return acc * P64_1;
}

static uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  acc ^= xxh_round(0, v);
  return acc * P64_1 + P64_4;
}

static uint64_t xxh64(const uint8_t *p, size_t len) {
  const uint8_t *end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P64_1 + P64_2, v2 = P64_2, v3 = 0, v4 = (uint64_t)0 - P64_1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xxh_round(v1, rd64(p));
      v2 = xxh_round(v2, rd64(p + 8));
      v3 = xxh_round(v3, rd64(p + 16));
      v4 = xxh_round(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = P64_5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, rd64(p));
    h = rotl64(h, 27) * P64_1 + P64_4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P64_1;
    h = rotl64(h, 23) * P64_2 + P64_3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P64_5;
    h = rotl64(h, 11) * P64_1;
    p++;
  }
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  h ^= h >> 32;
  return h;
}

/* ------------------------------------------------------------------ */
/* Bit readers                                                         */
/* ------------------------------------------------------------------ */

/* Little-endian load of up to 8 bytes at p (bytes past len read as 0). */
static uint64_t load_le(const uint8_t *buf, int64_t len, int64_t at) {
  if (at >= 0 && at + 8 <= len) return rd64(buf + at);
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    int64_t k = at + i;
    if (k >= 0 && k < len) v |= (uint64_t)buf[k] << (8 * i);
  }
  return v;
}

/* A backward bit stream (Huffman and FSE-coded data): read from the top,
 * below the marker bit of the last byte. ``left`` counts the bits not yet
 * read; it goes negative once more were asked for than the stream holds
 * (those read as zeros), which is how the decoders see its end. */
typedef struct {
  const uint8_t *buf;
  int64_t len;
  int64_t left;
} BitBack;

static int back_init(BitBack *b, const uint8_t *buf, int64_t len) {
  if (len <= 0) return ZC_E_CORRUPT;
  uint8_t last = buf[len - 1];
  if (last == 0) return ZC_E_CORRUPT;
  b->buf = buf;
  b->len = len;
  b->left = len * 8 - (8 - highbit32(last));
  return 0;
}

static inline uint64_t back_peek(const BitBack *b, int n) {
  if (n == 0) return 0;
  int64_t pos = b->left - n;
  uint64_t v;
  if (pos >= 0) {
    v = load_le(b->buf, b->len, pos >> 3) >> (pos & 7);
  } else if (b->left > 0) {
    v = load_le(b->buf, b->len, 0) << (-pos);
  } else {
    return 0;
  }
  return v & ((n == 64) ? ~0ULL : ((1ULL << n) - 1));
}

static inline uint64_t back_read(BitBack *b, int n) {
  uint64_t v = back_peek(b, n);
  b->left -= n;
  return v;
}

/* ------------------------------------------------------------------ */
/* FSE                                                                 */
/* ------------------------------------------------------------------ */

typedef struct {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
} FseCell;

typedef struct {
  int log;      /* accuracy log; 0 for an RLE table of one cell */
  int ready;
  FseCell cell[512];
} FseTable;

/* The table description (RFC 8878 4.1.1): the normalised counts into norm,
 * returns the bytes it took or an error. */
static int64_t fse_read_counts(const uint8_t *src, int64_t len, int16_t *norm, int *max_sym,
                               int *log, int max_log) {
  if (len < 1) return ZC_E_TRUNCATED;
  int64_t bit = 0;
#define FWD(n) ((int)((load_le(src, len, bit >> 3) >> (bit & 7)) & ((1ULL << (n)) - 1)))
  int acc = FWD(4) + 5;
  bit += 4;
  if (acc > max_log) return ZC_E_CORRUPT;
  *log = acc;
  int remaining = (1 << acc) + 1;
  int threshold = 1 << acc;
  int nbits = acc + 1;
  int sym = 0;
  int limit = *max_sym + 1;
  while (remaining > 1) {
    if (sym >= limit) return ZC_E_CORRUPT;
    int maxv = (2 * threshold - 1) - remaining;
    int count;
    int low = FWD(nbits - 1);
    if (low < maxv) {
      count = low;
      bit += nbits - 1;
    } else {
      count = FWD(nbits);
      if (count >= threshold) count -= maxv;
      bit += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    if (count == 0) {
      for (;;) {
        int rep = FWD(2);
        bit += 2;
        for (int i = 0; i < rep; i++) {
          if (sym >= limit) return ZC_E_CORRUPT;
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
    if (remaining < 1) return ZC_E_CORRUPT;
    while (remaining < threshold && threshold > 1) {
      nbits--;
      threshold >>= 1;
    }
  }
#undef FWD
  if (remaining != 1) return ZC_E_CORRUPT;
  int64_t used = (bit + 7) >> 3;
  if (used > len) return ZC_E_TRUNCATED;
  *max_sym = sym - 1;
  return used;
}

static int fse_build(FseTable *t, const int16_t *norm, int max_sym, int log) {
  int size = 1 << log;
  if (log > 9) return ZC_E_CORRUPT;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -1) {
      if (high < 0) return ZC_E_CORRUPT;
      t->cell[high--].symbol = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)(norm[s] < 0 ? 0 : norm[s]);
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s <= max_sym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      t->cell[pos].symbol = (uint8_t)s;
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) return ZC_E_CORRUPT;
  for (int u = 0; u < size; u++) {
    int s = t->cell[u].symbol;
    uint32_t ns = next[s]++;
    if (ns == 0) return ZC_E_CORRUPT;
    int nb = log - highbit32(ns);
    t->cell[u].nbits = (uint8_t)nb;
    t->cell[u].base = (uint16_t)((ns << nb) - size);
  }
  t->log = log;
  t->ready = 1;
  return 0;
}

static void fse_rle(FseTable *t, int symbol) {
  t->cell[0].symbol = (uint8_t)symbol;
  t->cell[0].nbits = 0;
  t->cell[0].base = 0;
  t->log = 0;
  t->ready = 1;
}

/* ------------------------------------------------------------------ */
/* Huffman literals                                                    */
/* ------------------------------------------------------------------ */

typedef struct {
  int log;
  int ready;
  uint8_t symbol[2048];
  uint8_t nbits[2048];
} HufTable;

static int64_t huf_read_table(HufTable *h, const uint8_t *src, int64_t len, int64_t *counters) {
  if (len < 1) return ZC_E_TRUNCATED;
  uint8_t weights[256];
  int n = 0;
  int64_t used;
  int hb = src[0];
  if (hb >= 128) {
    n = hb - 127;
    used = 1 + (n + 1) / 2;
    if (used > len) return ZC_E_TRUNCATED;
    for (int i = 0; i < n; i++) {
      uint8_t byte = src[1 + i / 2];
      weights[i] = (i & 1) ? (byte & 15) : (byte >> 4);
    }
    BUMP(counters, C_HUF_DIRECT, 1);
  } else {
    used = 1 + hb;
    if (used > len || hb == 0) return ZC_E_TRUNCATED;
    int16_t norm[256];
    int max_sym = 255, log;
    int64_t hdr = fse_read_counts(src + 1, hb, norm, &max_sym, &log, 6);
    if (hdr < 0) return hdr;
    FseTable t;
    int rc = fse_build(&t, norm, max_sym, log);
    if (rc < 0) return rc;
    BitBack b;
    rc = back_init(&b, src + 1 + hdr, hb - hdr);
    if (rc < 0) return rc;
    int s1 = (int)back_read(&b, log), s2 = (int)back_read(&b, log);
    if (b.left < 0) return ZC_E_CORRUPT;
    for (;;) {
      if (n > 253) return ZC_E_CORRUPT;
      weights[n++] = t.cell[s1].symbol;
      s1 = t.cell[s1].base + (int)back_read(&b, t.cell[s1].nbits);
      if (b.left < 0) {
        weights[n++] = t.cell[s2].symbol;
        break;
      }
      if (n > 253) return ZC_E_CORRUPT;
      weights[n++] = t.cell[s2].symbol;
      s2 = t.cell[s2].base + (int)back_read(&b, t.cell[s2].nbits);
      if (b.left < 0) {
        weights[n++] = t.cell[s1].symbol;
        break;
      }
    }
    BUMP(counters, C_HUF_FSE, 1);
  }
  /* The last weight is implied by the others: they sum to a power of two. */
  uint32_t total = 0;
  for (int i = 0; i < n; i++) {
    if (weights[i] > 11) return ZC_E_CORRUPT;
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) return ZC_E_CORRUPT;
  int maxbits = highbit32(total) + 1;
  if (maxbits > 11) return ZC_E_CORRUPT;
  uint32_t rest = (1u << maxbits) - total;
  if (rest & (rest - 1)) return ZC_E_CORRUPT;
  if (n >= 256) return ZC_E_CORRUPT;
  weights[n++] = (uint8_t)(highbit32(rest) + 1);
  /* Table cells by weight, lowest first, symbols in order within one. */
  uint32_t start[13] = {0};
  uint32_t rank[13] = {0};
  for (int i = 0; i < n; i++) rank[weights[i]]++;
  uint32_t nxt = 0;
  for (int w = 1; w <= maxbits; w++) {
    start[w] = nxt;
    nxt += rank[w] << (w - 1);
  }
  if (nxt != (1u << maxbits)) return ZC_E_CORRUPT;
  for (int s = 0; s < n; s++) {
    int w = weights[s];
    if (!w) continue;
    uint32_t span = 1u << (w - 1);
    for (uint32_t u = start[w]; u < start[w] + span; u++) {
      h->symbol[u] = (uint8_t)s;
      h->nbits[u] = (uint8_t)(maxbits + 1 - w);
    }
    start[w] += span;
  }
  h->log = maxbits;
  h->ready = 1;
  return used;
}

static int huf_stream(const HufTable *h, const uint8_t *src, int64_t len, uint8_t *dst,
                      int64_t n) {
  BitBack b;
  int rc = back_init(&b, src, len);
  if (rc < 0) return rc;
  int log = h->log;
  int64_t i = 0;
  /* Five symbols (at most 55 bits) from each 56-bit load while the stream
   * holds that many; then one at a time. */
  const uint64_t mask = (1ULL << log) - 1;
  while (b.left >= 56 && n - i >= 5) {
    int64_t pos = b.left - 56;
    uint64_t v = load_le(b.buf, b.len, pos >> 3) >> (pos & 7);
    int avail = 56;
    for (int k = 0; k < 5; k++) {
      int idx = (int)((v >> (avail - log)) & mask);
      dst[i++] = h->symbol[idx];
      avail -= h->nbits[idx];
    }
    b.left -= 56 - avail;
  }
  for (; i < n; i++) {
    int idx = (int)back_peek(&b, log);
    dst[i] = h->symbol[idx];
    b.left -= h->nbits[idx];
    if (b.left < 0) return ZC_E_CORRUPT;
  }
  return b.left == 0 ? 0 : ZC_E_CORRUPT;
}

/* ------------------------------------------------------------------ */
/* Sequences                                                           */
/* ------------------------------------------------------------------ */

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                     12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,   12,   13,   14,   15,  16,
                                     17, 18, 19, 20, 21, 22, 23,  24,  25,   26,   27,   28,   29,  30,
                                     31, 32, 33, 34, 35, 37, 39,  41,  43,   47,   51,   59,   67,  83,
                                     99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

typedef struct {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3];
  uint8_t *lit;  /* 128 KiB of literals */
} Frame;

/* One of the three sequence tables by its mode; returns bytes used. */
static int64_t seq_table(FseTable *t, int mode, const uint8_t *src, int64_t len,
                         const int16_t *def, int def_max, int def_log, int max_sym, int max_log,
                         int64_t *counters, int slot) {
  int16_t norm[256];
  int rc;
  switch (mode) {
    case 0:
      memcpy(norm, def, sizeof(int16_t) * (def_max + 1));
      rc = fse_build(t, norm, def_max, def_log);
      BUMP(counters, slot, 1);
      return rc < 0 ? rc : 0;
    case 1:
      if (len < 1) return ZC_E_TRUNCATED;
      if (src[0] > max_sym) return ZC_E_CORRUPT;
      fse_rle(t, src[0]);
      BUMP(counters, slot + 1, 1);
      return 1;
    case 2: {
      int ms = max_sym, log;
      int64_t used = fse_read_counts(src, len, norm, &ms, &log, max_log);
      if (used < 0) return used;
      rc = fse_build(t, norm, ms, log);
      if (rc < 0) return rc;
      BUMP(counters, slot + 2, 1);
      return used;
    }
    default:
      if (!t->ready) return ZC_E_CORRUPT;
      BUMP(counters, slot + 3, 1);
      return 0;
  }
}

/* Copy n bytes from out[pos - off] to out[pos], forward (overlap repeats). */
static void match_copy(uint8_t *out, int64_t pos, int64_t off, int64_t n) {
  uint8_t *d = out + pos;
  const uint8_t *s = out + pos - off;
  if (off >= n) {
    memcpy(d, s, (size_t)n);
  } else if (off >= 8) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) memcpy(d + i, s + i, 8);
    for (; i < n; i++) d[i] = s[i];
  } else {
    for (int64_t i = 0; i < n; i++) d[i] = s[i];
  }
}

/* A compressed block into dst[pos ...]; returns the new position. */
static int64_t block_compressed(Frame *f, const uint8_t *src, int64_t len, uint8_t *dst,
                                int64_t cap, int64_t pos, int64_t frame_start,
                                int64_t *counters) {
  if (len < 1) return ZC_E_TRUNCATED;
  /* Literals section. */
  int ltype = src[0] & 3, sfmt = (src[0] >> 2) & 3;
  int64_t regen, csize = 0, hsize;
  if (ltype <= 1) {
    if (sfmt == 0 || sfmt == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      hsize = 2;
      if (len < 2) return ZC_E_TRUNCATED;
      regen = (src[0] >> 4) + ((int64_t)src[1] << 4);
    } else {
      hsize = 3;
      if (len < 3) return ZC_E_TRUNCATED;
      regen = (src[0] >> 4) + ((int64_t)src[1] << 4) + ((int64_t)src[2] << 12);
    }
  } else {
    if (sfmt <= 1) {
      hsize = 3;
      if (len < 3) return ZC_E_TRUNCATED;
      uint32_t h = src[0] | (src[1] << 8) | ((uint32_t)src[2] << 16);
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (sfmt == 2) {
      hsize = 4;
      if (len < 4) return ZC_E_TRUNCATED;
      uint32_t h = rd32(src);
      regen = (h >> 4) & 0x3FFF;
      csize = h >> 18;
    } else {
      hsize = 5;
      if (len < 5) return ZC_E_TRUNCATED;
      uint32_t h = rd32(src);
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) | ((uint32_t)src[4] << 10);
    }
  }
  if (regen > (1 << 17)) return ZC_E_CORRUPT;
  const uint8_t *lit;
  int64_t at = hsize;
  if (ltype == 0) {
    if (at + regen > len) return ZC_E_TRUNCATED;
    lit = src + at;
    at += regen;
    BUMP(counters, C_LIT_RAW, 1);
  } else if (ltype == 1) {
    if (at + 1 > len) return ZC_E_TRUNCATED;
    memset(f->lit, src[at], (size_t)regen);
    lit = f->lit;
    at += 1;
    BUMP(counters, C_LIT_RLE, 1);
  } else {
    if (at + csize > len) return ZC_E_TRUNCATED;
    const uint8_t *p = src + at;
    int64_t plen = csize;
    if (ltype == 2) {
      int64_t used = huf_read_table(&f->huf, p, plen, counters);
      if (used < 0) return used;
      p += used;
      plen -= used;
    } else {
      if (!f->huf.ready) return ZC_E_CORRUPT;
      BUMP(counters, C_LIT_TREELESS, 1);
    }
    if (sfmt == 0) {
      int rc = huf_stream(&f->huf, p, plen, f->lit, regen);
      if (rc < 0) return rc;
      BUMP(counters, C_LIT_HUF1, 1);
    } else {
      if (plen < 6) return ZC_E_TRUNCATED;
      int64_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
      int64_t s4 = plen - 6 - s1 - s2 - s3;
      if (s4 < 1) return ZC_E_CORRUPT;
      int64_t seg = (regen + 3) / 4;
      if (3 * seg > regen) return ZC_E_CORRUPT;
      const uint8_t *q = p + 6;
      int64_t sizes[4] = {s1, s2, s3, s4};
      for (int k = 0; k < 4; k++) {
        int64_t m = k < 3 ? seg : regen - 3 * seg;
        int rc = huf_stream(&f->huf, q, sizes[k], f->lit + k * seg, m);
        if (rc < 0) return rc;
        q += sizes[k];
      }
      BUMP(counters, C_LIT_HUF4, 1);
    }
    lit = f->lit;
    at += csize;
  }
  /* Sequences section. */
  if (at >= len) return ZC_E_TRUNCATED;
  int64_t nseq = src[at];
  if (nseq == 0) {
    at += 1;
  } else if (nseq < 128) {
    at += 1;
  } else if (nseq < 255) {
    if (at + 2 > len) return ZC_E_TRUNCATED;
    nseq = ((nseq - 128) << 8) + src[at + 1];
    at += 2;
  } else {
    if (at + 3 > len) return ZC_E_TRUNCATED;
    nseq = src[at + 1] + ((int64_t)src[at + 2] << 8) + 0x7F00;
    at += 3;
  }
  int64_t lit_left = regen;
  const uint8_t *lp = lit;
  if (nseq > 0) {
    if (at >= len) return ZC_E_TRUNCATED;
    int modes = src[at++];
    if (modes & 3) return ZC_E_CORRUPT;
    int64_t u;
    u = seq_table(&f->ll, (modes >> 6) & 3, src + at, len - at, LL_DEFAULT, 35, 6, 35, 9,
                  counters, C_LL_PREDEF);
    if (u < 0) return u;
    at += u;
    u = seq_table(&f->of, (modes >> 4) & 3, src + at, len - at, OF_DEFAULT, 28, 5, 31, 8,
                  counters, C_OF_PREDEF);
    if (u < 0) return u;
    at += u;
    u = seq_table(&f->ml, (modes >> 2) & 3, src + at, len - at, ML_DEFAULT, 52, 6, 52, 9,
                  counters, C_ML_PREDEF);
    if (u < 0) return u;
    at += u;
    BitBack b;
    int rc = back_init(&b, src + at, len - at);
    if (rc < 0) return rc;
    int sll = (int)back_read(&b, f->ll.log);
    int sof = (int)back_read(&b, f->of.log);
    int sml = (int)back_read(&b, f->ml.log);
    if (b.left < 0) return ZC_E_CORRUPT;
    for (int64_t i = 0; i < nseq; i++) {
      int ofc = f->of.cell[sof].symbol, llc = f->ll.cell[sll].symbol, mlc = f->ml.cell[sml].symbol;
      if (ofc > 31 || llc > 35 || mlc > 52) return ZC_E_CORRUPT;
      uint64_t ofv = (1ULL << ofc) + back_read(&b, ofc);
      int64_t ml = ML_BASE[mlc] + (int64_t)back_read(&b, ML_BITS[mlc]);
      int64_t ll = LL_BASE[llc] + (int64_t)back_read(&b, LL_BITS[llc]);
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        f->rep[2] = f->rep[1];
        f->rep[1] = f->rep[0];
        f->rep[0] = off;
      } else {
        int idx = (int)ofv - 1 + (ll == 0);
        if (idx == 0) {
          off = f->rep[0];
        } else {
          off = idx == 3 ? f->rep[0] - 1 : f->rep[idx];
          if (idx != 1) f->rep[2] = f->rep[1];
          f->rep[1] = f->rep[0];
          f->rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sll = f->ll.cell[sll].base + (int)back_read(&b, f->ll.cell[sll].nbits);
        sml = f->ml.cell[sml].base + (int)back_read(&b, f->ml.cell[sml].nbits);
        sof = f->of.cell[sof].base + (int)back_read(&b, f->of.cell[sof].nbits);
      }
      if (b.left < 0) return ZC_E_CORRUPT;
      /* Execute: the literals, then the match. */
      if (ll > lit_left) return ZC_E_CORRUPT;
      if (pos + ll + ml > cap) return ZC_E_DST;
      memcpy(dst + pos, lp, (size_t)ll);
      pos += ll;
      lp += ll;
      lit_left -= ll;
      if (off == 0 || off > (uint64_t)(pos - frame_start)) return ZC_E_CORRUPT;
      match_copy(dst, pos, (int64_t)off, ml);
      pos += ml;
    }
    if (b.left != 0) return ZC_E_CORRUPT;
    BUMP(counters, C_SEQUENCES, nseq);
  } else if (at != len) {
    return ZC_E_CORRUPT;
  }
  if (pos + lit_left > cap) return ZC_E_DST;
  memcpy(dst + pos, lp, (size_t)lit_left);
  return pos + lit_left;
}

/* Decode every frame of src into dst; returns the bytes written. */
int64_t zc_zstd_decompress(const uint8_t *src, int64_t srclen, uint8_t *dst, int64_t cap,
                           int64_t *counters) {
  if (!src || srclen < 0 || cap < 0 || (cap > 0 && !dst)) return ZC_E_ARG;
  Frame *f = (Frame *)malloc(sizeof(Frame));
  if (!f) return ZC_E_NOMEM;
  f->lit = (uint8_t *)malloc(1 << 17);
  if (!f->lit) {
    free(f);
    return ZC_E_NOMEM;
  }
  int64_t in = 0, pos = 0, rc = 0;
  int frames = 0;
  while (in < srclen) {
    if (srclen - in < 4) { rc = ZC_E_TRUNCATED; break; }
    uint32_t magic = rd32(src + in);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (srclen - in < 8) { rc = ZC_E_TRUNCATED; break; }
      int64_t sz = rd32(src + in + 4);
      if (sz > srclen - in - 8) { rc = ZC_E_TRUNCATED; break; }
      in += 8 + sz;
      BUMP(counters, C_SKIPPABLE, 1);
      continue;
    }
    if (magic != 0xFD2FB528u) { rc = ZC_E_CORRUPT; break; }
    in += 4;
    if (in >= srclen) { rc = ZC_E_TRUNCATED; break; }
    int fhd = src[in++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did = fhd & 3;
    if (fhd & 8) { rc = ZC_E_CORRUPT; break; }
    uint64_t window = 0;
    if (!single) {
      if (in >= srclen) { rc = ZC_E_TRUNCATED; break; }
      int wd = src[in++];
      int wlog = 10 + (wd >> 3);
      if (wlog > 41) { rc = ZC_E_CORRUPT; break; }
      uint64_t base = 1ULL << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    int did_size = did == 0 ? 0 : (did == 1 ? 1 : (did == 2 ? 2 : 4));
    if (srclen - in < did_size) { rc = ZC_E_TRUNCATED; break; }
    uint32_t dict_id = 0;
    for (int i = 0; i < did_size; i++) dict_id |= (uint32_t)src[in + i] << (8 * i);
    in += did_size;
    if (dict_id != 0) { rc = ZC_E_DICTIONARY; break; }
    int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
    if (srclen - in < fcs_size) { rc = ZC_E_TRUNCATED; break; }
    int64_t content = -1;
    if (fcs_size) {
      uint64_t v = 0;
      for (int i = 0; i < fcs_size; i++) v |= (uint64_t)src[in + i] << (8 * i);
      if (fcs_size == 2) v += 256;
      if (v > (uint64_t)INT64_MAX) { rc = ZC_E_CORRUPT; break; }
      content = (int64_t)v;
      in += fcs_size;
    }
    if (single) window = content < 0 ? 0 : (uint64_t)content;
    int64_t block_max = window < (1 << 17) ? (int64_t)window : (1 << 17);
    f->ll.ready = f->of.ready = f->ml.ready = 0;
    f->huf.ready = 0;
    f->rep[0] = 1;
    f->rep[1] = 4;
    f->rep[2] = 8;
    int64_t start = pos;
    for (;;) {
      if (srclen - in < 3) { rc = ZC_E_TRUNCATED; break; }
      uint32_t bh = src[in] | (src[in + 1] << 8) | ((uint32_t)src[in + 2] << 16);
      in += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 3) { rc = ZC_E_CORRUPT; break; }
      if (type == 1) {
        if (srclen - in < 1) { rc = ZC_E_TRUNCATED; break; }
        if (size > block_max && block_max) { rc = ZC_E_CORRUPT; break; }
        if (cap - pos < size) { rc = ZC_E_DST; break; }
        memset(dst + pos, src[in], (size_t)size);
        pos += size;
        in += 1;
        BUMP(counters, C_BLOCK_RLE, 1);
      } else {
        if (srclen - in < size) { rc = ZC_E_TRUNCATED; break; }
        if (size > (1 << 17)) { rc = ZC_E_CORRUPT; break; }
        if (type == 0) {
          if (cap - pos < size) { rc = ZC_E_DST; break; }
          memcpy(dst + pos, src + in, (size_t)size);
          pos += size;
          BUMP(counters, C_BLOCK_RAW, 1);
        } else {
          int64_t np = block_compressed(f, src + in, size, dst, cap, pos, start, counters);
          if (np < 0) { rc = np; break; }
          pos = np;
          BUMP(counters, C_BLOCK_COMPRESSED, 1);
        }
        in += size;
      }
      if (last) break;
    }
    if (rc < 0) break;
    if (content >= 0 && pos - start != content) { rc = ZC_E_SIZE; break; }
    if (checksum) {
      if (srclen - in < 4) { rc = ZC_E_TRUNCATED; break; }
      uint32_t want = rd32(src + in);
      in += 4;
      if ((uint32_t)xxh64(dst + start, (size_t)(pos - start)) != want) {
        rc = ZC_E_CHECKSUM;
        break;
      }
      BUMP(counters, C_CHECKSUMS, 1);
    }
    frames++;
    BUMP(counters, C_FRAMES, 1);
  }
  free(f->lit);
  free(f);
  if (rc < 0) return rc;
  if (frames == 0) return ZC_E_CORRUPT;
  return pos;
}

/* ------------------------------------------------------------------ */
/* zstd encoder                                                        */
/* ------------------------------------------------------------------ */

/* The mirror of the decoder above. A frame is one segment with its content
 * size and no checksum (what c-blosc's ZSTD_compressCCtx writes), its window
 * the whole frame. Each block: RLE where it is one byte repeated, raw where
 * the compressed form would not be smaller, else compressed. The match
 * finder keeps hash tables of positions across the blocks of a frame:
 * level 1 one table of 6-byte prefixes (zstd's "fast"), levels 2 and 3 a
 * table of 8-byte and one of 5-byte prefixes ("dfast"); matches are of 4
 * bytes or more (the format's least is 3). Literals go raw, RLE or Huffman
 * coded (package-merge lengths of at most 11 bits; the weights direct or
 * FSE-coded; one stream under 1 KiB, else four; the frame's last table
 * reused, treeless, where that is smaller). Each of the three sequence codes
 * takes the predefined, RLE or an FSE-compressed table, whichever costs
 * least; the repeat offsets carry across blocks as the decoder keeps them. */

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the encoder stores its bit streams with little-endian word writes"
#endif

#define ZE_BLOCK (1 << 17)            /* zstd's largest block */
#define ZE_MAX_SEQ (ZE_BLOCK / 4 + 1) /* matches are of 4 bytes or more */
#define ZE_TAIL 16                    /* bytes at a block's end the search leaves (8-byte reads) */
#define ZE_HUF_MAX_BITS 11

static inline void st16(uint8_t *p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
}

static inline void st24(uint8_t *p, uint32_t v) {
  st16(p, v);
  p[2] = (uint8_t)(v >> 16);
}

static inline void st32(uint8_t *p, uint32_t v) {
  st16(p, v);
  st16(p + 2, v >> 16);
}

/* A forward bit stream that the decoder reads backward (BitBack). Stores
 * are whole 64-bit words; past `cap` it stops writing and flags overflow. */
typedef struct {
  uint8_t *start, *ptr, *end;
  uint64_t acc;
  int bits;
  int overflow;
} BitOut;

static void bo_init(BitOut *b, uint8_t *dst, int64_t cap) {
  b->start = b->ptr = dst;
  b->end = dst + (cap >= 8 ? cap - 8 : 0);
  b->acc = 0;
  b->bits = 0;
  b->overflow = cap < 8;
}

/* Add the n low bits of v (v < 2^n); at most 56 bits between flushes. */
static inline void bo_add(BitOut *b, uint64_t v, int n) {
  b->acc |= v << b->bits;
  b->bits += n;
}

static inline void bo_flush(BitOut *b) {
  int nb = b->bits >> 3;
  if (!b->overflow) memcpy(b->ptr, &b->acc, 8);
  b->ptr += nb;
  if (b->ptr > b->end) {
    b->ptr = b->end;
    b->overflow = 1;
  }
  b->acc = nb ? (nb == 8 ? 0 : b->acc >> (8 * nb)) : b->acc;
  b->bits &= 7;
}

/* The closing 1 bit; returns the stream's bytes, or -1 past its capacity. */
static int64_t bo_close(BitOut *b) {
  bo_add(b, 1, 1);
  bo_flush(b);
  if (b->overflow) return -1;
  return (b->ptr - b->start) + (b->bits > 0);
}

/* Fixed-point log2 (1/256 bit) of 1 <= x < 2^24. */
static int log2_fix(uint32_t x) {
  int hb = highbit32(x);
  uint32_t f = hb >= 8 ? (x >> (hb - 8)) & 255 : (x << (8 - hb)) & 255;
  return (hb << 8) + (int)f + (int)((f * (256 - f) * 89) >> 16);
}

/* ---- FSE tables for encoding ---- */

typedef struct {
  int log;
  uint16_t state[512];
  int32_t dnb[64];  /* (nbits out << 16) - the least state that takes them */
  int32_t dfs[64];  /* the symbol's first entry in `state`, less its count */
  int32_t first[64];
} FseCTable;

static int fse_ctable(FseCTable *ct, const int16_t *norm, int max_sym, int log) {
  int size = 1 << log, high = size - 1;
  uint8_t sym_at[512];
  int cumul[65];
  cumul[0] = 0;
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -1) {
      sym_at[high--] = (uint8_t)s;
      cumul[s + 1] = cumul[s] + 1;
    } else {
      cumul[s + 1] = cumul[s] + norm[s];
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s <= max_sym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      sym_at[pos] = (uint8_t)s;
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0 || cumul[max_sym + 1] != size) return ZC_E_ARG;
  int next[64];
  memcpy(next, cumul, sizeof(int) * (max_sym + 1));
  for (int u = 0; u < size; u++) ct->state[next[sym_at[u]]++] = (uint16_t)(size + u);
  for (int s = 0; s <= max_sym; s++) {
    int n = norm[s];
    ct->first[s] = cumul[s];
    if (n == 0) {
      ct->dnb[s] = ((log + 1) << 16) - size;
      ct->dfs[s] = 0;
    } else if (n == -1 || n == 1) {
      ct->dnb[s] = (log << 16) - size;
      ct->dfs[s] = cumul[s] - 1;
    } else {
      int out = log - highbit32((uint32_t)n - 1);
      ct->dnb[s] = (out << 16) - (n << out);
      ct->dfs[s] = cumul[s] - n;
    }
  }
  ct->log = log;
  return 0;
}

/* The state that decodes s with no bits before it: its first cell, whose
 * update reads the most bits (at least 1), so a stream's end is seen. */
static inline uint32_t fse_init(const FseCTable *ct, int s) { return ct->state[ct->first[s]]; }

static inline void fse_enc(BitOut *b, const FseCTable *ct, uint32_t *state, int s) {
  uint32_t nb = (uint32_t)((int64_t)*state + ct->dnb[s]) >> 16;
  bo_add(b, *state & ((1u << nb) - 1), (int)nb);
  *state = ct->state[(*state >> nb) + ct->dfs[s]];
}

/* Counts to a table of 2^log (zstd's FSE_normalizeCount, with a plain
 * fix-up where the largest symbol cannot take the rounding alone). A count
 * at most total >> log becomes -1 where low_prob, else 1. Returns 0, or
 * ZC_E_ARG for one symbol or more symbols than cells. */
static int fse_normalize(int16_t *norm, int log, const uint32_t *count, uint32_t total,
                         int max_sym, int low_prob) {
  static const uint32_t rtb[8] = {0, 473195, 504333, 520860, 550000, 700000, 750000, 830000};
  const int scale = 62 - log;
  const uint64_t step = ((uint64_t)1 << 62) / total, vstep = (uint64_t)1 << (scale - 20);
  const uint32_t low = total >> log;
  int still = 1 << log, largest = 0, present = 0;
  int16_t largest_p = 0;
  for (int s = 0; s <= max_sym; s++) {
    if (count[s] == total) return ZC_E_ARG;
    norm[s] = 0;
    if (!count[s]) continue;
    present++;
    if (count[s] <= low) {
      norm[s] = low_prob ? -1 : 1;
      still--;
    } else {
      int16_t p = (int16_t)((count[s] * step) >> scale);
      if (p < 8) p += (count[s] * step) - ((uint64_t)p << scale) > vstep * rtb[p];
      if (p < 1) p = 1;
      if (p > largest_p) {
        largest_p = p;
        largest = s;
      }
      norm[s] = p;
      still -= p;
    }
  }
  if (present > (1 << log)) return ZC_E_ARG;
  if (-still < (norm[largest] >> 1)) {
    norm[largest] = (int16_t)(norm[largest] + still);
    return 0;
  }
  while (still != 0) {
    /* Take from (or give to) the symbol with the most cells. */
    int best = -1;
    for (int s = 0; s <= max_sym; s++) {
      if (norm[s] > (still < 0 ? 1 : 0) && (best < 0 || norm[s] > norm[best])) best = s;
    }
    if (best < 0) return ZC_E_ARG;
    norm[best] = (int16_t)(norm[best] + (still < 0 ? -1 : 1));
    still += still < 0 ? 1 : -1;
  }
  return 0;
}

/* The table description (the inverse of fse_read_counts); returns bytes. */
static int64_t fse_write_counts(uint8_t *out, int64_t cap, const int16_t *norm, int max_sym,
                                int log) {
  uint64_t acc = 0;
  int bits = 0;
  int64_t o = 0;
#define PUT(v, n)                                  \
  do {                                             \
    acc |= (uint64_t)(v) << bits;                  \
    bits += (n);                                   \
    while (bits >= 8) {                            \
      if (o >= cap) return ZC_E_DST;               \
      out[o++] = (uint8_t)acc;                     \
      acc >>= 8;                                   \
      bits -= 8;                                   \
    }                                              \
  } while (0)
  PUT(log - 5, 4);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, s = 0, prev0 = 0;
  while (s <= max_sym && remaining > 1) {
    if (prev0) {
      int start = s;
      while (s <= max_sym && !norm[s]) s++;
      if (s > max_sym) return ZC_E_ARG;
      while (s >= start + 3) {
        start += 3;
        PUT(3, 2);
      }
      PUT(s - start, 2);
    }
    int count = norm[s++];
    int max = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;
    if (count >= threshold) count += max;
    PUT(count, nbits - (count < max));
    prev0 = count == 1;
    if (remaining < 1) return ZC_E_ARG;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return ZC_E_ARG;
  if (bits > 0) {
    if (o >= cap) return ZC_E_DST;
    out[o++] = (uint8_t)acc;
  }
#undef PUT
  return o;
}

/* zstd's FSE_optimalTableLog. */
static int fse_table_log(int max_log, uint32_t total, int max_sym) {
  int log = max_log;
  int from_src = highbit32(total - 1) - 2;
  int min_src = highbit32(total) + 1, min_sym = highbit32((uint32_t)max_sym) + 2;
  int min_bits = min_src < min_sym ? min_src : min_sym;
  if (from_src < log) log = from_src;
  if (min_bits > log) log = min_bits;
  if (log < 5) log = 5;
  if (log > max_log) log = max_log;
  return log;
}

/* Bits (1/256) that counts cost under a table's normalised counts. */
static uint64_t fse_cost(const uint32_t *count, int max_sym, const int16_t *norm, int log) {
  uint64_t c = 0;
  for (int s = 0; s <= max_sym; s++) {
    if (!count[s]) continue;
    int n = norm[s] < 0 ? 1 : norm[s];
    c += (uint64_t)count[s] * (uint64_t)((log << 8) - log2_fix((uint32_t)n));
  }
  return c;
}

/* ---- the encoder's state ---- */

typedef struct {
  uint32_t ll, ml, of;  /* literal length, match length, offset value (1-3 repeat codes) */
} ZSeq;

typedef struct {
  int valid, maxbits;
  uint8_t len[256];
  uint16_t code[256];
} HufCode;

typedef struct {
  int level, hlog, slog;
  /* Frame position + gen; below gen, an earlier frame's. A candidate is
   * taken only where it lies before the search's position. */
  uint32_t *hash, *hash_short;
  uint64_t gen;
  uint32_t rep[3];
  HufCode huf;                  /* the frame's last Huffman table the decoder holds */
  uint8_t *lit;
  int64_t nlit;
  ZSeq *seq;
  int64_t nseq;
  uint8_t *codes;               /* three code arrays of ZE_MAX_SEQ */
  uint8_t *body;                /* a compressed block, ZE_BLOCK + 64 */
  uint8_t ll_code[64], ml_code[128];
} Enc;

static void enc_free(Enc *e) {
  if (!e) return;
  free(e->hash);
  free(e->hash_short);
  free(e->lit);
  free(e->seq);
  free(e->codes);
  free(e->body);
  free(e);
}

static Enc *enc_new(int level) {
  Enc *e = (Enc *)calloc(1, sizeof(Enc));
  if (!e) return NULL;
  e->level = level < 1 ? 1 : (level > 3 ? 3 : level);
  e->hlog = e->level == 1 ? 14 : (e->level == 2 ? 15 : 16);
  e->slog = e->level == 1 ? 0 : e->hlog - 1;
  e->hash = (uint32_t *)calloc((size_t)1 << e->hlog, 4);
  e->hash_short = e->slog ? (uint32_t *)calloc((size_t)1 << e->slog, 4) : NULL;
  e->lit = (uint8_t *)malloc(ZE_BLOCK + 64);
  e->seq = (ZSeq *)malloc(sizeof(ZSeq) * ZE_MAX_SEQ);
  e->codes = (uint8_t *)malloc(3 * ZE_MAX_SEQ);
  e->body = (uint8_t *)malloc(ZE_BLOCK + 64);
  if (!e->hash || (e->slog && !e->hash_short) || !e->lit || !e->seq || !e->codes || !e->body) {
    enc_free(e);
    return NULL;
  }
  e->gen = 1;
  for (int v = 0; v < 64; v++) {
    int c = 0;
    while (c + 1 < 36 && LL_BASE[c + 1] <= (uint32_t)v) c++;
    e->ll_code[v] = (uint8_t)c;
  }
  for (int v = 0; v < 128; v++) {
    int c = 0;
    while (c + 1 < 53 && ML_BASE[c + 1] <= (uint32_t)v + 3) c++;
    e->ml_code[v] = (uint8_t)c;
  }
  return e;
}

/* ---- match finding ---- */

static inline uint32_t hash5(const uint8_t *p, int h) {
  return (uint32_t)(((rd64(p) << 24) * 889523592379ULL) >> (64 - h));
}

static inline uint32_t hash6(const uint8_t *p, int h) {
  return (uint32_t)(((rd64(p) << 16) * 227718039650203ULL) >> (64 - h));
}

static inline uint32_t hash8(const uint8_t *p, int h) {
  return (uint32_t)((rd64(p) * 0xCF1BBCDCB7A56463ULL) >> (64 - h));
}

/* Equal bytes at a and at b (b before a), a running to end. */
static inline int64_t match_len(const uint8_t *a, const uint8_t *b, const uint8_t *end) {
  const uint8_t *s = a;
  while (a + 8 <= end) {
    uint64_t d = rd64(a) ^ rd64(b);
    if (d) return (a - s) + (__builtin_ctzll(d) >> 3);
    a += 8;
    b += 8;
  }
  while (a < end && *a == *b) a++, b++;
  return a - s;
}

/* One sequence: `ll` literals from `lits`, then a match of `ml` bytes at
 * distance `off`; its offset value and the repeat offsets as the decoder
 * will update them. */
static void emit(Enc *e, const uint8_t *lits, int64_t ll, int64_t ml, uint32_t off) {
  memcpy(e->lit + e->nlit, lits, (size_t)ll);
  e->nlit += ll;
  uint32_t *rep = e->rep, of;
  int idx;
  if (ll > 0) {
    idx = off == rep[0] ? 0 : (off == rep[1] ? 1 : (off == rep[2] ? 2 : -1));
    of = idx < 0 ? off + 3 : (uint32_t)idx + 1;
  } else {
    idx = off == rep[1] ? 1 : (off == rep[2] ? 2 : (off == rep[0] - 1 ? 3 : -1));
    of = idx < 0 ? off + 3 : (uint32_t)idx;
  }
  if (idx < 0) {
    rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = off;
  } else if (idx > 0) {
    if (idx != 1) rep[2] = rep[1];
    rep[1] = rep[0];
    rep[0] = off;
  }
  ZSeq *q = &e->seq[e->nseq++];
  q->ll = (uint32_t)ll;
  q->ml = (uint32_t)ml;
  q->of = of;
}

/* Sequences of block [bs, be) of the frame src: level 1. */
static int64_t search_fast(Enc *e, const uint8_t *src, int64_t bs, int64_t be) {
  const int h = e->hlog;
  uint32_t *t = e->hash;
  const uint64_t g = e->gen;
  const uint8_t *end = src + be;
  const int64_t ilimit = be - ZE_TAIL;
  int64_t ip = bs > 0 ? bs : 1, anchor = bs;
  while (ip < ilimit) {
    const uint8_t *p = src + ip;
    uint32_t hv = hash6(p, h);
    uint64_t cand = t[hv];
    t[hv] = (uint32_t)(ip + g);
    uint32_t r0 = e->rep[0];
    if (ip + 1 >= (int64_t)r0 && rd32(p + 1) == rd32(p + 1 - r0)) {
      int64_t ml = 4 + match_len(p + 5, p + 5 - r0, end);
      emit(e, src + anchor, ip + 1 - anchor, ml, r0);
      ip += 1 + ml;
      anchor = ip;
    } else if (cand >= g && cand < g + ip && rd32(src + (cand - g)) == rd32(p)) {
      int64_t m = (int64_t)(cand - g);
      int64_t ml = 4 + match_len(p + 4, src + m + 4, end);
      while (ip > anchor && m > 0 && src[ip - 1] == src[m - 1]) ip--, m--, ml++;
      emit(e, src + anchor, ip - anchor, ml, (uint32_t)(ip - m));
      ip += ml;
      anchor = ip;
    } else {
      ip += ((ip - anchor) >> 8) + 1;
      continue;
    }
    if (ip < ilimit) t[hash6(src + ip - 2, h)] = (uint32_t)(ip - 2 + g);
    /* The second repeat offset straight after a match. */
    while (ip < ilimit && ip >= (int64_t)e->rep[1] && rd32(src + ip) == rd32(src + ip - e->rep[1])) {
      uint32_t r1 = e->rep[1];
      int64_t rl = 4 + match_len(src + ip + 4, src + ip + 4 - r1, end);
      t[hash6(src + ip, h)] = (uint32_t)(ip + g);
      emit(e, src + ip, 0, rl, r1);
      ip += rl;
      anchor = ip;
    }
  }
  return anchor;
}

/* Levels 2 and 3: a long (8-byte) and a short (5-byte) hash. */
static int64_t search_dfast(Enc *e, const uint8_t *src, int64_t bs, int64_t be) {
  const int hl = e->hlog, hs = e->slog;
  uint32_t *lt = e->hash, *stt = e->hash_short;
  const uint64_t g = e->gen;
  const uint8_t *end = src + be;
  const int64_t ilimit = be - ZE_TAIL;
  int64_t ip = bs > 0 ? bs : 1, anchor = bs;
  while (ip < ilimit) {
    const uint8_t *p = src + ip;
    uint32_t h8 = hash8(p, hl), h5 = hash5(p, hs);
    uint64_t cl = lt[h8], cs = stt[h5];
    lt[h8] = stt[h5] = (uint32_t)(ip + g);
    uint32_t r0 = e->rep[0];
    int64_t start = ip, ml, m = -1;
    if (ip + 1 >= (int64_t)r0 && rd32(p + 1) == rd32(p + 1 - r0)) {
      ml = 4 + match_len(p + 5, p + 5 - r0, end);
      ip++;
      emit(e, src + anchor, ip - anchor, ml, r0);
    } else {
      if (cl >= g && cl < g + ip && rd64(src + (cl - g)) == rd64(p)) {
        m = (int64_t)(cl - g);
        ml = 8 + match_len(p + 8, src + m + 8, end);
      } else if (cs >= g && cs < g + ip && rd32(src + (cs - g)) == rd32(p)) {
        uint32_t h8n = hash8(p + 1, hl);
        uint64_t c3 = lt[h8n];
        lt[h8n] = (uint32_t)(ip + 1 + g);
        if (c3 >= g && c3 < g + ip + 1 && rd64(src + (c3 - g)) == rd64(p + 1)) {
          ip++;
          m = (int64_t)(c3 - g);
          ml = 8 + match_len(src + ip + 8, src + m + 8, end);
        } else {
          m = (int64_t)(cs - g);
          ml = 4 + match_len(p + 4, src + m + 4, end);
        }
      } else {
        ip += ((ip - anchor) >> 8) + 1;
        continue;
      }
      while (ip > anchor && m > 0 && src[ip - 1] == src[m - 1]) ip--, m--, ml++;
      emit(e, src + anchor, ip - anchor, ml, (uint32_t)(ip - m));
    }
    ip += ml;
    anchor = ip;
    if (ip < ilimit) {
      lt[hash8(src + start + 2, hl)] = (uint32_t)(start + 2 + g);
      stt[hash5(src + start + 2, hs)] = (uint32_t)(start + 2 + g);
      lt[hash8(src + ip - 2, hl)] = (uint32_t)(ip - 2 + g);
      stt[hash5(src + ip - 1, hs)] = (uint32_t)(ip - 1 + g);
    }
    while (ip < ilimit && ip >= (int64_t)e->rep[1] && rd32(src + ip) == rd32(src + ip - e->rep[1])) {
      uint32_t r1 = e->rep[1];
      int64_t rl = 4 + match_len(src + ip + 4, src + ip + 4 - r1, end);
      stt[hash5(src + ip, hs)] = lt[hash8(src + ip, hl)] = (uint32_t)(ip + g);
      emit(e, src + ip, 0, rl, r1);
      ip += rl;
      anchor = ip;
    }
  }
  return anchor;
}

/* ---- literals ---- */

/* Optimal code lengths of at most `limit` bits (package-merge) for the
 * symbols with a count (at least two); returns the longest. */
static int huf_lengths(const uint32_t *count, int max_sym, int limit, uint8_t *len) {
  int sym[256], n = 0;
  for (int s = 0; s <= max_sym; s++) {
    len[s] = 0;
    if (count[s]) {
      /* insertion by count, ascending */
      int i = n++;
      while (i > 0 && count[sym[i - 1]] > count[s]) {
        sym[i] = sym[i - 1];
        i--;
      }
      sym[i] = s;
    }
  }
  static const int MAXN = 512;
  uint64_t wa[512], wb[512], *prev = wa, *cur = wb;
  uint8_t pkg[ZE_HUF_MAX_BITS][512];
  int cnt[ZE_HUF_MAX_BITS];
  for (int i = 0; i < n; i++) {
    prev[i] = count[sym[i]];
    pkg[0][i] = 0;
  }
  cnt[0] = n;
  for (int l = 1; l < limit; l++) {
    int np = cnt[l - 1] / 2, a = 0, b = 0, k = 0;
    while (a < n || b < np) {
      uint64_t pw = b < np ? prev[2 * b] + prev[2 * b + 1] : 0;
      if (b >= np || (a < n && count[sym[a]] <= pw)) {
        cur[k] = count[sym[a++]];
        pkg[l][k++] = 0;
      } else {
        cur[k] = pw;
        pkg[l][k++] = 1;
        b++;
      }
      if (k >= MAXN) break;
    }
    cnt[l] = k;
    uint64_t *t = prev;
    prev = cur;
    cur = t;
  }
  int c = 2 * n - 2, maxbits = 0;
  for (int l = limit - 1; l >= 0; l--) {
    int p = 0, leaf = 0;
    if (c > cnt[l]) c = cnt[l];
    for (int i = 0; i < c; i++) {
      if (pkg[l][i]) p++;
      else len[sym[leaf++]]++;
    }
    c = 2 * p;
  }
  for (int s = 0; s <= max_sym; s++) maxbits = len[s] > maxbits ? len[s] : maxbits;
  return maxbits;
}

/* Canonical codes the decoder's table gives for lengths `len`. */
static void huf_codes(HufCode *h, const uint8_t *len, int max_sym, int maxbits) {
  uint32_t rank[ZE_HUF_MAX_BITS + 2] = {0}, start[ZE_HUF_MAX_BITS + 2] = {0};
  memset(h->len, 0, sizeof(h->len));
  for (int s = 0; s <= max_sym; s++) {
    h->len[s] = len[s];
    if (len[s]) rank[maxbits + 1 - len[s]]++;
  }
  uint32_t nxt = 0;
  for (int w = 1; w <= maxbits; w++) {
    start[w] = nxt;
    nxt += rank[w] << (w - 1);
  }
  for (int s = 0; s <= max_sym; s++) {
    if (!len[s]) continue;
    int w = maxbits + 1 - len[s];
    h->code[s] = (uint16_t)(start[w] >> (w - 1));
    start[w] += 1u << (w - 1);
  }
  h->maxbits = maxbits;
  h->valid = 1;
}

/* The weights FSE-coded behind their byte count (hb < 128); 0 where that
 * cannot be. */
static int64_t huf_weights_fse(const uint8_t *w, int nw, uint8_t *out) {
  if (nw < 2) return 0;
  uint32_t count[16] = {0};
  int maxw = 0;
  for (int i = 0; i < nw; i++) {
    count[w[i]]++;
    maxw = w[i] > maxw ? w[i] : maxw;
  }
  int64_t best = 0;
  uint8_t buf[160];
  for (int log = 5; log <= 6; log++) {
    int16_t norm[16];
    FseCTable ct;
    if (fse_normalize(norm, log, count, (uint32_t)nw, maxw, 0) < 0) return 0;
    int64_t hsz = fse_write_counts(buf, 128, norm, maxw, log);
    if (hsz < 0 || fse_ctable(&ct, norm, maxw, log) < 0) continue;
    BitOut b;
    bo_init(&b, buf + hsz, 150 - hsz);
    uint32_t s1, s2;
    int i;
    if (nw & 1) {
      s1 = fse_init(&ct, w[nw - 1]);
      s2 = fse_init(&ct, w[nw - 2]);
      fse_enc(&b, &ct, &s1, w[nw - 3]);
      i = nw - 3;
    } else {
      s2 = fse_init(&ct, w[nw - 1]);
      s1 = fse_init(&ct, w[nw - 2]);
      i = nw - 2;
    }
    bo_flush(&b);
    while (i > 0) {
      fse_enc(&b, &ct, &s2, w[--i]);
      fse_enc(&b, &ct, &s1, w[--i]);
      bo_flush(&b);
    }
    bo_add(&b, s2 & ((1u << log) - 1), log);
    bo_add(&b, s1 & ((1u << log) - 1), log);
    int64_t bsz = bo_close(&b);
    if (bsz < 0 || hsz + bsz > 127) continue;
    if (!best || hsz + bsz < best) {
      best = hsz + bsz;
      out[0] = (uint8_t)best;
      memcpy(out + 1, buf, (size_t)best);
    }
  }
  return best ? best + 1 : 0;
}

/* The Huffman tree description: the weights of symbols 0 .. max_sym - 1
 * (the last one's is implied), direct or FSE-coded, whichever is smaller;
 * 0 where neither can be written. */
static int64_t huf_describe(const HufCode *h, int max_sym, uint8_t *out) {
  uint8_t w[256];
  int nw = max_sym;
  for (int s = 0; s < nw; s++) w[s] = h->len[s] ? (uint8_t)(h->maxbits + 1 - h->len[s]) : 0;
  uint8_t fse[160];
  int64_t nf = huf_weights_fse(w, nw, fse);
  int64_t nd = nw <= 128 ? 1 + (nw + 1) / 2 : 0;
  if (nf && (!nd || nf < nd)) {
    memcpy(out, fse, (size_t)nf);
    return nf;
  }
  if (!nd) return 0;
  out[0] = (uint8_t)(127 + nw);
  memset(out + 1, 0, (size_t)(nd - 1));
  for (int i = 0; i < nw; i++) out[1 + i / 2] |= (uint8_t)(i & 1 ? w[i] : w[i] << 4);
  return nd;
}

static int64_t huf_write_stream(const uint8_t *lit, int64_t n, const HufCode *h, uint8_t *dst,
                          int64_t cap) {
  BitOut b;
  bo_init(&b, dst, cap);
  int64_t i = n;
  while (i >= 4) {
    for (int k = 0; k < 4; k++) {
      uint8_t c = lit[--i];
      bo_add(&b, h->code[c], h->len[c]);
    }
    bo_flush(&b);
    if (b.overflow) return -1;
  }
  while (i > 0) {
    uint8_t c = lit[--i];
    bo_add(&b, h->code[c], h->len[c]);
  }
  return bo_close(&b);
}

static int lit_header_raw(uint8_t *dst, int type, int64_t n) {
  if (n < 32) {
    dst[0] = (uint8_t)(type | (n << 3));
    return 1;
  }
  if (n < 4096) {
    dst[0] = (uint8_t)(type | (1 << 2) | ((n & 15) << 4));
    dst[1] = (uint8_t)(n >> 4);
    return 2;
  }
  dst[0] = (uint8_t)(type | (3 << 2) | ((n & 15) << 4));
  dst[1] = (uint8_t)(n >> 4);
  dst[2] = (uint8_t)(n >> 12);
  return 3;
}

/* Huffman-coded literals, under `limit` bytes; 0 where they would not be. */
static int64_t huf_literals(Enc *e, const uint32_t *count, int max_sym, uint8_t *dst,
                            int64_t limit) {
  const uint8_t *lit = e->lit;
  int64_t n = e->nlit;
  uint8_t len[256];
  HufCode fresh;
  int maxbits = huf_lengths(count, max_sym, ZE_HUF_MAX_BITS, len);
  huf_codes(&fresh, len, max_sym, maxbits);
  uint64_t bits_new = 0, bits_old = 0;
  int old_ok = e->huf.valid;
  for (int s = 0; s <= max_sym; s++) {
    if (!count[s]) continue;
    bits_new += (uint64_t)count[s] * len[s];
    if (!e->huf.len[s]) old_ok = 0;
    bits_old += (uint64_t)count[s] * e->huf.len[s];
  }
  const int MAXHDR = 5;
  uint8_t *p = dst + MAXHDR;
  int64_t cap = limit - MAXHDR, o = 0;
  if (cap <= 0) return 0;
  uint8_t desc[160];
  int64_t dsize = huf_describe(&fresh, max_sym, desc);
  int treeless = old_ok && (!dsize || (bits_old + 7) / 8 <= (bits_new + 7) / 8 + (uint64_t)dsize);
  if (!treeless && !dsize) return 0;
  /* The streams' sizes are known from the counts: write none that lose. */
  uint64_t need = (treeless ? (bits_old + 7) / 8 : (bits_new + 7) / 8 + (uint64_t)dsize) + 3;
  if (need >= (uint64_t)limit) return 0;
  const HufCode *h = treeless ? &e->huf : &fresh;
  if (!treeless) {
    if (dsize > cap) return 0;
    memcpy(p, desc, (size_t)dsize);
    o = dsize;
  }
  int four = n >= 1024;
  if (!four) {
    int64_t s = huf_write_stream(lit, n, h, p + o, cap - o);
    if (s < 0) return 0;
    o += s;
  } else {
    if (cap - o < 6) return 0;
    int64_t seg = (n + 3) / 4, jt = o;
    o += 6;
    for (int k = 0; k < 4; k++) {
      int64_t m = k < 3 ? seg : n - 3 * seg;
      int64_t s = huf_write_stream(lit + k * seg, m, h, p + o, cap - o);
      if (s < 0 || (k < 3 && s > 65535)) return 0;
      if (k < 3) st16(p + jt + 2 * k, (uint32_t)s);
      o += s;
    }
  }
  /* The header's size format, then the payload moved up against it. */
  int64_t big = n > o ? n : o;
  int type = treeless ? 3 : 2, hsz;
  uint64_t hv;
  if (!four) {
    if (big >= 1024) return 0;
    hsz = 3;
    hv = (uint64_t)type | ((uint64_t)n << 4) | ((uint64_t)o << 14);
  } else if (big < 1024) {
    hsz = 3;
    hv = (uint64_t)type | (1 << 2) | ((uint64_t)n << 4) | ((uint64_t)o << 14);
  } else if (big < 16384) {
    hsz = 4;
    hv = (uint64_t)type | (2 << 2) | ((uint64_t)n << 4) | ((uint64_t)o << 18);
  } else {
    hsz = 5;
    hv = (uint64_t)type | (3 << 2) | ((uint64_t)n << 4) | ((uint64_t)o << 22);
  }
  if (hsz + o >= limit) return 0;
  memmove(dst + hsz, p, (size_t)o);
  for (int i = 0; i < hsz; i++) dst[i] = (uint8_t)(hv >> (8 * i));
  if (!treeless) e->huf = fresh;
  return hsz + o;
}

static int64_t enc_literals(Enc *e, uint8_t *dst, int64_t cap) {
  const uint8_t *lit = e->lit;
  int64_t n = e->nlit;
  int64_t hraw = n < 32 ? 1 : (n < 4096 ? 2 : 3);
  if (n == 0) {
    if (cap < 1) return ZC_E_DST;
    dst[0] = 0;
    return 1;
  }
  uint32_t count[4][256];
  memset(count, 0, sizeof(count));
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    count[0][lit[i]]++;
    count[1][lit[i + 1]]++;
    count[2][lit[i + 2]]++;
    count[3][lit[i + 3]]++;
  }
  for (; i < n; i++) count[0][lit[i]]++;
  uint32_t maxc = 0;
  int max_sym = 0;
  for (int s = 0; s < 256; s++) {
    count[0][s] += count[1][s] + count[2][s] + count[3][s];
    if (count[0][s]) max_sym = s;
    if (count[0][s] > maxc) maxc = count[0][s];
  }
  if (maxc == n) {
    if (cap < hraw + 1) return ZC_E_DST;
    int hsz = lit_header_raw(dst, 1, n);
    dst[hsz] = lit[0];
    return hsz + 1;
  }
  if (n >= 64) {
    int64_t lim = hraw + n < cap ? hraw + n : cap;
    int64_t got = huf_literals(e, count[0], max_sym, dst, lim);
    if (got > 0) return got;
  }
  if (cap < hraw + n) return ZC_E_DST;
  int hsz = lit_header_raw(dst, 0, n);
  memcpy(dst + hsz, lit, (size_t)n);
  return hsz + n;
}

/* ---- sequences ---- */

typedef struct {
  int mode;  /* 0 predefined, 1 RLE, 2 FSE-compressed */
  FseCTable ct;
} SeqTable;

/* The cheapest table of one code's symbols, its description into dst;
 * returns the bytes written. */
static int64_t seq_choose(SeqTable *t, const uint8_t *codes, int64_t n, int max_log,
                          const int16_t *def, int def_max, int def_log, uint8_t *dst,
                          int64_t cap) {
  uint32_t count[64] = {0};
  for (int64_t i = 0; i < n; i++) count[codes[i]]++;
  int ms = 63;
  while (!count[ms]) ms--;
  if (count[ms] == (uint32_t)n) {
    if (cap < 1) return ZC_E_DST;
    t->mode = 1;
    dst[0] = (uint8_t)ms;
    return 1;
  }
  uint64_t c_def = UINT64_MAX, c_fse = UINT64_MAX;
  if (ms <= def_max) c_def = fse_cost(count, ms, def, def_log);
  int16_t norm[64];
  uint8_t desc[128];
  int log = fse_table_log(max_log, (uint32_t)n, ms);
  int64_t dsize = -1;
  if (fse_normalize(norm, log, count, (uint32_t)n, ms, 1) == 0) {
    dsize = fse_write_counts(desc, sizeof(desc), norm, ms, log);
    if (dsize > 0) c_fse = fse_cost(count, ms, norm, log) + ((uint64_t)dsize << 11);
  }
  if (c_def <= c_fse) {
    if (c_def == UINT64_MAX) return ZC_E_ARG;
    t->mode = 0;
    return fse_ctable(&t->ct, def, def_max, def_log) < 0 ? ZC_E_ARG : 0;
  }
  if (dsize > cap) return ZC_E_DST;
  t->mode = 2;
  memcpy(dst, desc, (size_t)dsize);
  return fse_ctable(&t->ct, norm, ms, log) < 0 ? ZC_E_ARG : dsize;
}

static int64_t enc_sequences(Enc *e, uint8_t *dst, int64_t cap) {
  int64_t n = e->nseq, o = 0;
  if (cap < 4) return ZC_E_DST;
  if (n < 128) {
    dst[o++] = (uint8_t)n;
  } else if (n < 0x7F00) {
    dst[o++] = (uint8_t)((n >> 8) + 128);
    dst[o++] = (uint8_t)n;
  } else {
    dst[o++] = 255;
    st16(dst + o, (uint32_t)(n - 0x7F00));
    o += 2;
  }
  if (n == 0) return o;
  uint8_t *llc = e->codes, *ofc = e->codes + ZE_MAX_SEQ, *mlc = e->codes + 2 * ZE_MAX_SEQ;
  for (int64_t i = 0; i < n; i++) {
    const ZSeq *q = &e->seq[i];
    uint32_t mb = q->ml - 3;
    llc[i] = q->ll < 64 ? e->ll_code[q->ll] : (uint8_t)(highbit32(q->ll) + 19);
    mlc[i] = mb < 128 ? e->ml_code[mb] : (uint8_t)(highbit32(mb) + 36);
    ofc[i] = (uint8_t)highbit32(q->of);
  }
  int64_t at_modes = o++;
  SeqTable tl, to, tm;
  int64_t u;
  if ((u = seq_choose(&tl, llc, n, 9, LL_DEFAULT, 35, 6, dst + o, cap - o)) < 0) return u;
  o += u;
  if ((u = seq_choose(&to, ofc, n, 8, OF_DEFAULT, 28, 5, dst + o, cap - o)) < 0) return u;
  o += u;
  if ((u = seq_choose(&tm, mlc, n, 9, ML_DEFAULT, 52, 6, dst + o, cap - o)) < 0) return u;
  o += u;
  dst[at_modes] = (uint8_t)((tl.mode << 6) | (to.mode << 4) | (tm.mode << 2));
  BitOut b;
  bo_init(&b, dst + o, cap - o);
  uint32_t sl = 0, so = 0, sm = 0;
  int64_t last = n - 1;
  if (tl.mode != 1) sl = fse_init(&tl.ct, llc[last]);
  if (to.mode != 1) so = fse_init(&to.ct, ofc[last]);
  if (tm.mode != 1) sm = fse_init(&tm.ct, mlc[last]);
  for (int64_t i = last; i >= 0; i--) {
    const ZSeq *q = &e->seq[i];
    if (i < last) {
      if (to.mode != 1) fse_enc(&b, &to.ct, &so, ofc[i]);
      if (tm.mode != 1) fse_enc(&b, &tm.ct, &sm, mlc[i]);
      if (tl.mode != 1) fse_enc(&b, &tl.ct, &sl, llc[i]);
      bo_flush(&b);
    }
    bo_add(&b, q->ll - LL_BASE[llc[i]], LL_BITS[llc[i]]);
    bo_add(&b, q->ml - ML_BASE[mlc[i]], ML_BITS[mlc[i]]);
    bo_flush(&b);
    bo_add(&b, q->of - (1u << ofc[i]), ofc[i]);
    bo_flush(&b);
    if (b.overflow) return ZC_E_DST;
  }
  if (tm.mode != 1) bo_add(&b, sm & ((1u << tm.ct.log) - 1), tm.ct.log);
  if (to.mode != 1) bo_add(&b, so & ((1u << to.ct.log) - 1), to.ct.log);
  bo_flush(&b);
  if (tl.mode != 1) bo_add(&b, sl & ((1u << tl.ct.log) - 1), tl.ct.log);
  int64_t s = bo_close(&b);
  if (s < 0) return ZC_E_DST;
  return o + s;
}

/* ---- blocks and frames ---- */

/* Block [bs, be) of the frame src (header included) into dst. */
static int64_t enc_block(Enc *e, const uint8_t *src, int64_t bs, int64_t be, int last,
                         uint8_t *dst, int64_t cap) {
  int64_t n = be - bs;
  if (n > 1 && src[bs] == src[be - 1] && !memcmp(src + bs, src + bs + 1, (size_t)(n - 1))) {
    if (cap < 4) return ZC_E_DST;
    st24(dst, (uint32_t)(last | (1 << 1) | (n << 3)));
    dst[3] = src[bs];
    return 4;
  }
  uint32_t rep[3] = {e->rep[0], e->rep[1], e->rep[2]};
  HufCode huf = e->huf;
  e->nlit = e->nseq = 0;
  int64_t anchor = bs;
  if (n > ZE_TAIL) anchor = e->level == 1 ? search_fast(e, src, bs, be) : search_dfast(e, src, bs, be);
  memcpy(e->lit + e->nlit, src + anchor, (size_t)(be - anchor));
  e->nlit += be - anchor;
  int64_t body = -1, l = enc_literals(e, e->body, n);
  if (l > 0 && l < n) {
    int64_t s = enc_sequences(e, e->body + l, n - l);
    if (s > 0 && l + s < n) body = l + s;
  }
  if (body > 0) {
    if (cap < 3 + body) return ZC_E_DST;
    st24(dst, (uint32_t)(last | (2 << 1) | (body << 3)));
    memcpy(dst + 3, e->body, (size_t)body);
    return 3 + body;
  }
  /* Raw: the decoder's state stays as it was before this block. */
  memcpy(e->rep, rep, sizeof(rep));
  e->huf = huf;
  if (cap < 3 + n) return ZC_E_DST;
  st24(dst, (uint32_t)(last | (n << 3)));
  memcpy(dst + 3, src + bs, (size_t)n);
  return 3 + n;
}

/* One frame of src in blocks of at most `block` bytes into dst; ZC_E_DST
 * where it does not fit in cap. */
static int64_t enc_frame(Enc *e, const uint8_t *src, int64_t n, int64_t block, uint8_t *dst,
                         int64_t cap) {
  int flag = n < 256 ? 0 : (n < 65536 + 256 ? 1 : (n <= 0xFFFFFFFFLL ? 2 : 3));
  int fcs = flag == 0 ? 1 : (flag == 1 ? 2 : (flag == 2 ? 4 : 8));
  int64_t o = 5 + fcs;
  if (cap < o + 3) return ZC_E_DST;
  st32(dst, 0xFD2FB528u);
  dst[4] = (uint8_t)((flag << 6) | 0x20);
  uint64_t v = flag == 1 ? (uint64_t)n - 256 : (uint64_t)n;
  for (int i = 0; i < fcs; i++) dst[5 + i] = (uint8_t)(v >> (8 * i));
  if (e->gen + (uint64_t)n >= 0xFFFFFFFFull) {
    memset(e->hash, 0, (size_t)4 << e->hlog);
    if (e->hash_short) memset(e->hash_short, 0, (size_t)4 << e->slog);
    e->gen = 1;
  }
  e->rep[0] = 1;
  e->rep[1] = 4;
  e->rep[2] = 8;
  e->huf.valid = 0;
  memset(e->huf.len, 0, sizeof(e->huf.len));
  if (n == 0) {
    st24(dst + o, 1);
    return o + 3;
  }
  if (block > ZE_BLOCK || block < 1) block = ZE_BLOCK;
  int64_t r = 0;
  for (int64_t bs = 0; bs < n; bs += block) {
    int64_t be = n - bs > block ? bs + block : n;
    r = enc_block(e, src, bs, be, be == n, dst + o, cap - o);
    if (r < 0) break;
    o += r;
  }
  /* However the frame ends: the tables hold its positions, which the next
   * frame must not take for its own. */
  e->gen += (uint64_t)n;
  return r < 0 ? r : o;
}

/* One zstd frame of src[0, n) into dst; returns its bytes, ZC_E_DST where
 * they do not fit in cap (n + 3 a block + 18 always do). Levels 1-3; a
 * higher level runs level 3's search. */
int64_t zc_zstd_compress(const uint8_t *src, int64_t n, uint8_t *dst, int64_t cap,
                         int64_t level) {
  if ((n > 0 && !src) || n < 0 || !dst || cap < 0 || level < 1) return ZC_E_ARG;
  Enc *e = enc_new((int)level);
  if (!e) return ZC_E_NOMEM;
  int64_t r = enc_frame(e, src, n, ZE_BLOCK, dst, cap);
  enc_free(e);
  return r;
}

/* ------------------------------------------------------------------ */
/* Blosc 1                                                             */
/* ------------------------------------------------------------------ */

#define ZC_COPY_UNIT (1 << 20)

/* info: version, versionlz, flags, typesize, nbytes, blocksize, cbytes,
 * units. The units are what zc_blosc_decode splits a container by: its
 * blocks, or for a memcpyed container (no blocks) runs of ZC_COPY_UNIT
 * bytes. */
int64_t zc_blosc_info(const uint8_t *src, int64_t srclen, int64_t *info) {
  if (!src || !info) return ZC_E_ARG;
  if (srclen < 16) return ZC_E_TRUNCATED;
  int64_t nbytes = rd32(src + 4), blocksize = rd32(src + 8), cbytes = rd32(src + 12);
  info[0] = src[0];
  info[1] = src[1];
  info[2] = src[2];
  info[3] = src[3];
  info[4] = nbytes;
  info[5] = blocksize;
  info[6] = cbytes;
  if (src[0] == 0 || src[0] > 2 || src[3] == 0) return ZC_E_HEADER;
  if (cbytes > srclen || cbytes < 16) return ZC_E_TRUNCATED;
  if (src[2] & 0x02) {
    if (cbytes != nbytes + 16) return ZC_E_HEADER;
    info[7] = (nbytes + ZC_COPY_UNIT - 1) / ZC_COPY_UNIT;
    return 0;
  }
  if (nbytes == 0) {
    info[7] = 0;
    return 0;
  }
  if (blocksize <= 0) return ZC_E_HEADER;
  int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  if (16 + 4 * nblocks > cbytes) return ZC_E_TRUNCATED;
  info[7] = nblocks;
  return 0;
}

static void unshuffle(int ts, int64_t n, const uint8_t *src, uint8_t *dst) {
  int64_t elems = n / ts;
  if (ts == 2) {
    const uint8_t *a = src, *b = src + elems;
    for (int64_t i = 0; i < elems; i++) {
      dst[2 * i] = a[i];
      dst[2 * i + 1] = b[i];
    }
  } else if (ts == 4) {
    const uint8_t *a = src, *b = src + elems, *c = src + 2 * elems, *d = src + 3 * elems;
    for (int64_t i = 0; i < elems; i++) {
      dst[4 * i] = a[i];
      dst[4 * i + 1] = b[i];
      dst[4 * i + 2] = c[i];
      dst[4 * i + 3] = d[i];
    }
  } else {
    for (int j = 0; j < ts; j++) {
      const uint8_t *s = src + j * elems;
      for (int64_t i = 0; i < elems; i++) dst[i * ts + j] = s[i];
    }
  }
  memcpy(dst + elems * ts, src + elems * ts, (size_t)(n - elems * ts));
}

/* Units [first, last) of a container (zc_blosc_info) into dst, the whole
 * decoded buffer (dstlen >= nbytes). */
int64_t zc_blosc_decode(const uint8_t *src, int64_t srclen, uint8_t *dst, int64_t dstlen,
                        int64_t first, int64_t last, int64_t *counters) {
  int64_t info[8];
  int64_t rc = zc_blosc_info(src, srclen, info);
  if (rc < 0) return rc;
  int flags = (int)info[2], ts = (int)info[3];
  int64_t nbytes = info[4], bs = info[5], cbytes = info[6], nblocks = info[7];
  if (!dst || dstlen < nbytes) return ZC_E_DST;
  if (flags & 0x02) {
    if (first < 0 || first > last || last > nblocks) return ZC_E_ARG;
    int64_t a = first * ZC_COPY_UNIT, b = last * ZC_COPY_UNIT;
    if (b > nbytes) b = nbytes;
    if (a < b) memcpy(dst + a, src + 16 + a, (size_t)(b - a));
    BUMP(counters, C_BLOSC_MEMCPYED, 1);
    return 0;
  }
  int comp = flags >> 5;
  if (flags & 0x04) return ZC_E_BITSHUFFLE;
  if (comp != 4) return ZC_E_COMPRESSOR;
  if (first < 0 || last > nblocks || first > last) return ZC_E_ARG;
  int shuffle = (flags & 0x01) && ts > 1;
  int dont_split = (flags & 0x10) != 0;
  uint8_t *tmp = NULL;
  if (shuffle) {
    tmp = (uint8_t *)malloc((size_t)bs);
    if (!tmp) return ZC_E_NOMEM;
  }
  for (int64_t k = first; k < last && rc == 0; k++) {
    int64_t bsize = bs, leftover = 0;
    if (k == nblocks - 1 && nbytes % bs) {
      bsize = nbytes % bs;
      leftover = 1;
    }
    int64_t at = rd32(src + 16 + 4 * k);
    if (at < 16 + 4 * nblocks || at > cbytes) { rc = ZC_E_CORRUPT; break; }
    int nsplits = (!dont_split && !leftover) ? ts : 1;
    int64_t neblock = bsize / nsplits;
    uint8_t *out = shuffle ? tmp : dst + k * bs;
    for (int j = 0; j < nsplits; j++) {
      if (cbytes - at < 4) { rc = ZC_E_TRUNCATED; break; }
      int64_t cs = (int32_t)rd32(src + at);
      at += 4;
      if (cs < 0 || cs > cbytes - at) { rc = ZC_E_TRUNCATED; break; }
      if (cs == neblock) {
        memcpy(out, src + at, (size_t)neblock);
        BUMP(counters, C_BLOSC_RAW_STREAMS, 1);
      } else {
        int64_t got = zc_zstd_decompress(src + at, cs, out, neblock, counters);
        if (got < 0) { rc = got; break; }
        if (got != neblock) { rc = ZC_E_SIZE; break; }
      }
      at += cs;
      out += neblock;
    }
    if (rc == 0 && nsplits * neblock != bsize) {
      /* a split block whose size is no multiple of the type (never written) */
      rc = ZC_E_CORRUPT;
    }
    if (rc == 0 && shuffle) unshuffle(ts, bsize, tmp, dst + k * bs);
    BUMP(counters, C_BLOSC_BLOCKS, 1);
  }
  free(tmp);
  return rc;
}

/* The 16-byte header of the memcpyed container of nbytes raw bytes into
 * dst. flags: the shuffle and compressor bits the container names (its bytes
 * are never shuffled). One block: the container holds no block table.
 * Returns the bytes written. */
int64_t zc_blosc_memcpyed(int64_t nbytes, int64_t typesize, int64_t flags, uint8_t *dst,
                          int64_t dstlen) {
  if (!dst || nbytes < 0 || typesize < 1 || typesize > 255) return ZC_E_ARG;
  if (nbytes > 2147483631LL) return ZC_E_ARG;  /* BLOSC_MAX_BUFFERSIZE */
  if (dstlen < 16) return ZC_E_DST;
  int64_t bs = nbytes;
  int64_t cb = nbytes + 16;
  uint8_t h[16] = {2, 1, (uint8_t)((flags & 0xF1) | 0x02), (uint8_t)typesize};
  for (int i = 0; i < 4; i++) {
    h[4 + i] = (uint8_t)(nbytes >> (8 * i));
    h[8 + i] = (uint8_t)(bs >> (8 * i));
    h[12 + i] = (uint8_t)(cb >> (8 * i));
  }
  memcpy(dst, h, 16);
  return 16;
}

/* c-blosc 1's block size for zstd (compute_blocksize, no forced size, no
 * split): 64 KiB scaled by the level, at most the buffer, a multiple of the
 * type. */
int64_t zc_blosc_blocksize(int64_t nbytes, int64_t typesize, int64_t clevel) {
  if (nbytes < typesize) return 1;
  int64_t bs = nbytes;
  if (nbytes >= 32 * 1024) {
    static const int scale[10] = {0, 1, 2, 4, 8, 8, 16, 16, 16, 32};  /* in 32 KiB */
    bs = clevel < 1 ? 16 * 1024 : 32 * 1024 * (int64_t)scale[clevel > 9 ? 9 : clevel];
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

static void shuffle_bytes(int ts, int64_t n, const uint8_t *src, uint8_t *dst) {
  int64_t elems = n / ts;
  if (ts == 2) {
    uint8_t *a = dst, *b = dst + elems;
    for (int64_t i = 0; i < elems; i++) {
      a[i] = src[2 * i];
      b[i] = src[2 * i + 1];
    }
  } else if (ts == 4) {
    uint8_t *a = dst, *b = dst + elems, *c = dst + 2 * elems, *d = dst + 3 * elems;
    for (int64_t i = 0; i < elems; i++) {
      a[i] = src[4 * i];
      b[i] = src[4 * i + 1];
      c[i] = src[4 * i + 2];
      d[i] = src[4 * i + 3];
    }
  } else {
    for (int j = 0; j < ts; j++) {
      uint8_t *d = dst + j * elems;
      for (int64_t i = 0; i < elems; i++) d[i] = src[i * ts + j];
    }
  }
  memcpy(dst + elems * ts, src + elems * ts, (size_t)(n - elems * ts));
}

/* Blocks [first, last) of the blosc 1 container of src[0, nbytes) (blocks
 * of zc_blosc_blocksize) into dst, one after another: each an int32 size and
 * one zstd frame of the block, byte-shuffled first where `shuffle` (in the
 * call's own scratch), or the block's bytes where the frame would not be
 * smaller (c-blosc's raw block). A shuffled block's zstd blocks are its byte
 * planes (at most 128 KiB each), so each plane gets its own literal table.
 * sizes[k - first]: block k's bytes. Returns the bytes written. Calls on
 * disjoint ranges may run at once; zc_blosc_header then writes the header
 * and block starts from the sizes. */
int64_t zc_blosc_encode(const uint8_t *src, int64_t nbytes, int64_t typesize, int64_t shuffle,
                        int64_t clevel, int64_t first, int64_t last, uint8_t *dst, int64_t cap,
                        int64_t *sizes) {
  if (!src || !dst || !sizes || nbytes < 1 || typesize < 1 || typesize > 255 || clevel < 1)
    return ZC_E_ARG;
  if (nbytes > 2147483631LL) return ZC_E_ARG;
  int64_t bs = zc_blosc_blocksize(nbytes, typesize, clevel);
  int64_t nblocks = (nbytes + bs - 1) / bs;
  if (first < 0 || first > last || last > nblocks) return ZC_E_ARG;
  int ts = (int)typesize, shuf = shuffle && ts > 1;
  Enc *e = enc_new((int)clevel);
  uint8_t *tmp = shuf ? (uint8_t *)malloc((size_t)bs) : NULL;
  if (!e || (shuf && !tmp)) {
    enc_free(e);
    free(tmp);
    return ZC_E_NOMEM;
  }
  int64_t o = 0, rc = 0;
  for (int64_t k = first; k < last; k++) {
    int64_t bsize = k == nblocks - 1 ? nbytes - k * bs : bs;
    const uint8_t *blk = src + k * bs;
    int64_t zblock = ZE_BLOCK;
    if (shuf) {
      shuffle_bytes(ts, bsize, blk, tmp);
      blk = tmp;
      if (bsize % ts == 0 && bsize / ts < ZE_BLOCK) zblock = bsize / ts;
    }
    if (cap - o < 4 + bsize) {
      rc = ZC_E_DST;
      break;
    }
    int64_t r = enc_frame(e, blk, bsize, zblock, dst + o + 4, bsize - 1);
    if (r == ZC_E_DST) {
      memcpy(dst + o + 4, blk, (size_t)bsize);
      r = bsize;
    } else if (r < 0) {
      rc = r;
      break;
    }
    st32(dst + o, (uint32_t)r);
    sizes[k - first] = 4 + r;
    o += 4 + r;
  }
  enc_free(e);
  free(tmp);
  return rc < 0 ? rc : o;
}

/* The header and block starts of the container whose blocks (sizes[k]
 * bytes each, as zc_blosc_encode wrote them) follow: version 2, zstd format
 * 1, flags 0x90 (zstd, no split) | 0x01 with byte shuffle, the typesize,
 * nbytes, the block size and the total. Returns the bytes written,
 * 16 + 4 * nblocks. */
int64_t zc_blosc_header(int64_t nbytes, int64_t typesize, int64_t shuffle, int64_t clevel,
                        const int64_t *sizes, int64_t nblocks, uint8_t *dst, int64_t cap) {
  if (!sizes || !dst || nbytes < 1 || typesize < 1 || typesize > 255) return ZC_E_ARG;
  int64_t bs = zc_blosc_blocksize(nbytes, typesize, clevel);
  if (nblocks != (nbytes + bs - 1) / bs) return ZC_E_ARG;
  int64_t head = 16 + 4 * nblocks, at = head;
  if (cap < head) return ZC_E_DST;
  for (int64_t k = 0; k < nblocks; k++) {
    if (at > 2147483647LL) return ZC_E_ARG;
    st32(dst + 16 + 4 * k, (uint32_t)at);
    at += sizes[k];
  }
  if (at > 2147483647LL) return ZC_E_ARG;
  dst[0] = 2;
  dst[1] = 1;
  dst[2] = (uint8_t)(0x90 | (shuffle ? 0x01 : 0));
  dst[3] = (uint8_t)typesize;
  st32(dst + 4, (uint32_t)nbytes);
  st32(dst + 8, (uint32_t)bs);
  st32(dst + 12, (uint32_t)at);
  return head;
}

/* 1 when buf (n bytes) is the item of `item` bytes repeated, else 0. */
int64_t zc_all_equal(const uint8_t *buf, int64_t n, const uint8_t *item, int64_t item_len) {
  if (!buf || !item || item_len < 1 || n % item_len) return ZC_E_ARG;
  if (n == 0) return 1;
  if (memcmp(buf, item, (size_t)item_len)) return 0;
  /* buf[0, k) holds the item repeated: compare doubling prefixes. */
  int64_t k = item_len;
  while (k < n) {
    int64_t m = k < n - k ? k : n - k;
    if (memcmp(buf + k, buf, (size_t)m)) return 0;
    k += m;
  }
  return 1;
}
