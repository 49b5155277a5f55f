/*
 * The chunk codec of the port's zarr engine (io/chunkstore.py): the blosc 1
 * container around zstd, decoded here and called through ctypes.
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
 *
 * Every entry point checks its bounds and returns a negative ZC_E* code on
 * bad input; none reads or writes past a buffer it was given. Blocks of one
 * container are independent, so the caller decodes ranges of them on
 * several threads at once (ctypes releases the GIL). Counters of the modes
 * a decode took are added into an int64 array the caller passes (or NULL).
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

static int highbit32(uint32_t v) {  /* v > 0 */
  int n = 0;
  while (v >>= 1) n++;
  return n;
}

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
