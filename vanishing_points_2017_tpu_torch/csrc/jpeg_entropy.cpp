// Huffman entropy coding of JPEG scans, the bit-serial part of data/jpeg.py:
// sequential scans both ways (ITU-T T.81, Annex F) and the four kinds of
// progressive scan for decoding (Annex G), as libjpeg's jdphuff.c reads
// them. Everything else of the codec (markers, quantisation, DCT, sampling,
// colour) is numpy. Plain C interface, built with g++ at first use and
// bound with ctypes.
//
// A scan is described by its MCU grid and, per component, six int64 values:
// blocks per MCU across and down, the width of the component's block array
// (in blocks), the offset of that array in the coefficient buffer (in
// int16 elements), and its DC and AC table indices. Block (r, c) of a
// component lies at offset + (r * width + c) * 64, coefficients in natural
// (row-major) order. Huffman tables come as the DHT segment's BITS (16
// counts) and HUFFVAL (up to 256 values), four DC tables then four AC
// tables, each padded to 16 + 256 bytes.

#include <cstdint>
#include <cstring>

namespace {

const int ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ZIGZAG with 16 more entries of 63: a run that overshoots the band in a
// progressive scan writes where libjpeg's padded jpeg_natural_order does
const int NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int TABLE_BYTES = 16 + 256;

enum {
  ERR_TRUNCATED = -1,   // the data ended inside the scan
  ERR_BAD_CODE = -2,    // a bit string that is no Huffman code
  ERR_BAD_COEF = -3,    // a run past the 64th coefficient
  ERR_RESTART = -4,     // a restart marker missing or out of sequence
  ERR_NO_TABLE = -5,    // a component names a table that was not defined
  ERR_OVERFLOW = -6,    // the output buffer is too small
  ERR_BAD_VALUE = -7    // a coefficient outside the baseline range
};

struct Component {
  int64_t hs, vs, width, offset, dc, ac;
};

// ---------------------------------------------------------------- decoding

struct DecodeTable {
  bool defined = false;
  int32_t mincode[17], maxcode[18], valptr[17];
  uint8_t vals[256];
};

void build_decode_table(const uint8_t* spec, DecodeTable* t) {
  int total = 0;
  for (int i = 0; i < 16; ++i) total += spec[i];
  t->defined = total > 0 && total <= 256;
  if (!t->defined) return;
  std::memcpy(t->vals, spec + 16, 256);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = spec[len - 1];
    t->valptr[len] = k;
    t->mincode[len] = code;
    code += n;
    k += n;
    t->maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
}

struct BitReader {
  const uint8_t* data;
  int64_t size, pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool marker = false;  // the next bytes are a marker: feed zero bits

  BitReader(const uint8_t* d, int64_t n) : data(d), size(n) {}

  // One bit; after the scan's data ran out (a marker or the end of the
  // buffer) zero bits are returned and `starved` counts them.
  int64_t starved = 0;
  int bit() {
    if (nbits == 0) {
      uint8_t b = 0;
      if (!marker && pos < size) {
        b = data[pos];
        if (b == 0xFF) {
          if (pos + 1 < size && data[pos + 1] == 0x00) {
            pos += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      } else {
        marker = true;
      }
      if (marker) starved += 8;
      acc = b;
      nbits = 8;
    }
    --nbits;
    return (acc >> nbits) & 1;
  }

  int32_t receive(int n) {
    int32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  // Drop the bits left in the current byte and take the marker RSTm.
  bool restart(int m) {
    nbits = 0;
    marker = false;
    starved = 0;
    while (pos < size && data[pos] == 0xFF && pos + 1 < size &&
           data[pos + 1] == 0xFF)
      ++pos;  // fill bytes
    if (pos + 1 >= size || data[pos] != 0xFF || data[pos + 1] != 0xD0 + m)
      return false;
    pos += 2;
    return true;
  }
};

inline int32_t extend(int32_t v, int n) {
  return (n && v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

int decode_symbol(BitReader& br, const DecodeTable& t) {
  int32_t code = 0;
  for (int len = 1; len <= 16; ++len) {
    code = (code << 1) | br.bit();
    if (t.maxcode[len] >= 0 && code <= t.maxcode[len] &&
        code >= t.mincode[len])
      return t.vals[t.valptr[len] + code - t.mincode[len]];
  }
  return -1;
}

// The scan's Huffman tables, and a check that every component of the scan
// names defined ones (`need_dc`, `need_ac`: which of the two it reads).
bool scan_setup(const uint8_t* tables, int ncomp, const int64_t* layout,
                bool need_dc, bool need_ac, DecodeTable* dc, DecodeTable* ac,
                Component* comp) {
  for (int i = 0; i < 4; ++i) {
    build_decode_table(tables + i * TABLE_BYTES, &dc[i]);
    build_decode_table(tables + (4 + i) * TABLE_BYTES, &ac[i]);
  }
  for (int c = 0; c < ncomp; ++c) {
    std::memcpy(&comp[c], layout + 6 * c, sizeof(Component));
    if (need_dc && (comp[c].dc < 0 || comp[c].dc > 3 || !dc[comp[c].dc].defined))
      return false;
    if (need_ac && (comp[c].ac < 0 || comp[c].ac > 3 || !ac[comp[c].ac].defined))
      return false;
  }
  return true;
}

// One block of an AC first scan over the band ss..se (jdphuff.c's
// decode_mcu_AC_first): values shifted up by al; an EOBn symbol starts a
// run of end-of-bands that spans the following blocks.
bool ac_first(BitReader& br, const DecodeTable& t, int ss, int se, int al,
              int64_t& eobrun, int16_t* blk) {
  if (eobrun > 0) {
    --eobrun;
    return true;
  }
  for (int k = ss; k <= se; ++k) {
    int rs = decode_symbol(br, t);
    if (rs < 0) return false;
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int32_t v = extend(br.receive(s), s);
      blk[NATURAL[k]] = (int16_t)((uint32_t)v << al);
    } else if (r == 15) {
      k += 15;  // sixteen zeros
    } else {
      eobrun = (int64_t(1) << r) + br.receive(r) - 1;
      break;
    }
  }
  return true;
}

// One block of an AC refinement scan (decode_mcu_AC_refine): a correction
// bit for every coefficient already nonzero as the walk passes it, a zero
// run that counts only zero coefficients, new coefficients of +-(1 << al).
// A symbol's size other than 0 or 1 is only a warning in libjpeg and is
// read as 1. Within an end-of-band run, the block takes correction bits
// only.
bool ac_refine(BitReader& br, const DecodeTable& t, int ss, int se, int al,
               int64_t& eobrun, int16_t* blk) {
  const int p1 = 1 << al, m1 = -p1;
  int k = ss;
  auto correct = [&](int16_t* c) {
    if (br.bit() && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
  };
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = decode_symbol(br, t);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15, v = 0;
      if (s) {
        v = br.bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun = int64_t(1) << r;
        if (r) eobrun += br.receive(r);
        break;  // the rest of the band is the run's
      }
      do {
        int16_t* c = blk + NATURAL[k];
        if (*c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;  // the zero the new coefficient takes
        }
        ++k;
      } while (k <= se);
      if (v) blk[NATURAL[k]] = (int16_t)v;
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* c = blk + NATURAL[k];
      if (*c != 0) correct(c);
    }
    --eobrun;
  }
  return true;
}

// ---------------------------------------------------------------- encoding

struct EncodeTable {
  bool defined = false;
  uint16_t code[256];
  uint8_t size[256];
};

void build_encode_table(const uint8_t* spec, EncodeTable* t) {
  std::memset(t->size, 0, sizeof t->size);
  int total = 0;
  for (int i = 0; i < 16; ++i) total += spec[i];
  t->defined = total > 0 && total <= 256;
  if (!t->defined) return;
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < spec[len - 1]; ++i, ++k) {
      t->code[spec[16 + k]] = (uint16_t)code++;
      t->size[spec[16 + k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool full = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  void byte(uint8_t b) {
    if (pos >= cap) {
      full = true;
      return;
    }
    out[pos++] = b;
  }

  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0x00);
      nbits -= 8;
    }
  }

  // Pad the last byte with one bits, as the standard asks.
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
};

inline int bit_length(int32_t v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Decode one scan. Returns the number of bytes of `data` the scan used
// (the position of the marker after it), or a negative error code.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t size, int ncomp,
                         const int64_t* layout, int64_t mcus_x,
                         int64_t mcus_y, int restart_interval,
                         const uint8_t* tables, int16_t* coefs) {
  DecodeTable dc[4], ac[4];
  Component comp[4];
  if (!scan_setup(tables, ncomp, layout, true, true, dc, ac, comp))
    return ERR_NO_TABLE;
  BitReader br(data, size);
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t todo = restart_interval;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval && todo == 0) {
        if (!br.restart(next_rst)) return ERR_RESTART;
        next_rst = (next_rst + 1) & 7;
        todo = restart_interval;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      --todo;
      for (int c = 0; c < ncomp; ++c) {
        const Component& k = comp[c];
        for (int64_t by = 0; by < k.vs; ++by) {
          for (int64_t bx = 0; bx < k.hs; ++bx) {
            int16_t* blk = coefs + k.offset +
                           ((my * k.vs + by) * k.width + mx * k.hs + bx) * 64;
            int s = decode_symbol(br, dc[k.dc]);
            if (s < 0 || s > 11) return ERR_BAD_CODE;
            pred[c] += extend(br.receive(s), s);
            blk[0] = (int16_t)pred[c];
            for (int i = 1; i < 64;) {
              int rs = decode_symbol(br, ac[k.ac]);
              if (rs < 0) return ERR_BAD_CODE;
              int r = rs >> 4, n = rs & 15;
              if (n == 0) {
                if (r != 15) break;  // end of block
                i += 16;
                continue;
              }
              i += r;
              if (i > 63) return ERR_BAD_COEF;
              blk[ZIGZAG[i++]] = (int16_t)extend(br.receive(n), n);
            }
            if (br.starved > 16) return ERR_TRUNCATED;
          }
        }
      }
    }
  }
  return br.pos;
}

// Decode one scan of a progressive frame into the coefficients the earlier
// scans left (T.81 G.1.2; libjpeg's jdphuff.c): ss == 0 is a DC scan (first
// when ah == 0, else one refinement bit per block), over one component or
// interleaved; ss > 0 an AC scan of one component over the band ss..se,
// first when ah == 0, else the correction-bit pass. Values are scaled by
// 1 << al. Restart markers reset the DC predictions and the end-of-band
// run. The scan parameters are checked by the caller. Returns the bytes
// used, or a negative error code.
int64_t jpeg_decode_scan_progressive(const uint8_t* data, int64_t size,
                                     int ncomp, const int64_t* layout,
                                     int64_t mcus_x, int64_t mcus_y,
                                     int restart_interval,
                                     const uint8_t* tables, int ss, int se,
                                     int ah, int al, int16_t* coefs) {
  DecodeTable dc[4], ac[4];
  Component comp[4];
  if (!scan_setup(tables, ncomp, layout, ss == 0 && ah == 0, ss > 0, dc, ac,
                  comp))
    return ERR_NO_TABLE;
  BitReader br(data, size);
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0, todo = restart_interval;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval && todo == 0) {
        if (!br.restart(next_rst)) return ERR_RESTART;
        next_rst = (next_rst + 1) & 7;
        todo = restart_interval;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      --todo;
      for (int c = 0; c < ncomp; ++c) {
        const Component& k = comp[c];
        for (int64_t by = 0; by < k.vs; ++by) {
          for (int64_t bx = 0; bx < k.hs; ++bx) {
            int16_t* blk = coefs + k.offset +
                           ((my * k.vs + by) * k.width + mx * k.hs + bx) * 64;
            bool ok = true;
            if (ss == 0 && ah == 0) {
              int s = decode_symbol(br, dc[k.dc]);
              if (s < 0 || s > 15) return ERR_BAD_CODE;
              pred[c] += extend(br.receive(s), s);
              blk[0] = (int16_t)((uint32_t)pred[c] << al);
            } else if (ss == 0) {
              if (br.bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
            } else if (ah == 0) {
              ok = ac_first(br, ac[k.ac], ss, se, al, eobrun, blk);
            } else {
              ok = ac_refine(br, ac[k.ac], ss, se, al, eobrun, blk);
            }
            if (!ok) return ERR_BAD_CODE;
            if (br.starved > 16) return ERR_TRUNCATED;
          }
        }
      }
    }
  }
  return br.pos;
}

// Encode one scan into `out` (at most `cap` bytes). Returns the number of
// bytes written or a negative error code.
int64_t jpeg_encode_scan(const int16_t* coefs, int ncomp,
                         const int64_t* layout, int64_t mcus_x,
                         int64_t mcus_y, int restart_interval,
                         const uint8_t* tables, uint8_t* out, int64_t cap) {
  EncodeTable dc[4], ac[4];
  for (int i = 0; i < 4; ++i) {
    build_encode_table(tables + i * TABLE_BYTES, &dc[i]);
    build_encode_table(tables + (4 + i) * TABLE_BYTES, &ac[i]);
  }
  Component comp[4];
  for (int c = 0; c < ncomp; ++c) {
    std::memcpy(&comp[c], layout + 6 * c, sizeof(Component));
    if (comp[c].dc < 0 || comp[c].dc > 3 || comp[c].ac < 0 ||
        comp[c].ac > 3 || !dc[comp[c].dc].defined || !ac[comp[c].ac].defined)
      return ERR_NO_TABLE;
  }
  BitWriter bw(out, cap);
  int32_t pred[4] = {0, 0, 0, 0};
  int64_t todo = restart_interval;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval && todo == 0) {
        bw.flush();
        bw.byte(0xFF);
        bw.byte((uint8_t)(0xD0 + next_rst));
        next_rst = (next_rst + 1) & 7;
        todo = restart_interval;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      --todo;
      for (int c = 0; c < ncomp; ++c) {
        const Component& k = comp[c];
        const EncodeTable& tdc = dc[k.dc];
        const EncodeTable& tac = ac[k.ac];
        for (int64_t by = 0; by < k.vs; ++by) {
          for (int64_t bx = 0; bx < k.hs; ++bx) {
            const int16_t* blk =
                coefs + k.offset +
                ((my * k.vs + by) * k.width + mx * k.hs + bx) * 64;
            int32_t diff = blk[0] - pred[c];
            pred[c] = blk[0];
            int32_t mag = diff < 0 ? -diff : diff;
            int n = bit_length(mag);
            if (n > 11 || !tdc.size[n]) return ERR_BAD_VALUE;
            bw.put(tdc.code[n], tdc.size[n]);
            if (n) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
            int run = 0;
            for (int i = 1; i < 64; ++i) {
              int32_t v = blk[ZIGZAG[i]];
              if (v == 0) {
                ++run;
                continue;
              }
              while (run > 15) {
                if (!tac.size[0xF0]) return ERR_BAD_VALUE;
                bw.put(tac.code[0xF0], tac.size[0xF0]);
                run -= 16;
              }
              mag = v < 0 ? -v : v;
              n = bit_length(mag);
              int rs = (run << 4) | n;
              if (n > 10 || !tac.size[rs]) return ERR_BAD_VALUE;
              bw.put(tac.code[rs], tac.size[rs]);
              bw.put((uint32_t)(v < 0 ? v - 1 : v), n);
              run = 0;
            }
            if (run) {
              if (!tac.size[0]) return ERR_BAD_VALUE;
              bw.put(tac.code[0], tac.size[0]);
            }
            if (bw.full) return ERR_OVERFLOW;
          }
        }
      }
    }
  }
  bw.flush();
  return bw.full ? ERR_OVERFLOW : bw.pos;
}

}  // extern "C"
