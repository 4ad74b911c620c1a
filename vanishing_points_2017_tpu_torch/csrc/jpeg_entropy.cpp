// Entropy coding of JPEG scans, the bit-serial part of data/jpeg.py:
// Huffman sequential scans both ways (ITU-T T.81, Annex F) and the four
// kinds of progressive scan for decoding (Annex G), as libjpeg's jdphuff.c
// reads them; and the arithmetic-coded decoder of both (T.81 Annex D's QM
// decoder, the models of F.1.4 and G.1.3), as libjpeg's jdarith.c reads
// them; and Huffman-coded lossless scans (Annex H) with the undoing of
// their prediction, as libjpeg-turbo's jdlhuff.c and jdpred.c. Everything
// else of the codec (markers, quantisation, DCT, sampling, colour) is
// numpy. Plain C interface, built with g++ at first
// use and bound with ctypes.
//
// A scan is described by its MCU grid and, per component, six int64 values:
// blocks per MCU across and down, the width of the component's block array
// (in blocks), the offset of that array in the coefficient buffer (in
// int16 elements), and its DC and AC table indices. Block (r, c) of a
// component lies at offset + (r * width + c) * 64, coefficients in natural
// (row-major) order. Huffman tables come as the DHT segment's BITS (16
// counts) and HUFFVAL (up to 256 values), four DC tables then four AC
// tables, each padded to 16 + 256 bytes. An arithmetic-coded scan takes the
// DAC conditioning instead: 32 bytes, DC tables 0-15 (U << 4 | L) then AC
// tables 0-15 (K).

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
  ERR_BAD_VALUE = -7,   // a coefficient outside the baseline range
  ERR_ARITH = -8        // an arithmetic-coded value past its range
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

// ------------------------------------------------------ arithmetic decoding

// T.81 Table D.2 per state: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS;
// and a 114th state of fixed probability 1/2 (libjpeg's, for signs and
// refinement bits).
const uint16_t QE[114][4] = {
    {0x5A1D, 1, 1, 1},    {0x2586, 14, 2, 0},   {0x1114, 16, 3, 0},
    {0x080B, 18, 4, 0},   {0x03D8, 20, 5, 0},   {0x01DA, 23, 6, 0},
    {0x00E5, 25, 7, 0},   {0x006F, 28, 8, 0},   {0x0036, 30, 9, 0},
    {0x001A, 33, 10, 0},  {0x000D, 35, 11, 0},  {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},  {0x0001, 12, 13, 0},  {0x5A7F, 15, 15, 1},
    {0x3F25, 36, 16, 0},  {0x2CF2, 38, 17, 0},  {0x207C, 39, 18, 0},
    {0x17B9, 40, 19, 0},  {0x1182, 42, 20, 0},  {0x0CEF, 43, 21, 0},
    {0x09A1, 45, 22, 0},  {0x072F, 46, 23, 0},  {0x055C, 48, 24, 0},
    {0x0406, 49, 25, 0},  {0x0303, 51, 26, 0},  {0x0240, 52, 27, 0},
    {0x01B1, 54, 28, 0},  {0x0144, 56, 29, 0},  {0x00F5, 57, 30, 0},
    {0x00B7, 59, 31, 0},  {0x008A, 60, 32, 0},  {0x0068, 62, 33, 0},
    {0x004E, 63, 34, 0},  {0x003B, 32, 35, 0},  {0x002C, 33, 9, 0},
    {0x5AE1, 37, 37, 1},  {0x484C, 64, 38, 0},  {0x3A0D, 65, 39, 0},
    {0x2EF1, 67, 40, 0},  {0x261F, 68, 41, 0},  {0x1F33, 69, 42, 0},
    {0x19A8, 70, 43, 0},  {0x1518, 72, 44, 0},  {0x1177, 73, 45, 0},
    {0x0E74, 74, 46, 0},  {0x0BFB, 75, 47, 0},  {0x09F8, 77, 48, 0},
    {0x0861, 78, 49, 0},  {0x0706, 79, 50, 0},  {0x05CD, 48, 51, 0},
    {0x04DE, 50, 52, 0},  {0x040F, 50, 53, 0},  {0x0363, 51, 54, 0},
    {0x02D4, 52, 55, 0},  {0x025C, 53, 56, 0},  {0x01F8, 54, 57, 0},
    {0x01A4, 55, 58, 0},  {0x0160, 56, 59, 0},  {0x0125, 57, 60, 0},
    {0x00F6, 58, 61, 0},  {0x00CB, 59, 62, 0},  {0x00AB, 61, 63, 0},
    {0x008F, 61, 32, 0},  {0x5B12, 65, 65, 1},  {0x4D04, 80, 66, 0},
    {0x412C, 81, 67, 0},  {0x37D8, 82, 68, 0},  {0x2FE8, 83, 69, 0},
    {0x293C, 84, 70, 0},  {0x2379, 86, 71, 0},  {0x1EDF, 87, 72, 0},
    {0x1AA9, 87, 73, 0},  {0x174E, 72, 74, 0},  {0x1424, 72, 75, 0},
    {0x119C, 74, 76, 0},  {0x0F6B, 74, 77, 0},  {0x0D51, 75, 78, 0},
    {0x0BB6, 77, 79, 0},  {0x0A40, 77, 48, 0},  {0x5832, 80, 81, 1},
    {0x4D1C, 88, 82, 0},  {0x438E, 89, 83, 0},  {0x3BDD, 90, 84, 0},
    {0x34EE, 91, 85, 0},  {0x2EAE, 92, 86, 0},  {0x299A, 93, 87, 0},
    {0x2516, 86, 71, 0},  {0x5570, 88, 89, 1},  {0x4CA9, 95, 90, 0},
    {0x44D9, 96, 91, 0},  {0x3E22, 97, 92, 0},  {0x3824, 99, 93, 0},
    {0x32B4, 99, 94, 0},  {0x2E17, 93, 86, 0},  {0x56A8, 95, 96, 1},
    {0x4F46, 101, 97, 0}, {0x47E5, 102, 98, 0}, {0x41CF, 103, 99, 0},
    {0x3C3D, 104, 100, 0}, {0x375E, 99, 93, 0}, {0x5231, 105, 102, 0},
    {0x4C0F, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415E, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50E7, 108, 107, 0}, {0x4B85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504F, 111, 107, 0}, {0x5A10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59EB, 112, 111, 1}, {0x5A1D, 113, 113, 0}};
const uint8_t FIXED_STATE = 113;

// The QM decoder (D.2), C and A registers and the bit counter as libjpeg
// keeps them. A statistics bin is one byte: the state in its low 7 bits,
// the more probable symbol in its top bit. Past a marker, or the end of
// the buffer, zero bytes are read, as T.81 has it.
struct ArithDecoder {
  const uint8_t* data;
  int64_t size, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;          // -16: the two first bytes are still to be read
  bool marker = false;   // `pos` is at a marker

  ArithDecoder(const uint8_t* d, int64_t n) : data(d), size(n) {}

  int next_byte() {
    if (marker || pos >= size) return 0;
    uint8_t b = data[pos];
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    int64_t q = pos + 1;
    while (q < size && data[q] == 0xFF) ++q;  // fill bytes
    if (q < size && data[q] == 0x00) {
      pos = q + 1;  // a stuffed zero: the data byte 0xFF
      return 0xFF;
    }
    marker = true;
    return 0;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // both first bytes in
      }
      a <<= 1;
    }
    int sv = *st;
    const uint16_t* q = QE[sv & 0x7F];
    int64_t qe = q[0];
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // the more probable symbol, exchanged
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ q[2]);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ (q[1] | q[3] << 7));
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // the less probable symbol, exchanged
        *st = (uint8_t)((sv & 0x80) ^ (q[1] | q[3] << 7));
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ q[2]);
      }
    }
    return sv >> 7;
  }

  // libjpeg's next_marker from where the decoder stopped (skipping data
  // it left unread and stuffed zeros), which must be RSTm; the decoder
  // then starts afresh.
  bool restart(int m) {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      int64_t q = pos;
      while (q < size && data[q] == 0xFF) ++q;
      if (q >= size) return false;
      if (data[q] != 0x00) {
        if (data[q] != 0xD0 + m) return false;
        pos = q + 1;
        break;
      }
      pos = q + 1;
    }
    c = a = 0;
    ct = -16;
    marker = false;
    return true;
  }
};

// The value of a nonzero DC difference or AC coefficient given its first
// decision bin `st` (F.1.4.3.1: sign done; the magnitude category from
// `st`, then from the X bins at `x`; the bits below the top one 14 bins
// further). `ac`: the category's second decision is taken at `st` again.
// Returns |v| - 1, or -1 past 15 bits.
int arith_magnitude(ArithDecoder& d, uint8_t* st, uint8_t* x, bool ac) {
  int m = d.decode(st);
  if (m && (!ac || d.decode(st))) {
    if (ac) m <<= 1;
    st = x;
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) return -1;
      ++st;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  return v;
}

// A DC difference (F.1.4.1, the conditioning of F.1.4.4.1): into `diff`;
// false on a magnitude past 15 bits.
bool arith_dc(ArithDecoder& d, uint8_t* stats, int& ctx, int cond,
              int32_t& diff) {
  uint8_t* st = stats + ctx;
  if (d.decode(st) == 0) {
    ctx = 0;
    diff = 0;
    return true;
  }
  int sign = d.decode(st + 1);
  uint8_t* sp = st + 2 + sign;
  int v = arith_magnitude(d, sp, stats + 20, false);
  if (v < 0) return false;
  int m = 1;
  while (m <= v >> 1) m <<= 1;
  if (!v) m = 0;
  int lo = cond & 15, hi = cond >> 4;
  if (m < (1 << lo) >> 1)
    ctx = 0;
  else if (m > (1 << hi) >> 1)
    ctx = 12 + 4 * sign;
  else
    ctx = 4 + 4 * sign;
  diff = sign ? -(v + 1) : v + 1;
  return true;
}

// AC coefficients ss..se of one block (F.1.4.2, G.1.3.2), values shifted
// up by al.
bool arith_ac_first(ArithDecoder& d, uint8_t* stats, uint8_t* fixed, int kx,
                    int ss, int se, int al, int16_t* blk) {
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (d.decode(st)) break;  // end of block
    while (d.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) return false;
    }
    int sign = d.decode(fixed);
    int v = arith_magnitude(d, st + 2, stats + (k <= kx ? 189 : 217), true);
    if (v < 0) return false;
    v += 1;
    blk[ZIGZAG[k]] = (int16_t)((uint32_t)(sign ? -v : v) << al);
  }
  return true;
}

// An AC refinement of one block (G.1.3.3): a correction bit for each
// coefficient already nonzero, new coefficients of +-(1 << al), the
// end-of-block decision only past the last coefficient already nonzero.
bool arith_ac_refine(ArithDecoder& d, uint8_t* stats, uint8_t* fixed, int ss,
                     int se, int al, int16_t* blk) {
  const int p1 = 1 << al, m1 = -p1;
  int kex = se;
  while (kex > 0 && !blk[ZIGZAG[kex]]) --kex;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && d.decode(st)) break;  // end of block
    for (;;) {
      int16_t* c = blk + ZIGZAG[k];
      if (*c) {
        if (d.decode(st + 2)) *c = (int16_t)(*c + (*c < 0 ? m1 : p1));
        break;
      }
      if (d.decode(st + 1)) {
        *c = (int16_t)(d.decode(fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return false;
    }
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

// Decode one arithmetic-coded scan (sequential when `progressive` is 0,
// the band then 0..63; else one progressive scan as for the Huffman
// entry). `conditioning`: the DAC values, see the top of the file. The
// statistics and, for a DC first or sequential scan, the predictions are
// reset at the start and at every restart marker. Returns the bytes used
// (up to the marker after the scan or where the decoder stopped reading),
// or a negative error code.
int64_t jpeg_decode_scan_arith(const uint8_t* data, int64_t size, int ncomp,
                               const int64_t* layout, int64_t mcus_x,
                               int64_t mcus_y, int restart_interval,
                               const uint8_t* conditioning, int progressive,
                               int ss, int se, int ah, int al,
                               int16_t* coefs) {
  Component comp[4];
  for (int c = 0; c < ncomp; ++c) {
    std::memcpy(&comp[c], layout + 6 * c, sizeof(Component));
    if (comp[c].dc < 0 || comp[c].dc > 15 || comp[c].ac < 0 ||
        comp[c].ac > 15)
      return ERR_NO_TABLE;
  }
  const bool dc_first = !progressive || (ss == 0 && ah == 0);
  const bool ac = !progressive || ss > 0;
  // per table 64 DC bins and 256 AC bins; the fixed-probability bin
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed = FIXED_STATE;
  int32_t pred[4];
  int ctx[4];
  auto reset = [&]() {
    for (int c = 0; c < ncomp; ++c) {
      if (dc_first) {
        std::memset(dc_stats[comp[c].dc], 0, 64);
        pred[c] = ctx[c] = 0;
      }
      if (ac) std::memset(ac_stats[comp[c].ac], 0, 256);
    }
  };
  reset();
  ArithDecoder d(data, size);
  int64_t todo = restart_interval;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval && todo == 0) {
        if (!d.restart(next_rst)) return ERR_RESTART;
        next_rst = (next_rst + 1) & 7;
        todo = restart_interval;
        reset();
      }
      --todo;
      for (int c = 0; c < ncomp; ++c) {
        const Component& k = comp[c];
        uint8_t* acs = ac_stats[k.ac];
        const int kx = conditioning[16 + k.ac];
        for (int64_t by = 0; by < k.vs; ++by) {
          for (int64_t bx = 0; bx < k.hs; ++bx) {
            int16_t* blk = coefs + k.offset +
                           ((my * k.vs + by) * k.width + mx * k.hs + bx) * 64;
            bool ok = true;
            if (dc_first) {
              int32_t diff = 0;
              ok = arith_dc(d, dc_stats[k.dc], ctx[c], conditioning[k.dc],
                            diff);
              pred[c] += diff;
              blk[0] = (int16_t)((uint32_t)pred[c] << al);
              if (ok && !progressive)
                ok = arith_ac_first(d, acs, &fixed, kx, 1, 63, 0, blk);
            } else if (ss == 0) {
              if (d.decode(&fixed)) blk[0] = (int16_t)(blk[0] | (1 << al));
            } else if (ah == 0) {
              ok = arith_ac_first(d, acs, &fixed, kx, ss, se, al, blk);
            } else {
              ok = arith_ac_refine(d, acs, &fixed, ss, se, al, blk);
            }
            if (!ok) return ERR_ARITH;
          }
        }
      }
    }
  }
  return d.pos;
}

// Decode one lossless scan (T.81 Annex H, Huffman coded): per MCU and per
// component hs x vs samples (one for a scan of one component), each a
// difference coded as a DC one is (categories 0-16; 16 means 32768 and
// sends no bits). The differences go to `diffs` as int16 (mod 2^16, as
// the undifferencing takes them), laid out as a sequential scan's blocks
// with blocks of one sample. Returns the bytes used or an error code.
int64_t jpeg_decode_scan_lossless(const uint8_t* data, int64_t size,
                                  int ncomp, const int64_t* layout,
                                  int64_t mcus_x, int64_t mcus_y,
                                  int restart_interval, const uint8_t* tables,
                                  int16_t* diffs) {
  DecodeTable dc[4], ac[4];
  Component comp[4];
  if (!scan_setup(tables, ncomp, layout, true, false, dc, ac, comp))
    return ERR_NO_TABLE;
  BitReader br(data, size);
  int64_t todo = restart_interval;
  int next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval && todo == 0) {
        if (!br.restart(next_rst)) return ERR_RESTART;
        next_rst = (next_rst + 1) & 7;
        todo = restart_interval;
      }
      --todo;
      for (int c = 0; c < ncomp; ++c) {
        const Component& k = comp[c];
        for (int64_t by = 0; by < k.vs; ++by) {
          for (int64_t bx = 0; bx < k.hs; ++bx) {
            int s = decode_symbol(br, dc[k.dc]);
            if (s < 0 || s > 16) return ERR_BAD_CODE;
            int32_t diff = s == 16 ? 32768 : extend(br.receive(s), s);
            diffs[k.offset + (my * k.vs + by) * k.width + mx * k.hs + bx] =
                (int16_t)(uint16_t)diff;
          }
        }
        if (br.starved > 16) return ERR_TRUNCATED;
      }
    }
  }
  return br.pos;
}

// Undo a lossless component's prediction (H.1.2.1, libjpeg-turbo's
// jdpred.c): `rows` x `width` differences (row stride `stride`) -> samples
// (mod 2^16, then shifted up by the point transform `pt`, the low 8 bits
// kept). A row marked in `first` (the first after the scan's start or a
// restart, as libjpeg-turbo's iMCU rows place it) predicts from the left
// alone, its first sample from `initial`; every other row's first sample
// from the one above, the rest by `predictor` (1-7).
void jpeg_undifference(const int16_t* diffs, int64_t stride, int64_t rows,
                       int64_t width, int predictor, int initial, int pt,
                       const uint8_t* first, uint8_t* out) {
  int32_t* prev = new int32_t[width];
  int32_t* cur = new int32_t[width];
  for (int64_t r = 0; r < rows; ++r) {
    const int16_t* d = diffs + r * stride;
    if (first[r]) {
      int32_t ra = initial;
      for (int64_t x = 0; x < width; ++x)
        cur[x] = ra = (int32_t)(((uint16_t)d[x] + ra) & 0xFFFF);
    } else {
      int32_t rb = prev[0];
      int32_t ra = (int32_t)(((uint16_t)d[0] + rb) & 0xFFFF);
      cur[0] = ra;
      for (int64_t x = 1; x < width; ++x) {
        int32_t rc = rb, p = 0;
        rb = prev[x];
        switch (predictor) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        cur[x] = ra = (int32_t)(((uint16_t)d[x] + p) & 0xFFFF);
      }
    }
    for (int64_t x = 0; x < width; ++x)
      out[r * width + x] = (uint8_t)(cur[x] << pt);
    int32_t* t = prev;
    prev = cur;
    cur = t;
  }
  delete[] prev;
  delete[] cur;
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
