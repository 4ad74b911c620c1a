// The bit-serial and per-block work of data/webp.py: WebP's two codecs.
//
// * VP8 key frames (lossy, RFC 6386) to Y, U and V planes: the boolean
//   decoder, the frame header, 1-8 token partitions, the coefficient
//   tokens with their contexts, dequantisation, the inverse WHT and DCT,
//   the intra predictors and the simple and normal loop filters, in the
//   order and with the edge rules libwebp uses (its output is the
//   reference: the codec's decode is exact, so every bit must match).
// * libwebp's RGB output of those planes: "fancy" upsampling of the
//   chroma and its 14-bit fixed-point YUV -> RGB.
// * VP8L (lossless) to ARGB: prefix codes (normal, simple and one-symbol),
//   meta codes, LZ77 with the 120-entry distance map, the colour cache and
//   the four transforms.
//
// Plain C entry points for ctypes. An error returns a negative code that
// data/webp.py names; nothing is written past the caller's buffers. The
// optional `stats` array counts the coding tools a stream uses (the tests'
// coverage record).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ tables

// RFC 6386 section 14.1: dequantisation factors by quantiser index
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148,
    151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146,
    149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254,
    259, 264, 269, 274, 279, 284};

// RFC 6386 section 13.5: the default coefficient probabilities
// [type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189,
    129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214,
    209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128,
    128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134,
    202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255,
    128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128,
    128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251,
    255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255,
    255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255,
    238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128,
    128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177,
    135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194,
    224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162,
    160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68,
    47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221,
    224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128,
    128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232,
    253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255,
    202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1,
    200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231,
    245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128,
    128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136,
    225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161,
    255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128,
    128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181,
    251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255, 236, 231, 255,
    255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213,
    255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128,
    128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248,
    251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249,
    198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1,
    95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211,
    209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128,
    128, 128, 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219,
    255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255,
    228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255,
    255, 128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128,
    128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149,
    1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134, 252,
    255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128,
    128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126,
    38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151,
    178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255,
    255, 128, 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77,
    162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199,
    249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255,
    128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249,
    219, 240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171,
    128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81,
    230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196,
    255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128,
    128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246,
    252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255,
    255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240,
    162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255,
    128, 128, 128, 128, 128, 128, 128, 128,
};

// RFC 6386 section 13.4: the probabilities that a coefficient probability
// is updated in the frame header
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223,
    241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255,
    255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255,
    255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253,
    255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254,
    255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253,
    253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255,
    255, 255, 255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248,
    254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255,
    255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255,
};

// RFC 6386 section 11.5: key-frame 4x4 mode probabilities [above][left]
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46,
    70, 95, 175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189,
    17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26,
    62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19,
    136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11,
    96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72,
    187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234,
    128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166, 49,
    23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27, 217, 255,
    87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183,
    21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88, 147, 150, 42,
    46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39, 53, 200, 87,
    26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77, 39, 28, 85,
    171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54,
    32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19,
    21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193,
    101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18,
    111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209,
    10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67,
    45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255,
    128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168,
    209, 192, 23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58,
    169, 82, 115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40,
    21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46,
    17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65,
    32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6, 223, 87,
    37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64,
    90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30,
    34, 26, 133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205, 45, 37,
    192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88, 104, 85, 117,
    175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128,
    81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73,
    26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255,
    166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102, 102,
    213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34,
    53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1,
    47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154,
    100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9,
    64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1, 56, 8, 17, 132,
    137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31,
    137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40,
    64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45,
    16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213, 83,
    12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20,
    32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85,
    37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55,
    70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62,
    219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12,
    61, 195, 128, 48, 4, 24,
};

// coefficient index -> band, with a 17th entry for the position past the
// last coefficient
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
// zigzag position -> raster index in a 4x4 block
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
// the fixed probabilities of the DCT_CAT3..6 extra bits (0-terminated)
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// intra modes, in libwebp's order (the 4x4 probabilities above are indexed
// by it); the 16x16 and chroma modes are DC, TM, V (=VE) and H (=HE)
enum {
  B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
  DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT
};

// VP8 error codes (data/webp.py names them)
enum {
  E_HEADER = -1,      // frame tag or start code
  E_NOT_KEY = -2,     // an inter frame
  E_PART0 = -3,       // partition 0 longer than the data
  E_SEGMENT = -4,     // data ends in the segment header
  E_FILTER = -5,      // data ends in the filter header
  E_PARTITIONS = -6,  // the partition sizes overrun the data
  E_MODES = -7,       // data ends in partition 0's modes
  E_TOKENS = -8,      // data ends in a token partition
  E_SIZE = -9,        // frame size differs from the caller's
};

// coverage counters of a VP8 frame (data/webp.py names them)
enum {
  S_I16 = 0,         // 4 16x16 modes: DC, TM, V, H
  S_I4 = 4,          // 10 4x4 modes in libwebp's order
  S_UV = 14,         // 4 chroma modes
  S_SIMPLE = 18, S_NORMAL, S_NOFILTER,
  S_PARTS = 21,      // 1, 2, 4, 8 partitions
  S_SEGMENTS = 25, S_SEGMENT_MAP, S_SKIP_PROBA, S_NO_SKIP_PROBA, S_SKIPPED,
  S_PROBA_UPDATES, S_LF_DELTA, S_SHARPNESS, S_I4_MB, S_I16_MB,
  S_VP8_END
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------- boolean decoder

// RFC 6386 section 7 in libwebp's form: `range` holds range - 1, `value`
// the bits read so far and `bits` how many lie below the 8-bit window.
// Reading past the last byte appends zero bytes and sets `eof`, which the
// decoder checks where libwebp checks it.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int b;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int literal(int n) {  // n bits at probability 1/2, most significant first
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_literal(int n) {  // magnitude, then the sign
    const int v = literal(n);
    return bit(0x80) ? -v : v;
  }
};

// ------------------------------------------------------------ transforms

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// inverse DCT of one 4x4 block (raster order), added to dst
void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * stride;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

// inverse Walsh-Hadamard transform of the Y2 block into the DC of the 16
// luma blocks (16 coefficients apart)
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ------------------------------------------------------------ predictors

// The work buffer of one macroblock, as libwebp lays it out: rows of BPS
// bytes, Y at Y_OFF with its top row, top-left sample and 4 above-right
// samples above it and its left column to the left; U and V side by side
// below it. Predictors read the samples around their block in place.
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int WORK_SIZE = BPS * 17 + BPS * 9;

inline uint8_t avg3(int a, int b, int c) {
  return (uint8_t)((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

// the 16x16 luma (size 16) and 8x8 chroma (size 8) predictors
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j)
        memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

// the ten 4x4 luma predictors
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = (uint8_t)L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}

#undef DST

// ----------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// RFC 6386 section 15 in libwebp's arithmetic: p points at the first
// sample past the edge, step crosses it
inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// the simple filter across one edge of `len` samples: hstride crosses the
// edge, vstride walks along it
void simple_edge(uint8_t* p, int hstride, int vstride, int len, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < len; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

// the normal filter: 6 taps on macroblock edges (mb), 4 on inner edges
void normal_edge(uint8_t* p, int hstride, int vstride, int len, int thresh,
                 int ithresh, int hev_thresh, bool mb) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < len; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      filter2(p, hstride);
    } else if (mb) {
      filter6(p, hstride);
    } else {
      filter4(p, hstride);
    }
  }
}

// ----------------------------------------------------------- VP8 decoder

struct FilterInfo {
  int limit = 0;   // 0: not filtered
  int ilevel = 0;
  int hev_thresh = 0;
  bool inner = false;
};

struct MBInfo {  // one macroblock's modes, parsed from partition 0
  int segment = 0;
  bool skip = false;
  bool is_i4x4 = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0;
};

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts = 1;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;  // 0 none, 1 simple, 2 normal
  // dequantisation per segment: [y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac]
  int dq[4][6];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FilterInfo fstrength[4][2];
  int64_t* stats = nullptr;

  void count(int i, int64_t n = 1) {
    if (stats) stats[i] += n;
  }
};

int parse_header(VP8& d, const uint8_t* buf, size_t size) {
  if (size < 10) return E_HEADER;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) return E_NOT_KEY;
  if (profile > 3 || !show) return E_HEADER;
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) return E_HEADER;
  const int w = ((buf[7] << 8) | buf[6]) & 0x3fff;  // scale bits ignored
  const int h = ((buf[9] << 8) | buf[8]) & 0x3fff;
  if (w != d.width || h != d.height) return E_SIZE;
  d.mb_w = (w + 15) >> 4;
  d.mb_h = (h + 15) >> 4;
  buf += 10;
  size -= 10;
  if (part0 > size) return E_PART0;
  BoolReader& br = d.br;
  br.init(buf, part0);
  buf += part0;
  size -= part0;

  br.literal(1);  // colour space
  br.literal(1);  // clamping type (libwebp always clamps)
  // segment header
  d.use_segment = br.literal(1);
  if (d.use_segment) {
    d.count(S_SEGMENTS);
    d.update_map = br.literal(1);
    if (br.literal(1)) {  // update the segment data
      d.absolute_delta = br.literal(1);
      for (int s = 0; s < 4; ++s)
        d.quantizer[s] = br.literal(1) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s)
        d.filter_strength[s] = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (d.update_map) {
      d.count(S_SEGMENT_MAP);
      for (int s = 0; s < 3; ++s)
        d.seg_proba[s] = br.literal(1) ? (uint8_t)br.literal(8) : 255;
    }
  }
  if (br.eof) return E_SEGMENT;
  // filter header
  d.simple = br.literal(1);
  d.level = br.literal(6);
  d.sharpness = br.literal(3);
  d.use_lf_delta = br.literal(1);
  if (d.use_lf_delta) {
    d.count(S_LF_DELTA);
    if (br.literal(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.literal(1)) d.ref_lf_delta[i] = br.signed_literal(6);
      for (int i = 0; i < 4; ++i)
        if (br.literal(1)) d.mode_lf_delta[i] = br.signed_literal(6);
    }
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return E_FILTER;
  d.count(d.filter_type == 0 ? S_NOFILTER
                             : d.filter_type == 1 ? S_SIMPLE : S_NORMAL);
  if (d.filter_type && d.sharpness) d.count(S_SHARPNESS);
  // token partitions: 3-byte sizes, the last one takes the rest
  d.num_parts = 1 << br.literal(2);
  d.count(S_PARTS + __builtin_ctz(d.num_parts));
  const size_t last = d.num_parts - 1;
  if (size < 3 * last) return E_PARTITIONS;
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  size_t left = size - 3 * last;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    d.parts[p].init(start, psize);
    start += psize;
    left -= psize;
    sz += 3;
  }
  d.parts[last].init(start, left);
  if (start >= buf + size) return E_PARTITIONS;
  // quantisers
  const int base_q = br.literal(7);
  int dqv[5];
  for (int i = 0; i < 5; ++i) dqv[i] = br.literal(1) ? br.signed_literal(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q = base_q;
    if (d.use_segment) {
      q = d.quantizer[s] + (d.absolute_delta ? 0 : base_q);
    }
    int* m = d.dq[s];
    m[0] = kDcTable[clip(q + dqv[0], 127)];
    m[1] = kAcTable[clip(q, 127)];
    m[2] = kDcTable[clip(q + dqv[1], 127)] * 2;
    m[3] = (kAcTable[clip(q + dqv[2], 127)] * 101581) >> 16;  // x 155/100
    if (m[3] < 8) m[3] = 8;
    m[4] = kDcTable[clip(q + dqv[3], 117)];
    m[5] = kAcTable[clip(q + dqv[4], 127)];
  }
  br.literal(1);  // refresh_entropy_probs: one frame, no use
  // coefficient probabilities
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          if (br.bit(kCoeffsUpdateProba[t][b][c][p])) {
            d.proba[t][b][c][p] = (uint8_t)br.literal(8);
            d.count(S_PROBA_UPDATES);
          } else {
            d.proba[t][b][c][p] = kCoeffsProba0[t][b][c][p];
          }
        }
  d.use_skip_proba = br.literal(1);
  if (d.use_skip_proba) d.skip_p = br.literal(8);
  d.count(d.use_skip_proba ? S_SKIP_PROBA : S_NO_SKIP_PROBA);
  // filter strength per segment and per 4x4 / 16x16 macroblock
  if (d.filter_type) {
    for (int s = 0; s < 4; ++s) {
      int base = d.level;
      if (d.use_segment) {
        base = d.filter_strength[s] + (d.absolute_delta ? 0 : d.level);
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& f = d.fstrength[s][i4x4];
        int lv = base;
        if (d.use_lf_delta) {
          lv += d.ref_lf_delta[0];  // intra frame
          if (i4x4) lv += d.mode_lf_delta[0];  // B_PRED
        }
        lv = clip(lv, 63);
        if (lv > 0) {
          int ilevel = lv;
          if (d.sharpness > 0) {
            ilevel >>= d.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * lv + ilevel;
          f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4x4;
      }
    }
  }
  return 0;
}

void parse_modes(VP8& d, MBInfo& mb, uint8_t* top, uint8_t* left) {
  BoolReader& br = d.br;
  if (d.update_map) {
    mb.segment = !br.bit(d.seg_proba[0]) ? br.bit(d.seg_proba[1])
                                         : br.bit(d.seg_proba[2]) + 2;
  } else {
    mb.segment = 0;
  }
  mb.skip = d.use_skip_proba ? br.bit(d.skip_p) : false;
  mb.is_i4x4 = !br.bit(145);
  if (!mb.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                  : (br.bit(163) ? B_VE : B_DC);
    mb.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
    d.count(S_I16 + ymode);
    d.count(S_I16_MB);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        ymode = !br.bit(prob[0])   ? B_DC
                : !br.bit(prob[1]) ? B_TM
                : !br.bit(prob[2]) ? B_VE
                : !br.bit(prob[3])
                    ? (!br.bit(prob[4])   ? B_HE
                       : !br.bit(prob[5]) ? B_RD
                                          : B_VR)
                    : (!br.bit(prob[6])   ? B_LD
                       : !br.bit(prob[7]) ? B_VL
                       : !br.bit(prob[8]) ? B_HD
                                          : B_HU);
        top[x] = (uint8_t)ymode;
        d.count(S_I4 + ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
    d.count(S_I4_MB);
  }
  mb.uvmode = !br.bit(142)   ? B_DC
              : !br.bit(114) ? B_VE
              : br.bit(183)  ? B_TM
                             : B_HE;
  d.count(S_UV + mb.uvmode);
}

int large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// the tokens of one 4x4 block from position n on; returns the position
// after the last token read (16 after a run of zeros to the end)
int get_coeffs(BoolReader& br, const uint8_t (*prob)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;  // end of block
    while (!br.bit(p[1])) {       // a zero
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*next)[11] = prob[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    out[kZigzag[n]] = (int16_t)((br.bit(0x80) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

// non-zero contexts: per macroblock column above and for the left
// neighbour, 4 luma + 2 U + 2 V flags and the Y2 flag
struct NzContext {
  uint8_t y[4] = {0, 0, 0, 0};
  uint8_t u[2] = {0, 0}, v[2] = {0, 0};
  uint8_t dc = 0;
};

// parse one macroblock's coefficients into coeffs (24 blocks of 16);
// returns whether they are all zero
bool parse_residuals(VP8& d, const MBInfo& mb, BoolReader& br,
                     NzContext& top, NzContext& left, int16_t* coeffs) {
  const int* q = d.dq[mb.segment];
  memset(coeffs, 0, 384 * sizeof(int16_t));
  bool any = false;
  int first;
  const uint8_t(*ac)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top.dc + left.dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, q + 2, 0, dc);
    top.dc = left.dc = nz > 0;
    iwht(dc, coeffs);
    first = 1;
    ac = d.proba[0];
  } else {
    first = 0;
    ac = d.proba[3];
  }
  for (int y = 0; y < 4; ++y) {
    int l = left.y[y];
    for (int x = 0; x < 4; ++x) {
      int16_t* blk = coeffs + 16 * (4 * y + x);
      const int nz = get_coeffs(br, ac, l + top.y[x], q, first, blk);
      l = nz > first;
      top.y[x] = (uint8_t)l;
      if (nz > 1 || blk[0]) any = true;
    }
    left.y[y] = (uint8_t)l;
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* tnz = ch ? top.v : top.u;
    uint8_t* lnz = ch ? left.v : left.u;
    for (int y = 0; y < 2; ++y) {
      int l = lnz[y];
      for (int x = 0; x < 2; ++x) {
        int16_t* blk = coeffs + 16 * (16 + 4 * ch + 2 * y + x);
        const int nz = get_coeffs(br, d.proba[2], l + tnz[x], q + 4, 0, blk);
        l = nz > 0;
        tnz[x] = (uint8_t)l;
        if (nz > 1 || blk[0]) any = true;
      }
      lnz[y] = (uint8_t)l;
    }
  }
  return !any;
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

int decode_vp8(VP8& d, const uint8_t* data, size_t size, uint8_t* yp,
               uint8_t* up, uint8_t* vp) {
  int err = parse_header(d, data, size);
  if (err) return err;
  const int mb_w = d.mb_w, mb_h = d.mb_h;
  const int ys = mb_w * 16, uvs = mb_w * 8;  // plane strides (padded)
  std::vector<uint8_t> Y((size_t)ys * mb_h * 16), U((size_t)uvs * mb_h * 8),
      V((size_t)uvs * mb_h * 8);
  std::vector<MBInfo> row(mb_w);
  std::vector<FilterInfo> finfo((size_t)mb_w * mb_h);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<NzContext> nz_top(mb_w);
  std::vector<TopSamples> yuv_t(mb_w);
  uint8_t work[WORK_SIZE];
  memset(work, 0, sizeof(work));
  int16_t coeffs[384];
  uint8_t* const ydst = work + Y_OFF;
  uint8_t* const udst = work + U_OFF;
  uint8_t* const vdst = work + V_OFF;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      parse_modes(d, row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (d.br.eof) return E_MODES;
    BoolReader& tokens = d.parts[mb_y & (d.num_parts - 1)];
    NzContext nz_left;

    // the left-most block: left samples 129, the top row 127 on the first
    // macroblock row, the top-left sample 129 below it
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
    } else {
      memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      memset(udst - BPS - 1, 127, 8 + 1);
      memset(vdst - BPS - 1, 127, 8 + 1);
    }

    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBInfo& mb = row[mb_x];
      NzContext& nzt = nz_top[mb_x];
      bool skip = mb.skip;
      if (!skip) {
        skip = parse_residuals(d, mb, tokens, nzt, nz_left, coeffs);
      } else {
        const uint8_t tdc = nzt.dc, ldc = nz_left.dc;
        nzt = NzContext();
        nz_left = NzContext();
        if (mb.is_i4x4) {  // no Y2 block: its context stays
          nzt.dc = tdc;
          nz_left.dc = ldc;
        }
        memset(coeffs, 0, sizeof(coeffs));
        d.count(S_SKIPPED);
      }
      if (d.filter_type) {
        FilterInfo f = d.fstrength[mb.segment][mb.is_i4x4];
        f.inner = f.inner || !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = f;
      }
      if (tokens.eof) return E_TOKENS;

      // rotate in the left samples of the previous macroblock (and the
      // top-left one)
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          memcpy(&ydst[j * BPS - 4], &ydst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&udst[j * BPS - 4], &udst[j * BPS + 4], 4);
          memcpy(&vdst[j * BPS - 4], &vdst[j * BPS + 4], 4);
        }
      }
      TopSamples* top = &yuv_t[mb_x];
      if (mb_y > 0) {
        memcpy(ydst - BPS, top->y, 16);
        memcpy(udst - BPS, top->u, 8);
        memcpy(vdst - BPS, top->v, 8);
      }
      if (mb.is_i4x4) {
        uint8_t* top_right = ydst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top->y[15], 4);
          } else {
            memcpy(top_right, top[1].y, 4);
          }
        }
        // sub-blocks 3, 7, 11 and 15 take the above-right macroblock's
        // samples too
        for (int k = 1; k <= 3; ++k)
          memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, mb.imodes[n]);
          idct_add(coeffs + 16 * n, dst, BPS);
        }
      } else {
        int mode = mb.imodes[0];
        if (mode == B_DC) {
          mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                           : (mb_y == 0 ? DC_NOTOP : B_DC);
        }
        predict_block(ydst, 16, mode);
        for (int n = 0; n < 16; ++n)
          idct_add(coeffs + 16 * n, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS,
                   BPS);
      }
      int uvmode = mb.uvmode;
      if (uvmode == B_DC) {
        uvmode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                           : (mb_y == 0 ? DC_NOTOP : B_DC);
      }
      predict_block(udst, 8, uvmode);
      predict_block(vdst, 8, uvmode);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        idct_add(coeffs + 16 * (16 + n), udst + off, BPS);
        idct_add(coeffs + 16 * (20 + n), vdst + off, BPS);
      }
      // stash the bottom row for the macroblock below (unfiltered)
      if (mb_y < mb_h - 1) {
        memcpy(top->y, ydst + 15 * BPS, 16);
        memcpy(top->u, udst + 7 * BPS, 8);
        memcpy(top->v, vdst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], ydst + j * BPS,
               16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], udst + j * BPS, 8);
        memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], vdst + j * BPS, 8);
      }
    }
  }

  // the loop filter, macroblock by macroblock in raster order: left edge,
  // inner vertical edges, top edge, inner horizontal edges
  if (d.filter_type) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FilterInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* y = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
        if (d.filter_type == 1) {
          if (mb_x > 0) simple_edge(y, 1, ys, 16, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4)
              simple_edge(y + k, 1, ys, 16, limit);
          if (mb_y > 0) simple_edge(y, ys, 1, 16, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4)
              simple_edge(y + k * ys, ys, 1, 16, limit);
        } else {
          uint8_t* u = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
          uint8_t* v = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
          const int il = f.ilevel, ht = f.hev_thresh;
          if (mb_x > 0) {
            normal_edge(y, 1, ys, 16, limit + 4, il, ht, true);
            normal_edge(u, 1, uvs, 8, limit + 4, il, ht, true);
            normal_edge(v, 1, uvs, 8, limit + 4, il, ht, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4)
              normal_edge(y + k, 1, ys, 16, limit, il, ht, false);
            normal_edge(u + 4, 1, uvs, 8, limit, il, ht, false);
            normal_edge(v + 4, 1, uvs, 8, limit, il, ht, false);
          }
          if (mb_y > 0) {
            normal_edge(y, ys, 1, 16, limit + 4, il, ht, true);
            normal_edge(u, uvs, 1, 8, limit + 4, il, ht, true);
            normal_edge(v, uvs, 1, 8, limit + 4, il, ht, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4)
              normal_edge(y + k * ys, ys, 1, 16, limit, il, ht, false);
            normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
            normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          }
        }
      }
    }
  }

  // crop to the frame
  const int w = d.width, h = d.height, uw = (w + 1) / 2, uh = (h + 1) / 2;
  for (int j = 0; j < h; ++j) memcpy(yp + (size_t)j * w, &Y[(size_t)j * ys], w);
  for (int j = 0; j < uh; ++j) {
    memcpy(up + (size_t)j * uw, &U[(size_t)j * uvs], uw);
    memcpy(vp + (size_t)j * uw, &V[(size_t)j * uvs], uw);
  }
  return 0;
}

// ------------------------------------------------------- YUV -> RGB

// libwebp's 14-bit fixed point: MultHi(v, c) = (v * c) >> 8, results in
// 1/64 units clipped to 0..255
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip(int v) {
  return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip(yy + mult_hi(u, 33050) - 17685);
}

// one output row of libwebp's "fancy" upsampler: the chroma row nearest
// the luma row (weight 3) and the other one (weight 1), each sample pair
// interpolated as (9a + 3b + 3c + d + 8) >> 4 in two rounded steps
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                  const uint8_t* fu, const uint8_t* fv, int len,
                  uint8_t* rgb) {
  const int last_pair = (len - 1) >> 1;
  int tu = nu[0], tv = nv[0], lu = fu[0], lv = fv[0];  // near, far at k-1
  yuv_to_rgb(y[0], (3 * tu + lu + 2) >> 2, (3 * tv + lv + 2) >> 2, rgb);
  for (int k = 1; k <= last_pair; ++k) {
    const int u1 = nu[k], v1 = nv[k], fu1 = fu[k], fv1 = fv[k];
    const int au = tu + u1 + lu + fu1 + 8, av = tv + v1 + lv + fv1 + 8;
    const int du12 = (au + 2 * (u1 + lu)) >> 3;
    const int dv12 = (av + 2 * (v1 + lv)) >> 3;
    const int du03 = (au + 2 * (tu + fu1)) >> 3;
    const int dv03 = (av + 2 * (tv + fv1)) >> 3;
    yuv_to_rgb(y[2 * k - 1], (du12 + tu) >> 1, (dv12 + tv) >> 1,
               rgb + 3 * (2 * k - 1));
    yuv_to_rgb(y[2 * k], (du03 + u1) >> 1, (dv03 + v1) >> 1, rgb + 3 * (2 * k));
    tu = u1;
    tv = v1;
    lu = fu1;
    lv = fv1;
  }
  if (!(len & 1)) {
    yuv_to_rgb(y[len - 1], (3 * tu + lu + 2) >> 2, (3 * tv + lv + 2) >> 2,
               rgb + 3 * (len - 1));
  }
}

}  // namespace

extern "C" {

// One VP8 key frame (the chunk's payload, with its padding byte if any)
// of width x height -> Y (h x w), U and V ((h+1)/2 x (w+1)/2). Returns 0,
// or a negative error code. stats: S_VP8_END int64 counters, or NULL.
int64_t webp_vp8_decode(const uint8_t* data, int64_t size, int32_t width,
                        int32_t height, uint8_t* y, uint8_t* u, uint8_t* v,
                        int64_t* stats) {
  VP8 d;
  d.width = width;
  d.height = height;
  d.stats = stats;
  return decode_vp8(d, data, (size_t)size, y, u, v);
}

// libwebp's RGB output of the planes above: h x w x 3 bytes.
void webp_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                     int32_t width, int32_t height, uint8_t* rgb) {
  const int uw = (width + 1) / 2, uh = (height + 1) / 2;
  for (int j = 0; j < height; ++j) {
    const int near = j >> 1;
    int far = (j & 1) ? (j + 1) >> 1 : (j >> 1) - 1;
    if (far < 0) far = 0;
    if (far > uh - 1) far = uh - 1;
    upsample_row(y + (size_t)j * width, u + (size_t)near * uw,
                 v + (size_t)near * uw, u + (size_t)far * uw,
                 v + (size_t)far * uw, width, rgb + (size_t)j * width * 3);
  }
}

int32_t webp_vp8_stats_size() { return S_VP8_END; }

}  // extern "C"

// ------------------------------------------------------------------ VP8L

namespace {

// the 120 nearest (dx, dy) offsets of VP8L's distance codes 1..120, as
// (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};
const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

// VP8L error codes (data/webp.py names them)
enum {
  L_EOS = -20,        // the data ends before the image does
  L_HEADER = -21,     // signature, version or size
  L_TRANSFORM = -22,  // a transform given twice
  L_CACHE = -23,      // colour cache bits outside 1..11
  L_CODE = -24,       // a prefix code that is not complete
  L_REPEAT = -25,     // a code-length repeat past the alphabet
  L_COPY = -26,       // a backward reference before the start or past
                      // the end
  L_LENGTHS = -27,    // more code lengths than symbols
};

// coverage counters of a VP8L stream, after the VP8 ones
enum {
  T_PRED = 0,  // 14 predictor modes (tiles)
  T_PREDICTOR = 14, T_CROSS_COLOR, T_SUBTRACT_GREEN, T_COLOR_INDEXING,
  T_PACK = 18,  // palette bundling: 1, 2, 4, 8 pixels per byte
  T_CACHE = 22, T_CACHE_HITS, T_META, T_ONE_SYMBOL, T_SIMPLE_CODE,
  T_NORMAL_CODE, T_BACKREF,
  T_END
};

// LSB-first bit reader with libwebp's end of stream: bits past the data
// read as zeros and the stream has ended once more than 8 * max(size, 8)
// bits were taken
struct LBits {
  std::vector<uint8_t> buf;  // the data and 8 zero bytes
  size_t size = 0;
  uint64_t pos = 0, limit = 0;
  bool eos = false;

  void init(const uint8_t* p, size_t n) {
    buf.assign(p, p + n);
    buf.resize(n + 8, 0);
    size = n;
    pos = 0;
    limit = 8 * (uint64_t)(n > 8 ? n : 8);
    eos = false;
  }
  uint32_t peek() const {  // the next 32 bits
    const uint64_t byte = pos >> 3;
    if (byte >= size) return 0;
    uint64_t v;
    memcpy(&v, &buf[byte], 8);
    return (uint32_t)(v >> (pos & 7));
  }
  void skip(int n) {
    pos += n;
    if (pos > limit) eos = true;
  }
  uint32_t read(int n) {
    const uint32_t v = n ? peek() & ((1u << n) - 1) : 0;
    skip(n);
    return v;
  }
};

// a canonical prefix code, read as VP8L stores it (first code bit first in
// the LSB-first stream): an 8-bit table for short codes, the canonical
// walk for longer ones; a code of one symbol takes no bits
struct Prefix {
  int single = -1;
  uint16_t fast[256];  // (symbol << 4) | length, or 0: longer than 8
  int count[16];
  std::vector<uint16_t> sorted;

  // returns false for a code that is neither complete nor of one symbol
  bool build(const int* lengths, int n) {
    memset(count, 0, sizeof(count));
    int used = 0, last = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
        last = s;
      }
    }
    if (used == 0) return false;
    if (used == 1) {
      single = last;
      return true;
    }
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign(used, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[offs[lengths[s]]++] = (uint16_t)s;
    memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int len = 1; len <= 8; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = rev; fill < 256; fill += 1 << len)
          fast[fill] = (uint16_t)((sorted[k] << 4) | len);
      }
      code <<= 1;
    }
    return true;
  }
  int read(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek();
    const uint16_t e = fast[bits & 255];
    if (e) {
      br.skip(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int c = count[len];
      if (code - first < c) {
        br.skip(len);
        return sorted[index + code - first];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // unreachable for a complete code
  }
};

struct Group {
  Prefix code[5];  // green + lengths + cache, red, blue, alpha, distance
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct VP8L {
  LBits br;
  bool alpha = false;  // an ALPH chunk's stream (no header)
  int err = 0;
  unsigned seen = 0;  // transform types read
  std::vector<Transform> transforms;
  int64_t* stats = nullptr;

  void count(int i, int64_t n = 1) {
    if (stats) stats[i] += n;
  }
  bool fail(int code) {
    if (!err) err = code;
    return false;
  }
};

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool read_code(VP8L& d, int alphabet, Prefix& out) {
  LBits& br = d.br;
  std::vector<int> lengths(alphabet > 256 ? alphabet : 256, 0);
  if (br.read(1)) {  // simple: 1 or 2 symbols given directly
    const int num = br.read(1) + 1;
    const int first8 = br.read(1);
    lengths[br.read(first8 ? 8 : 1)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
    d.count(T_SIMPLE_CODE);
  } else {  // normal: code lengths coded with a code of 19 lengths
    int cl[19] = {0};
    const int num = br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Prefix lcode;
    if (br.eos) return d.fail(L_EOS);
    if (!lcode.build(cl, 19)) return d.fail(L_CODE);
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) return d.fail(L_LENGTHS);
    }
    int prev = 8, s = 0;
    while (s < alphabet) {
      if (max_symbol-- == 0) break;
      if (br.eos) return d.fail(L_EOS);
      const int len = lcode.read(br);
      if (len < 16) {
        lengths[s++] = len;
        if (len) prev = len;
      } else {
        const int slot = len - 16;
        const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int repeat = br.read(extra[slot]) + offset[slot];
        if (s + repeat > alphabet) return d.fail(L_REPEAT);
        const int v = len == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[s++] = v;
      }
    }
    d.count(T_NORMAL_CODE);
  }
  if (br.eos) return d.fail(L_EOS);
  if (!out.build(lengths.data(), alphabet)) return d.fail(L_CODE);
  if (out.single >= 0) d.count(T_ONE_SYMBOL);
  return true;
}

// copy length or distance from its prefix symbol and extra bits
int prefix_value(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int v = kCodeToPlane[code - 1];
  const int dist = (v >> 4) * xsize + (8 - (v & 0xf));
  return dist >= 1 ? dist : 1;
}

// one entropy-coded image of xsize x ysize ARGB pixels (VP8L's
// DecodeImageStream); the main image (level0) reads the transforms first
// and may use meta prefix codes
bool decode_stream(VP8L& d, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>& out);

bool read_transform(VP8L& d, int& xsize, int ysize) {
  LBits& br = d.br;
  const int type = br.read(2);
  if (d.seen & (1u << type)) return d.fail(L_TRANSFORM);
  d.seen |= 1u << type;
  d.count(T_PREDICTOR + type);
  Transform t;
  t.type = type;
  t.xsize = xsize;
  t.ysize = ysize;
  if (type == 0 || type == 1) {  // predictor, cross-colour
    t.bits = br.read(3) + 2;
    if (!decode_stream(d, subsample(xsize, t.bits), subsample(ysize, t.bits),
                       false, t.data))
      return false;
  } else if (type == 3) {  // colour indexing
    const int num = br.read(8) + 1;
    t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
    d.count(T_PACK + t.bits);
    xsize = subsample(xsize, t.bits);
    std::vector<uint32_t> pal;
    if (!decode_stream(d, num, 1, false, pal)) return false;
    // delta-coded entries; the unused ones of 1 << (8 >> bits) are zero
    t.data.assign((size_t)1 << (8 >> t.bits), 0);
    uint32_t prev = 0;
    for (int i = 0; i < num; ++i) {
      const uint32_t c = pal[i];
      uint32_t v = 0;
      for (int s = 0; s < 32; s += 8)
        v |= (((c >> s) + (prev >> s)) & 0xff) << s;
      t.data[i] = prev = v;
    }
  }
  d.transforms.push_back(std::move(t));
  return true;
}

bool decode_stream(VP8L& d, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>& out) {
  LBits& br = d.br;
  int width = xsize;
  if (level0) {
    while (br.read(1)) {
      if (br.eos) return d.fail(L_EOS);
      if (!read_transform(d, width, ysize)) return false;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return d.fail(L_CACHE);
    d.count(T_CACHE);
  }
  // meta prefix codes: an image of group indices over tiles
  int meta_bits = 0, meta_xsize = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = br.read(3) + 2;
    meta_xsize = subsample(width, meta_bits);
    if (!decode_stream(d, meta_xsize, subsample(ysize, meta_bits), false,
                       meta))
      return false;
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if ((int)m >= num_groups) num_groups = (int)m + 1;
    }
    d.count(T_META);
  }
  if (br.eos) return d.fail(L_EOS);
  // the groups' codes; those no tile uses are read and checked, not kept
  std::vector<char> used(num_groups, meta.empty() ? 1 : 0);
  for (uint32_t m : meta) used[m] = 1;
  std::vector<int> slot(num_groups, -1);
  std::vector<Group> groups;
  bool all_trivial = true, used_trivial = true;
  for (int g = 0; g < num_groups; ++g) {
    Group grp;
    for (int j = 0; j < 5; ++j) {
      const int alphabet =
          kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      if (!read_code(d, alphabet, grp.code[j])) return false;
    }
    const bool trivial = grp.code[1].single >= 0 &&
                         grp.code[2].single >= 0 && grp.code[3].single >= 0;
    all_trivial = all_trivial && trivial;
    if (used[g]) used_trivial = used_trivial && trivial;
    if (used[g]) {
      slot[g] = (int)groups.size();
      groups.push_back(std::move(grp));
    }
  }
  for (uint32_t& m : meta) m = (uint32_t)slot[m];
  // libwebp decodes an alpha stream whose only transform is colour
  // indexing, without a colour cache and with one-symbol red, blue and
  // alpha codes in every group, one byte per pixel; that path accepts a
  // stream that ends inside the symbols of its last pixels. (libwebp keeps
  // only the groups tiles use where there are more than 1000 of them or
  // more than pixels, and then checks only those.)
  const bool remapped =
      num_groups > 1000 || (int64_t)num_groups > (int64_t)width * ysize;
  const bool lenient = level0 && d.alpha && d.transforms.size() == 1 &&
                       d.transforms[0].type == 3 && cache_bits == 0 &&
                       (remapped ? used_trivial : all_trivial);

  const size_t total = (size_t)width * ysize;
  out.assign(total, 0);
  std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0);
  const int cache_shift = 32 - cache_bits;
  size_t p = 0;
  int x = 0, y = 0;
  auto insert = [&](uint32_t argb) {
    if (cache_bits) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
  };
  while (p < total) {
    const Group& g = groups[meta_bits ? meta[(size_t)(y >> meta_bits) *
                                                 meta_xsize +
                                             (x >> meta_bits)]
                                      : 0];
    const int green = g.code[0].read(br);
    if (green < 256) {
      const uint32_t red = g.code[1].read(br);
      const uint32_t blue = g.code[2].read(br);
      const uint32_t alpha = g.code[3].read(br);
      const uint32_t argb = (alpha << 24) | (red << 16) | (green << 8) | blue;
      out[p++] = argb;
      insert(argb);
      if (++x == width) {
        x = 0;
        ++y;
      }
    } else if (green < 256 + 24) {
      const int length = prefix_value(green - 256, br);
      const int dsym = g.code[4].read(br);
      const int dist = plane_to_distance(width, prefix_value(dsym, br));
      if (br.eos && !lenient) return d.fail(L_EOS);
      if (p < (size_t)dist || total - p < (size_t)length)
        return d.fail(L_COPY);
      for (int i = 0; i < length; ++i, ++p) {
        out[p] = out[p - dist];
        insert(out[p]);
      }
      x += length;
      while (x >= width) {
        x -= width;
        ++y;
      }
      d.count(T_BACKREF);
    } else {
      const uint32_t argb = cache[green - 256 - 24];
      out[p++] = argb;
      insert(argb);
      if (++x == width) {
        x = 0;
        ++y;
      }
      d.count(T_CACHE_HITS);
    }
    if (br.eos && !(lenient && p == total)) return d.fail(L_EOS);
  }
  if (br.eos && !lenient) return d.fail(L_EOS);
  return true;
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 0xff) + (int)((b >> s) & 0xff) -
                             (int)((c >> s) & 0xff))
           << s;
  return out;
}
inline uint32_t add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = (a >> s) & 0xff, y = (b >> s) & 0xff;
    out |= (uint32_t)clip255(x + (x - y) / 2) << s;
  }
  return out;
}
inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int diff = 0;  // sum over channels of |L - TL| - |T - TL|
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    diff += abs(b - c) - abs(a - c);
  }
  return diff <= 0 ? t : l;
}
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t predict(int mode, const uint32_t* cur, const uint32_t* up) {
  // cur: the pixel's left neighbour is cur[-1]; up: the pixel above
  const uint32_t L = cur[-1], T = up[0], TR = up[1], TL = up[-1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return add_sub_full(L, T, TL);
    case 13: return add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

void inverse_transform(VP8L& d, const Transform& t,
                       std::vector<uint32_t>& img) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 0) {  // predictor
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      uint32_t* row = &img[(size_t)y * w];
      for (int x = 0; x < w; ++x) {
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? 0xff000000u : row[x - 1];
        } else if (x == 0) {
          pred = row[x - w];
        } else {
          const uint32_t m =
              t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          const int mode = (m >> 8) & 0xf;
          // the rightmost column's top-right is the row's first pixel,
          // which lies next to it in memory
          pred = predict(mode, row + x, row + x - w);
        }
        row[x] = add_pixels(row[x], pred);
      }
    }
    if (d.stats) {
      for (uint32_t m : t.data)
        if (((m >> 8) & 0xf) < 14) d.count(T_PRED + ((m >> 8) & 0xf));
    }
  } else if (t.type == 1) {  // cross-colour
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      uint32_t* row = &img[(size_t)y * w];
      for (int x = 0; x < w; ++x) {
        const uint32_t m =
            t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff);
        const int8_t r2b = (int8_t)((m >> 16) & 0xff);
        const uint32_t argb = row[x];
        const int8_t green = (int8_t)(argb >> 8);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + ((g2r * green) >> 5)) & 0xff;
        blue += (g2b * green) >> 5;
        blue += (r2b * (int8_t)red) >> 5;
        blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
      }
    }
  } else if (t.type == 2) {  // subtract green
    for (uint32_t& p : img) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else {  // colour indexing: from the packed width to t.xsize
    const int pw = subsample(w, t.bits);
    std::vector<uint32_t> out((size_t)w * h);
    const int bpp = 8 >> t.bits, per = 1 << t.bits;
    const uint32_t mask = (1u << bpp) - 1;
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = &img[(size_t)y * pw];
      uint32_t* dst = &out[(size_t)y * w];
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (src[x >> t.bits] >> 8) & 0xff;
        const int idx = (packed >> ((x & (per - 1)) * bpp)) & mask;
        dst[x] = t.data[idx];
      }
    }
    img.swap(out);
  }
}

int decode_vp8l(VP8L& d, int width, int height, bool header,
                std::vector<uint32_t>& img) {
  LBits& br = d.br;
  if (header) {
    if (br.read(8) != 0x2f) return L_HEADER;
    const int w = br.read(14) + 1, h = br.read(14) + 1;
    br.read(1);  // alpha is used
    if (br.read(3) != 0) return L_HEADER;
    if (w != width || h != height) return L_HEADER;
  }
  if (!decode_stream(d, width, height, true, img)) return d.err ? d.err : L_EOS;
  for (size_t i = d.transforms.size(); i-- > 0;)
    inverse_transform(d, d.transforms[i], img);
  return 0;
}

}  // namespace

extern "C" {

// One VP8L image (the chunk's payload with its padding byte if any;
// header=0 for an ALPH chunk's headerless stream) of width x height ->
// ARGB (h x w uint32). Returns 0 or a negative error code. stats:
// T_END int64 counters, or NULL.
int64_t webp_vp8l_decode(const uint8_t* data, int64_t size, int32_t width,
                         int32_t height, int32_t header, uint32_t* argb,
                         int64_t* stats) {
  VP8L d;
  d.stats = stats;
  d.alpha = header == 0;
  d.br.init(data, (size_t)size);
  std::vector<uint32_t> img;
  const int err = decode_vp8l(d, width, height, header != 0, img);
  if (err) return err;
  memcpy(argb, img.data(), img.size() * sizeof(uint32_t));
  return 0;
}

int32_t webp_vp8l_stats_size() { return T_END; }

}  // extern "C"
