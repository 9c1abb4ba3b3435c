// VP8 frame decoding (RFC 6386), shared by the lossy WebP decoder
// (webp_decoder.cpp: one key frame) and the VP8 video decoder
// (vp8_decoder.cpp: key and inter frames, with their references).
//
// FrameDecoder decodes one frame into YUV 4:2:0 planes on the macroblock
// grid, keeping what persists from frame to frame: the coefficient, mode and
// motion vector probabilities (with refresh_entropy_probs = 0 restoring the
// set saved before the frame's updates; a key frame resets them), the
// segmentation and its map, the loop-filter deltas. Its parts: the boolean
// entropy decoder; segments and their quantisers; token probabilities and
// their updates; 16x16, 4x4 and chroma intra prediction; the inverse WHT and
// DCT; inter macroblocks -- the reference, the near vectors of the
// neighbours (sign bias, clamping), the mode contexts, vectors in short and
// long form, SPLITMV in its four partitionings --, six-tap (version 0) or
// bilinear (versions 1-3, full-pixel chroma in version 3) prediction from the
// references, whose edges repeat without end from the macroblock grid; the
// simple and normal loop filters with the frame type's edge-variance
// thresholds and the reference and mode deltas. Intra prediction reads the
// frame's unfiltered pixels, inter prediction the filtered references.
//
// The tables are the normative ones of RFC 6386. The 4x4 intra modes are
// numbered as libwebp numbers them (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU),
// and so is the mode-probability table.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace sr_vp8 {

static const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};
static const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95}, {175, 69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152}, {114, 26, 17, 163, 44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85}, {144, 71, 10, 38, 171, 213, 144, 34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71}, {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80}, {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141, 26, 8, 107}, {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128}, {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23}, {47, 41, 14, 110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61}, {39, 53, 200, 87, 26, 21, 43, 232, 171}, {56, 34, 51, 104, 114, 102, 29, 93, 77}, {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22, 116, 206, 23, 34, 43, 166, 73}, {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171, 36, 225, 114}, {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111}, {112, 113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109}, {88, 43, 29, 140, 166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209}, {100, 80, 8, 43, 154, 1, 51, 26, 71}, {142, 78, 78, 16, 255, 128, 34, 197, 171}, {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179}, {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34, 39, 175}, {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183}, {57, 46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205}, {40, 3, 9, 115, 51, 192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57}, {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34, 26, 133, 152, 116, 10, 32, 134}, {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2, 15, 1, 118, 73}, {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186, 85}, {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45}, {75, 79, 123, 47, 51, 128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49}, {38, 33, 13, 121, 57, 73, 26, 1, 85}, {41, 10, 67, 138, 77, 110, 90, 47, 114}, {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16, 10, 85, 128, 101, 196, 26}, {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37}, {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70}, {37, 43, 37, 154, 100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85}, {75, 15, 9, 9, 64, 255, 184, 119, 16}, {86, 6, 28, 5, 64, 255, 25, 248, 1}, {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158}, {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1, 209}, {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213}, {83, 12, 13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171}, {18, 11, 7, 63, 144, 171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32}, {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62}, {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138, 55, 70, 43, 26, 142}, {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81, 188, 64}, {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// Intra modes as libwebp numbers them; the 16x16 and chroma modes share
// the first four numbers.
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };

// RFC 6386's boolean decoder; past the end of its data it reads zeros. The
// value is held in 64 bits, the 8 the RFC's decoder compares on top and the
// bytes after them below (a comparison on the top bits with more bits below
// decides as the RFC's two-byte one does); the range is renormalised in one
// shift.
class BoolDecoder {
 public:
  void Init(const uint8_t* data, size_t size) {
    data_ = data;
    end_ = data + size;
    value_ = 0;
    count_ = -8;
    range_ = 255;
    Fill();
  }
  int GetBit(int prob) {
    const uint32_t split = 1 + (((range_ - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint64_t big_split = static_cast<uint64_t>(split) << 56;
    int bit;
    if (value_ >= big_split) {
      bit = 1;
      range_ -= split;
      value_ -= big_split;
    } else {
      bit = 0;
      range_ = split;
    }
    const int shift = __builtin_clz(range_) - 24;
    range_ <<= shift;
    value_ <<= shift;
    count_ -= shift;
    if (count_ < 0) Fill();
    return bit;
  }
  int Get() { return GetBit(128); }
  int GetValue(int bits) {
    int v = 0;
    while (bits-- > 0) v |= Get() << bits;
    return v;
  }
  int GetSignedValue(int bits) {
    const int v = GetValue(bits);
    return Get() ? -v : v;
  }

 private:
  // Loads whole bytes under the top 8 bits; count_ is how many bits lie below them.
  void Fill() {
    for (int shift = 48 - count_; shift >= 0; shift -= 8) {
      count_ += 8;
      if (data_ < end_) value_ |= static_cast<uint64_t>(*data_++) << shift;
    }
  }
  const uint8_t* data_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 255;
  int count_ = 0;
};

inline uint8_t Clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// The work buffer of one macroblock: a row above and four columns to the
// left of each plane, and four top-right pixels for the 4x4 modes.
constexpr int BPS = 32;

inline int Avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int Avg2(int a, int b) { return (a + b + 1) >> 1; }
#define DST(x, y) dst[(x) + (y) * BPS]

inline void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int top_left = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x) dst[x + y * BPS] = Clip8(top[x] + left - top_left);
  }
}
inline void Vertical(uint8_t* dst, int size) {
  for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
}
inline void Horizontal(uint8_t* dst, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[-1 + y * BPS], size);
}
// DC of a 16x16 or 8x8 block, with or without the row above / the column to the left.
inline void DcPredict(uint8_t* dst, int size, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  int dc;
  if (has_top && has_left) {
    int sum = 0;
    for (int i = 0; i < size; ++i) sum += dst[i - BPS] + dst[-1 + i * BPS];
    dc = (sum + size) >> (shift + 1);
  } else if (has_top || has_left) {
    int sum = 0;
    for (int i = 0; i < size; ++i) sum += has_top ? dst[i - BPS] : dst[-1 + i * BPS];
    dc = (sum + (size >> 1)) >> shift;
  } else {
    dc = 0x80;
  }
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dc, size);
}

inline void Predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, dc, 4);
      break;
    }
    case B_TM:
      TrueMotion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {static_cast<uint8_t>(Avg3(X, A, B)), static_cast<uint8_t>(Avg3(A, B, C)),
                               static_cast<uint8_t>(Avg3(B, C, D)), static_cast<uint8_t>(Avg3(C, D, E))};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int rows[4] = {Avg3(X, I, J), Avg3(I, J, K), Avg3(J, K, L), Avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, rows[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = Avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = Avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = Avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = Avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = Avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = Avg3(C, B, A);
      DST(3, 0) = Avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = Avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
      DST(3, 3) = Avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = Avg2(X, A);
      DST(1, 0) = DST(2, 2) = Avg2(A, B);
      DST(2, 0) = DST(3, 2) = Avg2(B, C);
      DST(3, 0) = Avg2(C, D);
      DST(0, 3) = Avg3(K, J, I);
      DST(0, 2) = Avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
      DST(3, 1) = Avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = Avg2(A, B);
      DST(1, 0) = DST(0, 2) = Avg2(B, C);
      DST(2, 0) = DST(1, 2) = Avg2(C, D);
      DST(3, 0) = DST(2, 2) = Avg2(D, E);
      DST(0, 1) = Avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
      DST(3, 2) = Avg3(E, F, G);
      DST(3, 3) = Avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = Avg2(I, J);
      DST(2, 0) = DST(0, 1) = Avg2(J, K);
      DST(2, 1) = DST(0, 2) = Avg2(K, L);
      DST(1, 0) = Avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = Avg2(I, X);
      DST(0, 1) = DST(2, 2) = Avg2(J, I);
      DST(0, 2) = DST(2, 3) = Avg2(K, J);
      DST(0, 3) = Avg2(L, K);
      DST(3, 0) = Avg3(A, B, C);
      DST(2, 0) = Avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = Avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = Avg3(K, J, I);
      DST(1, 3) = Avg3(L, K, J);
      break;
  }
}
#undef DST

inline void PredictBlock(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
  switch (mode) {
    case DC_PRED: DcPredict(dst, size, mb_y > 0, mb_x > 0); break;
    case TM_PRED: TrueMotion(dst, size); break;
    case V_PRED: Vertical(dst, size); break;
    default: Horizontal(dst, size); break;
  }
}

// The inverse DCT of one 4x4 block, added to the prediction in dst.
inline void InverseDct(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
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
    uint8_t* row = dst + i * BPS;
    row[0] = Clip8(row[0] + ((a + d) >> 3));
    row[1] = Clip8(row[1] + ((b + c) >> 3));
    row[2] = Clip8(row[2] + ((b - c) >> 3));
    row[3] = Clip8(row[3] + ((a - d) >> 3));
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block: the DC of each of
// the 16 luma blocks (out[16 * k]).
inline void InverseWht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3];
    const int a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2];
    const int a3 = dc - tmp[4 * i + 3];
    out[64 * i + 0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[64 * i + 16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[64 * i + 32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[64 * i + 48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// The same two transforms as FFmpeg's x86 build computes them (vp8dsp.asm,
// which cv2.VideoCapture runs): 16-bit lanes in which every sum wraps, the
// products by 20091 and 35468 / 2 as pmulhw takes them (35468 x through 2x,
// which wraps past 16383), the shift by 3 on the wrapped sum. On what
// encoders write nothing wraps, and they equal the two above.
inline int16_t Wrap16(int v) { return static_cast<int16_t>(v); }
inline int16_t Mul20091(int16_t x) { return Wrap16(((x * 20091) >> 16) + x); }
inline int16_t Mul35468(int16_t x) { return static_cast<int16_t>((Wrap16(2 * x) * 17734) >> 16); }

inline void InverseDct16(const int16_t* in, uint8_t* dst) {
  int16_t tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int16_t a = Wrap16(in[i] + in[8 + i]), b = Wrap16(in[i] - in[8 + i]);
    const int16_t c = Wrap16(Mul35468(in[4 + i]) - Mul20091(in[12 + i]));
    const int16_t d = Wrap16(Mul20091(in[4 + i]) + Mul35468(in[12 + i]));
    tmp[4 * i + 0] = Wrap16(a + d);
    tmp[4 * i + 1] = Wrap16(b + c);
    tmp[4 * i + 2] = Wrap16(b - c);
    tmp[4 * i + 3] = Wrap16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int16_t dc = Wrap16(tmp[i] + 4);
    const int16_t a = Wrap16(dc + tmp[8 + i]), b = Wrap16(dc - tmp[8 + i]);
    const int16_t c = Wrap16(Mul35468(tmp[4 + i]) - Mul20091(tmp[12 + i]));
    const int16_t d = Wrap16(Mul20091(tmp[4 + i]) + Mul35468(tmp[12 + i]));
    uint8_t* row = dst + i * BPS;
    row[0] = Clip8(row[0] + (Wrap16(a + d) >> 3));
    row[1] = Clip8(row[1] + (Wrap16(b + c) >> 3));
    row[2] = Clip8(row[2] + (Wrap16(b - c) >> 3));
    row[3] = Clip8(row[3] + (Wrap16(a - d) >> 3));
  }
}

// FFmpeg's WHT: with only a DC coefficient, its C shortcut (no wrap); else
// its SIMD transform, the exact sums wrapped to 16 bits before the shift.
inline void InverseWht16(const int16_t* in, bool dc_only, int16_t* out) {
  if (dc_only) {
    for (int k = 0; k < 16; ++k) out[16 * k] = static_cast<int16_t>((in[0] + 3) >> 3);
    return;
  }
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[64 * i + 0] = static_cast<int16_t>(Wrap16(a0 + a1) >> 3);
    out[64 * i + 16] = static_cast<int16_t>(Wrap16(a3 + a2) >> 3);
    out[64 * i + 32] = static_cast<int16_t>(Wrap16(a0 - a1) >> 3);
    out[64 * i + 48] = static_cast<int16_t>(Wrap16(a3 - a2) >> 3);
  }
}

// ---- loop filter (RFC 6386 section 15, in libwebp's arrangement)

inline int SignedClip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline int Sclip1(int v) { return SignedClip(v, -128, 127); }
inline int Sclip2(int v) { return SignedClip(v, -16, 15); }

inline void Filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + Sclip1(p1 - q1);
  const int a1 = Sclip2((a + 4) >> 3);
  const int a2 = Sclip2((a + 3) >> 3);
  p[-step] = Clip8(p0 + a2);
  p[0] = Clip8(q0 - a1);
}
inline void Filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = Sclip2((a + 4) >> 3);
  const int a2 = Sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip8(p1 + a3);
  p[-step] = Clip8(p0 + a2);
  p[0] = Clip8(q0 - a1);
  p[step] = Clip8(q1 - a3);
}
inline void Filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = Sclip1(3 * (q0 - p0) + Sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip8(p2 + a3);
  p[-2 * step] = Clip8(p1 + a2);
  p[-step] = Clip8(p0 + a1);
  p[0] = Clip8(q0 - a1);
  p[step] = Clip8(q1 - a2);
  p[2 * step] = Clip8(q2 - a3);
}
inline bool Hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
inline bool NeedsFilter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `step` crosses the edge, `along` walks it.
inline void SimpleEdge(uint8_t* p, int step, int along, int thresh) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along) {
    if (NeedsFilter(p, step, t)) Filter2(p, step);
  }
}
inline void NormalEdge(uint8_t* p, int step, int along, int size, int thresh, int ithresh, int hev_thresh, bool mb_edge) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!NeedsFilter2(p, step, t, ithresh)) continue;
    if (Hev(p, step, hev_thresh)) {
      Filter2(p, step);
    } else if (mb_edge) {
      Filter6(p, step);
    } else {
      Filter4(p, step);
    }
  }
}

// ---- inter frames (RFC 6386 sections 16-18)

// The probabilities of the mode tree (ZEROMV | NEARESTMV | NEARMV | NEWMV /
// SPLITMV), each by the weight of its near vector.
static const uint8_t kModeContexts[6][4] = {
    {7, 1, 1, 143}, {14, 18, 14, 107}, {135, 64, 57, 68}, {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28}};
// Motion vector probabilities, row then column: is-long, sign, the short
// tree (7), the long form's bits 0-9.
static const uint8_t kMvProba0[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
static const uint8_t kMvUpdateProba[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
// Intra macroblocks of inter frames: the 16x16 and chroma mode trees'
// default probabilities (updated by frame headers) and the fixed ones of
// the 4x4 modes, which take no context.
static const uint8_t kYModeProba0[4] = {112, 86, 140, 37};
static const uint8_t kUvModeProba0[3] = {162, 101, 204};
static const uint8_t kBModeProbaInter[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
// SPLITMV: the partitioning tree, the sub-vector tree by the left and above
// vectors' context, and each 4x4 block's partition for 16x8, 8x16, 8x8, 4x4.
static const uint8_t kSplitProba[3] = {110, 111, 150};
static const uint8_t kSubMvProba[5][3] = {{147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
static const uint8_t kSplits[4][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                       {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                       {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                       {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
static const uint8_t kSplitCount[4] = {2, 2, 4, 16};
// Six-tap sub-pixel filters by the eighth-pixel phase (version 0).
static const int kSixtap[8][6] = {{0, 0, 128, 0, 0, 0},  {0, -6, 123, 12, -1, 0}, {2, -11, 108, 36, -8, 1},
                                  {0, -9, 93, 50, -6, 0},  {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
                                  {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};

// Macroblock modes: the intra ones, then the inter ones.
enum : uint8_t { B_PRED = 4, ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV, kNumModes };
enum : uint8_t { kIntraFrame = 0, kLastFrame, kGoldenFrame, kAltRefFrame };
constexpr uint8_t kNoSplit = 4;

// A motion vector in quarter pixels of luma.
struct Mv {
  int16_t x = 0, y = 0;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool IsZero() const { return x == 0 && y == 0; }
};

struct MacroBlock {
  uint8_t segment = 0, ymode = DC_PRED, uvmode = DC_PRED, ref = kIntraFrame, partitioning = kNoSplit;
  bool skip = false;  // the skip flag: no coefficients coded
  uint8_t imodes[16] = {};
  Mv mv;       // the macroblock's vector (SPLITMV: its last partition's)
  Mv bmv[16];  // each 4x4 block's vector (zero in intra macroblocks)
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

inline int ClipQ(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }

struct Quant {
  int y1[2], y2[2], uv[2];
};

// A picture on the macroblock grid: luma 16 mb_w x 16 mb_h, each chroma
// plane half that in both directions, rows packed.
struct Picture {
  int mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;
  void Allocate(int mbw, int mbh) {
    mb_w = mbw;
    mb_h = mbh;
    y.assign(static_cast<size_t>(256) * mb_w * mb_h, 0);
    u.assign(static_cast<size_t>(64) * mb_w * mb_h, 0);
    v.assign(u.size(), 0);
  }
  int y_stride() const { return 16 * mb_w; }
  int uv_stride() const { return 8 * mb_w; }
};

// Whose rules a key frame follows where libwebp and FFmpeg differ: a
// macroblock's inner edges are filtered when it has a non-zero coefficient
// (libwebp) or any coefficient token (FFmpeg, libvpx); segments reset to
// absolute values (libwebp) or to deltas (FFmpeg); FFmpeg also reads the
// scaling bits, the colour space and the clamping type, which the video
// decoder refuses.
enum Flavor { kLibwebp, kFfmpeg };

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// What the caller needs from a frame header to update the references.
struct FrameHeader {
  bool key = false, show = false;
  int version = 0;
  bool refresh_golden = true, refresh_altref = true, refresh_last = true;
  int copy_to_golden = 0, copy_to_altref = 0;  // 1: from the last frame, 2: from the other one
};

// Counts over the frames a decoder has decoded, in this order.
enum Stat {
  kFrames, kKeyFrames, kHiddenFrames,
  kModes,                                        // 10: DC_PRED .. SPLITMV macroblocks
  kRefs = kModes + kNumModes,                    // 4: intra, last, golden, altref macroblocks
  kSplitKinds = kRefs + 4,                       // 4: SPLITMV 16x8, 8x16, 8x8, 4x4
  kVersions = kSplitKinds + 4,                   // 4: frames of versions 0-3
  kGoldenRefreshes = kVersions + 4, kAltRefRefreshes, kGoldenFromLast, kGoldenFromAltRef, kAltRefFromLast,
  kAltRefFromGolden, kSegmentedFrames, kSegmentMapUpdates, kSegmentMapsKept, kSegmentDataUpdates,
  kEntropyNotRefreshed, kSignBiasGolden, kSignBiasAltRef,
  kPartitions,                                   // 4: frames of 1, 2, 4, 8 token partitions
  kLfDeltaUpdates = kPartitions + 4, kSimpleFilterFrames, kNormalFilterFrames, kMbsFarOutside,
  kMbsLargeCoefficients,  // a dequantised coefficient of 2^14 or more: FFmpeg's 16-bit transforms wrap
  kNumStats
};

class FrameDecoder {
 public:
  explicit FrameDecoder(Flavor flavor) : flavor_(flavor) {}

  int width() const { return width_; }
  int height() const { return height_; }
  const int64_t* stats() const { return stats_; }

  // Decodes one frame into `out`, predicting inter macroblocks from
  // refs[0..2] (last, golden, altref; unused by key frames). Throws
  // Corrupt or Unsupported.
  FrameHeader Decode(const uint8_t* data, size_t size, Picture& out, const Picture* const* refs) {
    if (size < 3) throw Corrupt("a frame of " + std::to_string(size) + " bytes (no frame tag)");
    const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
    FrameHeader hdr;
    hdr.key = !(bits & 1);
    hdr.version = (bits >> 1) & 7;
    hdr.show = (bits >> 4) & 1;
    const size_t part0_size = bits >> 5;
    if (hdr.version > 3) throw Unsupported("VP8 version " + std::to_string(hdr.version) + " (RFC 6386 defines 0-3)");
    data += 3;
    size -= 3;
    if (hdr.key) {
      if (size < 7) throw Corrupt("a key frame header cut short");
      if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a) throw Corrupt("a key frame without its start code");
      const int w = (data[3] | data[4] << 8) & 0x3fff, h = (data[5] | data[6] << 8) & 0x3fff;
      if (flavor_ == kFfmpeg && ((data[4] | data[6]) >> 6))
        throw Unsupported("VP8 frame scaling (horizontal_scale / vertical_scale set in a key frame)");
      if (w == 0 || h == 0) throw Corrupt("a key frame of size 0");
      if (width_ && (w != width_ || h != height_))
        throw Unsupported("a frame size that changes mid-stream (" + std::to_string(width_) + "x" +
                          std::to_string(height_) + " to " + std::to_string(w) + "x" + std::to_string(h) + ")");
      width_ = w;
      height_ = h;
      mb_w_ = (w + 15) >> 4;
      mb_h_ = (h + 15) >> 4;
      data += 7;
      size -= 7;
    } else if (!width_) {
      throw Corrupt("an inter frame before the first key frame");
    }
    if (part0_size > size) throw Corrupt("a first partition that runs past the frame");
    key_ = hdr.key;
    version_ = hdr.version;
    if (out.mb_w != mb_w_ || out.mb_h != mb_h_) out.Allocate(mb_w_, mb_h_);
    BoolDecoder br;
    br.Init(data, part0_size);
    if (key_) {
      ResetForKeyFrame();
      const int colour_space = br.Get(), clamping_type = br.Get();
      if (flavor_ == kFfmpeg && colour_space) throw Unsupported("VP8 colour space 1 (reserved)");
      if (flavor_ == kFfmpeg && clamping_type)
        throw Unsupported("VP8 clamping_type 1 (FFmpeg then marks the frame full-range)");
    }
    ParseSegmentHeader(br);
    ParseFilterHeader(br);
    ParsePartitions(data + part0_size, size - part0_size, br);
    ParseQuant(br);
    if (!key_) {
      hdr.refresh_golden = br.Get();
      hdr.refresh_altref = br.Get();
      if (!hdr.refresh_golden) hdr.copy_to_golden = br.GetValue(2);
      if (!hdr.refresh_altref) hdr.copy_to_altref = br.GetValue(2);
      sign_bias_[kGoldenFrame] = br.Get();
      sign_bias_[kAltRefFrame] = br.Get();
    }
    const bool refresh_entropy = br.Get();
    if (!refresh_entropy) saved_ = proba_;
    if (!key_) hdr.refresh_last = br.Get();
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b) {
        for (int c = 0; c < 3; ++c) {
          for (int p = 0; p < 11; ++p) {
            if (br.GetBit(kCoeffsUpdateProba[t][b][c][p])) proba_.coeffs[t][b][c][p] = br.GetValue(8);
          }
        }
      }
    }
    use_skip_proba_ = br.Get();
    if (use_skip_proba_) skip_proba_ = br.GetValue(8);
    if (!key_) {
      prob_intra_ = br.GetValue(8);
      prob_last_ = br.GetValue(8);
      prob_golden_ = br.GetValue(8);
      if (br.Get()) {
        for (uint8_t& p : proba_.ymode) p = br.GetValue(8);
      }
      if (br.Get()) {
        for (uint8_t& p : proba_.uvmode) p = br.GetValue(8);
      }
      for (int i = 0; i < 2; ++i) {
        for (int j = 0; j < 19; ++j) {
          if (br.GetBit(kMvUpdateProba[i][j])) {
            const int v = br.GetValue(7);
            proba_.mv[i][j] = v ? v << 1 : 1;
          }
        }
      }
    }
    Reconstruct(br, out, refs);
    if (filter_type_ > 0) LoopFilter(out);
    if (!refresh_entropy) proba_ = saved_;
    Count(hdr, refresh_entropy);
    return hdr;
  }

 private:
  struct Probas {
    uint8_t coeffs[4][8][3][11];
    uint8_t ymode[4], uvmode[3];
    uint8_t mv[2][19];
  };
  struct Segmentation {
    bool enabled = false, update_map = false, update_data = false, absolute = false;
    int quantizer[4] = {0, 0, 0, 0}, filter_level[4] = {0, 0, 0, 0};
    int proba[3] = {255, 255, 255};
  };

  void ResetForKeyFrame() {
    std::memcpy(proba_.coeffs, kCoeffsProba0, sizeof(proba_.coeffs));
    std::memcpy(proba_.ymode, kYModeProba0, sizeof(proba_.ymode));
    std::memcpy(proba_.uvmode, kUvModeProba0, sizeof(proba_.uvmode));
    std::memcpy(proba_.mv, kMvProba0, sizeof(proba_.mv));
    seg_ = Segmentation();
    seg_.absolute = flavor_ == kLibwebp;
    use_lf_delta_ = false;
    std::memset(ref_lf_delta_, 0, sizeof(ref_lf_delta_));
    std::memset(mode_lf_delta_, 0, sizeof(mode_lf_delta_));
    sign_bias_[kGoldenFrame] = sign_bias_[kAltRefFrame] = 0;
  }

  void ParseSegmentHeader(BoolDecoder& br) {
    seg_.enabled = br.Get();
    seg_.update_map = seg_.update_data = false;
    if (!seg_.enabled) return;
    seg_.update_map = br.Get();
    seg_.update_data = br.Get();
    if (seg_.update_data) {
      seg_.absolute = br.Get();
      for (int& q : seg_.quantizer) q = br.Get() ? br.GetSignedValue(7) : 0;
      for (int& f : seg_.filter_level) f = br.Get() ? br.GetSignedValue(6) : 0;
    }
    if (seg_.update_map) {
      for (int& p : seg_.proba) p = br.Get() ? br.GetValue(8) : 255;
    }
  }
  void ParseFilterHeader(BoolDecoder& br) {
    simple_ = br.Get();
    level_ = br.GetValue(6);
    sharpness_ = br.GetValue(3);
    use_lf_delta_ = br.Get();
    lf_delta_update_ = false;
    if (use_lf_delta_ && br.Get()) {
      lf_delta_update_ = true;
      for (int& d : ref_lf_delta_) {
        if (br.Get()) d = br.GetSignedValue(6);
      }
      for (int& d : mode_lf_delta_) {
        if (br.Get()) d = br.GetSignedValue(6);
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }
  void ParsePartitions(const uint8_t* data, size_t size, BoolDecoder& br) {
    const int last = (1 << br.GetValue(2)) - 1;
    num_parts_ = last + 1;
    if (size < static_cast<size_t>(3 * last)) throw Corrupt("the token partition sizes run past the frame");
    const uint8_t* sizes = data;
    const uint8_t* start = data + 3 * last;
    size_t left = size - 3 * last;
    for (int p = 0; p < last; ++p) {
      size_t psize = sizes[0] | sizes[1] << 8 | sizes[2] << 16;
      if (psize > left) {
        if (flavor_ == kFfmpeg) throw Corrupt("a token partition that runs past the frame");
        psize = left;
      }
      parts_[p].Init(start, psize);
      start += psize;
      left -= psize;
      sizes += 3;
    }
    parts_[last].Init(start, left);
    if (left == 0 && flavor_ == kLibwebp) throw Corrupt("an empty last token partition");
  }
  void ParseQuant(BoolDecoder& br) {
    const int base_q0 = br.GetValue(7);
    const int dqy1_dc = br.Get() ? br.GetSignedValue(4) : 0;
    const int dqy2_dc = br.Get() ? br.GetSignedValue(4) : 0;
    const int dqy2_ac = br.Get() ? br.GetSignedValue(4) : 0;
    const int dquv_dc = br.Get() ? br.GetSignedValue(4) : 0;
    const int dquv_ac = br.Get() ? br.GetSignedValue(4) : 0;
    for (int s = 0; s < 4; ++s) {
      const int q = seg_.enabled ? seg_.quantizer[s] + (seg_.absolute ? 0 : base_q0) : base_q0;
      Quant& m = quant_[s];
      m.y1[0] = kDcTable[ClipQ(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[ClipQ(q, 127)];
      m.y2[0] = kDcTable[ClipQ(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[ClipQ(q + dqy2_ac, 127)] * 101581) >> 16;  // = x * 155 / 100 on the table
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[ClipQ(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[ClipQ(q + dquv_ac, 127)];
    }
  }

  // ---- modes

  static int ReadBMode(BoolDecoder& br, const uint8_t* prob) {
    return !br.GetBit(prob[0])   ? B_DC
           : !br.GetBit(prob[1]) ? B_TM
           : !br.GetBit(prob[2]) ? B_VE
           : !br.GetBit(prob[3]) ? (!br.GetBit(prob[4]) ? B_HE : (!br.GetBit(prob[5]) ? B_RD : B_VR))
                                 : (!br.GetBit(prob[6])   ? B_LD
                                    : !br.GetBit(prob[7]) ? B_VL
                                    : !br.GetBit(prob[8]) ? B_HD
                                                          : B_HU);
  }

  // A key frame's modes: the 4x4 modes' probabilities by the modes above and to the left.
  void ParseKeyFrameModes(BoolDecoder& br, MacroBlock& mb, uint8_t* top, uint8_t* left) {
    if (!br.GetBit(145)) {
      mb.ymode = B_PRED;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          ymode = ReadBMode(br, kBModesProba[top[x]][ymode]);
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(mb.imodes + 4 * y, top, 4);
        left[y] = static_cast<uint8_t>(ymode);
      }
    } else {
      mb.ymode = br.GetBit(156) ? (br.GetBit(128) ? TM_PRED : H_PRED) : (br.GetBit(163) ? V_PRED : DC_PRED);
      std::memset(top, mb.ymode, 4);
      std::memset(left, mb.ymode, 4);
    }
    mb.uvmode = !br.GetBit(142) ? DC_PRED : !br.GetBit(114) ? V_PRED : br.GetBit(183) ? TM_PRED : H_PRED;
  }

  // An intra macroblock of an inter frame (RFC 6386 section 16.1): the trees
  // of the frame's probabilities, the 4x4 modes without context.
  void ParseIntraModes(BoolDecoder& br, MacroBlock& mb) {
    const uint8_t* p = proba_.ymode;
    mb.ymode = !br.GetBit(p[0])   ? DC_PRED
               : !br.GetBit(p[1]) ? (!br.GetBit(p[2]) ? V_PRED : H_PRED)
                                  : (!br.GetBit(p[3]) ? static_cast<uint8_t>(TM_PRED) : B_PRED);
    if (mb.ymode == B_PRED) {
      for (uint8_t& m : mb.imodes) m = static_cast<uint8_t>(ReadBMode(br, kBModeProbaInter));
    }
    const uint8_t* q = proba_.uvmode;
    mb.uvmode = !br.GetBit(q[0]) ? DC_PRED : !br.GetBit(q[1]) ? V_PRED : !br.GetBit(q[2]) ? H_PRED : TM_PRED;
  }

  static int ReadMvComponent(BoolDecoder& br, const uint8_t* p) {
    int x = 0;
    if (br.GetBit(p[0])) {  // the long form: bits 0-2, 9-4, then bit 3 unless implied
      for (int i = 0; i < 3; ++i) x += br.GetBit(p[9 + i]) << i;
      for (int i = 9; i > 3; --i) x += br.GetBit(p[9 + i]) << i;
      if (!(x & 0xfff0) || br.GetBit(p[9 + 3])) x += 8;
    } else {  // the short tree
      const int b2 = br.GetBit(p[2]);
      const int b1 = br.GetBit(p[3 + 3 * b2]);
      x = 4 * b2 + 2 * b1 + br.GetBit(p[4 + 3 * b2 + b1]);
    }
    return x && br.GetBit(p[1]) ? -x : x;
  }
  Mv ReadMv(BoolDecoder& br, Mv base) {
    base.y = static_cast<int16_t>(base.y + ReadMvComponent(br, proba_.mv[0]));
    base.x = static_cast<int16_t>(base.x + ReadMvComponent(br, proba_.mv[1]));
    return base;
  }
  // A near vector clamped to reach at most 16 pixels past the macroblock grid.
  Mv Clamp(Mv mv, int mb_x, int mb_y) const {
    auto clamp = [](int v, int lo, int hi) { return static_cast<int16_t>(v < lo ? lo : v > hi ? hi : v); };
    mv.x = clamp(mv.x, -64 * (mb_x + 1), 64 * (mb_w_ - mb_x));
    mv.y = clamp(mv.y, -64 * (mb_y + 1), 64 * (mb_h_ - mb_y));
    return mv;
  }

  // An inter macroblock (RFC 6386 sections 16.2-16.4): its reference, the
  // near vectors of the macroblocks above, to the left and above-left
  // (sign-corrected by the references' sign bias), the mode and its vectors.
  void ParseInterModes(BoolDecoder& br, MacroBlock& mb, int mb_x, int mb_y) {
    static const MacroBlock kOutside;
    mb.ref = br.GetBit(prob_last_) ? (br.GetBit(prob_golden_) ? kAltRefFrame : kGoldenFrame) : kLastFrame;
    const MacroBlock* here = &mbs_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
    const MacroBlock& above = mb_y > 0 ? here[-mb_w_] : kOutside;
    const MacroBlock& left = mb_x > 0 ? here[-1] : kOutside;
    const MacroBlock& above_left = mb_y > 0 && mb_x > 0 ? here[-mb_w_ - 1] : kOutside;
    const MacroBlock* edges[3] = {&above, &left, &above_left};
    Mv near_mv[4];
    int cnt[4] = {0, 0, 0, 0}, idx = 0;
    for (int n = 0; n < 3; ++n) {
      const MacroBlock& e = *edges[n];
      if (e.ref == kIntraFrame) continue;
      const int weight = n == 2 ? 1 : 2;
      if (e.mv.IsZero()) {
        cnt[0] += weight;
        continue;
      }
      Mv mv = e.mv;
      if (sign_bias_[e.ref] != sign_bias_[mb.ref]) {
        mv.x = static_cast<int16_t>(-mv.x);
        mv.y = static_cast<int16_t>(-mv.y);
      }
      if (n == 0 || !(mv == near_mv[idx])) near_mv[++idx] = mv;
      cnt[idx] += weight;
    }
    Mv mv;
    if (!br.GetBit(kModeContexts[cnt[0]][0])) {
      mb.ymode = ZEROMV;
    } else {
      if (cnt[3] && near_mv[1] == near_mv[3]) cnt[1] += 1;
      if (cnt[2] > cnt[1]) {
        std::swap(cnt[1], cnt[2]);
        std::swap(near_mv[1], near_mv[2]);
      }
      if (!br.GetBit(kModeContexts[cnt[1]][1])) {
        mb.ymode = NEARESTMV;
        mv = Clamp(near_mv[1], mb_x, mb_y);
      } else if (!br.GetBit(kModeContexts[cnt[2]][2])) {
        mb.ymode = NEARMV;
        mv = Clamp(near_mv[2], mb_x, mb_y);
      } else {
        const Mv best = Clamp(near_mv[cnt[1] >= cnt[0] ? 1 : 0], mb_x, mb_y);
        const int split_ctx =
            2 * ((left.ymode == SPLITMV) + (above.ymode == SPLITMV)) + (above_left.ymode == SPLITMV);
        if (br.GetBit(kModeContexts[split_ctx][3])) {
          mb.ymode = SPLITMV;
          ParseSplit(br, mb, best, left, above);
          return;
        }
        mb.ymode = NEWMV;
        mv = ReadMv(br, best);
      }
    }
    mb.mv = mv;
    for (Mv& b : mb.bmv) b = mv;
  }

  // SPLITMV: the partitioning, then each partition's vector: the left or the
  // above 4x4 block's (across the macroblock edge, the neighbour's block;
  // an intra or absent neighbour's is zero), zero, or new from `best`.
  void ParseSplit(BoolDecoder& br, MacroBlock& mb, Mv best, const MacroBlock& left, const MacroBlock& above) {
    const int part = !br.GetBit(kSplitProba[0]) ? 3 : !br.GetBit(kSplitProba[1]) ? 2 : br.GetBit(kSplitProba[2]);
    mb.partitioning = static_cast<uint8_t>(part);
    const uint8_t* map = kSplits[part];
    for (int n = 0; n < kSplitCount[part]; ++n) {
      int k = 0;
      while (map[k] != n) ++k;
      const Mv l = (k & 3) ? mb.bmv[k - 1] : left.bmv[k + 3];
      const Mv a = k > 3 ? mb.bmv[k - 4] : above.bmv[k + 12];
      const int ctx = l == a ? (l.IsZero() ? 4 : 3) : a.IsZero() ? 2 : l.IsZero() ? 1 : 0;
      const uint8_t* p = kSubMvProba[ctx];
      Mv mv;
      if (!br.GetBit(p[0])) {
        mv = l;
      } else if (!br.GetBit(p[1])) {
        mv = a;
      } else if (br.GetBit(p[2])) {
        mv = ReadMv(br, best);
      }
      for (int b = k; b < 16; ++b) {
        if (map[b] == n) mb.bmv[b] = mv;
      }
      mb.mv = mv;
    }
  }

  // The segment (kept from the frame before where the map is not updated,
  // zero without segmentation), the skip flag and the modes.
  void ParseModes(BoolDecoder& br, MacroBlock& mb, int mb_x, int mb_y, uint8_t* top, uint8_t* left) {
    uint8_t& segment = segment_map_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
    if (seg_.update_map) {
      segment = static_cast<uint8_t>(!br.GetBit(seg_.proba[0]) ? br.GetBit(seg_.proba[1])
                                                                : br.GetBit(seg_.proba[2]) + 2);
    } else if (!seg_.enabled) {
      segment = 0;
    }
    mb.segment = segment;
    mb.skip = use_skip_proba_ ? br.GetBit(skip_proba_) : false;
    if (key_) {
      ParseKeyFrameModes(br, mb, top, left);
    } else if (br.GetBit(prob_intra_)) {
      ParseInterModes(br, mb, mb_x, mb_y);
    } else {
      ParseIntraModes(br, mb);
    }
  }

  // ---- coefficients

  int GetLargeValue(BoolDecoder& br, const uint8_t* p) {
    int v;
    if (!br.GetBit(p[3])) {
      v = !br.GetBit(p[4]) ? 2 : 3 + br.GetBit(p[5]);
    } else if (!br.GetBit(p[6])) {
      if (!br.GetBit(p[7])) {
        v = 5 + br.GetBit(159);
      } else {
        v = 7 + 2 * br.GetBit(165);
        v += br.GetBit(145);
      }
    } else {
      const int bit1 = br.GetBit(p[8]);
      const int bit0 = br.GetBit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.GetBit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // One block's tokens from position n; returns the position after the
  // last coefficient read (n when the block is empty).
  int GetCoeffs(BoolDecoder& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = proba_.coeffs[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.GetBit(p[0])) return n;
      while (!br.GetBit(p[1])) {
        p = proba_.coeffs[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.GetBit(p[2])) {
        v = 1;
        p = proba_.coeffs[type][kBands[n + 1]][1];
      } else {
        v = GetLargeValue(br, p);
        p = proba_.coeffs[type][kBands[n + 1]][2];
      }
      const int coeff = (br.Get() ? -v : v) * dq[n > 0];
      large_coefficient_ |= coeff >= 16384 || coeff <= -16384;
      out[kZigzag[n]] = static_cast<int16_t>(coeff);
    }
    return 16;
  }

  // Parses one macroblock's coefficients into coeffs (16 Y, 4 U, 4 V
  // blocks; the Y2 block's inverse WHT into the Y blocks' DC where the mode
  // has one). Returns the blocks with a non-zero coefficient (bit n: block
  // n); *tokens tells whether any block, Y2 included, holds a token.
  uint32_t ParseResiduals(BoolDecoder& br, const MacroBlock& mb, bool has_y2, int mb_x, int16_t* coeffs,
                          bool* tokens) {
    const Quant& q = quant_[mb.segment];
    uint8_t* tnz = top_nz_.data() + 9 * mb_x;  // 4 Y, 2 U, 2 V, Y2
    uint8_t* lnz = left_nz_;
    uint32_t nonzero = 0;
    bool any = false;
    int first = 0, type = 3;
    if (has_y2) {
      int16_t dc[16] = {0};
      const int nz = GetCoeffs(br, 1, tnz[8] + lnz[8], q.y2, 0, dc);
      tnz[8] = lnz[8] = nz > 0;
      any = nz > 0;
      if (nz > 0 && flavor_ == kFfmpeg) {
        InverseWht16(dc, nz == 1, coeffs);
      } else if (nz > 0) {
        InverseWht(dc, coeffs);
      }
      first = 1;
      type = 0;
    }
    for (int y = 0; y < 4; ++y) {
      for (int x = 0; x < 4; ++x) {
        int16_t* block = coeffs + 16 * (4 * y + x);
        const int nz = GetCoeffs(br, type, lnz[y] + tnz[x], q.y1, first, block);
        lnz[y] = tnz[x] = nz > first;
        any |= nz > first;
        if (nz > 1 || block[0] != 0) nonzero |= 1u << (4 * y + x);
      }
    }
    for (int ch = 0; ch < 2; ++ch) {
      for (int y = 0; y < 2; ++y) {
        for (int x = 0; x < 2; ++x) {
          const int n = 16 + 4 * ch + 2 * y + x;
          int16_t* block = coeffs + 16 * n;
          const int nz = GetCoeffs(br, 2, lnz[4 + 2 * ch + y] + tnz[4 + 2 * ch + x], q.uv, 0, block);
          lnz[4 + 2 * ch + y] = tnz[4 + 2 * ch + x] = nz > 0;
          any |= nz > 0;
          if (nz > 1 || block[0] != 0) nonzero |= 1u << n;
        }
      }
    }
    *tokens = any;
    return nonzero;
  }

  // ---- inter prediction

  // A w x h block of `plane` (pw x ph, on the macroblock grid) at (x, y)
  // displaced by (mx, my) eighths of a pixel, into dst (BPS stride): the
  // six-tap filters (version 0) or the bilinear ones (versions 1-3), each
  // pass rounded and clipped, the horizontal one first; outside the plane
  // the edge pixels repeat without end. Returns whether the block's
  // position lies wholly outside the plane.
  bool PredictInter(const uint8_t* plane, int pw, int ph, int x, int y, int mx, int my, int w, int h,
                    uint8_t* dst) const {
    x += mx >> 3;
    y += my >> 3;
    const int fx = mx & 7, fy = my & 7;
    constexpr int kWin = 21;
    uint8_t win[kWin * kWin];
    const uint8_t* src;
    int ss;
    if (x >= 2 && y >= 2 && x + w + 3 <= pw && y + h + 3 <= ph) {  // the filter taps lie inside the plane
      src = plane + static_cast<size_t>(y) * pw + x;
      ss = pw;
    } else {
      int cols[kWin];
      for (int c = 0; c < w + 5; ++c) cols[c] = std::min(std::max(x - 2 + c, 0), pw - 1);
      for (int r = 0; r < h + 5; ++r) {
        const uint8_t* row = plane + static_cast<size_t>(std::min(std::max(y - 2 + r, 0), ph - 1)) * pw;
        for (int c = 0; c < w + 5; ++c) win[r * kWin + c] = row[cols[c]];
      }
      src = win + 2 * kWin + 2;
      ss = kWin;
    }
    uint8_t tmp[kWin * 16];
    const uint8_t* rows = src;
    int rs = ss;
    if (version_ == 0) {
      if (fx) {
        const int* f = kSixtap[fx];
        for (int r = -2; r < h + 3; ++r) {
          const uint8_t* s = src + r * ss;
          uint8_t* t = tmp + (r + 2) * 16;
          for (int c = 0; c < w; ++c) {
            t[c] = Clip8((f[0] * s[c - 2] + f[1] * s[c - 1] + f[2] * s[c] + f[3] * s[c + 1] + f[4] * s[c + 2] +
                          f[5] * s[c + 3] + 64) >> 7);
          }
        }
        rows = tmp + 2 * 16;
        rs = 16;
      }
      if (fy) {
        const int* f = kSixtap[fy];
        for (int r = 0; r < h; ++r) {
          const uint8_t* s = rows + r * rs;
          for (int c = 0; c < w; ++c) {
            dst[r * BPS + c] = Clip8((f[0] * s[c - 2 * rs] + f[1] * s[c - rs] + f[2] * s[c] + f[3] * s[c + rs] +
                                      f[4] * s[c + 2 * rs] + f[5] * s[c + 3 * rs] + 64) >> 7);
          }
        }
      } else {
        for (int r = 0; r < h; ++r) std::memcpy(dst + r * BPS, rows + r * rs, w);
      }
    } else {
      if (fx) {
        for (int r = 0; r <= h; ++r) {
          const uint8_t* s = src + r * ss;
          for (int c = 0; c < w; ++c) tmp[r * 16 + c] = static_cast<uint8_t>((s[c] * (8 - fx) + s[c + 1] * fx + 4) >> 3);
        }
        rows = tmp;
        rs = 16;
      }
      if (fy) {
        for (int r = 0; r < h; ++r) {
          const uint8_t* s = rows + r * rs;
          for (int c = 0; c < w; ++c) {
            dst[r * BPS + c] = static_cast<uint8_t>((s[c] * (8 - fy) + s[c + rs] * fy + 4) >> 3);
          }
        }
      } else {
        for (int r = 0; r < h; ++r) std::memcpy(dst + r * BPS, rows + r * rs, w);
      }
    }
    return x + w <= 0 || x >= pw || y + h <= 0 || y >= ph;
  }

  // The macroblock's prediction from `ref` into the work buffers. Luma
  // vectors are quarter pixels, taken as eighths; a chroma vector, in
  // eighths of a chroma pixel, is the luma vector, or in SPLITMV the rounded
  // mean of its four 4x4 blocks' vectors; version 3 drops its fraction.
  void InterPredict(const MacroBlock& mb, int mb_x, int mb_y, const Picture& ref, uint8_t* y_dst, uint8_t* u_dst,
                    uint8_t* v_dst) {
    const int pw = 16 * mb_w_, ph = 16 * mb_h_, x0 = 16 * mb_x, y0 = 16 * mb_y;
    const int full_pixel = version_ == 3 ? ~7 : ~0;
    bool outside = false;
    if (mb.ymode != SPLITMV) {
      outside = PredictInter(ref.y.data(), pw, ph, x0, y0, 2 * mb.mv.x, 2 * mb.mv.y, 16, 16, y_dst);
      const int ux = mb.mv.x & full_pixel, uy = mb.mv.y & full_pixel;
      PredictInter(ref.u.data(), pw / 2, ph / 2, x0 / 2, y0 / 2, ux, uy, 8, 8, u_dst);
      PredictInter(ref.v.data(), pw / 2, ph / 2, x0 / 2, y0 / 2, ux, uy, 8, 8, v_dst);
    } else {
      for (int n = 0; n < 16; ++n) {
        const int bx = 4 * (n & 3), by = 4 * (n >> 2);
        outside |= PredictInter(ref.y.data(), pw, ph, x0 + bx, y0 + by, 2 * mb.bmv[n].x, 2 * mb.bmv[n].y, 4, 4,
                                y_dst + by * BPS + bx);
      }
      for (int n = 0; n < 4; ++n) {
        const int bx = 4 * (n & 1), by = 4 * (n >> 1), k = 8 * (n >> 1) + 2 * (n & 1);
        int sx = mb.bmv[k].x + mb.bmv[k + 1].x + mb.bmv[k + 4].x + mb.bmv[k + 5].x;
        int sy = mb.bmv[k].y + mb.bmv[k + 1].y + mb.bmv[k + 4].y + mb.bmv[k + 5].y;
        sx = ((sx + 2 + (sx < 0 ? -1 : 0)) >> 2) & full_pixel;
        sy = ((sy + 2 + (sy < 0 ? -1 : 0)) >> 2) & full_pixel;
        const int cx = x0 / 2 + bx, cy = y0 / 2 + by;
        PredictInter(ref.u.data(), pw / 2, ph / 2, cx, cy, sx, sy, 4, 4, u_dst + by * BPS + bx);
        PredictInter(ref.v.data(), pw / 2, ph / 2, cx, cy, sx, sy, 4, 4, v_dst + by * BPS + bx);
      }
    }
    stats_[kMbsFarOutside] += outside;
  }

  // ---- reconstruction and loop filter

  void Idct(const int16_t* in, uint8_t* dst) const {
    if (flavor_ == kFfmpeg) {
      InverseDct16(in, dst);
    } else {
      InverseDct(in, dst);
    }
  }

  FilterInfo Strength(const MacroBlock& mb, bool coded) const {
    FilterInfo info;
    int level = seg_.enabled ? seg_.filter_level[mb.segment] + (seg_.absolute ? 0 : level_) : level_;
    if (use_lf_delta_) {
      level += ref_lf_delta_[mb.ref];
      if (mb.ymode == B_PRED) {
        level += mode_lf_delta_[0];
      } else if (mb.ymode == ZEROMV) {
        level += mode_lf_delta_[1];
      } else if (mb.ymode == SPLITMV) {
        level += mode_lf_delta_[3];
      } else if (mb.ymode > ZEROMV) {
        level += mode_lf_delta_[2];
      }
    }
    level = level < 0 ? 0 : level > 63 ? 63 : level;
    if (level == 0) return info;
    int ilevel = level;
    if (sharpness_ > 0) {
      ilevel >>= sharpness_ > 4 ? 2 : 1;
      if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
    }
    if (ilevel < 1) ilevel = 1;
    info.ilevel = ilevel;
    info.limit = 2 * level + ilevel;
    info.hev_thresh = key_ ? (level >= 40 ? 2 : level >= 15 ? 1 : 0)
                           : (level >= 40 ? 3 : level >= 20 ? 2 : level >= 15 ? 1 : 0);
    info.inner = coded || mb.ymode == B_PRED || mb.ymode == SPLITMV;
    return info;
  }

  // Every macroblock, unfiltered: intra ones predicted from this frame's
  // unfiltered pixels (the work buffers hold the row above and the columns
  // to the left), inter ones from the (filtered) references.
  void Reconstruct(BoolDecoder& br, Picture& out, const Picture* const* refs) {
    const int stride = out.y_stride(), uv_stride = out.uv_stride();
    mbs_.assign(static_cast<size_t>(mb_w_) * mb_h_, MacroBlock());
    segment_map_.resize(mbs_.size(), 0);
    finfo_.assign(mbs_.size(), FilterInfo());
    top_nz_.assign(9 * static_cast<size_t>(mb_w_), 0);
    std::vector<uint8_t> intra_top(4 * static_cast<size_t>(mb_w_), B_DC);
    std::vector<uint8_t> top_y(16 * static_cast<size_t>(mb_w_)), top_u(8 * static_cast<size_t>(mb_w_)),
        top_v(8 * static_cast<size_t>(mb_w_));
    int16_t coeffs[384];
    // Work buffers: row -1 holds the samples above, columns -4..-1 those to the left.
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t* const y_dst = ybuf + BPS + 8;
    uint8_t* const u_dst = ubuf + BPS + 8;
    uint8_t* const v_dst = vbuf + BPS + 8;
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t intra_left[4];
      std::memset(intra_left, B_DC, 4);
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      std::memset(left_nz_, 0, sizeof(left_nz_));
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MacroBlock& mb = mbs_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        ParseModes(br, mb, mb_x, mb_y, intra_top.data() + 4 * mb_x, intra_left);
        const bool has_y2 = mb.ymode != B_PRED && mb.ymode != SPLITMV;
        std::memset(coeffs, 0, sizeof(coeffs));
        uint32_t nonzero = 0;
        bool tokens_read = false;
        if (!mb.skip) {
          large_coefficient_ = false;
          nonzero = ParseResiduals(tokens, mb, has_y2, mb_x, coeffs, &tokens_read);
          stats_[kMbsLargeCoefficients] += large_coefficient_;
        } else {
          std::memset(left_nz_, 0, 8);
          std::memset(top_nz_.data() + 9 * mb_x, 0, 8);
          if (has_y2) left_nz_[8] = top_nz_[9 * mb_x + 8] = 0;
        }
        if (filter_type_ > 0) {
          finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] =
              Strength(mb, flavor_ == kFfmpeg ? tokens_read : nonzero != 0);
        }
        ++stats_[kModes + mb.ymode];
        ++stats_[kRefs + mb.ref];
        if (mb.ymode == SPLITMV) ++stats_[kSplitKinds + mb.partitioning];
        if (mb_x > 0) {  // rotate in the left samples
          for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
          for (int j = -1; j < 8; ++j) {
            std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
            std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
          }
        }
        if (mb_y > 0) {
          std::memcpy(y_dst - BPS, top_y.data() + 16 * mb_x, 16);
          std::memcpy(u_dst - BPS, top_u.data() + 8 * mb_x, 8);
          std::memcpy(v_dst - BPS, top_v.data() + 8 * mb_x, 8);
        }
        if (mb.ref != kIntraFrame) {
          InterPredict(mb, mb_x, mb_y, *refs[mb.ref - 1], y_dst, u_dst, v_dst);
        } else if (mb.ymode == B_PRED) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w_ - 1) {
              std::memset(top_right, top_y[16 * mb_x + 15], 4);
            } else {
              std::memcpy(top_right, top_y.data() + 16 * (mb_x + 1), 4);
            }
          }
          for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        } else {
          PredictBlock(y_dst, 16, mb.ymode, mb_x, mb_y);
        }
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          if (mb.ref == kIntraFrame && mb.ymode == B_PRED) Predict4(dst, mb.imodes[n]);
          if (nonzero >> n & 1) Idct(coeffs + 16 * n, dst);
        }
        if (mb.ref == kIntraFrame) {
          PredictBlock(u_dst, 8, mb.uvmode, mb_x, mb_y);
          PredictBlock(v_dst, 8, mb.uvmode, mb_x, mb_y);
        }
        for (int n = 0; n < 4; ++n) {
          const int offset = (n & 1) * 4 + (n >> 1) * 4 * BPS;
          if (nonzero >> (16 + n) & 1) Idct(coeffs + 16 * (16 + n), u_dst + offset);
          if (nonzero >> (20 + n) & 1) Idct(coeffs + 16 * (20 + n), v_dst + offset);
        }
        std::memcpy(top_y.data() + 16 * mb_x, y_dst + 15 * BPS, 16);
        std::memcpy(top_u.data() + 8 * mb_x, u_dst + 7 * BPS, 8);
        std::memcpy(top_v.data() + 8 * mb_x, v_dst + 7 * BPS, 8);
        for (int j = 0; j < 16; ++j) {
          std::memcpy(&out.y[(static_cast<size_t>(mb_y) * 16 + j) * stride + 16 * mb_x], y_dst + j * BPS, 16);
        }
        for (int j = 0; j < 8; ++j) {
          std::memcpy(&out.u[(static_cast<size_t>(mb_y) * 8 + j) * uv_stride + 8 * mb_x], u_dst + j * BPS, 8);
          std::memcpy(&out.v[(static_cast<size_t>(mb_y) * 8 + j) * uv_stride + 8 * mb_x], v_dst + j * BPS, 8);
        }
      }
    }
  }

  void LoopFilter(Picture& out) {
    const int ys = out.y_stride(), uvs = out.uv_stride();
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        if (f.limit == 0) continue;
        uint8_t* y = &out.y[static_cast<size_t>(mb_y) * 16 * ys + 16 * mb_x];
        if (filter_type_ == 1) {
          if (mb_x > 0) SimpleEdge(y, 1, ys, f.limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) SimpleEdge(y + k, 1, ys, f.limit);
          }
          if (mb_y > 0) SimpleEdge(y, ys, 1, f.limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) SimpleEdge(y + k * ys, ys, 1, f.limit);
          }
          continue;
        }
        uint8_t* u = &out.u[static_cast<size_t>(mb_y) * 8 * uvs + 8 * mb_x];
        uint8_t* v = &out.v[static_cast<size_t>(mb_y) * 8 * uvs + 8 * mb_x];
        const int t = f.limit, it = f.ilevel, hev = f.hev_thresh;
        if (mb_x > 0) {
          NormalEdge(y, 1, ys, 16, t + 4, it, hev, true);
          NormalEdge(u, 1, uvs, 8, t + 4, it, hev, true);
          NormalEdge(v, 1, uvs, 8, t + 4, it, hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) NormalEdge(y + k, 1, ys, 16, t, it, hev, false);
          NormalEdge(u + 4, 1, uvs, 8, t, it, hev, false);
          NormalEdge(v + 4, 1, uvs, 8, t, it, hev, false);
        }
        if (mb_y > 0) {
          NormalEdge(y, ys, 1, 16, t + 4, it, hev, true);
          NormalEdge(u, uvs, 1, 8, t + 4, it, hev, true);
          NormalEdge(v, uvs, 1, 8, t + 4, it, hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) NormalEdge(y + k * ys, ys, 1, 16, t, it, hev, false);
          NormalEdge(u + 4 * uvs, uvs, 1, 8, t, it, hev, false);
          NormalEdge(v + 4 * uvs, uvs, 1, 8, t, it, hev, false);
        }
      }
    }
  }

  void Count(const FrameHeader& hdr, bool refresh_entropy) {
    ++stats_[kFrames];
    stats_[kKeyFrames] += hdr.key;
    stats_[kHiddenFrames] += !hdr.show;
    ++stats_[kVersions + hdr.version];
    if (!hdr.key) {
      stats_[kGoldenRefreshes] += hdr.refresh_golden;
      stats_[kAltRefRefreshes] += hdr.refresh_altref;
      stats_[kGoldenFromLast] += hdr.copy_to_golden == 1;
      stats_[kGoldenFromAltRef] += hdr.copy_to_golden == 2;
      stats_[kAltRefFromLast] += hdr.copy_to_altref == 1;
      stats_[kAltRefFromGolden] += hdr.copy_to_altref == 2;
      stats_[kSignBiasGolden] += sign_bias_[kGoldenFrame];
      stats_[kSignBiasAltRef] += sign_bias_[kAltRefFrame];
    }
    stats_[kSegmentedFrames] += seg_.enabled;
    stats_[kSegmentMapUpdates] += seg_.update_map;
    stats_[kSegmentMapsKept] += seg_.enabled && !seg_.update_map;
    stats_[kSegmentDataUpdates] += seg_.update_data;
    stats_[kEntropyNotRefreshed] += !refresh_entropy;
    ++stats_[kPartitions + (num_parts_ == 1 ? 0 : num_parts_ == 2 ? 1 : num_parts_ == 4 ? 2 : 3)];
    stats_[kLfDeltaUpdates] += lf_delta_update_;
    stats_[kSimpleFilterFrames] += filter_type_ == 1;
    stats_[kNormalFilterFrames] += filter_type_ == 2;
  }

  const Flavor flavor_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  bool key_ = true;
  int version_ = 0;
  Segmentation seg_;
  bool simple_ = false, use_lf_delta_ = false, lf_delta_update_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int sign_bias_[4] = {0, 0, 0, 0};
  int num_parts_ = 1;
  BoolDecoder parts_[8];
  Quant quant_[4];
  Probas proba_, saved_;
  bool use_skip_proba_ = false;
  int skip_proba_ = 0, prob_intra_ = 0, prob_last_ = 0, prob_golden_ = 0;
  std::vector<MacroBlock> mbs_;
  std::vector<uint8_t> segment_map_;
  std::vector<uint8_t> top_nz_;
  uint8_t left_nz_[9];
  std::vector<FilterInfo> finfo_;
  bool large_coefficient_ = false;
  int64_t stats_[kNumStats] = {};
};

}  // namespace sr_vp8
