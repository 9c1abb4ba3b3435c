"""A VP8 stream writer of random syntax (RFC 6386), for the port's tests.

``tests/test_torch_vp8.py`` holds the port's VP8 decoder against
``cv2.VideoCapture`` on streams this writer makes, because ``cv2.VideoWriter``
(libvpx at OpenCV's settings) never writes some of VP8's syntax: segmentation
with a map that is kept or updated, ``refresh_entropy_probs = 0``, sign bias
on the golden and altref references, 2-8 token partitions, loop-filter delta
updates, vectors far outside the picture, hidden frames, ``copy_buffer_to_*``
codes, every mode of inter frames, coefficients past the transforms' 16 bits. The writer has its own boolean encoder
and its own context code (the near vectors and their counts, the split and
sub-vector contexts, the token contexts), written from RFC 6386; what it
writes is random, and cv2.VideoCapture (FFmpeg) is the judge of what it
means. It counts the macroblocks it writes by mode and by reference, so a
test can check that the decoder read the modes the writer meant.

Key frames use the 16x16 intra modes only (B_PRED on key frames, with its
contextual probabilities, comes from cv2.VideoWriter's clips); coefficients
stay small enough that no 16-bit intermediate of FFmpeg's transforms
overflows, unless the stream asks for ``large_coefficients``.
"""

import copy
import struct

import numpy as np

# RFC 6386's tables: default coefficient probabilities and their update probabilities, [4][8][3][11]
# each, as bytes; the quantiser steps by index.
COEFF_PROBA0 = (
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a"
    "7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896"
    "f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfe"
    "fff5ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddac"
    "b0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ff"
    "ff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea"
    "80015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff80808080808080800186"
    "fcffff808080808080d53efaffff808080808080375dff808080808080808080808080808080808080808080808080808080808080808080"
    "8080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fc"
    "d3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4ad"
    "ffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
COEFF_UPDATE_PROBA = (
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9"
    "fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffffffffeffd"
    "fefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfe"
    "fffffffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdff"
    "fffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffff"
    "fffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffeffffff"
    "fffffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdfffffffffffffffff6fdfdff"
    "fffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffff"
    "fffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
DC_TABLE = [4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157]
AC_TABLE = [4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284]


MODE_CONTEXTS = [[7, 1, 1, 143], [14, 18, 14, 107], [135, 64, 57, 68], [60, 56, 128, 65], [159, 134, 128, 34],
                 [234, 188, 128, 28]]
MV_PROBA0 = [[162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254],
             [164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254]]
MV_UPDATE_PROBA = [[237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254],
                   [231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254]]
YMODE_PROBA0, UVMODE_PROBA0 = [112, 86, 140, 37], [162, 101, 204]
KF_YMODE_PROBA, KF_UVMODE_PROBA = [145, 156, 163, 128], [142, 114, 183]
BMODE_PROBA_INTER = [120, 90, 79, 133, 87, 85, 80, 111, 151]
SPLIT_PROBA = [110, 111, 150]
SUB_MV_PROBA = [[147, 136, 18], [106, 145, 1], [179, 121, 1], [223, 1, 34], [208, 1, 1]]
SPLITS = [[0] * 8 + [1] * 8, [0, 0, 1, 1] * 4, [0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3], list(range(16))]
BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
CAT_PROBA = {1: [159], 2: [165, 145], 3: [173, 148, 140], 4: [176, 155, 140, 135], 5: [180, 157, 141, 134, 130],
             6: [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]}
CAT_BASE = {1: 5, 2: 7, 3: 11, 4: 19, 5: 35, 6: 67}

# Modes, as the decoder's counts name them.
DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = "DC_PRED", "V_PRED", "H_PRED", "TM_PRED", "B_PRED"
ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV = "ZEROMV", "NEARESTMV", "NEARMV", "NEWMV", "SPLITMV"
INTRA, LAST, GOLDEN, ALTREF = 0, 1, 2, 3
REF_NAMES = ("intra_mbs", "last_mbs", "golden_mbs", "altref_mbs")


def _leaf(value):
    return ("leaf", value)


# Trees as RFC 6386 writes them: entry 2k and 2k + 1 are node k's branches, each the index of a node or a leaf.
KF_YMODE_TREE = [_leaf(B_PRED), 2, 4, 6, _leaf(DC_PRED), _leaf(V_PRED), _leaf(H_PRED), _leaf(TM_PRED)]
YMODE_TREE = [_leaf(DC_PRED), 2, 4, 6, _leaf(V_PRED), _leaf(H_PRED), _leaf(TM_PRED), _leaf(B_PRED)]
UVMODE_TREE = [_leaf(DC_PRED), 2, _leaf(V_PRED), 4, _leaf(H_PRED), _leaf(TM_PRED)]
BMODE_TREE = [_leaf(0), 2, _leaf(1), 4, _leaf(2), 6, 8, 12, _leaf(3), 10, _leaf(4), _leaf(5), _leaf(6), 14,
              _leaf(7), 16, _leaf(8), _leaf(9)]
MV_REF_TREE = [_leaf(ZEROMV), 2, _leaf(NEARESTMV), 4, _leaf(NEARMV), 6, _leaf(NEWMV), _leaf(SPLITMV)]
SPLIT_TREE = [_leaf(3), 2, _leaf(2), 4, _leaf(0), _leaf(1)]  # 4x4, 8x8, 16x8, 8x16
SUB_MV_TREE = [_leaf("left"), 2, _leaf("above"), 4, _leaf("zero"), _leaf("new")]
SEGMENT_TREE = [2, 4, _leaf(0), _leaf(1), _leaf(2), _leaf(3)]


def _paths(tree):
    """{leaf: [(node, bit), ...]} of a tree."""
    paths, stack = {}, [(0, [])]
    while stack:
        node, path = stack.pop()
        for bit in (0, 1):
            branch = tree[node + bit]
            step = path + [(node >> 1, bit)]
            if isinstance(branch, tuple):
                paths[branch[1]] = step
            else:
                stack.append((branch, step))
    return paths


_PATHS = {id(t): _paths(t) for t in (KF_YMODE_TREE, YMODE_TREE, UVMODE_TREE, BMODE_TREE, MV_REF_TREE, SPLIT_TREE,
                                     SUB_MV_TREE, SEGMENT_TREE)}


class BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3); ``data`` pads the end with 32 zero bits, as libvpx does."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):  # carry into the bytes written
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, value, bits):
        for b in reversed(range(bits)):
            self.put((value >> b) & 1)

    def signed(self, value, bits):
        """An optional signed value: a flag, then magnitude and sign (the frame header's delta fields)."""
        self.put(value != 0)
        if value:
            self.literal(abs(value), bits)
            self.put(value < 0)

    def tree(self, tree, probs, leaf):
        for node, bit in _PATHS[id(tree)][leaf]:
            self.put(bit, probs[node])

    def data(self):
        for _ in range(32):
            self.put(0)
        c, v = self.bit_count, self.bottom
        v <<= c & 7
        out = bytearray(self.out)
        for _ in range(c >> 3):
            v <<= 8
        for _ in range(4):
            out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(out)


def _table(hex_rows):
    """A [4][8][3][11] table of nested lists from its hex rows."""
    return np.frombuffer(bytes.fromhex("".join(hex_rows)), np.uint8).reshape(4, 8, 3, 11).tolist()


def _clamp(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


class _Mb:
    __slots__ = ("ref", "mode", "mv", "bmv")

    def __init__(self, ref=INTRA, mode=DC_PRED, mv=(0, 0)):
        self.ref, self.mode, self.mv, self.bmv = ref, mode, mv, [mv] * 16


_OUTSIDE = _Mb()
FEATURES = ("segmentation", "entropy", "sign_bias", "partitions", "lf_deltas", "far_mvs", "hidden", "copies",
            "large_coefficients")


class Vp8Writer:
    """Writes frames of random VP8 syntax at ``width`` x ``height``. Each frame draws its header and its
    macroblocks from ``rng``; ``features`` (a subset of :data:`FEATURES`) switches on the syntax the
    stream is meant to reach, ``version`` (0-3) is every frame's."""

    def __init__(self, width, height, rng, features=FEATURES, version=0):
        self.width, self.height, self.rng, self.features, self.version = width, height, rng, set(features), version
        self.mb_w, self.mb_h = (width + 15) // 16, (height + 15) // 16
        self.counts = {}
        self.coeffs = _table(COEFF_PROBA0)
        self.update_proba = _table(COEFF_UPDATE_PROBA)
        self.ymode, self.uvmode, self.mvp = list(YMODE_PROBA0), list(UVMODE_PROBA0), [list(p) for p in MV_PROBA0]
        self.seg_enabled, self.seg_absolute, self.seg_quant = False, False, [0] * 4
        self.sign_bias = [0, 0, 0, 0]
        self.have_key = False
        self.inter_frames = 0

    # ---- the frame header

    def frame(self, key=False, show=True, colour_space=0, clamping_type=0, scale=0):
        """One frame's bytes: a key frame (the first one must be) or an inter frame."""
        rng, f = self.rng, self.features
        key = key or not self.have_key
        self.have_key = True
        self.key = key
        h = BoolEncoder()
        if key:
            h.put(colour_space)
            h.put(clamping_type)
            self.coeffs = _table(COEFF_PROBA0)
            self.ymode, self.uvmode, self.mvp = list(YMODE_PROBA0), list(UVMODE_PROBA0), [list(p) for p in MV_PROBA0]
            self.seg_enabled, self.seg_absolute, self.seg_quant = False, False, [0] * 4
            self.sign_bias = [0, 0, 0, 0]
        # segmentation
        self.seg_enabled = "segmentation" in f and rng.random() < 0.8
        h.put(self.seg_enabled)
        self.seg_update_map, self.seg_proba = False, [255, 255, 255]
        if self.seg_enabled:
            self.seg_update_map = bool(rng.random() < 0.5)
            update_data = bool(rng.random() < 0.6)
            h.put(self.seg_update_map)
            h.put(update_data)
            if update_data:
                self.seg_absolute = bool(rng.random() < 0.3)
                h.put(self.seg_absolute)
                self.seg_quant = [int(rng.integers(0, 48)) if self.seg_absolute else int(rng.integers(-30, 31))
                                  if rng.random() < 0.8 else 0 for _ in range(4)]
                for q in self.seg_quant:
                    h.signed(q, 7)
                for _ in range(4):
                    h.signed(int(rng.integers(0, 64)) if self.seg_absolute else int(rng.integers(-40, 41))
                             if rng.random() < 0.8 else 0, 6)
            if self.seg_update_map:
                self.seg_proba = [int(rng.integers(1, 256)) if rng.random() < 0.7 else 255 for _ in range(3)]
                for p in self.seg_proba:
                    h.put(p != 255)
                    if p != 255:
                        h.literal(p, 8)
        # loop filter
        h.put(rng.random() < 0.3)  # simple
        h.literal(int(rng.integers(0, 64)) if rng.random() < 0.8 else 0, 6)
        h.literal(int(rng.integers(0, 8)), 3)
        lf_delta = "lf_deltas" in f and rng.random() < 0.8
        h.put(lf_delta)
        if lf_delta:
            update = rng.random() < 0.6
            h.put(update)
            if update:
                for _ in range(8):
                    flag = rng.random() < 0.6
                    h.put(flag)
                    if flag:
                        d = int(rng.integers(-63, 64))
                        h.literal(abs(d), 6)
                        h.put(d < 0)
        # token partitions
        self.parts = 1 << (int(rng.integers(1, 4)) if "partitions" in f else 0)
        h.literal(self.parts.bit_length() - 1, 2)
        # quantisers: small enough, with the deltas, that no transform overflows 16 bits unless asked
        q = int(rng.integers(0, 128 if "large_coefficients" in f else 40))
        h.literal(q, 7)
        deltas = [int(rng.integers(-15, 16)) if rng.random() < 0.4 else 0 for _ in range(5)]
        for d in deltas:
            h.signed(d, 4)
        qs = [(s + (0 if self.seg_absolute else q)) if self.seg_enabled else q for s in self.seg_quant]
        self.max_q = max(_clamp(x + max(deltas + [0]), 0, 127) for x in qs)
        # references
        if not key:
            refresh_golden, refresh_altref = rng.random() < 0.2, rng.random() < 0.2
            h.put(refresh_golden)
            h.put(refresh_altref)
            # copy_buffer_to_golden / _alternate: every code in turn (3 means none, as 0 does)
            copies = "copies" in f
            if not refresh_golden:
                h.literal(self.inter_frames % 4 if copies else 0, 2)
            if not refresh_altref:
                h.literal((self.inter_frames + 1) % 4 if copies else 0, 2)
            self.inter_frames += 1
            bias = "sign_bias" in f
            self.sign_bias = [0, 0, int(bias and rng.random() < 0.5), int(bias and rng.random() < 0.5)]
            h.put(self.sign_bias[GOLDEN])
            h.put(self.sign_bias[ALTREF])
        refresh_entropy = not ("entropy" in f and rng.random() < 0.5)
        h.put(refresh_entropy)
        saved = (copy.deepcopy(self.coeffs), list(self.ymode), list(self.uvmode), [list(p) for p in self.mvp])
        if not key:
            h.put(rng.random() < 0.8)  # refresh_last
        # coefficient probability updates
        update_rate = 0.02 if "entropy" in f else 0.0
        for i, j, k, m in np.ndindex(4, 8, 3, 11):
            update = rng.random() < update_rate
            h.put(update, self.update_proba[i][j][k][m])
            if update:
                self.coeffs[i][j][k][m] = int(rng.integers(1, 256))
                h.literal(self.coeffs[i][j][k][m], 8)
        self.skip_proba = int(rng.integers(1, 256)) if rng.random() < 0.7 else None
        h.put(self.skip_proba is not None)
        if self.skip_proba is not None:
            h.literal(self.skip_proba, 8)
        if not key:
            self.prob_intra, self.prob_last, self.prob_golden = (int(rng.integers(1, 256)) for _ in range(3))
            for p in (self.prob_intra, self.prob_last, self.prob_golden):
                h.literal(p, 8)
            for probs in (self.ymode, self.uvmode):
                update = "entropy" in f and rng.random() < 0.4
                h.put(update)
                if update:
                    for i in range(len(probs)):
                        probs[i] = int(rng.integers(1, 256))
                        h.literal(probs[i], 8)
            for i in range(2):
                for j in range(19):
                    update = "entropy" in f and rng.random() < 0.1
                    h.put(update, MV_UPDATE_PROBA[i][j])
                    if update:
                        v = int(rng.integers(0, 128))
                        h.literal(v, 7)
                        self.mvp[i][j] = v << 1 if v else 1
        tokens = [BoolEncoder() for _ in range(self.parts)]
        self._macroblocks(h, tokens)
        if not refresh_entropy:
            self.coeffs, self.ymode, self.uvmode, self.mvp = saved
        first = h.data()
        parts = [t.data() for t in tokens]
        tag = (0 if key else 1) | self.version << 1 | int(show) << 4 | len(first) << 5
        out = bytearray(struct.pack("<I", tag)[:3])
        if key:
            out += b"\x9d\x01\x2a" + struct.pack("<HH", self.width | scale << 14, self.height | scale << 14)
        out += first
        for p in parts[:-1]:
            out += struct.pack("<I", len(p))[:3]
        for p in parts:
            out += p
        return bytes(out)

    # ---- macroblocks

    def _count(self, name):
        self.counts[name] = self.counts.get(name, 0) + 1

    def _macroblocks(self, h, tokens):
        rng = self.rng
        self.mbs = [[None] * self.mb_w for _ in range(self.mb_h)]
        self.top_nz = [[0] * 9 for _ in range(self.mb_w)]
        for mb_y in range(self.mb_h):
            self.left_nz = [0] * 9
            t = tokens[mb_y % self.parts]
            for mb_x in range(self.mb_w):
                if self.seg_update_map:
                    h.tree(SEGMENT_TREE, self.seg_proba, int(rng.integers(0, 4)))
                skip = self.skip_proba is not None and rng.random() < 0.3
                if self.skip_proba is not None:
                    h.put(skip, self.skip_proba)
                mb = self._modes(h, mb_x, mb_y)
                self.mbs[mb_y][mb_x] = mb
                self._count(mb.mode)
                self._count(REF_NAMES[mb.ref])
                has_y2 = mb.mode not in (B_PRED, SPLITMV)
                if skip:
                    self.left_nz[:8] = [0] * 8
                    self.top_nz[mb_x][:8] = [0] * 8
                    if has_y2:
                        self.left_nz[8] = self.top_nz[mb_x][8] = 0
                else:
                    self._residuals(t, mb_x, has_y2)

    def _modes(self, h, mb_x, mb_y):
        rng = self.rng
        if self.key:
            mode = [DC_PRED, V_PRED, H_PRED, TM_PRED][int(rng.integers(0, 4))]
            h.tree(KF_YMODE_TREE, KF_YMODE_PROBA, mode)
            h.tree(UVMODE_TREE, KF_UVMODE_PROBA, [DC_PRED, V_PRED, H_PRED, TM_PRED][int(rng.integers(0, 4))])
            return _Mb(INTRA, mode)
        if rng.random() < 0.15:
            h.put(0, self.prob_intra)
            mode = [DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED][int(rng.integers(0, 5))]
            h.tree(YMODE_TREE, self.ymode, mode)
            if mode == B_PRED:
                for _ in range(16):
                    h.tree(BMODE_TREE, BMODE_PROBA_INTER, int(rng.integers(0, 10)))
            h.tree(UVMODE_TREE, self.uvmode, [DC_PRED, V_PRED, H_PRED, TM_PRED][int(rng.integers(0, 4))])
            return _Mb(INTRA, mode)
        h.put(1, self.prob_intra)
        ref = [LAST, GOLDEN, ALTREF][int(rng.integers(0, 3))]
        h.put(ref != LAST, self.prob_last)
        if ref != LAST:
            h.put(ref == ALTREF, self.prob_golden)
        above = self.mbs[mb_y - 1][mb_x] if mb_y else _OUTSIDE
        left = self.mbs[mb_y][mb_x - 1] if mb_x else _OUTSIDE
        above_left = self.mbs[mb_y - 1][mb_x - 1] if mb_y and mb_x else _OUTSIDE
        # the near vectors (RFC 6386 section 16.3)
        near, cnt = [(0, 0)] * 4, [0, 0, 0, 0]
        idx = 0
        for n, e in enumerate((above, left, above_left)):
            if e.ref == INTRA:
                continue
            weight = 1 if n == 2 else 2
            if e.mv == (0, 0):
                cnt[0] += weight
                continue
            mv = e.mv
            if self.sign_bias[e.ref] != self.sign_bias[ref]:
                mv = (-mv[0], -mv[1])
            if n == 0 or mv != near[idx]:
                idx += 1
                near[idx] = mv
            cnt[idx] += weight
        if cnt[3] and near[1] == near[3]:
            cnt[1] += 1
        if cnt[2] > cnt[1]:
            cnt[1], cnt[2] = cnt[2], cnt[1]
            near[1], near[2] = near[2], near[1]
        best = self._clamp_mv(near[1] if cnt[1] >= cnt[0] else near[0], mb_x, mb_y)
        split_ctx = 2 * ((left.mode == SPLITMV) + (above.mode == SPLITMV)) + (above_left.mode == SPLITMV)
        probs = [MODE_CONTEXTS[cnt[0]][0], MODE_CONTEXTS[cnt[1]][1], MODE_CONTEXTS[cnt[2]][2],
                 MODE_CONTEXTS[split_ctx][3]]
        mode = [ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV][int(rng.integers(0, 5))]
        h.tree(MV_REF_TREE, probs, mode)
        if mode == ZEROMV:
            return _Mb(ref, mode)
        if mode in (NEARESTMV, NEARMV):
            return _Mb(ref, mode, self._clamp_mv(near[1 if mode == NEARESTMV else 2], mb_x, mb_y))
        if mode == NEWMV:
            return _Mb(ref, mode, self._new_mv(h, best, mb_x, mb_y))
        mb = _Mb(ref, SPLITMV)
        part = int(rng.integers(0, 4))
        h.tree(SPLIT_TREE, SPLIT_PROBA, part)
        split = SPLITS[part]
        for n in range(max(split) + 1):
            k = split.index(n)
            lv = mb.bmv[k - 1] if k & 3 else left.bmv[k + 3]
            av = mb.bmv[k - 4] if k > 3 else above.bmv[k + 12]
            ctx = (4 if lv == (0, 0) else 3) if lv == av else 2 if av == (0, 0) else 1 if lv == (0, 0) else 0
            sub = ["left", "above", "zero", "new"][int(rng.integers(0, 4))]
            h.tree(SUB_MV_TREE, SUB_MV_PROBA[ctx], sub)
            mv = {"left": lv, "above": av, "zero": (0, 0)}.get(sub) or self._new_mv(h, best, mb_x, mb_y)
            mb.bmv = [mv if split[b] == n else mb.bmv[b] for b in range(16)]
            mb.mv = mv
        return mb

    def _clamp_mv(self, mv, mb_x, mb_y):
        return (_clamp(mv[0], -64 * (mb_x + 1), 64 * (self.mb_w - mb_x)),
                _clamp(mv[1], -64 * (mb_y + 1), 64 * (self.mb_h - mb_y)))

    def _new_mv(self, h, best, mb_x, mb_y):
        """A new vector, written as its difference from ``best`` (row first); quarter pixels."""
        rng = self.rng
        if "far_mvs" in self.features and rng.random() < 0.5:
            reach = 4 * (max(self.width, self.height) + 48)
            target = tuple(int(rng.integers(-reach, reach + 1)) for _ in range(2))
        else:
            target = tuple(b + int(rng.integers(-40, 41)) for b in best)
        delta = [_clamp(t - b, -1023, 1023) for t, b in zip(target, best)]
        for component, d in ((0, delta[1]), (1, delta[0])):
            self._mv_component(h, d, self.mvp[component])
        return (best[0] + delta[0], best[1] + delta[1])

    @staticmethod
    def _mv_component(h, v, p):
        a = abs(v)
        if a < 8:
            h.put(0, p[0])
            b2, b1 = a >> 2, (a >> 1) & 1
            h.put(b2, p[2])
            h.put(b1, p[3 + 3 * b2])
            h.put(a & 1, p[4 + 3 * b2 + b1])
        else:
            h.put(1, p[0])
            for i in range(3):
                h.put((a >> i) & 1, p[9 + i])
            for i in range(9, 3, -1):
                h.put((a >> i) & 1, p[9 + i])
            if a & 0xFFF0:
                h.put((a >> 3) & 1, p[12])
        if a:
            h.put(v < 0, p[1])

    # ---- coefficients

    def _block_values(self, first):
        """Random coefficient values at positions ``first``-15, within a budget of dequantised magnitude;
        None, now and then, for a block of ZERO tokens to its end (tokens, yet no coefficient: FFmpeg then
        filters the macroblock's inner edges, libwebp would not)."""
        rng = self.rng
        values = [0] * 16
        if rng.random() < 0.03:
            return None
        if rng.random() < 0.4:
            return values
        if "large_coefficients" in self.features and rng.random() < 0.5:  # past 16 bits, a DC alone or many
            for i in ([first] if rng.random() < 0.3 else range(first, 16)):
                if i == first or rng.random() < 0.5:
                    values[i] = int(rng.integers(-2114, 2115))
            return values
        budget = 3000 // (2 * AC_TABLE[self.max_q])  # in units of the largest step
        last = int(rng.integers(first, 16))
        for i in range(first, last + 1):
            r = rng.random()
            v = 0 if r < 0.5 else 1 if r < 0.75 else int(rng.integers(2, 11)) if r < 0.95 else int(rng.integers(11, 90))
            v = min(v, budget)
            budget -= v
            values[i] = -v if rng.random() < 0.5 else v
        return values

    def _residuals(self, t, mb_x, has_y2):
        tnz, lnz = self.top_nz[mb_x], self.left_nz
        first, kind = 0, 3
        if has_y2:
            n = self._tokens(t, 1, tnz[8] + lnz[8], 0, self._block_values(0))
            tnz[8] = lnz[8] = int(n > 0)
            first, kind = 1, 0
        for y in range(4):
            for x in range(4):
                n = self._tokens(t, kind, lnz[y] + tnz[x], first, self._block_values(first))
                lnz[y] = tnz[x] = int(n > first)
        for ch in range(2):
            for y in range(2):
                for x in range(2):
                    n = self._tokens(t, 2, lnz[4 + 2 * ch + y] + tnz[4 + 2 * ch + x], 0, self._block_values(0))
                    lnz[4 + 2 * ch + y] = tnz[4 + 2 * ch + x] = int(n > 0)

    def _tokens(self, t, kind, ctx, first, values):
        """Writes one block's tokens from position ``first``; returns the position after its last one."""
        if values is None:  # ZERO tokens to the end
            for i in range(first, 16):
                p = self.coeffs[kind][BANDS[i]][0 if i > first else ctx]
                if i == first:
                    t.put(1, p[0])
                t.put(0, p[1])
            return 16
        nonzero = [i for i in range(first, 16) if values[i]]
        last = nonzero[-1] if nonzero else first - 1
        after_zero = False
        for i in range(first, last + 1):
            p = self.coeffs[kind][BANDS[i]][ctx]
            if not after_zero:
                t.put(1, p[0])  # not the end of the block
            v = abs(values[i])
            t.put(v != 0, p[1])
            if v == 0:
                after_zero, ctx = True, 0
                continue
            after_zero = False
            if v == 1:
                t.put(0, p[2])
                ctx = 1
            else:
                t.put(1, p[2])
                ctx = 2
                if v <= 4:
                    t.put(0, p[3])
                    t.put(v != 2, p[4])
                    if v != 2:
                        t.put(v == 4, p[5])
                else:
                    t.put(1, p[3])
                    cat = next(c for c in (6, 5, 4, 3, 2, 1) if v >= CAT_BASE[c])
                    if cat <= 2:
                        t.put(0, p[6])
                        t.put(cat == 2, p[7])
                    else:
                        t.put(1, p[6])
                        t.put((cat - 3) >> 1, p[8])
                        t.put((cat - 3) & 1, p[9 + ((cat - 3) >> 1)])
                    extra, probs = v - CAT_BASE[cat], CAT_PROBA[cat]
                    for b, prob in enumerate(probs):
                        t.put((extra >> (len(probs) - 1 - b)) & 1, prob)
            t.put(values[i] < 0)
        if last < 15:
            t.put(0, self.coeffs[kind][BANDS[last + 1]][ctx][0])  # the end of the block
        return last + 1 if last >= first else 0


def ivf(frames, width, height, fourcc=b"VP80"):
    """An IVF file of ``frames``."""
    out = bytearray(struct.pack("<4sHH4sHHIII4x", b"DKIF", 0, 32, fourcc, width, height, 30, 1, len(frames)))
    for i, frame in enumerate(frames):
        out += struct.pack("<IQ", len(frame), i) + frame
    return bytes(out)
