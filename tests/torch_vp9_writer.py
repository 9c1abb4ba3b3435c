"""A VP9 stream writer of random syntax (profile 0), for the port's tests.

``tests/test_torch_vp9.py`` holds the port's VP9 decoder against
``cv2.VideoCapture`` on streams this writer makes, because ``cv2.VideoWriter``
(libvpx at OpenCV's settings) never writes most of VP9's syntax: backward
adaptation, segmentation (maps written, temporally predicted and carried,
every feature), intra-only frames, hidden frames in superframes followed by
``show_existing_frame``, compound prediction fixed and selected per block,
each fixed interpolation filter, lossless frames, tile rows and several tile
columns, ``reset_frame_context`` 2 and 3, ``error_resilient_mode``, all four
probability contexts, refreshes of every slot, loop-filter delta updates and
sharpness, vectors far outside the picture, odd sizes.

The writer has its own boolean encoder, its own probability contexts (the
specification's defaults from ``torch_vp9_tables.py``, forward updates,
backward adaptation) and its own context code (partitions, skip, transform
sizes, references, modes, filters, segment ids, coefficient tokens), written
from the VP9 Bitstream Specification with FFmpeg's reading of it where the
two part (which probability context an intra-only frame loads and saves, the
segmentation map a frame predicts from). What it writes is random, and
cv2.VideoCapture (FFmpeg) is the judge of what it means. It counts the
symbols and blocks it writes under the names of ``utils/vp9.py``'s
``STATS``, so a test can check that the decoder read what the writer meant.

Vectors are written at eighth-pixel precision with ``allow_high_precision_mv``
off, so that no bit depends on the candidate vectors (the clips of
``cv2.VideoWriter`` and libvpx cover high precision); coefficients stay small
enough that no 16-bit intermediate of FFmpeg's transforms overflows.
"""

import struct

import numpy as np

import torch_vp9_tables as T

FEATURES = ("adaptation", "segmentation", "intra_only", "hidden", "compound_fixed", "compound_select", "filters",
            "lossless", "tiles", "contexts", "error_resilient", "lf_deltas", "far_mvs", "odd_size")

DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, TM_PRED = range(10)
NEARESTMV, NEARMV, ZEROMV, NEWMV = 10, 11, 12, 13
INTRA_MODES = ("DC_PRED", "V_PRED", "H_PRED", "D45_PRED", "D135_PRED", "D117_PRED", "D153_PRED", "D207_PRED",
               "D63_PRED", "TM_PRED")
INTER_MODES = ("NEARESTMV", "NEARMV", "ZEROMV", "NEWMV")
REF_NAMES = ("intra_blocks", "last_blocks", "golden_blocks", "altref_blocks")
FILTER_NAMES = ("filter_regular", "filter_smooth", "filter_sharp", "filter_bilinear")
INTRA, LAST, GOLDEN, ALTREF = 0, 1, 2, 3
SWITCHABLE = 4
B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16, B32X32, B32X64, B64X32, B64X64 = range(13)
MI_W = (1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8)
MI_H = (1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8)
W4 = (1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16)
H4 = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16)
MAX_TX = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3)
SUBSIZE = {(0, B8X8): B8X8, (1, B8X8): B8X4, (2, B8X8): B4X8, (3, B8X8): B4X4,
           (0, B16X16): B16X16, (1, B16X16): B16X8, (2, B16X16): B8X16, (3, B16X16): B8X8,
           (0, B32X32): B32X32, (1, B32X32): B32X16, (2, B32X32): B16X32, (3, B32X32): B16X16,
           (0, B64X64): B64X64, (1, B64X64): B64X32, (2, B64X64): B32X64, (3, B64X64): B32X32}
ABOVE_PARTITION = (15, 15, 14, 14, 14, 12, 12, 12, 8, 8, 8, 0, 0)
LEFT_PARTITION = (15, 14, 15, 14, 12, 14, 12, 8, 12, 8, 0, 8, 0)
TX_BIGGEST = (0, 1, 2, 3, 3)
MODE_TO_TX_TYPE = (0, 1, 2, 0, 3, 1, 2, 2, 1, 3)  # DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST
# The two nearest motion-vector candidates of each block size, (column, row) in 8x8 units.
MV_REF_FIRST_TWO = (((0, -1), (-1, 0)),) * 4 + (((-1, 0), (0, -1)), ((0, -1), (-1, 0)), ((0, -1), (-1, 0)),
                                                ((-1, 0), (0, -1)), ((0, -1), (-1, 0)), ((1, -1), (-1, 1)),
                                                ((-1, 0), (0, -1)), ((0, -1), (-1, 0)), ((3, -1), (-1, 3)))
COUNTER_TO_CONTEXT = (2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6)
CAT_PROBS = {5: [159], 7: [165, 145], 11: [173, 148, 140], 19: [176, 155, 140, 135], 35: [180, 157, 141, 134, 130],
             67: [254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133, 130, 129]}
BAND_4X4 = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5)
BAND_BIG = tuple(0 if i == 0 else 1 if i < 3 else 2 if i < 6 else 3 if i < 10 else 4 if i < 21 else 5
                 for i in range(1024))

INTRA_MODE_TREE = (-DC_PRED, 2, -TM_PRED, 4, -V_PRED, 6, 8, 12, -H_PRED, 10, -D135_PRED, -D117_PRED, -D45_PRED, 14,
                   -D63_PRED, 16, -D153_PRED, -D207_PRED)
SEGMENT_TREE = (2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7)
PARTITION_TREE = (0, 2, -1, 4, -2, -3)
INTER_MODE_TREE = (-2, 2, 0, 4, -1, -3)  # offsets from NEARESTMV
INTERP_TREE = (0, 2, -1, -2)
MV_JOINT_TREE = (0, 2, -1, 4, -2, -3)
MV_CLASS_TREE = (0, 2, -1, 4, 6, 8, -2, -3, 10, 12, -4, -5, -6, 14, 16, 18, -7, -8, -9, -10)
MV_FP_TREE = (0, 2, -1, 4, -2, -3)
TOKEN_TREE = (2, 6, -2, 4, -3, -4, 8, 10, -5, -6, 12, 14, -7, -8, -9, -10)  # TWO.. on the Pareto probabilities
INV_MAP = tuple([7 + 13 * k for k in range(20)] + [v for v in range(1, 254) if (v - 7) % 13] + [253])


def _paths(tree):
    """{leaf: [(probability index, bit), ...]} of a tree in libvpx's layout (-leaf, or a node's index)."""
    paths = {}

    def walk(i, path):
        for bit in (0, 1):
            nxt, step = tree[i + bit], path + [(i >> 1, bit)]
            if nxt > 0:
                walk(nxt, step)
            else:
                paths[-nxt] = step
    walk(0, [])
    return paths


_PATHS = {id(t): _paths(t) for t in (INTRA_MODE_TREE, SEGMENT_TREE, PARTITION_TREE, INTER_MODE_TREE, INTERP_TREE,
                                      MV_JOINT_TREE, MV_CLASS_TREE, MV_FP_TREE, TOKEN_TREE)}


class BoolEncoder:
    """libvpx's vpx_writer: the boolean coder whose output VP9's decoder reads."""

    def __init__(self):
        self.low, self.range, self.count, self.buf = 0, 255, -24, bytearray()
        self.put(0)  # the marker bit

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        low, rng = self.low, split
        if bit:
            low += split
            rng = self.range - split
        shift = 8 - rng.bit_length()
        rng <<= shift
        count = self.count + shift
        if count >= 0:
            offset = shift - count
            if ((low << (offset - 1)) & 0xFFFFFFFF) & 0x80000000:
                x = len(self.buf) - 1
                while x >= 0 and self.buf[x] == 0xFF:
                    self.buf[x] = 0
                    x -= 1
                self.buf[x] += 1
            self.buf.append((low >> (24 - offset)) & 0xFF)
            low = (low << offset) & 0xFFFFFF
            shift, count = count, count - 8
        self.low, self.range, self.count = (low << shift) & 0xFFFFFFFF, rng, count

    def literal(self, value, bits):
        for i in range(bits - 1, -1, -1):
            self.put((value >> i) & 1)

    def tree(self, tree, probs, leaf):
        for node, bit in _PATHS[id(tree)][leaf]:
            self.put(bit, probs[node])

    def data(self):
        for _ in range(32):
            self.put(0)
        if (self.buf[-1] & 0xE0) == 0xC0:  # no byte that reads as a superframe marker at the end
            self.buf.append(0)
        return bytes(self.buf)


class BitWriter:
    """The uncompressed header: most significant bit first."""

    def __init__(self):
        self.bits = []

    def put(self, value, n=1):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def signed(self, value, n):
        self.put(abs(value), n)
        self.put(int(value < 0))

    def data(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


# --- probability contexts ---------------------------------------------------------------------

def default_probs():
    u8 = lambda v: np.array(v, np.int64)  # noqa: E731
    mv = [dict(sign=u8(128), classes=u8(c), class0=u8(cl0), bits=u8([136, 140, 148, 160, 176, 192, 224, 234, 234, 240]),
               class0_fp=u8([[128, 128, 64], [96, 112, 64]]), fp=u8([64, 96, 64]), class0_hp=u8(160), hp=u8(128))
          for c, cl0 in (([224, 144, 192, 168, 192, 176, 192, 198, 198, 245], 216),
                         ([216, 128, 176, 160, 176, 176, 192, 198, 198, 208], 208))]
    return dict(coef=u8(T.DEFAULT_COEF_PROBS).reshape(4, 2, 2, 6, 6, 3), y_mode=u8(T.Y_MODE_PROBS).reshape(4, 9),
                uv_mode=u8(T.UV_MODE_PROBS).reshape(10, 9), partition=u8(T.PARTITION_PROBS).reshape(16, 3),
                skip=u8([192, 128, 64]), tx8=u8([[100], [66]]), tx16=u8([[20, 152], [15, 101]]),
                tx32=u8([[3, 136, 37], [5, 52, 13]]), interp=u8([[235, 162], [36, 255], [34, 3], [149, 144]]),
                inter_mode=u8([[2, 173, 34], [7, 145, 85], [7, 166, 63], [7, 94, 66], [8, 64, 46], [17, 81, 31],
                               [25, 29, 30]]),
                intra_inter=u8([9, 102, 187, 225]), comp_inter=u8([239, 183, 119, 96, 41]),
                single_ref=u8([[33, 16], [77, 74], [142, 142], [172, 170], [238, 247]]),
                comp_ref=u8([50, 126, 123, 221, 226]), mv_joints=u8([32, 64, 96]), mv=mv)


def copy_probs(p):
    return {k: ([{a: b.copy() for a, b in c.items()} for c in v] if k == "mv" else v.copy()) for k, v in p.items()}


def zero_counts():
    z = lambda *s: np.zeros(s, np.int64)  # noqa: E731
    return dict(coef=z(4, 2, 2, 6, 6, 3), eob=z(4, 2, 2, 6, 6, 2), y_mode=z(4, 10), uv_mode=z(10, 10),
                partition=z(16, 4), skip=z(3, 2), tx8=z(2, 2), tx16=z(2, 3), tx32=z(2, 4), interp=z(4, 3),
                inter_mode=z(7, 4), intra_inter=z(4, 2), comp_inter=z(5, 2), single_ref=z(5, 2, 2), comp_ref=z(5, 2),
                mv_joints=z(4), mv=[dict(sign=z(2), classes=z(11), class0=z(2), bits=z(10, 2), class0_fp=z(2, 4),
                                         fp=z(4), class0_hp=z(2), hp=z(2)) for _ in range(2)])


def adapt_prob(arr, idx, ct0, ct1, max_count, factor):
    ct = int(ct0 + ct1)
    if not ct:
        return
    f = factor * min(ct, max_count) // max_count
    p1 = int(arr[idx])
    p2 = min(max(((int(ct0) << 8) + (ct >> 1)) // ct, 1), 255)
    arr[idx] = p1 + (((p2 - p1) * f + 128) >> 8)


def adapt_tree(arr, idx, tree, counts, max_count=20, factor=128):
    """Adapts the probabilities of ``tree`` (arr[idx + (node,)]) to leaf counts, as a sum over each branch."""
    def total(i):
        return sum(int(counts[leaf]) for leaf, path in _PATHS[id(tree)].items() if path[:len(i)] == i)
    nodes = {}
    for leaf, path in _PATHS[id(tree)].items():
        for k, (node, _) in enumerate(path):
            nodes[node] = path[:k]
    for node, prefix in nodes.items():
        adapt_prob(arr, idx + (node,), total(prefix + [(node, 0)]), total(prefix + [(node, 1)]), max_count, factor)


# --- forward updates --------------------------------------------------------------------------

def inv_remap(d, p):
    def recenter(v, m):
        if v > 2 * m:
            return v
        return m - ((v + 1) >> 1) if v & 1 else m + (v >> 1)
    v = INV_MAP[d]
    return 1 + recenter(v, p - 1) if p <= 128 else 255 - recenter(v, 255 - p)


def write_subexp(bd, d):
    if d < 16:
        bd.put(0)
        bd.literal(d, 4)
    elif d < 32:
        bd.put(1)
        bd.put(0)
        bd.literal(d - 16, 4)
    elif d < 64:
        bd.put(1)
        bd.put(1)
        bd.put(0)
        bd.literal(d - 32, 5)
    else:
        bd.put(1)
        bd.put(1)
        bd.put(1)
        v = d - 64
        if v < 65:
            bd.literal(v, 7)
        else:
            bd.literal((v + 65) >> 1, 7)
            bd.put((v + 65) & 1)


class _Block:
    __slots__ = ("bsize", "skip", "tx", "is_inter", "comp", "ref", "mode", "sub_modes", "filter", "seg_id", "row",
                 "col")

    def __init__(self, bsize, row, col):
        self.bsize, self.row, self.col = bsize, row, col
        self.skip = self.tx = self.is_inter = self.comp = self.filter = self.seg_id = 0
        self.ref, self.mode, self.sub_modes = [INTRA, -1], DC_PRED, [DC_PRED] * 4


class Vp9Writer:
    """Writes a VP9 stream of ``width`` x ``height`` frames with random syntax, reaching ``features``."""

    def __init__(self, width, height, rng, features=FEATURES):
        self.w, self.h, self.rng, self.features = width, height, rng, set(features)
        self.mi_cols, self.mi_rows = (width + 7) >> 3, (height + 7) >> 3
        self.sb_cols, self.sb_rows = (self.mi_cols + 7) >> 3, (self.mi_rows + 7) >> 3
        self.ctx = [default_probs() for _ in range(4)]
        self.slots = [None] * 8  # each a frame's segmentation map (None: empty)
        self.counts = {}
        self.cur_map = None          # the last decoded frame's segmentation map
        self.segmap_ref = None
        self.seg = dict(enabled=False, update_map=False, temporal=False, abs=False,
                        feature=np.zeros((8, 4), bool), data=np.zeros((8, 4), np.int64),
                        tree=[255] * 7, pred=[255] * 3)
        self.lf_ref_deltas, self.lf_mode_deltas = [1, 0, -1, -1], [0, 0]
        self.key = False

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def r(self, n):
        return int(self.rng.integers(n))

    def chance(self, p):
        return bool(self.rng.random() < p)

    # --- the stream ---------------------------------------------------------------------------

    def stream(self, frames):
        """``frames`` payloads; hidden frames ride in superframes or alone, shown again later."""
        payloads, hidden_slots = [], []
        f = self.features
        while len(payloads) < frames:
            i = len(payloads)
            if i == 0:
                payloads.append(self.frame(key=True))
                continue
            if hidden_slots and self.chance(0.5):
                slot = hidden_slots.pop(0)
                payloads.append(bytes([0x88 | slot]))  # show_existing_frame of that slot
                self.count("shown_again")
                continue
            kinds = []
            if "intra_only" in f:
                kinds.append("intra_only")
            if "hidden" in f:
                kinds.append("hidden")
            kind = kinds[self.r(len(kinds))] if kinds and self.chance(0.4) else "inter"
            if kind == "inter":
                payloads.append(self.frame(key=self.chance(0.05)))
                continue
            slot = self.r(8)
            hidden = self.frame(intra_only=kind == "intra_only", show=False, refresh=1 << slot)
            hidden_slots.append(slot)
            if self.chance(0.5):
                shown = self.frame()
                payloads.append(superframe([hidden, shown]))
                self.count("superframes")
            else:
                payloads.append(hidden)
        return payloads[:frames]

    # --- one frame ----------------------------------------------------------------------------

    def frame(self, key=False, show=True, intra_only=False, refresh=None):
        f, rng = self.features, self.rng
        prev_seg = dict(self.seg)
        retain = self.segmap_ref is not None and (not prev_seg["enabled"] or not prev_seg["update_map"])
        self.key, self.intra_only, self.show = key, intra_only, show
        intra = key or intra_only
        self.error_res = (not intra_only) and "error_resilient" in f and self.chance(0.3)
        bw = BitWriter()
        bw.put(2, 2)
        bw.put(0, 2)  # profile 0
        bw.put(0)     # show_existing_frame
        bw.put(0 if key else 1)
        bw.put(int(show))
        bw.put(int(self.error_res))
        self.sign_bias = [False] * 4
        self.allow_hp, self.interp_filter = False, 0
        reset = 0
        if key:
            bw.put(0x498342, 24)
            bw.put(0, 3)  # color_space BT.601
            bw.put(0)     # color_range
            bw.put(self.w - 1, 16)
            bw.put(self.h - 1, 16)
            bw.put(0)
            self.refresh = 0xFF
        else:
            if not show:
                bw.put(int(intra_only))
            if not self.error_res:
                reset = self.r(4) if "contexts" in f else 0
                bw.put(reset, 2)
            if intra_only:
                bw.put(0x498342, 24)
                self.refresh = refresh if refresh is not None else self.r(256)
                bw.put(self.refresh, 8)
                bw.put(self.w - 1, 16)
                bw.put(self.h - 1, 16)
                bw.put(0)
            else:
                self.refresh = refresh if refresh is not None else (1 << self.r(8) if "contexts" in f else 1)
                if self.chance(0.2):
                    self.refresh |= 1 << self.r(8)
                bw.put(self.refresh, 8)
                filled = [i for i in range(8) if self.slots[i] is not None]
                self.ref_slots = [filled[self.r(len(filled))] for _ in range(3)]
                compound = "compound_fixed" in f or "compound_select" in f
                for i, slot in enumerate(self.ref_slots):
                    bias = compound and i == 2 and not self.chance(0.2)
                    bw.put(slot, 3)
                    bw.put(int(bias))
                    self.sign_bias[LAST + i] = bias and not self.error_res
                bw.put(1)  # size from the first reference
                bw.put(0)  # no render size
                bw.put(0)  # allow_high_precision_mv
                if "filters" in f and self.chance(0.6):
                    bw.put(0)
                    literal = self.r(4)
                    bw.put(literal, 2)
                    self.interp_filter = (1, 0, 2, 3)[literal]
                else:
                    bw.put(1)
                    self.interp_filter = SWITCHABLE
        if self.error_res:
            self.refresh_ctx, self.parallel = False, True
        else:
            self.refresh_ctx = not ("contexts" in f and self.chance(0.25))
            self.parallel = not ("adaptation" in f and self.chance(0.85))
            bw.put(int(self.refresh_ctx))
            bw.put(int(self.parallel))
        ctx_read = self.r(4) if "contexts" in f else 0
        bw.put(ctx_read, 2)
        self.ctx_save = 0 if intra else ctx_read
        if key or self.error_res or intra_only:
            self.lf_ref_deltas, self.lf_mode_deltas = [1, 0, -1, -1], [0, 0]
            self.seg["feature"] = np.zeros((8, 4), bool)
            self.seg["data"] = np.zeros((8, 4), np.int64)
        if key or self.error_res or (intra_only and reset == 3):
            self.ctx = [default_probs() for _ in range(4)]
        elif intra_only and reset == 2:
            self.ctx[ctx_read] = default_probs()
        if intra_only:
            self.count("intra_only_frames")
        # loop filter
        self.lossless = "lossless" in f and self.chance(0.4)
        self.lf_level = 0 if self.lossless else self.r(64)
        self.sharpness = self.r(8) if "lf_deltas" in f else 0
        bw.put(self.lf_level, 6)
        bw.put(self.sharpness, 3)
        delta_enabled = "lf_deltas" in f and self.chance(0.7)
        bw.put(int(delta_enabled))
        if delta_enabled:
            update = self.chance(0.6)
            bw.put(int(update))
            if update:
                for deltas, n in ((self.lf_ref_deltas, 4), (self.lf_mode_deltas, 2)):
                    for i in range(n):
                        u = self.chance(0.5)
                        bw.put(int(u))
                        if u:
                            deltas[i] = self.r(127) - 63
                            bw.signed(deltas[i], 6)
        # quantisers
        if self.lossless:
            bw.put(0, 8)
            bw.put(0)
            bw.put(0)
            bw.put(0)
        else:
            bw.put(1 + self.r(50), 8)
            for _ in range(3):
                d = self.r(9) - 4 if self.chance(0.3) else 0
                bw.put(int(d != 0))
                if d:
                    bw.signed(d, 4)
        # segmentation
        s = self.seg
        s["enabled"] = "segmentation" in f and self.chance(0.8)
        bw.put(int(s["enabled"]))
        if s["enabled"]:
            s["update_map"] = self.chance(0.8 if intra else 0.6)
            bw.put(int(s["update_map"]))
            if s["update_map"]:
                s["tree"] = [self.r(255) + 1 if self.chance(0.7) else 255 for _ in range(7)]
                for p in s["tree"]:
                    bw.put(int(p != 255))
                    if p != 255:
                        bw.put(p, 8)
                s["temporal"] = (not intra) and self.chance(0.5)
                bw.put(int(s["temporal"]))
                if s["temporal"]:
                    s["pred"] = [self.r(255) + 1 if self.chance(0.7) else 255 for _ in range(3)]
                    for p in s["pred"]:
                        bw.put(int(p != 255))
                        if p != 255:
                            bw.put(p, 8)
            update_data = self.chance(0.6)
            bw.put(int(update_data))
            if update_data:
                s["abs"] = self.chance(0.3)
                bw.put(int(s["abs"]))
                for i in range(8):
                    for j, bits in enumerate((8, 6, 2, 0)):
                        on = self.chance(0.3 if j < 2 else 0.15)
                        if j == 2 and intra:
                            on = False
                        s["feature"][i, j] = on
                        bw.put(int(on))
                        v = 0
                        if on and bits:
                            if j == 0:
                                v = self.r(40) if s["abs"] else self.r(41) - 20
                            elif j == 1:
                                v = self.r(64) if s["abs"] else self.r(41) - 20
                            else:
                                v = self.r(4)
                            bw.put(abs(v), bits)
                            if j < 2:
                                bw.put(int(v < 0))
                        s["data"][i, j] = v
        # tiles
        min_log2, max_log2 = 0, 1
        while (64 << min_log2) < self.sb_cols:
            min_log2 += 1
        while (self.sb_cols >> max_log2) >= 4:
            max_log2 += 1
        max_log2 -= 1
        self.log2_cols = min_log2 + (self.r(max_log2 - min_log2 + 1) if "tiles" in f else 0)
        for _ in range(self.log2_cols - min_log2):
            bw.put(1)
        if self.log2_cols < max_log2:
            bw.put(0)
        self.log2_rows = 0
        if "tiles" in f and self.sb_rows >= 4:
            self.log2_rows = self.r(3)
        bw.put(int(self.log2_rows > 0))
        if self.log2_rows:
            bw.put(self.log2_rows - 1)
        # FFmpeg's references for segmentation prediction
        src = self.cur_map if (not intra and not self.error_res) else None
        if not retain or intra:
            self.segmap_ref = src
        self.prob = copy_probs(self.ctx[ctx_read])
        self.counters = zero_counts()
        compressed = self.compressed_header()
        tiles = self.tiles()
        bw.put(len(compressed), 16)
        self.save_contexts()
        for i in range(8):
            if self.refresh >> i & 1:
                self.slots[i] = self.seg_map
                self.count(f"refresh_slot_{i}")
        self.cur_map = self.seg_map
        self.count("frames")
        if key:
            self.count("key_frames")
        elif not intra_only:
            self.count("inter_frames")
        if not show:
            self.count("hidden_frames")
        return bw.data() + compressed + tiles

    # --- the compressed header ----------------------------------------------------------------

    def _update(self, bd, arr, idx, chance=0.08):
        u = self.chance(chance)
        bd.put(int(u), 252)
        if u:
            d = self.r(254)
            write_subexp(bd, d)
            arr[idx] = inv_remap(d, int(arr[idx]))

    def _mv_update(self, bd, arr, idx):
        u = self.chance(0.08)
        bd.put(int(u), 252)
        if u:
            v = self.r(128)
            bd.literal(v, 7)
            arr[idx] = (v << 1) | 1

    def compressed_header(self):
        bd, p, f = BoolEncoder(), self.prob, self.features
        intra = self.key or self.intra_only
        if self.lossless:
            self.tx_mode = 0
        else:
            self.tx_mode = self.r(5) if self.chance(0.8) else 4
            bd.literal(min(self.tx_mode, 3), 2)
            if self.tx_mode >= 3:
                bd.put(int(self.tx_mode == 4))
            if self.tx_mode == 4:
                for i in range(2):
                    self._update(bd, p["tx8"], (i, 0))
                for i in range(2):
                    for j in range(2):
                        self._update(bd, p["tx16"], (i, j))
                for i in range(2):
                    for j in range(3):
                        self._update(bd, p["tx32"], (i, j))
        for t in range(TX_BIGGEST[self.tx_mode] + 1):
            u = self.chance(0.3)
            bd.put(int(u))
            if u:
                for i in range(2):
                    for j in range(2):
                        for k in range(6):
                            for m in range(3 if k == 0 else 6):
                                for n in range(3):
                                    self._update(bd, p["coef"], (t, i, j, k, m, n), 0.03)
        for i in range(3):
            self._update(bd, p["skip"], (i,))
        self.ref_mode = 0
        if not intra:
            for i in range(7):
                for j in range(3):
                    self._update(bd, p["inter_mode"], (i, j))
            if self.interp_filter == SWITCHABLE:
                for i in range(4):
                    for j in range(2):
                        self._update(bd, p["interp"], (i, j))
            for i in range(4):
                self._update(bd, p["intra_inter"], (i,))
            sb = self.sign_bias
            if sb[LAST] != sb[GOLDEN] or sb[LAST] != sb[ALTREF]:
                modes = [0] + [1] * ("compound_fixed" in f) + [2] * ("compound_select" in f)
                self.ref_mode = modes[self.r(len(modes))]
                bd.put(int(self.ref_mode > 0))
                if self.ref_mode:
                    bd.put(int(self.ref_mode == 2))
                if sb[LAST] == sb[GOLDEN]:
                    self.comp_fixed, self.comp_var = ALTREF, (LAST, GOLDEN)
                elif sb[LAST] == sb[ALTREF]:
                    self.comp_fixed, self.comp_var = GOLDEN, (LAST, ALTREF)
                else:
                    self.comp_fixed, self.comp_var = LAST, (GOLDEN, ALTREF)
            if self.ref_mode == 2:
                for i in range(5):
                    self._update(bd, p["comp_inter"], (i,))
            if self.ref_mode != 1:
                for i in range(5):
                    self._update(bd, p["single_ref"], (i, 0))
                    self._update(bd, p["single_ref"], (i, 1))
            if self.ref_mode != 0:
                for i in range(5):
                    self._update(bd, p["comp_ref"], (i,))
            for i in range(4):
                for j in range(9):
                    self._update(bd, p["y_mode"], (i, j))
            for i in range(16):
                for j in range(3):
                    self._update(bd, p["partition"], (i, j))
            for j in range(3):
                self._mv_update(bd, p["mv_joints"], (j,))
            for i in range(2):
                c = p["mv"][i]
                self._mv_update(bd, c["sign"], ())
                for j in range(10):
                    self._mv_update(bd, c["classes"], (j,))
                self._mv_update(bd, c["class0"], ())
                for j in range(10):
                    self._mv_update(bd, c["bits"], (j,))
            for i in range(2):
                c = p["mv"][i]
                for j in range(2):
                    for k in range(3):
                        self._mv_update(bd, c["class0_fp"], (j, k))
                for k in range(3):
                    self._mv_update(bd, c["fp"], (k,))
        if not intra and self.interp_filter == SWITCHABLE:
            self.count("switchable_filter_frames")
        return bd.data()

    def save_contexts(self):
        if not self.refresh_ctx:
            return
        save = self.ctx[self.ctx_save]
        if self.parallel:
            for t in range(TX_BIGGEST[self.tx_mode] + 1):
                save["coef"][t] = self.prob["coef"][t]
            for k, v in copy_probs(self.prob).items():
                if k != "coef":
                    save[k] = v
            return
        self.adapt(save)

    def adapt(self, pc):
        """FFmpeg's backward adaptation of the saved context ``pc`` to this frame's counts."""
        n, intra = self.counters, self.key or self.intra_only
        uf = 112 if (intra or not self.last_key) else 128
        for t in range(4):
            for i in range(2):
                for j in range(2):
                    for k in range(6):
                        for m in range(3 if k == 0 else 6):
                            e, c = n["eob"][t, i, j, k, m], n["coef"][t, i, j, k, m]
                            idx = (t, i, j, k, m)
                            adapt_prob(pc["coef"], idx + (0,), e[0], e[1], 24, uf)
                            adapt_prob(pc["coef"], idx + (1,), c[0], c[1] + c[2], 24, uf)
                            adapt_prob(pc["coef"], idx + (2,), c[1], c[2], 24, uf)
        if intra:
            for k in ("skip", "tx8", "tx16", "tx32"):
                pc[k] = self.prob[k].copy()
            return
        for i in range(3):
            adapt_prob(pc["skip"], (i,), n["skip"][i, 0], n["skip"][i, 1], 20, 128)
        for i in range(4):
            adapt_prob(pc["intra_inter"], (i,), n["intra_inter"][i, 0], n["intra_inter"][i, 1], 20, 128)
        if self.ref_mode == 2:
            for i in range(5):
                adapt_prob(pc["comp_inter"], (i,), n["comp_inter"][i, 0], n["comp_inter"][i, 1], 20, 128)
        if self.ref_mode != 0:
            for i in range(5):
                adapt_prob(pc["comp_ref"], (i,), n["comp_ref"][i, 0], n["comp_ref"][i, 1], 20, 128)
        if self.ref_mode != 1:
            for i in range(5):
                for j in range(2):
                    adapt_prob(pc["single_ref"], (i, j), n["single_ref"][i, j, 0], n["single_ref"][i, j, 1], 20, 128)
        for i in range(16):
            adapt_tree(pc["partition"], (i,), PARTITION_TREE, n["partition"][i])
        if self.tx_mode == 4:
            for i in range(2):
                c8, c16, c32 = n["tx8"][i], n["tx16"][i], n["tx32"][i]
                adapt_prob(pc["tx8"], (i, 0), c8[0], c8[1], 20, 128)
                adapt_prob(pc["tx16"], (i, 0), c16[0], c16[1] + c16[2], 20, 128)
                adapt_prob(pc["tx16"], (i, 1), c16[1], c16[2], 20, 128)
                adapt_prob(pc["tx32"], (i, 0), c32[0], c32[1] + c32[2] + c32[3], 20, 128)
                adapt_prob(pc["tx32"], (i, 1), c32[1], c32[2] + c32[3], 20, 128)
                adapt_prob(pc["tx32"], (i, 2), c32[2], c32[3], 20, 128)
        if self.interp_filter == SWITCHABLE:
            for i in range(4):
                adapt_tree(pc["interp"], (i,), INTERP_TREE, n["interp"][i])
        for i in range(7):
            adapt_tree(pc["inter_mode"], (i,), INTER_MODE_TREE, n["inter_mode"][i])
        adapt_tree(pc["mv_joints"], (), MV_JOINT_TREE, n["mv_joints"])
        for i in range(2):
            q, c = pc["mv"][i], n["mv"][i]
            adapt_prob(q["sign"], (), c["sign"][0], c["sign"][1], 20, 128)
            adapt_tree(q["classes"], (), MV_CLASS_TREE, c["classes"])
            adapt_prob(q["class0"], (), c["class0"][0], c["class0"][1], 20, 128)
            for j in range(10):
                adapt_prob(q["bits"], (j,), c["bits"][j, 0], c["bits"][j, 1], 20, 128)
            for j in range(2):
                adapt_tree(q["class0_fp"], (j,), MV_FP_TREE, c["class0_fp"][j])
            adapt_tree(q["fp"], (), MV_FP_TREE, c["fp"])
        for i in range(4):
            adapt_tree(pc["y_mode"], (i,), INTRA_MODE_TREE, n["y_mode"][i])
        for i in range(10):
            adapt_tree(pc["uv_mode"], (i,), INTRA_MODE_TREE, n["uv_mode"][i])

    # --- tiles, partitions, blocks ------------------------------------------------------------

    def tiles(self):
        self.last_key = getattr(self, "prev_key", False)
        self.prev_key = self.key
        cols, rows = 1 << self.log2_cols, 1 << self.log2_rows
        self.above_partition = [0] * (self.sb_cols * 8 + 8)
        self.above_seg_pred = [0] * (self.sb_cols * 8 + 8)
        self.above_nnz = [[0] * (self.sb_cols * 16 + 16), [0] * (self.sb_cols * 8 + 8), [0] * (self.sb_cols * 8 + 8)]
        self.grid = {}
        self.seg_map = np.zeros((self.mi_rows, self.mi_cols), np.int64)
        if cols > 1:
            self.count("tile_col_frames")

        def offset(i, n, log2):
            return min((((i * ((n + 7) >> 3)) >> log2) << 3), n)
        out = b""
        for tr in range(rows):
            for tc in range(cols):
                bd = BoolEncoder()
                self.col_start = offset(tc, self.mi_cols, self.log2_cols)
                col_end = offset(tc + 1, self.mi_cols, self.log2_cols)
                for mi_row in range(offset(tr, self.mi_rows, self.log2_rows),
                                    offset(tr + 1, self.mi_rows, self.log2_rows), 8):
                    self.left_partition, self.left_seg_pred = [0] * 8, [0] * 8
                    self.left_nnz = [[0] * 16, [0] * 8, [0] * 8]
                    for mi_col in range(self.col_start, col_end, 8):
                        self.partition(bd, mi_row, mi_col, B64X64)
                data = bd.data()
                last = tr == rows - 1 and tc == cols - 1
                out += data if last else struct.pack(">I", len(data)) + data
        return out

    def partition(self, bd, mi_row, mi_col, bsize):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        n8 = MI_W[bsize]
        hbs = n8 >> 1
        bsl = {B8X8: 0, B16X16: 1, B32X32: 2, B64X64: 3}[bsize]
        ctx = bsl * 4 + ((self.left_partition[mi_row & 7] >> bsl) & 1) * 2 + ((self.above_partition[mi_col] >> bsl) & 1)
        intra = self.key or self.intra_only
        probs = T.KF_PARTITION_PROBS[3 * ctx:3 * ctx + 3] if intra else self.prob["partition"][ctx]
        has_rows, has_cols = mi_row + hbs < self.mi_rows, mi_col + hbs < self.mi_cols
        weights = {B64X64: (1, 1, 1, 6), B32X32: (2, 1, 1, 4), B16X16: (3, 1, 1, 3), B8X8: (5, 1, 1, 1)}[bsize]
        if hbs == 0 or (has_rows and has_cols):
            p = int(self.rng.choice(4, p=np.array(weights) / sum(weights)))
            bd.tree(PARTITION_TREE, probs, p)
        elif has_cols:
            p = 3 if self.chance(0.6) else 1
            bd.put(int(p == 3), probs[1])
        elif has_rows:
            p = 3 if self.chance(0.6) else 2
            bd.put(int(p == 3), probs[2])
        else:
            p = 3
        self.counters["partition"][ctx, p] += 1
        self.count(("partition_none", "partition_horz", "partition_vert", "partition_split")[p])
        sub = SUBSIZE[(p, bsize)]
        if hbs == 0:
            self.block(bd, mi_row, mi_col, sub)
        elif p == 0:
            self.block(bd, mi_row, mi_col, sub)
        elif p == 1:
            self.block(bd, mi_row, mi_col, sub)
            if has_rows:
                self.block(bd, mi_row + hbs, mi_col, sub)
        elif p == 2:
            self.block(bd, mi_row, mi_col, sub)
            if has_cols:
                self.block(bd, mi_row, mi_col + hbs, sub)
        else:
            for dr, dc in ((0, 0), (0, hbs), (hbs, 0), (hbs, hbs)):
                self.partition(bd, mi_row + dr, mi_col + dc, sub)
        if bsize == B8X8 or p != 3:
            for i in range(n8):
                self.above_partition[mi_col + i] = ABOVE_PARTITION[sub]
                if (mi_row & 7) + i < 8:
                    self.left_partition[(mi_row & 7) + i] = LEFT_PARTITION[sub]

    def _at(self, r, c):
        return self.grid[(r, c)]

    def block(self, bd, mi_row, mi_col, bsize):
        b = _Block(bsize, mi_row, mi_col)
        above = self._at(mi_row - 1, mi_col) if mi_row > 0 else None
        left = self._at(mi_row, mi_col - 1) if mi_col > self.col_start else None
        intra_frame = self.key or self.intra_only
        s, p, n = self.seg, self.prob, self.counters
        x_mis, y_mis = min(MI_W[bsize], self.mi_cols - mi_col), min(MI_H[bsize], self.mi_rows - mi_row)
        # segment id
        if s["enabled"]:
            if intra_frame:
                seg = 0
                if s["update_map"]:
                    seg = self.r(8)
                    bd.tree(SEGMENT_TREE, s["tree"], seg)
            else:
                ctx = self.above_seg_pred[mi_col] + self.left_seg_pred[mi_row & 7]
                pred_flag = s["update_map"] and s["temporal"] and self.chance(0.5)
                if s["update_map"] and s["temporal"]:
                    bd.put(int(pred_flag), s["pred"][ctx])
                if not s["update_map"] or pred_flag:
                    seg = 0
                    if not self.error_res and self.segmap_ref is not None:
                        seg = int(self.segmap_ref[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis].min())
                    value = 1
                else:
                    seg = self.r(8)
                    bd.tree(SEGMENT_TREE, s["tree"], seg)
                    value = 0
                for i in range(MI_W[bsize]):
                    self.above_seg_pred[mi_col + i] = value
                for i in range(MI_H[bsize]):
                    if (mi_row & 7) + i < 8:
                        self.left_seg_pred[(mi_row & 7) + i] = value
            if s["update_map"] or intra_frame:
                self.seg_map[mi_row:mi_row + y_mis, mi_col:mi_col + x_mis] = seg
            b.seg_id = seg
        feat = s["feature"][b.seg_id] if s["enabled"] else np.zeros(4, bool)
        # skip
        if feat[3]:
            b.skip = 1
        else:
            ctx = (above.skip if above else 0) + (left.skip if left else 0)
            b.skip = int(self.chance(0.3))
            bd.put(b.skip, p["skip"][ctx])
            n["skip"][ctx, b.skip] += 1
        # intra or inter
        if intra_frame:
            b.is_inter = 0
        elif feat[2]:
            b.is_inter = int(s["data"][b.seg_id, 2] != INTRA)
        else:
            if above and left:
                ctx = 3 if (not above.is_inter and not left.is_inter) else int(not above.is_inter or not left.is_inter)
            elif above or left:
                ctx = 2 * (not (above or left).is_inter)
            else:
                ctx = 0
            b.is_inter = int(self.chance(0.75))
            bd.put(b.is_inter, p["intra_inter"][ctx])
            n["intra_inter"][ctx, b.is_inter] += 1
        # transform size
        max_tx = MAX_TX[bsize]
        if self.tx_mode == 4 and bsize >= B8X8 and (not b.skip or not b.is_inter):
            actx = above.tx if above and not above.skip else max_tx
            lctx = left.tx if left and not left.skip else max_tx
            if not left:
                lctx = actx
            if not above:
                actx = lctx
            ctx = int(actx + lctx > max_tx)
            b.tx = self.r(max_tx + 1)
            if max_tx == 1:
                bd.put(b.tx, p["tx8"][ctx][0])
                n["tx8"][ctx, b.tx] += 1
            elif max_tx == 2:
                bd.put(int(b.tx > 0), p["tx16"][ctx][0])
                if b.tx:
                    bd.put(int(b.tx > 1), p["tx16"][ctx][1])
                n["tx16"][ctx, b.tx] += 1
            else:
                bd.put(int(b.tx > 0), p["tx32"][ctx][0])
                if b.tx:
                    bd.put(int(b.tx > 1), p["tx32"][ctx][1])
                    if b.tx > 1:
                        bd.put(int(b.tx > 2), p["tx32"][ctx][2])
                n["tx32"][ctx, b.tx] += 1
        else:
            b.tx = min(max_tx, TX_BIGGEST[self.tx_mode])
        # modes
        if intra_frame:
            self.kf_modes(bd, b, above, left)
        elif b.is_inter:
            self.inter_modes(bd, b, above, left, feat)
        else:
            def read_y(group):
                m = self.r(10)
                bd.tree(INTRA_MODE_TREE, p["y_mode"][group], m)
                n["y_mode"][group, m] += 1
                self.count(INTRA_MODES[m])
                return m
            if bsize == B4X4:
                b.sub_modes = [read_y(0) for _ in range(4)]
            elif bsize == B4X8:
                m0, m1 = read_y(0), read_y(0)
                b.sub_modes = [m0, m1, m0, m1]
            elif bsize == B8X4:
                m0, m2 = read_y(0), read_y(0)
                b.sub_modes = [m0, m0, m2, m2]
            else:
                b.sub_modes = [read_y(SIZE_GROUP[bsize])] * 4
            b.mode = b.sub_modes[3]
            uv = self.r(10)
            bd.tree(INTRA_MODE_TREE, p["uv_mode"][b.mode], uv)
            n["uv_mode"][b.mode, uv] += 1
            b.ref = [INTRA, -1]
        for r in range(y_mis):
            for c in range(x_mis):
                self.grid[(mi_row + r, mi_col + c)] = b
        # coefficients
        if bsize < B8X8:
            self.count("sub8x8_blocks")
        self.count(f"tx_{4 << b.tx}x{4 << b.tx}")
        self.count(REF_NAMES[b.ref[0] if b.is_inter else 0])
        if not b.is_inter and not intra_frame:
            self.count("intra_blocks_in_inter_frames")
        if b.is_inter:
            if b.comp:
                self.count("compound_blocks")
            self.count(FILTER_NAMES[b.filter])
        self.residual(bd, b)
        if b.skip:
            self.count("skip_blocks")

    def kf_modes(self, bd, b, above, left):
        def above_mode(i):
            if i >= 2:
                return b.sub_modes[i - 2]
            return above.sub_modes[i + 2] if above else DC_PRED

        def left_mode(i):
            if i & 1:
                return b.sub_modes[i - 1]
            return left.sub_modes[i + 1] if left else DC_PRED

        def read(i):
            m = self.r(10)
            ctx = (above_mode(i) * 10 + left_mode(i)) * 9
            bd.tree(INTRA_MODE_TREE, T.KF_Y_MODE_PROBS[ctx:ctx + 9], m)
            self.count(INTRA_MODES[m])
            return m
        if b.bsize == B4X4:
            for i in range(4):
                b.sub_modes[i] = read(i)
        elif b.bsize == B4X8:
            b.sub_modes[0] = b.sub_modes[2] = read(0)
            b.sub_modes[1] = b.sub_modes[3] = read(1)
        elif b.bsize == B8X4:
            b.sub_modes[0] = b.sub_modes[1] = read(0)
            b.sub_modes[2] = b.sub_modes[3] = read(2)
        else:
            b.sub_modes = [read(0)] * 4
        b.mode = b.sub_modes[3]
        uv = self.r(10)
        bd.tree(INTRA_MODE_TREE, T.KF_UV_MODE_PROBS[b.mode * 9:b.mode * 9 + 9], uv)
        b.ref = [INTRA, -1]

    def refs(self, bd, b, above, left, feat):
        p, n, s = self.prob, self.counters, self.seg
        if feat[2]:
            b.ref, b.comp = [int(s["data"][b.seg_id, 2]), -1], 0
            return
        second = lambda m: m.is_inter and m.comp  # noqa: E731
        inter = lambda m: bool(m.is_inter)  # noqa: E731
        if self.ref_mode == 2:
            fixed = self.comp_fixed
            if above and left:
                if not second(above) and not second(left):
                    ctx = int(above.ref[0] == fixed) ^ int(left.ref[0] == fixed)
                elif not second(above):
                    ctx = 2 + int(above.ref[0] == fixed or not inter(above))
                elif not second(left):
                    ctx = 2 + int(left.ref[0] == fixed or not inter(left))
                else:
                    ctx = 4
            elif above or left:
                e = above or left
                ctx = int(e.ref[0] == fixed) if not second(e) else 3
            else:
                ctx = 1
            b.comp = int(self.chance(0.5))
            bd.put(b.comp, p["comp_inter"][ctx])
            n["comp_inter"][ctx, b.comp] += 1
        else:
            b.comp = int(self.ref_mode == 1)
        if b.comp:
            fix_idx = int(self.sign_bias[self.comp_fixed])
            var_idx = 1 - fix_idx
            var1 = self.comp_var[1]
            if above and left:
                ai, li = not inter(above), not inter(left)
                if ai and li:
                    ctx = 2
                elif ai or li:
                    e = left if ai else above
                    ctx = 1 + 2 * int((e.ref[0] if not second(e) else e.ref[var_idx]) != var1)
                else:
                    l_sg, a_sg = not second(left), not second(above)
                    vrfa = above.ref[0] if a_sg else above.ref[var_idx]
                    vrfl = left.ref[0] if l_sg else left.ref[var_idx]
                    if vrfa == vrfl and var1 == vrfa:
                        ctx = 0
                    elif l_sg and a_sg:
                        if ((vrfa == self.comp_fixed and vrfl == self.comp_var[0]) or
                                (vrfl == self.comp_fixed and vrfa == self.comp_var[0])):
                            ctx = 4
                        elif vrfa == vrfl:
                            ctx = 3
                        else:
                            ctx = 1
                    elif l_sg or a_sg:
                        vrfc = vrfa if l_sg else vrfl
                        rfs = vrfa if a_sg else vrfl
                        if vrfc == var1 and rfs != var1:
                            ctx = 1
                        elif rfs == var1 and vrfc != var1:
                            ctx = 2
                        else:
                            ctx = 4
                    elif vrfa == vrfl:
                        ctx = 4
                    else:
                        ctx = 2
            elif above or left:
                e = above or left
                if not inter(e):
                    ctx = 2
                elif second(e):
                    ctx = 4 * int(e.ref[var_idx] != var1)
                else:
                    ctx = 3 * int(e.ref[0] != var1)
            else:
                ctx = 2
            bit = self.r(2)
            bd.put(bit, p["comp_ref"][ctx])
            n["comp_ref"][ctx, bit] += 1
            b.ref = [0, 0]
            b.ref[fix_idx] = self.comp_fixed
            b.ref[var_idx] = self.comp_var[bit]
            return
        if above and left:
            ai, li = not inter(above), not inter(left)
            if ai and li:
                ctx0 = 2
            elif ai or li:
                e = left if ai else above
                ctx0 = 4 * int(e.ref[0] == LAST) if not second(e) else 1 + int(LAST in e.ref)
            else:
                a_s, l_s = second(above), second(left)
                a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
                if a_s and l_s:
                    ctx0 = 1 + int(LAST in (a0, a1, l0, l1))
                elif a_s or l_s:
                    rfs = a0 if not a_s else l0
                    crf1, crf2 = (a0, a1) if a_s else (l0, l1)
                    ctx0 = 3 + int(LAST in (crf1, crf2)) if rfs == LAST else int(LAST in (crf1, crf2))
                else:
                    ctx0 = 2 * int(a0 == LAST) + 2 * int(l0 == LAST)
        elif above or left:
            e = above or left
            if not inter(e):
                ctx0 = 2
            elif not second(e):
                ctx0 = 4 * int(e.ref[0] == LAST)
            else:
                ctx0 = 1 + int(LAST in e.ref)
        else:
            ctx0 = 2
        ref = (LAST, GOLDEN, ALTREF)[self.r(3)]
        bit0 = int(ref != LAST)
        bd.put(bit0, p["single_ref"][ctx0][0])
        n["single_ref"][ctx0, 0, bit0] += 1
        b.ref = [ref, -1]
        if not bit0:
            return
        if above and left:
            ai, li = not inter(above), not inter(left)
            if ai and li:
                ctx1 = 2
            elif ai or li:
                e = left if ai else above
                if not second(e):
                    ctx1 = 3 if e.ref[0] == LAST else 4 * int(e.ref[0] == GOLDEN)
                else:
                    ctx1 = 1 + 2 * int(GOLDEN in e.ref)
            else:
                a_s, l_s = second(above), second(left)
                a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
                if a_s and l_s:
                    ctx1 = 3 * int(GOLDEN in (a0, a1, l0, l1)) if (a0 == l0 and a1 == l1) else 2
                elif a_s or l_s:
                    rfs = a0 if not a_s else l0
                    crf1, crf2 = (a0, a1) if a_s else (l0, l1)
                    g = int(GOLDEN in (crf1, crf2))
                    ctx1 = 3 + g if rfs == GOLDEN else g if rfs == ALTREF else 1 + 2 * g
                else:
                    if a0 == LAST and l0 == LAST:
                        ctx1 = 3
                    elif a0 == LAST or l0 == LAST:
                        edge0 = l0 if a0 == LAST else a0
                        ctx1 = 4 * int(edge0 == GOLDEN)
                    else:
                        ctx1 = 2 * int(a0 == GOLDEN) + 2 * int(l0 == GOLDEN)
        elif above or left:
            e = above or left
            if not inter(e) or (e.ref[0] == LAST and not second(e)):
                ctx1 = 2
            elif not second(e):
                ctx1 = 4 * int(e.ref[0] == GOLDEN)
            else:
                ctx1 = 3 * int(GOLDEN in e.ref)
        else:
            ctx1 = 2
        bit1 = int(ref == ALTREF)
        bd.put(bit1, p["single_ref"][ctx1][1])
        n["single_ref"][ctx1, 1, bit1] += 1

    def inter_modes(self, bd, b, above, left, feat):
        p, n = self.prob, self.counters
        self.refs(bd, b, above, left, feat)
        counter = 0
        for dc, dr in MV_REF_FIRST_TWO[b.bsize]:
            c, r = b.col + dc, b.row + dr
            if self.col_start <= c < self.mi_cols and 0 <= r < self.mi_rows:
                m = self._at(r, c)
                counter += 9 if not m.is_inter else 3 if m.mode == ZEROMV else 1 if m.mode == NEWMV else 0
        ctx = COUNTER_TO_CONTEXT[counter]

        def read_mode():
            m = int(self.rng.choice(4, p=(0.3, 0.2, 0.25, 0.25))) if "far_mvs" not in self.features else \
                int(self.rng.choice(4, p=(0.2, 0.1, 0.2, 0.5)))
            bd.tree(INTER_MODE_TREE, p["inter_mode"][ctx], m)
            n["inter_mode"][ctx, m] += 1
            self.count(INTER_MODES[m])
            return NEARESTMV + m
        if b.bsize >= B8X8:
            if feat[3]:
                b.mode = ZEROMV
                self.count("ZEROMV")
            else:
                b.mode = read_mode()
        if self.interp_filter == SWITCHABLE:
            lt = left.filter if left and left.is_inter else 3
            at = above.filter if above and above.is_inter else 3
            fctx = lt if lt == at else at if lt == 3 else lt if at == 3 else 3
            b.filter = self.r(3)
            bd.tree(INTERP_TREE, p["interp"][fctx], b.filter)
            n["interp"][fctx, b.filter] += 1
        else:
            b.filter = self.interp_filter
        if b.bsize < B8X8:
            modes = [read_mode()]
            self.new_mvs(bd, b, modes[0])
            if b.bsize != B8X4:
                modes.append(read_mode())
                self.new_mvs(bd, b, modes[-1])
            else:
                modes.append(modes[0])
            if b.bsize != B4X8:
                modes.append(read_mode())
                self.new_mvs(bd, b, modes[-1])
                if b.bsize != B8X4:
                    modes.append(read_mode())
                    self.new_mvs(bd, b, modes[-1])
                else:
                    modes.append(modes[2])
            else:
                modes += [modes[0], modes[1]]
            b.sub_modes = modes
            b.mode = modes[3]
        else:
            self.new_mvs(bd, b, b.mode)
            b.sub_modes = [b.mode] * 4

    def new_mvs(self, bd, b, mode):
        if mode != NEWMV:
            return
        p, n = self.prob, self.counters
        far = "far_mvs" in self.features
        for _ in range(1 + b.comp):
            j = self.r(4)
            bd.tree(MV_JOINT_TREE, p["mv_joints"], j)
            n["mv_joints"][j] += 1
            for comp in (0, 1):
                if not (j >= 2 if comp == 0 else j & 1):
                    continue
                q, c = p["mv"][comp], n["mv"][comp]
                sign = self.r(2)
                cls = self.r(9 if far and self.chance(0.3) else 4)
                bd.put(sign, q["sign"])
                bd.tree(MV_CLASS_TREE, q["classes"], cls)
                c["sign"][sign] += 1
                c["classes"][cls] += 1
                if cls:
                    for m in range(cls):
                        bit = self.r(2)
                        bd.put(bit, q["bits"][m])
                        c["bits"][m, bit] += 1
                    fp = self.r(4)
                    bd.tree(MV_FP_TREE, q["fp"], fp)
                    c["fp"][fp] += 1
                    c["hp"][1] += 1
                else:
                    d = self.r(2)
                    bd.put(d, q["class0"])
                    c["class0"][d] += 1
                    fp = self.r(4)
                    bd.tree(MV_FP_TREE, q["class0_fp"][d], fp)
                    c["class0_fp"][d, fp] += 1
                    c["class0_hp"][1] += 1

    # --- coefficients ---------------------------------------------------------------------------

    def residual(self, bd, b):
        mi_row, mi_col = b.row, b.col
        if b.skip:
            w, h = MI_W[b.bsize], MI_H[b.bsize]
            for plane, scale in ((0, 2), (1, 1), (2, 1)):
                for i in range(w * scale):
                    self.above_nnz[plane][mi_col * scale + i] = 0
                for i in range(h * scale):
                    if ((mi_row & 7) * scale) + i < 8 * scale:
                        self.left_nnz[plane][(mi_row & 7) * scale + i] = 0
            return
        min_dim = min(W4[b.bsize], H4[b.bsize]) * 4
        uv_tx = min(b.tx, 3 if min_dim >= 64 else 2 if min_dim >= 32 else 1 if min_dim >= 16 else 0)
        any_coef = False
        for plane in range(3):
            tx = uv_tx if plane else b.tx
            step = 1 << tx
            w4 = MI_W[b.bsize] * (1 if plane else 2)
            h4 = MI_H[b.bsize] * (1 if plane else 2)
            x0, y0 = (mi_col, mi_row) if plane else (mi_col * 2, mi_row * 2)
            edge_x, edge_y = (self.mi_cols, self.mi_rows) if plane else (self.mi_cols * 2, self.mi_rows * 2)
            for y in range(0, min(h4, edge_y - y0), step):
                for x in range(0, min(w4, edge_x - x0), step):
                    tx_type = 0
                    if not (plane or b.is_inter or self.lossless or tx == 3):
                        tx_type = MODE_TO_TX_TYPE[b.sub_modes[(y << 1) + x] if b.bsize < B8X8 else b.mode]
                    any_coef |= self.tokens(bd, b, plane, x0 + x, y0 + y, tx, tx_type, edge_x, edge_y)
        if not any_coef and b.is_inter and b.bsize >= B8X8:
            b.skip = 1

    def tokens(self, bd, b, plane, x4, y4, tx, tx_type, edge_x, edge_y):
        n4 = 1 << tx
        a = self.above_nnz[plane]
        left = self.left_nnz[plane]
        ly = y4 & (7 if plane else 15)
        ctx = int(any(a[x4:x4 + n4])) + int(any(left[ly:ly + n4]))
        size = 16 << (2 * tx)
        l = 4 << tx
        scan = {0: (T.SCAN_DEFAULT_4, T.SCAN_ROW_4, T.SCAN_COL_4, T.SCAN_DEFAULT_4),
                1: (T.SCAN_DEFAULT_8, T.SCAN_ROW_8, T.SCAN_COL_8, T.SCAN_DEFAULT_8),
                2: (T.SCAN_DEFAULT_16, T.SCAN_ROW_16, T.SCAN_COL_16, T.SCAN_DEFAULT_16),
                3: (T.SCAN_DEFAULT_32,) * 4}[tx][tx_type]
        kind = "col" if (tx < 3 and tx_type == 2) else "row" if (tx < 3 and tx_type == 1) else "default"
        band = BAND_4X4 if tx == 0 else BAND_BIG
        eob = 0 if self.chance(0.3) else 1 + min(int(self.rng.geometric(0.25)) - 1, size - 1, 15)
        values = [0] * eob
        for i in range(eob):
            if i == eob - 1 or self.chance(0.6):
                v = int(self.rng.choice((1, 1, 1, 2, 2, 3, 4, 5, 6, 7, 9, 12)))
                values[i] = -v if self.chance(0.5) else v
        probs = self.prob["coef"][tx][int(plane > 0)][b.is_inter]
        cnt = self.counters["coef"][tx][int(plane > 0)][b.is_inter]
        eobc = self.counters["eob"][tx][int(plane > 0)][b.is_inter]
        cache = {}

        def neighbours(c):
            rc = scan[c]
            i, j = divmod(rc, l)
            if i > 0 and j > 0:
                if kind == "col":
                    return (i - 1) * l + j, (i - 1) * l + j
                if kind == "row":
                    return i * l + j - 1, i * l + j - 1
                return (i - 1) * l + j, i * l + j - 1
            if i > 0:
                return (i - 1) * l + j, (i - 1) * l + j
            return i * l + j - 1, i * l + j - 1
        more_check = True
        for c in range(eob):
            bnd = band[c]
            pr = probs[bnd][ctx]
            if more_check:
                bd.put(1, pr[0])
                eobc[bnd, ctx, 1] += 1
            v = values[c]
            if v == 0:
                bd.put(0, pr[1])
                cnt[bnd, ctx, 0] += 1
                cache[scan[c]] = 0
                more_check = False
            else:
                bd.put(1, pr[1])
                av = abs(v)
                if av == 1:
                    bd.put(0, pr[2])
                    cnt[bnd, ctx, 1] += 1
                    energy = 1
                else:
                    bd.put(1, pr[2])
                    cnt[bnd, ctx, 2] += 1
                    pareto = T.PARETO8[(int(pr[2]) - 1) * 8:(int(pr[2]) - 1) * 8 + 8]
                    if av <= 4:
                        bd.tree(TOKEN_TREE, pareto, av)
                        energy = 2 if av == 2 else 3
                    else:
                        base = max(k for k in CAT_PROBS if k <= av)
                        leaf = {5: 5, 7: 6, 11: 7, 19: 8, 35: 9, 67: 10}[base]
                        bd.tree(TOKEN_TREE, pareto, leaf)
                        extra, nbits = av - base, len(CAT_PROBS[base])
                        for i, cp in enumerate(CAT_PROBS[base]):
                            bd.put((extra >> (nbits - 1 - i)) & 1, cp)
                        energy = 4 if base < 11 else 5
                bd.put(int(v < 0))
                cache[scan[c]] = energy
                more_check = True
            if c + 1 < size:
                n0, n1 = neighbours(c + 1)
                ctx = (1 + cache.get(n0, 0) + cache.get(n1, 0)) >> 1
        if eob < size:
            bnd = band[eob]
            bd.put(0, probs[bnd][ctx][0])
            eobc[bnd, ctx, 0] += 1
        nz = int(eob > 0)
        for i in range(n4):
            a[x4 + i] = nz if x4 + i < edge_x else 0
            if (y4 & (7 if plane else 15)) + i < (8 if plane else 16):
                left[ly + i] = nz if y4 + i < edge_y else 0
        return nz


def superframe(frames):
    """Frames packed with a superframe index (4-byte sizes)."""
    marker = 0xC0 | (3 << 3) | (len(frames) - 1)
    index = bytes([marker]) + b"".join(struct.pack("<I", len(f)) for f in frames) + bytes([marker])
    return b"".join(frames) + index


def ivf(frames, width, height, fourcc=b"VP90"):
    """An IVF file of ``frames``."""
    head = struct.pack("<4sHH4sHHIII4x", b"DKIF", 0, 32, fourcc, width, height, 10, 1, len(frames))
    return head + b"".join(struct.pack("<IQ", len(f), i) + f for i, f in enumerate(frames))
