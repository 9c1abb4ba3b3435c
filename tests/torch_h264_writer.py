"""A writer of H.264 streams (progressive 4:2:0, I, P and B slices, CAVLC or
CABAC) for the port's tests: random syntax that covers what
``native/h264_decoder.cpp`` reads, and containers around it (Annex B, MP4
``avc1`` with or without composition offsets, Matroska ``V_MPEG4/ISO/AVC``,
AVI ``H264``).

:func:`random_stream` draws every macroblock type and sub-partition, every
intra mode the neighbours allow, skip runs, reference lists of up to 16
frames with modification, MMCO 1-6 and long-term references, explicit
weights, several slices a picture with each deblocking mode and its offsets,
``constrained_intra_pred``, POC types 0, 1 and 2, the QP range with
``chroma_qp_index_offset`` -12..12 and the ``mb_qp_delta`` wrap, vectors far
outside the picture, level escapes, I_PCM, crops and small frame sizes; and,
as its ``Options`` ask, High-profile tools: CABAC (:class:`CabacWriter`, the
arithmetic encoder, under each ``cabac_init_idc``), the 8x8 transform with
intra 8x8, scaling matrices in the SPS and the PPS, a second chroma QP
offset; and B pictures (``b_frames``): mini-GOPs reordered in POC type 0
(B-pyramid, max_num_reorder_frames 1 and 2) or in display order in POC type
2, every B mb_type and sub_mb_type, B_Skip, spatial and temporal direct under
either direct_8x8_inference_flag, weighted_bipred_idc 0, 1 and 2, list 1
modification. The writer keeps its own model of what the decoder must track
to read the stream as meant (:class:`_Syntax`) -- availability under slices
and constrained intra, the intra mode prediction, ``coeff_token``'s nC,
CABAC's context selection, motion-vector prediction in both lists, direct
prediction as FFmpeg derives it, the decoded picture buffer and its marking,
FFmpeg's output order (:class:`FFmpegOutput`) -- and counts what it writes
under :data:`super_resolution_tpu_torch.utils.h264.STATS`' names, and the
(table, ctxIdx) pairs it codes bins with (list 1's ref_idx and mvd bins
apart too). It keeps every inverse transform's intermediates inside 16 bits,
as conforming streams do (FFmpeg's x86 transforms work in 16 bits).

:func:`encode_frames` is an encoder of real pictures: Baseline
(:class:`FrameEncoder`: an IDR of intra 16x16 macroblocks, then P frames
with a motion search, a residual at a fixed QP and the deblocking filter
off, its reconstruction its own, in the closed loop) or High profile
(:class:`HighEncoder`: CABAC, the 8x8 transform, intra 8x8, P_8x8,
deblocking on, each P picture predicted from FFmpeg's decode of the stream
before it; with ``b_frames`` also B pictures in x264's default GOP shape):
they make the checked-in fixtures.

The tables come from ``torch_h264_tables.py``, copied from the standard, not
from the port.
"""

from __future__ import annotations

import struct
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from torch_h264_tables import (ABS_OFFSET, CABAC_INIT, CBF_OFFSET, CBP_CODE_INTER, CBP_CODE_INTRA, CHROMA_DC_TOKEN,
                               CHROMA_DC_TOTAL_ZEROS, COEFF_TOKEN, DEFAULT_4X4, DEFAULT_8X8, LAST_8X8, NORM_ADJUST,
                               RANGE_LPS, RUN_BEFORE, SIG_8X8, SIG_OFFSET, TOTAL_ZEROS, TRANS_LPS, ZIGZAG, ZIGZAG8,
                               chroma_qp, level_scale, level_scale8)

# The 16-bit bound the writer keeps each 4x4 block's dequantised coefficients under (their absolute sum bounds
# every intermediate of the inverse transform), and each 8x8 block's (whose two passes each grow a value by up to
# 1.5 times the absolute sum of their inputs).
COEFF_BOUND = 30000
COEFF_BOUND8 = 12000
FLAT4 = [[16] * 4 for _ in range(4)]
FLAT8 = [[16] * 8 for _ in range(8)]


class BitWriter:
    def __init__(self):
        self.bits = []

    def u(self, n, v):
        v = int(v)
        assert 0 <= v < (1 << n) or n == 0, (n, v)
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def ue(self, v):
        v = int(v)
        assert v >= 0
        v += 1
        n = v.bit_length()
        self.u(n - 1, 0)
        self.u(n, v)

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def code(self, lv):
        self.u(*lv)

    def align_zero(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def align_one(self):
        while len(self.bits) % 8:
            self.bits.append(1)

    def trailing(self):
        self.bits.append(1)
        self.align_zero()

    def data(self):
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            byte = 0
            for b in self.bits[i:i + 8]:
                byte = (byte << 1) | b
            out.append(byte)
        return bytes(out)


def nal_unit(ref_idc, kind, rbsp):
    """A NAL unit: its header, then the RBSP with emulation prevention."""
    out, zeros = bytearray([(ref_idc << 5) | kind]), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ---------------------------------------------------------------------------------------------
# Parameter sets


@dataclass
class Sps:
    mb_width: int
    mb_height: int
    sps_id: int = 0
    profile_idc: int = 66
    level_idc: int = 30
    log2_max_frame_num: int = 4
    poc_type: int = 2
    log2_max_poc_lsb: int = 6
    delta_always_zero: bool = False
    offset_non_ref: int = 1
    offset_top_bottom: int = 0
    offsets_ref: list = field(default_factory=lambda: [2])
    max_num_ref_frames: int = 1
    crop: tuple = (0, 0, 0, 0)  # left, right, top, bottom in crop units (2 samples)
    vui: bool = False
    full_range: bool = False
    matrix: int | None = None
    bitstream_restriction: bool = False
    num_reorder_frames: int = 0
    direct_8x8_inference: bool = True
    # Refused features, for the tests of the refusals.
    frame_mbs_only: bool = True
    chroma_format_idc: int = 1
    bit_depth: int = 8
    separate_colour_plane: bool = False
    bypass: bool = False
    # seq_scaling_matrix_present_flag's lists: None (no flag), or eight entries of None (not sent: fall-back rule
    # A), "default" (useDefaultScalingMatrixFlag) or the list in scan order, with (values, n): its first n sent.
    scaling_lists: list | None = None

    def rbsp(self):
        w = BitWriter()
        w.u(8, self.profile_idc)
        w.u(8, 0)
        w.u(8, self.level_idc)
        w.ue(self.sps_id)
        if self.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
            w.ue(self.chroma_format_idc)
            if self.chroma_format_idc == 3:
                w.u(1, int(self.separate_colour_plane))
            w.ue(self.bit_depth - 8)
            w.ue(self.bit_depth - 8)
            w.u(1, int(self.bypass))
            w.u(1, int(self.scaling_lists is not None))
            if self.scaling_lists is not None:
                write_scaling_lists(w, self.scaling_lists, 8 if self.chroma_format_idc != 3 else 12)
        w.ue(self.log2_max_frame_num - 4)
        w.ue(self.poc_type)
        if self.poc_type == 0:
            w.ue(self.log2_max_poc_lsb - 4)
        elif self.poc_type == 1:
            w.u(1, int(self.delta_always_zero))
            w.se(self.offset_non_ref)
            w.se(self.offset_top_bottom)
            w.ue(len(self.offsets_ref))
            for o in self.offsets_ref:
                w.se(o)
        w.ue(self.max_num_ref_frames)
        w.u(1, 0)  # gaps_in_frame_num_value_allowed_flag
        w.ue(self.mb_width - 1)
        w.ue(self.mb_height - 1 if self.frame_mbs_only else self.mb_height // 2 - 1)
        w.u(1, int(self.frame_mbs_only))
        if not self.frame_mbs_only:
            w.u(1, 0)  # mb_adaptive_frame_field_flag
        w.u(1, int(self.direct_8x8_inference))
        cropped = any(self.crop)
        w.u(1, int(cropped))
        if cropped:
            for c in self.crop:
                w.ue(c)
        w.u(1, int(self.vui))
        if self.vui:
            w.u(1, 1)  # aspect_ratio_info_present_flag
            w.u(8, 1)  # 1:1
            w.u(1, 0)  # overscan_info_present_flag
            w.u(1, 1)  # video_signal_type_present_flag
            w.u(3, 5)
            w.u(1, int(self.full_range))
            w.u(1, int(self.matrix is not None))
            if self.matrix is not None:
                w.u(8, self.matrix)
                w.u(8, self.matrix)
                w.u(8, self.matrix)
            w.u(1, 1)  # chroma_loc_info_present_flag
            w.ue(0)
            w.ue(0)
            w.u(1, 1)  # timing_info_present_flag
            w.u(32, 1)
            w.u(32, 20)
            w.u(1, 1)
            w.u(1, 0)  # nal_hrd_parameters_present_flag
            w.u(1, 0)  # vcl_hrd_parameters_present_flag
            w.u(1, 0)  # pic_struct_present_flag
            w.u(1, int(self.bitstream_restriction))
            if self.bitstream_restriction:
                w.u(1, 1)
                w.ue(0)
                w.ue(0)
                w.ue(16)
                w.ue(16)
                w.ue(self.num_reorder_frames)
                w.ue(self.max_num_ref_frames)
        w.trailing()
        return w.data()


@dataclass
class Pps:
    pps_id: int = 0
    sps_id: int = 0
    num_ref_default: int = 1
    num_ref_default_l1: int = 1
    weighted: bool = False
    bipred_idc: int = 0
    pic_init_qp: int = 26
    chroma_qp_offset: int = 0
    deblocking_control: bool = True
    constrained_intra: bool = False
    bottom_field_pic_order: bool = False
    cabac: bool = False
    transform_8x8: bool = False
    # pic_scaling_matrix_present_flag's lists, as Sps.scaling_lists: six, or eight with the 8x8 transform.
    scaling_lists: list | None = None
    second_chroma_qp_offset: int | None = None
    # Refused features.
    slice_groups: int = 1
    redundant_pic_cnt: bool = False

    def rbsp(self):
        w = BitWriter()
        w.ue(self.pps_id)
        w.ue(self.sps_id)
        w.u(1, int(self.cabac))
        w.u(1, int(self.bottom_field_pic_order))
        w.ue(self.slice_groups - 1)
        if self.slice_groups > 1:
            w.ue(0)  # slice_group_map_type 0: interleaved runs
            for _ in range(self.slice_groups):
                w.ue(0)
        w.ue(self.num_ref_default - 1)
        w.ue(self.num_ref_default_l1 - 1)
        w.u(1, int(self.weighted))
        w.u(2, self.bipred_idc)
        w.se(self.pic_init_qp - 26)
        w.se(0)
        w.se(self.chroma_qp_offset)
        w.u(1, int(self.deblocking_control))
        w.u(1, int(self.constrained_intra))
        w.u(1, int(self.redundant_pic_cnt))
        if self.transform_8x8 or self.scaling_lists is not None or self.second_chroma_qp_offset is not None:
            w.u(1, int(self.transform_8x8))
            w.u(1, int(self.scaling_lists is not None))
            if self.scaling_lists is not None:
                write_scaling_lists(w, self.scaling_lists, 6 + 2 * int(self.transform_8x8))
            w.se(self.cr_qp_offset)
        w.trailing()
        return w.data()

    @property
    def cr_qp_offset(self):
        return self.chroma_qp_offset if self.second_chroma_qp_offset is None else self.second_chroma_qp_offset


def write_scaling_lists(w, lists, count):
    """scaling_list() syntax (7.3.2.1.1.1) of ``count`` lists (entries as ``Sps.scaling_lists``)."""
    assert len(lists) == count, (len(lists), count)
    for entry in lists:
        w.u(1, int(entry is not None))
        if entry is None:
            continue
        if entry == "default":
            w.se(-8)  # nextScale 0 at the first position: useDefaultScalingMatrixFlag
            continue
        values, sent = entry
        last = 8
        for j in range(sent):
            w.se((values[j] - last + 128) % 256 - 128)
            last = values[j]
        if sent < len(values):
            assert all(v == last for v in values[sent:]), "the unsent tail repeats the last value sent"
            w.se((0 - last + 128) % 256 - 128)  # nextScale 0: the rest repeat the last


def resolve_lists(sps, pps):
    """The weightScale4x4 (six, raster order as 4x4 lists) and weightScale8x8 (Intra Y, Inter Y) lists the pictures
    of ``pps`` use: the PPS's lists under fall-back rule A or B, else the SPS's under rule A, else flat."""
    def read(entry, default, fallback, size):
        if entry is None:
            return fallback
        scan = ZIGZAG if size == 4 else ZIGZAG8
        values = default if entry == "default" else entry[0]
        out = [[0] * size for _ in range(size)]
        for k, (r, c) in enumerate(scan):
            out[r][c] = values[k]
        return out

    def matrices(lists, base4, base8, eight):
        l4 = []
        for i in range(6):
            t = i // 3
            fallback = l4[i - 1] if i % 3 else base4[t]
            l4.append(read(lists[i], DEFAULT_4X4[t], fallback, 4))
        l8 = [read(lists[6 + t], DEFAULT_8X8[t], base8[t], 8) for t in range(2)] if eight else list(base8)
        return l4, l8

    defaults4 = [read("default", DEFAULT_4X4[t], None, 4) for t in range(2)]
    defaults8 = [read("default", DEFAULT_8X8[t], None, 8) for t in range(2)]
    if sps.scaling_lists is not None:
        s4, s8 = matrices(sps.scaling_lists, defaults4, defaults8, True)
    else:
        s4, s8 = [FLAT4] * 6, [FLAT8] * 2
    if pps.scaling_lists is None:
        return s4, s8
    if sps.scaling_lists is None:  # rule A
        return matrices(pps.scaling_lists, defaults4, defaults8, pps.transform_8x8)
    return matrices(pps.scaling_lists, [s4[0], s4[3]], s8, pps.transform_8x8)  # rule B


def parameter_set_counts(sps, pps):
    """What a decoder counts as it reads these parameter sets (``utils/h264.STATS``' names)."""
    counts = Counter()
    for owner, lists, rule_b in ((sps, sps.scaling_lists, False),
                                 *((p, p.scaling_lists, sps.scaling_lists is not None) for p in pps)):
        if lists is None:
            continue
        counts["sps_scaling_matrices" if owner is sps else "pps_scaling_matrices"] += 1
        for entry in lists:
            if entry is None:
                counts["scaling_lists_fallback_b" if rule_b else "scaling_lists_fallback_a"] += 1
            else:
                counts["scaling_lists_default" if entry == "default" else "scaling_lists_explicit"] += 1
    for p in pps:
        counts["transform_8x8_pps"] += int(p.transform_8x8)
        counts["second_chroma_qp_offsets"] += int(p.cr_qp_offset != p.chroma_qp_offset)
    return counts


# ---------------------------------------------------------------------------------------------
# CAVLC residual blocks


def _level_codes(levels, trailing, total):
    """(length, value) codes of the levels (highest frequency first), with the suffixLength adaptation."""
    codes, counts = [], Counter()
    suffix_length = 1 if total > 10 and trailing < 3 else 0
    for i, level in enumerate(levels):
        if i < trailing:
            codes.append((1, int(level < 0)))
            continue
        code = 2 * level - 2 if level > 0 else -2 * level - 1
        if i == trailing and trailing < 3:
            code -= 2
        assert code >= 0
        if suffix_length == 0:
            if code < 14:
                prefix, suffix, size = code, 0, 0
            elif code < 30:
                prefix, suffix, size = 14, code - 14, 4
            else:
                prefix, suffix, size = 15, code - 30, 12
        elif code < (15 << suffix_length):
            prefix, suffix, size = code >> suffix_length, code & ((1 << suffix_length) - 1), suffix_length
        else:
            prefix, suffix, size = 15, code - (15 << suffix_length), 12
        assert suffix < (1 << 12), level
        codes.append((prefix + 1, 1))
        if size:
            codes.append((size, suffix))
        if prefix == 14:
            counts["level_prefix_14"] += 1
        if prefix >= 15:
            counts["level_prefix_15"] += 1
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1
    return codes, counts


def max_level(suffix_length=0):
    """The largest magnitude level_prefix 15 reaches (the writer keeps levels below it)."""
    return (30 + 4095) // 2 if suffix_length == 0 else ((15 << suffix_length) + 4095 + 2) // 2


def write_block(w, coeffs, nc, max_coeff):
    """CAVLC of one block: ``coeffs`` in scan order (of the block's ``max_coeff`` positions). Returns
    (TotalCoeff, the level-prefix counts)."""
    nonzero = [i for i, c in enumerate(coeffs) if c]
    total = len(nonzero)
    levels = [coeffs[i] for i in reversed(nonzero)]
    trailing = 0
    for lv in levels:
        if abs(lv) != 1 or trailing == 3:
            break
        trailing += 1
    if nc == -1:
        w.code(CHROMA_DC_TOKEN[total][trailing])
    else:
        table = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        w.code(COEFF_TOKEN[table][total][trailing])
    if total == 0:
        return 0, Counter()
    codes, counts = _level_codes(levels, trailing, total)
    for c in codes:
        w.code(c)
    if total < max_coeff:
        zeros = nonzero[-1] + 1 - total
        w.code((CHROMA_DC_TOTAL_ZEROS if nc == -1 else TOTAL_ZEROS)[total - 1][zeros])
        zeros_left = zeros
        positions = list(reversed(nonzero))
        for i in range(total - 1):
            if zeros_left == 0:
                break
            run = positions[i] - positions[i + 1] - 1
            w.code(RUN_BEFORE[min(zeros_left, 7) - 1][run])
            zeros_left -= run
    return total, counts


# ---------------------------------------------------------------------------------------------
# CABAC


class CabacWriter:
    """The arithmetic encoder (9.3.4.2-9.3.4.5) writing into a :class:`BitWriter`, with the context states of one
    slice, initialised (9.3.1.1) from its QP and table (0: I slices, 1-3: P slices with cabac_init_idc 0-2). Each
    context it codes a bin with is added to ``used`` as (table, ctxIdx)."""

    def __init__(self, w, slice_qp, table, used):
        self.w, self.table, self.used = w, table, used
        q = min(max(slice_qp, 0), 51)
        self.state = []
        for m, n in CABAC_INIT[table]:
            pre = min(max(((m * q) >> 4) + n, 1), 126)
            self.state.append([63 - pre, 0] if pre <= 63 else [pre - 64, 1])
        self.start()

    def start(self):
        """InitEncoder: at the slice data's start and again after I_PCM's samples."""
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.w.bits.append(b)
        self.w.bits += [1 - b] * self.outstanding
        self.outstanding = 0

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, b):
        self.used.add((self.table, ctx))
        st = self.state[ctx]
        lps = RANGE_LPS[st[0]][(self.range >> 6) & 3]
        self.range -= lps
        if b != st[1]:
            self.low += self.range
            self.range = lps
            if st[0] == 0:
                st[1] = 1 - st[1]
            st[0] = TRANS_LPS[st[0]]
        else:
            st[0] = min(st[0] + 1, 62)
        self._renorm()

    def bypass(self, b):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def exp_golomb(self, v, k):
        """The Exp-Golomb suffix of UEGk (9.3.2.3), in bypass bins."""
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)

    def terminate(self, b):
        """A bin of ctxIdx 276; a 1 flushes (its last bit is the rbsp_stop_one_bit, or the one before I_PCM's
        alignment)."""
        self.range -= 2
        if not b:
            self._renorm()
            return
        self.low += self.range
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.w.u(2, ((self.low >> 7) & 3) | 1)


# ---------------------------------------------------------------------------------------------
# Bounds on the inverse transforms' inputs


def _hadamard4(c):
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
    return h @ c @ h


def _scale(v, ls, qp, shift):
    """(v * LevelScale) scaled by 2^(qP / 6 - shift), rounded as 8.5.12.1 / 8.5.13.1 round below it."""
    q6 = qp // 6
    return (v * ls) << (q6 - shift) if q6 >= shift else (v * ls + (1 << (shift - q6 - 1))) >> (shift - q6)


def luma_dc_values(levels_scan, qp, w00=16):
    """dcY (4x4, by block position) of the Intra 16x16 DC levels in scan order; w00: weightScale4x4(0, 0)."""
    c = np.zeros((4, 4), np.int64)
    for k, v in enumerate(levels_scan):
        c[ZIGZAG[k]] = v
    return _scale(_hadamard4(c), w00 * NORM_ADJUST[qp % 6][0], qp, 6)


def chroma_dc_values(levels, qpc, w00=16):
    c = np.array(levels, np.int64).reshape(2, 2)
    h = np.array([[1, 1], [1, -1]])
    f = h @ c @ h
    return ((f * w00 * NORM_ADJUST[qpc % 6][0]) << (qpc // 6)) >> 5


def dequantised(levels_scan, qp, start, weights=FLAT4):
    """The block's dequantised AC (or all) coefficients, by raster position; weights: weightScale4x4."""
    d = np.zeros((4, 4), np.int64)
    for k in range(start, 16):
        v = levels_scan[k - start] if k - start < len(levels_scan) else 0
        if v:
            r, c = ZIGZAG[k]
            d[r, c] = _scale(v, weights[r][c] * level_scale(qp, r, c), qp, 4)
    return d


def dequantised8(levels_scan, qp, weights=FLAT8):
    """An 8x8 block's dequantised coefficients (8.5.13.1), by raster position."""
    d = np.zeros((8, 8), np.int64)
    for k, v in enumerate(levels_scan):
        if v:
            r, c = ZIGZAG8[k]
            d[r, c] = _scale(v, weights[r][c] * level_scale8(qp, r, c), qp, 6)
    return d


def fit_levels(levels, qp, start, dc=0, bound=COEFF_BOUND, weights=FLAT4):
    """``levels`` (scan order) reduced until the block's dequantised coefficients, its DC ``dc`` included,
    sum to at most ``bound`` in absolute value."""
    levels = list(levels)
    while True:
        d = dequantised(levels, qp, start, weights)
        if np.abs(d).sum() + abs(int(dc)) <= bound:
            return levels
        k = max(range(len(levels)), key=lambda i: abs(d[ZIGZAG[i + start]]))
        levels[k] = int(np.sign(levels[k])) * (abs(levels[k]) // 2)


def fit_levels8(levels, qp, weights=FLAT8, bound=COEFF_BOUND8):
    """An 8x8 block's levels (scan order) reduced as :func:`fit_levels` reduces a 4x4 block's."""
    levels = list(levels)
    while True:
        d = dequantised8(levels, qp, weights)
        if np.abs(d).sum() <= bound:
            return levels
        k = max(range(64), key=lambda i: abs(d[ZIGZAG8[i]]))
        levels[k] = int(np.sign(levels[k])) * (abs(levels[k]) // 2)


# ---------------------------------------------------------------------------------------------
# Containers


def annexb(access_units):
    """An Annex B byte stream of the access units (each a list of NAL units)."""
    return b"".join(b"\0\0\0\1" + n for au in access_units for n in au)


def split_parameter_sets(access_units):
    """(SPS NAL units, PPS NAL units, the access units without them)."""
    sps, pps, rest = [], [], []
    for au in access_units:
        kept = []
        for n in au:
            kind = n[0] & 31
            if kind == 7 and n not in sps:
                sps.append(n)
            elif kind == 8 and n not in pps:
                pps.append(n)
            elif kind not in (7, 8):
                kept.append(n)
        rest.append(kept)
    return sps, pps, rest


def avcc(sps, pps, length_size=4):
    """An AVCDecoderConfigurationRecord."""
    first = sps[0]
    out = bytes([1, first[1], first[2], first[3], 0xFC | (length_size - 1), 0xE0 | len(sps)])
    for s in sps:
        out += struct.pack(">H", len(s)) + s
    out += bytes([len(pps)])
    for p in pps:
        out += struct.pack(">H", len(p)) + p
    return out


def length_prefixed(au, length_size=4):
    return b"".join(len(n).to_bytes(length_size, "big") + n for n in au)


def _box(kind, body):
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind, version, flags, body):
    return _box(kind, struct.pack(">I", (version << 24) | flags) + body)


def mp4(access_units, width, height, length_size=4, fourcc=b"avc1", pts=None, ctts_version=0, skip=0):
    """An MP4 file of one avc1 track: the parameter sets in its avcC, the samples length-prefixed; an avc3 track
    keeps them in band too. With ``pts`` (each access unit's place in display order) the track has composition
    offsets as FFmpeg's mov muxer writes them: ``ctts`` version 0 and an edit list whose media_time is the first
    composition delay (later by ``skip`` frames, which it leaves out), or ``ctts`` version 1 with negative offsets and
    no edit list."""
    sps, pps, rest = split_parameter_sets(access_units)
    if fourcc == b"avc3":
        rest = access_units
    samples = [length_prefixed(au, length_size) for au in rest]
    n = len(samples)
    entry = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HH", width, height)
             + struct.pack(">II", 0x480000, 0x480000) + b"\0" * 4 + struct.pack(">H", 1) + b"\0" * 32
             + struct.pack(">Hh", 0x18, -1) + _box(b"avcC", avcc(sps, pps, length_size)))
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + _box(fourcc, entry))
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1))
    ctts, edts = b"", b""
    if pts is not None:
        delay = max(i - p for i, p in enumerate(pts)) if ctts_version == 0 else 0
        offsets = [p - i + delay for i, p in enumerate(pts)]
        ctts = _full_box(b"ctts", ctts_version, 0, struct.pack(">I", n)
                         + b"".join(struct.pack(">Ii", 1, o) for o in offsets))
        if ctts_version == 0:
            edts = _box(b"edts", _full_box(b"elst", 0, 0, struct.pack(">IIiI", 1, n - skip, delay + skip, 0x10000)))
    stss = _full_box(b"stss", 0, 0, struct.pack(">II", 1, 1))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(s)) for s in samples))
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")

    def moov(offset):
        chunk_offsets, pos = [], offset
        for s in samples:
            chunk_offsets.append(pos)
            pos += len(s)
        stco = _full_box(b"stco", 0, 0, struct.pack(">I", n) + b"".join(struct.pack(">I", o) for o in chunk_offsets))
        stbl = _box(b"stbl", stsd + stts + ctts + stss + stsc + stsz + stco)
        vmhd = _full_box(b"vmhd", 0, 1, b"\0" * 8)
        dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1) + _full_box(b"url ", 0, 1, b""))
        minf = _box(b"minf", vmhd + _box(b"dinf", dref) + stbl)
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, 10, n, 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, b"\0" * 4 + b"vide" + b"\0" * 12 + b"video\0")
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, n) + b"\0" * 8 + b"\0" * 8
                         + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                         + struct.pack(">II", width << 16, height << 16))
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 10, n) + struct.pack(">IH", 0x10000, 0x100)
                         + b"\0" * 10 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                         + b"\0" * 24 + struct.pack(">I", 2))
        return _box(b"moov", mvhd + _box(b"trak", tkhd + edts + mdia))

    head = len(ftyp) + len(moov(0)) + 8
    return ftyp + moov(head) + _box(b"mdat", b"".join(samples))


def _ebml_id(ident):
    return ident.to_bytes((ident.bit_length() + 7) // 8, "big")


def _ebml_size(n):
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            return ((1 << (7 * length)) | n).to_bytes(length, "big")
    raise ValueError(n)


def _el(ident, body):
    if isinstance(body, int):
        body = body.to_bytes(max(1, (body.bit_length() + 7) // 8), "big")
    elif isinstance(body, str):
        body = body.encode()
    return _ebml_id(ident) + _ebml_size(len(body)) + body


def mkv(access_units, width, height, length_size=4, pts=None):
    """A Matroska file of one V_MPEG4/ISO/AVC track (CodecPrivate: the avcC), a SimpleBlock a frame, timed by its
    place in display order (``pts``; default: decoding order)."""
    sps, pps, rest = split_parameter_sets(access_units)
    header = _el(0x1A45DFA3, _el(0x4286, 1) + _el(0x42F7, 1) + _el(0x42F2, 4) + _el(0x42F3, 8)
                 + _el(0x4282, "matroska") + _el(0x4287, 4) + _el(0x4285, 2))
    info = _el(0x1549A966, _el(0x2AD7B1, 1000000) + _el(0x4D80, "torch_h264_writer") + _el(0x5741, "torch_h264_writer"))
    track = _el(0xAE, _el(0xD7, 1) + _el(0x73C5, 1) + _el(0x83, 1) + _el(0x86, "V_MPEG4/ISO/AVC")
                + _el(0x63A2, avcc(sps, pps, length_size)) + _el(0xE0, _el(0xB0, width) + _el(0xBA, height)))
    blocks = b""
    for i, au in enumerate(rest):
        flags = 0x80 if i == 0 else 0
        t = i if pts is None else pts[i]
        blocks += _el(0xA3, b"\x81" + struct.pack(">hB", t * 100, flags) + length_prefixed(au, length_size))
    cluster = _el(0x1F43B675, _el(0xE7, 0) + blocks)
    return header + _el(0x18538067, info + _el(0x1654AE6B, track) + cluster)


def avi(path, access_units, width, height, fourcc=b"H264"):
    """An AVI of Annex B access units (each chunk one access unit, its parameter sets in band)."""
    from torch_libav import write_avi

    payloads = [annexb([au]) for au in access_units]
    keys = [any((n[0] & 31) == 5 for n in au) for au in access_units]
    write_avi(path, payloads, width, height, fourcc, keys=keys)


# ---------------------------------------------------------------------------------------------
# The random syntax writer


I4_NEEDS = {0: "T", 1: "L", 2: "", 3: "T", 4: "TLD", 5: "TLD", 6: "TLD", 7: "T", 8: "L"}
# B mb_type 1-21 (Table 7-14): each partition's prediction, bit 0 list 0 and bit 1 list 1; B sub_mb_type (Table 7-18):
# its prediction (0: direct) and partition (0 8x8, 1 8x4, 2 4x8, 3 4x4).
B_PRED = [(0, 0), (1, 0), (2, 0), (3, 0), (1, 1), (1, 1), (2, 2), (2, 2), (1, 2), (1, 2), (2, 1), (2, 1), (1, 3),
          (1, 3), (2, 3), (2, 3), (3, 1), (3, 1), (3, 2), (3, 2), (3, 3), (3, 3)]
B_SUB_PRED = (0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3)
B_SUB_SHAPE = (0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 3, 3)
I_MODES = ("vertical", "horizontal", "dc", "diagonal_down_left", "diagonal_down_right", "vertical_right",
           "horizontal_down", "vertical_left", "horizontal_up")


@dataclass
class _Ref:
    frame_num: int
    uid: int
    long: bool = False
    long_idx: int = -1
    poc: int = 0  # as FFmpeg counts it
    motion: dict | None = None  # what direct prediction reads of it as the co-located picture (_Syntax.motion_record)


class _Mb:
    def __init__(self, slice_index):
        self.slice = slice_index
        self.kind = "P"
        self.nz = [0] * 24  # nonzero levels of each 4x4 block (CAVLC: TotalCoeff), as the decoder keeps them
        self.i4 = [2] * 16
        self.t8 = False
        self.cbp = 0
        self.dc = 0  # coded DC blocks: 1 luma, 2 Cb, 4 Cr
        self.chroma_mode = 0
        self.direct16 = False  # B_Direct_16x16
        self.shape = 0  # its partitions as FFmpeg types it: 0 16x16 (or intra), 1 16x8, 2 8x16, 3 8x8

    @property
    def intra(self):
        return self.kind in ("I4", "I16", "PCM")


@dataclass
class Options:
    """What :func:`random_stream` may draw (each tool on by default)."""

    mb_width: int = 4
    mb_height: int = 3
    frames: int = 6
    crop: tuple = (0, 0, 0, 0)
    poc_type: int | None = None
    slices: bool = True
    weights: bool = True
    mmco: bool = True
    long_term: bool = True
    modifications: bool = True
    constrained_intra: bool | None = None
    pcm: bool = True
    far_mv: bool = True
    escapes: bool = True
    qp_range: tuple = (0, 51)
    non_ref: bool = True
    max_refs: int | None = None
    intra_share: float = 0.2
    skip_share: float = 0.25
    poc_step: int = 2
    # High profile: CABAC (cabac_init_idc drawn for each P slice where None), the 8x8 transform (chosen for each
    # macroblock that may take it), scaling matrices in the SPS and in the PPSs (each list drawn from list_modes:
    # not sent, the default or explicit), a second chroma QP offset unlike the first.
    cabac: bool = False
    cabac_init_idc: int | None = None
    transform_8x8: bool = False
    sps_lists: bool = False
    pps_lists: bool = False
    list_modes: tuple = ("absent", "default", "explicit")
    second_chroma_qp_offset: bool = False
    intra_only: bool = False
    # The share of CAVLC 8x8 blocks coded in the cbp with no level in their four 4x4 parts (whose edges FFmpeg's
    # deblocking treats as coded where 8x8 blocks 0-2 are).
    empty_8x8_share: float = 0.0
    # B pictures: mini-GOPs of an anchor then up to 3 B pictures before it in display order (a middle one a
    # reference where b_pyramid), POC type 0 (else in display order, list 1 the initial list 0 with its first two
    # entries switched); direct_spatial_mv_pred per slice, direct_8x8_inference_flag and each PPS's
    # weighted_bipred_idc drawn where None; the share of B macroblocks of each kind (B_Skip, intra, B_Direct_16x16,
    # one 16x16 partition, two partitions, B_8x8); max_num_reorder_frames above what the GOPs need by up to
    # extra_reorder. Every slice of a picture then has its type and its lists.
    b_frames: bool = False
    b_pyramid: bool = True
    direct_spatial: bool | None = None
    direct_8x8_inference: bool | None = None
    bipred_idc: int | None = None
    b_mb_shares: tuple = (0.2, 0.1, 0.15, 0.2, 0.2, 0.15)
    extra_reorder: int = 1
    # Streams the decoder refuses or finds damaged, for those tests.
    first_non_idr: bool = False
    no_output_of_prior_pics: bool = False
    redundant_pic_cnt: int = 0
    bad_ref_idx: bool = False


class _Syntax:
    """What a writer of macroblocks keeps to write them as a decoder reads them: availability under slices and
    constrained intra, motion-vector prediction, the intra mode prediction, CAVLC's nC, and each syntax element in
    CAVLC or, where ``self.cabac`` is a :class:`CabacWriter`, in CABAC (its binarisation and context selection).
    The writer sets ``mbs`` (a ``_Mb`` or None per macroblock), ``mbw``, ``mbh``, ``slice_index``, ``pps``,
    ``ref`` / ``mv`` / ``mvd`` (per 4x4 block of the picture; ``ref1`` / ``mv1`` / ``mvd1`` for list 1, ``direct``
    the blocks predicted in direct mode), ``num_ref``, ``prev_dqp`` and ``stats``; for B slices also ``ref_lists`` (the
    two reference lists of ``_Ref``), ``col`` (list 1's first picture's ``motion``), ``cur_poc``,
    ``direct_spatial``, ``d8`` (direct_8x8_inference_flag) and ``dsf`` (temporal direct's DistScaleFactor)."""

    def arrays(self, lst):
        """(ref, mv, mvd) of list ``lst``."""
        return (self.ref, self.mv, self.mvd) if lst == 0 else (self.ref1, self.mv1, self.mvd1)

    def new_arrays(self):
        n = self.mbw * self.mbh * 16
        self.ref, self.mv, self.mvd = [-1] * n, [(0, 0)] * n, [(0, 0)] * n
        self.ref1, self.mv1, self.mvd1 = [-1] * n, [(0, 0)] * n, [(0, 0)] * n
        self.direct = [False] * n

    def count(self, name, n=1):
        self.stats[name] += n

    def mb_at(self, mbx, mby):
        if not (0 <= mbx < self.mbw and 0 <= mby < self.mbh):
            return None
        m = self.mbs[mby * self.mbw + mbx]
        return m if m is not None and m.slice == self.slice_index else None

    def intra_avail(self, mbx, mby):
        m = self.mb_at(mbx, mby)
        return m is not None and (not self.pps.constrained_intra or m.intra)

    def i4_avail(self, mbx, mby, x4, y4, blk):
        left = x4 > 0 or self.intra_avail(mbx - 1, mby)
        top = y4 > 0 or self.intra_avail(mbx, mby - 1)
        if x4 > 0 and y4 > 0:
            corner = True
        elif x4 > 0:
            corner = self.intra_avail(mbx, mby - 1)
        elif y4 > 0:
            corner = self.intra_avail(mbx - 1, mby)
        else:
            corner = self.intra_avail(mbx - 1, mby - 1)
        return {"T": top, "L": left, "D": corner}

    def i4_neighbour(self, mbx, mby, x4, y4, m):
        if x4 >= 0 and y4 >= 0:
            return m.i4[y4 * 4 + x4]
        n = self.mb_at(mbx - (x4 < 0), mby - (y4 < 0))
        if n is None or (not n.intra and self.pps.constrained_intra):
            return -1
        if n.kind != "I4":
            return 2
        return n.i4[((y4 + 4) & 3) * 4 + ((x4 + 4) & 3)]

    def motion(self, bx, by, mbx, mby, mask, lst=0):
        """(available, ref, mvx, mvy) in list ``lst`` of the 4x4 block at picture block coordinates (bx, by)."""
        if bx < 0 or by < 0 or (bx >> 2) >= self.mbw or (by >> 2) >= self.mbh:
            return (False, -1, 0, 0)
        nx, ny = bx >> 2, by >> 2
        if (nx, ny) == (mbx, mby):
            if not (mask >> ((by & 3) * 4 + (bx & 3))) & 1:
                return (False, -1, 0, 0)
        elif ny > mby or (ny == mby and nx > mbx) or self.mb_at(nx, ny) is None:
            return (False, -1, 0, 0)
        b = by * self.mbw * 4 + bx
        refs, mvs, _ = self.arrays(lst)
        ref = refs[b]
        mv = mvs[b] if ref >= 0 else (0, 0)
        return (True, ref, mv[0], mv[1])

    def predict_mv(self, mbx, mby, x4, y4, w4, ref, mask, shape, lst=0):
        bx, by = mbx * 4 + x4, mby * 4 + y4
        a = self.motion(bx - 1, by, mbx, mby, mask, lst)
        b = self.motion(bx, by - 1, mbx, mby, mask, lst)
        c = self.motion(bx + w4, by - 1, mbx, mby, mask, lst)
        if not c[0]:
            c = self.motion(bx - 1, by - 1, mbx, mby, mask, lst)
        if shape == 1:
            if y4 == 0 and b[1] == ref:
                return b[2:]
            if y4 != 0 and a[1] == ref:
                return a[2:]
        elif shape == 2:
            if x4 == 0 and a[1] == ref:
                return a[2:]
            if x4 != 0 and c[1] == ref:
                return c[2:]
        if not b[0] and not c[0] and a[0]:
            b = c = a
        same = [n for n in (a, b, c) if n[1] == ref]
        if len(same) == 1:
            return same[0][2:]
        return (sorted([a[2], b[2], c[2]])[1], sorted([a[3], b[3], c[3]])[1])

    def set_motion(self, mbx, mby, x4, y4, w4, h4, ref, mv, lst=0):
        mask = 0
        refs, mvs, _ = self.arrays(lst)
        for y in range(y4, y4 + h4):
            for x in range(x4, x4 + w4):
                b = (mby * 4 + y) * self.mbw * 4 + mbx * 4 + x
                refs[b] = ref
                mvs[b] = mv if ref >= 0 else (0, 0)
                mask |= 1 << (y * 4 + x)
        return mask

    def set_mvd(self, mbx, mby, x4, y4, w4, h4, d, lst=0):
        mvds = self.arrays(lst)[2]
        for y in range(y4, y4 + h4):
            for x in range(x4, x4 + w4):
                mvds[(mby * 4 + y) * self.mbw * 4 + mbx * 4 + x] = (abs(d[0]), abs(d[1]))

    def nc(self, mbx, mby, comp, x4, y4):
        m = self.mbs[mby * self.mbw + mbx]
        size = 4 if comp == 0 else 2

        def value(mx, my, x, y):
            n = m if (mx, my) == (mbx, mby) else self.mb_at(mx, my)
            if n is None:
                return None
            return n.nz[y * 4 + x] if comp == 0 else n.nz[16 + (comp - 1) * 4 + y * 2 + x]

        a = value(mbx, mby, x4 - 1, y4) if x4 > 0 else value(mbx - 1, mby, size - 1, y4)
        b = value(mbx, mby, x4, y4 - 1) if y4 > 0 else value(mbx, mby - 1, x4, size - 1)
        if a is not None and b is not None:
            return (a + b + 1) >> 1
        return a if a is not None else b if b is not None else 0

    def skip_mv(self, mbx, mby):
        """P_Skip's motion vector (8.4.1.1)."""
        a = self.motion(mbx * 4 - 1, mby * 4, mbx, mby, 0)
        b = self.motion(mbx * 4, mby * 4 - 1, mbx, mby, 0)
        if a[0] and b[0] and a[1:] != (0, 0, 0) and b[1:] != (0, 0, 0):
            return self.predict_mv(mbx, mby, 0, 0, 4, 0, 0, 0)
        return (0, 0)

    # ---- B slices: direct prediction (8.4.1.2) as FFmpeg derives it
    def motion_record(self, lists):
        """What direct prediction reads of this picture as the co-located one: per macroblock whether it is intra and
        its shape, per 4x4 block the reference index and vector of each list, and the frame_num of each entry of
        ``lists`` (those of its last slice; FFmpeg finds the co-located block's reference by frame_num)."""
        return {"intra": [m.intra for m in self.mbs], "shape": [m.shape for m in self.mbs],
                "b": getattr(self, "pic_kind", None) == "B",
                "ref": (list(self.ref), list(self.ref1)), "mv": (list(self.mv), list(self.mv1)),
                "fn": [[r.frame_num for r in lst] for lst in lists] + [[]] * (2 - len(lists))}

    def scale_factors(self):
        """DistScaleFactor of each list 0 entry (8.4.1.2.3; 256: long-term or no distance)."""
        out = []
        poc1 = self.ref_lists[1][0].poc
        for r in self.ref_lists[0]:
            td = max(-128, min(127, poc1 - r.poc))
            if td == 0 or r.long:
                out.append(256)
                continue
            tb = max(-128, min(127, self.cur_poc - r.poc))
            q = (16384 + (abs(td) >> 1)) // abs(td)
            tx = q if td > 0 else -q
            out.append(max(-1024, min(1023, (tb * tx + 32) >> 6)))
        return out

    def direct_motion(self, mbx, mby, b8x8):
        """(refs, vectors, shape, sub4) of direct prediction of the macroblock's 16 4x4 blocks in both lists; shape
        and sub4 as FFmpeg types the macroblock (16x16 where the co-located one is 16x16 or intra or the motion is
        uniform, the co-located 16x8 / 8x16, else 8x8) and its 8x8 blocks (4x4 blocks without
        direct_8x8_inference_flag)."""
        col, mbw = self.col, self.mbw
        col_mb = mby * mbw + mbx
        col_intra = col["intra"][col_mb]

        def col_block(k):
            x4, y4 = k & 3, k >> 2
            if self.d8:
                x4, y4 = (x4 >> 1) * 3, (y4 >> 1) * 3
            return (mby * 4 + y4) * mbw * 4 + mbx * 4 + x4

        shape = 3 if b8x8 else 0 if col_intra else col["shape"][col_mb]
        sub4 = [not self.d8] * 4
        refs, mvs = [[0] * 16, [0] * 16], [[(0, 0)] * 16, [(0, 0)] * 16]
        if not self.direct_spatial:
            self.count("temporal_direct_mbs")
            for k in range(16):
                ref0, mv0, mv1 = 0, (0, 0), (0, 0)
                if not col_intra:
                    cb = col_block(k)
                    lst = 0 if col["ref"][0][cb] >= 0 else 1
                    rc, mvc = col["ref"][lst][cb], col["mv"][lst][cb]
                    found = None
                    if 0 <= rc < len(col["fn"][lst]):
                        found = next((j for j, r in enumerate(self.ref_lists[0]) if r.frame_num == col["fn"][lst][rc]),
                                     None)
                    if found is None and hasattr(self, "facts"):
                        self.facts["co_located_reference_not_in_list0"] += 1
                    ref0 = found or 0
                    sf = self.dsf[ref0]
                    mv0 = ((sf * mvc[0] + 128) >> 8, (sf * mvc[1] + 128) >> 8)
                    mv1 = (mv0[0] - mvc[0], mv0[1] - mvc[1])
                refs[0][k] = ref0
                mvs[0][k], mvs[1][k] = mv0, mv1
            return refs, mvs, shape, sub4
        self.count("spatial_direct_mbs")
        ref, mv = [-1, -1], [(0, 0), (0, 0)]
        bx, by = mbx * 4, mby * 4

        def min_positive(x, y):
            return min(x, y) if x >= 0 and y >= 0 else max(x, y)

        for lst in range(2):
            a = self.motion(bx - 1, by, mbx, mby, 0, lst)
            b = self.motion(bx, by - 1, mbx, mby, 0, lst)
            c = self.motion(bx + 4, by - 1, mbx, mby, 0, lst)
            if not c[0]:
                c = self.motion(bx - 1, by - 1, mbx, mby, 0, lst)
            ref[lst] = min_positive(a[1], min_positive(b[1], c[1]))
            if ref[lst] >= 0:
                mv[lst] = tuple(self.predict_mv(mbx, mby, 0, 0, 4, ref[lst], 0, 0, lst))
        zero = ref[0] < 0 and ref[1] < 0
        if zero:
            ref = [0, 0]
        if not b8x8 and mv == [(0, 0), (0, 0)]:
            shape = 0
        usable = not col_intra and not self.ref_lists[1][0].long
        n = 0
        for i8 in range(4):
            m, cond8 = 0, False
            for i4 in range(4):
                k = ((i8 >> 1) * 2 + (i4 >> 1)) * 4 + (i8 & 1) * 2 + (i4 & 1)
                cb = col_block(k)
                r0, r1 = col["ref"][0][cb], col["ref"][1][cb]
                cond8 = usable and (r0 == 0 or (r0 < 0 and r1 == 0))
                cmv = col["mv"][0 if r0 == 0 else 1][cb]
                col_zero = cond8 and abs(cmv[0]) <= 1 and abs(cmv[1]) <= 1
                m += col_zero
                for lst in range(2):
                    refs[lst][k] = ref[lst]
                    z = zero or ref[lst] < 0 or (ref[lst] == 0 and col_zero)
                    mvs[lst][k] = (0, 0) if z else mv[lst]
            if not self.d8 and cond8 and m in (0, 4):
                sub4[i8] = False
            n += m
        if not b8x8 and n in (0, 16):
            shape = 0
        return refs, mvs, shape, sub4

    def set_direct(self, mbx, mby, refs, mvs, blocks):
        """The direct motion of ``blocks`` (indices of the macroblock's 4x4 blocks) into both lists."""
        for k in blocks:
            for lst in range(2):
                self.set_motion(mbx, mby, k & 3, k >> 2, 1, 1, refs[lst][k], mvs[lst][k], lst)
                self.set_mvd(mbx, mby, k & 3, k >> 2, 1, 1, (0, 0), lst)
            self.direct[(mby * 4 + (k >> 2)) * self.mbw * 4 + mbx * 4 + (k & 3)] = True

    # ---- syntax elements, in CAVLC or in CABAC (9.3.2 binarisations, 9.3.3.1 context selection)
    def put_skip_flag(self, mbx, mby, skip, b_slice=False):
        cond = [n is not None and n.kind != "SKIP" for n in (self.mb_at(mbx - 1, mby), self.mb_at(mbx, mby - 1))]
        self.cabac.decision((24 if b_slice else 11) + sum(cond), int(skip))

    def put_chroma_mode(self, w, m, mbx, mby, mode):
        m.chroma_mode = mode
        if not self.cabac:
            w.ue(mode)
            return
        cond = [n is not None and n.chroma_mode != 0 for n in (self.mb_at(mbx - 1, mby), self.mb_at(mbx, mby - 1))]
        self.cabac.decision(64 + sum(cond), int(mode > 0))
        for k in range(1, min(mode + 1, 3)):  # TU, cMax 3
            self.cabac.decision(67, int(k < mode))

    def put_mb_type_i(self, w, mbx, mby, slice_type, t):
        """mb_type of an intra macroblock (0 I_NxN, 1-24 I_16x16, 25 I_PCM) in an I, P or B slice."""
        c = self.cabac
        if not c:
            w.ue(t + {0: 5, 1: 23, 2: 0}[slice_type])
            return
        i_slice = slice_type == 2
        if slice_type == 0:
            c.decision(14, 1)  # the prefix: intra
        elif slice_type == 1:
            self.put_mb_type_b(w, mbx, mby, None)
        base = 17 if slice_type == 0 else 32
        cond = [n is not None and n.kind in ("I16", "PCM")
                for n in (self.mb_at(mbx - 1, mby), self.mb_at(mbx, mby - 1))]
        c.decision(3 + sum(cond) if i_slice else base, int(t != 0))
        if t == 0:
            return
        c.terminate(int(t == 25))
        if t == 25:
            return
        mode, chroma, luma = (t - 1) % 4, ((t - 1) // 4) % 3, (t - 1) // 12
        c.decision(6 if i_slice else base + 1, luma)
        c.decision(7 if i_slice else base + 2, int(chroma > 0))
        if chroma:
            c.decision(8 if i_slice else base + 2, int(chroma == 2))
        c.decision(9 if i_slice else base + 3, mode >> 1)
        c.decision(10 if i_slice else base + 3, mode & 1)

    def put_mb_type_b(self, w, mbx, mby, t):
        """mb_type of a B macroblock (0-22), or with ``t`` None the prefix of an intra one (Table 9-37 (b))."""
        c = self.cabac
        if not c:
            w.ue(t)
            return
        cond = [n is not None and n.kind != "SKIP" and not n.direct16
                for n in (self.mb_at(mbx - 1, mby), self.mb_at(mbx, mby - 1))]
        c.decision(27 + sum(cond), int(t != 0))
        if t == 0:
            return
        if t in (1, 2):
            c.decision(30, 0)
            c.decision(32, t - 1)
            return
        c.decision(30, 1)
        bits = {None: 13, 11: 14, 22: 15}.get(t, t - 3 if t is not None and t <= 10 else None)
        if bits is None:  # 12-21: six bins
            bits = (t + 4) >> 1
        for k, ctx in zip((3, 2, 1, 0), (31, 32, 32, 32)):
            c.decision(ctx, (bits >> k) & 1)
        if t is not None and 12 <= t <= 21:
            c.decision(32, (t + 4) & 1)

    def put_sub_mb_type_b(self, w, t):
        c = self.cabac
        if not c:
            w.ue(t)
            return
        c.decision(36, int(t != 0))
        if t == 0:
            return
        c.decision(37, int(t >= 3))
        if t < 3:
            c.decision(39, t - 1)
            return
        c.decision(38, int(t >= 7))
        if t >= 11:
            c.decision(39, 1)
            c.decision(39, t - 11)
            return
        if t >= 7:
            c.decision(39, 0)
        v = t - (7 if t >= 7 else 3)
        c.decision(39, v >> 1)
        c.decision(39, v & 1)

    def put_mb_type_p(self, w, kind):
        c = self.cabac
        if not c:
            w.ue(kind)
            return
        assert kind < 4, "P_8x8ref0 has no CABAC binarisation"
        c.decision(14, 0)
        c.decision(15, int(kind in (1, 2)))
        if kind in (1, 2):
            c.decision(17, int(kind == 1))
        else:
            c.decision(16, int(kind == 3))

    def put_sub_mb_type(self, w, t):
        c = self.cabac
        if not c:
            w.ue(t)
            return
        c.decision(21, int(t == 0))
        if t:
            c.decision(22, int(t != 1))
            if t != 1:
                c.decision(23, int(t == 2))

    def put_transform_flag(self, w, m, mbx, mby, t8):
        m.t8 = t8
        if not self.cabac:
            w.u(1, int(t8))
            return
        cond = [n is not None and n.t8 for n in (self.mb_at(mbx - 1, mby), self.mb_at(mbx, mby - 1))]
        self.cabac.decision(399 + sum(cond), int(t8))

    def put_intra_mode(self, w, pred, mode):
        c = self.cabac
        rem = mode if mode < pred else mode - 1
        if not c:
            if mode == pred:
                w.u(1, 1)
            else:
                w.u(1, 0)
                w.u(3, rem)
            return
        c.decision(68, int(mode == pred))
        if mode != pred:
            for k in range(3):
                c.decision(69, (rem >> k) & 1)

    def put_cbp(self, w, m, mbx, mby, cbp, intra):
        m.cbp = cbp
        c = self.cabac
        if not c:
            w.ue((CBP_CODE_INTRA if intra else CBP_CODE_INTER)[cbp])
            return
        a, b = self.mb_at(mbx - 1, mby), self.mb_at(mbx, mby - 1)
        for b8 in range(4):
            if b8 & 1:
                ca = not ((cbp >> (b8 - 1)) & 1)
            else:
                ca = a is not None and a.kind != "PCM" and not ((a.cbp >> (b8 + 1)) & 1)
            if b8 & 2:
                cb = not ((cbp >> (b8 - 2)) & 1)
            else:
                cb = b is not None and b.kind != "PCM" and not ((b.cbp >> (b8 + 2)) & 1)
            c.decision(73 + int(ca) + 2 * int(cb), (cbp >> b8) & 1)
        chroma = cbp >> 4
        cond = lambda n, k: int(n is not None and (n.cbp >> 4) > k)  # noqa: E731
        c.decision(77 + cond(a, 0) + 2 * cond(b, 0), int(chroma > 0))
        if chroma:
            c.decision(81 + cond(a, 1) + 2 * cond(b, 1), int(chroma == 2))

    def put_qp_delta(self, w, delta):
        c = self.cabac
        if not c:
            w.se(delta)
        else:
            k = 2 * delta - 1 if delta > 0 else -2 * delta
            c.decision(60 + int(self.prev_dqp != 0), int(k > 0))
            for i in range(1, k + 1):
                c.decision(62 if i == 1 else 63, int(i < k))
        self.prev_dqp = delta

    def put_ref_idx(self, w, ref, mbx, mby, x4, y4, cur_ref, lst=0, num_ref=None, b_slice=False):
        """ref_idx_lX; in B slices a neighbouring block predicted in direct mode counts as reference 0 (``direct``,
        set for the current macroblock's direct sub-macroblocks before their neighbours' indices are written)."""
        c = self.cabac
        if not c:
            if (num_ref or self.num_ref) == 2:
                w.u(1, 1 - ref)
            else:
                w.ue(ref)
            return
        refs = self.arrays(lst)[0]

        def cond(x, y):
            bx, by = mbx * 4 + x, mby * 4 + y
            if x >= 0 and y >= 0:
                return cur_ref[y * 4 + x] > 0 and not (b_slice and self.direct[by * self.mbw * 4 + bx])
            if bx < 0 or by < 0 or self.mb_at(bx >> 2, by >> 2) is None:
                return False
            b = by * self.mbw * 4 + bx
            return refs[b] > 0 and not (b_slice and self.direct[b])

        ctx = 54 + int(cond(x4 - 1, y4)) + 2 * int(cond(x4, y4 - 1))
        used = c.used
        if lst:
            c.used = self.ctx_used_l1
        for i in range(ref + 1):
            c.decision(ctx, int(i < ref))
            ctx = 58 if i == 0 else 59
        c.used = used

    def put_mvd(self, w, d, mbx, mby, x4, y4, lst=0):
        """mvd_lX (both components) of the partition whose top-left 4x4 block is (x4, y4)."""
        c = self.cabac
        mvds = self.arrays(lst)[2]
        if c and lst:
            used, c.used = c.used, self.ctx_used_l1
        for comp in range(2):
            v = d[comp]
            if not c:
                w.se(v)
                continue
            total = 0
            for x, y in ((x4 - 1, y4), (x4, y4 - 1)):
                bx, by = mbx * 4 + x, mby * 4 + y
                inside = x >= 0 and y >= 0
                if inside or (bx >= 0 and by >= 0 and self.mb_at(bx >> 2, by >> 2) is not None):
                    total += mvds[by * self.mbw * 4 + bx][comp]
            base = 47 if comp else 40
            a = abs(v)
            c.decision(base + (0 if total < 3 else 2 if total > 32 else 1), int(a > 0))
            if not a:
                continue
            for k in range(1, min(a, 9) + (a < 9)):  # UEG3's prefix, cMax 9
                c.decision(base + min(k + 2, 6), int(k < a))
            if a >= 9:
                c.exp_golomb(a - 9, 3)
                self.count("cabac_mvd_escapes")
            c.bypass(int(v < 0))
        if c and lst:
            c.used = used

    def block(self, w, m, cat, levels, mbx, mby, comp, x4, y4, max_coeff):
        """One residual block (ctxBlockCat ``cat``; its levels in scan order) at (x4, y4) of component ``comp``'s
        4x4 grid; returns its count of nonzero levels."""
        if not self.cabac:
            nc = -1 if cat == 3 else self.nc(mbx, mby, comp, x4, y4)
            total, counts = write_block(w, levels, nc, max_coeff)
            self.stats.update(counts)
            return total
        c = self.cabac
        nonzero = [i for i, v in enumerate(levels) if v]
        if cat != 5:
            inc = (self.cbf_cond(m, cat, mbx, mby, comp, x4, y4, True)
                   + 2 * self.cbf_cond(m, cat, mbx, mby, comp, x4, y4, False))
            c.decision(85 + CBF_OFFSET[cat] + inc, int(bool(nonzero)))
            if not nonzero:
                return 0
        sig = 402 if cat == 5 else 105 + SIG_OFFSET[cat]
        last = 417 if cat == 5 else 166 + SIG_OFFSET[cat]
        absc = 426 if cat == 5 else 227 + ABS_OFFSET[cat]
        end = nonzero[-1]
        for i in range(min(end + 1, max_coeff - 1)):
            inc = SIG_8X8[i] if cat == 5 else min(i, 2) if cat == 3 else i
            c.decision(sig + inc, int(levels[i] != 0))
            if levels[i]:
                c.decision(last + (LAST_8X8[i] if cat == 5 else inc), int(i == end))
        eq1 = gt1 = 0
        for i in reversed(nonzero):
            a = abs(levels[i]) - 1
            c.decision(absc + (0 if gt1 else min(4, 1 + eq1)), int(a > 0))
            if a:
                ctx = absc + 5 + min(4 - (cat == 3), gt1)
                for k in range(1, min(a, 14) + (a < 14)):  # TU prefix, cMax 14
                    c.decision(ctx, int(k < a))
                if a >= 14:
                    c.exp_golomb(a - 14, 0)
                    self.count("cabac_level_escapes")
                gt1 += 1
            else:
                eq1 += 1
            c.bypass(int(levels[i] < 0))
        return len(nonzero)

    def cbf_cond(self, m, cat, mbx, mby, comp, x4, y4, left):
        """condTermFlagN of coded_block_flag (9.3.3.1.1.9) for the block left of or above (x4, y4)."""
        if cat in (0, 3):
            n = self.mb_at(mbx - 1, mby) if left else self.mb_at(mbx, mby - 1)
        else:
            size = 2 if comp else 4
            x, y = (x4 - 1, y4) if left else (x4, y4 - 1)
            n = m
            if x < 0 or y < 0:
                n = self.mb_at(mbx - (x < 0), mby - (y < 0))
                x, y = x % size, y % size
        if n is None:
            return int(m.intra)
        if n.kind == "PCM":
            return 1
        if cat in (0, 3):
            return (n.dc >> comp) & 1
        return int((n.nz[y * 4 + x] if comp == 0 else n.nz[16 + (comp - 1) * 4 + y * 2 + x]) > 0)


class FFmpegOutput:
    """Which pictures FFmpeg outputs, in which order (h264_select_output_frame at each picture's start, the
    picture chosen output once it is decoded; send_next_delayed_frame at the end of the stream): with the SPS's
    bitstream restriction, held back by max_num_reorder_frames, the lowest picture order count first up to a key
    frame or an MMCO 5 picture, a picture dropped where it comes before one already output; without it, each as it
    is decoded (the writer keeps the count increasing there). ``order``: the ids output; ``reordered``: how many
    came after a picture decoded later."""

    NONE = -(1 << 31)

    def __init__(self, sps):
        self.sps = sps
        self.delayed, self.last, self.next, self.reset_next = [], [self.NONE] * 16, self.NONE, False
        self.order, self.pending, self.reordered, self.max_id = [], None, 0, 0

    def start(self, uid, poc, key):
        cur = self.cur = {"id": uid, "poc": poc, "key": key, "reset": self.reset_next}
        self.reset_next = False
        if key:
            self.last = [self.NONE] * 16
        if not self.sps.bitstream_restriction:
            self.pending = cur
            return
        has_b = self.sps.num_reorder_frames
        i = 0
        while True:
            if i == 16 or poc < self.last[i]:
                if i:
                    self.last[i - 1] = poc
                break
            if i:
                self.last[i - 1] = self.last[i]
            i += 1
        if i == 0:
            self.last = [poc] + [self.NONE] * 15
            cur["reset"] = True
        self.delayed.append(cur)
        out = 0
        for k in range(1, len(self.delayed)):
            if self.delayed[k]["key"] or self.delayed[k]["reset"]:
                break
            if self.delayed[k]["poc"] < self.delayed[out]["poc"]:
                out = k
        if has_b == 0 and (self.delayed[0]["key"] or self.delayed[0]["reset"]):
            self.next = self.NONE
        picked = self.delayed[out]
        late = picked["poc"] < self.next
        ready = len(self.delayed) > has_b
        if late or ready:
            del self.delayed[out]
        if not late and ready:
            self.pending = picked
            first = self.delayed[0] if self.delayed else None
            self.next = self.NONE if out == 0 and first and (first["key"] or first["reset"]) else picked["poc"]

    def finish(self, mmco5):
        if mmco5:  # FFmpeg's MMCO_RESET: this picture and the next one
            self.reset_next = self.cur["reset"] = True
            self.last = [self.NONE] * 16
        if self.pending:
            self.emit(self.pending)
        self.pending = None

    def emit(self, pic):
        self.reordered += pic["id"] < self.max_id
        self.max_id = max(self.max_id, pic["id"])
        self.order.append(pic["id"])

    def flush(self):
        while self.delayed:
            out = 0
            for k in range(1, len(self.delayed)):
                if self.delayed[k]["key"] or self.delayed[k]["reset"]:
                    break
                if self.delayed[k]["poc"] < self.delayed[out]["poc"]:
                    out = k
            self.emit(self.delayed.pop(out))


class StreamWriter(_Syntax):
    """Random syntax, one access unit a call to :meth:`picture`."""

    def __init__(self, rng, opts: Options):
        self.rng, self.o = rng, opts
        self.stats = Counter()
        mbw, mbh = opts.mb_width, opts.mb_height
        self.mbw, self.mbh = mbw, mbh
        poc_type = opts.poc_type if opts.poc_type is not None else int(rng.integers(3))
        max_refs = opts.max_refs if opts.max_refs is not None else int(rng.integers(1, 17))
        self.sps = Sps(mbw, mbh, profile_idc=int(rng.choice([66, 77, 100])), poc_type=poc_type,
                       log2_max_frame_num=int(rng.integers(4, 8)), log2_max_poc_lsb=int(rng.integers(5, 9)),
                       delta_always_zero=bool(rng.integers(2)), offset_non_ref=1,
                       offsets_ref=[int(v) for v in rng.integers(2, 5, size=int(rng.integers(1, 4)))],
                       max_num_ref_frames=max_refs, crop=opts.crop, vui=bool(rng.integers(2)),
                       matrix=int(rng.choice([1, 2, 4, 5, 6, 7])) if rng.integers(2) else None,
                       full_range=bool(rng.integers(2)),
                       bitstream_restriction=bool(rng.integers(2)))
        constrained = opts.constrained_intra
        self.ppss = []
        for pps_id in range(int(rng.integers(1, 3))):
            self.ppss.append(Pps(pps_id=pps_id, num_ref_default=int(rng.integers(1, max_refs + 1)),
                                 weighted=opts.weights and bool(rng.integers(2)),
                                 pic_init_qp=int(rng.integers(opts.qp_range[0], opts.qp_range[1] + 1)),
                                 chroma_qp_offset=int(rng.integers(-12, 13)),
                                 deblocking_control=bool(rng.integers(4)),
                                 constrained_intra=bool(rng.integers(2)) if constrained is None else constrained,
                                 bottom_field_pic_order=poc_type in (0, 1) and bool(rng.integers(2))))
        if opts.cabac or opts.transform_8x8 or opts.sps_lists or opts.pps_lists or opts.second_chroma_qp_offset:
            self.sps.profile_idc = 100
            if opts.sps_lists:
                self.sps.scaling_lists = self.random_lists(8)
            for pps in self.ppss:
                pps.cabac, pps.transform_8x8 = opts.cabac, opts.transform_8x8
                if opts.pps_lists:
                    pps.scaling_lists = self.random_lists(8 if pps.transform_8x8 else 6)
                if opts.second_chroma_qp_offset:
                    pps.second_chroma_qp_offset = (pps.chroma_qp_offset + self.ri(1, 24) + 12) % 25 - 12
        self.ctx_used = set()
        self.ctx_used_l1 = set()  # (table, ctxIdx) of list 1's ref_idx and mvd bins
        self.facts = Counter()  # what the stream reaches beyond STATS: long-term pictures in list 1, ...
        self.refs: list[_Ref] = []
        self.max_long_idx = -1
        self.prev_ref_frame_num = 0
        self.poc_counter = 0
        self.uid = 0
        self.uid_next = 1  # pictures in decoding order, for the output model
        self.first = True
        self.last_non_ref = False
        self.frame_num_offset = 0
        self.prev_frame_num = 0
        self.gop = []  # the pictures planned, in decoding order (B streams)
        self.output = FFmpegOutput(self.sps)
        if opts.b_frames:
            self.setup_b()

    def setup_b(self):
        """The parameter sets of a stream with B pictures: reordered in POC type 0 (the VUI's bitstream restriction
        with what the GOPs need), in display order in POC type 2."""
        o, sps = self.o, self.sps
        sps.poc_type = 0 if o.poc_type is None else o.poc_type
        assert sps.poc_type in (0, 2), "B pictures in POC type 0 (reordered) or 2 (in display order)"
        self.reorder = sps.poc_type == 0
        if sps.profile_idc == 66:
            sps.profile_idc = 77
        sps.log2_max_poc_lsb = self.ri(7, 9)
        sps.direct_8x8_inference = bool(self.ri(0, 1)) if o.direct_8x8_inference is None else o.direct_8x8_inference
        if self.reorder:
            sps.vui = sps.bitstream_restriction = True
            need = 2 if o.b_pyramid else 1
            sps.num_reorder_frames = need + self.ri(0, o.extra_reorder)
        for pps in self.ppss:
            pps.num_ref_default_l1 = self.ri(1, max(sps.max_num_ref_frames, 1))
            pps.bipred_idc = self.ri(0, 2) if o.bipred_idc is None else o.bipred_idc
            pps.bottom_field_pic_order = False
        self.output = FFmpegOutput(sps)

    # ---- helpers
    def chance(self, p):
        return self.rng.random() < p

    def ri(self, lo, hi):
        """A random integer in [lo, hi]."""
        return int(self.rng.integers(lo, hi + 1))

    def parameter_sets(self):
        self.stats.update(parameter_set_counts(self.sps, self.ppss))
        return [nal_unit(3, 7, self.sps.rbsp())] + [nal_unit(3, 8, p.rbsp()) for p in self.ppss]

    def random_lists(self, count):
        """Scaling lists for Sps / Pps.scaling_lists: each not sent, the default or explicit (4x4 weights 2-200, the
        first at most 28; 8x8 weights 2-50; the tail sometimes left to repeat the last one sent)."""
        lists = []
        for i in range(count):
            mode = self.o.list_modes[self.ri(0, len(self.o.list_modes) - 1)]
            if mode == "absent":
                lists.append(None)
            elif mode == "default":
                lists.append("default")
            else:
                size = 16 if i < 6 else 64
                # An 8x8 block coded under CABAC holds a level, whose scaled value stays within 16 bits at QP 51
                # while the 8x8 weights stay at most 50.
                values = [self.ri(2, 200 if size == 16 else 50) for _ in range(size)]
                if size == 16:
                    # FFmpeg's x86 DC dequantisation is exact while LevelScale4x4(qP % 6, 0, 0) << (qP / 6 + 2) fits
                    # 15 bits or is a multiple of 128: at most 28 keeps both DC weights within that at any QP.
                    values[0] = self.ri(2, 28)
                sent = size
                if self.chance(0.4):
                    sent = self.ri(1, size - 1)
                    values[sent:] = [values[sent - 1]] * (size - sent)
                lists.append((values, sent))
        return lists

    # ---- pictures
    def plan_gop(self):
        """The next pictures in decoding order, (IDR, kind "I" / "P" / "B", reference, display slot): an anchor, then
        up to 3 B pictures shown before it (a middle one first, as a reference, where the pyramid is drawn); in POC
        type 2 one picture, a B picture 7 times in 10 where the DPB holds a reference."""
        o = self.o
        idr = (self.first and not o.first_non_idr) or (not self.first and self.chance(0.1))
        if idr:
            self.slot = 0
            self.gop = [(True, "I", True, 0)]
            return
        step = lambda: self.ri(1, o.poc_step) if o.poc_step > 1 else o.poc_step  # noqa: E731
        if not self.reorder:
            kind = "I" if o.intra_only or self.chance(0.15) else "B" if self.chance(0.7) else "P"
            ref = not o.non_ref or self.last_non_ref or self.chance(0.75)
            self.gop = [(False, kind, ref, 0)]
            return
        g = self.ri(0, 3)
        slots = [self.slot]
        for _ in range(g + 1):
            slots.append(slots[-1] + step())
        self.slot = slots[-1]
        anchor = "I" if o.intra_only or self.chance(0.15) else "P"
        self.gop = [(False, anchor, True, slots[-1])]
        bs = slots[1:-1]
        if g >= 2 and o.b_pyramid and self.chance(0.7):
            mid = self.ri(1, g - 2) if g > 2 else self.ri(0, 1)
            self.gop.append((False, "B", True, bs.pop(mid)))
        for b in bs:
            self.gop.append((False, "B", not o.non_ref or self.chance(0.2), b))

    def picture(self):
        o, rng = self.o, self.rng
        kind = None
        if o.b_frames:
            if not self.gop:
                self.plan_gop()
            idr, kind, ref_flag, slot = self.gop.pop(0)
            intra = kind == "I" or o.intra_only
            if intra and kind == "B":
                kind = "I"
            ref_idc = self.ri(1, 3) if idr or ref_flag or self.first else 0
        else:
            idr = (self.first and not o.first_non_idr) or (not self.first and self.chance(0.1))
            intra = idr or self.first or self.chance(0.15) or o.intra_only
            # Two non-reference pictures in a row would share a picture order count.
            ref_idc = self.ri(1, 3) if idr or self.first or not o.non_ref or self.last_non_ref or self.chance(0.75) \
                else 0
        self.last_non_ref = not ref_idc
        au = self.parameter_sets() if idr or self.first or self.chance(0.2) else []
        max_frame_num = 1 << self.sps.log2_max_frame_num
        frame_num = 0 if idr else (self.prev_ref_frame_num + 1) % max_frame_num
        if idr:
            self.refs = []
            self.max_long_idx = -1
            self.poc_counter = 0
            self.frame_num_offset = 0
            self.prev_frame_num = 0
        pps = self.ppss[self.ri(0, len(self.ppss) - 1)]
        # The marking, the same in every slice.
        marking = self.plan_marking(idr, ref_idc, frame_num)
        # Picture order count fields.
        if o.b_frames and self.reorder:
            self.poc_counter = slot
        else:
            self.poc_counter += self.ri(1, o.poc_step) if o.poc_step > 1 else o.poc_step
        poc_lsb = (2 * self.poc_counter) % (1 << self.sps.log2_max_poc_lsb) if not idr else 0
        if idr:
            self.poc_counter = 0
        delta_bottom = self.ri(-1, 1) if pps.bottom_field_pic_order else 0
        delta_poc = [0, self.ri(0, 1) if pps.bottom_field_pic_order else 0]
        if not idr and self.prev_frame_num > frame_num:
            self.frame_num_offset += max_frame_num
        self.cur_frame_num = frame_num
        # The picture order count as FFmpeg counts it, relative to the last IDR picture (B streams: POC type 0 or 2).
        if self.sps.poc_type == 0:
            self.cur_poc = 2 * self.poc_counter + min(0, delta_bottom)
        else:
            self.cur_poc = 2 * (self.frame_num_offset + frame_num) - int(not ref_idc)
        self.mbs = [None] * (self.mbw * self.mbh)
        self.new_arrays()  # per 4x4 block: references, vectors, |mvd| (CABAC's mvd contexts), direct
        # Slices.
        total = self.mbw * self.mbh
        cuts = [0]
        if o.slices and total > 1 and self.chance(0.5):
            cuts += sorted(set(int(c) for c in rng.integers(1, total, size=self.ri(1, 2))))
        cuts.append(total)
        self.count("pictures")
        self.count("poc_type_%d" % self.sps.poc_type)
        if idr:
            self.count("idr_pictures")
        if not ref_idc:
            self.count("non_ref_pictures")
        if len(cuts) > 2:
            self.count("multi_slice_pictures")
        if any(self.sps.crop):
            self.count("cropped_pictures")
        self.pic_kind = kind
        self.output.start(self.uid_next, self.cur_poc, idr)
        for s in range(len(cuts) - 1):
            au.append(self.slice(s, cuts[s], cuts[s + 1], idr, intra, ref_idc, pps, frame_num, poc_lsb,
                                 delta_bottom, delta_poc, marking))
        if kind == "B" and ref_idc:
            self.count("reference_b_pictures")
        self.apply_marking(idr, ref_idc, frame_num, marking)
        self.output.finish(bool(marking.get("mmco5")))
        self.uid_next += 1
        self.prev_frame_num = frame_num if not marking.get("mmco5") else 0
        if marking.get("mmco5"):
            # frame_num starts over; the POC lsb goes on counting, so that FFmpeg's count, which goes on from the
            # reset picture's, increases (elsewhere FFmpeg's output order depends on its thread count).
            self.frame_num_offset = 0
        self.first = False
        return au

    def wraps(self, frame_num):
        max_frame_num = 1 << self.sps.log2_max_frame_num
        return {id(r): (r.frame_num - max_frame_num if r.frame_num > frame_num else r.frame_num)
                for r in self.refs if not r.long}

    def plan_marking(self, idr, ref_idc, frame_num):
        o = self.o
        if not ref_idc:
            return {}
        if idr:
            return {"long_term_reference": o.long_term and self.chance(0.3)}
        limit = max(self.sps.max_num_ref_frames, 1)
        full_of_long = len(self.refs) >= limit and all(r.long for r in self.refs)
        if not (o.mmco and self.chance(0.4)) and not full_of_long:
            return {"adaptive": False}
        # Simulate the operations on copies of the references.
        wrapv = self.wraps(frame_num)
        refs, wrap = [], {}
        for r in self.refs:
            c = _Ref(r.frame_num, r.uid, r.long, r.long_idx)
            refs.append(c)
            if not r.long:
                wrap[id(c)] = wrapv[id(r)]
        max_idx = self.max_long_idx
        ops, current_long = [], None
        for _ in range(self.ri(1, 4) if o.mmco else 0):
            choice = self.ri(1, 6)
            shorts = [r for r in refs if not r.long]
            longs = [r for r in refs if r.long]
            if choice == 1 and shorts:
                r = shorts[self.ri(0, len(shorts) - 1)]
                ops.append((1, frame_num - wrap[id(r)] - 1))
                refs.remove(r)
            elif choice == 2 and longs:
                r = longs[self.ri(0, len(longs) - 1)]
                ops.append((2, r.long_idx))
                refs.remove(r)
            elif choice == 3 and shorts and max_idx >= 0:
                r = shorts[self.ri(0, len(shorts) - 1)]
                idx = self.ri(0, max_idx)
                ops.append((3, frame_num - wrap[id(r)] - 1, idx))
                for x in [x for x in refs if x.long and x.long_idx == idx]:
                    refs.remove(x)
                r.long, r.long_idx = True, idx
            elif choice == 4 and o.long_term:
                new_max = self.ri(0, 4)
                ops.append((4, new_max))
                max_idx = new_max - 1
                for x in [x for x in refs if x.long and x.long_idx > max_idx]:
                    refs.remove(x)
            elif choice == 5 and self.sps.poc_type == 0 and self.chance(0.3):
                ops.append((5,))
                refs.clear()
                break
            elif choice == 6 and max_idx >= 0 and o.long_term:
                current_long = self.ri(0, max_idx)
                ops.append((6, current_long))
                for x in [x for x in refs if x.long and x.long_idx == current_long]:
                    refs.remove(x)
                break
        # Keep within max_num_ref_frames, the current picture included: the oldest short-term references go first.
        while len(refs) + 1 > limit:
            shorts = [r for r in refs if not r.long]
            if shorts:
                r = min(shorts, key=lambda x: wrap[id(x)])
                ops.append((1, frame_num - wrap[id(r)] - 1))
            else:
                r = refs[0]
                ops.append((2, r.long_idx))
            refs.remove(r)
        if not ops:
            return {"adaptive": False}
        return {"adaptive": True, "ops": ops, "mmco5": any(op[0] == 5 for op in ops)}

    def apply_marking(self, idr, ref_idc, frame_num, marking):
        """The decoded reference picture marking of the picture just written (8.2.5)."""
        if not ref_idc:
            return
        self.uid += 1
        cur = _Ref(frame_num, self.uid)
        if idr:
            self.refs = []
            if marking["long_term_reference"]:
                cur.long, cur.long_idx = True, 0
                self.max_long_idx = 0
                self.count("long_term_refs")
            else:
                self.max_long_idx = -1
        elif not marking["adaptive"]:
            if len(self.refs) >= max(self.sps.max_num_ref_frames, 1):
                wrap = self.wraps(frame_num)
                shorts = [r for r in self.refs if not r.long]
                self.refs.remove(min(shorts, key=lambda x: wrap[id(x)]))
                self.count("sliding_window_removals")
        else:
            for op in marking["ops"]:
                self.count("mmco_%d" % op[0])
                wrap = self.wraps(frame_num)
                by_num = {frame_num - wrap[id(r)] - 1: r for r in self.refs if not r.long}
                if op[0] == 1:
                    self.refs.remove(by_num[op[1]])
                elif op[0] == 2:
                    self.refs.remove(next(r for r in self.refs if r.long and r.long_idx == op[1]))
                elif op[0] == 3:
                    r = by_num[op[1]]
                    for x in [x for x in self.refs if x.long and x.long_idx == op[2]]:
                        self.refs.remove(x)
                    r.long, r.long_idx = True, op[2]
                    self.count("long_term_refs")
                elif op[0] == 4:
                    self.max_long_idx = op[1] - 1
                    self.refs = [x for x in self.refs if not (x.long and x.long_idx > self.max_long_idx)]
                elif op[0] == 5:
                    self.refs = []
                    self.max_long_idx = -1
                    cur.frame_num = 0
                elif op[0] == 6:
                    for x in [x for x in self.refs if x.long and x.long_idx == op[1]]:
                        self.refs.remove(x)
                    cur.long, cur.long_idx = True, op[1]
                    self.count("long_term_refs")
        cur.poc = self.cur_poc
        if self.o.b_frames:
            cur.motion = self.motion_record(self.ref_lists)
        self.refs.append(cur)
        self.prev_ref_frame_num = cur.frame_num
        assert len(self.refs) <= max(self.sps.max_num_ref_frames, 1)

    # ---- slices
    def ref_list(self, frame_num, num_ref, mods):
        """RefPicList0 after its initialisation and the modifications ``mods`` (8.2.4.2.1, 8.2.4.3)."""
        wrap = self.wraps(frame_num)
        shorts = sorted([r for r in self.refs if not r.long], key=lambda r: -wrap[id(r)])
        longs = sorted([r for r in self.refs if r.long], key=lambda r: r.long_idx)
        lst = (shorts + longs)[:num_ref]
        lst += [None] * (num_ref + 1 - len(lst))
        for idx, pic in enumerate(mods):
            for c in range(num_ref, idx, -1):
                lst[c] = lst[c - 1]
            lst[idx] = pic
            n = idx + 1
            for c in range(idx + 1, num_ref + 1):
                if lst[c] is not pic:
                    lst[n] = lst[c]
                    n += 1
        return lst[:num_ref]

    def slice(self, index, first, end, idr, intra, ref_idc, pps, frame_num, poc_lsb, delta_bottom, delta_poc,
              marking):
        o, sps = self.o, self.sps
        w = BitWriter()
        w.ue(first)
        if self.pic_kind is not None:  # B streams: every slice of a picture has its type
            slice_type = {"I": 2, "P": 0, "B": 1}[self.pic_kind]
        else:
            slice_type = 2 if intra else (0 if not self.chance(0.1) else 2)
        w.ue(slice_type + (5 if self.chance(0.3) else 0))
        w.ue(pps.pps_id)
        w.u(sps.log2_max_frame_num, frame_num)
        if idr:
            w.ue(self.ri(0, 3))
        if sps.poc_type == 0:
            w.u(sps.log2_max_poc_lsb, poc_lsb)
            if pps.bottom_field_pic_order:
                w.se(delta_bottom)
        elif sps.poc_type == 1 and not sps.delta_always_zero:
            w.se(delta_poc[0])
            if pps.bottom_field_pic_order:
                w.se(delta_poc[1])
        if pps.redundant_pic_cnt:
            w.ue(o.redundant_pic_cnt)
        self.count("slices")
        self.count({2: "i_slices", 0: "p_slices", 1: "b_slices"}[slice_type])
        self.refs_list = []
        self.ref_lists = [[], []]
        self.weights = None
        if self.pic_kind is not None:
            if slice_type == 1:
                self.direct_spatial = o.direct_spatial if o.direct_spatial is not None else self.chance(0.5)
                w.u(1, int(self.direct_spatial))
            if slice_type != 2:
                if index == 0:  # every slice of a picture has the same lists
                    self.list_plan = self.draw_lists(slice_type, frame_num, pps)
                self.write_lists(w, self.list_plan, slice_type)
                if slice_type == 1 and pps.bipred_idc == 2:
                    self.count("implicit_bipred_slices")
        elif slice_type == 0:
            usable = len(self.refs)
            num_ref = pps.num_ref_default
            if o.bad_ref_idx:
                num_ref = usable + 1
                w.u(1, 1)
                w.ue(num_ref - 1)
            elif num_ref > usable or self.chance(0.3):
                num_ref = self.ri(1, usable)
                w.u(1, 1)
                w.ue(num_ref - 1)
            else:
                w.u(1, 0)
            mods = []
            if o.modifications and self.chance(0.4):
                w.u(1, 1)
                pred = frame_num
                max_pic_num = 1 << sps.log2_max_frame_num
                wrap = self.wraps(frame_num)
                for _ in range(self.ri(1, num_ref)):
                    r = self.refs[self.ri(0, len(self.refs) - 1)]
                    if r.long:
                        w.ue(2)
                        w.ue(r.long_idx)
                    else:
                        no_wrap = wrap[id(r)] % max_pic_num  # picNumLXNoWrap of the target
                        if self.chance(0.5):
                            w.ue(0)
                            w.ue(((pred - no_wrap) % max_pic_num or max_pic_num) - 1)
                        else:
                            w.ue(1)
                            w.ue(((no_wrap - pred) % max_pic_num or max_pic_num) - 1)
                        pred = no_wrap
                    mods.append(r)
                    self.count("list_modifications")
                w.ue(3)
            else:
                w.u(1, 0)
            self.refs_list = self.ref_list(frame_num, num_ref, mods)
            self.num_ref = num_ref
            if pps.weighted:
                self.weights = self.pred_weight_table(w, num_ref)
                self.count("weighted_slices")
        if ref_idc:
            if idr:
                w.u(1, int(o.no_output_of_prior_pics))
                w.u(1, int(marking["long_term_reference"]))
            else:
                w.u(1, int(marking["adaptive"]))
                if marking["adaptive"]:
                    for op in marking["ops"]:
                        w.ue(op[0])
                        for v in op[1:]:
                            w.ue(v)
                    w.ue(0)
        table = 0
        if pps.cabac:
            self.count("cabac_slices")
            if slice_type != 2:
                idc = self.ri(0, 2) if o.cabac_init_idc is None else o.cabac_init_idc
                w.ue(idc)
                self.count("cabac_init_idc_%d" % idc)
                table = 1 + idc
        qp = self.ri(*o.qp_range)
        w.se(qp - pps.pic_init_qp)
        idc, alpha, beta = 0, 0, 0
        if pps.deblocking_control:
            idc = self.ri(0, 2)
            w.ue(idc)
            if idc != 1:
                alpha, beta = self.ri(-6, 6), self.ri(-6, 6)
                w.se(alpha)
                w.se(beta)
        self.count("deblock_idc_%d" % idc)
        if idc != 1 and (alpha or beta):
            self.count("deblock_offsets")
        if pps.constrained_intra:
            self.count("constrained_intra_slices")
        self.pps, self.slice_index = pps, index
        self.lists = resolve_lists(sps, pps)
        self.cabac = None
        if pps.cabac:
            w.align_one()  # cabac_alignment_one_bit
            self.cabac = CabacWriter(w, qp, table, self.ctx_used)
        self.slice_data(w, first, end, slice_type, qp)
        if self.cabac:
            w.align_zero()  # the flush of end_of_slice_flag wrote the rbsp_stop_one_bit
        else:
            w.trailing()
        return nal_unit(ref_idc, 5 if idr else 1, w.data())

    def draw_lists(self, slice_type, frame_num, pps):
        """The list syntax of the slices of a picture of a B stream: num_ref_idx_active of each list (overridden, or
        the PPS's where the DPB holds that many), the modifications of each list (idc, value, picture) and the
        weights (explicit weighted prediction of P slices, weighted_bipred_idc 1 in B slices)."""
        o, sps = self.o, self.sps
        n = 2 if slice_type == 1 else 1
        usable = len(self.refs)
        num = [pps.num_ref_default, pps.num_ref_default_l1][:n]
        override = any(k > usable for k in num) or self.chance(0.3)
        if override:
            num = [self.ri(1, usable) for _ in range(n)]
        mods = []
        max_pic_num = 1 << sps.log2_max_frame_num
        wrap = self.wraps(frame_num)
        for lst in range(n):
            entries = []
            if o.modifications and self.chance(0.4):
                pred = frame_num
                for _ in range(self.ri(1, num[lst])):
                    r = self.refs[self.ri(0, len(self.refs) - 1)]
                    if r.long:
                        entries.append((2, r.long_idx, r))
                        continue
                    no_wrap = wrap[id(r)] % max_pic_num  # picNumLXNoWrap of the target
                    if self.chance(0.5):
                        entries.append((0, ((pred - no_wrap) % max_pic_num or max_pic_num) - 1, r))
                    else:
                        entries.append((1, ((no_wrap - pred) % max_pic_num or max_pic_num) - 1, r))
                    pred = no_wrap
            mods.append(entries)
        weights = None
        if (pps.weighted if slice_type == 0 else pps.bipred_idc == 1):
            weights = (self.ri(0, 7), self.ri(0, 7), [[self.draw_weight() for _ in range(k)] for k in num])
        return {"override": override, "num": num, "mods": mods, "weights": weights}

    def draw_weight(self):
        entry = {}
        if self.chance(0.6):
            entry["luma"] = (self.ri(-128, 127), self.ri(-128, 127))
        if self.chance(0.6):
            entry["chroma"] = [(self.ri(-128, 127), self.ri(-128, 127)) for _ in range(2)]
        return entry

    def write_lists(self, w, plan, slice_type):
        """The slice header's list syntax of ``plan`` (:meth:`draw_lists`); the lists it makes."""
        w.u(1, int(plan["override"]))
        if plan["override"]:
            for k in plan["num"]:
                w.ue(k - 1)
        for lst, entries in enumerate(plan["mods"]):
            w.u(1, int(bool(entries)))
            for idc, value, _ in entries:
                w.ue(idc)
                w.ue(value)
                self.count("list1_modifications" if lst else "list_modifications")
            if entries:
                w.ue(3)
        if plan["weights"]:
            luma_log2, chroma_log2, tables = plan["weights"]
            w.ue(luma_log2)
            w.ue(chroma_log2)
            for table in tables:
                for entry in table:
                    w.u(1, int("luma" in entry))
                    if "luma" in entry:
                        w.se(entry["luma"][0])
                        w.se(entry["luma"][1])
                    w.u(1, int("chroma" in entry))
                    for cw, co in entry.get("chroma", ()):
                        w.se(cw)
                        w.se(co)
            self.count("explicit_bipred_slices" if slice_type == 1 else "weighted_slices")
        self.ref_lists = [self.apply_mods(init, plan["num"][lst], [e[2] for e in plan["mods"][lst]])
                          for lst, init in enumerate(self.initial_lists(slice_type))]
        self.num_refs = plan["num"]
        self.num_ref, self.refs_list = plan["num"][0], self.ref_lists[0]
        if slice_type == 1:
            self.col, self.d8 = self.ref_lists[1][0].motion, self.sps.direct_8x8_inference
            self.dsf = None if self.direct_spatial else self.scale_factors()
            self.facts["long_term_in_list1"] += any(r.long for r in self.ref_lists[1])
            self.facts["b_picture_co_located"] += bool(self.col["b"])

    def initial_lists(self, slice_type):
        """The initial reference lists (8.2.4.2.1, 8.2.4.2.3): P by PicNum, B by picture order count, the first two
        entries of list 1 switched where it equals list 0."""
        longs = sorted([r for r in self.refs if r.long], key=lambda r: r.long_idx)
        shorts = [r for r in self.refs if not r.long]
        if slice_type == 0:
            wrap = self.wraps(self.cur_frame_num)
            return [sorted(shorts, key=lambda r: -wrap[id(r)]) + longs]
        before = sorted([r for r in shorts if r.poc <= self.cur_poc], key=lambda r: -r.poc)
        after = sorted([r for r in shorts if r.poc > self.cur_poc], key=lambda r: r.poc)
        l0, l1 = before + after + longs, after + before + longs
        if len(l1) > 1 and all(a is b for a, b in zip(l0, l1)):
            l1[0], l1[1] = l1[1], l1[0]
        return [l0, l1]

    @staticmethod
    def apply_mods(initial, num_ref, mods):
        """A list cut to ``num_ref`` entries after the modifications naming the pictures ``mods`` (8.2.4.3)."""
        lst = initial[:num_ref]
        lst += [None] * (num_ref + 1 - len(lst))
        for idx, pic in enumerate(mods):
            for c in range(num_ref, idx, -1):
                lst[c] = lst[c - 1]
            lst[idx] = pic
            n = idx + 1
            for c in range(idx + 1, num_ref + 1):
                if lst[c] is not pic:
                    lst[n] = lst[c]
                    n += 1
        return lst[:num_ref]

    def pred_weight_table(self, w, num_ref):
        luma_log2, chroma_log2 = self.ri(0, 7), self.ri(0, 7)
        w.ue(luma_log2)
        w.ue(chroma_log2)
        weights = []
        for _ in range(num_ref):
            entry = {}
            if self.chance(0.6):
                entry["luma"] = (self.ri(-128, 127), self.ri(-128, 127))
                w.u(1, 1)
                w.se(entry["luma"][0])
                w.se(entry["luma"][1])
            else:
                w.u(1, 0)
            if self.chance(0.6):
                entry["chroma"] = [(self.ri(-128, 127), self.ri(-128, 127)) for _ in range(2)]
                w.u(1, 1)
                for cw, co in entry["chroma"]:
                    w.se(cw)
                    w.se(co)
            else:
                w.u(1, 0)
            weights.append(entry)
        return weights

    def far(self, mbx, mby, px, py, w, h, mv):
        ax, ay = mbx * 16 + px + (mv[0] >> 2), mby * 16 + py + (mv[1] >> 2)
        W, H = self.mbw * 16, self.mbh * 16
        if ax + w <= -16 or ay + h <= -16 or ax >= W + 16 or ay >= H + 16:
            self.count("far_mv_partitions")

    # ---- macroblocks
    def slice_data(self, w, first, end, slice_type, qp):
        o = self.o
        self.qp = qp
        self.prev_dqp = 0
        run = 0
        for addr in range(first, end):
            mbx, mby = addr % self.mbw, addr // self.mbw
            m = _Mb(self.slice_index)
            self.mbs[addr] = m
            skip = slice_type != 2 and self.chance(o.skip_share if slice_type == 0 else o.b_mb_shares[0])
            if self.cabac and slice_type != 2:
                self.put_skip_flag(mbx, mby, skip, slice_type == 1)
            if skip:
                m.kind = "SKIP"
                run += 1
                if slice_type == 1:
                    self.b_skip(m, mbx, mby)
                else:
                    self.skip(mbx, mby)
                self.prev_dqp = 0
            else:
                if slice_type != 2 and not self.cabac:
                    w.ue(run)
                    if run:
                        self.count("skip_runs")
                    run = 0
                self.macroblock(w, m, mbx, mby, slice_type)
            if self.cabac:
                self.cabac.terminate(int(addr == end - 1))  # end_of_slice_flag
        if run and not self.cabac:
            w.ue(run)
            self.count("skip_runs")

    def skip(self, mbx, mby):
        self.count("P_Skip")
        mv = self.skip_mv(mbx, mby)
        if mv != (0, 0):
            self.count("skip_mv_nonzero")
        self.set_motion(mbx, mby, 0, 0, 4, 4, 0, mv)
        self.set_mvd(mbx, mby, 0, 0, 4, 4, (0, 0))
        self.far(mbx, mby, 0, 0, 16, 16, mv)

    def macroblock(self, w, m, mbx, mby, slice_type):
        o = self.o
        if slice_type == 0 and not self.chance(o.intra_share):
            self.inter_mb(w, m, mbx, mby)
            return
        if slice_type == 1:
            if not self.chance(o.b_mb_shares[1] / max(1e-9, 1 - o.b_mb_shares[0])):
                self.b_mb(w, m, mbx, mby)
                return
            self.count("intra_mbs_in_b_slices")
        if slice_type == 0:
            self.count("intra_mbs_in_p_slices")
        self.set_motion(mbx, mby, 0, 0, 4, 4, -1, (0, 0))
        self.set_mvd(mbx, mby, 0, 0, 4, 4, (0, 0))
        r = self.rng.random()
        if o.pcm and r < 0.08:
            m.kind = "PCM"
            m.nz, m.cbp, m.dc = [16] * 24, 0x2F, 7
            self.count("I_PCM")
            self.put_mb_type_i(w, mbx, mby, slice_type, 25)
            w.align_zero()
            for v in self.rng.integers(1, 256, size=384):
                w.u(8, int(v))
            if self.cabac:
                self.count("cabac_pcm")
                self.cabac.start()
                self.prev_dqp = 0
            return
        if r < 0.55:
            m.kind = "I4"
            self.count("I_NxN")
            self.put_mb_type_i(w, mbx, mby, slice_type, 0)
            if self.pps.transform_8x8:
                self.put_transform_flag(w, m, mbx, mby, self.chance(0.5))
            if m.t8:
                self.count("I_8x8")
            for blk in range(4 if m.t8 else 16):
                x4 = (blk & 1) * 2 if m.t8 else ((blk >> 2) & 1) * 2 + (blk & 1)
                y4 = (blk >> 1) * 2 if m.t8 else (blk >> 3) * 2 + ((blk >> 1) & 1)
                avail = self.i4_avail(mbx, mby, x4, y4, blk)
                allowed = [mode for mode, needs in I4_NEEDS.items() if all(avail[c] for c in needs)]
                mode = allowed[self.ri(0, len(allowed) - 1)]
                pa, pb = self.i4_neighbour(mbx, mby, x4 - 1, y4, m), self.i4_neighbour(mbx, mby, x4, y4 - 1, m)
                self.put_intra_mode(w, 2 if pa < 0 or pb < 0 else min(pa, pb), mode)
                for k in range(4 if m.t8 else 1):
                    m.i4[(y4 + (k >> 1)) * 4 + x4 + (k & 1)] = mode
                self.count(("i8x8_" if m.t8 else "i4x4_") + I_MODES[mode])
            self.chroma_mode(w, m, mbx, mby)
            cbp = self.ri(0, 47)
            self.put_cbp(w, m, mbx, mby, cbp, True)
            self.residual(w, m, mbx, mby, cbp & 15, cbp >> 4, False)
            return
        m.kind = "I16"
        self.count("I_16x16")
        left, top, corner = (self.intra_avail(mbx - 1, mby), self.intra_avail(mbx, mby - 1),
                             self.intra_avail(mbx - 1, mby - 1))
        allowed = [2] + [0] * top + [1] * left + [3] * (top and left and corner)
        mode = allowed[self.ri(0, len(allowed) - 1)]
        self.count("i16x16_" + ("vertical", "horizontal", "dc", "plane")[mode])
        cbp_chroma, cbp_luma = self.ri(0, 2), 15 * self.ri(0, 1)
        self.put_mb_type_i(w, mbx, mby, slice_type, 1 + mode + 4 * cbp_chroma + (12 if cbp_luma else 0))
        m.cbp = cbp_luma | cbp_chroma << 4
        self.chroma_mode(w, m, mbx, mby)
        self.residual(w, m, mbx, mby, cbp_luma, cbp_chroma, True)

    def chroma_mode(self, w, m, mbx, mby):
        left, top, corner = (self.intra_avail(mbx - 1, mby), self.intra_avail(mbx, mby - 1),
                             self.intra_avail(mbx - 1, mby - 1))
        allowed = [0] + [1] * left + [2] * top + [3] * (top and left and corner)
        mode = allowed[self.ri(0, len(allowed) - 1)]
        self.put_chroma_mode(w, m, mbx, mby, mode)
        self.count("chroma_" + ("dc", "horizontal", "vertical", "plane")[mode])
        return mode

    def ref_idx(self, w, mbx, mby, x4, y4, cur_ref, forced0=False):
        usable = [i for i, r in enumerate(self.refs_list) if r is not None]
        ref = 0 if forced0 else usable[self.ri(0, len(usable) - 1)]
        if self.o.bad_ref_idx and not forced0:
            ref = self.num_ref - 1  # an empty entry
        if not forced0 and self.num_ref > 1:
            self.put_ref_idx(w, ref, mbx, mby, x4, y4, cur_ref)
            if ref > 0:
                self.count("ref_idx_nonzero")
        return ref

    def choose_mv(self, mbx, mby, px, py, w, h, pred):
        o = self.o
        if o.far_mv and self.chance(0.08):
            W, H = self.mbw * 16, self.mbh * 16
            side = self.ri(0, 3)
            x0, y0 = mbx * 16 + px, mby * 16 + py
            tx = 0
            if side == 0:
                tx = -w - self.ri(17, 60)
            elif side == 1:
                tx = W + self.ri(17, 60)
            ty = self.ri(-8, H)
            if side == 2:
                ty, tx = -h - self.ri(17, 60), self.ri(-8, W)
            elif side == 3:
                ty, tx = H + self.ri(17, 60), self.ri(-8, W)
            return ((tx - x0) * 4 + self.ri(0, 3), (ty - y0) * 4 + self.ri(0, 3))
        mv = (pred[0] + self.ri(-20, 20), pred[1] + self.ri(-20, 20))
        return (max(-1200, min(1200, mv[0])), max(-1200, min(1200, mv[1])))

    def inter_mb(self, w, m, mbx, mby):
        kind = self.ri(0, 3 if self.cabac else 4)
        m.kind = "P"
        m.shape = min(kind, 3)
        self.count(("P_L0_16x16", "P_L0_L0_16x8", "P_L0_L0_8x16", "P_8x8", "P_8x8ref0")[kind])
        self.put_mb_type_p(w, kind)
        mask, cur_ref, parts = 0, [0] * 16, []
        if kind < 3:
            refs = []
            for p in range(1 if kind == 0 else 2):
                x4, y4 = (2 * p if kind == 2 else 0), (2 * p if kind == 1 else 0)
                w4, h4 = (2 if kind == 2 else 4), (2 if kind == 1 else 4)
                refs.append(self.ref_idx(w, mbx, mby, x4, y4, cur_ref))
                for y in range(y4, y4 + h4):
                    cur_ref[y * 4 + x4:y * 4 + x4 + w4] = [refs[-1]] * w4
                parts.append((x4, y4, w4, h4, refs[-1]))
            all_8x8 = True
        else:
            subs = [self.ri(0, 3) for _ in range(4)]
            for t in subs:
                self.put_sub_mb_type(w, t)
                self.count(("sub_8x8", "sub_8x4", "sub_4x8", "sub_4x4")[t])
            refs = []
            for s in range(4):
                sx, sy = (s & 1) * 2, (s >> 1) * 2
                refs.append(self.ref_idx(w, mbx, mby, sx, sy, cur_ref, forced0=kind == 4))
                for y in (sy, sy + 1):
                    cur_ref[y * 4 + sx:y * 4 + sx + 2] = [refs[-1]] * 2
            for s in range(4):
                sx, sy = (s & 1) * 2, (s >> 1) * 2
                n = 1 if subs[s] == 0 else 4 if subs[s] == 3 else 2
                w4 = 2 if subs[s] in (0, 1) else 1
                h4 = 2 if subs[s] in (0, 2) else 1
                for k in range(n):
                    x4 = sx + ((k & 1) if w4 == 1 else 0)
                    y4 = sy + (((k >> 1) if subs[s] == 3 else k) if h4 == 1 else 0)
                    parts.append((x4, y4, w4, h4, refs[s]))
            all_8x8 = not any(subs)
        mvds = []
        for x4, y4, w4, h4, ref in parts:
            pred = self.predict_mv(mbx, mby, x4, y4, w4, ref, mask, kind if kind < 3 else 0)
            mv = self.choose_mv(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, pred)
            mvds.append((mv[0] - pred[0], mv[1] - pred[1]))
            mask |= self.set_motion(mbx, mby, x4, y4, w4, h4, ref, mv)
            self.far(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, mv)
        for (x4, y4, w4, h4, _), d in zip(parts, mvds):
            self.put_mvd(w, d, mbx, mby, x4, y4)
            self.set_mvd(mbx, mby, x4, y4, w4, h4, d)
        cbp = self.ri(0, 47)
        self.put_cbp(w, m, mbx, mby, cbp, False)
        if cbp & 15 and self.pps.transform_8x8 and all_8x8:
            self.put_transform_flag(w, m, mbx, mby, self.chance(0.5))
            if m.t8:
                self.count("transform_8x8_inter")
        self.residual(w, m, mbx, mby, cbp & 15, cbp >> 4, False)

    # ---- B macroblocks
    def b_skip(self, m, mbx, mby):
        refs, mvs, m.shape, _ = self.direct_motion(mbx, mby, False)
        self.set_direct(mbx, mby, refs, mvs, range(16))
        self.count("B_Skip")

    def b_ref(self, w, lst, mbx, mby, x4, y4, cur_ref):
        """A random reference index of list ``lst`` for the partition at (x4, y4), written where the list has more
        than one entry."""
        n = self.num_refs[lst]
        ref = self.ri(0, n - 1)
        if n > 1:
            self.put_ref_idx(w, ref, mbx, mby, x4, y4, cur_ref, lst, n, True)
            if ref > 0:
                self.count("ref_idx_nonzero")
        return ref

    def b_mb(self, w, m, mbx, mby):
        """A B macroblock other than B_Skip: B_Direct_16x16, one 16x16 or two 16x8 / 8x16 partitions, or B_8x8 with
        any sub_mb_type."""
        o = self.o
        shares = np.array(o.b_mb_shares[2:], np.float64)
        kind = int(self.rng.choice(4, p=shares / shares.sum()))
        m.kind = "P"
        cur_ref = [[-1] * 16, [-1] * 16]
        all_8x8 = True
        if kind == 0:
            self.put_mb_type_b(w, mbx, mby, 0)
            m.direct16 = True
            refs, mvs, m.shape, _ = self.direct_motion(mbx, mby, False)
            self.set_direct(mbx, mby, refs, mvs, range(16))
            self.count("B_Direct_16x16")
            all_8x8 = self.d8
        elif kind in (1, 2):
            t = self.ri(1, 3) if kind == 1 else self.ri(4, 21)
            self.put_mb_type_b(w, mbx, mby, t)
            shape = 0 if t < 4 else 2 if t & 1 else 1
            m.shape = shape
            self.count("B_16x16" if t < 4 else "B_16x8" if shape == 1 else "B_8x16")
            parts = [(0, 0, 4, 4)] if t < 4 else [(0, 2 * p, 4, 2) if shape == 1 else (2 * p, 0, 2, 4) for p in (0, 1)]
            preds = B_PRED[t]
            refs = [[-1] * len(parts), [-1] * len(parts)]
            for lst in range(2):
                for p, (x4, y4, w4, h4) in enumerate(parts):
                    if preds[p] >> lst & 1:
                        refs[lst][p] = self.b_ref(w, lst, mbx, mby, x4, y4, cur_ref[lst])
                        for y in range(y4, y4 + h4):
                            cur_ref[lst][y * 4 + x4:y * 4 + x4 + w4] = [refs[lst][p]] * w4
            for lst in range(2):
                mask = 0
                for p, (x4, y4, w4, h4) in enumerate(parts):
                    if refs[lst][p] < 0:
                        mask |= self.set_motion(mbx, mby, x4, y4, w4, h4, -1, (0, 0), lst)
                        continue
                    pred = self.predict_mv(mbx, mby, x4, y4, w4, refs[lst][p], mask, shape, lst)
                    mv = self.choose_mv(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, pred)
                    d = (mv[0] - pred[0], mv[1] - pred[1])
                    self.put_mvd(w, d, mbx, mby, x4, y4, lst)
                    self.set_mvd(mbx, mby, x4, y4, w4, h4, d, lst)
                    mask |= self.set_motion(mbx, mby, x4, y4, w4, h4, refs[lst][p], mv, lst)
            self.count("bi_partitions", sum(pr == 3 for pr in preds[:len(parts)]))
        else:
            self.put_mb_type_b(w, mbx, mby, 22)
            m.shape = 3
            self.count("B_8x8")
            subs = [self.ri(0, 12) for _ in range(4)]
            for t in subs:
                self.put_sub_mb_type_b(w, t)
                self.count("b_sub_direct" if t == 0 else ("b_sub_8x8", "b_sub_8x4", "b_sub_4x8",
                                                          "b_sub_4x4")[B_SUB_SHAPE[t]])
            all_8x8 = all(self.d8 if t == 0 else B_SUB_SHAPE[t] == 0 for t in subs)
            blocks = [[((s >> 1) * 2 + (k >> 1)) * 4 + (s & 1) * 2 + (k & 1) for k in range(4)] for s in range(4)]
            if any(t == 0 for t in subs):
                drefs, dmvs, _, _ = self.direct_motion(mbx, mby, True)
                for s in range(4):
                    if subs[s] == 0:
                        for k in blocks[s]:
                            self.direct[(mby * 4 + (k >> 2)) * self.mbw * 4 + mbx * 4 + (k & 3)] = True
            refs = [[-1] * 4, [-1] * 4]
            for lst in range(2):
                for s, t in enumerate(subs):
                    if t and B_SUB_PRED[t] >> lst & 1:
                        refs[lst][s] = self.b_ref(w, lst, mbx, mby, (s & 1) * 2, (s >> 1) * 2, cur_ref[lst])
                        for k in blocks[s]:
                            cur_ref[lst][k] = refs[lst][s]
            for lst in range(2):
                mask = 0
                for s, t in enumerate(subs):
                    sx, sy = (s & 1) * 2, (s >> 1) * 2
                    if t == 0:
                        for k in blocks[s]:
                            mask |= self.set_motion(mbx, mby, k & 3, k >> 2, 1, 1, drefs[lst][k], dmvs[lst][k], lst)
                        continue
                    if refs[lst][s] < 0:
                        mask |= self.set_motion(mbx, mby, sx, sy, 2, 2, -1, (0, 0), lst)
                        continue
                    sub_shape = B_SUB_SHAPE[t]
                    w4, h4 = (2 if sub_shape in (0, 1) else 1), (2 if sub_shape in (0, 2) else 1)
                    for k in range(1 if sub_shape == 0 else 4 if sub_shape == 3 else 2):
                        x4 = sx + ((k & 1) if w4 == 1 else 0)
                        y4 = sy + (((k >> 1) if sub_shape == 3 else k) if h4 == 1 else 0)
                        pred = self.predict_mv(mbx, mby, x4, y4, w4, refs[lst][s], mask, 0, lst)
                        mv = self.choose_mv(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, pred)
                        d = (mv[0] - pred[0], mv[1] - pred[1])
                        self.put_mvd(w, d, mbx, mby, x4, y4, lst)
                        self.set_mvd(mbx, mby, x4, y4, w4, h4, d, lst)
                        mask |= self.set_motion(mbx, mby, x4, y4, w4, h4, refs[lst][s], mv, lst)
            self.count("bi_partitions", sum((1 if B_SUB_SHAPE[t] == 0 else 4 if B_SUB_SHAPE[t] == 3 else 2)
                                            for t in subs if t and B_SUB_PRED[t] == 3))
        cbp = self.ri(0, 47)
        self.put_cbp(w, m, mbx, mby, cbp, False)
        if cbp & 15 and self.pps.transform_8x8 and all_8x8:
            self.put_transform_flag(w, m, mbx, mby, self.chance(0.5))
            if m.t8:
                self.count("transform_8x8_inter")
        self.residual(w, m, mbx, mby, cbp & 15, cbp >> 4, False)

    def qp_delta(self, w):
        delta = 0
        if self.chance(0.3):
            delta = self.ri(-26, 25)
        q = self.qp + delta
        lo, hi = self.o.qp_range
        if not lo <= q <= hi and (lo, hi) != (0, 51):
            delta, q = 0, self.qp
        if q < 0 or q > 51:
            q = (q + 52) % 52
            self.count("qp_wraps")
        self.put_qp_delta(w, delta)
        self.qp = q

    def random_levels(self, n, dc_heavy=False):
        """Up to ``n`` levels in scan order: mostly small, a few level escapes."""
        levels = [0] * n
        counts = [0, 1, 1, 2, 3, 4, 6, 9, 16] + ([24, 40, 64] if n == 64 else [])
        count = min(n, int(self.rng.choice(counts)))
        for pos in sorted(self.rng.choice(n, size=count, replace=False)):
            mag = 1 if self.chance(0.5) else self.ri(2, 6)
            if self.o.escapes and self.chance(0.08):
                mag = self.ri(8, 2000)
            levels[int(pos)] = mag * (1 if self.chance(0.5) else -1)
        return levels

    def residual(self, w, m, mbx, mby, cbp_luma, cbp_chroma, i16):
        if cbp_luma or cbp_chroma or i16:
            self.qp_delta(w)
        else:
            self.prev_dqp = 0
        qp = self.qp
        l4, l8 = self.lists
        wy = l4[0 if m.intra else 3]
        dcy = np.zeros((4, 4), np.int64)
        if i16:
            dc = self.random_levels(16)
            while True:
                dcy = luma_dc_values(dc, qp, wy[0][0])
                if np.abs(dcy).max() <= COEFF_BOUND // 4 and sum(abs(v) for v in dc) < 4000:
                    break
                k = max(range(16), key=lambda i: abs(dc[i]))
                dc[k] = int(np.sign(dc[k])) * (abs(dc[k]) // 2)
            if self.block(w, m, 0, dc, mbx, mby, 0, 0, 0, 16):
                m.dc |= 1
        for b8 in range(4):
            x8, y8 = (b8 & 1) * 2, (b8 >> 1) * 2
            if not (cbp_luma >> b8) & 1:
                for b4 in range(4):
                    m.nz[(y8 + (b4 >> 1)) * 4 + x8 + (b4 & 1)] = 0
                continue
            if m.t8:
                weights = l8[0 if m.intra else 1]
                levels = fit_levels8(self.random_levels(64), qp, weights)
                if not self.cabac and self.o.empty_8x8_share and self.chance(self.o.empty_8x8_share):
                    levels = [0] * 64
                if self.cabac and not any(levels):  # an 8x8 block has no coded_block_flag: it holds a level
                    k = int(self.rng.integers(64))
                    levels[k] = 1
                    assert np.abs(dequantised8(levels, qp, weights)).sum() <= COEFF_BOUND8
                if self.cabac:
                    n = self.block(w, m, 5, levels, mbx, mby, 0, x8, y8, 64)
                    for b4 in range(4):
                        m.nz[(y8 + (b4 >> 1)) * 4 + x8 + (b4 & 1)] = n
                else:  # four interleaved 4x4 blocks (7.3.5.3.2)
                    for b4 in range(4):
                        x4, y4 = x8 + (b4 & 1), y8 + (b4 >> 1)
                        m.nz[y4 * 4 + x4] = self.block(w, m, 2, levels[b4::4], mbx, mby, 0, x4, y4, 16)
                continue
            for b4 in range(4):
                x4, y4 = x8 + (b4 & 1), y8 + (b4 >> 1)
                n = 15 if i16 else 16
                levels = fit_levels(self.random_levels(n), qp, 1 if i16 else 0, dcy[y4, x4], weights=wy)
                m.nz[y4 * 4 + x4] = self.block(w, m, 1 if i16 else 2, levels, mbx, mby, 0, x4, y4, n)
        offsets = (self.pps.chroma_qp_offset, self.pps.cr_qp_offset)
        qpc = [chroma_qp(qp, off) for off in offsets]
        wc = [l4[(1 if m.intra else 4) + comp] for comp in range(2)]
        dcc = [np.zeros((2, 2), np.int64)] * 2
        if cbp_chroma:
            for comp in range(2):
                lv = self.random_levels(4)
                while True:
                    dcc[comp] = chroma_dc_values(lv, qpc[comp], wc[comp][0][0])
                    if np.abs(dcc[comp]).max() <= COEFF_BOUND // 4:
                        break
                    k = max(range(4), key=lambda i: abs(lv[i]))
                    lv[k] = int(np.sign(lv[k])) * (abs(lv[k]) // 2)
                if self.block(w, m, 3, lv, mbx, mby, comp + 1, 0, 0, 4):
                    m.dc |= 2 << comp
        for comp in range(2):
            for b in range(4):
                x4, y4 = b & 1, b >> 1
                if not cbp_chroma & 2:
                    m.nz[16 + comp * 4 + b] = 0
                    continue
                levels = fit_levels(self.random_levels(15), qpc[comp], 1, dcc[comp][y4, x4], weights=wc[comp])
                m.nz[16 + comp * 4 + b] = self.block(w, m, 4, levels, mbx, mby, comp + 1, x4, y4, 15)
def display_order(writer, count):
    """Each access unit's place in display order (FFmpeg's output order) of a stream ``writer`` wrote."""
    rank = {uid: k for k, uid in enumerate(writer.output.order)}
    return [rank[i + 1] for i in range(count)]


def random_stream(seed, **options):
    """(access units, the writer's counts, (coded width, coded height), (width, height) after the crop, the writer)
    of a random stream."""
    rng = np.random.default_rng(seed)
    opts = Options(**options)
    writer = StreamWriter(rng, opts)
    aus = [writer.picture() for _ in range(opts.frames)]
    writer.output.flush()
    writer.stats["reordered_pictures"] = writer.output.reordered
    cw, ch = 16 * opts.mb_width, 16 * opts.mb_height
    l, r, t, b = opts.crop
    return aus, writer.stats, (cw, ch), (cw - 2 * (l + r), ch - 2 * (t + b)), writer


# ---------------------------------------------------------------------------------------------
# An encoder of real pictures (the checked-in fixture)

# Forward quantisation: the multiplication factors of the 4x4 core transform by qP % 6 and position class.
_MF = [(13107, 5243, 8066), (11916, 4660, 7490), (10082, 4194, 6554), (9362, 3647, 5825), (8192, 3355, 5243),
       (7282, 2893, 4559)]
_CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], np.int64)
_CLASS = np.array([[0 if r % 2 == 0 and c % 2 == 0 else 1 if r % 2 and c % 2 else 2 for c in range(4)]
                   for r in range(4)])
_SCAN = np.array([r * 4 + c for r, c in ZIGZAG])


def _forward(x):
    """The forward core transform of 4x4 blocks x[..., 4, 4]."""
    return _CF @ x @ _CF.T


def _quantise(w, qp, intra, dc_shift=0):
    mf = _MF[qp % 6][0] if dc_shift else np.array(_MF[qp % 6])[_CLASS]
    qbits = 15 + qp // 6 + dc_shift
    f = (1 << qbits) // (3 if intra else 6)
    return np.sign(w) * ((np.abs(w) * mf + f) >> qbits)


def _dequantise(z, qp):
    """d = (c * LevelScale4x4) << (qP / 6) >> 4 at flat scaling (8.5.12.1), raster order."""
    v = np.array(NORM_ADJUST[qp % 6])[_CLASS]
    return (z * v) << (qp // 6)


def _inverse(d):
    """The 4x4 inverse transform (8.5.12.2) of d[..., 4, 4], rows then columns, with its rounding."""
    def one(x, axis):
        x0, x1, x2, x3 = (np.take(x, i, axis=axis) for i in range(4))
        e0, e1, e2, e3 = x0 + x2, x0 - x2, (x1 >> 1) - x3, x1 + (x3 >> 1)
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=axis)

    return (one(one(d, -1), -2) + 32) >> 6


def _blocks(a):
    """A (4n, 4m) array as (n, m, 4, 4) blocks."""
    n, m = a.shape[0] // 4, a.shape[1] // 4
    return a.reshape(n, 4, m, 4).transpose(0, 2, 1, 3)


def _unblocks(b):
    n, m = b.shape[:2]
    return b.transpose(0, 2, 1, 3).reshape(4 * n, 4 * m)


def _tap(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def quarter_planes(plane, pad):
    """The 16 quarter-sample planes of a luma plane (8.4.2.2.1), padded by ``pad`` samples on each side with the
    picture's edge (the clamped reference): planes[fy][fx][y, x] is the sample at (x - pad + fx / 4,
    y - pad + fy / 4)."""
    g = np.pad(plane.astype(np.int64), pad + 3, mode="edge")
    h, w = g.shape

    def sh(a, dy, dx):  # a shifted so that [y, x] reads a[y + dy, x + dx]
        return a[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx]

    b1 = _tap(*(sh(g, 0, k) for k in range(-2, 4)))
    h1 = _tap(*(sh(g, k, 0) for k in range(-2, 4)))
    b1p = np.pad(b1, 3, mode="edge")
    j1 = _tap(*(b1p[3 + k:b1p.shape[0] - 3 + k, 3:b1p.shape[1] - 3] for k in range(-2, 4)))
    G = sh(g, 0, 0)
    b = np.clip((b1 + 16) >> 5, 0, 255)
    hh = np.clip((h1 + 16) >> 5, 0, 255)
    j = np.clip((j1 + 512) >> 10, 0, 255)

    def nx(a):  # a at x + 1
        return np.pad(a[:, 1:], ((0, 0), (0, 1)), mode="edge")

    def ny(a):  # a at y + 1
        return np.pad(a[1:], ((0, 1), (0, 0)), mode="edge")

    avg = lambda a, c: (a + c + 1) >> 1  # noqa: E731
    planes = [[G, avg(G, b), b, avg(b, nx(G))],
              [avg(G, hh), avg(b, hh), avg(b, j), avg(b, nx(hh))],
              [hh, avg(hh, j), j, avg(j, nx(hh))],
              [avg(hh, ny(G)), avg(hh, ny(b)), avg(j, ny(b)), avg(nx(hh), ny(b))]]
    return [[p.astype(np.uint8) for p in row] for row in planes]


class FrameEncoder:
    """IDR then P pictures of real frames: intra 16x16 macroblocks (with DC chroma) in the IDR, P_L0_16x16 and
    P_Skip in the P pictures with a full-sample search then a quarter-sample refinement, one reference, one
    slice a picture, a fixed QP, the deblocking filter off. Its reconstruction is the decoder's."""

    PAD = 48

    def __init__(self, width, height, qp=22, search=6):
        self.w, self.h = width, height
        self.cw, self.ch = (width + 15) // 16 * 16, (height + 15) // 16 * 16
        self.mbw, self.mbh = self.cw // 16, self.ch // 16
        self.qp, self.search = qp, search
        self.sps = Sps(self.mbw, self.mbh, profile_idc=66, level_idc=31, poc_type=2, max_num_ref_frames=1,
                       crop=(0, (self.cw - width) // 2, 0, (self.ch - height) // 2))
        self.pps = Pps(pic_init_qp=qp, deblocking_control=True)
        self.ref = None
        self.frame_num = 0
        self.stats = Counter()

    def encode(self, yuv):
        """The access unit of one frame (Y, U, V planes at the frame's size), its reconstruction kept."""
        y, u, v = (np.pad(p, ((0, ch - p.shape[0]), (0, cw - p.shape[1])), mode="edge").astype(np.int64)
                   for p, cw, ch in ((yuv[0], self.cw, self.ch), (yuv[1], self.cw // 2, self.ch // 2),
                                     (yuv[2], self.cw // 2, self.ch // 2)))
        idr = self.ref is None
        w = BitWriter()
        w.ue(0)  # first_mb_in_slice
        w.ue(7 if idr else 5)  # I or P, all slices of the picture alike
        w.ue(0)
        w.u(self.sps.log2_max_frame_num, self.frame_num)
        if idr:
            w.ue(0)  # idr_pic_id
        else:
            w.u(1, 0)  # num_ref_idx_active_override_flag
            w.u(1, 0)  # ref_pic_list_modification_flag_l0
        w.u(1, 0)  # no_output_of_prior_pics / adaptive_ref_pic_marking_mode
        if idr:
            w.u(1, 0)  # long_term_reference_flag
        w.se(0)  # slice_qp_delta
        w.ue(1)  # disable_deblocking_filter_idc
        self.recon = [np.zeros((self.ch, self.cw), np.int64), np.zeros((self.ch // 2, self.cw // 2), np.int64),
                      np.zeros((self.ch // 2, self.cw // 2), np.int64)]
        self.nz = np.zeros((self.mbh, self.mbw, 24), np.int64)
        self.mvs = np.zeros((self.mbh, self.mbw, 2), np.int64)
        if idr:
            for mby in range(self.mbh):
                for mbx in range(self.mbw):
                    self.intra_mb(w, mbx, mby, y, u, v)
        else:
            self.inter_picture(w, y, u, v)
        w.trailing()
        au = ([nal_unit(3, 7, self.sps.rbsp()), nal_unit(3, 8, self.pps.rbsp())] if idr else [])
        au.append(nal_unit(3, 5 if idr else 1, w.data()))
        self.ref = [r.astype(np.uint8) for r in self.recon]
        self.frame_num = (self.frame_num + 1) % (1 << self.sps.log2_max_frame_num)
        return au

    # ---- residual coding shared by both picture kinds
    def nc(self, mbx, mby, comp, x4, y4):
        size = 4 if comp == 0 else 2
        base = 0 if comp == 0 else 16 + (comp - 1) * 4

        def at(mx, my, x, y):
            if mx < 0 or my < 0:
                return None
            return int(self.nz[my, mx, base + y * size + x])

        a = at(mbx, mby, x4 - 1, y4) if x4 > 0 else at(mbx - 1, mby, size - 1, y4)
        b = at(mbx, mby, x4, y4 - 1) if y4 > 0 else at(mbx, mby - 1, x4, size - 1)
        if a is not None and b is not None:
            return (a + b + 1) >> 1
        return a if a is not None else b if b is not None else 0

    def chroma_residual(self, mbx, mby, pred_u, pred_v, u, v, intra):
        """(quantised DC levels, quantised AC blocks, reconstruction) of both chroma planes of a macroblock."""
        qpc = chroma_qp(self.qp, self.pps.chroma_qp_offset)
        out = []
        for pred, src in ((pred_u, u), (pred_v, v)):
            x0, y0 = mbx * 8, mby * 8
            wt = _forward(_blocks(src[y0:y0 + 8, x0:x0 + 8] - pred))
            dc = wt[:, :, 0, 0]
            h2 = np.array([[1, 1], [1, -1]])
            zdc = _quantise(h2 @ dc @ h2, qpc, intra, 1)
            zac = _quantise(wt, qpc, intra)
            zac[:, :, 0, 0] = 0
            d = _dequantise(zac, qpc)
            d[:, :, 0, 0] = chroma_dc_values(zdc.reshape(-1).tolist(), qpc)
            rec = np.clip(pred + _unblocks(_inverse(d)), 0, 255)
            out.append((zdc, zac, rec))
        return out

    def write_chroma(self, w, mbx, mby, chroma, cbp_chroma):
        if cbp_chroma:
            for zdc, _, _ in chroma:
                write_block(w, zdc.reshape(-1).tolist(), -1, 4)
        for comp, (_, zac, _) in enumerate(chroma):
            for b in range(4):
                if cbp_chroma == 2:
                    levels = zac[b >> 1, b & 1].reshape(-1)[_SCAN][1:].tolist()
                    total, _ = write_block(w, levels, self.nc(mbx, mby, comp + 1, b & 1, b >> 1), 15)
                    self.nz[mby, mbx, 16 + comp * 4 + b] = total

    @staticmethod
    def chroma_cbp(chroma):
        if any(np.any(zac) for _, zac, _ in chroma):
            return 2
        return 1 if any(np.any(zdc) for zdc, _, _ in chroma) else 0

    # ---- intra 16x16 (the IDR)
    def intra16_pred(self, rl, mbx, mby):
        """{mode: prediction} of the intra 16x16 modes (8.3.3) the neighbours in ``rl`` allow."""
        x0, y0 = mbx * 16, mby * 16
        top = rl[y0 - 1, x0:x0 + 16] if mby else None
        left = rl[y0:y0 + 16, x0 - 1] if mbx else None
        preds = {2: np.full((16, 16), 128 if top is None and left is None else
                            ((top.sum() + left.sum() + 16) >> 5) if top is not None and left is not None else
                            ((left.sum() + 8) >> 4) if left is not None else ((top.sum() + 8) >> 4), np.int64)}
        if top is not None:
            preds[0] = np.tile(top, (16, 1))
        if left is not None:
            preds[1] = np.tile(left[:, None], (1, 16))
        if top is not None and left is not None:
            corner = rl[y0 - 1, x0 - 1]
            t = np.concatenate([[corner], top])
            lft = np.concatenate([[corner], left])
            hh = sum((i + 1) * (t[9 + i] - t[7 - i]) for i in range(8))
            vv = sum((i + 1) * (lft[9 + i] - lft[7 - i]) for i in range(8))
            a, b, c = 16 * (left[15] + top[15]), (5 * hh + 32) >> 6, (5 * vv + 32) >> 6
            yy, xx = np.mgrid[:16, :16]
            preds[3] = np.clip((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5, 0, 255)
        return preds

    def intra16(self, y, mbx, mby):
        """(mode, DC levels, AC levels, reconstruction) of the intra 16x16 macroblock at (mbx, mby), its mode the
        allowed one of least SAD."""
        x0, y0 = mbx * 16, mby * 16
        preds = self.intra16_pred(self.recon[0], mbx, mby)
        src = y[y0:y0 + 16, x0:x0 + 16]
        mode = min(preds, key=lambda k: (np.abs(src - preds[k]).sum(), k))
        wt = _forward(_blocks(src - preds[mode]))
        h4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
        zdc = _quantise((h4 @ wt[:, :, 0, 0] @ h4) // 2, self.qp, True, 1)
        zac = _quantise(wt, self.qp, True)
        zac[:, :, 0, 0] = 0
        d = _dequantise(zac, self.qp)
        d[:, :, 0, 0] = luma_dc_values(zdc.reshape(-1)[_SCAN].tolist(), self.qp)
        return mode, zdc, zac, np.clip(preds[mode] + _unblocks(_inverse(d)), 0, 255)

    @staticmethod
    def chroma_dc_pred(plane, mbx, mby):
        """Intra chroma DC prediction (8.3.4.1-3) of each 4x4 block of a macroblock's 8x8 chroma block."""
        cx, cy = mbx * 8, mby * 8
        ct = plane[cy - 1, cx:cx + 8] if mby else None
        cl = plane[cy:cy + 8, cx - 1] if mbx else None
        p = np.zeros((8, 8), np.int64)
        for by in range(2):
            for bx in range(2):
                st = ct[bx * 4:bx * 4 + 4].sum() if ct is not None else None
                sl = cl[by * 4:by * 4 + 4].sum() if cl is not None else None
                if bx == by:
                    val = ((st + sl + 4) >> 3 if st is not None and sl is not None else
                           (sl + 2) >> 2 if sl is not None else (st + 2) >> 2 if st is not None else 128)
                elif bx == 1:
                    val = (st + 2) >> 2 if st is not None else (sl + 2) >> 2 if sl is not None else 128
                else:
                    val = (sl + 2) >> 2 if sl is not None else (st + 2) >> 2 if st is not None else 128
                p[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = val
        return p

    def intra_mb(self, w, mbx, mby, y, u, v):
        x0, y0 = mbx * 16, mby * 16
        rc = self.recon[1:]
        mode, zdc, zac, rec = self.intra16(y, mbx, mby)
        cbp_luma = 15 if np.any(zac) else 0
        self.recon[0][y0:y0 + 16, x0:x0 + 16] = rec
        chroma = self.chroma_residual(mbx, mby, *[self.chroma_dc_pred(p, mbx, mby) for p in rc], u, v, True)
        cbp_chroma = self.chroma_cbp(chroma)
        for plane, (_, _, rec) in zip(rc, chroma):
            plane[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = rec
        w.ue(1 + mode + 4 * cbp_chroma + (12 if cbp_luma else 0))
        w.ue(0)  # intra_chroma_pred_mode: DC
        w.se(0)  # mb_qp_delta
        write_block(w, zdc.reshape(-1)[_SCAN].tolist(), self.nc(mbx, mby, 0, 0, 0), 16)
        for b8 in range(4):
            for b4 in range(4):
                x4, y4 = (b8 & 1) * 2 + (b4 & 1), (b8 >> 1) * 2 + (b4 >> 1)
                if cbp_luma:
                    levels = zac[y4, x4].reshape(-1)[_SCAN][1:].tolist()
                    total, _ = write_block(w, levels, self.nc(mbx, mby, 0, x4, y4), 15)
                    self.nz[mby, mbx, y4 * 4 + x4] = total
        self.write_chroma(w, mbx, mby, chroma, cbp_chroma)
        self.stats["I_16x16"] += 1

    # ---- P pictures
    def mv_pred(self, mbx, mby):
        """The 16x16 vector prediction (8.4.1.3) with every neighbour inter and on reference 0."""
        def n(x, yy):
            if 0 <= x < self.mbw and 0 <= yy and (yy < mby or (yy == mby and x < mbx)):
                return True, tuple(int(c) for c in self.mvs[yy, x])
            return False, (0, 0)

        a, b, c = n(mbx - 1, mby), n(mbx, mby - 1), n(mbx + 1, mby - 1)
        if not c[0]:
            c = n(mbx - 1, mby - 1)
        if not b[0] and not c[0] and a[0]:
            b = c = a
        avail = [x for x in (a, b, c) if x[0]]
        if len(avail) == 1:
            return avail[0][1]
        return (sorted([a[1][0], b[1][0], c[1][0]])[1], sorted([a[1][1], b[1][1], c[1][1]])[1])

    def skip_mv(self, mbx, mby):
        if mbx == 0 or mby == 0:
            return (0, 0)
        if tuple(self.mvs[mby, mbx - 1]) == (0, 0) or tuple(self.mvs[mby - 1, mbx]) == (0, 0):
            return (0, 0)
        return self.mv_pred(mbx, mby)

    def inter_picture(self, w, y, u, v):
        pad, r = self.PAD, self.search
        planes = quarter_planes(self.ref[0], pad)
        ref_c = [np.pad(c.astype(np.int64), pad // 2 + 1, mode="edge") for c in self.ref[1:]]
        full = planes[0][0].astype(np.int64)
        # Full-sample search: the SAD of every macroblock at each displacement.
        mbs = y.reshape(self.mbh, 16, self.mbw, 16)
        best = np.full((self.mbh, self.mbw), np.iinfo(np.int64).max)
        best_mv = np.zeros((self.mbh, self.mbw, 2), np.int64)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                shifted = full[pad + dy:pad + dy + self.ch, pad + dx:pad + dx + self.cw]
                sad = np.abs(shifted.reshape(self.mbh, 16, self.mbw, 16) - mbs).sum(axis=(1, 3))
                better = sad < best
                best = np.where(better, sad, best)
                best_mv[better] = (4 * dx, 4 * dy)
        run = 0
        for mby in range(self.mbh):
            for mbx in range(self.mbw):
                x0, y0 = mbx * 16, mby * 16
                src = y[y0:y0 + 16, x0:x0 + 16]
                skip = self.skip_mv(mbx, mby)
                mv = self.refine(planes, src, x0, y0, 16, 16, best_mv[mby, mbx], (skip,))[1]
                pred = self.luma_pred(planes, x0, y0, 16, 16, mv)
                cpred = [self.chroma_pred(rc, mbx * 8, mby * 8, 8, 8, mv) for rc in ref_c]
                wt = _forward(_blocks(src - pred))
                z = _quantise(wt, self.qp, False)
                chroma = self.chroma_residual(mbx, mby, cpred[0], cpred[1], u, v, False)
                cbp_chroma = self.chroma_cbp(chroma)
                cbp_luma = sum(1 << b8 for b8 in range(4)
                               if np.any(z[(b8 >> 1) * 2:(b8 >> 1) * 2 + 2, (b8 & 1) * 2:(b8 & 1) * 2 + 2]))
                if mv == skip and not cbp_luma and not cbp_chroma:
                    self.recon[0][y0:y0 + 16, x0:x0 + 16] = pred
                    for plane, p in zip(self.recon[1:], cpred):
                        plane[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = p
                    self.mvs[mby, mbx] = mv
                    run += 1
                    self.stats["P_Skip"] += 1
                    continue
                w.ue(run)
                run = 0
                pmv = self.mv_pred(mbx, mby)
                self.mvs[mby, mbx] = mv
                w.ue(0)  # P_L0_16x16
                w.se(mv[0] - pmv[0])
                w.se(mv[1] - pmv[1])
                cbp = cbp_luma | (cbp_chroma << 4)
                w.ue(CBP_CODE_INTER[cbp])
                d = _dequantise(z, self.qp)
                for b8 in range(4):
                    if not (cbp_luma >> b8) & 1:
                        ys, xs = (b8 >> 1) * 2, (b8 & 1) * 2
                        d[ys:ys + 2, xs:xs + 2] = 0
                self.recon[0][y0:y0 + 16, x0:x0 + 16] = np.clip(pred + _unblocks(_inverse(d)), 0, 255)
                if not cbp_chroma:
                    chroma = [(np.zeros_like(zdc), np.zeros_like(zac), p) for (zdc, zac, _), p in zip(chroma, cpred)]
                elif cbp_chroma == 1:
                    chroma = self.chroma_residual_dc_only(mbx, mby, cpred, chroma)
                for plane, (_, _, rec) in zip(self.recon[1:], chroma):
                    plane[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = rec
                if cbp:
                    w.se(0)  # mb_qp_delta
                    for b8 in range(4):
                        for b4 in range(4):
                            x4, y4 = (b8 & 1) * 2 + (b4 & 1), (b8 >> 1) * 2 + (b4 >> 1)
                            if (cbp_luma >> b8) & 1:
                                total, _ = write_block(w, z[y4, x4].reshape(-1)[_SCAN].tolist(),
                                                       self.nc(mbx, mby, 0, x4, y4), 16)
                                self.nz[mby, mbx, y4 * 4 + x4] = total
                    self.write_chroma(w, mbx, mby, chroma, cbp_chroma)
                self.stats["P_L0_16x16"] += 1
        if run:
            w.ue(run)

    def chroma_residual_dc_only(self, mbx, mby, cpred, chroma):
        """The chroma of a macroblock whose AC levels are all zero: its reconstruction from the DC alone."""
        qpc = chroma_qp(self.qp, self.pps.chroma_qp_offset)
        out = []
        for (zdc, zac, _), pred in zip(chroma, cpred):
            d = np.zeros((2, 2, 4, 4), np.int64)
            d[:, :, 0, 0] = chroma_dc_values(zdc.reshape(-1).tolist(), qpc)
            out.append((zdc, zac, np.clip(pred + _unblocks(_inverse(d)), 0, 255)))
        return out

    def luma_pred(self, planes, x, y, wd, ht, mv):
        """Quarter-sample luma prediction of a wd x ht block at (x, y) from ``quarter_planes`` padded by ``PAD``."""
        pad = self.PAD
        return planes[mv[1] & 3][mv[0] & 3][pad + y + (mv[1] >> 2):pad + y + (mv[1] >> 2) + ht,
                                            pad + x + (mv[0] >> 2):pad + x + (mv[0] >> 2) + wd].astype(np.int64)

    def chroma_pred(self, plane, x, y, wd, ht, mv):
        """Eighth-sample bilinear chroma prediction (8.4.2.2.2) of a wd x ht block at chroma sample (x, y), from an
        edge-padded chroma plane."""
        off = self.PAD // 2 + 1
        xi, yi = x + (mv[0] >> 3) + off, y + (mv[1] >> 3) + off
        fx, fy = mv[0] & 7, mv[1] & 7
        a, b = plane[yi:yi + ht, xi:xi + wd], plane[yi:yi + ht, xi + 1:xi + wd + 1]
        c, d = plane[yi + 1:yi + ht + 1, xi:xi + wd], plane[yi + 1:yi + ht + 1, xi + 1:xi + wd + 1]
        return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b + (8 - fx) * fy * c + fx * fy * d + 32) >> 6

    def refine(self, planes, src, x, y, wd, ht, center, extra=()):
        """(SAD, vector) of the best quarter-sample vector within 3 of ``center`` or among ``extra`` (which wins a
        tie)."""
        cands = [(int(center[0]) + dx, int(center[1]) + dy) for dy in range(-3, 4) for dx in range(-3, 4)]
        cands += list(extra)
        return min(((np.abs(src - self.luma_pred(planes, x, y, wd, ht, m)).sum(), m) for m in cands),
                   key=lambda t: (t[0], t[1] not in extra, t[1]))

    def planes(self):
        """The reconstruction of the last picture, cropped (Y, U, V)."""
        return (self.ref[0][:self.h, :self.w], self.ref[1][:self.h // 2, :self.w // 2],
                self.ref[2][:self.h // 2, :self.w // 2])


# The 8x8 core transform (8.5.13's inverse is its transpose, scaled): rows of the forward matrix, times 8.
_T8 = np.array([[8, 8, 8, 8, 8, 8, 8, 8], [12, 10, 6, 3, -3, -6, -10, -12], [8, 4, -4, -8, -8, -4, 4, 8],
                [10, -3, -12, -6, 6, 12, 3, -10], [8, -8, -8, 8, 8, -8, -8, 8], [6, -12, 3, 10, -10, -3, 12, -6],
                [4, -8, 8, -4, -4, 8, -8, 4], [3, -6, 10, -12, 12, -10, 6, -3]], np.int64)
_T8_NORM = np.linalg.inv((_T8 @ _T8.T).astype(np.float64))
_SCAN8 = np.array([r * 8 + c for r, c in ZIGZAG8])


def _inverse8(d):
    """The 8x8 inverse transform (8.5.13.2) of d[8, 8]: rows, then columns, with its rounding."""
    def one(x, axis):
        d0, d1, d2, d3, d4, d5, d6, d7 = (np.take(x, i, axis=axis) for i in range(8))
        e0, e1, e2, e3 = d0 + d4, -d3 + d5 - d7 - (d7 >> 1), d0 - d4, d1 + d7 - d3 - (d3 >> 1)
        e4, e5, e6, e7 = (d2 >> 1) - d6, -d1 + d7 + d5 + (d5 >> 1), d2 + (d6 >> 1), d3 + d5 + d1 + (d1 >> 1)
        f0, f1, f2, f3 = e0 + e6, e1 + (e7 >> 2), e2 + e4, e3 + (e5 >> 2)
        f4, f5, f6, f7 = e2 - e4, (e3 >> 2) - e5, e0 - e6, e7 - (e1 >> 2)
        return np.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=axis)

    return (one(one(d, -1), -2) + 32) >> 6


def _quantise8(x, qp, intra):
    """Levels (raster order) of a residual x[8, 8] under the 8x8 transform at flat scaling, by least squares."""
    coeff = 4096.0 * (_T8_NORM @ _T8 @ x @ _T8.T @ _T8_NORM)  # the scaled coefficients d the residual asks for
    step = np.array([[16 * level_scale8(qp, r, c) for c in range(8)] for r in range(8)]) * 2.0 ** (qp // 6) / 64
    return (np.sign(coeff) * np.floor(np.abs(coeff) / step + (1 / 3 if intra else 1 / 6))).astype(np.int64)


class HighEncoder(_Syntax, FrameEncoder):
    """High profile (``profile_idc`` 100) as x264 writes it without B frames: CABAC, the 8x8 transform chosen for
    each macroblock, an IDR of I_16x16 (all four modes) and I_NxN macroblocks (intra 8x8: vertical, horizontal and
    DC), then P
    pictures of P_L0_16x16, P_8x8 (four 8x8 partitions, each its own vector) and P_Skip, one reference and one
    slice a picture, a fixed QP, the deblocking filter on. The reference of each P picture is FFmpeg's decode of
    the stream so far, ``reference(access units)`` (the last picture's uncropped planes), so that the encoder needs
    no deblocking filter of its own; within the IDR its intra prediction reads its own reconstruction, which is
    the decoder's before the filter."""

    def __init__(self, width, height, reference, qp=22, search=6):
        super().__init__(width, height, qp, search)
        self.sps = Sps(self.mbw, self.mbh, profile_idc=100, level_idc=31, poc_type=2, max_num_ref_frames=1,
                       crop=(0, (self.cw - width) // 2, 0, (self.ch - height) // 2))
        self.pps = Pps(pic_init_qp=qp, deblocking_control=True, cabac=True, transform_8x8=True)
        self.reference, self.aus, self.ref_planes = reference, [], None
        self.ctx_used, self.slice_index, self.num_ref = set(), 0, 1
        self.lam = 0.85 * 2.0 ** ((qp - 12) / 3)  # SSD per bit

    def encode(self, yuv):
        y, u, v = (np.pad(p, ((0, ch - p.shape[0]), (0, cw - p.shape[1])), mode="edge").astype(np.int64)
                   for p, cw, ch in ((yuv[0], self.cw, self.ch), (yuv[1], self.cw // 2, self.ch // 2),
                                     (yuv[2], self.cw // 2, self.ch // 2)))
        idr = self.ref_planes is None
        w = BitWriter()
        w.ue(0)  # first_mb_in_slice
        w.ue(7 if idr else 5)
        w.ue(0)
        w.u(self.sps.log2_max_frame_num, self.frame_num)
        if idr:
            w.ue(0)  # idr_pic_id
        else:
            w.u(1, 0)  # num_ref_idx_active_override_flag
            w.u(1, 0)  # ref_pic_list_modification_flag_l0
        w.u(1, 0)  # no_output_of_prior_pics / adaptive_ref_pic_marking_mode
        if idr:
            w.u(1, 0)  # long_term_reference_flag
        else:
            w.ue(0)  # cabac_init_idc
        w.se(0)  # slice_qp_delta
        w.ue(0)  # disable_deblocking_filter_idc: on, offsets 0
        w.se(0)
        w.se(0)
        w.align_one()
        self.cabac = CabacWriter(w, self.qp, 0 if idr else 1, self.ctx_used)
        self.prev_dqp = 0
        nblocks = self.mbw * self.mbh * 16
        self.mbs, self.ref, self.mv, self.mvd = [None] * (self.mbw * self.mbh), [-1] * nblocks, [(0, 0)] * nblocks, \
            [(0, 0)] * nblocks
        self.recon = [np.zeros((self.ch, self.cw), np.int64), np.zeros((self.ch // 2, self.cw // 2), np.int64),
                      np.zeros((self.ch // 2, self.cw // 2), np.int64)]
        if idr:
            for addr in range(self.mbw * self.mbh):
                self.intra_mb8(w, addr % self.mbw, addr // self.mbw, y, u, v)
                self.cabac.terminate(int(addr == self.mbw * self.mbh - 1))
        else:
            self.inter_picture8(w, y, u, v)
        w.align_zero()
        au = ([nal_unit(3, 7, self.sps.rbsp()), nal_unit(3, 8, self.pps.rbsp())] if idr else [])
        au.append(nal_unit(3, 5 if idr else 1, w.data()))
        self.aus.append(au)
        self.ref_planes = [p.astype(np.int64) for p in self.reference(self.aus)]
        self.frame_num = (self.frame_num + 1) % (1 << self.sps.log2_max_frame_num)
        return au

    def planes(self):
        """FFmpeg's decode of the last picture, cropped (Y, U, V)."""
        return tuple(p[:h, :w].astype(np.uint8) for p, w, h in zip(self.ref_planes, (self.w, self.w // 2, self.w // 2),
                                                                    (self.h, self.h // 2, self.h // 2)))

    def bits(self, levels):
        """A rough count of the bits CABAC spends on levels."""
        a = np.abs(levels)
        return 3 * np.count_nonzero(a) + np.log2(1 + a).sum()

    # ---- the IDR
    def intra8_pred(self, rl, mbx, mby, b8):
        """{mode: prediction} of intra 8x8 block b8 (8.3.2): vertical, horizontal and DC from the filtered
        reference samples."""
        bx, by = b8 & 1, b8 >> 1
        x0, y0 = mbx * 16 + bx * 8, mby * 16 + by * 8
        top, left = y0 > 0, x0 > 0
        corner = top and left
        top_right = top and (b8 == 2 or (b8 == 0) or (b8 == 1 and mbx + 1 < self.mbw))
        p = None
        if top:
            p = np.concatenate([rl[y0 - 1, x0:x0 + 8], rl[y0 - 1, x0 + 8:x0 + 16] if top_right else
                                np.full(8, rl[y0 - 1, x0 + 7])])
        q = rl[y0:y0 + 8, x0 - 1] if left else None
        c = rl[y0 - 1, x0 - 1] if corner else None
        preds = {}
        if top:
            t = np.empty(16, np.int64)
            t[0] = (c + 2 * p[0] + p[1] + 2) >> 2 if corner else (3 * p[0] + p[1] + 2) >> 2
            t[1:15] = (p[:-2] + 2 * p[1:-1] + p[2:] + 2) >> 2
            t[15] = (p[14] + 3 * p[15] + 2) >> 2
            preds[0] = np.tile(t[:8], (8, 1))
        if left:
            lf = np.empty(8, np.int64)
            lf[0] = (c + 2 * q[0] + q[1] + 2) >> 2 if corner else (3 * q[0] + q[1] + 2) >> 2
            lf[1:7] = (q[:-2] + 2 * q[1:-1] + q[2:] + 2) >> 2
            lf[7] = (q[6] + 3 * q[7] + 2) >> 2
            preds[1] = np.tile(lf[:, None], (1, 8))
        dc = ((t[:8].sum() + lf.sum() + 8) >> 4 if top and left else (lf.sum() + 4) >> 3 if left else
              (t[:8].sum() + 4) >> 3 if top else 128)
        preds[2] = np.full((8, 8), dc, np.int64)
        return preds

    def intra_mb8(self, w, mbx, mby, y, u, v):
        addr, x0, y0 = mby * self.mbw + mbx, mbx * 16, mby * 16
        m = _Mb(0)
        self.mbs[addr] = m
        rl = self.recon[0]
        src = y[y0:y0 + 16, x0:x0 + 16]
        mode16, zdc, zac, rec16 = self.intra16(y, mbx, mby)
        cost16 = ((rec16 - src) ** 2).sum() + self.lam * (self.bits(zdc) + self.bits(zac) + 4)
        # Intra 8x8, block by block into the reconstruction.
        modes, levels8, cost8 = [], [], 0.0
        for b8 in range(4):
            bx, by = (b8 & 1) * 8, (b8 >> 1) * 8
            s8 = src[by:by + 8, bx:bx + 8]
            best = None
            for mode, pred in self.intra8_pred(rl, mbx, mby, b8).items():
                z = _quantise8(s8 - pred, self.qp, True)
                rec = np.clip(pred + _inverse8(dequantised8(z.reshape(-1)[_SCAN8].tolist(), self.qp)), 0, 255)
                cost = ((rec - s8) ** 2).sum() + self.lam * (self.bits(z) + (1 if mode == 2 else 4))
                if best is None or cost < best[0]:
                    best = (cost, mode, z, rec)
            cost8 += best[0]
            modes.append(best[1])
            levels8.append(best[2])
            rl[y0 + by:y0 + by + 8, x0 + bx:x0 + bx + 8] = best[3]
        chroma = self.chroma_residual(mbx, mby, *[self.chroma_dc_pred(p, mbx, mby) for p in self.recon[1:]], u, v, True)
        cbp_chroma = self.chroma_cbp(chroma)
        for plane, (_, _, rec) in zip(self.recon[1:], chroma):
            plane[mby * 8:mby * 8 + 8, mbx * 8:mbx * 8 + 8] = rec
        self.set_motion(mbx, mby, 0, 0, 4, 4, -1, (0, 0))
        self.set_mvd(mbx, mby, 0, 0, 4, 4, (0, 0))
        # On these frames intra 8x8 costs less almost everywhere; intra 16x16 is taken where it costs at most 1.35
        # times as much, which keeps both kinds in the clip.
        if cost16 <= 1.35 * cost8:
            rl[y0:y0 + 16, x0:x0 + 16] = rec16
            m.kind = "I16"
            cbp_luma = 15 if np.any(zac) else 0
            m.cbp = cbp_luma | cbp_chroma << 4
            self.put_mb_type_i(w, mbx, mby, 2, 1 + mode16 + 4 * cbp_chroma + (12 if cbp_luma else 0))
            self.put_chroma_mode(w, m, mbx, mby, 0)
            self.put_qp_delta(w, 0)
            if self.block(w, m, 0, zdc.reshape(-1)[_SCAN].tolist(), mbx, mby, 0, 0, 0, 16):
                m.dc |= 1
            for b8 in range(4):
                for b4 in range(4):
                    x4, y4 = (b8 & 1) * 2 + (b4 & 1), (b8 >> 1) * 2 + (b4 >> 1)
                    if cbp_luma:
                        m.nz[y4 * 4 + x4] = self.block(w, m, 1, zac[y4, x4].reshape(-1)[_SCAN][1:].tolist(), mbx, mby,
                                                       0, x4, y4, 15)
            self.stats["I_16x16"] += 1
        else:
            m.kind = "I4"
            self.put_mb_type_i(w, mbx, mby, 2, 0)
            self.put_transform_flag(w, m, mbx, mby, True)
            for b8, mode in enumerate(modes):
                x4, y4 = (b8 & 1) * 2, (b8 >> 1) * 2
                pa, pb = self.i4_neighbour(mbx, mby, x4 - 1, y4, m), self.i4_neighbour(mbx, mby, x4, y4 - 1, m)
                self.put_intra_mode(w, 2 if pa < 0 or pb < 0 else min(pa, pb), mode)
                for k in range(4):
                    m.i4[(y4 + (k >> 1)) * 4 + x4 + (k & 1)] = mode
            self.put_chroma_mode(w, m, mbx, mby, 0)
            cbp = sum(1 << b8 for b8 in range(4) if np.any(levels8[b8])) | cbp_chroma << 4
            self.put_cbp(w, m, mbx, mby, cbp, True)
            if cbp:
                self.put_qp_delta(w, 0)
            else:
                self.prev_dqp = 0
            self.luma8(w, m, mbx, mby, levels8, cbp)
            self.stats["I_NxN"] += 1
            self.stats["I_8x8"] += 1
        self.write_chroma8(w, m, mbx, mby, chroma, cbp_chroma)

    def luma8(self, w, m, mbx, mby, levels8, cbp):
        for b8 in range(4):
            x8, y8 = (b8 & 1) * 2, (b8 >> 1) * 2
            n = self.block(w, m, 5, levels8[b8].reshape(-1)[_SCAN8].tolist(), mbx, mby, 0, x8, y8, 64) \
                if (cbp >> b8) & 1 else 0
            for b4 in range(4):
                m.nz[(y8 + (b4 >> 1)) * 4 + x8 + (b4 & 1)] = n

    def write_chroma8(self, w, m, mbx, mby, chroma, cbp_chroma):
        if cbp_chroma:
            for comp, (zdc, _, _) in enumerate(chroma):
                if self.block(w, m, 3, zdc.reshape(-1).tolist(), mbx, mby, comp + 1, 0, 0, 4):
                    m.dc |= 2 << comp
        for comp, (_, zac, _) in enumerate(chroma):
            for b in range(4):
                if cbp_chroma == 2:
                    levels = zac[b >> 1, b & 1].reshape(-1)[_SCAN][1:].tolist()
                    m.nz[16 + comp * 4 + b] = self.block(w, m, 4, levels, mbx, mby, comp + 1, b & 1, b >> 1, 15)

    # ---- P pictures
    def inter_picture8(self, w, y, u, v):
        pad, r = self.PAD, self.search
        planes = quarter_planes(self.ref_planes[0], pad)
        ref_c = [np.pad(c, pad // 2 + 1, mode="edge") for c in self.ref_planes[1:]]
        full = planes[0][0].astype(np.int64)
        best16, best8 = np.full((self.mbh, self.mbw), np.iinfo(np.int64).max), \
            np.full((2 * self.mbh, 2 * self.mbw), np.iinfo(np.int64).max)
        mv16, mv8 = np.zeros((self.mbh, self.mbw, 2), np.int64), np.zeros((2 * self.mbh, 2 * self.mbw, 2), np.int64)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                diff = np.abs(full[pad + dy:pad + dy + self.ch, pad + dx:pad + dx + self.cw] - y)
                sad8 = diff.reshape(2 * self.mbh, 8, 2 * self.mbw, 8).sum(axis=(1, 3))
                sad16 = sad8.reshape(self.mbh, 2, self.mbw, 2).sum(axis=(1, 3))
                for best, mv, sad in ((best16, mv16, sad16), (best8, mv8, sad8)):
                    better = sad < best
                    best[better] = sad[better]
                    mv[better] = (4 * dx, 4 * dy)
        total = self.mbw * self.mbh
        for addr in range(total):
            mbx, mby = addr % self.mbw, addr // self.mbw
            self.inter_mb8(w, mbx, mby, y, u, v, planes, ref_c, mv16[mby, mbx], mv8[2 * mby:2 * mby + 2,
                                                                                      2 * mbx:2 * mbx + 2])
            self.cabac.terminate(int(addr == total - 1))

    def inter_mb8(self, w, mbx, mby, y, u, v, planes, ref_c, c16, c8):
        addr, x0, y0 = mby * self.mbw + mbx, mbx * 16, mby * 16
        m = _Mb(0)
        self.mbs[addr] = m
        src = y[y0:y0 + 16, x0:x0 + 16]
        skip = self.skip_mv(mbx, mby)
        sad16, mv = self.refine(planes, src, x0, y0, 16, 16, c16, (skip,))
        pmv = self.predict_mv(mbx, mby, 0, 0, 4, 0, 0, 0)
        cost16 = sad16 + 4 * (np.log2(1 + abs(mv[0] - pmv[0])) + np.log2(1 + abs(mv[1] - pmv[1])))
        parts8 = [self.refine(planes, src[by:by + 8, bx:bx + 8], x0 + bx, y0 + by, 8, 8, c8[by // 8, bx // 8])
                  for by in (0, 8) for bx in (0, 8)]
        cost8 = sum(p[0] for p in parts8) + 4 * (8 + sum(np.log2(1 + abs(p[1][0] - pmv[0])) +
                                                         np.log2(1 + abs(p[1][1] - pmv[1])) for p in parts8))
        p8x8 = cost8 < cost16
        mvs = [p[1] for p in parts8] if p8x8 else [mv] * 4
        pred = np.zeros((16, 16), np.int64)
        cpred = [np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64)]
        for b8, pm in enumerate(mvs):
            bx, by = (b8 & 1) * 8, (b8 >> 1) * 8
            pred[by:by + 8, bx:bx + 8] = self.luma_pred(planes, x0 + bx, y0 + by, 8, 8, pm)
            for cp, rc in zip(cpred, ref_c):
                cp[by // 2:by // 2 + 4, bx // 2:bx // 2 + 4] = self.chroma_pred(rc, mbx * 8 + bx // 2,
                                                                                 mby * 8 + by // 2, 4, 4, pm)
        t8, z4, z8, cbp_luma, _ = self.transforms(src, pred)
        chroma = self.chroma_residual(mbx, mby, cpred[0], cpred[1], u, v, False)
        cbp_chroma = self.chroma_cbp(chroma)
        if not p8x8 and mv == skip and not cbp_luma and not cbp_chroma:
            self.put_skip_flag(mbx, mby, True)
            m.kind = "SKIP"
            self.set_motion(mbx, mby, 0, 0, 4, 4, 0, mv)
            self.set_mvd(mbx, mby, 0, 0, 4, 4, (0, 0))
            self.prev_dqp = 0
            self.stats["P_Skip"] += 1
            return
        self.put_skip_flag(mbx, mby, False)
        self.put_mb_type_p(w, 3 if p8x8 else 0)
        if p8x8:
            m.shape = 3
            for _ in range(4):
                self.put_sub_mb_type(w, 0)
            self.stats["sub_8x8"] += 4
        mask = 0
        for b8, pm in enumerate(mvs[:4 if p8x8 else 1]):
            x4, y4, s = ((b8 & 1) * 2, (b8 >> 1) * 2, 2) if p8x8 else (0, 0, 4)
            p = self.predict_mv(mbx, mby, x4, y4, s, 0, mask, 0)
            d = (pm[0] - p[0], pm[1] - p[1])
            self.put_mvd(w, d, mbx, mby, x4, y4)
            self.set_mvd(mbx, mby, x4, y4, s, s, d)
            mask |= self.set_motion(mbx, mby, x4, y4, s, s, 0, pm)
        self.write_residual(w, m, mbx, mby, t8, z4, z8, cbp_luma, chroma, cbp_chroma)
        self.stats["P_8x8" if p8x8 else "P_L0_16x16"] += 1

    def transforms(self, src, pred):
        """(8x8 transform, 4x4 levels, 8x8 levels, CodedBlockPatternLuma, cost) of an inter macroblock's residual: the
        4x4 or the 8x8 transform, the cheaper reconstruction (its cost: squared error plus lambda times bits)."""
        res = src - pred
        z4 = _quantise(_forward(_blocks(res)), self.qp, False)
        rec4 = _unblocks(_inverse(_dequantise(z4, self.qp)))
        z8 = [_quantise8(res[by:by + 8, bx:bx + 8], self.qp, False) for by in (0, 8) for bx in (0, 8)]
        rec8 = np.zeros((16, 16), np.int64)
        for b8, z in enumerate(z8):
            bx, by = (b8 & 1) * 8, (b8 >> 1) * 8
            rec8[by:by + 8, bx:bx + 8] = _inverse8(dequantised8(z.reshape(-1)[_SCAN8].tolist(), self.qp))
        cost4 = ((pred + rec4 - src) ** 2).sum() + self.lam * self.bits(z4)
        cost8t = ((pred + rec8 - src) ** 2).sum() + self.lam * self.bits(np.stack(z8))
        t8 = cost8t < cost4
        if t8:
            cbp_luma = sum(1 << b8 for b8 in range(4) if np.any(z8[b8]))
        else:
            cbp_luma = sum(1 << b8 for b8 in range(4)
                           if np.any(z4[(b8 >> 1) * 2:(b8 >> 1) * 2 + 2, (b8 & 1) * 2:(b8 & 1) * 2 + 2]))
        return t8, z4, z8, cbp_luma, min(cost4, cost8t)

    def write_residual(self, w, m, mbx, mby, t8, z4, z8, cbp_luma, chroma, cbp_chroma):
        """coded_block_pattern, transform_size_8x8_flag, mb_qp_delta and the levels of an inter macroblock."""
        cbp = cbp_luma | cbp_chroma << 4
        self.put_cbp(w, m, mbx, mby, cbp, False)
        if cbp_luma:
            self.put_transform_flag(w, m, mbx, mby, t8)
            self.stats["transform_8x8_inter"] += int(t8)
        if cbp:
            self.put_qp_delta(w, 0)
        else:
            self.prev_dqp = 0
        if m.t8:
            self.luma8(w, m, mbx, mby, z8, cbp_luma)
        else:
            for b8 in range(4):
                for b4 in range(4):
                    x4, y4 = (b8 & 1) * 2 + (b4 & 1), (b8 >> 1) * 2 + (b4 >> 1)
                    if (cbp_luma >> b8) & 1:
                        m.nz[y4 * 4 + x4] = self.block(w, m, 2, z4[y4, x4].reshape(-1)[_SCAN].tolist(), mbx, mby, 0,
                                                       x4, y4, 16)
        self.write_chroma8(w, m, mbx, mby, chroma, cbp_chroma)


class HighBEncoder(HighEncoder):
    """High profile with B pictures in x264's default GOP shape: after the IDR, an anchor P picture every 4 frames
    (or the last frame) and up to 3 B pictures before it in display order, the middle one of 3 a reference coded
    first (B-pyramid ``normal``), then the others; POC type 0, the VUI's max_num_reorder_frames 2; spatial direct
    (B_Skip and B_Direct_16x16), B_L0 / B_L1 / B_Bi_16x16 with implicit weighted bi-prediction
    (``weighted_bipred_idc`` 2); CABAC, the 8x8 transform, deblocking on; a fixed QP, 2 more in B slices (x264's
    ``--qp`` with its default pbratio 1.3). Each picture predicts from
    FFmpeg's decode of its references (``reference(access units)``: every frame decoded so far, in display order);
    a P picture from the anchor before it (moved to the head of list 0)."""

    def __init__(self, width, height, reference, qp=22, search=6):
        super().__init__(width, height, reference, qp, search)
        crop = self.sps.crop
        self.sps = Sps(self.mbw, self.mbh, profile_idc=100, level_idc=31, poc_type=0, log2_max_poc_lsb=8,
                       max_num_ref_frames=3, crop=crop, vui=True, bitstream_restriction=True, num_reorder_frames=2)
        self.pps = Pps(pic_init_qp=qp, deblocking_control=True, cabac=True, transform_8x8=True, bipred_idc=2)
        self.refs, self.decoded, self.done, self.uid = [], {}, [], 0
        self.ctx_used_l1, self.direct_spatial, self.d8 = set(), True, True
        self.last_anchor = None

    @staticmethod
    def gop(n):
        """(display index, kind, reference) of each of ``n`` frames in decoding order."""
        order, prev = [(0, "I", True)], 0
        while prev < n - 1:
            anchor = min(prev + 4, n - 1)
            bs = list(range(prev + 1, anchor))
            order.append((anchor, "P", True))
            if len(bs) == 3:
                order += [(bs[1], "B", True), (bs[0], "B", False), (bs[2], "B", False)]
            else:
                order += [(b, "B", False) for b in bs]
            prev = anchor
        return order

    def encode_all(self, yuvs):
        """The access units of the frames ``yuvs`` (Y, U, V planes each, in display order), in decoding order."""
        aus = []
        for disp, kind, ref in self.gop(len(yuvs)):
            aus.append(self.encode_picture(yuvs[disp], disp, kind, ref))
        return aus

    def encode_picture(self, yuv, disp, kind, ref):
        y, u, v = (np.pad(p, ((0, ch - p.shape[0]), (0, cw - p.shape[1])), mode="edge").astype(np.int64)
                   for p, cw, ch in ((yuv[0], self.cw, self.ch), (yuv[1], self.cw // 2, self.ch // 2),
                                     (yuv[2], self.cw // 2, self.ch // 2)))
        idr, self.pic_kind, self.cur_poc = kind == "I", kind, 2 * disp
        base_qp = self.qp
        self.qp += 2 * (kind == "B")
        w = BitWriter()
        w.ue(0)  # first_mb_in_slice
        w.ue({"I": 7, "P": 5, "B": 6}[kind])
        w.ue(0)
        w.u(self.sps.log2_max_frame_num, self.frame_num)
        if idr:
            w.ue(0)  # idr_pic_id
        w.u(self.sps.log2_max_poc_lsb, self.cur_poc % (1 << self.sps.log2_max_poc_lsb))
        shorts = list(self.refs)
        if kind == "B":
            w.u(1, 1)  # direct_spatial_mv_pred_flag
            before = sorted([r for r in shorts if r.poc <= self.cur_poc], key=lambda r: -r.poc)
            after = sorted([r for r in shorts if r.poc > self.cur_poc], key=lambda r: r.poc)
            self.ref_lists = [before + after, after + before]
        elif kind == "P":
            self.ref_lists = [[self.last_anchor]]
        else:
            self.ref_lists = []
        if kind != "I":
            w.u(1, 0)  # num_ref_idx_active_override_flag: one entry in each list
            if kind == "P":  # the anchor before, ahead of a reference B picture decoded after it
                default = max(shorts, key=lambda r: r.frame_num_wrap)
                w.u(1, int(default is not self.last_anchor))
                if default is not self.last_anchor:
                    w.ue(0)
                    w.ue(self.frame_num - self.last_anchor.frame_num_wrap - 1)
                    w.ue(3)
            else:
                w.u(1, 0)
                w.u(1, 0)
        if ref:
            w.u(1, 0)  # no_output_of_prior_pics_flag / adaptive_ref_pic_marking_mode_flag
            if idr:
                w.u(1, 0)  # long_term_reference_flag
        if kind != "I":
            w.ue(0)  # cabac_init_idc
        w.se(self.qp - base_qp)  # slice_qp_delta
        w.ue(0)  # disable_deblocking_filter_idc: on, offsets 0
        w.se(0)
        w.se(0)
        w.align_one()
        self.cabac = CabacWriter(w, self.qp, 0 if idr else 1, self.ctx_used)
        self.prev_dqp = 0
        self.mbs = [None] * (self.mbw * self.mbh)
        self.new_arrays()
        self.recon = [np.zeros((self.ch, self.cw), np.int64), np.zeros((self.ch // 2, self.cw // 2), np.int64),
                      np.zeros((self.ch // 2, self.cw // 2), np.int64)]
        if idr:
            for addr in range(self.mbw * self.mbh):
                self.intra_mb8(w, addr % self.mbw, addr // self.mbw, y, u, v)
                self.cabac.terminate(int(addr == self.mbw * self.mbh - 1))
        elif kind == "P":
            self.ref_planes = self.decoded[self.last_anchor.uid]
            self.inter_picture8(w, y, u, v)
        else:
            self.stats["b_slices"] += 1
            self.stats["implicit_bipred_slices"] += 1
            self.b_picture8(w, y, u, v)
        w.align_zero()
        au = ([nal_unit(3, 7, self.sps.rbsp()), nal_unit(3, 8, self.pps.rbsp())] if idr else [])
        au.append(nal_unit((2 if kind == "B" else 3) if ref else 0, 5 if idr else 1, w.data()))
        self.aus.append(au)
        # FFmpeg's decode of every frame so far, by display index.
        self.done.append(disp)
        frames = self.reference(self.aus)
        by_disp = dict(zip(sorted(self.done), frames))
        if ref:
            self.uid += 1
            cur = _Ref(self.frame_num, self.uid, poc=self.cur_poc)
            cur.motion = self.motion_record(self.ref_lists)
            if len(self.refs) >= self.sps.max_num_ref_frames:  # the sliding window
                self.refs.remove(min(self.refs, key=lambda r: r.frame_num))
            self.refs.append(cur)
            self.decoded[cur.uid] = [p.astype(np.int64) for p in by_disp[disp]]
            if kind != "B":
                self.last_anchor = cur
            self.frame_num = (self.frame_num + 1) % (1 << self.sps.log2_max_frame_num)
            for r in self.refs:
                r.frame_num_wrap = r.frame_num
        self.stats["reference_b_pictures"] += int(kind == "B" and ref)
        self.last_planes = by_disp
        self.qp = base_qp
        return au

    def b_picture8(self, w, y, u, v):
        pad, rad = self.PAD, self.search
        refs = [self.ref_lists[0][0], self.ref_lists[1][0]]
        planes = [quarter_planes(self.decoded[r.uid][0], pad) for r in refs]
        ref_c = [[np.pad(c, pad // 2 + 1, mode="edge") for c in self.decoded[r.uid][1:]] for r in refs]
        centres = []
        for pl in planes:
            full = pl[0][0].astype(np.int64)
            best = np.full((self.mbh, self.mbw), np.iinfo(np.int64).max)
            mv = np.zeros((self.mbh, self.mbw, 2), np.int64)
            for dy in range(-rad, rad + 1):
                for dx in range(-rad, rad + 1):
                    sad = np.abs(full[pad + dy:pad + dy + self.ch, pad + dx:pad + dx + self.cw] - y).reshape(
                        self.mbh, 16, self.mbw, 16).sum(axis=(1, 3))
                    better = sad < best
                    best[better] = sad[better]
                    mv[better] = (4 * dx, 4 * dy)
            centres.append(mv)
        self.col = refs[1].motion
        w0 = self.implicit_weight(refs[0], refs[1])
        total = self.mbw * self.mbh
        for addr in range(total):
            mbx, mby = addr % self.mbw, addr // self.mbw
            self.b_mb8(w, mbx, mby, y, u, v, planes, ref_c, [c[mby, mbx] for c in centres], w0)
            self.cabac.terminate(int(addr == total - 1))

    def implicit_weight(self, r0, r1):
        """w0 of implicit weighted bi-prediction (8.4.2.3.1) from list 0's r0 and list 1's r1."""
        td = max(-128, min(127, r1.poc - r0.poc))
        if not td:
            return 32
        tb = max(-128, min(127, self.cur_poc - r0.poc))
        q = (16384 + (abs(td) >> 1)) // abs(td)
        dsf = (tb * (q if td > 0 else -q) + 32) >> 8
        return 64 - dsf if -64 <= dsf <= 128 else 32

    def b_mb8(self, w, mbx, mby, y, u, v, planes, ref_c, centres, w0):
        addr, x0, y0 = mby * self.mbw + mbx, mbx * 16, mby * 16
        m = _Mb(0)
        m.kind = "P"
        self.mbs[addr] = m
        src = y[y0:y0 + 16, x0:x0 + 16]

        def weigh(a, b):
            return (a + b + 1) >> 1 if w0 == 32 else np.clip((a * w0 + b * (64 - w0) + 32) >> 6, 0, 255)

        # Spatial direct: the prediction of its 4x4 blocks (its count kept only where it is chosen).
        before = self.stats["spatial_direct_mbs"]
        drefs, dmvs, dshape, _ = self.direct_motion(mbx, mby, False)
        self.stats["spatial_direct_mbs"] = before
        dpred, dcpred = np.zeros((16, 16), np.int64), [np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64)]
        for k in range(16):
            bx, by = (k & 3) * 4, (k >> 2) * 4
            lum, chs = [], []
            for lst in range(2):
                if drefs[lst][k] >= 0:
                    lum.append(self.luma_pred(planes[lst], x0 + bx, y0 + by, 4, 4, dmvs[lst][k]))
                    chs.append([self.chroma_pred(rc, mbx * 8 + bx // 2, mby * 8 + by // 2, 2, 2, dmvs[lst][k])
                                for rc in ref_c[lst]])
            dpred[by:by + 4, bx:bx + 4] = lum[0] if len(lum) == 1 else weigh(*lum)
            for c in range(2):
                dcpred[c][by // 2:by // 2 + 2, bx // 2:bx // 2 + 2] = chs[0][c] if len(chs) == 1 else \
                    weigh(chs[0][c], chs[1][c])
        # One 16x16 partition from list 0, list 1 or both.
        cands = []
        mvs, pmvs = [], []
        for lst in range(2):
            pmv = self.predict_mv(mbx, mby, 0, 0, 4, 0, 0, 0, lst)
            _, mv = self.refine(planes[lst], src, x0, y0, 16, 16, centres[lst], (tuple(pmv),))
            mvs.append(mv)
            pmvs.append(pmv)
        preds = [self.luma_pred(planes[lst], x0, y0, 16, 16, mvs[lst]) for lst in range(2)]
        cpreds = [[self.chroma_pred(rc, mbx * 8, mby * 8, 8, 8, mvs[lst]) for rc in ref_c[lst]] for lst in range(2)]

        def mv_bits(lst):
            return np.log2(1 + abs(mvs[lst][0] - pmvs[lst][0])) + np.log2(1 + abs(mvs[lst][1] - pmvs[lst][1]))

        cands.append((np.abs(src - dpred).sum() - 8, 0, dpred, dcpred))
        cands.append((np.abs(src - preds[0]).sum() + 4 * (2 + mv_bits(0)), 1, preds[0], cpreds[0]))
        cands.append((np.abs(src - preds[1]).sum() + 4 * (2 + mv_bits(1)), 2, preds[1], cpreds[1]))
        bi, cbi = weigh(preds[0], preds[1]), [weigh(cpreds[0][c], cpreds[1][c]) for c in range(2)]
        cands.append((np.abs(src - bi).sum() + 4 * (4 + mv_bits(0) + mv_bits(1)), 3, bi, cbi))
        _, mode, pred, cpred = min(cands, key=lambda t: (t[0], t[1]))
        t8, z4, z8, cbp_luma, cost = self.transforms(src, pred)
        chroma = self.chroma_residual(mbx, mby, cpred[0], cpred[1], u, v, False)
        cbp_chroma = self.chroma_cbp(chroma)
        if mode == 0 and ((src - pred) ** 2).sum() <= cost:  # B_Skip where the luma residual does not pay for itself
            cbp_luma = cbp_chroma = 0
        if mode == 0:
            m.shape = dshape
            self.set_direct(mbx, mby, drefs, dmvs, range(16))
            self.stats["spatial_direct_mbs"] += 1
            if not cbp_luma and not cbp_chroma:
                self.put_skip_flag(mbx, mby, True, True)
                m.kind = "SKIP"
                self.prev_dqp = 0
                self.stats["B_Skip"] += 1
                return
        self.put_skip_flag(mbx, mby, False, True)
        self.put_mb_type_b(w, mbx, mby, mode)
        if mode == 0:
            m.direct16 = True
            self.stats["B_Direct_16x16"] += 1
        else:
            self.stats["B_16x16"] += 1
            self.stats["bi_partitions"] += int(mode == 3)
            for lst in range(2):
                if mode >> lst & 1:
                    d = (mvs[lst][0] - pmvs[lst][0], mvs[lst][1] - pmvs[lst][1])
                    self.put_mvd(w, d, mbx, mby, 0, 0, lst)
                    self.set_mvd(mbx, mby, 0, 0, 4, 4, d, lst)
                    self.set_motion(mbx, mby, 0, 0, 4, 4, 0, tuple(mvs[lst]), lst)
                else:
                    self.set_motion(mbx, mby, 0, 0, 4, 4, -1, (0, 0), lst)
        self.write_residual(w, m, mbx, mby, t8, z4, z8, cbp_luma, chroma, cbp_chroma)


def encode_frames(frames_bgr, qp=22, search=6, high=False, b_frames=False):
    """(access units in decoding order, the encoder's reconstruction of each frame as (Y, U, V) in display order, the
    encoder) of uint8 BGR frames of even size: BT.601 limited-range YUV 4:2:0 from ``cv2.cvtColor``, an IDR, then
    P pictures; Baseline (:class:`FrameEncoder`), or High with CABAC and the 8x8 transform (:class:`HighEncoder`,
    whose reconstruction is FFmpeg's decode), with ``b_frames`` B pictures in x264's GOP shape too
    (:class:`HighBEncoder`)."""
    import cv2

    h, w = frames_bgr[0].shape[:2]
    if high:
        from torch_libav import decode_planes

        def reference(aus):
            frames = decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", enc.cw, enc.ch,
                                   options={"apply_cropping": "0"})
            return frames if b_frames else frames[-1]

        enc = (HighBEncoder if b_frames else HighEncoder)(w, h, reference, qp, search)
    else:
        enc = FrameEncoder(w, h, qp, search)
    yuvs = []
    for frame in frames_bgr:
        i420 = cv2.cvtColor(np.ascontiguousarray(frame), cv2.COLOR_BGR2YUV_I420)
        yuvs.append((i420[:h], i420[h:h + h // 4].reshape(h // 2, w // 2), i420[h + h // 4:].reshape(h // 2, w // 2)))
    if b_frames:
        aus = enc.encode_all(yuvs)
        recon = [tuple(p[:hh, :ww].astype(np.uint8) for p, ww, hh in zip(enc.last_planes[i], (w, w // 2, w // 2),
                                                                          (h, h // 2, h // 2)))
                 for i in range(len(yuvs))]
        return aus, recon, enc
    aus, recon = [], []
    for yuv in yuvs:
        aus.append(enc.encode(yuv))
        recon.append(enc.planes())
    return aus, recon, enc
