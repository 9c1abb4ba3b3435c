"""OpenCV's own FFmpeg (the libraries bundled with the cv2 wheel, in
``opencv_python.libs``) through ctypes, for the port's video tests: its
encoders with any AVOption, its decoders' planes, and swscale's conversion
to BGR24 as ``cv2.VideoCapture`` calls it.

The structure fields used are few and are read at fixed byte offsets (FFmpeg
8: libavutil 60, libavcodec 62): ``AVFrame`` ``data`` / ``linesize`` /
``width`` / ``height`` / ``format`` / ``pts`` at 0 / 64 / 104 / 108 / 116 /
136, ``AVPacket`` ``data`` / ``size`` at 24 / 32, ``AVCodecParameters``
``extradata`` / ``extradata_size`` at 16 / 24.
"""

import ctypes
import glob
import os
import struct

import cv2
import numpy as np

LIBS = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
_P = ctypes.c_void_p
_loaded = {}

# Planar layouts the tests use: (planes, log2 chroma width, log2 chroma height, bytes a pixel of plane 0).
PIX_FMTS = {"gray": (1, 0, 0, 1), "ya8": (1, 0, 0, 2), "bgr0": (1, 0, 0, 4), "bgra": (1, 0, 0, 4),
            "yuv420p": (3, 1, 1, 1), "yuv422p": (3, 1, 0, 1), "yuv444p": (3, 0, 0, 1), "yuv410p": (3, 2, 2, 1),
            "yuv411p": (3, 2, 0, 1), "yuv440p": (3, 0, 1, 1), "yuva420p": (4, 1, 1, 1), "yuva422p": (4, 1, 0, 1),
            "yuva444p": (4, 0, 0, 1), "yuv420p10le": (3, 1, 1, 2), "rgb24": (1, 0, 0, 3), "gray16le": (1, 0, 0, 2)}


def _library(name):
    if name not in _loaded:
        paths = glob.glob(os.path.join(LIBS, f"{name}-*.so*"))
        assert paths, f"no {name} beside cv2 in {LIBS}"
        _loaded[name] = ctypes.CDLL(paths[0], mode=ctypes.RTLD_GLOBAL)
    return _loaded[name]


def libavcodec():
    """(libavutil, libavcodec), with the signatures of the functions the tests call."""
    avutil = _library("libavutil")
    _library("libswresample")
    avcodec = _library("libavcodec")
    for name, restype, argtypes in (("avcodec_find_encoder_by_name", _P, [ctypes.c_char_p]),
                                    ("avcodec_find_decoder_by_name", _P, [ctypes.c_char_p]),
                                    ("avcodec_alloc_context3", _P, [_P]), ("avcodec_open2", ctypes.c_int, [_P, _P, _P]),
                                    ("av_packet_alloc", _P, []), ("av_new_packet", ctypes.c_int, [_P, ctypes.c_int]),
                                    ("avcodec_send_frame", ctypes.c_int, [_P, _P]),
                                    ("avcodec_receive_packet", ctypes.c_int, [_P, _P]),
                                    ("avcodec_send_packet", ctypes.c_int, [_P, _P]),
                                    ("avcodec_receive_frame", ctypes.c_int, [_P, _P]),
                                    ("av_packet_unref", None, [_P]), ("avcodec_parameters_alloc", _P, []),
                                    ("avcodec_parameters_from_context", ctypes.c_int, [_P, _P]),
                                    ("avcodec_parameters_to_context", ctypes.c_int, [_P, _P])):
        getattr(avcodec, name).restype, getattr(avcodec, name).argtypes = restype, argtypes
    for name, restype, argtypes in (("av_frame_alloc", _P, []), ("av_frame_get_buffer", ctypes.c_int, [_P, ctypes.c_int]),
                                    ("av_frame_make_writable", ctypes.c_int, [_P]), ("av_frame_unref", None, [_P]),
                                    ("av_opt_set", ctypes.c_int, [_P, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
                                    ("av_get_pix_fmt", ctypes.c_int, [ctypes.c_char_p])):
        getattr(avutil, name).restype, getattr(avutil, name).argtypes = restype, argtypes
    return avutil, avcodec


def plane_shapes(pix_fmt, w, h):
    """(rows, bytes a row) of each plane of a ``w`` x ``h`` frame of ``pix_fmt``."""
    planes, sx, sy, step = PIX_FMTS[pix_fmt]
    cw, ch = -(-w >> sx), -(-h >> sy)
    return [(h, w * step) if k in (0, 3) else (ch, cw * step) for k in range(planes)]


def _frame_planes(frame, shapes):
    head = ctypes.string_at(frame, 96)
    data, linesize = struct.unpack("<8Q", head[:64]), struct.unpack("<8i", head[64:])
    return data, linesize


def encode(codec_name, frames, pix_fmt, w, h, options=None):
    """(payloads, extradata) FFmpeg's encoder ``codec_name`` writes for ``frames`` (each a list of planes as
    :func:`plane_shapes` gives them) of ``pix_fmt`` at ``w`` x ``h``, with the AVOptions ``options``."""
    avutil, avcodec = libavcodec()
    codec = avcodec.avcodec_find_encoder_by_name(codec_name.encode())
    assert codec, f"no {codec_name} encoder in cv2's FFmpeg"
    ctx = avcodec.avcodec_alloc_context3(codec)
    settings = {"video_size": f"{w}x{h}", "pixel_format": pix_fmt, "time_base": "1/10", **(options or {})}
    for key, value in settings.items():
        assert avutil.av_opt_set(ctx, key.encode(), str(value).encode(), 1) >= 0, key  # 1: the encoder's own too
    assert avcodec.avcodec_open2(ctx, codec, None) == 0, f"{codec_name} refused {settings}"
    frame, packet = avutil.av_frame_alloc(), avcodec.av_packet_alloc()
    ctypes.memmove(frame + 104, struct.pack("<ii", w, h), 8)
    ctypes.memmove(frame + 116, struct.pack("<i", avutil.av_get_pix_fmt(pix_fmt.encode())), 4)
    assert avutil.av_frame_get_buffer(frame, 0) == 0
    payloads = []

    def drain():
        while avcodec.avcodec_receive_packet(ctx, packet) == 0:
            data, size = struct.unpack("<Qi", ctypes.string_at(packet + 24, 12))
            payloads.append(ctypes.string_at(data, size))
            avcodec.av_packet_unref(packet)

    shapes = plane_shapes(pix_fmt, w, h)
    for i, planes in enumerate(frames):
        assert avutil.av_frame_make_writable(frame) == 0
        data, linesize = _frame_planes(frame, shapes)
        for k, plane in enumerate(planes):
            plane = np.ascontiguousarray(plane).reshape(shapes[k])
            for row in range(plane.shape[0]):
                ctypes.memmove(data[k] + row * linesize[k], plane[row].tobytes(), plane.shape[1])
        ctypes.memmove(frame + 136, struct.pack("<q", i), 8)
        assert avcodec.avcodec_send_frame(ctx, frame) == 0
        drain()
    avcodec.avcodec_send_frame(ctx, None)
    drain()
    par = avcodec.avcodec_parameters_alloc()
    assert avcodec.avcodec_parameters_from_context(par, ctx) >= 0
    extradata, size = struct.unpack("<Qi", ctypes.string_at(par + 16, 12))
    return payloads, ctypes.string_at(extradata, size) if size else b""


def decode_planes(codec_name, payloads, pix_fmt, w, h, extradata=b"", options=None):
    """The planes (each ``rows x bytes``, as :func:`plane_shapes`) FFmpeg's decoder ``codec_name`` gives for each
    frame of ``payloads``, its frames being of ``pix_fmt`` at ``w`` x ``h``; ``options``: more AVOptions of the
    decoder (``{"apply_cropping": "0"}``: the coded frames)."""
    avutil, avcodec = libavcodec()
    codec = avcodec.avcodec_find_decoder_by_name(codec_name.encode())
    ctx = avcodec.avcodec_alloc_context3(codec)
    for key, value in {"video_size": f"{w}x{h}", "threads": "1", **(options or {})}.items():
        assert avutil.av_opt_set(ctx, key.encode(), value.encode(), 0) >= 0, key
    if extradata:
        par = avcodec.avcodec_parameters_alloc()
        keep = ctypes.create_string_buffer(extradata + bytes(64), len(extradata) + 64)
        ctypes.memmove(par, struct.pack("<ii", 0, 0), 8)
        ctypes.memmove(par + 16, struct.pack("<Qi", ctypes.addressof(keep), len(extradata)), 12)
        # avcodec_parameters_to_context copies the extradata; it also sets width / height, read back at 0 here,
        # so the size is set again below.
        assert avcodec.avcodec_parameters_to_context(ctx, par) >= 0
        ctypes.memmove(par + 16, struct.pack("<Qi", 0, 0), 12)
        for key, value in {"video_size": f"{w}x{h}"}.items():
            assert avutil.av_opt_set(ctx, key.encode(), value.encode(), 0) >= 0, key
    assert avcodec.avcodec_open2(ctx, codec, None) == 0
    packet, frame, out = avcodec.av_packet_alloc(), avutil.av_frame_alloc(), []
    shapes = plane_shapes(pix_fmt, w, h)

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            fw, fh = struct.unpack("<ii", ctypes.string_at(frame + 104, 8))
            assert (fw, fh) == (w, h)
            data, linesize = _frame_planes(frame, shapes)
            planes = []
            for k, (rows, width) in enumerate(shapes):
                raw = np.frombuffer(ctypes.string_at(data[k], linesize[k] * rows), np.uint8).reshape(rows, linesize[k])
                planes.append(raw[:, :width].copy())
            out.append(planes)
            avutil.av_frame_unref(frame)

    for payload in payloads:
        assert avcodec.av_new_packet(packet, len(payload)) == 0
        ctypes.memmove(struct.unpack("<Q", ctypes.string_at(packet + 24, 8))[0], payload, len(payload))
        assert avcodec.avcodec_send_packet(ctx, packet) == 0
        avcodec.av_packet_unref(packet)
        drain()
    avcodec.avcodec_send_packet(ctx, None)
    drain()
    return out


def sws_bgr(pix_fmt, planes, w, h, chroma_pos=(-513, -513)):
    """swscale's conversion of one frame's ``planes`` of ``pix_fmt`` to BGR24 at the same size with
    ``SWS_BICUBIC``, as cv2.VideoCapture converts each decoded frame; ``chroma_pos`` is the source's
    ``src_h_chr_pos`` / ``src_v_chr_pos`` (-513: swscale's default, centred)."""
    avutil, _ = libavcodec()
    sws = _library("libswscale")
    sws.sws_alloc_context.restype = _P
    sws.sws_init_context.restype, sws.sws_init_context.argtypes = ctypes.c_int, [_P, _P, _P]
    sws.sws_scale.restype, sws.sws_scale.argtypes = ctypes.c_int, [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    sws.sws_freeContext.argtypes = [_P]
    avutil.av_opt_set_int.restype, avutil.av_opt_set_int.argtypes = ctypes.c_int, [_P, ctypes.c_char_p,
                                                                                   ctypes.c_int64, ctypes.c_int]
    ctx = sws.sws_alloc_context()
    settings = {"srcw": w, "srch": h, "src_format": avutil.av_get_pix_fmt(pix_fmt.encode()), "dstw": w, "dsth": h,
                "dst_format": avutil.av_get_pix_fmt(b"bgr24"), "sws_flags": 4,  # SWS_BICUBIC
                "src_h_chr_pos": chroma_pos[0], "src_v_chr_pos": chroma_pos[1]}
    for key, value in settings.items():
        assert avutil.av_opt_set_int(ctx, key.encode(), value, 0) >= 0, key
    assert sws.sws_init_context(ctx, None, None) >= 0, pix_fmt
    bufs = [np.ascontiguousarray(p) for p in planes]
    src = (_P * 4)(*[b.ctypes.data for b in bufs], *([None] * (4 - len(bufs))))
    strides = (ctypes.c_int * 4)(*[b.shape[1] for b in bufs], *([0] * (4 - len(bufs))))
    out = np.zeros((h, w * 3 + 64), np.uint8)  # a row padded, as OpenCV's frame buffer is
    dst, dst_strides = (_P * 4)(out.ctypes.data, None, None, None), (ctypes.c_int * 4)(out.shape[1], 0, 0, 0)
    assert sws.sws_scale(ctx, src, strides, 0, h, dst, dst_strides) == h
    sws.sws_freeContext(ctx)
    return out[:, :w * 3].reshape(h, w, 3)


def _chunk(fourcc, body):
    return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def write_avi(path, payloads, w, h, fourcc, extradata=b"", keys=None):
    """A RIFF AVI of compressed frames with an ``idx1`` index (``keys``: which are key frames; default all), the
    decoder's configuration after the BITMAPINFOHEADER in ``strf``."""
    n = len(payloads)
    keys = keys if keys is not None else [True] * n
    avih = struct.pack("<14I", 100000, 0, 0, 0x10, n, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, 10, 0, n, 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0) + extradata
    hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih)
                  + _chunk(b"LIST", b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index, offset = b"", b"", 4
    for payload, key in zip(payloads, keys):
        index += struct.pack("<4sIII", b"00dc", 0x10 if key else 0, offset, len(payload))
        movi += _chunk(b"00dc", payload)
        offset += 8 + len(payload) + (len(payload) & 1)
    with open(path, "wb") as f:
        f.write(_chunk(b"RIFF", b"AVI " + hdrl + _chunk(b"LIST", b"movi" + movi) + _chunk(b"idx1", index)))


def capture(path):
    """Every frame cv2.VideoCapture reads from ``path``."""
    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames
