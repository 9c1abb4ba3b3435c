#!/usr/bin/env python3
"""Where the time goes in the port's VP9 decoder, on the host's CPU.

    python3 scripts/profile_vp9_decode.py [--clip tests/data_torch/vp9/vp9_960x540x12.webm] [--repeats 5]

Builds ``super_resolution_tpu_torch/native/vp9_decoder.cpp`` with its stage
timers compiled in (``-DSR_VP9_PROFILE``; the library the port loads has
none) into a temporary directory, decodes the clip's frames ``--repeats``
times and prints, for the fastest pass, the milliseconds a frame and the share
of each stage: mode info (the partition tree and every block's modes and
vectors), coefficient tokens, intra prediction, inter prediction, inverse
transforms, the loop filter, the rest of the decode (context bookkeeping,
the frame's set-up and adaptation), and the conversion of the shown frames
to BGR. Needs a C++ compiler. The numbers are this host's: a decode on
another machine (the card's host, say) takes another time.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STAGES = ("mode info", "tokens", "intra prediction", "inter prediction", "inverse transforms", "loop filter")


def build(directory: str) -> ctypes.CDLL:
    source = os.path.join(ROOT, "super_resolution_tpu_torch", "native", "vp9_decoder.cpp")
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        raise SystemExit("no C++ compiler (g++ / c++) on PATH")
    lib = os.path.join(directory, "libsr_vp9_profile.so")
    subprocess.run([compiler, "-O3", "-shared", "-fPIC", "-std=c++17", "-DSR_VP9_PROFILE", source, "-o", lib],
                   check=True)
    dll = ctypes.CDLL(lib)
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, restype, argtypes in (("sr_vp9_stream_new", p, []), ("sr_vp9_stream_free", None, [p]),
                                    ("sr_vp9_stream_decode", i, [p, ctypes.c_char_p, i64, ctypes.c_char_p, i]),
                                    ("sr_vp9_stream_size", None, [p, p]), ("sr_vp9_stream_bgr", None, [p, i, p]),
                                    ("sr_vp9_stream_profile", i, [p, p, i])):
        getattr(dll, name).restype, getattr(dll, name).argtypes = restype, argtypes
    return dll


def one_pass(dll: ctypes.CDLL, payloads: list[bytes]) -> tuple[float, float, np.ndarray, int]:
    """(decode s, BGR conversion s, stage ns, frames shown) of one decode of the stream."""
    handle, err = dll.sr_vp9_stream_new(), ctypes.create_string_buffer(256)
    decode_s = convert_s = 0.0
    shown = 0
    wh = np.zeros(2, np.int32)
    for payload in payloads:
        t0 = time.perf_counter()
        n = dll.sr_vp9_stream_decode(handle, payload, len(payload), err, len(err))
        decode_s += time.perf_counter() - t0
        if n < 0:
            raise SystemExit(f"decode failed: {err.value.decode()}")
        dll.sr_vp9_stream_size(handle, wh.ctypes.data)
        out = np.empty((wh[1], wh[0], 3), np.uint8)
        for k in range(n):
            t0 = time.perf_counter()
            dll.sr_vp9_stream_bgr(handle, k, out.ctypes.data)
            convert_s += time.perf_counter() - t0
        shown += n
    stages = np.zeros(len(STAGES), np.int64)
    dll.sr_vp9_stream_profile(handle, stages.ctypes.data, len(STAGES))
    dll.sr_vp9_stream_free(handle)
    return decode_s, convert_s, stages, shown


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--clip", default=os.path.join(ROOT, "tests", "data_torch", "vp9", "vp9_960x540x12.webm"))
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from super_resolution_tpu_torch.video import ivf, mkv, mp4

    data = open(args.clip, "rb").read()
    if ivf.is_ivf(data[:4]):
        payloads = ivf.read_ivf_video(data).frames
    elif mp4.is_iso_bmff(data[:12]):
        payloads = mp4.read_mp4_video(data).samples
    else:
        payloads = mkv.read_matroska_video(data).frames
    with tempfile.TemporaryDirectory() as directory:
        dll = build(directory)
        decode_s, convert_s, stages, shown = min((one_pass(dll, payloads) for _ in range(args.repeats)),
                                                 key=lambda r: r[0] + r[1])
    total = decode_s + convert_s
    rest = decode_s - stages.sum() / 1e9
    print(f"{os.path.basename(args.clip)}: {shown} frames, {1e3 * total / shown:.3f} ms a frame "
          f"({1e3 * decode_s / shown:.3f} to decode, {1e3 * convert_s / shown:.3f} to convert to BGR; fastest of "
          f"{args.repeats})")
    for name, ns in zip(STAGES, stages):
        print(f"  {name:20s} {ns / 1e6 / shown:8.3f} ms a frame  {100 * ns / 1e9 / total:5.1f} %")
    print(f"  {'rest of the decode':20s} {1e3 * rest / shown:8.3f} ms a frame  {100 * rest / total:5.1f} %")
    print(f"  {'BGR conversion':20s} {1e3 * convert_s / shown:8.3f} ms a frame  {100 * convert_s / total:5.1f} %")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
