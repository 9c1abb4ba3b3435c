"""MPEG transport streams (ISO/IEC 13818-1 2.4: .ts, and the 192-byte packets
of .m2ts / .mts, whose 4-byte prefix is skipped): the first video stream's
elementary stream, as ``cv2.VideoCapture`` (FFmpeg's ``mpegts`` demuxer)
delivers it.

:func:`read_transport_stream` reads the program association table (PID 0),
then the first program's map table, takes its first video elementary stream
by ``stream_type`` and joins the payloads of that PID's PES packets,
reassembled across transport packets (adaptation fields skipped, a PES packet
begun where ``payload_unit_start_indicator`` is set, cut at its
``PES_packet_length`` where it has one). Data of the PID before its first
PES start is dropped, as FFmpeg drops it, so a file cut between packets
decodes from the first whole PES packet; a packet repeated with its
continuity counter (a duplicate) is dropped. The stream types read:

- 0x01 (MPEG-1 video) and 0x02 (MPEG-2 video): :mod:`super_resolution_tpu_torch.utils.mpeg2`;
- 0x1B (H.264, Annex B): :mod:`super_resolution_tpu_torch.utils.h264`;
- 0x10 (MPEG-4 Part 2): :mod:`super_resolution_tpu_torch.utils.mpeg4`.

A program whose map names no video type but a stream of private data
(0x06) whose PES packets are video (``stream_id`` 0xE0-0xEF) -- what
FFmpeg's muxer writes for MPEG-1 video in .m2ts -- gives that stream, whose
codec FFmpeg tells by probing and the reader by its start codes
(``stream_type`` 0x06 in :class:`TransportStream`). Any other video type
(0x24 HEVC, 0xEA VC-1, ...) raises ``NotImplementedError`` naming it, and so
does a continuity counter that jumps (packets lost or a damaged file) where
the packet's adaptation field does not set ``discontinuity_indicator``: a
jump it signals (a splice) is read on, as FFmpeg reads it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from super_resolution_tpu_torch.video.mpegps import (PRIVATE_DATA, READ_STREAM_TYPES, STREAM_TYPES, pes_payload,
                                                     stream_codec)

__all__ = ["PRIVATE_DATA", "READ_STREAM_TYPES", "STREAM_TYPES", "TransportStream", "packet_size",
           "read_transport_stream"]

SYNC = 0x47


def packet_size(head: bytes) -> int:
    """188 or 192 where a file starting with ``head`` is a transport stream (sync bytes at 0, 188, 376 or, after
    the 4-byte prefix of .m2ts, at 4, 196, 388), else 0. A file of fewer packets needs its sync bytes at each."""
    for size, first in ((188, 0), (192, 4)):
        positions = [first + k * size for k in range(3) if first + k * size < len(head)]
        if len(head) > first and all(head[p] == SYNC for p in positions):
            return size
    return 0


@dataclass
class TransportStream:
    """The first video stream of the first program: its ``stream_type`` and elementary stream."""

    stream_type: int
    es: bytes

    def codec(self) -> str | None:
        """The decoder of the stream (:func:`super_resolution_tpu_torch.video.mpegps.stream_codec`)."""
        return stream_codec(self.stream_type, self.es, "MPEG transport stream")


def _packets(data: bytes, size: int):
    """(PID, payload_unit_start_indicator, continuity counter, discontinuity_indicator, payload or None) of each
    transport packet."""
    start = size - 188
    for pos in range(start, len(data) - 187, size):
        if data[pos] != SYNC:
            raise ValueError(f"MPEG transport packet at byte {pos} without its sync byte.")
        b1, b2, b3 = data[pos + 1], data[pos + 2], data[pos + 3]
        pid, pusi, control, counter = ((b1 & 0x1F) << 8) | b2, bool(b1 & 0x40), (b3 >> 4) & 3, b3 & 15
        p, discontinuity = pos + 4, False
        if control & 2:  # an adaptation field: its flags' first bit signals a counter that may jump
            discontinuity = data[p] > 0 and bool(data[p + 1] & 0x80)
            p += 1 + data[p]
        payload = data[p:pos + 188] if control & 1 and p < pos + 188 else None
        yield pid, pusi, counter, discontinuity, payload


def _sections(data: bytes, size: int, pid: int):
    """The sections (from ``table_id`` on) carried on ``pid``, each whole, in file order."""
    buf = None
    for p, pusi, _, _, payload in _packets(data, size):
        if p != pid or payload is None:
            continue
        if pusi:
            buf = bytearray(payload[1 + payload[0]:])  # after the pointer field
        elif buf is not None:
            buf += payload
        while buf is not None and len(buf) >= 3 and buf[0] != 0xFF:
            length = 3 + (((buf[1] & 0x0F) << 8) | buf[2])
            if len(buf) < length:
                break
            yield bytes(buf[:length])
            buf = buf[length:]


def _program_map_pid(data: bytes, size: int) -> int:
    for section in _sections(data, size, 0):
        if section[0] != 0x00:
            continue
        end = len(section) - 4  # the CRC
        for p in range(8, end - 3, 4):
            number, pid = struct.unpack(">HH", section[p:p + 4])
            if number:  # 0: the network PID
                return pid & 0x1FFF
    raise ValueError("MPEG transport stream without a program association table naming a program.")


def _video_stream(data: bytes, size: int, pmt_pid: int) -> tuple[int, int]:
    """(PID, stream_type) of the program map's first video elementary stream, else of its first private-data
    stream (checked to carry video when its PES packets are reassembled)."""
    for section in _sections(data, size, pmt_pid):
        if section[0] != 0x02:
            continue
        info = ((section[10] & 0x0F) << 8) | section[11]
        p, end, streams = 12 + info, len(section) - 4, []
        while p + 5 <= end:
            kind, pid, es_info = section[p], ((section[p + 1] & 0x1F) << 8) | section[p + 2], \
                ((section[p + 3] & 0x0F) << 8) | section[p + 4]
            streams.append((pid, kind))
            p += 5 + es_info
        for pid, kind in streams:
            if kind in STREAM_TYPES:
                return pid, kind
        for pid, kind in streams:
            if kind == PRIVATE_DATA:
                return pid, kind
        raise ValueError("MPEG transport stream whose program has no video stream.")
    raise ValueError("MPEG transport stream without its program map table.")


def read_transport_stream(data: bytes, size: int = 188) -> TransportStream:
    """The first video stream of the transport stream (``size``-byte packets) held in ``data``."""
    pid, kind = _video_stream(data, size, _program_map_pid(data, size))
    if kind != PRIVATE_DATA:
        stream_codec(kind, b"", "MPEG transport stream")  # a type the port does not read: refused before reassembly
    pes, out, last, index = None, [], None, 0

    def close():
        if pes is None or len(pes) < 6:
            return
        if kind == PRIVATE_DATA and not 0xE0 <= pes[3] <= 0xEF:
            raise ValueError("MPEG transport stream whose program has no video stream.")
        (length,) = struct.unpack(">H", pes[4:6])
        end = min(6 + length, len(pes)) if length else len(pes)
        out.append(pes[pes_payload(pes, 0, end):end])

    for p, pusi, counter, discontinuity, payload in _packets(data, size):
        index += 1
        if p != pid or payload is None:
            continue
        if last is not None and counter != (last + 1) & 15 and not discontinuity:
            if counter == last:
                continue  # a duplicate packet
            raise NotImplementedError(f"MPEG transport stream whose continuity counter jumps from {last} to {counter} "
                                      f"on PID 0x{pid:X} at packet {index - 1} (packets lost or damaged) is not "
                                      "supported by the port's video reader.")
        last = counter
        if pusi:
            close()
            pes = bytearray(payload)
        elif pes is not None:
            pes += payload
    close()
    return TransportStream(kind, b"".join(out))
