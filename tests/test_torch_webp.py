"""The port's WebP codec against OpenCV on the same bytes, and the loaders
and ``super_resolve`` against the JAX package's, which read and write WebP
through OpenCV.

- Reading: ``decode_webp`` / ``read_image`` array-equal to
  ``cv2.imdecode(..., IMREAD_UNCHANGED)`` on files from OpenCV's and PIL's
  libwebp encoders -- VP8L with 1 to 256 colours and on noise, VP8 at
  qualities 10 to 95 and odd sizes, both with and without alpha, the VP8X
  form with metadata chunks; VP8 with the simple loop filter and 2 to 8
  token partitions from PIL's libwebp driven through its C API -- and on
  hand-built ``ALPH`` chunks with each filter and compression.
- Writing: ``encode_webp``'s lossless file decodes, through ``cv2.imdecode``
  and ``decode_webp``, to its input; the JAX loader reads it as it reads
  OpenCV's own file of the same image.
- ``super_resolve`` from a ``.webp`` truth to a ``.webp`` result: the JAX CLI
  and the port's (``--device cpu --dtype float64``) write files that decode
  to the same pixels.

Each seeded image is at most 64x80; torch runs on one thread."""

import contextlib
import ctypes
import glob
import io
import os
import struct

import cv2
import numpy as np
import pytest
import torch
import PIL
from PIL import Image

from super_resolution_tpu.cli import super_resolve as j_super_resolve
from super_resolution_tpu.utils.data_loader import load_image as j_load_image
from super_resolution_tpu.utils.data_loader import save_image as j_save_image
from super_resolution_tpu.video import VideoLoader as JVideoLoader

from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.cli import super_resolve
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import load_image, save_image
from super_resolution_tpu_torch.utils.webp import decode_webp, encode_webp
from super_resolution_tpu_torch.video import VideoLoader

CPU = dict(device="cpu", dtype=torch.float64)
SIZES = [(1, 1), (3, 5), (17, 23), (37, 53), (64, 80)]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch, tmp_path_factory):
    torch.set_num_threads(1)
    monkeypatch.setenv("SRTPU_COMPILE_CACHE", str(tmp_path_factory.getbasetemp() / "jax_cache"))
    monkeypatch.delenv("DISPLAY", raising=False)


def _noise(rng, h, w, c):
    return rng.integers(0, 256, (h, w, c)).astype(np.uint8)


def _smooth(rng, h, w, c):
    """A photograph-like image: smooth waves and some noise."""
    yy, xx = np.mgrid[:h, :w]
    planes = [128 + 100 * np.sin(xx / (5.0 + k)) * np.cos(yy / (7.0 + k)) for k in range(c)]
    return np.clip(np.stack(planes, -1) + rng.normal(0, 8, (h, w, c)), 0, 255).astype(np.uint8)


def _image(kind, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return _noise(rng, h, w, c) if kind == "noise" else _smooth(rng, h, w, c)


def _opencv(data: bytes):
    decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert decoded is not None
    return decoded


def _assert_like_opencv(data: bytes):
    ours, theirs = decode_webp(data), _opencv(data)
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    return ours


def _pil(image, **options):
    """PIL's libwebp encoder on a BGR / BGRA array."""
    rgb = image[..., [2, 1, 0, 3]] if image.shape[2] == 4 else image[..., ::-1]
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb)).save(out, "WEBP", **options)
    return out.getvalue()


def _chunks(data):
    pos, chunks = 12, []
    while pos < len(data):
        fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        chunks.append((fourcc, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return chunks


def _riff(chunks):
    body = b"WEBP" + b"".join(fourcc + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1) for fourcc, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8x(flags, w, h):
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")


# --- VP8L -------------------------------------------------------------------


@pytest.mark.parametrize("colours", [1, 2, 3, 4, 5, 16, 17, 256])
@pytest.mark.parametrize("alpha", [False, True])
def test_vp8l_colour_indexed_like_opencv(colours, alpha):
    """1 to 256 colours: the encoder's colour-indexing transform with 8, 4, 2
    and 1 pixels to the byte."""
    rng = np.random.default_rng(colours)
    palette = rng.integers(0, 256, (colours, 4 if alpha else 3)).astype(np.uint8)
    image = palette[rng.integers(0, colours, (29, 41))]
    assert _chunks(cv2.imencode(".webp", image)[1].tobytes())[0][0] == b"VP8L"
    _assert_like_opencv(cv2.imencode(".webp", image)[1].tobytes())
    _assert_like_opencv(_pil(image, lossless=True, method=6))


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("channels", [3, 4])
def test_vp8l_like_opencv(kind, size, channels):
    """Lossless files of noise and of a photograph-like scene hold their
    pixels (libwebp may change the colour of a pixel whose alpha is 0)."""
    image = _image(kind, *size, channels, seed=size[0] * 100 + size[1])
    data = cv2.imencode(".webp", image)[1].tobytes()
    decoded = _assert_like_opencv(data)
    visible = image[..., 3] > 0 if channels == 4 else np.ones(size, bool)
    np.testing.assert_array_equal(decoded[visible], image[visible])


@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("channels", [3, 4])
def test_vp8l_encoder_efforts_like_opencv(method, channels):
    """PIL's lossless efforts 0-6 reach the cross-colour transform, the colour
    cache and the meta prefix image; ``exact`` keeps colour under alpha 0."""
    image = _image("smooth", 64, 80, channels, seed=method)
    if channels == 4:
        image[::3, ::2, 3] = 0
    for options in (dict(lossless=True, method=method), dict(lossless=True, method=method, exact=True)):
        _assert_like_opencv(_pil(image, **options))


# --- VP8 --------------------------------------------------------------------


@pytest.mark.parametrize("quality", [10, 50, 75, 95])
@pytest.mark.parametrize("size", [(1, 1), (3, 5), (16, 16), (17, 23), (33, 47), (64, 80)])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_vp8_like_opencv(quality, size, kind):
    image = _image(kind, *size, 3, seed=quality + size[1])
    data = cv2.imencode(".webp", image, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
    assert _chunks(data)[0][0] == b"VP8 "
    _assert_like_opencv(data)


@pytest.mark.parametrize("quality", [10, 50, 95])
@pytest.mark.parametrize("size", [(1, 1), (17, 23), (37, 53), (64, 80)])
def test_vp8_with_alpha_like_opencv(quality, size):
    image = _image("smooth", *size, 4, seed=quality)
    data = cv2.imencode(".webp", image, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()
    assert [fourcc for fourcc, _ in _chunks(data)] == [b"VP8X", b"ALPH", b"VP8 "]
    assert _assert_like_opencv(data).shape == (*size, 4)


@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_vp8_encoder_efforts_like_opencv(method, alpha_quality):
    """PIL's lossy efforts (segments, partitions, filter strengths) and alpha
    qualities (raw and lossless-coded planes, level reduction)."""
    image = _image("smooth", 48, 64, 4, seed=method + alpha_quality)
    _assert_like_opencv(_pil(image, quality=60, method=method, alpha_quality=alpha_quality))
    _assert_like_opencv(_pil(np.ascontiguousarray(image[..., :3]), quality=40, method=method))


@pytest.mark.parametrize("lossless", [False, True])
def test_extended_file_with_metadata_like_opencv(lossless):
    """VP8X files whose ICCP and EXIF chunks are skipped."""
    image = _image("smooth", 31, 45, 4, seed=3)
    for img in (image, np.ascontiguousarray(image[..., :3])):
        data = _pil(img, lossless=lossless, quality=70, exif=b"Exif\0\0abcd", icc_profile=b"x" * 13)
        assert _chunks(data)[0][0] == b"VP8X"
        _assert_like_opencv(data)


def _libwebp():
    """The libwebp that PIL bundles, for encoder options PIL does not pass on."""
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    for helper in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
        ctypes.CDLL(helper, mode=ctypes.RTLD_GLOBAL)
    (path,) = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    lib = ctypes.CDLL(path)
    lib.WebPConfigInitInternal.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    return lib


def _libwebp_vp8(bgr, quality, method, partitions, filter_type, filter_strength):
    """A lossy file from libwebp's ``WebPEncode`` with the given ``WebPConfig``
    fields (every field is 4 bytes; the indices are those of ``encode.h``)."""
    lib, abi = _libwebp(), 0x020F
    config = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(config, 0, quality, abi)
    config[2], config[8], config[10], config[18] = method, filter_strength, filter_type, partitions
    assert lib.WebPValidateConfig(config)
    picture, writer = (ctypes.c_uint8 * 512)(), (ctypes.c_uint8 * 64)()
    assert lib.WebPPictureInitInternal(picture, abi)
    fields = ctypes.cast(picture, ctypes.POINTER(ctypes.c_int32))
    fields[2], fields[3] = bgr.shape[1], bgr.shape[0]  # width, height
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    assert lib.WebPPictureImportRGB(picture, rgb.ctypes.data_as(ctypes.c_void_p), 3 * bgr.shape[1])
    lib.WebPMemoryWriterInit(writer)
    hooks = ctypes.cast(ctypes.addressof(picture) + 96, ctypes.POINTER(ctypes.c_void_p))  # writer, custom_ptr
    hooks[0], hooks[1] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value, ctypes.addressof(writer)
    try:
        assert lib.WebPEncode(config, picture)
        size = ctypes.cast(ctypes.addressof(writer) + 8, ctypes.POINTER(ctypes.c_size_t))[0]
        return ctypes.string_at(ctypes.cast(writer, ctypes.POINTER(ctypes.c_void_p))[0], size)
    finally:
        lib.WebPPictureFree(picture)
        lib.WebPMemoryWriterClear(writer)


@pytest.mark.parametrize("partitions", [0, 1, 3])
@pytest.mark.parametrize("filter_type", [0, 1])
@pytest.mark.parametrize("quality", [15.0, 70.0])
def test_vp8_partitions_and_simple_filter_like_opencv(partitions, filter_type, quality):
    """libwebp at effort 0 writes the token partitions it is asked for (1, 2
    or 8 here), and filter type 0 is the simple loop filter: paths that
    neither OpenCV nor PIL reach at their defaults."""
    image = _image("smooth", 64, 80, 3, seed=partitions + 4 * filter_type)
    data = _libwebp_vp8(image, quality, 0, partitions, filter_type, 60)
    simple, level, count = _vp8_filter_and_partitions(_chunks(data)[0][1])
    assert (simple, count) == (filter_type == 0, 1 << partitions) and level > 0
    _assert_like_opencv(data)


def _vp8_filter_and_partitions(vp8):
    """(simple filter, filter level, token partitions) from a VP8 frame header,
    read with RFC 6386's boolean decoder."""
    data, state = vp8[10:], {"value": vp8[10] << 8 | vp8[11], "range": 255, "count": 0, "pos": 2}

    def bit(prob=128):
        split = 1 + (((state["range"] - 1) * prob) >> 8)
        one = state["value"] >= split << 8
        state["range"], state["value"] = ((state["range"] - split, state["value"] - (split << 8)) if one
                                          else (split, state["value"]))
        while state["range"] < 128:
            state["value"], state["range"], state["count"] = state["value"] << 1, state["range"] << 1, state["count"] + 1
            if state["count"] == 8:
                state["count"], state["pos"] = 0, state["pos"] + 1
                state["value"] |= data[state["pos"] - 1] if state["pos"] - 1 < len(data) else 0
        return int(one)

    def value(n, signed=False):
        v = sum(bit() << (n - 1 - i) for i in range(n))
        if signed:
            bit()  # the sign, not needed here
        return v

    bit(), bit()  # colour space, clamping
    if bit():  # segmentation
        update_map = bit()
        if bit():
            bit()
            for n in (7,) * 4 + (6,) * 4:
                if bit():
                    value(n, signed=True)
        if update_map:
            for _ in range(3):
                if bit():
                    value(8)
    simple, level = bit(), value(6)
    value(3)  # sharpness
    if bit() and bit():  # loop-filter deltas, updated
        for _ in range(8):
            if bit():
                value(6, signed=True)
    return bool(simple), level, 1 << value(2)


def _filtered(alpha, method):
    """An ALPH filter applied (the inverse of the decoder's unfiltering)."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) % 256).astype(np.uint8)


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filtering", [0, 1, 2, 3])
def test_hand_built_alpha_chunks_like_opencv(compression, filtering):
    """ALPH with each filter, raw and VP8L-compressed (the port's own VP8L
    stream, its 5-byte header dropped, the plane in green), and the level
    reduction flag set: libwebp and the port agree, and the plane comes back."""
    h, w = 21, 34
    rng = np.random.default_rng(filtering)
    alpha = np.clip(_smooth(rng, h, w, 1)[..., 0].astype(int) + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    coded = _filtered(alpha, filtering) if filtering else alpha
    if compression == 0:
        payload = coded.tobytes()
    else:
        green = np.zeros((h, w, 3), np.uint8)
        green[..., 1] = coded
        payload = _chunks(encode_webp(green))[0][1][5:]
    head = bytes([compression | filtering << 2 | 1 << 4])
    vp8 = _chunks(cv2.imencode(".webp", _image("smooth", h, w, 3, 9), [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes())
    data = _riff([_vp8x(0x10, w, h), (b"ALPH", head + payload), vp8[0]])
    np.testing.assert_array_equal(_assert_like_opencv(data)[..., 3], alpha)


def test_grey_reads_back_as_bgr_as_opencv(tmp_path):
    """OpenCV writes a grey image as BGR, so WebP reads back with three
    channels: the port's ``ImageData`` sees what the JAX loader's does."""
    grey = _image("smooth", 30, 41, 1, seed=4)[..., 0]
    for name, data in (("lossless", cv2.imencode(".webp", grey)[1].tobytes()),
                       ("lossy", cv2.imencode(".webp", grey, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes()),
                       ("port", encode_webp(grey))):
        path = str(tmp_path / f"{name}.webp")
        with open(path, "wb") as f:
            f.write(data)
        assert image_io.read_image(path).shape == (30, 41, 3)
        ours, theirs = load_image(path, **CPU), j_load_image(path)
        assert ours.total_num_channels == theirs.total_num_channels == 3
        np.testing.assert_array_equal(ours.hidden_array.numpy(), np.asarray(theirs.hidden_array))
    np.testing.assert_array_equal(decode_webp(encode_webp(grey)), np.repeat(grey[..., None], 3, 2))


# --- writing ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (7, 1), (17, 23, 3), (64, 80, 3), (37, 53)])
@pytest.mark.parametrize("kind", ["noise", "smooth", "flat"])
def test_encoder_round_trips_through_opencv(shape, kind):
    channels = shape[2] if len(shape) == 3 else 1
    image = _image("noise" if kind == "flat" else kind, shape[0], shape[1], channels, seed=len(shape))
    if kind == "flat":
        image[:] = 77
    image = image.reshape(shape)
    data = encode_webp(image)
    assert data[12:16] == b"VP8L" and len(data) % 2 == 0
    want = image if image.ndim == 3 else np.repeat(image[..., None], 3, 2)
    np.testing.assert_array_equal(_opencv(data), want)
    np.testing.assert_array_equal(decode_webp(data), want)


def test_saved_file_decodes_to_the_jax_loaders_pixels(tmp_path):
    """``save_image`` to ``.webp``: the port's file and the JAX package's
    (``cv2.imwrite``) differ in bytes and decode, through OpenCV and through
    the port, to the same pixels; the JAX loader reads both alike."""
    source = str(tmp_path / "source.png")
    cv2.imwrite(source, _image("smooth", 40, 56, 3, seed=8))
    theirs, ours = str(tmp_path / "jax.webp"), str(tmp_path / "port.webp")
    j_save_image(j_load_image(source), theirs)
    save_image(load_image(source, **CPU), ours)
    their_bytes, our_bytes = open(theirs, "rb").read(), open(ours, "rb").read()
    assert their_bytes != our_bytes
    pixels = _opencv(their_bytes)
    for decoded in (_opencv(our_bytes), decode_webp(our_bytes), image_io.read_image(ours)):
        np.testing.assert_array_equal(decoded, pixels)
    np.testing.assert_array_equal(np.asarray(j_load_image(ours).hidden_array),
                                  np.asarray(j_load_image(theirs).hidden_array))


# --- refusals ---------------------------------------------------------------


def test_animated_webp_raises_naming_itself():
    frames = [_image("noise", 12, 16, 3, seed=k) for k in range(3)]
    out = io.BytesIO()
    Image.fromarray(frames[0][..., ::-1]).save(out, "WEBP", save_all=True, lossless=True,
                                               append_images=[Image.fromarray(f[..., ::-1]) for f in frames[1:]])
    data = out.getvalue()
    np.testing.assert_array_equal(_opencv(data)[..., :3], frames[0])  # OpenCV: the first frame
    with pytest.raises(NotImplementedError, match="Animated WebP"):
        decode_webp(data)


@pytest.mark.parametrize("lossless", [False, True])
def test_corrupt_and_truncated_files_raise(lossless):
    image = _image("smooth", 20, 30, 3, seed=5)
    data = cv2.imencode(".webp", image, [] if lossless else [cv2.IMWRITE_WEBP_QUALITY, 50])[1].tobytes()
    with pytest.raises(ValueError, match="truncated"):
        decode_webp(data[:-7])
    with pytest.raises(ValueError, match="Not a WebP"):
        decode_webp(b"RIFX" + data[4:])
    broken = bytearray(data)
    if lossless:
        broken[20] ^= 0xFF  # the signature
    else:
        broken[23:26] = b"\0\0\0"  # the key-frame start code
    with pytest.raises(ValueError, match="header"):
        decode_webp(bytes(broken))


@pytest.mark.parametrize("lossless", [False, True])
def test_no_compiler_means_no_webp_codec(monkeypatch, tmp_path, lossless):
    """There is no second codec: without a C++ compiler (and no library built
    yet) reading or writing WebP raises, naming the compiler."""
    image = _image("smooth", 8, 8, 3, seed=1)
    data = cv2.imencode(".webp", image, [] if lossless else [cv2.IMWRITE_WEBP_QUALITY, 50])[1].tobytes()
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_library_path", lambda source=None: tmp_path / "absent.so")
    for codec, argument in ((decode_webp, data), (encode_webp, image)):
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            codec(argument)


# --- the loaders and the CLI ------------------------------------------------


def test_video_loader_reads_a_webp_frame_directory_as_jax(tmp_path):
    for k in range(3):
        image = _image("smooth", 28, 36, 3, seed=20 + k)
        params = [] if k == 0 else [cv2.IMWRITE_WEBP_QUALITY, 40 + 20 * k]
        assert cv2.imwrite(str(tmp_path / f"frame_{k}.webp"), image, params)
    ours, theirs = VideoLoader(**CPU), JVideoLoader()
    ours.load_frames_from_directory(str(tmp_path))
    theirs.load_frames_from_directory(str(tmp_path))
    assert ours.num_frames == theirs.num_frames == 3 and ours.image_size == theirs.image_size == (36, 28)
    for a, b in zip(ours.get_frames(), theirs.get_frames()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_super_resolve_from_and_to_webp_as_jax(tmp_path):
    """A ``.webp`` truth (OpenCV's lossless file of a grey scene, so BGR) to a
    ``.webp`` result: the two CLIs' files decode to the same pixels."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:32, :32]
    scene = np.clip(0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.1 * rng.random((32, 32)), 0, 1)
    cv2.imwrite(str(tmp_path / "truth.webp"), (scene * 255).astype(np.uint8))
    (tmp_path / "shifts.txt").write_text("0 0\n1 1\n0 1\n1 0\n")
    argv = ["--data_path", str(tmp_path / "truth.webp"), "--generate_lr_images", "--motion_sequence_path",
            str(tmp_path / "shifts.txt"), "--upsampling_scale", "2", "--solver", "linear_cg",
            "--optimization_iterations", "2", "--solver_iterations", "10", "--evaluators", "psnr"]
    for side, main, extra in (("jax", j_super_resolve.main, []),
                              ("port", super_resolve.main, ["--device", "cpu", "--dtype", "float64"])):
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + extra + ["--result_path", str(tmp_path / f"{side}.webp")]) == 0
    theirs, ours = (open(tmp_path / f"{side}.webp", "rb").read() for side in ("jax", "port"))
    pixels = _opencv(theirs)
    assert pixels.shape == (32, 32, 3)
    np.testing.assert_array_equal(_opencv(ours), pixels)
    np.testing.assert_array_equal(decode_webp(ours), pixels)
