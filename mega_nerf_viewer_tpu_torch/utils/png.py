"""Minimal dependency-free PNG writer (numpy and zlib only; a copy of
``mega_nerf_viewer_tpu/utils/png.py``, byte for byte the same output).

Analogue of the reference's libpng screenshot writer
(``src/imwrite.cpp:11-68``), which uses the fastest settings (compression
level 0, Huffman-only).  We mirror that choice literally: the default
encode path is a vectorized Up filter (numpy row diff) + zlib with
``Z_HUFFMAN_ONLY`` — no LZ77 match search, entropy coding only;
``compress_level=0`` stores uncompressed for callers that only care
about latency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _filter_compress(image: np.ndarray, compress_level: int) -> bytes:
    """Validate + filter + zlib-compress one uint8 frame.

    ``compress_level >= 1``: Up filter (vectorized row diff, modular
    uint8) + Huffman-only deflate — the reference's screenshot settings
    (``imwrite.cpp:36-38``: compression 0 strategy Huffman-only).
    ``compress_level == 0``: filter 0 + stored deflate blocks.
    """
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("PNG encoding expects uint8")
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError("PNG encoding expects [H, W, 3|4]")
    h, w, c = image.shape
    lines = np.empty((h, w * c + 1), np.uint8)
    if compress_level == 0:
        lines[:, 0] = 0                      # filter 0 (None)
        lines[:, 1:] = image.reshape(h, w * c)
        comp = zlib.compressobj(0)
    else:
        lines[:, 0] = 2                      # filter 2 (Up)
        flat = image.reshape(h, w * c)
        lines[0, 1:] = flat[0]
        np.subtract(flat[1:], flat[:-1],     # wraps mod 256
                    out=lines[1:, 1:])
        comp = zlib.compressobj(compress_level, zlib.DEFLATED, 15, 8,
                                zlib.Z_HUFFMAN_ONLY)
    return comp.compress(lines) + comp.flush()


def _ihdr(w: int, h: int, c: int) -> bytes:
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                       6 if c == 4 else 2, 0, 0, 0))


def encode_png(image: np.ndarray, compress_level: int = 1) -> bytes:
    """Encode an RGB(A) uint8 image ``[H, W, 3|4]`` to PNG bytes."""
    image = np.asarray(image)
    data = _filter_compress(image, compress_level)
    h, w, c = image.shape
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _ihdr(w, h, c),
        _chunk(b"IDAT", data),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, image: np.ndarray, compress_level: int = 1) -> bool:
    """Write an RGB(A) uint8 image ``[H, W, 3|4]`` as a PNG file."""
    try:
        with open(path, "wb") as f:
            f.write(encode_png(image, compress_level))
        return True
    except OSError:
        return False


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Reverse filters 0 (None) and 2 (Up) — the two the encoder emits."""
    lines = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    filt, body = lines[:, 0], lines[:, 1:]
    assert np.isin(filt, (0, 2)).all(), "only filters 0/2 supported"
    if (filt == 0).all():
        return body.reshape(h, w, c).copy()
    # Up runs: within each run, row = cumsum from the run's base row
    # (uint8 cumsum wraps mod 256, matching the filter's arithmetic;
    # an Up filter on row 0 uses the implicit zero row, so a run that
    # begins at the top cumsums from row 0 directly)
    out = body.copy()
    bounds = np.unique(np.concatenate(
        [[0], np.flatnonzero(filt == 0), [h]]))
    for a, b in zip(bounds[:-1], bounds[1:]):
        np.cumsum(out[a:b], axis=0, dtype=np.uint8, out=out[a:b])
    return out.reshape(h, w, c)


def decode_png(blob: bytes) -> np.ndarray:
    """Decode PNGs produced by :func:`encode_png` (tests only)."""
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit, color_type = struct.unpack(">IIBB", payload[:10])
            assert bit == 8
            c = 4 if color_type == 6 else 3
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    return _unfilter(zlib.decompress(idat), h, w, c)


def read_png(path: str) -> np.ndarray:
    """Read back PNGs written by :func:`write_png` (tests only)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


class ApngEncoder:
    """Incremental animated-PNG encoder for uint8 RGB(A) frames.

    New capability beyond the reference (which only writes single-frame
    screenshots, ``imwrite.cpp:11-68``): orbit-trajectory renders can
    ship as one self-playing file.  APNG keeps the PNG writer's
    dependency-free fast-path encoding (Up filter + Huffman-only); every
    frame is a full-frame replace (dispose 0 / blend source), the
    layout every browser plays.  Frames compress as they are added, so
    a long orbit holds ~MBs of compressed streams rather than the raw
    rgba8 series (~1 GB for 120 frames at 1080p).
    """

    def __init__(self, fps: float = 30.0, loops: int = 0,
                 compress_level: int = 1):
        self.fps = fps
        self.loops = loops
        self.compress_level = compress_level
        self._shape = None
        self._streams = []

    def add(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if self._shape is not None and frame.shape != self._shape:
            raise ValueError("all frames must be uint8 [H, W, C] of "
                             "one shape")
        stream = _filter_compress(frame, self.compress_level)
        # record the shape only once a frame is ACCEPTED — a rejected
        # first frame must not poison the shape check
        self._shape = frame.shape
        self._streams.append(stream)

    def tobytes(self) -> bytes:
        if not self._streams:
            raise ValueError("APNG needs at least one frame")
        h, w, c = self._shape
        # delay as a fraction over a 1000 denominator; the u16 numerator
        # caps the slowest playable rate at 65.535 s/frame
        delay_num = min(0xFFFF,
                        max(1, int(round(1000.0 / max(self.fps, 1e-3)))))
        out = [b"\x89PNG\r\n\x1a\n", _ihdr(w, h, c),
               _chunk(b"acTL", struct.pack(">II", len(self._streams),
                                           self.loops))]
        seq = 0
        for i, data in enumerate(self._streams):
            out.append(_chunk(b"fcTL", struct.pack(
                ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, 1000, 0, 0)))
            seq += 1
            if i == 0:
                # the first frame is also the default (still) image
                out.append(_chunk(b"IDAT", data))
            else:
                out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
                seq += 1
        out.append(_chunk(b"IEND", b""))
        return b"".join(out)

    def write(self, path: str) -> bool:
        try:
            with open(path, "wb") as f:
                f.write(self.tobytes())
            return True
        except OSError:
            return False


def encode_apng(frames, fps: float = 30.0, loops: int = 0,
                compress_level: int = 1) -> bytes:
    """Encode a list of frames as an animated PNG (see ApngEncoder)."""
    enc = ApngEncoder(fps, loops, compress_level)
    for f in frames:
        enc.add(f)
    return enc.tobytes()


def write_apng(path: str, frames, fps: float = 30.0, loops: int = 0,
               compress_level: int = 1) -> bool:
    """Write an animated PNG of uint8 RGB(A) frames."""
    try:
        with open(path, "wb") as f:
            f.write(encode_apng(frames, fps, loops, compress_level))
        return True
    except OSError:
        return False


def decode_apng(blob: bytes):
    """Decode APNGs produced by :func:`encode_apng` (tests only).

    Returns ``(frames, fps, loops)`` for full-frame dispose-0/blend-0
    animations (the only layout the encoder emits)."""
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = c = None
    fps, loops, n_frames = 30.0, 0, 1
    streams = []           # one compressed stream per frame
    expect_seq = 0
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit, color_type = struct.unpack(">IIBB", payload[:10])
            assert bit == 8
            c = 4 if color_type == 6 else 3
        elif tag == b"acTL":
            n_frames, loops = struct.unpack(">II", payload)
        elif tag == b"fcTL":
            (seq, fw, fh, x0, y0, dnum, dden, dispose,
             blend) = struct.unpack(">IIIIIHHBB", payload)
            assert seq == expect_seq, "fcTL out of sequence"
            expect_seq += 1
            assert (fw, fh, x0, y0) == (w, h, 0, 0), "sub-frame APNG"
            assert dispose == 0 and blend == 0
            fps = dden / max(dnum, 1)
            streams.append(b"")
        elif tag == b"IDAT":
            streams[-1] += payload
        elif tag == b"fdAT":
            (seq,) = struct.unpack(">I", payload[:4])
            assert seq == expect_seq, "fdAT out of sequence"
            expect_seq += 1
            streams[-1] += payload[4:]
        pos += 12 + length
    assert len(streams) == n_frames
    frames = [_unfilter(zlib.decompress(s), h, w, c) for s in streams]
    return frames, fps, loops
