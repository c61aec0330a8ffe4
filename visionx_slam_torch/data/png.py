"""A small PNG codec on ``zlib`` and numpy, for the formats a TUM RGB-D
sequence has: 8-bit gray, 8-bit RGB and 16-bit gray, non-interlaced. It
takes the place of ``cv2.imread``/``cv2.imwrite`` in the port (the GPU host
has no cv2).

Reading undoes all five scanline filters. None, Sub and Up are vectorised
over whole runs of rows (Sub and Up are running sums modulo 256); Average
and Paeth depend on the pixel to the left within a row and are decoded
byte by byte, which is slow (about a second for a 640x480 RGB image) but
correct. The writer uses filter None only, so what the port writes decodes
fast here; files from other encoders mostly take the Sub or mixed paths.

``rgb_to_gray`` is OpenCV's ``COLOR_BGR2GRAY``/``RGB2GRAY`` for 8-bit
images, which is fixed point: ``(9798 R + 19235 G + 3735 B + 16384) >> 15``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY, _RGB = 0, 2       # PNG colour types
_GRAY_WEIGHTS = np.array([9798, 19235, 3735], np.int32)    # R, G, B (of 2^15)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 255
    return out


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Scanlines [height, 1 + stride] (filter byte first) -> bytes
    [height, stride]."""
    lines = raw.reshape(height, 1 + stride)
    ftype = lines[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: unknown scanline filter")
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    # runs of rows with one filter: a run starts where the filter changes,
    # and an Average or Paeth row is a run of its own
    starts = np.flatnonzero(np.r_[True, (ftype[1:] != ftype[:-1])
                                  | (ftype[1:] > 2)]).tolist()
    for y, end in zip(starts, starts[1:] + [height]):
        f = int(ftype[y])
        block = lines[y:end, 1:]
        if f == 0:
            out[y:end] = block
        elif f == 1:     # Sub: a running sum along the row, per channel
            out[y:end] = np.cumsum(
                block.reshape(end - y, stride // bpp, bpp), axis=1,
                dtype=np.uint8).reshape(end - y, stride)
        elif f == 2:     # Up: a running sum down the rows
            out[y:end] = np.cumsum(np.concatenate([prior[None], block]),
                                   axis=0, dtype=np.uint8)[1:]
        else:
            row = _average_row if f == 3 else _paeth_row
            out[y] = np.frombuffer(
                row(block[0].tobytes(), prior.tobytes(), bpp), np.uint8)
        prior = out[end - 1]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode ``path``: [H,W] uint8 (8-bit gray), [H,W,3] uint8 in RGB order
    (8-bit RGB) or [H,W] uint16 (16-bit gray). Raises ``FileNotFoundError``
    where the file is missing and ``ValueError`` for any other PNG flavour
    (palette, alpha, interlaced, other bit depths) or a damaged file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"PNG without IHDR or IDAT: {path}")
    width, height, depth, colour, _, _, interlace = header
    if interlace or (depth, colour) not in ((8, _GRAY), (8, _RGB), (16, _GRAY)):
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}): {path}")
    bpp = {(8, _GRAY): 1, (8, _RGB): 3, (16, _GRAY): 2}[(depth, colour)]
    stride = width * bpp
    # the whole image in one inflate call: each call of a growing buffer
    # gives the interpreter lock up and takes it back
    raw = np.frombuffer(zlib.decompress(b"".join(idat),
                                        bufsize=height * (1 + stride)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"PNG data of the wrong length: {path}")
    px = _unfilter(raw, height, stride, bpp)
    if depth == 16:      # samples are big-endian
        return px.view(">u2").astype(np.uint16).reshape(height, width)
    return px.reshape(height, width, 3) if colour == _RGB else px


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 3) -> None:
    """Encode [H,W] uint8, [H,W,3] uint8 (RGB order) or [H,W] uint16 as a
    non-interlaced PNG with filter None on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        depth, colour, rows = 8, _GRAY, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, colour, rows = 8, _RGB, img.reshape(img.shape[0], -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, colour = 16, _GRAY
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write {img.dtype} {img.shape} as PNG")
    height, width = img.shape[:2]
    lines = np.zeros((height, 1 + rows.shape[1]), np.uint8)
    lines[:, 1:] = rows
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                            colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(lines.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """[H,W,3] uint8 (RGB order) -> [H,W] uint8, OpenCV's fixed-point
    weights, in four numpy calls (each gives the interpreter lock up and
    takes it back once)."""
    s = np.matmul(rgb, _GRAY_WEIGHTS)
    s += 16384
    s >>= 15
    return s.astype(np.uint8)
