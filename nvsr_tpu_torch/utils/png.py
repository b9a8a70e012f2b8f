"""8-bit PNG reading and writing with zlib and struct only.

The eval path of the JAX package reads the dataset's PNGs and writes its
results through `imageio`; the port reads and writes them here, so a
machine without imageio (or PIL) runs it. Covered: 8 bits per sample,
no interlacing, grayscale ([H, W]), RGB ([H, W, 3]) and RGBA
([H, W, 4]) -- what Blender-style datasets and `ExperimentLogger` hold.
Reading undoes all five PNG row filters; writing uses filter 0 (none) on
every row. Anything else raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    """Yield (type, payload) for each chunk after the signature."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        yield kind, payload
        if kind == b"IEND":
            return


def _header(payload: bytes):
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", payload)
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    return h, w, _CHANNELS[ctype]


def read_dims(path: str):
    """(H, W) of a PNG from its header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    kinds = list(_chunks(head))
    if not kinds or kinds[0][0] != b"IHDR":
        raise ValueError(f"{path}: no IHDR chunk")
    w, h = struct.unpack(">II", kinds[0][1][:8])
    return h, w


def _paeth_or_average(line: bytearray, prior: bytes, bpp: int,
                      paeth: bool) -> None:
    """Undo filter 3 (average) or 4 (Paeth) in place: each byte depends
    on the one bpp to its left, so this walks the row."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        if paeth:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        line[i] = (line[i] + pred) & 0xFF


def imread(path: str) -> np.ndarray:
    """Read a PNG -> uint8 [H, W] (grayscale) or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    h = w = ch = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            h, w, ch = _header(payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if h is None:
        raise ValueError(f"{path}: no IHDR chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * ch
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            rec = line
        elif ftype == 1:       # sub: running sum of each channel, mod 256
            rec = np.cumsum(line.reshape(w, ch), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ftype == 2:       # up
            rec = line + prior
        elif ftype in (3, 4):  # average, Paeth
            buf = bytearray(line.tobytes())
            _paeth_or_average(buf, prior.tobytes(), ch, ftype == 4)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter {ftype}")
        out[y] = rec
        prior = out[y]
    img = out.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + \
        struct.pack(">I", crc)


def imwrite(path: str, image) -> None:
    """Write a uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] image as
    a PNG (filter 0 on every row)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if img.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))
