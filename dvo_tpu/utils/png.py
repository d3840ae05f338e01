"""PNG read and write with numpy and ``zlib`` only.

The native data plane (``dvo_tpu.native``, libpng) is the fast decode path;
this module is the decoder the host falls back to where the native library
cannot be built, and the encoder the synthetic sequence generator
(``utils/synth.py``) writes with.  It covers what the datasets hold:
non-interlaced 8-bit gray, gray+alpha, RGB, RGBA and palette images, and
16-bit gray (depth).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel by PNG colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write a (H, W) uint8/uint16 gray or (H, W, 3) uint8 RGB image.
    Rows are stored unfiltered; ``level`` is the zlib compression level."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color = 2
    else:
        raise ValueError(f"write_png takes gray or 8-bit RGB, got {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to (H, W) or (H, W, C) uint8/uint16 samples; palette
    images come back as (H, W, 3) RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise IOError(f"{path}: not a PNG file")
    pos, idat, palette, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise IOError(f"{path}: no IHDR chunk")
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if interlace != 0 or depth not in (8, 16) or color not in _CHANNELS:
        raise IOError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace})"
        )
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise IOError(f"{path}: truncated image data")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, cur = raw[y, 0], raw[y, 1:]
        if ft == 0:
            row = cur.copy()
        elif ft == 1:      # Sub: running sum over same-channel bytes
            row = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
        elif ft == 2:      # Up
            row = cur + prev
        elif ft in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(cur.tobytes())
            (_average_row if ft == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise IOError(f"{path}: bad filter type {ft} in row {y}")
        out[y] = row
        prev = out[y]
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = out.reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise IOError(f"{path}: palette image without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def decode_gray(path: str) -> np.ndarray:
    """Decode to float32 gray with the native decoder's semantics: gray and
    16-bit samples raw, colour as the cv::cvtColor BGR2GRAY luma
    0.299 R + 0.587 G + 0.114 B (alpha ignored)."""
    img = read_png(path)
    if img.ndim == 2:
        return img.astype(np.float32)
    if img.shape[2] == 2:   # gray + alpha
        return img[..., 0].astype(np.float32)
    rgb = img[..., :3].astype(np.float32)
    return (np.float32(0.299) * rgb[..., 0] + np.float32(0.587) * rgb[..., 1]
            + np.float32(0.114) * rgb[..., 2])


def png_size(path: str):
    """(height, width) from the IHDR chunk only."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise IOError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w
