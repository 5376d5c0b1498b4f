"""Headless image output (torch counterpart of tracer/utils/image.py):
frames are written as PNGs by a dependency-free encoder over the standard
library's zlib, and read back by a reader of the same files."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def tonemap(linear_rgb: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear HDR -> uint8 (a gamma curve and a clamp)."""
    x = np.clip(np.asarray(linear_rgb, np.float32), 0.0, 1.0)
    return (np.power(x, 1.0 / gamma) * 255.0 + 0.5).astype(np.uint8)


def tonemap_torch(linear_rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """tonemap on the tensor's own device -> a uint8 tensor, so that a frame
    is read back as a quarter of the bytes of its float32 image."""
    x = torch.clamp(linear_rgb, 0.0, 1.0)
    return (x ** (1.0 / gamma) * 255.0 + 0.5).to(torch.uint8)


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG."""
    rgb8 = np.asarray(rgb8)
    if rgb8.dtype != np.uint8 or rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError(f"write_png takes an (H, W, 3) uint8 array, got {rgb8.dtype} "
                         f"{rgb8.shape}")
    h, w = rgb8.shape[:2]
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG with rows filtered by None or Up (what
    write_png writes) -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, w = 8, 0
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, _h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError(f"{path}: only 8-bit RGB is read, got depth {depth}, "
                                 f"colour type {ctype}")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(len(raw) // stride):
        filt = raw[y * stride]
        row = np.frombuffer(raw[y * stride + 1:(y + 1) * stride], np.uint8).copy()
        if filt == 2:  # Up
            row = (row.astype(np.int16) + prev).astype(np.uint8)
        elif filt != 0:
            raise ValueError(f"unsupported PNG filter {filt}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(-1, w, 3)
