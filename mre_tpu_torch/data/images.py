"""PNG coding and bicubic resizing in numpy + zlib, without PIL.

The JAX package decodes and resizes entity images with PIL
(mre_tpu/data/multimodal.py:86-136). The port reproduces those steps bit
for bit with numpy:

* ``decode_png`` — 8-bit greyscale / grey+alpha / RGB / RGBA, non-interlaced,
  scanline filters 0-4; alpha is blended onto white with PIL's
  ``alpha_composite`` integer arithmetic (AlphaComposite.c), then dropped;
* ``encode_png`` — RGB, filter 0 on every row;
* ``resize_bicubic`` — PIL's ``Image.resize(..., BICUBIC)`` (Resample.c): a
  = −0.5, support 2 scaled by the reduction factor when downsampling,
  coefficients normalised then rounded to 22-bit fixed point, a horizontal
  pass then a vertical pass, each rounded and clipped to uint8.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG colour type → samples per pixel
_PRECISION_BITS = 22                      # Resample.c, 8 bits per channel


# -- PNG ---------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:                                   # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:                                   # Sub: running sum per channel
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):                              # Average, Paeth
            cur = line.copy()
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(a, b, c)
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _blend_on_white(rgba: np.ndarray) -> np.ndarray:
    """PIL ``alpha_composite(white, img)`` for an opaque white background,
    RGB channels of the result."""
    a = rgba[..., 3:4].astype(np.uint32)
    src = rgba[..., :3].astype(np.uint32)
    # coef1 = a·255·255·128 / (255·255) = a·128; coef2 = (255 − a)·128
    tmp = src * (a << 7) + 255 * ((255 - a) << 7) + (0x80 << 7)
    out = (((tmp >> 8) + tmp) >> 8) >> 7
    return np.where(a == 0, 255, out).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 [H, W, 3] RGB, as PIL's decode + RGB conversion in
    mre_tpu/data/multimodal.py:_decode_image gives it."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG: unsupported bit depth {depth}, colour type "
                         f"{color} or interlace {interlace}")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if color == 0:
        return np.repeat(px, 3, axis=2)
    if color == 2:
        return px
    if color == 4:
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=2), px[..., 1:]], axis=2)
    return _blend_on_white(px)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] → PNG bytes (RGB, 8 bits, filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("encode_png takes [H, W, 3] RGB")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


# -- bicubic resize (PIL Resample.c) ------------------------------------------


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int):
    """precompute_coeffs + normalize_coeffs_8bpc: (first index [out],
    int64 fixed-point weights [out, ksize])."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:                       # summed in order, as in C
            ww += v
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            scaled = k * (1 << _PRECISION_BITS)
            kk[xx, x] = int(-0.5 + scaled) if k < 0 else int(0.5 + scaled)
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)          # [in, other, C]
    acc = np.einsum("okpc,ok->opc", src[idx], kk) + (1 << (_PRECISION_BITS - 1))
    out = np.where(acc >= (1 << _PRECISION_BITS << 8), 255,
                   np.where(acc <= 0, 0, acc >> _PRECISION_BITS)).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] → [height, width, C], PIL ``resize((width, height),
    Image.BICUBIC)`` exactly."""
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, axis=1)
    if height != img.shape[0]:
        out = _resample_axis(out, height, axis=0)
    return out
