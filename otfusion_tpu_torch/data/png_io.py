"""PNG reading and writing, and PIL's bilinear resize, without PIL.

The JAX package's GAMMA loader reads each fundus photograph with
``Image.open(path).convert("RGB")`` and shrinks it with
``resize((s, s), Image.BILINEAR)``; the machine the port runs on has no PIL,
so these are the port's own:

  * ``read_png`` decodes a non-interlaced PNG to uint8 (H, W, 3) as
    ``convert("RGB")`` does: greyscale at 1, 2, 4 or 8 bits (scaled to 8
    bits and repeated over three channels), grey+alpha and RGBA (alpha
    dropped), RGB, and palette images at 1, 2, 4 or 8 bits (looked up in
    ``PLTE``). All five row filters. Anything else (16-bit samples,
    interlacing) raises ``ValueError`` naming the format;
  * ``write_png`` encodes a uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4)
    array with filter 0 on every row;
  * ``resize_bilinear_uint8`` is PIL's ``BILINEAR`` resize of a uint8
    image: a triangle filter widened by the scale when it shrinks (so it
    antialiases), in two separable passes with fixed-point weights, each
    rounded to uint8. PyTorch's ``interpolate(mode="bilinear",
    antialias=True)`` on a CPU uint8 tensor implements that filter; its
    fixed-point rounding matches PIL's bit for bit at 512 -> 384, 300 ->
    384 and integer ratios, and lies at most one grey level from it
    elsewhere (97 -> 32, 2000 -> 384);
  * ``resize_lanczos_uint8`` is PIL's ``LANCZOS`` resize of a uint8
    greyscale (mode ``L``) or RGB image, bit for bit: PIL's
    ``ImagingResample`` written out in numpy integer arithmetic (PyTorch's
    ``interpolate`` has no Lanczos mode).

Rows whose filter reads the reconstructed left neighbour non-linearly
(Average, Paeth) are decoded along anti-diagonals: pixel (r, x) depends on
(r, x-1), (r-1, x) and (r-1, x-1) only, so each anti-diagonal is one
vectorised step.
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples per pixel)
_COLOUR_TYPES = {0: ("greyscale", 1), 2: ("RGB", 3), 3: ("palette", 1),
                 4: ("grey+alpha", 2), 6: ("RGBA", 4)}
_SUB_BYTE = (1, 2, 4)


def _chunks(data: bytes, path):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _unfilter_rows(raw: np.ndarray, height: int, row_bytes: int,
                   bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (height rows of 1 + row_bytes
    bytes); returns (height, row_bytes) uint8."""
    rows = raw.reshape(height, row_bytes + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of "
                         "the five PNG filters")
    filt = rows[:, 1:].reshape(height, row_bytes // bpp, bpp)
    if np.isin(kinds, (3, 4)).any():
        return _unfilter_wavefront(filt, kinds).reshape(height, row_bytes)
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for r in range(height):
        row = filt[r]
        if kinds[r] == 1:    # Sub: a running sum along the row, mod 256
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif kinds[r] == 2:  # Up
            row = row + prev
        out[r] = prev = row
    return out.reshape(height, row_bytes)


def _unfilter_wavefront(filt: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """All five filters at once, one anti-diagonal of pixels per step;
    ``filt`` is (H, P, bpp) with P pixels (bytes when below 8 bits)."""
    h, p, _ = filt.shape
    # out[r + 1, x + 1] holds pixel (r, x); row 0 and column 0 are the zero
    # neighbours of the first row and column.
    out = np.zeros((h + 1, p + 1, filt.shape[2]), np.int16)
    filt = filt.astype(np.int16)
    kind_of_row = kinds.astype(np.int16)
    for k in range(h + p - 1):
        r = np.arange(max(0, k - p + 1), min(h - 1, k) + 1)
        x = k - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        kind = kind_of_row[r][:, None]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) // 2, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, row_bytes) packed samples of ``depth`` bits -> (H, width)."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1)
    h = rows.shape[0]
    per = bits[:, : (bits.shape[1] // depth) * depth].reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (per * weights).sum(axis=2).astype(np.uint8)[:, :width]


def read_png(path: str | Path) -> np.ndarray:
    """Decode the PNG at ``path`` to uint8 (H, W, 3), as PIL's
    ``Image.open(path).convert("RGB")`` gives it."""
    data = Path(path).read_bytes()
    header = palette = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _COLOUR_TYPES:
        raise ValueError(f"{path}: PNG colour type {colour} is unknown")
    name, samples = _COLOUR_TYPES[colour]
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) {name} PNG is not "
                         "supported; only non-interlaced PNGs are")
    if depth != 8 and not (depth in _SUB_BYTE and colour in (0, 3)):
        raise ValueError(f"{path}: {depth}-bit {name} PNG is not supported; "
                         "only 8-bit samples (and 1, 2, 4-bit greyscale or "
                         "palette) are")
    row_bytes = (width * samples * depth + 7) // 8
    bpp = max(1, samples * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = _unfilter_rows(raw[: height * (row_bytes + 1)], height, row_bytes,
                          bpp)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG has no PLTE chunk")
        index = _unpack_bits(rows, width, depth)
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette
        return full[index]
    if colour == 0:
        grey = _unpack_bits(rows, width, depth)
        if depth != 8:
            grey = (grey.astype(np.uint16) * 255 // ((1 << depth) - 1)
                    ).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    pixels = rows.reshape(height, width, samples)
    if colour == 4:
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Encode a uint8 (H, W) or (H, W, C) image, C in 1, 3 or 4
    (greyscale, RGB, RGBA), as an 8-bit PNG with filter 0 on every row."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    colour = {1: 0, 3: 2, 4: 6}.get(image.shape[2])
    if image.ndim != 3 or colour is None:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1|3|4) images, "
                         f"got shape {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b""))


def resize_bilinear_uint8(image: np.ndarray, size: int) -> np.ndarray:
    """PIL's ``resize((size, size), Image.BILINEAR)`` of a uint8 (H, W, 3)
    image: antialiased when it shrinks, rounded to uint8 after each pass;
    an image already of that size comes back as a copy, as PIL returns
    it."""
    if image.shape[:2] == (size, size):
        return np.array(image, copy=True)
    t = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    out = F.interpolate(t.contiguous(memory_format=torch.channels_last),
                        size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).contiguous().numpy()


_PRECISION_BITS = 32 - 8 - 2


def _lanczos(x: float) -> float:
    """PIL's Lanczos filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v
    return sinc(x) * sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` with support 3 and
    ``normalize_coeffs_8bpc``: each output's first input, and its weights
    (out_size, ksize) in 22-bit fixed point (int64, zero past its run)."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        total = 0.0
        for w in k:
            total += w
        k = [w / total if total != 0.0 else w for w in k]
        first[xx] = xmin
        weights[xx, :xmax] = [int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0
                              else int(0.5 + w * (1 << _PRECISION_BITS))
                              for w in k]
    return first, weights


def _resample_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's resample along ``axis`` of a uint8 array:
    fixed-point sums, rounded at half, clipped to uint8."""
    first, weights = _lanczos_coeffs(image.shape[axis], out_size)
    moved = np.moveaxis(image, axis, 0).astype(np.int64)
    taps = np.minimum(first[:, None] + np.arange(weights.shape[1]),
                      image.shape[axis] - 1)
    gathered = moved[taps]      # (out, ksize, ...)
    w = weights.reshape(weights.shape + (1,) * (moved.ndim - 1))
    acc = (1 << (_PRECISION_BITS - 1)) + (gathered * w).sum(axis=1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos_uint8(image: np.ndarray, size: int) -> np.ndarray:
    """PIL's ``Image.fromarray(image).resize((size, size), LANCZOS)`` of a
    uint8 (H, W) greyscale or (H, W, 3) RGB image, bit for bit: the
    horizontal pass first, then the vertical, each only where the size
    changes; an image already of that size comes back as a copy."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError("resize_lanczos_uint8 takes uint8 (H, W) or "
                         f"(H, W, 3) images, got {image.dtype} {image.shape}")
    out = np.array(image, copy=True)
    if out.shape[1] != size:
        out = _resample_axis(out, size, 1)
    if out.shape[0] != size:
        out = _resample_axis(out, size, 0)
    return out
