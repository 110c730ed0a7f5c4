"""A pure-NumPy DICOM series reader (port of
``otfusion_tpu.data.dicom_io``), for ``cli/data_tools.py convert`` where
dcm2niix is not installed; pydicom is not needed.

It parses Part-10 files in the UNCOMPRESSED little-endian transfer syntaxes
(implicit 1.2.840.10008.1.2 and explicit 1.2.840.10008.1.2.1) for what
volume assembly needs: the geometry tags, the rescale and PixelData.
Compressed syntaxes (JPEG, RLE) raise with the advice to install dcm2niix.
Not a general DICOM library: no character sets, no palettes, single-frame
slices only.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from otfusion_tpu_torch.data.nifti_io import write_nifti

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"

# VRs whose explicit-VR encoding uses a 2-byte reserved field + 4-byte
# length (PS3.5 §7.1.2).
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UC", b"UR",
             b"UT", b"UN"}

_UNDEFINED = 0xFFFFFFFF

# (group, element) -> name for the tags volume assembly needs
_TAGS = {
    (0x0008, 0x0018): "sop_instance_uid",
    (0x0010, 0x0020): "patient_id",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x0032): "image_position",
    (0x0020, 0x0037): "image_orientation",
    (0x0028, 0x0002): "samples_per_pixel",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x7FE0, 0x0010): "pixel_data",
}


class DicomParseError(ValueError):
    pass


def _skip_undefined_sequence(buf: bytes, pos: int) -> int:
    """Advance past an undefined-length sequence: scan for the sequence
    delimitation item (FFFE, E0DD), honouring nested undefined items."""
    depth = 1
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, pos)
        length = struct.unpack_from("<I", buf, pos + 4)[0]
        pos += 8
        if (group, elem) == (0xFFFE, 0xE0DD):  # sequence delimiter
            depth -= 1
            if depth == 0:
                return pos
        elif (group, elem) == (0xFFFE, 0xE000):  # item
            if length == _UNDEFINED:
                continue  # contents parsed element-wise
            pos += length
        elif (group, elem) == (0xFFFE, 0xE00D):  # item delimiter
            continue
        elif length == _UNDEFINED:
            depth += 1
        else:
            pos += length
    raise DicomParseError("unterminated undefined-length sequence")


def _parse_elements(buf: bytes, pos: int, explicit: bool,
                    stop_group: int | None = None) -> Dict[str, object]:
    """Walk data elements from ``pos`` collecting the tags in _TAGS."""
    out: Dict[str, object] = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if stop_group is not None and group > stop_group:
            out["_end"] = pos
            return out
        if explicit and group != 0xFFFE:
            vr = buf[pos + 4 : pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 8)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", buf, pos + 6)[0]
                hdr = 8
        else:
            vr = b""
            length = struct.unpack_from("<I", buf, pos + 4)[0]
            hdr = 8
        body = pos + hdr
        if length == _UNDEFINED:
            if (group, elem) == (0x7FE0, 0x0010):
                raise DicomParseError(
                    "encapsulated (compressed) PixelData — install "
                    "dcm2niix for this series")
            pos = _skip_undefined_sequence(buf, body)
            continue
        name = _TAGS.get((group, elem))
        if name is not None:
            out[name] = buf[body : body + length]
        pos = body + length
    out["_end"] = pos
    return out


def _ascii(raw: bytes) -> str:
    return raw.decode("ascii", "replace").strip("\x00 ")


def _us(raw: bytes) -> int:
    return struct.unpack("<H", raw[:2])[0]


def read_dicom_slice(path: str | Path) -> Tuple[np.ndarray, dict]:
    """Read one DICOM file -> (2-D float32 pixel array, metadata dict)."""
    buf = Path(path).read_bytes()
    pos = 0
    syntax = _EXPLICIT_LE
    if buf[128:132] == b"DICM":
        pos = 132
        # file-meta group (0002) is always explicit VR LE
        meta = _parse_elements(buf, pos, explicit=True, stop_group=0x0002)
        pos = meta["_end"]
        # transfer syntax UID (0002,0010)
        m_pos = 132
        while m_pos + 8 <= len(buf):
            group, elem = struct.unpack_from("<HH", buf, m_pos)
            if group != 0x0002:
                break
            vr = buf[m_pos + 4 : m_pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, m_pos + 8)[0]
                hdr = 12
            else:
                length = struct.unpack_from("<H", buf, m_pos + 6)[0]
                hdr = 8
            if (group, elem) == (0x0002, 0x0010):
                syntax = _ascii(buf[m_pos + hdr : m_pos + hdr + length])
            m_pos += hdr + length
    elif buf[:4] == b"DICM":
        pos = 4
    # else: raw data set with no preamble (legacy) — parse from 0

    if syntax == _IMPLICIT_LE:
        explicit = False
    elif syntax == _EXPLICIT_LE:
        explicit = True
    else:
        raise DicomParseError(
            f"unsupported transfer syntax {syntax!r} (only uncompressed "
            "little-endian is supported natively — install dcm2niix)")

    tags = _parse_elements(buf, pos, explicit=explicit)
    if "pixel_data" not in tags or "rows" not in tags:
        raise DicomParseError(f"{path}: no image data found")

    rows = _us(tags["rows"])
    cols = _us(tags["cols"])
    bits = _us(tags.get("bits_allocated", b"\x10\x00"))
    signed = _us(tags.get("pixel_representation", b"\x00\x00")) == 1
    samples = _us(tags.get("samples_per_pixel", b"\x01\x00"))
    if samples != 1:
        raise DicomParseError("multi-sample (colour) DICOM unsupported")
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16,
             32: np.int32 if signed else np.uint32}.get(bits)
    if dtype is None:
        raise DicomParseError(f"BitsAllocated={bits} unsupported")
    pixels = np.frombuffer(
        tags["pixel_data"], dtype=np.dtype(dtype).newbyteorder("<"),
        count=rows * cols,
    ).reshape(rows, cols).astype(np.float32)

    slope = float(_ascii(tags.get("rescale_slope", b"1")) or 1)
    intercept = float(_ascii(tags.get("rescale_intercept", b"0")) or 0)
    pixels = pixels * slope + intercept

    meta = {
        "instance_number": int(
            _ascii(tags.get("instance_number", b"0")) or 0),
        "position": [float(v) for v in _ascii(
            tags.get("image_position", b"")).split("\\") if v] or None,
        "pixel_spacing": [float(v) for v in _ascii(
            tags.get("pixel_spacing", b"")).split("\\") if v] or None,
        "patient_id": _ascii(tags.get("patient_id", b"")),
    }
    return pixels, meta


def read_dicom_series(directory: str | Path) -> np.ndarray:
    """Read all ``*.dcm`` files under ``directory`` (non-recursive) into
    one (n_slices, rows, cols) float32 volume, slices ordered by the
    z-coordinate of ImagePositionPatient when present (the scanner
    axis), else by InstanceNumber, else by filename — the same ordering
    cascade the reference's pydicom fallback relies on."""
    directory = Path(directory)
    files = sorted(
        f for f in os.listdir(directory) if f.lower().endswith(".dcm"))
    if not files:
        raise DicomParseError(f"no .dcm files in {directory}")
    slices = []
    for i, name in enumerate(files):
        pixels, meta = read_dicom_slice(directory / name)
        z = (meta["position"][2] if meta["position"]
             else float(meta["instance_number"] or i))
        slices.append((z, i, pixels))
    slices.sort(key=lambda s: (s[0], s[1]))
    shapes = {s[2].shape for s in slices}
    if len(shapes) != 1:
        raise DicomParseError(f"inconsistent slice shapes {shapes}")
    return np.stack([s[2] for s in slices]).astype(np.float32)


def convert_dicom_dir_to_nifti(src: str | Path, dst: str | Path) -> Path:
    """DICOM series directory -> .nii.gz (the fallback for dcm2niix)."""
    vol = read_dicom_series(src)
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    write_nifti(dst, vol)
    return dst
