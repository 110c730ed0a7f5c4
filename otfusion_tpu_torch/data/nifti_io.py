"""Minimal pure-NumPy NIfTI-1 reader/writer (a copy of
``otfusion_tpu.data.nifti_io``).

The reference reads volumes with nibabel (``nib.load(...).get_fdata()``,
3D_resnet.py:272); nibabel is not available in this image, and the subset
of NIfTI-1 the ADNI pipeline needs is small: uncompressed/gzipped single
files, scalar datatypes, scl_slope/scl_inter scaling. Implemented from the
public NIfTI-1 header specification (nifti1.h field offsets).

The writer emits the same subset and exists chiefly for the synthetic
dataset fixtures (tests + quick-test runs).
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_HDR_SIZE = 348
_MAGIC_OFFSET = 344

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str | Path, mode: str):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str | Path) -> np.ndarray:
    """Read a .nii/.nii.gz volume, returning float-compatible data with
    scl_slope/scl_inter applied (nibabel ``get_fdata`` semantics, minus the
    float64 upcast — we return the scaled array as float32 unless the file
    is float64)."""
    with _open(path, "rb") as f:
        raw = f.read()

    hdr = raw[:_HDR_SIZE]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        (sizeof_hdr,) = struct.unpack_from(">i", hdr, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr)")

    magic = hdr[_MAGIC_OFFSET : _MAGIC_OFFSET + 4]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(f"{endian}8h", hdr, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])

    (datatype,) = struct.unpack_from(f"{endian}h", hdr, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    (vox_offset,) = struct.unpack_from(f"{endian}f", hdr, 108)
    (scl_slope,) = struct.unpack_from(f"{endian}f", hdr, 112)
    (scl_inter,) = struct.unpack_from(f"{endian}f", hdr, 116)
    if magic[:3] == b"ni1":
        # header-only file; data in a sibling .img
        img_path = str(path).replace(".hdr", ".img")
        with _open(img_path, "rb") as f:
            raw = f.read()
        vox_offset = 0.0

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np_dtype, count=count, offset=int(vox_offset)
    )
    # NIfTI stores Fortran (column-major) order.
    vol = data.reshape(shape, order="F")

    # NIfTI semantics (nibabel parity): slope == 0 or non-finite header
    # values mean "no scaling" — many writers leave these uninitialised
    # (NaN), and applying NaN would silently blank the whole volume.
    if not np.isfinite(scl_slope) or scl_slope == 0.0:
        scl_slope, scl_inter = 1.0, 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope != 1.0 or scl_inter != 0.0:
        vol = vol.astype(np.float32) * scl_slope + scl_inter
    return np.asarray(vol)


def write_nifti(
    path: str | Path,
    volume: np.ndarray,
    pixdim: tuple[float, ...] | None = None,
) -> None:
    """Write a volume as a single-file NIfTI-1 (.nii or .nii.gz)."""
    volume = np.asarray(volume)
    if volume.dtype not in _DTYPE_CODES:
        volume = volume.astype(np.float32)
    ndim = volume.ndim
    if not 1 <= ndim <= 7:
        raise ValueError(f"unsupported ndim {ndim}")

    hdr = bytearray(_HDR_SIZE + 4)  # +4 bytes extension flag
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [ndim] + list(volume.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[volume.dtype])
    struct.pack_into("<h", hdr, 72, volume.dtype.itemsize * 8)  # bitpix
    pd = [1.0] + list(pixdim or (1.0,) * ndim) + [1.0] * (7 - ndim)
    struct.pack_into("<8f", hdr, 76, *pd[:8])
    struct.pack_into("<f", hdr, 108, float(_HDR_SIZE + 4))  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    hdr[_MAGIC_OFFSET : _MAGIC_OFFSET + 4] = b"n+1\0"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(volume).tobytes(order="F"))
