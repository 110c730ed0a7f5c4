"""The port's GAMMA data layer against PIL and the JAX package, on the CPU.

  * ``read_png`` equals PIL's ``Image.open(p).convert("RGB")`` bit for bit
    on PIL-written greyscale (8 and 1 bit), grey+alpha, RGB, RGBA and
    palette (8 and 1, 2, 4 bit) files, plain and ``optimize=True`` (PIL's
    encoder picks each row's filter), and on rows written with each of the
    five filters by hand; 16-bit and interlaced files raise;
  * ``write_png`` is read back by PIL bit for bit;
  * ``resize_bilinear_uint8`` against PIL's bilinear resize: exact at
    512 -> 384 and 300 -> 384, within one grey level at 97 -> 32;
  * ``GammaLoader`` batches bit-equal to the JAX loader's over two
    shuffled, augmented epochs (float32 and bf16 feeds) on the JAX
    package's fixture, and the port's ``make_synthetic_gamma`` writes the
    same pixels and volumes, read identically by both loaders;
  * ``MultiModalFileListDataset`` equal to the JAX class in every mode.
"""

import struct
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch
from PIL import Image

from otfusion_tpu.data import gamma as jax_gamma
from otfusion_tpu_torch.data import gamma
from otfusion_tpu_torch.data.png_io import (
    read_png,
    resize_bilinear_uint8,
    write_png,
)


def _image(rng, h=37, w=53):
    """A smooth gradient with noise: PIL's adaptive filtering then uses
    every filter type."""
    ramp = np.linspace(0, 150, w)[None, :, None] + np.linspace(0, 60, h)[
        :, None, None]
    return (rng.uniform(0, 40, (h, w, 3)) + ramp).astype(np.uint8)


def _pil_modes(base):
    rgb = Image.fromarray(base)
    rgba = np.concatenate([base, base[:, :, :1]], axis=2)
    return {
        "L": Image.fromarray(base[:, :, 0]),
        "1": Image.fromarray(base[:, :, 0]).convert("1"),
        "LA": Image.fromarray(base[:, :, 0]).convert("LA"),
        "RGB": rgb,
        "RGBA": Image.fromarray(rgba),
        "P256": rgb.convert("P", palette=Image.ADAPTIVE, colors=256),
        "P16": rgb.convert("P", palette=Image.ADAPTIVE, colors=16),
        "P4": rgb.convert("P", palette=Image.ADAPTIVE, colors=4),
        "P2": rgb.convert("P", palette=Image.ADAPTIVE, colors=2),
    }


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["L", "1", "LA", "RGB", "RGBA", "P256",
                                  "P16", "P4", "P2"])
def test_read_png_matches_pil(tmp_path, mode, optimize):
    image = _pil_modes(_image(np.random.default_rng(0)))[mode]
    path = tmp_path / f"{mode}.png"
    image.save(path, optimize=optimize)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filtered_png(path, image, kinds):
    """Write an 8-bit RGB PNG whose row r uses filter ``kinds[r]``."""
    h, w, _ = image.shape
    rows = image.reshape(h, w * 3).astype(np.int64)
    out = []
    for r in range(h):
        cur = rows[r]
        up = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        kind = kinds[r]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(out)))
        + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", ["all", "no_average_or_paeth"])
def test_read_png_undoes_every_row_filter(tmp_path, kinds):
    """Rows filtered by hand with each of the five filters in turn (and
    only None, Sub and Up, the row-by-row path); PIL agrees."""
    image = _image(np.random.default_rng(1), 40, 29)
    cycle = (0, 1, 2, 3, 4) if kinds == "all" else (0, 1, 2)
    path = tmp_path / "filtered.png"
    _filtered_png(path, image, [cycle[r % len(cycle)] for r in range(40)])
    np.testing.assert_array_equal(read_png(path), image)
    np.testing.assert_array_equal(
        np.asarray(Image.open(path).convert("RGB")), image)


def test_read_png_refuses_16_bit_and_interlaced(tmp_path):
    deep = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 900
                    ).save(deep)
    with pytest.raises(ValueError, match="16-bit greyscale"):
        read_png(deep)
    flat = tmp_path / "flat.png"
    write_png(flat, _image(np.random.default_rng(2), 8, 8))
    data = bytearray(flat.read_bytes())
    data[28] = 1  # IHDR interlace byte
    body = bytes(data[12:29])
    data[29:33] = struct.pack(">I", zlib.crc32(body))
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(interlaced)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_is_read_back_by_pil(tmp_path, channels):
    image = _image(np.random.default_rng(3))
    image = np.concatenate([image, image[:, :, :1]], axis=2)[:, :, :channels]
    path = tmp_path / "w.png"
    write_png(path, image)
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, image if channels > 1
                                  else image[:, :, 0])
    rgb = image[:, :, :3] if channels > 1 else np.repeat(image, 3, axis=2)
    np.testing.assert_array_equal(read_png(path), rgb)


@pytest.mark.parametrize("src,dst,levels", [(512, 384, 0), (300, 384, 0),
                                            (97, 32, 1)])
def test_resize_matches_pil_bilinear(src, dst, levels):
    rng = np.random.default_rng(src)
    for image in (rng.integers(0, 256, (src, src, 3), dtype=np.uint8),
                  _image(rng, src, src)):
        want = np.asarray(Image.fromarray(image).resize((dst, dst),
                                                        Image.BILINEAR))
        got = resize_bilinear_uint8(image, dst)
        assert got.dtype == np.uint8 and got.shape == (dst, dst, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= levels
    same = rng.integers(0, 256, (dst, dst, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize_bilinear_uint8(same, dst), same)


SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """The same 10-case cohort written by the JAX package (PIL) and by the
    port (``write_png``), fundus at 64^2 and OCT at 20^3."""
    kw = dict(n_cases=10, n_classes=2, fundus_size=64, oct_shape=(20,) * 3,
              seed=3)
    jax_root = jax_gamma.make_synthetic_gamma(
        tmp_path_factory.mktemp("jax_gamma"), **kw)
    port_root = gamma.make_synthetic_gamma(
        tmp_path_factory.mktemp("port_gamma"), **kw)
    return jax_root, port_root


def _datasets(root):
    mgamma, labels = root
    kw = dict(oct_shape=SHAPE, fundus_size=32)
    return (jax_gamma.GammaDataset(mgamma, labels, **kw),
            gamma.GammaDataset(mgamma, labels, **kw))


def test_port_fixture_writes_the_jax_fixture(cohorts):
    (jax_mg, jax_csv), (port_mg, port_csv) = cohorts
    assert jax_csv.read_text() == port_csv.read_text()
    cases = gamma.list_gamma_cases(port_mg)
    assert cases == jax_gamma.list_gamma_cases(jax_mg)
    for case in cases:
        name = f"{case}/data_{case}.nii"
        assert (jax_mg / name).read_bytes() == (port_mg / name).read_bytes()
        fundus = f"{case}/data_{case}_fundus.png"
        images = "multi-modality_images"
        np.testing.assert_array_equal(
            read_png(port_mg.parent / images / fundus),
            np.asarray(Image.open(jax_mg.parent / images / fundus)))


@pytest.mark.parametrize("which", ["jax_fixture", "port_fixture"])
@pytest.mark.parametrize("feed", ["float32", "bfloat16"])
def test_loader_batches_equal_jax(cohorts, which, feed):
    """Two shuffled, augmented epochs of 3-case batches: the same order,
    the same augmentations, the same bits, the JAX layouts."""
    root = cohorts[0] if which == "jax_fixture" else cohorts[1]
    jax_ds, port_ds = _datasets(root)
    assert port_ds.samples == jax_ds.samples
    idx = [7, 1, 4, 9, 0, 2, 5, 8]
    jax_feed = np.float32 if feed == "float32" else ml_dtypes.bfloat16
    port_feed = getattr(torch, feed)
    jl = jax_gamma.GammaLoader(jax_ds, idx, 3, shuffle=True, augment=True,
                               seed=11, feed_dtype=jax_feed)
    pl = gamma.GammaLoader(port_ds, idx, 3, shuffle=True, augment=True,
                           seed=11, feed_dtype=port_feed)
    assert len(pl) == len(jl) == 3
    for _ in range(2):
        for (jf, jo, jy), (pf, po, py) in zip(jl, pl, strict=True):
            assert pf.dtype == port_feed and po.dtype == port_feed
            assert pf.shape == jf.shape and po.shape == jo.shape
            assert pf.shape[1:] == (32, 32, 3) and po.shape[1:] == (*SHAPE, 1)
            np.testing.assert_array_equal(pf.float().numpy(),
                                          jf.astype(np.float32))
            np.testing.assert_array_equal(po.float().numpy(),
                                          jo.astype(np.float32))
            np.testing.assert_array_equal(py.numpy(), jy)


def test_fixtures_load_identically(cohorts):
    """Each loader reads the JAX package's fixture and the port's to the
    same arrays."""
    (jax_ds, port_ds), (jax_ds2, port_ds2) = (_datasets(cohorts[0]),
                                              _datasets(cohorts[1]))
    for case, _ in port_ds.samples:
        for ds_a, ds_b in ((jax_ds, jax_ds2), (port_ds, port_ds2),
                           (jax_ds, port_ds2)):
            for a, b in zip(ds_a.load(case), ds_b.load(case), strict=True):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [
    dict(),
    dict(model_base="transformer"),
    dict(condition="noise", condition_name="SaltPepper", seed_idx=7,
         sp_variance=0.1),
    dict(condition="noise", condition_name="Gaussian"),
    dict(condition="noise", g_variance=0.05, sp_variance=0.05, seed_idx=3),
])
def test_filelist_dataset_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(4)
    folder = tmp_path / "folder0"
    folder.mkdir()
    lists = {"FUN": [], "OCT": []}
    for i in range(3):
        for name, shape in (("FUN", (3, 20, 24)), ("OCT", (10, 12, 14))):
            path = tmp_path / f"{name}{i}.npy"
            np.save(path, rng.uniform(0, 255, size=shape).astype(np.float32))
            lists[name].append(str(path))
    for name, paths in lists.items():
        (folder / f"train_{name}.txt").write_text("\n".join(paths) + "\n")
    (folder / "train_GT.txt").write_text("0\n1\n0\n")
    args = (str(tmp_path) + "/", 2, ["FUN", "OCT"], "train")
    ref = jax_gamma.MultiModalFileListDataset(*args, **mode)
    ds = gamma.MultiModalFileListDataset(*args, **mode)
    assert len(ds) == len(ref) == 3
    for i in range(3):
        (data, y), (want, y_ref) = ds[i], ref[i]
        assert y == y_ref
        for k in want:
            assert data[k].dtype == want[k].dtype
            np.testing.assert_array_equal(data[k], want[k])
