"""The port's device preprocessing, Lanczos resize, DICOM reader and data
CLIs against the JAX package's, on the CPU.

  * ``resize_trilinear`` against ``jax.image.resize(method="trilinear")``
    at one upsampling and two downsampling shapes (1e-5; the downsampling
    ones pin JAX's antialiasing), ``zscore`` and ``preprocess_volume``
    (1e-5), ``flip_axes`` fed JAX's own ``jax.random.bernoulli`` bits
    (exactly);
  * ``resize_lanczos_uint8`` against PIL's ``LANCZOS`` resize, bit for bit;
  * ``dicom_io`` on tests/test_dicom.py's fixtures against the JAX reader's
    arrays, exactly;
  * ``generate_split``, ``aggregate_results``, ``data_tools`` (all five
    subcommands) and ``harvard30k`` (all three) run through both packages
    on the same fixtures: JSON, CSV and label lists byte for byte, the XLSX
    member by member, NIfTI arrays exactly, fundus PNGs pixel for pixel,
    and stdout once the two output roots are replaced.
"""

import json
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.data import preprocess as jax_pre
from otfusion_tpu.data.dicom_io import DicomParseError as JaxDicomParseError
from otfusion_tpu.data.dicom_io import read_dicom_series as jax_series
from otfusion_tpu.data.dicom_io import read_dicom_slice as jax_slice
from otfusion_tpu.data.nifti_io import read_nifti as jax_read_nifti
from otfusion_tpu_torch.data import preprocess
from otfusion_tpu_torch.data.dicom_io import (
    DicomParseError,
    read_dicom_series,
    read_dicom_slice,
)
from otfusion_tpu_torch.data.nifti_io import read_nifti
from otfusion_tpu_torch.data.png_io import read_png, resize_lanczos_uint8
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.utils.reporting import ResultsWriter
from test_dicom import _EXPLICIT, _IMPLICIT, write_dicom


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------- device preprocessing


@pytest.mark.parametrize("shape", [(64, 64, 64), (20, 24, 18), (32, 32, 32)])
def test_resize_trilinear_matches_jax(shape):
    vol = np.random.default_rng(0).normal(size=(40, 48, 36)).astype(
        np.float32)
    ref = np.asarray(jax_pre.resize_trilinear(jnp.asarray(vol), shape))
    ours = preprocess.resize_trilinear(torch.from_numpy(vol), shape).numpy()
    assert ours.shape == shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_downsampling_antialiases_as_jax_does():
    """At 32^3 from 40 x 48 x 36 the antialiased resize and plain
    two-voxel interpolation part by about 1 (unit-normal data): the port's
    device resize is JAX's, its host resize is JAX's host one."""
    vol = np.random.default_rng(0).normal(size=(40, 48, 36)).astype(
        np.float32)
    device = preprocess.resize_trilinear(torch.from_numpy(vol),
                                         (32, 32, 32)).numpy()
    host = preprocess.resize_trilinear_np(vol, (32, 32, 32))
    assert np.abs(device - host).max() > 0.5
    np.testing.assert_allclose(
        host, jax_pre.resize_trilinear_np(vol, (32, 32, 32)), rtol=0,
        atol=1e-6)


def test_zscore_and_preprocess_volume_match_jax():
    rng = np.random.default_rng(1)
    vol = (rng.normal(size=(30, 26, 22)) * 40.0 + 100.0).astype(np.float32)
    vol[3, 4, 5] = np.nan
    np.testing.assert_allclose(
        preprocess.zscore(torch.from_numpy(np.nan_to_num(vol))).numpy(),
        np.asarray(jax_pre.zscore(jnp.asarray(np.nan_to_num(vol)))),
        rtol=0, atol=1e-5)
    for shape in ((16, 16, 16), (36, 30, 24)):
        ours = preprocess.preprocess_volume(torch.from_numpy(vol),
                                            shape).numpy()
        ref = np.asarray(jax_pre.preprocess_volume(jnp.asarray(vol), shape))
        assert ours.shape == ref.shape == shape + (1,)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_flip_axes_with_jax_bits(seed):
    vol = np.random.default_rng(seed).normal(size=(4, 5, 6, 1)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    bits = np.asarray(jax.random.bernoulli(key, shape=(3,)))
    ref = np.asarray(jax_pre.random_flips(jnp.asarray(vol), key))
    np.testing.assert_array_equal(
        preprocess.flip_axes(torch.from_numpy(vol), bits).numpy(), ref)


def test_random_flips_draw_from_the_generator():
    vol = torch.arange(4 * 5 * 6, dtype=torch.float32).reshape(4, 5, 6, 1)
    a = preprocess.random_flips(vol, torch.Generator().manual_seed(3))
    b = preprocess.random_flips(vol, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    bits = torch.rand(3, generator=torch.Generator().manual_seed(3)) < 0.5
    assert torch.equal(a, preprocess.flip_axes(vol, bits))


# ------------------------------------------------------------ Lanczos resize


@pytest.mark.parametrize("shape,size", [
    ((32, 32), 448), ((16, 24), 448), ((800, 1000), 448),
    ((800, 1000, 3), 448), ((97, 53, 3), 48), ((448, 448), 448)])
def test_resize_lanczos_matches_pil(shape, size):
    from PIL import Image

    image = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(Image.fromarray(image).resize(
        (size, size), Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos_uint8(image, size), ref)


# --------------------------------------------------------------- DICOM


@pytest.mark.parametrize("syntax", [_EXPLICIT, _IMPLICIT])
def test_dicom_slice_matches_jax(tmp_path, syntax):
    pixels = np.random.default_rng(0).integers(-500, 500, (16, 16)).astype(
        np.int16)
    path = tmp_path / "a.dcm"
    write_dicom(path, pixels, syntax=syntax, slope=2.0, intercept=-10.0,
                position=(1.0, 2.0, 3.5), instance=7)
    ours, meta = read_dicom_slice(path)
    ref, ref_meta = jax_slice(path)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert meta == ref_meta


@pytest.mark.parametrize("order", ["position", "instance"])
def test_dicom_series_matches_jax(tmp_path, order):
    for name, key, fill in (("c.dcm", 0, 0), ("a.dcm", 2, 2),
                            ("b.dcm", 1, 1)):
        kw = ({"position": (0.0, 0.0, 5.0 * key)} if order == "position"
              else {"instance": key + 1})
        write_dicom(tmp_path / name, np.full((8, 8), fill, np.int16), **kw)
    ours = read_dicom_series(tmp_path)
    np.testing.assert_array_equal(ours, jax_series(tmp_path))
    np.testing.assert_array_equal(ours[:, 0, 0], [0.0, 1.0, 2.0])


def test_dicom_compressed_syntax_rejected_as_jax(tmp_path):
    path = tmp_path / "jpeg.dcm"
    write_dicom(path, np.zeros((4, 4), np.int16),
                syntax="1.2.840.10008.1.2.4.90")
    with pytest.raises(JaxDicomParseError) as ref:
        jax_slice(path)
    with pytest.raises(DicomParseError) as ours:
        read_dicom_slice(path)
    assert str(ours.value) == str(ref.value)


# ------------------------------------------------------------------ CLIs


def _both(capsys, jax_main, port_main, jax_argv, port_argv, roots=()):
    """Run the JAX CLI, then the port's; returns their stdouts, the port's
    with each (port root, JAX root) pair replaced."""
    capsys.readouterr()
    jax_main(jax_argv)
    ref = capsys.readouterr().out
    port_main(port_argv)
    out = capsys.readouterr().out
    for port_root, jax_root in roots:
        out = out.replace(str(port_root), str(jax_root))
    return ref, out


def test_generate_split_cli_matches_jax(tmp_path, capsys):
    from otfusion_tpu.cli.generate_split import main as jax_main
    from otfusion_tpu_torch.cli.generate_split import main as port_main

    ids = {"AD_MRI_130_FIN": [f"{i:03d}_S_{4000 + i}" for i in range(13)],
           "CN_MRI_229_FIN": [f"{i:03d}_S_{5000 + i}" for i in range(9)]}
    (tmp_path / "ids.json").write_text(json.dumps(ids))
    argv = ["--input", str(tmp_path / "ids.json"), "--val-fraction", "0.3",
            "--seed", "7", "--output"]
    ref, out = _both(capsys, jax_main, port_main,
                     [*argv, str(tmp_path / "jax.json")],
                     [*argv, str(tmp_path / "port.json")],
                     [(tmp_path / "port.json", tmp_path / "jax.json")])
    assert out == ref
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())


def _results_tree(root):
    rows = {"precision": 0.5, "recall": 0.75, "f1": 0.6,
            "specificity": 0.25}
    for setup, style in (("mri_depth10_balanced", "unimodal"),
                         ("mdepth50_drop0.3_all_with_pretrain_mri_pet_attn",
                          "fusion"),
                         ("depth18_all", "unimodal")):
        run = root / "runs" / setup
        run.mkdir(parents=True)
        writer = ResultsWriter(run / "results.txt", "title", {"lr": 1e-4},
                               style=style)
        writer.epoch_row(1, 0.7, 0.5, 0.69, 0.5, rows)
        writer.summary(0.69, {"epoch": 1, "val_acc": 0.5, **rows},
                       run / "best_model")
    (root / "runs" / "broken").mkdir()
    (root / "runs" / "broken" / "results.txt").write_text("no summary\n")


def test_aggregate_results_cli_matches_jax(tmp_path, capsys):
    from otfusion_tpu.cli.aggregate_results import main as jax_main
    from otfusion_tpu_torch.cli.aggregate_results import main as port_main

    _results_tree(tmp_path)
    argv = ["--results-dir", str(tmp_path / "runs"),
            "--default-modality", "PET", "--output"]
    ref, out = _both(capsys, jax_main, port_main,
                     [*argv, str(tmp_path / "jax" / "best.csv")],
                     [*argv, str(tmp_path / "port" / "best.csv")],
                     [(tmp_path / "port", tmp_path / "jax")])
    assert out == ref and "Wrote 3 rows" in out
    for name in ("best.csv",):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    with zipfile.ZipFile(tmp_path / "port" / "best.xlsx") as ours, \
            zipfile.ZipFile(tmp_path / "jax" / "best.xlsx") as ref_zip:
        assert ours.namelist() == ref_zip.namelist()
        for member in ours.namelist():
            assert ours.read(member) == ref_zip.read(member), member


@pytest.fixture
def cohort(tmp_path):
    return make_synthetic_adni(tmp_path / "adni", n_per_class=3,
                               shape=(8, 8, 8))


def test_data_tools_sizes_and_verify_match_jax(cohort, tmp_path, capsys):
    from otfusion_tpu.cli.data_tools import main as jax_main
    from otfusion_tpu_torch.cli.data_tools import main as port_main

    (cohort / "AD_MRI_130_FIN" / "bad.nii").write_bytes(b"junk" * 100)
    ref, out = _both(
        capsys, jax_main, port_main,
        ["sizes", "--root", str(cohort), "--output", str(tmp_path / "j.txt")],
        ["sizes", "--root", str(cohort), "--output", str(tmp_path / "p.txt")],
        [(tmp_path / "p.txt", tmp_path / "j.txt")])
    assert out == ref
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt"
                                                  ).read_bytes()
    argv = ["verify", "--root", str(cohort), "--pair-with", str(cohort)]
    ref, out = _both(capsys, jax_main, port_main, argv, argv)
    assert out == ref and "paired: 6" in out


@pytest.mark.parametrize("apply", [False, True])
def test_data_tools_relocate_and_cleanup_match_jax(cohort, tmp_path, capsys,
                                                   apply):
    from otfusion_tpu.cli.data_tools import main as jax_main
    from otfusion_tpu_torch.cli.data_tools import main as port_main

    (cohort / "AD_MRI_130_FIN" / "notes.txt").write_text("x")
    jax_tree, port_tree = tmp_path / "j", tmp_path / "p"
    shutil.copytree(cohort, jax_tree)
    shutil.copytree(cohort, port_tree)
    ids = tmp_path / "ids.txt"
    ids.write_text("001_S_4000\n")
    flag = ["--apply"] if apply else []
    ref, out = _both(
        capsys, jax_main, port_main,
        ["relocate", "--source", str(jax_tree / "AD_MRI_130_FIN"),
         "--dest", str(jax_tree / "moved"), "--id-file", str(ids), *flag],
        ["relocate", "--source", str(port_tree / "AD_MRI_130_FIN"),
         "--dest", str(port_tree / "moved"), "--id-file", str(ids), *flag],
        [(port_tree, jax_tree)])
    assert out == ref
    ref, out = _both(capsys, jax_main, port_main,
                     ["cleanup", "--root", str(jax_tree), *flag],
                     ["cleanup", "--root", str(port_tree), *flag],
                     [(port_tree, jax_tree)])
    assert out == ref and "1 files" in out

    def listing(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    assert listing(port_tree) == listing(jax_tree)
    assert (port_tree / "moved").exists() == apply


def test_data_tools_convert_matches_jax(tmp_path, capsys):
    from otfusion_tpu.cli.data_tools import main as jax_main
    from otfusion_tpu_torch.cli.data_tools import main as port_main

    for series, n in (("123_S_4567/MPRAGE/2024-01-01/I1", 4),
                      ("123_S_4567/PET/2024-02-01/I2", 3)):
        leaf = tmp_path / "in" / series
        leaf.mkdir(parents=True)
        for i in range(n):
            write_dicom(leaf / f"s{i}.dcm",
                        np.full((6, 5), i * 100 + n, np.int16),
                        position=(0.0, 0.0, float(n - i)))
    ref, out = _both(
        capsys, jax_main, port_main,
        ["convert", "--native", "--input", str(tmp_path / "in"),
         "--output", str(tmp_path / "j")],
        ["convert", "--native", "--input", str(tmp_path / "in"),
         "--output", str(tmp_path / "p")],
        [(tmp_path / "p", tmp_path / "j")])
    assert out == ref and "Converted 2 DICOM series" in out
    produced = sorted(p.relative_to(tmp_path / "p")
                      for p in (tmp_path / "p").rglob("*.nii.gz"))
    assert produced == sorted(p.relative_to(tmp_path / "j")
                              for p in (tmp_path / "j").rglob("*.nii.gz"))
    assert len(produced) == 2
    for rel in produced:
        ours = read_nifti(tmp_path / "p" / rel)
        np.testing.assert_array_equal(ours,
                                      jax_read_nifti(tmp_path / "j" / rel))


def _harvard_records(src):
    rng = np.random.default_rng(0)
    src.mkdir(parents=True)
    np.savez(src / "rec_a.npz",
             slo_fundus=rng.integers(0, 255, (40, 32), dtype=np.uint8),
             dr_subtype=np.asarray("pdr"),
             oct_bscans=rng.normal(size=(8, 10, 12)).astype(np.float32))
    np.savez(src / "rec_b.npz",
             slo_fundus=rng.integers(0, 255, (96, 120), dtype=np.uint8),
             dr_subtype=np.asarray("no.dr.diagnosis"),
             oct_bscans=rng.normal(size=(4, 6, 8)).astype(np.float32))


def test_harvard30k_cli_matches_jax(tmp_path, capsys):
    from otfusion_tpu.cli.harvard30k import main as jax_main
    from otfusion_tpu_torch.cli.harvard30k import main as port_main

    release = tmp_path / "release"
    release.mkdir()
    _harvard_records(tmp_path / "records")
    with zipfile.ZipFile(release / "part0.zip", "w") as zf:
        for name in ("rec_a.npz", "rec_b.npz"):
            zf.write(tmp_path / "records" / name, f"Training/p0/{name}")
        zf.writestr("Training/p0/preview.jpg", b"x")
        zf.writestr("test/rec_c.npz", b"y")
    j, p = tmp_path / "j", tmp_path / "p"
    ref, out = _both(capsys, jax_main, port_main,
                     ["merge-zips", "--work-dir", str(release),
                      "--output-dir", str(j / "merged")],
                     ["merge-zips", "--work-dir", str(release),
                      "--output-dir", str(p / "merged")], [(p, j)])
    assert out == ref
    files = sorted(x.relative_to(p) for x in (p / "merged").rglob("*"))
    assert files == sorted(x.relative_to(j) for x in (j / "merged").rglob("*"))
    for rel in files:
        if (p / rel).is_file():
            assert (p / rel).read_bytes() == (j / rel).read_bytes()

    source = p / "merged" / "merged_training" / "p0"
    ref, out = _both(
        capsys, jax_main, port_main,
        ["extract-fundus", "--source", str(source), "--fundus-dir",
         str(j / "fundus"), "--labels-file", str(j / "fundus.txt")],
        ["extract-fundus", "--source", str(source), "--fundus-dir",
         str(p / "fundus"), "--labels-file", str(p / "fundus.txt")],
        [(p, j)])
    assert out == ref
    assert (p / "fundus.txt").read_bytes() == (j / "fundus.txt").read_bytes()
    for name in ("rec_a_fundus.png", "rec_b_fundus.png"):
        ours = read_png(p / "fundus" / name)
        assert ours.shape == (448, 448, 3)
        np.testing.assert_array_equal(ours, read_png(j / "fundus" / name))

    ref, out = _both(capsys, jax_main, port_main,
                     ["oct-to-nii", "--input", str(source), "--output",
                      str(j / "oct")],
                     ["oct-to-nii", "--input", str(source), "--output",
                      str(p / "oct")], [(p, j)])
    assert out == ref
    assert sorted(x.name for x in (p / "oct").iterdir()) == ["rec_a.zip",
                                                             "rec_b.zip"]
    for name in ("rec_a", "rec_b"):
        for root in (p, j):
            with zipfile.ZipFile(root / "oct" / f"{name}.zip") as zf:
                zf.extract(f"{name}.nii", root / "unzipped")
        np.testing.assert_array_equal(
            read_nifti(p / "unzipped" / f"{name}.nii"),
            jax_read_nifti(j / "unzipped" / f"{name}.nii"))
