"""Harvard-30k AMD/DR data preparation (port of
``otfusion_tpu.cli.harvard30k``), three subcommands:

* ``merge-zips``: unpack every ``*.zip`` of the release into merged
  ``merged_training`` / ``merged_test`` / ``merged_validation`` trees,
  dropping the ``.jpg`` previews;
* ``extract-fundus``: the ``slo_fundus`` array of each ``.npz`` record,
  resized to ``--size`` square with PIL's Lanczos filter (written out in
  ``data/png_io.py:resize_lanczos_uint8``, bit for bit), saved as PNG,
  and the ``<name>_fundus.png <label>`` list with the DR-subtype ->
  referable-DR table;
* ``oct-to-nii``: each record's ``oct_bscans`` volume as a zipped NIfTI-1
  file (``data/nifti_io.py``).

    python -m otfusion_tpu_torch.cli.harvard30k extract-fundus \
        --source Test --fundus-dir fundus --labels-file fundus.txt
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import zipfile
from pathlib import Path

import numpy as np

from otfusion_tpu_torch.data.nifti_io import write_nifti
from otfusion_tpu_torch.data.png_io import resize_lanczos_uint8, write_png

# The release's DR subtype -> binary referable-DR label.
CONDITION_DISEASE_MAPPING = {
    "not.in.icd.table": 0.0,
    "no.dr.diagnosis": 0.0,
    "mild.npdr": 0.0,
    "moderate.npdr": 0.0,
    "severe.npdr": 1.0,
    "pdr": 1.0,
}

_SPLIT_DIRS = {
    "Training": "merged_training",
    "test": "merged_test",
    "validation": "merged_validation",
}


def merge_zips(work_dir: str | Path, output_dir: str | Path,
               verbose: bool = True) -> int:
    """Unpack the release zips into merged split trees. Returns the
    number of zips processed."""
    work_dir, output_dir = Path(work_dir), Path(output_dir)
    for d in _SPLIT_DIRS.values():
        (output_dir / d).mkdir(parents=True, exist_ok=True)
    n = 0
    for filename in sorted(os.listdir(work_dir)):
        if not filename.endswith(".zip") or filename.startswith("."):
            continue
        if verbose:
            print(f"unpacking {filename}")
        # Fresh scratch dir per zip: a fixed work_dir/"temp" would merge
        # stale leftovers of an interrupted prior run into the output
        # (and then delete user files occupying that name).
        temp_dir = Path(tempfile.mkdtemp(prefix=".merge-", dir=work_dir))
        try:
            with zipfile.ZipFile(work_dir / filename) as zf:
                zf.extractall(temp_dir)
            for subdir, target_name in _SPLIT_DIRS.items():
                subdir_path = temp_dir / subdir
                if not subdir_path.exists():
                    continue
                # drop the .jpg previews before merging
                for root, _, files in os.walk(subdir_path):
                    for f in files:
                        if f.endswith(".jpg"):
                            os.remove(os.path.join(root, f))
                target = output_dir / target_name
                for item in os.listdir(subdir_path):
                    s_path = subdir_path / item
                    d_path = target / item
                    if s_path.is_dir():
                        shutil.copytree(s_path, d_path, dirs_exist_ok=True)
                    else:
                        shutil.copy2(s_path, d_path)
        finally:
            shutil.rmtree(temp_dir)
        n += 1
    return n


def extract_fundus(source_folder: str | Path, fundus_folder: str | Path,
                   labels_file: str | Path, size: int = 448) -> int:
    """SLO-fundus PNGs + label list from the .npz records."""
    source_folder, fundus_folder = Path(source_folder), Path(fundus_folder)
    fundus_folder.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(labels_file, "w") as labels:
        for file in sorted(os.listdir(source_folder)):
            if not file.endswith(".npz"):
                continue
            data = np.load(source_folder / file, allow_pickle=True)
            img = resize_lanczos_uint8(np.asarray(data["slo_fundus"]), size)
            png_name = f"{file[:-4]}_fundus.png"
            write_png(fundus_folder / png_name, img)
            condition = data["dr_subtype"].item()
            label = int(CONDITION_DISEASE_MAPPING[condition])
            labels.write(f"{png_name} {label}\n")
            n += 1
    return n


def oct_to_nii(input_folder: str | Path, output_folder: str | Path) -> int:
    """OCT b-scan volumes -> zipped NIfTI-1 files (identity affine)."""
    input_folder, output_folder = Path(input_folder), Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    n = 0
    for file_name in sorted(os.listdir(input_folder)):
        if not file_name.endswith(".npz"):
            continue
        data = np.load(input_folder / file_name, allow_pickle=True)
        if "oct_bscans" not in data:
            continue
        vol = np.asarray(data["oct_bscans"])
        nii_name = file_name.replace(".npz", ".nii")
        nii_path = output_folder / nii_name
        write_nifti(nii_path, vol)
        zip_path = output_folder / file_name.replace(".npz", ".zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.write(nii_path, arcname=nii_name)
        os.remove(nii_path)
        n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Harvard-30k data preparation (data_process.py parity)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merge-zips")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--output-dir", required=True)

    p = sub.add_parser("extract-fundus")
    p.add_argument("--source", required=True)
    p.add_argument("--fundus-dir", required=True)
    p.add_argument("--labels-file", required=True)
    p.add_argument("--size", type=int, default=448)

    p = sub.add_parser("oct-to-nii")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "merge-zips":
        n = merge_zips(args.work_dir, args.output_dir)
    elif args.cmd == "extract-fundus":
        n = extract_fundus(args.source, args.fundus_dir, args.labels_file,
                           args.size)
    else:
        n = oct_to_nii(args.input, args.output)
    print(f"{args.cmd}: processed {n} items")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
