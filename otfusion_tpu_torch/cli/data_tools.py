"""Cohort data-prep and hygiene tooling, host-side.

The port of ``otfusion_tpu.cli.data_tools``: one CLI with five
subcommands:

  sizes       the volume shape of every NIfTI under each class directory
  verify      patients and scans per class directory, and the pairing
              with a second modality's tree (``--pair-with``)
  relocate    move the scans of a patient-ID list between trees (a dry
              run unless ``--apply``)
  cleanup     delete what is not NIfTI under a tree (a dry run unless
              ``--apply``)
  convert     DICOM -> NIfTI per series directory with dcm2niix when it is
              on PATH and ``--native`` is not given, else with the port's
              pure-NumPy reader (``data/dicom_io.py``; uncompressed
              little-endian series)

    python -m otfusion_tpu_torch.cli.data_tools sizes --root <class tree>
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

from otfusion_tpu_torch.data.datasets import extract_patient_id
from otfusion_tpu_torch.data.dicom_io import convert_dicom_dir_to_nifti
from otfusion_tpu_torch.data.nifti_io import read_nifti


def _walk_nii(root: Path):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        filenames.sort()
        for name in filenames:
            if name.endswith((".nii", ".nii.gz")):
                yield Path(dirpath) / name


def cmd_sizes(args):
    out_lines = []
    for class_dir in sorted(Path(args.root).iterdir()):
        if not class_dir.is_dir():
            continue
        for path in _walk_nii(class_dir):
            try:
                shape = read_nifti(path).shape
            except Exception as exc:  # corrupt file: report, keep going
                out_lines.append(f"{path}\tERROR: {exc}")
                continue
            out_lines.append(f"{path}\t{shape}")
    text = "\n".join(out_lines) + "\n"
    if args.output:
        Path(args.output).write_text(text)
        print(f"Wrote {len(out_lines)} entries to {args.output}")
    else:
        sys.stdout.write(text)


def cmd_verify(args):
    """Count patients/scans per class dir; report pairing across the two
    modality trees when --pair-with is given."""
    def index(root):
        per_dir = {}
        for class_dir in sorted(Path(root).iterdir()):
            if not class_dir.is_dir():
                continue
            patients = defaultdict(int)
            for path in _walk_nii(class_dir):
                pid = extract_patient_id(str(path))
                if pid:
                    patients[pid] += 1
            per_dir[class_dir.name] = dict(patients)
        return per_dir

    primary = index(args.root)
    for name, patients in primary.items():
        total_scans = sum(patients.values())
        print(f"{name}: {len(patients)} patients, {total_scans} scans")
        multi = {p: c for p, c in patients.items() if c > 1}
        if multi:
            print(f"  patients with multiple scans: {multi}")

    if args.pair_with:
        secondary = index(args.pair_with)
        prim_ids = {p for d in primary.values() for p in d}
        sec_ids = {p for d in secondary.values() for p in d}
        print(f"\nPairing vs {args.pair_with}:")
        print(f"  paired: {len(prim_ids & sec_ids)}")
        only_prim = sorted(prim_ids - sec_ids)
        only_sec = sorted(sec_ids - prim_ids)
        print(f"  only in {args.root}: {len(only_prim)} {only_prim[:10]}")
        print(f"  only in {args.pair_with}: {len(only_sec)} {only_sec[:10]}")


def cmd_relocate(args):
    ids = set(Path(args.id_file).read_text().split())
    moved = 0
    for path in _walk_nii(Path(args.source)):
        pid = extract_patient_id(str(path))
        if pid in ids:
            rel = path.relative_to(args.source)
            dest = Path(args.dest) / rel
            print(f"{'would move' if args.dry_run else 'moving'} "
                  f"{path} -> {dest}")
            if not args.dry_run:
                dest.parent.mkdir(parents=True, exist_ok=True)
                shutil.move(str(path), str(dest))
            moved += 1
    print(f"{moved} files {'would be ' if args.dry_run else ''}relocated")


def cmd_cleanup(args):
    removed = 0
    for dirpath, _, filenames in os.walk(args.root):
        for name in filenames:
            if not name.endswith((".nii", ".nii.gz")):
                path = Path(dirpath) / name
                print(f"{'would delete' if args.dry_run else 'deleting'} "
                      f"{path}")
                if not args.dry_run:
                    path.unlink()
                removed += 1
    print(f"{removed} files {'would be ' if args.dry_run else ''}removed")


def cmd_convert(args):
    binary = None if args.native else shutil.which("dcm2niix")
    if binary is None:
        print("dcm2niix not on PATH — using the native DICOM reader "
              "(uncompressed little-endian series only)"
              if not args.native else "native DICOM reader (--native)")
    # The ADNI layout subject/scan_type/date/image_id/*.dcm: one series
    # per leaf directory.
    converted = 0
    for dirpath, dirnames, filenames in os.walk(args.input):
        if any(f.lower().endswith(".dcm") for f in filenames):
            rel = Path(dirpath).relative_to(args.input)
            out_dir = Path(args.output) / rel
            out_dir.mkdir(parents=True, exist_ok=True)
            if binary is not None:
                subprocess.run(
                    [binary, "-z", "y", "-o", str(out_dir), dirpath],
                    check=True,
                )
            else:
                convert_dicom_dir_to_nifti(
                    dirpath, out_dir / (Path(dirpath).name + ".nii.gz"))
            converted += 1
    print(f"Converted {converted} DICOM series")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("sizes", help="volume shape audit")
    p.add_argument("--root", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_sizes)

    p = sub.add_parser("verify", help="patient/scan counts + pairing")
    p.add_argument("--root", required=True)
    p.add_argument("--pair-with", default=None)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("relocate", help="move scans by patient-ID list")
    p.add_argument("--source", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--id-file", required=True,
                   help="whitespace-separated patient IDs")
    p.add_argument("--apply", dest="dry_run", action="store_false",
                   default=True)
    p.set_defaults(fn=cmd_relocate)

    p = sub.add_parser("cleanup", help="delete non-NIfTI leftovers")
    p.add_argument("--root", required=True)
    p.add_argument("--apply", dest="dry_run", action="store_false",
                   default=True)
    p.set_defaults(fn=cmd_cleanup)

    p = sub.add_parser("convert",
                       help="DICOM -> NIfTI via dcm2niix, with a native "
                            "pure-NumPy fallback reader")
    p.add_argument("--native", action="store_true",
                   help="Force the native reader even when dcm2niix "
                        "is installed")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_convert)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
