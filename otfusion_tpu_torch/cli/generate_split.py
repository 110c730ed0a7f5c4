"""Fixed-split generator (port of ``otfusion_tpu.cli.generate_split``): a
per-class shuffled patient-ID split written as the {train, val} JSON the
trainers read with ``--load-patient-ids``.

    python -m otfusion_tpu_torch.cli.generate_split --input ids.json \
        --output split.json [--val-fraction 0.2] [--seed 42]
"""

from __future__ import annotations

import argparse
import json

from otfusion_tpu_torch.data.splits import generate_patient_split


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True,
                        help="JSON of {class_dir: [patient_ids]}")
    parser.add_argument("--output", required=True)
    parser.add_argument("--val-fraction", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    with open(args.input) as f:
        data = json.load(f)
    split = generate_patient_split(data, args.val_fraction, args.seed)
    for class_name in data:
        print(
            f"Class {class_name}: {len(split['train'][class_name])} train, "
            f"{len(split['val'][class_name])} val"
        )
    with open(args.output, "w") as f:
        json.dump(split, f, indent=2)
    print(f"Saved fixed split to {args.output}")


if __name__ == "__main__":
    main()
