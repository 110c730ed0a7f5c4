"""Best-results aggregator (port of ``otfusion_tpu.cli.aggregate_results``):
walks run directories for results.txt files and writes the 14-column CSV
and its XLSX twin (``--excel-output`` names it, default the CSV's path
with ``.xlsx``; ``--no-xlsx`` skips it).

    python -m otfusion_tpu_torch.cli.aggregate_results --results-dir RUNS \
        --output best.csv
"""

from __future__ import annotations

import argparse
from pathlib import Path

from otfusion_tpu_torch.utils.reporting import (
    collect_best_results,
    write_results_csv,
    write_results_xlsx,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results-dir", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--excel-output", type=str, default=None,
                        help="XLSX twin path (default: the CSV path with "
                             "an .xlsx suffix)")
    parser.add_argument("--no-xlsx", action="store_true",
                        help="Write the CSV only")
    parser.add_argument("--default-modality", type=str, default="")
    args = parser.parse_args(argv)

    rows = collect_best_results(Path(args.results_dir),
                                args.default_modality)
    write_results_csv(rows, Path(args.output))
    print(f"Wrote {len(rows)} rows to {args.output}")
    if not args.no_xlsx:
        xlsx = Path(args.excel_output) if args.excel_output else Path(
            args.output).with_suffix(".xlsx")
        write_results_xlsx(rows, xlsx)
        print(f"Wrote {len(rows)} rows to {xlsx}")


if __name__ == "__main__":
    main()
