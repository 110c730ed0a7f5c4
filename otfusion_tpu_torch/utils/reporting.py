"""results.txt and its aggregation (port of ``otfusion_tpu.utils.reporting``).

``ResultsWriter`` writes the reference's fixed-width results.txt, so either
package's aggregator parses the port's runs. The aggregator
(``cli/aggregate_results.py``) walks run directories for those files with
the reference's best-block regexes and setup-name parsing, and writes the
14-column CSV and its XLSX twin.
"""

from __future__ import annotations

import csv
import math
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSV_COLUMNS: List[str] = [
    "setup",
    "modality",
    "model_depth",
    "data_split",
    "dropout",
    "pretrained",
    "attention_target",
    "best_val_loss",
    "best_epoch",
    "val_acc",
    "precision",
    "recall",
    "f1_score",
    "specificity",
]

_NUMBER = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"

# Columns the reference's XLSX twin coerces to numbers
# (aggregate_pretraining_best_results.py:36-44, pd.to_numeric).
NUMERIC_COLUMNS: List[str] = [
    "best_val_loss",
    "best_epoch",
    "val_acc",
    "precision",
    "recall",
    "f1_score",
    "specificity",
]


class ResultsWriter:
    """Writes the reference's fixed-width results.txt."""

    def __init__(self, path: str | Path, title: str, config: Dict[str, object],
                 style: str = "unimodal", append: bool = False):
        """``style``: "unimodal" emits "Best Epoch: ..." in the summary;
        "fusion" emits "Best Metrics | Epoch: ...". ``append=True`` (a
        resumed run) keeps the file and strips its trailing summary block,
        so the file keeps one header, the rows and one summary."""
        self.path = Path(path)
        self.style = style
        if append and self.path.exists():
            text = self.path.read_text()
            idx = text.find("\n" + "=" * 80 + "\nBest Validation Loss:")
            if idx != -1:
                self.path.write_text(text[: idx + 1])
            return
        with open(self.path, "w") as f:
            f.write(title + "\n")
            f.write("=" * 80 + "\n")
            for key, value in config.items():
                f.write(f"{key}: {value}\n")
            f.write("=" * 80 + "\n\n")
            f.write(
                f"{'Epoch':<6} {'Train Loss':<12} {'Train Acc':<11} "
                f"{'Val Loss':<12} {'Val Acc':<11} "
                f"{'Precision':<11} {'Recall':<11} {'F1 Score':<11} "
                f"{'Specificity':<12}\n"
            )
            f.write("-" * 120 + "\n")

    def epoch_row(self, epoch: int, train_loss: float, train_acc: float,
                  val_loss: float, val_acc: float, metrics: Dict[str, float]):
        with open(self.path, "a") as f:
            f.write(
                f"{epoch:<6} {train_loss:<12.4f} {train_acc:<11.4f} "
                f"{val_loss:<12.4f} {val_acc:<11.4f} "
                f"{metrics['precision']:<11.4f} {metrics['recall']:<11.4f} "
                f"{metrics['f1']:<11.4f} {metrics['specificity']:<12.4f}\n"
            )

    def summary(self, best_val_loss: float, best: Optional[Dict[str, float]],
                model_path: str | Path):
        with open(self.path, "a") as f:
            f.write("\n" + "=" * 80 + "\n")
            f.write(f"Best Validation Loss: {best_val_loss:.4f}\n")
            if best:
                prefix = (
                    "Best Metrics | Epoch:" if self.style == "fusion"
                    else "Best Epoch:"
                )
                f.write(
                    f"{prefix} {best['epoch']} "
                    f"Acc: {best['val_acc']:.4f} "
                    f"Precision: {best['precision']:.4f} "
                    f"Recall: {best['recall']:.4f} "
                    f"F1: {best['f1']:.4f} "
                    f"Specificity: {best['specificity']:.4f}\n"
                )
            f.write(f"Best model saved to: {model_path}\n")


def _normalize_attention_target(attn_suffix: str) -> str:
    if not attn_suffix:
        return "none"
    if "mri_pet_attn" in attn_suffix:
        return "mri_pet"
    if "mri_attn" in attn_suffix:
        return "mri"
    if "pet_attn" in attn_suffix:
        return "pet"
    return attn_suffix


def parse_setup_fields(
    setup_name: str, default_modality: str = ""
) -> Tuple[str, str, str, Dict[str, str]]:
    """Directory name -> (modality, depth, split, extras): the three naming
    schemes of the reference's aggregator, then a fallback."""
    extras = {"dropout": "", "pretrained": "", "attention_target": ""}

    attn = re.match(
        r"^mdepth(?P<depth>\d+)_drop(?P<dropout>[^_]+)_"
        r"(?P<split>all|balanced)_(?P<pretrain>(?:with|no)_pretrain)"
        r"(?:_(?P<attn>.+))?$",
        setup_name,
    )
    if attn:
        extras["dropout"] = attn.group("dropout")
        extras["pretrained"] = attn.group("pretrain")
        extras["attention_target"] = _normalize_attention_target(
            attn.group("attn") or ""
        )
        return (
            default_modality.strip() or "mdepth",
            attn.group("depth"),
            attn.group("split"),
            extras,
        )

    m = re.match(r"^(?P<mod>[^_]+)_depth(?P<depth>\d+)_(?P<split>.+)$",
                 setup_name)
    if m:
        return m.group("mod"), m.group("depth"), m.group("split"), extras

    m = re.match(r"^depth(?P<depth>\d+)_(?P<split>.+)$", setup_name)
    if m:
        return default_modality.strip(), m.group("depth"), m.group("split"), extras

    depth_m = re.search(r"depth(?P<depth>\d+)", setup_name)
    depth = depth_m.group("depth") if depth_m else ""
    tokens = setup_name.split("_", 1)
    split = tokens[1] if len(tokens) > 1 else ""
    letters = re.match(r"([A-Za-z]+)", tokens[0])
    modality = default_modality.strip() or (
        letters.group(1) if letters else tokens[0]
    ) or setup_name
    return modality, depth, split, extras


def parse_results_file(
    path: Path, default_modality: str = ""
) -> Optional[Dict[str, str]]:
    text = Path(path).read_text(encoding="utf-8", errors="ignore")
    if not text.strip():
        return None
    modality, depth, split, extras = parse_setup_fields(
        Path(path).parent.name, default_modality
    )
    loss_m = re.search(rf"Best Validation Loss:\s*({_NUMBER})", text,
                       re.MULTILINE)
    metrics_m = re.search(
        rf"Best (?:Epoch|Metrics\s*\|\s*Epoch):\s*(\d+)\s+Acc:\s*({_NUMBER})"
        rf"\s+Precision:\s*({_NUMBER})\s+Recall:\s*({_NUMBER})"
        rf"\s+F1:\s*({_NUMBER})\s+Specificity:\s*({_NUMBER})",
        text,
    )
    if not (loss_m and metrics_m):
        return None
    row = {
        "setup": Path(path).parent.name,
        "modality": modality,
        "model_depth": depth,
        "data_split": split,
        "best_val_loss": loss_m.group(1),
        "best_epoch": metrics_m.group(1),
        "val_acc": metrics_m.group(2),
        "precision": metrics_m.group(3),
        "recall": metrics_m.group(4),
        "f1_score": metrics_m.group(5),
        "specificity": metrics_m.group(6),
    }
    row.update({k: extras[k] for k in
                ("dropout", "pretrained", "attention_target")})
    return row


def collect_best_results(
    results_dir: Path, default_modality: str = ""
) -> List[Dict[str, str]]:
    rows = []
    for f in sorted(Path(results_dir).rglob("results.txt")):
        parsed = parse_results_file(f, default_modality)
        if parsed is None:
            print(f"[WARN] Skipping {f} (missing best metrics block)",
                  file=sys.stderr)
            continue
        rows.append(parsed)
    return rows


def write_results_csv(rows: List[Dict[str, str]], output_path: Path) -> None:
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with output_path.open("w", newline="", encoding="utf-8") as fh:
        writer = csv.DictWriter(fh, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        for row in rows:
            writer.writerow(row)


def _xml_escape(text: str) -> str:
    return (text.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def write_results_xlsx(rows: List[Dict[str, str]],
                       output_path: Path) -> None:
    """The CSV's XLSX twin, written as the minimal Office Open XML package
    (a zip of 5 XML parts, one worksheet of inline strings and numbers)
    without openpyxl; Excel, LibreOffice and pandas read it.
    NUMERIC_COLUMNS become number cells, and a value that does not parse
    as a finite number an empty cell (pandas' ``to_numeric(errors=
    "coerce")``)."""
    import zipfile

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)

    def cell(ref: str, value: str, column: str) -> str:
        if column in NUMERIC_COLUMNS:
            try:
                num = float(value)
            except (TypeError, ValueError):
                return f'<c r="{ref}"/>'
            # nan/inf have no XLSX number-cell representation; pandas
            # writes nan as an empty cell (and int(num) would raise).
            if not math.isfinite(num):
                return f'<c r="{ref}"/>'
            # ints render without a trailing .0, like pandas
            text = repr(int(num)) if num == int(num) else repr(num)
            return f'<c r="{ref}"><v>{text}</v></c>'
        return (f'<c r="{ref}" t="inlineStr"><is><t>'
                f"{_xml_escape(str(value))}</t></is></c>")

    def col_letter(i: int) -> str:
        letters = ""
        i += 1
        while i:
            i, rem = divmod(i - 1, 26)
            letters = chr(ord("A") + rem) + letters
        return letters

    sheet_rows = []
    header = "".join(
        f'<c r="{col_letter(c)}1" t="inlineStr"><is><t>'
        f"{_xml_escape(name)}</t></is></c>"
        for c, name in enumerate(CSV_COLUMNS))
    sheet_rows.append(f'<row r="1">{header}</row>')
    for r, row in enumerate(rows, start=2):
        cells = "".join(
            cell(f"{col_letter(c)}{r}", row.get(name, ""), name)
            for c, name in enumerate(CSV_COLUMNS))
        sheet_rows.append(f'<row r="{r}">{cells}</row>')

    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
        + "".join(sheet_rows) + "</sheetData></worksheet>"
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main" xmlns:r="http://schemas.'
        'openxmlformats.org/officeDocument/2006/relationships">'
        '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>'
        "</workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/'
        'package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.'
        'org/officeDocument/2006/relationships/worksheet" '
        'Target="worksheets/sheet1.xml"/></Relationships>'
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/'
        'package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.'
        'org/officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
        'content-types">'
        '<Default Extension="rels" ContentType="application/vnd.'
        'openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/'
        'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        'worksheet+xml"/></Types>'
    )
    with zipfile.ZipFile(output_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
