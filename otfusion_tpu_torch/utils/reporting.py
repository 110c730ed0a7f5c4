"""results.txt writer (the ``ResultsWriter`` of
``otfusion_tpu.utils.reporting``): the reference's fixed-width format, so
the JAX package's aggregator parses the port's runs too."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional


class ResultsWriter:
    """Writes the reference's fixed-width results.txt."""

    def __init__(self, path: str | Path, title: str, config: Dict[str, object],
                 style: str = "unimodal"):
        """``style``: "unimodal" emits "Best Epoch: ..." in the summary;
        "fusion" emits "Best Metrics | Epoch: ..."."""
        self.path = Path(path)
        self.style = style
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
