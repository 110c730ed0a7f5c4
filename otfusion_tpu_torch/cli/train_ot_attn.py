"""Flagship trainer: per-epoch OT coupling + 3-token cross-modal attention.

    python -m otfusion_tpu_torch.cli.train_ot_attn --data-dir <ADNI root>
"""

from otfusion_tpu_torch.cli._fusion_main import fusion_main


def main(argv=None):
    return fusion_main(
        variant="per_epoch_attn",
        description=(
            "Train multimodal MRI-PET model with per-epoch Optimal "
            "Transport coupling and attention fusion"
        ),
        default_save_path="results/MRI_PET_OT_OT_per_epoch_attn/all",
        argv=argv,
    )


if __name__ == "__main__":
    main()
