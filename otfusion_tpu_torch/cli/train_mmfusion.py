"""No-OT multimodal fusion baseline (no OT loss, no coupling, no kernel).

    python -m otfusion_tpu_torch.cli.train_mmfusion --data-dir <ADNI root>
"""

from otfusion_tpu_torch.cli._fusion_main import fusion_main


def main(argv=None):
    return fusion_main(
        variant="mmfusion",
        description="Train multimodal MRI-PET fusion baseline (no OT)",
        default_save_path="results/MRI_PET_mmfusion/all",
        argv=argv,
    )


if __name__ == "__main__":
    main()
