"""Base fusion trainer: the in-batch FOT OT loss, solved inside every train
step (kernel K2 on a GPU, once per microbatch).

    python -m otfusion_tpu_torch.cli.train_mri_pet_ot --data-dir <ADNI root>
"""

from otfusion_tpu_torch.cli._fusion_main import fusion_main


def main(argv=None):
    return fusion_main(
        variant="base",
        description="Train multimodal MRI-PET model with Optimal Transport",
        default_save_path="results/MRI_PET_OT/all",
        argv=argv,
    )


if __name__ == "__main__":
    main()
