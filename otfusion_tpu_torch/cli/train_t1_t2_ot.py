"""MRI T1+T2 OT fusion trainer: the flagship architecture (per-epoch
coupling, kernels K1 and K2 on a GPU) on T1/T2 pairs, class folders
``1204_{AD,CN}_MRI_T{1,2}_FIN``.

    python -m otfusion_tpu_torch.cli.train_t1_t2_ot --data-dir <ADNI root>
"""

from otfusion_tpu_torch.cli._fusion_main import fusion_main

CLASS_NAMES_T1 = {"1204_AD_MRI_T1_FIN": 0, "1204_CN_MRI_T1_FIN": 1}
CLASS_NAMES_T2 = {"1204_AD_MRI_T2_FIN": 0, "1204_CN_MRI_T2_FIN": 1}


def main(argv=None):
    return fusion_main(
        variant="per_epoch_attn",
        description="Train multimodal MRI T1-T2 model with Optimal Transport",
        default_save_path="results/MRI_T1_T2_OT/all",
        class_names_a=CLASS_NAMES_T1,
        class_names_b=CLASS_NAMES_T2,
        argv=argv,
    )


if __name__ == "__main__":
    main()
