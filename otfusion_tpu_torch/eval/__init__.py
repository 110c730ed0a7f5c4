"""The Perturb-OT coupling-evaluation harness (port of ``otfusion_tpu.eval``).

Scores OT coupling methods on matching quality (FOSCTTM, Z-class diagonal
fractions) and downstream cross-modal prediction (coupling-weighted OLS,
an MLP on barycentric targets) across inner/outer cross-validation,
leave-one-treatment-out, whole-dataset and FOT feature-matching runs. The
OT solves run on the device (kernels K1 and K2 on CUDA); the VAE matching
family is not ported yet.
"""

from otfusion_tpu_torch.eval.matching import (
    coupling_confusion_matrix,
    get_FOSCTTM,
    get_diag_fracs,
    get_rel_mse,
)
from otfusion_tpu_torch.eval.prediction import get_evals, get_evals_preds
from otfusion_tpu_torch.eval.predictors import (
    make_G,
    ols_normed,
    predict,
    train_mlp,
    weight_1_ols_normed,
    weight_conc_normed,
    weighted_ols_normed,
)
from otfusion_tpu_torch.eval.harness import (
    OT_METHOD_HYPERPARAMS,
    OT_METHOD_MAP,
    run_all,
    run_feature_matching,
    run_grid,
    run_inner_cv,
    run_loo,
    run_outer_cv,
)

__all__ = [
    "coupling_confusion_matrix",
    "get_FOSCTTM",
    "get_diag_fracs",
    "get_rel_mse",
    "get_evals",
    "get_evals_preds",
    "make_G",
    "ols_normed",
    "predict",
    "train_mlp",
    "weight_1_ols_normed",
    "weight_conc_normed",
    "weighted_ols_normed",
    "OT_METHOD_HYPERPARAMS",
    "OT_METHOD_MAP",
    "run_all",
    "run_feature_matching",
    "run_grid",
    "run_inner_cv",
    "run_loo",
    "run_outer_cv",
]
