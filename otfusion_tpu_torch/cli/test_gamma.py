"""Legacy RIMA ensemble tester (port of ``otfusion_tpu.cli.test_gamma``;
reference test.py): restore trained fold checkpoints and evaluate the deep
ensemble on a GAMMA cohort with the uncertainty metrics; no training. Each
member's feature plan Tv comes from the whole cohort's features (kernel K1,
then K2, on CUDA).

Run: ``python -m otfusion_tpu_torch.cli.test_gamma --data-root
<root>/MGamma --label-file labels.csv --checkpoints <run>/fold0 <run>/fold1
--output metrics.json [--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from otfusion_tpu_torch.cli.common import (
    resolve_device,
    resolve_dtype,
    set_seed,
)
from otfusion_tpu_torch.cli.train_gamma import (
    add_gamma_args,
    build_model,
    eval_coupling,
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a deep ensemble of GAMMA fold checkpoints",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    add_gamma_args(parser)
    parser.add_argument("--checkpoints", type=str, nargs="+", required=True,
                        help="fold checkpoint directories (ensemble members)")
    parser.add_argument("--output", type=str, default=None,
                        help="write metrics JSON here")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)

    from otfusion_tpu_torch.data.gamma import GammaDataset, GammaLoader
    from otfusion_tpu_torch.train.ensemble import (
        collect_member_logits,
        evaluate_ensemble,
    )
    from otfusion_tpu_torch.train.legacy_steps import make_legacy_eval_step
    from otfusion_tpu_torch.utils.checkpoint import restore_checkpoint

    dataset = GammaDataset(args.data_root, args.label_file,
                           oct_shape=args.oct_shape,
                           fundus_size=args.fundus_size)
    loader = GammaLoader(dataset, range(len(dataset)), args.batch_size)
    eval_step = make_legacy_eval_step(
        compute_dtype=resolve_dtype(args.dtype))

    members, tvs = [], []
    for ckpt in args.checkpoints:
        # every parameter and buffer comes from the checkpoint: build the
        # member on the meta device, without drawing initial weights
        with torch.device("meta"):
            model = build_model(args, "meta")
        model = model.to_empty(device=device)
        restore_checkpoint(ckpt, model)
        members.append(model)
        tvs.append(eval_coupling(model, loader, eval_step, args, device))

    batches = [(f.to(device), o.to(device), l.to(device))
               for f, o, l in loader]
    member_logits, labels = collect_member_logits(members, eval_step,
                                                  batches, tvs)
    metrics = evaluate_ensemble(member_logits, labels)
    print(json.dumps(metrics, indent=2, default=float))
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2, default=float)
    return metrics


if __name__ == "__main__":
    main()
