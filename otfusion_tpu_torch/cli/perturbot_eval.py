"""CLI for the Perturb-OT evaluation harness (port of
``otfusion_tpu.cli.perturbot_eval``).

Mirrors the reference's five eval entry points (perturbot/perturbot/eval/
cv_inner_loop.py, cv_outer_loop.py, loo.py, all.py, feature_matching.py)
as subcommands of one command, with the reference's positional argument
order (method, [test_idx], filepath, [eps]) and its output-file naming
(``val_CV_{method}.{test_idx}.pkl``, ``test_{method}.{test_idx}.pkl``,
``all_{method}.{eps}.pkl``, ``features_{method}.{eps}.pkl``). The LSF
``bsub`` submitters are replaced by the ``grid`` subcommand, which runs
the same epsilon/fold grid in-process.

Input data: a pickle (or ``.npz`` with the same keys) holding the
reference's chemical-screen layout — ``Xs_dict``, ``Xt_dict``,
``Zs_dict``/``Zt_dict`` (optionally nested under ``"dosage"``).

``--device cuda`` (the default; it raises without a GPU) runs the OT
solves and the MLP on the card, kernels K1 and K2 included; ``--device
cpu`` runs their plain versions. The VAE methods and ``loo --latent-vae``
raise ``NotImplementedError``: they are not ported yet.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from otfusion_tpu_torch.eval import harness
from otfusion_tpu_torch.utils.device import resolve_device


def _parse_eps(text: str):
    """Float for OT methods; "adv,latent_dim,lr" tuple for VAE methods
    (the reference's hyperparameter triple, cv_inner_loop.py:121-129)."""
    if "," in text:
        a, d, lr = text.split(",")
        return (float(a), int(d), float(lr))
    return float(text)


def _load_data(path: str):
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p, allow_pickle=True) as z:
            return {k: z[k].item() for k in z.files}
    with open(p, "rb") as f:
        return pickle.load(f)


def _dump(obj, path: str, verbose: bool = True):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    if verbose:
        print(f"wrote {path}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="otfusion-perturbot-eval",
        description="Perturb-OT coupling evaluation harness (PyTorch/CUDA)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda raises when no GPU is present; it never "
                             "falls back to the CPU")
    parser.add_argument("--z-key", type=str, default="dosage",
                        help="Side-information key inside Zs/Zt dicts")
    parser.add_argument("--out-dir", type=str, default=".",
                        help="Directory for the output pickles")
    parser.add_argument("--epsilons", type=float, nargs="*", default=None,
                        help="Override the hyperparameter grid")
    parser.add_argument("--n-splits", type=int, default=5)
    parser.add_argument("--quiet", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inner-cv", help="inner hyperparameter CV "
                       "(cv_inner_loop.py parity)")
    p.add_argument("method", choices=sorted(harness.OT_METHOD_MAP))
    p.add_argument("test_idx", type=int)
    p.add_argument("filepath", type=str)

    p = sub.add_parser("outer-cv", help="outer test evaluation "
                       "(cv_outer_loop.py parity)")
    p.add_argument("method", choices=sorted(harness.OT_METHOD_MAP))
    p.add_argument("test_idx", type=int)
    p.add_argument("filepath", type=str)
    p.add_argument("eps", type=str,
                   help="match_eps,lin_eps,pred_eps (reference triple; "
                        "lin_eps is parsed and ignored, as upstream's "
                        "PC-space block is commented out)")
    p.add_argument("-b", "--baseline", type=str, default=None,
                   choices=["perfect", "random", "by_conc"])
    p.add_argument("-p", "--pred-filepath", type=str, default=None,
                   help="data pickle with full features for prediction")

    p = sub.add_parser("loo", help="leave-one-treatment-out (loo.py parity)")
    p.add_argument("method", choices=sorted(harness.OT_METHOD_MAP))
    p.add_argument("filepath", type=str)
    p.add_argument("eps", type=_parse_eps,
                   help="epsilon, or adv,latent_dim,lr for VAE methods")
    p.add_argument("--latent-vae", action="store_true",
                   help="VAE-then-OT: train a per-modality VAE per fold "
                        "and couple the latents (not ported yet: raises)")
    p.add_argument("--latent-dim", type=int, default=10,
                   help="per-modality VAE latent width (scVI default)")

    p = sub.add_parser("all", help="whole-dataset matching run "
                       "(all.py parity)")
    p.add_argument("method", choices=sorted(harness.OT_METHOD_MAP))
    p.add_argument("filepath", type=str)
    p.add_argument("eps", type=_parse_eps,
                   help="epsilon, or adv,latent_dim,lr for VAE methods")

    p = sub.add_parser("feature-matching", help="feature-level FOT "
                       "(feature_matching.py parity)")
    p.add_argument("method", type=str,
                   help="OT method name or perfect/random/by_conc")
    p.add_argument("filepath", type=str)
    p.add_argument("best_eps", type=float,
                   help="sample-coupling eps (0 = baseline methods)")
    p.add_argument("eps", type=float, help="feature-OT eps")

    p = sub.add_parser("grid", help="run a whole eps/fold grid in-process "
                       "(replaces the LSF submitters)")
    p.add_argument("kind", choices=["all", "inner-cv", "feature-matching"])
    p.add_argument("method", type=str)
    p.add_argument("filepath", type=str)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    say = (lambda s: None) if args.quiet else (lambda s: print(s, flush=True))
    data = _load_data(args.filepath)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    if args.cmd == "inner-cv":
        result = harness.run_inner_cv(
            data, args.method, args.test_idx, epsilons=args.epsilons,
            n_splits=args.n_splits, z_key=args.z_key, progress=say,
            device=device,
        )
        _dump(result["best_eps"],
              out / f"val_CV_{args.method}.{args.test_idx}.best_eps.pkl")
        _dump(result, out / f"val_CV_{args.method}.{args.test_idx}.pkl")
    elif args.cmd == "outer-cv":
        parts = tuple(map(float, args.eps.split(",")))
        match_eps, pred_eps = parts[0], parts[-1]
        result = harness.run_outer_cv(
            data, args.method, args.test_idx, match_eps, pred_eps,
            baseline=args.baseline,
            pred_data=(_load_data(args.pred_filepath)
                       if args.pred_filepath else None),
            n_splits=args.n_splits, z_key=args.z_key, device=device,
        )
        _dump(result, out / f"test_{args.method}.{args.test_idx}.pkl")
    elif args.cmd == "loo":
        if args.latent_vae:
            rows, log = harness.run_loo_latent(
                data, args.method, args.eps, latent_dim=args.latent_dim,
                z_key=args.z_key, progress=say, device=device,
            )
            _dump({"evals": rows, "log": log},
                  out / f"loo_vae_{args.method}.{args.eps}.pkl")
        else:
            rows, log = harness.run_loo(
                data, args.method, args.eps, z_key=args.z_key, progress=say,
                device=device,
            )
            _dump({"evals": rows, "log": log},
                  out / f"loo_{args.method}.{args.eps}.pkl")
    elif args.cmd == "all":
        result = harness.run_all(data, args.method, args.eps,
                                 z_key=args.z_key, device=device)
        _dump(result, out / f"all_{args.method}.{args.eps}.pkl")
    elif args.cmd == "feature-matching":
        result = harness.run_feature_matching(
            data, args.method, args.eps,
            best_eps=(args.best_eps if args.best_eps != 0 else None),
            z_key=args.z_key, device=device,
        )
        _dump(result, out / f"features_{args.method}.{args.eps}.pkl")
    elif args.cmd == "grid":
        results = harness.run_grid(
            data, args.method, kind=args.kind, epsilons=args.epsilons,
            n_splits=args.n_splits, z_key=args.z_key, progress=say,
            device=device,
        )
        _dump(results, out / f"grid_{args.kind}_{args.method}.pkl")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
