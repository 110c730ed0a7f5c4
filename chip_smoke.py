#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It

  1. prints the card (``nvidia-smi``), torch and CUDA versions, and turns
     TF32 off for the comparison phases;
  2. builds the CUDA kernels of ``otfusion_tpu_torch/csrc`` with ``nvcc``
     (one process per source, in parallel);
  3. holds kernel K2 (Sinkhorn, one launch per solve) against its plain
     PyTorch version on a 2048 x 2048 FOT-shaped cost, to the exit and at
     64 fixed iterations, and times the solve;
  4. holds kernel K1 (per-label GW, a thread-block cluster per label)
     against its plain version at 2 labels x cap 64 from 2048-dim features
     (one label padded to 50 rows), and at cap 128, and times it;
  5. drives the flagship trainer (``python -m
     otfusion_tpu_torch.cli.train_ot_attn``, CLI defaults: depth 101, s2d
     stem, bf16, 128^3, 64 samples per label) for 2 epochs on a synthetic
     ADNI cohort, with the kernels' launch counts zeroed before and read
     after (K2 must launch as often as K1: once per coupling), and checks
     its outputs.

Each kernel's ``bound_ms`` is the least time an H100 could take for the
work of this run's inputs (``k1_bound``, ``k2_bound``); ``library_ms`` is
null, since no single PyTorch call computes a Sinkhorn or a GW solve.
Every check that fails exits non-zero before the last line. The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it is the kernels' JSON summary. ``--kernels-only`` stops
after phase 4 and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = REPO / "otfusion_tpu_torch"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(smi_line(), flush=True)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN in the comparison phases "
        f"({time.perf_counter() - t0:.2f} s)")


def phase_build():
    from otfusion_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    seconds = cuda_build.build_all()
    for name in ("sinkhorn", "gw"):
        cuda_build.load_library(name)
        report = cuda_build._target(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    log(f"[build] nvcc per source {json.dumps(seconds)}; phase "
        f"{time.perf_counter() - t0:.2f} s")


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of bytes over the HBM rate and fp32
    operations over the fp32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound(n, m, n_iters, check_every, checked=True):
    """K2's work at these inputs: 2 passes per iteration (f and g), one per
    error check, one for the plan, 4 fp32 operations per entry and pass (a
    dual added, the max subtracted, an exp, a sum); the cost read once and
    the plan written once."""
    checks = 1 + (n_iters - 1) // check_every if checked else 0
    passes = 2 * n_iters + checks + 1
    return bound(8.0 * n * m, 4.0 * passes * n * m)


def k1_bound(L, cap, n_iters, inner_sweeps=10):
    """K1's work: per micro-step two cap^3 products (2 operations per FMA),
    2 * inner_sweeps passes and the plan over cap^2 entries at 4 operations
    per entry; each label for its own micro-step count. Bytes: Cx, Cy read
    once, T written once."""
    flops = sum(it * (4.0 * cap ** 3 + 4.0 * (2 * inner_sweeps + 1) * cap ** 2)
                for it in n_iters)
    return bound(12.0 * L * cap * cap, flops)


def phase_k2():
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import correlated_groups, time_ms
    from otfusion_tpu_torch.ops import sinkhorn_kernel
    from otfusion_tpu_torch.ops.fot import feature_cost
    from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
    from otfusion_tpu_torch.ops.sinkhorn_kernel import sinkhorn_fixed

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x, y = correlated_groups(rng, 1, 128, 2048)
    x = torch.from_numpy(x[0]).cuda()
    y = torch.from_numpy(y[0]).cuda()
    ts = torch.eye(128, device="cuda") / 128
    cost = feature_cost(x, y, ts).contiguous()
    kw = dict(epsilon=5e-3, threshold=1e-3, max_iterations=2000,
              scale_cost=True)
    before = sinkhorn_kernel.COUNTER.count
    ker = sinkhorn(cost, **kw)
    per_solve = sinkhorn_kernel.COUNTER.count - before
    ref = sinkhorn(cost, plain=True, **kw)
    torch.cuda.synchronize()
    t_max = float(ref.coupling.max())
    diff = float((ker.coupling - ref.coupling).abs().max())
    log(f"[k2] to exit: n_iters kernel {ker.n_iters} plain {ref.n_iters}; "
        f"converged {ker.converged}/{ref.converged}; err {ker.err:.3e}/"
        f"{ref.err:.3e}; max|dT| {diff:.3e} = {diff / t_max:.3e} max T; "
        f"mass {float(ker.coupling.sum()):.6f}; launches per solve "
        f"{per_solve}")
    check(per_solve == 1, "K2 took more than one launch for a solve")
    check(ker.n_iters == ref.n_iters, "K2 n_iters differ from the plain version")
    check(ker.converged == ref.converged, "K2 converged differs")
    check(diff <= 1e-4 * t_max, "K2 plan differs by more than 1e-4 max T")
    check(ker.err <= 1e-3 and ref.err <= 1e-3,
          "K2 row-marginal L1 errors not within the threshold")

    # The solve alone, on the cost the solver builds (neg_c = -C / eps).
    n, m = cost.shape
    neg_c = (-(cost / cost.max()) / 5e-3).contiguous()
    log_w = torch.full((n,), -float(np.log(n)), device="cuda")
    p_w = log_w.exp()
    args = (neg_c, log_w, log_w, p_w, 5e-3)
    solve_kw = dict(max_iterations=2000, threshold=1e-3, check_every=5)
    ms = time_ms(lambda: sinkhorn_kernel.solve(*args, **solve_kw))
    plain_ms = time_ms(lambda: sinkhorn_kernel.solve_plain(*args, **solve_kw))
    bound_ms, bound_by = k2_bound(n, m, ker.n_iters, 5)

    fk = sinkhorn_fixed(cost, epsilon=5e-3, n_iters=64)
    fr = sinkhorn_fixed(cost, epsilon=5e-3, n_iters=64, plain=True)
    fdiff = float((fk - fr).abs().max())
    fmax = float(fr.max())
    log(f"[k2] fixed 64 iterations: max|dT| {fdiff:.3e} = "
        f"{fdiff / fmax:.3e} max T")
    check(fdiff <= 1e-4 * fmax, "K2 fixed-iteration plan differs")
    fixed_ms = time_ms(lambda: sinkhorn_kernel.solve(
        *args, max_iterations=64, check=False))
    fixed_plain_ms = time_ms(lambda: sinkhorn_kernel.solve_plain(
        *args, max_iterations=64, check=False))
    log(f"[k2] 2048x2048 solve to exit ({ker.n_iters} it): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"fixed 64 it: kernel {fixed_ms:.4f} ms, plain {fixed_plain_ms:.4f} "
        f"ms, bound {k2_bound(n, m, 64, 1, checked=False)[0]:.4f} ms "
        f"(median of 20; {time.perf_counter() - t0:.2f} s)")
    return {"max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launches_per_solve": per_solve,
            "fixed64_ms": fixed_ms, "fixed64_plain_ms": fixed_plain_ms,
            "fixed64_max_abs_err": fdiff}


def _gw_inputs(cap, pad_rows):
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import correlated_groups

    rng = np.random.default_rng(1)
    x, y = correlated_groups(rng, 2, cap, 2048)
    mask = np.ones((2, cap), bool)
    if pad_rows is not None:
        mask[1, pad_rows:] = False
        x[1, pad_rows:] = 0.0
        y[1, pad_rows:] = 0.0
    to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return to(x), to(y), to(mask), mask


def _check_gw(tag, ker, ref, mask):
    import torch

    t_k, t_r = ker.coupling, ref.coupling
    diff = float((t_k - t_r).abs().max())
    close = bool(torch.allclose(t_k, t_r, rtol=1e-3, atol=1e-6))
    it_k = ker.n_iters.tolist()
    it_r = ref.n_iters.tolist()
    log(f"[k1] {tag}: n_iters kernel {it_k} plain {it_r}; max|dT| "
        f"{diff:.3e}; allclose(rtol 1e-3, atol 1e-6) {close}")
    check(close, f"K1 {tag} plans differ beyond rtol 1e-3 / atol 1e-6")
    for lbl in range(mask.shape[0]):
        n_valid = int(mask[lbl].sum())
        pad_mass = float(t_k[lbl, n_valid:].abs().sum()
                         + t_k[lbl, :, n_valid:].abs().sum())
        check(pad_mass == 0.0, f"K1 {tag} label {lbl} has mass on padding")
    if it_k != it_r:
        log(f"[k1] {tag}: n_iters differ (kernel {it_k}, plain {it_r})")
        check(all(abs(a - b) <= 8 for a, b in zip(it_k, it_r)),
              f"K1 {tag} n_iters more than one check apart")
    return diff


def _k1_case(cap, pad_rows, runs):
    """K1 against its plain version at 2 labels x ``cap``; times of the
    solve alone (on the prepared costs) and of ``egw_per_label``."""
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.ops import gw_kernel
    from otfusion_tpu_torch.ops.gromov import _prep, egw_per_label

    x, y, m, mask = _gw_inputs(cap, pad_rows)
    before = gw_kernel.COUNTER.count
    ker = egw_per_label(x, y, m, m)
    per_solve = gw_kernel.COUNTER.count - before
    ref = egw_per_label(x, y, m, m, plain=True)
    torch.cuda.synchronize()
    diff = _check_gw(f"L=2 cap={cap} d=2048", ker, ref, mask)
    check(per_solve == 1, "K1 took more than one launch for a solve")
    cx, p, log_p = _prep(x, m)
    cy, q, log_q = _prep(y, m)
    args = (cx, cy, log_p, log_q, p, q)
    ms = time_ms(lambda: gw_kernel.gw_solve(*args), runs)
    plain_ms = time_ms(lambda: gw_kernel.gw_solve_plain(*args), runs)
    with_prep_ms = time_ms(lambda: egw_per_label(x, y, m, m), runs)
    bound_ms, bound_by = k1_bound(2, cap, ker.n_iters.tolist())
    log(f"[k1] cap {cap}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"egw_per_label with prep {with_prep_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}) (median of {runs})")
    return {"max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
            "with_prep_ms": with_prep_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "launches_per_solve": per_solve}


def phase_k1():
    t0 = time.perf_counter()
    k1 = _k1_case(64, 50, 20)
    k1_128 = _k1_case(128, None, 5)
    log(f"[k1] phase {time.perf_counter() - t0:.2f} s")
    return {**k1, "cap128": k1_128}


def phase_main_path():
    """The flagship trainer through its CLI, in-process, on a synthetic
    cohort; returns the kernels' launch counts from this run."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli import train_ot_attn
    from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
    from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel

    t0 = time.perf_counter()
    # The comparison phases are over: the trainer runs as a user would,
    # with PyTorch's default precision settings.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(prefix="otf_smoke_") as tmp:
        data = Path(tmp) / "adni"
        out = Path(tmp) / "run"
        make_synthetic_adni(data, n_per_class=96, shape=(64, 64, 64))
        log(f"[main] synthetic cohort 2 x 96 at 64^3 "
            f"({time.perf_counter() - t0:.2f} s)")
        torch.cuda.reset_peak_memory_stats()
        sinkhorn_kernel.COUNTER.reset()
        gw_kernel.COUNTER.reset()
        t1 = time.perf_counter()
        result = train_ot_attn.main([
            "--device", "cuda", "--epochs", "2", "--batch-size", "8",
            "--data-dir", str(data), "--save-path", str(out),
        ])
        launches = {"sinkhorn": sinkhorn_kernel.COUNTER.count,
                    "gw": gw_kernel.COUNTER.count}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[main] trainer {wall:.2f} s; launches {launches}; "
            f"peak memory {peak:.2f} GiB")
        check(launches["sinkhorn"] > 0, "K2 was not launched by the trainer")
        check(launches["gw"] > 0, "K1 was not launched by the trainer")
        check(launches["sinkhorn"] == launches["gw"],
              "K2 did not launch once per coupling, as K1 does")

        for name in ("t_feature.npy", "results.txt", "metrics.jsonl",
                     "model_config.json", "best_model/checkpoint.pt",
                     "latest/checkpoint.pt"):
            check((out / name).exists(), f"missing artifact {name}")
        tv = np.load(out / "t_feature.npy")
        check(tv.shape == (2048, 2048), f"Tv has shape {tv.shape}")
        check(bool(np.isfinite(tv).all()), "Tv is not finite")
        check(abs(float(tv.sum()) - 1.0) <= 1e-3,
              f"Tv mass {float(tv.sum())} is not 1 +- 1e-3")
        rows = [json.loads(line) for line in
                (out / "metrics.jsonl").read_text().splitlines()]
        check(len(rows) == 2, f"metrics.jsonl has {len(rows)} rows")
        for row in rows:
            for key in ("train_loss", "val_loss"):
                check(np.isfinite(row[key]), f"{key} not finite: {row}")
            clog = row["coupling_log"]
            check(len(clog["gw_outer_iters"]) == 2 and clog["fot_iters"] > 0,
                  f"coupling_log incomplete: {clog}")
            log(f"[main] epoch {row['epoch']}: phase_seconds "
                f"{row['phase_seconds']}; train_loss {row['train_loss']:.4f} "
                f"val_loss {row['val_loss']:.4f}; gw iters "
                f"{clog['gw_outer_iters']} fot iters {clog['fot_iters']}; "
                f"median step {row['median_step_ms']:.1f} ms")
        check(result["best_summary"] is not None, "no best epoch recorded")
    log(f"[main] phase {time.perf_counter() - t0:.2f} s")
    return launches


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel comparisons (phase 4)")
    args = parser.parse_args(argv)
    if not (PACKAGE / "csrc").is_dir():
        fail(f"{PACKAGE} not found: run chip_smoke.py from a checkout of "
             "the repository")
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    k2 = phase_k2()
    k1 = phase_k1()
    if args.kernels_only:
        log(f"[done] kernels only, {time.perf_counter() - t0:.2f} s")
        return
    launches = phase_main_path()

    import torch

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "launches_per_solve")
    kernels = [
        {"name": "gw_solve", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/gw.cu",
         "replaces": "otfusion_tpu/experimental/gw_kernel.py:149",
         "launches": launches["gw"], **{k: k1[k] for k in keys},
         "library_ms": None},
        {"name": "sinkhorn", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/sinkhorn.cu",
         "replaces": "otfusion_tpu/experimental/sinkhorn_kernel.py:131",
         "launches": launches["sinkhorn"], **{k: k2[k] for k in keys},
         "library_ms": None},
    ]
    log(f"[done] {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
