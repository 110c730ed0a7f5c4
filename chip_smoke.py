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
  5. holds K2 at the base trainer's in-step inputs (FOT cost of 8 and of 4
     rows of 2048-dim features, eps 1e-3) against its plain version, and
     times it;
  6. drives every trainer through its CLI on one synthetic ADNI cohort,
     each with the kernels' launch counts zeroed just before and read just
     after, and checks its outputs:
       * the flagship (``train_ot_attn``, CLI defaults: depth 101, s2d
         stem, bf16, 128^3, cap 64) for 2 epochs: K2 launches as often as
         K1, once per coupling;
       * the base trainer (``train_mri_pet_ot``, same size) for 2 epochs:
         K2 once per train step, K1 never; then one full-width base step
         under ``torch.cuda.set_sync_debug_mode("error")`` (no host read
         in the step) and K2's device time inside a step;
       * at depth 18, 64^3, 1 epoch: the base trainer with ``--grad-accum
         2`` (K2 once per microbatch), ``train_mmfusion`` and
         ``train_unimodal --grad-accum 2`` (no kernel), and
         ``train_t1_t2_ot`` on the cohort's folders linked under the T1/T2
         class names.

Each kernel's ``bound_ms`` is the least time an H100 could take for the
work of this run's inputs (``k1_bound``, ``k2_bound``); ``library_ms`` is
null, since no single PyTorch call computes a Sinkhorn or a GW solve.
Every check that fails exits non-zero before the last line. The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it is the kernels' JSON summary (``launches`` counts every
trainer's launches; K2's ``base_*`` keys are its times at the base inputs,
B = 8). ``--kernels-only`` stops after phase 5 and prints no result line.
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
    k_it, r_it, k_err, r_err = (int(ker.n_iters), int(ref.n_iters),
                                float(ker.err), float(ref.err))
    t_max = float(ref.coupling.max())
    diff = float((ker.coupling - ref.coupling).abs().max())
    log(f"[k2] to exit: n_iters kernel {k_it} plain {r_it}; "
        f"converged {bool(ker.converged)}/{bool(ref.converged)}; err "
        f"{k_err:.3e}/{r_err:.3e}; max|dT| {diff:.3e} = {diff / t_max:.3e} "
        f"max T; mass {float(ker.coupling.sum()):.6f}; launches per solve "
        f"{per_solve}")
    check(per_solve == 1, "K2 took more than one launch for a solve")
    check(k_it == r_it, "K2 n_iters differ from the plain version")
    check(bool(ker.converged) == bool(ref.converged), "K2 converged differs")
    check(diff <= 1e-4 * t_max, "K2 plan differs by more than 1e-4 max T")
    check(k_err <= 1e-3 and r_err <= 1e-3,
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
    bound_ms, bound_by = k2_bound(n, m, k_it, 5)

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
    log(f"[k2] 2048x2048 solve to exit ({k_it} it): kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"fixed 64 it: kernel {fixed_ms:.4f} ms, plain {fixed_plain_ms:.4f} "
        f"ms, bound {k2_bound(n, m, 64, 1, checked=False)[0]:.4f} ms "
        f"(median of 20; {time.perf_counter() - t0:.2f} s)")
    return {"max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launches_per_solve": per_solve,
            "fixed64_ms": fixed_ms, "fixed64_plain_ms": fixed_plain_ms,
            "fixed64_max_abs_err": fdiff}


def _k2_base_case(b):
    """K2 at the base trainer's in-step inputs: FOT cost of two (b, 2048)
    feature sets under the identity plan eye(b) / b, eps 1e-3, scaled to
    max 1. Held against the plain solve run for the kernel's own iteration
    count (the checks do not change the duals), so an exit one check apart
    does not hide or fake a difference in the plan."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import correlated_groups, time_ms
    from otfusion_tpu_torch.ops import sinkhorn_kernel
    from otfusion_tpu_torch.ops.fot import feature_cost
    from otfusion_tpu_torch.ops.sinkhorn import sinkhorn

    x, y = correlated_groups(np.random.default_rng(2), 1, b, 2048)
    ts = torch.eye(b, device="cuda") / b
    cost = feature_cost(torch.from_numpy(x[0]).cuda(),
                        torch.from_numpy(y[0]).cuda(), ts).contiguous()
    kw = dict(epsilon=1e-3, threshold=1e-3, max_iterations=2000,
              scale_cost=True)
    before = sinkhorn_kernel.COUNTER.count
    ker = sinkhorn(cost, **kw)
    per_solve = sinkhorn_kernel.COUNTER.count - before
    ref = sinkhorn(cost, plain=True, **kw)
    k_it, r_it = int(ker.n_iters), int(ref.n_iters)
    n, m = cost.shape
    neg_c = (-(cost / cost.max()) / 1e-3).contiguous()
    log_w = torch.full((n,), -float(np.log(n)), device="cuda")
    args = (neg_c, log_w, log_w, log_w.exp(), 1e-3)
    same_count = sinkhorn_kernel.solve_plain(
        *args, max_iterations=k_it, check=False).plan
    t_max = float(same_count.max())
    diff = float((ker.coupling - same_count).abs().max())
    exit_diff = float((ker.coupling - ref.coupling).abs().max())
    log(f"[k2-base] B={b}: n_iters kernel {k_it} plain {r_it}; converged "
        f"{bool(ker.converged)}/{bool(ref.converged)}; err "
        f"{float(ker.err):.3e}/{float(ref.err):.3e}; max|dT| at the "
        f"kernel's count {diff:.3e} = {diff / t_max:.3e} max T (against the "
        f"plain exit {exit_diff / t_max:.3e}); launches per solve "
        f"{per_solve}")
    check(per_solve == 1, f"K2 B={b}: more than one launch for a solve")
    check(abs(k_it - r_it) <= 5,
          f"K2 B={b}: n_iters {k_it} and {r_it} more than one check apart")
    check(bool(ker.converged) and bool(ref.converged),
          f"K2 B={b}: a solve did not converge")
    check(diff <= K2_BASE_TOL * t_max,
          f"K2 B={b}: plan differs by more than {K2_BASE_TOL} max T")
    solve_kw = dict(max_iterations=2000, threshold=1e-3, check_every=5)
    ms = time_ms(lambda: sinkhorn_kernel.solve(*args, **solve_kw))
    plain_ms = time_ms(lambda: sinkhorn_kernel.solve_plain(*args, **solve_kw))
    bound_ms, bound_by = k2_bound(n, m, k_it, 5)
    log(f"[k2-base] B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}) (median of 20)")
    return {"base_ms": ms, "base_plain_ms": plain_ms,
            "base_bound_ms": bound_ms, "base_n_iters": k_it,
            "base_plain_n_iters": r_it, "base_max_abs_err": diff}


# K2 at eps 1e-3 against the plain solve at the same iteration count,
# relative to the plan's largest entry.
K2_BASE_TOL = 1e-4


def phase_k2_base():
    t0 = time.perf_counter()
    out = _k2_base_case(8)
    out["b4"] = _k2_base_case(4)
    log(f"[k2-base] phase {time.perf_counter() - t0:.2f} s")
    return out


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


def _drive(tag, module, argv):
    """Run ``module.main(argv)`` (a trainer's CLI, in-process) with every
    kernel's launch count zeroed just before and read just after; returns
    (result, launches, seconds)."""
    import torch

    from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel

    torch.cuda.synchronize()
    sinkhorn_kernel.COUNTER.reset()
    gw_kernel.COUNTER.reset()
    t0 = time.perf_counter()
    result = module.main(["--device", "cuda", *argv])
    launches = {"sinkhorn": sinkhorn_kernel.COUNTER.count,
                "gw": gw_kernel.COUNTER.count}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[{tag}] trainer {seconds:.2f} s; launches {launches}")
    return result, launches, seconds


def _check_rows(tag, out, epochs, result):
    """The run's artifacts and metrics rows; logs each epoch's phases and
    median step; returns the rows."""
    import numpy as np

    for name in ("results.txt", "metrics.jsonl", "model_config.json",
                 "best_model/checkpoint.pt", "latest/checkpoint.pt"):
        check((out / name).exists(), f"[{tag}] missing artifact {name}")
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    check(len(rows) == epochs, f"[{tag}] metrics.jsonl has {len(rows)} rows")
    for row in rows:
        for key in ("train_loss", "val_loss"):
            check(bool(np.isfinite(row[key])), f"[{tag}] {key} not finite: "
                  f"{row}")
        log(f"[{tag}] epoch {row['epoch']}: phase_seconds "
            f"{row['phase_seconds']}; train_loss {row['train_loss']:.4f} "
            f"val_loss {row['val_loss']:.4f}; median step "
            f"{row['median_step_ms']:.1f} ms")
    check(result["best_summary"] is not None, f"[{tag}] no best epoch")
    return rows


def _micro_total(n_train, batch, accum, epochs):
    """Train-step solves of the base trainer: each batch of n rows runs
    ``accum`` microbatches when accum > 1 divides n (n >= accum), else one
    (the JAX step's rule, otfusion_tpu/train/steps.py:110-111)."""
    sizes = [min(batch, n_train - i) for i in range(0, n_train, batch)]
    per_epoch = sum(accum if accum > 1 and n >= accum and n % accum == 0
                    else 1 for n in sizes)
    return epochs * per_epoch


def phase_flagship(data, work):
    """The flagship trainer at its CLI defaults for 2 epochs."""
    import numpy as np

    from otfusion_tpu_torch.cli import train_ot_attn

    t0 = time.perf_counter()
    out = work / "flagship"
    result, launches, _ = _drive("flagship", train_ot_attn, [
        "--epochs", "2", "--batch-size", "8", "--data-dir", str(data),
        "--save-path", str(out)])
    check(launches["sinkhorn"] > 0, "K2 was not launched by the flagship")
    check(launches["gw"] > 0, "K1 was not launched by the flagship")
    check(launches["sinkhorn"] == launches["gw"],
          "K2 did not launch once per coupling, as K1 does")
    rows = _check_rows("flagship", out, 2, result)
    for row in rows:
        clog = row["coupling_log"]
        check(len(clog["gw_outer_iters"]) == 2 and clog["fot_iters"] > 0,
              f"coupling_log incomplete: {clog}")
        log(f"[flagship] epoch {row['epoch']}: gw iters "
            f"{clog['gw_outer_iters']} fot iters {clog['fot_iters']}")
    tv = np.load(out / "t_feature.npy")
    check(tv.shape == (2048, 2048), f"Tv has shape {tv.shape}")
    check(bool(np.isfinite(tv).all()), "Tv is not finite")
    check(abs(float(tv.sum()) - 1.0) <= 1e-3,
          f"Tv mass {float(tv.sum())} is not 1 +- 1e-3")
    log(f"[flagship] phase {time.perf_counter() - t0:.2f} s")
    return launches


def phase_base(data, work):
    """The base trainer (K2 inside every train step) at full width for 2
    epochs; then one full-width base step under CUDA's sync debug mode."""
    from otfusion_tpu_torch.cli import train_mri_pet_ot

    t0 = time.perf_counter()
    out = work / "base"
    result, launches, _ = _drive("base", train_mri_pet_ot, [
        "--epochs", "2", "--batch-size", "8", "--data-dir", str(data),
        "--save-path", str(out)])
    n_train = len(json.loads((out / "train_split.json").read_text()))
    steps = _micro_total(n_train, 8, 1, 2)
    log(f"[base] {n_train} train samples: {steps} train steps")
    check(launches["sinkhorn"] == steps,
          f"K2 launched {launches['sinkhorn']} times for {steps} steps")
    check(launches["gw"] == 0, "K1 was launched by the base trainer")
    check(not (out / "t_feature.npy").exists(), "base saved t_feature.npy")
    rows = _check_rows("base", out, 2, result)
    step = _base_step_without_sync()
    log(f"[base] phase {time.perf_counter() - t0:.2f} s")
    return launches, {"median_step_ms": [r["median_step_ms"] for r in rows],
                      **step}


def _base_step_without_sync():
    """One base train step at full width (depth 101, 128^3, bf16, batch 8)
    under ``torch.cuda.set_sync_debug_mode("error")``: any host read inside
    the step, the in-step K2 solve included, raises. Also times the step and
    K2's device time inside it."""
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import K2_NAMES, device_ms, \
        time_ms
    from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
    from otfusion_tpu_torch.ops import sinkhorn_kernel
    from otfusion_tpu_torch.train.steps import make_fusion_train_step
    from otfusion_tpu_torch.train.train_state import make_optimizer

    torch.manual_seed(0)
    model = MultimodalOTFusion(depth=101, s2d_stem=True, variant="base").to(
        device="cuda", memory_format=torch.channels_last_3d)
    step = make_fusion_train_step(
        model, make_optimizer(model.parameters(), 1e-5), in_batch_fot=True,
        compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    mri, pet = (torch.randn((8, 128, 128, 128, 1), device="cuda",
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
    labels = torch.arange(8, device="cuda") % 2
    step(mri, pet, labels, None, gen)  # warm-up: cuDNN picks algorithms
    torch.cuda.synchronize()
    before = sinkhorn_kernel.COUNTER.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        met = step(mri, pet, labels, None, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = sinkhorn_kernel.COUNTER.count - before
    loss = float(met["loss"])
    log(f"[base] one step under set_sync_debug_mode('error'): no host "
        f"read; loss {loss:.4f}; K2 launches {launched}")
    check(launched == 1, "the base step did not solve on K2 once")
    check(loss == loss and abs(loss) < float("inf"), "base loss not finite")
    step_ms = time_ms(lambda: step(mri, pet, labels, None, gen), 5)
    k2_ms, events = device_ms(lambda: step(mri, pet, labels, None, gen),
                              K2_NAMES, 3)
    log(f"[base] full-width step {step_ms:.2f} ms (median of 5); K2 "
        f"{k2_ms:.4f} ms of it on the device ({events:.1f} launches per "
        f"step, {k2_ms / step_ms:.4f} of the step)")
    return {"step_ms": step_ms, "k2_device_ms_per_step": k2_ms}


def phase_small(data, work):
    """The other trainers for 1 epoch at depth 18, 64^3, batch 8: base
    with --grad-accum 2, mmfusion, unimodal with --grad-accum 2 (no
    kernel), and the T1/T2 trainer on the cohort's folders linked under
    its class names (K1 and K2 once per coupling)."""
    import os

    from otfusion_tpu_torch.cli import (
        train_mmfusion,
        train_mri_pet_ot,
        train_t1_t2_ot,
        train_unimodal,
    )

    small = ["--epochs", "1", "--batch-size", "8", "--model-depth", "18",
             "--target-shape", "64", "64", "64"]
    launches = {}
    t0 = time.perf_counter()
    out = work / "accum"
    result, got, _ = _drive("accum", train_mri_pet_ot, [
        *small, "--grad-accum", "2", "--data-dir", str(data),
        "--save-path", str(out)])
    n_train = len(json.loads((out / "train_split.json").read_text()))
    solves = _micro_total(n_train, 8, 2, 1)
    log(f"[accum] {n_train} train samples: {solves} microbatch solves")
    check(got["sinkhorn"] == solves,
          f"K2 launched {got['sinkhorn']} times for {solves} microbatches")
    check(got["gw"] == 0, "K1 was launched by the base trainer")
    _check_rows("accum", out, 1, result)
    launches["accum"] = got
    log(f"[accum] phase {time.perf_counter() - t0:.2f} s")

    for tag, module, extra in (
            ("mmfusion", train_mmfusion, []),
            ("unimodal", train_unimodal,
             ["--grad-accum", "2", "--classes", "AD", "CN"])):
        t0 = time.perf_counter()
        out = work / tag
        result, got, _ = _drive(tag, module, [
            *small, *extra, "--data-dir", str(data),
            "--save-path", str(out)])
        check(got == {"sinkhorn": 0, "gw": 0}, f"[{tag}] launched a kernel")
        _check_rows(tag, out, 1, result)
        launches[tag] = got
        log(f"[{tag}] phase {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    t1t2 = work / "adni_t1_t2"
    t1t2.mkdir()
    for cls, size in (("AD", 130), ("CN", 229)):
        for mod, seq in (("MRI", "T1"), ("PET", "T2")):
            os.symlink(data / f"{cls}_{mod}_{size}_FIN",
                       t1t2 / f"1204_{cls}_MRI_{seq}_FIN")
    out = work / "t1t2"
    result, got, _ = _drive("t1t2", train_t1_t2_ot, [
        *small, "--data-dir", str(t1t2), "--save-path", str(out)])
    check(got["gw"] > 0 and got["sinkhorn"] == got["gw"],
          "the T1/T2 trainer did not launch K1 and K2 once per coupling")
    check((out / "t_feature.npy").exists(), "[t1t2] no t_feature.npy")
    _check_rows("t1t2", out, 1, result)
    launches["t1t2"] = got
    log(f"[t1t2] phase {time.perf_counter() - t0:.2f} s")
    return launches


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel comparisons")
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
    k2_base = phase_k2_base()
    if args.kernels_only:
        log(f"[done] kernels only, {time.perf_counter() - t0:.2f} s")
        return

    import torch

    from otfusion_tpu_torch.data.synthetic import make_synthetic_adni

    # The comparison phases are over: the trainers run as a user's would,
    # with PyTorch's default precision settings.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory(prefix="otf_smoke_") as tmp:
        work = Path(tmp)
        t1 = time.perf_counter()
        data = make_synthetic_adni(work / "adni", n_per_class=96,
                                   shape=(64, 64, 64))
        log(f"[cohort] synthetic 2 x 96 at 64^3 "
            f"({time.perf_counter() - t1:.2f} s)")
        torch.cuda.reset_peak_memory_stats()
        runs = {"flagship": phase_flagship(data, work)}
        runs["base"], base = phase_base(data, work)
        runs.update(phase_small(data, work))
        log(f"[trainers] peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    total = {k: sum(r[k] for r in runs.values()) for k in ("sinkhorn", "gw")}
    log(f"[trainers] launches per run {json.dumps(runs)}; total {total}")
    log(f"[base] {json.dumps(base)}")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "launches_per_solve")
    base_keys = ("base_ms", "base_plain_ms", "base_bound_ms", "base_n_iters",
                 "base_max_abs_err")
    kernels = [
        {"name": "gw_solve", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/gw.cu",
         "replaces": "otfusion_tpu/experimental/gw_kernel.py:149",
         "launches": total["gw"], **{k: k1[k] for k in keys},
         "library_ms": None},
        {"name": "sinkhorn", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/sinkhorn.cu",
         "replaces": "otfusion_tpu/experimental/sinkhorn_kernel.py:131",
         "launches": total["sinkhorn"], **{k: k2[k] for k in keys},
         **{k: k2_base[k] for k in base_keys}, "library_ms": None},
    ]
    log(f"[done] {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
