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
     times it; then at the non-square feature plans of heterogeneous
     backbones, (6144, 768), (768, 6144), (768, 1024) and (2048, 6144)
     (the last on the device route): the same n_iters, the plan within
     1e-4 of max T, route and times logged;
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
         class names;
 6b. checks the PNGs the flagship and unimodal runs wrote
     (``confusion_matrix.png`` 1000 x 800, ``tsne_best_val.png`` 800 x
     600), runs the t-SNE on the card and on the CPU at the flagship's
     validation logits (38 x 2) and at 512 x 2048 features in two clusters
     (P within 1e-6, the PCA start and the first 10 iterations alike, at
     most 21 host reads on the card under CUDA's sync debug mode; at 512
     also the same iteration count and KL within 5 %), runs
     ``preprocess_volume`` of a 256 x 256 x 176 volume to 128^3 on the card
     against the CPU (1e-5; median ms of 20), drives every subcommand of
     ``data_tools``, ``harvard30k``, ``aggregate_results`` and
     ``generate_split`` on fixtures it writes (a DICOM series, two
     Harvard-30k records in a zip, a run tree, a patient-ID list) and reads
     each output back, and checks that none of matplotlib, scikit-learn,
     PIL, pydicom or JAX is loaded (``phase_artifacts``);
  7. serves the flagship's run through ``cli/predict.py`` (B16, all 192
     subjects) with BatchNorm folded and unfolded, in bf16 (the run's
     dtype) and in float32 (TF32 off): in float32 the same predictions and
     probabilities within 1e-4; in bf16 the unfolded serve within 1e-2 of
     the trainer's own bf16 eval of the same weights on the val subjects,
     and each serve within a fixed bound of its float32 serve; no OT
     kernel launched;
  8. drives the run lifecycle at depth 18, 64^3, 1 epoch each: a plain-stem
     unimodal run, served with ``--stem auto`` and ``as-trained`` (held as
     in 7); the flagship from pretrained backbones (that run's
     ``best_model`` and a seeded ``.pth``; every tensor grafted, as the
     trainer's result counts), K1 = K2 = 2; the same flagship
     ``--resume``d to epoch 2, K1 = K2 = 2; the base trainer with
     ``--remat --grad-accum 2``, K2 once per microbatch;
  9. runs one full-width flagship train step with remat off and on (peak
     memory lower with it, the same loss, gradients within 1e-2 under
     deterministic cuDNN), then the flagship ``--batch-size 16 --grad-accum
     2 --remat`` for 1 epoch. The flagship's and base trainer's runs log
     their checkpoint phase and the final flush's wait;
 10. drives the model zoo at full width: the flagship with UNETR (MRI) and
     MedicalNet-10 (PET) at 96^3 for 2 epochs (Tv (6144, 768), mass 1; K1
     and K2 as often as the default flagship's), the base trainer the
     other way round for 1 epoch (K2 once a step on a (768, 6144) plan, K1
     never), the first run served as in 7 (MedicalNet folded and not), and
     BASELINE.json config 5: Swin-B/384 (remat on) + UNETR grafted from
     official-layout ``.pth`` files (every tensor read lands), a bf16
     feature pass over 2 x 64 random pairs, the coupling (K1, then K2 on
     (768, 1024)) and 5 bf16 train steps, median step and peak logged;
     the hetero serve's gap to the trainer's own bf16 eval is logged as
     ``[fault2]`` (the classifier heads compute in float32);
 11. drives the Perturb-OT evaluation harness (``phase_perturbot``) on a
     synthetic screen of 10 labels x 80-96 rows, d = d' = 2048, post-ReLU
     with ~5 % dead channels: K1 at 10 labels x cap 96 against its plain
     version, and K2 on a padded label's masked sample cost (eps 1e-2,
     1e-4 and 1e-5), on LEOT's plan-masked cost over all rows and on
     COOT's 2048^2 feature cost with zero marginals against the plain
     version run on the CPU (the same n_iters, the duals within 1e-4, the
     plan within 1e-4 of max T, 1e-2 below eps 1e-3), times beside the
     bound; then
     ``cli/perturbot_eval.py all`` for EGW_ott, EGWL_ott, LEOT_ott and
     ECOOTL and ``feature-matching EGW_ott``, each with its launches
     (finite couplings, FOSCTTM below the random coupling's); then all
     nine OT methods on a small screen with ``--device cuda`` and
     ``--device cpu`` (plans and metrics within 1e-4, the same counts);
11b. holds K1's device route (labels above 128 rows: one cooperative
     launch, the labels in device memory) against its plain version on the
     card at 2 labels x cap 129 (one padded), at 4 labels x 200-400 rows
     and at phase 11's whole screen as one label (``EGW_all_ott``'s input):
     the same n_iters (or one check apart, logged), the plan within 1e-4 of
     max T, one launch, times beside the bound; then ``all EGW_all_ott`` on
     phase 11's screen and ``all EGW_ott`` on the 4-label screen, each on
     ``--device cuda`` and ``--device cpu`` (couplings within 1e-4 of max
     T, FOSCTTM below the random coupling's, one device-route launch);
11c. drives the harness's VAE family on phase 11's screen: ``all
     VAE_label`` (10,128,1e-4: 600 steps), ``loo VAE`` and ``loo EGW_ott
     --latent-vae`` (two 10-wide VAEs of 500 steps a fold, K1 once a fold;
     the VAE methods launch no kernel): finite outputs, the last step's
     reconstruction below the first's; then the first 10 steps of
     ``train_vae_model`` and ``train_modality_vae`` from the same weights
     and noise, the card against the CPU in float64 (losses within 1e-4,
     99.9 % of the parameters within 1e-5) and the card's float32 against
     its float64 (losses within 1e-3: Adam amplifies float32 rounding), and
     each trainer's step loop under ``torch.cuda.set_sync_debug_mode
     ("error")`` (no host read), ms a step.

Each kernel's ``bound_ms`` is the least time an H100 could take for the
work of this run's inputs (``k1_bound``, ``k2_bound``); ``library_ms`` is
null, since no single PyTorch call computes a Sinkhorn or a GW solve.
Every check that fails exits non-zero before the last line. The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it is the kernels' JSON summary (``launches`` counts every
run's launches; K2's ``base_*`` keys are its times at the base inputs,
B = 8, ``hetero`` its times at the hetero plans, each kernel's
``perturbot`` its times at the harness's inputs and ``gamma`` at the
legacy GAMMA trainer's; K1's device route is an entry of its own, timed at
phase 11's whole screen, its ``cases`` at all three inputs).
``--kernels-only`` stops after phase 5 and prints no result line.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
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


# K2 at the feature plans of heterogeneous backbones: (d_pet, d_mri) of the
# hetero flagship (MedicalNet-10 at 96^3 against UNETR), of the hetero base
# trainer (the other way round), of BASELINE config 5 (UNETR against
# Swin-B/384) and of MedicalNet-10 at 96^3 against a 2048-wide ResNet (the
# device route: its band does not fit in shared memory).
K2_HETERO_SHAPES = ((6144, 768), (768, 6144), (768, 1024), (2048, 6144))


def _correlated_features(rng, b, d_x, d_y):
    """(b, d_x) and (b, d_y) fp32 feature sets sharing an 8-dim latent, as
    two backbones' features of the same subjects are."""
    import numpy as np

    z = rng.normal(size=(b, 8))
    x = z @ rng.normal(size=(8, d_x)) + 0.05 * rng.normal(size=(b, d_x))
    y = z @ rng.normal(size=(8, d_y)) + 0.05 * rng.normal(size=(b, d_y))
    return x.astype(np.float32), y.astype(np.float32)


def phase_k2_hetero():
    """K2 against its plain version on FOT-shaped (d_pet, d_mri) costs of 128
    correlated subjects under the identity plan, eps 5e-3, to the exit: the
    same n_iters, the plan within 1e-4 of max T; route and times logged."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.ops import sinkhorn_kernel
    from otfusion_tpu_torch.ops.fot import feature_cost
    from otfusion_tpu_torch.ops.sinkhorn import sinkhorn

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for n, m in K2_HETERO_SHAPES:
        x, y = _correlated_features(np.random.default_rng(n + m), 128, n, m)
        ts = torch.eye(128, device="cuda") / 128
        cost = feature_cost(torch.from_numpy(x).cuda(),
                            torch.from_numpy(y).cuda(), ts).contiguous()
        kw = dict(epsilon=5e-3, threshold=1e-3, max_iterations=2000,
                  scale_cost=True)
        before = sinkhorn_kernel.COUNTER.count
        ker = sinkhorn(cost, **kw)
        per_solve = sinkhorn_kernel.COUNTER.count - before
        ref = sinkhorn(cost, plain=True, **kw)
        k_it, r_it = int(ker.n_iters), int(ref.n_iters)
        t_max = float(ref.coupling.max())
        diff = float((ker.coupling - ref.coupling).abs().max())
        lay = sinkhorn_kernel.sinkhorn_layout(n, m, sms)
        tag = f"{n}x{m}"
        log(f"[k2-hetero] {tag}: route {lay.route} (grid {lay.grid}, "
            f"{lay.rows} rows per block, {lay.smem_bytes} B shared); n_iters "
            f"kernel {k_it} plain {r_it}; converged {bool(ker.converged)}/"
            f"{bool(ref.converged)}; max|dT| {diff:.3e} = {diff / t_max:.3e} "
            f"max T; mass {float(ker.coupling.sum()):.6f}")
        check(per_solve == 1, f"K2 {tag}: more than one launch for a solve")
        check(k_it == r_it, f"K2 {tag}: n_iters {k_it} and {r_it} differ")
        check(diff <= 1e-4 * t_max,
              f"K2 {tag}: plan differs by more than 1e-4 max T")
        neg_c = (-(cost / cost.max()) / 5e-3).contiguous()
        log_p = torch.full((n,), -float(np.log(n)), device="cuda")
        log_q = torch.full((m,), -float(np.log(m)), device="cuda")
        args = (neg_c, log_p, log_q, log_p.exp(), 5e-3)
        solve_kw = dict(max_iterations=2000, threshold=1e-3, check_every=5)
        ms = time_ms(lambda: sinkhorn_kernel.solve(*args, **solve_kw))
        plain_ms = time_ms(lambda: sinkhorn_kernel.solve_plain(
            *args, **solve_kw))
        bound_ms, bound_by = k2_bound(n, m, k_it, 5)
        log(f"[k2-hetero] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} "
            "of the bound (median of 20)")
        out[tag] = {"route": lay.route, "n_iters": k_it, "max_abs_err": diff,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}
    log(f"[k2-hetero] phase {time.perf_counter() - t0:.2f} s")
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
    """Run ``module.main(argv)`` (a CLI, in-process) with every kernel's
    launch count zeroed just before and read just after; returns (result,
    launches, seconds)."""
    import torch

    from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel

    torch.cuda.synchronize()
    sinkhorn_kernel.COUNTER.reset()
    gw_kernel.COUNTER.reset()
    gw_kernel.DEVICE_COUNTER.reset()
    t0 = time.perf_counter()
    result = module.main(["--device", "cuda", *argv])
    launches = {"sinkhorn": sinkhorn_kernel.COUNTER.count,
                "gw": gw_kernel.COUNTER.count}
    # K1's device route (labels above 128 rows) appears where it ran, so a
    # stray launch of it fails every earlier run's check of its counts.
    if gw_kernel.DEVICE_COUNTER.count:
        launches["gw_device"] = gw_kernel.DEVICE_COUNTER.count
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"[{tag}] run {seconds:.2f} s; launches {launches}")
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
    _log_checkpoints("flagship", rows, result)
    log(f"[flagship] phase {time.perf_counter() - t0:.2f} s")
    return launches, _final_eval(out, data, result), result["final_logits"]


def _final_eval(out, data, result):
    """The trainer's own bf16 eval of its best weights (the final pass):
    {resolved MRI path: softmax probabilities} over the val subjects, in
    ``val_split.json``'s order (the val loader's)."""
    import numpy as np

    logits = np.asarray(result["final_logits"], np.float64)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    entries = json.loads((out / "val_split.json").read_text())
    check(len(entries) == len(probs),
          f"[flagship] {len(probs)} final logits for {len(entries)} val "
          "subjects")
    paths = [str((data.parent / e["mri_path"]).resolve()) for e in entries]
    return dict(zip(paths, probs))


def _log_checkpoints(tag, rows, result):
    """The checkpoint phase of each epoch (the host snapshot; the writes
    run behind) and the final flush's wait."""
    log(f"[{tag}] checkpoint phase s "
        f"{[r['phase_seconds']['checkpoint'] for r in rows]} (the host "
        f"snapshot; the writes run behind); final flush waited "
        f"{result['flush_seconds']:.3f} s")


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
    _log_checkpoints("base", rows, result)
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


def _read_predictions(path):
    """(rows, probabilities) of a predictions CSV."""
    import numpy as np

    rows = list(csv.DictReader(open(path)))
    probs = np.asarray([[float(r[k]) for k in r if k.startswith("prob_")]
                        for r in rows])
    return rows, probs


def _serve(tag, run_dir, data, out_csv, flags, n_expected):
    """``cli/predict.py`` on ``run_dir``: no OT kernel, ``n_expected`` rows;
    returns (rows, probabilities, result, peak GiB)."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli import predict

    torch.cuda.reset_peak_memory_stats()
    result, launches, seconds = _drive(tag, predict, [
        "--run-dir", str(run_dir), "--data-dir", str(data),
        "--output", str(out_csv), *flags])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == {"sinkhorn": 0, "gw": 0},
          f"[{tag}] serving launched an OT kernel: {launches}")
    rows, probs = _read_predictions(out_csv)
    check(len(rows) == n_expected,
          f"[{tag}] {len(rows)} predictions for {n_expected} subjects")
    check(bool(np.isfinite(probs).all()), f"[{tag}] probabilities not finite")
    log(f"[{tag}] {len(rows)} predictions in {result['seconds']:.2f} s: "
        f"{result['samples_per_s']:.2f} samples/s end to end, median "
        f"forward {result['median_forward_ms']:.2f} ms per batch; peak "
        f"memory {peak:.2f} GiB")
    return rows, probs, result, peak


def _prob_diff(tag, a, b):
    """Identical ``pred`` columns; returns max |dprob| (logged)."""
    (rows_a, p_a), (rows_b, p_b) = a, b
    check([r["pred"] for r in rows_a] == [r["pred"] for r in rows_b],
          f"[{tag}] the pred columns differ")
    diff = float(abs(p_a - p_b).max())
    log(f"[{tag}] identical preds; max |dprob| {diff:.3e}")
    return diff


def _witness_diff(tag, served, witness):
    """Max |dprob| of ``served`` (rows, probabilities) against ``witness``
    ({resolved MRI path: probabilities}) on the witness's subjects, and the
    number of those whose ``pred`` differs."""
    import numpy as np

    rows, probs = served
    at = {str(Path(r["mri_path"]).resolve()): i for i, r in enumerate(rows)}
    check(all(p in at for p in witness),
          f"[{tag}] the serve lacks a subject of the trainer's val split")
    idx = [at[p] for p in witness]
    want = np.stack(list(witness.values()))
    diff = float(abs(probs[idx] - want).max())
    flips = int((probs[idx].argmax(-1) != want.argmax(-1)).sum())
    return diff, flips


# bf16 serving is held to two fixed bounds. Against the trainer's own bf16
# eval of the same weights (same eval step, dtype and batch size) the serve
# as trained agrees to rounding. Against float32, each bf16 serve of this
# script's 2-epoch depth-101 flagship read 3.0e-2 to 9.9e-2 on an H100 80GB
# (the depth-18 unimodal run: 3.0e-5 to 6.7e-5).
_WITNESS_DPROB = 1e-2
_BF16_VS_FP32_DPROB = {"serve": 0.15, "uni-serve": 1e-3}


def _serve_pair(tag, run, data, work, variants, witness=None):
    """Serve ``run`` with each of two flag sets ``variants`` (name -> flags;
    an exact rewrite of the model, then the model as trained), in bf16
    (the run's dtype) and in float32 (TF32 off). The rewrite is exact, so
    in float32 the predictions must be the same and the probabilities
    within 1e-4. In bf16, the serve as trained must agree with
    ``witness`` (the trainer's own bf16 eval, when given) within
    ``_WITNESS_DPROB``, and each bf16 serve with its float32 serve within
    ``_BF16_VS_FP32_DPROB[tag]``; bf16 prediction flips are counted.
    Returns the numbers."""
    import torch

    fp32_run = work / f"{run.name}_fp32"
    fp32_run.mkdir()
    for name in ("best_model", "t_feature.npy"):
        if (run / name).exists():
            (fp32_run / name).symlink_to(run / name)
    cfg = json.loads((run / "model_config.json").read_text())
    (fp32_run / "model_config.json").write_text(
        json.dumps({**cfg, "dtype": "float32"}))
    out, served = {}, {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    for dtype, run_dir in (("bf16", run), ("fp32", fp32_run)):
        on = dtype == "bf16" and tf32
        torch.backends.cuda.matmul.allow_tf32 = bool(on and tf32[0])
        torch.backends.cudnn.allow_tf32 = bool(on and tf32[1])
        for name, flags in variants.items():
            key = f"{tag}-{dtype}-{name}"
            rows, probs, result, peak = _serve(
                key, run_dir, data, work / f"{key}.csv", flags, 192)
            served[dtype, name] = (rows, probs)
            out[f"{dtype}-{name}"] = {
                "samples_per_s": result["samples_per_s"],
                "median_forward_ms": result["median_forward_ms"],
                "peak_gib": peak}
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    shutil.rmtree(fp32_run)
    first, second = variants
    out["fp32_dprob"] = _prob_diff(f"{tag}-fp32", served["fp32", first],
                                   served["fp32", second])
    check(out["fp32_dprob"] <= 1e-4,
          f"[{tag}-fp32] {first} moved a probability by "
          f"{out['fp32_dprob']} in float32 (above 1e-4)")
    if witness is not None:
        diff, flips = _witness_diff(f"{tag}-bf16-{second}",
                                    served["bf16", second], witness)
        out["bf16_vs_trainer_eval"] = {"dprob": diff, "pred_flips": flips}
        log(f"[{tag}] bf16 {second} against the trainer's own bf16 eval of "
            f"{len(witness)} val subjects: max |dprob| {diff:.3e}, {flips} "
            f"pred flips (bound {_WITNESS_DPROB})")
        check(diff <= _WITNESS_DPROB,
              f"[{tag}] the bf16 serve lies {diff} from the trainer's own "
              f"bf16 eval of the same weights (above {_WITNESS_DPROB})")
    a, b = served["bf16", first], served["bf16", second]
    bound = _BF16_VS_FP32_DPROB.get(tag)
    out["bf16_vs_fp32_dprob"] = {}
    for name in variants:
        err = float(abs(served["bf16", name][1]
                        - served["fp32", name][1]).max())
        out["bf16_vs_fp32_dprob"][name] = err
        check(bound is None or err <= bound, f"[{tag}] the bf16 {name} "
              f"serve lies {err} from its float32 serve (above {bound})")
    out["bf16_dprob"] = float(abs(a[1] - b[1]).max())
    out["bf16_pred_flips"] = sum(ra["pred"] != rb["pred"]
                                 for ra, rb in zip(a[0], b[0]))
    log(f"[{tag}] bf16 {first} against {second}: max |dprob| "
        f"{out['bf16_dprob']:.3e}, {out['bf16_pred_flips']} pred flips; "
        f"against float32: " + ", ".join(
            f"{k} {v:.3e}" for k, v in out["bf16_vs_fp32_dprob"].items())
        + f" (bound {bound})")
    return out


def phase_serve(data, work, final_eval):
    """The flagship's run (depth 101, 128^3, bf16, s2d) served over all 192
    subjects at B16, BatchNorm folded and unfolded (``_serve_pair``), the
    unfolded bf16 serve held to the trainer's ``final_eval``."""
    t0 = time.perf_counter()
    out = _serve_pair("serve", work / "flagship", data, work, {
        "fold": ["--fold-bn", "--batch-size", "16"],
        "no-fold": ["--no-fold-bn", "--batch-size", "16"]}, final_eval)
    log(f"[serve] phase {time.perf_counter() - t0:.2f} s")
    return out


def _pth_backbone(path, depth):
    """A seeded port ResNet3DBackbone (plain stem) saved as the reference
    saves a checkpoint: ``module.`` keys in ``{"model_state_dict": ...}``;
    returns the number of its tensors (BatchNorm counters left out)."""
    import torch

    from otfusion_tpu_torch.models.resnet3d import ResNet3DBackbone

    torch.manual_seed(7)
    state = ResNet3DBackbone(depth, s2d_stem=False).state_dict()
    torch.save({"model_state_dict": {"module." + k: v
                                     for k, v in state.items()}}, path)
    return sum(not k.endswith("num_batches_tracked") for k in state)


def phase_lifecycle(data, work):
    """Depth 18, 64^3, 1 epoch each: a plain-stem unimodal run served with
    both stems; the flagship from pretrained backbones, then resumed to
    epoch 2; the base trainer with --remat --grad-accum 2."""
    from otfusion_tpu_torch.cli import (
        train_mri_pet_ot,
        train_ot_attn,
        train_unimodal,
    )

    small = ["--batch-size", "8", "--model-depth", "18",
             "--target-shape", "64", "64", "64"]
    launches = {}
    t0 = time.perf_counter()
    uni = work / "uni_plain"
    result, got, _ = _drive("uni-plain", train_unimodal, [
        *small, "--epochs", "1", "--no-s2d-stem", "--classes", "AD", "CN",
        "--data-dir", str(data), "--save-path", str(uni)])
    check(got == {"sinkhorn": 0, "gw": 0}, "[uni-plain] launched a kernel")
    _check_rows("uni-plain", uni, 1, result)
    check(not json.loads((uni / "model_config.json").read_text())[
        "s2d_stem"], "[uni-plain] the run did not keep the plain stem")
    serve = _serve_pair("uni-serve", uni, data, work, {
        "auto": ["--stem", "auto"], "as-trained": ["--stem", "as-trained"]})

    pth = work / "pet_pretrained.pth"
    n_tensors = _pth_backbone(pth, 18)
    flag = work / "pretrained"
    flagship = [*small, "--data-dir", str(data), "--save-path", str(flag),
                "--mri-pretrained", str(uni / "best_model"),
                "--pet-pretrained", str(pth)]
    result, got, _ = _drive("pretrained", train_ot_attn,
                            [*flagship, "--epochs", "1"])
    check(result["grafted"] == {"mri": n_tensors, "pet": n_tensors},
          f"[pretrained] grafted {result['grafted']}, expected {n_tensors} "
          "tensors each (every tensor, the plain stem rewritten)")
    check(json.loads((flag / "model_config.json").read_text())["s2d_stem"],
          "[pretrained] the run is not on the s2d stem")
    check(got == {"sinkhorn": 2, "gw": 2},
          f"[pretrained] launches {got}, expected K1 = K2 = 2")
    _check_rows("pretrained", flag, 1, result)
    launches["pretrained"] = got

    result, got, _ = _drive("resume", train_ot_attn,
                            [*flagship, "--epochs", "2", "--resume"])
    rows = [json.loads(line) for line in
            (flag / "metrics.jsonl").read_text().splitlines()]
    check([r["epoch"] for r in rows] == [1, 2],
          f"[resume] metrics.jsonl epochs {[r['epoch'] for r in rows]}")
    check((flag / "results.txt").read_text().count(
        "Best Validation Loss:") == 1,
          "[resume] results.txt does not hold exactly one summary")
    check(got == {"sinkhorn": 2, "gw": 2},
          f"[resume] launches {got}, expected K1 = K2 = 2")
    launches["resume"] = got

    out = work / "base_remat"
    result, got, _ = _drive("base-remat", train_mri_pet_ot, [
        *small, "--epochs", "1", "--grad-accum", "2", "--remat",
        "--data-dir", str(data), "--save-path", str(out)])
    n_train = len(json.loads((out / "train_split.json").read_text()))
    solves = _micro_total(n_train, 8, 2, 1)
    check(got == {"sinkhorn": solves, "gw": 0},
          f"[base-remat] launches {got}, expected K2 = {solves}, K1 = 0")
    _check_rows("base-remat", out, 1, result)
    launches["base_remat"] = got
    log(f"[lifecycle] phase {time.perf_counter() - t0:.2f} s")
    return launches, serve


def phase_remat_step():
    """One flagship train step at full width (depth 101, 128^3, bf16, B8)
    from the same weights, batch and dropout seed, remat off then on. The
    gradients are compared on a step with cuDNN's deterministic algorithms
    (the default ones sum in an order that varies from run to run); peak
    memory and step time are read over 5 steps in the default mode."""
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
    from otfusion_tpu_torch.train.steps import make_fusion_train_step
    from otfusion_tpu_torch.train.train_state import make_optimizer

    t0 = time.perf_counter()
    torch.manual_seed(0)
    init = MultimodalOTFusion(depth=101, s2d_stem=True).state_dict()
    gen = torch.Generator(device="cuda").manual_seed(3)
    mri, pet = (torch.randn((8, 128, 128, 128, 1), device="cuda",
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
    labels = torch.arange(8, device="cuda") % 2
    tv = torch.full((2048, 2048), 1.0 / 2048**2, device="cuda")
    cudnn = torch.backends.cudnn
    runs = {}
    for remat in (False, True):
        model = MultimodalOTFusion(depth=101, s2d_stem=True, remat=remat)
        model.load_state_dict(init)
        model = model.to(device="cuda", memory_format=torch.channels_last_3d)
        step = make_fusion_train_step(
            model, make_optimizer(model.parameters(), 1e-5),
            compute_dtype=torch.bfloat16)
        modes = (cudnn.deterministic, cudnn.benchmark)
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            met = step(mri, pet, labels, tv,
                       torch.Generator(device="cuda").manual_seed(1))
            loss = float(met["loss"])
        finally:
            cudnn.deterministic, cudnn.benchmark = modes
        grads = torch.cat([p.grad.float().flatten()
                           for p in model.parameters()]).cpu()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(mri, pet, labels, tv, gen), 5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[remat] = {"loss": loss, "peak_gib": peak, "step_ms": ms}
        log(f"[remat-step] remat {remat}: loss {loss:.6f}; peak memory "
            f"{peak:.2f} GiB; step {ms:.2f} ms (median of 5)")
        del model, step, met
        runs[remat]["grads"] = grads
        torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    rel_loss = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    rel_grad = float((remat.pop("grads") - plain["grads"]).norm()
                     / plain.pop("grads").norm())
    log(f"[remat-step] loss relative difference {rel_loss:.3e}; gradient "
        f"relative L2 difference {rel_grad:.3e} (deterministic cuDNN); "
        f"phase {time.perf_counter() - t0:.2f} s")
    check(remat["peak_gib"] < plain["peak_gib"],
          "[remat-step] remat did not lower the peak memory")
    check(rel_loss <= 1e-5, f"[remat-step] losses differ by {rel_loss}")
    check(rel_grad <= 1e-2, f"[remat-step] gradients differ by {rel_grad}")
    return {"plain": plain, "remat": remat, "rel_loss": rel_loss,
            "rel_grad": rel_grad}


def phase_remat_trainer(data, work):
    """The flagship at the JAX package's memory-saving setting, --batch-size
    16 --grad-accum 2 --remat (depth 101, 128^3, bf16), for 1 epoch."""
    import torch

    from otfusion_tpu_torch.cli import train_ot_attn

    t0 = time.perf_counter()
    out = work / "flagship_remat"
    torch.cuda.reset_peak_memory_stats()
    result, launches, _ = _drive("remat-trainer", train_ot_attn, [
        "--epochs", "1", "--batch-size", "16", "--grad-accum", "2",
        "--remat", "--data-dir", str(data), "--save-path", str(out)])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == {"sinkhorn": 2, "gw": 2},
          f"[remat-trainer] launches {launches}, expected one K1 and one "
          "K2 per coupling (2)")
    rows = _check_rows("remat-trainer", out, 1, result)
    log(f"[remat-trainer] median step {rows[0]['median_step_ms']:.1f} ms "
        f"(B16 as 2 x 8); peak memory {peak:.2f} GiB; phase "
        f"{time.perf_counter() - t0:.2f} s")
    shutil.rmtree(out)
    return launches, {"median_step_ms": rows[0]["median_step_ms"],
                      "peak_gib": peak}


# The hetero paths' volume size: UNETR's published geometry (96^3, 16^3
# patches, 216 tokens); MedicalNet-10 keeps 12 depth slices there (6144).
HETERO_SHAPE = 96


def _widths(mri, pet, shape):
    from otfusion_tpu_torch.models.registry import feature_width

    return feature_width(mri, shape), feature_width(pet, shape)


def phase_hetero_flagship(data, work, flagship_launches):
    """The flagship with UNETR (MRI) and MedicalNet-10 (PET) at 96^3, the
    CLI's other defaults, batch 8, for 2 epochs: Tv is (6144, 768) with mass
    1; K1 and K2 launch as often as the default flagship's 2 epochs."""
    import numpy as np

    from otfusion_tpu_torch.cli import train_ot_attn

    t0 = time.perf_counter()
    out = work / "hetero"
    shape = (HETERO_SHAPE,) * 3
    d_mri, d_pet = _widths("unetr_vit", "medicalnet-10", shape)
    result, launches, _ = _drive("hetero", train_ot_attn, [
        "--mri-backbone", "unetr_vit", "--pet-backbone", "medicalnet-10",
        "--target-shape", *map(str, shape), "--epochs", "2",
        "--batch-size", "8", "--data-dir", str(data),
        "--save-path", str(out)])
    check(launches == flagship_launches,
          f"[hetero] launches {launches}, the default flagship's "
          f"{flagship_launches}")
    rows = _check_rows("hetero", out, 2, result)
    for row in rows:
        clog = row["coupling_log"]
        log(f"[hetero] epoch {row['epoch']}: gw iters "
            f"{clog['gw_outer_iters']} fot iters {clog['fot_iters']}")
    tv = np.load(out / "t_feature.npy")
    check(tv.shape == (d_pet, d_mri), f"[hetero] Tv has shape {tv.shape}, "
          f"not {(d_pet, d_mri)}")
    check(bool(np.isfinite(tv).all()), "[hetero] Tv is not finite")
    check(abs(float(tv.sum()) - 1.0) <= 1e-3,
          f"[hetero] Tv mass {float(tv.sum())} is not 1 +- 1e-3")
    log(f"[hetero] Tv {tv.shape}, mass {float(tv.sum()):.6f}; phase "
        f"{time.perf_counter() - t0:.2f} s")
    return launches, _final_eval(out, data, result)


def phase_hetero_base(data, work):
    """The base trainer with MedicalNet-10 (MRI) and UNETR (PET) at 96^3,
    batch 8, for 1 epoch: K2 once per train step on a (768, 6144) plan, K1
    never."""
    from otfusion_tpu_torch.cli import train_mri_pet_ot

    t0 = time.perf_counter()
    out = work / "hetero_base"
    shape = (HETERO_SHAPE,) * 3
    d_mri, d_pet = _widths("medicalnet-10", "unetr_vit", shape)
    result, launches, _ = _drive("hetero-base", train_mri_pet_ot, [
        "--mri-backbone", "medicalnet-10", "--pet-backbone", "unetr_vit",
        "--target-shape", *map(str, shape), "--epochs", "1",
        "--batch-size", "8", "--data-dir", str(data),
        "--save-path", str(out)])
    n_train = len(json.loads((out / "train_split.json").read_text()))
    steps = _micro_total(n_train, 8, 1, 1)
    check(launches == {"sinkhorn": steps, "gw": 0},
          f"[hetero-base] launches {launches}, expected K2 = {steps} (one "
          "per train step), K1 = 0")
    _check_rows("hetero-base", out, 1, result)
    log(f"[hetero-base] {steps} train steps, each K2 on a ({d_pet}, "
        f"{d_mri}) plan; phase {time.perf_counter() - t0:.2f} s")
    shutil.rmtree(out)
    return launches


def phase_hetero_serve(data, work, final_eval):
    """The hetero flagship's run served over all 192 subjects with
    MedicalNet's BatchNorm folded and unfolded (UNETR has none), held as
    ``_serve_pair`` holds the default flagship's, at the trainer's eval
    batch at 96^3 (32)."""
    t0 = time.perf_counter()
    out = _serve_pair("hetero-serve", work / "hetero", data, work, {
        "fold": ["--fold-bn", "--batch-size", "32"],
        "no-fold": ["--no-fold-bn", "--batch-size", "32"]}, final_eval)
    log(f"[hetero-serve] phase {time.perf_counter() - t0:.2f} s")
    return out


def _swin_pth_state(rng, embed=128, depths=(2, 2, 18, 2),
                    heads=(4, 8, 16, 32), window=12):
    """An official-layout Swin state dict (the layout of
    ``tests/test_torch_import_zoo.py:_tiny_swin_sd``), head and buffers
    included, at Swin-B/384's geometry by default."""
    import numpy as np

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.02

    sd = {"patch_embed.proj.weight": t(embed, 3, 4, 4),
          "patch_embed.proj.bias": t(embed)}

    def ln(name, c):
        sd[name + ".weight"] = 1.0 + t(c)
        sd[name + ".bias"] = t(c)

    ln("patch_embed.norm", embed)
    for s, depth in enumerate(depths):
        dim = embed * 2 ** s
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            ln(p + ".norm1", dim)
            sd[p + ".attn.qkv.weight"] = t(3 * dim, dim)
            sd[p + ".attn.qkv.bias"] = t(3 * dim)
            sd[p + ".attn.relative_position_bias_table"] = t(
                (2 * window - 1) ** 2, heads[s])
            sd[p + ".attn.relative_position_index"] = np.zeros(
                (window * window, window * window), np.int64)
            sd[p + ".attn.proj.weight"] = t(dim, dim)
            sd[p + ".attn.proj.bias"] = t(dim)
            ln(p + ".norm2", dim)
            sd[p + ".mlp.fc1.weight"] = t(4 * dim, dim)
            sd[p + ".mlp.fc1.bias"] = t(4 * dim)
            sd[p + ".mlp.fc2.weight"] = t(dim, 4 * dim)
            sd[p + ".mlp.fc2.bias"] = t(dim)
        if s < len(depths) - 1:
            ln(f"layers.{s}.downsample.norm", 4 * dim)
            sd[f"layers.{s}.downsample.reduction.weight"] = t(2 * dim, 4 * dim)
    ln("norm", embed * 2 ** (len(depths) - 1))
    sd["head.weight"] = t(1000, embed * 2 ** (len(depths) - 1))
    sd["head.bias"] = t(1000)
    read = [k for k in sd if not k.startswith("head.")
            and not k.endswith("relative_position_index")]
    return sd, len(read)


def _unetr_pth_state(rng, hidden=768, heads=12, blocks=12, patch=16,
                     n_tokens=216):
    """A full-UNETR state dict in MONAI's layout (``vit.`` encoder, bias-free
    qkv, decoder keys; the layout of
    ``tests/test_torch_import_zoo.py:_unetr_sd``), at UNETR's 96^3 geometry
    by default."""
    import numpy as np

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.02

    v = "vit."
    sd = {v + "patch_embedding.patch_embeddings.1.weight": t(hidden,
                                                             patch ** 3),
          v + "patch_embedding.patch_embeddings.1.bias": t(hidden),
          v + "patch_embedding.position_embeddings": t(1, n_tokens, hidden)}
    for i in range(blocks):
        p = f"{v}blocks.{i}"
        for norm in (".norm1", ".norm2"):
            sd[p + norm + ".weight"] = 1.0 + t(hidden)
            sd[p + norm + ".bias"] = t(hidden)
        sd[p + ".attn.qkv.weight"] = t(3 * hidden, hidden)
        sd[p + ".attn.out_proj.weight"] = t(hidden, hidden)
        sd[p + ".attn.out_proj.bias"] = t(hidden)
        sd[p + ".mlp.linear1.weight"] = t(4 * hidden, hidden)
        sd[p + ".mlp.linear1.bias"] = t(4 * hidden)
        sd[p + ".mlp.linear2.weight"] = t(hidden, 4 * hidden)
        sd[p + ".mlp.linear2.bias"] = t(hidden)
    sd[v + "norm.weight"] = 1.0 + t(hidden)
    sd[v + "norm.bias"] = t(hidden)
    sd["decoder2.blocks.0.conv1.conv.weight"] = t(8, 8, 3, 3)
    sd["out.conv.conv.weight"] = t(14, 16, 1, 1)
    return sd, sum(k.startswith(v) for k in sd)


# BASELINE.json config 5 as the JAX package's bench.py drives it: Swin-B/384
# (MRI, 2D fundus images) and UNETR (PET, 96^3), batch 2; the feature pass
# over CONFIG5_PER_LABEL subjects of each of 2 labels.
CONFIG5_BATCH = 2
CONFIG5_PER_LABEL = 64
CONFIG5_IMAGE = 384


def phase_config5(work):
    """Swin-B/384 (remat on) + UNETR at full width, both grafted from
    official-layout ``.pth`` files (every tensor read lands): a bf16 feature
    pass over 2 x 64 random pairs, the coupling pipeline (K1, then K2 on a
    (768, 1024) plan), 5 bf16 train steps."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
    from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel
    from otfusion_tpu_torch.train.coupling import coupling_pipeline
    from otfusion_tpu_torch.train.loop import place_model
    from otfusion_tpu_torch.train.steps import (
        make_feature_extract_step,
        make_fusion_train_step,
    )
    from otfusion_tpu_torch.train.train_state import make_optimizer
    from otfusion_tpu_torch.utils.checkpoint import restore_backbone

    t0 = time.perf_counter()
    img, vol = (CONFIG5_IMAGE,) * 2, (HETERO_SHAPE,) * 3
    torch.manual_seed(0)
    model = MultimodalOTFusion(
        variant="per_epoch_attn", mri_backbone="swin_base_384",
        pet_backbone="unetr_vit", mri_shape=img, pet_shape=vol)
    rng = np.random.default_rng(3)
    grafted = {}
    for side, spec, make in (("mri", "swin_base_384", _swin_pth_state),
                             ("pet", "unetr_vit", _unetr_pth_state)):
        sd, n_read = make(rng)
        pth = work / f"{spec}.pth"
        torch.save({"state_dict": {k: torch.from_numpy(a)
                                   for k, a in sd.items()}}, pth)
        del sd
        n = restore_backbone(model, pth, f"{side}_backbone", backbone=spec)
        check(n == n_read, f"[config5] {spec}: grafted {n} of the {n_read} "
              "tensors its importer reads")
        grafted[spec] = n
        pth.unlink()
    model = place_model(model, torch.device("cuda"))
    d_mri = model.mri_backbone.out_dim
    d_pet = model.pet_backbone.out_dim
    log(f"[config5] grafted {grafted} (every tensor read, none skipped); "
        f"d_mri {d_mri}, d_pet {d_pet} ({time.perf_counter() - t0:.2f} s)")

    gen = torch.Generator(device="cuda").manual_seed(4)
    n_pairs = 2 * CONFIG5_PER_LABEL
    labels = torch.arange(n_pairs, device="cuda") % 2
    extract = make_feature_extract_step(model, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    feats = []
    for i in range(0, n_pairs, 16):
        b = min(16, n_pairs - i)
        mri = torch.randn((b, *img, 3), device="cuda", generator=gen)
        pet = torch.randn((b, *vol, 1), device="cuda", generator=gen)
        feats.append(extract(mri.to(torch.bfloat16), pet.to(torch.bfloat16)))
    mri_f = torch.cat([f[0] for f in feats]).float()
    pet_f = torch.cat([f[1] for f in feats]).float()
    torch.cuda.synchronize()
    feature_s = time.perf_counter() - t1
    groups = lambda f: torch.stack([f[labels == k] for k in (0, 1)])  # noqa
    mask = torch.ones((2, CONFIG5_PER_LABEL), dtype=torch.bool, device="cuda")
    sinkhorn_kernel.COUNTER.reset()
    gw_kernel.COUNTER.reset()
    t1 = time.perf_counter()
    tv, gw, fot_res = coupling_pipeline(groups(pet_f), groups(mri_f), mask,
                                        mask)
    torch.cuda.synchronize()
    coupling_s = time.perf_counter() - t1
    launches = {"sinkhorn": sinkhorn_kernel.COUNTER.count,
                "gw": gw_kernel.COUNTER.count}
    check(launches == {"sinkhorn": 1, "gw": 1},
          f"[config5] coupling launches {launches}, expected K1 = K2 = 1")
    check(tuple(tv.shape) == (d_pet, d_mri), f"[config5] Tv {tuple(tv.shape)}")
    check(bool(torch.isfinite(tv).all())
          and abs(float(tv.sum()) - 1.0) <= 1e-3,
          f"[config5] Tv not finite or mass {float(tv.sum())} not 1")
    log(f"[config5] feature pass over {n_pairs} pairs {feature_s:.2f} s; "
        f"coupling {coupling_s:.3f} s (gw iters {gw.n_iters.tolist()}, fot "
        f"iters {int(fot_res.n_iters)}); Tv {tuple(tv.shape)}")

    step = make_fusion_train_step(model, make_optimizer(model.parameters(),
                                                        1e-5),
                                  compute_dtype=torch.bfloat16)
    mri = torch.randn((CONFIG5_BATCH, *img, 3), device="cuda", generator=gen)
    pet = torch.randn((CONFIG5_BATCH, *vol, 1), device="cuda", generator=gen)
    y = torch.arange(CONFIG5_BATCH, device="cuda") % 2
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        met = step(mri, pet, y, tv, gen)
        losses.append(float(met["loss"]))
        times.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"[config5] losses {losses}")
    out = {"grafted": grafted, "launches": launches,
           "feature_pass_s": feature_s, "coupling_s": coupling_s,
           "step_ms": times, "median_step_ms": float(np.median(times)),
           "peak_gib": peak, "losses": losses}
    log(f"[config5] 5 bf16 train steps at B{CONFIG5_BATCH}: ms {times} "
        f"(median {out['median_step_ms']:.2f}, the first includes cuDNN's "
        f"and cuBLAS's warm-up); losses {losses}; peak memory {peak:.2f} "
        f"GiB; phase {time.perf_counter() - t0:.2f} s")
    del model, step
    torch.cuda.empty_cache()
    return launches, out


# The Perturb-OT harness's screen: 10 treatment labels of 80-96 rows (the
# same count in both modalities, as FOSCTTM's true pairs need; unequal, so
# the per-label caps pad), post-ReLU features of the flagship's width with
# about 5 % dead channels, a two-class dosage. The CUDA-against-CPU runs
# use 3 labels x 20 rows x 16 features scaled by 0.01: COOT stops on an
# absolute |dcost| < 1e-7, which at unit scale (costs of order 10, a
# float32 step of 1e-6) holds only when two costs round alike, so its
# count there is rounding noise on any two routes.
PERTURBOT_LABELS = 10
PERTURBOT_ROWS = (80, 96)
PERTURBOT_WIDTH = 2048
PERTURBOT_DEAD = 0.05
PERTURBOT_EPS = 1e-2
SMALL_SCREEN = dict(n_labels=3, rows=(20, 20), d=16, dead=0.0, scale=0.01)
# COOT can sit where its iteration amplifies rounding: on seed 12's label 1
# ECOOT_each's plans on the card and on the CPU ended 2.2e-3 of max T apart
# at the same counts (this phase, NVIDIA H100 80GB HBM3, 700.00 W), and the
# port on the CPU and JAX part there too, further every iteration, to two
# fixed points. The next seed, 13, is a screen where every method is stable.
SMALL_SCREEN_SEED = 13
CLI_METHODS = ("EGW_ott", "EGWL_ott", "LEOT_ott", "ECOOTL")


def _screen(rng, n_labels, rows, d, dead, scale=1.0):
    """A chemical-screen dict in the harness's layout: per label, X and Y
    rows share a 3-dim latent (true pairs share a row index), as the JAX
    harness tests' ``synthetic_screen``; the two modalities' feature maps
    share half their variance (entropic OT on the cross cost, EOT/LEOT,
    needs features that correspond; with independent maps LEOT's FOSCTTM
    read 0.52 against the random coupling's 0.49); features are shifted by
    2 and ReLU'd, as pooled post-ReLU features are non-negative with a
    positive mean, with a ``dead`` share of channels zero in every row;
    the dosage is the sign of the first latent."""
    import numpy as np

    a = rng.normal(size=(3, d))
    b = 0.5 * a + np.sqrt(0.75) * rng.normal(size=(3, d))
    dead_x = rng.random(d) < dead
    dead_y = rng.random(d) < dead
    counts = rng.integers(rows[0], rows[1] + 1, size=n_labels)
    counts[0] = rows[1]
    xs, ys, zs = {}, {}, {}
    for label, n in enumerate(counts):
        z = rng.normal(size=(n, 3))
        x = np.maximum(z @ a + 2.0 + 0.05 * rng.normal(size=(n, d)), 0.0)
        y = np.maximum(z @ b + 2.0 + 0.05 * rng.normal(size=(n, d)), 0.0)
        x[:, dead_x] = 0.0
        y[:, dead_y] = 0.0
        xs[label] = (scale * x).astype(np.float32)
        ys[label] = (scale * y).astype(np.float32)
        zs[label] = (z[:, 0] > 0).astype(int)
    return {"Xs_dict": xs, "Xt_dict": ys, "Zs_dict": {"dosage": zs},
            "Zt_dict": {"dosage": zs}}


def _on_cpu(kw):
    import torch

    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}


# Below eps 1e-3, -C/eps reaches -1e4 and a float32 step of the exponents
# is ~1e-3: two orders of the same sums put plans apart by 1e-4 of max T
# and more (the phase logs the plain solve on the card against the one on
# the CPU beside K2's; PERF.md keeps the readings). There the duals carry
# the comparison and the plan is held within K2_SMALL_EPS_PLAN_TOL of max T.
K2_SMALL_EPS_PLAN_TOL = 1e-2


def _k2_harness_case(tag, cost, runs, plain_runs, *, phase="perturbot",
                     **kw):
    """K2 on a cost the harness (or the legacy trainer, ``phase="gamma"``)
    gives it against the plain version run on the CPU, the one the CPU tests hold to JAX: one launch, the same
    n_iters, the duals within 1e-4 of their largest (valid and masked
    entries apart), the plan exactly 0 off the masks and within 1e-4 of
    max T at eps >= 1e-3 (else ``K2_SMALL_EPS_PLAN_TOL``). The plain
    version on the card is logged beside it. Times of the whole
    ``sinkhorn`` call, kernel against the plain version on the card (the
    same masking and scaling on both)."""
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.ops import sinkhorn_kernel
    from otfusion_tpu_torch.ops.sinkhorn import sinkhorn

    before = sinkhorn_kernel.COUNTER.count
    ker = sinkhorn(cost, **kw)
    per_solve = sinkhorn_kernel.COUNTER.count - before
    ref = sinkhorn(cost.cpu(), **_on_cpu(kw))
    card = sinkhorn(cost, plain=True, **kw)
    n, m = cost.shape
    k_it, r_it, c_it = (int(ker.n_iters), int(ref.n_iters),
                        int(card.n_iters))
    t_ref = ref.coupling.cuda()
    t_max = float(t_ref.max())
    diff = float((ker.coupling - t_ref).abs().max())
    card_diff = float((card.coupling - t_ref).abs().max())
    rows = kw.get("row_mask", torch.ones(n, dtype=torch.bool, device="cuda"))
    cols = kw.get("col_mask", torch.ones(m, dtype=torch.bool, device="cuda"))
    pair = rows[:, None] & cols[None, :]
    if "plan_mask" in kw:
        pair = pair & kw["plan_mask"]
    off = float(ker.coupling[~pair].abs().sum()) if (~pair).any() else 0.0
    duals = {}
    for name, valid in (("valid", True), ("masked", False)):
        for a, b, v in ((ker.f, ref.f, rows), (ker.g, ref.g, cols)):
            sel = v if valid else ~v
            if sel.any():
                b = b.cuda()[sel]
                err = float((a[sel] - b).abs().max() / b.abs().max())
                duals[name] = max(duals.get(name, 0.0), err)
    log(f"[{phase}] K2 {tag} ({n}x{m}): n_iters kernel {k_it}, plain on "
        f"the CPU {r_it}, plain on the card {c_it}; converged "
        f"{bool(ker.converged)}/{bool(ref.converged)}; max|dT| against the "
        f"CPU's plain {diff / t_max:.3e} max T (the card's plain "
        f"{card_diff / t_max:.3e}); mass off the masks {off}; duals "
        f"{duals} of their largest; mass {float(ker.coupling.sum()):.6f}")
    check(per_solve == 1, f"K2 {tag}: more than one launch for a solve")
    tol = 1e-4 if kw["epsilon"] >= 1e-3 else K2_SMALL_EPS_PLAN_TOL
    check(k_it == r_it, f"K2 {tag}: n_iters {k_it} and {r_it} differ")
    check(diff <= tol * t_max,
          f"K2 {tag}: plan differs by more than {tol} max T")
    check(off == 0.0, f"K2 {tag}: mass off the masks")
    check(max(duals.values()) <= 1e-4, f"K2 {tag}: duals differ {duals}")
    ms = time_ms(lambda: sinkhorn(cost, **kw), runs)
    plain_ms = time_ms(lambda: sinkhorn(cost, plain=True, **kw), plain_runs)
    bound_ms, bound_by = k2_bound(n, m, k_it, 5)
    log(f"[{phase}] K2 {tag}: kernel {ms:.4f} ms, plain on the card "
        f"{plain_ms:.4f} ms (median of {runs} / {plain_runs}), bound "
        f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.4f} of the bound")
    return {"shape": [n, m], "eps": kw["epsilon"], "n_iters": k_it,
            "max_abs_err": diff, "rel_err": diff / t_max,
            "card_plain_n_iters": c_it, "card_plain_max_abs_err": card_diff,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _perturbot_kernels(screen):
    """(a): K1 at the screen's 10 labels x cap 96 and K2 at the costs the
    harness gives it, each against its plain version."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.ops import gw_kernel
    from otfusion_tpu_torch.ops.api import _concat_dicts, _pad_dicts
    from otfusion_tpu_torch.ops.costs import pairwise_sq_euclidean
    from otfusion_tpu_torch.ops.cot import (
        coot_problem,
        feature_costs,
        sample_costs,
    )
    from otfusion_tpu_torch.ops.gromov import _prep, egw_per_label

    def cuda(a):
        return torch.as_tensor(a, device="cuda")

    data = (screen["Xs_dict"], screen["Xt_dict"])
    labels, xs, ys, xm, ym = _pad_dicts(*data, common_cap=True)
    L, cap = xm.shape
    x, y, m = cuda(xs), cuda(ys), cuda(xm)
    before = gw_kernel.COUNTER.count
    ker = egw_per_label(x, y, m, m, epsilon=PERTURBOT_EPS)
    per_solve = gw_kernel.COUNTER.count - before
    ref = egw_per_label(x, y, m, m, epsilon=PERTURBOT_EPS, plain=True)
    it_k, it_r = ker.n_iters.tolist(), ref.n_iters.tolist()
    t_max = float(ref.coupling.max())
    diff = float((ker.coupling - ref.coupling).abs().max())
    pad = float((ker.coupling * ~(m[:, :, None] & m[:, None, :])).abs().sum())
    log(f"[perturbot] K1 {L} labels x cap {cap} (rows {xm.sum(1).tolist()}): "
        f"n_iters kernel {it_k} plain {it_r}; max|dT| {diff:.3e} = "
        f"{diff / t_max:.3e} max T; mass on padding {pad}")
    check(per_solve == 1, "K1: more than one launch for the 10 labels")
    check(it_k == it_r, "K1 at cap 96: n_iters differ from the plain version")
    check(diff <= 1e-4 * t_max, "K1 at cap 96: plan differs by more than 1e-4 "
          "max T")
    check(pad == 0.0, "K1 at cap 96: mass on padding")
    cx, p, log_p = _prep(x, m)
    cy, q, log_q = _prep(y, m)
    args = (cx, cy, log_p, log_q, p, q)
    ms = time_ms(lambda: gw_kernel.gw_solve(*args, epsilon=PERTURBOT_EPS))
    plain_ms = time_ms(lambda: gw_kernel.gw_solve_plain(
        *args, epsilon=PERTURBOT_EPS), 5)
    bound_ms, bound_by = k1_bound(L, cap, it_k)
    log(f"[perturbot] K1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median "
        f"of 20 / 5), bound {bound_ms:.5f} ms ({bound_by}), "
        f"{bound_ms / ms:.4f} of the bound")
    k1 = {"labels": L, "cap": cap, "n_iters": it_k, "max_abs_err": diff,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": bound_by}

    # COOT's first iteration: the sample cost of the label with the fewest
    # rows (padded rows and columns masked), and the feature cost on the
    # data-driven marginals (0 on the dead channels).
    prob = coot_problem(cuda(xs), cuda(ys), cuda(xm), cuda(ym))
    d, dp = xs.shape[2], ys.shape[2]
    tv0 = torch.full((d, dp), 1.0 / (d * dp), device="cuda")
    k = int(np.argmin(xm.sum(1)))
    m_s = sample_costs(prob, tv0)[k].contiguous()
    ts0 = prob.w1[:, :, None] * prob.w2[:, None, :]
    m_v = feature_costs(prob, ts0).contiguous()
    dead = int((prob.v1 == 0).sum()), int((prob.v2 == 0).sum())
    log(f"[perturbot] COOT feature marginals: {dead[0]} and {dead[1]} "
        f"channels of {d} carry 0")
    check(min(dead) > 0, "the screen has no dead channel")
    k2 = {}
    for eps in (1e-2, 1e-4, 1e-5):
        k2[f"masked_{cap}_eps{eps:g}"] = _k2_harness_case(
            f"label {k} sample cost, eps {eps:g}", m_s, 20, 5,
            p=prob.w1[k], q=prob.w2[k], epsilon=eps, scale_cost=True,
            row_mask=prob.x_mask[k], col_mask=prob.y_mask[k])
    k2[f"coot_features_{d}"] = _k2_harness_case(
        "COOT feature cost", m_v, 20, 5, p=prob.v1, q=prob.v2,
        epsilon=PERTURBOT_EPS, scale_cost=True)
    _, xa, ya, lx, ly = _concat_dicts(*data)
    cost = pairwise_sq_euclidean(cuda(xa), cuda(ya)).contiguous()
    k2[f"leot_{len(lx)}"] = _k2_harness_case(
        "LEOT plan-masked cost", cost, 20, 5, epsilon=PERTURBOT_EPS,
        scale_cost=True, plan_mask=cuda(lx[:, None] == ly[None, :]))
    return k1, k2


def _walk_counts(log, path=""):
    """{path: value} of every solver count and convergence flag in a log."""
    out = {}
    for key, value in log.items():
        if isinstance(value, dict):
            out.update(_walk_counts(value, f"{path}{key}/"))
        elif key.startswith(("n_iters", "converged")):
            out[path + key] = value
    return out


def _plans(t):
    import numpy as np

    if isinstance(t, dict):
        return np.concatenate([np.ravel(t[k]) for k in sorted(t)])
    return np.ravel(t)


def phase_perturbot(work):
    """The Perturb-OT harness on the card: (a) K1 and K2 against their
    plain versions at the inputs the harness gives them; (b) the CLI's
    ``all`` run of EGW_ott, EGWL_ott, LEOT_ott and ECOOTL and a
    ``feature-matching`` run on the full screen, each with its launches;
    (c) all nine OT methods' ``all`` runs on a small screen on the card and
    on the CPU. Returns ({run: launches}, summary)."""
    import pickle

    import numpy as np
    import torch

    from otfusion_tpu_torch.cli import perturbot_eval
    from otfusion_tpu_torch.eval import harness
    from otfusion_tpu_torch.eval.matching import get_FOSCTTM

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    screen = _screen(rng, PERTURBOT_LABELS, PERTURBOT_ROWS, PERTURBOT_WIDTH,
                     PERTURBOT_DEAD)
    xs, ys = screen["Xs_dict"], screen["Xt_dict"]
    n_rows = sum(v.shape[0] for v in xs.values())
    k1, k2 = _perturbot_kernels(screen)
    t_kernels = time.perf_counter() - t0

    path = work / "screen.pkl"
    path.write_bytes(pickle.dumps(screen))
    out_dir = work / "perturbot"
    random_t = {k: np.ones((xs[k].shape[0], ys[k].shape[0])) for k in xs}
    _, random_foscttm = get_FOSCTTM(random_t, xs, ys)
    runs, summary = {}, {"kernels_s": t_kernels}
    eps = str(PERTURBOT_EPS)
    for method in CLI_METHODS:
        tag = f"perturbot-{method}"
        _, launches, seconds = _drive(tag, perturbot_eval, [
            "--quiet", "--out-dir", str(out_dir), "all", method, str(path),
            eps])
        res = pickle.loads((out_dir / f"all_{method}.{eps}.pkl").read_bytes())
        plan = _plans(res["T"])
        foscttm = res["matching_evals"]["mean_foscttm"]
        if method == "ECOOTL":
            want = {"gw": 0, "sinkhorn": (PERTURBOT_LABELS + 1)
                    * res["log"]["n_iters"]}
        else:
            want = {"EGW_ott": {"gw": 1, "sinkhorn": 0},
                    "EGWL_ott": {"gw": 0, "sinkhorn": 0},
                    "LEOT_ott": {"gw": 0, "sinkhorn": 1}}[method]
        log(f"[{tag}] {n_rows} rows: FOSCTTM {foscttm:.4f} (random coupling "
            f"{random_foscttm:.4f}); rel dfracs "
            f"{res['matching_evals']['rel_dfracs']:.4f}; counts "
            f"{_walk_counts(res['log'])}; launches {launches} (want {want})")
        check(bool(np.isfinite(plan).all()), f"[{tag}] coupling not finite")
        check(abs(plan.sum() - 1.0) <= 1e-3, f"[{tag}] coupling mass "
              f"{plan.sum()}")
        check(foscttm < random_foscttm, f"[{tag}] FOSCTTM {foscttm} not "
              f"below the random coupling's {random_foscttm}")
        check(launches == want, f"[{tag}] launches {launches}, want {want}")
        runs[tag] = launches
        summary[method] = {"seconds": seconds, "foscttm": foscttm,
                           "counts": _walk_counts(res["log"])}
    tag = "perturbot-feature-matching"
    _, launches, seconds = _drive(tag, perturbot_eval, [
        "--quiet", "--out-dir", str(out_dir), "feature-matching", "EGW_ott",
        str(path), "1e-2", "5e-3"])
    res = pickle.loads((out_dir / "features_EGW_ott.0.005.pkl").read_bytes())
    tv = res["Tv"]
    log(f"[{tag}] Tv {tv.shape}, mass {tv.sum():.6f}, FOT n_iters "
        f"{res['log']['n_iters']}; launches {launches}")
    check(tv.shape == (PERTURBOT_WIDTH, PERTURBOT_WIDTH)
          and bool(np.isfinite(tv).all()) and abs(tv.sum() - 1.0) <= 1e-3,
          f"[{tag}] Tv not finite, of the wrong shape or mass")
    check(launches == {"gw": 1, "sinkhorn": 1},
          f"[{tag}] launches {launches}, want one of each")
    runs[tag] = launches
    summary["feature-matching"] = {"seconds": seconds}

    # (c) every OT method on a small screen, on the card and on the CPU
    small = _screen(np.random.default_rng(SMALL_SCREEN_SEED), **SMALL_SCREEN)
    small_path = work / "small.pkl"
    small_path.write_bytes(pickle.dumps(small))
    methods = sorted(m for m in harness.OT_METHOD_MAP if "VAE" not in m)
    worst = 0.0
    for method in methods:
        tag = f"perturbot-small-{method}"
        common = ["--quiet", "all", method, str(small_path), eps]
        _, launches, _ = _drive(tag, perturbot_eval, [
            "--out-dir", str(work / "small_cuda"), *common])
        perturbot_eval.main(["--device", "cpu", "--out-dir",
                             str(work / "small_cpu"), *common])
        name = f"all_{method}.{eps}.pkl"
        a = pickle.loads((work / "small_cuda" / name).read_bytes())
        b = pickle.loads((work / "small_cpu" / name).read_bytes())
        pa, pb = _plans(a["T"]), _plans(b["T"])
        d_plan = float(np.abs(pa - pb).max() / np.abs(pb).max())
        d_metric = max(abs(a["matching_evals"][k] - b["matching_evals"][k])
                       for k in b["matching_evals"])
        counts = _walk_counts(a["log"]), _walk_counts(b["log"])
        log(f"[{tag}] cuda against cpu: max|dT| {d_plan:.3e} max T, metrics "
            f"{d_metric:.3e}; counts {counts[0]}")
        check(d_plan <= 1e-4, f"[{tag}] plans differ by {d_plan} max T")
        check(d_metric <= 1e-4, f"[{tag}] metrics differ by {d_metric}")
        check(counts[0] == counts[1], f"[{tag}] counts differ: {counts}")
        worst = max(worst, d_plan)
        runs[tag] = launches
    summary["small_worst_plan_diff"] = worst
    summary["seconds"] = time.perf_counter() - t0
    log(f"[perturbot] phase {summary['seconds']:.2f} s (kernels "
        f"{t_kernels:.2f} s)")
    shutil.rmtree(out_dir)
    return runs, {"k1": k1, "k2": k2, "runs": summary}


# phase_k1_device: K1's device route (labels above 128 rows). The screen of
# 4 labels x 200-400 rows is phase 11's kind at the sizes real screens have
# per treatment; EGW_all_ott couples phase 11's whole screen as one label.
LARGE_LABELS = 4
LARGE_ROWS = (200, 400)
LARGE_SEED = 17
K1_DEVICE_RUNS = 5


def _phase11_screen():
    import numpy as np

    return _screen(np.random.default_rng(11), PERTURBOT_LABELS,
                   PERTURBOT_ROWS, PERTURBOT_WIDTH, PERTURBOT_DEAD)


def _k1_device_case(tag, x, y, m):
    """K1's device route against its plain version on the card: one
    device-route launch and no cluster launch, the same n_iters per label
    (one check apart at most, logged), the plan within 1e-4 of max T, no
    mass on padding; median times of K1_DEVICE_RUNS solves beside the
    bound."""
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.ops import gw_kernel
    from otfusion_tpu_torch.ops.gromov import _prep, egw_per_label

    L, cap = m.shape
    before = gw_kernel.COUNTER.count, gw_kernel.DEVICE_COUNTER.count
    ker = egw_per_label(x, y, m, m, epsilon=PERTURBOT_EPS)
    launches = (gw_kernel.COUNTER.count - before[0],
                gw_kernel.DEVICE_COUNTER.count - before[1])
    ref = egw_per_label(x, y, m, m, epsilon=PERTURBOT_EPS, plain=True)
    torch.cuda.synchronize()
    it_k, it_r = ker.n_iters.tolist(), ref.n_iters.tolist()
    t_max = float(ref.coupling.max())
    diff = float((ker.coupling - ref.coupling).abs().max())
    pad = float((ker.coupling * ~(m[:, :, None] & m[:, None, :])).abs().sum())
    log(f"[k1-device] {tag}: {L} labels x cap {cap} (rows "
        f"{m.sum(1).tolist()}): n_iters kernel {it_k} plain {it_r}; max|dT| "
        f"{diff:.3e} = {diff / t_max:.3e} max T; mass on padding {pad}; "
        f"launches (cluster, device) {launches}")
    check(launches == (0, 1), f"K1 {tag}: launches {launches}, want one on "
          "the device route")
    if it_k != it_r:
        log(f"[k1-device] {tag}: n_iters differ (kernel {it_k}, plain {it_r})")
    check(all(abs(a - b) <= 8 for a, b in zip(it_k, it_r)),
          f"K1 {tag}: n_iters more than one check apart")
    check(diff <= 1e-4 * t_max, f"K1 {tag}: plan differs by more than 1e-4 "
          "max T")
    check(pad == 0.0, f"K1 {tag}: mass on padding")
    cx, p, log_p = _prep(x, m)
    cy, q, log_q = _prep(y, m)
    args = (cx, cy, log_p, log_q, p, q)
    ms = time_ms(lambda: gw_kernel.gw_solve(*args, epsilon=PERTURBOT_EPS),
                 K1_DEVICE_RUNS)
    plain_ms = time_ms(lambda: gw_kernel.gw_solve_plain(
        *args, epsilon=PERTURBOT_EPS), K1_DEVICE_RUNS)
    bound_ms, bound_by = k1_bound(L, cap, it_k)
    log(f"[k1-device] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(median of {K1_DEVICE_RUNS}), bound {bound_ms:.5f} ms "
        f"({bound_by}), {bound_ms / ms:.4f} of the bound")
    return {"labels": L, "cap": cap, "n_iters": it_k, "plain_n_iters": it_r,
            "max_abs_err": diff, "rel_err": diff / t_max, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launches_per_solve": 1}


def _cli_card_and_cpu(tag, work, screen_path, method, eps, want):
    """``all <method>`` on the card (launches as ``want``) and on the CPU:
    couplings within 1e-4 of max T, FOSCTTM below the random coupling's;
    returns (launches, summary)."""
    import pickle

    import numpy as np

    from otfusion_tpu_torch.cli import perturbot_eval
    from otfusion_tpu_torch.eval.matching import get_FOSCTTM

    common = ["--quiet", "all", method, str(screen_path), eps]
    _, launches, seconds = _drive(tag, perturbot_eval, [
        "--out-dir", str(work / "k1d_cuda"), *common])
    t0 = time.perf_counter()
    perturbot_eval.main(["--device", "cpu", "--out-dir",
                         str(work / "k1d_cpu"), *common])
    cpu_seconds = time.perf_counter() - t0
    name = f"all_{method}.{eps}.pkl"
    a = pickle.loads((work / "k1d_cuda" / name).read_bytes())
    b = pickle.loads((work / "k1d_cpu" / name).read_bytes())
    pa, pb = _plans(a["T"]), _plans(b["T"])
    d_plan = float(np.abs(pa - pb).max() / np.abs(pb).max())
    screen = pickle.loads(screen_path.read_bytes())
    xs, ys = screen["Xs_dict"], screen["Xt_dict"]
    if isinstance(a["T"], dict):
        random_t = {k: np.ones((xs[k].shape[0], ys[k].shape[0])) for k in xs}
    else:
        random_t = np.ones(a["T"].shape)
    _, random_foscttm = get_FOSCTTM(random_t, xs, ys)
    foscttm = a["matching_evals"]["mean_foscttm"]
    counts = _walk_counts(a["log"]), _walk_counts(b["log"])
    log(f"[{tag}] cuda against cpu: max|dT| {d_plan:.3e} max T; FOSCTTM "
        f"{foscttm:.4f} (cpu {b['matching_evals']['mean_foscttm']:.4f}, "
        f"random {random_foscttm:.4f}); counts {counts[0]} (cpu "
        f"{counts[1]}); launches {launches} (want {want}); cuda {seconds:.2f}"
        f" s, cpu {cpu_seconds:.2f} s")
    check(bool(np.isfinite(pa).all()), f"[{tag}] coupling not finite")
    check(d_plan <= 1e-4, f"[{tag}] card and CPU plans differ by {d_plan} "
          "max T")
    check(foscttm < random_foscttm, f"[{tag}] FOSCTTM {foscttm} not below "
          f"the random coupling's {random_foscttm}")
    check(launches == want, f"[{tag}] launches {launches}, want {want}")
    return launches, {"seconds": seconds, "cpu_seconds": cpu_seconds,
                      "foscttm": foscttm, "random_foscttm": random_foscttm,
                      "plan_diff": d_plan, "counts": counts[0]}


def phase_k1_device(work):
    """(11b) K1's device route: against its plain version at the boundary,
    at 4 labels x 200-400 rows and at phase 11's screen as one label; then
    the CLI's ``all EGW_all_ott`` and ``all EGW_ott`` at those inputs, card
    against CPU. Returns ({run: launches}, {case: numbers}, summary)."""
    import pickle

    import numpy as np
    import torch

    from otfusion_tpu_torch.ops.api import _concat_dicts, _pad_dicts

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    x, y, m, _ = _gw_inputs(129, 100)
    cases["cap129"] = _k1_device_case("2 labels x cap 129, d 2048", x, y, m)
    large = _screen(np.random.default_rng(LARGE_SEED), LARGE_LABELS,
                    LARGE_ROWS, PERTURBOT_WIDTH, PERTURBOT_DEAD)
    _, xs, ys, xm, _ = _pad_dicts(large["Xs_dict"], large["Xt_dict"],
                                  common_cap=True)
    cuda = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    cases["labels4"] = _k1_device_case(
        "4 labels x 200-400 rows, d 2048", cuda(xs), cuda(ys), cuda(xm))
    screen = _phase11_screen()
    _, xa, ya, _, _ = _concat_dicts(screen["Xs_dict"], screen["Xt_dict"])
    ones = torch.ones((1, xa.shape[0]), dtype=torch.bool, device="cuda")
    cases["screen"] = _k1_device_case(
        "phase 11's screen as one label", cuda(xa)[None], cuda(ya)[None],
        ones)
    t_kernels = time.perf_counter() - t0

    runs, summary = {}, {"kernels_s": t_kernels}
    eps = str(PERTURBOT_EPS)
    for tag, data, method in (("k1d-EGW_all_ott", screen, "EGW_all_ott"),
                              ("k1d-EGW_ott", large, "EGW_ott")):
        path = work / f"{tag}.pkl"
        path.write_bytes(pickle.dumps(data))
        runs[tag], summary[method] = _cli_card_and_cpu(
            tag, work, path, method, eps,
            {"sinkhorn": 0, "gw": 0, "gw_device": 1})
    shutil.rmtree(work / "k1d_cuda")
    shutil.rmtree(work / "k1d_cpu")
    summary["seconds"] = time.perf_counter() - t0
    log(f"[k1-device] phase {summary['seconds']:.2f} s (kernels "
        f"{t_kernels:.2f} s)")
    return runs, cases, summary


# phase_vae: the harness's VAE family on phase 11's screen, at the
# reference's grid point for the shared-latent VAE and the scVI-sized
# latent for VAE-then-OT.
VAE_EPS = "10,128,1e-4"
VAE_LATENT = 10
VAE_PARITY_STEPS = 10
VAE_SYNC_STEPS = 50


def _params_apart(a, b):
    """(share of parameter entries more than 1e-5 apart, largest gap)."""
    import numpy as np

    da = np.concatenate([(a[k].double().cpu() - b[k].double().cpu()).abs()
                         .numpy().ravel() for k in a])
    return float(np.mean(da > 1e-5)), float(da.max())


# Full-batch Adam scales each entry's step by its gradient's size, so the
# entries whose gradients are rounding noise move apart step by step: at
# phase 11's screen the CPU's own float32 steps of the shared-latent VAE
# part from its float64 steps by 2e-6 after one step and 8.4e-5 (relative,
# the discriminator's loss) after ten, so two float32 runs part by about
# twice that. Card and CPU are held to each other in float64 at the CPU
# tests' tolerances, and the card's float32 to its float64 at
# VAE_FLOAT32_LOSS.
VAE_FLOAT32_LOSS = 1e-3


def _vae_card_against_cpu(tag, make, optimizers, step, lr, draw):
    """The first VAE_PARITY_STEPS steps from the same weights (``make()`` on
    the CPU: (model, inputs)) and the same normals (``draw(generator)``, on
    the CPU): the card against the CPU in float64, losses within 1e-4
    relative at every step, 99.9 % of the parameters within 1e-5 and all
    within 2 lr steps (the CPU tests' bounds against JAX); the card's
    float32 against its float64, losses within VAE_FLOAT32_LOSS, the
    parameters within 2 lr steps."""
    import copy

    import torch

    def to(v, device, dtype):
        if torch.is_tensor(v):
            return v.to(device, dtype)
        return type(v)(*(t if t is None else t.to(device, dtype) for t in v))

    model, inputs = make()
    runs = {}
    for key, device, dtype in (("cpu64", "cpu", torch.float64),
                               ("card64", "cuda", torch.float64),
                               ("card32", "cuda", torch.float32)):
        m = copy.deepcopy(model).to(device, dtype)
        runs[key] = (m, optimizers(m), to(inputs, device, dtype), dtype,
                     device)
    gen = torch.Generator().manual_seed(5)
    losses = {k: [] for k in runs}
    for _ in range(VAE_PARITY_STEPS):
        noise = draw(gen)
        for key, (m, opt, x, dtype, device) in runs.items():
            out = step(m, opt, x, [n.to(device, dtype) for n in noise])
            losses[key].append(out.double().cpu())
    loss = {k: torch.stack(v) for k, v in losses.items()}
    rel64 = float(((loss["card64"] - loss["cpu64"]).abs()
                   / loss["cpu64"].abs()).max())
    rel32 = float(((loss["card32"] - loss["card64"]).abs()
                   / loss["card64"].abs()).max())
    state = {k: v[0].state_dict() for k, v in runs.items()}
    share64, gap64 = _params_apart(state["card64"], state["cpu64"])
    share32, gap32 = _params_apart(state["card32"], state["card64"])
    log(f"[vae] {tag}: {VAE_PARITY_STEPS} steps, card against CPU in "
        f"float64: losses {rel64:.3e} relative at worst, parameters "
        f"{share64:.2e} more than 1e-5 apart, {gap64:.3e} at most; the card's "
        f"float32 against its float64: losses {rel32:.3e}, parameters "
        f"{share32:.2e} more than 1e-5 apart, {gap32:.3e} at most")
    bound = 2 * lr * VAE_PARITY_STEPS
    check(rel64 <= 1e-4 and share64 <= 1e-3 and gap64 <= bound,
          f"[vae] {tag}: card and CPU apart in float64 ({rel64}, {share64}, "
          f"{gap64})")
    check(rel32 <= VAE_FLOAT32_LOSS and gap32 <= bound,
          f"[vae] {tag}: float32 apart from float64 ({rel32}, {gap32})")
    return {"loss_rel_64": rel64, "params_share_apart_64": share64,
            "params_max_gap_64": gap64, "loss_rel_32": rel32,
            "params_share_apart_32": share32, "params_max_gap_32": gap32}


def _loop_without_sync(tag, run, steps):
    """``run(steps)`` (a trainer's step loop) under
    ``set_sync_debug_mode("error")``: a host read raises. Then the ms a
    step of another such loop, between CUDA events."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(steps)
    except RuntimeError as err:
        fail(f"[vae] {tag}: a host read in the step loop: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    log(f"[vae] {tag}: {steps} steps without a host read; {ms:.4f} ms a "
        "step")
    return ms


def phase_vae(work):
    """(11c) The VAE family through the CLI on phase 11's screen, card
    against CPU over the first steps, and the step loops without a host
    read. Returns ({run: launches}, summary)."""
    import pickle

    import numpy as np
    import torch

    from otfusion_tpu_torch.cli import perturbot_eval
    from otfusion_tpu_torch.eval import preprocess, vae

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    screen = _phase11_screen()
    data = (screen["Xs_dict"], screen["Xt_dict"])
    path = work / "vae_screen.pkl"
    path.write_bytes(pickle.dumps(screen))
    out = work / "vae"
    adv_w, latent, lr = perturbot_eval._parse_eps(VAE_EPS)
    runs, summary = {}, {}
    none = {"sinkhorn": 0, "gw": 0}

    # all VAE_label at the reference's grid point
    _, launches, seconds = _drive("vae-all-VAE_label", perturbot_eval, [
        "--quiet", "--out-dir", str(out), "all", "VAE_label", str(path),
        VAE_EPS])
    res = pickle.loads((out / f"all_VAE_label.{(adv_w, latent, lr)}.pkl")
                       .read_bytes())
    me, vlog = res["matching_evals"], res["log"]
    model, batch = vae.init_vae_match(data, latent, True, device="cuda")
    gen_opt, disc_opt = vae.make_optimizers(model, lr)
    first = vae.vae_match_steps(model, gen_opt, disc_opt, batch, 1, 0,
                                adv_w)
    first_recon = float(first[0, 2])
    finite = [me["mean_foscttm"], *me["dfracs"].values(),
              *me["rel_dfracs"].values(),
              *(v for k, v in vlog.items() if k.startswith("final"))]
    log(f"[vae-all-VAE_label] FOSCTTM {me['mean_foscttm']:.4f}, rel dfracs "
        f"{me['rel_dfracs']}; recon {first_recon:.5f} at the first step, "
        f"{vlog['final_recon']:.5f} at the last; {seconds:.2f} s")
    check(bool(np.isfinite(finite).all()), "[vae-all-VAE_label] not finite")
    check(vlog["final_recon"] < first_recon,
          "[vae-all-VAE_label] final recon not below the first step's")
    check(launches == none, f"[vae-all-VAE_label] launches {launches}")
    runs["vae-all-VAE_label"] = launches
    summary["all_VAE_label"] = {"seconds": seconds,
                                "foscttm": me["mean_foscttm"],
                                "first_recon": first_recon,
                                "final_recon": vlog["final_recon"]}

    # loo VAE: one shared-latent VAE a fold
    _, launches, seconds = _drive("vae-loo-VAE", perturbot_eval, [
        "--quiet", "--out-dir", str(out), "loo", "VAE", str(path), VAE_EPS])
    res = pickle.loads((out / f"loo_VAE.{(adv_w, latent, lr)}.pkl")
                       .read_bytes())
    mses = [r["MSE"] for r in res["evals"]]
    preds = np.concatenate([np.ravel(v) for v in res["log"]["preds"]
                            .values()])
    recon = [lg["final_recon"] for lg in res["log"]["logs"].values()]
    log(f"[vae-loo-VAE] {len(mses)} folds: MSE {min(mses):.4f}-"
        f"{max(mses):.4f}; final recon {min(recon):.4f}-{max(recon):.4f}; "
        f"{seconds:.2f} s")
    check(len(mses) == PERTURBOT_LABELS and bool(np.isfinite(mses).all())
          and bool(np.isfinite(preds).all()), "[vae-loo-VAE] not finite")
    check(launches == none, f"[vae-loo-VAE] launches {launches}")
    runs["vae-loo-VAE"] = launches
    summary["loo_VAE"] = {"seconds": seconds, "mse": [min(mses), max(mses)]}

    # loo EGW_ott --latent-vae: two VAEs and one K1 solve a fold
    _, launches, seconds = _drive("vae-loo-latent-EGW_ott", perturbot_eval, [
        "--quiet", "--out-dir", str(out), "loo", "EGW_ott", str(path),
        str(PERTURBOT_EPS), "--latent-vae", "--latent-dim",
        str(VAE_LATENT)])
    res = pickle.loads((out / f"loo_vae_EGW_ott.{PERTURBOT_EPS}.pkl")
                       .read_bytes())
    rows = [r for r in res["evals"] if r["_id"] == "ot_latent"]
    preds = np.concatenate([np.ravel(v[0]) for v in res["log"]["preds"]
                            .values()])
    vlogs = [v for fold in res["log"]["vae_logs"].values()
             for v in fold.values()]
    falls = all(v["losses"][-1] < v["losses"][0] for v in vlogs)
    counts = _walk_counts(res["log"]["logs"])
    log(f"[vae-loo-latent-EGW_ott] {len(rows)} folds, {len(vlogs)} VAEs: "
        f"ot_latent MSE {min(r['MSE'] for r in rows):.4f}-"
        f"{max(r['MSE'] for r in rows):.4f}; every VAE's loss fell {falls}; "
        f"K1 counts {sorted(set(counts.values()), key=str)}; launches "
        f"{launches}; {seconds:.2f} s")
    check(len(rows) == PERTURBOT_LABELS and bool(np.isfinite(preds).all())
          and all(np.isfinite(r["MSE"]) for r in rows),
          "[vae-loo-latent-EGW_ott] not finite")
    check(falls, "[vae-loo-latent-EGW_ott] a VAE's loss did not fall")
    check(launches == {"sinkhorn": 0, "gw": PERTURBOT_LABELS},
          f"[vae-loo-latent-EGW_ott] launches {launches}, want K1 once a "
          "fold")
    runs["vae-loo-latent-EGW_ott"] = launches
    summary["loo_latent_EGW_ott"] = {"seconds": seconds}
    shutil.rmtree(out)

    # the first steps card against CPU, then the loops without a host read
    n_x = sum(v.shape[0] for v in data[0].values())

    summary["parity_match"] = _vae_card_against_cpu(
        "train_vae_model",
        lambda: vae.init_vae_match(data, latent, True, device="cpu"),
        lambda m: vae.make_optimizers(m, lr),
        lambda m, o, b, n: vae.vae_match_step(m, *o, b, *n, adv_w), lr,
        lambda g: [torch.randn((n_x, latent), generator=g),
                   torch.randn((n_x, latent), generator=g)])
    summary["parity_modality"] = _vae_card_against_cpu(
        "train_modality_vae",
        lambda: preprocess.init_modality_vae(data[0], VAE_LATENT,
                                             device="cpu"),
        lambda m: preprocess.make_adam(m.parameters(), 1e-3),
        lambda m, o, x, n: preprocess.modality_vae_step(m, o, x, *n), 1e-3,
        lambda g: [torch.randn((n_x, VAE_LATENT), generator=g)])
    model, batch = vae.init_vae_match(data, latent, True, device="cuda")
    opts = vae.make_optimizers(model, lr)
    summary["match_step_ms"] = _loop_without_sync(
        "train_vae_model", lambda n: vae.vae_match_steps(
            model, *opts, batch, n, 0, adv_w), VAE_SYNC_STEPS)
    mvae, xn = preprocess.init_modality_vae(data[0], VAE_LATENT,
                                            device="cuda")
    mopt = preprocess.make_adam(mvae.parameters(), 1e-3)
    summary["modality_step_ms"] = _loop_without_sync(
        "train_modality_vae", lambda n: preprocess.modality_vae_steps(
            mvae, mopt, xn, n, 0), VAE_SYNC_STEPS)
    summary["seconds"] = time.perf_counter() - t0
    log(f"[vae] phase {summary['seconds']:.2f} s")
    return runs, summary


# phase_gamma: the legacy GAMMA fundus+OCT trainer and its ensemble tester.
# The cohort is written at a photograph-like 512^2 and OCT 112^3, so the
# loader's resizes to the CLI defaults (384^2, 96^3: d_oct = 6144) run.
GAMMA_CASES = 40
GAMMA_WRITTEN = dict(fundus_size=512, oct_shape=(112, 112, 112))
GAMMA_FUNDUS = 384
GAMMA_OCT = 96
GAMMA_LABELS = 2
GAMMA_BATCH = 4
GAMMA_EPS = 5e-3
GAMMA_GW_ITERS = 500  # the legacy train step's EGWL cap
# One train step, card against CPU, at a size the CPU steps quickly:
# fundus 128^2, OCT 32^3 (d_oct 2048). In float32 the gradients of these
# shapes are noise-limited (the port's own float32 and float64 steps on
# the CPU part by 0.42 of a leaf's largest entry in layer4 of Res2Net,
# 4x4 maps over 4 cases): the float32 step is held on its losses and on
# AdamW's bound for each update (2 lr), the float64 step on every
# gradient leaf and on the updates whose sign is firm.
GAMMA_PARITY_FUNDUS = 128
GAMMA_PARITY_OCT = 32
GAMMA_PARITY_LR = 1e-4
GAMMA_PARITY = {
    "float32": {"loss_rel": 1e-3, "moved_share": 2e-2},
    "float64": {"loss_rel": 1e-5, "grad_rel": 1e-3, "firm_abs": 1e-6},
}


def _gamma_model(fundus_size, oct_depth, dropout=True):
    from otfusion_tpu_torch.models.legacy_fusion import (
        LegacyMultiModalFusion,
        probe_oct_dim,
    )

    rates = {} if dropout else dict(projection_dropout=0.0,
                                    attention_dropout=0.0)
    return LegacyMultiModalFusion(
        num_classes=GAMMA_LABELS, oct_input_depth=oct_depth,
        oct_feature_dim=probe_oct_dim((oct_depth,) * 3), **rates)


def _gamma_features(mgamma, label_csv, n_cases):
    """Features of the first ``n_cases`` cases as the train step's encode
    gives them (a seeded full-width model, BatchNorm in train mode, bf16
    autocast, batches of 4): (fundus (n, 2048), OCT (n, 6144), labels),
    on the card."""
    import torch

    from otfusion_tpu_torch.data.gamma import GammaDataset, GammaLoader

    torch.manual_seed(0)
    model = _gamma_model(GAMMA_FUNDUS, GAMMA_OCT).cuda().train()
    ds = GammaDataset(mgamma, label_csv, oct_shape=(GAMMA_OCT,) * 3,
                      fundus_size=GAMMA_FUNDUS)
    loader = GammaLoader(ds, range(n_cases), GAMMA_BATCH,
                         feed_dtype=torch.bfloat16)
    f_all, o_all, y_all = [], [], []
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        for fundus, oct_vol, labels in loader:
            f, o = model.encode(fundus.cuda(), oct_vol.cuda())
            f_all.append(f.float())
            o_all.append(o.float())
            y_all.append(labels.cuda())
    return torch.cat(f_all), torch.cat(o_all), torch.cat(y_all)


def _gw_loss(x, y, xm, ym, t):
    """Each label's GW loss sum_ijkl (Cx_ik - Cy_jl)^2 T_ij T_kl of plan
    ``t`` on the costs ``_prep`` builds, in float64: two plans of one
    problem that part by a permutation at an equal loss are a tie."""
    import torch

    from otfusion_tpu_torch.ops.gromov import _prep

    cx, cy = (_prep(a, m)[0].double() for a, m in ((x, xm), (y, ym)))
    t = t.double()
    a, b = t.sum(2), t.sum(1)
    loss = (torch.einsum("li,lij,lj->l", a, cx * cx, a)
            + torch.einsum("li,lij,lj->l", b, cy * cy, b)
            - 2 * torch.einsum("lij,lik,lkm,ljm->l", t, cx, t, cy))
    return [float(v) for v in loss]


def _gamma_kernels(mgamma, label_csv):
    """K2 at the train step's input, the (6144, 2048) FOT cost from a
    4-row EGWL plan on real encoder features; EGWL on the card against the
    CPU; K1 at the coupling's input (the 32 cases of a 5-fold train split,
    2 labels x cap 64, 16 rows each; its FOT is K2 at the same shape)."""
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.ops import gw_kernel
    from otfusion_tpu_torch.ops.fot import feature_cost
    from otfusion_tpu_torch.ops.gromov import (
        _prep,
        egw_per_label,
        entropic_gw_labels,
    )
    from otfusion_tpu_torch.train.coupling import group_and_pad

    f, o, y = _gamma_features(mgamma, label_csv,
                              GAMMA_CASES - GAMMA_CASES // 5)
    fb, ob, yb = f[:GAMMA_BATCH], o[:GAMMA_BATCH], y[:GAMMA_BATCH]
    egwl, plans = {}, {}
    for tag, a, b in (("f2o", fb, ob), ("o2f", ob, fb)):
        kw = dict(epsilon=GAMMA_EPS, max_iterations=GAMMA_GW_ITERS)
        card = entropic_gw_labels(a, b, yb, yb, **kw)
        cpu = entropic_gw_labels(a.cpu(), b.cpu(), yb.cpu(), yb.cpu(), **kw)
        it_card, it_cpu = int(card.n_iters), int(cpu.n_iters)
        t_max = float(cpu.coupling.max())
        diff = float((card.coupling.cpu() - cpu.coupling).abs().max())
        ms = time_ms(lambda: entropic_gw_labels(a, b, yb, yb, **kw), 10)
        log(f"[gamma] EGWL {tag} (4 x 4, d {a.shape[1]} -> {b.shape[1]}): "
            f"n_iters card {it_card} CPU {it_cpu}; max|dT| "
            f"{diff / t_max:.3e} max T; {ms:.3f} ms a solve, "
            f"{it_card // 8} host reads")
        check(it_card == it_cpu, f"[gamma] EGWL {tag}: n_iters differ")
        check(diff <= 1e-4 * t_max, f"[gamma] EGWL {tag}: plans differ")
        egwl[tag] = {"n_iters": it_card, "rel_err": diff / t_max, "ms": ms,
                     "host_reads": it_card // 8}
        plans[tag] = card.coupling

    # the step's FOT: fot(o, f, t_f2o.T) normalises the plan, then solves
    # the max-scaled feature cost
    ts = plans["f2o"].T / plans["f2o"].sum()
    k2_step = _k2_harness_case(
        "step FOT", feature_cost(ob, fb, ts).contiguous(), 20, 5,
        phase="gamma", epsilon=GAMMA_EPS, scale_cost=True)

    # the coupling's inputs, as train_gamma.eval_coupling builds them
    ya = y.cpu().numpy()
    o_g, o_m = group_and_pad(o.cpu().numpy(), ya, GAMMA_LABELS, 64)
    f_g, f_m = group_and_pad(f.cpu().numpy(), ya, GAMMA_LABELS, 64)
    to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    x, xm, yg, ym = to(o_g), to(o_m), to(f_g), to(f_m)
    before = gw_kernel.COUNTER.count
    ker = egw_per_label(x, yg, xm, ym, epsilon=GAMMA_EPS)
    per_solve = gw_kernel.COUNTER.count - before
    ref = egw_per_label(x, yg, xm, ym, epsilon=GAMMA_EPS, plain=True)
    it_k, it_r = ker.n_iters.tolist(), ref.n_iters.tolist()
    t_max = float(ref.coupling.max())
    diff = float((ker.coupling - ref.coupling).abs().max())
    pad = float((ker.coupling * ~(xm[:, :, None] & ym[:, None, :])).abs()
                .sum())
    log(f"[gamma] K1 coupling: n_iters kernel {it_k} plain {it_r}; max|dT| "
        f"{diff:.3e} = {diff / t_max:.3e} max T; mass on padding {pad}; "
        f"GW loss a label kernel {_gw_loss(x, yg, xm, ym, ker.coupling)} "
        f"plain {_gw_loss(x, yg, xm, ym, ref.coupling)}")
    check(it_k == it_r, "K1 at the gamma coupling: n_iters differ")
    check(diff <= 1e-4 * t_max, "K1 at the gamma coupling: plans differ by "
          "more than 1e-4 max T")
    check(pad == 0.0, "K1 at the gamma coupling: mass on padding")
    check(per_solve == 1, "K1 at the gamma coupling: more than one launch")
    cx, p, log_p = _prep(x, xm)
    cy, q, log_q = _prep(yg, ym)
    args = (cx, cy, log_p, log_q, p, q)
    ms = time_ms(lambda: gw_kernel.gw_solve(*args, epsilon=GAMMA_EPS))
    plain_ms = time_ms(lambda: gw_kernel.gw_solve_plain(
        *args, epsilon=GAMMA_EPS), 5)
    bound_ms, bound_by = k1_bound(2, 64, it_k)
    log(f"[gamma] K1 coupling (rows {o_m.sum(1).tolist()} of cap 64): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    k1 = {"rows": o_m.sum(1).tolist(), "n_iters": it_k,
          "max_abs_err": diff, "rel_err": diff / t_max, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by}
    return {"k1": k1, "k2_step": k2_step, "egwl": egwl}


def _gamma_parity_step():
    """One train step from identical weights, dropout at 0 and the same
    partner indices, on the card (TF32 off, deterministic cuDNN) and on
    the CPU, in float32 and in float64 (EGWL and FOT compute in float32
    in both, as in the JAX step). Float32: the losses, and every updated
    parameter within AdamW's first-step bound, with the share that moved
    apart logged; float64: the losses, every gradient leaf and the
    updated parameters where the gradient's sign is firm."""
    import copy

    import numpy as np
    import torch

    from otfusion_tpu_torch.train.legacy_steps import make_legacy_train_step
    from otfusion_tpu_torch.train.train_state import make_optimizer

    torch.manual_seed(1)
    start = _gamma_model(GAMMA_PARITY_FUNDUS, GAMMA_PARITY_OCT,
                         dropout=False)
    rng = np.random.default_rng(2)
    s, d = GAMMA_PARITY_FUNDUS, GAMMA_PARITY_OCT
    fundus = torch.from_numpy(rng.uniform(size=(4, s, s, 3)).astype(
        np.float32))
    oct_vol = torch.from_numpy(rng.uniform(size=(4, d, d, d, 1)).astype(
        np.float32))
    labels = torch.tensor([0, 1, 0, 1])
    # partners of the same label, as the label-masked plans give them
    partners = torch.tensor([2, 3, 0, 1])

    def run(dtype, device):
        model = copy.deepcopy(start).to(device, dtype)
        optimizer = make_optimizer(model.parameters(), GAMMA_PARITY_LR)
        step = make_legacy_train_step(
            model, optimizer, sample_partners=lambda a, b, g: (
                partners.to(device), partners.to(device)))
        met = step(fundus.to(device, dtype), oct_vol.to(device, dtype),
                   labels.to(device))
        return {k: float(v) for k, v in met.items()}, {
            n: (p.detach().double().cpu(), p.grad.double().cpu())
            for n, p in model.named_parameters()}

    out = {}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    for dtype in (torch.float32, torch.float64):
        # the comparison settings (the trainer phases turn cuDNN's TF32 on)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            card, card_p = run(dtype, "cuda")
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        cpu, cpu_p = run(dtype, "cpu")
        loss_rel = max(abs(card[k] - cpu[k]) / abs(cpu[k])
                       for k in ("loss", "ce_loss", "ot_loss"))
        grad_rel, worst, param_abs, firm_abs = 0.0, "", 0.0, 0.0
        moved = firm = total = 0
        for name, (p, g) in cpu_p.items():
            pc, gc = card_p[name]
            scale = float(g.abs().max())
            rel = (float((gc - g).abs().max()) - 1e-9) / max(scale, 1e-30)
            if rel > grad_rel:
                grad_rel, worst = rel, name
            diff = (pc - p).abs()
            param_abs = max(param_abs, float(diff.max()))
            moved += int((diff > 1e-6).sum())
            # AdamW's first update is lr * g / (|g| + 1e-8): its sign where
            # |g| is well above 1e-8, weight decay alone where g is 0
            sure = (g.abs() >= 1e-6) | ((g == 0) & (gc == 0))
            if bool(sure.any()):
                firm_abs = max(firm_abs, float(diff[sure].max()))
            firm += int(sure.sum())
            total += g.numel()
        tag = str(dtype).split(".")[-1]
        log(f"[gamma] one {tag} step, card against CPU: losses {card} / "
            f"{cpu}, worst relative {loss_rel:.3e}; gradients within "
            f"{grad_rel:.3e} of a leaf's largest (+1e-9; worst {worst}); "
            f"updated parameters within {param_abs:.3e}, {moved / total:.4f} "
            f"of them more than 1e-6 apart; where |g| >= 1e-6 or g = 0 "
            f"({firm / total:.4f} of them) within {firm_abs:.3e}")
        check(card["correct"] == cpu["correct"],
              f"[gamma] {tag} parity: correct")
        bounds = GAMMA_PARITY[tag]
        check(loss_rel <= bounds["loss_rel"], f"[gamma] {tag} parity: losses")
        check(param_abs <= 2.0 * GAMMA_PARITY_LR * (1 + 1e-3),
              f"[gamma] {tag} parity: an update beyond AdamW's bound")
        if tag == "float32":
            check(moved / total <= bounds["moved_share"],
                  f"[gamma] {tag} parity: too many updates apart")
        else:
            check(grad_rel <= bounds["grad_rel"],
                  f"[gamma] {tag} parity: gradients")
            check(firm_abs <= bounds["firm_abs"],
                  f"[gamma] {tag} parity: updated parameters")
        out[tag] = {"loss_rel": loss_rel, "grad_rel": grad_rel,
                    "param_abs": param_abs, "moved_share": moved / total,
                    "firm_abs": firm_abs, "firm_share": firm / total}
    return out


def _check_ensemble_metrics(tag, metrics):
    """Every ensemble metric finite, but the one whose definition
    (scikit-learn's, kept by the JAX package) leaves it undefined when
    every prediction is right: the FPR at 95 % TPR of correctness, which
    then has no negatives."""
    import math

    undefined = set()
    if metrics["ens_accuracy"] == 1.0:
        undefined.add("ens_fpr_at_95_tpr")
    bad = sorted(k for k, v in metrics.items()
                 if not math.isfinite(v) and k not in undefined)
    check(not bad, f"[{tag}] metrics not finite: {bad}")
    for key in undefined:
        log(f"[{tag}] {key} = {metrics[key]} (undefined on this data)")


def phase_gamma(work):
    """The legacy GAMMA surface at full width (see the module docstring):
    the fixture, K2 and EGWL at the step's inputs and K1 at the
    coupling's, ``train_gamma --folds 5 --max-folds 2 --epochs 2`` and
    ``test_gamma`` on its two folds with their launches, and one step
    card against CPU. Returns ({run: launches}, summary)."""
    import math

    import torch

    from otfusion_tpu_torch.cli import test_gamma, train_gamma
    from otfusion_tpu_torch.data.gamma import make_synthetic_gamma

    t0 = time.perf_counter()
    mgamma, label_csv = make_synthetic_gamma(
        work / "gamma", n_cases=GAMMA_CASES, n_classes=GAMMA_LABELS,
        seed=0, **GAMMA_WRITTEN)
    t_fixture = time.perf_counter() - t0
    log(f"[gamma] cohort of {GAMMA_CASES} cases, written as "
        f"{GAMMA_WRITTEN} ({t_fixture:.2f} s)")
    kernels = _gamma_kernels(mgamma, label_csv)
    t_kernels = time.perf_counter() - t0 - t_fixture

    out = work / "gamma_run"
    folds, max_folds, epochs = 5, 2, 2
    torch.cuda.reset_peak_memory_stats()
    size = ["--fundus-size", str(GAMMA_FUNDUS), "--oct-shape",
            *[str(GAMMA_OCT)] * 3]
    _, launches, train_s = _drive("gamma-train", train_gamma, [
        "--data-root", str(mgamma), "--label-file", str(label_csv),
        "--folds", str(folds), "--max-folds", str(max_folds),
        "--epochs", str(epochs), "--save-path", str(out), *size])
    peak = torch.cuda.max_memory_allocated() / 2**30
    train_cases = GAMMA_CASES - GAMMA_CASES // folds
    steps = max_folds * epochs * math.ceil(train_cases / GAMMA_BATCH)
    couplings = epochs * max_folds + max_folds
    want = {"sinkhorn": steps + couplings, "gw": couplings}
    log(f"[gamma-train] {steps} train steps, {couplings} couplings: "
        f"launches {launches} (want {want}); peak {peak:.2f} GiB")
    timings = json.loads((out / "timings.json").read_text())
    for row in timings:
        log(f"[gamma-train] fold {row['fold']} epoch {row['epoch']}: "
            f"phase_seconds {row['phase_seconds']}; median step "
            f"{row['median_step_ms']:.1f} ms")
    check(launches == want, f"[gamma-train] launches {launches}, want {want}")
    metrics = json.loads((out / "ensemble_metrics.json").read_text())
    log(f"[gamma-train] ensemble: {json.dumps(metrics)}")
    check(metrics["n_members"] == max_folds, "[gamma-train] members")
    _check_ensemble_metrics("gamma-train", metrics)
    for fold in range(max_folds):
        check((out / f"fold{fold}" / "checkpoint.pt").exists(),
              f"[gamma-train] no checkpoint for fold {fold}")

    _, test_launches, test_s = _drive("gamma-test", test_gamma, [
        "--data-root", str(mgamma), "--label-file", str(label_csv),
        "--checkpoints", str(out / "fold0"), str(out / "fold1"),
        "--output", str(work / "gamma_test.json"), *size])
    tested = json.loads((work / "gamma_test.json").read_text())
    log(f"[gamma-test] metrics: {json.dumps(tested)}")
    check(test_launches == {"sinkhorn": max_folds, "gw": max_folds},
          f"[gamma-test] launches {test_launches}, want one of each a "
          "member")
    _check_ensemble_metrics("gamma-test", tested)
    parity = _gamma_parity_step()
    seconds = time.perf_counter() - t0
    log(f"[gamma] phase {seconds:.2f} s (fixture {t_fixture:.2f}, kernels "
        f"{t_kernels:.2f}, trainer {train_s:.2f}, tester {test_s:.2f})")
    shutil.rmtree(work / "gamma")
    shutil.rmtree(out)
    summary = {"seconds": seconds, "train_seconds": train_s,
               "test_seconds": test_s, "peak_gib": peak,
               "median_step_ms": [r["median_step_ms"] for r in timings],
               "phase_seconds": [r["phase_seconds"] for r in timings],
               "parity": parity, "egwl": kernels["egwl"]}
    return ({"gamma-train": launches, "gamma-test": test_launches},
            kernels, summary)


# Phase 12: the run's PNG artifacts, t-SNE on the card, device
# preprocessing and the data tools.
ARTIFACT_SIZES = {"confusion_matrix.png": (800, 1000),
                  "tsne_best_val.png": (600, 800)}
TSNE_SEED = 0
TSNE_ROWS, TSNE_WIDTH = 512, 2048
RAW_VOLUME, PREPROCESSED = (256, 256, 176), (128, 128, 128)
HOST_ONLY = ("matplotlib", "sklearn", "PIL", "pydicom", "jax")


def _tsne_card_and_cpu(tag, x, whole_run):
    """t-SNE of ``x`` (a CPU tensor) on the card and on the CPU: P within
    1e-6, the PCA start within 1e-6 of its largest entry, the first 10
    iterations within 1e-9 of the embedding's largest entry, at most 21 host
    reads on the card (counted under CUDA's sync debug mode, the input
    already on the card); with ``whole_run`` also the same iteration count
    and the card's final KL within 5 % of the CPU's. Returns the summary."""
    import warnings

    import torch

    from otfusion_tpu_torch.utils import tsne

    n = x.shape[0]
    perplexity = tsne.default_perplexity(n)
    k = tsne.n_neighbors(n, perplexity)
    lr = tsne.learning_rate(n)
    p, start, steps = {}, {}, {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev)
        p[dev] = tsne.joint_probabilities_nn(*tsne.knn_sqdist(xd, k),
                                             perplexity)
        start[dev] = tsne.pca_init(xd)
        steps[dev] = tsne._gradient_descent(
            start["cpu"].to(dev, torch.float64),
            p[dev] * tsne.EARLY_EXAGGERATION, 0, 10, 0.5, lr, 250)[0].cpu()
    p_err = float((p["cuda"].cpu() - p["cpu"]).abs().max())
    start_err = float((start["cuda"].cpu() - start["cpu"]).abs().max()
                      / start["cpu"].abs().max())
    step_err = float((steps["cuda"] - steps["cpu"]).abs().max()
                     / steps["cpu"].abs().max())
    x_card = x.cuda()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            card = tsne.tsne(x_card, device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        card_s = time.perf_counter() - t0
    # (setting the mode warns once that it is a prototype: not a read)
    reads = sum(str(w.message).startswith("called a synchronizing")
                for w in caught)
    t0 = time.perf_counter()
    cpu = tsne.tsne(x, device="cpu")
    cpu_s = time.perf_counter() - t0
    kl_gap = abs(card.kl_divergence - cpu.kl_divergence) / cpu.kl_divergence
    # how far float32 rounding of the start moves a whole run on the CPU
    nudged = start["cpu"] * (1.0 + 1e-7 * torch.randn(
        start["cpu"].shape, generator=torch.Generator().manual_seed(1)))
    moved = tsne.tsne(x, device="cpu", init=nudged)
    out = {"n": n, "d": int(x.shape[1]), "perplexity": perplexity,
           "p_max_abs_err": p_err, "start_rel_err": start_err,
           "step10_rel_err": step_err, "n_iter": [card.n_iter, cpu.n_iter],
           "kl": [card.kl_divergence, cpu.kl_divergence],
           "kl_rel_gap": kl_gap, "cpu_start_1e-7_apart": {
               "n_iter": moved.n_iter, "kl": moved.kl_divergence},
           "host_reads": reads,
           "checks": card.checks, "card_s": card_s, "cpu_s": cpu_s}
    log(f"[{tag}] {json.dumps(out)}")
    check(p_err <= 1e-6, f"[{tag}] P on the card {p_err:.3e} from the CPU's")
    check(start_err <= 1e-6, f"[{tag}] PCA start {start_err:.3e} apart")
    check(step_err <= 1e-9, f"[{tag}] 10 iterations {step_err:.3e} apart")
    check(reads <= 21, f"[{tag}] {reads} host reads")
    check(bool(card.embedding.shape == (n, 2)
               and torch.isfinite(torch.from_numpy(card.embedding)).all()),
          f"[{tag}] embedding not finite or of shape "
          f"{card.embedding.shape}")
    if whole_run:
        check(card.n_iter == cpu.n_iter, f"[{tag}] iterations "
              f"{card.n_iter} on the card, {cpu.n_iter} on the CPU")
        check(kl_gap <= 0.05, f"[{tag}] KL {card.kl_divergence} on the "
              f"card, {cpu.kl_divergence} on the CPU")
    return out


def _dicom_element(group, elem, vr, value):
    """One explicit-VR little-endian data element."""
    import struct

    head = struct.pack("<HH", group, elem)
    if vr in (b"OB", b"OW"):
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def _write_dicom_series(leaf, volume):
    """An uncompressed explicit-VR little-endian Part-10 file per slice of
    ``volume`` (int16), positioned along z in reverse file order."""
    import struct

    def text(s):
        b = s.encode()
        return b + b" " if len(b) % 2 else b

    leaf.mkdir(parents=True)
    n, rows, cols = volume.shape
    for i in range(n):
        body = b"".join([
            _dicom_element(0x0010, 0x0020, b"LO", text("123_S_4567")),
            _dicom_element(0x0020, 0x0013, b"IS", text(str(i + 1))),
            _dicom_element(0x0020, 0x0032, b"DS",
                           text(f"0.0\\0.0\\{float(n - 1 - i):.1f}")),
            _dicom_element(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
            _dicom_element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
            _dicom_element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
            _dicom_element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
            _dicom_element(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
            _dicom_element(0x7FE0, 0x0010, b"OW",
                           volume[n - 1 - i].astype("<i2").tobytes())])
        meta = _dicom_element(0x0002, 0x0010, b"UI",
                              text("1.2.840.10008.1.2.1"))
        (leaf / f"s{i:03d}.dcm").write_bytes(b"\x00" * 128 + b"DICM" + meta
                                             + body)


def _data_tools(work):
    """Every subcommand of the four data CLIs on fixtures written here;
    each output exists and reads back. Returns {command: seconds}."""
    import contextlib
    import io
    import zipfile

    import numpy as np

    from otfusion_tpu_torch.cli import (
        aggregate_results,
        data_tools,
        generate_split,
        harvard30k,
    )
    from otfusion_tpu_torch.data.nifti_io import read_nifti
    from otfusion_tpu_torch.data.png_io import read_png
    from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
    from otfusion_tpu_torch.utils.reporting import CSV_COLUMNS, ResultsWriter

    root = work / "tools"
    rng = np.random.default_rng(TSNE_SEED)
    seconds = {}

    def run(tag, main, argv):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        seconds[tag] = time.perf_counter() - t0
        return buf.getvalue()

    tree = make_synthetic_adni(root / "adni", n_per_class=3, shape=(8, 8, 8))
    (tree / "AD_MRI_130_FIN" / "notes.txt").write_text("x")
    run("sizes", data_tools.main, ["sizes", "--root", str(tree), "--output",
                                   str(root / "sizes.txt")])
    check((root / "sizes.txt").read_text().count("(8, 8, 8)") == 12,
          "[tools] sizes did not list 12 volumes of 8^3")
    out = run("verify", data_tools.main, ["verify", "--root", str(tree),
                                          "--pair-with", str(tree)])
    check("paired: 6" in out, f"[tools] verify printed {out!r}")
    (root / "ids.txt").write_text("001_S_4000\n")
    out = run("relocate", data_tools.main, [
        "relocate", "--source", str(tree / "AD_MRI_130_FIN"), "--dest",
        str(root / "moved"), "--id-file", str(root / "ids.txt"), "--apply"])
    check(len(list((root / "moved").rglob("*.nii*"))) == 1,
          f"[tools] relocate moved nothing: {out!r}")
    run("cleanup", data_tools.main, ["cleanup", "--root", str(tree),
                                     "--apply"])
    check(not (tree / "AD_MRI_130_FIN" / "notes.txt").exists(),
          "[tools] cleanup left a non-NIfTI file")
    volume = rng.integers(-1000, 3000, (12, 20, 16)).astype(np.int16)
    _write_dicom_series(root / "dicom" / "123_S_4567" / "MPRAGE" / "d" / "I1",
                        volume)
    out = run("convert", data_tools.main, [
        "convert", "--native", "--input", str(root / "dicom"), "--output",
        str(root / "nifti")])
    produced = list((root / "nifti").rglob("*.nii.gz"))
    check(len(produced) == 1 and "Converted 1 DICOM series" in out,
          f"[tools] convert wrote {produced}: {out!r}")
    check(bool(np.array_equal(read_nifti(produced[0]), volume)),
          "[tools] the converted NIfTI does not read back as the series")

    records = root / "records"
    records.mkdir()
    for name, shape, subtype in (("rec_a", (768, 768), "pdr"),
                                 ("rec_b", (664, 512), "mild.npdr")):
        np.savez(records / f"{name}.npz",
                 slo_fundus=rng.integers(0, 256, shape, dtype=np.uint8),
                 dr_subtype=np.asarray(subtype),
                 oct_bscans=rng.normal(size=(16, 20, 24)).astype(np.float32))
    (root / "release").mkdir()
    with zipfile.ZipFile(root / "release" / "part0.zip", "w") as zf:
        for name in ("rec_a.npz", "rec_b.npz"):
            zf.write(records / name, f"Training/p0/{name}")
        zf.writestr("Training/p0/preview.jpg", b"x")
    run("merge-zips", harvard30k.main, [
        "merge-zips", "--work-dir", str(root / "release"), "--output-dir",
        str(root / "merged")])
    source = root / "merged" / "merged_training" / "p0"
    check(sorted(p.name for p in source.iterdir())
          == ["rec_a.npz", "rec_b.npz"], "[tools] merge-zips output")
    run("extract-fundus", harvard30k.main, [
        "extract-fundus", "--source", str(source), "--fundus-dir",
        str(root / "fundus"), "--labels-file", str(root / "fundus.txt")])
    check((root / "fundus.txt").read_text().split("\n")[:2]
          == ["rec_a_fundus.png 1", "rec_b_fundus.png 0"],
          "[tools] fundus label list")
    for name in ("rec_a", "rec_b"):
        check(read_png(root / "fundus" / f"{name}_fundus.png").shape
              == (448, 448, 3), f"[tools] {name}_fundus.png")
    run("oct-to-nii", harvard30k.main, [
        "oct-to-nii", "--input", str(source), "--output", str(root / "oct")])
    with zipfile.ZipFile(root / "oct" / "rec_a.zip") as zf:
        zf.extract("rec_a.nii", root / "unzipped")
    check(bool(np.array_equal(read_nifti(root / "unzipped" / "rec_a.nii"),
                              np.load(records / "rec_a.npz")["oct_bscans"])),
          "[tools] oct-to-nii does not read back")

    metrics = {"precision": 0.5, "recall": 0.75, "f1": 0.6,
               "specificity": 0.25}
    for setup, style in (("mri_depth18_balanced", "unimodal"),
                         ("mdepth101_drop0.3_all_with_pretrain_mri_pet_attn",
                          "fusion")):
        run_dir = root / "runs" / setup
        run_dir.mkdir(parents=True)
        writer = ResultsWriter(run_dir / "results.txt", "title", {},
                               style=style)
        writer.epoch_row(1, 0.7, 0.5, 0.69, 0.5, metrics)
        writer.summary(0.69, {"epoch": 1, "val_acc": 0.5, **metrics},
                       run_dir / "best_model")
    run("aggregate", aggregate_results.main, [
        "--results-dir", str(root / "runs"), "--output",
        str(root / "best.csv")])
    with open(root / "best.csv") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 2 and list(rows[0]) == CSV_COLUMNS,
          f"[tools] best.csv has {len(rows)} rows")
    with zipfile.ZipFile(root / "best.xlsx") as zf:
        sheet = zf.read("xl/worksheets/sheet1.xml").decode()
    check(sheet.count("<row ") == 3 and "mri_pet" in sheet,
          "[tools] best.xlsx does not hold the header and two rows")

    ids = {"AD_MRI_130_FIN": [f"{i:03d}_S_{4000 + i}" for i in range(20)],
           "CN_MRI_229_FIN": [f"{i:03d}_S_{5000 + i}" for i in range(15)]}
    (root / "patients.json").write_text(json.dumps(ids))
    run("generate_split", generate_split.main, [
        "--input", str(root / "patients.json"), "--output",
        str(root / "split.json")])
    split = json.loads((root / "split.json").read_text())
    for cls, all_ids in ids.items():
        check(sorted(split["train"][cls] + split["val"][cls])
              == sorted(all_ids) and len(split["val"][cls])
              == int(len(all_ids) * 0.2), f"[tools] split of {cls}")
    shutil.rmtree(root)
    return seconds


def phase_artifacts(work, flagship_logits):
    """The trainers' PNGs, t-SNE on the card against the CPU, device
    preprocessing against the CPU, and the data tools; then no host-only
    library is loaded. Returns the summary."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.cli.bench_kernels import time_ms
    from otfusion_tpu_torch.data.png_io import read_png
    from otfusion_tpu_torch.data.preprocess import preprocess_volume

    t0 = time.perf_counter()
    for run in ("flagship", "unimodal"):
        for name, shape in ARTIFACT_SIZES.items():
            image = read_png(work / run / name)
            check(image.shape == shape + (3,), f"[artifacts] {run}/{name} "
                  f"is {image.shape}, want {shape}")
            check(int(image.min()) < 64 and int(image.max()) == 255,
                  f"[artifacts] {run}/{name} is blank")
    log(f"[artifacts] flagship and unimodal PNGs at {ARTIFACT_SIZES}")

    # At 38 points the exaggerated phase (learning rate 50) amplifies
    # rounding into other minima, as the CPU's own run from a start 1e-7
    # apart shows (logged), so whole runs are compared at 512 points only.
    logits = torch.from_numpy(np.asarray(flagship_logits, np.float32))
    summary = {"tsne_logits": _tsne_card_and_cpu("artifacts-tsne", logits,
                                                 whole_run=False)}
    rng = np.random.default_rng(TSNE_SEED)
    feats = rng.normal(size=(TSNE_ROWS, TSNE_WIDTH)).astype(np.float32)
    feats[: TSNE_ROWS // 2] += 0.5   # two clusters, centres 22.6 apart
    summary["tsne_features"] = _tsne_card_and_cpu(
        "artifacts-tsne", torch.from_numpy(feats), whole_run=True)

    raw = rng.gamma(2.0, 150.0, RAW_VOLUME).astype(np.float32)
    card = torch.from_numpy(raw).cuda()
    got = preprocess_volume(card, PREPROCESSED).cpu()
    want = preprocess_volume(torch.from_numpy(raw), PREPROCESSED)
    err = float((got - want).abs().max())
    ms = time_ms(lambda: preprocess_volume(card, PREPROCESSED), 20)
    summary["preprocess"] = {"shape": list(got.shape), "max_abs_err": err,
                             "card_ms": ms}
    log(f"[artifacts-preprocess] {RAW_VOLUME} -> {PREPROCESSED}: "
        f"{json.dumps(summary['preprocess'])}")
    check(tuple(got.shape) == PREPROCESSED + (1,),
          f"[artifacts-preprocess] shape {tuple(got.shape)}")
    check(err <= 1e-5, f"[artifacts-preprocess] the card {err:.3e} from the "
          "CPU")

    summary["tools_s"] = _data_tools(work)
    log(f"[artifacts-tools] seconds {json.dumps(summary['tools_s'])}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in HOST_ONLY)
    check(not loaded, f"[artifacts] host-only libraries loaded: {loaded}")
    summary["seconds"] = time.perf_counter() - t0
    log(f"[artifacts] phase {summary['seconds']:.2f} s")
    return summary


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
    k2_hetero = phase_k2_hetero()
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
        runs = {}
        runs["flagship"], final_eval, flagship_logits = phase_flagship(
            data, work)
        runs["base"], base = phase_base(data, work)
        runs.update(phase_small(data, work))
        artifacts = phase_artifacts(work, flagship_logits)
        log(f"[trainers] peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        serve = phase_serve(data, work, final_eval)
        shutil.rmtree(work / "flagship")
        lifecycle, uni_serve = phase_lifecycle(data, work)
        runs.update(lifecycle)
        remat_step = phase_remat_step()
        runs["remat_trainer"], remat_trainer = phase_remat_trainer(data,
                                                                   work)
        runs["hetero"], hetero_eval = phase_hetero_flagship(
            data, work, runs["flagship"])
        runs["hetero_base"] = phase_hetero_base(data, work)
        hetero_serve = phase_hetero_serve(data, work, hetero_eval)
        # ROADMAP §3's second fault: with the heads in float32, does the
        # hetero serve's gap to the trainer's own bf16 eval fall toward the
        # ResNet flagship's (1.242e-6 in PERF.md's serving record)?
        log("[fault2] hetero bf16 serve against the trainer's own bf16 "
            f"eval: {json.dumps(hetero_serve['bf16_vs_trainer_eval'])}")
        shutil.rmtree(work / "hetero")
        runs["config5"], config5 = phase_config5(work)
        perturbot_runs, perturbot = phase_perturbot(work)
        runs.update(perturbot_runs)
        k1d_runs, k1_device, k1d_summary = phase_k1_device(work)
        runs.update(k1d_runs)
        vae_runs, vae_summary = phase_vae(work)
        runs.update(vae_runs)
        gamma_runs, gamma_kernels, gamma = phase_gamma(work)
        runs.update(gamma_runs)
    total = {k: sum(r.get(k, 0) for r in runs.values())
             for k in ("sinkhorn", "gw", "gw_device")}
    log(f"[trainers] launches per run {json.dumps(runs)}; total {total}")
    check(all(total.values()), f"a kernel was never launched: {total}")
    log(f"[base] {json.dumps(base)}")
    log("[lifecycle] " + json.dumps({"serve": serve,
                                     "uni_serve": uni_serve,
                                     "remat_step": remat_step,
                                     "remat_trainer": remat_trainer}))
    log("[hetero] " + json.dumps({"serve": hetero_serve,
                                  "config5": config5}))
    log("[perturbot] " + json.dumps(perturbot["runs"]))
    log("[k1-device] " + json.dumps(k1d_summary))
    log("[vae] " + json.dumps(vae_summary))
    log("[gamma] " + json.dumps(gamma))
    log("[artifacts] " + json.dumps(artifacts))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "launches_per_solve")
    base_keys = ("base_ms", "base_plain_ms", "base_bound_ms", "base_n_iters",
                 "base_max_abs_err")
    kernels = [
        {"name": "gw_solve", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/gw.cu",
         "replaces": "otfusion_tpu/experimental/gw_kernel.py:149",
         "launches": total["gw"], **{k: k1[k] for k in keys},
         "perturbot": perturbot["k1"], "gamma": gamma_kernels["k1"],
         "library_ms": None},
        {"name": "gw_solve_device", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/gw.cu",
         "replaces": "otfusion_tpu/experimental/gw_kernel.py:149",
         "launches": total["gw_device"],
         **{k: k1_device["screen"][k] for k in keys}, "cases": k1_device,
         "library_ms": None},
        {"name": "sinkhorn", "route": "cuda",
         "source": "otfusion_tpu_torch/csrc/sinkhorn.cu",
         "replaces": "otfusion_tpu/experimental/sinkhorn_kernel.py:131",
         "launches": total["sinkhorn"], **{k: k2[k] for k in keys},
         **{k: k2_base[k] for k in base_keys}, "hetero": k2_hetero,
         "perturbot": perturbot["k2"],
         "gamma": gamma_kernels["k2_step"],
         "library_ms": None},
    ]
    log(f"[done] {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
