"""Profile the flagship's train step and per-epoch coupling on one device.

    python -m otfusion_tpu_torch.cli.profile_flagship [--out DIR]

The defaults are the flagship trainer's (``train_ot_attn``): depth 101, s2d
stem, bf16 autocast, batch 8 at 128^3, feature batch 16, 64 samples per
label, on a synthetic ADNI cohort of 2 x 96 subjects made at 64^3 with
random weights from ``--seed``. It prints, and writes to
``DIR/profile.json`` (default ``build/prof``):

  * train-step ms: host clock after a synchronise, mean over ``--steps``
    steps, ``--repeats`` times, after ``--warmup`` steps;
  * under ``torch.profiler``, ``--profiled-steps`` train steps and then one
    coupling pipeline (K1 + FOT cost + K2) on the cohort's features: the
    wall ms, the device's busy ms (the union of the device-activity
    intervals), and device ms per bucket of kernels (``BUCKETS``: the first
    pattern found in a kernel's name decides; ``other`` takes the rest);
  * the coupling's phases: the feature pass, the pipeline, GW alone and
    ``CouplingService.compute`` (host clock after a synchronise).

Profiler annotations (``record_function`` ranges such as the optimiser's
step) are not device work and count in no bucket. ``--device cpu`` runs the
same phases at whatever size is given, for a rehearsal; there the profile
holds no device activity.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from otfusion_tpu_torch.cli.common import resolve_device
from otfusion_tpu_torch.data.datasets import MultimodalNiftiDataset
from otfusion_tpu_torch.data.loader import MultimodalLoader, _VolumeCache
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.ops.gromov import egw_per_label
from otfusion_tpu_torch.train import coupling
from otfusion_tpu_torch.train.steps import (
    make_feature_extract_step,
    make_fusion_train_step,
)
from otfusion_tpu_torch.train.train_state import make_optimizer

REPO = Path(__file__).resolve().parents[2]

# (bucket, name patterns); the first bucket with a pattern in the kernel's
# name takes it.
BUCKETS = (
    ("port_k1", ("gw_cluster_kernel",)),
    ("port_k2", ("sinkhorn_solve_kernel",)),
    ("batchnorm", ("batch_norm", "WelfordOps")),
    ("conv_gemm", ("xmma", "gemm", "nvjet", "cutlass", "conv")),
    ("memcpy", ("Memcpy", "Memset")),
    ("copy_cast", ("direct_copy",)),
    ("optimizer", ("multi_tensor_apply", "fused_adam")),
    ("pool", ("pool",)),
)


def bucket_of(name: str) -> str:
    for bucket, patterns in BUCKETS:
        if any(p in name for p in patterns):
            return bucket
    return "other"


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize(prof, wall_ms: float, top: int = 25) -> dict:
    """Busy ms, ms and launches per bucket and per kernel name."""
    events = _device_events(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    per_name: dict = defaultdict(lambda: [0.0, 0])
    for e in events:
        per_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        per_name[e.name][1] += 1
    buckets: dict = defaultdict(lambda: {"ms": 0.0, "launches": 0})
    for name, (ms, count) in per_name.items():
        b = buckets[bucket_of(name)]
        b["ms"] += ms
        b["launches"] += count
    device_ms = sum(b["ms"] for b in buckets.values())
    for b in buckets.values():
        b["share"] = b["ms"] / device_ms if device_ms else 0.0
    kernels = sorted(((ms, count, name) for name, (ms, count)
                      in per_name.items()), reverse=True)[:top]
    return {
        "wall_ms": wall_ms,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / wall_ms if wall_ms else 0.0,
        "device_ms": device_ms,
        "buckets": dict(sorted(buckets.items(), key=lambda kv: -kv[1]["ms"])),
        "top": [{"ms": ms, "launches": c, "name": n, "bucket": bucket_of(n)}
                for ms, c, n in kernels],
    }


def _print_summary(tag: str, s: dict) -> None:
    print(f"[{tag}] wall {s['wall_ms']:.3f} ms; device busy "
          f"{s['busy_ms']:.3f} ms = {s['busy_share']:.4f} of wall; device "
          f"ms {s['device_ms']:.3f}", flush=True)
    for name, b in s["buckets"].items():
        print(f"[{tag}]   {name:10s} {b['ms']:10.3f} ms {b['share']:7.4f} "
              f"{b['launches']:6d} launches", flush=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--model-depth", type=int, default=101)
    parser.add_argument("--target-side", type=int, default=128)
    parser.add_argument("--n-per-class", type=int, default=96)
    parser.add_argument("--max-jax-samples", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--warmup", type=int, default=4)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--profiled-steps", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=str(REPO / "build" / "prof"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    result: dict = {"args": vars(args)}
    if on_cuda:
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(result["card"], flush=True)
        torch.backends.cudnn.benchmark = True
    shape = (args.target_side,) * 3
    n_batches = args.warmup + args.steps + args.profiled_steps
    with tempfile.TemporaryDirectory(prefix="otf_prof_") as tmp:
        make_synthetic_adni(tmp, n_per_class=args.n_per_class,
                            shape=(max(args.target_side // 2, 8),) * 3,
                            seed=args.seed)
        samples = MultimodalNiftiDataset(tmp).samples
        cache = _VolumeCache(shape, num_workers=4)
        train = MultimodalLoader(samples, shape, args.batch_size, shuffle=True,
                                 seed=args.seed, cache=cache,
                                 feed_dtype=torch.bfloat16)
        batches = []
        while len(batches) < n_batches:
            batches.extend(train)
        batches = batches[:n_batches]
        feat = MultimodalLoader(samples, shape, 2 * args.batch_size,
                                cache=cache, feed_dtype=torch.bfloat16)
        feat_batches = list(feat)

    torch.manual_seed(args.seed)
    model = MultimodalOTFusion(depth=args.model_depth, s2d_stem=True)
    model = (model.to(device=device, memory_format=torch.channels_last_3d)
             if on_cuda else model.to(device))
    opt = make_optimizer(model.parameters(), 1e-5)
    step = make_fusion_train_step(model, opt, compute_dtype=torch.bfloat16)
    d_pet = model.pet_backbone.out_dim
    d_mri = model.mri_backbone.out_dim
    tv = torch.full((d_pet, d_mri), 1.0 / (d_pet * d_mri), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def run_steps(bs):
        for mri, pet, lbl in bs:
            step(mri.to(device, non_blocking=True),
                 pet.to(device, non_blocking=True),
                 lbl.to(device, non_blocking=True), tv, gen)

    run_steps(batches[:args.warmup])
    sync()
    timed = batches[args.warmup:args.warmup + args.steps]
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        run_steps(timed)
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / max(len(timed), 1))
    result["train_step_ms"] = times
    print(f"[train] step ms, mean of {len(timed)} steps, {args.repeats} "
          f"times: {times}", flush=True)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_steps(batches[args.warmup + args.steps:])
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    result["train_profile"] = summarize(prof, wall)
    result["train_profile"]["steps"] = args.profiled_steps
    _print_summary("train", result["train_profile"])

    fx = make_feature_extract_step(model, compute_dtype=torch.bfloat16)
    svc = coupling.CouplingService(fx, 2, device, args.max_jax_samples)
    svc.compute(iter(feat_batches))  # warm-up: cuDNN picks its algorithms
    sync()
    phases: dict = {}
    t0 = time.perf_counter()
    feats = [fx(m.to(device), p.to(device)) for m, p, _ in feat_batches]
    sync()
    phases["feature_pass_ms"] = (time.perf_counter() - t0) * 1e3
    labels = np.concatenate([np.asarray(b[2]) for b in feat_batches])
    mri = torch.cat([f[0] for f in feats]).cpu().numpy()
    pet = torch.cat([f[1] for f in feats]).cpu().numpy()
    mg, mm = coupling.group_and_pad(mri, labels, 2, args.max_jax_samples)
    pg, pm = coupling.group_and_pad(pet, labels, 2, args.max_jax_samples)
    groups = tuple(torch.from_numpy(a).to(device) for a in (pg, mg, pm, mm))
    for _ in range(2):  # the second round is the one kept
        sync()
        t0 = time.perf_counter()
        _, gw, fot_res = coupling.coupling_pipeline(*groups)
        sync()
        phases["pipeline_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        egw_per_label(*groups)
        sync()
        phases["gw_ms"] = (time.perf_counter() - t0) * 1e3
    phases["gw_iters"] = gw.n_iters.tolist()
    phases["fot_iters"] = int(fot_res.n_iters)
    t0 = time.perf_counter()
    svc.compute(iter(feat_batches))
    sync()
    phases["compute_ms"] = (time.perf_counter() - t0) * 1e3
    phases["samples"] = int(len(labels))
    result["coupling"] = phases
    print(f"[coupling] {json.dumps(phases)}", flush=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        coupling.coupling_pipeline(*groups)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    result["pipeline_profile"] = summarize(prof, wall)
    _print_summary("pipeline", result["pipeline_profile"])
    result["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                          if on_cuda else None)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile.json").write_text(json.dumps(result, indent=1))
    print(f"[done] median step {statistics.median(times):.3f} ms; peak "
          f"{result['peak_gib']} GiB; wrote {out / 'profile.json'}",
          flush=True)
    return result


if __name__ == "__main__":
    main()
