"""Time kernels K1 and K2 on one GPU, beside another checkout's if given.

    python -m otfusion_tpu_torch.cli.bench_kernels [--baseline DIR] [--out FILE]

At the main path's shapes (the inputs ``chip_smoke.py`` builds from the same
seeds): K2 solves a 2048 x 2048 FOT-shaped cost to its exit
(``ops.sinkhorn.sinkhorn``) and for 64 fixed iterations
(``sinkhorn_fixed``); K1 solves 2 labels x cap 64 (label 1 padded to 50)
and 2 labels x cap 128 from 2048-dim features (``gw_kernel.gw_solve`` on
the prepared costs). Per call it reports:

  * ``ms``: the median of ``--runs`` CUDA-event-timed calls after a warm-up
    (host work inside the call included, as a caller waits for it);
  * ``device_ms``: under ``torch.profiler``, the kernel's own device time
    per call (``profiled_kernels``: the kernel events it found);
  * ``launches``: the kernel launches of one call, from the package's own
    launch counter.

Each package is timed in a fresh process. With ``--baseline DIR`` the same
public calls run with the package of the checkout at DIR, in turns:
baseline, this, this, baseline. Then this package's K1 runs once per
cluster size that its layout admits (``gw_kernel.CLUSTER_SIZES``), each
held to the built-in size's plan. Everything lands in ``--out`` as JSON.

``K1_NAMES``, ``K2_NAMES``, ``time_ms``, ``device_ms`` and
``correlated_groups`` are public: ``chip_smoke.py`` and the ``cuda`` tests
time and feed the kernels with them, so a change to one changes those
numbers too. They stay in this module (and import nothing of the package)
because the ``--baseline`` worker runs this file against another checkout's
package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# Device-kernel names of K1 and K2, matched as substrings of profiler
# events: this package's and the port's earlier design's (one block per
# label; one launch per Sinkhorn primitive), so that a --baseline checkout
# of that design is timed as well.
K1_NAMES = ("gw_cluster_kernel", "gw_solve_kernel")
K2_NAMES = ("sinkhorn_solve_kernel", "row_update_f", "col_update_g",
            "row_marginal", "sum_reduce", "emit_plan")


def time_ms(fn, runs: int = 20) -> float:
    """Median ms of ``runs`` calls of ``fn`` after one warm-up, each
    between two CUDA events on the current stream and synchronised, so
    host work inside the call counts as a caller waits for it."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, names, calls: int = 5) -> tuple[float, float]:
    """(device ms, kernel events) per call of ``fn``, averaged over
    ``calls`` calls with one ``torch.profiler`` session each: the summed
    device time of the CUDA events whose name contains one of ``names``
    (other kernels of the call are left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    us, count = 0.0, 0
    for _ in range(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and any(n in e.name for n in names)]
        us += sum(e.time_range.end - e.time_range.start for e in events)
        count += len(events)
    return us / 1e3 / calls, count / calls


def _launches(fn, counter) -> int:
    """Launches of one call, from the package's own launch counter."""
    before = counter.count
    fn()
    return counter.count - before


def correlated_groups(rng, L, cap, d):
    """Two (L, cap, d) fp32 numpy clouds sharing an 8-dim latent, as
    grouped backbone features are, drawn from ``rng``
    (``np.random.default_rng``) in a fixed order, so a seed fixes them."""
    z = rng.normal(size=(L, cap, 8))
    x = z @ rng.normal(size=(8, d)) + 0.05 * rng.normal(size=(L, cap, d))
    y = z @ rng.normal(size=(8, d)) + 0.05 * rng.normal(size=(L, cap, d))
    return x.astype("float32"), y.astype("float32")


def _gw_args(cap, pad_rows):
    import numpy as np
    import torch

    from otfusion_tpu_torch.ops.gromov import _prep

    x, y = correlated_groups(np.random.default_rng(1), 2, cap, 2048)
    mask = np.ones((2, cap), bool)
    if pad_rows is not None:
        mask[1, pad_rows:] = False
        x[1, pad_rows:] = 0.0
        y[1, pad_rows:] = 0.0
    x, y, m = (torch.from_numpy(a).cuda() for a in (x, y, mask))
    cx, p, log_p = _prep(x, m)
    cy, q, log_q = _prep(y, m)
    return cx, cy, log_p, log_q, p, q


def measure(runs: int) -> dict:
    """The public calls of whichever ``otfusion_tpu_torch`` is imported."""
    import numpy as np
    import torch

    from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel
    from otfusion_tpu_torch.ops.fot import feature_cost
    from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
    from otfusion_tpu_torch.ops.sinkhorn_kernel import sinkhorn_fixed

    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = correlated_groups(np.random.default_rng(0), 1, 128, 2048)
    ts = torch.eye(128, device="cuda") / 128
    cost = feature_cost(torch.from_numpy(x[0]).cuda(),
                        torch.from_numpy(y[0]).cuda(), ts).contiguous()
    kw = dict(epsilon=5e-3, threshold=1e-3, max_iterations=2000,
              scale_cost=True)
    out = {}
    k2 = (K2_NAMES, sinkhorn_kernel.COUNTER)
    k1 = (K1_NAMES, gw_kernel.COUNTER)
    calls = {
        "k2_exit": (lambda: sinkhorn(cost, **kw), k2, runs),
        "k2_fixed64": (lambda: sinkhorn_fixed(cost, epsilon=5e-3, n_iters=64),
                       k2, runs),
    }
    for cap, pad, n in ((64, 50, runs), (128, None, max(runs // 4, 3))):
        args = _gw_args(cap, pad)
        calls[f"k1_cap{cap}"] = (
            lambda a=args: gw_kernel.gw_solve(*a), k1, n)
    for key, (fn, (names, counter), n) in calls.items():
        ms = time_ms(fn, n)
        dev, events = device_ms(fn, names)
        out[key] = {"ms": ms, "device_ms": dev,
                    "launches": _launches(fn, counter),
                    "profiled_kernels": events}
    out["k2_exit"]["n_iters"] = int(sinkhorn(cost, **kw).n_iters)
    return out


def cluster_sweep(runs: int) -> dict:
    """This package's K1 at every admitted cluster size, cap 64 and 128."""
    import torch

    from otfusion_tpu_torch.ops import gw_kernel
    from otfusion_tpu_torch.utils.cuda_build import load_library

    lib = load_library("gw")
    out = {}
    for cap, pad in ((64, 50), (128, None)):
        args = _gw_args(cap, pad)
        ref_t, ref_it, _ = gw_kernel.gw_solve(*args)
        row = {"built_in": lib.otf_gw_cluster_for_cap(cap)}
        for cluster in gw_kernel.CLUSTER_SIZES:
            try:
                gw_kernel.gw_layout(cap, cluster)
            except ValueError:
                continue

            def run(c=cluster):
                return gw_kernel._launch(lib, *args, c, 5e-3, 2000, 1e-3, 10)

            t, it, _ = run()
            row[str(cluster)] = {
                "ms": time_ms(run, runs),
                "device_ms": device_ms(run, K1_NAMES)[0],
                "n_iters": it.tolist(),
                "allclose": bool(torch.allclose(t, ref_t, rtol=1e-3,
                                                atol=1e-6)),
                "same_n_iters": bool(torch.equal(it, ref_it)),
            }
        out[f"cap{cap}"] = row
    return out


def _worker(root: str, runs: int) -> dict:
    """Run ``measure`` in a fresh process on the package at ``root``."""
    proc = subprocess.run(
        [sys.executable, __file__, "--worker", root, "--runs", str(runs)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"worker on {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", default=None,
                        help="root of another checkout to time in turns")
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--out", default=str(REPO / "build" / "bench.json"))
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        sys.path.insert(0, str(Path(args.worker).resolve()))
        print(json.dumps(measure(args.runs)))
        return {}
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    result: dict = {"card": card, "turns": []}
    order = ([("baseline", args.baseline), ("this", str(REPO)),
              ("this", str(REPO)), ("baseline", args.baseline)]
             if args.baseline else [("this", str(REPO))])
    for tag, root in order:
        turn = {"package": tag, **_worker(root, args.runs)}
        result["turns"].append(turn)
        print(f"[{tag}] {json.dumps(turn)}", flush=True)
    sys.path.insert(0, str(REPO))
    result["k1_cluster_sizes"] = cluster_sweep(args.runs)
    print(f"[clusters] {json.dumps(result['k1_cluster_sizes'])}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
