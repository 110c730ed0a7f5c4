"""Checkpoints with write-behind (port of ``otfusion_tpu.utils.checkpoint``).

Layout: ``<dir>/checkpoint.pt`` holds ``{"model": state_dict, "optimizer":
state_dict or None}``; the metadata (epoch, best loss, scheduler state) is a
sidecar ``<dir>.meta.json``, so ``load_metadata`` never unpickles the
weights.

Write-behind, as in JAX: ``save_checkpoint`` copies every tensor of the
model's and the optimiser's state to host memory on the caller's thread
(``optimizer.step()`` updates parameters and moments in place right after),
then one background worker writes ``<dir>.tmp`` and swaps it in (``dir`` ->
``.old``, ``.tmp`` -> ``dir``). At most one write per directory is in flight;
the read helpers drain their directory's write first, and
``flush_checkpoints`` (also run at exit) drains every write and re-raises a
worker's error.

Also here: the pretrained-backbone graft (``restore_backbone``), the
serving BatchNorm fold (``fold_conv_bn_params`` for the inline ResNet3D,
``fold_zoo_conv_bn`` for any conv backbone, ``fold_state_for_serving``)
and the plain -> space-to-depth stem rewrite (``rewrite_stem_params``).
Left out of the port: the pre-round-4 remat key migration (the port has no
such checkpoints) and the multi-host gather (parallelism).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch import nn

from otfusion_tpu_torch.models.resnet3d import (
    FoldableBackbone,
    bn_conv_pairs,
    conv_name_of_bn,
    s2d_stem_kernel,
)

CHECKPOINT_FILE = "checkpoint.pt"

# One worker drains every write in submission order; _PENDING holds the
# last write scheduled per directory.
_EXECUTOR: ThreadPoolExecutor | None = None
_PENDING: Dict[str, Future] = {}
_LOCK = threading.Lock()


def _executor() -> ThreadPoolExecutor:
    global _EXECUTOR
    with _LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="otf-ckpt")
            atexit.register(flush_checkpoints)
        return _EXECUTOR


def _wait_dir(directory: Path) -> None:
    """Block until the write scheduled for ``directory`` has landed,
    re-raising its error."""
    with _LOCK:
        fut = _PENDING.get(str(directory))
    if fut is None:
        return
    try:
        fut.result()
    finally:
        with _LOCK:
            if _PENDING.get(str(directory)) is fut:
                del _PENDING[str(directory)]


def flush_checkpoints() -> None:
    """Drain every scheduled write; re-raise the first worker error."""
    with _LOCK:
        futs = list(_PENDING.items())
    err = None
    for key, fut in futs:
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001 - re-raised below
            err = err or e
        with _LOCK:
            if _PENDING.get(key) is fut:
                del _PENDING[key]
    if err is not None:
        raise err


def _host_copy(obj):
    """``obj`` with every tensor copied to fresh host memory (a CPU tensor
    too: ``.cpu()`` would return the live tensor itself). Containers are
    rebuilt, so nothing aliases the caller's state. A tensor on the card is
    copied asynchronously into pinned memory (PyTorch's caching host
    allocator, reused from one save to the next); the caller waits for the
    copies before anything may change the source."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", non_blocking=True, copy=True)
    if isinstance(obj, dict):
        out = type(obj)((k, _host_copy(v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):  # a state_dict's module versions
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def save_checkpoint(directory: str | Path, model: nn.Module,
                    meta: Optional[Dict[str, Any]] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    block: bool = False) -> None:
    """Save ``model`` (and ``optimizer``, the resumable "latest" flavour)
    under ``directory``. The host snapshot is taken here; the write runs on
    the background worker unless ``block=True``."""
    directory = Path(directory).resolve()
    payload = {
        "model": _host_copy(model.state_dict()),
        "optimizer": (_host_copy(optimizer.state_dict())
                      if optimizer is not None else None),
    }
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the copies into pinned memory landed
    if block:
        _write_payload(directory, payload, meta)
        return
    # Backpressure: never more than one payload per directory in flight.
    _wait_dir(directory)
    fut = _executor().submit(_write_payload, directory, payload, meta)
    with _LOCK:
        _PENDING[str(directory)] = fut


def _write_payload(directory: Path, payload: Dict[str, Any],
                   meta: Optional[Dict[str, Any]]) -> None:
    """Write ``payload`` under ``directory`` with an atomic swap, then the
    metadata sidecar."""
    tmp_dir = directory.with_name(directory.name + ".tmp")
    old_dir = directory.with_name(directory.name + ".old")
    # A crash between the two renames below leaves no ``directory`` but a
    # complete ``.old``: promote it before the stale cleanup removes it.
    if not directory.exists() and old_dir.exists():
        os.rename(old_dir, directory)
    for stale in (tmp_dir, old_dir):
        if stale.exists():
            shutil.rmtree(stale)
    tmp_dir.mkdir(parents=True)
    torch.save(payload, tmp_dir / CHECKPOINT_FILE)
    if directory.exists():
        os.rename(directory, old_dir)
    os.rename(tmp_dir, directory)
    if old_dir.exists():
        shutil.rmtree(old_dir)
    if meta is not None:
        meta_path = _meta_path(directory)
        tmp_meta = meta_path.with_suffix(".json.tmp")
        with open(tmp_meta, "w") as f:
            json.dump(meta, f, indent=2, default=float)
        os.replace(tmp_meta, meta_path)


def _meta_path(directory: Path) -> Path:
    return directory.with_name(directory.name + ".meta.json")


def _recover_dir(directory: Path) -> Path:
    """``directory``, or its ``.old`` when a crash left only that."""
    old_dir = directory.with_name(directory.name + ".old")
    if not directory.exists() and old_dir.exists():
        return old_dir
    return directory


def checkpoint_exists(directory: str | Path) -> bool:
    """True when ``directory`` (or its ``.old`` fallback) holds a
    checkpoint."""
    directory = Path(directory).resolve()
    _wait_dir(directory)
    return (_recover_dir(directory) / CHECKPOINT_FILE).exists()


def load_metadata(directory: str | Path) -> Dict[str, Any] | None:
    """The sidecar metadata of ``directory``, or None."""
    directory = Path(directory).resolve()
    _wait_dir(directory)
    meta = _meta_path(directory)
    if meta.exists():
        with open(meta) as f:
            return json.load(f)
    return None


def _load_payload(directory: Path) -> Dict[str, Any]:
    return torch.load(_recover_dir(directory) / CHECKPOINT_FILE,
                      map_location="cpu", weights_only=True)


def restore_checkpoint(directory: str | Path, model: nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> None:
    """Load the model (and the optimiser) state saved under ``directory``
    into ``model`` (and ``optimizer``), in place on their devices."""
    directory = Path(directory).resolve()
    _wait_dir(directory)
    payload = _load_payload(directory)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        if payload["optimizer"] is None:
            raise ValueError(f"{directory} holds no optimiser state")
        optimizer.load_state_dict(payload["optimizer"])


def restore_backbone(model: nn.Module, source: str | Path,
                     target_module: str, backbone: str = "") -> int:
    """Graft a pretrained backbone into ``model.<target_module>`` (e.g.
    ``mri_backbone``), in place; returns the number of tensors loaded.

    ``source`` is a port checkpoint directory of a ``ResNet3DClassifier``
    (its ``backbone`` module: a ``train_unimodal`` run's ``best_model``),
    or a torch ``.pth``/``.pt`` file of the registry family ``backbone``
    ('' = the inline ResNet3D), grafted by intersecting keys
    (``utils.torch_import.graft_torch_backbone``). A plain stem goes onto a
    space-to-depth target through ``rewrite_stem_params``.
    """
    if str(source).endswith((".pth", ".pt")):
        from otfusion_tpu_torch.utils.torch_import import graft_torch_backbone

        return graft_torch_backbone(model, source, target_module,
                                    backbone=backbone)
    directory = Path(source).resolve()
    _wait_dir(directory)
    if not (_recover_dir(directory) / CHECKPOINT_FILE).exists():
        raise ValueError(
            f"{source} is not a pretrained source the port reads: give a "
            f"port checkpoint directory (holding {CHECKPOINT_FILE}, e.g. a "
            "train_unimodal run's best_model) or a torch .pth/.pt file. A "
            "JAX (orbax) checkpoint directory cannot be read without JAX.")
    state = _load_payload(directory)["model"]
    src = {k[len("backbone."):]: v for k, v in state.items()
           if k.startswith("backbone.")}
    if not src:
        raise KeyError(f"no 'backbone' module in {directory}")
    target = getattr(model, target_module)
    target.load_state_dict(rewrite_stem_params(src, target.state_dict()))
    n = sum(not k.endswith("num_batches_tracked") for k in src)
    print(f"Grafted {n} tensors from {directory} into {target_module}")
    return n


def _fold_pairs(state_dict: Dict[str, torch.Tensor], pairs,
                eps: float) -> Dict[str, torch.Tensor]:
    """Fold each (conv, BatchNorm) pair of ``state_dict`` (dotted module
    names) in eval mode:

        g = weight / sqrt(running_var + eps)
        conv.weight' = conv.weight * g      (per output channel)
        conv.bias'   = bias - running_mean * g

    on the tensors' device, in float32 or wider; the BatchNorm entries are
    dropped."""
    out = OrderedDict(state_dict)
    for conv, bn in pairs:
        w = state_dict[f"{conv}.weight"]
        dt = torch.promote_types(w.dtype, torch.float32)
        g = (state_dict[f"{bn}.weight"].to(dt)
             / torch.sqrt(state_dict[f"{bn}.running_var"].to(dt) + eps))
        out[f"{conv}.weight"] = w.to(dt) * g.view(-1, *[1] * (w.dim() - 1))
        out[f"{conv}.bias"] = (state_dict[f"{bn}.bias"].to(dt)
                               - state_dict[f"{bn}.running_mean"].to(dt) * g)
        for name in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            out.pop(f"{bn}.{name}", None)
    return out


def fold_conv_bn_params(state_dict: Dict[str, torch.Tensor],
                        eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold every eval-mode BatchNorm of an inline-ResNet3D state dict (a
    backbone, a classifier or a fusion model of two) into the conv it
    follows, paired by the ResNet3D names (``conv_name_of_bn``). Returns
    the state dict of the folded model (``fold_bn_()``): biased convs, no
    BatchNorm entries."""
    pairs = [(conv_name_of_bn(k[:-len(".running_mean")]),
              k[:-len(".running_mean")])
             for k in state_dict if k.endswith(".running_mean")]
    return _fold_pairs(state_dict, pairs, eps)


def fold_zoo_conv_bn(state_dict: Dict[str, torch.Tensor], module: nn.Module,
                     eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """``fold_conv_bn_params`` for any conv backbone ``module`` (whose
    ``state_dict`` this is): MedicalNet, Res2Net or the inline ResNet3D.
    Each BatchNorm pairs with the conv it follows by dataflow, as its
    module class declares (``models.resnet3d.bn_conv_pairs``), never by
    index; a BatchNorm with no conv partner raises."""
    return _fold_pairs(state_dict, bn_conv_pairs(module), eps)


def fold_state_for_serving(model: nn.Module) -> nn.Module:
    """Fold the BatchNorms of every conv backbone of ``model`` (ResNet3D,
    MedicalNet, Res2Net) into their convs, once, in place on the model's
    device; returns the model in eval mode. LayerNorm backbones (Swin,
    UNETR) are left as they are."""
    model.eval()
    state = model.state_dict()
    pairs = []
    for name, module in list(model.named_modules()):
        if isinstance(module, FoldableBackbone) and not module.fold_bn:
            prefix = f"{name}." if name else ""
            pairs += [(prefix + c, prefix + b)
                      for c, b in bn_conv_pairs(module)]
            module.fold_bn_()
    model.load_state_dict(_fold_pairs(state, pairs, 1e-5))
    return model


def rewrite_stem_params(src: Dict[str, torch.Tensor],
                        dst: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Backbone state dict ``src`` with a plain (O, I, kD, 7, 7) stem
    rewritten losslessly onto ``dst``'s space-to-depth (O, 4I, kD, 4, 4)
    stem (``models.resnet3d.s2d_stem_kernel``); any other pair of shapes
    is returned unchanged."""
    key = "conv1.weight"
    if key not in src or key not in dst:
        return src
    s, d = src[key], dst[key]
    if tuple(s.shape) == tuple(d.shape):
        return src
    kd = s.shape[2]
    if (tuple(s.shape[3:]) == (7, 7) and tuple(d.shape[2:]) == (kd, 4, 4)
            and d.shape[1] == 4 * s.shape[1]):
        out = dict(src)
        out[key] = torch.from_numpy(
            s2d_stem_kernel(s.detach().cpu().numpy())).to(s.device)
        return out
    return src
