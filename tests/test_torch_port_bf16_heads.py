"""The classifier heads and the plan application under bf16, against JAX.

JAX's ``nn.Dense(num_classes, name="fc")`` has no dtype, so under a bf16
model it promotes against its float32 kernel and returns float32 logits;
``features @ tv`` with a float32 plan is float32 as well. The port runs its
models under ``torch.autocast(bfloat16)``, which would compute both in
bf16: ``float32_dense`` and ``apply_feature_coupling`` turn autocast off
there. Depth 10 at 16^3, for the flagship (``per_epoch_attn``), ``base``
and ``ResNet3DClassifier``: the JAX modules at ``dtype=bfloat16`` (dtypes
from ``jax.eval_shape``, values from one jitted apply), the port's under
CPU autocast, from the same weights (seeded numpy values on the JAX
parameter shapes, carried across by ``utils/convert.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.models.resnet3d import ResNet3DClassifier as JaxClassifier
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import ResNet3DClassifier
from otfusion_tpu_torch.utils.convert import (
    classifier_state_dict_from_jax,
    fusion_state_dict_from_jax,
)

T = torch.from_numpy
# bf16 rounds a value in [0.5, 1) in steps of 3.9e-3, and JAX and the port
# round at different points (flax casts each Dense's inputs and kernel,
# autocast each product's operands). On these inputs the logits read
# 3.2e-3 to 6.5e-3 apart (largest |logit| 0.74 to 1.38) and
# ``ot_mri_from_pet`` 2.2e-3 to 7.0e-3 of its largest entry.
BOUND = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores at once, where PyTorch's default of a thread per core
    makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_variables(tree, rng, path=()):
    """Seeded values on a flax variables tree of ShapeDtypeStructs: lecun
    scale for kernels (fan-in over all axes but the last; the embedding
    axis for MHA's q/k/v), small biases, BatchNorm/LayerNorm scales near
    1, BatchNorm statistics of a trained model."""
    if isinstance(tree, dict):
        return {k: _random_variables(v, rng, path + (k,))
                for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        qkv = path[-2] in ("query", "key", "value")
        fan_in = shape[0] if qkv else math.prod(shape[:-1])
        value = rng.normal(size=shape) / math.sqrt(fan_in)
    elif name in ("scale", "var"):
        value = rng.uniform(0.5, 1.5, shape)
    else:  # bias, mean
        value = rng.normal(0.0, 0.1, shape)
    return value.astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    """{name: (jax output shapes, jax bf16 outputs, port bf16 outputs)}."""
    rng = np.random.default_rng(0)
    mri = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    pet = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    tv = rng.uniform(size=(512, 512)).astype(np.float32)
    tv /= tv.sum()
    out = {}
    for variant in ("per_epoch_attn", "base"):
        jm = JaxFusion(depth=10, s2d_stem=True, variant=variant,
                       dtype=jnp.bfloat16)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.key(0), mri, pet, t_feature=tv, train=False))
        v = _random_variables(shapes, rng)

        def apply(v, a, b, c, jm=jm):
            return jm.apply(v, a, b, t_feature=c, train=False)

        ref_shapes = jax.eval_shape(apply, v, mri, pet, tv)
        ref = jax.jit(apply)(v, mri, pet, tv)
        tm = MultimodalOTFusion(depth=10, s2d_stem=True, variant=variant)
        tm.load_state_dict(fusion_state_dict_from_jax(v["params"],
                                                      v["batch_stats"]))
        with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
            port = tm.eval()(T(mri), T(pet), T(tv))
        out[variant] = (ref_shapes, ref, port)

    jm = JaxClassifier(depth=10, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), mri,
                                            train=False))
    v = _random_variables(shapes, rng)

    def apply_cls(v, a):
        return jm.apply(v, a, train=False)[0]

    tm = ResNet3DClassifier(depth=10)
    tm.load_state_dict(classifier_state_dict_from_jax(v["params"],
                                                      v["batch_stats"]))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        logits, _ = tm.eval()(T(mri))
    out["classifier"] = ({"logits": jax.eval_shape(apply_cls, v, mri)},
                         {"logits": jax.jit(apply_cls)(v, mri)},
                         {"logits": logits})
    return out


@pytest.mark.parametrize("name", ["per_epoch_attn", "base", "classifier"])
def test_bf16_logits_are_float32_like_jax(cases, name):
    ref_shapes, ref, port = cases[name]
    assert ref_shapes["logits"].dtype == jnp.float32
    assert port["logits"].dtype == torch.float32
    want = np.asarray(ref["logits"], np.float32)
    got = port["logits"].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BOUND * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("name", ["per_epoch_attn", "base"])
def test_bf16_plan_application_is_float32_like_jax(cases, name):
    """``ot_mri_from_pet`` (the flagship's token, the base variant's OT-loss
    input) is float32, as JAX's ``features @ tv`` with a float32 plan."""
    ref_shapes, ref, port = cases[name]
    assert ref_shapes["ot_mri_from_pet"].dtype == jnp.float32
    got = port["ot_mri_from_pet"]
    assert got.dtype == torch.float32
    want = np.asarray(ref["ot_mri_from_pet"], np.float32)
    # Its inputs (the backbone's pooled features, the fusion MLP's bf16
    # output) carry the two frameworks' bf16 rounding; the product adds none.
    assert np.abs(got.numpy() - want).max() <= BOUND * np.abs(want).max()
