"""convert.py: JAX parameter trees into the port, strictly.

Round trip: a flax tree, made numpy, converted and loaded into the port's
model, gives back every leaf exactly (dense kernels transposed, conv
kernels HWIO -> OIHW).  A tree with a missing, extra or misshapen leaf
raises with the leaf's path.  Causal LM, LeNet-5 and the MLP.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    causal_lm_state_dict,
    lenet5_state_dict,
    load_causal_lm,
    load_lenet5,
    load_mlp,
    mlp_state_dict,
)

torch.set_num_threads(1)

KW = dict(num_classes=40, dim=64, depth=2, heads=4)
VARIANTS = {"mha": {}, "gqa": {"heads_kv": 2}, "tied": {"tie_embeddings": True}}


def _params_np(extra, seed=0):
    model = jax_get_model("causal_lm", **KW, **extra, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_round_trip_is_exact_and_strict(variant):
    extra = VARIANTS[variant]
    params = _params_np(extra)
    model = load_causal_lm(params, device="cpu", **KW, **extra, dtype=torch.float32)
    state = model.state_dict()
    converted = causal_lm_state_dict(params, {**KW, **extra})
    assert set(converted) == set(state)  # every key consumed, none left over
    n_leaves = 0
    for path, leaf in _flat(params):
        n_leaves += 1
        block, *mod, name = path
        key = ("blocks." + block.split("_")[1] if block.startswith("block_") else block)
        key = ".".join([key, *mod, {"kernel": "weight", "scale": "weight",
                                    "embedding": "weight"}.get(name, name)])
        got = state[key].numpy()
        want = leaf.T if name == "kernel" else leaf
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))
    assert n_leaves == len(state)
    if extra.get("tie_embeddings"):
        assert model.logits is None and "logits" not in params


def test_missing_leaf_names_its_path():
    params = _params_np({})
    del params["block_1"]["proj"]["bias"]
    with pytest.raises(ValueError, match="block_1/proj/bias"):
        causal_lm_state_dict(params, KW)


def test_wrong_shape_names_its_path():
    params = _params_np({})
    params["block_0"]["qkv"]["kernel"] = params["block_0"]["qkv"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="block_0/qkv/kernel"):
        causal_lm_state_dict(params, KW)


def test_unexpected_leaf_names_its_path():
    """A GQA tree offered as MHA: its q_proj is not an MHA leaf."""
    params = _params_np({"heads_kv": 2})
    with pytest.raises(ValueError, match="block_0/(q_proj|kv_proj)"):
        causal_lm_state_dict(params, KW)


# LeNet-5 and the MLP: conv kernels HWIO -> OIHW, dense kernels transposed


@functools.cache
def _image_params(name):
    kw = {"hidden": (64, 32)} if name == "mlp" else {}
    model = jax_get_model(name, num_classes=10, **kw)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    return jax.tree.map(np.asarray, params), kw


IMAGE_MODELS = {"lenet5": (lenet5_state_dict, load_lenet5),
                "mlp": (mlp_state_dict, load_mlp)}


@pytest.mark.parametrize("name", sorted(IMAGE_MODELS))
def test_image_model_round_trip_is_exact(name):
    to_state, load = IMAGE_MODELS[name]
    params, kw = _image_params(name)
    model = load(params, device="cpu", **kw)
    state = model.state_dict()
    assert set(to_state(params, kw)) == set(state)
    n_leaves = 0
    for path, leaf in _flat(params):
        n_leaves += 1
        module, kind = path
        got = state[f"{module}.{'weight' if kind == 'kernel' else kind}"].numpy()
        if kind == "kernel":
            want = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
        else:
            want = leaf
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))
    assert n_leaves == len(state)


@pytest.mark.parametrize("name", sorted(IMAGE_MODELS))
def test_image_model_missing_leaf_names_its_path(name):
    to_state, _ = IMAGE_MODELS[name]
    params, kw = _image_params(name)
    params = {k: dict(v) for k, v in params.items()}
    del params["logits"]["bias"]
    with pytest.raises(ValueError, match="logits/bias"):
        to_state(params, kw)


@pytest.mark.parametrize("name", sorted(IMAGE_MODELS))
def test_image_model_extra_leaf_names_its_path(name):
    to_state, _ = IMAGE_MODELS[name]
    params, kw = _image_params(name)
    params = {**params, "extra": {"kernel": np.zeros((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="extra/kernel"):
        to_state(params, kw)


@pytest.mark.parametrize("name, leaf", [("lenet5", "conv2"), ("lenet5", "fc1"),
                                        ("mlp", "dense_1")])
def test_image_model_wrong_shape_names_its_path(name, leaf):
    to_state, _ = IMAGE_MODELS[name]
    params, kw = _image_params(name)
    params = {k: dict(v) for k, v in params.items()}
    params[leaf]["kernel"] = params[leaf]["kernel"][..., :-1]
    with pytest.raises(ValueError, match=f"{leaf}/kernel"):
        to_state(params, kw)
