"""``Trainer.generate(on_mesh=True)`` in the port: decoding through the
run's own model in its sharded layout, against the port's default path
(whole leaves on one device, ``_decode_params``) and JAX's generator, on
the CPU.

The counterparts of JAX's ``tests/test_generate.py:473-520`` (tp=4),
``:756-788`` (tp=4, bf16 ragged + EOS, and sampled with the same key),
``:790`` (fsdp), ``:530`` (EP) and ``:886`` (int8 cache), at JAX's toy
sizes; JAX's EP x tp test (``:571``) is held in
``tests/test_torch_moe_mesh_serving.py``.  The ranks are four gloo processes
(``tests/torch_cp_ranks.py``, one spawn for the module): each run is a
port ``Trainer`` holding the weights of a JAX model's initialisation
(converted by ``convert.py``, each rank keeping its blocks by the run's
plan), the fsdp and EP runs at dp=4 where JAX's run at dp=8.  JAX's tokens
are its ``make_generator`` on those weights (which JAX's own tests pin
equal to its Trainer's default and on_mesh paths).

On every rank the on_mesh tokens equal the default path's and JAX's,
``_decode_params`` is never called on the on_mesh path and its cache stays
empty (JAX's check that no single-device re-layout happened), the module
keeps its float32 masters, and under tp each rank's cache holds H_kv / tp
heads.  JAX's refusals (a run with no sharded layout, sp, pp) come with
JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.generate import make_generator as jax_generator
from distributed_tensorflow_ibm_mnist_tpu.core.trainer import Trainer as JaxTrainer
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun

torch.set_num_threads(1)

P2 = [[2, 9, 4, 7], [1, 3, 3, 7]]
P1 = [[2, 9, 4, 7]]
# name -> (model kwargs, the port's run, its generate calls); JAX's configs
RUNS = {
    "tp": ({"dim": 64, "depth": 1, "heads": 4}, {"tp": 4},
           [(P2, {"max_new": 8})]),
    "bf16": ({"dim": 64, "depth": 1, "heads": 4, "dtype": "bfloat16"}, {"tp": 4},
             [([[2, 9, 4, 7], [1, 3, 0, 0]],
               {"max_new": 6, "eos_id": 1, "pad_id": 0, "prompt_lens": [4, 2]}),
              (P1, {"max_new": 6, "temperature": 0.8, "top_k": 8, "rng": 3})]),
    "fsdp": ({"dim": 64, "depth": 2, "heads": 4}, {"dp": 4, "fsdp": True},
             [(P1, {"max_new": 6})]),
    "ep": ({"dim": 32, "depth": 2, "heads": 2, "moe_every": 2, "n_experts": 8,
            "moe_capacity_factor": 8.0}, {"dp": 4}, [(P2, {"max_new": 8})]),
    "int8_kv": ({"dim": 64, "depth": 1, "heads": 4, "kv_cache_dtype": "int8"}, {"tp": 4},
                [(P1, {"max_new": 6})]),
}
F32 = {"dim": 64, "depth": 1, "heads": 4}
REFUSALS = {"dp": (F32, {"dp": 2}, {"dp": 4}), "sp": (F32, {"tp": 2, "sp": 2}, {"tp": 2, "sp": 2}),
            "pp": ({**F32, "depth": 2}, {"tp": 2, "pp": 2}, {"tp": 2, "pp": 2})}
DATA = dict(dataset="retrieval", dataset_kwargs={"vocab": 16, "seq_len": 32}, n_train=128,
            n_test=32, batch_size=64, epochs=1, quiet=True, eval_batch_size=32)


def _dtype(mk: dict, lib) -> dict:
    return {**mk, "dtype": getattr(lib, mk.get("dtype", "float32"))}


def _port_config(mk: dict, par: dict) -> dict:
    return dict(model="causal_lm", model_kwargs=_dtype(mk, torch), **DATA, **par)


@pytest.fixture(scope="module")
def jax_tokens(eight_devices):
    """JAX's generator on each run's initial weights, and the weights."""
    out = {}
    for name, (mk, _, calls) in RUNS.items():
        model = jax_get_model("causal_lm", num_classes=16, **_dtype(mk, jnp))
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        toks = []
        for prompt, kw in calls:
            kw = dict(kw)
            rng, lens = kw.pop("rng", None), kw.pop("prompt_lens", None)
            max_new = kw.pop("max_new")
            gen = jax_generator(model, len(prompt[0]) + max_new, max_new, **kw)
            toks.append(np.asarray(gen(params, jnp.asarray(prompt, jnp.int32),
                                       rng=None if rng is None else jax.random.PRNGKey(rng),
                                       prompt_lens=None if lens is None else
                                       jnp.asarray(lens, jnp.int32))).tolist())
        state = causal_lm_state_dict(jax.tree.map(np.asarray, params),
                                     {"num_classes": 16, **{k: v for k, v in mk.items()
                                                            if k != "dtype"}})
        out[name] = {"tokens": toks, "state": {k: v.float().numpy() for k, v in state.items()}}
    return out


@pytest.fixture(scope="module")
def jax_refusals(eight_devices):
    """JAX's Trainer refusals of on_mesh, word for word (no training)."""
    out = {}
    for name, (mk, par, _) in REFUSALS.items():
        cfg = JaxConfig(name=f"onmesh_{name}", model="causal_lm", model_kwargs=_dtype(mk, jnp),
                        **DATA, **par)
        with pytest.raises(ValueError) as e:
            JaxTrainer(cfg).generate(jnp.asarray(P1, jnp.int32), max_new=2, on_mesh=True)
        out[name] = str(e.value)
    return out


@pytest.fixture(scope="module")
def port(jax_tokens, tmp_path_factory):
    jobs = {name: {"kind": "on_mesh", "config": _port_config(mk, par),
                   "state": jax_tokens[name]["state"],
                   "calls": [{"prompt": p, "kw": kw} for p, kw in calls]}
            for name, (mk, par, calls) in RUNS.items()}
    jobs["refusals"] = {"kind": "on_mesh_refusals", "configs": {
        name: _port_config(mk, par) for name, (mk, _, par) in REFUSALS.items()}}
    tmp = tmp_path_factory.mktemp("on_mesh")
    return torchrun.spawn(ranks.run, 4, "gloo", "cpu", tmp / "store", args=(4, jobs),
                          timeout=420)


def test_ranks_import_no_jax(port):
    assert all(not r["forbidden"] for r in port)


@pytest.mark.parametrize("name", list(RUNS))
def test_on_mesh_equals_the_default_path_and_jax(port, jax_tokens, name):
    """Every rank's on_mesh tokens are its default path's and JAX's; the
    on_mesh calls built no ``_decode_params`` (its cache stays empty) and
    decoded from the float32 masters; a tp rank's cache held H_kv / 4
    heads (1 of 4), an fsdp or EP rank's all of them."""
    want = jax_tokens[name]["tokens"]
    for r in port:
        got = r[name]
        assert got["on_mesh"] == got["default"] == want, (name, got, want)
        assert got["decode_params_calls"] == 0 and got["gen_params_empty"]
        assert got["masters_float32"]
        heads = 1 if "tp" in RUNS[name][1] else RUNS[name][0]["heads"]
        assert got["cache_heads"] == [heads] * len(RUNS[name][2])


def test_on_mesh_refusals_are_jaxs(port, jax_refusals):
    """A run with no sharded layout (dp only), sp beside tp and pp beside tp
    refuse on_mesh with JAX's ``ValueError`` (the port's dp run at dp=4, as
    the port's other runs; JAX's at dp=2)."""
    for r in port:
        assert r["refusals"] == jax_refusals
