"""MoE blocks in the port's serving engine beside tp and cp, and on-mesh
decode of an expert-parallel x tp run, against the JAX package's engines
and generator at the same tp and cp over its virtual CPU devices.

The ranks are gloo processes (``tests/torch_cp_ranks.py``'s bodies, one
spawn of 2 and one of 4 for the module); each JAX reference engine is
built once.  The model is JAX's serving toy (vocab 16, dim 64, depth 2, 4
heads, float32) with its second block a top-2 MoE block of 4 experts at a
capacity factor of 1.0, where the prefill drops assignments.

* tp=2 and cp=2 (paged, 8-token pages): greedy streams identical to JAX's
  engine at the same tp or cp, and to JAX's tp=1 engine; every token's
  logprob within 1e-5 of JAX's (the first window's included); no build
  after ``prewarm`` on any rank.  Under cp=2 every prefill routes the whole
  prompt's tokens, gathered over the cp row, at the capacity of its whole
  token count, as JAX's does.
* Weight bytes a rank equal JAX's ``per_chip_bytes``: the experts and the
  router whole on every rank, the Megatron leaves halved under tp.
* int8 weights beside MoE blocks quantize exactly the leaves JAX's
  quantizer touches (never the experts or the router), and the tp=2 int8
  engine's streams are JAX's int8 engine's.
* ``Trainer.generate(on_mesh=True)`` of a dp=2 x tp=2 MoE run (expert
  leaves over ``data``, the dense leaves over ``model``; JAX
  ``tests/test_generate.py:572-593``) decodes JAX's generator's tokens and
  the port's default path's, without building ``_decode_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_ranks as ranks
from distributed_tensorflow_ibm_mnist_tpu.core.generate import make_generator as jax_generator
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.models.quant import quantize_params_int8
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict, flax_layout
from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models.quant import quantize_state_dict_int8

torch.set_num_threads(1)

MAX_LEN, PAGE = ranks.MAX_LEN, ranks.PAGE
KW = dict(num_classes=16, dim=64, depth=2, heads=4, moe_every=2, n_experts=4, moe_top_k=2,
          moe_capacity_factor=1.0)
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5, 4, 5, 4, 5], [6, 7, 8, 9], [2, 4, 2, 4, 2, 4]]
LOGP_TOL = 1e-5
# JAX's EP x tp on_mesh run (tests/test_generate.py:572-593), from its weights
ON_MESH_KW = {"dim": 64, "depth": 2, "heads": 4, "moe_every": 2, "n_experts": 2,
              "moe_capacity_factor": 8.0}
ON_MESH_CFG = dict(model="causal_lm", dataset="retrieval",
                   dataset_kwargs={"vocab": 16, "seq_len": 32}, n_train=128, n_test=32,
                   batch_size=64, epochs=1, quiet=True, eval_batch_size=32, dp=2, tp=2)
ON_MESH_PROMPT, ON_MESH_NEW = [[2, 9, 4, 7]], 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(**over):
    model = jax_get_model("causal_lm", **{**KW, "dtype": jnp.float32, **over})
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _jax_serve(model, params, **ekw):
    eng = JaxEngine(model, params, slots=2, max_len=MAX_LEN, kv_page_size=PAGE,
                    scheduler=JaxScheduler(max_len=MAX_LEN, buckets=(16,),
                                           max_queue=len(PROMPTS)), **ekw)
    reqs = [eng.submit(p, max_new=6) for p in PROMPTS]
    eng.run()
    out = {"streams": [list(r.generated) for r in reqs],
           "logprobs": [list(r.logprobs) for r in reqs],
           "weights": eng.weight_bytes_per_chip(), "kv": eng.kv_bytes_per_chip()}
    eng.close()
    return out


def _state(params, **over) -> dict:
    mk = {k: v for k, v in {**KW, **over}.items() if k != "dtype"}
    return {k: v.float().numpy() for k, v in causal_lm_state_dict(_np(params), mk).items()}


@pytest.fixture(scope="module")
def jax_refs(eight_devices):
    model, params = _jax_model()
    out = {"params": params, "tp1": _jax_serve(model, params),
           "tp2": _jax_serve(model, params, tp=2), "cp2": _jax_serve(model, params, cp=2),
           "int8_tp1": _jax_serve(model, params, quant="int8"),
           "int8_tp2": _jax_serve(model, params, tp=2, quant="int8")}
    # the prefill's routing under pressure: the first prompt padded to its bucket
    row = jnp.asarray([PROMPTS[0] + [0] * (16 - len(PROMPTS[0]))], jnp.int32)
    _, state = model.apply({"params": params}, row, mutable=["moe_stats"])
    out["prefill_dropped"] = float(jax.tree.leaves(state["moe_stats"])[0])
    om = jax_get_model("causal_lm", num_classes=16, **ON_MESH_KW, dtype=jnp.float32)
    om_params = om.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    gen = jax_generator(om, len(ON_MESH_PROMPT[0]) + ON_MESH_NEW, ON_MESH_NEW)
    out["on_mesh_tokens"] = np.asarray(gen(om_params, jnp.asarray(ON_MESH_PROMPT,
                                                                  jnp.int32))).tolist()
    out["on_mesh_state"] = {k: v.float().numpy() for k, v in causal_lm_state_dict(
        _np(om_params), {"num_classes": 16, **ON_MESH_KW}).items()}
    return out


@pytest.fixture(scope="module")
def port(jax_refs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh_serving")
    state = _state(jax_refs["params"])
    base = {"kind": "serve", "model_kw": KW, "state": state, "prompts": PROMPTS,
            "ranks": [0, 1], "prewarm": True}
    jobs2 = {"tp2": dict(base, tp=2, cp=1), "cp2": dict(base, tp=1, cp=2),
             "int8_tp2": dict(base, tp=2, cp=1, engine={"quant": "int8"}, prewarm=False)}
    cfg = dict(ON_MESH_CFG, model_kwargs=dict(ON_MESH_KW, dtype=torch.float32))
    jobs4 = {"on_mesh": {"kind": "on_mesh", "config": cfg, "state": jax_refs["on_mesh_state"],
                         "calls": [{"prompt": ON_MESH_PROMPT,
                                    "kw": {"max_new": ON_MESH_NEW}}]}}
    return {w: torchrun.spawn(ranks.run, w, "gloo", "cpu", tmp / f"store{w}", args=(w, jobs),
                              timeout=420)
            for w, jobs in ((2, jobs2), (4, jobs4))}


def test_ranks_import_no_jax(port):
    assert all(not r["forbidden"] for w in (2, 4) for r in port[w])


def test_the_prefill_routes_under_capacity_pressure(jax_refs):
    assert jax_refs["prefill_dropped"] > 0.0


@pytest.mark.parametrize("name", ["tp2", "cp2"])
def test_moe_engine_streams_and_logprobs_equal_jaxs(port, jax_refs, name):
    want = jax_refs[name]
    assert want["streams"] == jax_refs["tp1"]["streams"]  # JAX's own mesh parity
    leader = port[2][0][name]
    assert leader["streams"] == want["streams"]
    assert leader["statuses"] == ["done"] * len(PROMPTS)
    np.testing.assert_allclose([x for r in leader["logprobs"] for x in r],
                               [x for r in want["logprobs"] for x in r], rtol=0, atol=LOGP_TOL)
    assert leader["builds_after_prewarm"] == 0
    assert port[2][1][name]["follow"] is not None  # the follower served every call


@pytest.mark.parametrize("name", ["tp2", "cp2", "int8_tp2"])
def test_weight_bytes_a_rank_equal_jaxs_per_chip_bytes(port, jax_refs, name):
    for r in port[2]:
        assert r[name]["weight_bytes"] == jax_refs[name]["weights"]
    if name == "cp2":  # whole weights on every cp rank, as at tp=1
        assert jax_refs["cp2"]["weights"] == jax_refs["tp1"]["weights"]


def test_int8_quantizes_the_leaves_jaxs_quantizer_touches(jax_refs):
    model = get_model("causal_lm", device="cpu", dtype=torch.float32, **KW)
    paths = {name: path for name, (path, _, _) in flax_layout(model).items()}
    q = quantize_state_dict_int8(model.state_dict())
    got = {paths[k][:-1] for k, v in q.items() if v.dtype == torch.int8}

    def int8_paths(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from int8_paths(v, path + (k,))
            elif k == "kernel" and np.asarray(v).dtype == np.int8:
                yield path

    want = set(int8_paths(_np(quantize_params_int8(jax_refs["params"]))))
    assert got == want and not any("moe" in p for p in got)


def test_int8_moe_engine_at_tp2_equals_jaxs(port, jax_refs):
    want = jax_refs["int8_tp2"]["streams"]
    assert want == jax_refs["int8_tp1"]["streams"]
    assert port[2][0]["int8_tp2"]["streams"] == want


def test_on_mesh_decode_of_an_ep_tp_run_equals_jax_and_the_default_path(port, jax_refs):
    want = [jax_refs["on_mesh_tokens"]]
    for r in port[4]:
        got = r["on_mesh"]
        assert got["on_mesh"] == got["default"] == want
        assert got["decode_params_calls"] == 0 and got["gen_params_empty"]
        assert got["masters_float32"]
        assert got["cache_heads"] == [4 // 2]  # each model rank's H_kv / tp heads
