"""The causal-LM and ViT training follow-ups of the port against the JAX
package, on the CPU at toy sizes.

* The bf16 causal LM trains on float32 master weights and float32 Adam
  moments, as flax's ``param_dtype`` keeps them: eight ``warmup_cosine``
  Adam steps (updates of 1e-5 to 7e-5) from a JAX ``TrainState`` carried in
  by ``convert.load_train_state`` move every parameter as JAX's steps move
  it, each tensor's change within ``DELTA_REL`` of JAX's change (bf16
  masters would round most of these updates away).
* MoE blocks (top-2 GShard routing under capacity pressure, the
  load-balancing aux loss and the router z-loss) in the LM and the ViT, on
  converted weights in float32: logits, the training loss with its aux
  and z terms, every gradient and one train step against JAX's, and the
  ``moe_dropped_frac`` step metric; the epoch records carry
  ``moe_dropped_frac`` for MoE runs only (starved and ample capacity, JAX's
  ``tests/test_expert_parallel.py:284-323``).
* MoE decode: teacher-forced decode logits against the full forward (JAX's
  ``tests/test_generate.py:635``, at its 2e-4) and greedy engine streams
  against the JAX engine's, dense and paged.
* ``pos="learned"``: the forward against JAX's, training, and JAX's
  ``ValueError`` word for word from every decode entry point.
* Dropout.  Its masks cannot match JAX's (another generator), so it is
  gated by statistics: the keep fraction within 5 sigma of 1 - p, the
  survivors scaled by 1/(1 - p), eval identical to dropout 0, masks that
  differ across blocks, steps and ranks; and remat's recompute replays
  the forward's masks, so its gradients equal the plain step's (with MoE
  terms counted once).
* The Trainer: float32 masters and moments, the decode cast (dense leaves
  in the compute dtype, ``norm_*`` and ``moe`` float32), ``generate`` and
  ``InferenceEngine.from_trainer`` on a MoE LM.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.core import steps as jax_steps
from distributed_tensorflow_ibm_mnist_tpu.core.optim import make_optimizer as jax_make_optimizer
from distributed_tensorflow_ibm_mnist_tpu.core.state import TrainState as JaxTrainState
from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import (
    causal_lm_state_dict,
    load_causal_lm,
    load_train_state,
    load_vit,
    train_state_dict,
    vit_state_dict,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
    init_cache,
    make_decode_step,
    make_generator,
    make_prefill,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer, _seed_words
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models.lenet import dropout
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

torch.set_num_threads(1)

LM_KW = dict(num_classes=16, dim=32, depth=2, heads=4)
VIT_KW = dict(patch_size=7, dim=32, depth=2, heads=4)
SEQ, BATCH = 12, 8
# top-2 GShard routing at capacity factor 1.0: under pressure, so the
# comparisons below see dropped assignments; z-loss on
MOE = dict(moe_every=2, n_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
           moe_z_weight=1e-3)
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed: int, b=BATCH, s=SEQ, vocab=16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, s)).astype(np.int32),
            rng.integers(0, vocab, (b, s)).astype(np.int32))


def _images(seed: int, b=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 28, 28, 1)).astype(np.uint8),
            rng.integers(0, 10, b).astype(np.int32))


# ------------------------------------------------ float32 masters (the repair)

# each tensor's change over 8 steps against JAX's change, relative to the
# norm of JAX's change.  The two sides' bf16 forward and backward round at
# different places, and Adam's early steps amplify small gradients towards
# sign(g); measured on this port: worst 0.052 (a qkv bias).  bf16 masters
# leave most updates at exactly zero: 0.9 and more.
DELTA_REL = 0.2
BF16_STEPS = 8


@functools.cache
def _bf16_runs():
    """JAX's bf16 LM and the port's, from one JAX TrainState, 8 Adam steps
    under warmup_cosine (lr 1e-3, 100 warmup steps: updates of a few
    1e-5) on the same batches."""
    opt = dict(optimizer="adam", lr=1e-3, schedule="warmup_cosine", warmup_steps=100)
    total = 1000
    jmodel = jax_get_model("causal_lm", **LM_KW, dtype=jnp.bfloat16)
    tx = jax_make_optimizer(JaxRunConfig(**opt), total)
    jstate = JaxTrainState.create(jmodel, tx, jax.random.PRNGKey(0),
                                  jnp.zeros((1, SEQ), jnp.int32))
    start = _np(jstate)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, tx))
    batches = [_tokens(100 + i) for i in range(BF16_STEPS)]
    for x, y in batches:
        jstate, _ = jstep(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    cfg = RunConfig(model="causal_lm", dataset="retrieval", batch_size=BATCH,
                    model_kwargs={k: v for k, v in LM_KW.items() if k != "num_classes"}
                    | {"dtype": torch.bfloat16}, **opt)
    state = load_train_state(start, cfg, device="cpu", total_steps=total,
                             num_classes=LM_KW["num_classes"])
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step = steps.make_train_step(state.model, state.optimizer)
    for x, y in batches:
        step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    j0 = causal_lm_state_dict(start.params, LM_KW)
    j1 = train_state_dict(_np(jstate), cfg, num_classes=LM_KW["num_classes"])
    return state, p0, j0, j1


def test_bf16_lm_keeps_float32_masters_and_moments():
    state, *_ = _bf16_runs()
    names = [n for n, _ in state.model.named_parameters()]
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert state.model.dtype == torch.bfloat16  # the compute dtype
    opt = state.optimizer.state_dict(names)
    assert {t.dtype for m in ("mu", "nu") for t in opt[m].values()} == {torch.float32}


def test_bf16_lm_warmup_steps_move_the_weights_as_jax_does():
    """Every tensor's change over 8 tiny-lr Adam steps within DELTA_REL of
    JAX's change (the raw values would hide a fault: the start point's
    rounding is common to both)."""
    state, p0, j0, j1 = _bf16_runs()
    worst = {}
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(p0[name].numpy(), j0[name].numpy())
        # elements whose gradient stayed at rounding level (JAX's second
        # moment under 1e-6 of the tensor's largest: the k part of the qkv
        # bias, which softmax cannot see) take Adam's sign-like step on
        # noise on both sides, so they are left out
        nu = j1["optimizer"]["nu"][name].numpy()
        real = nu >= 1e-6 * nu.max()
        d_port = (p.detach() - p0[name]).numpy()[real]
        d_jax = (j1["params"][name] - j0[name]).numpy()[real]
        assert np.linalg.norm(d_jax) > 0, name
        worst[name] = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
    bad = {k: v for k, v in worst.items() if v > DELTA_REL}
    assert not bad, bad


# ------------------------------------------------ MoE against JAX, float32


@functools.cache
def _setup(kind: str):
    """JAX model and params, a loader of the port's model on the same
    weights, a batch, the tree converter."""
    if kind == "lm":
        jm = jax_get_model("causal_lm", **LM_KW, **MOE, dtype=jnp.float32)
        params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                       jnp.zeros((1, SEQ), jnp.int32))["params"])
        load = functools.partial(load_causal_lm, params, device="cpu", **LM_KW, **MOE,
                                 dtype=torch.float32)
        x, y = _tokens(5)
        convert = functools.partial(causal_lm_state_dict, cfg={**LM_KW, **MOE})
    else:
        kw = {**VIT_KW, **MOE, "moe_every": 1}
        jm = jax_get_model("vit", **kw, dtype=jnp.float32)
        params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                       jnp.zeros((1, 28, 28, 1)))["params"])
        load = functools.partial(load_vit, params, device="cpu", **kw, dtype=torch.float32)
        x, y = _images(5)
        convert = functools.partial(vit_state_dict, cfg=kw)
    return jm, params, load, {"image": x, "label": y}, convert


@functools.cache
def _moe_case(kind: str):
    jm, params, load, batch, convert = _setup(kind)
    tm = load().train()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss_fn = jax_steps.make_loss_fn(jm)
    (jl, (_, jlogits, jdrop)), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True), static_argnums=(4,))(
        params, {}, jbatch, jax.random.PRNGKey(0), True)
    jeval = float(jax.jit(jloss_fn, static_argnums=(4,))(
        params, {}, jbatch, jax.random.PRNGKey(0), False)[0])
    loss, logits, drop = steps.make_loss_fn(tm, with_drop=True)(tbatch)
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    with torch.no_grad():
        eval_loss = float(steps.make_loss_fn(tm)(tbatch, train=False)[0])
    # one SGD step on each side
    tx = jax_make_optimizer(JaxRunConfig(optimizer="sgd", lr=0.5), 10)
    jstate = JaxTrainState.create(jm, tx, jax.random.PRNGKey(0), jbatch["image"][:1])
    jstate = jstate.replace(params=params)
    jnew, jm_metrics = jax.jit(jax_steps.make_train_step(jm, tx))(jstate, jbatch)
    tm2 = load().train()
    opt = make_optimizer(RunConfig(optimizer="sgd", lr=0.5), 10, list(tm2.parameters()))
    state = TrainState(step=0, model=tm2, optimizer=opt, data_generator=torch.Generator())
    metrics = steps.make_train_step(tm2, opt)(state, tbatch)
    return dict(jl=float(jl), jlogits=np.asarray(jlogits), jdrop=float(jdrop),
                jgrads=convert(_np(jgrads)), jeval=jeval, loss=float(loss),
                logits=logits.detach().numpy(), drop=float(drop), grads=grads,
                eval_loss=eval_loss, jnew=convert(_np(jnew.params)),
                jmetrics={k: float(v) for k, v in jm_metrics.items()},
                new=tm2.state_dict(), metrics={k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("kind", ["lm", "vit"])
def test_moe_forward_and_loss_with_aux_and_z_match_jax(kind):
    c = _moe_case(kind)
    np.testing.assert_allclose(c["logits"], c["jlogits"], atol=TOL, rtol=TOL)
    assert c["loss"] == pytest.approx(c["jl"], rel=TOL)
    assert c["eval_loss"] == pytest.approx(c["jeval"], rel=TOL)
    assert c["loss"] > c["eval_loss"]  # the aux and z terms: training loss only
    assert c["drop"] == pytest.approx(c["jdrop"], abs=1e-7)
    assert c["drop"] > 0.0  # capacity factor 1.0 drops assignments


@pytest.mark.parametrize("kind", ["lm", "vit"])
def test_moe_gradients_match_jax(kind):
    c = _moe_case(kind)
    assert set(c["grads"]) == set(c["jgrads"])
    for name, g in c["grads"].items():
        np.testing.assert_allclose(g.numpy(), c["jgrads"][name].numpy(), atol=TOL,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["lm", "vit"])
def test_moe_train_step_matches_jax(kind):
    c = _moe_case(kind)
    for key in ("loss", "accuracy", "moe_dropped_frac"):
        assert c["metrics"][key] == pytest.approx(c["jmetrics"][key], rel=TOL, abs=1e-7), key
    for name, want in c["jnew"].items():
        np.testing.assert_allclose(c["new"][name].numpy(), want.numpy(), atol=TOL,
                                   err_msg=name)


def _vit_cfg(**kw):
    model_kwargs = dict(VIT_KW, dim=16, heads=2, moe_every=1, n_experts=8,
                        dtype=torch.float32) | kw.pop("model_kwargs", {})
    base = dict(model="vit", dataset="mnist", synthetic=True, quiet=True, n_train=256,
                n_test=64, batch_size=64, epochs=1, eval_batch_size=64,
                model_kwargs=model_kwargs)
    return RunConfig(**{**base, **kw})


@pytest.mark.parametrize("factor, starved", [(0.1, True), (8.0, False)],
                         ids=["starved", "ample"])
def test_moe_dropped_frac_reaches_epoch_records(factor, starved):
    """An undersized capacity factor reports most assignments dropped, an
    ample one none (JAX's thresholds)."""
    t = Trainer(_vit_cfg(model_kwargs={"moe_capacity_factor": factor}), device="cpu")
    t.fit()
    rec = t.history[-1]
    assert "moe_dropped_frac" in rec
    if starved:
        assert rec["moe_dropped_frac"] > 0.5, rec
    else:
        assert rec["moe_dropped_frac"] < 1e-6, rec
    assert rec["moe_dropped_frac"] == round(rec["moe_dropped_frac"], 6)


def test_non_moe_runs_have_no_drop_metric_and_grad_accum_averages_it():
    t = Trainer(_vit_cfg(model_kwargs={"moe_every": 0}), device="cpu")
    t.fit()
    assert "moe_dropped_frac" not in t.history[-1]
    t = Trainer(_vit_cfg(grad_accum=2, model_kwargs={"moe_capacity_factor": 0.5}),
                device="cpu")
    m = t._run_epoch(t.state, t.train_images[:64], t.train_labels[:64])
    assert m["moe_dropped_frac"].shape == (1,) and 0.0 < float(m["moe_dropped_frac"]) < 1.0


# ------------------------------------------------ MoE decode and serving

DECODE_MOE = dict(moe_every=2, n_experts=4, moe_capacity_factor=8.0)


@functools.cache
def _decode_pair(top_k: int = 1):
    jm = jax_get_model("causal_lm", num_classes=16, dim=32, depth=2, heads=2,
                       **DECODE_MOE, moe_top_k=top_k, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(_np(params), device="cpu", num_classes=16, dim=32, depth=2,
                        heads=2, **DECODE_MOE, moe_top_k=top_k, dtype=torch.float32)
    return jm, params, tm


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_decodes_teacher_forcing(top_k):
    """With ample capacity, incremental decode logits equal the full
    forward position for position (JAX's test, its 2e-4), and the full
    forward equals JAX's."""
    jm, params, tm = _decode_pair(top_k)
    tokens = np.random.default_rng(2).integers(0, 16, size=(2, 12)).astype(np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens)))
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        full = tm(t).numpy()
        np.testing.assert_allclose(full, want, atol=TOL)
        cache = init_cache(tm, 2, 16)
        logits = tm(t[:, :6], cache=cache, max_len=16)
        np.testing.assert_allclose(logits.numpy(), full[:, :6], atol=2e-4)
        step = make_decode_step(tm, 16)
        for i in range(6, 12):
            _, step_logits = step(cache, t[:, i])
            np.testing.assert_allclose(step_logits.numpy(), full[:, i], atol=2e-4,
                                       err_msg=f"position {i}")


PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9], [3, 1, 4, 1, 5]]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_moe_engine_streams_equal_the_jax_engine(paged):
    jm, params, tm = _decode_pair(2)
    kw = dict(kv_page_size=8) if paged else {}
    eng = InferenceEngine(tm, device="cpu", slots=2, max_len=32, **kw)
    reqs = [eng.submit(p, max_new=8) for p in PROMPTS]
    eng.run()
    jeng = JaxEngine(jm, params, slots=2, max_len=32, **kw)
    jreqs = [jeng.submit(np.asarray(p, np.int32), max_new=8) for p in PROMPTS]
    jeng.run()
    assert [r.status for r in reqs] == ["done"] * len(PROMPTS)
    assert [tuple(r.generated) for r in reqs] == [tuple(r.generated) for r in jreqs]


# capacity factor 1.0 under top-2 routing: a 16-token bucket's 32 assignments
# meet 4 experts of int(16 / 4) = 4 slots (the prefill drops), and a two-slot
# window's 4 meet 4 experts of max(1, int(2 / 4)) = 1 slot (a decode step
# drops whenever the two tokens' expert pairs meet)
PRESSURE_MOE = dict(moe_every=2, n_experts=4, moe_capacity_factor=1.0, moe_top_k=2)


@functools.cache
def _pressure_pair():
    jm = jax_get_model("causal_lm", num_classes=16, dim=32, depth=2, heads=2,
                       **PRESSURE_MOE, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(_np(params), device="cpu", num_classes=16, dim=32, depth=2,
                        heads=2, **PRESSURE_MOE, dtype=torch.float32)
    return jm, params, tm


def test_moe_engine_under_capacity_pressure_equals_the_jax_engine():
    """Decode under capacity pressure (queue 3 gap 3): the engine's MoE
    blocks route each call's padded token set at a capacity factor that
    drops assignments, as JAX's do, so the greedy streams and per-token
    logprobs equal the JAX engine's, and the first window (two B=1 bucket
    prefills inserted into a two-slot cache, one decode step of both rows)
    gives JAX's logits."""
    import importlib

    jgen = importlib.import_module("distributed_tensorflow_ibm_mnist_tpu.core.generate")
    jm, params, tm = _pressure_pair()
    padded = [p + [0] * (16 - len(p)) for p in PROMPTS[:2]]
    with torch.no_grad():
        _, moe = tm(torch.tensor(padded[:1]), with_moe=True)
    assert float(moe["dropped"]) > 0.0  # the prefill's routing drops
    eng = InferenceEngine(tm, device="cpu", slots=2, max_len=32)
    reqs = [eng.submit(p, max_new=8) for p in PROMPTS]
    eng.run()
    jeng = JaxEngine(jm, params, slots=2, max_len=32)
    jreqs = [jeng.submit(np.asarray(p, np.int32), max_new=8) for p in PROMPTS]
    jeng.run()
    assert [r.status for r in reqs] == ["done"] * len(PROMPTS)
    assert [tuple(r.generated) for r in reqs] == [tuple(r.generated) for r in jreqs]
    np.testing.assert_allclose([x for r in reqs for x in r.logprobs],
                               [x for r in jreqs for x in r.logprobs], atol=TOL)

    cache, jcache = init_cache(tm, 2, 32), jgen.init_cache(jm, params, 2, 32)
    toks = []
    for slot, (p, row) in enumerate(zip(PROMPTS[:2], padded)):
        lens = [len(p)]
        tcache, tlast = make_prefill(tm, 32)(torch.tensor([row]), torch.tensor(lens))
        jrow, jlast = jgen.make_prefill(jm, 32)(params, jnp.asarray([row], jnp.int32),
                                                jnp.asarray(lens, jnp.int32))
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=TOL)
        InferenceEngine._insert_impl(cache, tcache, slot)
        jcache = JaxEngine._insert_impl(jcache, jrow, slot)
        toks.append(int(np.asarray(jlast).argmax()))
    _, logits = make_decode_step(tm, 32)(cache, torch.tensor(toks))
    _, jlogits = jgen.make_decode_step(jm, 32)(params, jcache, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL)


# ------------------------------------------------ learned positions


@functools.cache
def _learned():
    jm = jax_get_model("causal_lm", **LM_KW, pos="learned", dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))["params"]
    tm = load_causal_lm(_np(params), device="cpu", **LM_KW, pos="learned", seq_len=SEQ,
                        dtype=torch.float32)
    return jm, params, tm


def test_learned_positions_forward_matches_jax():
    jm, params, tm = _learned()
    x, _ = _tokens(7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    assert tm.pos_embed.shape == (1, SEQ, LM_KW["dim"])
    with pytest.raises(ValueError, match="built for seq_len=12"):
        tm(torch.from_numpy(x[:, :5]))


def _jax_decode_refusal() -> str:
    jm, params, _ = _learned()
    with pytest.raises(ValueError) as e:
        jm.apply({"params": params}, jnp.zeros((1, 4), jnp.int32), decode=True,
                 max_len=16, mutable=["cache"])
    return str(e.value)


@pytest.mark.parametrize("entry", ["make_prefill", "make_generator", "make_decode_step",
                                   "InferenceEngine", "forward"])
def test_learned_positions_refuse_decode_in_jax_words(entry):
    want = _jax_decode_refusal()
    _, _, tm = _learned()
    calls = {
        "make_prefill": lambda: make_prefill(tm, 16),
        "make_generator": lambda: make_generator(tm, 16, 4),
        "make_decode_step": lambda: make_decode_step(tm, 16),
        "InferenceEngine": lambda: InferenceEngine(tm, device="cpu", slots=1, max_len=16),
        "forward": lambda: tm(torch.zeros((1, SEQ), dtype=torch.int32), sow_kv=True),
    }
    with pytest.raises(ValueError) as got:
        calls[entry]()
    assert str(got.value) == want


def _lm_cfg(**kw):
    model_kwargs = dict(dim=32, depth=2, heads=4) | kw.pop("model_kwargs", {})
    base = dict(model="causal_lm", dataset="retrieval",
                dataset_kwargs={"vocab": 16, "seq_len": SEQ}, n_train=64, n_test=16,
                batch_size=16, epochs=1, quiet=True, eval_batch_size=16,
                model_kwargs=model_kwargs)
    return RunConfig(**{**base, **kw})


def test_trainer_learns_learned_positions_and_generate_refuses():
    t = Trainer(_lm_cfg(model_kwargs={"pos": "learned"}), device="cpu")
    assert t.model.seq_len == SEQ and t.model.pos_embed.dtype == torch.float32
    before = t.model.pos_embed.detach().clone()
    t.fit()
    assert not torch.equal(t.model.pos_embed.detach(), before)
    with pytest.raises(ValueError) as got:
        t.generate(np.asarray([1, 2, 3]), max_new=2)
    assert str(got.value) == _jax_decode_refusal()
    with pytest.raises(ValueError) as got:
        InferenceEngine.from_trainer(t, slots=1, max_len=16)
    assert str(got.value) == _jax_decode_refusal()


# ------------------------------------------------ dropout, by statistics


def test_dropout_keep_fraction_and_scale():
    """Masks come from another generator than JAX's, so no element can be
    compared: the keep fraction lies within 5 sigma of 1 - p and every
    survivor is scaled by exactly 1/(1 - p), as flax's nn.Dropout does."""
    p, n = 0.1, 1 << 17
    x = torch.ones(n)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    keep = float((y != 0).float().mean())
    assert abs(keep - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - p)))


def _dropout_lm(rate=0.1, **kw):
    return get_model("causal_lm", **LM_KW, dropout=rate, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(4), **kw)


def test_dropout_is_off_in_eval_and_on_in_training():
    a, b = _dropout_lm(0.1), _dropout_lm(0.0)
    x = torch.from_numpy(_tokens(8)[0])
    with torch.no_grad():
        assert torch.equal(a(x), b(x))  # train=False: bit for bit
        state = a.generator.get_state()
        assert torch.equal(a(x), b(x, train=True))
        assert torch.equal(a.generator.get_state(), state)  # eval draws nothing
        assert not torch.allclose(a(x, train=True), b(x))


def test_dropout_masks_differ_across_blocks_steps_and_ranks():
    m = _dropout_lm()
    ones = torch.ones(4, SEQ, LM_KW["dim"])
    blocks = [blk._dropout(ones, True) != 0 for blk in m.blocks]
    assert not torch.equal(blocks[0], blocks[1])  # across blocks of one forward
    again = m.blocks[0]._dropout(ones, True) != 0
    assert not torch.equal(blocks[0], again)  # across steps
    # across ranks: the Trainer seeds rank r's model generator from
    # (seed, 0, r) under dp > 1
    masks = []
    for rank in (0, 1):
        m.generator.manual_seed(_seed_words(0, 0, rank))
        masks.append(m.blocks[0]._dropout(ones, True) != 0)
    assert not torch.equal(masks[0], masks[1])


@pytest.mark.parametrize("mode", ["blocks", "whole"])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_remat_replays_the_dropout_masks_and_counts_moe_terms_once(mode, moe):
    """Dropout 0.1 (and MoE with aux and z terms): the loss and every
    gradient under remat equal the plain step's from the same generator
    state (the recompute replays the forward's masks; the MoE terms leave
    the forward as outputs, so they are counted once)."""
    kw = MOE if moe else {}
    x, y = _tokens(9)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    out = {}
    for remat in (False, True):
        m = _dropout_lm(block_remat=remat and mode == "blocks", **kw)
        m.generator.manual_seed(11)
        loss, _ = steps.make_loss_fn(m, remat=remat and mode == "whole")(batch)
        out[remat] = (loss, torch.autograd.grad(loss, list(m.parameters())))
    assert float(out[True][0]) == float(out[False][0])
    for g1, g0 in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(g1, g0, rtol=0, atol=1e-7)


# ------------------------------------------------ the Trainer's MoE LM


@functools.cache
def _moe_lm_trainer():
    t = Trainer(_lm_cfg(model_kwargs={**MOE, "moe_capacity_factor": 8.0, "dropout": 0.1}),
                device="cpu")
    t.fit()
    return t


def test_trainer_moe_lm_masters_moments_and_records():
    t = _moe_lm_trainer()
    assert {p.dtype for p in t.model.parameters()} == {torch.float32}
    assert t.model.dtype == torch.bfloat16
    assert {m.dtype for m in t.state.optimizer.mu + t.state.optimizer.nu} == {torch.float32}
    rec = t.history[-1]
    assert np.isfinite(rec["train_loss"]) and 0.0 <= rec["moe_dropped_frac"] <= 1.0


def test_trainer_decode_cast_is_jaxs():
    """JAX's decode cast: floating leaves in the compute dtype, norms and
    MoE leaves float32; generate and an engine run on it."""
    t = _moe_lm_trainer()
    params = t._decode_params()
    for name, v in params.items():
        keep = ".moe." in name or ".norm_" in name or name.startswith("norm_")
        assert v.dtype == (torch.float32 if keep else torch.bfloat16), name
        src = t.model.state_dict()[name]
        assert torch.equal(v, src.to(v.dtype)), name
    out = t.generate(np.asarray([1, 2, 3, 4]), max_new=4)
    assert out.shape == (1, 8)
    eng = InferenceEngine.from_trainer(t, slots=2, max_len=32, device="cpu")
    req = eng.submit([1, 2, 3, 4], max_new=4)
    eng.run()
    assert req.status == "done" and list(req.generated) == out[0, 4:].tolist()


def test_pre_change_bf16_checkpoint_upcasts_into_float32_masters():
    """A save form written when the LM trained on bf16 masters (parameters
    and moments in bf16) loads into the float32-master state: each value
    upcast exactly, the dtypes float32."""
    old = get_model("causal_lm", **LM_KW, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for n, p in old.named_parameters() if "norm" not in n} == {torch.bfloat16}
    old_opt = make_optimizer(RunConfig(), 10, list(old.parameters()))
    for m in old_opt.mu:
        m.fill_(0.25)
    form = TrainState(step=3, model=old, optimizer=old_opt,
                      data_generator=torch.Generator()).state_dict()
    new = get_model("causal_lm", **LM_KW, dtype=torch.bfloat16, device="cpu",
                    param_dtype=torch.float32)
    state = TrainState(step=0, model=new, optimizer=make_optimizer(
        RunConfig(), 10, list(new.parameters())), data_generator=torch.Generator())
    state.load_state_dict(form)
    assert state.step == 3
    for name, p in new.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), form["params"][name].float()), name
    assert all(m.dtype == torch.float32 and float(m.min()) == 0.25
               for m in state.optimizer.mu)


def test_train_state_dict_keeps_moe_moments_float32():
    jm = jax_get_model("causal_lm", **LM_KW, **MOE, dtype=jnp.bfloat16)
    tx = jax_make_optimizer(JaxRunConfig(optimizer="adam"), 10)
    jstate = JaxTrainState.create(jm, tx, jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    x, y = _tokens(12)
    jstate, _ = jax.jit(jax_steps.make_train_step(jm, tx))(
        jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    cfg = RunConfig(model="causal_lm", optimizer="adam",
                    model_kwargs={**MOE, "dim": 32, "depth": 2, "heads": 4,
                                  "dtype": torch.bfloat16})
    form = train_state_dict(_np(jstate), cfg, num_classes=16)
    state = load_train_state(_np(jstate), cfg, device="cpu", total_steps=10, num_classes=16)
    names = [n for n, _ in state.model.named_parameters()]
    assert any(".moe." in n for n in names)
    opt = state.optimizer.state_dict(names)
    for moment in ("mu", "nu"):
        for name in names:
            got = opt[moment][name]
            assert got.dtype == torch.float32
            assert torch.equal(got, form["optimizer"][moment][name]), (moment, name)


def test_moe_flops_count_the_router_and_the_routed_experts():
    """A MoE block's FFN counts its router (2 T D E) and the expert FFN on
    the T * top_k routed assignments (2 x 2 D H each), not the capacity
    padding: bench_lm8k with 2 of 4 blocks MoE at top-2 adds per token
    2 x (2 D E + (2 - 1) x 4 D H) training-step FLOPs x 3 to the dense
    count."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils import flops

    s, d, depth, h, v = 8192, 512, 4, 8, 256
    dense = flops.causal_lm_flops_per_sequence(s, d, depth, h, v)
    moe = flops.causal_lm_flops_per_sequence(s, d, depth, h, v, moe_every=2, n_experts=8,
                                             moe_top_k=2)
    per_block_token = 2 * d * 8 + (2 - 1) * 2 * 2 * d * 4 * d
    assert moe - dense == pytest.approx(2 * 3 * s * per_block_token, rel=1e-12)
    t = Trainer(_vit_cfg(model_kwargs={"moe_top_k": 2}), device="cpu")
    kw = dict(VIT_KW, dim=16, heads=2)
    want = 3 * flops.vit_forward_flops((28, 28, 1), kw["patch_size"], kw["dim"], kw["depth"],
                                       kw["heads"], moe_every=1, n_experts=8, moe_top_k=2)
    assert t._flops_per_image == pytest.approx(want, rel=1e-12)
    assert want > 3 * flops.vit_forward_flops((28, 28, 1), kw["patch_size"], kw["dim"],
                                              kw["depth"], kw["heads"])
