"""The port's ResNets against the JAX package's, on the CPU at toy sizes.

ResNet-20 (its full width: it is small) and ResNet-50's bottleneck layout
at width 8, on (2, 32, 32, 3) images and at odd sizes (15 px, where XLA's
SAME padding of a stride-2 3x3 conv is (1, 1), against (0, 1) at 32 px),
with both stems.  JAX's parameters come from its own ``init``; BatchNorm's
scale, bias and ``batch_stats`` are then redrawn from a numpy seed, so
every normalisation does real work.  Everything is converted with
``convert.load_resnet``.

* eval logits: float32 within 1e-4 (reduction order), bf16 within 2e-2 of
  the largest |logit| (two frameworks rounding to bf16 at different places);
* one ``train=True`` forward: logits within 1e-4 and the running mean and
  variance against JAX's mutated ``batch_stats`` within 1e-5 (float32);
* one train step through ``make_train_step`` (momentum, weight decay,
  with and without ``grad_accum``): parameters within 1e-4 and statistics
  within 1e-5 of the JAX step's, run in float64 (the test says why).

ResNet-50's training-mode checks run in float64 on both sides (JAX under
``jax.enable_x64``), at 1e-9: in float32 its deep, small-batch BatchNorms
make JAX's own result differ from its float64 result by up to 3.4e-5 in
the running statistics and 4e-4 in the logits, so no float32 comparison
across frameworks can hold 1e-5 there.  Either rule PyTorch defaults to
(the unbiased running variance, (1, 1) padding of a stride-2 3x3 conv)
moves those numbers by 1e-3 or more;
* the Trainer on ResNet-20 and ResNet-50: one epoch, finite loss,
  ``measure_throughput`` leaves the BatchNorm buffers bit-identical;
* ``utils/flops.py``'s forward counts within 7% of XLA's cost analysis of
  the JAX forward (XLA also counts BatchNorm, relu and the adds, and no
  padded taps).
"""

import contextlib
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
from distributed_tensorflow_ibm_mnist_tpu.models import resnet as jax_resnet
from distributed_tensorflow_ibm_mnist_tpu.utils.flops import compiled_flops
from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_resnet, resnet_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps
from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import ARCHS as PORT_ARCHS
from distributed_tensorflow_ibm_mnist_tpu_torch.models.resnet import same_pads
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import flops
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig, get_preset

torch.set_num_threads(1)

ATOL = 1e-4        # float32 logits and parameters: reduction order
STATS_ATOL = 1e-5  # float32 running statistics
BF16_REL = 2e-2    # bf16 logits, relative to the largest |logit|

# name -> (JAX ResNet keywords, the port's load_resnet keywords, image size)
ARCHS = {
    "resnet20-32px": (dict(stage_sizes=(3, 3, 3), block=jax_resnet.BasicBlock, width=16),
                      dict(arch="resnet20"), 32),
    "resnet20-15px": (dict(stage_sizes=(3, 3, 3), block=jax_resnet.BasicBlock, width=16),
                      dict(arch="resnet20"), 15),
    "resnet50w8-32px": (dict(stage_sizes=(3, 4, 6, 3), block=jax_resnet.BottleneckBlock,
                             width=8), dict(arch="resnet50", width=8), 32),
    "resnet50w8-stem7-32px": (dict(stage_sizes=(3, 4, 6, 3),
                                   block=jax_resnet.BottleneckBlock, width=8,
                                   low_res=False),
                              dict(arch="resnet50", width=8, low_res=False), 32),
    "resnet50w8-stem7-15px": (dict(stage_sizes=(3, 4, 6, 3),
                                   block=jax_resnet.BottleneckBlock, width=8,
                                   low_res=False),
                              dict(arch="resnet50", width=8, low_res=False), 15),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _images(size, seed=1, n=2):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _redraw_bn(params, stats, seed=2):
    """BatchNorm scale/bias and running mean/var from a numpy seed, so the
    normalisation is no identity."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        p, s = dict(p), dict(s)
        for name in list(s):
            if "mean" in s[name]:  # a BatchNorm: (scale, bias) and (mean, var)
                n = s[name]["mean"].shape
                p[name] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                           "bias": rng.normal(0, 0.2, n).astype(np.float32)}
                s[name] = {"mean": rng.normal(0, 0.2, n).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            else:
                p[name], s[name] = walk(p[name], s[name])
        return p, s

    return walk(params, stats)


@functools.cache
def _jax_setup(name, dtype="float32"):
    """The JAX model, its (redrawn) params and batch_stats as numpy."""
    kw, _, size = ARCHS[name]
    model = jax_resnet.ResNet(dtype=getattr(jnp, dtype), **kw)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    params, stats = _redraw_bn(_np(variables["params"]), _np(variables["batch_stats"]))
    return model, params, stats


def _resnet_kw(name):
    """The port's ResNet keywords for ``name`` (what resnet_state_dict reads)."""
    kw = dict(ARCHS[name][1])
    return {**PORT_ARCHS[kw.pop("arch")], **kw, "in_channels": 3}


def _port(name, params, stats, dtype=torch.float32):
    _, port_kw, _ = ARCHS[name]
    return load_resnet(params, stats, device="cpu", dtype=dtype, in_channels=3, **port_kw)


@pytest.mark.parametrize("n, k, s", [(28, 3, 2), (32, 3, 2), (15, 3, 2), (32, 7, 2),
                                     (16, 3, 2), (7, 1, 2), (14, 3, 1), (9, 7, 2)])
def test_same_pads_are_xlas(n, k, s):
    assert same_pads(n, k, s) == jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_eval_logits_match_jax_float32(name):
    model, params, stats = _jax_setup(name)
    x = _images(ARCHS[name][2])
    want = np.asarray(model.apply({"params": params, "batch_stats": stats}, x, train=False))
    got = _port(name, params, stats)(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet20-32px", "resnet50w8-32px"])
def test_eval_logits_match_jax_bf16(name):
    _, params, stats = _jax_setup(name)
    model = _jax_setup(name, "bfloat16")[0]
    x = _images(ARCHS[name][2])
    want = np.asarray(model.apply({"params": params, "batch_stats": stats}, x, train=False))
    got = _port(name, params, stats, torch.bfloat16)(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


# the training-mode checks: ResNet-20 in float32, ResNet-50 in float64
# (module docstring), each with its (logit or parameter, statistic) tolerance
TRAIN_DTYPE = {"resnet20-32px": "float32", "resnet20-15px": "float32",
               "resnet50w8-32px": "float64", "resnet50w8-stem7-32px": "float64",
               "resnet50w8-stem7-15px": "float64"}
TRAIN_TOL = {"float32": (ATOL, STATS_ATOL), "float64": (1e-9, 1e-9)}
# a train step's parameters in float64: both models hand the loss float32
# logits (flax's astype(float32)), so the gradients carry float32 rounding,
# which the small-batch BatchNorms amplify (3.2e-7 seen); an update moves a
# parameter by up to ~0.1
STEP64_ATOL = 1e-6


def _jax64(name):
    """The JAX model in float64 and its params and stats cast to float64
    (run it under jax.enable_x64)."""
    _, params, stats = _jax_setup(name)
    cast = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64))
    return jax_resnet.ResNet(dtype=jnp.float64, **ARCHS[name][0]), cast(params), cast(stats)


def _train_port(name):
    """The port's model in the case's training dtype."""
    _, params, stats = _jax_setup(name)
    if TRAIN_DTYPE[name] == "float32":
        return _port(name, params, stats)
    return _port(name, params, stats, torch.float64).double()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_forward_updates_running_stats_as_flax(name):
    dtype = TRAIN_DTYPE[name]
    tol, stats_tol = TRAIN_TOL[dtype]
    x = _images(ARCHS[name][2], n=4).astype(dtype)
    if dtype == "float32":
        model, params, stats = _jax_setup(name)
        x64 = contextlib.nullcontext
    else:
        model, params, stats = _jax64(name)
        x64 = functools.partial(jax.enable_x64, True)
    with x64():
        want, mutated = model.apply({"params": params, "batch_stats": stats}, x, train=True,
                                    mutable=["batch_stats"])
        mutated = _np(mutated["batch_stats"])
    port = _train_port(name)
    got = port(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol)
    before = resnet_state_dict(params, stats, _resnet_kw(name))
    want_sd = resnet_state_dict(params, mutated, _resnet_kw(name))
    got_sd = port.state_dict()
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys and len(keys) == len([k for k in got_sd if "running" in k])
    for key in keys:
        assert got_sd[key].dtype == want_sd[key].dtype
        assert not torch.equal(got_sd[key], before[key]), key
        np.testing.assert_allclose(got_sd[key].numpy(), want_sd[key].numpy(),
                                   atol=stats_tol, err_msg=key)


STEP_CASES = {
    "momentum-wd": dict(optimizer="momentum", lr=0.1, weight_decay=1e-4),
    "momentum-wd-accum2": dict(optimizer="momentum", lr=0.1, weight_decay=1e-4,
                               grad_accum=2),
}


@pytest.mark.parametrize("name", ["resnet20-32px", "resnet50w8-32px"])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(name, case):
    """One make_train_step update (momentum + weight decay, as presets 4-5
    train): loss, every parameter and every running statistic, against the
    JAX step in float64.  That is the reference for the float32 port too:
    JAX's own float32 step moves ResNet-20's stem by up to 7.6e-4 off its
    float64 step at batch 4 (the stem BatchNorm's gradient sums 4096
    terms), where the port's float32 step stays within 5e-7 of it.  With
    ``grad_accum`` the statistics thread through the microbatches in
    order, as JAX's scan carries them."""
    kw = dict(STEP_CASES[case])
    accum = kw.pop("grad_accum", 1)
    dtype = TRAIN_DTYPE[name]
    tol, stats_tol = TRAIN_TOL[dtype]
    if dtype == "float64":
        tol = STEP64_ATOL
    x = _images(ARCHS[name][2], n=4)
    labels = np.array([1, 7, 3, 0], np.int32)
    model, params, stats = _jax64(name)
    with jax.enable_x64(True):
        tx = jax_make_optimizer(JaxRunConfig(**kw), 10)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params),
                               rng=jax.random.PRNGKey(0))
        new, jm = jax.jit(jax_steps.make_train_step(model, tx, grad_accum=accum))(
            jstate, {"image": jnp.asarray(x, jnp.float64), "label": jnp.asarray(labels)})
        new_params, new_stats, jloss = _np(new.params), _np(new.batch_stats), float(jm["loss"])

    port = _train_port(name)
    opt = make_optimizer(RunConfig(**kw), 10, list(port.parameters()))
    state = TrainState(step=0, model=port, optimizer=opt, data_generator=torch.Generator())
    m = steps.make_train_step(port, opt, grad_accum=accum)(
        state, {"image": torch.from_numpy(x.astype(dtype)), "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(m["loss"]), jloss, atol=1e-5, rtol=1e-5)
    want = resnet_state_dict(new_params, new_stats, _resnet_kw(name))
    got = port.state_dict()
    assert set(got) == set(want)
    for key in want:
        t = stats_tol if key.endswith(("running_mean", "running_var")) else tol
        np.testing.assert_allclose(got[key].double().numpy(), want[key].numpy(), atol=t,
                                   err_msg=key)


def test_converter_is_strict_over_both_trees():
    _, params, stats = _jax_setup("resnet20-32px")
    kw = _resnet_kw("resnet20-32px")
    missing = {**stats, "stem_bn": {"mean": stats["stem_bn"]["mean"]}}
    with pytest.raises(ValueError, match="batch_stats/stem_bn/var"):
        resnet_state_dict(params, missing, kw)
    extra = {**stats, "stem_bn": {**stats["stem_bn"], "count": np.zeros(16, np.float32)}}
    with pytest.raises(ValueError, match="batch_stats/stem_bn/count"):
        resnet_state_dict(params, extra, kw)
    bad = {**params, "stem": {"kernel": np.zeros((3, 3, 1, 16), np.float32)}}
    with pytest.raises(ValueError, match="params/stem/kernel"):
        resnet_state_dict(bad, stats, kw)


@pytest.mark.parametrize("bad, error, match", [
    (dict(axis_name="data"), ValueError, "launch.torchrun"),
    (dict(block_remat=True), NotImplementedError, "ROADMAP.md queue 1"),
], ids=["axis_name", "block_remat"])
def test_model_refuses_what_the_port_lacks(bad, error, match):
    """``block_remat`` is not ported; cross-replica BatchNorm
    (``axis_name``) is, and without a process group it asks for one."""
    with pytest.raises(error, match=match):
        get_model("resnet20", device="cpu", **bad)


def _bn_buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


@pytest.mark.parametrize("preset, kw", [
    ("fashion_resnet20_dp32", dict(dp=1, n_train=256, n_test=64, batch_size=64)),
    ("cifar_resnet50_dp32", dict(dp=1, grad_accum=4, n_train=32, n_test=16,
                                 batch_size=32, eval_batch_size=16)),
], ids=["resnet20", "resnet50"])
def test_trainer_trains_the_preset_on_the_cpu(preset, kw):
    """The single-chip form of presets 4 and 5 (dp=1; ResNet-50 also
    grad_accum=4), at full width on toy data: one epoch
    with a finite loss and moved running statistics; measure_throughput
    leaves the BatchNorm buffers bit-identical."""
    cfg = get_preset(preset).replace(epochs=1, synthetic=True, quiet=True,
                                     target_accuracy=None, **kw)
    trainer = Trainer(cfg, device="cpu")
    init = _bn_buffers(trainer.model)
    summary = trainer.fit()
    assert summary["epochs_run"] == 1 and np.isfinite(trainer.history[0]["train_loss"])
    after_fit = _bn_buffers(trainer.model)
    moved = [k for k in init if not torch.equal(init[k], after_fit[k])]
    assert moved and all(torch.isfinite(after_fit[k]).all() for k in moved)
    tp = trainer.measure_throughput(epochs=1)
    assert np.isfinite(tp["last_loss"])
    after = _bn_buffers(trainer.model)
    assert all(torch.equal(after[k], after_fit[k]) for k in after)


@pytest.mark.parametrize("name, shape, kw", [
    ("resnet20", (28, 28, 1), {}),
    ("resnet50", (32, 32, 3), {}),
    ("resnet50", (64, 64, 3), {"low_res": False}),
], ids=["resnet20-28px", "resnet50-32px", "resnet50-7x7stem-64px"])
def test_forward_flops_match_xla_cost_analysis(name, shape, kw):
    """The full-width forward of one image: the analytic count against XLA's
    (ResNet-20: 62.04 M against 58.86 M; ResNet-50: 2.596 G against 2.554 G;
    its 7x7/2 stem at 64 px: 0.667 G against 0.657 G).
    The training count is 3x this."""
    model = jax_get_model(name, **kw)
    x = jax.ShapeDtypeStruct((1, *shape), jnp.float32)
    variables = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x), x)
    want = compiled_flops(jax.jit(lambda v, x: model.apply(v, x, train=False)), variables, x)
    got = flops.resnet_forward_flops(name, shape, 10, **kw)
    assert abs(got / want - 1) <= 0.07, (got, want)
    assert flops.model_flops_per_image(name, kw, 10, 0, image_shape=shape) == 3 * got
