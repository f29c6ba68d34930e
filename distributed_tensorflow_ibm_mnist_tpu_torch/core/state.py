"""Train state of the port.

The JAX package threads one immutable pytree (step, params, batch_stats,
opt_state, rng) through its compiled step.  PyTorch runs eagerly and
updates in place, so here the state is a small mutable record: the step
count, the model (its parameters, and its buffers: the BatchNorm running
statistics, JAX's ``batch_stats``), the optimizer (its count and moments)
and the explicit random generators (the model's own generator, which its
dropout draws from, and the generator of the epoch permutations).
``snapshot`` / ``restore`` copy all of it on the device, for a caller that
must leave training undisturbed; ``state_dict`` / ``load_state_dict`` are
its save form (utils/checkpoint.py), keyed by parameter and buffer NAME,
not by position, and loaded strictly (every name, every shape).  Under the ZeRO-1 sharded update the
optimizer is this rank's sharded one: its count and its 1/N moments are
what the snapshot carries (its parameter shards are copied from the
model's parameters at every step, so they need no copy of their own).
A sharded run (ZeRO-3, expert parallelism) carries its ``plan``
(``parallel.fsdp.ShardPlan``): the snapshot copies the plan's masters, the
save form holds every leaf and moment gathered whole (a collective: every
rank calls it), the replicated form, and loading gives each rank its
block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import Optimizer


@dataclass
class TrainState:
    """Everything needed to continue training."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    data_generator: torch.Generator
    plan: Any = None  # parallel.fsdp.ShardPlan of a sharded run

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def generators(self) -> list[torch.Generator]:
        gens = [self.data_generator]
        model_gen = getattr(self.model, "generator", None)
        if model_gen is not None:
            gens.append(model_gen)
        return gens

    def param_count(self) -> int:
        if self.plan is not None:
            return self.plan.numel()
        return sum(p.numel() for p in self.model.parameters())

    @torch.no_grad()
    def snapshot(self) -> dict:
        """Device copies of the parameters, the model's buffers and the
        optimizer state, with the step and every generator's state."""
        snap = {"step": self.step,
                "params": [p.clone() for p in self.params],
                "buffers": [b.clone() for b in self.model.buffers()],
                "optimizer": self.optimizer.state(),
                "generators": [g.get_state() for g in self.generators]}
        if self.plan is not None:
            snap["masters"] = [m.clone() for m in self.plan.masters]
        return snap

    def state_dict(self, optimizer: dict | None = None) -> dict:
        """The save form: ``step``; ``params`` and ``buffers`` as ``{name:
        tensor}``; ``optimizer`` (``Optimizer.state_dict`` over the
        parameter names, or the caller's form, e.g. the ZeRO-1 buckets
        gathered whole); ``generators``: the data and model generators'
        states (``"model"`` absent for a model without one).  Tensors are
        the live ones; a caller that keeps them past the next step copies
        them (``utils.checkpoint.snapshot_to_host``)."""
        plan = self.plan
        if plan is not None:  # every leaf and moment gathered whole
            if optimizer is None:
                optimizer = {"count": self.optimizer.count,
                             **plan.whole_moments(self.optimizer)}
            params = dict(zip(plan.names, plan.whole(plan.masters)))
        else:
            if optimizer is None:
                optimizer = self.optimizer.state_dict(
                    [n for n, _ in self.model.named_parameters()])
            params = {n: p.detach() for n, p in self.model.named_parameters()}
        return {"step": self.step, "params": params,
                "buffers": dict(self.model.named_buffers()),
                "optimizer": optimizer, "generators": self.generator_states()}

    def generator_states(self) -> dict:
        """``{"data": state}``, plus ``"model"`` for a model with a generator."""
        gens = {"data": self.data_generator.get_state()}
        model_gen = getattr(self.model, "generator", None)
        if model_gen is not None:
            gens["model"] = model_gen.get_state()
        return gens

    @torch.no_grad()
    def load_state_dict(self, state: dict, optimizer: bool = True) -> None:
        """Load :meth:`state_dict`'s form strictly: the parameter and buffer
        names must be this model's, every shape must match (``ValueError``
        naming the entry otherwise).  Generator states are optional (a
        converted JAX state has none): absent ones are left as they are.  ``optimizer=False`` leaves the
        optimizer to the caller (the ZeRO-1 form)."""
        plan = self.plan
        if plan is not None:  # the whole form: each rank takes its block
            names = plan.names
            missing, extra = set(names) - set(state["params"]), set(state["params"]) - set(names)
            if missing or extra:
                raise ValueError(
                    f"params: the saved state does not match this model (missing "
                    f"{sorted(missing)[:4]}, unexpected {sorted(extra)[:4]})")
            if optimizer:
                plan.load_moments(self.optimizer, state["optimizer"])
            plan.load_whole(state["params"])
            state = {**state, "params": {}}
            live = {"params": {}, "buffers": dict(self.model.named_buffers())}
        else:
            live = {"params": dict(self.model.named_parameters()),
                    "buffers": dict(self.model.named_buffers())}
        for key, tensors in live.items():
            saved = state[key]
            if set(saved) != set(tensors):
                raise ValueError(
                    f"{key}: the saved state does not match this model (missing "
                    f"{sorted(set(tensors) - set(saved))[:4]}, unexpected "
                    f"{sorted(set(saved) - set(tensors))[:4]})")
            for name, dst in tensors.items():
                if tuple(saved[name].shape) != tuple(dst.shape):
                    raise ValueError(f"{key}/{name}: saved shape {tuple(saved[name].shape)},"
                                     f" expected {tuple(dst.shape)}")
        if optimizer and plan is None:  # checks every moment before it copies one
            self.optimizer.load_state_dict(state["optimizer"], list(live["params"]))
        for key, tensors in live.items():
            for name, dst in tensors.items():
                dst.copy_(state[key][name])
        self.step = int(state["step"])
        gens = state.get("generators", {})  # absent in a converted JAX state
        if "data" in gens:
            self.data_generator.set_state(gens["data"])
        model_gen = getattr(self.model, "generator", None)
        if model_gen is not None and "model" in gens:
            model_gen.set_state(gens["model"])

    @torch.no_grad()
    def restore(self, snap: dict) -> None:
        self.step = snap["step"]
        for p, saved in zip(self.params, snap["params"]):
            p.copy_(saved)
        for b, saved in zip(self.model.buffers(), snap["buffers"]):
            b.copy_(saved)
        self.optimizer.load_state(snap["optimizer"])
        for m, saved in zip(self.plan.masters if self.plan is not None else (),
                            snap.get("masters", ())):
            m.copy_(saved)
        for g, s in zip(self.generators, snap["generators"]):
            g.set_state(s)
