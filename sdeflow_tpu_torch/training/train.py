"""Training: the Adam step over the SSM or DSM loss and the host-side loop.

Port of sdeflow_tpu/training/train.py. One train step is the loss of a data
batch (SSM: for MSGM the 64-step forward RK4 solve of kernel K2 and the one
JVP of the score net; DSM, SGM only: the closed-form kernel and one forward
of the score net), ``.backward()``, and the optimizer's update. The JAX
package returns a new state from a jitted step; here the step updates the
score net's parameters, the optimizer and the state in place and returns
the state. Eager PyTorch has no dispatch to amortize, so the Trainer takes
one step at a time (the JAX package's ``steps_per_dispatch`` has no
counterpart); ``make_train_chunk`` is the loop of n such steps with the
data drawn on the device. The Trainer keeps the JAX Trainer's on-disk
checkpoints (a rolling one at the print cadence, a tagged one at each
``save_every`` multiple, resumed from when present; training/checkpoint.py).
The sharded trainer (``mesh``) comes with ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch

from sdeflow_tpu_torch.eval.elbo import evaluate
from sdeflow_tpu_torch.ops.rng import fold_in
from sdeflow_tpu_torch.training.checkpoint import (
    checkpoint_exists, load_checkpoint, save_checkpoint)


@dataclass
class TrainState:
    """What a train step updates: the generative SDE (its score net holds
    the parameters), the number of steps taken and the EMA parameters
    (None without ema_rate)."""

    gen_sde: Any
    step: int = 0
    ema_params: Optional[dict] = None

    @property
    def params(self):
        return dict(self.gen_sde.score_net.named_parameters())


def ema_rate_at(ema_rate, step, warmup=True):
    """EMA decay at update number `step` (1-based): min(rate, (1+n)/(10+n))
    with warmup, else the rate."""
    if not warmup:
        return ema_rate
    return min(ema_rate, (1.0 + step) / (10.0 + step))


@torch.no_grad()
def update_ema(target_params, source_params, rate=0.99):
    """target ← rate·target + (1−rate)·source, over dicts of tensors;
    returns a new dict."""
    return {k: rate * t + (1.0 - rate) * source_params[k]
            for k, t in target_params.items()}


class _AdamChain(torch.optim.AdamW):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(linear warmup
    schedule, weight_decay)) as one torch optimizer; AdamW with
    weight_decay 0 is Adam."""

    def __init__(self, params, lr, grad_clip, weight_decay, lr_warmup_steps):
        super().__init__(params, lr=lr, weight_decay=weight_decay)
        self.peak_lr = lr
        self.grad_clip = grad_clip
        self.lr_warmup_steps = lr_warmup_steps
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if self.grad_clip is not None and grads:
            # optax: where(‖g‖ < c, g, (g / ‖g‖)·c), without a host sync
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, (g / norm) * self.grad_clip))
        if self.lr_warmup_steps:
            lr = (self.peak_lr * min(self.count, self.lr_warmup_steps)
                  / self.lr_warmup_steps)
            for group in self.param_groups:
                group["lr"] = lr
        self.count += 1
        return super().step(closure)

    def state_dict(self):
        return dict(super().state_dict(), count=self.count)

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count")
        super().load_state_dict(state_dict)


def build_optimizer(params, lr, grad_clip=None, weight_decay=0.0,
                    lr_warmup_steps=0):
    """The optimizer of the JAX package's knobs over `params`. With the
    defaults it is bare ``torch.optim.Adam(lr)`` (β 0.9/0.999, ε 1e-8),
    which is optax.adam; clipping by global norm, AdamW's decoupled weight
    decay and a linear warmup from 0 behave as their optax counterparts."""
    params = list(params)
    if grad_clip is None and weight_decay == 0.0 and lr_warmup_steps == 0:
        return torch.optim.Adam(params, lr=lr)
    return _AdamChain(params, lr, grad_clip, weight_decay, lr_warmup_steps)


def _loss_fn(loss):
    """The mean of the reverse SDE's per-sample loss "ssm" or "dsm"."""
    if loss not in ("ssm", "dsm"):
        raise ValueError(f"unknown loss {loss}")
    return lambda gen, generator, x, draws: getattr(gen, loss)(
        generator, x, **draws).mean()


def make_train_step(optimizer, loss="ssm", ema_rate=None, ema_warmup=True):
    """A train step ``(state, generator, x, **draws) -> (state, loss)`` over
    the parameters `optimizer` holds; `draws` inject the loss's draws
    (SSM: t, noise, noise_one, v; DSM: t, noise). The loss comes back as a
    0-d device tensor, so the step does not wait for the device."""
    loss_fn = _loss_fn(loss)

    def train_step(state, generator, x, **draws):
        optimizer.zero_grad(set_to_none=True)
        value = loss_fn(state.gen_sde, generator, x, draws)
        value.backward()
        optimizer.step()
        state.step += 1
        if ema_rate is not None:
            state.ema_params = update_ema(
                state.ema_params, state.params,
                ema_rate_at(ema_rate, state.step, ema_warmup))
        return state, value.detach()

    return train_step


def make_train_chunk(optimizer, sample_fn, batch_size, loss="ssm",
                     ema_rate=None, ema_warmup=True):
    """``chunk(state, generator, num_steps) -> (state, last_loss)``: that
    many train steps, each on a batch ``sample_fn(generator, batch_size)``
    drawn on the device, with no host synchronisation between them."""
    step = make_train_step(optimizer, loss, ema_rate, ema_warmup)

    def chunk(state, generator, num_steps):
        value = None
        for _ in range(num_steps):
            x = sample_fn(generator, batch_size)
            state, value = step(state, generator, x)
        return state, value

    return chunk


class Trainer:
    """Host-side loop with the JAX Trainer's cadence: loss and ELBO prints
    with ms/step at step 1, every print_every steps and at the end; with a
    checkpoint_path, a rolling checkpoint there at each print and a tagged
    one at ``<checkpoint_path>_<step>`` at each save_every multiple. The
    optimizer is ``build_optimizer``'s over the score net's parameters."""

    def __init__(self, gen_sde, sampler, *, lr=1e-3, batch_size=256,
                 loss="ssm", print_every=10_000, save_every=100_000,
                 checkpoint_path: Optional[str] = None,
                 log_fn: Callable[[str], None] = print, mesh=None,
                 print_ram: bool = False, ema_rate: Optional[float] = None,
                 ema_warmup: bool = True, grad_clip: Optional[float] = None,
                 weight_decay: float = 0.0, lr_warmup_steps: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "sharded training (mesh): ROADMAP Queue 1 item 14")
        if print_ram:
            raise NotImplementedError("print_ram: ROADMAP Queue 1 item 15")
        net = gen_sde.score_net
        low = sorted({str(p.dtype) for p in net.parameters()
                      if p.dtype in (torch.bfloat16, torch.float16)})
        if low:
            raise ValueError(
                f"score-net parameters in {low}: parameters, Adam moments "
                "and the EMA stay float32 (a bf16 compute dtype casts them "
                "at each use, models/unet2d.py)")
        self.optimizer = build_optimizer(
            net.parameters(), lr, grad_clip=grad_clip,
            weight_decay=weight_decay, lr_warmup_steps=lr_warmup_steps)
        self.state = TrainState(gen_sde=gen_sde, ema_params=(
            {k: p.detach().clone() for k, p in net.named_parameters()}
            if ema_rate is not None else None))
        self.sampler = sampler
        self.batch_size = batch_size
        self.print_every = print_every
        self.save_every = save_every
        self.checkpoint_path = checkpoint_path
        self.log_fn = log_fn
        self.train_step = make_train_step(self.optimizer, loss, ema_rate,
                                          ema_warmup)
        self.history = []

    @property
    def ema_gen_sde(self):
        """The generative SDE over a copy of the score net holding the EMA
        parameters."""
        if self.state.ema_params is None:
            raise ValueError("Trainer was built without ema_rate")
        net = copy.deepcopy(self.state.gen_sde.score_net)
        net.load_state_dict(self.state.ema_params, strict=False)
        return replace(self.state.gen_sde, score_net=net)

    def run(self, generator, iterations, x_test=None, resume=True):
        """Train until `iterations` steps are done, first resuming from the
        checkpoint at checkpoint_path when there is one (and `resume`);
        returns (state, last loss). The training draws come from
        `generator`; each ELBO print draws from a stream folded off it, so
        the print cadence does not change the training."""
        start_iter = 0
        path = self.checkpoint_path
        if resume and path and checkpoint_exists(path):
            self.state, generator, start_iter = load_checkpoint(
                path, self.state, generator, self.optimizer)
            self.log_fn(f"Resuming from iteration {start_iter + 1}")
            start_iter += 1
        start_time = time.time()
        loss = None
        steps_since_print = 0
        for i in range(start_iter + 1, iterations + 1):
            x = self.sampler.sample(generator, self.batch_size)
            self.state, loss = self.train_step(self.state, generator, x)
            steps_since_print += 1
            do_print = i == 1 or i % self.print_every == 0 or i == iterations
            do_tag = i % self.save_every == 0
            if do_print:
                g_eval = fold_in(generator, i)
                x_eval = (x_test if x_test is not None else
                          self.sampler.sample(g_eval, self.batch_size))
                with torch.no_grad():
                    elbo, elbo_std = evaluate(self.state.gen_sde, g_eval,
                                              x_eval)
                elapsed = time.time() - start_time
                self.log_fn(
                    "| iter {:6d} | {:5.2f} ms/step | loss {:8.3f} | "
                    "elbo {:8.3f} | elbo std {:8.3f}".format(
                        i, elapsed * 1000 / steps_since_print,
                        float(loss), float(elbo), float(elbo_std)))
                self.history.append(dict(step=i, loss=float(loss),
                                         elbo=float(elbo)))
            if path and (do_print or do_tag):
                save_checkpoint(path, self.state, generator, i - 1,
                                self.optimizer)
                if do_tag:
                    save_checkpoint(f"{path}_{i}", self.state, generator,
                                    i - 1, self.optimizer)
            if do_print:
                start_time = time.time()
                steps_since_print = 0
        return self.state, float(loss) if loss is not None else None
