"""Training substrate (port of ``repro.train.loop``): the train-step
factory (AdamW, per-layer remat, optional microbatch gradient
accumulation) and a simple host loop.

NetFuse training mode (the paper's section 6, "applicability on training
models"): with M > 1 merged instances one step trains M models at once.
The loss averages the per-instance cross-entropies (each instance sees
its own data stream) and every op is local to its instance's weights,
so gradients stay inside each instance; the one coupling is AdamW's
global clip norm (``optim/adamw.py``).

The parameters are a trainable ``MergedParams`` (``api.init(...,
train=True)`` or ``common.training_params``): f32 master weights, cast to
the activation dtype inside each layer.  A step runs ``loss.backward()``
and updates the parameters in place.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import api
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Any       # a trainable MergedParams
    opt: Any          # optim.OptState


def _grads(params) -> dict:
    """The gradient tree; a parameter that backward left without one is an
    error (its output was cut off the graph, e.g. by a kernel launched
    without a backward)."""
    missing = [name for name, p in params.named_parameters() if p.grad is None]
    if missing:
        raise RuntimeError(f"no gradient reached {len(missing)} parameters: {missing[:8]}")
    return params.tree("grad")


def make_train_step(cfg, *, lr_schedule: Callable, weight_decay: float = 0.1,
                    max_grad_norm: float = 1.0, microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics): loss and
    gradients, then one AdamW step at ``lr_schedule(step)``.  With
    ``microbatches`` > 1 each instance's batch splits into that many
    slices along B (every batch leaf: tokens, labels, vlm's
    ``image_embeds``, audio's ``frames``), the gradients are summed over
    them and divided by their count, as the reference does; the metrics
    then hold no nll / aux, as the reference's do not."""

    def train_step(state: TrainState, batch):
        params, opt = state
        params.zero_grad(set_to_none=True)
        if microbatches > 1:
            lsum = 0.0
            for i in range(microbatches):
                sub = {k: v.reshape(v.shape[0], microbatches, -1, *v.shape[2:])[:, i]
                       for k, v in batch.items()}
                l, _ = api.loss_fn(cfg, params, sub)
                l.backward()
                lsum = lsum + l.detach()
            loss = lsum / microbatches
            grads = tree_map(lambda g: g / microbatches, _grads(params))
            metrics = {}
        else:
            loss, metrics = api.loss_fn(cfg, params, batch)
            loss.backward()
            loss = loss.detach()
            grads = _grads(params)
        lr = lr_schedule(opt.step)
        params, opt, opt_metrics = adamw_update(grads, opt, params, lr=lr,
                                                weight_decay=weight_decay,
                                                max_grad_norm=max_grad_norm)
        params.zero_grad(set_to_none=True)
        out = {"loss": loss, "lr": lr, **opt_metrics}
        out.update({k: v.detach() for k, v in metrics.items()})
        return TrainState(params, opt), out

    return train_step


def init_state(cfg, generator: torch.Generator | None = None, device=None) -> TrainState:
    """Fresh trainable parameters drawn from ``generator`` and AdamW's
    zero moments."""
    params = api.init(cfg, generator, device, train=True)
    return TrainState(params, adamw_init(params))


def train_loop(cfg, data, *, steps: int, batch_size: int, seq_len: int, lr_schedule,
               generator: torch.Generator | None = None, device=None, log_every: int = 10,
               state: TrainState | None = None, print_fn=print, max_grad_norm: float = 1.0):
    """Host loop (examples, tests, the CLI).  ``data`` has
    ``batch(step, batch_size, seq_len)`` or is a function of the step;
    its batches move to the parameters' device.  ``max_grad_norm`` is
    AdamW's global clip norm (``math.inf``: no clipping).  Returns
    (state, [(step, loss)] at the logged steps)."""
    if state is None:
        dev = api.resolve_device(device)
        state = init_state(cfg, generator or torch.Generator(device=dev).manual_seed(0), dev)
    dev = next(state.params.parameters()).device
    step_fn = make_train_step(cfg, lr_schedule=lr_schedule, max_grad_norm=max_grad_norm)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = data.batch(step, batch_size, seq_len) if hasattr(data, "batch") else data(step)
        batch = {k: v.to(dev) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            aux = metrics.get("aux") if cfg.family == "moe" else None
            aux = "" if aux is None else f"aux {float(aux):.4f}  "
            print_fn(f"step {step:5d}  loss {loss:.4f}  {aux}lr {float(metrics['lr']):.2e}  "
                     f"gnorm {float(metrics['grad_norm']):.3f}  "
                     f"({time.perf_counter() - t0:.1f}s)")
    return state, losses
