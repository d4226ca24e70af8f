"""Whisper fine-tuning on one card: teacher-forced cross-entropy over
(mel, token) pairs, AdamW with a linear warmup and a cosine decay, and
clipping by the global gradient norm.

Counterpart of ``audio_rag_tpu/training/train.py``: the same
:class:`TrainConfig` fields and defaults, the same :func:`loss_fn` (encode →
cross K/V → teacher-forced decoder → f32 log-softmax → masked mean NLL), and
:func:`make_optimizer` reproduces its optax chain,
``chain(clip_by_global_norm(grad_clip), adamw(warmup_cosine_decay_schedule(
0, lr, warmup, 10_000), weight_decay))``:

* the clip is optax's, g·max_norm/‖g‖ once ‖g‖ ≥ max_norm (not
  ``clip_grad_norm_``, which adds 1e-6 to the norm);
* AdamW (b1 0.9, b2 0.999, eps 1e-8, decay on every leaf, as optax's
  ``mask=None``) is ``torch.optim.AdamW`` with the schedule as a
  ``LambdaLR`` read at the count before the step, as optax reads it: the
  first update has learning rate 0 and leaves the parameters as they were.

Gradients pass through the flash kernel (``ops/kernels.FlashAttentionFn``)
and the bf16 tensor-core matmuls (``models/layers.MmOutF32``); a step runs
its forward and its backward under :func:`device.full_f32`, so that neither
f32 matmuls nor the convolutions' backward take TF32.

Departures: one card and no mesh, so the tensor-parallel layout
(``whisper_param_spec``) is not exported; it waits for a port of
``parallel/mesh.py``. Parameters are leaf tensors updated in place, and
``run`` hands back the same dict, where the JAX step returns new arrays.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from audio_rag_tpu_torch.device import full_f32, resolve_device
from audio_rag_tpu_torch.models.whisper import (
    WhisperDims,
    decoder_forward,
    encode,
    precompute_cross_kv,
)

__all__ = ["TrainConfig", "loss_fn", "warmup_cosine_decay", "Optimizer",
           "OptState", "make_optimizer", "init_train_state",
           "make_train_step"]

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    warmup_steps: int = 100
    grad_clip: float = 1.0
    dtype: torch.dtype = torch.float32


def loss_fn(
    params: Params,
    dims: WhisperDims,
    mel: torch.Tensor,  # (B, n_mels, T)
    tokens: torch.Tensor,  # (B, S) teacher-forced input
    targets: torch.Tensor,  # (B, S) next-token labels
    mask: torch.Tensor,  # (B, S) 1 where the label counts
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    enc = encode(params, dims, mel, dtype=dtype)
    ckv = precompute_cross_kv(params, dims, enc, dtype=dtype)
    logits, _ = decoder_forward(params, dims, tokens, ckv, dtype=dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def warmup_cosine_decay(count: int, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value)(count)``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    from ``peak_value`` to ``end_value`` over the remaining
    ``decay_steps - warmup_steps`` counts, ``end_value`` after them."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    if count < warmup_steps:
        frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    t = min(count - warmup_steps, span)
    cosine = 0.5 * (1 + math.cos(math.pi * t / span))
    return peak_value * ((1 - alpha) * cosine + alpha)


def _leaves(params: Params) -> list[torch.Tensor]:
    out = []
    for key in sorted(params):
        v = params[key]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


class OptState(NamedTuple):
    adamw: torch.optim.AdamW
    #: its ``last_epoch`` is optax's ``count``: the updates applied so far
    schedule: torch.optim.lr_scheduler.LambdaLR


#: optax.adamw's moment decays and epsilon
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The JAX trainer's optax chain over a tree of leaf tensors: global
    norm clip, then AdamW at the warmup-cosine learning rate."""

    learning_rate: float
    weight_decay: float
    warmup_steps: int
    decay_steps: int = 10_000
    end_value: float = 0.0
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(count, 0.0, self.learning_rate,
                                   self.warmup_steps, self.decay_steps,
                                   self.end_value)

    def init(self, params: Params) -> OptState:
        # lr 1.0 scaled by the schedule's value: LambdaLR sets each step's
        # rate to exactly the schedule at the count before the step
        adamw = torch.optim.AdamW(
            _leaves(params), lr=1.0, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
            weight_decay=self.weight_decay)
        return OptState(adamw, torch.optim.lr_scheduler.LambdaLR(
            adamw, self.schedule))

    def clip(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """optax's ``clip_by_global_norm`` in place: each gradient becomes
        g / ‖g‖ · max_norm where ‖g‖ ≥ max_norm (no host sync); returns
        ‖g‖."""
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads])
                          .sum())
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        return norm

    @torch.no_grad()
    def update(self, params: Params, state: OptState) -> None:
        """One update from the leaves' ``.grad``: clip, AdamW, then the
        schedule's count."""
        self.clip([p.grad for p in _leaves(params)])
        state.adamw.step()
        state.schedule.step()


def make_optimizer(cfg: TrainConfig, decay_steps: int = 10_000,
                   end_value: float = 0.0) -> Optimizer:
    """The JAX ``make_optimizer``'s chain; ``decay_steps`` and
    ``end_value`` are the schedule's (``scripts/train_asr.py`` decays to
    ``LR·0.05`` over its own step count)."""
    return Optimizer(cfg.learning_rate, cfg.weight_decay, cfg.warmup_steps,
                     decay_steps, end_value, cfg.grad_clip)


def init_train_state(params: Params, cfg: TrainConfig, dims: WhisperDims,
                     device: str | torch.device = "cuda",
                     opt: Optimizer | None = None
                     ) -> tuple[Params, Optimizer, OptState]:
    """(params, optimizer, its state): every leaf of ``params`` (numpy
    arrays or tensors, ``init_whisper``'s layout) copied to ``device`` as
    an f32 leaf tensor that requires grad. ``opt`` defaults to
    :func:`make_optimizer` of ``cfg``."""
    dev = resolve_device(device)

    def leaf(x):
        t = (x.detach() if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x, np.float32)))
        return t.to(dev, torch.float32).clone().requires_grad_(True)

    def place(tree):
        return {k: place(v) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}

    placed = place(params)
    opt = opt or make_optimizer(cfg)
    return placed, opt, opt.init(placed)


def make_train_step(dims: WhisperDims, cfg: TrainConfig, opt: Optimizer
                    ) -> Callable[[Params, OptState, dict],
                                  tuple[Params, OptState, torch.Tensor]]:
    """``run(params, opt_state, batch) → (params, opt_state, loss)``: one
    step on ``batch`` ({"mel", "tokens", "targets", "mask"}, arrays or
    tensors, moved to the parameters' device). The loss is a 0-d tensor on
    the device (reading it waits for the step)."""

    def run(params: Params, opt_state: OptState, batch: dict):
        leaves = _leaves(params)
        dev = leaves[0].device
        mel, tokens, targets, mask = (
            torch.as_tensor(batch[k]).to(dev)
            for k in ("mel", "tokens", "targets", "mask"))
        opt_state.adamw.zero_grad(set_to_none=True)
        with full_f32(dev):
            loss = loss_fn(params, dims, mel, tokens, targets, mask,
                           cfg.dtype)
            loss.backward()
        opt.update(params, opt_state)
        return params, opt_state, loss.detach()

    return run
