"""The port's Whisper training against the JAX package's, on the CPU:
``training/train.py``'s loss and its gradient at every leaf
(``jax.value_and_grad`` of the JAX ``loss_fn``, jitted), the optimizer
against the JAX trainer's optax chain (clip, AdamW, warmup-cosine
schedule), and three train steps against the JAX ``make_train_step`` on a
one-CPU mesh.

Tolerances (f32 on both sides; the port sums in other orders than XLA):
the loss within 1e-6 relative; each gradient leaf within 2e-5 of its
largest JAX value (measured: 2.4e-6); the optimizer's parameters within
1e-6 relative to their scale after each of five steps; the schedule
within 1e-5 relative (optax evaluates it in f32, where the warmup's
(0 − peak)·frac + peak cancels to ~2e-6 relative; the port in float64);
after train steps 2 and 3 (step 1's update is zero: the schedule starts
at 0) each parameter within 1e-6 of JAX's, a few thousandths of the
largest step (Adam moves a weight by about the learning rate, 1e-3 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_rag_tpu.models.whisper import WHISPER_PRESETS as JAX_PRESETS
from audio_rag_tpu.models.whisper import init_whisper as jax_init_whisper
from audio_rag_tpu.parallel.mesh import create_mesh
from audio_rag_tpu.training import train as jtrain
from audio_rag_tpu_torch.models.whisper import WHISPER_PRESETS
from audio_rag_tpu_torch.training import train as ttrain
from audio_rag_tpu_torch.weights import _flatten, whisper_params
from torch_llm_common import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-6
GRAD_TOL = 2e-5
PARAM_ATOL = 1e-6


def _batch(dims, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"mel": rng.standard_normal(
                (B, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32),
            "tokens": rng.integers(0, dims.n_vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, dims.n_vocab, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}


def _jax_params(name):
    return jax.tree.map(np.asarray,
                        jax_init_whisper(jax.random.PRNGKey(0),
                                         JAX_PRESETS[name]))


@pytest.fixture(scope="module")
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(jtrain.loss_fn), static_argnums=(1, 6))


@pytest.mark.parametrize("name,B", [("test", 2), ("tiny-synth", 4)])
def test_loss_and_every_gradient_match_jax(jax_value_and_grad, name, B):
    params = _jax_params(name)
    b = _batch(JAX_PRESETS[name], B, 16, seed=1)
    args = (b["mel"], b["tokens"], b["targets"], b["mask"])
    jl, jg = jax_value_and_grad(params, JAX_PRESETS[name], *args,
                                jnp.float32)
    dims = WHISPER_PRESETS[name]
    p = whisper_params(params, dims, "cpu")
    leaves = ttrain._leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = ttrain.loss_fn(p, dims, *(torch.from_numpy(a) for a in args))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = _flatten(jax.tree.map(np.asarray, jg))
    got = _flatten(p)
    assert set(ref) == set(got)
    for key, r in ref.items():
        g = got[key].grad
        assert g is not None, key
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=key)


def _optax_chain(cfg, decay_steps=10_000, end_value=0.0):
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps, decay_steps,
        end_value=end_value)
    return sched, optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip),
        optax.adamw(sched, weight_decay=cfg.weight_decay))


@pytest.mark.parametrize("warmup,decay,end", [(100, 10_000, 0.0),
                                              (30, 300, 1.5e-5)])
def test_schedule_matches_optax(warmup, decay, end):
    cfg = ttrain.TrainConfig(learning_rate=3e-4, warmup_steps=warmup)
    sched, _ = _optax_chain(cfg, decay, end)
    opt = ttrain.make_optimizer(cfg, decay, end)
    for count in (0, 1, warmup // 2, warmup, warmup + 1, decay // 2, decay,
                  10_000, 20_000):
        np.testing.assert_allclose(opt.schedule(count), float(sched(count)),
                                   rtol=1e-5, atol=1e-12,
                                   err_msg=f"count {count}")
    assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clip_matches_optax(scale):
    """Below ``grad_clip`` the gradients pass unchanged; above it each is
    g / ‖g‖ · max_norm, as optax computes it."""
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((3, 5)).astype(np.float32) * scale,
             "b": rng.standard_normal((7,)).astype(np.float32) * scale}
    ref, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    opt = ttrain.make_optimizer(ttrain.TrainConfig())
    got = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    norm = opt.clip([got["a"], got["b"]])
    np.testing.assert_allclose(
        norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for k in grads:
        if scale < 1:
            np.testing.assert_array_equal(got[k].numpy(), grads[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0)


def test_optimizer_matches_optax_over_five_steps():
    """AdamW with decoupled weight decay at the warmup-cosine rate, after
    the global-norm clip, on the same gradients: the parameters after each
    of five steps (step 1 at rate 0 leaves them unchanged)."""
    cfg = ttrain.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                             weight_decay=0.1)
    _, chain = _optax_chain(cfg)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "n": {"b": rng.standard_normal((4,)).astype(np.float32)}}
    state = chain.init(params)
    jp = params
    tp, opt, ost = ttrain.init_train_state(params, cfg, None, "cpu")
    for step in range(5):
        scale = 0.05 if step % 2 else 5.0  # below and above the clip
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32)
            * scale, params)
        updates, state = chain.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, g in zip(ttrain._leaves(tp), ttrain._leaves(grads)):
            t.grad = torch.from_numpy(np.array(g))
        opt.update(tp, ost)
        assert ost.schedule.last_epoch == step + 1  # optax's count
        for key, r in _flatten(jax.tree.map(np.asarray, jp)).items():
            t = _flatten(tp)[key].detach().numpy()
            np.testing.assert_allclose(t, r, rtol=0,
                                       atol=1e-6 * np.abs(r).max(),
                                       err_msg=f"{key} after {step + 1}")
            if step == 0:
                np.testing.assert_array_equal(t, _flatten(params)[key])


def test_three_train_steps_match_jax():
    """Three steps of ``make_train_step`` on the ``test`` preset (B 2),
    port against the JAX step on a one-CPU mesh: the losses, and every
    parameter after steps 2 and 3."""
    name = "test"
    cfg_kw = {"learning_rate": 1e-3, "warmup_steps": 2}
    params = _jax_params(name)
    batches = [_batch(JAX_PRESETS[name], 2, 16, seed=10 + i)
               for i in range(3)]

    mesh = create_mesh(data_axis=1, model_axis=1,
                       devices=jax.devices()[:1])
    jcfg = jtrain.TrainConfig(**cfg_kw)
    jp, jopt, jstate, _ = jtrain.init_train_state(
        params, jcfg, mesh, JAX_PRESETS[name])
    jstep = jtrain.make_train_step(JAX_PRESETS[name], jcfg, mesh, jopt)

    dims = WHISPER_PRESETS[name]
    tcfg = ttrain.TrainConfig(**cfg_kw)
    tp, topt, tstate = ttrain.init_train_state(params, tcfg, dims, "cpu")
    tstep = ttrain.make_train_step(dims, tcfg, topt)
    for i, batch in enumerate(batches):
        jp, jstate, jl = jstep(jp, jstate, batch)
        tp, tstate, tl = tstep(tp, tstate, batch)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"loss of step {i + 1}")
        if i == 0:
            continue
        ref = _flatten(jax.tree.map(np.asarray, jp))
        got = _flatten(tp)
        moved = max(np.abs(ref[k] - _flatten(params)[k]).max() for k in ref)
        assert moved > 1e-4  # the step did move the weights
        for key, r in ref.items():
            np.testing.assert_allclose(got[key].detach().numpy(), r, rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{key} after step {i + 1}")
