"""The port's remat policies.

Each superblock of the training forward runs under
``torch.utils.checkpoint`` where the config's ``remat_policy`` is in
``models.transformer.REMAT_POLICIES``, as the reference's scan body runs
under ``jax.checkpoint``.  Checked here, on the CPU in float32 at the
smoke configs:

- every policy gives the no-remat step bit for bit: the loss, every
  gradient, and the train step's metrics, parameters and moments
  (tolerance 0: a recompute runs the same ops on the same inputs);
- each superblock runs under the checkpoint once, and only in training.

The FLOPs of each policy against the reference's compiled steps are
``tests/test_torch_remat_flops.py``'s.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.parallel import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

ARCHS = ("qwen2.5-3b", "falcon-mamba-7b", "jamba-1.5-large-398b",
         "whisper-base")
POLICIES = tuple(REMAT_POLICIES)            # nothing, dots, dots_no_batch
BITS = ShapeSpec("tiny_bits", 16, 2, "train")      # the bit-for-bit cases
OPT = OptimizerConfig(learning_rate=2e-3, warmup_steps=3, total_steps=20,
                      weight_decay=0.1, clip_norm=0.5)


def _cfg(arch, policy="full"):
    return get_config(arch, smoke=True).replace(dtype="float32",
                                                remat_policy=policy)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The JAX smoke config's initial weights (seed 0) in the port's
    layout, float32."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
    tree = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return params_from_jax(_cfg(arch), jax.tree.map(np.asarray, tree))


def _batch(cfg, shape=BITS):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len + 1,
        global_batch=shape.global_batch, seed=0))
    b = {k: torch.as_tensor(v[:, :shape.seq_len])
         for k, v in pipe.batch_at(0).items()}
    if cfg.is_encdec:
        rng = np.random.default_rng(1)
        b["frames"] = torch.as_tensor(rng.standard_normal(
            (shape.global_batch, cfg.encoder_seq, cfg.d_model),
            dtype=np.float32))
    return b


@functools.lru_cache(maxsize=None)
def _run(arch, policy):
    """Loss and gradients of one forward/backward, then one train step:
    its metrics, parameters and moments."""
    cfg = _cfg(arch, policy)
    bundle = build_model(cfg, device="cpu")
    batch = _batch(cfg)
    params = {k: v.clone().requires_grad_() for k, v in
              _weights(arch).items()}
    loss, metrics = bundle.loss(params, batch, impl="ref")
    grads = torch.autograd.grad(loss, list(params.values()))
    step = make_train_step(bundle, make_host_mesh(device="cpu"), BITS, OPT,
                           impl="ref")
    p0 = {k: v.clone() for k, v in _weights(arch).items()}
    state, m = step.fn({"params": p0, "opt": init_opt_state(p0, OPT)},
                       batch)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads, m, state)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policy_is_bit_identical(arch, policy):
    """Tolerance 0: the loss, every aux metric, every gradient and the
    train step's outputs equal the no-remat step's bit for bit."""
    pytest.importorskip("jax")
    loss, metrics, grads, m, state = _run(arch, policy)
    loss0, metrics0, grads0, m0, state0 = _run(arch, "full")
    assert torch.equal(loss, loss0)
    assert sorted(metrics) == sorted(metrics0)
    for k in metrics:
        assert torch.equal(metrics[k], metrics0[k]), k
    assert len(grads) == len(grads0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(m[k], m0[k]), k
    assert torch.isfinite(m["grad_norm"])
    for part in ("params",):
        for k in state0[part]:
            assert torch.equal(state[part][k], state0[part][k]), k
    for mom in ("m", "v"):
        for k in state0["opt"][mom]:
            assert torch.equal(state["opt"][mom][k],
                               state0["opt"][mom][k]), (mom, k)


def test_remat_runs_superblocks_under_checkpoint(monkeypatch):
    """Under "nothing" the training forward calls the checkpoint once a
    superblock (jamba's smoke width at 16 layers: 2 superblocks of 8); under
    "full" never, and never in a serving call."""
    import repro_torch.models.transformer as tr
    calls = []
    real = tr.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(tr, "checkpoint", counting)
    cfg = get_config("jamba-1.5-large-398b", smoke=True).replace(
        dtype="float32", n_layers=16)
    assert cfg.n_superblocks == 2
    bundle = build_model(cfg, device="cpu")
    params = {k: v.requires_grad_() for k, v in
              bundle.init(0).state_dict().items()}
    bundle.loss(params, _batch(cfg), impl="ref")
    assert len(calls) == cfg.n_superblocks
    calls.clear()
    build_model(cfg.replace(remat_policy="full"), device="cpu").loss(
        params, _batch(cfg), impl="ref")
    assert calls == []
    model = bundle.init(0)
    model.prefill(_batch(cfg)["tokens"][:, :8],
                  bundle.make_cache(BITS.global_batch, 8), impl="ref")
    assert calls == []
