"""The port's training step against the JAX package's, on the CPU.

The same numpy inputs go through both packages: the synthetic pipeline's
batches, the optimizer on a fixed parameter tree, the failure injector on
a cluster, and the dense and SSM smoke configs' loss and gradients, with
the JAX initial weights carried to the port by ``params_from_jax`` and the
JAX optimizer state by ``opt_state_from_jax``.  The port takes the
kernels' plain versions here (CPU tensors); on the card the attention and
scan forwards are the CUDA kernels and their backward this same plain
recompute (``tests/test_torch_train_kernels.py``).

Tolerances (float32):
- pipeline batches, frontend stubs and failure steps: equal, bit for bit
  (both are numpy on the same counters and seeds);
- ``lr_at`` and ``adamw_update``: rtol 1e-6, and for the parameters and
  moments 1e-6 of each leaf's largest magnitude besides (the same float32
  operations in the same order, but XLA may round a fused product and sum
  once: measured 9.3e-10 on a moment of 0.026, where ``b1 * m + (1 - b1)
  * g`` cancels to a small value);
- the loss: rtol 1e-5; every gradient leaf within 1e-4 of its largest
  magnitude (another summation order in every product and in the
  backward's reductions: measured 1e-6 to 1e-5);
- one train step: loss and ce_loss rtol 1e-5, grad_norm rtol 1e-4, lr
  rtol 1e-6; the moments ``m`` and ``v`` within 1e-4 and 2e-4 of each
  leaf's largest magnitude (linear and quadratic in the gradients); the
  updated parameters within 2e-2 of the learning rate of the reference's
  where the first moment is resolved (``|m|`` above 1e-2 of the leaf's
  largest), and within 2 lr everywhere.  AdamW's update is about ``lr *
  m / sqrt(v)``, scale-free: where a gradient is at the two packages'
  summation noise, that ratio is noise too (measured 0.10 lr on a norm
  scale's near-zero entries, 4.7e-3 lr on resolved embedding rows).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.params import Params as ClusterParams
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import (build_model, opt_state_from_jax,
                                params_from_jax, train_state_from_jax)
from repro_torch.parallel import make_train_step
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         global_norm, init_opt_state, lr_at)

torch.set_num_threads(1)

SHAPE = ShapeSpec("tiny_train", 32, 4, "train")
ARCHS = ("qwen2.5-3b", "falcon-mamba-7b")
#: the MoE smoke configs (kimi: shared expert; arctic: dense residual;
#: jamba: attention + Mamba + MoE)
MOE_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: the card's machine has
    no JAX)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.core.params import Params as JaxClusterParams
    from repro.data.pipeline import DataConfig as JaxDataConfig
    from repro.data.pipeline import SyntheticTokenPipeline as JaxPipeline
    from repro.launch.mesh import make_host_mesh as jax_mesh
    from repro.models import build_model as jax_build_model
    from repro.parallel import make_train_step as jax_make_train_step
    from repro.train import optimizer as jopt
    from repro.train.fault_tolerance import FailureInjector as JaxInjector
    return dict(jax=jax, jnp=jax.numpy, get_config=jax_get_config,
                ClusterParams=JaxClusterParams, DataConfig=JaxDataConfig,
                Pipeline=JaxPipeline, mesh=jax_mesh,
                build_model=jax_build_model,
                make_train_step=jax_make_train_step, opt=jopt,
                Injector=JaxInjector)


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=17, global_batch=4, seed=7),
    dict(vocab_size=151936, seq_len=33, global_batch=8, seed=3, n_shards=2,
         shard_id=1)], ids=["small", "sharded"])
def test_pipeline_batches_are_the_references(jx, kw):
    ours = SyntheticTokenPipeline(DataConfig(**kw))
    theirs = jx["Pipeline"](jx["DataConfig"](**kw))
    for step in (0, 1, 5, 123456):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ours.seek(9)
    theirs.seek(9)
    assert ours.state_dict() == theirs.state_dict()
    np.testing.assert_array_equal(next(ours)["tokens"],
                                  next(theirs)["tokens"])


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b",
                                  "qwen2.5-3b"])
def test_frontend_stubs_are_the_references(jx, arch):
    kw = dict(vocab_size=512, seq_len=9, global_batch=2, seed=1)
    ours = SyntheticTokenPipeline(DataConfig(**kw))
    theirs = jx["Pipeline"](jx["DataConfig"](**kw))
    ours.seek(4)
    theirs.seek(4)
    a = ours.with_frontend_stubs(ours.batch_at(4),
                                 get_config(arch, smoke=True))
    b = theirs.with_frontend_stubs(theirs.batch_at(4),
                                   jx["get_config"](arch, smoke=True))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# optimizer and failure injector
# ---------------------------------------------------------------------------

OPT = OptimizerConfig(learning_rate=2e-3, warmup_steps=3, total_steps=20,
                      weight_decay=0.1, clip_norm=0.5)


def test_lr_schedule_is_the_references(jx):
    for cfg in (OPT, OptimizerConfig(learning_rate=1.0, warmup_steps=10,
                                     total_steps=100, min_lr_fraction=0.1)):
        for step in (0, 1, 3, 7, 10, 20, 55, 100, 250):
            want = float(jx["opt"].lr_at(cfg, jx["jnp"].asarray(step)))
            got = float(lr_at(cfg, torch.tensor(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_adamw_update_is_the_references(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    ours = {k: torch.tensor(v) for k, v in params.items()}
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    st_o, st_t = init_opt_state(ours, OPT), jx["opt"].init_opt_state(
        theirs, OPT)
    for i in range(6):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 * (3.0 if i == 2 else 0.2) for k, v in params.items()}
        ours, st_o, s_o = adamw_update(
            ours, {k: torch.tensor(g) for k, g in grads.items()}, st_o, OPT)
        theirs, st_t, s_t = jx["opt"].adamw_update(
            theirs, {k: jnp.asarray(g) for k, g in grads.items()}, st_t,
            OPT)
        assert float(s_o["grad_norm"]) == pytest.approx(
            float(s_t["grad_norm"]), rel=1e-6)
        assert float(s_o["lr"]) == pytest.approx(float(s_t["lr"]), rel=1e-6)
        for k in params:
            for got, want in ((ours[k], theirs[k]), (st_o["m"][k],
                                                     st_t["m"][k]),
                              (st_o["v"][k], st_t["v"][k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()), err_msg=k)
        assert int(st_o["step"]) == int(st_t["step"]) == i + 1
    assert float(global_norm(ours)) == pytest.approx(
        float(jx["opt"].global_norm(theirs)), rel=1e-6)


@pytest.mark.parametrize("case", ["default", "busy", "deterministic"])
def test_failure_injector_draws_the_references_steps(jx, case):
    kw = {"default": {}, "busy": dict(
        job_size=64, working_pool_size=72, spare_pool_size=8,
        warm_standbys=4, random_failure_rate=1.0 / 1440,
        systematic_failure_rate=5.0 / 1440), "deterministic": dict(
            random_failure_rate=0.0, systematic_failure_rate=0.0)}[case]
    det = [3, 11] if case == "deterministic" else None
    ours = FailureInjector(ClusterParams(**kw), 1.0, seed=4,
                           deterministic_steps=det)
    theirs = jx["Injector"](jx["ClusterParams"](**kw), 1.0, seed=4,
                            deterministic_steps=det)
    assert ours.rate_per_step == theirs.rate_per_step
    assert ours.p_systematic == theirs.p_systematic
    for step in list(range(400)) + [3, 11]:
        a, b = ours.check(step), theirs.check(step)
        assert (a is None) == (b is None), step
        if a is not None:
            assert (a.step, a.kind) == (b.step, b.kind)
    assert len(ours.events) == len(theirs.events)


# ---------------------------------------------------------------------------
# loss and gradients, one train step
# ---------------------------------------------------------------------------

def _models(jx, arch):
    jcfg = jx["get_config"](arch, smoke=True).replace(dtype="float32")
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jbundle = jx["build_model"](jcfg)
    jparams = jbundle.init(jx["jax"].random.PRNGKey(0))
    return cfg, jcfg, jbundle, jparams


def _batch(cfg, step=0):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SHAPE.seq_len + 1,
        global_batch=SHAPE.global_batch, seed=0))
    b = pipe.batch_at(step)
    return {k: v[:, :SHAPE.seq_len] for k, v in b.items()}


def _approx(key, want, rel):
    """``rel`` of the reference's metric; the drop fraction, 0 where no
    slot overflows (``1 - routed / assignments`` in float32), also within
    1e-7, below one float32 step of 1."""
    if key == "moe_drop_fraction":
        return pytest.approx(want, rel=rel, abs=1e-7)
    return pytest.approx(want, rel=rel)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_loss_and_grads_match_jax(jx, arch):
    """The loss, every metric (the MoE aux losses included) and every
    gradient leaf."""
    cfg, jcfg, jbundle, jparams = _models(jx, arch)
    batch = _batch(cfg)
    (j_loss, j_metrics), j_grads = jx["jax"].value_and_grad(
        lambda p: jbundle.loss(p, {k: jx["jnp"].asarray(v)
                                   for k, v in batch.items()}, impl="ref"),
        has_aux=True)(jparams)
    params = {k: v.requires_grad_()
              for k, v in params_from_jax(cfg, _np(jparams)).items()}
    bundle = build_model(cfg, device="cpu")
    loss, metrics = bundle.loss(params, {k: torch.as_tensor(v)
                                         for k, v in batch.items()})
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    assert sorted(metrics) == sorted(j_metrics)
    for k in metrics:
        assert float(metrics[k]) == _approx(k, float(j_metrics[k]), 1e-5), k
    if arch in MOE_ARCHS:
        assert float(metrics["loss"]) > float(metrics["ce_loss"])
    want = params_from_jax(cfg, _np(j_grads))
    assert sorted(want) == sorted(grads)
    for k, w in want.items():
        g = grads[k].numpy()
        scale = max(float(np.abs(w.numpy()).max()), 1e-30)
        err = float(np.abs(g - w.numpy()).max()) / scale
        assert np.isfinite(g).all() and err <= 1e-4, (k, err)


def _jax_step_off_mesh(jx, jbundle):
    """The reference's train step without its mesh: its body as
    ``repro.parallel.steps.make_train_step`` writes it (value_and_grad of
    the bundle's loss, then ``adamw_update``), without the sharding scope.
    The reference's own step cannot take a MoE config on the host mesh:
    its MoE buffer constraint names the mesh's Explicit axes, which this
    JAX refuses in ``with_sharding_constraint``."""
    jax = jx["jax"]

    def step(state, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jbundle.loss(p, batch), has_aux=True)(state["params"])
        params, opt, stats = jx["opt"].adamw_update(state["params"], grads,
                                                    state["opt"], OPT)
        return {"params": params, "opt": opt}, {**metrics, **stats}

    return jax.jit(step)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_after_carry_over(jx, arch):
    """Two JAX train steps; the state after the first is carried to the
    port (moments included), and the second step is taken by both."""
    _carry_over_check(jx, arch, lambda jbundle: jx["make_train_step"](
        jbundle, jx["mesh"](), SHAPE, OPT).fn)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_jax_after_carry_over(jx, arch):
    """The same for the MoE configs, against the reference's step body
    off the mesh (``_jax_step_off_mesh``); the aux metrics too."""
    _carry_over_check(jx, arch, lambda jbundle: _jax_step_off_mesh(
        jx, jbundle))


def _carry_over_check(jx, arch, make_jax_step):
    cfg, jcfg, jbundle, jparams = _models(jx, arch)
    jstep = make_jax_step(jbundle)
    state_j = {"params": jparams,
               "opt": jx["opt"].init_opt_state(jparams, OPT)}
    jbatch = [{k: jx["jnp"].asarray(v) for k, v in _batch(cfg, s).items()}
              for s in (0, 1)]
    state_j, _ = jstep(state_j, jbatch[0])
    carried = _np(state_j)
    state_j, metrics_j = jstep(state_j, jbatch[1])
    state_j = _np(state_j)

    state = train_state_from_jax(cfg, carried)
    assert int(state["opt"]["step"]) == 1
    mom = opt_state_from_jax(cfg, carried["opt"])
    assert sorted(mom["m"]) == sorted(state["params"])
    built = make_train_step(build_model(cfg, device="cpu"),
                            make_host_mesh(device="cpu"), SHAPE, OPT)
    state, metrics = built.fn(state, {k: torch.as_tensor(v)
                                      for k, v in _batch(cfg, 1).items()})
    assert sorted(metrics) == sorted(metrics_j)
    for k, rel in (("loss", 1e-5), ("ce_loss", 1e-5), ("grad_norm", 1e-4),
                   ("lr", 1e-6), ("moe_load_balance", 1e-5),
                   ("moe_z_loss", 1e-5), ("moe_drop_fraction", 1e-5)):
        if k in metrics_j:
            assert float(metrics[k]) == _approx(k, float(metrics_j[k]),
                                                rel), k
    want = train_state_from_jax(cfg, state_j)
    lr = float(metrics_j["lr"])
    for k, w in want["params"].items():
        m, v = want["opt"]["m"][k], want["opt"]["v"][k]
        for name, got, ref, tol in (("m", state["opt"]["m"][k], m, 1e-4),
                                    ("v", state["opt"]["v"][k], v, 2e-4)):
            scale = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= tol * scale, (name, k)
        err = (state["params"][k] - w).abs()
        resolved = m.abs() > 1e-2 * float(m.abs().max())
        assert float(err.max()) <= 2 * lr, k
        assert float(err[resolved].max()) <= 2e-2 * lr, k
    assert int(state["opt"]["step"]) == int(want["opt"]["step"]) == 2
