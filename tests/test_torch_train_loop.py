"""The port's fault-tolerant training loop and checkpoints against the JAX
package's, on the CPU.

Mirrors ``tests/test_train_loop.py``'s three loop tests on the qwen2.5-3b
smoke config in float32: the port's bundle keeps its own step and loss,
and only its ``init`` is replaced by the JAX initial weights carried
across (``params_from_jax``), so both loops start from the same state,
read the same pipeline batches and inject the same failures.  Then the
histories agree within the stated tolerance, and the recovery counts and
the Young/Daly cadence are equal.  On the CPU the port's run with an
injected failure ends on the very parameters of its run without one (the
restore replays the same steps from the same bits).  Checkpoints: a
directory the JAX package wrote restores in the port, bfloat16 leaves
included, and one the port wrote restores in the JAX package; the port's
own round trip, corruption check and async writer.

Tolerances (float32): the first logged step's loss rtol 1e-5 and
grad_norm rtol 1e-4 (one step from the same state,
tests/test_torch_train_step.py's); every logged step's loss rtol 5e-4 and
grad_norm rtol 0.1; lr rtol 1e-6.  AdamW's first step moves every
parameter by about lr * sign(g), also where g is at the two packages'
summation noise, so the runs part by up to 2 lr on such parameters from
step 1 on: over 9 steps the loss (a smooth function of all parameters)
stays within 1.0e-4, the gradient norm spreads 0.4-4.5% (measured).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.params import Params as ClusterParams
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.model_zoo import train_state_from_jax
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import StragglerPolicy
from repro_torch.train.loop import TrainLoopConfig, checkpoint_cadence, train
from repro_torch.train.optimizer import OptimizerConfig

torch.set_num_threads(1)

SHAPE = ShapeSpec("tiny_train", 32, 4, "train")
#: the three loops of tests/test_train_loop.py
RUNS = {
    "runs": (dict(total_steps=8, log_every=2, checkpoint_every=4),
             dict(learning_rate=1e-3, warmup_steps=2, total_steps=8)),
    "restarts": (dict(total_steps=10, log_every=5, checkpoint_every=3,
                      inject_failures=True, deterministic_failure_steps=[7],
                      cluster=dict(random_failure_rate=0.0,
                                   systematic_failure_rate=0.0)),
                 dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)),
    "no_failure": (dict(total_steps=10, log_every=5, checkpoint_every=3),
                   dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: the card's machine has
    no JAX)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.core.params import Params as JaxClusterParams
    from repro.launch.mesh import make_host_mesh as jax_mesh
    from repro.models import build_model as jax_build_model
    from repro.train import checkpoint as jckpt
    from repro.train import loop as jloop
    from repro.train.optimizer import OptimizerConfig as JaxOptConfig
    from repro.train.optimizer import init_opt_state as jax_init_opt
    return dict(jax=jax, get_config=jax_get_config,
                ClusterParams=JaxClusterParams, mesh=jax_mesh,
                build_model=jax_build_model, ckpt=jckpt, loop=jloop,
                OptConfig=JaxOptConfig, init_opt=jax_init_opt)


@pytest.fixture(scope="module")
def setup(jx):
    jcfg = jx["get_config"]("qwen2.5-3b", smoke=True).replace(
        dtype="float32")
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype="float32")
    jbundle = jx["build_model"](jcfg)
    jparams = jbundle.init(jx["jax"].random.PRNGKey(0))
    carried = jx["jax"].tree.map(np.asarray, jparams)
    bundle = dataclasses.replace(
        build_model(cfg, device="cpu"),
        init=lambda seed: params_from_jax(cfg, carried))
    return dict(cfg=cfg, jbundle=jbundle, jparams=jparams, bundle=bundle,
                mesh=make_host_mesh(device="cpu"), jmesh=jx["mesh"]())


def _loop_cfg(kw, ckdir, cluster_cls):
    kw = dict(kw, checkpoint_dir=ckdir)
    if "cluster" in kw:
        kw["cluster"] = cluster_cls(**kw["cluster"])
    return kw


@pytest.fixture(scope="module")
def runs(jx, setup, tmp_path_factory):
    """Each of RUNS through both loops: name -> (port's output, JAX's
    output, port's checkpoint directory)."""
    out = {}
    for name, (loop_kw, opt_kw) in RUNS.items():
        base = tmp_path_factory.mktemp(name)
        ours = train(setup["bundle"], setup["mesh"], SHAPE,
                     TrainLoopConfig(**_loop_cfg(loop_kw, str(base / "port"),
                                                 ClusterParams)),
                     OptimizerConfig(**opt_kw))
        theirs = jx["loop"].train(
            setup["jbundle"], setup["jmesh"], SHAPE,
            jx["loop"].TrainLoopConfig(**_loop_cfg(
                loop_kw, str(base / "jax"), jx["ClusterParams"])),
            jx["OptConfig"](**opt_kw))
        out[name] = (ours, theirs, str(base / "port"))
    return out


def _same_history(ours, theirs):
    assert [h["step"] for h in ours["history"]] == \
        [h["step"] for h in theirs["history"]]
    first = ours["history"][0]["step"] == 0
    for i, (a, b) in enumerate(zip(ours["history"], theirs["history"])):
        rel = (1e-5, 1e-4) if first and i == 0 else (5e-4, 0.1)
        assert a["loss"] == pytest.approx(b["loss"], rel=rel[0]), a["step"]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=rel[1])
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)


def _counts(rec):
    return {k: v for k, v in rec.items() if k != "recovery_wall_s"}


def test_train_loop_runs_and_loss_finite(runs):
    ours, theirs, ckdir = runs["runs"]
    assert ours["steps"] == theirs["steps"] == 8
    assert np.isfinite(ours["final_loss"])
    assert latest_step(ckdir) == 8
    _same_history(ours, theirs)
    assert ours["checkpoint_cadence"] == theirs["checkpoint_cadence"] == 4


def test_train_loop_restarts_from_checkpoint(runs):
    ours, theirs, ckdir = runs["restarts"]
    assert ours["recovery"]["n_failures"] == 1
    assert ours["recovery"]["n_restores"] == 1
    assert ours["recovery"]["lost_steps"] == 1   # 7 -> back to checkpoint @6
    assert _counts(ours["recovery"]) == _counts(theirs["recovery"])
    assert ours["steps"] == theirs["steps"] >= 10
    assert ours["checkpoint_cadence"] == theirs["checkpoint_cadence"]
    _same_history(ours, theirs)
    # the restore replays steps 6 and 7 from the same bits: the run ends on
    # the parameters of the run without a failure
    clean = runs["no_failure"][2]
    _, a, _ = restore_checkpoint(ckdir)
    _, b, _ = restore_checkpoint(clean)
    for k, t in b["params"].items():
        assert torch.equal(a["params"][k], t), k
    for mom in ("m", "v"):
        for k, t in b["opt"][mom].items():
            assert torch.equal(a["opt"][mom][k], t), (mom, k)


def test_resume_after_process_restart(jx, setup, tmp_path):
    ours, theirs = [], []
    for total in (4, 8):
        kw = dict(total_steps=total, checkpoint_every=2)
        ours.append(train(setup["bundle"], setup["mesh"], SHAPE,
                          TrainLoopConfig(checkpoint_dir=str(tmp_path / "p"),
                                          **kw),
                          OptimizerConfig(warmup_steps=1, total_steps=8)))
        theirs.append(jx["loop"].train(
            setup["jbundle"], setup["jmesh"], SHAPE,
            jx["loop"].TrainLoopConfig(checkpoint_dir=str(tmp_path / "j"),
                                       **kw),
            jx["OptConfig"](warmup_steps=1, total_steps=8)))
    assert ours[1]["steps"] == theirs[1]["steps"] == 4  # resumed at 4
    for a, b in zip(ours, theirs):
        _same_history(a, b)


def test_checkpoint_cadence_is_the_references(jx):
    for kw in (dict(checkpoint_cost_minutes=1.0, step_minutes=1.0),
               dict(checkpoint_cost_minutes=0.5, step_minutes=2.0),
               dict(checkpoint_every=17)):
        ours = checkpoint_cadence(TrainLoopConfig(cluster=ClusterParams(),
                                                  **kw))
        theirs = jx["loop"].checkpoint_cadence(jx["loop"].TrainLoopConfig(
            cluster=jx["ClusterParams"](), **kw))
        assert ours == theirs
    # MTBF ~ 1/0.0305 per min -> tau = sqrt(2*1*32.8) ~ 8.1 steps
    assert 2 <= checkpoint_cadence(TrainLoopConfig(
        cluster=ClusterParams(random_failure_rate=0.0,
                              systematic_failure_rate=0.0),
        total_steps=40)) == 10


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_in_the_port(jx, setup, tmp_path):
    """A train state the JAX package wrote (float32, and its bf16 twin)
    restores here and carries to the port's names."""
    import ml_dtypes
    cfg, jparams = setup["cfg"], setup["jparams"]
    opt = jx["init_opt"](jparams, jx["OptConfig"]())
    state = {"params": jparams, "opt": opt}
    host = jx["jax"].tree.map(np.asarray, state)
    jx["ckpt"].save_checkpoint(str(tmp_path / "f32"), 5, host,
                               extra={"data_step": 5})
    step, restored, extra = restore_checkpoint(str(tmp_path / "f32"))
    assert step == 5 and extra == {"data_step": 5}
    got = train_state_from_jax(cfg, restored)
    want = params_from_jax(cfg, host["params"])
    assert sorted(got["params"]) == sorted(want)
    for k, t in want.items():
        assert torch.equal(got["params"][k], t), k
        assert not bool(got["opt"]["m"][k].any())
    assert int(got["opt"]["step"]) == 0
    bf16 = jx["jax"].tree.map(lambda a: a.astype(ml_dtypes.bfloat16),
                              host["params"])
    jx["ckpt"].save_checkpoint(str(tmp_path / "bf16"), 1, {"params": bf16})
    _, restored, _ = restore_checkpoint(str(tmp_path / "bf16"))
    got = params_from_jax(cfg, restored["params"])
    want = params_from_jax(cfg, bf16)
    for k, t in want.items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), t.view(torch.int16)), k


def test_port_checkpoint_restores_in_jax(jx, tmp_path):
    import ml_dtypes
    w = torch.arange(16, dtype=torch.float32).to(torch.bfloat16)
    state = {"params": {"stack.0.w": w, "b": torch.ones(3)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 7, state, extra={"data_step": 7})
    step, restored, extra = jx["ckpt"].restore_checkpoint(str(tmp_path))
    assert step == 7 and extra["data_step"] == 7
    got = restored["params"]["stack.0.w"]
    assert got.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(np.uint16),
                                  w.view(torch.int16).numpy().view(np.uint16))
    assert int(restored["opt"]["step"]) == 7


def test_checkpoint_roundtrip_and_corruption(tmp_path):
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    state = {"params": {"w": w, "h": w.to(torch.bfloat16)},
             "opt": {"step": np.int32(7)}}
    path = save_checkpoint(str(tmp_path), 7, state, extra={"data_step": 7})
    step, restored, extra = restore_checkpoint(str(tmp_path))
    assert step == 7 and extra["data_step"] == 7
    assert torch.equal(restored["params"]["w"], w)
    assert restored["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["h"], w.to(torch.bfloat16))
    assert int(restored["opt"]["step"]) == 7
    shard = os.path.join(path, "shard_00000.npz")
    with np.load(shard) as z:
        data = {k: z[k] for k in z.files}
    data["params/w"][0, :2] = -99.0
    np.savez(shard, **data)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path))


def test_async_checkpointer_keeps_latest(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, {"w": torch.full((4,), float(step))})
    ck.close()
    assert latest_step(str(tmp_path)) == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert len(steps) <= 2
    _, restored, _ = restore_checkpoint(str(tmp_path))
    assert torch.equal(restored["w"], torch.full((4,), 4.0))


def test_straggler_policy_fires_after_patience():
    pol = StragglerPolicy(threshold=2.0, patience=2, window=16)
    fired = [pol.observe(1.0) for _ in range(10)]
    fired += [pol.observe(5.0) for _ in range(3)]
    assert any(fired)
    assert pol.n_stragglers >= 2
