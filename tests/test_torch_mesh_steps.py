"""The port's mesh steps on real gloo ranks against the JAX package.

The parent process writes the port's initial weights of the smoke
configs (seed 0) as numpy and starts two groups of child processes -- 2
ranks on a (1, 2) mesh and 4 ranks on a (2, 2) mesh over ("data",
"model"), spawned with ``torch.multiprocessing`` and a file store -- which
import only ``torch`` and ``repro_torch`` (this module); meanwhile it
stacks the same weights into the JAX package's tree and computes the
references on its one-device host mesh (``repro.parallel.build_step``,
``train.loop.train``).  The ranks place the weights by the steps' specs
and run, in float32:

- qwen2.5-3b: prefill of 2 x 8 tokens and 4 greedy decode steps, one
  train step, and a batch-1 decode on the default decode config (the
  caches' sequence axis over "data", each rank attending over its block);
- falcon-mamba-7b: prefill (the scan on each rank's ``d_inner`` block);
- kimi-k2: prefill under ``moe_buffer_mode="shard_map"`` (the reference
  refuses ``"ep"`` on its host mesh), and under the port's "ep",
  "ep_local", "dp" and "none", held to its own "shard_map" run;
- on 2 ranks, the fault-tolerant loop, 5 steps with a failure at step 3,
  whose checkpoint the reference's ``restore_checkpoint`` reads.

Each rank's parameter bytes must be what its placements give.  A one-rank
mesh (a gloo group of one in this process) must give the one-device steps
bit for bit, and ``python -m repro_torch.launch.train`` the losses of
``train()`` called directly.

Tolerances (float32), those of ``tests/test_torch_models.py`` and
``tests/test_torch_train_step.py``: logits and caches within 1e-4 of the
reference's largest magnitude, greedy tokens equal; the train step's
loss rtol 1e-5, ``grad_norm`` rtol 1e-4, lr rtol 1e-6, the moments within
1e-4 / 2e-4 of each leaf's largest magnitude and the parameters within
2 lr everywhere and 2e-2 lr where the first moment is resolved; the
loop's first step loss rtol 1e-5 and ``grad_norm`` rtol 1e-4, its later
steps rtol 5e-4 and 0.1 (``tests/test_torch_train_loop.py``'s); the MoE
modes within 1e-5 of the shard_map run's largest logit (the same
products, partial sums grouped another way).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.params import Params as ClusterParams
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import HostMesh, make_mesh
from repro_torch.models import build_model, params_from_jax
from repro_torch.parallel import ParallelConfig, build_step, sharding
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.loop import TrainLoopConfig, train
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

torch.set_num_threads(1)

ARCHS = ("qwen2.5-3b", "falcon-mamba-7b", "kimi-k2-1t-a32b")
MESHES = {2: (1, 2), 4: (2, 2)}
AXES = ("data", "model")
B, S, N = 2, 8, 4                       # prompts, prompt length, new tokens
TRAIN = ShapeSpec("tiny_train", 16, 4, "train")
OPT = OptimizerConfig(learning_rate=2e-3, warmup_steps=3, total_steps=20,
                      weight_decay=0.1, clip_norm=0.5)
MOE_MODES = ("ep", "ep_local", "dp", "none")
LOOP = dict(total_steps=5, log_every=1, checkpoint_every=2,
            inject_failures=True, deterministic_failure_steps=[3])
LOOP_CLUSTER = dict(random_failure_rate=0.0, systematic_failure_rate=0.0)
LOOP_OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5)
TIMEOUT_S = 300


def _cfg(arch):
    return get_config(arch, smoke=True).replace(dtype="float32")


def _prompts(cfg, batch=B):
    rng = np.random.default_rng(3)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, S)))


def _train_batch(cfg):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN.seq_len + 1,
        global_batch=TRAIN.global_batch, seed=0))
    return {k: torch.as_tensor(v[:, :TRAIN.seq_len])
            for k, v in pipe.batch_at(0).items()}


def _params(work, arch):
    with np.load(os.path.join(work, f"{arch}.npz")) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _serve(bundle, mesh, params, tokens, n_new, pcfg=None):
    """Prefill ``tokens`` and greedy-decode ``n_new`` tokens through the
    mesh steps: the gathered logits of each step, the tokens, the
    gathered cache and this rank's parameter bytes."""
    Bt, St = tokens.shape
    pre = build_step(bundle, mesh, ShapeSpec("p", St, Bt, "prefill"),
                     pcfg=pcfg)
    p_l, b_l, c_l = pre.place(params, {"tokens": tokens},
                              bundle.make_cache(Bt, St + n_new))
    logits, c_l = pre.fn(p_l, b_l, c_l)
    out = [pre.gather(logits, pre.out_shardings[0])]
    cache = pre.gather(c_l, pre.out_shardings[1])
    dec = build_step(bundle, mesh, ShapeSpec("d", St + n_new, Bt, "decode"),
                     pcfg=pcfg)
    if dec.in_shardings[2] != pre.out_shardings[1]:
        c_l = sharding.place(cache, dec.in_shardings[2], mesh)
    toks = []
    for i in range(n_new):
        tok = out[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        logits, c_l = dec.fn(p_l, sharding.place(tok, dec.in_shardings[1],
                                                 mesh), c_l, St + i)
        out.append(dec.gather(logits, dec.out_shardings[0]))
    return {"logits": out, "tokens": toks,
            "cache": dec.gather(c_l, dec.in_shardings[2]),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in p_l.values())}


def _rank_work(rank, world, work):
    mesh = make_mesh(MESHES[world], AXES, device="cpu")
    res = {"coords": mesh.coords}
    cfg = _cfg("qwen2.5-3b")
    bundle = build_model(cfg, device="cpu")
    params = _params(work, "qwen2.5-3b")
    res["qwen"] = _serve(bundle, mesh, params, _prompts(cfg), N)
    res["qwen_b1"] = _serve(bundle, mesh, params, _prompts(cfg, 1), N)

    built = build_step(bundle, mesh, TRAIN, OPT)
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    st_l, b_l = built.place(state, _train_batch(cfg))
    st_l, metrics = built.fn(st_l, b_l)
    res["train"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": built.gather(st_l, built.in_shardings[0])}

    fcfg = _cfg("falcon-mamba-7b")
    res["falcon"] = _serve(build_model(fcfg, device="cpu"), mesh,
                           _params(work, "falcon-mamba-7b"), _prompts(fcfg),
                           0)
    kcfg = _cfg("kimi-k2-1t-a32b")
    kbundle = build_model(kcfg, device="cpu")
    kparams = _params(work, "kimi-k2-1t-a32b")
    res["kimi"] = {mode: _serve(kbundle, mesh, kparams, _prompts(kcfg), 0,
                                ParallelConfig(moe_buffer_mode=mode))
                   ["logits"][0]
                   for mode in ("shard_map",) + MOE_MODES}

    if world == 2:
        lbundle = dataclasses.replace(bundle,
                                      init=lambda seed: _params(
                                          work, "qwen2.5-3b"))
        loop_cfg = TrainLoopConfig(
            **LOOP, checkpoint_dir=os.path.join(work, "loop"),
            cluster=ClusterParams(**LOOP_CLUSTER))
        res["loop"] = json.loads(json.dumps(train(
            lbundle, mesh, TRAIN, loop_cfg, OptimizerConfig(**LOOP_OPT)),
            default=float))
    return res


def _child(rank, world, work):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/store{world}", rank=rank,
        world_size=world)
    try:
        torch.save(_rank_work(rank, world, work),
                   os.path.join(work, f"w{world}r{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: references, ranks, launcher
# ---------------------------------------------------------------------------

def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _jax_tree(cfg, spec_tree, params, prefix=""):
    """The port's parameters as the reference's tree: each stacked leaf
    the port's layers of its superblock slot, stacked."""
    out = {}
    for k, v in spec_tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out[k] = _jax_tree(cfg, v, params, path)
            continue
        parts = path.split("/")
        if "stack" not in parts[:2]:
            out[k] = params[path.replace("/", ".")].numpy()
            continue
        enc = parts[0] == "encoder"
        size, n_sb = cfg.superblock_size, cfg.n_superblocks
        j = int(parts[2 if enc else 1].removeprefix("layer"))
        rest = ".".join(parts[3 if enc else 2:])
        out[k] = np.stack([params[f"stack.{sb * size + j}.{rest}"].numpy()
                           for sb in range(n_sb)])
    return out


def _cache_from_jax(cfg, tree):
    """The reference's stacked cache as the port's list of layers."""
    size = cfg.superblock_size
    return [{kind: {k: torch.as_tensor(np.asarray(v[i // size]))
                    for k, v in entries.items()}
             for kind, entries in tree[f"layer{i % size}"].items()}
            for i in range(cfg.n_layers)]


def _jax_bundle(jx, arch):
    jcfg = jx["get_config"](arch, smoke=True).replace(dtype="float32")
    return jx["build_model"](jcfg)


def _jax_serve(jx, arch, batch, n_new, pcfg=None):
    """The reference's prefill and greedy decode through its build_step on
    its host mesh: logits of every step, tokens, final cache."""
    jnp = jx["jax"].numpy
    jb = _jax_bundle(jx, arch)
    params = jx["params"][arch]
    tokens = jnp.asarray(_prompts(_cfg(arch), batch).numpy())
    mesh = jx["mesh"]()
    pre = jx["build_step"](jb, mesh, ShapeSpec("p", S, batch, "prefill"),
                           pcfg=pcfg)
    cache = jb.make_cache(batch, S + n_new)
    logits, cache = pre.fn(params, {"tokens": tokens}, cache)
    out, toks = [np.asarray(logits)], []
    dec = jx["build_step"](jb, mesh, ShapeSpec("d", S + n_new, batch,
                                               "decode"))
    for i in range(n_new):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = dec.fn(params, tok, cache, jnp.int32(S + i))
        out.append(np.asarray(logits))
    return {"logits": out, "tokens": toks,
            "cache": _cache_from_jax(_cfg(arch), _np(cache))}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: the card's machine has
    no JAX)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.core.params import Params as JaxClusterParams
    from repro.launch.mesh import make_host_mesh as jax_mesh
    from repro.models import build_model as jax_build_model
    from repro.parallel import build_step as jax_build_step
    from repro.parallel.sharding import ParallelConfig as JaxPcfg
    from repro.train import checkpoint as jckpt
    from repro.train import loop as jloop
    from repro.train.optimizer import OptimizerConfig as JaxOpt
    from repro.train.optimizer import init_opt_state as jax_init_opt
    from repro.parallel.steps import param_specs as jax_param_specs
    return dict(jax=jax, get_config=jax_get_config, mesh=jax_mesh,
                build_model=jax_build_model, build_step=jax_build_step,
                Pcfg=JaxPcfg, ckpt=jckpt, loop=jloop, Opt=JaxOpt,
                init_opt=jax_init_opt, ClusterParams=JaxClusterParams,
                param_specs=jax_param_specs)


@pytest.fixture(scope="module")
def run(jx, tmp_path_factory):
    """Start both rank groups and the launcher, compute the references
    meanwhile, and collect: {"ranks": {world: [rank results]}, "ref":
    ..., "launcher": (its JSON, train()'s output)}."""
    work = str(tmp_path_factory.mktemp("mesh"))
    weights = {}
    for arch in ARCHS:
        weights[arch] = {k: v.detach() for k, v in build_model(
            _cfg(arch), device="cpu").init(0).state_dict().items()}
        np.savez(os.path.join(work, f"{arch}.npz"),
                 **{k: v.numpy() for k, v in weights[arch].items()})
    groups = {world: mp.start_processes(_child, args=(world, work),
                                        nprocs=world, join=False,
                                        start_method="spawn")
              for world in MESHES}
    launch_dir = os.path.join(work, "launch")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--smoke", "--steps", "5", "--inject-failures",
         "--device", "cpu", "--ckpt-dir", os.path.join(launch_dir, "ckpt"),
         "--out", os.path.join(work, "launch.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jx["params"] = {arch: jx["jax"].tree.map(
            jx["jax"].numpy.asarray, _jax_tree(
                _cfg(arch), jx["param_specs"](_jax_bundle(jx, arch)),
                weights[arch])) for arch in ARCHS}
        ref = _references(jx, work)
        direct = train(build_model(get_config("qwen2.5-3b", smoke=True),
                                   device="cpu"),
                       HostMesh(torch.device("cpu")),
                       ShapeSpec("cli", 64, 4, "train"),
                       TrainLoopConfig(total_steps=5, log_every=1,
                                       checkpoint_dir=os.path.join(
                                           launch_dir, "direct"),
                                       inject_failures=True,
                                       cluster=ClusterParams()),
                       OptimizerConfig(learning_rate=3e-4, warmup_steps=1,
                                       total_steps=5))
        deadline = time.time() + TIMEOUT_S
        for world, ctx in groups.items():
            while not ctx.join(timeout=max(deadline - time.time(), 1)):
                if time.time() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish")
        _, err = launcher.communicate(timeout=TIMEOUT_S)
        assert launcher.returncode == 0, err[-3000:]
    finally:
        for ctx in groups.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        if launcher.poll() is None:
            launcher.kill()
    with open(os.path.join(work, "launch.json")) as f:
        launched = json.load(f)
    ranks = {world: [torch.load(os.path.join(work, f"w{world}r{r}.pt"),
                                weights_only=True) for r in range(world)]
             for world in MESHES}
    return {"ranks": ranks, "ref": ref, "work": work,
            "launcher": (launched, direct)}


def _references(jx, work):
    jax = jx["jax"]
    ref = {"qwen": _jax_serve(jx, "qwen2.5-3b", B, N),
           "qwen_b1": _jax_serve(jx, "qwen2.5-3b", 1, N),
           "falcon": _jax_serve(jx, "falcon-mamba-7b", B, 0),
           "kimi": _jax_serve(jx, "kimi-k2-1t-a32b", B, 0,
                              jx["Pcfg"](moe_buffer_mode="shard_map"))}
    jb = _jax_bundle(jx, "qwen2.5-3b")
    params = jx["params"]["qwen2.5-3b"]

    def fresh(key=None):     # a copy: the reference's step donates it
        return jax.tree.map(jax.numpy.array, params)

    state = {"params": fresh(), "opt": jx["init_opt"](params, OPT)}
    batch = {k: jax.numpy.asarray(v.numpy())
             for k, v in _train_batch(_cfg("qwen2.5-3b")).items()}
    state, metrics = jx["build_step"](jb, jx["mesh"](), TRAIN, OPT).fn(
        state, batch)
    ref["train"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": _np(state)}
    loop_cfg = jx["loop"].TrainLoopConfig(
        **LOOP, checkpoint_dir=os.path.join(work, "jax_loop"),
        cluster=jx["ClusterParams"](**LOOP_CLUSTER))
    jb = dataclasses.replace(jb, init=fresh)
    ref["loop"] = jx["loop"].train(jb, jx["mesh"](), TRAIN, loop_cfg,
                                   jx["Opt"](**LOOP_OPT))
    return ref


def _close(got, want, tol=1e-4, what=""):
    got = torch.as_tensor(np.asarray(got)).float()
    want = torch.as_tensor(np.asarray(want)).float()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("case", ["qwen", "qwen_b1", "falcon", "kimi"])
def test_serving_steps_match_jax(run, world, case):
    """Prefill (and decode) logits on every rank, the greedy tokens and
    the caches, against the reference's steps."""
    want = run["ref"][case]
    for res in run["ranks"][world]:
        got = res[case]
        if case == "kimi":
            _close(got["shard_map"], want["logits"][0], what="kimi")
            continue
        assert len(got["logits"]) == len(want["logits"])
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(g, w, what=f"{case} step {i}")
        for g, w in zip(got["tokens"], want["tokens"]):
            assert np.array_equal(g.numpy(), w), case
        for i, (g, w) in enumerate(zip(got["cache"], want["cache"])):
            for kind in w:
                for k in w[kind]:
                    _close(g[kind][k], w[kind][k], what=f"{case} {i} {k}")


@pytest.mark.parametrize("world", sorted(MESHES))
def test_moe_modes_compute_the_same_function(run, world):
    for res in run["ranks"][world]:
        base = res["kimi"]["shard_map"]
        for mode in MOE_MODES:
            _close(res["kimi"][mode], base, tol=1e-5, what=mode)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_each_rank_holds_its_placements_share(run, world):
    """A rank's parameter bytes are the sum of its blocks under the
    specs; the ranks of a data group together hold each tensor once a
    model rank."""
    cfg = _cfg("qwen2.5-3b")
    bundle = build_model(cfg, device="cpu")
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.steps import param_specs
    mesh = AbstractMesh(MESHES[world], AXES)
    specs = param_specs(bundle)
    p_sh = sharding.params_shardings(specs, mesh)
    full = sum(int(np.prod(s.shape)) * 4 for s in specs.values())
    for res in run["ranks"][world]:
        want = 0
        for k, s in specs.items():
            idx = sharding.local_slice(p_sh[k], s.shape, mesh, res["coords"])
            want += int(np.prod([i.stop - i.start for i in idx])) * 4
        assert res["qwen"]["param_bytes"] == want
        assert want < full          # something is sharded on every rank


def _assert_train_step_close(got, want_metrics, wstate):
    """A train step's metrics and gathered state (``got``) against
    another's, by tests/test_torch_train_step.py's tolerances; ``wstate``
    holds the other's parameters and moments by the port's names."""
    lr = want_metrics["lr"]
    assert sorted(got["metrics"]) == sorted(want_metrics)
    for k, rel in (("loss", 1e-5), ("ce_loss", 1e-5), ("grad_norm", 1e-4),
                   ("lr", 1e-6)):
        assert got["metrics"][k] == pytest.approx(want_metrics[k],
                                                  rel=rel), k
    st = got["state"]
    assert int(st["opt"]["step"]) == 1
    for k, w in wstate["params"].items():
        m, v = wstate["m"][k], wstate["v"][k]
        for name, g, r, tol in (("m", st["opt"]["m"][k], m, 1e-4),
                                ("v", st["opt"]["v"][k], v, 2e-4)):
            assert float((g - r).abs().max()) <= tol * float(
                r.abs().max()), (name, k)
        err = (st["params"][k] - w).abs()
        resolved = m.abs() > 1e-2 * float(m.abs().max())
        assert float(err.max()) <= 2 * lr, k
        assert float(err[resolved].max()) <= 2e-2 * lr, k


@pytest.mark.parametrize("world", sorted(MESHES))
def test_train_step_matches_jax(run, world):
    want = run["ref"]["train"]
    cfg = _cfg("qwen2.5-3b")
    wstate = {"params": params_from_jax(cfg, want["state"]["params"]),
              "m": params_from_jax(cfg, want["state"]["opt"]["m"]),
              "v": params_from_jax(cfg, want["state"]["opt"]["v"])}
    for res in run["ranks"][world]:
        _assert_train_step_close(res["train"], want["metrics"], wstate)


def test_train_loop_on_two_ranks_matches_jax(run, jx):
    """The loop's history and recovery against the reference's loop, and
    its last checkpoint (rank 0's, of the gathered state) read by the
    reference's ``restore_checkpoint``."""
    ours = run["ranks"][2][0]["loop"]
    theirs = run["ref"]["loop"]
    assert sorted(ours) == sorted(theirs)
    assert [h["step"] for h in ours["history"]] == \
        [h["step"] for h in theirs["history"]]
    for i, (a, b) in enumerate(zip(ours["history"], theirs["history"])):
        rel = (1e-5, 1e-4) if i == 0 else (5e-4, 0.1)
        assert a["loss"] == pytest.approx(b["loss"], rel=rel[0]), a["step"]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=rel[1])
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    counts = {k: v for k, v in theirs["recovery"].items()
              if k != "recovery_wall_s"}
    assert {k: ours["recovery"][k] for k in counts} == counts
    assert counts["n_failures"] == 1
    assert [h["loss"] for h in run["ranks"][2][1]["loop"]["history"]] == \
        [h["loss"] for h in ours["history"]]
    step, tree, extra = jx["ckpt"].restore_checkpoint(
        os.path.join(run["work"], "loop"))
    assert step == LOOP["total_steps"] and extra["data_step"] == step
    _, port_tree, _ = restore_checkpoint(os.path.join(run["work"], "loop"))
    jstep, jtree, _ = jx["ckpt"].restore_checkpoint(
        os.path.join(run["work"], "jax_loop"))
    assert jstep == step
    want = params_from_jax(_cfg("qwen2.5-3b"), jtree["params"])
    assert sorted(tree["params"]) == sorted(want)
    # the steps taken, the failure's replay included; AdamW moves a
    # parameter by about lr a step where its gradient is at the two
    # packages' summation noise
    taken = LOOP["total_steps"] + ours["recovery"]["lost_steps"]
    for k, w in want.items():
        got = torch.as_tensor(np.asarray(tree["params"][k]))
        assert torch.equal(got, port_tree["params"][k]), k
        assert got.shape == w.shape and got.dtype == w.dtype, k
        assert float((got - w).abs().max()) <= 2 * taken * LOOP_OPT[
            "learning_rate"], k


def test_train_launcher_matches_train(run):
    """``python -m repro_torch.launch.train --smoke`` writes the
    reference's keys, and the losses of ``train()`` called directly with
    the same arguments."""
    launched, direct = run["launcher"]
    assert sorted(launched) == sorted(run["ref"]["loop"])
    assert [h["loss"] for h in launched["history"]] == \
        [h["loss"] for h in direct["history"]]
    assert launched["steps"] == direct["steps"] == 5


# ---------------------------------------------------------------------------
# one rank: the one-device steps bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of one rank in this process, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), AXES, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "kimi-k2-1t-a32b"])
def test_one_rank_mesh_is_the_one_device_step(one_rank, arch):
    cfg = _cfg(arch)
    bundle = build_model(cfg, device="cpu")
    params = {k: v.detach() for k, v in bundle.init(0).state_dict().items()}
    host = HostMesh(torch.device("cpu"))
    pcfg = ParallelConfig(moe_buffer_mode="shard_map")
    a = _serve(bundle, host, params, _prompts(cfg), 2, pcfg)
    b = _serve(bundle, one_rank, params, _prompts(cfg), 2, pcfg)
    for x, y in zip(a["logits"], b["logits"]):
        assert torch.equal(x, y)
    outs = []
    for mesh in (host, one_rank):
        state = {"params": {k: v.clone() for k, v in params.items()}}
        state["opt"] = init_opt_state(state["params"], OPT)
        built = build_step(bundle, mesh, TRAIN, OPT, pcfg)
        outs.append(built.fn(*built.place(state, _train_batch(cfg))))
    (s1, m1), (s2, m2) = outs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1["params"][k], s2["params"][k]) for k in params)


def test_mesh_refusals():
    """A mesh never builds smaller than asked, and names both counts."""
    with pytest.raises(ValueError, match="needs 4 ranks.*has 1"):
        make_mesh((2, 2), AXES, device="cpu")
    with pytest.raises(ValueError, match="moe_buffer_mode"):
        build_step(build_model(_cfg("qwen2.5-3b"), device="cpu"),
                   HostMesh(torch.device("cpu")),
                   ShapeSpec("p", S, B, "prefill"),
                   pcfg=ParallelConfig(moe_buffer_mode="sharded"))


# ---------------------------------------------------------------------------
# on the card (NCCL): chip_smoke.py phase 31's checks at the smoke size
# ---------------------------------------------------------------------------

def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", "ep"),
                                       ("kimi-k2-1t-a32b", "shard_map"),
                                       ("kimi-k2-1t-a32b", "ep")])
def test_gpu_one_rank_nccl_mesh_is_the_one_device_step(tmp_path, arch, mode):
    """A one-rank NCCL mesh on the card: the greedy tokens and the
    logits of the one-device steps, bit for bit, in bf16."""
    _cards(1)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), AXES)
        cfg = get_config(arch, smoke=True)
        bundle = build_model(cfg, device=mesh.device)
        params = {k: v.detach()
                  for k, v in bundle.init(0).state_dict().items()}
        pcfg = ParallelConfig(moe_buffer_mode=mode)
        a = _serve(bundle, HostMesh(mesh.device), params, _prompts(cfg), N,
                   pcfg)
        b = _serve(bundle, mesh, params, _prompts(cfg), N, pcfg)
        for x, y in zip(a["tokens"], b["tokens"]):
            assert torch.equal(x, y)
        for x, y in zip(a["logits"], b["logits"]):
            assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _train_step(bundle, mesh, params):
    """One train step of TRAIN from ``params`` through the step built on
    ``mesh``: the metrics and the gathered state."""
    built = build_step(bundle, mesh, TRAIN, OPT)
    state = {"params": {k: v.clone() for k, v in params.items()}}
    state["opt"] = init_opt_state(state["params"], OPT)
    st_l, metrics = built.fn(*built.place(state,
                                          _train_batch(bundle.cfg)))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": _cpu(built.gather(st_l, built.in_shardings[0]))}


def _gpu_child(rank, world, work):
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{work}/store", rank=rank,
        world_size=world)
    try:
        mesh = make_mesh((1, world), AXES)
        out = {}
        for arch in ("qwen2.5-3b", "kimi-k2-1t-a32b"):
            cfg = _cfg(arch)
            params = _params(work, arch)
            out[arch] = _serve(build_model(cfg, device=mesh.device), mesh,
                               params, _prompts(cfg), N,
                               ParallelConfig(moe_buffer_mode="shard_map"))
        cfg = _cfg("qwen2.5-3b")
        bundle = build_model(cfg, device=mesh.device)
        params = _params(work, "qwen2.5-3b")
        out["train"] = _train_step(bundle, mesh, params)
        seq_mesh = make_mesh((world, 1), AXES)
        out["qwen_b1"] = _serve(bundle, seq_mesh, params, _prompts(cfg, 1),
                                N)
        torch.save(_cpu(out), os.path.join(work, f"gpu{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gpu_two_ranks_match_one_device(tmp_path):
    """Two NCCL ranks, one card each, in float32, against one device: on
    a (1, 2) mesh the tokens, the logits within 1e-4 and less than the
    whole parameter bytes a rank, and one train step within
    tests/test_torch_train_step.py's tolerances; on a (2, 1) mesh a
    batch-1 decode over caches whose positions split over "data"."""
    _cards(2)
    work = str(tmp_path)
    want = {}
    host = HostMesh(torch.device("cuda", 0))
    for arch in ("qwen2.5-3b", "kimi-k2-1t-a32b"):
        cfg = _cfg(arch)
        params = {k: v.detach().cpu() for k, v in build_model(
            cfg, device="cpu").init(0).state_dict().items()}
        np.savez(os.path.join(work, f"{arch}.npz"),
                 **{k: v.numpy() for k, v in params.items()})
        bundle = build_model(cfg, device="cuda:0")
        want[arch] = _serve(bundle, host, params, _prompts(cfg), N)
        want[arch]["bytes"] = sum(v.numel() * 4 for v in params.values())
        if arch == "qwen2.5-3b":
            train = _train_step(bundle, host, params)
            b1 = _serve(bundle, host, params, _prompts(cfg, 1), N)
    mp.start_processes(_gpu_child, args=(2, work), nprocs=2, join=True,
                       start_method="spawn")
    for rank in range(2):
        got = torch.load(os.path.join(work, f"gpu{rank}.pt"),
                         weights_only=True)
        for arch, w in want.items():
            g = got[arch]
            for x, y in zip(g["tokens"], w["tokens"]):
                assert torch.equal(x.cpu(), y.cpu()), arch
            for x, y in zip(g["logits"], w["logits"]):
                _close(x.cpu(), y.cpu(), what=arch)
            assert g["param_bytes"] < w["bytes"], arch
        st = train["state"]
        _assert_train_step_close(got["train"], train["metrics"], {
            "params": st["params"], "m": st["opt"]["m"],
            "v": st["opt"]["v"]})
        for x, y in zip(got["qwen_b1"]["tokens"], b1["tokens"]):
            assert torch.equal(x, y.cpu())
        for x, y in zip(got["qwen_b1"]["logits"], b1["logits"]):
            _close(x, y.cpu(), what="batch 1")
