"""Megatron sequence parallelism (SP) in the port's mesh steps, on gloo
ranks.

The train and prefill steps shard the activation between sublayers along
the sequence over "model" (``parallel.context``); ``ParallelConfig(
shard_sequence=False)`` (perf.py's ``no_sp``) keeps it whole.  The parent
process writes each case's initial weights (seed 0, float32) as numpy and
starts two groups of child processes -- 2 ranks on a (1, 2) mesh and 4
on a (2, 2) mesh over ("data", "model"), spawned once each with
``torch.multiprocessing`` and a file store -- which run every case under
SP and under ``no_sp``: a prefill of 2 x 8 tokens, the gradients of a
train batch (4 x 16) through the train step's own scope, and one train
step.  The cases: qwen2.5-3b (attention + MLP), the same with one kv
head (the query heads split, the kv heads do not), with 3 query heads, 1
kv head and 129 MLP columns (neither splits over 2), falcon-mamba-7b
(the scan), the same at 63 channels (the scan does not split), kimi-k2
under ``"shard_map"`` and ``"none"`` (MoE with a shared expert), jamba (a
superblock of 8: attention, Mamba, MoE and MLP; its experts cut to 32
columns), whisper-base (an
encoder, cross-attention, the GELU MLP's ``bo`` added on the shard) and
whisper-base with 3 heads and 129 columns (cross-attention and the GELU
MLP whole on every rank).

Checked, on every rank:

- the forward is ``no_sp``'s bit for bit (prefill logits and caches): on
  gloo the reduce-scatter is an all-reduce and a chunk, the same sums;
- the train step's metrics and state against ``no_sp``'s at the
  tolerances of ``tests/test_torch_mesh_steps.py`` (loss rtol 1e-5,
  grad_norm 1e-4, lr 1e-6; moments within 1e-4 / 2e-4 of each leaf's
  largest magnitude; parameters within 2 lr, 2e-2 lr where the first
  moment is resolved); the MoE drop fraction equal;
- every gradient, gathered, within 1e-4 of its leaf's largest magnitude
  of ``no_sp``'s and of the one-device gradient
  (``tests/test_torch_train_step.py``'s gradient tolerance) -- by name
  the rules at the stack's ends and on the shard: the embedding's
  (entry), the final norms' scales (exit), each layer's norm scales,
  whisper's ``bo`` and the whole weights of the sublayers that do not
  split.  whisper-base's split case is held to the one-device gradient
  within 2e-3: its float32 encoder gradients are resolved to about 5e-3
  of their largest magnitude (the one-device float32 gradient of
  ``encoder.stack.0.attn.wk`` is 4.8e-3 from the same step with float64
  weights and inputs), and the mesh's head split sums them in another
  order with or without SP (1.3e-3 on that leaf, ``no_sp``'s the same);
- the prefill forward's collectives: against ``no_sp``'s, SP adds one
  all-gather of the (B_l, S, D) activation a sublayer (split or not) and
  one at each stack's exit, and one reduce-scatter of the float32
  partials a split sublayer, and drops ``no_sp``'s all-reduce of them;
  no all-reduce of a (B_l, S, D) partial is left.
"""

import collections
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel import ParallelConfig, build_step, comm, context
from repro_torch.parallel.steps import _scope
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

torch.set_num_threads(1)

MESHES = {2: (1, 2), 4: (2, 2)}
AXES = ("data", "model")
TP = 2
B, S = 2, 8                                  # prompts, prompt length
TRAIN = ShapeSpec("tiny_train", 16, 4, "train")
OPT = OptimizerConfig(learning_rate=2e-3, warmup_steps=3, total_steps=20,
                      weight_decay=0.1, clip_norm=0.5)
#: case -> (arch, smoke-config overrides, moe_buffer_mode)
CASES = {
    "qwen": ("qwen2.5-3b", {}, "ep"),
    "qwen_kv1": ("qwen2.5-3b", {"n_kv_heads": 1}, "ep"),
    "qwen_odd": ("qwen2.5-3b", {"n_heads": 3, "n_kv_heads": 1,
                                "d_ff": 129}, "ep"),
    "falcon": ("falcon-mamba-7b", {}, "ep"),
    "falcon_odd": ("falcon-mamba-7b", {"d_model": 63, "ssm_expand": 1},
                   "ep"),
    "kimi_shard_map": ("kimi-k2-1t-a32b", {}, "shard_map"),
    "kimi_none": ("kimi-k2-1t-a32b", {}, "none"),
    "jamba": ("jamba-1.5-large-398b", {"d_ff_expert": 32}, "ep"),
    "whisper": ("whisper-base", {}, "ep"),
    "whisper_odd": ("whisper-base", {"n_heads": 3, "n_kv_heads": 3,
                                     "d_ff": 129}, "ep"),
}
#: the one-device gradient tolerance where 1e-4 is below float32's
#: resolution of the step (see above)
ONE_DEVICE_TOL = {"whisper": 2e-3}
TIMEOUT_S = 300


def _cfg(case):
    arch, over, _ = CASES[case]
    return get_config(arch, smoke=True).replace(dtype="float32", **over)


def _pcfg(case, sp):
    return ParallelConfig(shard_sequence=sp, moe_buffer_mode=CASES[case][2])


def _with_cross(cfg, batch, step):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=2, global_batch=1, seed=step))
    pipe._step = step
    batch = {k: v.numpy() if isinstance(v, torch.Tensor) else v
             for k, v in batch.items()}
    return {k: torch.as_tensor(v)
            for k, v in pipe.with_frontend_stubs(batch, cfg).items()}


def _prompt_batch(cfg):
    rng = np.random.default_rng(3)
    return _with_cross(cfg, {"tokens": rng.integers(0, cfg.vocab_size,
                                                    (B, S))}, 1)


def _train_batch(cfg):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN.seq_len + 1,
        global_batch=TRAIN.global_batch, seed=0))
    return _with_cross(cfg, {k: v[:, :TRAIN.seq_len]
                             for k, v in pipe.batch_at(0).items()}, 0)


def _params(work, case):
    with np.load(os.path.join(work, f"{case}.npz")) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _run(case, mesh, params, sp):
    """One case under SP or ``no_sp``: the gathered prefill logits and
    cache and the forward's collectives, the gathered gradients of the
    train batch, and one train step's metrics and gathered state."""
    cfg = _cfg(case)
    bundle = build_model(cfg, device="cpu")
    pcfg = _pcfg(case, sp)
    out = {}
    pre = build_step(bundle, mesh, ShapeSpec("p", S, B, "prefill"),
                     pcfg=pcfg)
    args = pre.place(params, _prompt_batch(cfg), bundle.make_cache(B, S))
    with comm.recording() as rec:
        logits, cache = pre.fn(*args)
    out["collectives"] = [tuple(c) for c in rec]
    out["logits"] = pre.gather(logits, pre.out_shardings[0])
    out["cache"] = pre.gather(cache, pre.out_shardings[1])

    built = build_step(bundle, mesh, TRAIN, OPT, pcfg)
    p_sh = built.in_shardings[0]["params"]
    state = {"params": {k: v.clone() for k, v in params.items()}}
    state["opt"] = init_opt_state(state["params"], OPT)
    st_l, b_l = built.place(state, _train_batch(cfg))
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in st_l["params"].items()}
    with context.activation_sharding_scope(_scope(mesh, TRAIN, pcfg, p_sh)):
        loss, _ = bundle.loss(leaves, b_l)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    out["grads"] = built.gather(dict(zip(leaves, grads)), p_sh)
    st_l, metrics = built.fn(st_l, b_l)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = built.gather(st_l, built.in_shardings[0])
    return out


def _child(rank, world, work):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/store{world}", rank=rank,
        world_size=world)
    try:
        mesh = make_mesh(MESHES[world], AXES, device="cpu")
        res = {"coords": mesh.coords}
        for case in CASES:
            params = _params(work, case)
            res[case] = {sp: _run(case, mesh, params, sp)
                         for sp in (True, False)}
        torch.save(res, os.path.join(work, f"w{world}r{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both rank groups' results and the one-device gradients: {"ranks":
    {world: [rank results]}, "grads": {case: gradients}}."""
    work = str(tmp_path_factory.mktemp("sp"))
    weights = {}
    for case in CASES:
        weights[case] = {k: v.detach() for k, v in build_model(
            _cfg(case), device="cpu").init(0).state_dict().items()}
        np.savez(os.path.join(work, f"{case}.npz"),
                 **{k: v.numpy() for k, v in weights[case].items()})
    groups = {world: mp.start_processes(_child, args=(world, work),
                                        nprocs=world, join=False,
                                        start_method="spawn")
              for world in MESHES}
    try:
        grads = {}
        for case in CASES:
            cfg = _cfg(case)
            leaves = {k: v.clone().requires_grad_()
                      for k, v in weights[case].items()}
            loss, _ = build_model(cfg, device="cpu").loss(
                leaves, _train_batch(cfg))
            grads[case] = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        deadline = time.time() + TIMEOUT_S
        for world, ctx in groups.items():
            while not ctx.join(timeout=max(deadline - time.time(), 1)):
                if time.time() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish")
    finally:
        for ctx in groups.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
    ranks = {world: [torch.load(os.path.join(work, f"w{world}r{r}.pt"),
                                weights_only=True) for r in range(world)]
             for world in MESHES}
    return {"ranks": ranks, "grads": grads}


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= tol, (what, err)


def _tree_equal(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{what}/{i}")
    else:
        assert torch.equal(a, b), what


def _ranks(run, world, case):
    for rank, res in enumerate(run["ranks"][world]):
        yield rank, res[case][True], res[case][False]


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_prefill_is_no_sp_bit_for_bit(run, world, case):
    for rank, sp, no_sp in _ranks(run, world, case):
        _tree_equal(sp["logits"], no_sp["logits"], f"{case} r{rank} logits")
        _tree_equal(sp["cache"], no_sp["cache"], f"{case} r{rank} cache")


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_train_step_matches_no_sp(run, world, case):
    """Metrics and state by tests/test_torch_mesh_steps.py's rules."""
    for rank, sp, no_sp in _ranks(run, world, case):
        want, got = no_sp["metrics"], sp["metrics"]
        assert sorted(got) == sorted(want)
        for k, rel in (("loss", 1e-5), ("ce_loss", 1e-5),
                       ("grad_norm", 1e-4), ("lr", 1e-6)):
            assert got[k] == pytest.approx(want[k], rel=rel), (rank, k)
        if "moe_drop_fraction" in want:
            assert got["moe_drop_fraction"] == want["moe_drop_fraction"]
        lr = want["lr"]
        st, wst = sp["state"], no_sp["state"]
        assert int(st["opt"]["step"]) == 1
        for k, w in wst["params"].items():
            m = wst["opt"]["m"][k]
            _close(st["opt"]["m"][k], m, 1e-4, (rank, "m", k))
            _close(st["opt"]["v"][k], wst["opt"]["v"][k], 2e-4,
                   (rank, "v", k))
            err = (st["params"][k] - w).abs()
            resolved = m.abs() > 1e-2 * float(m.abs().max())
            assert float(err.max()) <= 2 * lr, (rank, k)
            assert float(err[resolved].max()) <= 2e-2 * lr, (rank, k)


def _named(cfg, grads):
    """The gradients the SP rules decide, by name: the embedding's, every
    norm's scale (the final norms' included), whisper's ``bo``, the self
    attention's kv projections where the kv heads do not split, the MoE
    router's and the weights of the sublayers that do not split over 2."""
    names = ["embed"]
    names += [k for k in grads if k.endswith((".scale", ".mlp.bo"))]
    if cfg.n_heads % TP:
        names += [k for k in grads if ".attn." in k or ".cross." in k]
    if cfg.n_kv_heads and cfg.n_kv_heads % TP:
        names += [k for k in grads if k.endswith(
            (".attn.wk", ".attn.wv", ".attn.bk", ".attn.bv"))]
    if cfg.d_ff % TP:
        names += [k for k in grads if ".mlp." in k]
    if cfg.ssm_state and cfg.d_inner % TP:
        names += [k for k in grads if ".ssm." in k]
    if cfg.n_experts:
        names += [k for k in grads if k.endswith(".moe.router")]
    return sorted(set(names))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_gradients_are_the_one_device_gradients(run, world, case):
    cfg = _cfg(case)
    want = run["grads"][case]
    named = _named(cfg, want)
    assert {"embed", "final_norm.scale", "stack.0.norm1.scale"} <= set(named)
    if cfg.is_encdec:
        assert {"encoder.final_norm.scale", "stack.0.mlp.bo"} <= set(named)
    tol = ONE_DEVICE_TOL.get(case, 1e-4)
    for rank, sp, no_sp in _ranks(run, world, case):
        assert sorted(sp["grads"]) == sorted(want)
        for k, w in want.items():
            _close(sp["grads"][k], no_sp["grads"][k], 1e-4,
                   (rank, "no_sp", k))
            _close(sp["grads"][k], w, tol, (rank, "one device", k))
        for k in named:                 # the rules, each named
            assert float(want[k].abs().max()) > 0, k
            _close(sp["grads"][k], want[k], tol, (rank, k))


def _stacks(cfg, mode):
    """(positions, sublayers, split sublayers) of each stack that a
    prefill of S positions runs, on a "model" axis of 2 under
    ``moe_buffer_mode`` ``mode``."""
    def count(c):
        n_sub = n_split = 0
        heads = c.n_heads % TP == 0 and (c.n_kv_heads % TP == 0
                                         or TP % c.n_kv_heads == 0)
        for spec in (c.superblock_pattern()[i % c.superblock_size]
                     for i in range(c.n_layers)):
            units = [heads if spec["kind"] == "attn"
                     else c.d_inner % TP == 0]
            if spec["cross_attn"]:
                units.append(heads)
            if spec["moe"]:
                units.append(mode != "none" and c.n_experts % TP == 0)
                if c.n_shared_experts:
                    units.append(c.n_shared_experts * c.d_ff_expert % TP
                                 == 0)
                if c.dense_residual:
                    units.append(c.d_ff % TP == 0)
            elif spec["mlp"]:
                units.append(c.d_ff % TP == 0)
            n_sub += len(units)
            n_split += sum(units)
        return n_sub, n_split
    from repro_torch.models.model_zoo import encoder_config
    out = [(S,) + count(cfg)]
    if cfg.is_encdec:
        out.append((cfg.encoder_seq,) + count(encoder_config(cfg)))
    return out


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_forward_collectives(run, world, case):
    """SP against no_sp in the prefill's forward: an all-gather a
    sublayer and an encoder's exit, of each rank's last row at the
    decoder's exit, a reduce-scatter a split sublayer, no all-reduce of a
    (B_l, S, D) partial."""
    cfg = _cfg(case)
    stacks = _stacks(cfg, CASES[case][2])
    b_l = B // MESHES[world][0]
    added, dropped = collections.Counter(), collections.Counter()
    added[("all-gather", b_l * TP * cfg.d_model * 4, TP)] += 1
    for i, (n, n_sub, n_split) in enumerate(stacks):
        act = b_l * n * cfg.d_model * 4
        added[("all-gather", act, TP)] += n_sub + (i > 0)
        added[("reduce-scatter", act // TP, TP)] += n_split
        dropped[("all-reduce", act, TP)] += n_split
    assert sum(added.values()) > sum(dropped.values())
    for rank, sp, no_sp in _ranks(run, world, case):
        got, base = (collections.Counter(map(tuple, r["collectives"]))
                     for r in (sp, no_sp))
        assert got - base == +added, (rank, got - base)
        assert base - got == +dropped, (rank, base - got)
        for n, _, _ in stacks:
            assert ("all-reduce", b_l * n * cfg.d_model * 4, TP) not in got
