"""The port's dry run (``launch.dryrun``) and its variants
(``launch.perf``).

- Real gloo ranks against the fake world: 4 ranks on a (2, 2) mesh over
  ("data", "model"), spawned with ``torch.multiprocessing`` and a file
  store, each run qwen2.5-3b's smoke config (float32) through a train, a
  prefill and a decode step under the dry run's counters; every rank's
  matmul FLOPs, HBM bytes and collectives (kind, bytes, group size, in
  order) equal the fake-world trace of that rank, exactly.
- Two full-size production cells trace OK, and their argument bytes are
  the sum of the reference's shard shapes (its ``build_step`` on a JAX
  ``AbstractMesh``), exactly; a SKIP cell carries the reference's
  reason; the CLI writes a cell's record.
- The (1, 2) decode of qwen2.5-3b all-gathers the 622 MB embedding twice
  a step (the lookup and the tied head).
- ``perf.run_variant`` writes the traced and the kernelized terms;
  ``no_sp`` (the mesh steps without sequence parallelism) writes its
  record: qwen2.5-3b train_4k on 16x16 holds more a rank than the
  baseline, and its forward (a 2-layer cut traced as a prefill of the
  cell's 16 x 4,096 rows a rank) all-reduces each split sublayer's
  float32 partials where the baseline reduce-scatters them and
  all-gathers the bf16 activation.

Every fake world is torn down by the dry run's context manager; the
fixture below fails a test that leaves a process group behind.
"""

import collections
import json
import os
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import SHAPES, applicable, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel import ParallelConfig, build_step

MESH = ((2, 2), ("data", "model"))
SHAPES_SMOKE = {"train": ShapeSpec("tiny_train", 16, 4, "train"),
                "prefill": ShapeSpec("tiny_prefill", 16, 4, "prefill"),
                "decode": ShapeSpec("tiny_decode", 16, 4, "decode")}
TIMEOUT_S = 300


def _cfg():
    return get_config("qwen2.5-3b", smoke=True).replace(dtype="float32")


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    left = dist.is_initialized()
    if left:
        dist.destroy_process_group()
    assert not left, "a test left a process group initialised"


def _key(tr):
    return {"flops": tr.flops, "nbytes": tr.nbytes,
            "collectives": [tuple(c) for c in tr.collectives]}


def _rank_traces(rank, world):
    mesh = make_mesh(*MESH, device="cpu")
    cfg = _cfg()
    bundle = build_model(cfg, device="cpu")
    out = {}
    for kind, shape in SHAPES_SMOKE.items():
        step = build_step(bundle, mesh, shape,
                          opt_cfg=dryrun.opt_config_for(cfg), impl="ref")
        args = dryrun.step_args(step, shape, mesh)
        out[kind] = _key(dryrun.trace_step(step.fn, args))
    return out


def _child(rank, world, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(work, f"r{rank}.json"), "w") as f:
            json.dump(_rank_traces(rank, world), f)
    finally:
        dist.destroy_process_group()


def test_real_ranks_match_their_fake_traces(tmp_path):
    """Exact: FLOPs, bytes and the collectives in order, each rank."""
    world = 4
    ctx = mp.start_processes(_child, args=(world, str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    try:
        fake = {r: {kind: _key(dryrun.trace_rank(
            _cfg(), shape, "2x2", rank=r))
            for kind, shape in SHAPES_SMOKE.items()} for r in range(world)}
        deadline = time.time() + TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.time(), 1)):
            if time.time() > deadline:
                raise TimeoutError("the ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    kinds_seen = set()
    for r in range(world):
        with open(tmp_path / f"r{r}.json") as f:
            real = json.load(f)
        for kind in SHAPES_SMOKE:
            got = real[kind]
            got["collectives"] = [tuple(c) for c in got["collectives"]]
            assert got == fake[r][kind], (r, kind)
            assert got["flops"] > 0 and got["nbytes"] > 0
            kinds_seen |= {c[0] for c in got["collectives"]}
    # FSDP gathers, their reduce-scatter (gloo: an all-reduce and a
    # slice, recorded as asked) and the "model" all-reduces
    assert kinds_seen == {"all-gather", "reduce-scatter", "all-reduce"}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import applicable as jax_applicable
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.parallel import build_step as jax_build_step
    return dict(jax=jax, AbstractMesh=AbstractMesh,
                NamedSharding=NamedSharding, get_config=jax_get_config,
                build_model=jax_build_model, build_step=jax_build_step,
                applicable=jax_applicable)


def _reference_arg_bytes(jx, arch, shape_name, mesh_name):
    import math
    sizes, axes = dryrun.mesh_layout(mesh_name)
    try:
        mesh = jx["AbstractMesh"](sizes, axes)
    except TypeError:   # jax 0.4.x takes ((name, size), ...)
        mesh = jx["AbstractMesh"](tuple(zip(axes, sizes)))
    step = jx["build_step"](jx["build_model"](jx["get_config"](arch)), mesh,
                            SHAPES[shape_name])
    specs = jx["jax"].tree.leaves(step.in_specs)
    shardings = jx["jax"].tree.leaves(
        step.in_shardings,
        is_leaf=lambda x: isinstance(x, jx["NamedSharding"]))
    assert len(specs) == len(shardings)
    return sum(math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
               for s, sh in zip(specs, shardings))


@pytest.mark.parametrize("arch,shape,mesh", [
    ("whisper-base", "prefill_32k", "16x16"),
    ("qwen2.5-3b", "prefill_32k", "2x16x16")])
def test_production_cells(jx, arch, shape, mesh):
    """OK, with every field of the record; arg_bytes exact."""
    rec = dryrun.run_cell(arch, shape, mesh == "2x16x16", verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["n_chips"] == (512 if mesh == "2x16x16" else 256)
    assert rec["arg_bytes"] == _reference_arg_bytes(jx, arch, shape, mesh)
    assert rec["temp_bytes"] > 0 and rec["counted_flops"] > 0
    assert rec["per_device_resident_gb"] == round(
        (rec["arg_bytes"] + rec["temp_bytes"]) / 1e9, 3)
    r = rec["roofline"]
    assert r["hlo_flops"] >= rec["counted_flops"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert set(rec["collectives"]) == set(r["collectives"])
    assert r["fits_hbm"] == (r["per_device_hbm"] <= 80e9)


def test_skip_cell_has_the_references_reason(jx):
    rec = dryrun.run_cell("qwen2.5-3b", "long_500k", False, verbose=False)
    ok, reason = jx["applicable"](jx["get_config"]("qwen2.5-3b"),
                                  SHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": "qwen2.5-3b", "shape": "long_500k",
                   "mesh": "16x16", "status": "SKIP", "reason": reason}
    assert applicable(get_config("qwen2.5-3b"), SHAPES["long_500k"]) == \
        (ok, reason)


def test_two_rank_decode_gathers_the_embedding_twice():
    """qwen2.5-3b decode_32k on (1, 2): the vocab-sharded embedding (151,936
    x 2,048 bf16, 622 MB) is all-gathered for the lookup and again for
    the tied head."""
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", "1x2", verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["collectives"]["all-gather"] == {
        "count": 2, "bytes": 2 * 151936 * 2048 * 2}


def test_cli_writes_a_cell(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "1 OK, 0 SKIP, 0 FAIL" in done.stdout
    (rec,) = json.loads(out.read_text())
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == (
        "whisper-base", "decode_32k", "16x16", "OK")
    assert "jax" not in done.stdout + done.stderr


def test_perf_baseline_and_kernelized():
    rec = perf.run_variant("whisper-base", "prefill_32k", "baseline")
    assert (rec["variant"], rec["mesh"]) == ("baseline", "16x16")
    k, r = rec["kernelized"], rec["roofline"]
    assert k["collective_s"] == r["collective_s"]
    # the kernels keep the plain attention's score tensors off HBM
    assert 0 < k["memory_s"] < r["memory_s"]
    assert k["bottleneck"] in ("compute", "memory", "collective")


def test_perf_refuses_no_sp():
    """What replaced the refusal: ``no_sp``'s record and its forward."""
    base = perf.run_variant("qwen2.5-3b", "train_4k", "baseline")
    rec = perf.run_variant("qwen2.5-3b", "train_4k", "no_sp")
    assert (rec["arch"], rec["shape"], rec["variant"], rec["mesh"]) == (
        "qwen2.5-3b", "train_4k", "no_sp", "16x16")
    assert rec["per_device_resident_gb"] > base["per_device_resident_gb"]
    assert rec["roofline"]["collectives"] != base["roofline"]["collectives"]
    cfg = get_config("qwen2.5-3b").replace(n_layers=2)
    fwd = ShapeSpec("fwd", SHAPES["train_4k"].seq_len,
                    SHAPES["train_4k"].global_batch, "prefill")
    b_l = fwd.global_batch // 16
    act = b_l * fwd.seq_len * cfg.d_model           # a rank's (B_l, S, D)
    traced = {sp: collections.Counter(map(tuple, dryrun.trace_rank(
        cfg, fwd, "16x16", ParallelConfig(shard_sequence=sp)).collectives))
        for sp in (True, False)}
    # two split sublayers a layer (attention, MLP); the gathers one each,
    # and at the stack's exit one of each rank's last row
    assert traced[False] - traced[True] == {("all-reduce", act * 4, 16): 4}
    assert traced[True] - traced[False] == {
        ("reduce-scatter", act * 4 // 16, 16): 4,
        ("all-gather", act * 2, 16): 4,
        ("all-gather", b_l * 16 * cfg.d_model * 2, 16): 1}
    with pytest.raises(ValueError, match="unknown variant"):
        perf.run_variant("qwen2.5-3b", "train_4k", "no_such_variant")
