"""The port's FLOPs under each remat policy against the reference's.

The port's matmul FLOPs (``FlopCounterMode``) equal the reference's dot
FLOPs (``roofline.analysis.hlo_flops_and_bytes`` on its compiled
one-device step), at the smoke configs in float32, exactly:

- ``make_train_step`` under "nothing", "dots" and "full".  Where the
  head is not tied to the embedding the port has one more LM-head
  forward, exactly 2 B S d_model vocab: its chunked cross-entropy
  recomputes the chunk's logits in the backward, as the reference's
  ``jax.checkpoint``ed chunk does, and the reference's compiled step
  keeps that recompute only for the tied heads (qwen2.5-3b,
  falcon-mamba-7b; the reference's step body jitted off its mesh drops
  it for those too);
- "nothing" recomputes every superblock's matmuls, "dots" none of them,
  "dots_no_batch" its batched ones (the port alone);
- prefill and decode (kimi-k2 under the MoE modes the reference's
  host-mesh step lowers: "none" and "shard_map").
"""

import pytest
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.dryrun import step_args
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.parallel import ParallelConfig, build_step
from repro_torch.train.optimizer import OptimizerConfig

FLOP_ARCHS = ("qwen2.5-3b", "falcon-mamba-7b", "whisper-base",
              "llama-3.2-vision-90b")
TRAIN = ShapeSpec("tiny_train", 32, 4, "train")
PREFILL = ShapeSpec("tiny_prefill", 32, 2, "prefill")
DECODE = ShapeSpec("tiny_decode", 32, 2, "decode")


@pytest.fixture(scope="module")
def jx():
    """The JAX package (imported here: the card's machine has no JAX)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.configs.shapes import ShapeSpec as JaxShape
    from repro.launch.mesh import make_host_mesh as jax_mesh
    from repro.models import build_model as jax_build_model
    from repro.parallel import ParallelConfig as JaxPcfg
    from repro.parallel import build_step as jax_build_step
    from repro.roofline.analysis import hlo_flops_and_bytes
    from repro.train.optimizer import OptimizerConfig as JaxOpt
    return dict(jax=jax, get_config=jax_get_config, shape=JaxShape,
                mesh=jax_mesh, build_model=jax_build_model, pcfg=JaxPcfg,
                build_step=jax_build_step, flops=hlo_flops_and_bytes,
                opt=JaxOpt)


def _cfg(arch, policy="full"):
    return get_config(arch, smoke=True).replace(dtype="float32",
                                                remat_policy=policy)


def _port_flops(cfg, shape, pcfg=None):
    bundle = build_model(cfg, device="cpu")
    mesh = make_host_mesh(device="cpu")
    step = build_step(bundle, mesh, shape, opt_cfg=OptimizerConfig(),
                      pcfg=pcfg, impl="ref")
    args = step_args(step, shape, mesh)
    with FlopCounterMode(display=False) as fc:
        step.fn(*args)
    return fc.get_total_flops()


def _ref_flops(jx, arch, shape, policy="full", moe_mode=None):
    jcfg = jx["get_config"](arch, smoke=True).replace(dtype="float32",
                                                      remat_policy=policy)
    jshape = jx["shape"](shape.name, shape.seq_len, shape.global_batch,
                         shape.kind)
    pcfg = None if moe_mode is None else jx["pcfg"](moe_buffer_mode=moe_mode)
    mesh = jx["mesh"]()
    with mesh:
        step = jx["build_step"](jx["build_model"](jcfg), mesh, jshape,
                                opt_cfg=jx["opt"](), pcfg=pcfg)
        hlo = step.fn.lower(*step.in_specs).compile().as_text()
    return jx["flops"](hlo, None)[0]


def test_remat_flops_order(jx):
    """"nothing" recomputes every superblock's matmuls, "dots" none of
    them, "dots_no_batch" its batched ones (the attention products)."""
    f = {p: _port_flops(_cfg("qwen2.5-3b", p), TRAIN)
         for p in ("full", "nothing", "dots", "dots_no_batch")}
    assert f["dots"] == f["full"] < f["dots_no_batch"] < f["nothing"]


@pytest.mark.parametrize("arch,moe_mode", [
    ("qwen2.5-3b", None), ("falcon-mamba-7b", None), ("whisper-base", None),
    ("llama-3.2-vision-90b", None), ("kimi-k2-1t-a32b", "none"),
    ("kimi-k2-1t-a32b", "shard_map")])
def test_prefill_flops_match_reference(jx, arch, moe_mode):
    """Exact."""
    pcfg = None if moe_mode is None else \
        ParallelConfig(moe_buffer_mode=moe_mode)
    assert _port_flops(_cfg(arch), PREFILL, pcfg) == \
        _ref_flops(jx, arch, PREFILL, moe_mode=moe_mode)


def test_decode_flops_match_reference(jx):
    """Exact, at the cache's last slot (the reference's compiled step
    attends over every slot, masked)."""
    assert _port_flops(_cfg("qwen2.5-3b"), DECODE) == \
        _ref_flops(jx, "qwen2.5-3b", DECODE)


@pytest.mark.parametrize("policy", ("nothing", "dots", "full"))
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_train_flops_match_reference(jx, arch, policy):
    """Exact: the port's count is the reference's plus one LM-head
    forward (2 B S d_model vocab) where the head is untied."""
    cfg = _cfg(arch, policy)
    head = 0 if cfg.tie_embeddings else \
        2 * TRAIN.global_batch * TRAIN.seq_len * cfg.d_model * cfg.vocab_size
    assert _port_flops(cfg, TRAIN) == _ref_flops(jx, arch, TRAIN,
                                                 policy) + head
