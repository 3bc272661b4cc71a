"""Serving path of the port's LM stack against the JAX model zoo, on the CPU.

JAX parameters of the smoke configs go through
``repro_torch.models.params_from_jax``, and the same prompt (numpy, from
a seed) goes through JAX's ``bundle.prefill`` / ``bundle.decode``
(``impl="ref"``) and the port's, with the JAX run's greedy tokens fed to
both.  Models: qwen2.5-3b (dense GQA, QKV bias, tied head), falcon-mamba-7b
(pure Mamba), jamba's pattern with the MoE switched off and two
superblocks (attention + Mamba, mixed caches, superblock unstacking), and
the three MoE configs: kimi-k2 (8 experts top-2 and a shared expert, two
superblocks of one layer), arctic (4 experts top-2 and a dense residual
MLP) and jamba with its MoE (attention + Mamba + MoE in one superblock).

Tolerances, relative to the largest magnitude of the reference tensor:
- float32: 1e-4 (another summation order in every product), end to end.
- bfloat16: 2e-2, and 3e-2 for the fp32 Mamba state, which integrates
  bf16 inputs over the prompt (the bf16 scan tolerance of
  ``tests/test_kernels.py``).  bf16 rounds at other places in the two
  frameworks (XLA:CPU keeps fp32 between fused elementwise ops; the port
  rounds once at the end of each elementwise chain).  With random weights
  the attention scores are in the hundreds, so softmax is nearly one-hot
  and a rounding flip between two close keys changes a head's output
  wholesale; across layers that grows until JAX's own bf16 run is far
  from its float32 run on the same weights.  So in bf16 each layer is
  held on its own -- fed the JAX layer's input, it must give the JAX
  layer's output and cache -- and the pure-Mamba model, which has no
  such flips, is also held end to end.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.model_zoo import unported_reason
from repro_torch.models.module import tree_param_count, tree_paths

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import embed as jax_embed  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.models.model_zoo import _logits as jax_logits  # noqa: E402
from repro.models.transformer import apply_layer  # noqa: E402

B, S, S_MAX, STEPS = 2, 12, 20, 4
MODELS = {
    "qwen2.5-3b": {},
    "falcon-mamba-7b": {},
    "jamba-1.5-large-398b": {"n_experts": 0, "n_layers": 16},
    "kimi-k2-1t-a32b": {},
    "arctic-480b": {},
    "jamba-1.5-large-398b-moe": {},
}
#: the config a MODELS key names, where the key is not an arch id
ARCH = {"jamba-1.5-large-398b-moe": "jamba-1.5-large-398b"}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: the archs the port refused before its MoE and cross-attention layers
#: were ported (the ids of test_unported_families_refused)
UNPORTED_BEFORE_MOE = [a for a in ARCH_IDS
                       if get_config(a).n_experts > 0
                       or get_config(a).is_encdec
                       or get_config(a).cross_attn_period > 0]


def _cfgs(key, dtype):
    arch, kw = ARCH.get(key, key), dict(MODELS[key], dtype=dtype)
    return (jax_get_config(arch, smoke=True).replace(**kw),
            get_config(arch, smoke=True).replace(**kw))


def _np(a):
    return np.array(a.float() if isinstance(a, torch.Tensor)
                    else jnp.asarray(a, jnp.float32))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of the scale > {tol}"


def _tokens(vocab):
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, (B, S + STEPS)).astype(np.int32)


def _port_model(tcfg, params):
    bundle = build_model(tcfg, device="cpu")
    model = bundle.init(0)
    model.load_state_dict(params_from_jax(tcfg,
                                          jax.tree.map(np.asarray, params)))
    return bundle, model


def _layer_cache(jcache, cfg, i):
    """Layer i's slice of JAX's stacked cache."""
    size = cfg.superblock_size
    return jax.tree.map(lambda a: a[i // size], jcache[f"layer{i % size}"])


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    """JAX bundle and params, and the port's bundle and model loaded with
    them (built once per module run)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jb = jax_build_model(jcfg)
    params = jb.init(jax.random.PRNGKey(0))
    bundle, model = _port_model(tcfg, params)
    return jcfg, tcfg, jb, params, bundle, model


def _cache_tol(dtype, name):
    return 3e-2 if dtype == "bfloat16" and name == "ssm" else TOL[dtype]


END_TO_END = [(a, "float32") for a in MODELS] + [("falcon-mamba-7b",
                                                  "bfloat16")]


@pytest.mark.parametrize("arch,dtype", END_TO_END)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Logits and caches after prefill, then 4 decode steps of logits."""
    jcfg, tcfg, jb, params, bundle, model = _setup(arch, dtype)
    tol = TOL[dtype]
    toks = _tokens(jcfg.vocab_size)
    prefill = jax.jit(lambda p, t, c: jb.prefill(p, {"tokens": t}, c,
                                                 impl="ref"))
    decode = jax.jit(lambda p, t, c, pos: jb.decode(p, t, c, pos,
                                                    impl="ref"))
    j_logits, j_cache = prefill(params, jnp.asarray(toks[:, :S]),
                                jb.make_cache(B, S_MAX))
    cache = bundle.make_cache(B, S_MAX)
    t_logits, cache = bundle.prefill(
        model, {"tokens": torch.as_tensor(toks[:, :S])}, cache)
    _close(t_logits, j_logits, tol, "prefill logits")
    for i, layer in enumerate(cache):
        for kind, entries in layer.items():
            for name, t in entries.items():
                want = _layer_cache(j_cache, jcfg, i)[kind][name]
                _close(t, want, _cache_tol(dtype, name),
                       f"layer {i} cache {kind}/{name}")
    for pos in range(S, S + STEPS):
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1)).astype(np.int32)
        j_logits, j_cache = decode(params, jnp.asarray(tok[:, None]),
                                   j_cache, jnp.int32(pos))
        t_logits, cache = bundle.decode(
            model, torch.as_tensor(tok[:, None]), cache, pos)
        assert torch.isfinite(t_logits).all()
        _close(t_logits, j_logits, tol, f"decode logits at {pos}")


@pytest.mark.parametrize("arch", list(MODELS))
def test_layers_match_jax_bf16(arch):
    """Each layer, fed the JAX layer's bf16 input, gives its output in
    prefill and 4 decode steps, and its cache after the prefill and after
    the last step; then the final norm and head give JAX's logits from
    JAX's last hidden state."""
    jcfg, tcfg, jb, params, bundle, model = _setup(arch, "bfloat16")
    tol = TOL["bfloat16"]
    pattern, size = jcfg.superblock_pattern(), jcfg.superblock_size
    j_cache = jb.make_cache(B, S_MAX)
    j_caches = [_layer_cache(j_cache, jcfg, i) for i in range(jcfg.n_layers)]
    j_params = [jax.tree.map(lambda a, i=i: a[i // size],
                             params["stack"][f"layer{i % size}"])
                for i in range(jcfg.n_layers)]
    layer_fns = {
        j: jax.jit(lambda p, x, c, pos, spec=spec: apply_layer(
            p, jcfg, spec, x, cross_src=None, cache=c, pos=pos,
            causal=True, impl="ref")[:2])
        for j, spec in enumerate(pattern)}
    cache = bundle.make_cache(B, S_MAX)
    toks = _tokens(jcfg.vocab_size)
    spans = [(0, S)] + [(p, p + 1) for p in range(S, S + STEPS)]
    for lo, hi in spans:
        x = jax_embed(params["embed"], jnp.asarray(toks[:, lo:hi]))
        for i, layer in enumerate(model.stack):
            xt = torch.as_tensor(_np(x)).to(torch.bfloat16)
            x, j_caches[i] = layer_fns[i % size](j_params[i], x, j_caches[i],
                                                 jnp.int32(lo))
            with torch.no_grad():
                yt = layer(xt, cache=cache[i], pos=lo, causal=True,
                           impl=None)
            _close(yt, x, tol, f"layer {i} output at positions {lo}..{hi}")
            if hi not in (S, S + STEPS):      # caches after prefill and last
                continue
            for kind, entries in cache[i].items():
                for name, t in entries.items():
                    _close(t, j_caches[i][kind][name],
                           _cache_tol("bfloat16", name),
                           f"layer {i} cache {kind}/{name} after {hi}")
        with torch.no_grad():
            xt = torch.as_tensor(_np(x[:, -1:])).to(torch.bfloat16)
            t_logits = model._logits(model.final_norm(xt))
        j_logits = jax_logits(params, jcfg,
                              jax_rmsnorm(params["final_norm"], x[:, -1:],
                                          jcfg.norm_eps))
        _close(t_logits, j_logits, tol, f"logits after {hi}")


@pytest.mark.parametrize("arch", list(MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(arch, dtype):
    """The port's own init has the JAX tree's paths (unstacked), shapes
    and dtypes, and the config's parameter count."""
    jcfg, tcfg = _cfgs(arch, dtype)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    bundle = build_model(tcfg, device="cpu")
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    got = dict(bundle.init(1).state_dict())
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.shape == want[k].shape and t.dtype == want[k].dtype, k
    assert tree_param_count(got) == tcfg.param_count()
    n_jax = sum(int(np.asarray(v).size) for _, v in
                tree_paths(jax.tree.map(np.asarray, params)))
    assert tree_param_count(got) == n_jax


def test_non_swiglu_mlp_refused():
    """The reference's GELU MLP, once refused, now builds in a
    decoder-only config too, and its MLP gives the reference's output."""
    from repro.models.layers import mlp as jax_mlp
    jcfg, tcfg = _cfgs("qwen2.5-3b", "float32")
    jcfg, tcfg = jcfg.replace(act="gelu"), tcfg.replace(act="gelu")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    _, model = _port_model(tcfg, params)
    x = np.random.default_rng(1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    want = jax_mlp(jax.tree.map(lambda a: a[0], params["stack"]["layer0"])
                   ["mlp"], jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = model.stack[0].mlp(torch.as_tensor(x))
    _close(got, want, TOL["float32"], "gelu MLP")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_jax(arch):
    """The port's copies of the configs are the reference's, field by
    field, full and smoke."""
    import dataclasses
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke)) ==
                dataclasses.asdict(jax_get_config(arch, smoke)))


@pytest.mark.parametrize("arch", UNPORTED_BEFORE_MOE)
def test_unported_families_refused(arch):
    """The MoE, encoder-decoder and VLM configs, refused before their
    layers were ported, build on the CPU and their prefill (given the
    frames or image embeddings their cross-attention reads) gives finite
    logits."""
    cfg = get_config(arch, smoke=True)
    assert unported_reason(cfg) is None
    bundle = build_model(cfg, device="cpu")
    batch = {"tokens": torch.as_tensor(_tokens(cfg.vocab_size)[:, :S])}
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model))
    elif cfg.cross_attn_period > 0:
        batch["image_embeds"] = torch.ones((B, cfg.n_image_tokens,
                                            cfg.d_image))
    logits, _ = bundle.prefill(bundle.init(0), batch,
                               bundle.make_cache(B, S_MAX))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_served_architectures():
    served = [a for a in ARCH_IDS if unported_reason(get_config(a)) is None]
    assert served == list(ARCH_IDS) and len(served) == 10


def test_params_from_jax_refuses_wrong_shapes():
    jcfg, tcfg = _cfgs("qwen2.5-3b", "float32")
    tree = jax.tree.map(np.asarray,
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed has shape"):
        params_from_jax(tcfg, tree)
    del tree["embed"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tcfg, tree)


def test_default_device_is_cuda():
    """Without a device the bundle is on the card, and without a card the
    call raises unless ``device="cpu"`` is given."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_cache_overflow_refused():
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype="float32")
    bundle = build_model(cfg, device="cpu")
    model = bundle.init(0)
    cache = bundle.make_cache(1, 4)
    toks = torch.zeros((1, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="do not fit a cache"):
        bundle.prefill(model, {"tokens": toks}, cache)


def test_cross_attention_inputs_refused():
    """A model without cross-attention layers refuses their inputs."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    bundle = build_model(cfg, device="cpu")
    model = bundle.init(0)
    with pytest.raises(ValueError, match="no cross-attention"):
        bundle.prefill(model, {"tokens": torch.zeros((1, 2), dtype=torch.long),
                               "frames": torch.zeros((1, 2, 64))},
                       bundle.make_cache(1, 4))
