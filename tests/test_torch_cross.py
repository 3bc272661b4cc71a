"""Cross-attention of the port against the JAX package, on the CPU.

whisper-base (encoder-decoder: an encoder over stubbed audio frames,
cross-attention in every decoder layer, the GELU MLP) and
llama-3.2-vision-90b (VLM: stubbed patch embeddings through ``img_proj``,
cross-attention in every fifth layer), at their smoke sizes.  The same
numpy inputs go through the JAX functions (``impl="ref"``) and the port's
(``device="cpu"``, the kernels' plain versions), the JAX weights carried
across by ``params_from_jax``.  Card-only cases (``gpu``) hold the CUDA
attention kernel against ``attention_ref`` at the shapes this slice adds
to the serving path.

Tolerances, relative to the largest magnitude of the reference tensor
(those of ``tests/test_torch_models.py``):
- float32: 1e-4 (another summation order in every product), end to end;
- bfloat16: 2e-2, a layer at a time.  With random weights the attention
  softmax is nearly one-hot, so one bf16 rounding that the two frameworks
  place differently flips a head's output wholesale and grows across
  layers (measured 3-10% end to end for the decoders, 3% for the
  two-layer encoder); so in bf16 each layer is fed the JAX layer's input
  and must give its output and caches.
The float32 frames that ``with_frontend_stubs`` makes run the whole
whisper encoder in float32 inside a bf16 model, as JAX promotes them, so
that source is held at 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.layers import MLP, Attention
from repro_torch.models.model_zoo import (cross_input_key, decayed_names,
                                          encoder_config)

torch.set_num_threads(1)

CROSS_ARCHS = ("whisper-base", "llama-3.2-vision-90b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, S_MAX, STEPS = 2, 12, 20, 3
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: the card's machine has
    no JAX), and a cache of built models."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.models import layers as jlayers
    from repro.models.model_zoo import _cross_source
    from repro.models.model_zoo import encoder_config as jax_encoder_config
    from repro.models.transformer import apply_layer
    return dict(jax=jax, jnp=jax.numpy, get_config=jax_get_config,
                build_model=jax_build_model, layers=jlayers,
                cross_source=_cross_source, apply_layer=apply_layer,
                encoder_config=jax_encoder_config, built={})


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(np.asarray(a, dtype=np.float32))


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert np.isfinite(got).all() and err <= tol, \
        f"{what}: {err:.3e} of the scale > {tol}"


def _jnp(jx, a, dtype):
    return jx["jnp"].asarray(a, getattr(jx["jnp"], dtype))


def _torch(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype])


def _setup(jx, arch, dtype):
    """The JAX config, bundle and params and the port's bundle and model
    loaded with them (built once a module run)."""
    key = (arch, dtype)
    if key not in jx["built"]:
        jcfg = jx["get_config"](arch, smoke=True).replace(dtype=dtype)
        tcfg = get_config(arch, smoke=True).replace(dtype=dtype)
        jb = jx["build_model"](jcfg)
        params = jb.init(jx["jax"].random.PRNGKey(0))
        bundle = build_model(tcfg, device="cpu")
        model = bundle.init(1)
        model.load_state_dict(params_from_jax(
            tcfg, jx["jax"].tree.map(np.asarray, params)))
        jx["built"][key] = (jcfg, tcfg, jb, params, bundle, model)
    return jx["built"][key]


def _cross_input(cfg, seed=0):
    """Frames (B, encoder_seq, D) or image embeddings (B, n_image, d_image)
    as ``with_frontend_stubs`` scales them, float32 numpy."""
    shape = ((B, cfg.encoder_seq, cfg.d_model) if cfg.is_encdec
             else (B, cfg.n_image_tokens, cfg.d_image))
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _tokens(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)


def _layer(jx, tree, i, size):
    """Layer i's parameters of a stacked JAX tree."""
    return jx["jax"].tree.map(lambda a: a[i // size], tree[f"layer{i % size}"])


# ---------------------------------------------------------------------------
# the two modules: the GELU MLP and the cross branch of Attention
# ---------------------------------------------------------------------------

def _load(module, tree):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.tensor(np.asarray(tree[name], np.float32)))


def _random_biases(jx, tree, names, dtype, seed):
    rng = np.random.default_rng(seed)
    for n in names:
        tree[n] = _jnp(jx, rng.standard_normal(tree[n].shape) * 0.5, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(jx, dtype):
    """``act="gelu"``: gelu(x @ wi + bi) @ wo_mlp + bo with JAX's tanh
    GELU, nonzero biases; the parameters under the reference's names."""
    jcfg = jx["get_config"]("whisper-base", smoke=True)
    tcfg = get_config("whisper-base", smoke=True)
    jdt = getattr(jx["jnp"], dtype)
    tree = dict(jx["layers"].init_mlp(jx["jax"].random.PRNGKey(3), jcfg,
                                      jcfg.d_ff, "mlp", jdt))
    _random_biases(jx, tree, ("bi", "bo"), dtype, 4)
    mlp = MLP(tcfg, tcfg.d_ff, device="cpu", dtype=TORCH_DT[dtype])
    assert sorted(n for n, _ in mlp.named_parameters()) == sorted(tree)
    _load(mlp, tree)
    x = np.random.default_rng(5).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    want = jx["layers"].mlp(tree, jcfg, _jnp(jx, x, dtype))
    got = mlp(_torch(x, dtype))
    assert got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype], "gelu MLP")


#: (mode, model dtype, source dtype): training (no cache; a bf16 model's
#: queries over a float32 source, as whisper's float32 encoder gives
#: them, included), prefill (the cache written) and decode (from it)
ATTN_MODES = [("train", "float32", "float32"),
              ("train", "bfloat16", "bfloat16"),
              ("train", "bfloat16", "float32"),
              ("prefill", "float32", "float32"),
              ("prefill", "bfloat16", "float32"),
              ("decode", "float32", "float32"),
              ("decode", "bfloat16", "bfloat16")]


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("mode,dtype,src_dtype", ATTN_MODES)
def test_cross_attention_matches_jax(jx, mode, dtype, src_dtype, qkv_bias):
    """The cross branch of ``Attention`` against the reference's
    ``attention(..., cross=True)``: no RoPE, every key visible, biases
    where ``qkv_bias``; the output, and the cross cache prefill writes
    in place (cast to its dtype)."""
    jcfg = jx["get_config"]("llama-3.2-vision-90b", smoke=True).replace(
        qkv_bias=qkv_bias)
    tcfg = get_config("llama-3.2-vision-90b", smoke=True).replace(
        qkv_bias=qkv_bias)
    jdt = getattr(jx["jnp"], dtype)
    tree = dict(jx["layers"].init_attention(jx["jax"].random.PRNGKey(7),
                                            jcfg, "cross", jdt))
    if qkv_bias:
        _random_biases(jx, tree, ("bq", "bk", "bv"), dtype, 8)
    attn = Attention(tcfg, device="cpu", dtype=TORCH_DT[dtype], cross=True)
    _load(attn, tree)
    rng = np.random.default_rng(9)
    L, Hkv, hd = 16, tcfg.n_kv_heads, tcfg.head_dim
    x = rng.standard_normal((B, 1 if mode == "decode" else S,
                             jcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
    jxx, tx = _jnp(jx, x, dtype), _torch(x, dtype)
    if mode == "train":
        want, _ = jx["layers"].attention(tree, jcfg, jxx, cross=True,
                                         kv_src=_jnp(jx, src, src_dtype),
                                         impl="ref")
        got = attn(tx, cache=None, kv_src=_torch(src, src_dtype))
    elif mode == "prefill":
        zeros = np.zeros((B, L, Hkv, hd), np.float32)
        jcache = {"k": _jnp(jx, zeros, dtype), "v": _jnp(jx, zeros, dtype)}
        cache = {"k": _torch(zeros, dtype), "v": _torch(zeros, dtype)}
        want, jnew = jx["layers"].attention(
            tree, jcfg, jxx, cross=True, kv_src=_jnp(jx, src, src_dtype),
            cache=jcache, impl="ref")
        got = attn(tx, cache=cache, kv_src=_torch(src, src_dtype))
        for name in ("k", "v"):
            assert cache[name].dtype == TORCH_DT[dtype]
            _close(cache[name], jnew[name], TOL[dtype], f"cross cache {name}")
    else:
        kv = [rng.standard_normal((B, L, Hkv, hd)).astype(np.float32)
              for _ in range(2)]
        jcache = {"k": _jnp(jx, kv[0], dtype), "v": _jnp(jx, kv[1], dtype)}
        cache = {"k": _torch(kv[0], dtype), "v": _torch(kv[1], dtype)}
        want, _ = jx["layers"].attention(tree, jcfg, jxx, cross=True,
                                         cache=jcache, impl="ref")
        got = attn(tx, cache=cache)
    assert got.dtype == TORCH_DT[dtype]
    _close(got, want, TOL[dtype], f"cross-attention {mode}")


# ---------------------------------------------------------------------------
# the cross source: the encoder, the image projection
# ---------------------------------------------------------------------------

#: (arch, model dtype, input dtype)
SOURCES = [("whisper-base", "float32", "float32"),
           ("whisper-base", "bfloat16", "float32"),
           ("whisper-base", "bfloat16", "bfloat16"),
           ("llama-3.2-vision-90b", "float32", "float32"),
           ("llama-3.2-vision-90b", "bfloat16", "float32")]


@pytest.mark.parametrize("arch,dtype,in_dtype", SOURCES)
def test_cross_source_matches_jax(jx, arch, dtype, in_dtype):
    """``LM.cross_source`` against the reference's ``_cross_source``:
    whisper's encoder (float32 frames in a bf16 model run it in float32,
    as JAX promotes them; bf16 frames a layer at a time), llama-vision's
    ``img_proj`` then the cast to the model's dtype."""
    jcfg, tcfg, _, params, _, model = _setup(jx, arch, dtype)
    x = _cross_input(tcfg)
    jin, tin = _jnp(jx, x, in_dtype), _torch(x, in_dtype)
    want = jx["cross_source"](params, jcfg, {cross_input_key(tcfg): jin},
                              "ref")
    with torch.no_grad():
        got = model.cross_source(tin)
    assert str(got.dtype)[6:] == str(want.dtype)
    tol = TOL["float32" if want.dtype == jx["jnp"].float32 else "bfloat16"]
    if not (arch == "whisper-base" and in_dtype == "bfloat16"):
        _close(got, want, tol, f"{arch} cross source")
        return
    enc_cfg = jx["encoder_config"](jcfg)
    spec = enc_cfg.superblock_pattern()[0]
    h = jin
    for i, layer in enumerate(model.encoder.stack):
        th = _torch(h, "bfloat16")
        h, _, _ = jx["apply_layer"](
            _layer(jx, params["encoder"]["stack"], i, 1), enc_cfg, spec, h,
            cross_src=None, cache=None, pos=0, causal=False, impl="ref")
        with torch.no_grad():
            out = layer(th, cache=None, pos=0, causal=False, impl=None)
        _close(out, h, tol, f"encoder layer {i}")
    want = jx["layers"].rmsnorm(params["encoder"]["final_norm"], h,
                                jcfg.norm_eps)
    with torch.no_grad():
        got = model.encoder.final_norm(_torch(h, "bfloat16"))
    _close(got, want, tol, "encoder final norm")


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _jax_serve(jx, jb):
    jax = jx["jax"]
    key = {True: "frames", False: "image_embeds"}[jb.cfg.is_encdec]
    prefill = jax.jit(lambda p, t, f, c: jb.prefill(
        p, {"tokens": t, key: f}, c, impl="ref"))
    decode = jax.jit(lambda p, t, c, pos: jb.decode(p, t, c, pos,
                                                    impl="ref"))
    return prefill, decode


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_prefill_and_decode_match_jax(jx, arch):
    """float32, end to end: the prefill's logits and every cache (self and
    cross), then 3 greedy decode steps' logits."""
    jcfg, tcfg, jb, params, bundle, model = _setup(jx, arch, "float32")
    jnp, tol = jx["jnp"], TOL["float32"]
    toks, x = _tokens(tcfg), _cross_input(tcfg)
    key = cross_input_key(tcfg)
    prefill, decode = _jax_serve(jx, jb)
    j_logits, j_cache = prefill(params, jnp.asarray(toks[:, :S]),
                                jnp.asarray(x), jb.make_cache(B, S_MAX))
    cache = bundle.make_cache(B, S_MAX)
    t_logits, cache = bundle.prefill(
        model, {"tokens": torch.as_tensor(toks[:, :S]),
                key: torch.as_tensor(x)}, cache)
    _close(t_logits, j_logits, tol, "prefill logits")
    size = jcfg.superblock_size
    for i, layer in enumerate(cache):
        want = _layer(jx, j_cache, i, size)
        assert sorted(layer) == sorted(want)
        for kind, entries in layer.items():
            for name, t in entries.items():
                _close(t, want[kind][name], tol, f"layer {i} {kind}/{name}")
    assert sum("cross" in layer for layer in cache) == sum(
        jcfg.layer_has_cross_attn(i) for i in range(jcfg.n_layers)) > 0
    for pos in range(S, S + STEPS):
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1)).astype(np.int32)
        j_logits, j_cache = decode(params, jnp.asarray(tok[:, None]),
                                   j_cache, jnp.int32(pos))
        t_logits, cache = bundle.decode(
            model, torch.as_tensor(tok[:, None]), cache, pos)
        _close(t_logits, j_logits, tol, f"decode logits at {pos}")


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_layers_match_jax_bf16(jx, arch):
    """bfloat16, a layer at a time: each decoder layer, fed the JAX
    layer's input and the reference's cross source, gives its output in
    the prefill and 3 decode steps (the cross layers' decode from their
    caches), and its self and cross caches after the prefill and the last
    step."""
    jcfg, tcfg, jb, params, bundle, model = _setup(jx, arch, "bfloat16")
    jnp, tol = jx["jnp"], TOL["bfloat16"]
    key = cross_input_key(tcfg)
    src = jx["cross_source"](params, jcfg,
                             {key: jnp.asarray(_cross_input(tcfg))}, "ref")
    pattern, size = jcfg.superblock_pattern(), jcfg.superblock_size
    j_cache = jb.make_cache(B, S_MAX)
    j_caches = [_layer(jx, j_cache, i, size) for i in range(jcfg.n_layers)]
    j_params = [_layer(jx, params["stack"], i, size)
                for i in range(jcfg.n_layers)]
    layer_fns = {
        j: jx["jax"].jit(lambda p, x, c, pos, s, spec=spec: jx[
            "apply_layer"](p, jcfg, spec, x, cross_src=s, cache=c, pos=pos,
                           causal=True, impl="ref")[:2])
        for j, spec in enumerate(pattern)}
    cache = bundle.make_cache(B, S_MAX)
    toks = _tokens(tcfg)
    spans = [(0, S)] + [(p, p + 1) for p in range(S, S + STEPS)]
    for lo, hi in spans:
        prefill = lo == 0
        t_src = _torch(src, str(src.dtype)) if prefill else None
        x = jx["layers"].embed(params["embed"], jnp.asarray(toks[:, lo:hi]))
        for i, layer in enumerate(model.stack):
            xt = _torch(x, "bfloat16")
            x, j_caches[i] = layer_fns[i % size](
                j_params[i], x, j_caches[i], jnp.int32(lo),
                src if prefill else None)
            with torch.no_grad():
                yt = layer(xt, cache=cache[i], pos=lo, causal=True,
                           impl=None, cross_src=t_src)
            _close(yt, x, tol, f"layer {i} output at positions {lo}..{hi}")
            if hi not in (S, S + STEPS):
                continue
            for kind, entries in cache[i].items():
                for name, t in entries.items():
                    _close(t, j_caches[i][kind][name], tol,
                           f"layer {i} cache {kind}/{name} after {hi}")


# ---------------------------------------------------------------------------
# training: forward, loss and gradients on the pipeline's stubbed batch
# ---------------------------------------------------------------------------

def _stub_batch(cfg):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S + 1, global_batch=B, seed=0))
    batch = {k: v[:, :S] for k, v in pipe.batch_at(0).items()}
    return pipe.with_frontend_stubs(batch, cfg)


#: a gradient leaf's tolerance, relative to its largest magnitude.
#: whisper's float32 gradient is itself only good to 3.1e-4 (the port)
#: and 7.2e-4 (JAX) of its scale against a float64 run of the port: the
#: near one-hot softmax of the reference's random weights (scores ~100)
#: amplifies float32 rounding through its encoder and decoder; measured
#: 4.1e-4 apart.  llama-vision's: 8.0e-5 apart.
GRAD_TOL = {"whisper-base": 1e-3, "llama-3.2-vision-90b": 1e-4}


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_forward_loss_and_grads_match_jax(jx, arch):
    """float32 model, the batch of ``with_frontend_stubs`` (float32
    frames or image embeddings): ``forward_train``'s logits, ``loss_fn``'s
    loss and metrics, and every gradient leaf (the encoder's and
    ``img_proj``'s included) within ``GRAD_TOL``."""
    jax = jx["jax"]
    jcfg, tcfg, jb, params, bundle, _ = _setup(jx, arch, "float32")
    batch = _stub_batch(tcfg)
    assert batch[cross_input_key(tcfg)].dtype == np.float32
    jbatch = {k: jx["jnp"].asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    j_logits, _ = jax.jit(lambda p, b: jb.forward(p, b, impl="ref"))(
        params, jbatch)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    t_logits, aux = bundle.forward(tparams, tbatch)
    assert aux == {}
    _close(t_logits, j_logits, TOL["float32"], "forward_train logits")
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jb.loss(p, b, impl="ref"), has_aux=True))(params, jbatch)
    leaves = {k: v.requires_grad_() for k, v in tparams.items()}
    loss, metrics = bundle.loss(leaves, tbatch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    assert sorted(metrics) == sorted(j_metrics)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, j_grads))
    assert sorted(want) == sorted(grads)
    assert any(k.startswith("encoder.") or k == "img_proj" for k in want)
    for k, w in want.items():
        _close(grads[k], w, GRAD_TOL[arch], f"gradient {k}")


# ---------------------------------------------------------------------------
# caches, parameter trees, weight decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cache_spec_matches_jax(jx, arch):
    """Each layer's cache entries (``"cross"`` beside ``"self"`` on the
    cross layers, of the reference's ``cross_len``) have the shapes and
    dtypes of the reference's stacked spec, unstacked."""
    jcfg, tcfg, jb, _, bundle, _ = _setup(jx, arch, "bfloat16")
    want, got = jb.cache_spec(B, S_MAX), bundle.cache_spec(B, S_MAX)
    size = jcfg.superblock_size
    assert len(got) == jcfg.n_layers
    for i, layer in enumerate(got):
        ref = want[f"layer{i % size}"]
        assert sorted(layer) == sorted(ref)
        assert ("cross" in layer) == jcfg.layer_has_cross_attn(i)
        for kind, entries in layer.items():
            for name, spec in entries.items():
                assert tuple(spec.shape) == ref[kind][name].shape[1:]
                assert str(spec.dtype)[6:] == str(ref[kind][name].dtype)
    n_cross = (jcfg.encoder_seq if jcfg.is_encdec else jcfg.n_image_tokens)
    assert {layer["cross"]["k"].shape[1] for layer in got
            if "cross" in layer} == {n_cross}


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_params_from_jax_and_decay_match_jax_tree(jx, arch):
    """The encoder's stacked leaves are unstacked over
    ``encoder_config``'s superblocks and ``img_proj`` carried across;
    ``decayed_names`` is the reference's rule -- its AdamW decays every
    leaf of two or more dimensions of the stacked tree, so the encoder's
    stacked norms are decayed and its final norm is not."""
    jax = jx["jax"]
    jcfg, tcfg, _, params, _, model = _setup(jx, arch, "float32")
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tcfg, tree)
    assert sorted(sd) == sorted(model.state_dict())
    if tcfg.is_encdec:
        enc = tree["encoder"]["stack"]["layer0"]
        n_sb = encoder_config(tcfg).n_superblocks
        assert n_sb == tcfg.encoder_layers
        for i in range(n_sb):
            np.testing.assert_array_equal(
                sd[f"encoder.stack.{i}.attn.wq"].numpy(), enc["attn"]["wq"][i])
            np.testing.assert_array_equal(
                sd[f"encoder.stack.{i}.mlp.bi"].numpy(), enc["mlp"]["bi"][i])
    else:
        np.testing.assert_array_equal(sd["img_proj"].numpy(),
                                      tree["img_proj"])
    rule = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2),
                                          np.float32), tree)
    want = sorted(k for k, t in params_from_jax(tcfg, rule).items()
                  if bool(t.all()))
    assert sorted(decayed_names(sd)) == want
    if tcfg.is_encdec:
        assert "encoder.stack.0.norm1.scale" in want
        assert "encoder.final_norm.scale" not in want


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_inputs_refused(arch):
    """A cross source whose length is not the cache's ``cross_len``, a
    batch without the cross input, and the other family's input."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    bundle = build_model(cfg, device="cpu")
    model = bundle.init(0)
    key = cross_input_key(cfg)
    other = "image_embeds" if key == "frames" else "frames"
    toks = torch.zeros((B, 4), dtype=torch.long)
    x = torch.as_tensor(_cross_input(cfg))
    with pytest.raises(ValueError, match="does not fit a cross cache"):
        bundle.prefill(model, {"tokens": toks, key: x[:, :-1]},
                       bundle.make_cache(B, 8))
    with pytest.raises(ValueError, match=f"needs '{key}'"):
        bundle.prefill(model, {"tokens": toks}, bundle.make_cache(B, 8))
    with pytest.raises(ValueError, match=f"needs '{key}'"):
        bundle.loss(dict(model.state_dict()),
                    {"tokens": toks, "labels": toks})
    with pytest.raises(ValueError, match=rf"\['{other}'\] are not used"):
        bundle.prefill(model, {"tokens": toks, key: x, other: x},
                       bundle.make_cache(B, 8))


# ---------------------------------------------------------------------------
# the attention kernel at this slice's shapes (card only)
# ---------------------------------------------------------------------------

#: (label, (B, Sq, Sk, Hq, Hkv, d), causal, dtype): whisper-base's encoder
#: (non-causal, no kv_len, Sq = Sk = 1500, the last 64-row tile ragged;
#: float32 frames take the SIMT kernel), its decoder self prefill (64
#: rows a KV head: the decode kernel) and cross prefill and decode over
#: 1500 frames; llama-3.2-vision's cross prefill (512 queries over 1600
#: image tokens, 64/8 heads) and cross decode
CROSS_REGIMES = [
    ("whisper encoder", (4, 1500, 1500, 8, 8, 64), False, "bfloat16"),
    ("whisper encoder", (4, 1500, 1500, 8, 8, 64), False, "float32"),
    ("whisper self prefill", (4, 64, 64, 8, 8, 64), True, "bfloat16"),
    ("whisper cross prefill", (4, 64, 1500, 8, 8, 64), False, "bfloat16"),
    ("whisper cross decode", (1, 1, 1500, 8, 8, 64), False, "bfloat16"),
    ("vision cross prefill", (4, 512, 1600, 64, 8, 128), False, "bfloat16"),
    ("vision cross decode", (1, 1, 1600, 64, 8, 128), False, "bfloat16"),
]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("label,shape,causal,dtype", CROSS_REGIMES)
def test_cuda_cross_regimes_match_ref(label, shape, causal, dtype):
    """One launch each, within 2e-5 (float32) / 2e-2 (bf16) of
    ``attention_ref``; the whisper prefills go to the decode kernel."""
    _cuda_or_skip()
    Bq, Sq, Sk, Hq, Hkv, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(Sq * 7 + Sk)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(
        TORCH_DT[dtype]) for s in ((Bq, Sq, Hq, d), (Bq, Sk, Hkv, d),
                                   (Bq, Sk, Hkv, d)))
    rows = Sq * Hq // Hkv
    assert fa.takes_decode(q, k) == (dtype == "bfloat16" and rows <= 64)
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES == before + 1, label
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_mixed_dtype_call_promotes():
    """bf16 queries over float32 keys and values (a training cross-
    attention over whisper's float32 encoder): one float32 launch, the
    output in q's dtype, as ``attention_ref`` gives it."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q = torch.randn((2, 64, 8, 64), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((2, 300, 8, 64), generator=gen, device="cuda")
            for _ in range(2))
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=False)
    assert fa.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    want = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
