"""The port's MoE layer against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``repro.models.moe``
and ``repro_torch.models.moe``; the JAX layer's parameters (``init_moe``)
are carried across as numpy.  The smoke configs: kimi-k2 (8 experts
top-2, a shared expert), arctic (4 experts top-2, a dense residual MLP)
and jamba (4 experts top-2).

Tolerances:
- capacity, and the dispatch's integers (``tok_slot``, the drop
  fraction's count): equal.  The dispatch's floats (``w_slot`` and the
  buffer) are copies, so equal too, in float32.
- routing: the port's top-k experts equal JAX's, except where two
  probabilities lie within 1e-6 of each other (the router's logits come
  from another summation order; ROADMAP's step-parity rule), where a
  swap is allowed; the seeds here meet none.
- the layer's output: 1e-4 of its largest magnitude in float32, 2e-2 in
  bfloat16 (another summation order in every product; bf16 rounds at
  other places in the two frameworks, see tests/test_torch_models.py);
  the aux losses rtol 1e-5 (float32 router in both dtypes).
- gradients of the input and of every parameter, float32: 1e-4 of each
  leaf's largest magnitude.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.model_zoo import _to_tensor, decayed_names
from repro_torch.models.module import tree_paths
from repro_torch.models.moe import (MoE, _dispatch_local_experts,
                                    _dispatch_one_group, moe_capacity)

torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "jamba-1.5-large-398b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TIE_BUDGET = 1e-6


def _cfgs(arch, dtype="float32", **kw):
    return (jax_get_config(arch, smoke=True).replace(dtype=dtype, **kw),
            get_config(arch, smoke=True).replace(dtype=dtype, **kw))


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# capacity and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,S,factor", [
    (8, 2, 12, 1.25), (8, 2, 1, 1.25), (4, 2, 64, 0.25), (384, 8, 512, 1.25),
    (384, 8, 1, 1.25), (128, 2, 512, 1.25), (16, 2, 33, 2.0), (3, 1, 5, 1.0)])
def test_capacity_is_the_references(E, k, S, factor):
    jcfg, cfg = _cfgs("kimi-k2-1t-a32b", n_experts=E, top_k=k,
                      capacity_factor=factor)
    assert moe_capacity(cfg, S) == jmoe.moe_capacity(jcfg, S)


def _assignments(B, S, E, k, seed, skew=False):
    """Top-k expert ids (distinct a token) and weights, from a seed;
    ``skew`` draws the experts from the first three, so they overflow."""
    rng = np.random.default_rng(seed)
    pool = min(E, 3) if skew else E
    idx = np.stack([np.stack([rng.permutation(pool)[:k] for _ in range(S)])
                    for _ in range(B)]).astype(np.int32)
    w = rng.random((B, S, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


DISPATCH_CASES = {
    "roomy": (2, 12, 8, 2, 8, False),
    "forced-drops": (2, 12, 8, 2, 2, False),
    "skewed": (3, 16, 8, 2, 8, True),
    "decode": (4, 1, 8, 2, 2, False),
    "top-1": (2, 9, 5, 1, 1, False),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_one_group_is_the_references(case):
    B, S, E, k, C, skew = DISPATCH_CASES[case]
    top_idx, top_w = _assignments(B, S, E, k, seed=len(case), skew=skew)
    x = np.random.default_rng(1).standard_normal((B, S, 6)).astype(
        np.float32)
    want = jax.vmap(lambda xg, ig, wg: jmoe._dispatch_one_group(
        xg, ig, wg, E, C))(jnp.asarray(x), jnp.asarray(top_idx),
                           jnp.asarray(top_w))
    got = _dispatch_one_group(torch.as_tensor(x), torch.as_tensor(top_idx),
                              torch.as_tensor(top_w), E, C)
    buffer, tok_slot, w_slot = (np.asarray(a) for a in want)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), tok_slot)
    np.testing.assert_array_equal(got[2].numpy(), w_slot)
    np.testing.assert_array_equal(got[0].numpy(), buffer)
    dropped = B * S * k - int((tok_slot < S).sum())
    assert (dropped > 0) == (case not in ("roomy", "decode"))


@pytest.mark.parametrize("e_lo,n_local,C", [(0, 3, 2), (3, 3, 2), (5, 3, 8),
                                            (0, 8, 2), (7, 1, 4)])
def test_dispatch_local_experts_is_the_references(e_lo, n_local, C):
    B, S, E, k = 2, 12, 8, 2
    top_idx, top_w = _assignments(B, S, E, k, seed=e_lo + 10 * n_local)
    x = np.random.default_rng(2).standard_normal((B, S, 5)).astype(
        np.float32)
    want = jax.vmap(lambda xg, ig, wg: jmoe._dispatch_local_experts(
        xg, ig, wg, e_lo, n_local, C))(jnp.asarray(x), jnp.asarray(top_idx),
                                       jnp.asarray(top_w))
    got = _dispatch_local_experts(torch.as_tensor(x),
                                  torch.as_tensor(top_idx),
                                  torch.as_tensor(top_w), e_lo, n_local, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    outside = ~((top_idx >= e_lo) & (top_idx < e_lo + n_local))
    assert outside.any() == (n_local < E)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer(arch, dtype, **kw):
    """JAX params and config, and the port's MoE loaded with them."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    p = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, "moe",
                      getattr(jnp, dtype))
    layer = MoE(cfg, device="cpu", dtype=getattr(torch, dtype))
    layer.load_state_dict({k.replace("/", "."): _to_tensor(v) for k, v in
                           tree_paths(jax.tree.map(np.asarray, p))})
    return jcfg, cfg, p, layer


def _jax_moe(jcfg):
    return jax.jit(lambda p, x: jmoe.moe(p, jcfg, x))


def _jax_tree(jcfg, fill):
    """The JAX model's parameter tree as numpy, each leaf ``fill(shape,
    dtype)`` (from the init's shapes: no weights are drawn)."""
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: fill(s.shape, s.dtype), shapes)


def _x(cfg, S, seed=4, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _check_routing(layer, jcfg, p, x):
    """The port's top-k experts are JAX's, up to swaps of experts whose
    probabilities lie within TIE_BUDGET."""
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, want = jax.lax.top_k(probs, jcfg.top_k)
    with torch.no_grad():
        _, t_probs, _, got = layer.route(torch.as_tensor(x))
    want, probs = np.asarray(want), np.asarray(probs)
    for b, s, j in zip(*np.nonzero(got.numpy() != want)):
        gap = abs(probs[b, s, got[b, s, j]] - probs[b, s, want[b, s, j]])
        assert gap <= TIE_BUDGET, (b, s, j, gap)
    assert _rel_err(t_probs, probs) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(arch, dtype):
    """Output and the three aux values; in float32 the routing too."""
    jcfg, cfg, p, layer = _layer(arch, dtype)
    x = _x(cfg, 12)
    y_j, aux_j = _jax_moe(jcfg)(p, jnp.asarray(x, getattr(jnp, dtype)))
    with torch.no_grad():
        y, aux = layer(torch.as_tensor(x).to(getattr(torch, dtype)))
    assert y.dtype == getattr(torch, dtype)
    assert _rel_err(_np(y), _np(y_j)) <= TOL[dtype]
    assert sorted(aux) == sorted(aux_j)
    for k in aux:
        assert float(aux[k]) == pytest.approx(float(aux_j[k]), rel=1e-5,
                                              abs=1e-7), k
    if dtype == "float32":
        _check_routing(layer, jcfg, p, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_drops_match_jax(arch):
    """capacity_factor 0.25 at S = 64 leaves 8 slots an expert for 128
    assignments: about half are dropped, the same ones in both."""
    jcfg, cfg, p, layer = _layer(arch, "float32", capacity_factor=0.25)
    x = _x(cfg, 64, seed=5)
    assert moe_capacity(cfg, 64) == 8
    y_j, aux_j = _jax_moe(jcfg)(p, jnp.asarray(x))
    with torch.no_grad():
        y, aux = layer(torch.as_tensor(x))
    _check_routing(layer, jcfg, p, x)
    assert float(aux["moe_drop_fraction"]) == float(
        aux_j["moe_drop_fraction"]) > 0.2
    assert _rel_err(_np(y), _np(y_j)) <= TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_gradients_match_jax(arch):
    """d/d(x, params) of sum(y * cotangent) + the aux losses at the
    loss's weights, with forced drops (dropped slots get none)."""
    jcfg, cfg, p, layer = _layer(arch, "float32", capacity_factor=0.25)
    x = _x(cfg, 64, seed=6)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def j_loss(p, x):
        y, aux = jmoe.moe(p, jcfg, x)
        return (jnp.sum(y * cot) + 0.01 * aux["moe_load_balance"]
                + 1e-3 * aux["moe_z_loss"])

    g_p, g_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    params = dict(layer.named_parameters())
    for t in params.values():
        t.requires_grad_()
    y, aux = layer(xt)
    loss = (torch.sum(y * torch.as_tensor(cot))
            + 0.01 * aux["moe_load_balance"] + 1e-3 * aux["moe_z_loss"])
    grads = torch.autograd.grad(loss, [xt] + list(params.values()))
    want = {k.replace("/", "."): v for k, v in
            tree_paths(jax.tree.map(np.asarray, g_p))}
    assert sorted(want) == sorted(params)
    assert _rel_err(_np(grads[0]), g_x) <= 1e-4
    for k, g in zip(params, grads[1:]):
        assert np.isfinite(_np(g)).all(), k
        assert _rel_err(_np(g), want[k]) <= 1e-4, k


def test_router_stays_float32_in_bf16():
    """The router is float32 in a bf16 model: built, initialised, carried
    from JAX and loaded."""
    jcfg, cfg = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    assert MoE(cfg, device="meta", dtype=torch.bfloat16).router.dtype \
        == torch.float32
    model = build_model(cfg, device="cpu").init(0)
    sd = params_from_jax(cfg, _jax_tree(jcfg, np.zeros))
    model.load_state_dict(sd)
    for name, t in model.state_dict().items():
        want = torch.float32 if name.endswith("moe.router") \
            else torch.bfloat16
        assert t.dtype == want == sd[name].dtype, name


@pytest.mark.parametrize("arch", ARCHS)
def test_decayed_names_are_the_references_matrices(arch):
    """AdamW decays the reference's leaves of two or more dimensions; on
    the port's names those are ``decayed_names``, MoE layers included."""
    jcfg, cfg = _cfgs(arch)
    sd = params_from_jax(cfg, _jax_tree(
        jcfg, lambda shape, dtype: np.full(shape, len(shape) >= 2,
                                           np.float32)))
    want = sorted(k for k, v in sd.items() if bool(v.all()))
    assert any(".moe." in k for k in want)
    assert sorted(decayed_names(sd)) == want
