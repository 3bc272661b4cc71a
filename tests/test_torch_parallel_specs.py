"""The port's sharding rules against the JAX package's, with no ranks.

Parameter, cache, batch and activation specs and input specs of all ten
architectures at full size, from shapes alone (``jax.eval_shape`` and the
port's ``device="meta"`` build: nothing is allocated), on the abstract
meshes (16, 16) over ("data", "model"), (2, 16, 16) over ("pod", "data",
"model") and (2, 2), under ``ParallelConfig()``,
``shard_embed_vocab=False`` and ``fsdp_params=False`` (the caches also
under ``cache_seq_axis=("data",)``, the decode step's default at batch
1).  The port's parameters are unstacked, so a layer's spec must equal
the reference's for its stacked leaf with the leading None dropped.  A
spec is compared as a tuple, as ``tuple(PartitionSpec(...))`` gives it.
Every comparison is exact.  Then the cases of ``tests/test_sharding.py``,
and the local parts of a spec on a mesh.
"""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.mesh import AbstractMesh, production_shape
from repro_torch.models import build_model
from repro_torch.models.model_zoo import encoder_config
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.steps import input_specs, param_specs

torch.set_num_threads(1)

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 2), ("data", "model"))}
PCFGS = {"default": sh.ParallelConfig(),
         "no_vocab": sh.ParallelConfig(shard_embed_vocab=False),
         "no_fsdp": sh.ParallelConfig(fsdp_params=False)}
CACHE_PCFGS = dict(PCFGS, seq=sh.ParallelConfig(cache_seq_axis=("data",)))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's rules and models (imported here: the card's
    machine has no JAX)."""
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh as JaxMesh

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.parallel import sharding as jsh
    from repro.parallel import steps as jsteps
    bundles = {}

    def bundle(arch):
        if arch not in bundles:
            bundles[arch] = jax_build_model(jax_get_config(arch))
        return bundles[arch]

    def mesh(sizes, axes):
        try:
            return JaxMesh(sizes, axes)
        except TypeError:   # jax 0.4.x takes ((name, size), ...)
            return JaxMesh(tuple(zip(axes, sizes)))

    return dict(jax=jax, sh=jsh, steps=jsteps, bundle=bundle, mesh=mesh)


def _meshes(jx, name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), jx["mesh"](sizes, axes)


def _port_names(cfg, path):
    """The port's names of the reference's leaf ``path``: a stacked
    layer leaf unstacks into one name a superblock."""
    parts = path.split("/")
    if "stack" not in parts[:2]:
        return [path.replace("/", ".")]
    enc = parts[0] == "encoder"
    scfg = encoder_config(cfg) if enc else cfg
    j = int(parts[2 if enc else 1].removeprefix("layer"))
    rest = ".".join(parts[3 if enc else 2:])
    prefix = "encoder.stack" if enc else "stack"
    return [f"{prefix}.{sb * scfg.superblock_size + j}.{rest}"
            for sb in range(scfg.n_superblocks)]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references(jx, arch, mesh_name):
    cfg = get_config(arch)
    mesh, jmesh = _meshes(jx, mesh_name)
    ours = param_specs(build_model(cfg, device="cpu"))
    ref_tree = jx["steps"].param_specs(jx["bundle"](arch))
    for pname, pcfg in PCFGS.items():
        got = sh.params_shardings(ours, mesh, pcfg)
        seen = set()
        for path, leaf in _leaves(ref_tree):
            want = tuple(jx["sh"].param_spec(path, tuple(leaf.shape), jmesh,
                                             pcfg))
            dims = tuple(leaf.shape)
            if "stack" in path.split("/")[:2]:     # a stacked layer leaf
                want, dims = want[1:], dims[1:]
            for name in _port_names(cfg, path):
                assert tuple(ours[name].shape) == dims, name
                assert got[name] == want, (pname, path, name)
                seen.add(name)
        assert seen == set(ours), pname


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_are_the_references(jx, arch, shape_name):
    """Every layer's self / cross / Mamba cache entries, batch 128 and
    batch 1 (the B == 1 rule that moves to ``cache_seq_axis``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    ours = build_model(cfg, device="cpu").cache_spec(B, S)
    theirs = jx["bundle"](arch).cache_spec(B, S)
    size = cfg.superblock_size
    for mesh_name in MESHES:
        mesh, jmesh = _meshes(jx, mesh_name)
        for pname, pcfg in CACHE_PCFGS.items():
            got = sh.cache_shardings(ours, mesh, pcfg)
            want = jx["sh"].cache_shardings(theirs, jmesh, pcfg)
            assert len(got) == cfg.n_layers
            for i, layer in enumerate(got):
                ref = want[f"layer{i % size}"]
                assert sorted(layer) == sorted(ref)
                for kind, entries in layer.items():
                    for k, spec in entries.items():
                        w = tuple(ref[kind][k].spec)
                        w = w + (None,) * (len(theirs[f"layer{i % size}"]
                                               [kind][k].shape) - len(w))
                        assert spec == w[1:], (mesh_name, pname, i, kind, k)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_batch_and_activation_specs_are_the_references(jx, arch,
                                                             shape_name):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ours = input_specs(cfg, shape)
    theirs = jx["steps"].input_specs(jx["bundle"](arch).cfg, shape)
    assert sorted(ours) == sorted(theirs)
    for k, spec in ours.items():
        assert tuple(spec.shape) == tuple(theirs[k].shape), k
        assert str(spec.dtype).removeprefix("torch.") == str(theirs[k].dtype)
    for mesh_name in MESHES:
        mesh, jmesh = _meshes(jx, mesh_name)
        for pname, pcfg in dict(PCFGS, no_sp=sh.ParallelConfig(
                shard_sequence=False)).items():
            got = sh.batch_shardings(ours, mesh, pcfg)
            want = jx["sh"].batch_shardings(theirs, jmesh, pcfg)
            for k in ours:
                w = tuple(want[k].spec)
                w = w + (None,) * (len(ours[k].shape) - len(w))
                assert got[k] == w, (mesh_name, pname, k)
            args = (shape.global_batch, shape.seq_len, pcfg)
            assert sh.activation_spec(mesh, *args) == tuple(
                jx["sh"].activation_spec(jmesh, *args))
            assert sh.batch_spec(mesh, shape.global_batch, pcfg) == tuple(
                jx["sh"].batch_spec(jmesh, shape.global_batch, pcfg))


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases
# ---------------------------------------------------------------------------

OFF = sh.ParallelConfig(shard_sequence=False)

#: (reference path, stacked shape, mesh, expected reference spec)
PARAM_CASES = [
    ("stack/layer0/attn/wq", (36, 2048, 16, 128), "pod",
     (None, "data", "model", None)),
    ("stack/layer0/attn/wk", (88, 6144, 1, 128), "pod",
     (None, "data", None, None)),
    ("stack/layer0/attn/wo", (36, 16, 128, 2048), "pod",
     (None, "model", None, "data")),
    ("stack/layer0/mlp/wg", (36, 2048, 11008), "pod",
     (None, "data", "model")),
    ("stack/layer0/mlp/wd", (36, 11008, 2048), "pod",
     (None, "model", "data")),
    ("stack/layer0/moe/wg", (61, 384, 7168, 2048), "pod",
     (None, "model", "data", None)),
    ("stack/layer0/moe/wd", (61, 384, 2048, 7168), "pod",
     (None, "model", None, "data")),
    ("stack/layer0/moe/wg", (9, 16, 8192, 24576), "pod",
     (None, "model", "data", None)),
    ("embed", (151936, 2048), "pod", ("model", "data")),
    ("head", (2048, 151936), "pod", ("data", "model")),
    ("embed", (122753, 2304), "pod", (None, "data")),
    ("stack/layer0/ssm/in_proj", (64, 4096, 16384), "pod",
     (None, "data", "model")),
    ("stack/layer0/ssm/A_log", (64, 8192, 16), "pod",
     (None, "model", None)),
    ("stack/layer0/ssm/out_proj", (64, 8192, 4096), "pod",
     (None, "model", "data")),
    ("stack/layer0/norm1/scale", (36, 2048), "pod", (None, None)),
    ("final_norm/scale", (2048,), "pod", (None,)),
    ("stack/layer0/mlp/wg", (40, 2305, 5760), "pod", (None, None, "model")),
    ("stack/layer0/mlp/wg", (36, 2048, 11008), "multi_pod",
     (None, ("pod", "data"), "model")),
]

ACT_CASES = [  # (batch, seq, pcfg, expected)
    (256, 4096, sh.ParallelConfig(), ("data", "model", None)),
    (256, 4096, OFF, ("data", None, None)),
    (1, 524288, sh.ParallelConfig(), (None, "model", None)),
]


def _case_ids():
    return ([f"param-{i}-{c[0].split('/')[-1]}"
             for i, c in enumerate(PARAM_CASES)]
            + [f"activation-{i}" for i in range(len(ACT_CASES))]
            + ["mesh_axes"])


@pytest.mark.parametrize("case", range(len(PARAM_CASES) + len(ACT_CASES)
                                       + 1), ids=_case_ids())
def test_sharding_cases(jx, case):
    """Each case of ``tests/test_sharding.py``: the port's spec equals the
    expected one (the stacked lead dropped) and the reference's."""
    mesh, jmesh = _meshes(jx, "pod")
    if case == len(PARAM_CASES) + len(ACT_CASES):
        pod, jpod = _meshes(jx, "multi_pod")
        assert sh.mesh_axes(mesh) == (("data",), "model") \
            == jx["sh"].mesh_axes(jmesh)
        assert sh.mesh_axes(pod) == (("pod", "data"), "model") \
            == jx["sh"].mesh_axes(jpod)
        return
    if case >= len(PARAM_CASES):
        batch, seq, pcfg, want = ACT_CASES[case - len(PARAM_CASES)]
        assert sh.activation_spec(mesh, batch, seq, pcfg) == want == tuple(
            jx["sh"].activation_spec(jmesh, batch, seq, pcfg))
        return
    path, shape, mesh_name, want = PARAM_CASES[case]
    mesh, jmesh = _meshes(jx, mesh_name)
    assert tuple(jx["sh"].param_spec(path, shape, jmesh)) == want
    stacked = path.startswith("stack/")
    name = path.replace("/layer0/", ".0.").replace("/", ".")
    got = sh.param_spec(name, shape[1:] if stacked else shape, mesh)
    assert got == (want[1:] if stacked else want)


# ---------------------------------------------------------------------------
# a spec on a mesh
# ---------------------------------------------------------------------------

def test_local_parts():
    """The block a rank holds (several axes on one dimension major
    first): every rank's blocks tile the tensor once."""
    mesh = AbstractMesh(*production_shape(multi_pod=True))
    spec = sh.param_spec("stack.0.mlp.wg", (2048, 11008), mesh)
    assert spec == (("pod", "data"), "model")
    small = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    full = torch.arange(8 * 6).reshape(8, 6)
    seen = torch.zeros_like(full)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                idx = sh.local_slice((("pod", "data"), "model"), full.shape,
                                     small, {"pod": p, "data": d, "model": m})
                assert idx[0] == slice((2 * p + d) * 2, (2 * p + d + 1) * 2)
                assert idx[1] == slice(3 * m, 3 * (m + 1))
                seen[idx] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not divide"):
        sh.local_slice(("model",), (3,), small, {"model": 0})
