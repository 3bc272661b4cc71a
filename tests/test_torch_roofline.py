"""The port's roofline (``roofline.analysis``, ``roofline.kernel_adjust``)
against the reference's.

- ``model_flops`` / ``model_bytes`` equal the reference's for every arch x
  shape (exact);
- ``collective_bytes`` over ``parallel.comm.Collective`` records equals
  the reference's over HLO lines written for each kind, at group sizes
  2, 16 and 32 (exact);
- with the port's H100 constants patched to the reference's TPU v5e
  ones, every field of ``analyze`` equals the reference's (exact; the
  reference reads FLOPs and bytes from its cost analysis here, the port
  takes them as counted);
- ``kernelized_memory_bytes`` less the port's kernel terms equals the
  reference's less its attention and scan terms, every arch x shape at
  256 and 512 chips (relative 1e-12: the same sums grouped another way);
- the byte counter's rules on hand-built ops (exact);
- the kernel bounds ``chip_smoke.py`` prints, at their shapes (the
  digits PERF.md carries).
"""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.parallel import comm
from repro_torch.roofline import analysis as an
from repro_torch.roofline import kernel_adjust as ka

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.roofline import analysis as jan
    from repro.roofline import kernel_adjust as jka
    return dict(get_config=jax_get_config, an=jan, ka=jka)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_bytes_are_the_references(jx, arch, shape):
    cfg, jcfg = get_config(arch), jx["get_config"](arch)
    s = SHAPES[shape]
    assert an.model_flops(cfg, s) == jx["an"].model_flops(jcfg, s)
    assert an.model_bytes(cfg, s) == jx["an"].model_bytes(jcfg, s)


def _hlo(lines):
    """An entry computation holding ``lines``, with its parameter."""
    return "\n".join(["HloModule m", "",
                      "ENTRY %main (p: bf16[8,128]) -> bf16[8,128] {",
                      "  %p = bf16[8,128]{1,0} parameter(0)",
                      *lines, "}"])


def _line(i, kind, g, rows=4):
    """One collective of ``kind`` over groups of ``g`` whose result is
    (rows * g, 128) bf16 (rows for a reduce-scatter's)."""
    out = rows if kind == "reduce-scatter" else rows * g
    return (f"  %c{i} = bf16[{out},128]{{1,0}} {kind}(bf16[8,128]{{1,0}} "
            f"%p), replica_groups=[{64 // g},{g}]<=[64]"), \
        comm.Collective(kind, out * 128 * 2, g)


@pytest.mark.parametrize("g", (2, 16, 32))
def test_collective_bytes_are_the_references(jx, g):
    lines, records = zip(*(_line(i, kind, g) for i, kind in
                           enumerate(KINDS * 2)))
    want = jx["an"].collective_bytes(_hlo(lines))
    got = an.collective_bytes(records)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.total_bytes == want.total_bytes


_V5E = ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_PER_CHIP")


@pytest.mark.parametrize("flops,nbytes", [(3e15, 4e12), (1e6, 1e3)])
@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-3b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"),
    ("falcon-mamba-7b", "long_500k"), ("whisper-base", "prefill_32k")])
def test_analyze_is_the_references(jx, monkeypatch, arch, shape, flops,
                                   nbytes):
    """The second row's counts fall under the analytic floors."""
    for name in _V5E:
        monkeypatch.setattr(an, name, getattr(jx["an"], name))
    cfg, jcfg, s = get_config(arch), jx["get_config"](arch), SHAPES[shape]
    lines, records = zip(*(_line(i, kind, 16) for i, kind in
                           enumerate(KINDS)))
    want = jx["an"].analyze(arch, shape, "16x16", 256, jcfg, s, _hlo(lines),
                            {"flops": flops, "bytes accessed": nbytes},
                            12.5e9).to_dict()
    got = an.analyze(arch, shape, "16x16", 256, cfg, s, records, flops,
                     nbytes, 12.5e9).to_dict()
    assert got == want


def test_constants_are_the_h100s():
    assert (an.PEAK_FLOPS, an.HBM_BW, an.HBM_PER_CHIP, an.LINK_BW) == \
        (989e12, 3.35e12, 80e9, 50e9)


def _reference_kernel_terms(cfg, shape, n_chips, train):
    """The reference's attention and scan terms (its kernel_adjust.py,
    the attn_io and ssm_io lines), times their layer counts."""
    B, S = shape.global_batch, shape.seq_len
    n_attn, n_ssm, n_cross, _ = ka._layer_counts(cfg)
    bpe = 2.0
    tok_dev = B * S / n_chips
    if shape.kind == "decode":
        tok_dev = B * 1.0 / min(B, n_chips)
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, max(cfg.n_kv_heads, 1)
    attn_io = tok_dev * hd * (2 * Hq + 2 * Hkv) * bpe
    if shape.kind == "decode":
        attn_io = (B * S * Hkv * hd * 2 * bpe) / n_chips \
            + tok_dev * Hq * hd * bpe
    if train:
        attn_io *= 3.0
    di, N = cfg.d_inner, max(cfg.ssm_state, 1)
    ssm_io = tok_dev * (4 * di + 2 * N) * bpe
    if train:
        ssm_io *= 3.0
    return n_attn * attn_io + n_ssm * ssm_io + n_cross * attn_io


@pytest.mark.parametrize("n_chips", (256, 512))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_non_kernel_terms_are_the_references(jx, arch, n_chips):
    cfg, jcfg = get_config(arch), jx["get_config"](arch)
    for name, s in SHAPES.items():
        train = s.kind == "train"
        want = jx["ka"].kernelized_memory_bytes(jcfg, s, n_chips, train) \
            - _reference_kernel_terms(cfg, s, n_chips, train)
        terms = ka.kernel_terms(cfg, s, n_chips, train)
        got = ka.kernelized_memory_bytes(cfg, s, n_chips, train) \
            - terms["attention"] - terms["scan"]
        assert got == pytest.approx(want, rel=1e-12), name
        assert terms["attention"] >= 0 and terms["scan"] >= 0


def test_kernel_terms_are_the_kernels_traffic():
    """qwen2.5-3b prefill on one chip: 36 tile-kernel calls' q, k, v, o;
    falcon-mamba-7b: 64 scans' x, dt, y, B, C, A, h0, h_final."""
    s = SHAPES["prefill_32k"]
    cfg = get_config("qwen2.5-3b")
    assert ka.kernel_terms(cfg, s, 1, False) == {
        "attention": 36 * 2 * (2 * 32 * 32768 * 16 * 128
                               + 2 * 32 * 32768 * 2 * 128), "scan": 0.0}
    cfg = get_config("falcon-mamba-7b")
    di = 8192
    assert ka.kernel_terms(cfg, s, 1, False)["scan"] == 64 * (
        2 * (3 * 32 * 32768 * di + 2 * 32 * 32768 * 16)
        + 4 * (di * 16 + 2 * 32 * di * 16))


def test_kernel_bounds_at_chip_smokes_shapes():
    """The bounds chip_smoke.py prints for the kernel table: attention
    prefill 4 x 512 (16/2 heads, d 128, bf16, causal) and decode (one
    query at position 527 over 544 slots, kv_len 528), the scan 4 x 512 x
    8192, N 16, bf16."""
    t, by = ka.attention_bound_s(4, 512, 544, 16, 2, 128, 2, True)
    assert (round(t * 1e6, 3), by) == (5.634, "bytes")
    t, by = ka.attention_bound_s(4, 1, 544, 16, 2, 128, 2, True,
                                 q_offset=527, kv_len=528)
    assert (round(t * 1e6, 3), by) == (0.655, "bytes")
    t, by = ka.scan_bound_s(4, 512, 8192, 16, 2)
    assert (round(t * 1e6, 2), by) == (64.19, "operations")


def test_decode_partials():
    """The split-KV decode's partials: B * Hkv * splits * rows * (d + 2)
    floats, written and read once (132 SMs: 8 heads take 17 splits of
    528 keys)."""
    assert ka.decode_partials_bytes(4, 528, 16, 2, 128) == \
        2 * 4 * 4 * 2 * 17 * 8 * 130


# ---------------------------------------------------------------------------
# the byte counter
# ---------------------------------------------------------------------------

def test_byte_counter_rules():
    x = torch.zeros(4, 8)                               # 128 bytes
    idx = torch.tensor([0, 2], dtype=torch.int64)       # 16 bytes
    table = torch.zeros(10, 8)
    cases = [
        (lambda: x.view(8, 4).t(), 0),                  # views
        (lambda: torch.empty(4, 8), 0),                 # allocation
        (lambda: x + x, 3 * 128),                       # 2 in + 1 out
        (lambda: x.clone(), 2 * 128),
        (lambda: x.sum(0), 128 + 32),
        (lambda: x.copy_(torch.ones(4, 8)), 2 * 128 + 128),   # ones + copy_
        (lambda: x[1:3].copy_(torch.ones(2, 8)), 2 * 64 + 64),
        (lambda: x.index_select(0, idx), 2 * 64 + 16),
        (lambda: torch.nn.functional.embedding(idx, table), 2 * 64 + 16),
        (lambda: x.index_put_((idx,), torch.ones(2, 8)), 64 + 2 * 64),
        (lambda: x.scatter_(1, torch.zeros(4, 1, dtype=torch.int64), 1.0),
         32 + 2 * 16),                                  # zeros + scatter_
    ]
    for fn, want in cases:
        with an.ByteCounter() as bc:
            fn()
        assert bc.total == want, (bc.by_op, want)


def test_byte_counter_scales_and_skips_collectives():
    x = torch.zeros(4, 8)
    with an.ByteCounter() as bc:
        with an.repeated(3):
            x + x
        with comm._collective("all-reduce", 128, 2):
            x.clone()
    assert bc.total == 3 * 3 * 128
    with comm.recording() as rec:
        with comm._collective("all-gather", 256, 2):
            pass
    assert rec == [comm.Collective("all-gather", 256, 2)]
