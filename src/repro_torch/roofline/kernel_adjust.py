"""The kernelized roofline: what the port's CUDA kernels change.

The dry run traces the plain (``impl="ref"``) attention and selective
scan, which materialise score matrices and per-step scan tensors in HBM;
that traffic dominates the counted memory term.  On the card the kernels
(``csrc/flash_attention.cu``, ``csrc/mamba_scan.cu``) keep those
internals on chip.  This module computes the memory and compute terms
with each kernel's own HBM traffic in their place.

Counterpart of ``src/repro/roofline/kernel_adjust.py``.  The activation,
parameter, MoE and head terms are the reference's; the attention and scan
terms are the port's kernels' (the byte and operation counts below, which
``chip_smoke.py``'s kernel bounds call too):

* the tile kernel reads q, k, v and writes o once (and the row
  log-sum-exp, fp32, where the caller asks for it: the sequence-split
  decode at batch 1);
* the split-KV decode reads the cache up to the position and q, writes o,
  and writes fp32 partials (d + 2 floats a row and split) that its merge
  kernel reads back;
* the scan kernel reads x, dt, B, C (the model's dtype) and A, h0 (fp32)
  and writes y and h_final; the gate z is applied outside the kernel.
  A decode step's scan is the plain one-step update (no kernel): it reads
  and writes the (B, d_inner, N) fp32 state.

Training charges the attention and scan terms three times, as the
reference charges a backward kernel's traffic; the port's backward is the
plain recompute today, so that is the traffic of a backward kernel, not
yet of the program.  All terms are per device and step; the collective
term is the traced step's, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..configs.shapes import ShapeSpec
from ..kernels.flash_attention import plan_decode_splits
from ..models.config import ModelConfig
from .analysis import (FP32_FLOPS, HBM_BW, N_SM, PEAK_FLOPS, SFU_OPS_PER_S,
                       Roofline, model_flops)

# ---------------------------------------------------------------------------
# the kernels' traffic and work, as functions of shapes and dtypes
# ---------------------------------------------------------------------------


def visible_keys(q_len: int, n_keys: int, causal: bool,
                 q_offset: int = 0) -> List[int]:
    """Keys each of ``q_len`` query rows (at positions ``q_offset``...)
    attends to, of ``n_keys``."""
    rows = range(q_offset, q_offset + q_len)
    return [min(n_keys, r + 1) if causal else n_keys for r in rows]


def attention_bytes(batch: float, q_len: int, kv_rows: int, n_heads: int,
                    n_kv_heads: int, head_dim: int, itemsize: int,
                    lse: bool = False) -> float:
    """HBM bytes of one attention kernel call: q and o (batch, q_len,
    n_heads, head_dim) and the k / v rows it needs (batch, kv_rows,
    n_kv_heads, head_dim) moved once, in the inputs' dtype; with ``lse``
    the fp32 row log-sum-exp (batch, q_len, n_heads) written too."""
    return (itemsize * (2 * batch * q_len * n_heads * head_dim
                        + 2 * batch * kv_rows * n_kv_heads * head_dim)
            + (4 * batch * q_len * n_heads if lse else 0))


def attention_ops(batch: float, n_heads: int, head_dim: int,
                  visible: List[int]) -> float:
    """4 head_dim operations a visible (query, key) pair: the score and
    the value product, a multiply-add each."""
    return 4 * head_dim * batch * n_heads * sum(visible)


def decode_partials_bytes(batch: float, n_keys: int, n_heads: int,
                          n_kv_heads: int, head_dim: int,
                          n_sm: int = N_SM) -> float:
    """The split-KV decode's fp32 partials (``head_dim`` + 2 floats a query
    row and split), written by the split kernel and read by the merge."""
    heads = max(int(round(batch * n_kv_heads)), 1)
    n_split, _ = plan_decode_splits(max(int(n_keys), 1), heads, n_sm)
    rows = n_heads // n_kv_heads
    return 2 * 4 * batch * n_kv_heads * n_split * rows * (head_dim + 2)


def scan_bytes(batch: float, seq: int, d_inner: int, n_state: int,
               itemsize: int) -> float:
    """HBM bytes of one scan kernel call: x, dt and y (batch, seq, d_inner)
    and B, C (batch, seq, N) in the model's dtype; A (d_inner, N), h0 and
    h_final (batch, d_inner, N) in fp32."""
    return (itemsize * (3 * batch * seq * d_inner + 2 * batch * seq * n_state)
            + 4 * (d_inner * n_state + 2 * batch * d_inner * n_state))


def scan_ops(batch: float, seq: int, d_inner: int,
             n_state: int) -> Tuple[float, float]:
    """(fp32 operations, exponentials) of one scan: 7 a (b, t, c, n) --
    dt*A, exp, decay*h, drive, add, and y's multiply-add -- plus dt*x a
    (b, t, c); one exponential a (b, t, c, n)."""
    cells = batch * seq * d_inner
    return cells * (7 * n_state + 1), cells * n_state


def bound_s(nbytes: float, ops: float, peak: float,
            exps: float = 0.0) -> Tuple[float, str]:
    """The least time of ``nbytes`` at the HBM rate, ``ops`` at ``peak``
    and ``exps`` at the special-function rate, and what binds it
    ("bytes" or "operations")."""
    bytes_s = nbytes / HBM_BW
    ops_s = max(ops / peak, exps / SFU_OPS_PER_S)
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s \
        else "operations"


def attention_bound_s(batch: int, q_len: int, n_keys: int, n_heads: int,
                      n_kv_heads: int, head_dim: int, itemsize: int,
                      causal: bool, q_offset: int = 0,
                      kv_len: Optional[int] = None) -> Tuple[float, str]:
    """Least time of one attention call on these shapes: q, the k / v rows
    it needs and o moved once; 4 head_dim operations a visible pair at
    the dtype's peak (bf16 tensor cores, else fp32)."""
    limit = n_keys if kv_len is None else min(kv_len, n_keys)
    visible = visible_keys(q_len, limit, causal, q_offset)
    nbytes = attention_bytes(batch, q_len, max(visible), n_heads,
                             n_kv_heads, head_dim, itemsize)
    peak = PEAK_FLOPS if itemsize == 2 else FP32_FLOPS
    return bound_s(nbytes, attention_ops(batch, n_heads, head_dim, visible),
                   peak)


def scan_bound_s(batch: int, seq: int, d_inner: int, n_state: int,
                 itemsize: int) -> Tuple[float, str]:
    """Least time of one scan on these shapes (:func:`scan_bytes`,
    :func:`scan_ops` at the fp32 and special-function rates)."""
    ops, exps = scan_ops(batch, seq, d_inner, n_state)
    return bound_s(scan_bytes(batch, seq, d_inner, n_state, itemsize), ops,
                   FP32_FLOPS, exps)


# ---------------------------------------------------------------------------
# the kernelized memory term
# ---------------------------------------------------------------------------

def _layer_counts(cfg: ModelConfig):
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    n_ssm = cfg.n_layers - n_attn
    n_cross = sum(1 for i in range(cfg.n_layers)
                  if cfg.layer_has_cross_attn(i))
    n_moe = sum(1 for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
    return n_attn, n_ssm, n_cross, n_moe


def kernel_terms(cfg: ModelConfig, shape: ShapeSpec, n_chips: int,
                 train: bool) -> Dict[str, float]:
    """Per-device HBM bytes of the kernels a step runs: ``"attention"``
    (every self- and cross-attention layer) and ``"scan"`` (every Mamba
    layer), each already multiplied by its layer count."""
    B, S = shape.global_batch, shape.seq_len
    n_attn, n_ssm, n_cross, _ = _layer_counts(cfg)
    bpe = 2  # bf16
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, max(cfg.n_kv_heads, 1)
    di, N = cfg.d_inner, max(cfg.ssm_state, 1)
    if shape.kind == "decode":
        # the device's share of the cache, read up to the position; q, o
        # for its tokens; the partials of its split-KV launch
        b_dev = B / min(B, n_chips)
        attn = (2 * B * S * Hkv * hd * bpe / n_chips
                + attention_bytes(b_dev, 1, 0, Hq, Hkv, hd, bpe, lse=B == 1)
                + decode_partials_bytes(B / n_chips, S, Hq, Hkv, hd))
        # the plain one-step update: the fp32 state read and written, and
        # x, dt, B, C, y for its tokens
        ssm = (2 * 4 * B * di * N / n_chips
               + b_dev * (3 * di + 2 * N) * bpe)
        cross = attention_bytes(b_dev, 1, 0, Hq, Hkv, hd, bpe) \
            + 2 * B * _cross_len(cfg) * Hkv * hd * bpe / n_chips
    else:
        b_dev = B / n_chips
        attn = attention_bytes(b_dev, S, S, Hq, Hkv, hd, bpe)
        ssm = scan_bytes(b_dev, S, di, N, bpe)
        cross = attention_bytes(b_dev, S, _cross_len(cfg), Hq, Hkv, hd, bpe)
    f = 3.0 if train else 1.0
    return {"attention": f * (n_attn * attn + n_cross * cross),
            "scan": f * n_ssm * ssm}


def _cross_len(cfg: ModelConfig) -> int:
    return (cfg.encoder_seq if cfg.is_encdec
            else cfg.n_image_tokens if cfg.cross_attn_period else 0)


def kernelized_memory_bytes(cfg: ModelConfig, shape: ShapeSpec,
                            n_chips: int, train: bool) -> float:
    """Per-device HBM bytes with the kernels' attention / scan traffic.

    Accounting (bf16 activations/params, fp32 optimizer), the reference's
    outside the kernels:
      * params: read once fwd (+ once bwd re-gather under FSDP) and the
        optimizer update reads/writes p/m/v -- training charges
        params*(2 reads + grad write + 3*opt rw); inference charges one
        read of active params.
      * per layer, the residual stream + mixer/MLP activations stream
        through HBM a small constant number of times: ~12 tensors of
        (B, S, D) bf16 fwd (x3 in training: bwd + remat recompute).
      * the attention and scan kernels: :func:`kernel_terms`.
      * MoE: dispatch buffer read/write ~3x per matmul set.
    """
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    n_attn, n_ssm, n_cross, n_moe = _layer_counts(cfg)
    bpe = 2.0  # bf16

    tok_dev = B * S / n_chips
    if shape.kind == "decode":
        tok_dev = B * 1.0 / min(B, n_chips)

    act_stream = 12.0 * tok_dev * D * bpe          # per dense layer fwd
    if train:
        act_stream *= 3.0                          # bwd + remat recompute

    # MoE buffer traffic: top_k token copies in/out of the expert buffers
    moe_io = 0.0
    if cfg.n_experts:
        moe_io = 6.0 * tok_dev * cfg.top_k * D * bpe * cfg.capacity_factor
        if train:
            moe_io *= 3.0

    kernels = kernel_terms(cfg, shape, n_chips, train)
    layer_bytes = (n_attn * act_stream + n_ssm * act_stream * 0.8
                   + n_moe * moe_io + kernels["attention"] + kernels["scan"])

    # parameter traffic
    p_active = cfg.active_param_count()
    p_total = cfg.param_count()
    if train:
        param_bytes = (p_total * bpe * 2          # fwd + bwd weight reads
                       + p_total * bpe            # grad write
                       + p_total * 3 * 4          # adam p/m/v read+write
                       ) / n_chips
    else:
        param_bytes = p_active * bpe / n_chips

    # logits/CE traffic (vocab-sharded)
    head_bytes = tok_dev * (cfg.vocab_size / max(n_chips ** 0.5, 1)) * bpe \
        if shape.kind == "train" else 0.0

    return layer_bytes + param_bytes + head_bytes


def kernelized_roofline(base: Roofline, cfg: ModelConfig, shape: ShapeSpec,
                        ) -> Dict[str, float]:
    """The 'kernelized' variant of a traced baseline cell."""
    train = shape.kind == "train"
    mem_bytes = kernelized_memory_bytes(cfg, shape, base.n_chips, train)
    # compute term: the model math (+ 20% slack in training for the
    # recompute of the remat policy), as the reference
    mf_dev = model_flops(cfg, shape) / base.n_chips
    compute_s = 1.2 * mf_dev / PEAK_FLOPS if train else mf_dev / PEAK_FLOPS
    memory_s = mem_bytes / HBM_BW
    collective_s = base.collective_s  # unchanged by kernelization
    bound = max(compute_s, memory_s, collective_s)
    useful_s = mf_dev / PEAK_FLOPS
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(
            {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}.items(), key=lambda kv: kv[1])[0],
        "step_time_bound_s": bound,
        "roofline_fraction": useful_s / bound if bound else 0.0,
        "memory_bytes_per_dev": mem_bytes,
    }
