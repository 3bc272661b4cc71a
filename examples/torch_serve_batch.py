"""Serving example on the PyTorch/CUDA port: batched prefill + decode
with KV/SSM caches.

The port's copy of ``examples/serve_batch.py``: prefill a batch of
prompts, then decode tokens greedily against the cache, for a dense model
and a hybrid (attention + Mamba + MoE) one whose cache carries both KV
blocks and SSM states.  Smoke configs, float32, random weights from seed
0; on the card by default, ``--device cpu`` for the CPU.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model

BATCH, PROMPT_LEN, GEN_TOKENS, S_MAX = 4, 24, 12, 64
ARCHS = ("qwen2.5-3b", "jamba-1.5-large-398b")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, device) -> None:
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    bundle = build_model(cfg, device=device)
    model = bundle.init(0)
    dev = bundle.device

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)), device=dev)

    # ---- prefill: one pass over the prompts, caches filled --------------
    cache = bundle.make_cache(BATCH, S_MAX)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(model, {"tokens": prompts}, cache)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())

    # ---- decode loop ------------------------------------------------------
    tok = logits[:, -1].argmax(-1, keepdim=True)
    generated = [tok]
    t0 = time.perf_counter()
    for step in range(GEN_TOKENS - 1):
        logits, cache = bundle.decode(model, tok, cache, PROMPT_LEN + step)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        generated.append(tok)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3 / (GEN_TOKENS - 1)

    out = torch.cat(generated, dim=1).cpu()
    print(f"{arch}: prefill {BATCH}x{PROMPT_LEN} tokens in {prefill_ms:.1f} "
          f"ms; decode {decode_ms:.1f} ms/token (smoke config, {dev})")
    print(f"  generated token ids (request 0): {out[0].numpy()}")
    if out.shape != (BATCH, GEN_TOKENS):
        raise RuntimeError(f"{arch}: generated ids of shape "
                           f"{tuple(out.shape)}")
    if not (finite and bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"{arch}: non-finite logits")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="cpu for the CPU (default: the card)")
    args = parser.parse_args()
    for arch in ARCHS:
        serve(arch, args.device)
    print("serving OK")


if __name__ == "__main__":
    main()
