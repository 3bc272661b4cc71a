#!/usr/bin/env python3
"""Time the serving main path of this checkout against another
checkout's, in turns, on the card.

    python3 scripts/torch_serve_ab.py --other DIR [--arch qwen2.5-3b]
        [--rounds 1] [--repeats 3]

Serves ``--arch`` at full width in bf16 (random weights from seed 0) by
``chip_smoke.py`` phase 8's protocol: 4 prompts x 512 tokens, then 32
greedy tokens; the host clock around the prefill and around the 31
decode steps, each ending in a synchronize.  Each turn is a process of
its own that imports ``repro_torch`` from its checkout's ``src/`` (two
packages of one name cannot share a process), builds that checkout's
attention and scan kernels, serves once to warm and then ``--repeats``
times.  The order is other, this, this, other, ``--rounds`` times.
Prints the card's name and power limit, each turn's prefill ms and
decode ms a step (the medians of its repeats), and each checkout's
medians over its turns; fails unless every turn generated the same ids.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, NEW, SEED = 4, 512, 32, 0


def serve(root: Path, arch: str, repeats: int) -> dict:
    """One turn: serve ``arch`` from the checkout at ``root``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, mamba_scan
    from repro_torch.models import build_model
    for lib in (flash_attention.LIBRARY, mamba_scan.LIBRARY):
        lib.build()
    cfg = get_config(arch)
    bundle = build_model(cfg, device="cuda")
    model = bundle.init(SEED)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (BATCH, PROMPT)), device="cuda")

    def generate(tokens, n_new):
        cache = bundle.make_cache(BATCH, tokens.shape[1] + n_new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.prefill(model, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = logits[:, -1].argmax(-1, keepdim=True)
        ids = [tok]
        t0 = time.perf_counter()
        for step in range(n_new - 1):
            logits, cache = bundle.decode(model, tok, cache,
                                          tokens.shape[1] + step)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            ids.append(tok)
        torch.cuda.synchronize()
        return (prefill_s, (time.perf_counter() - t0) / (n_new - 1),
                torch.cat(ids, 1).cpu().tolist())

    generate(prompts[:, :16], 3)
    generate(prompts, NEW)
    runs = [generate(prompts, NEW) for _ in range(repeats)]
    return {"root": str(root), "arch": arch,
            "prefill_ms": [r[0] * 1e3 for r in runs],
            "decode_ms_per_step": [r[1] * 1e3 for r in runs],
            "ids": runs[0][2]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other checkout's root")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print(json.dumps(serve(args.turn, args.arch, args.repeats)))
        return 0
    import torch
    if not torch.cuda.is_available() or args.other is None:
        print("torch_serve_ab: needs a CUDA device and --other",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    roots = {"other": args.other.resolve(), "this": ROOT}
    turns = []
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            proc = subprocess.run(
                [sys.executable, __file__, "--turn", str(roots[name]),
                 "--arch", args.arch, "--repeats", str(args.repeats)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec["name"] = name
            turns.append(rec)
            pre, dec = rec["prefill_ms"], rec["decode_ms_per_step"]
            print(f"  {name}: prefill {statistics.median(pre):.3f} ms, "
                  f"decode {statistics.median(dec):.3f} ms a step "
                  f"(repeats {[round(t, 3) for t in dec]})")
    for name in roots:
        mine = [t for t in turns if t["name"] == name]
        pre = statistics.median(v for t in mine for v in t["prefill_ms"])
        dec = statistics.median(v for t in mine
                                for v in t["decode_ms_per_step"])
        print(f"{name} ({roots[name]}), {args.arch}: prefill median "
              f"{pre:.3f} ms, decode median {dec:.3f} ms a step")
    same = all(t["ids"] == turns[0]["ids"] for t in turns)
    print(json.dumps({"arch": args.arch, "same_ids": same,
                      "turns": [{k: t[k] for k in ("name", "prefill_ms",
                                                   "decode_ms_per_step")}
                                for t in turns]}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
