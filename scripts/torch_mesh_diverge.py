"""Where two ranks' qwen2.5-3b parts from one card's, on two cards.

    python3 scripts/torch_mesh_diverge.py
    python3 scripts/torch_mesh_diverge.py --perturbed RMS

Prints the attention kernel's largest difference from ``attention_ref``
at the local head shapes a rank of two gets (8 / 1 heads of 16 / 2, d
128, 4 x 512 prefill and a 516-key decode row; bf16 and float32), then
runs qwen2.5-3b cut to one layer, float32, random weights from seed 0,
through ``parallel.build_step``'s prefill on one card (``HostMesh``) and
on two NCCL ranks of a (1, 2) mesh, and prints, for each rank, the
parameters whose sums differ from the one-card init and each module's
largest output difference (forward hooks on the stack's modules) and the
logits'.  Needs two CUDA devices (``chip_smoke.py`` phase 31d's setting).

With ``--perturbed RMS`` (one CUDA device): qwen2.5-3b at full depth in
float32 from seed 0, served as phase 31d serves it, once as it is and
once with Gaussian noise of that RMS added to its first layer's prefill
output (``chip_smoke.perturbed_run``; phase 31d measures the two ranks'
first-layer difference): prints how far the perturbed run's first
logits are from the unperturbed ones and where its greedy tokens fork.
"""
import os, sys, tempfile, time
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEED = 0


def hooks(cfg, store):
    from repro_torch.models.model_zoo import _skeleton
    sk = _skeleton(cfg)
    hs = []
    for name, m in sk.named_modules():
        if name.count(".") <= 2 and name:
            def hook(mod, inp, out, name=name):
                store.setdefault(name, (out[0] if isinstance(out, tuple)
                                        else out).detach().float().cpu())
            hs.append(m.register_forward_hook(hook))
    return hs


def run(mesh, cfg, dtype, tag, work, device):
    import chip_smoke as cs
    from repro_torch.models import build_model
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.parallel import build_step
    bundle = build_model(cfg, device=device, dtype=dtype)
    params = {k: p.detach() for k, p in bundle.init(SEED).state_dict().items()}
    sums = {k: float(p.double().sum()) for k, p in params.items()}
    import numpy as np
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 512)), device=device)
    pre = build_step(bundle, mesh, ShapeSpec("p", 512, 4, "prefill"))
    store = {}
    hs = hooks(cfg, store)
    p_l, b_l, c_l = pre.place(params, {"tokens": prompts}, bundle.make_cache(4, 516))
    logits, _ = pre.fn(p_l, b_l, c_l)
    for h in hs:
        h.remove()
    torch.save({"sums": sums, "store": store, "logits": logits.float().cpu()},
               os.path.join(work, f"{tag}.pt"))


def child(rank, world, work, n_layers, dt):
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{work}/store", rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.configs import get_config
        mesh = make_mesh((1, world), ("data", "model"))
        cfg = get_config("qwen2.5-3b").replace(n_layers=n_layers)
        run(mesh, cfg, getattr(torch, dt), f"rank{rank}", work, mesh.device)
    finally:
        dist.destroy_process_group()


def perturbed(rms):
    import subprocess
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    fa.LIBRARY.build()
    arch, n_layers, _, dtype = cs.MESH_AB_RUN
    bundle = cs.mesh_bundle(arch, n_layers, dtype)
    model = bundle.init(SEED)
    prompts = cs.prompts_for(bundle.cfg)
    one = cs.generate_steps(bundle, model, prompts, None, None)
    pert = cs.perturbed_run(bundle, model, prompts, rms)
    err, _ = cs.close_err(pert["logits"], one["logits"], cs.MESH_F32_TOL)
    first = cs.first_difference(pert["ids"], one["ids"])
    print(f"{arch} ({bundle.cfg.n_layers} layers, {dtype}) on one card, its "
          f"first layer's prefill output perturbed by noise of RMS {rms:.3e}:"
          f" first logits max abs err {err:.3e} (of "
          f"{float(one['logits'].abs().max()):.3e}), greedy tokens equal up "
          f"to token {first} of {cs.GEN_TOKENS}")


if __name__ == "__main__" and sys.argv[1:2] == ["--perturbed"]:
    torch.backends.cuda.matmul.allow_tf32 = False
    perturbed(float(sys.argv[2]))
elif __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import flash_attention as fa, ref
    fa.LIBRARY.build()
    for dt in (torch.bfloat16, torch.float32):
        for shape in ((4, 512, 512, 8, 1, 128), (4, 512, 512, 16, 2, 128), (4, 1, 516, 8, 1, 128)):
            B, Sq, Sk, Hq, Hkv, d = shape
            g = torch.Generator(device="cuda"); g.manual_seed(1)
            q = torch.randn(B, Sq, Hq, d, device="cuda", generator=g).to(dt)
            k = torch.randn(B, Sk, Hkv, d, device="cuda", generator=g).to(dt)
            v = torch.randn(B, Sk, Hkv, d, device="cuda", generator=g).to(dt)
            kw = dict(causal=True) if Sq > 1 else dict(causal=False, kv_len=516)
            a = fa.flash_attention_cuda(q, k, v, **kw).float()
            b = ref.attention_ref(q, k, v, **kw).float()
            print("kernel", dt, shape, float((a - b).abs().max()), flush=True)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HostMesh
    for n_layers, dt in ((1, "float32"),):
        work = tempfile.mkdtemp()
        cfg = get_config("qwen2.5-3b").replace(n_layers=n_layers)
        run(HostMesh(torch.device("cuda", 0)), cfg, getattr(torch, dt), "one", work, "cuda:0")
        mp.start_processes(child, args=(2, work, n_layers, dt), nprocs=2, start_method="spawn")
        one = torch.load(os.path.join(work, "one.pt"))
        for r in range(2):
            got = torch.load(os.path.join(work, f"rank{r}.pt"))
            bad = [k for k in one["sums"] if one["sums"][k] != got["sums"][k]]
            print(f"rank {r}: weights differing from the parent's init: {bad[:5]} ({len(bad)})")
            for name, t in one["store"].items():
                u = got["store"].get(name)
                if u is None:
                    print("  missing", name); continue
                if u.shape != t.shape:
                    print("  shape", name, tuple(u.shape), tuple(t.shape)); continue
                print(f"  {name}: max abs err {float((u - t).abs().max()):.3e} of {float(t.abs().max()):.3e}")
            print("  logits", float((got["logits"] - one["logits"]).abs().max()))
