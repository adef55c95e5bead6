"""Train launcher: an LM config of the registry cut to its smoke size,
trained end to end by ``run_train_loop`` on ``SyntheticLM`` batches.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --steps 10 [--batch 8] [--seq 128] [--ckpt-dir DIR] [--device cpu]

The reference's ``launch/train.py --smoke``: the same cut (2 layers,
d_model 128, float32), the same batches.  Without ``--device`` it runs on
the CUDA card (and raises without one); ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM, params_to_jax_tree
from repro_torch.training.train_loop import TrainLoopConfig, run_train_loop


def smoke_config(arch: str):
    """The reference's smoke cut of ``arch``."""
    spec = get_arch(arch)
    cfg = spec.model
    if spec.family != "lm":
        raise SystemExit("the train launcher supports LM archs")
    overrides = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512, dtype="float32",
                     grad_accum=1, fsdp=False)
    if cfg.is_moe:
        overrides.update(n_routed_experts=8, n_shared_experts=1, top_k=2,
                         moe_d_ff=64, n_kv_heads=4)
    if cfg.is_mla:
        overrides.update(kv_lora_rank=32, q_lora_rank=64, qk_nope_head_dim=32,
                         qk_rope_head_dim=16, v_head_dim=32, n_kv_heads=4)
    return reduced(cfg, **overrides)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args()

    cfg = smoke_config(args.arch)
    device = resolve_device(args.device)
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, args.seq, args.batch))

    def loss_fn(p, batch):
        loss, _ = model.loss_fn(batch["tokens"], batch["labels"])
        return loss

    out = run_train_loop(
        loss_fn, params_to_jax_tree(model), data.batches(args.steps + 1),
        TrainLoopConfig(n_steps=args.steps, ckpt_dir=args.ckpt_dir),
        meta={"arch": args.arch, "smoke": True, "device": str(device)})
    print(f"[train] done on {device}: final loss {out['final_loss']:.4f} "
          f"wall {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
