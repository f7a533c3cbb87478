"""End-to-end driver of the port: train a reduced llama3-family model for a
few hundred steps on the synthetic Markov LM task, with checkpointing and
auto-resume (``examples/train_lm.py``'s, on PyTorch).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

It trains on the card unless ``--device cpu`` is given.  The loss must
drop: the same substrate (model zoo, optimizer, data, checkpointing, fault
tolerance) drives ``repro_torch.launch.train``.
"""

import argparse
import dataclasses

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import TrainLoop
from repro_torch.optim import AdamWConfig


def reduced_config(arch: str = "llama3-8b"):
    """The smoke config of ``arch`` cut to 4 layers of width 128 and a
    512-token vocabulary (the reference example's)."""
    return dataclasses.replace(get_smoke_config(arch), n_layers=4,
                               d_model=128, n_heads=4, kv_heads=2, d_ff=320,
                               vocab=512)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--ckpt", default="runs/example_train")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    args = p.parse_args(argv)

    cfg = reduced_config(args.arch)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=64, global_batch=8)
    loop = TrainLoop(
        cfg=cfg,
        adamw=AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=20),
        ckpt=Checkpointer(args.ckpt), dataset=ds, device=args.device,
        ckpt_every=100, log_every=25)
    out = loop.run(args.steps)
    first = out["history"][0]["loss"] if out["history"] else float("nan")
    last = out["history"][-1]["loss"] if out["history"] else float("nan")
    print(f"loss: {first:.3f} → {last:.3f} over {out['final_step']} steps "
          f"on {loop.device}")
    if not last < first:
        raise SystemExit("training did not reduce the loss")
    return out


if __name__ == "__main__":
    main()
