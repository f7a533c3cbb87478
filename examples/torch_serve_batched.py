"""Batched serving on the port: a batch of prompts prefilled, then decoded
step by step, every dense matmul a launch of the hand-written GEMM
through ``repro_torch.launch.serve.main``.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch rwkv6-1.6b
    PYTHONPATH=src python examples/torch_serve_batched.py \\
        --arch whisper-medium --device cpu

Every model family serves, at its smoke config (``--full`` for the
published one): llama3-8b, granite-moe-3b-a800m, deepseek-v2-lite-16b,
zamba2-1.2b, rwkv6-1.6b, whisper-medium (stub frames, encoded once) and
internvl2-76b (stub patch embeddings ahead of the prompt).  The default
device is the card; ``--models DIR`` takes the knobs from an install.
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3-8b")
    p.add_argument("--device", default="cuda")
    p.add_argument("--full", action="store_true",
                   help="the published config instead of the smoke one")
    p.add_argument("--models", default=None,
                   help="registry directory of installed artifacts")
    args = p.parse_args(argv)
    extra = ([] if args.full else ["--smoke"]) + (
        ["--models", args.models] if args.models else [])
    return serve_main(["--arch", args.arch, "--device", args.device,
                       "--requests", "4", "--prompt-len", "24",
                       "--max-new", "16", "--temperature", "0.8", *extra])


if __name__ == "__main__":
    main()
