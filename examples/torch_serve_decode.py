"""Batched serving example on the PyTorch port: prefill + decode with a
KV/state cache on a reduced assigned architecture (works for all 10 ids).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch qwen3-8b
    PYTHONPATH=src python examples/torch_serve_decode.py --arch mamba2-780m \
        --device cpu

The counterpart of examples/serve_decode.py: temperature 0.8 sampling.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve  # noqa: E402


def main(arch: str = "qwen3-8b", gen: int = 16, device: str = "cuda",
         batch: int = 4, prompt_len: int = 64) -> dict:
    """Serve `batch` prompts of the reduced `arch` for `gen` tokens on
    `device`; prints and returns the serve result."""
    out = serve(arch, reduced=True, batch_size=batch, prompt_len=prompt_len,
                gen_tokens=gen, temperature=0.8, device=device)
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args()
    main(args.arch, args.gen, args.device, args.batch, args.prompt_len)
