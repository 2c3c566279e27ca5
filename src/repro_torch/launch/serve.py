"""Batched serving entry point of the PyTorch port: prefill a batch of
prompts, then decode N tokens per request with greedy/temperature
sampling against the KV/state caches.

    python -m repro_torch.launch.serve --arch qwen3-8b --reduced --batch 4 \\
        --prompt-len 64 --gen 32 [--device cpu]

Takes the flags of the JAX serving module (``repro.launch.serve``) plus
``--device`` (default ``cuda``; without a card it raises). The prompts
come from ``np.random.default_rng(seed)`` as there, so both packages serve
the same prompts; the parameters come from a ``torch.Generator`` seeded
with `seed` on the device, and temperature sampling from one seeded
``seed + 1``. Greedy decoding takes the first maximum (``argmax``), as JAX
does. Prefill and decode are timed with a device sync at each end. The
serve loop owns its caches, so it donates them: each step writes its slot
in place (``LM.decode_step(..., donate=True)``). The dense products stay
in full f32 on the card (``exact_f32_matmul``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import exact_f32_matmul, resolve_device, synchronize
from repro_torch.models.model import LM


def add_stubs(batch, cfg, b, dtype, device="cuda"):
    """Zero stand-ins for the audio frames (enc-dec) and image tokens (VLM)
    the arch reads as memory."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        batch["audio_embed"] = torch.zeros(b, cfg.num_audio_frames,
                                           cfg.d_model, dtype=dtype,
                                           device=dev)
    if cfg.num_image_tokens:
        batch["image_embed"] = torch.zeros(b, cfg.num_image_tokens,
                                           cfg.d_model, dtype=dtype,
                                           device=dev)
    return batch


def serve_with(lm: LM, params, batch_size: int, prompt_len: int,
               gen_tokens: int, temperature: float = 0.0,
               seed: int = 0) -> dict:
    """Serve `batch_size` prompts of `prompt_len` tokens with the given
    parameters, on their device: prefill, then `gen_tokens` decode steps.
    Returns the JAX serve result's keys, plus ``device`` and the times
    unrounded (``prefill_ms``, ``decode_ms_per_step``)."""
    cfg = lm.cfg
    dev = params["embed"]["table"].device
    exact_f32_matmul()
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch_size, prompt_len))).to(dev)
    batch = add_stubs({"tokens": prompts}, cfg, batch_size, lm.dtype, dev)
    caches = lm.init_caches(batch_size, prompt_len + gen_tokens, dev)

    with torch.inference_mode():
        synchronize(dev)
        t0 = time.perf_counter()
        logits, caches = lm.prefill(params, batch, caches, donate=True)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0

        gen = torch.Generator(dev).manual_seed(seed + 1)
        generated = []
        t1 = time.perf_counter()
        for i in range(gen_tokens):
            if temperature > 0:
                probs = torch.softmax(logits[:, -1].float() / temperature, -1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
            generated.append(tok)
            logits, caches = lm.decode_step(params, tok, caches,
                                            prompt_len + i, donate=True)
        synchronize(dev)
        t_decode = time.perf_counter() - t1

    out_tokens = torch.cat(generated, dim=1).cpu().numpy()
    return {
        "arch": cfg.arch_id, "batch": batch_size, "prompt_len": prompt_len,
        "gen_tokens": gen_tokens,
        "prefill_s": round(t_prefill, 3),
        "decode_s": round(t_decode, 3),
        "decode_tok_per_s": round(batch_size * gen_tokens / t_decode, 1),
        "sample_output": out_tokens[0, :8].tolist(),
        "device": str(dev),
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_step": t_decode * 1e3 / max(gen_tokens, 1),
    }


def serve(arch: str, reduced: bool, batch_size: int, prompt_len: int,
          gen_tokens: int, temperature: float = 0.0, seed: int = 0,
          device="cuda") -> dict:
    """Serve the arch (reduced or at full width) with parameters drawn from
    a generator seeded `seed` on `device`."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    lm = LM(cfg)
    params = lm.init_params(torch.Generator(dev).manual_seed(seed))
    return serve_with(lm, params, batch_size, prompt_len, gen_tokens,
                      temperature, seed)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    out = serve(args.arch, args.reduced, args.batch, args.prompt_len,
                args.gen, args.temperature, args.seed, args.device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
