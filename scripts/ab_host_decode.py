"""Host time of the LM's decode step for two checkouts: on the CPU at a
reduced width, where a step is nearly all Python and dispatch, or on the
card at the published widths cut to a few layers in bf16, where a step
is host-bound (its kernels are short).

  python3 scripts/ab_host_decode.py ROOT_A ROOT_B [--arch qwen3-8b] \
      [--steps 200] [--turns ABBAABBA] [--device cuda --layers 4]

Each turn is a fresh process importing the port from its checkout: one
prefill of 16 tokens at batch 2, then `steps` decode steps timed one by
one (each ended by a device sync on the card); the turn prints its
median and quartiles in microseconds, and the torch calls one more step
makes (counted by a function mode; exact, where the times share the host
with whatever else runs).
"""
import argparse
import subprocess
import sys

TURN = r"""
import os, sys, time
import dataclasses
root, arch, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
dev, layers = sys.argv[4], int(sys.argv[5])
sys.path.insert(0, os.path.join(root, "src"))
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_arch
from repro_torch.models.model import LM
if dev == "cpu":
    lm = LM(get_arch(arch).reduced(dtype="float32"))
else:
    lm = LM(dataclasses.replace(get_arch(arch), num_layers=layers,
                                dtype="bfloat16"))
gen = torch.Generator(dev).manual_seed(0)
params = lm.init_params(gen)
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
tok = torch.randint(0, lm.cfg.vocab_size, (2, 16), generator=gen,
                    device=dev)
prompt = {"tokens": tok}
if lm.cfg.is_encdec:
    prompt["audio_embed"] = torch.randn(2, lm.cfg.num_audio_frames,
                                        lm.cfg.d_model, generator=gen,
                                        device=dev, dtype=lm.dtype)
times = []
with torch.inference_mode():
    caches = lm.init_caches(2, 16 + steps, device=dev)
    _, caches = lm.prefill(params, prompt, caches)
    nxt = tok[:, -1:]
    for i in range(steps):
        sync()
        t = time.perf_counter()
        _, caches = lm.decode_step(params, nxt, caches, 16 + i,
                                   donate=True)
        sync()
        times.append((time.perf_counter() - t) * 1e6)
    from torch.overrides import TorchFunctionMode
    class Count(TorchFunctionMode):
        calls = 0
        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))
    with Count():
        lm.decode_step(params, nxt, caches, 16 + steps - 1)
times.sort()
n = len(times)
print(times[n // 4], times[n // 2], times[3 * n // 4], Count.calls)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--turns", default="ABBAABBA")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=4,
                    help="layers at the published widths (on the card)")
    args = ap.parse_args(argv)
    roots = {"A": args.root_a, "B": args.root_b}
    for turn, label in enumerate(args.turns):
        out = subprocess.run(
            [sys.executable, "-c", TURN, roots[label], args.arch,
             str(args.steps), args.device, str(args.layers)],
            capture_output=True, text=True, check=True)
        q1, med, q3, calls = map(float, out.stdout.split())
        print(f"turn {turn} {label}: decode step median {med:.1f} us "
              f"(quartiles {q1:.1f}, {q3:.1f}), {calls:.0f} torch calls",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
