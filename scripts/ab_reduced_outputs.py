"""Whether two checkouts of the repo give the same outputs, bit for bit, on
the ten archs at reduced widths: the plain model path (serve and training)
that a change to the sharded-program layer must leave as it was.

  python3 scripts/ab_reduced_outputs.py ROOT_A ROOT_B [--device cuda] \
      [--out DIR]

Each checkout runs in a fresh process that imports the port from it. Per
arch (f32, parameters drawn on the device from seed 0, inputs from numpy
seed 1): the prefill logits and 3 greedy decode steps' logits, and the
training loss and every gradient leaf (``launch.train.loss_and_grads``).
The tensors go to DIR/ab_outputs_<A|B>.pt (DIR defaults to build/);
standard output gets, per arch, whether every tensor of B equals A's
(``torch.equal``) and the largest difference where one does not.
"""
import argparse
import os
import subprocess
import sys

RUN = r"""
import os, sys
root, dev, out = sys.argv[1:4]
sys.path.insert(0, os.path.join(root, "src"))
import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import exact_f32_matmul
from repro_torch.launch.train import loss_and_grads
from repro_torch.models.model import LM
exact_f32_matmul()
B, S, STEPS = 2, 12, 3
res = {}
for arch in ARCH_IDS:
    lm = LM(get_arch(arch).reduced())
    cfg = lm.cfg
    params = lm.init_params(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S + 1))).to(dev)
    batch = {"tokens": toks[:, :S]}
    if cfg.is_encdec:
        batch["audio_embed"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model))).float().to(dev)
    if cfg.num_image_tokens:
        batch["image_embed"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).float().to(dev)
    got = []
    with torch.no_grad():
        caches = lm.init_caches(B, S + STEPS, device=dev)
        last, caches = lm.prefill(params, batch, caches)
        got.append(last)
        for i in range(STEPS):
            last, caches = lm.decode_step(
                params, last[..., :cfg.vocab_size].argmax(-1).reshape(B, 1),
                caches, S + i)
            got.append(last)
    loss, grads = loss_and_grads(lm, params, dict(batch, labels=toks[:, 1:]))
    got += [loss] + tree_leaves(grads)
    res[arch] = [t.detach().cpu() for t in got]
torch.save(res, out)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    files = {}
    for label, root in (("A", args.root_a), ("B", args.root_b)):
        files[label] = os.path.join(args.out, f"ab_outputs_{label}.pt")
        proc = subprocess.run([sys.executable, "-c", RUN,
                               os.path.abspath(root), args.device,
                               files[label]], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{label} ({root}) failed:\n{proc.stderr[-3000:]}")
            return 1
    import torch
    a, b = (torch.load(files[k]) for k in "AB")
    same = True
    for arch in a:
        pairs = list(zip(a[arch], b[arch]))
        equal = len(a[arch]) == len(b[arch]) and all(
            torch.equal(x, y) for x, y in pairs)
        worst = max(float((x.double() - y.double()).abs().max())
                    for x, y in pairs)
        same &= equal
        print(f"{arch:24s} {len(pairs):3d} tensors "
              f"{'bitwise equal' if equal else 'DIFFER'} (max |B - A| "
              f"{worst:.3e})", flush=True)
    print(f"all bitwise equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
