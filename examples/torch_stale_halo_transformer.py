"""PipeGCN's deferred boundary exchange transplanted to a sequence-parallel
sliding-window transformer, on the PyTorch port (see models/halo.py).

Trains a tiny local-attention LM on a learnable copy task with the token
axis split across 4 shards, comparing:
  sync      — halo K/V fetched on the critical path (vanilla analogue)
  stale     — halo deferred one step (PipeGCN analogue)
  stale+EMA — smoothed halo (PipeGCN-F analogue)

    PYTHONPATH=src python examples/torch_stale_halo_transformer.py
    PYTHONPATH=src python examples/torch_stale_halo_transformer.py \\
        --device cpu --steps 100

The counterpart of examples/stale_halo_transformer.py.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.models.halo import (HaloConfig, init_halo_buffers,  # noqa: E402
                                     init_params, make_sim_train_step)


def batches(rng, vocab, shards, b, s_loc, steps, device):
    """Copy task with a cross-shard dependency: every token repeats the
    token 16 positions earlier — inside the window but often across the
    shard boundary, so the halo matters."""
    for _ in range(steps):
        total = shards * s_loc
        base = rng.integers(0, vocab, (b, total))
        base[:, 16:] = base[:, :-16]
        toks = base.reshape(b, shards, s_loc).transpose(1, 0, 2)
        labels = np.roll(base, -1, axis=1).reshape(b, shards, s_loc)
        labels = labels.transpose(1, 0, 2)
        yield (torch.from_numpy(np.ascontiguousarray(toks)).to(device),
               torch.from_numpy(np.ascontiguousarray(labels)).to(device))


def main(steps: int = 600, device: str = "cuda") -> dict:
    """Train the three modes for `steps` steps on `device`; returns
    {mode: [loss per step]}."""
    shards, B, S_loc = 4, 16, 64
    results = {}
    for name, stale, smooth in (("sync", False, False),
                                ("stale", True, False),
                                ("stale+EMA", True, True)):
        cfg = HaloConfig(stale=stale, smooth=smooth, window=32, vocab=16,
                         d_model=64, num_heads=4, num_layers=2)
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             cfg)
        bufs = init_halo_buffers(cfg, S_loc, B, shards, device=device)
        opt_init, step = make_sim_train_step(cfg, shards, lr=1e-2)
        opt_state = opt_init(params)
        pos0 = torch.arange(shards, device=device) * S_loc
        rng = np.random.default_rng(0)
        losses = []
        for toks, labels in batches(rng, cfg.vocab, shards, B, S_loc, steps,
                                    device):
            loss, params, opt_state, bufs = step(params, opt_state, toks,
                                                 labels, bufs, pos0)
            losses.append(float(loss))
        results[name] = losses
        print(f"{name:10s} loss: start={losses[0]:.3f} "
              f"mid={losses[steps // 2]:.3f} final={losses[-1]:.3f}")
    sync_final = results["sync"][-1]
    for name in ("stale", "stale+EMA"):
        gap = results[name][-1] - sync_final
        print(f"{name:10s} final-loss gap vs sync: {gap:+.4f} "
              f"({'parity' if abs(gap) < 0.15 else 'degraded'})")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args()
    main(args.steps, args.device)
