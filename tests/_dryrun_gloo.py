"""The dry-run's sharded steps against the single-device port on a real
4-rank gloo world (float64, CPU): the worker of
tests/test_torch_dryrun_gloo*.py, and a report of its readings.

Four ranks on a (2, 2) ("data", "model") mesh, each holding its shard of
every parameter, input and cache laid out by the port's spec trees,
run a reduced arch through the dry-run's train step (``loss_fn``,
autograd with the gradients reduced to the parameters' placements, one
Adam update) and one decode step from prefilled caches, under
``shardctx.dtensor_ops()``; rank 0 compares each with the single-device
port on the same tensors. Gloo moves the data, so the values are the
job's. For every compared quantity the reading is the largest
|sharded - single| of a leaf over the largest |single| of that leaf, or
of FLOOR times the largest in its tree where the leaf itself is ~0 (a
key bias's gradient is zero up to rounding: softmax is blind to a shift
shared by all keys); the result keeps the worst leaf's reading and path.

``casts="lift"`` runs both sides with the model's f32 casts turned into
float64 ones (`lift_f32`), so that the two programs differ only in the
order of their sums; ``casts="keep"`` runs the model as it is, whose f32
casts round a value that a sharded program sums in another order.

Report, in a fresh process (seeds and casts as wanted):

  PYTHONPATH=src python tests/_dryrun_gloo.py --seeds 0,1,2 --casts lift
"""
import argparse
import json
import os
import sys

WORLD = 4
FLOOR = 1e-2
# the two MoE archs shard their 4 experts over 'model' (2 per rank), so
# the train and decode steps take `shardctx.take`'s partial-sum layout in
# the combine; deepseek-v2 has MLA and MoE in one layer, and its decode
# multiplies the length-sharded latent cache by the up-projections
# (shardctx.local_einsum)
ARCHS = ("qwen3-8b", "granite-moe-1b-a400m", "mamba2-780m",
         "whisper-large-v3", "deepseek-v2-236b")
OVERRIDES = {
    # 1 kv head: fewer kv heads than 'model' shards, as its 8 kv heads on
    # the production 16-way axis
    "qwen3-8b": {"num_kv_heads": 1},
    "deepseek-v2-236b": {"num_layers": 1, "first_dense_layers": 0},
}
QUANTITIES = ("loss", "grads", "adam", "decode", "caches")
# and, once per run, "expert_product/local_einsum" (`expert_product`)


def lift_f32():
    """A function mode under which every float32 that a torch call is
    given as a dtype (``x.to(torch.float32)``, ``x.float()``,
    ``dtype=torch.float32``) is float64 instead."""
    import torch
    from torch.overrides import TorchFunctionMode

    def up(a):
        return torch.float64 if a is torch.float32 else a

    class Lift(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = {k: up(v) for k, v in (kwargs or {}).items()}
            if func is torch.Tensor.float:
                func = torch.Tensor.double
            return func(*[up(a) for a in args], **kwargs)
    return Lift()


def worker(rank: int, init: str, out: str, archs, seeds, casts: str):
    import contextlib

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._pytree import (tree_flatten_with_path, tree_map,
                                     keystr)

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import reduced_grads
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import adapt_spec, batch_axes, \
        cache_specs_for
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.config import InputShape
    from repro_torch.models.model import LM
    from repro_torch.models.shardctx import (P, dtensor_ops, from_local,
                                             placements)
    from repro_torch.optim import adam
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    f64 = torch.float64
    B, S, MAX = 4, 16, 32

    def shard_tree(tree, tree_spec):
        # each rank keeps the slice of the full tree its placements give it
        def one(x, spec):
            pl = placements(adapt_spec(spec, mesh), mesh)
            size, offset = compute_local_shape_and_global_offset(
                x.shape, mesh, pl)
            local = x[tuple(slice(o, o + n) for o, n in zip(offset, size))]
            return from_local(local.contiguous(), mesh, pl, x.shape)
        return tree_map(one, tree, tree_spec)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def rel(a, b):
        """(worst reading, its leaf's path) of tree a against tree b."""
        pairs = [(keystr(path), full(x), y) for (path, x), (_, y) in zip(
            tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0])
            if isinstance(y, torch.Tensor)]
        top = max(y.abs().max() for _, _, y in pairs) * FLOOR
        return max((((x - y).abs().max()
                     / torch.maximum(y.abs().max(), top)).item(), path)
                   for path, x, y in pairs)

    def one(arch: str, seed: int) -> dict:
        cfg = get_arch(arch).reduced(dtype="float64",
                                     **OVERRIDES.get(arch, {}))
        lm = LM(cfg)
        gen = torch.Generator().manual_seed(seed)
        params = lm.init_params(gen)
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        specs = {"tokens": P(batch_axes(mesh), None),
                 "labels": P(batch_axes(mesh), None)}
        if cfg.is_encdec:
            batch["audio_embed"] = torch.randn(
                B, cfg.num_audio_frames, cfg.d_model, generator=gen,
                dtype=f64)
            specs["audio_embed"] = P(batch_axes(mesh), None, None)
        sp = shard_tree(params, lm.param_specs())
        sb = shard_tree(batch, specs)
        opt = adam(1e-3)
        got = {}

        # train: loss and every gradient; one Adam update of the sharded
        # gradients against the same update of them gathered
        loss, grads = loss_and_grads(lm, params, batch)
        with dtensor_ops(cfg.padded_vocab):
            s_loss, s_grads = reduced_grads(lm, sp, sb)
            s_new, _ = opt.apply(sp, s_grads, opt.init(sp))
        g_full = tree_map(full, s_grads)
        new_p, _ = opt.apply(params, g_full, opt.init(params))
        got["loss"] = rel(s_loss, loss)
        got["grads"] = rel(s_grads, grads)
        got["adam"] = rel(s_new, new_p)

        # serve: one decode step from the prefilled caches
        shape = InputShape("gloo", MAX, B, "decode")
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        nxt = tok[:, -1:]
        with torch.no_grad():
            _, caches = lm.prefill(params, prompt,
                                   lm.init_caches(B, MAX, device="cpu"))
            sc = shard_tree(caches, cache_specs_for(lm, shape, mesh))
            dlog, caches = lm.decode_step(params, nxt, caches, S)
            with dtensor_ops(cfg.padded_vocab):
                s_dlog, sc = lm.decode_step(
                    sp, shard_tree(nxt, P(batch_axes(mesh), None)), sc, S)
        got["decode"] = rel(s_dlog, dlog)
        got["caches"] = rel(sc, caches)
        return got

    def expert_product():
        """MoE's dispatch and expert product in the layout torch 2.11's
        sort gives the dry-run's MoE block (the slot index replicated, so
        the dispatched tokens are whole on 'model'; the expert weights
        sharded there on their leading dim, so the product goes to
        `local_einsum`, which cuts the tokens per rank), forward and
        backward (the cut's gradient sharded over 'model' into `take`'s
        backward), against the plain ops."""
        from repro_torch.models.shardctx import _batch_split
        gen = torch.Generator().manual_seed(0)
        xf = torch.randn(12, 8, dtype=f64, generator=gen)       # (T, D)
        sel = torch.randint(0, 12, (4, 6), generator=gen)       # (E, C)
        w = torch.randn(4, 8, 5, dtype=f64, generator=gen)      # (E, D, F)
        cot = torch.randn(4, 6, 5, dtype=f64, generator=gen)
        sx = shard_tree(xf, P("data", None)).requires_grad_()
        sw = shard_tree(w, P("model", None, None)).requires_grad_()
        with dtensor_ops():
            tok = sx[sel]
            assert _batch_split("ecd,edf->ecf", (tok, sw))
            sy = torch.einsum("ecd,edf->ecf", tok, sw)
            (sy.full_tensor() * cot).sum().backward()
        xf.requires_grad_()
        w.requires_grad_()
        y = torch.einsum("ecd,edf->ecf", xf[sel], w)
        (y * cot).sum().backward()
        return rel([sy, sx.grad, sw.grad], [y, xf.grad, w.grad])

    res = {}
    lift = lift_f32() if casts == "lift" else contextlib.nullcontext()
    err, path = expert_product()
    res["expert_product/local_einsum"] = (err, path, 0)
    for arch in archs:
        for seed in seeds:
            with lift:
                got = one(arch, seed)
            for q, (err, path) in got.items():
                key = f"{arch}/{q}"
                if key not in res or err > res[key][0]:
                    res[key] = (err, path, seed)
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--casts", choices=("keep", "lift"), default="lift")
    ap.add_argument("--archs", default=",".join(ARCHS))
    args = ap.parse_args(argv)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res = run(args.archs.split(","), [int(s) for s in
                                          args.seeds.split(",")],
                  args.casts, os.path.join(tmp, "errs.pt"))
    for key, (err, path, seed) in sorted(res.items()):
        print(f"{key:36s} {err:.3e}  seed {seed}  {path}")
    print(json.dumps({k: v[0] for k, v in res.items()}))
    return 0


def run(archs, seeds, casts: str, out: str, timeout_s: float = 600):
    """Run the 4-rank job; {arch/quantity: (worst reading, leaf, seed)}."""
    import torch

    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(
        lambda rank, init: [sys.executable, os.path.abspath(__file__),
                            "worker", str(rank), init, out, ",".join(archs),
                            ",".join(map(str, seeds)), casts],
        WORLD, timeout_s, capture=True)
    for rank, (code, log) in enumerate(ranks):
        if code != 0:
            raise RuntimeError(f"rank {rank} failed:\n{log}")
    return torch.load(out)


if __name__ == "__main__":
    if sys.argv[1:2] == ["worker"]:
        rank, init, out, archs, seeds, casts = sys.argv[2:8]
        worker(int(rank), init, out, archs.split(","),
               [int(s) for s in seeds.split(",")], casts)
    else:
        sys.exit(main())
