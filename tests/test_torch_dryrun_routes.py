"""What reaches DTensor in the dry-run's formerly refused combos, on the CPU.

torch 2.11's DTensor (the card machine's) refused four ops on the dry-run's
path, so ``python -m repro_torch.launch.dryrun --all`` erred on 4 of the 40
combos on 16x16 and 7 of 40 on 2x16x16; ``shardctx.dtensor_ops()`` now
routes them to shard-wise forms (`cumsum_local`, `take`, `local_einsum`).
The torch here refuses none of them, so this file checks what reaches
DTensor instead: the combos run at reduced widths (one layer, bf16) on the
production meshes, abstract, as rank 0 of a fake process group, under a
``TorchDispatchMode`` that records every (aten op, arguments) pair that
reaches DTensor inside the step, forward and backward
(tests/_dryrun_routes.py); no refused pair may appear, and every combo
must give a row with no error. The three 2x16x16 train_4k combos are left
to the card test (tests/test_torch_cuda.py ``-k refused``): this torch
plans their redistributions by a graph search and takes over 15 minutes on
the first of them here. A torch release whose DTensor refuses a new op on
this path shows up in that card test first.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import _torch_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 240

# the combos, in processes run side by side (a process's later combos
# reuse DTensor's sharding and redistribution plans of its earlier ones)
GROUPS = (
    ("granite-moe-1b-a400m:train_4k:16x16", "deepseek-v2-236b:train_4k:16x16"),
    ("mamba2-780m:train_4k:16x16", "deepseek-v2-236b:decode_32k:16x16"),
    ("granite-moe-1b-a400m:decode_32k:2x16x16",),
)

# The pairs torch 2.11 refused on the card (full size), as the recorder
# writes them: (op, its arguments), a DTensor as its shape and placements.
REFUSED = {
    # mamba2-780m train_4k, both meshes: the backward of
    # torch.cumsum(dtac, dim=2) (models/ssd.py), autograd's reversed sum.
    # "NotImplementedError: Operator aten.flip.default does not have a
    # sharding strategy registered."
    "flip": ["aten.flip.default",
             [{"shape": [256, 16, 256, 48], "placements": ["S(0)", "P(sum)"]},
              [2]]],
    # granite-moe-1b-a400m and deepseek-v2-236b train_4k on 16x16: the
    # backward of xf[sel_t] (models/moe.py _moe_block), values of more
    # dims than the tensor written.
    # "RuntimeError: Shard dim -1 in placements (Shard(dim=-1),
    # Replicate()) must be normalized ... Sharding propagation failed for
    # aten.index_put.default(Spec(bf16[1048576, 1024](RR)), [...(RR)],
    # Spec(bf16[32, 327680, 1024](S(0)P(sum))), True)"
    "index_put": ["aten.index_put.default",
                  [{"shape": [1048576, 1024], "placements": ["R", "R"]},
                   [{"shape": [32, 327680], "placements": ["R", "R"]}],
                   {"shape": [32, 327680, 1024],
                    "placements": ["S(0)", "P(sum)"]}, True]],
    # granite-moe-1b-a400m train / prefill / decode and deepseek-v2-236b
    # train / prefill on 2x16x16: _combine's slot[gi, top_i, arange(t)]
    # (models/moe.py), top_i's token dim split over 'pod' and 'data'.
    # "RuntimeError: Sharding propagation failed on op aten.index.Tensor
    # ... Error: Tensor dim 1 is already sharded on mesh dim 0, DTensor
    # operator implementation does not support things like hybrid sharding
    # strategies yet (i.e. [Shard(0), Shard(0)])"
    "index": ["aten.index.Tensor",
              [{"shape": [1, 32, 128], "placements": ["R", "R", "R"]},
               [{"shape": [1, 1, 1], "placements": ["R", "R", "R"]},
                {"shape": [1, 128, 8], "placements": ["S(1)", "S(1)", "R"]},
                {"shape": [1, 128, 1], "placements": ["R", "R", "R"]}]]],
    # deepseek-v2-236b decode_32k, both meshes: c_kv @ wk_b
    # (models/mla.py _expand) on the length-sharded latent cache; matmul
    # flattens (B, L) into one dim.
    # "RuntimeError: ('Attempted to flatten multiple dimensions, with
    # dimension 1 being sharded. ', 'It cannot be performed without
    # redistribution, which is disallowed by the current operator.')
    # Sharding propagation failed for aten.view.default(Spec(bf16[128,
    # 32768, 512](S(0)S(1))), [4194304, 512])"
    "view": ["aten.view.default",
             [{"shape": [128, 32768, 512], "placements": ["S(0)", "S(1)"]},
              [4194304, 512]]],
}


def _dt(a) -> bool:
    return isinstance(a, dict) and "placements" in a


def _shard_dims(a) -> list:
    return [int(p[2:-1]) for p in a["placements"] if p.startswith("S(")]


def _flattens_a_sharded_dim(x, shape) -> bool:
    """Whether viewing `x` as `shape` merges a run of its dims (size-1 dims
    aside) whose later member is sharded."""
    sharded, i = set(_shard_dims(x)), 0
    for n in shape:
        run, size = [], 1
        while i < len(x["shape"]) and (size < n or not run):
            size *= x["shape"][i]
            if x["shape"][i] != 1:
                run.append(i)
            i += 1
        if size != n:
            return False        # not a pure merge of runs: no flatten
        if any(d in sharded for d in run[1:]):
            return True
    return False


def refused_kind(op, args):
    """The kind of refused pair (a key of REFUSED) that (op, args) is, or
    None. Each kind is matched on what made 2.11 refuse it: flip has no
    rule at all; index_put's values have more dims than its tensor (2.11
    shards the tensor on a negative dim where the values are sharded on a
    leading one); an index tensor splits one dim over several mesh dims;
    a view flattens a run of dims whose later member is sharded."""
    if op == "aten.flip.default":
        return "flip"
    if op in ("aten.index_put.default", "aten.index_put_.default",
              "aten._index_put_impl_.default"):
        if _dt(args[2]) and len(args[2]["shape"]) > len(args[0]["shape"]):
            return "index_put"
    if op == "aten.index.Tensor":
        if any(_dt(i) and len(_shard_dims(i)) > len(set(_shard_dims(i)))
               for i in args[1]):
            return "index"
    if op in ("aten.view.default", "aten._unsafe_view.default"):
        if _dt(args[0]) and _flattens_a_sharded_dim(args[0], args[1]):
            return "view"
    return None


def test_refused_pairs_are_matched():
    for kind, (op, args) in REFUSED.items():
        assert refused_kind(op, args) == kind
    # the size-1 dims a decode step's views merge are not a flatten
    assert refused_kind("aten.view.default", [
        {"shape": [128, 16, 1, 32768, 1], "placements": ["S(0)", "S(3)"]},
        [128, 16, 32768]]) is None


def _run(combos) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_dryrun_routes.py"), "--record",
         "--layers", "1", *combos], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_refused_pair_reaches_dtensor():
    with ThreadPoolExecutor(len(GROUPS)) as ex:
        outs = list(ex.map(_run, GROUPS))
    rows = {k: v for out in outs for k, v in out["rows"].items()}
    assert sorted(rows) == sorted(c for g in GROUPS for c in g)
    errs = {k: v["error"] for k, v in rows.items() if "error" in v}
    assert not errs, errs
    for combo, row in rows.items():
        assert row["argument_size_in_bytes"] > 0, combo
        assert row["collective_total_bytes"] == sum(
            row["collective_bytes_per_device"].values()), combo
    found = [(refused_kind(op, args), op, args) for out in outs
             for op, args in out["ops"] if refused_kind(op, args)]
    assert not found, found[:4]
    # the recorder saw the steps: matmuls forward and backward
    assert all(any(op == "aten.mm.default" for op, _ in out["ops"])
               for out in outs)
