"""The elastic runtime on the port's torch.distributed backend: gloo drills
on the CPU, 4 ranks, one partition each of tiny P = 4.

The loss is logical, as in the JAX package's drill: every process stays
alive, the survivors step on their own process group, and the lost rank
follows them (one broadcast per epoch) until it rejoins or the run ends.
Checked: losing device 1, the recovery equals a fresh launch on the
survivor ranks from a copy of the same checkpoint, bitwise, and equals
the sim backend's drill; losing device 0, the checkpoint writer moves to
rank 1 and the recovery equals the fresh launch; a bounded outage of
device 2 recovers and rejoins, as on the sim backend. Every rank returns
the same parameters, history and anomalies.
"""
import sys
import textwrap

import pytest
import torch

import _torch_threads  # noqa: F401
from repro_torch.launch.mesh import run_ranks

JOIN_TIMEOUT_S = 120
WORLD = 4

WORKER = textwrap.dedent('''
    import dataclasses, os, shutil, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, out = sys.argv[3:5]
    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=world)
    from repro_torch.core import (ElasticConfig, ElasticPlan, FaultPlan,
                                  ModelConfig, PipeConfig, device_down_site,
                                  train_pipegcn)
    from repro_torch.data import GraphDataPipeline

    P = world
    pipes = {agg: GraphDataPipeline.build("tiny", P, seed=0, agg=agg,
                                          device="cpu")
             for agg in ("coo", "blocksparse")}

    def cfgs(agg):
        ds = pipes[agg].dataset
        mc = ModelConfig(kind="sage", feat_dim=ds.feat_dim, hidden=16,
                         num_layers=3, num_classes=ds.num_classes,
                         dropout=0.0, agg=agg)
        pc = dataclasses.replace(PipeConfig.named("pipegcn"),
                                 guard_exchange=True, max_staleness=8)
        return mc, pc

    def pack(r):
        return (r.params, r.history, r.anomalies, r.recoveries,
                r.resumed_from, r.final_metrics)

    res = {}
    for lost, agg in ((1, "blocksparse"), (0, "coo")):
        mc, pc = cfgs(agg)
        ec = ElasticConfig(rejoin=False)
        kw = dict(epochs=8, eval_every=1, device="cpu", elastic=ec,
                  checkpoint_every=2)
        faults = FaultPlan(sites=(device_down_site(step=3, device=lost),))
        d_a, d_b = f"{out}/lost{lost}/a", f"{out}/lost{lost}/b"
        a = train_pipegcn(pipes[agg], mc, pc, faults=faults, ckpt_dir=d_a,
                          parts_per_device=1, **kw)
        step = a.anomalies["device_losses"][0]["resumed_from"]
        if rank == 0:
            name = "step_%08d" % step
            shutil.copytree(os.path.join(d_a, name), os.path.join(d_b, name))
        dist.barrier()
        plan = ElasticPlan(P, P, tuple(d for d in range(P) if d != lost))
        b = train_pipegcn(pipes[agg], mc, pc, elastic_plan=plan,
                          ckpt_dir=d_b, resume=True, parts_per_device=1,
                          **kw)
        res["lost", lost] = (pack(a), pack(b), sorted(os.listdir(d_a)))
        if rank == 0:
            res["sim", lost] = pack(train_pipegcn(
                pipes[agg], mc, pc, faults=faults,
                ckpt_dir=f"{out}/sim{lost}", **kw))
    mc, pc = cfgs("blocksparse")
    kw = dict(epochs=12, eval_every=2, device="cpu", checkpoint_every=2,
              elastic=ElasticConfig(rejoin=True),
              faults=FaultPlan(sites=(device_down_site(step=3, device=2,
                                                       until=6),)))
    res["rejoin"] = pack(train_pipegcn(pipes["blocksparse"], mc, pc,
                                       ckpt_dir=f"{out}/rejoin",
                                       parts_per_device=1, **kw))
    if rank == 0:
        res["sim", "rejoin"] = pack(train_pipegcn(
            pipes["blocksparse"], mc, pc, ckpt_dir=f"{out}/simrejoin", **kw))
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the three drills (one gloo job)."""
    out = tmp_path_factory.mktemp("elastic_gloo")
    ranks = run_ranks(
        lambda rank, init: [sys.executable, "-c", WORKER, str(rank),
                            str(WORLD), init, str(out)], WORLD,
        JOIN_TIMEOUT_S, capture=True)
    for rank, (code, log) in enumerate(ranks):
        assert code == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


def _same_on_every_rank(ranks, key):
    for r, res in enumerate(ranks[1:], 1):
        _equal(res[key], ranks[0][key], f"{key} rank {r}")


@pytest.mark.parametrize("lost", [1, 0])
def test_gloo_recovery_equals_fresh_survivor_launch(ranks, lost):
    """Device `lost` goes down at step 3: detected, the survivors restore
    the last checkpoint on the padded layout (3 ranks × 2 partitions, 2
    pads), and from there the run equals, bitwise, a fresh launch on the
    survivor ranks from a copy of that checkpoint, and the sim backend's
    drill. Losing device 0, rank 1 writes the checkpoints after the
    loss."""
    _same_on_every_rank(ranks, ("lost", lost))
    (a, b, written) = ranks[0]["lost", lost]
    params, hist, anom, rec, _, final = a
    loss = anom["device_losses"]
    assert rec == 1 and len(loss) == 1
    assert loss[0]["device"] == lost
    assert loss[0]["survivors"] == [d for d in range(WORLD) if d != lost]
    step = loss[0]["resumed_from"]
    assert b[3] == 0 and b[4] == step
    _equal(params, b[0], "recovery vs fresh params")
    n = len(b[1]["epoch"])
    for k in ("epoch", "loss", "val_acc", "test_acc"):
        assert hist[k][-n:] == b[1][k], k
    assert written == [f"step_{s:08d}" for s in (2, 4, 6, 8)]
    sim = ranks[0]["sim", lost]
    _equal(params, sim[0], "gloo vs sim params")
    assert (hist, anom, final) == (sim[1], sim[2], sim[5])


def test_gloo_rejoin(ranks):
    """Device 2 down for steps [3, 6): one recovery onto ranks 0, 1, 3,
    then a rejoin at the next checkpoint boundary after it returns (rank 2
    restores the written checkpoint); the run ends on 4 ranks, equal to
    the sim backend's drill."""
    _same_on_every_rank(ranks, "rejoin")
    params, hist, anom, rec, _, final = ranks[0]["rejoin"]
    assert rec == 1 and anom["rejoins"] == 1
    assert anom["device_losses"][0]["survivors"] == [0, 1, 3]
    sim = ranks[0]["sim", "rejoin"]
    _equal(params, sim[0], "gloo vs sim params")
    assert (hist, anom, final) == (sim[1], sim[2], sim[5])
