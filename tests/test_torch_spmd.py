"""The port's torch.distributed SPMD backend on the CPU (gloo).

Each case starts one process per rank (2 or 4), each holding 1 or 2
partitions of grid-tiny (flat and hierarchical exchange), runs 3 training
steps and an eval forward in float64 at dropout 0 for several engines,
variants and schedules (unsplit and split-phase), and 2 epochs of
`train_pipegcn` in float32. Every rank's loss, gradients, pipeline buffers
and logits must equal the sim backend's bitwise: the SPMD reductions sum
the per-partition terms in global partition order, as the sim backend
does. The recorded schedule events must match the sim step's. Under the
guarded exchange, fault plans and checkpoints cross the backends
bitwise. The exchange helpers are checked against the JAX package's
arrays.
"""
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.core.pipegcn import (flat_exchange_reference as jflat,  # noqa: E402
                                hierarchical_exchange_host as jhier)
from repro_torch.core.pipegcn import (SpmdBackend, _hier_pack,  # noqa: E402
                                      _hier_unpack, flat_exchange_reference,
                                      hierarchical_exchange_host)
from repro_torch.data.graph_pipeline import (from_local_layout,  # noqa: E402
                                             rank_view, to_local_layout)
from repro_torch.launch.mesh import run_ranks  # noqa: E402

JOIN_TIMEOUT_S = 120

# (engine, variant, overlap, fuse_exchange): unsplit and split schedules,
# fused and per-layer exchanges, vanilla and stale, all three engines
CONFIGS = [("blocksparse", "pipegcn", "auto", True),
           ("blocksparse", "vanilla", "none", True),
           ("fused", "pipegcn", "split-phase", False),
           ("coo", "vanilla", "split-phase", True)]

# the same with a boundary wire codec: the encoded uint8 and bf16 wires
# cross gloo's all_to_all_single as they are
WIRE_CONFIGS = [("blocksparse", "pipegcn", "auto", True, "int8"),
                ("coo", "pipegcn", "none", False, "bf16"),
                ("fused", "vanilla", "split-phase", True, "bf16"),
                ("blocksparse", "pipegcn", "none", True, "auto")]

WORKER = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, n_local = (int(a) for a in sys.argv[1:4])
    init, out = sys.argv[4:6]
    configs = eval(sys.argv[6])
    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=world)
    from repro_torch.core import (HealthConfig, ModelConfig, PipeConfig,
                                  PipeGCN, train_pipegcn)
    from repro_torch.core.pipegcn import SimBackend, SpmdBackend
    from repro_torch.core.trace_utils import RecordingBackend
    from repro_torch.data import GraphDataPipeline
    from repro_torch.data.graph_pipeline import rank_view

    P = world * n_local
    tp = GraphDataPipeline.build("grid-tiny", P, agg="fused", layout="rcm",
                                 device="cpu")
    sp = tp.split_spec()
    assert sp is not None
    topo = tp.topo.to(torch.float64)
    data = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
    ds = tp.dataset

    def run(model, backend, topo, data):
        params = model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float64)
        bufs = model.init_buffers(topo, dtype=torch.float64)
        steps = []
        for t in range(3):
            loss, grads, bufs, logits = model.train_step(
                topo, params, bufs, data, backend=backend)
            steps.append((loss, grads, bufs, logits))
            params = {k: params[k] - 0.05 * grads[k] for k in params}
        return steps, model.forward(topo, params, data, backend=backend)

    res = {"split": sp is not None}
    for key in configs:
        agg, variant, overlap, fuse = key[:4]
        mc = ModelConfig(feat_dim=ds.feat_dim, hidden=16, num_layers=3,
                         num_classes=ds.num_classes, dropout=0.0, agg=agg,
                         layout="rcm")
        pc = PipeConfig.named(variant)
        pc = PipeConfig(stale=pc.stale, overlap=overlap, fuse_exchange=fuse,
                        wire=key[4] if len(key) > 4 else "f32")
        model = PipeGCN(mc, pc, split=sp)
        rec = RecordingBackend(SpmdBackend(n_local))
        res[key] = run(model, rec, rank_view(topo, rank, n_local),
                       rank_view(data, rank, n_local)) + (rec.events,)
        if rank == 0:
            sim = RecordingBackend(SimBackend())
            res["sim", key] = run(model, sim, topo, data) + (sim.events,)
    tp32 = GraphDataPipeline.build("grid-tiny", P, agg="blocksparse",
                                   device="cpu")
    mc = ModelConfig(feat_dim=ds.feat_dim, hidden=16, num_layers=3,
                     num_classes=ds.num_classes, dropout=0.0,
                     agg="blocksparse")
    kw = dict(epochs=2, eval_every=1, device="cpu", health=HealthConfig())
    res["train"] = train_pipegcn(tp32, mc, PipeConfig(),
                                 parts_per_device=n_local, **kw).history
    if rank == 0:
        res["sim", "train"] = train_pipegcn(tp32, mc, PipeConfig(),
                                            **kw).history
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
''')


# Faults and checkpoints across backends: 3 guarded steps under a drop plan
# and under a corrupt plan (2-deep FIFO, so buffers carry the partition
# axis second), 4 epochs of train_pipegcn under a background drop plan, and
# checkpoints saved under one backend and resumed under the other.
FAULT_WORKER = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, n_local = (int(a) for a in sys.argv[1:4])
    init, out = sys.argv[4:6]
    dist.init_process_group("gloo", init_method=init,
                            rank=rank, world_size=world)
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import ModelConfig, PipeConfig, PipeGCN, train_pipegcn
    from repro_torch.core.faults import FaultPlan, FaultSite
    from repro_torch.core.pipegcn import SimBackend, SpmdBackend
    from repro_torch.data import GraphDataPipeline
    from repro_torch.data.graph_pipeline import rank_view

    P = world * n_local
    tp = GraphDataPipeline.build("grid-tiny", P, agg="blocksparse",
                                 device="cpu")
    topo = tp.topo.to(torch.float64)
    data = tp.train_data._replace(x=tp.train_data.x.to(torch.float64))
    ds = tp.dataset
    mc = ModelConfig(feat_dim=ds.feat_dim, hidden=16, num_layers=3,
                     num_classes=ds.num_classes, dropout=0.0,
                     agg="blocksparse")
    pc = PipeConfig(guard_exchange=True, staleness_steps=2)
    model = PipeGCN(mc, pc, split=tp.split_spec())
    plans = {"drop": FaultPlan(sites=(
                 FaultSite(0, 1, 0, 3), FaultSite(1, 2, 2, 1, "bwd"),
                 FaultSite(1, 1, 3, 0, "bwd")), rate=0.1, seed=2),
             "corrupt": FaultPlan(rate=0.3, rate_kind="corrupt", seed=4,
                                  density=0.3)}

    def run(backend, topo, data, tables):
        params = model.init_params(torch.Generator().manual_seed(0),
                                   dtype=torch.float64)
        bufs = model.init_buffers(topo, dtype=torch.float64)
        steps = []
        for t in range(3):
            loss, grads, bufs, logits = model.train_step(
                topo, params, bufs, data, backend=backend, step_idx=t,
                faults=tables)
            steps.append((loss, grads, bufs, logits))
            params = {k: params[k] - 0.05 * grads[k] for k in params}
        return steps

    res = {}
    for name, plan in plans.items():
        tab = plan.compile(3, 3, P)
        res[name] = run(SpmdBackend(n_local), rank_view(topo, rank, n_local),
                        rank_view(data, rank, n_local), tab)
        if rank == 0:
            res["sim", name] = run(SimBackend(), topo, data, tab)
    kw = dict(eval_every=1, device="cpu")
    mc32 = ModelConfig(feat_dim=ds.feat_dim, hidden=16, num_layers=3,
                       num_classes=ds.num_classes, dropout=0.0,
                       agg="blocksparse")
    plan = FaultPlan(rate=0.2, seed=1)
    spmd = train_pipegcn(tp, mc32, pc, epochs=4, faults=plan,
                         parts_per_device=n_local, **kw)
    res["train"] = (spmd.history, spmd.anomalies)
    # spmd checkpoint at epoch 2, resumed on sim; sim checkpoint, resumed
    # under spmd
    train_pipegcn(tp, mc32, pc, epochs=2, faults=plan, ckpt_dir=out + "/a",
                  checkpoint_every=2, parts_per_device=n_local, **kw)
    if rank == 0:
        sim = train_pipegcn(tp, mc32, pc, epochs=4, faults=plan, **kw)
        res["sim", "train"] = (sim.history, sim.anomalies)
        res["sim", "params"] = sim.params
        res["sim from spmd"] = train_pipegcn(
            tp, mc32, pc, epochs=4, faults=plan, ckpt_dir=out + "/a",
            resume=True, **kw).params
        train_pipegcn(tp, mc32, pc, epochs=2, faults=plan,
                      ckpt_dir=out + "/b", checkpoint_every=2, **kw)
    dist.barrier()
    res["spmd from sim"] = train_pipegcn(
        tp, mc32, pc, epochs=4, faults=plan, ckpt_dir=out + "/b",
        resume=True, parts_per_device=n_local, **kw).params
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()
''')


def _launch(tmp_path, world, n_local, configs=CONFIGS, worker=WORKER):
    """Run `worker` on `world` ranks; fail (and kill them) on a hang."""
    ranks = run_ranks(
        lambda rank, init: [sys.executable, "-c", worker, str(rank),
                            str(world), str(n_local), init, str(tmp_path),
                            repr(configs)], world, JOIN_TIMEOUT_S,
        capture=True)
    for rank, (code, log) in enumerate(ranks):
        assert code == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _assert_equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and torch.equal(a, b), what
    else:
        assert a == b, what


def _assert_ranks_equal_sim(ranks, configs, world, n_local):
    """Every rank's steps, eval, schedule events and training history
    equal the sim backend's bitwise."""
    sim = ranks[0]
    assert sim["split"]
    for key in configs:
        sim_steps, sim_eval, sim_events = sim["sim", key]
        for rank, res in enumerate(ranks):
            steps, (eval_loss, eval_logits), events = res[key]
            what = f"{key} rank {rank}/{world}×{n_local}"
            assert events == sim_events, what
            local = (rank_view(x, rank, n_local) for x in (
                [s[2] for s in sim_steps], [s[3] for s in sim_steps],
                sim_eval[1]))
            bufs, logits, ev_logits = local
            for t, (loss, grads, b, lg) in enumerate(steps):
                _assert_equal(loss, sim_steps[t][0], f"{what} loss {t}")
                _assert_equal(grads, sim_steps[t][1], f"{what} grads {t}")
                _assert_equal(b, bufs[t], f"{what} buffers {t}")
                _assert_equal(lg, logits[t], f"{what} logits {t}")
            _assert_equal(eval_loss, sim_eval[0], f"{what} eval loss")
            _assert_equal(eval_logits, ev_logits, f"{what} eval logits")
    for res in ranks:
        _assert_equal(res["train"]["loss"], sim["sim", "train"]["loss"],
                      "train_pipegcn losses")
        _assert_equal(res["train"]["val_acc"],
                      sim["sim", "train"]["val_acc"], "train_pipegcn val")


@pytest.mark.parametrize("world,n_local", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_gloo_spmd_equals_sim_bitwise(tmp_path, world, n_local):
    ranks = _launch(tmp_path, world, n_local)
    _assert_ranks_equal_sim(ranks, CONFIGS, world, n_local)


@pytest.mark.parametrize("world,n_local", [(2, 1), (2, 2)])
def test_gloo_spmd_equals_sim_under_wire_codecs(tmp_path, world, n_local):
    """int8, bf16 and auto wires, flat and hierarchical exchange, unsplit
    and split: SPMD equals sim bitwise."""
    ranks = _launch(tmp_path, world, n_local, WIRE_CONFIGS)
    _assert_ranks_equal_sim(ranks, WIRE_CONFIGS, world, n_local)


def test_gloo_spmd_equals_sim_under_faults_and_checkpoints(tmp_path):
    """World 2 with 2 partitions per rank, guarded, 2-deep FIFO: 3 steps
    under a drop plan and under a corrupt plan equal sim bitwise ("es"
    included); train_pipegcn under a drop plan gives sim's history and
    anomalies; a checkpoint saved under SPMD resumes on sim, and one saved
    on sim resumes under SPMD, bitwise to the uninterrupted sim run."""
    world, n_local = 2, 2
    ranks = _launch(tmp_path, world, n_local, worker=FAULT_WORKER)
    sim = ranks[0]
    for rank, res in enumerate(ranks):
        for name in ("drop", "corrupt"):
            sim_steps = sim["sim", name]
            for t, (loss, grads, bufs, logits) in enumerate(res[name]):
                what = f"{name} rank {rank} step {t}"
                _assert_equal(loss, sim_steps[t][0], what)
                _assert_equal(grads, sim_steps[t][1], what)
                want = {k: (tuple(rank_view(x, rank, n_local,
                                            axis=0 if k == "es" else 1)
                                  for x in v) if isinstance(v, tuple)
                            else rank_view(v, rank, n_local))
                        for k, v in sim_steps[t][2].items()}
                _assert_equal(bufs, want, what)
                _assert_equal(logits, rank_view(sim_steps[t][3], rank,
                                                n_local), what)
            assert any(bool((s[2]["es"] > 0).any()) for s in sim_steps), name
        _assert_equal(res["train"], sim["sim", "train"], f"train {rank}")
        assert res["train"][1]["exchange_fallbacks"] > 0
        _assert_equal(res["spmd from sim"], sim["sim", "params"],
                      f"spmd from sim {rank}")
    _assert_equal(sim["sim from spmd"], sim["sim", "params"], "sim from spmd")


@pytest.mark.parametrize("n_dev,n_local", [(1, 4), (2, 2), (4, 1), (2, 3)])
def test_hierarchical_exchange_matches_flat_and_jax(n_dev, n_local):
    rng = np.random.default_rng(n_dev * 10 + n_local)
    p = n_dev * n_local
    S = rng.standard_normal((n_dev, n_local, p, 3, 5))
    got = hierarchical_exchange_host(torch.from_numpy(S))
    flat = flat_exchange_reference(torch.from_numpy(S))
    assert torch.equal(got, flat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jhier(jnp.asarray(S))))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat(jnp.asarray(S))))
    # one rank alone (n_dev = 1): the all_to_all is the identity, and
    # pack + unpack is the whole exchange, a local transpose
    if n_dev == 1:
        s = torch.from_numpy(S[0])
        assert torch.equal(_hier_unpack(_hier_pack(s, n_local), n_local),
                           s.transpose(0, 1))


def test_dropout_mask_does_not_depend_on_ranks_per_partition():
    """One generator stream per global partition id: partition p's mask
    is the same whether 1, 2 or 4 partitions share its rank."""
    P, shape = 4, (7, 5)
    masks = {}
    for n_local in (1, 2, 4):
        world = P // n_local
        for rank in range(world):
            be = SpmdBackend(n_local, rank=rank, world_size=world)
            gen = torch.Generator().manual_seed(11)
            m = be.dropout_mask(gen, 0.5, (n_local,) + shape)
            assert m.shape == (n_local,) + shape
            assert set(m.unique().tolist()) <= {0.0, 2.0}
            for l, pid in enumerate(be.part_ids()):
                masks.setdefault(pid, []).append(m[l])
    for pid, ms in masks.items():
        assert len(ms) == 3
        assert all(torch.equal(ms[0], m) for m in ms[1:]), pid
    assert not torch.equal(masks[0][0], masks[1][0])


def test_local_layout_round_trip():
    x = torch.arange(4 * 3 * 2).reshape(4, 3, 2)
    fifo = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
    loc = to_local_layout({"x": x, "q": (None,)}, 2)
    assert loc["x"].shape == (2, 2, 3, 2) and loc["q"] == (None,)
    assert torch.equal(loc["x"][1], rank_view(x, 1, 2))
    assert torch.equal(from_local_layout(loc)["x"], x)
    assert torch.equal(to_local_layout(fifo, 2, axis=1)[:, 1],
                       rank_view(fifo, 1, 2, axis=1))
    with pytest.raises(ValueError, match="multiple"):
        to_local_layout(x, 3)
