"""The port's atomic checkpoints, bit-exact resume and preemption, and
restoring a JAX checkpoint into the port, on the CPU.

The checkpoint module's cases are tests/test_checkpoint.py's (atomic
stage + rename, strict validation naming the leaf, retries, keep-last
retention), parametrised where they repeat each other. The trainer
resumes bitwise at dropout 0.5 (the generator state is part of the
checkpoint) under the guard with a 2-deep FIFO and with EMA buffers, and
SIGTERM / SIGINT end a run after its epoch. A checkpoint the JAX trainer
writes restores into the port with every leaf but the key bitwise, and
the port's next epochs stay within 1e-5 of JAX's resumed ones.
"""
import dataclasses
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.core.config import ModelConfig as JModelConfig  # noqa: E402
from repro.core.config import PipeConfig as JPipeConfig  # noqa: E402
from repro.core.trainer import train_pipegcn as jtrain  # noqa: E402
from repro.data import GraphDataPipeline as JPipeline  # noqa: E402
from repro_torch.checkpoint import (latest_step, read_manifest,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import (ModelConfig, PipeConfig, PipeGCN,  # noqa: E402
                              train_pipegcn)
from repro_torch.data import GraphDataPipeline  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

P = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors: under the
    suite's parallel workers, several threads per worker oversubscribe
    the cores and a tiny training step then takes seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipeline():
    return GraphDataPipeline.build("tiny", P, seed=0, device="cpu")


def _cfgs(pipeline, variant="pipegcn", dropout=0.0, **pipe_kw):
    ds = pipeline.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=dropout)
    return ModelConfig(**cfg), dataclasses.replace(
        PipeConfig.named(variant), **pipe_kw)


def _equal(a, b, what="tree"):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, what


# ---------------------------------------------------------------------------
# atomicity + validation
# ---------------------------------------------------------------------------

def test_save_is_atomic_no_tmp_left(tmp_path):
    d = str(tmp_path)
    path = save_checkpoint(d, 3, {"w": torch.arange(4.0)})
    assert os.path.isdir(path)
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert latest_step(d) == 3


def test_latest_step_ignores_tmp_and_junk(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 2, {"w": torch.zeros(2)})
    # a crashed save's staging dir and unrelated noise stay invisible
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    os.makedirs(os.path.join(d, "step_xyz"))
    open(os.path.join(d, "notes.txt"), "w").close()
    assert latest_step(d) == 2
    got = restore_checkpoint(d, None, {"w": torch.ones(2)})
    assert (got["w"] == 0).all()


def test_save_clears_leftover_tmp_and_overwrites(tmp_path):
    d = str(tmp_path)
    junk = os.path.join(d, "step_00000001.tmp")
    os.makedirs(junk)
    open(os.path.join(junk, "arrays.npz"), "w").close()
    save_checkpoint(d, 1, {"w": torch.ones(3)})
    assert (restore_checkpoint(d, 1, {"w": torch.zeros(3)})["w"] == 1).all()
    save_checkpoint(d, 1, {"w": torch.full((3,), 2.0)})   # overwrite=True
    assert (restore_checkpoint(d, 1, {"w": torch.zeros(3)})["w"] == 2).all()
    with pytest.raises(FileExistsError):
        save_checkpoint(d, 1, {"w": torch.ones(3)}, overwrite=False)


# (saved tree, restore template, error pattern, leaf named in the error)
BAD_RESTORES = [
    ({"a": torch.zeros(2), "b": torch.ones(3)},
     {"a": torch.zeros(2), "c": torch.ones(3)}, "treedef", None),
    ({"a": torch.zeros(2)}, {"a": torch.zeros(2), "b": torch.ones(3)},
     "leaves", None),
    ({"outer": {"weights": torch.zeros(2), "steps": torch.zeros(
        (), dtype=torch.int32)}},
     {"outer": {"weights": torch.zeros(2), "steps": torch.zeros(
         (), dtype=torch.int64)}}, "dtype", "steps"),
    ({"weights": torch.zeros(2, 3)}, {"weights": torch.zeros(3, 2)},
     "shape", "weights"),
    ({"w": (torch.zeros(2), torch.zeros(2))},
     {"w": [torch.zeros(2), torch.zeros(2)]}, "treedef", None),
]


@pytest.mark.parametrize("saved,template,pattern,leaf", BAD_RESTORES)
def test_restore_validates(tmp_path, saved, template, pattern, leaf):
    d = str(tmp_path)
    save_checkpoint(d, 0, saved)
    with pytest.raises(ValueError, match=pattern) as err:
        restore_checkpoint(d, 0, template)
    if leaf is not None:
        assert leaf in str(err.value)


def test_restore_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), None, {"w": torch.zeros(1)})


# ---------------------------------------------------------------------------
# retry + retention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("failures,retries", [(2, 3), (5, 3)])
def test_save_retries_transient_oserror(tmp_path, monkeypatch, failures,
                                        retries):
    """A flaky os.replace: two failures still land a complete, restorable
    checkpoint on the third attempt (each attempt restages); a permanent
    failure surfaces after `retries` attempts with nothing committed."""
    import repro_torch.checkpoint.checkpoint as ckpt_mod
    real_replace = os.replace
    calls = {"n": 0}

    def flaky(src, dst):
        calls["n"] += 1
        if calls["n"] <= failures:
            raise OSError("injected transient failure")
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt_mod.os, "replace", flaky)
    monkeypatch.setattr(ckpt_mod.time, "sleep", lambda _s: None)
    d = str(tmp_path)
    if failures < retries:
        save_checkpoint(d, 1, {"w": torch.arange(3.0)}, retries=retries)
        assert calls["n"] == failures + 1 and latest_step(d) == 1
        got = restore_checkpoint(d, 1, {"w": torch.zeros(3)})
        assert torch.equal(got["w"], torch.arange(3.0))
    else:
        with pytest.raises(OSError, match="injected"):
            save_checkpoint(d, 1, {"w": torch.zeros(2)}, retries=retries)
        assert calls["n"] == retries and latest_step(d) is None


def test_save_does_not_retry_fileexists(tmp_path, monkeypatch):
    import repro_torch.checkpoint.checkpoint as ckpt_mod

    def no_sleep(_s):
        raise AssertionError("must not back off on FileExistsError")

    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    monkeypatch.setattr(ckpt_mod.time, "sleep", no_sleep)
    with pytest.raises(FileExistsError):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)},
                        overwrite=False)


def test_keep_last_prunes_committed_only(tmp_path):
    """Oldest committed dirs go, the newest N stay; `.tmp` leftovers do
    not count, and an orphan `.tmp` of a surviving step stays."""
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, s, {"w": torch.full((2,), float(s))})
    os.makedirs(os.path.join(d, "step_00000001.tmp"))
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    save_checkpoint(d, 4, {"w": torch.full((2,), 4.0)}, keep_last=2)
    assert set(os.listdir(d)) == {"step_00000003", "step_00000004",
                                  "step_00000007.tmp"}
    assert latest_step(d) == 4
    assert (restore_checkpoint(d, None, {"w": torch.zeros(2)})["w"]
            == 4.0).all()


def test_keep_last_never_prunes_just_written(tmp_path):
    d = str(tmp_path)
    for s in (5, 6):
        save_checkpoint(d, s, {"w": torch.zeros(1)})
    save_checkpoint(d, 2, {"w": torch.ones(1)}, keep_last=1)
    assert "step_00000002" in os.listdir(d)
    with pytest.raises(ValueError, match="keep_last"):
        save_checkpoint(d, 9, {"w": torch.zeros(1)}, keep_last=0)


def test_trainer_checkpoint_keep(tmp_path, pipeline):
    mc, pc = _cfgs(pipeline)
    d = str(tmp_path)
    train_pipegcn(pipeline, mc, pc, epochs=8, eval_every=4, device="cpu",
                  ckpt_dir=d, checkpoint_every=2, checkpoint_keep=2)
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        "step_00000006", "step_00000008"]


# ---------------------------------------------------------------------------
# leaves and layout
# ---------------------------------------------------------------------------

def test_leaves_round_trip_and_manifest(tmp_path):
    """bf16 (stored as uint16 views), f32, f64, int32, bool, uint8 tensors,
    numpy arrays, Python ints and NamedTuples round-trip bitwise; the
    manifest holds JAX's keystr paths in sorted-key order and the uint16
    view of bf16."""
    from repro_torch.optim.optimizers import OptState
    g = torch.Generator().manual_seed(0)
    state = {"z": torch.randn(8, 5, generator=g).to(torch.bfloat16),
             "a": OptState(step=7, mu={"w1": torch.randn(3, generator=g),
                                       "w0": torch.randn(2, generator=g)},
                           nu={}),
             "m": (torch.arange(3, dtype=torch.int32),
                   torch.tensor([True, False]),
                   torch.randn(2, dtype=torch.float64, generator=g)),
             "k": g.get_state(), "e": 5, "n": np.arange(4, dtype=np.uint32)}
    d = str(tmp_path)
    save_checkpoint(d, 0, state)
    man = read_manifest(d, 0)
    assert [r["path"] for r in man["leaves"]] == [
        "['a'].step", "['a'].mu['w0']", "['a'].mu['w1']", "['e']", "['k']",
        "['m'][0]", "['m'][1]", "['m'][2]", "['n']", "['z']"]
    assert [r["dtype"] for r in man["leaves"]] == [
        "int32", "float32", "float32", "int32", "uint8", "int32", "bool",
        "float64", "uint32", "bfloat16"]
    assert man["num_leaves"] == 10 and man["step"] == 0
    assert np.load(os.path.join(d, "step_00000000", "arrays.npz"))[
        "leaf_9"].dtype == np.uint16
    tmpl = {"z": torch.zeros(8, 5, dtype=torch.bfloat16),
            "a": OptState(step=0, mu={"w1": torch.zeros(3),
                                      "w0": torch.zeros(2)}, nu={}),
            "m": (torch.zeros(3, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.bool),
                  torch.zeros(2, dtype=torch.float64)),
            "k": torch.zeros_like(g.get_state()), "e": 0,
            "n": np.zeros(4, np.uint32)}
    got = restore_checkpoint(d, 0, tmpl)
    n = got.pop("n")
    np.testing.assert_array_equal(n, state.pop("n"))
    _equal(got, state)


def test_jax_checkpoint_leaves_restore(tmp_path):
    """A JAX-written tree (bf16, f32, int32, nested) restores into the
    port's template bitwise; the port's checkpoint does not restore into
    JAX, whose treedef string it cannot write."""
    key = jax.random.PRNGKey(0)
    jstate = {"h": jax.random.normal(key, (8, 5)).astype(jnp.bfloat16),
              "w": {"b": jax.random.normal(key, (4,), dtype=jnp.float32)},
              "n": (jnp.arange(3, dtype=jnp.int32),)}
    d = str(tmp_path / "jax")
    jsave(d, 0, jstate)
    got = restore_checkpoint(d, 0, {
        "h": torch.zeros(8, 5, dtype=torch.bfloat16),
        "w": {"b": torch.zeros(4)}, "n": (torch.zeros(3, dtype=torch.int32),)})
    assert torch.equal(got["h"].view(torch.int16), torch.from_numpy(
        np.array(jstate["h"]).view(np.int16)))
    assert torch.equal(got["w"]["b"], torch.from_numpy(
        np.array(jstate["w"]["b"])))
    assert torch.equal(got["n"][0], torch.arange(3, dtype=torch.int32))
    d2 = str(tmp_path / "port")
    save_checkpoint(d2, 0, {"w": {"b": got["w"]["b"]}})
    with pytest.raises(ValueError, match="treedef"):
        jrestore(d2, 0, {"w": {"b": jnp.zeros(4, jnp.float32)}})


# ---------------------------------------------------------------------------
# trainer: resume, preemption, a JAX checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,pipe_kw", [
    ("pipegcn", {"guard_exchange": True, "staleness_steps": 2}),
    ("pipegcn-gf", {"guard_exchange": True}),
])
def test_trainer_resume_is_bit_exact(tmp_path, pipeline, variant, pipe_kw):
    """6 epochs == 3 epochs + resume for 3 more, at dropout 0.5 (the
    generator state rides in the checkpoint): params, the resumed losses
    and the final metrics bitwise; and the checkpointed state after 6
    epochs (params, Adam moments, buffers, es, generator) equals the
    uninterrupted run's."""
    mc, pc = _cfgs(pipeline, variant, dropout=0.5, **pipe_kw)
    full_dir, d = str(tmp_path / "full"), str(tmp_path / "ckpt")
    full = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=1,
                         device="cpu", ckpt_dir=full_dir, checkpoint_every=6)
    train_pipegcn(pipeline, mc, pc, epochs=3, eval_every=1, device="cpu",
                  ckpt_dir=d, checkpoint_every=3)
    assert latest_step(d) == 3
    res = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=1,
                        device="cpu", ckpt_dir=d, checkpoint_every=3,
                        resume=True)
    assert res.resumed_from == 3 and res.history["epoch"] == [3, 4, 5]
    assert res.history["loss"] == full.history["loss"][3:]
    _equal(res.params, full.params)
    assert res.final_metrics == full.final_metrics
    model = PipeGCN(mc, pc)
    params = model.init_params(torch.Generator().manual_seed(0))
    tmpl = {"params": params, "opt_state": adam(0.01).init(params),
            "buffers": model.init_buffers(pipeline.topo),
            "key": torch.Generator().get_state(), "epoch": 0}
    a = restore_checkpoint(d, 6, tmpl)
    b = restore_checkpoint(full_dir, 6, tmpl)
    _equal(a, b)
    assert a["epoch"] == 6 and a["opt_state"].step == 6
    assert a["buffers"]["es"].shape == (P, 2, 3, P)


def test_sigterm_finishes_epoch_checkpoints_and_resumes_bitwise(
        tmp_path, pipeline):
    """SIGTERM from the log callback after 3 epoch lines: the epoch ends,
    a final checkpoint lands although every=100, the result is preempted,
    the handler is restored, and resuming equals the uninterrupted run."""
    mc, pc = _cfgs(pipeline, guard_exchange=True)
    full = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=1,
                         device="cpu")
    seen = {"epochs": 0}

    def kill_after_three(line):
        if line.startswith("epoch "):
            seen["epochs"] += 1
            if seen["epochs"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    d = str(tmp_path)
    res = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=1,
                        log=kill_after_three, device="cpu", ckpt_dir=d,
                        checkpoint_every=100)
    assert res.preempted and res.history["epoch"] == [0, 1, 2]
    assert latest_step(d) == 3
    assert signal.getsignal(signal.SIGTERM) is before
    res2 = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=1,
                         device="cpu", ckpt_dir=d, checkpoint_every=100,
                         resume=True)
    assert res2.resumed_from == 3 and not res2.preempted
    _equal(res2.params, full.params)
    assert res2.final_metrics == full.final_metrics


def test_sigint_without_checkpointing_still_exits_cleanly(pipeline):
    mc, pc = _cfgs(pipeline)
    seen = {"epochs": 0}

    def kill_after_two(line):
        if line.startswith("epoch "):
            seen["epochs"] += 1
            if seen["epochs"] == 2:
                os.kill(os.getpid(), signal.SIGINT)

    res = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=1,
                        log=kill_after_two, device="cpu")
    assert res.preempted and res.history["epoch"] == [0, 1]


def test_trainer_resume_requires_ckpt_dir(pipeline):
    mc, pc = _cfgs(pipeline)
    with pytest.raises(ValueError, match="ckpt_dir"):
        train_pipegcn(pipeline, mc, pc, epochs=1, resume=True, device="cpu")


def test_trainer_resume_empty_dir_starts_fresh(tmp_path, pipeline):
    mc, pc = _cfgs(pipeline)
    res = train_pipegcn(pipeline, mc, pc, epochs=2, eval_every=1,
                        device="cpu", ckpt_dir=str(tmp_path / "empty"),
                        resume=True)
    assert res.resumed_from is None and res.history["epoch"] == [0, 1]


def test_jax_checkpoint_resumes_in_the_port(tmp_path, pipeline):
    """The JAX trainer (f32, dropout 0, guard on) checkpoints at epoch 3;
    the port restores it with every leaf but `key` bitwise equal to the
    stored arrays, and its 3 resumed epochs end within 1e-5 relative norm
    per parameter of the JAX trainer's own resumed run."""
    ds = pipeline.dataset
    cfg = dict(kind="sage", feat_dim=ds.feat_dim, hidden=16, num_layers=3,
               num_classes=ds.num_classes, dropout=0.0)
    jpipe = JPipeline.build("tiny", P, seed=0)
    jmc, jpc = JModelConfig(**cfg), JPipeConfig(guard_exchange=True)
    mc, pc = ModelConfig(**cfg), PipeConfig(guard_exchange=True)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrain(jpipe, jmc, jpc, epochs=3, eval_every=3, ckpt_dir=jdir,
           checkpoint_every=3)
    shutil.copytree(jdir, tdir)
    man = read_manifest(tdir, 3)
    key = next(r for r in man["leaves"] if r["path"] == "['key']")
    assert (key["dtype"], key["shape"]) == ("uint32", [2])
    stored = np.load(os.path.join(tdir, "step_00000003", "arrays.npz"))
    model = PipeGCN(mc, pc)
    params = model.init_params(torch.Generator().manual_seed(0))
    got = restore_checkpoint(tdir, 3, {
        "params": params, "opt_state": adam(0.01).init(params),
        "buffers": model.init_buffers(pipeline.topo),
        "key": np.zeros(2, np.uint32), "epoch": 0})
    from repro_torch.checkpoint.checkpoint import _flatten
    flat = _flatten(got)
    assert [p for p, _ in flat] == [r["path"] for r in man["leaves"]]
    for i, (path, leaf) in enumerate(flat):
        want = stored[f"leaf_{i}"]
        have = (leaf.numpy() if isinstance(leaf, torch.Tensor) else
                np.asarray(leaf, want.dtype if isinstance(leaf, int)
                           else None))
        assert have.dtype == want.dtype and np.array_equal(have, want), path
    jres = jtrain(jpipe, jmc, jpc, epochs=6, eval_every=6, ckpt_dir=jdir,
                  resume=True)
    tres = train_pipegcn(pipeline, mc, pc, epochs=6, eval_every=6,
                         device="cpu", ckpt_dir=tdir, resume=True)
    assert jres.resumed_from == tres.resumed_from == 3
    for k, v in tres.params.items():
        want = np.asarray(jres.params[k])
        rel = np.linalg.norm(v.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (k, rel)
