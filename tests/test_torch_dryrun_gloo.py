"""The dry-run's sharded programs against the single-device port, on a
real 4-rank gloo world (float64, CPU), with the model as it runs.

Four ranks on a (2, 2) ("data", "model") mesh run reduced qwen3-8b (with
one kv head, fewer than the 'model' shards, as at production scale),
granite-moe, mamba2-780m, whisper-large-v3 and deepseek-v2 (one layer of
MLA and MoE) through the dry-run's train step and one decode step
(tests/_dryrun_gloo.py); the MoE archs' experts are sharded over 'model',
so their combine runs as partial sums there (``shardctx.take``). The port keeps
JAX's f32 casts inside a float64 model (the norms, RoPE's angles, the
attention softmax, the MoE router, the SSD state), and a sharded program
sums a value that feeds one of them in another order than one device
does (partial sums per rank, then the reduction), so here the loss,
every gradient leaf, the logits and every cache leaf agree to f32
rounding (REL), and the sharded Adam update equals the single-device
update of the same gradients at 1e-10. tests/test_torch_dryrun_gloo_f64.py
holds the same steps to 1e-10 with those casts lifted to float64. (The
single-device port is held to JAX at 1e-5 by tests/test_torch_lm*.py.)
"""
import _torch_threads  # noqa: F401
import _dryrun_gloo

REL = 2e-6


def test_sharded_steps_equal_single_device(tmp_path):
    errs = _dryrun_gloo.run(_dryrun_gloo.ARCHS, [0], "keep",
                            str(tmp_path / "errs.pt"))
    assert len(errs) == (len(_dryrun_gloo.QUANTITIES)
                         * len(_dryrun_gloo.ARCHS) + 1)
    bad = {k: v for k, v in errs.items()
           if not v[0] <= (1e-10 if k.endswith("/adam") else REL)}
    assert not bad, (bad, errs)
