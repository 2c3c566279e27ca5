"""The dry-run's sharded programs against the single-device port on a
real 4-rank gloo world, in float64 throughout.

The steps of tests/test_torch_dryrun_gloo.py (reduced qwen3-8b with one
kv head, granite-moe, mamba2-780m, whisper-large-v3, and deepseek-v2 cut
to one layer of MLA and MoE; the train step's loss, every gradient leaf
and one Adam update; one decode step's logits and every cache leaf), with
the model's f32 casts lifted to float64 on both sides
(``_dryrun_gloo.lift_f32``): the sharded and the single-device program
then differ only in the order of their sums, and every quantity agrees at
1e-10 relative, the MoE combine's partial sums over 'model'
(``shardctx.take``) and deepseek's latent cache sharded on its length
(``shardctx.local_einsum``) included.
"""
import _torch_threads  # noqa: F401
import _dryrun_gloo

BAR = 1e-10


def test_sharded_steps_equal_single_device_f64(tmp_path):
    errs = _dryrun_gloo.run(_dryrun_gloo.ARCHS, [0], "lift",
                            str(tmp_path / "errs.pt"))
    assert len(errs) == (len(_dryrun_gloo.QUANTITIES)
                         * len(_dryrun_gloo.ARCHS) + 1)
    bad = {k: v for k, v in errs.items() if not v[0] <= BAR}
    assert not bad, (bad, errs)
