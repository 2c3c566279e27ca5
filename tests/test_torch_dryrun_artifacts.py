"""The JAX package's gates on its dry-run artifacts (tests/
test_dryrun_artifacts.py, which reads rows that the JAX dry-run wrote to
``results/``), held on the port's rows, which this file and the dry-run
tests build themselves (no file is read).

- `check_rows` (``repro_torch.launch.dryrun``): the gates, as chip_smoke
  phase "dryrun" and the card tests apply them to whole sweeps; here they
  must reject each kind of bad row. The dry-run tests that produce rows
  (tests/test_torch_dryrun.py's CLI test, test_torch_dryrun_moe.py,
  test_torch_dryrun_args.py) hold them to `check_row` and to
  ``bytes_per_device >= argument_size_in_bytes > 0``.
- `check_against_jax` (tests/_dryrun_jax_rows.py), which holds the port's
  rows to JAX's: it must reject each kind of bad row.
- The roofline gates on all 40 combos of each mesh, from the analytic
  terms alone (`_roofline` with the collective term at 0, so that
  "decode is not compute-bound" is the stronger check): in train the
  model-FLOPs ratio lies in (0.2, 1.3), and no decode combo is
  compute-bound.
"""
import copy

import pytest

import _torch_threads  # noqa: F401
from _dryrun_jax_rows import (ARGUMENT_BYTES, COLLECTIVE_BYTES, F5, FACTOR,
                              check_against_jax, moe_output_reduction)
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.dryrun import (BOTTLENECKS, _roofline, check_row,
                                       check_rows, variant_for)
from repro_torch.models.config import INPUT_SHAPES


def _rows(chips: int) -> list:
    """A mesh's 40 rows with the roofline terms and the run's keys (the
    collectives at 0), as the CLI would write them."""
    rows = []
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            cfg, _ = variant_for(get_arch(arch), name)
            rows.append(dict(_roofline(cfg, shape, chips, 0), arch=arch,
                             shape=name, mode=shape.mode, chips=chips,
                             run_s=0.5, collective_bytes_per_device={}))
    return rows


@pytest.mark.parametrize("chips", [256, 512])
def test_roofline_gates_on_all_combos(chips):
    rows = _rows(chips)
    check_rows(rows, chips)
    for r in rows:
        assert r["t_collective"] == 0 and r["bottleneck"] in BOTTLENECKS
        if r["mode"] == "decode":
            assert r["t_memory"] > r["t_compute"], (r["arch"], r["shape"])


def test_check_rows_rejects_each_bad_row():
    rows = _rows(256)
    gcn = {"arch": "pipegcn-pipegcn", "chips": 256, "t_compute": 1e-3,
           "t_memory": 1e-3, "bottleneck": "collective",
           "collective_bytes_per_device": {"all-to-all": 4096}}
    check_rows(rows + [gcn], 256)
    for r in rows[:3] + [gcn]:
        check_row(r, 256)

    def bad(i, **change):
        got = copy.deepcopy(rows)
        got[i].update(change)
        return got
    train = next(i for i, r in enumerate(rows) if r["mode"] == "train")
    decode = next(i for i, r in enumerate(rows) if r["mode"] == "decode")
    for got in (rows[:-1], rows + rows[:1], bad(0, error="boom"),
                bad(0, chips=512), bad(0, run_s=0.0), bad(0, t_memory=0.0),
                bad(0, t_compute=-1.0), bad(0, bottleneck="network"),
                bad(train, model_flops_ratio=1.3),
                bad(train, model_flops_ratio=0.2),
                bad(decode, bottleneck="compute"),
                rows + [dict(gcn, collective_bytes_per_device={
                    "all-to-all": 0})]):
        with pytest.raises(AssertionError):
            check_rows(got, 256)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_check_against_jax_rejects_each_bad_row(mesh):
    rows = []
    for (arch, shape), args in ARGUMENT_BYTES[mesh].items():
        layers, floor = moe_output_reduction(arch, shape, mesh)
        total = COLLECTIVE_BYTES[mesh][(arch, shape)]
        rows.append(dict(
            arch=arch, shape=shape, argument_size_in_bytes=args - 4,
            collective_total_bytes=total,
            collective_counts_per_device={"all-reduce": layers,
                                          "all-gather": 1},
            collective_bytes_per_device={"all-reduce": floor,
                                         "all-gather": total - floor}))
    got = check_against_jax(rows, mesh)
    assert len(got) == 40 and all(d == 4 for d, _ in got.values())
    moe = next(i for i, r in enumerate(rows)
               if (r["arch"], r["shape"], mesh) in F5)
    dense = next(i for i, r in enumerate(rows)
                 if moe_output_reduction(r["arch"], r["shape"], mesh)[0] == 0)

    def bad(i, **change):
        got = copy.deepcopy(rows)
        for key, value in change.items():
            if isinstance(value, dict):
                got[i][key].update(value)
            else:
                got[i][key] = value
        return got
    f5 = rows[moe]
    for got in (bad(dense, collective_total_bytes=0,
                    collective_bytes_per_device={"all-reduce": 0,
                                                 "all-gather": 0}),
                bad(dense, collective_total_bytes=rows[dense][
                    "collective_total_bytes"] + 1),
                bad(dense, argument_size_in_bytes=rows[dense][
                    "argument_size_in_bytes"] - 1),
                bad(dense, argument_size_in_bytes=rows[dense][
                    "argument_size_in_bytes"] + 5),
                bad(moe, collective_counts_per_device={
                    "all-reduce": f5["collective_counts_per_device"][
                        "all-reduce"] - 1}),
                bad(moe, collective_bytes_per_device={
                    "all-reduce": f5["collective_bytes_per_device"][
                        "all-reduce"] - 1, "all-gather": f5[
                        "collective_bytes_per_device"]["all-gather"] + 1}),
                bad(moe, collective_total_bytes=FACTOR * f5[
                    "collective_total_bytes"] + 1,
                    collective_bytes_per_device={"all-gather": FACTOR * f5[
                        "collective_total_bytes"] + 1 - f5[
                        "collective_bytes_per_device"]["all-reduce"]})):
        with pytest.raises(AssertionError):
            check_against_jax(got, mesh)
