"""Split-phase parity cells 12-16 of 16 (tests/test_torch_overlap.py has
the first six and describes them): the port's split step bitwise equal to
its unsplit step and within 1e-12 of the JAX package's split step, on
grid-tiny in float64. The setup and the cell body are shared
(tests/_torch_overlap_cells.py); this file lets pytest-xdist's `loadfile`
run its cells on another worker.
"""
import pytest

from _torch_overlap_cells import CELLS, build_setups, cell_ids, run_cell

MINE = CELLS[11:]


@pytest.fixture(scope="module")
def setups():
    return build_setups()


@pytest.mark.parametrize("kind,variant,agg,order,pipe_kw,dropout", MINE,
                         ids=cell_ids(MINE))
def test_split_equals_unsplit_and_jax(setups, kind, variant, agg, order,
                                      pipe_kw, dropout):
    run_cell(setups, kind, variant, agg, order, pipe_kw, dropout)
