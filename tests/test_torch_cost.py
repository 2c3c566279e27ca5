"""The port's LM cost model (``analysis/cost.py`` `analytic_cost`) against
the JAX package's: for the ten full architectures at the four
INPUT_SHAPES, params_total exactly and the two float counts within 1e-12
relative; the port's parameter count (drawn on the ``meta`` device) equals
the leaf sizes of its own ``init_params`` on the reduced configs."""
import jax
import pytest
import torch
from torch.utils._pytree import tree_leaves

import _torch_threads  # noqa: F401

jax.config.update("jax_enable_x64", True)

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import cost as jcost  # noqa: E402
from repro.models.config import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import analytic_cost, param_count  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_analytic_cost_equals_jax(arch):
    assert list(INPUT_SHAPES) == list(JSHAPES)
    cfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        got = analytic_cost(cfg, shape)
        want = jcost.analytic_cost(jcfg, JSHAPES[name])
        assert set(got) == set(want) == {"flops_global", "hbm_bytes_global",
                                         "params_total"}
        assert got["params_total"] == want["params_total"], name
        assert isinstance(got["params_total"], int)
        for k in ("flops_global", "hbm_bytes_global"):
            assert isinstance(got[k], float)
            assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), (name, k)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_count_equals_init_params_leaves(arch):
    cfg = configs.get_arch(arch).reduced()
    params = LM(cfg).init_params(torch.Generator().manual_seed(0))
    assert param_count(cfg) == sum(x.numel() for x in tree_leaves(params))
