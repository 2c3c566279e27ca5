"""Activation-sharding rules, injected contextually.

Port of the JAX package's ``models/shardctx.py``. There, explicit rules
(residual stream data-sharded, logits vocab-sharded) are applied by the
``constrain()`` calls inside the model; rules default to None, and every
single-device run leaves them so. The port runs on one device and has no
counterpart of the rules yet (ROADMAP Queue 1 item 12, the sharding-rules
bullet): ``constrain`` returns its input unchanged, and installing rules
raises rather than ignoring them.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def sharding_rules(rules: dict | None):
    """Install activation-sharding rules for the enclosed calls. Only None
    (no rules, the default) is accepted."""
    if rules is not None:
        raise NotImplementedError(
            "activation-sharding rules are not ported (ROADMAP Queue 1 item "
            "12, the sharding-rules bullet); the port runs on one device")
    yield


def constrain(x, name: str):
    """The activation `x` under the rule `name`: with no rules installed,
    `x` itself."""
    return x
