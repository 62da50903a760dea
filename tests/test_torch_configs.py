"""The port's own copy of the arch configs equals the reference's, field by
field, for every arch and its ``reduced()`` form."""

from __future__ import annotations

import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro_torch import configs as tconfigs
from repro_torch.configs.base import reduced as treduced


def test_same_arch_list():
    assert tconfigs.ARCHS == jconfigs.ARCHS


@pytest.mark.parametrize("name", jconfigs.ARCHS)
def test_arch_equal_field_by_field(name):
    mine, ref = tconfigs.get(name), jconfigs.get(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(treduced(mine))
            == dataclasses.asdict(jreduced(ref)))
    for method in ("param_count", "active_param_count",
                   "supports_long_context", "is_moe", "is_enc_dec"):
        a, b = getattr(mine, method), getattr(ref, method)
        assert (a() if callable(a) else a) == (b() if callable(b) else b)


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")
