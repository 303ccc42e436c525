"""The port's top-level lazy exports match the reference's: every name in
``repro._LAZY`` resolves on ``repro_torch`` to the port's own object of
the same module path (``repro.reduce.plan`` -> ``repro_torch.reduce.plan``).
"""

import importlib

import pytest

import repro
import repro_torch


@pytest.mark.parametrize("name", sorted(repro._LAZY))
def test_reference_lazy_export_resolves_on_the_port(name):
    module, attr = repro._LAZY[name]
    assert module.split(".")[0] == "repro"
    port_module = importlib.import_module("repro_torch" + module[len("repro"):])
    assert getattr(repro_torch, name) is getattr(port_module, attr)
    assert name in dir(repro_torch)


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'no_such_name'"):
        repro_torch.no_such_name  # noqa: B018
