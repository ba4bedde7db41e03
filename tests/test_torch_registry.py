"""The port's block registry helpers against the reference's:
``unregister``, ``temporary``, ``kinds``, ``items`` and ``view``, and the
eleven archs' kinds all registered with the reference's contracts."""

import dataclasses

import pytest

from repro.models import bcnn as jbcnn  # noqa: F401  (registers bindense)
from repro.models import registry as jregistry
import repro_torch.configs as configs
from repro_torch.models import blocks, registry
from repro_torch.models.registry import BlockContract


def test_kinds_are_the_references():
    """Every kind the reference registers, sorted, and nothing else."""
    assert registry.kinds() == jregistry.kinds() == [
        "attn", "bindense", "cross", "dec", "enc", "local", "mlstm", "moe",
        "rglru", "slstm"]
    assert [k for k, _ in registry.items()] == registry.kinds()
    assert all(registry.get(k) is cls for k, cls in registry.items())
    used = {k for cfg in configs.ALL.values()
            for k, _ in cfg.segments() + cfg.encoder_segments()}
    assert used == set(registry.kinds())


def test_view_is_the_live_table():
    view = registry.view()
    assert view is registry.view() and sorted(view) == registry.kinds()
    assert view["mlstm"] is blocks.MlstmBlock


class _Probe(blocks.PagedLayout):
    contract = BlockContract("probe-kind", per_slot_state=True)

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        return None


def test_temporary_registers_for_the_with_block_only():
    before = registry.kinds()
    with registry.temporary(_Probe) as cls:
        assert cls is _Probe and registry.get("probe-kind") is _Probe
        assert "probe-kind" in registry.view()
        assert registry.contract("probe-kind").per_slot_state
        with pytest.raises(ValueError, match="already registered"):
            registry.register(_Probe)
    assert registry.kinds() == before
    with pytest.raises(KeyError, match="probe-kind"):
        registry.get("probe-kind")


def test_temporary_unregisters_on_error():
    with pytest.raises(RuntimeError):
        with registry.temporary(_Probe):
            raise RuntimeError("inside")
    assert "probe-kind" not in registry.view()


def test_unregister_is_quiet_for_unknown_kinds():
    registry.register(_Probe)
    registry.unregister("probe-kind")
    registry.unregister("probe-kind")
    registry.unregister("never-registered")
    assert "probe-kind" not in registry.kinds()


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "bindense"])
def test_new_kinds_contracts_are_the_references(kind):
    """The reference's fields, plus ``decode_writes_slot``: True for the
    xLSTM kinds (decode writes their memory), False for ``bindense``
    (decode only reads its gate, so the step copies nothing for it)."""
    t, j = registry.contract(kind), jregistry.contract(kind)
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), (kind, f.name)
    assert t.decode_writes_slot == (kind != "bindense")
