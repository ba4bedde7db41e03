"""The port's placements against the JAX package's, leaf for leaf, for
all eleven archs with and without ``+xnor``: the logical spec every
``ParamDef`` carries, and the mesh placement under the default rules and
under the ``fsdp_pods`` rule (fsdp over ``("pod", "data")``, the
dry-run's ``--fsdp-pods``).  A ``PartitionSpec`` is a tuple, and so is
the port's placement: they compare as tuples.  Then the production
meshes over a recording process group."""

import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import pytest

import repro.configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.models import bcnn as jbcnn  # noqa: F401 (registers bindense)
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.train import train_step as jtrain
import repro_torch.configs as configs
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.models import params as pdefs
from repro_torch.train import train_step as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(configs.ALL)
FSDP_PODS = dict(sharding.DEFAULT_RULES, fsdp=("pod", "data"))


def _flat(tree, prefix: str = "") -> dict:
    """Leaves of nested dicts by "a/b" key (a placement is a leaf)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key in sorted(tree)
            for k, v in _flat(tree[key], f"{prefix}/{key}".lstrip("/"))
            .items()}


def _jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (tuple, jparams.ParamDef)))[0]
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in leaves}


def test_default_rules_are_the_references():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


@pytest.mark.parametrize("xnor", [False, True], ids=["float", "xnor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_references(arch, xnor):
    name = arch + ("+xnor" if xnor else "")
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    defs, jdefs = lm.param_defs(cfg), jlm.param_defs(jcfg)
    got = _flat(pdefs.logical_specs(defs))
    want = _jflat(jparams.logical_specs(jdefs))
    assert got == want
    assert all(len(s) == len(d.shape) for s, d in
               zip(got.values(), _flat(defs).values()))
    for rules in (sharding.DEFAULT_RULES, FSDP_PODS):
        got = _flat(lm.param_pspecs(cfg, rules))
        want = {k: tuple(v) for k, v in
                _jflat(jlm.param_pspecs(jcfg, rules)).items()}
        assert got == want, rules


def test_state_pspecs_mirror_the_references():
    """The moments take the parameters' placement and the step counter is
    whole, as in the reference's ``TrainState`` of specs.  The port's
    are head-aligned: a dim of heads is a ``sharding.Heads`` entry over
    the reference's axis (whole heads a rank), every other entry the
    reference's."""
    cfg = configs.get("moonshot-v1-16b-a3b+xnor")
    jcfg = jconfigs.get("moonshot-v1-16b-a3b+xnor")
    got = ttrain.state_pspecs(cfg, FSDP_PODS)
    want = jtrain.state_pspecs(jcfg, FSDP_PODS)
    assert got.opt.step == tuple(want.opt.step) == ()

    def axes(spec):
        return tuple(e.axes if isinstance(e, sharding.Heads) else e
                     for e in spec)
    heads = 0
    for g, w in ((got.params, want.params), (got.opt.m, want.opt.m),
                 (got.opt.v, want.opt.v)):
        g = _flat(g)
        assert {k: axes(v) for k, v in g.items()} == \
            {k: tuple(v) for k, v in _jflat(w).items()}
        heads += sum(isinstance(e, sharding.Heads) for v in g.values()
                     for e in v)
    assert heads == 3 * 4      # wq, wk, wv, wo of the moe layers


def test_production_meshes_over_a_recording_group():
    """The reference's production meshes, (16, 16) over (data, model) and
    (2, 16, 16) over (pod, data, model), built over torch's ``fake``
    process group, which stands in for 256 and 512 ranks without
    sending: the shapes, this rank's coordinates, the batch axes and the
    groups over several axes that the sharded step takes."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed import sharding
        from repro_torch.launch import mesh as mesh_mod
        for multi, n, want in ((False, 256, (16, 16)),
                               (True, 512, (2, 16, 16))):
            dist.init_process_group("fake", rank=37, world_size=n,
                                    store=FakeStore())
            m = mesh_mod.make_production_mesh(multi_pod=multi, device="cpu")
            assert tuple(m.mesh.shape) == want, m.mesh.shape
            names = ("pod", "data", "model") if multi else ("data", "model")
            assert m.mesh_dim_names == names
            assert tuple(m.get_coordinate()) == (
                (0, 2, 5) if multi else (2, 5))
            ba = ("pod", "data") if multi else "data"
            assert sharding.batch_axes(m, 64) == ba
            assert sharding.batch_axes(m, 2) == ("pod" if multi else None)
            g = sharding.axis_group(m, ba)
            assert dist.get_world_size(g) == (32 if multi else 16)
            assert sharding.copies((None, "data", "model"), m) == (
                2 if multi else 1)
            dist.destroy_process_group()
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
