"""The dry-run driver (``python -m repro_torch.launch.dryrun``): the cells'
inputs against the reference's ``ShapeDtypeStruct``s, the driver itself
on the production meshes over torch's ``fake`` process group, and two
cells held to what the card read.

The driver runs in subprocesses (a process group is per process) and
writes into ``tmp_path``, never into the repo.  Phase 10b of
``chip_smoke.py`` (qwen2-7b+xnor at full width and 8 layers, batch 4 x
256, 2 ranks on ``data``) read 17,497,901,060 bytes of train state a rank
on the card (PERF.md, PR 23); the dry-run of that cell must give exactly
those bytes."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import pytest

import repro.configs as jconfigs
from repro.launch import dryrun as jdryrun
import repro_torch.configs as configs
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.mark.parametrize("arch", sorted(configs.ALL))
def test_input_specs_equal_the_references(arch):
    for name, shape in configs.SHAPES.items():
        for variant in (arch, arch + "+xnor"):
            got = dryrun.input_specs(configs.get(variant), shape)
            want = jdryrun.input_specs(jconfigs.get(variant),
                                       jconfigs.SHAPES[name])
            assert sorted(got) == sorted(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (name, k)
                assert str(t.dtype).removeprefix("torch.") == \
                    str(jnp.dtype(want[k].dtype))
            for unroll in (False, True):
                assert dryrun.default_q_chunk(configs.get(variant), shape,
                                              unroll) == \
                    jdryrun.default_q_chunk(jconfigs.get(variant),
                                            jconfigs.SHAPES[name], unroll)


def _driver(out: Path, *args) -> list:
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--out", str(out), *args], capture_output=True,
                       text=True, env=ENV, timeout=600, cwd=out)
    return r


def test_driver_decode_cell_on_two_pods(tmp_path):
    """The reference's ``test_dryrun_cell_end_to_end_small``: the cheapest
    cell over 512 ranks."""
    r = _driver(tmp_path, "--arch", "whisper-tiny", "--shape", "decode_32k",
                "--mesh", "multi", "--tag", "unittest")
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads((tmp_path / "whisper-tiny_decode_32k_multi_unittest"
                      ".json").read_text())
    assert res["status"] == "ok"
    assert res["n_devices"] == 512
    assert res["memory_analysis"]["peak_bytes"] < analysis.CARD_BYTES
    assert res["fits_card"] is True
    # one rank's program: every leaf gathered whole, once, at the start
    assert res["collectives"]["all-gather"]["count"] > 0
    assert res["dispatches"] > 0 and res["bottleneck"] in (
        "compute", "memory", "collective")
    assert list((tmp_path).glob("*.json")) == [
        tmp_path / "whisper-tiny_decode_32k_multi_unittest.json"]


def test_driver_train_cell_on_one_pod(tmp_path):
    r = _driver(tmp_path, "--arch", "qwen2-7b+xnor", "--shape", "train_4k")
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads((tmp_path / "qwen2-7b+xnor_train_4k_single.json")
                     .read_text())
    assert res["status"] == "ok" and res["n_devices"] == 256
    cfg = configs.get("qwen2-7b+xnor")
    from repro_torch.models import lm
    assert res["model_flops_per_chip"] == pytest.approx(
        lm.model_flops(cfg, "train", 256 * 4096) / 256)
    # the sharded step's whole-tree gathers and whole gradients (S13)
    assert res["fits_card"] is (res["memory_analysis"]["peak_bytes"]
                                <= analysis.CARD_BYTES)
    assert set(res["collectives"]) == {"all-gather", "all-reduce"}


def test_microbatch_on_a_mesh_is_an_error_with_its_reason(tmp_path):
    r = _driver(tmp_path, "--arch", "whisper-tiny", "--shape", "train_4k",
                "--microbatch", "2")
    assert r.returncode == 1
    res = json.loads((tmp_path / "whisper-tiny_train_4k_single.json")
                     .read_text())
    assert res["status"] == "error"
    assert "microbatch > 1 is not ported to the sharded step" in \
        res["error"]


def test_phase_10b_cell_state_bytes_equal_the_cards_reading():
    code = textwrap.dedent("""
        import dataclasses, json
        import repro_torch.configs as configs
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun, mesh as mesh_mod
        cfg = dataclasses.replace(configs.get("qwen2-7b+xnor"), n_layers=8)
        with dryrun.fake_group(2):
            mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), "cpu")
            r = dryrun.trace_cell(cfg, ShapeConfig("10b", "train", 256, 4),
                                  mesh)
        print(json.dumps(r))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["state_bytes"] == 17_497_901_060
    assert r["n_devices"] == 2
    # 10b's reading: 2.41 GB gathered and 5.91 GB reduced a rank a step
    # (host counters, PR 23); the ring factor of 2 ranks is 1/2 of the
    # gathered result and 1 of the reduced one
    assert r["collectives"]["all-gather"]["bytes"] == pytest.approx(
        2.409e9, rel=1e-3)
    assert r["collectives"]["all-reduce"]["bytes"] == pytest.approx(
        5.909e9, rel=1e-3)
