"""The port's restartable ``Runner`` on the CPU: the JAX package's Runner
tests (``tests/test_fault.py``) on the port, and a training run that
crosses packages at a checkpoint.

The crossing: 20 straight reference steps (qwen2-7b smoke, batch 8 x
32, the reference integration test's run, in f32) against 10 steps in
one package, a ``Runner`` checkpoint (encrypted), a resume in the other
package and its steps to 20.  The two runs must agree at the reference
test's own tolerances: params rtol 2e-2 / atol 2e-3 and the last loss
within 2e-2 (``RESTART_TOL``, ``LOSS_TOL``).  Not in bf16: there the two
packages' backward passes round apart (up to 1.5 % of a leaf's largest
gradient, ``test_torch_train.py``), and the key bias ``attn_bk``, whose
gradient the softmax nearly cancels, follows that noise: AdamW moves 6
of its 32 elements the other way within 10 steps.  A ``TrainState``'s
leaf keys (``.params/...``, ``.opt/.m/...``) and bytes are the same in
both packages, so either restores the other's checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.data import synthetic as jsynthetic
from repro.distributed import fault as jfault
from repro.train import train_step as jtrain
import repro_torch.configs as configs
from repro_torch.checkpoint import ckpt
from repro_torch.core import verify
from repro_torch.data import synthetic
from repro_torch.distributed.fault import Runner, StragglerPolicy
from repro_torch.train import train_step as ttrain

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:overflow:RuntimeWarning")

RESTART_TOL = dict(rtol=2e-2, atol=2e-3)
LOSS_TOL = 2e-2
SCHEDULE = dict(peak_lr=3e-3, warmup=10)
KEY = "train-root-key"


def _state(v: float):
    return {"w": np.full((4,), v, np.float32),
            "b": np.arange(3, dtype=np.int32)}


def _like():
    return {"w": torch.empty((4,), dtype=torch.float32, device="meta"),
            "b": torch.empty((3,), dtype=torch.int32, device="meta")}


def _runner(path, **kw):
    return Runner(str(path), device="cpu", **kw)


def _w(state):
    w = state["w"]
    return w.numpy() if isinstance(w, torch.Tensor) else w


def test_runner_init_when_empty(tmp_path):
    r = _runner(tmp_path / "ckpt")
    state, step = r.resume_or_init(_like(), lambda: _state(7.0))
    assert step == 0
    np.testing.assert_array_equal(_w(state), _state(7.0)["w"])


def test_runner_maybe_save_cadence(tmp_path):
    r = _runner(tmp_path, save_every=10)
    saved = [s for s in range(1, 35) if r.maybe_save(s, _state(float(s)))]
    assert saved == [10, 20, 30]
    assert r._steps() == [10, 20, 30]


def test_runner_resumes_latest(tmp_path):
    r = _runner(tmp_path, save_every=10)
    for s in (10, 20, 30):
        r.maybe_save(s, _state(float(s)))
    state, step = r.resume_or_init(_like(), lambda: _state(0.0))
    assert step == 30
    np.testing.assert_array_equal(_w(state), _state(30.0)["w"])
    assert state["b"].dtype == torch.int32


def test_runner_falls_back_past_corrupt_checkpoint(tmp_path):
    r = _runner(tmp_path, save_every=10)
    for s in (10, 20):
        r.maybe_save(s, _state(float(s)))
    (tmp_path / "ckpt_00000020.npz").write_bytes(b"garbage")
    state, step = r.resume_or_init(_like(), lambda: _state(0.0))
    assert step == 10
    np.testing.assert_array_equal(_w(state), _state(10.0)["w"])
    assert [s for s, _ in r.fallbacks] == [20]


def test_runner_falls_back_past_truncated_checkpoint(tmp_path):
    """A checkpoint cut short mid-write (the first half of its bytes)."""
    r = _runner(tmp_path, save_every=10)
    for s in (10, 20):
        r.maybe_save(s, _state(float(s)))
    npz = tmp_path / "ckpt_00000020.npz"
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])
    state, step = r.resume_or_init(_like(), lambda: _state(0.0))
    assert step == 10
    np.testing.assert_array_equal(_w(state), _state(10.0)["w"])


def test_runner_falls_back_to_init_when_all_corrupt(tmp_path):
    r = _runner(tmp_path, save_every=10)
    r.maybe_save(10, _state(10.0))
    (tmp_path / "ckpt_00000010.npz").write_bytes(b"garbage")
    state, step = r.resume_or_init(_like(), lambda: _state(-1.0))
    assert step == 0
    np.testing.assert_array_equal(_w(state), _state(-1.0)["w"])


def test_runner_gc_keeps_last_k(tmp_path):
    r = _runner(tmp_path, save_every=1, keep_last=3)
    for s in range(1, 8):
        r.maybe_save(s, _state(float(s)))
    assert r._steps() == [5, 6, 7]
    manifests = sorted(f.name for f in tmp_path.glob("manifest_*.msgpack"))
    assert manifests == [f"manifest_{s:08d}.msgpack" for s in (5, 6, 7)]
    state, step = ckpt.restore(str(tmp_path), None, _like(), device="cpu")
    assert step == 7


def test_runner_encrypted_roundtrip(tmp_path):
    r = _runner(tmp_path, save_every=1, root_key="runner-key")
    r.maybe_save(1, _state(3.0))
    state, step = r.resume_or_init(_like(), lambda: _state(0.0))
    assert step == 1
    np.testing.assert_array_equal(_w(state), _state(3.0)["w"])
    # wrong key: decrypt garbage fails parity -> falls back to init
    r2 = _runner(tmp_path, save_every=1, root_key="wrong-key")
    state, step = r2.resume_or_init(_like(), lambda: _state(-2.0))
    assert step == 0
    np.testing.assert_array_equal(_w(state), _state(-2.0)["w"])


def test_runner_observe_step_delegates_to_policy(tmp_path):
    r = _runner(tmp_path, policy=StragglerPolicy(straggler_factor=2.0))
    for s in range(6):
        assert r.observe_step(s, 0.01) == "ok"
    assert r.observe_step(6, 0.1) == "straggler"


def test_runners_read_each_others_checkpoints(tmp_path):
    """The port's Runner resumes the reference's, and the other way."""
    jr = jfault.Runner(str(tmp_path / "a"), save_every=5, root_key=KEY)
    jr.maybe_save(5, _state(5.0))
    state, step = _runner(tmp_path / "a", root_key=KEY).resume_or_init(
        _like(), lambda: _state(0.0))
    assert step == 5
    np.testing.assert_array_equal(_w(state), _state(5.0)["w"])
    _runner(tmp_path / "b", save_every=5, root_key=KEY).maybe_save(
        5, {k: torch.from_numpy(v) for k, v in _state(6.0).items()})
    jlike = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype),
                         _state(0.0))
    state, step = jfault.Runner(str(tmp_path / "b"), root_key=KEY) \
        .resume_or_init(jlike, lambda: _state(0.0))
    assert step == 5
    np.testing.assert_array_equal(np.asarray(state["w"]), _state(6.0)["w"])


# ---------------------------------------------------------------------------
# a training run across packages
# ---------------------------------------------------------------------------

def _jrun(jcfg, steps, state=None, start=0):
    pipe = jsynthetic.Pipeline(jcfg, batch_size=8, seq_len=32, seed=0)
    if state is None:
        state = jtrain.init_state(jcfg, jax.random.PRNGKey(0))
    fn = jax.jit(lambda s, b, t: jtrain.train_step(
        jcfg, s, b, t, total=steps, **SCHEDULE))
    losses = []
    for step in range(start, steps):
        state, m = fn(state, jax.tree.map(jnp.asarray, pipe.get(step)),
                      jnp.asarray(step, jnp.int32))
        losses.append(float(m["loss"]))
    return state, losses


def _trun(cfg, steps, state, start):
    pipe = synthetic.Pipeline(cfg, batch_size=8, seq_len=32, seed=0)
    losses = []
    for step in range(start, steps):
        state, m = ttrain.train_step(
            cfg, state, synthetic.to_device(pipe.get(step), "cpu"), step,
            total=steps, **SCHEDULE)
        losses.append(float(m["loss"]))
    return state, losses


def _cfgs():
    return (jconfigs.get("qwen2-7b").smoke(dtype=jnp.float32),
            configs.get("qwen2-7b").smoke(dtype=torch.float32))


@pytest.fixture(scope="module")
def straight():
    return _jrun(_cfgs()[0], 20)


def _hold_run(want_state, want_losses, params, losses):
    got = [leaf for _, leaf in verify.tree_flatten_with_path(params)]
    want = jax.tree.leaves(want_state.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w,
                                   np.float32), **RESTART_TOL)
    assert abs(want_losses[-1] - losses[-1]) < LOSS_TOL


def test_port_resumes_reference_training_checkpoint(tmp_path, straight):
    """Reference steps 0-9, its Runner's encrypted save at step 10; the
    port's Runner resumes and takes steps 10-19."""
    jcfg, cfg = _cfgs()
    half, _ = _jrun(jcfg, 10)
    jr = jfault.Runner(str(tmp_path), save_every=10, root_key=KEY)
    assert jr.maybe_save(10, half)
    r = _runner(tmp_path, save_every=10, root_key=KEY)
    state, step = r.resume_or_init(ttrain.abstract_state(cfg),
                                   lambda: pytest.fail("no checkpoint"))
    assert step == 10 and not r.fallbacks
    assert int(state.opt.step) == 10
    assert state.params["embed"]["tokens"].dtype == cfg.dtype
    state, losses = _trun(cfg, 20, state, 10)
    _hold_run(straight[0], straight[1], state.params, losses)


def test_reference_resumes_port_training_checkpoint(tmp_path, straight):
    """The other way: reference steps 0-9 carried into the port, the
    port's Runner saves at step 10, the reference's Runner resumes."""
    jcfg, cfg = _cfgs()
    half, _ = _jrun(jcfg, 10)
    r = _runner(tmp_path, save_every=4, root_key=KEY)
    like = ttrain.abstract_state(cfg)
    # the reference's state, read through the port's checkpoint reader
    jckpt.save(str(tmp_path / "carry"), 10, half)
    carried, _ = ckpt.restore(str(tmp_path / "carry"), 10, like,
                              device="cpu")
    state, _ = _trun(cfg, 12, carried, 10)      # two port steps
    assert r.maybe_save(12, state)
    jlike = jtrain.abstract_state(jcfg)
    resumed, step = jfault.Runner(str(tmp_path), root_key=KEY) \
        .resume_or_init(jlike, lambda: pytest.fail("no checkpoint"))
    assert step == 12
    resumed, losses = _jrun(jcfg, 20, resumed, 12)
    flat = {verify.leaf_key(p): leaf
            for p, leaf in verify.tree_flatten_with_path(resumed.params)}
    _hold_run(straight[0], straight[1],
              {k: torch.from_numpy(np.asarray(v, np.float32))
               for k, v in flat.items()}, losses)
