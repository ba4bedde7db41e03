"""The port's serving workloads against the JAX package's, on the CPU.

- ``TranscriptionService`` on whisper-tiny smoke (f32, the reference's
  parameters converted): the port's transcripts equal the reference's at
  1 and 3 slots (sampling at T 0.8 folds (rid, step) into the key, so
  the schedule never reaches the tokens), and the reference test's
  incremental-prompt and validation checks;
- ``bcnn.train_classifier`` from the reference's initial parameters and
  the same images (``prng`` draws the reference's bits): after 50
  full-batch SGD steps the parameters within ``CLS_TOL_50`` of the
  reference's (measured: 5e-7), after 150 within ``CLS_REL_150`` of each
  leaf's largest |w| (measured: 2.9e-4; a binary net's forward is
  discontinuous, and past step 50 the two runs part slowly), the same
  train accuracy at both; then ``ClassifierService`` on the
  trained parameters: the reference's classes on held-out images, packed
  = float-sign, one-shot slot turnover, the reference test's accuracy
  thresholds.

Reference engines are built through ``test_torch_reference.
reference_engine`` (shared compiled programs).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import bcnn as jbcnn
from repro.models import lm as jlm
from repro.serve import workloads as jworkloads
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import prng, verify
from repro_torch.models import bcnn
from repro_torch.serve import (ClassifierService, TranscriptStream,
                               TranscriptionService, synthetic_audio_trace)

from test_torch_reference import reference_engine

CLS_TOL_50 = dict(rtol=1e-5, atol=2e-6)
CLS_REL_150 = 1e-3


@pytest.fixture(autouse=True)
def _shared_reference_programs(monkeypatch):
    monkeypatch.setattr(jworkloads, "ServeEngine", reference_engine)


@pytest.fixture(scope="module")
def whisper():
    jcfg = jconfigs.get("whisper-tiny").smoke(dtype=jnp.float32)
    cfg = configs.get("whisper-tiny").smoke(dtype=torch.float32)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(
        zlib.crc32(b"whisper-tiny") % 2**31))
    return jcfg, cfg, jp, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def test_synthetic_audio_trace_matches_reference():
    from repro.serve import synthetic_audio_trace as jtrace
    want = jtrace(3, 2, n_ctx_tokens=16, d_model=8, seed=4)
    got = synthetic_audio_trace(3, 2, n_ctx_tokens=16, d_model=8, seed=4)
    assert [s.sid for s in got] == [s.sid for s in want]
    for a, b in zip(got, want):
        for wa, wb in zip(a.windows, b.windows):
            np.testing.assert_array_equal(wa, wb)


@pytest.mark.parametrize("slots", [1, 3])
def test_transcripts_match_reference(whisper, slots):
    jcfg, cfg, jp, tp = whisper
    streams = synthetic_audio_trace(3, 2, n_ctx_tokens=cfg.n_ctx_tokens,
                                    d_model=cfg.d_model, seed=5)
    want = jworkloads.TranscriptionService(
        jcfg, jp, slots=slots, seed=7).transcribe(streams)
    svc = TranscriptionService(cfg, tp, slots=slots, seed=7, device="cpu")
    got = svc.transcribe(streams)
    assert got == want
    assert sorted(got) == [0, 1, 2]
    assert all(len(t) == 2 * 4 for t in got.values())
    assert svc.stats.prefills == 3 * 2


def test_transcription_is_incremental(whisper):
    _, cfg, _, tp = whisper
    svc = TranscriptionService(cfg, tp, slots=2, tokens_per_window=3,
                               carry=4, seed=1, device="cpu")
    assert svc._prompt([]).tolist() == [svc.bos_id]
    assert svc._prompt([5, 6]).tolist() == [svc.bos_id, 5, 6]
    assert svc._prompt(list(range(10))).tolist() == [svc.bos_id, 6, 7, 8, 9]
    streams = synthetic_audio_trace(2, 3, n_ctx_tokens=cfg.n_ctx_tokens,
                                    d_model=cfg.d_model, seed=2)
    out = svc.transcribe(streams)
    assert all(len(t) == 3 * 3 for t in out.values())
    assert svc.stats.prefills == 2 * 3
    assert svc.transcribe(streams) == out


def test_transcription_validation(whisper):
    _, cfg, _, tp = whisper
    with pytest.raises(ValueError, match="enc-dec"):
        TranscriptionService(configs.get("qwen3-4b").smoke(), tp,
                             device="cpu")
    with pytest.raises(ValueError, match="s_max"):
        TranscriptionService(cfg, tp, carry=30, tokens_per_window=8,
                             s_max=32, device="cpu")
    svc = TranscriptionService(cfg, tp, slots=2, device="cpu")
    w = np.zeros((cfg.n_ctx_tokens, cfg.d_model), np.float32)
    dup = [TranscriptStream(sid=1, windows=[w]),
           TranscriptStream(sid=1, windows=[w])]
    with pytest.raises(ValueError, match="duplicate"):
        svc.transcribe(dup)
    with pytest.raises(ValueError, match="no windows"):
        TranscriptStream(sid=0, windows=[])


def _train_both(steps: int):
    """Both packages' classifiers trained from the reference's initial
    parameters for seed 0 (the reference's ``train_classifier``)."""
    jcfg, cfg = jconfigs.get("xnor-cnn"), configs.get("xnor-cnn")
    jp, jacc = jbcnn.train_classifier(jcfg, steps=steps, seed=0)
    init = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp, tacc = bcnn.train_classifier(
        cfg, steps=steps, seed=0, device="cpu",
        init=convert.from_jax(cfg, jax.tree.map(np.asarray, init)))
    return jcfg, cfg, jp, jacc, tp, tacc


@pytest.fixture(scope="module")
def trained():
    return _train_both(150)


def _hold_params(jp, tp, rel=None, **tol):
    want = {verify.leaf_key(p): leaf for p, leaf in
            verify.tree_flatten_with_path(jax.tree.map(np.asarray, jp))}
    for path, leaf in verify.tree_flatten_with_path(tp):
        key = verify.leaf_key(path)
        assert not leaf.requires_grad
        w = want[key]
        if rel is not None:
            tol = dict(rtol=0, atol=rel * np.abs(w).max())
        np.testing.assert_allclose(leaf.numpy(), w, **tol, err_msg=key)


def test_train_classifier_matches_reference(trained):
    _, _, jp, jacc, tp, tacc = _train_both(50)
    assert tacc == jacc
    _hold_params(jp, tp, **CLS_TOL_50)
    _, _, jp, jacc, tp, tacc = trained
    assert tacc == jacc and tacc >= 0.95
    _hold_params(jp, tp, rel=CLS_REL_150)


def test_classifier_service_matches_reference(trained):
    jcfg, cfg, jp, _, tp, _ = trained
    jsvc = jworkloads.ClassifierService(cfg=jcfg, params=jp, slots=3)
    svc = ClassifierService(cfg=cfg, params=tp, slots=3, device="cpu")
    imgs, y = bcnn.synthetic_images(prng.PRNGKey(99), 32)
    jimgs, jy = jbcnn.synthetic_images(jax.random.PRNGKey(99), 32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    pred = svc.classify(imgs)
    np.testing.assert_array_equal(pred, jsvc.classify(np.asarray(jimgs)))
    assert pred.shape == (32,) and set(np.unique(pred)) <= {0, 1}
    assert float(np.mean(pred == y.numpy())) >= 0.9
    float_svc = ClassifierService(cfg=cfg, params=tp, slots=3, pack=False,
                                  device="cpu")
    np.testing.assert_array_equal(float_svc.classify(imgs), pred)


def test_classifier_one_shot_sessions(trained):
    _, cfg, _, _, tp, _ = trained
    svc = ClassifierService(cfg=cfg, params=tp, slots=3, device="cpu")
    imgs, _ = bcnn.synthetic_images(prng.PRNGKey(11), 10)
    pred = svc.classify(imgs)
    assert pred.shape == (10,) and svc.stats.prefills == 10
    sessions = list(svc.engine.sessions.values())[-10:]
    assert all(s.finish_reason == "length" and len(s.tokens) == 1
               for s in sessions)
    np.testing.assert_array_equal(svc.classify(imgs), pred)
    assert svc.stats.prefills == 20


def test_classifier_service_trains_when_given_no_params():
    svc = ClassifierService(slots=2, train_steps=40, seed=3, device="cpu")
    assert svc.train_acc is not None and 0.0 <= svc.train_acc <= 1.0
    imgs, _ = bcnn.synthetic_images(prng.PRNGKey(5), 4)
    assert svc.classify(imgs).shape == (4,)
