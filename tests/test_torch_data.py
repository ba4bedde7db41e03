"""The port's synthetic data pipeline against the JAX package's, on the
CPU: ``synthetic.batch`` and ``Pipeline`` bitwise (tokens, labels and a
context arch's ctx), the reference test's determinism and structure,
and ``batch_on_device``'s contract (shapes, dtypes, shifted labels, the
-1 tail; its draws are the port's own ``torch.Generator``'s)."""

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import synthetic as jsynthetic
import repro_torch.configs as configs
from repro_torch.data import synthetic

pytestmark = pytest.mark.filterwarnings("ignore:overflow:RuntimeWarning")


@pytest.mark.parametrize("seed,step,b,s,vocab,ctx", [
    (0, 0, 4, 32, 1000, None), (3, 7, 2, 16, 256, None),
    (2**40 + 5, 123456, 3, 65, 152064, None), (1, 2, 2, 8, 512, (16, 64)),
])
def test_batch_bitwise(seed, step, b, s, vocab, ctx):
    want = jsynthetic.batch(seed, step, b, s, vocab, ctx)
    got = synthetic.batch(seed, step, b, s, vocab, ctx)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-tiny",
                                  "llama-3.2-vision-11b"])
def test_pipeline_bitwise_with_lookahead(arch):
    jp = jsynthetic.Pipeline(jconfigs.get(arch).smoke(), 2, 16, seed=5)
    tp = synthetic.Pipeline(configs.get(arch).smoke(), 2, 16, seed=5)
    for step in (0, 1, 2, 7, 8, 3):
        want, got = jp.get(step), tp.get(step)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_deterministic_and_structured():
    b1 = synthetic.batch(0, 7, 4, 32, 1000)
    b2 = synthetic.batch(0, 7, 4, 32, 1000)
    b3 = synthetic.batch(0, 8, 4, 32, 1000)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 1000
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    assert (b1["labels"][:, -1] == -1).all()


def test_to_device_keeps_values():
    host = synthetic.batch(1, 2, 2, 8, 512, (4, 8))
    dev = synthetic.to_device(host, "cpu")
    for k, v in host.items():
        assert dev[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(dev[k].numpy(), v)


def test_batch_on_device_contract():
    a = synthetic.batch_on_device(0, 3, 4, 16, 100, device="cpu")
    b = synthetic.batch_on_device(0, 3, 4, 16, 100, device="cpu")
    c = synthetic.batch_on_device(0, 4, 4, 16, 100, device="cpu")
    assert a["tokens"].shape == a["labels"].shape == (4, 16)
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 100
