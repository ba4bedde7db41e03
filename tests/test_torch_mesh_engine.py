"""``ShardedCimEngine`` over gloo ranks on the CPU against the JAX
package's single-device ``CimEngine(impl="ref")``, at 2, 4 and 8 ranks:
xor, xnor, the cipher (and its round trip), digests and digest rows
bit for bit on the reference test's randomized sweep and its edges
(``mesh_ranks.engine_cases``); the cycle model ``devices`` times faster;
the digests the only bytes that cross ranks."""

import jax.numpy as jnp
import numpy as np
import pytest

from mesh_ranks import engine_cases, engine_rank
from repro.core.engine import CimEngine as JCimEngine
from repro_torch.launch import mesh as mesh_mod

SEED = 0


@pytest.mark.parametrize("world", [2, 4, 8])
def test_sharded_engine_is_bitwise_the_single_device_engine(world):
    ranks = mesh_mod.run_ranks(engine_rank, world, world, SEED,
                               device="cpu")
    ref = JCimEngine(impl="ref")
    for i, c in enumerate(engine_cases(SEED)):
        a, b = jnp.asarray(c["a"]), jnp.asarray(c["b"])
        mine = [r["cases"][i] for r in ranks]
        starts = [m["range"][0] for m in mine]
        assert starts == sorted(starts) and mine[0]["range"][0] == 0
        assert mine[-1]["range"][1] == c["n"]
        for op, want in (("xor", ref.xor(a, b)), ("xnor", ref.xnor(a, b)),
                         ("cipher", ref.stream_cipher(
                             a, jnp.asarray(c["key"]), counter=c["ctr"]))):
            got = np.concatenate([m[op] for m in mine])
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{op} case {i}")
        dig = np.asarray(ref.digest(a, c["width"]))
        rows = np.asarray(ref.digest_chunks(a, c["chunk"], c["width"]))
        for m in mine:
            assert m["round_trip"], i
            np.testing.assert_array_equal(m["digest"], dig, err_msg=str(i))
            np.testing.assert_array_equal(m["chunks"], rows, err_msg=str(i))
    assert all(r["cycles"] * world == ref.cycles_for(1 << 22) for r in ranks)
    # only digests cross: one per digest, one per digest row
    words = sum(c["width"] * (1 + len(range(0, max(c["n"], 1), -(
        -c["chunk"] // c["width"]) * c["width"]))) for c in engine_cases(SEED))
    assert all(r["digest_bytes"] == 4 * words * (world - 1)
               and r["other_bytes"] == 0 for r in ranks)
