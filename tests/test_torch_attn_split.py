"""Host-side logic of the split attention kernels, on the CPU.

``online_softmax.merge`` combines partial (m, l, acc) states of disjoint key
ranges; the paged decode kernel's last-block merge implements it (held on
the card by ``tests/test_torch_cuda.py``).  Here the key axis is split at
random points, with empty and all-masked parts: each part's plain
recurrence, merged, must equal the one-pass recurrence within 1e-5
relative in f32 (the order of summation differs), and after ``finish``
the JAX reference's ``flash_attention_ref`` within 2e-5.

``paged_attn.split_plan`` cuts a table's W columns into the kernel's
splits from shapes alone: every column exactly once, never more splits
than columns, and neither a position nor the batch size among its inputs
(a slot's rows are the same bits at any batch size).  ``paged_attn.live_columns``
is the kernel's O(1) dead-column rule, held against the reference kernel's
``any(valid)`` over each column's keys.  The paged decode through the split
plan (``paged_attn.split_reference``), merged, equals the JAX reference's
``paged_decode``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import online_softmax as osm
from repro_torch.kernels import paged_attn as kpaged
from repro_torch.kernels import ref

NEG_INF = osm.NEG_INF


def _part_state(s, v, keep):
    """Plain recurrence over one part: scores ``s`` (BH, R, n) already
    masked, ``keep`` (BH, R, n) bool.  Rows with no kept key keep
    ``init``'s state, as the kernels skip what they cannot see."""
    m, l, acc = osm.init(s.shape[:2], v.shape[-1])
    if s.shape[-1] == 0:
        return m, l, acc
    m2, l2, acc2 = osm.update(s, v, m, l, acc)
    live = keep.any(dim=-1, keepdim=True)
    return (torch.where(live, m2, m), torch.where(live, l2, l),
            torch.where(live, acc2, acc))


def _scores(q, k, causal):
    s = torch.matmul(q, k.transpose(1, 2)) * q.shape[-1] ** -0.5
    r, n = q.shape[1], k.shape[1]
    keep = torch.ones((r, n), dtype=torch.bool)
    if causal:
        keep = torch.arange(n)[None] <= torch.arange(r)[:, None]
    keep = keep[None].expand(q.shape[0], r, n)
    return torch.where(keep, s, NEG_INF), keep


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("causal", [True, False])
def test_merge_of_random_splits_equals_one_pass(seed, causal):
    rng = np.random.default_rng(seed)
    bh, s_len, dh, rows = 2, int(rng.integers(24, 97)), 16, 20
    q, k, v = (rng.standard_normal((bh, s_len, dh)).astype(np.float32)
               for _ in range(3))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    # the first `rows` queries: causal parts past them are all masked
    sc, keep = _scores(qt[:, :rows], kt, causal)
    # random cuts, one past the rows (causal: every later key is masked
    # for every row) and a repeated one (an empty part)
    cuts = rng.integers(0, s_len + 1, size=int(rng.integers(1, 7)))
    bounds = sorted([0, s_len, rows + 1, int(cuts[0]), *cuts.tolist()])
    parts = [_part_state(sc[..., a:b], vt[:, a:b], keep[..., a:b])
             for a, b in zip(bounds[:-1], bounds[1:])]
    m, l, acc = osm.merge(parts)
    m1, l1, acc1 = osm.update(sc, vt, *osm.init((bh, rows), dh))
    torch.testing.assert_close(m, m1, rtol=0, atol=0)
    torch.testing.assert_close(l, l1, rtol=1e-5, atol=0)
    torch.testing.assert_close(acc, acc1, rtol=1e-5, atol=1e-6)
    want = np.asarray(jflash.flash_attention_ref(q, k, v, causal))[:, :rows]
    np.testing.assert_allclose(osm.finish(m, l, acc).numpy(), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_parts", [1, 2, 5])
def test_merge_weighs_dead_parts_nothing(n_parts):
    rng = np.random.default_rng(n_parts)
    s = torch.from_numpy(rng.standard_normal((1, 3, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    live = osm.update(s, v, *osm.init((1, 3), 4))
    dead = osm.init((1, 3), 4)
    m, l, acc = osm.merge([dead] * n_parts + [live] + [dead])
    for got, want in zip((m, l, acc), live):
        assert torch.equal(got, want)
    m, l, acc = osm.merge([dead] * n_parts)      # nothing live at all
    for got, want in zip((m, l, acc), dead):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kv,sms", [(1, 132), (16, 132), (28, 132),
                                    (112, 132), (2048, 132), (16, 1),
                                    (3, 7), (1000, 114)])
def test_split_plan_covers_every_column_once(kv, sms):
    for w in range(1, 4097):
        n, cols = kpaged.split_plan(w, kv, sms)
        assert 1 <= n <= w and cols >= 1
        ranges = [(i * cols, min(w, (i + 1) * cols)) for i in range(n)]
        assert all(b > a for a, b in ranges), (w, n, cols)     # none empty
        assert ranges[0][0] == 0 and ranges[-1][1] == w
        assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n - 1))
        assert n * kpaged.PLAN_SLOTS * kv <= \
            max(kpaged.BLOCKS_PER_SM * sms, kpaged.PLAN_SLOTS * kv) + \
            kpaged.PLAN_SLOTS * kv


def test_split_plan_reads_no_positions():
    """Nor the batch: the plan sizes the grid for ``PLAN_SLOTS`` slots."""
    assert list(inspect.signature(kpaged.split_plan).parameters) == [
        "w", "kv", "sms"]
    # qwen2-7b's 4 KV heads at the serving and long-context tables of
    # chip_smoke.py on 132 SMs
    assert kpaged.split_plan(8, 4, 132) == (8, 1)
    assert kpaged.split_plan(2048, 4, 132) == (25, 82)


def _valid_np(pos, w, bs, window):
    """The reference kernel's key mask, (B, W*bs), in numpy."""
    cap = w * bs
    kslot = np.arange(cap)[None]
    p = pos[:, None].astype(np.int64)
    if window:
        return np.mod(np.mod(p, cap) - kslot, cap) < np.minimum(window, p + 1)
    return kslot <= p


@pytest.mark.parametrize("bs,w,window", [(16, 8, 0), (16, 8, 40),
                                         (4, 5, 7), (1, 9, 3), (8, 3, 100),
                                         (16, 2048, 40), (16, 2048, 0),
                                         (3, 11, 16)])
def test_live_columns_match_the_reference_mask(bs, w, window):
    cap = w * bs
    pos = np.unique(np.concatenate([np.arange(min(3 * cap, 400)),
                                    np.arange(0, 3 * cap, max(1, cap // 7)),
                                    [cap - 1, cap, cap + 1, 2 * cap - 1]]))
    want = _valid_np(pos, w, bs, window).reshape(len(pos), w, bs).any(-1)
    got = kpaged.live_columns(torch.from_numpy(pos).to(torch.int32), w, bs,
                              window)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window,pos", [(0, [0, 17, 127, 64]),
                                        (40, [45, 80, 300, 127]),
                                        (0, [200, 5, 255, 31]),
                                        (24, [1000, 3, 77, 16])])
@pytest.mark.parametrize("sms", [1, 4, 132])
def test_split_paged_decode_equals_the_reference(window, pos, sms):
    rng = np.random.default_rng(7)
    b, kv, g, dh, bs, w = 4, 2, 3, 16, 4, 16 if window else 64
    q = rng.standard_normal((b, kv, g, dh)).astype(np.float32)
    ck, cv = (rng.standard_normal((1 + b * w, kv, bs, dh)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(b * w).reshape(b, w) + 1).astype(np.int32)
    pos_np = np.asarray(pos, dtype=np.int32)
    kw = dict(window=window, scale=dh ** -0.5, out_scale=1.0)
    got = kpaged.split_reference(*(torch.from_numpy(a) for a in (
        q, ck, cv, table, pos_np)), sms=sms, **kw)
    want = np.asarray(jref.paged_decode(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(table),
        jnp.asarray(pos_np), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    plain = ref.paged_decode(*(torch.from_numpy(a) for a in (
        q, ck, cv, table, pos_np)), **kw)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("w", [8, 32, 300])
def test_split_rows_do_not_depend_on_the_batch(w):
    """Slots 0-1 of a 4-slot split walk equal a 2-slot walk's bitwise
    (f32), so a session moved between engines of other ``slots`` meets
    the same merge order."""
    rng = np.random.default_rng(w)
    kv, g, dh, bs = 2, 3, 16, 4
    q = torch.from_numpy(rng.standard_normal((4, kv, g, dh))
                         .astype(np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((1 + 4 * w, kv, bs, dh))
                               .astype(np.float32)) for _ in range(2))
    table = torch.from_numpy((rng.permutation(4 * w).reshape(4, w) + 1)
                             .astype(np.int32))
    pos = torch.tensor([w * bs - 1, 5, w * bs // 2, 0], dtype=torch.int32)
    kw = dict(scale=dh ** -0.5, sms=132)
    four = kpaged.split_reference(q, ck, cv, table, pos, **kw)
    two = kpaged.split_reference(q[:2], ck, cv, table[:2], pos[:2], **kw)
    assert torch.equal(four[:2], two)
