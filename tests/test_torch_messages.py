"""The port's MessageQueue (``repro_torch.core.messages``) on torch tensors,
with the semantics of ``tests/test_messages.py``: per-key metadata
indexing, ``torch.cat`` assembly of axis-0-contiguous fragments, slice
assembly of arbitrary fragment layouts, M-to-N composition, blocking
pulls, timeouts that name producer and scope, scope eviction and sealing,
per-edge stats; plus the move onto the consumer's device."""
import logging
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.messages import (MessageQueue, PullTimeout,  # noqa: E402
                                       StaleScopeError, _axis0_contiguous)


class _Jnp:
    """The few ``jnp`` constructors the JAX package's tests use, as torch
    tensors, so each case reads as its counterpart."""
    float32 = torch.float32

    @staticmethod
    def asarray(x):
        return torch.as_tensor(np.asarray(x))

    @staticmethod
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    @staticmethod
    def ones(shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)

    @staticmethod
    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype)


jnp = _Jnp()


def test_m_to_n_axis0_contiguous_device_path():
    q = MessageQueue()
    x = np.arange(48, dtype=np.float32).reshape(12, 4)
    # three senders, out-of-order ranks, axis-0 contiguous tiling
    q.push("t", "s", "h", jnp.asarray(x[8:12]), frag_index=(slice(8, 12),),
           frag_rank=2, frag_count=3, global_shape=(12, 4))
    q.push("t", "s", "h", jnp.asarray(x[0:4]), frag_index=(slice(0, 4),),
           frag_rank=0, frag_count=3, global_shape=(12, 4))
    q.push("t", "s", "h", jnp.asarray(x[4:8]), frag_index=(slice(4, 8),),
           frag_rank=1, frag_count=3, global_shape=(12, 4))
    got = q.pull("t", "s", "h")
    np.testing.assert_array_equal(np.asarray(got), x)


def test_non_contiguous_fragments_slice_assembly():
    q = MessageQueue()
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    # axis-1 split: not axis-0 contiguous -> host assembly
    frags = [((slice(0, 4), slice(0, 4)), x[:, :4]),
             ((slice(0, 4), slice(4, 8)), x[:, 4:])]
    for r, (idx, frag) in enumerate(frags):
        q.push("t", "s", "k", jnp.asarray(np.ascontiguousarray(frag)),
               frag_index=idx, frag_rank=r, frag_count=2,
               global_shape=(4, 8))
    got = q.pull("t", "s", "k")
    np.testing.assert_array_equal(np.asarray(got), x)


def test_axis0_contiguity_detection():
    from repro_torch.core.messages import Meta

    def meta(rank, sl0, gshape=(8, 4), sl1=None):
        idx = (sl0, sl1 if sl1 is not None else slice(0, gshape[1]))
        return Meta("k", "t", gshape, np.float32, idx, rank, 2)

    ok = {0: meta(0, slice(0, 4)), 1: meta(1, slice(4, 8))}
    assert _axis0_contiguous(ok) == [0, 1]
    # reversed rank order still detected (sorted by start offset)
    rev = {0: meta(0, slice(4, 8)), 1: meta(1, slice(0, 4))}
    assert _axis0_contiguous(rev) == [1, 0]
    gap = {0: meta(0, slice(0, 3)), 1: meta(1, slice(4, 8))}
    assert _axis0_contiguous(gap) is None
    partial_cols = {0: meta(0, slice(0, 4), sl1=slice(0, 2)),
                    1: meta(1, slice(4, 8))}
    assert _axis0_contiguous(partial_cols) is None


def test_per_key_indexing_with_deep_backlog():
    """A pull must find its key regardless of how many other keys are
    buffered on the channel (the old implementation rescanned every
    buffered meta per wakeup)."""
    q = MessageQueue()
    for i in range(50):
        q.push("a", "b", f"k{i}", jnp.full((2,), i, jnp.float32))
    # pull in arbitrary order; untouched keys stay buffered
    for i in (37, 0, 49, 12):
        got = q.pull("a", "b", f"k{i}")
        np.testing.assert_array_equal(np.asarray(got),
                                      np.full((2,), i, np.float32))
    assert q.stats()["pushes"] == 50


def test_pull_blocks_until_all_fragments_arrive():
    q = MessageQueue()
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    out = {}

    def puller():
        out["v"] = q.pull("t", "s", "h", timeout=10.0)

    th = threading.Thread(target=puller)
    q.push("t", "s", "h", jnp.asarray(x[:2]), frag_index=(slice(0, 2),),
           frag_rank=0, frag_count=2, global_shape=(4, 2))
    th.start()
    q.push("t", "s", "h", jnp.asarray(x[2:]), frag_index=(slice(2, 4),),
           frag_rank=1, frag_count=2, global_shape=(4, 2))
    th.join(timeout=10)
    assert not th.is_alive()
    np.testing.assert_array_equal(np.asarray(out["v"]), x)


def test_pull_timeout():
    q = MessageQueue()
    with pytest.raises(TimeoutError):
        q.pull("a", "b", "missing", timeout=0.1)


# --------------------------------------------------------------------------- #
# Diagnosability (satellite): per-edge stats, pending keys in timeouts
# --------------------------------------------------------------------------- #
def test_stats_per_edge_depth_pending_bytes():
    q = MessageQueue()
    q.push("a", "b", "s0/x", jnp.zeros((4, 2), jnp.float32))
    q.push("a", "b", "s0/y", jnp.zeros((8,), jnp.float32))
    q.push("b", "c", "s0/z", jnp.zeros((2,), jnp.float32))
    st = q.stats()
    assert st["pushes"] == 3 and st["channels"] == 2
    ab = st["edges"]["a->b"]
    assert ab["depth"] == 2
    assert ab["pending"] == ["s0/x", "s0/y"]
    assert ab["bytes"] == (4 * 2 + 8) * 4
    assert st["edges"]["b->c"] == {"depth": 1, "pending": ["s0/z"],
                                   "bytes": 2 * 4}
    q.pull("a", "b", "s0/x")
    st2 = q.stats()
    assert st2["edges"]["a->b"]["pending"] == ["s0/y"]
    assert st2["edges"]["a->b"]["bytes"] == 8 * 4


def test_pull_timeout_reports_pending_keys():
    """The timeout error must name what IS buffered on the edge — a
    stale-scope or typo'd key is diagnosed from the message alone."""
    q = MessageQueue()
    q.push("a", "b", "s0/emb.0", jnp.zeros((2,)))
    with pytest.raises(TimeoutError, match=r"s1/emb\.0.*s0/emb\.0"):
        q.pull("a", "b", "s1/emb.0", timeout=0.1)


# --------------------------------------------------------------------------- #
# Iteration-scoped namespaces (streaming tentpole)
# --------------------------------------------------------------------------- #
def test_evict_scope_drops_leftovers_and_seals_namespace():
    q = MessageQueue()
    q.push("a", "b", "s0/left", jnp.zeros((2,)))
    q.push("a", "b", "s1/keep", jnp.ones((2,)))
    q.push("a", "b", "unscoped", jnp.ones((3,)))
    evicted = q.evict_scope("s0")
    assert evicted == {"a->b": ["s0/left"]}
    # the retired namespace is sealed in both directions
    with pytest.raises(RuntimeError, match=r"scope 's0'.*retired"):
        q.push("a", "b", "s0/late", jnp.zeros((1,)))
    with pytest.raises(RuntimeError, match=r"scope 's0'.*retired"):
        q.pull("a", "b", "s0/left", timeout=0.1)
    # other scopes and unscoped keys are untouched
    np.testing.assert_array_equal(np.asarray(q.pull("a", "b", "s1/keep")),
                                  np.ones((2,), np.float32))
    np.testing.assert_array_equal(np.asarray(q.pull("a", "b", "unscoped")),
                                  np.ones((3,), np.float32))
    assert q.stats()["edges"]["a->b"]["depth"] == 0


def test_evict_scope_clean_iteration_reports_nothing():
    q = MessageQueue()
    q.push("a", "b", "s7/x", jnp.zeros((2,)))
    q.pull("a", "b", "s7/x")
    assert q.evict_scope("s7") == {}


# --------------------------------------------------------------------------- #
# Retirement diagnosability (satellite): named errors, eviction logging,
# stats after eviction
# --------------------------------------------------------------------------- #
def test_sealed_scope_raises_named_error():
    """Stale traffic into a retired scope raises the NAMED
    StaleScopeError (a RuntimeError subclass, so old handlers keep
    working) — callers can catch exactly this condition."""
    q = MessageQueue()
    q.evict_scope("s0")
    with pytest.raises(StaleScopeError, match=r"scope 's0'.*retired"):
        q.push("a", "b", "s0/late", jnp.zeros((1,)))
    with pytest.raises(StaleScopeError, match=r"scope 's0'.*retired"):
        q.pull("a", "b", "s0/late", timeout=0.1)
    assert issubclass(StaleScopeError, RuntimeError)


def test_pull_timeout_is_named_and_blames_producer_and_scope():
    """The timeout error is the NAMED PullTimeout (TimeoutError
    subclass) and names the producing section and the iteration scope
    being waited on."""
    q = MessageQueue()
    with pytest.raises(PullTimeout,
                       match=r"producer section 'vit'.*scope 's3'"):
        q.pull("vit", "llm", "s3/emb.1", timeout=0.1)
    # unscoped keys still name the producer, without a scope clause
    with pytest.raises(PullTimeout, match=r"producer section 'a'"):
        q.pull("a", "b", "plainkey", timeout=0.1)


def test_evict_scope_logs_leftovers(caplog):
    """Leftover eviction must leave a log trail naming scope, edge and
    keys — a producer pushed something no consumer ever pulled."""
    q = MessageQueue()
    q.push("a", "b", "s0/orphan.0", jnp.zeros((2,)))
    q.push("a", "b", "s0/orphan.1", jnp.zeros((2,)))
    with caplog.at_level(logging.WARNING, logger="repro_torch.messages"):
        q.evict_scope("s0")
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "repro_torch.messages"]
    assert len(msgs) == 1
    assert "'s0'" in msgs[0] and "a->b" in msgs[0]
    assert "s0/orphan.0" in msgs[0] and "s0/orphan.1" in msgs[0]
    # a clean eviction logs nothing
    caplog.clear()
    q.push("a", "b", "s1/x", jnp.zeros((2,)))
    q.pull("a", "b", "s1/x")
    with caplog.at_level(logging.WARNING, logger="repro_torch.messages"):
        q.evict_scope("s1")
    assert not [r for r in caplog.records if r.name == "repro_torch.messages"]


def test_stats_per_edge_after_eviction():
    """stats() must reflect eviction: depth and buffered bytes drop to
    zero for the evicted scope while other scopes' bytes survive."""
    q = MessageQueue()
    q.push("a", "b", "s0/x", jnp.zeros((4, 2), jnp.float32))
    q.push("a", "b", "s1/y", jnp.zeros((8,), jnp.float32))
    q.push("b", "c", "s0/z", jnp.zeros((2,), jnp.float32))
    q.evict_scope("s0")
    st = q.stats()
    assert st["edges"]["a->b"] == {"depth": 1, "pending": ["s1/y"],
                                   "bytes": 8 * 4}
    assert st["edges"]["b->c"] == {"depth": 0, "pending": [], "bytes": 0}
    # totals are cumulative push-side counters, untouched by eviction
    assert st["pushes"] == 3


def test_pull_moves_onto_the_consumer_device_and_counts_bytes():
    q = MessageQueue()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    q.push("a", "b", "s0/h", x)
    got = q.pull("a", "b", "s0/h", device=torch.device("cpu"))
    assert got.device.type == "cpu" and torch.equal(got, x)
    assert q.stats()["bytes_pushed"] == 6 * 4
    bf = torch.zeros((4, 2), dtype=torch.bfloat16)
    q.push("a", "b", "s0/bf", bf)
    assert q.stats()["edges"]["a->b"]["bytes"] == 4 * 2 * 2
    assert q.pull("a", "b", "s0/bf").dtype == torch.bfloat16
