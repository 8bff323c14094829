"""The message queue between ranks (``core.messages.PeerTransport``): the
cases of ``tests/drivers/driver_messages.py`` on 6 spawned gloo ranks, a
producer of dp 2 on ranks 0-1 and a consumer of dp 4 on ranks 2-5
(``tests/torch_drivers/driver_sections.py``, case ``messages``, asserts
each on its ranks):

* 1-to-1: rank 0 sends a whole [8, 4] tensor, rank 2 receives it equal;
* 2-to-4: each producer rank sends its 4-row fragment to the two consumer
  ranks whose 2 rows it holds, and each takes its own rows;
* keys pulled in the other order than they were pushed between one pair
  of ranks (receives posted in the sender's order, buffered by key);
* a message that never comes raises ``PullTimeout`` naming its producer,
  without closing the connection (the ranks go on to a barrier);
* the logical push count: 4 keys (``h0``, ``h1``, ``k1``, ``k2``) over 8
  fragments on the wire.
"""
import pytest

pytest.importorskip("torch")

import torch_sections_util as su  # noqa: E402


def test_messages_between_ranks(tmp_path):
    got = su.run("messages", 6, {"unused": [0]}, tmp_path)
    assert sorted(got) == list(range(6))
    for npz in got.values():
        assert int(npz["pushes"][0]) == 4
        # h0 once, h1 four times, k1 and k2, and the late message
        assert int(npz["fragments"][0]) == 8
