"""The port's ``_SlotScheduler`` against ``tpufw`` (``tests/test_slots.py``
scheduling tests), on llama3_tiny in fp32 with the Flax weights moved
into the port, in contiguous and paged (page 16) mode:

- a short request submitted while a long one decodes joins a free slot at
  a chunk boundary and completes first; both give ``tpufw``'s greedy
  tokens;
- a streaming request is an ordinary slot occupant: it shares chunks with
  a non-streamed request, flushes at most one chunk per event, and its
  events concatenate to ``tpufw``'s greedy tokens;
- sampled requests replay from the seed base and arrival order.
"""

import functools
import queue
import threading
import time

import pytest

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import generate_text as j_generate_text
from tpufw_torch.infer import SamplingConfig
from tpufw_torch.workloads import serve

GREEDY = SamplingConfig()
MODES = {"contiguous": 0, "paged": 16}


@functools.lru_cache(maxsize=None)
def _want(prompt, max_new):
    jmodel, params, _ = decode_pair()
    return j_generate_text(jmodel, params, [list(prompt)],
                           max_new_tokens=max_new)


def _scheduler(mode, **kw):
    return serve._SlotScheduler(
        decode_pair()[2], eos_id=None, default_sampling=GREEDY,
        page=MODES[mode], **kw,
    )


def _wait_occupied(sched):
    deadline = time.monotonic() + 120
    while sched.slots_occupied == 0 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert sched.slots_occupied, "the long request never took a slot"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_mid_flight_join_and_leave(mode, monkeypatch):
    monkeypatch.setenv("TPUFW_SERVE_CHUNK", "2")
    sched = _scheduler(mode)
    done = {}

    def run(name, prompt, max_new):
        outs, bw = sched.submit([prompt], max_new)
        done[name] = (time.monotonic(), outs, bw)

    try:
        long_t = threading.Thread(target=run, args=("long", [1, 2, 3], 40))
        long_t.start()
        _wait_occupied(sched)
        short_t = threading.Thread(target=run, args=("short", [4, 5], 4))
        short_t.start()
        long_t.join(timeout=300)
        short_t.join(timeout=300)
        assert not long_t.is_alive() and not short_t.is_alive()
        t_long, long_out, long_bw = done["long"]
        t_short, short_out, short_bw = done["short"]
        assert t_short < t_long
        assert long_bw >= 2 and short_bw >= 2
        assert long_out == _want((1, 2, 3), 40)
        assert short_out == _want((4, 5), 4)
        assert sched.slots_occupied == 0
        if mode == "paged":
            # Only the trie's pages outlive the rows.
            assert sched.pages_in_use == len(sched.pool.allocator.held)
    finally:
        sched.close()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scheduler_stream_shares_chunks(mode, monkeypatch):
    monkeypatch.setenv("TPUFW_SERVE_CHUNK", "2")
    sched = _scheduler(mode)
    done = {}

    def run():
        done["long"] = sched.submit([[1, 2, 3]], 24)

    try:
        long_t = threading.Thread(target=run)
        long_t.start()
        _wait_occupied(sched)
        q = queue.Queue()
        sched.submit_stream([[6, 7]], 8, None, q)
        events = []
        while True:
            kind, payload = q.get(timeout=120)
            events.append((kind, payload))
            if kind in ("done", "error"):
                break
        long_t.join(timeout=300)
        assert not long_t.is_alive()
        assert events[-1] == ("done", 8)
        chunks = [rows for kind, rows in events[:-1] if kind == "chunk"]
        assert len(chunks) >= 2
        # The admission flush carries the prefill token, later flushes at
        # most one chunk of 2 tokens.
        assert all(len(rows[0]) <= 2 for rows in chunks)
        assert [t for rows in chunks for t in rows[0]] == _want((6, 7), 8)[0]
        assert done["long"][1] >= 2
    finally:
        sched.close()


def test_sampled_requests_replay_from_the_seed():
    """Two schedulers with one seed base give the same sampled tokens for
    the same arrival order; another seed base gives others; after
    ``reset_after_warmup`` a scheduler replays its first request."""
    hot = SamplingConfig(temperature=100.0)

    def run(seed, n=2, reset=False):
        sched = serve._SlotScheduler(decode_pair()[2], default_sampling=hot,
                                     seed_base=seed)
        try:
            outs = [sched.submit([[1, 5, 9]], 6)[0] for _ in range(n)]
            if reset:
                sched.reset_after_warmup()
                outs.append(sched.submit([[1, 5, 9]], 6)[0])
            return outs
        finally:
            sched.close()

    a = run(3, reset=True)
    assert a[0] != a[1]  # each prefill and chunk draws its own stream
    assert a[2] == a[0]
    assert run(3) == a[:2]
    assert run(4) != a[:2]


def test_close_fails_queued_and_refuses_new_requests():
    sched = _scheduler("contiguous")
    sched.close()
    assert not sched._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit([[1, 2]], 2)
