"""The learner inbox's end-of-stream events, in the two orders that a learner under load
meets (``sheeprl_tpu_torch/distributed/sebulba.py::LearnerInbox``), forced over a real
socket without timing luck:

* a learner that takes its items late: the dead actor's ``closed`` item stays queued after
  its blocks, and the event is stamped with the time its reader saw the end of the stream,
  not the time the learner took it (the reference's stamp);
* a respawn that connects before the old reader sees the end of the stream (its reader is
  blocked on a full queue): the old generation's ``closed`` is still queued, keyed by its
  generation, and folds only that generation's env steps.
"""

import time

from sheeprl_tpu_torch.distributed import placement, sebulba, transport


def _inbox(queue_depth: int = 2) -> sebulba.LearnerInbox:
    spec = placement.PlacementSpec(mode="sebulba", role="learner", num_actors=1, queue_depth=queue_depth)
    return sebulba.LearnerInbox(transport.Listener("127.0.0.1", 0), spec)


def _actor(inbox: sebulba.LearnerInbox, generation: int) -> transport.Channel:
    ch = transport.connect("127.0.0.1", inbox._listener.port, timeout_s=5.0)
    ch.send("hello", None, actor_id=0, generation=generation, algo="sac")
    return ch


def _wait(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def test_a_late_learner_records_the_close_when_the_stream_ended():
    inbox = _inbox()
    try:
        actor = _actor(inbox, 0)
        actor.send("block", {"batches": None}, iter_num=1, env_steps=8)
        actor.close()  # the actor dies
        _wait(lambda: inbox.qsize() == 2, "the block and the end of the stream to be queued")
        ended_by = time.monotonic()
        time.sleep(0.5)  # the learner takes its items late
        items = [inbox.get(timeout=5.0), inbox.get(timeout=5.0)]
        assert [(kind, actor_id) for kind, actor_id, *_ in items] == [("block", 0), ("closed", 0)]
        assert items[1][2] == {"generation": 0}  # the reference's item
        closed = [e for e in inbox.events if e[3] == "closed"]
        assert [e[1:] for e in closed] == [[0, 0, "closed"]]
        assert closed[0][0] <= ended_by, (closed[0][0], ended_by)
        assert [e[0] for e in inbox.events] == sorted(e[0] for e in inbox.events)
    finally:
        inbox.close()


def test_a_respawn_that_connects_first_still_gets_the_old_generations_close():
    inbox = _inbox(queue_depth=1)
    try:
        old = _actor(inbox, 0)
        old.send("block", {"batches": None}, iter_num=1, env_steps=4)
        old.send("block", {"batches": None}, iter_num=2, env_steps=8)
        # the first block fills the queue: the old reader holds the second, blocked on put
        _wait(lambda: inbox.qsize() == 1, "the first block")
        time.sleep(0.2)
        new = _actor(inbox, 1)  # the respawn replaces the channel before the old reader sees its end
        _wait(lambda: [0, 1, "connected"] in [e[1:] for e in inbox.events], "the respawn's connection")
        new.send("block", {"batches": None}, iter_num=1, env_steps=2)
        items = [inbox.get(timeout=5.0) for _ in range(4)]
        old.close()
        new.close()
        kinds = [(kind, meta.get("_generation", meta.get("generation"))) for kind, _, meta, _ in items]
        assert ("closed", 0) in kinds, kinds
        assert sorted(kinds, key=str) == sorted([("block", 0), ("block", 0), ("block", 1), ("closed", 0)], key=str), kinds
        assert kinds.index(("closed", 0)) > max(i for i, k in enumerate(kinds) if k == ("block", 0))
        assert [0, 0, "closed"] in [e[1:] for e in inbox.events]

        # the learner's accounting folds the closed generation's own count only
        slots = sebulba._SlotAccounting()
        for kind, actor_id, meta, _ in items:
            if kind == "block":
                slots.report(actor_id, meta["env_steps"], meta["_generation"])
            else:
                slots.fold(actor_id, meta["generation"])
        assert slots.total == 8 + 2
    finally:
        inbox.close()
