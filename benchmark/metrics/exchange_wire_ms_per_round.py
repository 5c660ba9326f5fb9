"""Collaboration layer, the wire between the cards
(``parallel/mesh.sharded_collab_round_desc``'s ``all_gather`` of the query
VLADs and ``all_to_all`` of the keyframe grid): device milliseconds of the
collectives' transfer per round, in the traced segment of a multi-rank
driver (``drivers/sharded.py``: the port's recorder on every rank, from each
collective's ``wire`` stamp to the next segment's; per round and collective
the least over the ranks, since the last rank to arrive waits for no one;
the trace's ``rounds`` and ``collective_s``). Rank 0's wait for the other
ranks is the trace's ``wait_s``, which no metric reads. None where the
trace has neither."""


def read(run):
    t = run.trace
    if not t or not t.get("rounds") or not t.get("collective_s"):
        return None
    return t["collective_s"] * 1e3 / t["rounds"]
