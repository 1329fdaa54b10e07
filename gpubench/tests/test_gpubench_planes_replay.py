"""planes_replay_share's reader on hand-built traces: two video chunks whose
plane stages are all replayed, none, or half."""

import pytest

from gpubench.tests.test_gpubench_spans import ev, frame, read


def chunks(replayed: list) -> list:
    """A video chunk a flag: its G pass, with a `G.planes.replay` span inside
    its `G.planes` span where the flag is set."""
    out = []
    for i, r in enumerate(replayed):
        t = 40.0 * i
        out += [ev("video.chunk", t, 30.0)] + frame(t + 1.0, 10.0, 5.0, 8.0)
        if r:
            out += [ev("G.planes.replay", t + 2.0, 1.0), ev("cudaGraphLaunch", t + 2.1, 0.5, "cpu_op")]
    return out


@pytest.mark.parametrize("replayed,want", [
    ([True, True], 1.0), ([False, False], 0.0), ([True, False, False, True], 0.5)])
def test_planes_replay_share(replayed, want):
    assert read("planes_replay_share.video", chunks(replayed)) == want


def test_planes_replay_share_needs_the_card_and_the_spans():
    assert read("planes_replay_share.video", chunks([True]), device="cpu") is None
    assert read("planes_replay_share.video", [ev("video.chunk", 0.0, 30.0)]) is None
